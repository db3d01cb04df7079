"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA card: python -m pytest tests/ -m gpu -q
Without a card every test here skips (the check is in the fixture).
Tolerances: rq_encode ids identical except rows at an argmin near-tie;
decoder_stack max abs error 1e-3 in f32 and 6e-2 in bf16 (a bf16 rounding
flipped by f32 summation order carries through the residual stream);
attention 2e-5 in f32 and 3.2e-2 in bf16 (one bf16 step, 2^-5, of an output
between 4 and 8 whose f32 sum lands across a rounding boundary); encoder_stack
1e-3 in f32 and, in bf16, 1.5e-1 at the worst element with a mean error of
at most 4e-3 (flipped roundings carry through 4 layers of 800-key softmaxes);
attention backward, against its plain version: dq, dk, dv and dbias within
4e-6 of the tensor's largest entry in f32 (a few f32 steps of sums of up to
800 terms taken in another order) and within 2^-7 of it in bf16 (one bf16 step
of the largest output: a sum that lands across a rounding boundary), dbias
within 1e-4 of its largest entry in bf16 (it is summed in f32 from ds whose p
differs in the 7th digit), two launches bit-equal. The stack kernels take the
same tolerances on both routes (bf16 at widths that are multiples of 64 for
the encoder's rows and of 128 for the decoder, whose tensor-core kernel runs a
cluster of two blocks per batch row: the tensor cores; float32 and other
widths: the CUDA cores), give the same bits on two launches, and the C
libraries' routes are the Python mirrors' own. The libraries compute the
shared memory of each route: every tensor-core shape fits a block, and the
wrappers refuse a shape that fits neither route. An operand that is strided
or does not start on a 16-byte boundary is launched from a copy and gives
the same bits. rq_encode in bf16: ids equal the plain bf16 version's outside
the bf16 near-tie set (a level whose top-2 distance gap along the bf16 path
is within what one bf16 step of every residual element can move it), and on
integer-valued inputs, whose float32 sums are exact, on every row.
"""

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.models.t5 import T5Stack, T5StackConfig
from rqvae_tpu_torch.ops.cuda.attention import t5_attention, t5_attention_backward_plain, t5_attention_plain
from rqvae_tpu_torch.ops.cuda.decoder_stack import t5_decoder_stack_infer, t5_decoder_stack_plain
from rqvae_tpu_torch.ops.cuda.encoder_stack import t5_encoder_stack_infer, t5_encoder_stack_plain
from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize, fused_encode_quantize_plain
from rqvae_tpu_torch.serving.retriever import Retriever
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

pytestmark = pytest.mark.gpu

SMALL_VAE = dict(input_dim=32, embed_dim=8, hidden_dims=(24, 16), codebook_size=16, n_layers=3)
AMAZON_VAE = dict(input_dim=768, embed_dim=32, hidden_dims=(512, 256, 128), codebook_size=256, n_layers=3)
ML32M_VAE = dict(input_dim=788, embed_dim=64, hidden_dims=(512, 256, 128), codebook_size=256, n_layers=3)
ODD_VAE = dict(input_dim=40, embed_dim=8, hidden_dims=(24,), codebook_size=16, n_layers=2)  # 2 products
SMALL_T5 = dict(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)
AMAZON_T5 = dict(d_model=384, d_kv=64, num_heads=6, d_ff=1024, num_layers=4)
SYNTHETIC_T5 = dict(d_model=64, d_kv=64, num_heads=4, d_ff=128, num_layers=2)  # configs/decoder_synthetic.gin


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rqvae(fields, n, device, seed=0):
    """An RQ-VAE whose codebooks are jittered residuals of its corpus."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, fields["input_dim"], generator=g)
    rq = RqVae(RqVaeConfig(**fields, codebook_mode=QuantizeForwardMode.STE), device="cpu", seed=seed)
    with torch.no_grad():
        res = rq.encode(x)
        for level in range(fields["n_layers"]):
            cb = res[torch.randperm(n, generator=g)[: fields["codebook_size"]]]
            cb = cb + 0.1 * res.std() * torch.randn(cb.shape, generator=g)
            rq.codebooks[level].copy_(cb)
            res = res - cb[torch.cdist(res, cb).argmin(1)]
    return rq.to(device), x.to(device)


def _near_ties(x, weights, codebooks, rel=1e-5):
    """Rows with a level whose float64 top-2 distance gap is below `rel` of
    ||res||^2 + max ||c||^2."""
    h = x.double()
    for i, w in enumerate(weights):
        h = h @ w.double()
        h = torch.relu(h) if i != len(weights) - 1 else h
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for cb in codebooks.double():
        top2 = torch.topk(torch.cdist(h, cb) ** 2, 2, dim=1, largest=False)
        near |= top2.values[:, 1] - top2.values[:, 0] < rel * ((h * h).sum(1) + (cb * cb).sum(1).max())
        h = h - cb[top2.indices[:, 0]]
    return near


@pytest.mark.parametrize("fields,n", [(SMALL_VAE, 1000), (ODD_VAE, 333), (AMAZON_VAE, 8192), (ML32M_VAE, 8191)])
def test_rq_encode_kernel_matches_plain(cuda, fields, n):
    rq, x = _rqvae(fields, n, cuda)
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    before = fused_encode_quantize.launches
    got = fused_encode_quantize(x, w, cb, fields["n_layers"])
    torch.cuda.synchronize()
    assert fused_encode_quantize.launches == before + 1
    want = fused_encode_quantize_plain(x, w, cb, fields["n_layers"])
    differ = (got != want).any(1)
    assert not (differ & ~_near_ties(x, w, cb)).any()


def _decoder_operands(t5_fields, dtype, beams, T, B, Le, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    cfg = T5StackConfig(**t5_fields, dtype=dtype)
    stack = T5Stack(cfg, is_decoder=True, device=device)
    for p in stack.parameters():  # T5-scale random weights
        with torch.no_grad():
            p.copy_((torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5).to(device))
    d = cfg.d_model
    x = torch.randn(B, beams * T, d, generator=g).to(device)
    enc = torch.randn(B, Le, d, generator=g).to(device)
    enc_mask = (torch.rand(B, Le, generator=g) > 0.2).to(torch.int32).to(device)
    enc_mask[:, 0] = 1
    with torch.no_grad():
        ops = stack.decode_operands(x, stack.cross_kv(enc), enc_mask, beams, stack.decode_weights())
    return ops, cfg.layer_norm_eps


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 6e-2)])
@pytest.mark.parametrize(
    "t5_fields,beams,T,B,Le",
    [(SMALL_T5, 3, 2, 5, 7), (SMALL_T5, 1, 1, 3, 4), (AMAZON_T5, 1, 1, 64, 80),
     (AMAZON_T5, 10, 2, 64, 80), (AMAZON_T5, 10, 3, 64, 80),
     # the bf16 tensor-core route's edges: odd B, kT = 32 and 17, Le = 128 and 33, narrow widths
     (AMAZON_T5, 10, 3, 7, 80), (AMAZON_T5, 4, 8, 3, 33), (AMAZON_T5, 1, 17, 2, 128), (AMAZON_T5, 1, 1, 5, 1),
     (SYNTHETIC_T5, 3, 2, 4, 12)],
)
def test_decoder_stack_kernel_matches_plain(cuda, dtype, tol, t5_fields, beams, T, B, Le):
    ops, eps = _decoder_operands(t5_fields, dtype, beams, T, B, Le, cuda)
    before = t5_decoder_stack_infer.launches
    got = t5_decoder_stack_infer(*ops, eps=eps)
    torch.cuda.synchronize()
    assert t5_decoder_stack_infer.launches == before + 1
    want = t5_decoder_stack_plain(*ops, eps=eps)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol


def _attention_inputs(B, H, Lq, Lk, dk, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, dk, generator=g).to(dtype).to(device) for L in (Lq, Lk, Lk))
    bias = torch.randn(H, Lq, Lk, generator=g).to(device)
    lengths = torch.randint(1, Lk + 1, (B,), generator=g)
    mask = (torch.arange(Lk)[None, :] < lengths[:, None]).to(torch.int32)
    mask[0] = 0  # a row with every key masked
    return q, k, v, bias, mask.to(device)


# bf16 at dk = 64 takes the whole-row routes up to 128 keys (the backward up
# to 128 queries too) and the tiled routes beyond; the edges of both, odd
# batches, Lq != Lk, causal and dropout
ROUTE_CASES = [(5, 6, 80, 80, 64, False, 0.1), (3, 2, 16, 16, 64, True, 0.1), (7, 3, 100, 128, 64, False, 0.1),
               (3, 2, 127, 127, 64, True, 0.0), (3, 2, 129, 129, 64, True, 0.1), (3, 2, 50, 800, 64, False, 0.1),
               (3, 2, 200, 80, 64, False, 0.1), (5, 2, 80, 48, 64, False, 0.05)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize(
    "B,H,Lq,Lk,dk,causal,rate",
    [(3, 2, 24, 24, 8, False, 0.0), (2, 3, 70, 133, 16, False, 0.3), (2, 2, 65, 65, 128, True, 0.1),
     (4, 6, 512, 512, 64, True, 0.0), (64, 6, 800, 800, 64, False, 0.0), (64, 6, 800, 800, 64, False, 0.1),
     *ROUTE_CASES],
)
def test_attention_kernel_matches_plain(cuda, dtype, tol, B, H, Lq, Lk, dk, causal, rate):
    q, k, v, bias, mask = _attention_inputs(B, H, Lq, Lk, dk, dtype, cuda)
    before = t5_attention.launches
    got = t5_attention(q, k, v, bias, mask, 77, causal=causal, dropout_rate=rate)
    torch.cuda.synchronize()
    assert t5_attention.launches == before + 1
    want = t5_attention_plain(q, k, v, bias, mask, 77, causal=causal, dropout_rate=rate)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    if rate == 0.0 and Lk < 100:
        # every key at -1e9, and scores small enough to round away beside it
        # (f32 steps are 64 there): the uniform softmax, the mean of v
        torch.testing.assert_close(got[0].float(), v[0].float().mean(1, keepdim=True).expand_as(got[0]),
                                   atol=tol, rtol=0)


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    """A head width or dtype the kernels lack is refused; a strided operand is
    not: its result and gradients equal the contiguous operand's."""
    q, k, v, bias, mask = _attention_inputs(2, 2, 16, 16, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="dk"):
        t5_attention(q[..., :6].contiguous(), k[..., :6].contiguous(), v[..., :6].contiguous(), bias, mask)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t5_attention(q.half(), k.half(), v.half(), bias, mask)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    want = _attention_grads(q, k, v, bias, mask, do)
    got = _attention_grads(strided, k, v, bias, mask, do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _attention_grads(q, k, v, bias, mask, do, **kw):
    """(out, dq, dk, dv, dbias) through the autograd function."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    out = t5_attention(*leaves, mask, 77, **kw)
    out.backward(do)
    return [out.detach(), *(t.grad for t in leaves)]


@pytest.mark.parametrize("dtype,tol,dbias_tol", [(torch.float32, 4e-6, 4e-6), (torch.bfloat16, 2.0 ** -7, 1e-4)])
@pytest.mark.parametrize(
    "B,H,Lq,Lk,dk,causal,rate",
    [(3, 2, 24, 24, 8, False, 0.0), (2, 3, 70, 133, 16, False, 0.3), (2, 2, 65, 65, 128, True, 0.1),
     (9, 2, 200, 200, 64, True, 0.2), (640, 6, 80, 80, 64, False, 0.1), (64, 6, 800, 800, 64, False, 0.1),
     *ROUTE_CASES],
)
def test_attention_backward_kernel_matches_plain(cuda, dtype, tol, dbias_tol, B, H, Lq, Lk, dk, causal, rate):
    q, k, v, bias, mask = _attention_inputs(B, H, Lq, Lk, dk, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dtype).to(cuda)
    kw = dict(causal=causal, dropout_rate=rate)
    before = (t5_attention.launches, t5_attention.backward_launches)
    out, *got = _attention_grads(q, k, v, bias, mask, do, **kw)
    torch.cuda.synchronize()
    assert (t5_attention.launches, t5_attention.backward_launches) == (before[0] + 1, before[1] + 1)
    _, *again = _attention_grads(q, k, v, bias, mask, do, **kw)
    want = t5_attention_backward_plain(q, k, v, bias, mask, 77, do, **kw)
    # the forward that saves its row statistics is the forward
    assert torch.equal(out, t5_attention(q, k, v, bias, mask, 77, **kw))
    for name, g, a, w in zip(("dq", "dk", "dv", "dbias"), got, again, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all(), name
        assert torch.equal(g, a), f"{name}: two launches differ"
        limit = (dbias_tol if name == "dbias" else tol) * w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= limit, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,rate,causal", [(64, 0.0, False), (64, 0.2, True), (16, 0.2, False), (128, 0.0, True)])
def test_attention_backward_rebuilds_the_forwards_p(cuda, dtype, L, rate, causal):
    """With v = dout = the identity at Lq = Lk = dk = L the forward's output is
    its rounded (dropped) p and the backward's dv the transpose of its own:
    they must be equal bit for bit (at dk = 64 in bf16 both run mma.sync,
    elsewhere both sum q.k in ascending order on the CUDA cores)."""
    g = torch.Generator().manual_seed(8)
    q, k = (torch.randn(5, 3, L, L, generator=g).to(dtype).to(cuda) for _ in range(2))
    eye = torch.eye(L).to(dtype).to(cuda).expand(5, 3, L, L).contiguous()
    bias = torch.randn(3, L, L, generator=g).to(cuda)
    mask = (torch.rand(5, L, generator=g) > 0.2).to(torch.int32).to(cuda)
    v = eye.clone().requires_grad_()
    out = t5_attention(q, k, v, bias, mask, 9, causal=causal, dropout_rate=rate)
    out.backward(eye)
    assert torch.equal(v.grad.transpose(-1, -2), out.detach())


@pytest.mark.parametrize("B,L,blocks", [(3, 80, [(0, 0), (1, 0), (0, 1)]), (2, 128, [(1, 1), (0, 1)]),
                                          (2, 800, [(0, 0), (12, 12), (5, 9), (12, 0)])])
@pytest.mark.parametrize("rate,causal", [(0.0, False), (0.2, True)])
def test_attention_backward_p_equals_forward_p_on_both_routes(cuda, B, L, blocks, rate, causal):
    """bf16 at dk = 64 (whole rows at 80 and 128, key tiles at 800): with v the
    identity on keys 64j .. 64j + 63 and dout the identity on queries 64i ..
    64i + 63, the forward's out[64i:] and the backward's dv^T[:, 64j:] are the
    same 64 x 64 block of the rounded, dropped p: equal bits."""
    from rqvae_tpu_torch.ops.cuda import attention as A

    g = torch.Generator().manual_seed(8)
    q, k = (torch.randn(B, 3, L, 64, generator=g).to(torch.bfloat16).to(cuda) for _ in range(2))
    bias = torch.randn(3, L, L, generator=g).to(cuda)
    mask = (torch.rand(B, L, generator=g) > 0.2).to(torch.int32).to(cuda)

    def block_eye(j):
        e = torch.zeros(L, 64)
        idx = torch.arange(64 * j, min(L, 64 * j + 64))
        e[idx, idx - 64 * j] = 1.0
        return e.to(torch.bfloat16).to(cuda).expand(B, 3, L, 64).contiguous()

    for i, j in blocks:
        v, do = block_eye(j), block_eye(i)
        out, m, l, bits = A._forward_cuda(q, k, v, bias, mask, 9, causal, rate, True)
        assert (bits is not None) == (L > 128 and rate > 0)  # the tiled route with dropout keeps its bits
        rows, cols = slice(64 * i, min(L, 64 * i + 64)), slice(64 * j, min(L, 64 * j + 64))
        n_r, n_c = rows.stop - rows.start, cols.stop - cols.start
        for keep_bits in {id(bits): bits, id(None): None}.values():  # the forward's bits, and hashed anew
            dv = A._backward_cuda(q, k, v, bias, mask, 9, do, m, l, causal, rate, keep_bits=keep_bits)[2]
            assert torch.equal(dv.transpose(-1, -2)[:, :, :n_r, cols], out[:, :, rows, :n_c]), (i, j)


def test_attention_routes_match_the_libraries(cuda):
    """The C libraries pick the route that attention_route names."""
    from rqvae_tpu_torch.ops.cuda import attention as A
    from rqvae_tpu_torch.ops.cuda._build import load_library

    fwd = load_library("attention", A._FUNCTIONS)
    bwd = load_library("attention_bwd", A._BWD_FUNCTIONS)
    code = {"cuda_cores": 0, "whole_row": 1, "tiled": 2}
    for dtype in (torch.float32, torch.bfloat16):
        for dk in (8, 64, 128):
            for Lq in (1, 80, 128, 129, 800):
                for Lk in (1, 16, 127, 128, 129, 800):
                    bf = int(dtype == torch.bfloat16)
                    assert fwd.attention_route(bf, Lk, dk) == code[A.attention_route(Lq, Lk, dk, dtype)]
                    assert bwd.attention_backward_route(bf, Lq, Lk, dk) == code[
                        A.attention_route(Lq, Lk, dk, dtype, backward=True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk", [(80, 80), (200, 150)])
def test_attention_backward_batch_groups(cuda, dtype, Lq, Lk):
    """An odd batch in groups that do not divide it: dq, dk and dv do not
    depend on the groups (bit-equal to one group); dbias is the same sum in
    another order."""
    from rqvae_tpu_torch.ops.cuda import attention as A

    q, k, v, bias, mask = _attention_inputs(9, 2, Lq, Lk, 64, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dtype).to(cuda)
    _, m, l, bits = A._forward_cuda(q, k, v, bias, mask, 77, False, 0.1, True)
    one = A._backward_cuda(q, k, v, bias, mask, 77, do, m, l, False, 0.1, groups=1, keep_bits=bits)
    for groups in (2, 3, 5):
        got = A._backward_cuda(q, k, v, bias, mask, 77, do, m, l, False, 0.1, groups=groups, keep_bits=bits)
        for a, b in zip(got[:3], one[:3]):
            assert torch.equal(a, b), groups
        assert (got[3] - one[3]).abs().max().item() <= 1e-5 * one[3].abs().max().item()


def test_kernels_launch_on_the_tensors_device(cuda):
    """Inputs on cuda:1 while cuda:0 is current: every wrapper launches on the
    inputs' card and agrees with its plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda:1")
    torch.cuda.set_device(0)
    q, k, v, bias, mask = _attention_inputs(3, 2, 80, 80, 64, torch.bfloat16, dev)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16).to(dev)
    out, *grads = _attention_grads(q, k, v, bias, mask, do, dropout_rate=0.1)
    torch.cuda.synchronize(dev)
    want = t5_attention_plain(q, k, v, bias, mask, 77, dropout_rate=0.1)
    assert (out.float() - want.float()).abs().max().item() <= 3.2e-2
    for g, w in zip(grads, t5_attention_backward_plain(q, k, v, bias, mask, 77, do, dropout_rate=0.1)):
        assert g.device == dev and (g.float() - w.float()).abs().max().item() <= 2.0 ** -7 * w.float().abs().max().item()
    rq, x = _rqvae(SMALL_VAE, 200, dev)
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    ids = fused_encode_quantize(x, w, cb, 3)
    differ = (ids != fused_encode_quantize_plain(x, w, cb, 3)).any(1)
    assert not (differ & ~_near_ties(x, w, cb)).any()
    ops, eps = _decoder_operands(SMALL_T5, "float32", 3, 2, 5, 7, dev)
    assert (t5_decoder_stack_infer(*ops, eps=eps) - t5_decoder_stack_plain(*ops, eps=eps)).abs().max().item() <= 1e-3
    ops, eps = _encoder_operands(SMALL_T5, "float32", 3, 11, dev)
    assert (t5_encoder_stack_infer(*ops, eps=eps) - t5_encoder_stack_plain(*ops, eps=eps)).abs().max().item() <= 1e-3
    assert torch.cuda.current_device() == 0


def test_attention_backward_has_no_fallback(cuda, monkeypatch):
    """A backward kernel that cannot be loaded raises; nothing computes the
    gradient some other way."""
    import rqvae_tpu_torch.ops.cuda.attention as mod

    q, k, v, bias, mask = _attention_inputs(2, 2, 16, 16, 8, torch.float32, cuda)
    real = mod.load_library

    def broken(name, functions):
        if name == "attention_bwd":
            raise RuntimeError("nvcc failed for attention_bwd.cu")
        return real(name, functions)

    monkeypatch.setattr(mod, "load_library", broken)
    out = t5_attention(q.requires_grad_(), k, v, bias, mask)
    with pytest.raises(RuntimeError, match="attention_bwd"):
        out.sum().backward()


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 training step with dropout, card (kernels 4 and 5) against CPU
    (plain versions), same weights and seeds: loss rtol 1e-5, every gradient
    within 1e-4 of the tensor's largest entry."""
    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=32, t5_d_kv=8, t5_num_heads=4,
                          t5_d_ff=64, t5_num_layers=2, t5_dropout=0.1)
    from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch

    r = np.random.RandomState(0)
    B, n = 8, 6
    mask = np.repeat(np.arange(n)[None, :] < r.randint(1, n + 1, B)[:, None], 4, axis=1)
    sem = np.where(mask, r.randint(0, 16, (B, n * 4)), -1)
    fields = dict(user_ids=np.zeros(B, np.int64), sem_ids=sem, sem_ids_fut=r.randint(0, 16, (B, 4)), seq_mask=mask,
                  token_type_ids=np.zeros((B, n * 4), np.int64), token_type_ids_fut=np.zeros((B, 4), np.int64))
    grads, losses = {}, {}
    before = (t5_attention.launches, t5_attention.backward_launches)
    for dev in ("cpu", cuda):
        model = EncoderDecoderRetrievalModel(cfg, device=dev, seed=3)
        batch = TokenizedSeqBatch(**{k: torch.as_tensor(v, device=dev) for k, v in fields.items()})
        out = model(batch, training=True, generator=torch.Generator().manual_seed(5))
        out.loss.backward()
        losses[str(dev)] = out.loss.item()
        grads[str(dev)] = {n_: p.grad.cpu() for n_, p in model.named_parameters()}
    assert (t5_attention.launches, t5_attention.backward_launches) == (before[0] + 2, before[1] + 2)  # encoder layers
    assert losses["cpu"] == pytest.approx(losses[str(cuda)], rel=1e-5)
    for name, g in grads["cpu"].items():
        assert (g - grads[str(cuda)][name]).abs().max() <= 1e-4 * g.abs().max() + 1e-8, name


def _encoder_operands(t5_fields, dtype, B, L, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    cfg = T5StackConfig(**t5_fields, dtype=dtype)
    stack = T5Stack(cfg, device=device)
    for p in stack.parameters():  # T5-scale random weights
        with torch.no_grad():
            p.copy_((torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5).to(device))
    x = torch.randn(B, L, cfg.d_model, generator=g).to(device)
    lengths = torch.randint(1, L + 1, (B,), generator=g)
    lengths[0] = L
    mask = (torch.arange(L)[None, :] < lengths[:, None]).to(torch.int32).to(device)
    with torch.no_grad():
        return stack.encode_operands(x, mask), cfg.layer_norm_eps


@pytest.mark.parametrize("dtype,tol,mean_tol", [("float32", 1e-3, 1e-5), ("bfloat16", 1.5e-1, 4e-3)])
@pytest.mark.parametrize("t5_fields,B,L", [(SMALL_T5, 3, 11), (SMALL_T5, 5, 70), (AMAZON_T5, 2, 513),
                                           (AMAZON_T5, 64, 800),
                                           # bf16 tensor-core rows at ragged row counts (B*L not a
                                           # multiple of 64), short rows, narrow widths
                                           (AMAZON_T5, 3, 517), (AMAZON_T5, 5, 67), (SYNTHETIC_T5, 3, 45)])
def test_encoder_stack_kernel_matches_plain(cuda, dtype, tol, mean_tol, t5_fields, B, L):
    ops, eps = _encoder_operands(t5_fields, dtype, B, L, cuda)
    before = t5_encoder_stack_infer.launches
    got = t5_encoder_stack_infer(*ops, eps=eps)
    torch.cuda.synchronize()
    assert t5_encoder_stack_infer.launches == before + 1
    want = t5_encoder_stack_plain(*ops, eps=eps)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = (got - want).abs()
    assert err.max().item() <= tol and err.mean().item() <= mean_tol


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stack_kernels_repeat_bit_equal(cuda, dtype):
    """Two launches on the same inputs give the same bits (no float atomics),
    on both routes of both stack kernels."""
    ops, eps = _encoder_operands(AMAZON_T5, dtype, 3, 517, cuda)
    first = t5_encoder_stack_infer(*ops, eps=eps)
    assert torch.equal(first, t5_encoder_stack_infer(*ops, eps=eps))
    for beams, T in ((1, 1), (10, 2), (10, 3)):
        ops, eps = _decoder_operands(AMAZON_T5, dtype, beams, T, 64, 80, cuda)
        first = t5_decoder_stack_infer(*ops, eps=eps)
        assert torch.equal(first, t5_decoder_stack_infer(*ops, eps=eps))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stack_kernels_rows_do_not_move_with_the_batch(cuda, dtype):
    """The first half of a batch equals the same rows launched alone, bit for
    bit, on both routes of both stack kernels (each batch row is blocks of
    its own): the decoder at the Amazon serving shapes (64 rows, 10 beams of
    3, 80 encoder rows), the encoder at 8 rows of 517."""
    g = torch.Generator().manual_seed(3)

    def stack(is_decoder):
        s = T5Stack(T5StackConfig(**AMAZON_T5, dtype=dtype), is_decoder=is_decoder, device=cuda)
        with torch.no_grad():
            for p in s.parameters():
                p.copy_((torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5).to(cuda))
        return s

    d = AMAZON_T5["d_model"]
    dec, enc_stack = stack(True), stack(False)
    x = torch.randn(64, 30, d, generator=g).to(cuda)
    enc = torch.randn(64, 80, d, generator=g).to(cuda)
    enc_mask = (torch.rand(64, 80, generator=g) > 0.2).to(torch.int32).to(cuda)
    enc_mask[:, 0] = 1
    eps = dec.cfg.layer_norm_eps
    with torch.no_grad():
        kv, w = dec.cross_kv(enc), dec.decode_weights()
        whole = t5_decoder_stack_infer(*dec.decode_operands(x, kv, enc_mask, 10, w), eps=eps)
        rows = tuple(t[:, :32].contiguous() for t in kv)
        alone = t5_decoder_stack_infer(*dec.decode_operands(x[:32].contiguous(), rows, enc_mask[:32], 10, w), eps=eps)
        assert torch.equal(whole[:32], alone)
        xe = torch.randn(8, 517, d, generator=g).to(cuda)
        mask = (torch.arange(517)[None, :] < torch.randint(1, 518, (8, 1), generator=g)).to(torch.int32).to(cuda)
        whole = t5_encoder_stack_infer(*enc_stack.encode_operands(xe, mask), eps=eps)
        alone = t5_encoder_stack_infer(*enc_stack.encode_operands(xe[:4].contiguous(), mask[:4]), eps=eps)
        assert torch.equal(whole[:4], alone)


def _stack_libraries():
    from rqvae_tpu_torch.ops.cuda import decoder_stack as D
    from rqvae_tpu_torch.ops.cuda import encoder_stack as E
    from rqvae_tpu_torch.ops.cuda._build import load_library

    return load_library("encoder_stack", E._FUNCTIONS), load_library("decoder_stack", D._FUNCTIONS)


def test_stack_routes_match_the_library(cuda):
    """The Python routes are the C libraries' own."""
    from rqvae_tpu_torch.ops.cuda import decoder_stack as D
    from rqvae_tpu_torch.ops.cuda import encoder_stack as E

    enc, dec = _stack_libraries()
    for dt in (torch.bfloat16, torch.float32):
        bf = int(dt == torch.bfloat16)
        for d, dk, inner, dff in ((384, 64, 384, 1024), (64, 64, 256, 128), (32, 8, 32, 64), (384, 32, 384, 1024),
                                  (448, 64, 448, 1024), (384, 64, 384, 1000), (128, 64, 64, 64),
                                  (320, 64, 384, 1024), (256, 64, 256, 1088), (128, 64, 128, 128)):
            want = E.encoder_stack_route(d, dk, inner, dff, dt)
            assert enc.encoder_stack_route(bf, d, dk, inner, dff) == int(want == "tensor_cores")
            for kT, Le in ((1, 80), (20, 80), (30, 80), (32, 128), (33, 80), (30, 129), (6, 7)):
                want = D.decoder_stack_route(kT, d, dk, inner, dff, Le, dt)
                assert dec.decoder_stack_route(bf, kT, d, dk, inner, dff, Le) == int(want == "tensor_cores")


def test_stack_shared_memory_at_the_repo_widths(cuda):
    """What a block asks for at d = 384, 6 heads of 64, dff = 1024 on each
    route, and at the synthetic configuration's widths."""
    from rqvae_tpu_torch.ops.cuda.decoder_stack import MAX_SMEM_BYTES

    enc, dec = _stack_libraries()
    assert enc.encoder_stack_smem_bytes(1, 384, 64, 384, 1024) == 209_920  # 64 bf16 rows, 3 weight tiles
    assert enc.encoder_stack_smem_bytes(0, 384, 64, 384, 1024) == 212_992  # 32 float32 rows
    for kt in (1, 20, 30):  # each block of the pair: half the heads and columns
        assert dec.decoder_stack_smem_bytes(1, kt, 384, 64, 384, 1024, 80) == 189_952
    assert dec.decoder_stack_smem_bytes(0, 30, 384, 64, 384, 1024, 80) == MAX_SMEM_BYTES  # split-K room filled
    assert dec.decoder_stack_smem_bytes(1, 6, 64, 64, 256, 128, 12) <= MAX_SMEM_BYTES  # synthetic: CUDA cores


@pytest.mark.parametrize("heads", [1, 2, 4, 6])
def test_every_tensor_core_stack_shape_fits_a_block(cuda, heads):
    """The tensor-core routes take only shapes whose shared memory fits: the
    widest kT, Le and dff chunk at every width they take."""
    from rqvae_tpu_torch.ops.cuda.decoder_stack import MAX_SMEM_BYTES, decoder_stack_route
    from rqvae_tpu_torch.ops.cuda.encoder_stack import encoder_stack_route

    enc, dec = _stack_libraries()
    inner = 64 * heads
    for d in (64, 128, 192, 256, 320, 384):
        assert encoder_stack_route(d, 64, inner, 1024, torch.bfloat16) == "tensor_cores"
        assert enc.encoder_stack_smem_bytes(1, d, 64, inner, 1024) <= MAX_SMEM_BYTES
        for kt, le in ((1, 1), (32, 128), (17, 80)):
            if decoder_stack_route(kt, d, 64, inner, 1024, le, torch.bfloat16) == "tensor_cores":
                assert d % 128 == 0 and inner % 128 == 0
                assert dec.decoder_stack_smem_bytes(1, kt, d, 64, inner, 1024, le) <= MAX_SMEM_BYTES


def test_stack_wrappers_refuse_what_no_route_fits(cuda):
    """Shapes whose shared memory fits neither route are refused before launch."""
    before = (t5_encoder_stack_infer.launches, t5_decoder_stack_infer.launches)
    for (B, L, d, NL, H, dk, dff), dt in (((1, 2, 512, 1, 8, 64, 2048), torch.float32),  # 262,144 B
                                          ((1, 2, 448, 1, 7, 64, 1024), torch.bfloat16)):  # past both routes
        z = lambda *shape, t=dt: torch.zeros(shape, dtype=t, device=cuda)
        f = torch.float32
        args = (z(B, L, d), z(NL, H, d, dk), z(NL, H, d, dk), z(NL, H, d, dk), z(NL, H, dk, d), z(NL, d, dff),
                z(NL, dff, d), z(NL, d, t=f), z(NL, d, t=f), z(d, t=f), z(H, L, L, t=f), z(B, L, t=f))
        with pytest.raises(ValueError, match="shared memory"):
            t5_encoder_stack_infer(*args, eps=1e-6)
    for (B, kT, d, NL, H, dk, dff, Le), dt in (((1, 64, 384, 1, 6, 64, 1024, 80), torch.bfloat16),  # kT = 64
                                               ((1, 30, 384, 1, 6, 64, 1024, 256), torch.float32)):  # 256 keys
        z = lambda *shape, t=dt: torch.zeros(shape, dtype=t, device=cuda)
        f = torch.float32
        args = (z(B, kT, d), z(NL, H, d, dk), z(NL, H, d, dk), z(NL, H, d, dk), z(NL, H, dk, d), z(NL, H, d, dk),
                z(NL, H, dk, d), z(NL, d, dff), z(NL, dff, d), z(NL, d, t=f), z(NL, d, t=f), z(NL, d, t=f),
                z(d, t=f), z(H, kT, kT, t=f), z(NL, B, H, Le, dk), z(NL, B, H, Le, dk), z(B, Le, t=f))
        with pytest.raises(ValueError, match="shared memory"):
            t5_decoder_stack_infer(*args, eps=1e-6)
    assert (t5_encoder_stack_infer.launches, t5_decoder_stack_infer.launches) == before


def _offset_copy(t):
    """t's values in a contiguous view that starts 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stack_kernels_take_unaligned_operands(cuda, dtype):
    """A contiguous operand that does not start on a 16-byte boundary gives
    the bits an aligned one gives (the wrapper launches on a copy)."""
    ops, eps = _encoder_operands(AMAZON_T5, dtype, 2, 67, cuda)
    want = t5_encoder_stack_infer(*ops, eps=eps)
    moved = list(ops)
    moved[0], moved[5] = _offset_copy(ops[0]), _offset_copy(ops[5])  # x and wi
    assert moved[0].data_ptr() % 16 and torch.equal(t5_encoder_stack_infer(*moved, eps=eps), want)
    ops, eps = _decoder_operands(AMAZON_T5, dtype, 10, 2, 3, 80, cuda)
    want = t5_decoder_stack_infer(*ops, eps=eps)
    moved = list(ops)
    moved[0], moved[14] = _offset_copy(ops[0]), _offset_copy(ops[14])  # x and the K cache
    assert moved[14].data_ptr() % 16 and torch.equal(t5_decoder_stack_infer(*moved, eps=eps), want)


def test_retriever_on_card_matches_cpu(cuda):
    """The small slice end to end in f32: card (kernels) against CPU (plain)."""
    rq, x = _rqvae(SMALL_VAE, 600, cuda, seed=1)
    tok = SemanticIdTokenizer(rq, device=cuda, precision="f32")  # the CPU's model path is f32
    before = (fused_encode_quantize.launches, t5_decoder_stack_infer.launches)
    tok.precompute_corpus_ids(x)
    rq_cpu = RqVae(rq.config, device="cpu")
    rq_cpu.load_state_dict({k: v.cpu() for k, v in rq.state_dict().items()})
    tok_cpu = SemanticIdTokenizer(rq_cpu, device="cpu")
    tok_cpu.precompute_corpus_ids(x.cpu())
    near = _near_ties(x, rq.encoder.kernels(), rq.codebooks.detach()).cpu()
    differ = (tok.cached_ids.cpu()[:, :3] != tok_cpu.cached_ids[:, :3]).any(1)
    assert not (differ & ~near).any()

    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=32, t5_d_kv=8, t5_num_heads=4,
                          t5_d_ff=64, t5_num_layers=2, top_k_for_generation=5)
    hist = np.random.RandomState(2).randint(-1, 600, (8, 6))
    card = Retriever(EncoderDecoderRetrievalModel(cfg, device=cuda, seed=3), tok, device=cuda).retrieve(hist)
    host = Retriever(EncoderDecoderRetrievalModel(cfg, device="cpu", seed=3), tok_cpu, device="cpu").retrieve(hist)
    assert fused_encode_quantize.launches == before[0] + 1
    assert t5_decoder_stack_infer.launches == before[1] + 3
    same = (card.sem_ids.cpu() == host.sem_ids).all(2).all(1).float().mean().item()
    assert same >= 0.95
    torch.testing.assert_close(card.log_probas.cpu(), host.log_probas, rtol=1e-4, atol=1e-4)


SYNTHETIC_VAE = dict(input_dim=64, embed_dim=16, hidden_dims=(128, 64), codebook_size=64, n_layers=3)  # rqvae_synthetic.gin


def bf16_ulp(v):
    """One bf16 step at each value of v (float64): 2^(floor(log2 |v|) - 7); 0 at 0."""
    return torch.exp2(torch.floor(torch.log2(v.abs())) - 7)


def bf16_near_tie_rows(x, weights, codebooks):
    """Rows where some level's top-2 distance gap, in float64 along the bf16
    path (kernel 1's rounding points), is within the most that one bf16 step
    of every element of the level's residual can move it,
    2 sum_i ulp(res_i) |c1_i - c2_i|: a float32 sum taken in another order
    can move a value across a bf16 rounding boundary, one bf16 step."""
    r16 = lambda t: t.to(torch.bfloat16).double()
    h = r16(x.double())
    for i, w in enumerate(weights):
        h = h @ r16(w.double())
        h = r16(torch.relu(h) if i != len(weights) - 1 else h)
    cb32 = codebooks.double()
    cb, cb2 = r16(cb32), (cb32 ** 2).sum(-1)
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for level in range(cb.shape[0]):
        top2 = torch.topk(cb2[level][None] - 2 * h @ cb[level].T, 2, dim=1, largest=False)
        c1, c2 = cb[level][top2.indices[:, 0]], cb[level][top2.indices[:, 1]]
        near |= top2.values[:, 1] - top2.values[:, 0] <= 2 * (bf16_ulp(h) * (c1 - c2).abs()).sum(1)
        h = r16(h - c1)
    return near


def integer_bf16_case(seed, n=512, k=16, d=8):
    """Integer-valued x, weights and codebooks whose float32 sums are all
    exact, whatever their order, and whose bf16 roundings change values:
    kernel 1's bf16 ids are then a function of its rounding points alone.
    The codewords are odd (mostly not bf16 values) and one is duplicated
    (an exact tie, which the lower index takes)."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import round_bf16

    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randint(-3, 4, (n, 32)).astype(np.float32))
    weights = [torch.from_numpy(r.randint(-a, a + 1, shape).astype(np.float32))
               for a, shape in ((3, (32, 24)), (2, (24, 16)), (1, (16, d)))]
    h = x
    for i, w in enumerate(weights):
        h = round_bf16(torch.relu(h @ w) if i < 2 else h @ w)
    cbs = []
    for _ in range(3):  # each level's codewords: jittered residuals, made odd
        cb = h[torch.from_numpy(r.choice(n, k, replace=False))] + torch.from_numpy(r.randint(-20, 21, (k, d))).float()
        cb = torch.where(cb % 2 == 0, cb + 1, cb)
        cb[k - 3] = cb[2]
        cbs.append(cb)
        dist = (cb * cb).sum(-1)[None] - 2 * h @ round_bf16(cb).T
        h = round_bf16(h - round_bf16(cb)[dist.argmin(-1)])
    return x, weights, torch.stack(cbs)


def integer_bf16_case_wide(seed, n=1024, widths=(768, 512, 256, 128, 32), k=256):
    """integer_bf16_case at the Amazon widths, which take the tensor-core
    route: x in {-1, 0, 1}, sparse weights in {-1, 0, 1} (one entry in 4, 16,
    16 and 32 nonzero, so every float32 sum stays below 2^24 and is exact in
    any order and alignment, while layer outputs pass 256 and bf16 rounds
    them), codewords odd integers near residuals (one duplicated)."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import round_bf16

    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randint(-1, 2, (n, widths[0])).astype(np.float32))
    weights = []
    for (a, b), every in zip(zip(widths[:-1], widths[1:]), (4, 16, 16, 32)):
        w = r.randint(-1, 2, (a, b)) * (r.randint(0, every, (a, b)) == 0)
        weights.append(torch.from_numpy(w.astype(np.float32)))
    h = x
    for i, w in enumerate(weights):
        h = round_bf16(torch.relu(h @ w) if i < len(weights) - 1 else h @ w)
    cbs = []
    for _ in range(3):
        cb = h[torch.from_numpy(r.choice(n, k, replace=False))]
        cb = cb + torch.from_numpy(r.randint(-200, 201, (k, widths[-1]))).float()
        cb = torch.where(cb % 2 == 0, cb + 1, cb)
        cb[k - 3] = cb[2]
        cbs.append(cb)
        dist = (cb * cb).sum(-1)[None] - 2 * h @ round_bf16(cb).T
        h = round_bf16(h - round_bf16(cb)[dist.argmin(-1)])
    return x, weights, torch.stack(cbs)


@pytest.mark.parametrize("fields,n", [(AMAZON_VAE, 8192), (AMAZON_VAE, 31), (AMAZON_VAE, 1), (ML32M_VAE, 8191),
                                      (ML32M_VAE, 33), (SYNTHETIC_VAE, 1000), (SYNTHETIC_VAE, 7), (ODD_VAE, 333)])
def test_rq_encode_bf16_kernel_matches_plain(cuda, fields, n):
    """bf16 ids equal the plain bf16 version's outside the bf16 near-tie
    set, at odd row counts (below one 32-row block, one row); two launches
    give the same bits."""
    rq, x = _rqvae(fields, max(n, 1024), cuda)  # codebooks from 1024 rows at least
    x = x[:n]
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    before = fused_encode_quantize.launches
    got = fused_encode_quantize(x, w, cb, fields["n_layers"], precision="bf16")
    again = fused_encode_quantize(x, w, cb, fields["n_layers"], precision="bf16")
    torch.cuda.synchronize()
    assert fused_encode_quantize.launches == before + 2 and torch.equal(got, again)
    want = fused_encode_quantize_plain(x, w, cb, fields["n_layers"], precision="bf16")
    differ = (got != want).any(1)
    assert not (differ & ~bf16_near_tie_rows(x, w, cb)).any()


@pytest.mark.parametrize("seed", [0, 2])
def test_rq_encode_bf16_integer_inputs_bit_equal(cuda, seed):
    x, weights, cbs = integer_bf16_case(seed)
    got = fused_encode_quantize(x.to(cuda), [w.to(cuda) for w in weights], cbs.to(cuda), 3, precision="bf16")
    want = fused_encode_quantize_plain(x, weights, cbs, 3, precision="bf16")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_rq_encode_takes_any_operand_layout(cuda, precision):
    """A view at an odd offset, a transposed weight and a bf16 x give the ids
    of the aligned float32 operands (bf16 x: the values x rounds to)."""
    rq, x = _rqvae(AMAZON_VAE, 2000, cuda)
    w, cb = list(rq.encoder.kernels()), rq.codebooks.detach()
    x16 = x.to(torch.bfloat16)
    want = fused_encode_quantize(x, w, cb, 3, precision=precision)
    want16 = fused_encode_quantize(x16.float(), w, cb, 3, precision=precision)
    flat = torch.empty(x.numel() + 1, device=cuda)
    offset = flat[1:].view(x.shape)
    offset.copy_(x)
    assert offset.data_ptr() % 16
    w_t = [w[0].T.contiguous().T, *w[1:]]  # the same values, column-major
    assert not w_t[0].is_contiguous()
    cb_offset = torch.empty(cb.numel() + 1, device=cuda)[1:].view(cb.shape)
    cb_offset.copy_(cb)
    assert torch.equal(fused_encode_quantize(offset, w, cb, 3, precision=precision), want)
    assert torch.equal(fused_encode_quantize(x, w_t, cb_offset, 3, precision=precision), want)
    assert torch.equal(fused_encode_quantize(x16, w, cb, 3, precision=precision), want16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stack_kernels_take_strided_operands(cuda, dtype):
    """A transposed (non-contiguous) operand gives the bits of the contiguous one."""
    ops, eps = _encoder_operands(AMAZON_T5, dtype, 2, 67, cuda)
    want = t5_encoder_stack_infer(*ops, eps=eps)
    moved = list(ops)
    moved[0] = ops[0].transpose(1, 2).contiguous().transpose(1, 2)  # x
    moved[5] = ops[5].transpose(1, 2).contiguous().transpose(1, 2)  # wi
    assert not moved[0].is_contiguous() and torch.equal(t5_encoder_stack_infer(*moved, eps=eps), want)
    ops, eps = _decoder_operands(AMAZON_T5, dtype, 10, 2, 3, 80, cuda)
    want = t5_decoder_stack_infer(*ops, eps=eps)
    moved = list(ops)
    moved[0] = ops[0].transpose(1, 2).contiguous().transpose(1, 2)  # x
    moved[14] = ops[14].transpose(3, 4).contiguous().transpose(3, 4)  # the K cache
    assert not moved[14].is_contiguous() and torch.equal(t5_decoder_stack_infer(*moved, eps=eps), want)


def test_tokenizer_runs_kernel_1_in_bf16_in_the_index_build_only(cuda):
    """As the JAX tokenizer: encode_batch takes the model path, the index
    build one kernel launch at the default precision, bf16."""
    rq, x = _rqvae(AMAZON_VAE, 3000, cuda, seed=2)
    tok = SemanticIdTokenizer(rq, device=cuda)
    assert tok.precision == "bf16"
    before = fused_encode_quantize.launches
    ids = tok.encode_batch(x)
    assert fused_encode_quantize.launches == before
    cached = tok.precompute_corpus_ids(x)
    assert fused_encode_quantize.launches == before + 1
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    differ = (cached[:, :3] != fused_encode_quantize_plain(x, w, cb, 3, precision="bf16")).any(1)
    assert not (differ & ~bf16_near_tie_rows(x, w, cb)).any()
    model = rq.get_semantic_ids(x).sem_ids
    assert torch.equal(ids, model)


def test_rqvae_train_step_on_card_matches_cpu(cuda):
    """One f32 stage-1 step (STE and rotation trick, categorical features),
    card against CPU: loss rtol 1e-5, every gradient within 2e-4 of its
    largest entry; a step repeats bit for bit on the card."""
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_train_step
    from rqvae_tpu_torch.train.state import adamw

    for mode, n_cat in ((QuantizeForwardMode.STE, 0), (QuantizeForwardMode.ROTATION_TRICK, 4)):
        cfg = RqVaeConfig(**{**SMALL_VAE, "n_cat_feats": n_cat}, codebook_mode=mode)
        g = torch.Generator().manual_seed(3)
        x = torch.randn(2, 64, 32, generator=g)
        if n_cat:
            x[..., -n_cat:] = (x[..., -n_cat:] > 0).float()
        res = {}
        for name, dev in (("card", cuda), ("cpu", torch.device("cpu")), ("card_again", cuda)):
            model = RqVae(cfg, device=dev, seed=4)
            step = make_rqvae_train_step(model, adamw(model.parameters(), 1e-3))
            m = step(x.to(dev), None, 0.2)
            res[name] = (m["total_loss"].item(), {n: p.grad.cpu() for n, p in model.named_parameters()})
        assert res["card"][0] == pytest.approx(res["cpu"][0], rel=1e-5)
        for n, want in res["cpu"][1].items():
            assert (res["card"][1][n] - want).abs().max() <= 2e-4 * want.abs().max(), n
            assert torch.equal(res["card"][1][n], res["card_again"][1][n]), n


ML1M_VAE = dict(input_dim=786, embed_dim=32, hidden_dims=(512, 256, 128), codebook_size=256, n_layers=3)


def _route(fields, precision):
    from rqvae_tpu_torch.ops.cuda.rq_encode import rq_encode_route

    dims = (fields["input_dim"], *fields["hidden_dims"], fields["embed_dim"])
    return rq_encode_route(dims, fields["codebook_size"], fields["embed_dim"], precision)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_rq_encode_at_the_ml1m_width(cuda, precision):
    """786 inputs (configs/rqvae_ml1m.gin), which the wrapper refused: both
    precisions compute, equal to the plain version outside near-ties, and the
    tokenizer's index build runs the kernel."""
    rq, x = _rqvae(ML1M_VAE, 3883, cuda)  # ML-1M's movie count
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    assert _route(ML1M_VAE, precision) == ("tensor_cores" if precision == "bf16" else "cuda_cores")
    got = fused_encode_quantize(x, w, cb, 3, precision=precision)
    want = fused_encode_quantize_plain(x, w, cb, 3, precision=precision)
    near = bf16_near_tie_rows(x, w, cb) if precision == "bf16" else _near_ties(x, w, cb)
    assert not ((got != want).any(1) & ~near).any()
    before = fused_encode_quantize.launches
    cached = SemanticIdTokenizer(rq, device=cuda, precision=precision).precompute_corpus_ids(x)
    assert fused_encode_quantize.launches == before + 1 and torch.equal(cached[:, :3], got)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 87585])
def test_rq_encode_at_tile_boundaries(cuda, precision, n):
    """Row counts around the 64-row block of both routes, and ML-32M's 87,585
    (a ragged last tile of 33 rows): the route by precision, ids equal to the
    plain version's outside near-ties, and rows past n never written."""
    from rqvae_tpu_torch.ops.cuda.rq_encode import ROWS_PER_BLOCK

    assert ROWS_PER_BLOCK == 64
    rq, x = _rqvae(ML32M_VAE, max(n, 1024), cuda, seed=3)
    x = x[:n]
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    assert _route(ML32M_VAE, precision) == ("tensor_cores" if precision == "bf16" else "cuda_cores")
    got = fused_encode_quantize(x, w, cb, 3, precision=precision)
    assert got.shape == (n, 3) and got.dtype == torch.int32
    want = fused_encode_quantize_plain(x, w, cb, 3, precision=precision)
    near = bf16_near_tie_rows(x, w, cb) if precision == "bf16" else _near_ties(x, w, cb)
    assert not ((got != want).any(1) & ~near).any()
    assert int(got.min()) >= 0 and int(got.max()) < 256


@pytest.mark.parametrize("seed", [0, 2])
def test_rq_encode_tensor_cores_integer_inputs_bit_equal(cuda, seed):
    """The integer case at the Amazon widths, on the tensor-core route: every
    float32 sum is exact, so the ids equal the plain version's on every row."""
    x, weights, cbs = integer_bf16_case_wide(seed)
    assert _route(AMAZON_VAE, "bf16") == "tensor_cores"
    got = fused_encode_quantize(x.to(cuda), [w.to(cuda) for w in weights], cbs.to(cuda), 3, precision="bf16")
    assert torch.equal(got.cpu(), fused_encode_quantize_plain(x, weights, cbs, 3, precision="bf16"))


@pytest.mark.parametrize("fields,precision", [(AMAZON_VAE, "bf16"), (AMAZON_VAE, "f32"), (ML1M_VAE, "bf16"),
                                              (SMALL_VAE, "bf16")])
def test_rq_encode_repeats_bit_equal_on_each_route(cuda, fields, precision):
    rq, x = _rqvae(fields, 5000, cuda, seed=4)
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    runs = [fused_encode_quantize(x, w, cb, fields["n_layers"], precision=precision) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_rq_encode_shared_memory_matches_the_library(cuda):
    """The Python estimate of each route's shared memory is the C library's,
    at every shipped stage-1 width and at a few others."""
    import ctypes
    import glob

    from rqvae_tpu_torch.ops.cuda import rq_encode as R
    from rqvae_tpu_torch.utils.config import parse_config_file

    lib = R._library()
    assert lib.rq_encode_rows_per_block() == R.ROWS_PER_BLOCK
    shapes = []
    for path in glob.glob("configs/rqvae_*.gin"):
        cfg = parse_config_file(path)
        shapes.append(((cfg["vae_input_dim"], *cfg["vae_hidden_dims"], cfg["vae_embed_dim"]), cfg["vae_codebook_size"]))
    shapes += [((40, 24, 8), 16), ((100, 64), 512), ((2048, 512, 16), 64)]
    for dims, K in shapes:
        widths, kp = R.prepared_widths(dims, K)
        c_dims = (ctypes.c_int * len(widths))(*widths)
        for code, route in enumerate(R.ROUTES):
            assert lib.rq_encode_smem_bytes(c_dims, len(widths) - 1, kp, code) == R.rq_encode_smem_bytes(
                widths, kp, route), (dims, K, route)


def test_rq_encode_library_refuses_a_route_that_does_not_take_the_shape(cuda, monkeypatch):
    """The library launches the route it is given or refuses: float32 sent to
    the tensor-core route raises, and nothing falls back."""
    from rqvae_tpu_torch.ops.cuda import rq_encode as R

    rq, x = _rqvae(AMAZON_VAE, 256, cuda)
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    monkeypatch.setattr(R, "rq_encode_route", lambda *a: "tensor_cores")
    with pytest.raises(RuntimeError, match="rq_encode"):
        fused_encode_quantize(x, w, cb, 3, precision="f32")
    with pytest.raises(ValueError, match="up to 512"):
        fused_encode_quantize(x, [torch.randn(768, 1024, device=cuda), torch.randn(1024, 32, device=cuda)], cb, 3)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("fields,n", [(SMALL_VAE, 1000), (AMAZON_VAE, 4099)])
def test_rq_encode_emit_packed(cuda, fields, n, precision):
    """The packed key column of the kernel's epilogue: ids equal to an
    unpacked launch's, the key equal to pack_sem_id_tuples of them."""
    from rqvae_tpu_torch.ops.dedup import pack_sem_id_tuples

    rq, x = _rqvae(fields, n, cuda)
    w, cb = rq.encoder.kernels(), rq.codebooks.detach()
    ids = fused_encode_quantize(x, w, cb, 3, precision=precision)
    packed = fused_encode_quantize(x, w, cb, 3, precision=precision, emit_packed=True)
    torch.cuda.synchronize()
    assert packed.shape == (n, 4)
    assert torch.equal(packed[:, :3], ids)
    assert torch.equal(packed[:, 3], pack_sem_id_tuples(ids, fields["codebook_size"]))


def _small_serving(cuda, n_items=600):
    rq, x = _rqvae(SMALL_VAE, n_items, cuda, seed=1)
    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=32, t5_d_kv=8, t5_num_heads=4,
                          t5_d_ff=64, t5_num_layers=2, top_k_for_generation=5)
    model = EncoderDecoderRetrievalModel(cfg, device=cuda, seed=3)
    return rq, x, model


def _retriever(rq, model, x, cuda, capacity=None):
    tok = SemanticIdTokenizer(rq, device=cuda)
    tok.precompute_corpus_ids(x)
    return Retriever(model, tok, device=cuda, capacity=capacity)


def test_engine_replay_equals_eager_in_every_bucket(cuda):
    """One CUDA graph per bucket: each replay gives the eager retrieve's
    item ids and log-probas bit for bit (short rows: the decoder kernel;
    128 items, 512 encoder rows: the encoder-stack kernel)."""
    from rqvae_tpu_torch.serving.engine import RetrievalEngine

    rq, x, model = _small_serving(cuda)
    r = _retriever(rq, model, x, cuda)
    eng = RetrievalEngine(r, max_items=128, item_buckets=(8, 20, 128), batch_buckets=(1, 4, 16))
    assert eng.warmup() == 9 and len(eng.graphs) == 9
    rng = np.random.RandomState(0)
    for (bb, ib) in eng.graphs:
        hist = rng.randint(0, 600, (bb, ib)).astype(np.int32)
        hist[:, rng.randint(1, ib + 1):] = -1
        eager = r.retrieve(hist)
        flight = eng._replay(hist, np.zeros(bb, np.int32))
        flight.event.synchronize()
        for got, want in zip(flight.host, eager):
            assert torch.equal(got, want.cpu()), (bb, ib)
    reqs = [rng.randint(0, 600, rng.randint(1, 140)) for _ in range(40)]
    got = eng.retrieve_many(reqs)
    want = RetrievalEngine(r, max_items=128, item_buckets=(8, 20, 128), batch_buckets=(1, 4, 16),
                           cuda_graphs=False).retrieve_many(reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_engine_replays_serve_the_grown_corpus(cuda):
    """extend_corpus after capture: the captured graphs read the grown state
    (updated in place) and return what a fresh engine over the whole corpus
    returns, new items included."""
    from rqvae_tpu_torch.serving.engine import RetrievalEngine

    rq, x, model = _small_serving(cuda, n_items=800)
    grown = _retriever(rq, model, x[:500], cuda, capacity=800)
    eng = RetrievalEngine(grown, max_items=8, batch_buckets=(64,))
    eng.warmup()
    ptrs = [t.data_ptr() for t in grown.corpus_tensors()]
    assert grown.extend_corpus(x[500:]) == 800
    assert [t.data_ptr() for t in grown.corpus_tensors()] == ptrs
    full = _retriever(rq, model, x, cuda)
    assert torch.equal(grown.tokenizer.cached_ids, full.tokenizer.cached_ids)
    reqs = list(np.random.RandomState(1).randint(500, 800, (64, 6)))
    got = eng.retrieve_many(reqs)
    want = RetrievalEngine(full, max_items=8, batch_buckets=(64,), cuda_graphs=False).retrieve_many(reqs)
    np.testing.assert_array_equal(got.item_ids, want.item_ids)
    np.testing.assert_array_equal(got.log_probas, want.log_probas)
    assert (got.item_ids >= 500).any()


def test_engine_capture_failure_raises(cuda, monkeypatch):
    """No eager fallback on the card: a body that reads the device from the
    host cannot be captured, and the engine says so."""
    from rqvae_tpu_torch.serving.engine import RetrievalEngine

    rq, x, model = _small_serving(cuda)
    r = _retriever(rq, model, x, cuda)
    body = r.shard_body

    def host_read(i, hist, uids, noise=None):
        out = body(i, hist, uids, noise)
        out.item_ids.sum().item()  # a host read: illegal while capturing
        return out

    monkeypatch.setattr(r, "shard_body", host_read)
    eng = RetrievalEngine(r, max_items=8, batch_buckets=(4,))
    with pytest.raises(RuntimeError, match="capture"):
        eng.retrieve_many([np.arange(5)])
    torch.rand(4, device=cuda)  # the failed capture left the device's generator usable


# ---- kernels 4 and 5 with the seed in device memory; step graphs ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [80, 300])
def test_attention_kernels_read_a_device_seed(cuda, dtype, L):
    """The seed as a 1-element int32 tensor on the card (a view into a seed
    row, as the model passes it): forward and backward equal their plain
    versions with the same tensor, for a seed below and one at or above 2^31;
    another seed gives other outputs; the kernels read the seed when they run
    (a graph captured with one seed and replayed after the buffer changed
    gives the new seed's output)."""
    q, k, v, bias, mask = _attention_inputs(3, 2, L, L, 64, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(dtype).to(cuda)
    tol, gtol, dbias_tol = (2e-5, 4e-6, 4e-6) if dtype == torch.float32 else (3.2e-2, 2.0 ** -7, 1e-4)
    row = torch.tensor([5, 11, -(2**31) + 7, -3], dtype=torch.int32, device=cuda)  # -3: 2^32 - 3
    for seed in (row[1:2], row[2:3]):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        out = t5_attention(*leaves, mask, seed, dropout_rate=0.1)
        out.backward(do)
        want = t5_attention_plain(q, k, v, bias, mask, seed, dropout_rate=0.1)
        assert (out.detach().float() - want.float()).abs().max() <= tol
        plain = t5_attention_backward_plain(q, k, v, bias, mask, seed, do, dropout_rate=0.1)
        for i, (leaf, w) in enumerate(zip(leaves, plain)):
            rel = dbias_tol if i == 3 else gtol
            assert (leaf.grad.float() - w.float()).abs().max() <= rel * w.float().abs().max(), i
    assert not torch.equal(t5_attention(q, k, v, bias, mask, row[1:2], dropout_rate=0.1),
                           t5_attention(q, k, v, bias, mask, row[0:1], dropout_rate=0.1))
    buf = row[3:4].clone()
    with torch.no_grad():
        t5_attention(q, k, v, bias, mask, buf, dropout_rate=0.1)  # loads and sets up the kernel
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = t5_attention(q, k, v, bias, mask, buf, dropout_rate=0.1)
        buf.copy_(row[2:3])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, t5_attention(q, k, v, bias, mask, row[2:3], dropout_rate=0.1))


def _small_store(device, rows=48, T=14, n_items=40, K=16):
    r = np.random.RandomState(0)
    seq_items = r.randint(0, n_items, (rows, T)).astype(np.int64)
    seq_lengths = r.randint(5, T + 1, rows).astype(np.int64)
    seq_items[np.arange(T)[None, :] >= seq_lengths[:, None]] = -1
    cached = r.randint(0, K, (n_items, 4)).astype(np.int32)
    cached[:, -1] = 0
    return [torch.as_tensor(a, device=device) for a in (seq_items, seq_lengths, np.arange(rows), cached)]


@pytest.mark.parametrize("dtype,accum", [("bfloat16", 1), ("float32", 2)])
def test_stage2_graph_chunk_equals_eager_steps(cuda, dtype, accum):
    """6 stage-2 steps at small widths with dropout 0.1 (kernels 4 and 5 in
    the graph), eagerly one by one against 2 chunks of 3 replays of the
    step's CUDA graph, from one state: parameters, moments and the chunk
    means bit-equal; the replays do not tick the wrappers' counters."""
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=64, t5_d_kv=64, t5_num_heads=2,
                          t5_d_ff=128, t5_num_layers=2, t5_dropout=0.1, t5_dtype=dtype)
    store = _small_store(cuda)
    runs = {}
    for name, n_steps in (("eager", 1), ("graph", 3)):
        model = EncoderDecoderRetrievalModel(cfg, device=cuda, seed=2)
        opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=1.0)
        step = make_decoder_graph_train_step(model, opt, max_seq_len=6, n_steps=n_steps, batch_size=8, accum=accum)
        draws = [step.draws(3, s, 48) for s in range(6)]
        before = t5_attention.launches
        means = [step(*store, draws[i:i + n_steps]) for i in range(0, 6, n_steps)]
        runs[name] = (model, opt, means, t5_attention.launches - before, step)
    (me, oe, eager, _, _), (mg, og, chunks, launched, gstep) = runs["eager"], runs["graph"]
    assert gstep.chunks.graph is not None and gstep.chunks.replays == 6
    assert launched == 2 * 2 * accum  # the capture's eager run and the capture itself; replays tick nothing
    for (n, a), b in zip(me.named_parameters(), mg.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(oe.mu + oe.nu, og.mu + og.nu):
        assert torch.equal(a, b)
    for c, chunk in enumerate(chunks):
        for key, v in chunk.items():
            total = torch.zeros_like(v)
            for m in eager[3 * c:3 * c + 3]:
                total = total + m[key]
            assert torch.equal(v, total / 3), key


def test_stage1_graph_chunk_equals_eager_steps(cuda):
    """Stage 1, Gumbel mode with the anneal on the device and 2 micro-batches:
    6 eager steps against 2 chunks of 3 replays, bit-equal."""
    import functools

    from rqvae_tpu_torch.ops.schedules import gumbel_temperature_at
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    cfg = RqVaeConfig(**SMALL_VAE, codebook_mode=QuantizeForwardMode.GUMBEL_SOFTMAX)
    x = torch.randn(256, 32, generator=torch.Generator().manual_seed(1)).to(cuda)
    t_fn = functools.partial(gumbel_temperature_at, t0=1.0, min_t=0.1, anneal_rate=0.05, step_size=2)
    runs = {}
    for name, n_steps in (("eager", 1), ("graph", 3)):
        model = RqVae(cfg, device=cuda, seed=4)
        opt = adamw(model.parameters(), 1e-3, weight_decay=0.01)
        step = make_rqvae_graph_train_step(model, opt, n_steps=n_steps, accum=2, batch_size=32, t_fn=t_fn)
        draws = [step.draws(5, s, 256) for s in range(6)]
        runs[name] = (model, opt, [step(x, draws[i:i + n_steps]) for i in range(0, 6, n_steps)])
    (me, oe, eager), (mg, og, chunks) = runs["eager"], runs["graph"]
    for (n, a), b in zip(me.named_parameters(), mg.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(oe.mu + oe.nu, og.mu + og.nu):
        assert torch.equal(a, b)
    total = eager[3]["total_loss"] + eager[4]["total_loss"] + eager[5]["total_loss"]
    assert torch.equal(chunks[1]["total_loss"], (torch.zeros_like(total) + eager[3]["total_loss"]
                                                 + eager[4]["total_loss"] + eager[5]["total_loss"]) / 3)


def test_step_graph_capture_failure_raises(cuda, monkeypatch):
    """No eager fallback on the card: a step body that reads the device from
    the host cannot be captured, and the chunk says so."""
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    model = RqVae(RqVaeConfig(**SMALL_VAE, codebook_mode=QuantizeForwardMode.STE), device=cuda, seed=0)
    step = make_rqvae_graph_train_step(model, adamw(model.parameters(), 1e-3), n_steps=2, accum=1, batch_size=16)
    body = step.chunks.body

    def host_read(**draws):
        out = body(**draws)
        out["total_loss"].item()  # a host read: illegal while capturing
        return out

    monkeypatch.setattr(step.chunks, "body", host_read)
    x = torch.randn(64, 32, device=cuda)
    with pytest.raises(RuntimeError, match="capture"):
        step(x, [step.draws(0, s, 64) for s in range(2)])
    torch.rand(4, device=cuda)  # the failed capture left the device's generator usable


# ---- amp: bf16 operands with float32 sums (ops/amp.py) ----

AMP_CASES = [((640, 80, 384), (1024, 384), True), ((640, 768), (512, 768), False), ((96, 40), (24, 40), True)]


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("x_shape,w_shape,x_grad", AMP_CASES)
def test_amp_linear_matches_f32_products_of_bf16_operands(cuda, x_shape, w_shape, x_grad):
    """amp.linear on the card (torch.mm with out_dtype=float32 on bf16
    operands, backward written out): forward, dx and dW against float32
    products of the bf16-rounded operands (TF32 off), within 1e-5 of the
    tensor's largest entry for the forward and dx (sums of up to 1,024 terms
    in another order) and 1e-4 for dW (sums over all 51,200 rows); 3 products
    (2 when x needs no gradient); reduced-precision reduction off inside the
    flag and restored after."""
    from rqvae_tpu_torch.ops import amp

    g = torch.Generator().manual_seed(7)
    x = torch.randn(x_shape, generator=g).to(cuda).requires_grad_(x_grad)
    w = (torch.randn(w_shape, generator=g) * 0.05).to(cuda).requires_grad_(True)
    gy = torch.randn(*x_shape[:-1], w_shape[0], generator=g).to(cuda)
    assert not torch.backends.cuda.matmul.allow_tf32
    before = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    n0 = amp.products
    with amp.bf16_products(True):
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        y = amp.linear(x, w)
        y.backward(gy)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == before
    assert amp.products - n0 == (3 if x_grad else 2) and y.dtype == torch.float32
    xb, wb, gb = (t.detach().to(torch.bfloat16).float() for t in (x, w, gy))
    assert _rel_err(y, xb @ wb.t()) <= 1e-5
    assert _rel_err(w.grad, gb.reshape(-1, w_shape[0]).t() @ xb.reshape(-1, w_shape[1])) <= 1e-4
    if x_grad:
        assert _rel_err(x.grad, gb @ wb) <= 1e-5
    else:
        assert x.grad is None
    assert _rel_err(y, x.detach() @ w.detach().t()) > 1e-4  # the operands were rounded: not the float32 product


def test_amp_batched_heads_match_f32_products_of_bf16_operands(cuda):
    from rqvae_tpu_torch.ops import amp

    g = torch.Generator().manual_seed(8)
    a = torch.randn(3, 640, 384, generator=g).to(cuda).requires_grad_(True)
    b = (torch.randn(3, 384, 256, generator=g) * 0.05).to(cuda).requires_grad_(True)
    gy = torch.randn(3, 640, 256, generator=g).to(cuda)
    with amp.bf16_products(True):
        y = amp.matmul(a, b)
        y.backward(gy)
    ab, bb, gb = (t.detach().to(torch.bfloat16).float() for t in (a, b, gy))
    assert _rel_err(y, ab @ bb) <= 1e-5
    assert _rel_err(a.grad, gb @ bb.transpose(1, 2)) <= 1e-5
    assert _rel_err(b.grad, ab.transpose(1, 2) @ gb) <= 1e-4


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_amp_graph_chunk_equals_eager_steps(cuda, stage):
    """amp=True inside the step graph: 6 steps one by one against 2 chunks of
    3 replays, bit-equal (more than one step, so a bf16 copy of the weights
    kept across updates would show), and the steps differ from the float32
    route's (the products took the bf16 route)."""
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    store = _small_store(cuda)
    x = torch.randn(256, 32, generator=torch.Generator().manual_seed(1)).to(cuda)

    def run(n_steps, amp):
        if stage == "stage2":
            cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=64, t5_d_kv=64, t5_num_heads=2,
                                  t5_d_ff=128, t5_num_layers=2, t5_dropout=0.1, t5_dtype="float32")
            model = EncoderDecoderRetrievalModel(cfg, device=cuda, seed=2)
            opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=1.0)
            step = make_decoder_graph_train_step(model, opt, max_seq_len=6, n_steps=n_steps, batch_size=8, amp=amp)
            draws = [step.draws(3, s, 48) for s in range(6)]
            means = [step(*store, draws[i:i + n_steps]) for i in range(0, 6, n_steps)]
        else:
            model = RqVae(RqVaeConfig(**SMALL_VAE, codebook_mode=QuantizeForwardMode.STE), device=cuda, seed=4)
            opt = adamw(model.parameters(), 1e-3, weight_decay=0.01)
            step = make_rqvae_graph_train_step(model, opt, n_steps=n_steps, accum=1, batch_size=32, amp=amp)
            draws = [step.draws(5, s, 256) for s in range(6)]
            means = [step(x, draws[i:i + n_steps]) for i in range(0, 6, n_steps)]
        return model, opt, means

    me, oe, _ = run(1, True)
    mg, og, _ = run(3, True)
    mf, _, _ = run(3, False)
    for (n, a), b in zip(me.named_parameters(), mg.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(oe.mu + oe.nu, og.mu + og.nu):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(mg.parameters(), mf.parameters()))


def test_a_dead_step_graph_does_not_break_a_later_capture(cuda):
    """A step runner whose graph is left in a dead reference cycle (the
    runner closes over itself) must not be destroyed during a later capture:
    with the collector made to run on almost every allocation, a second
    runner still captures and replays."""
    import gc

    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    x = torch.randn(128, 32, generator=torch.Generator().manual_seed(2)).to(cuda)

    def runner():
        model = RqVae(RqVaeConfig(**SMALL_VAE, codebook_mode=QuantizeForwardMode.STE), device=cuda, seed=0)
        step = make_rqvae_graph_train_step(model, adamw(model.parameters(), 1e-3), n_steps=2, accum=1,
                                           batch_size=16)
        step.cycle = step  # the dead cycle
        return step

    first = runner()
    first(x, [first.draws(0, s, 128) for s in range(2)])
    assert first.chunks.graph is not None
    del first
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        second = runner()
        metrics = second(x, [second.draws(0, s, 128) for s in range(2)])
    finally:
        gc.set_threshold(*thresholds)
    assert second.chunks.replays == 2 and bool(torch.isfinite(metrics["total_loss"]))


@pytest.mark.parametrize("dtype,L", [(torch.bfloat16, 80), (torch.bfloat16, 800), (torch.float32, 80)])
def test_attention_kernels_count_dropout_from_b0(cuda, dtype, L):
    """Kernels 4 and 5 launched with b0 = B (a data-parallel rank's first
    global row): the output and dq, dk, dv are bit-equal to rows B .. 2B - 1
    of the launches over the batch doubled at b0 = 0, within the attention
    tolerances of the plain versions at b0 = B, and other than at b0 = 0."""
    B, H = 3, 2
    q, k, v, bias, mask = _attention_inputs(B, H, L, L, 64, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(dtype).to(cuda)
    seed = torch.tensor([77], dtype=torch.int32, device=cuda)
    tol, gtol, dbias_tol = (2e-5, 4e-6, 4e-6) if dtype == torch.float32 else (3.2e-2, 2.0 ** -7, 1e-4)

    def run(b0, *ops):
        leaves = [t.detach().clone().requires_grad_() for t in ops[:3]] + [bias.detach().clone().requires_grad_()]
        out = t5_attention(*leaves, ops[3], seed, dropout_rate=0.1, b0=b0)
        out.backward(ops[4])
        return out.detach(), [leaf.grad for leaf in leaves]

    out, grads = run(B, q, k, v, mask, do)
    whole, whole_grads = run(0, *(torch.cat([t, t]) for t in (q, k, v, mask, do)))
    assert torch.equal(out, whole[B:])
    for g, w in zip(grads[:3], whole_grads[:3]):
        assert torch.equal(g, w[B:])
    assert not torch.equal(out, run(0, q, k, v, mask, do)[0])
    want = t5_attention_plain(q, k, v, bias, mask, seed, dropout_rate=0.1, b0=B)
    assert (out.float() - want.float()).abs().max() <= tol
    plain = t5_attention_backward_plain(q, k, v, bias, mask, seed, do, dropout_rate=0.1, b0=B)
    for i, (g, w) in enumerate(zip(grads, plain)):
        assert (g.float() - w.float()).abs().max() <= (dbias_tol if i == 3 else gtol) * w.float().abs().max(), i


def test_nccl_world_of_one_step_graph_equals_the_plain_graph_step(cuda):
    """A process group of one rank over NCCL: the data-parallel stage-2
    step's chunks (graphs of 3 steps, the all-reduce and the quantiles'
    all-gather captured with it) equal, bit for bit, the same chunks without
    a group (a sum over one rank divided by 1)."""
    import torch.distributed as tdist

    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.parallel.dist import Replicas
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.state import adamw
    from torch_dist_worker import free_port

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=64, t5_d_kv=64, t5_num_heads=2,
                          t5_d_ff=128, t5_num_layers=2, t5_dropout=0.1, t5_dtype="bfloat16")
    store = _small_store(dev)
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                             device_id=dev)
    try:
        runs = []
        for replicas in (Replicas(0, 1, "nccl"), None):
            model = EncoderDecoderRetrievalModel(cfg, device=dev, seed=2)
            opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=1.0)
            step = make_decoder_graph_train_step(model, opt, max_seq_len=6, n_steps=3, batch_size=8,
                                                 replicas=replicas)
            draws = [step.draws(3, s, 48) for s in range(6)]
            means = [step(*store, draws[i:i + 3]) for i in (0, 3)]
            assert step.chunks.graph is not None and step.chunks.replays == 6
            runs.append((model, means))
    finally:
        tdist.destroy_process_group()
    (ma, a), (mb, b) = runs
    for (n, x), y in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(x, y), n
    for ca, cb in zip(a, b):
        assert all(torch.equal(ca[k], cb[k]) for k in ca)


def test_sharded_serving_over_two_cards(cuda):
    """A mesh of [cuda:0, cuda:1]: the index build runs kernel 1 on each card
    and equals the unsharded build; the Retriever's shards run on their cards
    (a model and corpus copy on cuda:1) and give the unsharded beams."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from rqvae_tpu_torch.parallel.mesh import make_mesh

    rq, x, model = _small_serving(cuda)
    mesh = make_mesh(devices=["cuda:0", "cuda:1"])
    plain = _retriever(rq, model, x, cuda)
    tok = SemanticIdTokenizer(rq, mesh=mesh)
    assert torch.equal(tok.precompute_corpus_ids(x), plain.tokenizer.cached_ids)
    r = Retriever(model, tok, mesh=mesh)
    assert [s.table.device for s in r.shards] == [torch.device("cuda:0"), torch.device("cuda:1")]
    hist = np.random.RandomState(0).randint(0, 600, (6, 12)).astype(np.int32)
    got, want = r.retrieve(hist), plain.retrieve(hist)
    assert torch.equal(got.item_ids, want.item_ids) and torch.equal(got.sem_ids, want.sem_ids)


def test_two_ranks_over_nccl_hold_the_all_reduce_in_their_step_graphs(cuda, tmp_path):
    """Two processes on two cards (NCCL), stage-2 chunks of 3 replays of
    the data-parallel step's graph, f32 with dropout 0.1: the all-reduce is
    an NCCL kernel among the graph's nodes, the ranks end bit-equal, and
    they follow one process on the whole batch: losses rtol 1e-5; all but
    1% of the parameters within 1e-5, and every one within the peak LR
    (1e-3, one AdamW step's size). The sums are taken in another order, and
    Adam's normalised update turns a last-bit difference in a gradient near
    0 into a step of up to the LR whatever the gradient's size (measured on
    two H100s: 0.2-0.8% of a tensor's entries apart, by up to 5.7e-4)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import json

    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.state import adamw
    from torch_dist_worker import launch

    cfg = dict(num_hierarchies=3, codebook_size=16, t5_d_model=64, t5_d_kv=64, t5_num_heads=2, t5_d_ff=128,
               t5_num_layers=2, t5_dropout=0.1, t5_dtype="float32")
    spec = {"out": str(tmp_path), "device": "cuda", "scenarios": [dict(
        kind="decoder_graph", name="graph", device="cuda", config=cfg, n_steps=3, steps=6, batch=8,
        opt=dict(lr=1e-3, warmup=2, wd=0.1, max_grad_norm=1.0))]}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    lines = launch(2, str(tmp_path / "spec.json"), timeout=300)
    assert [line["backend"] for line in lines] == ["nccl", "nccl"]
    a, b = (torch.load(tmp_path / f"graph.rank{r}.pt") for r in range(2))
    assert any("nccl" in name.lower() for name in a["graph_kernels"]), a["graph_kernels"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    dev = torch.device("cuda", torch.cuda.current_device())
    model = EncoderDecoderRetrievalModel(RetrievalConfig(**cfg), device=dev, seed=2)
    opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=1.0)
    step = make_decoder_graph_train_step(model, opt, max_seq_len=6, n_steps=3, batch_size=8)
    draws = [step.draws(3, s, 48) for s in range(6)]
    store = _small_store(dev)
    means = [step(*store, draws[i:i + 3]) for i in (0, 3)]
    got, want = ([m["total_loss"].item() for m in ms] for ms in (a["metrics"], means))
    diffs = torch.cat([(a["params"][k] - p.cpu()).abs().flatten() for k, p in model.state_dict().items()])
    print(json.dumps({"losses_two_ranks": got, "losses_one_process": want,
                      "params_share_above_1e-5": float((diffs > 1e-5).float().mean()),
                      "params_max_abs_diff": float(diffs.max())}))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float((diffs > 1e-5).float().mean()) < 0.01 and float(diffs.max()) <= 1e-3
