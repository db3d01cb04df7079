"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA card, with the path tests:
    python -m pytest --noconftest -m gpu -q tests/test_torch_kernels_gpu.py tests/test_torch_paths_gpu.py
Without a card every test here skips (the check is in the fixture).
Tolerances: rq_encode ids identical except rows at an argmin near-tie;
decoder_stack max abs error 1e-3 in f32; in bf16 kernel and plain version
are each held to a float64 evaluation of the same operands, and the kernel
may lie no farther from it than the plain version does (a bf16 rounding
flipped by f32 summation order carries through the residual stream, so
their difference is no measure of either); attention 2e-5 in f32 and
3.2e-2 in bf16 (one bf16 step, 2^-5, of an output between 4 and 8 whose
f32 sum lands across a rounding boundary); encoder_stack
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

import gc
import math

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
from torch_gpu_common import cuda  # noqa: F401 (the fixture)
from torch_gpu_common import (AMAZON, gin_rqvae, item_corpus, make_rqvae, retrieval_model, seed_codebooks,
                              write_training_inputs)

pytestmark = pytest.mark.gpu

SMALL_VAE = dict(input_dim=32, embed_dim=8, hidden_dims=(24, 16), codebook_size=16, n_layers=3)
AMAZON_VAE = dict(input_dim=768, embed_dim=32, hidden_dims=(512, 256, 128), codebook_size=256, n_layers=3)
ML32M_VAE = dict(input_dim=788, embed_dim=64, hidden_dims=(512, 256, 128), codebook_size=256, n_layers=3)
ODD_VAE = dict(input_dim=40, embed_dim=8, hidden_dims=(24,), codebook_size=16, n_layers=2)  # 2 products
SMALL_T5 = dict(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)
AMAZON_T5 = dict(d_model=384, d_kv=64, num_heads=6, d_ff=1024, num_layers=4)
SYNTHETIC_T5 = dict(d_model=64, d_kv=64, num_heads=4, d_ff=128, num_layers=2)  # configs/decoder_synthetic.gin


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


def decoder_stack_f64(ops, eps):
    """The decoder stack of `ops` (t5_decoder_stack_infer's operands) in
    float64 with no rounding between its steps: the value that the kernel
    and its plain version each approximate in their own order of roundings."""
    x, wq, wk, wv, wo, cq, co, wi, wo2, ln_s, ln_c, ln_f, ln_final, bias_fold, kc, vc, mask = (t.double() for t in ops)

    def rms(t, w):
        return t * torch.rsqrt(torch.mean(t * t, dim=-1, keepdim=True) + eps) * w

    for layer in range(wq.shape[0]):
        xn, attn = rms(x, ln_s[layer]), torch.zeros_like(x)
        for h in range(wq.shape[1]):
            q, k, v = xn @ wq[layer, h], xn @ wk[layer, h], xn @ wv[layer, h]
            attn = attn + torch.softmax(q @ k.transpose(-1, -2) + bias_fold[h], dim=-1) @ v @ wo[layer, h]
        x = x + attn
        xn, catt = rms(x, ln_c[layer]), torch.zeros_like(x)
        for h in range(wq.shape[1]):
            s = xn @ cq[layer, h] @ kc[layer, :, h].transpose(-1, -2) + mask[:, None, :]
            catt = catt + torch.softmax(s, dim=-1) @ vc[layer, :, h] @ co[layer, h]
        x = x + catt
        x = x + torch.relu(rms(x, ln_f[layer]) @ wi[layer]) @ wo2[layer]
    return rms(x, ln_final)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "t5_fields,beams,T,B,Le",
    [(SMALL_T5, 3, 2, 5, 7), (SMALL_T5, 1, 1, 3, 4), (AMAZON_T5, 1, 1, 64, 80),
     (AMAZON_T5, 10, 2, 64, 80), (AMAZON_T5, 10, 3, 64, 80),
     # the bf16 tensor-core route's edges: odd B, kT = 32 and 17, Le = 128 and 33, narrow widths
     (AMAZON_T5, 10, 3, 7, 80), (AMAZON_T5, 4, 8, 3, 33), (AMAZON_T5, 1, 17, 2, 128), (AMAZON_T5, 1, 1, 5, 1),
     (SYNTHETIC_T5, 3, 2, 4, 12),
     # the full evaluation's batch of 640 at the last beam level
     (AMAZON_T5, 10, 3, 640, 80)],
)
def test_decoder_stack_kernel_matches_plain(cuda, dtype, t5_fields, beams, T, B, Le):
    """f32: max abs error 1e-3. bf16: against a float64 evaluation of the same
    operands the kernel lies no farther than the plain version does, by one
    bf16 step at the output's largest magnitude in the max abs error and by
    2% in the mean."""
    ops, eps = _decoder_operands(t5_fields, dtype, beams, T, B, Le, cuda)
    before = t5_decoder_stack_infer.launches
    got = t5_decoder_stack_infer(*ops, eps=eps)
    torch.cuda.synchronize()
    assert t5_decoder_stack_infer.launches == before + 1
    want = t5_decoder_stack_plain(*ops, eps=eps)
    assert torch.isfinite(got).all()
    if dtype == "float32":
        assert (got - want).abs().max().item() <= 1e-3
        return
    exact = decoder_stack_f64(ops, eps)
    step = 2.0 ** (math.floor(math.log2(exact.abs().max().item())) - 7)  # one bf16 step there
    k, p = (got.double() - exact).abs(), (want.double() - exact).abs()
    assert k.max().item() <= p.max().item() + step, (k.max().item(), p.max().item(), step)
    assert k.mean().item() <= 1.02 * p.mean().item(), (k.mean().item(), p.mean().item())


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
     (640, 6, 80, 80, 64, False, 0.0), (640, 6, 80, 80, 64, False, 0.1),  # the Amazon training shape
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
    if rate == 0.0 and Lk < 100 and (q[0].float() @ k[0].float().transpose(-1, -2) + bias).abs().max() < 32:
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
     # the training shapes without dropout, and Amazon's causal
     (640, 6, 80, 80, 64, False, 0.0), (64, 6, 800, 800, 64, False, 0.0), (640, 6, 80, 80, 64, True, 0.1),
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,L,blocks", [(3, 64, [(0, 0)]), (3, 80, [(0, 0), (1, 0), (0, 1)]),
                                          (2, 128, [(1, 1), (0, 1)]), (2, 800, [(0, 0), (12, 12), (5, 9), (12, 0)])])
@pytest.mark.parametrize("rate,causal", [(0.0, False), (0.2, True)])
def test_attention_backward_p_equals_forward_p_on_both_routes(cuda, dtype, B, L, blocks, rate, causal):
    """dk = 64 (bf16: whole rows up to 128, key tiles at 800; float32: the CUDA
    cores): with v the identity on keys 64j .. 64j + 63 and dout the identity
    on queries 64i .. 64i + 63, the forward's out[64i:] and the backward's
    dv^T[:, 64j:] are the same 64 x 64 block of the rounded, dropped p: equal
    bits."""
    from rqvae_tpu_torch.ops.cuda import attention as A

    g = torch.Generator().manual_seed(8)
    q, k = (torch.randn(B, 3, L, 64, generator=g).to(dtype).to(cuda) for _ in range(2))
    bias = torch.randn(3, L, L, generator=g).to(cuda)
    mask = (torch.rand(B, L, generator=g) > 0.2).to(torch.int32).to(cuda)

    def block_eye(j):
        e = torch.zeros(L, 64)
        idx = torch.arange(64 * j, min(L, 64 * j + 64))
        e[idx, idx - 64 * j] = 1.0
        return e.to(dtype).to(cuda).expand(B, 3, L, 64).contiguous()

    tiled = A.attention_route(L, L, 64, dtype) == "tiled"
    for i, j in blocks:
        v, do = block_eye(j), block_eye(i)
        out, m, l, bits = A._forward_cuda(q, k, v, bias, mask, 9, causal, rate, True)
        assert (bits is not None) == (tiled and rate > 0)  # the tiled route with dropout keeps its bits
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
    # the forward's keep bits (the tiled route's) are the hash's: the backward that hashes them anew agrees
    hashed = A._backward_cuda(q, k, v, bias, mask, 77, do, m, l, False, 0.1, groups=1)
    assert all(torch.equal(a, b) for a, b in zip(hashed, one))
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
    from rqvae_tpu_torch.ops.hash_dropout import hash_dropout, hash_dropout_plain

    h = torch.randn(40, 24, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16).to(dev)
    assert torch.equal(hash_dropout(h, 77, 0.1), hash_dropout_plain(h, 77, 0.1))
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


def _small_train_step(dev, _):
    """The model's forward with dropout 0.1 and its backward at small widths
    on a hand-made batch of 8 histories."""
    from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch

    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=32, t5_d_kv=8, t5_num_heads=4,
                          t5_d_ff=64, t5_num_layers=2, t5_dropout=0.1)
    r = np.random.RandomState(0)
    B, n = 8, 6
    mask = np.repeat(np.arange(n)[None, :] < r.randint(1, n + 1, B)[:, None], 4, axis=1)
    sem = np.where(mask, r.randint(0, 16, (B, n * 4)), -1)
    fields = dict(user_ids=np.zeros(B, np.int64), sem_ids=sem, sem_ids_fut=r.randint(0, 16, (B, 4)), seq_mask=mask,
                  token_type_ids=np.zeros((B, n * 4), np.int64), token_type_ids_fut=np.zeros((B, 4), np.int64))
    model = EncoderDecoderRetrievalModel(cfg, device=dev, seed=3)
    batch = TokenizedSeqBatch(**{k: torch.as_tensor(v, device=dev) for k, v in fields.items()})
    out = model(batch, training=True, generator=torch.Generator().manual_seed(5))
    out.loss.backward()
    return out.loss.item(), model


def _amazon_train_step(dev, inputs):
    """The stage-2 trainer's first fused step (train/decoder_steps.py::
    make_decoder_fused_train_step, dropout 0.1) at the Amazon T5 on 32 users
    of the synthetic Amazon set, tokenized from the card's index."""
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_fused_train_step
    from rqvae_tpu_torch.train.state import adamw
    from rqvae_tpu_torch.train.train_decoder import step_generator, step_rows

    data, cached, geo = inputs
    model = retrieval_model("float32", dev, t5_dropout=0.1)
    opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 10000), weight_decay=1e-4)
    step = make_decoder_fused_train_step(model, opt, max_seq_len=geo["history"], leave_two_out=True, subsample=True)
    tables = [torch.as_tensor(data[k], device=dev) for k in ("seq_items", "seq_lengths", "user_ids")]
    rows = torch.as_tensor(step_rows(0, 0, geo["users"], 32), device=dev)
    metrics = step(*tables, cached.to(dev), rows, step_generator(0, 0))
    return float(metrics["total_loss"]), model


# (step, gradient tolerance relative to the tensor's largest entry, its floor, kernel 4 launches on the card)
TRAIN_STEP_CASES = {"small": (_small_train_step, 1e-4, 1e-8, 2), "amazon": (_amazon_train_step, 2e-4, 0.0, 4)}


@pytest.mark.parametrize("case", list(TRAIN_STEP_CASES))
def test_train_step_on_card_matches_cpu(cuda, tmp_path, case):
    """One f32 training step with dropout, card (kernels 4 and 5) against CPU
    (plain versions), same weights and seeds: loss rtol 1e-5, every gradient
    within 1e-4 of the tensor's largest entry at small widths, 2e-4 at the
    Amazon T5. The Amazon case's users come from Amazon Beauty's 22,363 and
    its items from 65,536, seeded; both sides tokenize from the card's index,
    as the two devices' indexes differ at argmin near-ties."""
    run, tol, floor, layers = TRAIN_STEP_CASES[case]
    inputs = None
    if case == "amazon":
        geo = dict(AMAZON, users=22363, items=65536)
        rq, x = make_rqvae(geo, cuda)
        _, _, data = write_training_inputs(str(tmp_path), geo, rq, x, seed=12)
        inputs = (data, SemanticIdTokenizer(rq, device=cuda).precompute_corpus_ids(x.to(cuda)).cpu(), geo)
    grads, losses = {}, {}
    before = (t5_attention.launches, t5_attention.backward_launches)
    for dev in ("cpu", cuda):
        losses[str(dev)], model = run(dev, inputs)
        grads[str(dev)] = {n_: p.grad.cpu() for n_, p in model.named_parameters()}
    assert (t5_attention.launches, t5_attention.backward_launches) == (before[0] + layers, before[1] + layers)
    assert losses["cpu"] == pytest.approx(losses[str(cuda)], rel=1e-5)
    for name, g in grads["cpu"].items():
        assert (g - grads[str(cuda)][name]).abs().max() <= tol * g.abs().max() + floor, name


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


SMALL_T5_CFG = dict(t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64, t5_num_layers=2)
AMAZON_T5_CFG = dict(t5_d_model=384, t5_d_kv=64, t5_num_heads=6, t5_d_ff=1024, t5_num_layers=4)  # decoder_amazon.gin
# (RQ-VAE, items, T5, top k, queries x items a history, decoder and encoder kernel launches, log-prob tol)
SERVING_CASES = {
    "small": (SMALL_VAE, 600, dict(codebook_size=16, **SMALL_T5_CFG), 5, (8, 6), (3, 0), 1e-4),
    # the published widths: Amazon's 20-item histories (Le 80: kernel 2), ML-32M's 200 (Le 800: kernel 3)
    "amazon": (AMAZON_VAE, 8192, dict(codebook_size=256, **AMAZON_T5_CFG), 10, (64, 20), (3, 0), None),
    "ml32m": (ML32M_VAE, 8192, dict(codebook_size=256, **AMAZON_T5_CFG), 10, (8, 200), (0, 1), None),
}


@pytest.mark.parametrize("case", list(SERVING_CASES))
def test_retriever_on_card_matches_cpu(cuda, case):
    """End to end in f32: card (kernels) against CPU (plain), each with its own
    index: ids identical except near-ties, all beams identical on >= 95% of
    the queries, and (small) log-probas within 1e-4."""
    vae, n_items, t5, top_k, (Q, n), (dec, enc), logp_tol = SERVING_CASES[case]
    rq, x = _rqvae(vae, n_items, cuda, seed=1)
    tok = SemanticIdTokenizer(rq, device=cuda, precision="f32")  # the CPU's model path is f32
    before = (fused_encode_quantize.launches, t5_decoder_stack_infer.launches, t5_encoder_stack_infer.launches)
    tok.precompute_corpus_ids(x)
    rq_cpu = RqVae(rq.config, device="cpu")
    rq_cpu.load_state_dict({k: v.cpu() for k, v in rq.state_dict().items()})
    tok_cpu = SemanticIdTokenizer(rq_cpu, device="cpu")
    tok_cpu.precompute_corpus_ids(x.cpu())
    near = _near_ties(x, rq.encoder.kernels(), rq.codebooks.detach()).cpu()
    differ = (tok.cached_ids.cpu()[:, :3] != tok_cpu.cached_ids[:, :3]).any(1)
    assert not (differ & ~near).any()

    cfg = RetrievalConfig(num_hierarchies=3, **t5, top_k_for_generation=top_k)
    hist = np.random.RandomState(2).randint(-1, n_items, (Q, n))
    card = Retriever(EncoderDecoderRetrievalModel(cfg, device=cuda, seed=3), tok, device=cuda).retrieve(hist)
    host = Retriever(EncoderDecoderRetrievalModel(cfg, device="cpu", seed=3), tok_cpu, device="cpu").retrieve(hist)
    assert fused_encode_quantize.launches == before[0] + 1
    assert t5_decoder_stack_infer.launches == before[1] + dec and t5_encoder_stack_infer.launches == before[2] + enc
    same = (card.sem_ids.cpu() == host.sem_ids).all(2).all(1).float().mean().item()
    assert same >= 0.95
    if logp_tol is not None:
        torch.testing.assert_close(card.log_probas.cpu(), host.log_probas, rtol=logp_tol, atol=logp_tol)


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


@pytest.mark.parametrize("case", ["small", "configs/rqvae_amazon.gin", "configs/rqvae_ml32m.gin"])
def test_rqvae_train_step_on_card_matches_cpu(cuda, case):
    """One f32 stage-1 step, card against CPU: loss rtol 1e-5, every gradient
    within 2e-4 of its largest entry; a step repeats bit for bit on the card.
    "small": STE and the rotation trick with categorical features, 2
    micro-batches of 64. A config file: its widths, estimator, batch, LR and
    weight decay, codebooks seeded from the data, the batch's rows at an f32
    argmin near-tie left out (there the two devices may pick another
    codeword)."""
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_train_step
    from rqvae_tpu_torch.train.state import adamw

    runs = []  # (model on the CPU, micro-batches, optimizer settings)
    if case == "small":
        for mode, n_cat in ((QuantizeForwardMode.STE, 0), (QuantizeForwardMode.ROTATION_TRICK, 4)):
            g = torch.Generator().manual_seed(3)
            x = torch.randn(2, 64, 32, generator=g)
            if n_cat:
                x[..., -n_cat:] = (x[..., -n_cat:] > 0).float()
            cfg = RqVaeConfig(**{**SMALL_VAE, "n_cat_feats": n_cat}, codebook_mode=mode)
            runs.append((RqVae(cfg, device="cpu", seed=4), x, dict(learning_rate=1e-3)))
    else:
        cfg, st = gin_rqvae(case)
        rq = RqVae(cfg, device="cpu", seed=5)
        x = item_corpus(4096 + 4 * st["batch_size"], cfg, seed=6)
        seed_codebooks(rq, x[:4096], seed=7)
        cand = x[4096:]
        near = _near_ties(cand, rq.encoder.kernels(), rq.codebooks.detach())
        runs.append((rq, cand[~near][None, : st["batch_size"]],
                     dict(learning_rate=st["learning_rate"], weight_decay=st["weight_decay"])))
    for ref, x, opt in runs:
        res = {}
        for name, dev in (("card", cuda), ("cpu", torch.device("cpu")), ("card_again", cuda)):
            model = RqVae(ref.config, device=dev)
            model.load_state_dict(ref.state_dict())
            step = make_rqvae_train_step(model, adamw(model.parameters(), **opt))
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


def _serving_parts(cuda, case="small", n_items=None):
    """A SERVING_CASES row's corpus (`n_items` rows, else the row's), its
    RQ-VAE and a retrieval model: small in f32, the published widths in bf16
    as they are served."""
    vae, n, t5, top_k = SERVING_CASES[case][:4]
    rq, x = _rqvae(vae, n if n_items is None else n_items, cuda, seed=1)
    cfg = RetrievalConfig(num_hierarchies=3, **t5, top_k_for_generation=top_k,
                          t5_dtype="float32" if case == "small" else "bfloat16")
    return rq, x, EncoderDecoderRetrievalModel(cfg, device=cuda, seed=3)


def _retriever(rq, model, x, cuda, capacity=None):
    tok = SemanticIdTokenizer(rq, device=cuda)
    tok.precompute_corpus_ids(x)
    return Retriever(model, tok, device=cuda, capacity=capacity)


def _replays_held(eng, reqs, reference):
    """retrieve_many through the engine's graphs, each bucket it replayed held
    bit for bit against reference.retrieve of the same padded bucket (what an
    eager engine runs). Returns the stacked result and the replays."""
    replay, held = eng._replay, []

    def recording(padded, users):
        flight = replay(padded, users)
        held.append((padded, users, flight))
        return flight

    eng._replay = recording
    try:
        got = eng.retrieve_many(reqs)
    finally:
        del eng._replay
    for padded, users, flight in held:
        for a, b in zip(flight.host, reference.retrieve(padded, users)):
            assert torch.equal(a, b.cpu()), padded.shape
    return got, len(held)


# engine settings and the buckets they make: small widths at hand-picked buckets, the published ones at the defaults
ENGINE_CASES = {"small": (dict(max_items=128, item_buckets=(8, 20, 128), batch_buckets=(1, 4, 16)), 9),
                "amazon": (dict(max_items=20), 12), "ml32m": (dict(max_items=200), 24)}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_replay_equals_eager_in_every_bucket(cuda, case):
    """One CUDA graph per bucket: each replay gives the eager retrieve's
    item ids and log-probas bit for bit (small: short rows take the decoder
    kernel; 128 items, 512 encoder rows, the encoder-stack kernel; Amazon in
    bf16: kernel 2 at every bucket; ML-32M: kernel 3 from 128 items); then
    retrieve_many over mixed lengths, some past max_items: each replayed
    bucket equals the same padded bucket run eagerly."""
    from rqvae_tpu_torch.serving.engine import RetrievalEngine

    kw, n_graphs = ENGINE_CASES[case]
    rq, x, model = _serving_parts(cuda, case)
    n_items = x.shape[0]
    r = _retriever(rq, model, x, cuda)
    eng = RetrievalEngine(r, **kw)
    assert eng.warmup() == n_graphs and len(eng.graphs) == n_graphs
    rng = np.random.RandomState(0)
    for (bb, ib) in eng.graphs:
        hist = rng.randint(0, n_items, (bb, ib)).astype(np.int32)
        hist[:, rng.randint(1, ib + 1):] = -1
        eager = r.retrieve(hist)
        flight = eng._replay(hist, np.zeros(bb, np.int32))
        flight.event.synchronize()
        for got, want in zip(flight.host, eager):
            assert torch.equal(got, want.cpu()), (bb, ib)
    reqs = [rng.randint(0, n_items, rng.randint(1, eng.max_items + 12)) for _ in range(40)]
    got, replays = _replays_held(eng, reqs, r)
    assert replays >= 1 and got.item_ids.shape[0] == 40


@pytest.mark.parametrize("case,n_old,n_new", [("small", 500, 300), ("amazon", 8192, 1024)])
def test_engine_replays_serve_the_grown_corpus(cuda, case, n_old, n_new):
    """extend_corpus after capture, some new items equal to old ones and to
    each other: one kernel-1 launch, no corpus tensor moved, the ids and the
    dedup column those of a rebuild; the captured graphs read the grown state
    (updated in place) and each replayed bucket equals the same padded bucket
    run eagerly over the rebuilt corpus, new items among the results."""
    from rqvae_tpu_torch.serving.engine import RetrievalEngine

    rq, x, model = _serving_parts(cuda, case, n_items=n_old + n_new)
    new = x[n_old:]
    new[:20] = x[:20]  # equal to old items
    new[200:210] = new[50:60]  # equal to earlier new items
    grown = _retriever(rq, model, x[:n_old], cuda, capacity=n_old + n_new)
    eng = RetrievalEngine(grown, max_items=8, batch_buckets=(64,))
    eng.warmup()
    ptrs = [t.data_ptr() for t in grown.corpus_tensors()]
    before = fused_encode_quantize.launches
    assert grown.extend_corpus(new) == n_old + n_new
    assert fused_encode_quantize.launches == before + 1
    assert [t.data_ptr() for t in grown.corpus_tensors()] == ptrs
    full = _retriever(rq, model, x, cuda)
    assert torch.equal(grown.tokenizer.cached_ids, full.tokenizer.cached_ids)
    assert (grown.tokenizer.cached_ids[n_old:n_old + 20, 3] > 0).all()  # the copies of old items count as such
    reqs = list(np.random.RandomState(1).randint(n_old, n_old + n_new, (64, 6)))
    got, _ = _replays_held(eng, reqs, full)
    assert (got.item_ids >= n_old).any()


def test_engine_capture_failure_raises(cuda, monkeypatch):
    """No eager fallback on the card: a body that reads the device from the
    host cannot be captured, and the engine says so."""
    from rqvae_tpu_torch.serving.engine import RetrievalEngine

    rq, x, model = _serving_parts(cuda)
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
    # ... but not the caching allocator, which still allocates to the graph's pool and so releases no
    # memory for the rest of the process (ROADMAP section 3, F4): end that, for the tests after this one
    torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), eng.pools[eng.device])


# ---- kernels 4 and 5 with the seed in device memory; step graphs ----

def _keep_bits(q, k, bias, mask, seed, rate, **kw):
    """The keep bits that kernels 4 and 5 apply (dk = 64), read off identity
    blocks and held to attention_keep_mask's on unmasked keys: with v the
    identity on keys 0..63 the forward's out[..., :64] is the dropped p of
    those keys; with dout the identity on queries 0..63 the backward's
    dv^T[:, :, :64] is the dropped p of those queries (it hashes its bits
    itself). `kw`: b0, h0, heads_total. Returns the forward's bits."""
    from rqvae_tpu_torch.ops.cuda import attention as A
    from rqvae_tpu_torch.ops.hash_dropout import attention_keep_mask

    B, H, L = q.shape[:3]
    eye = torch.zeros(L, 64)
    eye[torch.arange(64), torch.arange(64)] = 1.0
    eye = eye.to(q.dtype).to(q.device).expand(B, H, L, 64).contiguous()
    keys = mask.bool()[:, None, None, :]
    want = attention_keep_mask(seed, B, H, L, L, rate, q.device, **kw)
    with torch.no_grad():
        o, m, l, _ = A._forward_cuda(q, k, eye, bias, mask, seed, False, rate, True, **kw)
        dv = A._backward_cuda(q, k, eye, bias, mask, seed, eye, m, l, False, rate, **kw)[2]
    fwd = (o != 0) & keys[..., :64]
    assert torch.equal(fwd, want[..., :64] & keys[..., :64])
    assert torch.equal((dv.transpose(-1, -2) != 0) & keys, want[:, :, :64, :] & keys)
    return fwd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [80, 300])
def test_attention_kernels_read_a_device_seed(cuda, dtype, L):
    """The seed as a 1-element int32 tensor on the card (a view into a seed
    row, as the model passes it): forward and backward equal their plain
    versions with the same tensor, for a seed below and one at or above 2^31,
    and keep attention_keep_mask's bits; another seed gives other outputs;
    the kernels read the seed when they run (a graph captured with one seed
    and replayed after the buffer changed gives the new seed's output)."""
    q, k, v, bias, mask = _attention_inputs(3, 2, L, L, 64, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(dtype).to(cuda)
    tol, gtol, dbias_tol = (2e-5, 4e-6, 4e-6) if dtype == torch.float32 else (3.2e-2, 2.0 ** -7, 1e-4)
    row = torch.tensor([5, 11, -(2**31) + 7, -3], dtype=torch.int32, device=cuda)  # -3: 2^32 - 3
    for seed in (row[1:2], row[2:3]):
        _keep_bits(q, k, bias, mask, seed, 0.1)
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


# ---- hash dropout's masked multiply (csrc/hash_dropout.cu) ----

def _bits(t):
    """A float32 or bf16 tensor's bits, so that +0 and -0 (and NaN) compare."""
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _wrapped_plain(x, seed, rate, offset, row=None):
    """where(keep, x, 0) * scale with the counters built on the host in
    int64 and wrapped to uint32 (the plain route's _check_span refuses a span
    that passes 2^32, which the kernel's arithmetic must still wrap)."""
    from rqvae_tpu_torch.ops import hash_dropout as thd

    i = torch.arange(x.numel(), dtype=torch.int64)
    counter = offset + (i if row is None else (i // row[0]) * row[1] + i % row[0])
    keep = thd.hash_keep_bits(counter & 0xFFFFFFFF, seed, rate).reshape(x.shape).to(x.device)
    return torch.where(keep, x, 0) * thd.keep_scale(rate, x.dtype)


# (shape, offset, total, row): the plain layout at sizes that are no multiple
# of 8 or 4; an offset past 2^31; rows of w in global rows of W, w below and
# above the vector width
HASH_LAYOUTS = [((3, 37, 5), 0, None, None), ((1000, 33), 2**31 + 12345, None, None),
                ((2, 3, 7), 6 * 40, 12 * 40, None), ((20, 3), 5, None, (3, 10)),
                ((6, 50), 128 + 40, 7 * 128, (50, 128)), ((64, 9, 13), 2**31 + 7, 2**32 - 1, (13, 40)),
                # the training cells' sites: Amazon's d_ff from a rank's offset past 2^31, ML-32M's d_model
                ((640, 80, 1024), 2**31 + 5, None, None), ((64, 800, 384), 0, None, None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,offset,total,row", HASH_LAYOUTS)
def test_hash_dropout_kernel_matches_plain(cuda, dtype, shape, offset, total, row):
    """The kernel against the plain route bit for bit, on negative inputs with
    NaN and -inf in dropped places (+0 out), from a strided view too; each
    launch counts its elements under hash_dropout.kernel."""
    from rqvae_tpu_torch.ops import hash_dropout as thd
    from rqvae_tpu_torch.ops.cuda.hash_dropout import hash_dropout_cuda
    from rqvae_tpu_torch.utils import profiling

    seed = torch.tensor([-(2**31) + 99], dtype=torch.int32, device=cuda)
    x = -torch.rand(shape, generator=torch.Generator().manual_seed(4)).to(dtype).to(cuda)
    keep = thd.keep_mask(seed, shape, 0.3, cuda, offset, total, row)
    x[~keep] = float("nan")
    x.view(-1)[~keep.view(-1) & (torch.arange(x.numel(), device=cuda) % 2 == 0)] = float("-inf")
    want = thd.hash_dropout_plain(x, seed, 0.3, offset, total, row)
    assert (_bits(want)[~keep] == 0).all() and 0 < keep.float().mean() < 1
    before = (hash_dropout_cuda.launches, profiling.ROOT.snapshot().get("hash_dropout.kernel"))
    got = thd._drop(x, seed, 0.3, offset, total, row)
    assert torch.equal(_bits(got), _bits(want))
    count = profiling.ROOT.snapshot()["hash_dropout.kernel"].count
    assert hash_dropout_cuda.launches == before[0] + 1 and count == (before[1].count if before[1] else 0) + x.numel()
    wide = torch.zeros(*shape[:-1], 2 * shape[-1], dtype=dtype, device=cuda)
    wide[..., ::2] = x
    strided = thd._drop(wide[..., ::2], seed, 0.3, offset, total, row)
    assert strided.is_contiguous() and torch.equal(_bits(strided), _bits(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,offset,row", [(5003, 2**32 - 1000, None), (4800, 2**32 - 30 * 64, (48, 64))])
def test_hash_dropout_kernel_counters_wrap_past_2_32(cuda, dtype, n, offset, row):
    """Counters that pass 2^32 inside the span wrap as uint32 values do."""
    from rqvae_tpu_torch.ops.cuda.hash_dropout import hash_dropout_cuda
    from rqvae_tpu_torch.ops.hash_dropout import keep_scale, keep_threshold

    seed = torch.tensor([12345], dtype=torch.int32, device=cuda)
    x = torch.randn(n, generator=torch.Generator().manual_seed(5)).to(dtype).to(cuda)
    got = hash_dropout_cuda(x, seed, keep_threshold(0.25), keep_scale(0.25, dtype), offset, row)
    assert torch.equal(_bits(got), _bits(_wrapped_plain(x, seed, 0.25, offset, row)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,offset,total,row", [HASH_LAYOUTS[0], HASH_LAYOUTS[2], HASH_LAYOUTS[4]])
def test_hash_dropout_autograd_under_graph_replay(cuda, dtype, shape, offset, total, row):
    """Forward and backward through autograd captured in one CUDA graph: each
    replay after the seed buffer changed gives the new seed's output and
    gradient, bit for bit with the plain route."""
    from rqvae_tpu_torch.ops import hash_dropout as thd

    g = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=g).to(dtype).to(cuda).requires_grad_()
    dy = torch.randn(shape, generator=g).to(dtype).to(cuda)
    buf = torch.tensor([1], dtype=torch.int32, device=cuda)

    def body():
        y = thd.hash_dropout(x, buf, 0.1, offset, total, row)
        return y, torch.autograd.grad(y, x, dy)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # warm: loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, dx = body()
    outs = []
    for seed in (7, -5, 2**31 - 1):
        buf.fill_(seed)
        graph.replay()
        torch.cuda.synchronize()
        want = thd.hash_dropout_plain(x.detach(), buf, 0.1, offset, total, row)
        assert torch.equal(_bits(y), _bits(want)), seed
        assert torch.equal(_bits(dx), _bits(thd.hash_dropout_plain(dy, buf, 0.1, offset, total, row))), seed
        outs.append(y.clone())
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("remat", [False, True])
def test_stage2_step_with_the_kernel_equals_the_plain_route(cuda, monkeypatch, remat):
    """One bf16 stage-2 step with dropout 0.1: loss and updated parameters
    through the kernel equal those of the same step with _drop patched to the
    plain route, bit for bit; the kernel ran at every site, forward and
    backward (and again in remat's recompute)."""
    from rqvae_tpu_torch.ops import hash_dropout as thd
    from rqvae_tpu_torch.ops.cuda.hash_dropout import hash_dropout_cuda
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=64, t5_d_kv=64, t5_num_heads=2,
                          t5_d_ff=128, t5_num_layers=2, t5_dropout=0.1, t5_dtype="bfloat16", t5_remat=remat)
    store = _small_store(cuda)
    runs = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(thd, "_drop", thd.hash_dropout_plain)
        model = EncoderDecoderRetrievalModel(cfg, device=cuda, seed=2)
        opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=1.0)
        step = make_decoder_graph_train_step(model, opt, max_seq_len=6, n_steps=1, batch_size=8)
        before = hash_dropout_cuda.launches
        means = step(*store, [step.draws(3, 0, 48)])
        torch.cuda.synchronize()
        runs[route] = (means, model, hash_dropout_cuda.launches - before)
    (mk, model_k, launched), (mp, model_p, plain_launched) = runs["kernel"], runs["plain"]
    assert plain_launched == 0 and launched >= 2 * 5  # a forward and a backward at each site at least
    assert torch.equal(mk["total_loss"], mp["total_loss"])
    for (n, a), b in zip(model_k.named_parameters(), model_p.parameters()):
        assert torch.equal(a, b), n


def _small_store(device, rows=48, T=14, n_items=40, K=16):
    r = np.random.RandomState(0)
    seq_items = r.randint(0, n_items, (rows, T)).astype(np.int64)
    seq_lengths = r.randint(5, T + 1, rows).astype(np.int64)
    seq_items[np.arange(T)[None, :] >= seq_lengths[:, None]] = -1
    cached = r.randint(0, K, (n_items, 4)).astype(np.int32)
    cached[:, -1] = 0
    return [torch.as_tensor(a, device=device) for a in (seq_items, seq_lengths, np.arange(rows), cached)]


# stage-2 step geometries: T5 widths, the store (_small_store's sizes), max_seq_len and batch; the
# published ones are configs/decoder_amazon.gin's (Le 80) and decoder_ml32m.gin's (Le 800)
STAGE2_GEOS = {
    "small": (dict(codebook_size=16, t5_d_model=64, t5_d_kv=64, t5_num_heads=2, t5_d_ff=128, t5_num_layers=2),
              dict(rows=48, T=14, n_items=40, K=16), 6, 8),
    "amazon": (dict(codebook_size=256, **AMAZON_T5_CFG), dict(rows=2048, T=22, n_items=4096, K=256), 20, 640),
    "ml32m": (dict(codebook_size=256, **AMAZON_T5_CFG), dict(rows=256, T=202, n_items=4096, K=256), 200, 64),
}


@pytest.mark.parametrize("dtype,accum,geo", [("bfloat16", 1, "small"), ("float32", 2, "small"),
                                              ("bfloat16", 1, "amazon"), ("bfloat16", 1, "ml32m")])
def test_stage2_graph_chunk_equals_eager_steps(cuda, dtype, accum, geo):
    """6 stage-2 steps with dropout 0.1 (kernels 4 and 5 and the hash-dropout
    kernel in the graph), eagerly one by one against 2 chunks of 3 replays of
    the step's CUDA graph, from one state: parameters, moments and the chunk
    means bit-equal; the capture records one step's launches (its eager run
    and the capture tick the wrappers, a step's worth each) and the replays
    tick nothing."""
    from rqvae_tpu_torch.ops.cuda.hash_dropout import hash_dropout_cuda
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    widths, store_kw, max_seq_len, batch = STAGE2_GEOS[geo]
    cfg = RetrievalConfig(num_hierarchies=3, **widths, t5_dropout=0.1, t5_dtype=dtype)
    store = _small_store(cuda, **store_kw)
    runs = {}
    for name, n_steps in (("eager", 1), ("graph", 3)):
        model = EncoderDecoderRetrievalModel(cfg, device=cuda, seed=2)
        opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=1.0)
        step = make_decoder_graph_train_step(model, opt, max_seq_len=max_seq_len, n_steps=n_steps, batch_size=batch,
                                             accum=accum)
        draws = [step.draws(3, s, store_kw["rows"]) for s in range(6)]
        before = (t5_attention.launches, t5_attention.backward_launches, hash_dropout_cuda.launches)
        means = [step(*store, draws[i:i + n_steps]) for i in range(0, 6, n_steps)]
        after = (t5_attention.launches, t5_attention.backward_launches, hash_dropout_cuda.launches)
        runs[name] = (model, opt, means, [a - b for a, b in zip(after, before)], step)
    (me, oe, eager, eager_launched, _), (mg, og, chunks, launched, gstep) = runs["eager"], runs["graph"]
    assert gstep.chunks.graph is not None and gstep.chunks.replays == 6
    step_launches = widths["t5_num_layers"] * accum  # kernels 4 and 5: each encoder layer of each micro-batch
    assert eager_launched[:2] == [6 * step_launches] * 2 and launched[:2] == [2 * step_launches] * 2
    assert launched[2] > 0 and 3 * launched[2] == eager_launched[2]  # hash dropout: 2 steps' worth against 6
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


@pytest.mark.parametrize("remat", [False, True])
def test_moe_step_graph_chunk_equals_eager_steps(cuda, remat):
    """The sparse-expert model (models/moe.py) at small widths, bf16, dropout
    0.1: 6 eager steps against 2 chunks of 3 replays of the captured step,
    parameters, moments and chunk means (the balance loss and the MoE
    counters among them) bit-equal; the choices read after a replay are the
    last replayed step's."""
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    cfg = RetrievalConfig(num_hierarchies=3, codebook_size=16, t5_d_model=64, t5_d_kv=64, t5_num_heads=2,
                          t5_d_ff=128, t5_num_layers=3, t5_dropout=0.1, t5_dtype="bfloat16", t5_remat=remat,
                          t5_ffn="moe", t5_first_k_dense=1, t5_n_experts=16, t5_experts_per_token=4,
                          t5_expert_d_ff=64, t5_shared_d_ff=128, t5_experts_held=(4, 8), t5_aux_loss_alpha=0.001)
    store = _small_store(cuda)
    runs = {}
    for name, n_steps in (("eager", 1), ("graph", 3)):
        model = EncoderDecoderRetrievalModel(cfg, device=cuda, seed=2)
        opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1)
        step = make_decoder_graph_train_step(model, opt, max_seq_len=6, n_steps=n_steps, batch_size=8)
        draws = [step.draws(3, s, 48) for s in range(6)]
        means = [step(*store, draws[i:i + n_steps]) for i in range(0, 6, n_steps)]
        runs[name] = (model, opt, means, step, [c.clone() for c in model.encoder.moe_chosen])
    (me, oe, eager, _, chosen_e), (mg, og, chunks, gstep, chosen_g) = runs["eager"], runs["graph"]
    assert gstep.chunks.graph is not None and gstep.chunks.replays == 6
    for (n, a), b in zip(me.named_parameters(), mg.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(oe.mu + oe.nu, og.mu + og.nu):
        assert torch.equal(a, b)
    assert {"aux_loss", "moe.encoder", "moe.decoder"} <= set(chunks[0])
    for c, chunk in enumerate(chunks):
        for key, v in chunk.items():
            total = torch.zeros_like(v)
            for m in eager[3 * c:3 * c + 3]:
                total = total + m[key]
            assert torch.equal(v, total / 3), key
    assert all(torch.equal(a, b) for a, b in zip(chosen_e, chosen_g))


def test_moe_grouped_products_equal_the_per_expert_loop(cuda):
    """The MoE layer's grouped products (torch._grouped_mm over the held
    experts' rows, on the card) against a loop over the held experts with
    masks, both bf16 operands with f32 sums, forward and every gradient, on a
    router biased (over inputs of one sign) so that a few experts take most
    rows and one none."""
    from rqvae_tpu_torch.models.moe import MoEFFN

    d, f, E = 256, 128, 32
    layer = MoEFFN(d, E, 6, f, 256, (8, 16), 0.001, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=cuda) * 0.05)
        layer.router[9] += 0.2
        layer.router[10] += 0.1
        layer.router[12] -= 1.0
    x = torch.randn(4, 300, d, generator=g, device=cuda).abs().to(torch.bfloat16)
    mask = torch.ones(4, 300, dtype=torch.bool, device=cuda)
    mask[1, 200:] = False
    params = list(layer.parameters())
    y, stats = layer(x, torch.bfloat16, mask, training=True)
    dy = torch.randn(y.shape, generator=g, device=cuda).to(torch.bfloat16)
    got = torch.autograd.grad([y, stats.aux_loss], params, [dy, torch.ones((), device=cuda)], allow_unused=True)

    h = x.reshape(-1, d)
    valid = mask.reshape(-1)
    s, chosen, weight, key = layer.route(h, valid)
    assert torch.equal(chosen, stats.chosen)
    out = layer.shared(h, torch.bfloat16).float()
    wg, wu, wd = (w.to(torch.bfloat16) for w in (layer.w_gate, layer.w_up, layer.w_down))
    for e in range(layer.count):
        pick = key == e
        rows = pick.any(1)
        he = h[rows]
        a = (torch.nn.functional.silu((he @ wg[e]).float()) * (he @ wu[e]).float()).to(torch.bfloat16)
        ye = (a @ wd[e]).float()
        out = out.index_add(0, rows.nonzero()[:, 0], (weight * pick).sum(1)[rows, None] * ye)
    want = out.to(torch.bfloat16).reshape(y.shape)
    aux = layer.balance_loss(s, chosen, valid, 4)
    ref = torch.autograd.grad([want, aux], params, [dy, torch.ones((), device=cuda)], allow_unused=True)
    torch.testing.assert_close(y.float(), want.float(), rtol=2e-2, atol=2e-2)
    for (n, _), a, b in zip(layer.named_parameters(), got, ref):
        scale = float(b.abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale, n
    counts = (key < layer.count).sum()
    assert int(stats.counts[1]) == int(counts) and int((key == 4).sum()) == 0  # expert 12: none routed


@pytest.mark.parametrize("case", ["small_gumbel", "configs/rqvae_amazon.gin", "configs/rqvae_ml32m.gin",
                                  "configs/rqvae_amazon.gin:gumbel"])
def test_stage1_graph_chunk_equals_eager_steps(cuda, case):
    """Stage 1: 6 eager steps against 2 chunks of 3 replays, bit-equal.
    small_gumbel: Gumbel mode with the anneal on the device and 2
    micro-batches of 32. A config file: its widths, estimator (STE, the
    rotation trick) and batch, codebooks seeded from the data; ":gumbel" the
    Gumbel mode with the anneal in its place."""
    import functools

    from rqvae_tpu_torch.ops.schedules import gumbel_temperature_at
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    anneal = functools.partial(gumbel_temperature_at, t0=1.0, min_t=0.1, anneal_rate=0.05, step_size=2)
    if case == "small_gumbel":
        cfg = RqVaeConfig(**SMALL_VAE, codebook_mode=QuantizeForwardMode.GUMBEL_SOFTMAX)
        x = torch.randn(256, 32, generator=torch.Generator().manual_seed(1))
        rq = RqVae(cfg, device="cpu", seed=4)
        kw, t_fn, batch, lr, wd = dict(accum=2), anneal, 32, 1e-3, 0.01
    else:
        path, _, mode = case.partition(":")
        cfg, st = gin_rqvae(path, QuantizeForwardMode.GUMBEL_SOFTMAX if mode else None)
        x = item_corpus(4 * st["batch_size"], cfg, seed=1)
        rq = RqVae(cfg, device="cpu", seed=4)
        seed_codebooks(rq, x, seed=2)
        kw = dict(accum=1, gumbel_t=1.0) if mode else dict(accum=1)
        t_fn, batch, lr, wd = anneal if mode else None, st["batch_size"], st["learning_rate"], st["weight_decay"]
    x = x.to(cuda)
    runs = {}
    for name, n_steps in (("eager", 1), ("graph", 3)):
        model = RqVae(cfg, device=cuda)
        model.load_state_dict(rq.state_dict())
        opt = adamw(model.parameters(), lr, weight_decay=wd)
        step = make_rqvae_graph_train_step(model, opt, n_steps=n_steps, batch_size=batch, t_fn=t_fn, **kw)
        draws = [step.draws(5, s, x.shape[0]) for s in range(6)]
        runs[name] = (model, opt, [step(x, draws[i:i + n_steps]) for i in range(0, 6, n_steps)])
    (me, oe, eager), (mg, og, chunks) = runs["eager"], runs["graph"]
    for (n, a), b in zip(me.named_parameters(), mg.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(oe.mu + oe.nu, og.mu + og.nu):
        assert torch.equal(a, b)
    total = eager[3]["total_loss"] + eager[4]["total_loss"] + eager[5]["total_loss"]
    assert torch.equal(chunks[1]["total_loss"], (torch.zeros_like(total) + eager[3]["total_loss"]
                                                 + eager[4]["total_loss"] + eager[5]["total_loss"]) / 3)


def _uncapturable_step(device, monkeypatch):
    """A stage-1 step runner whose body reads the device from the host, which
    no CUDA graph can capture, with its batch and draws."""
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    model = RqVae(RqVaeConfig(**SMALL_VAE, codebook_mode=QuantizeForwardMode.STE), device=device, seed=0)
    step = make_rqvae_graph_train_step(model, adamw(model.parameters(), 1e-3), n_steps=2, accum=1, batch_size=16)
    body = step.chunks.body

    def host_read(**draws):
        out = body(**draws)
        out["total_loss"].item()  # a host read: illegal while capturing
        return out

    monkeypatch.setattr(step.chunks, "body", host_read)
    return step, torch.randn(64, 32, device=device), [step.draws(0, s, 64) for s in range(2)]


def test_step_graph_capture_failure_raises(cuda, monkeypatch):
    """No eager fallback on the card: a step body that reads the device from
    the host cannot be captured, and the chunk says so."""
    step, x, draws = _uncapturable_step(cuda, monkeypatch)
    with pytest.raises(RuntimeError, match="capture"):
        step(x, draws)
    torch.rand(4, device=cuda)  # the failed capture left the device's generator usable
    torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), step.chunks.pool)  # as the engine's test says


@pytest.mark.xfail(strict=True, raises=AssertionError,
                   reason="ROADMAP F4: utils/device.py::end_failed_capture leaves the caching allocator allocating "
                          "to the failed capture's pool, and empty_cache releases nothing while it does")
def test_failed_capture_leaves_freed_memory_releasable(cuda, monkeypatch):
    """After a step graph's capture failed, memory freed on the card goes
    back to it at torch.cuda.empty_cache(). Passes once end_failed_capture
    ends the failed pool's allocation; then the capture-failure tests above
    lose their own call that ends it."""
    step, x, draws = _uncapturable_step(cuda, monkeypatch)
    with pytest.raises(RuntimeError, match="capture"):
        step(x, draws)
    try:
        block = torch.empty(1 << 28, device=cuda)  # 1 GiB
        del block
        held = torch.cuda.memory_reserved(cuda)
        torch.cuda.empty_cache()
        assert torch.cuda.memory_reserved(cuda) < held
    finally:
        torch._C._cuda_endAllocateToPool(torch.cuda.current_device(), step.chunks.pool)


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
    (2 when x needs no gradient), counted by their multiply-adds under
    "amp.bf16"; reduced-precision reduction off inside the flag and restored
    after."""
    from rqvae_tpu_torch.ops import amp
    from rqvae_tpu_torch.utils import profiling

    g = torch.Generator().manual_seed(7)
    x = torch.randn(x_shape, generator=g).to(cuda).requires_grad_(x_grad)
    w = (torch.randn(w_shape, generator=g) * 0.05).to(cuda).requires_grad_(True)
    gy = torch.randn(*x_shape[:-1], w_shape[0], generator=g).to(cuda)
    assert not torch.backends.cuda.matmul.allow_tf32
    before = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    agg = lambda: profiling.ROOT.snapshot().get("amp.bf16")  # noqa: E731
    n0 = agg().count if agg() else 0
    with amp.bf16_products(True):
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        y = amp.linear(x, w)
        y.backward(gy)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == before
    assert agg().count - n0 == (3 if x_grad else 2) * x.numel() * w_shape[0] and y.dtype == torch.float32
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


# ---- dense at bf16: tensor-core products with float32 sums (models/t5.py, ops/amp.py) ----

# (rows, in, out) of the training cells' products: Amazon's FFN (wi, wo) over
# its 640 x 80 tokens, and at 2,048 wide the MoE cell's dense SwiGLU gate and
# its shared experts' down projection over 64 x 800
DENSE_SHAPES = {"amazon-wi": (51200, 384, 1024), "amazon-wo": (51200, 1024, 384),
                "moe-gate": (51200, 2048, 10944), "moe-shared-down": (51200, 2816, 2048)}


def _dense_formula(x16, w16, g16):
    """The float32 formula on the card (TF32 off): y, dX and dW as float32
    products of the bf16 operands, each rounded to bf16 once."""
    xf, wf, gf = x16.float(), w16.float(), g16.float()
    return (xf @ wf.t()).to(torch.bfloat16), (gf @ wf).to(torch.bfloat16), (gf.t() @ xf).to(torch.bfloat16)


def _dense_route(x16, w, g16):
    from rqvae_tpu_torch.models.t5 import dense

    x = x16.detach().requires_grad_(True)
    y = dense(x, w, torch.bfloat16)
    y.backward(g16)
    return y.detach(), x.grad, w.grad


@pytest.mark.parametrize("data", ["integers", "normal"])
@pytest.mark.parametrize("shape", list(DENSE_SHAPES), ids=list(DENSE_SHAPES))
def test_dense_bf16_route_matches_the_float32_formula(cuda, shape, data):
    """dense at bf16 on the card (bf16 operands on the tensor cores, float32
    sums, each of y, dX and dW rounded to bf16 once) against the float32
    formula on the card, at the training cells' shapes. On small integers,
    whose float32 sums are exact in any order, bit for bit: a bf16 partial
    sum or a missing or extra rounding would show. On normal values, every
    element within one bf16 step of the formula's (or, for a sum that
    cancels to near zero, within 1e-5 of the tensor's largest entry, 1e-4
    for dW's sums over 51,200 rows: what summation order alone moves). dW
    reaches the float32 parameter as its bf16 value; 3 products counted under
    dense.bf16; no backend flag changed."""
    from rqvae_tpu_torch.ops import amp
    from rqvae_tpu_torch.utils import profiling

    m, k, n = DENSE_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(11)
    if data == "integers":
        x16, w, g16 = (torch.randint(-4, 5, s, generator=g, device=cuda).float() for s in ((m, k), (n, k), (m, n)))
    else:
        x16, w, g16 = (torch.randn(s, generator=g, device=cuda) for s in ((m, k), (n, k), (m, n)))
        w = w * k ** -0.5
    x16, g16 = x16.to(torch.bfloat16), g16.to(torch.bfloat16)
    w.requires_grad_(True)
    matmul = torch.backends.cuda.matmul
    flags = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    before = profiling.ROOT.snapshot().get("dense.bf16")
    got = _dense_route(x16, w, g16)
    torch.cuda.synchronize()
    after = profiling.ROOT.snapshot()["dense.bf16"].count
    assert after - (0 if before is None else before.count) == 3 * m * k * n
    assert (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction) == flags
    want = _dense_formula(x16, w.detach().to(torch.bfloat16), g16)
    assert got[2].dtype == torch.float32 and torch.equal(got[2], got[2].to(torch.bfloat16).float())
    for name, a, b, floor in zip(("y", "dx", "dw"), got, want, (1e-5, 1e-5, 1e-4)):
        a = a.to(torch.bfloat16)
        if data == "integers":
            assert torch.equal(a, b), (shape, name, int((a != b).sum()))
            continue
        bf = b.float()
        step = torch.where(bf == 0, 0.0, 2.0 ** (torch.frexp(bf).exponent - 8).float())  # one bf16 step at |b|
        bound = torch.maximum(step, floor * bf.abs().max())
        err = (a.float() - bf).abs()
        assert bool((err <= bound).all()), (shape, name, float((err / bound).max()), int((err > step).sum()))


# (rows, in, out) of every product dense runs at bf16 in each cell: the training
# cells' encoders over 51,200 tokens and their decoders over batch x 4 rows
# (forward, dX and dW); serving's plain encoder and cross K/V over the buckets'
# 80-key rows, and the batch cell's cross K/V over 1,024 x 800 rows and its
# plain decoder's beams (forward only)
T5_WIDTHS = ((384, 384), (384, 1024), (1024, 384))
MOE_WIDTHS = ((2048, 2048), (2048, 10944), (10944, 2048), (2048, 2816), (2816, 2048))
DENSE_CELL_SHAPES = {
    "amazon-beauty.train": [(m, k, n, True) for m in (51200, 2560) for k, n in T5_WIDTHS],
    "ml-32m.train": [(m, k, n, True) for m in (51200, 256) for k, n in T5_WIDTHS],
    "ml-32m-moe.train": [(m, k, n, True) for m in (51200, 256) for k, n in MOE_WIDTHS],
    "amazon-beauty.serve-poisson": [(80 * b, k, n, False) for b in (1, 4, 16, 64) for k, n in T5_WIDTHS],
    "ml-32m.batch-retrieve": [(819200, 384, 384, False)] + [(m, k, n, False) for m in (1024, 10240, 30720)
                                                            for k, n in T5_WIDTHS],
}


@pytest.mark.parametrize("cell", list(DENSE_CELL_SHAPES))
def test_dense_bf16_output_equals_the_float32_output_rounded(cuda, cell):
    """dense's products write bf16 straight from cuBLAS (float32 sums,
    reduced-precision reductions off for the call): bit-equal to the
    float32-output product rounded to bf16 once, for every product of the
    cell (forward; dX = g W and dW = g^T x where it trains), on normal
    values; the flag is back on after each call."""
    from rqvae_tpu_torch.ops import amp

    bf = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(5)
    matmul = torch.backends.cuda.matmul
    assert matmul.allow_bf16_reduced_precision_reduction
    for m, k, n, trains in DENSE_CELL_SHAPES[cell]:
        x, w, gy = (torch.randn(s, generator=g, device=cuda).to(bf) for s in ((m, k), (n, k), (m, n)))
        products = {"y": (x, w.t())}
        if trains:
            products.update(dx=(gy, w), dw=(gy.t(), x))
        for name, (a, b) in products.items():
            got = amp._product(a, b, bf)
            assert matmul.allow_bf16_reduced_precision_reduction
            want = amp._product(a, b, torch.float32).to(bf)
            assert got.dtype == bf and torch.equal(got, want), (cell, (m, k, n), name, int((got != want).sum()))
        del x, w, gy, products


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
@pytest.mark.parametrize("geo", ["small", "amazon"])
def test_amp_graph_chunk_equals_eager_steps(cuda, stage, geo):
    """amp=True inside the step graph: 6 steps one by one against 2 chunks of
    3 replays, bit-equal (more than one step, so a bf16 copy of the weights
    kept across updates would show), and the steps differ from the float32
    route's (the products took the bf16 route). Small widths, and Amazon's:
    stage 2 at decoder_amazon.gin's T5 in float32 (batch 640, Le 80), stage 1
    at configs/rqvae_amazon.gin."""
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_graph_train_step
    from rqvae_tpu_torch.train.state import adamw

    widths, store_kw, max_seq_len, batch2 = STAGE2_GEOS[geo]
    store = _small_store(cuda, **store_kw)
    if geo == "small":
        vae, batch1, rows = RqVaeConfig(**SMALL_VAE, codebook_mode=QuantizeForwardMode.STE), 32, 256
    else:
        vae, st = gin_rqvae("configs/rqvae_amazon.gin")
        batch1, rows = st["batch_size"], 4 * st["batch_size"]
    x = torch.randn(rows, vae.input_dim, generator=torch.Generator().manual_seed(1)).to(cuda)

    def run(n_steps, amp):
        if stage == "stage2":
            cfg = RetrievalConfig(num_hierarchies=3, **widths, t5_dropout=0.1, t5_dtype="float32")
            model = EncoderDecoderRetrievalModel(cfg, device=cuda, seed=2)
            opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=1.0)
            step = make_decoder_graph_train_step(model, opt, max_seq_len=max_seq_len, n_steps=n_steps,
                                                 batch_size=batch2, amp=amp)
            draws = [step.draws(3, s, store_kw["rows"]) for s in range(6)]
            means = [step(*store, draws[i:i + n_steps]) for i in range(0, 6, n_steps)]
        else:
            model = RqVae(vae, device=cuda, seed=4)
            opt = adamw(model.parameters(), 1e-3, weight_decay=0.01)
            step = make_rqvae_graph_train_step(model, opt, n_steps=n_steps, accum=1, batch_size=batch1, amp=amp)
            draws = [step.draws(5, s, rows) for s in range(6)]
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


# (dtype, B, H, L): small batches, and the training cells' shapes (Amazon whole rows, ML-32M key tiles)
DP_TP_SHAPES = [(torch.bfloat16, 3, 2, 80), (torch.bfloat16, 3, 2, 800), (torch.float32, 3, 2, 80),
                (torch.bfloat16, 640, 6, 80), (torch.bfloat16, 64, 6, 800), (torch.float32, 640, 6, 80),
                (torch.float32, 64, 6, 800)]


@pytest.mark.parametrize("dtype,B,H,L", DP_TP_SHAPES)
def test_attention_kernels_count_dropout_from_b0(cuda, dtype, B, H, L):
    """Kernels 4 and 5 launched with b0 = B (a data-parallel rank's first
    global row): the output and dq, dk, dv are bit-equal to rows B .. 2B - 1
    of the launches over the batch doubled at b0 = 0, within the attention
    tolerances of the plain versions at b0 = B, and other than at b0 = 0; the
    keep bits are attention_keep_mask's at b0 = B."""
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
    _keep_bits(q, k, bias, mask, seed, 0.1, b0=B)


@pytest.mark.parametrize("dtype,B,H,L", DP_TP_SHAPES)
def test_attention_kernels_count_dropout_from_h0(cuda, dtype, B, H, L):
    """Kernels 4 and 5 launched over heads h0 = H/2 .. H - 1 of H global heads
    (a tensor-parallel rank's): the output and dq, dk, dv are bit-equal to
    those heads of the launches over all H heads, the keep bits (read off
    identity blocks of v and dout) equal attention_keep_mask's at h0 bit for
    bit, the results lie within the attention tolerances of the plain
    versions at h0, and h0 = 0 keeps other bits."""
    h0, hs = H // 2, slice(H // 2, H)
    q, k, v, bias, mask = _attention_inputs(B, H, L, L, 64, dtype, cuda)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(dtype).to(cuda)
    seed = torch.tensor([77], dtype=torch.int32, device=cuda)
    tol, gtol, dbias_tol = (2e-5, 4e-6, 4e-6) if dtype == torch.float32 else (3.2e-2, 2.0 ** -7, 1e-4)

    def run(ops, **kw):
        leaves = [t.detach().clone().requires_grad_() for t in ops[:4]]
        out = t5_attention(*leaves, mask, seed, dropout_rate=0.1, **kw)
        out.backward(ops[4])
        return out.detach(), [leaf.grad for leaf in leaves]

    part_ops = [t[:, hs].contiguous() for t in (q, k, v)] + [bias[hs].contiguous(), do[:, hs].contiguous()]
    out, grads = run(part_ops, h0=h0, heads_total=H)
    whole, whole_grads = run((q, k, v, bias, do))
    assert torch.equal(out, whole[:, hs])
    for g, w in zip(grads[:3], whole_grads[:3]):
        assert torch.equal(g, w[:, hs])
    assert not torch.equal(out, run(part_ops)[0])  # h0 = 0 of H / 2 heads: other masks
    want = t5_attention_plain(*part_ops[:4], mask, seed, dropout_rate=0.1, h0=h0, heads_total=H)
    assert (out.float() - want.float()).abs().max() <= tol
    plain = t5_attention_backward_plain(*part_ops[:4], mask, seed, part_ops[4], dropout_rate=0.1, h0=h0,
                                        heads_total=H)
    for i, (g, w) in enumerate(zip(grads, plain)):
        assert (g.float() - w.float()).abs().max() <= (dbias_tol if i == 3 else gtol) * w.float().abs().max(), i
    _keep_bits(part_ops[0], part_ops[1], part_ops[3], mask, seed, 0.1, h0=h0, heads_total=H)


def test_two_cards_tensor_parallel_step_over_nccl(cuda, tmp_path):
    """Two processes on two cards, a 1 x 2 mesh over NCCL (parallel/mesh.py::
    make_process_mesh): two tensor-parallel stage-2 steps, f32 with dropout
    0.1, against one process on the whole model: losses rtol 1e-5 and the
    gathered parameters within the peak LR (one AdamW step's size; the sums
    are taken in another order, as the data-parallel test says)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import json

    from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
    from rqvae_tpu_torch.models.t5 import DropoutSeeds
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_train_step
    from rqvae_tpu_torch.train.state import adamw
    from torch_dist_worker import launch

    cfg = dict(num_hierarchies=3, codebook_size=16, t5_d_model=64, t5_d_kv=64, t5_num_heads=2, t5_d_ff=128,
               t5_num_layers=2, t5_dropout=0.1, t5_dtype="float32", num_user_bins=8)
    dev = torch.device("cuda", torch.cuda.current_device())
    model = EncoderDecoderRetrievalModel(RetrievalConfig(**cfg), device=dev, seed=3)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, tmp_path / "sd.pt")
    r = np.random.RandomState(0)
    B, n_items, D = 8, 6, 4
    batches = []
    for _ in range(2):
        mask = np.repeat(np.arange(n_items)[None, :] < r.randint(1, n_items + 1, B)[:, None], D, axis=1)
        batches.append({"user_ids": torch.from_numpy(r.randint(0, 50, B).astype(np.int32)),
                        "sem_ids": torch.from_numpy(np.where(mask, r.randint(0, 16, (B, n_items * D)), -1)
                                                    .astype(np.int32)),
                        "sem_ids_fut": torch.from_numpy(r.randint(0, 16, (B, D)).astype(np.int32)),
                        "seq_mask": torch.from_numpy(mask),
                        "token_type_ids": torch.from_numpy(np.tile(np.arange(D), (B, n_items)).astype(np.int32)),
                        "token_type_ids_fut": torch.from_numpy(np.tile(np.arange(D), (B, 1)).astype(np.int32))})
    seeds = DropoutSeeds.draw(torch.Generator().manual_seed(7), 1, model.n_dropout_sites)[0]
    torch.save({"batches": batches, "seeds": [seeds] * 2}, tmp_path / "b.pt")
    opt_cfg = dict(lr=1e-3, warmup=2, wd=0.1, max_grad_norm=1.0)
    spec = {"out": str(tmp_path), "device": "cuda", "scenarios": [dict(
        kind="tp_step", name="tp", device="cuda", config=cfg, state_dict=str(tmp_path / "sd.pt"), n_data=1,
        n_model=2, opt=opt_cfg, batches=str(tmp_path / "b.pt"), steps=2)]}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    lines = launch(2, str(tmp_path / "spec.json"), timeout=300)
    assert [line["backend"] for line in lines] == ["nccl", "nccl"]
    a, b = (torch.load(tmp_path / f"tp.rank{i}.pt") for i in range(2))
    assert a["backend"] == "nccl" and a["round_trip"] and b["round_trip"]
    opt = adamw(model.parameters(), inverse_sqrt_schedule(1e-3, 2), weight_decay=0.1, max_grad_norm=1.0)
    step = make_decoder_train_step(model, opt)
    want = [step(TokenizedSeqBatch(**{k: v.to(dev) for k, v in bt.items()}), seeds=seeds.to(dev))["total_loss"].item()
            for bt in batches]
    for got in (a, b):
        np.testing.assert_allclose([m["total_loss"].item() for m in got["metrics"]], want, rtol=1e-5)
        for k, p in model.state_dict().items():
            assert (got["params"][k] - p.cpu()).abs().max().item() <= 1e-3, k
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


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


@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"), ("cuda:0", "cuda:1")], ids=["one_card", "two_cards"])
def test_sharded_serving_over_two_cards(cuda, devices):
    """A mesh of two 'data' shards, on one card or on two: the index build
    runs kernel 1 once a shard and equals the unsharded build; the
    Retriever's shards run on their cards (a model and corpus copy on
    cuda:1), launch kernel 2 three times a shard a call and give the
    unsharded beams; an engine bucket (one graph a shard) replays the
    sharded call bit for bit."""
    if torch.cuda.device_count() < len(set(devices)):
        pytest.skip("needs two CUDA devices")
    from rqvae_tpu_torch.parallel.mesh import make_mesh
    from rqvae_tpu_torch.serving.engine import RetrievalEngine

    rq, x, model = _serving_parts(cuda)
    mesh = make_mesh(devices=list(devices))
    plain = _retriever(rq, model, x, cuda)
    tok = SemanticIdTokenizer(rq, mesh=mesh)
    before = fused_encode_quantize.launches
    assert torch.equal(tok.precompute_corpus_ids(x), plain.tokenizer.cached_ids)
    assert fused_encode_quantize.launches == before + 2
    r = Retriever(model, tok, mesh=mesh)
    assert [s.table.device for s in r.shards] == [torch.device(d) for d in devices]
    hist = np.random.RandomState(0).randint(0, 600, (6, 12)).astype(np.int32)
    before = t5_decoder_stack_infer.launches
    got = r.retrieve(hist)
    assert t5_decoder_stack_infer.launches == before + 3 * 2
    want = plain.retrieve(hist)
    assert torch.equal(got.item_ids, want.item_ids) and torch.equal(got.sem_ids, want.sem_ids)
    eng = RetrievalEngine(r, max_items=12, item_buckets=(12,), batch_buckets=(6,))
    assert eng.warmup() == 1 and len(eng.graphs[(6, 12)]) == 2
    flight = eng._replay(hist, np.zeros(6, np.int32))
    flight.event.synchronize()
    assert all(torch.equal(h, g.cpu()) for h, g in zip(flight.host, got))


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
