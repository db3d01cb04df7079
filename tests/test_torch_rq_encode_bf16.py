"""Kernel 1's bf16 mode on the CPU: the port's plain bf16 version against the
Pallas kernel in interpret mode (`precision="bf16"`, as
tests/test_pallas_kernels.py runs it), and the tokenizer's route and default.

The reference rounds to bf16 at fixed points (rq_encode.py::_kernel): x; each
weight; each layer's output after the ReLU, and the last layer's (the
residual); the codebooks in the products; the residual after each level;
with float32 sums and squared codebook norms from the unrounded float32
codebooks.

- Integer-valued inputs: small-integer x and weights, codebooks of odd
  integers (mostly not bf16 values), one codeword duplicated (exact ties),
  magnitudes such that every float32 sum is exact whatever its order (checked:
  each sum of |terms| below 2^24). The rounding points alone decide, so the
  ids must be equal on every row, ties included; and each variant that
  rounds at one point fewer or more, or takes the other tie, must differ on
  some row (the data can tell them apart).
- Random inputs: ids equal outside the near-tie set, the rows where some
  level's top-2 distance gap, computed in float64 along the bf16 path, is
  within the most that one bf16 step of every element of the level's
  residual can move it, 2 sum_i ulp(res_i) |c1_i - c2_i| (c1, c2 the two
  nearest codewords): a float32 sum taken in another order can move a value
  across a bf16 rounding boundary, which moves it by one bf16 step. The set
  is counted and must hold under a tenth of the rows (10, 9 and 19 of the
  512 rows of the three cases here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops.pallas.rq_encode import encoder_weights_from_params
from rqvae_tpu.ops.pallas.rq_encode import fused_encode_quantize as j_fused
from rqvae_tpu.tokenizer import semids as jsemids

from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize, fused_encode_quantize_plain, round_bf16
from rqvae_tpu_torch.tokenizer import semids as tsemids
from rqvae_tpu_torch.tokenizer.semids import SemanticIdTokenizer

from test_torch_kernels_gpu import bf16_near_tie_rows, integer_bf16_case  # the card tests' cases
from test_torch_rqvae import _pair

EXACT_LIMIT = 2.0 ** 24  # every integer below it is a float32 value


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variant(x, weights, codebooks, n_levels, cb2_rounded=False, last_round=True, res_round=True,
             rounding=True, last_on_ties=False):
    """The bf16 arithmetic with one rounding point changed (all defaults: the
    reference's); also returns the largest sum of |terms| of any float32 sum
    and the count of exact argmin ties."""
    rnd = round_bf16 if rounding else torch.Tensor.float
    h, biggest, ties = rnd(x), 0.0, 0
    for i, w in enumerate(weights):
        biggest = max(biggest, float((h.abs().double() @ rnd(w).abs().double()).max()))
        h = h @ rnd(w)
        if i != len(weights) - 1:
            h = rnd(torch.relu(h))
        elif last_round:
            h = rnd(h)
    cb32 = codebooks.float()
    cb = rnd(cb32)
    cb2 = (cb * cb if cb2_rounded else cb32 * cb32).sum(-1)
    biggest = max(biggest, float((cb32.double() ** 2).sum(-1).max()))
    ids = []
    for level in range(n_levels):
        biggest = max(biggest, float((cb2[level].double() + 2 * h.abs().double() @ cb[level].abs().double().T).max()))
        dist = cb2[level][None] - 2.0 * (h @ cb[level].T)
        ties += int(((dist == dist.min(-1, keepdim=True).values).sum(-1) > 1).sum())
        idx = dist.shape[1] - 1 - dist.flip(-1).argmin(-1) if last_on_ties else dist.argmin(-1)
        h = h - cb[level][idx]
        h = rnd(h) if res_round else h
        ids.append(idx.to(torch.int32))
    return torch.stack(ids, 1), biggest, ties


@pytest.mark.parametrize("seed", [0, 2])
def test_integer_inputs_equal_the_pallas_kernel_on_every_row(seed):
    x, weights, cbs = integer_bf16_case(seed)
    want = np.asarray(j_fused(jnp.asarray(x.numpy()), tuple(jnp.asarray(w.numpy()) for w in weights),
                              jnp.asarray(cbs.numpy()), n_levels=3, block_rows=x.shape[0], precision="bf16",
                              interpret=True))
    got = fused_encode_quantize(x, weights, cbs, 3, precision="bf16")  # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    ref, biggest, ties = _variant(x, weights, cbs, 3)
    assert biggest < EXACT_LIMIT and ties > 0
    np.testing.assert_array_equal(ref.numpy(), want)
    for name, kw in {"cb2 from rounded codebooks": dict(cb2_rounded=True),
                     "last layer not rounded": dict(last_round=False),
                     "residual update not rounded": dict(res_round=False),
                     "no rounding (f32)": dict(rounding=False),
                     "last index on ties": dict(last_on_ties=True)}.items():
        changed = _variant(x, weights, cbs, 3, **kw)[0].numpy()
        assert (changed != want).any(), f"the data cannot tell '{name}' from the reference"


@pytest.mark.parametrize("seed,over", [(4, {}), (9, dict(input_dim=788, embed_dim=64, hidden_dims=(512, 256, 128))),
                                       (3, dict(input_dim=768, embed_dim=32, hidden_dims=(512, 256, 128)))],
                         ids=["small", "ml32m", "amazon"])
def test_random_inputs_equal_the_pallas_kernel_outside_near_ties(seed, over):
    n = 512
    jm, params, tm, x = _pair(seed=seed, n=n, **over)
    want = np.asarray(j_fused(jnp.asarray(x), encoder_weights_from_params(params), params["params"]["codebooks"],
                              n_levels=3, block_rows=n, precision="bf16", interpret=True))
    weights, cbs = tm.encoder.kernels(), tm.codebooks.detach()
    got = fused_encode_quantize_plain(torch.from_numpy(x), weights, cbs, 3, precision="bf16").numpy()
    near = bf16_near_tie_rows(torch.from_numpy(x), weights, cbs).numpy()
    differ = (got != want).any(1)
    assert not (differ & ~near).any(), f"{int((differ & ~near).sum())} rows differ outside the near-tie set"
    assert near.sum() < n // 10, f"near-tie set of {int(near.sum())} rows of {n}"
    if over:  # at the repo widths bf16 is another function than f32: some ids differ
        assert (fused_encode_quantize_plain(torch.from_numpy(x), weights, cbs, 3).numpy() != got).any()


def test_tokenizer_defaults_to_bf16_like_the_jax_tokenizer():
    import inspect

    want = inspect.signature(jsemids.SemanticIdTokenizer.__init__).parameters["pallas_precision"].default
    got = inspect.signature(SemanticIdTokenizer.__init__).parameters["precision"].default
    assert got == want == "bf16"


def test_tokenizer_runs_the_kernel_in_the_index_build_only(monkeypatch):
    """With the kernel route open (on the card), encode_batch takes the
    model's path as the JAX tokenizer's does, and precompute_corpus_ids one
    kernel call at the tokenizer's precision; here the route is opened on the
    CPU, where the wrapper runs the plain version."""
    jm, params, tm, x = _pair(seed=4, n=256)
    calls = []

    def wrapper(*args, **kw):
        calls.append(kw["precision"])
        return fused_encode_quantize(*args, **kw)

    monkeypatch.setattr(tsemids, "fused_encode_quantize", wrapper)
    monkeypatch.setattr(SemanticIdTokenizer, "use_kernel", property(lambda self: True))
    tok = SemanticIdTokenizer(tm, device="cpu")
    model_ids = tok.encode_batch(x)
    assert calls == []
    np.testing.assert_array_equal(model_ids.numpy(), tm.get_semantic_ids(torch.from_numpy(x)).sem_ids.numpy())
    cached = tok.precompute_corpus_ids(x)
    assert calls == ["bf16"]
    want = fused_encode_quantize_plain(torch.from_numpy(x), tm.encoder.kernels(), tm.codebooks.detach(), 3,
                                       precision="bf16")
    np.testing.assert_array_equal(cached[:, :3].numpy(), want.numpy())
    SemanticIdTokenizer(tm, device="cpu", precision="f32").precompute_corpus_ids(x)
    assert calls == ["bf16", "f32"]
    with pytest.raises(ValueError, match="precision"):
        SemanticIdTokenizer(tm, device="cpu", precision="fp16")
