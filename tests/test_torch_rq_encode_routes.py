"""Kernel 1's routes and operand preparation on the CPU, and its widths
against the JAX package.

- `rq_encode_route`: every shipped stage-1 config (configs/rqvae_*.gin)
  takes "tensor_cores" in bf16 and "cuda_cores" in float32; other widths
  take "cuda_cores"; the Python shared-memory estimate of each route stays
  within the 232,448 B a Hopper block may use at every shipped width (the C
  library computes the same figure on the card: tests/test_torch_kernels_gpu.py).
- `pad_operands` (zero padding of the widths to what the kernel reads) gives
  the ids of the unpadded operands through the plain version, in both
  precisions; `kernel_operands` stores what each route reads, with codes past
  the codebook size never winning an argmin.
- ML-1M's widths (786 -> 512 -> 256 -> 128 -> 32, the width the wrapper used
  to refuse): the plain version gives the JAX package's ids in float32
  through its XLA path and its Pallas kernel in interpret mode (seeded so
  that no row sits at a float64 near-tie, asserted), and in bf16 the Pallas
  kernel's ids outside the bf16 near-tie set.
- The integer-valued case at the Amazon widths, the card tests' check of the
  tensor-core route: every float32 sum exact in any order, the plain version
  equal to the Pallas kernel on every row, and each rounding-point variant
  distinguishable on its data.
Nothing here compiles or launches a kernel.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.ops.pallas.rq_encode import encoder_weights_from_params
from rqvae_tpu.ops.pallas.rq_encode import fused_encode_quantize as j_fused

from rqvae_tpu_torch.ops.cuda import rq_encode as R
from rqvae_tpu_torch.utils.config import parse_config_file

from test_torch_kernels_gpu import bf16_near_tie_rows, integer_bf16_case_wide  # the card tests' cases
from test_torch_rq_encode_bf16 import EXACT_LIMIT, _variant
from test_torch_rqvae import _min_gap, _pair

CONFIGS = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs",
                                                                               "rqvae_*.gin")))
ML1M = dict(input_dim=786, embed_dim=32, hidden_dims=(512, 256, 128))  # codebooks: test_torch_rqvae.FIELDS's 3 x 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _widths(name):
    cfg = parse_config_file(os.path.join(os.path.dirname(__file__), "..", "configs", f"{name}.gin"))
    dims = (cfg["vae_input_dim"], *cfg["vae_hidden_dims"], cfg["vae_embed_dim"])
    return dims, cfg["vae_codebook_size"]


def test_every_stage_1_config_is_listed():
    assert len(CONFIGS) >= 9 and {"rqvae_amazon", "rqvae_ml1m", "rqvae_ml32m", "rqvae_synthetic"} <= set(CONFIGS)


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_configs_take_the_tensor_cores_in_bf16(name):
    dims, K = _widths(name)
    assert R.rq_encode_route(dims, K, dims[-1], "bf16") == "tensor_cores"
    assert R.rq_encode_route(dims, K, dims[-1], "f32") == "cuda_cores"  # float32 never drops to TF32


@pytest.mark.parametrize("name", CONFIGS)
def test_shared_memory_at_the_shipped_widths(name):
    dims, K = _widths(name)
    widths, kp = R.prepared_widths(dims, K)
    for route in R.ROUTES:
        assert R.rq_encode_smem_bytes(widths, kp, route) <= R.MAX_SMEM_BYTES, (route, widths)


@pytest.mark.parametrize(
    "dims,K,precision,want",
    [((786, 512, 256, 128, 32), 256, "bf16", "tensor_cores"),  # ML-1M: any input width
     ((787, 512, 256, 128, 32), 256, "bf16", "tensor_cores"), ((5, 16), 64, "bf16", "tensor_cores"),
     ((768, 512, 256, 128, 32), 256, "f32", "cuda_cores"),
     ((768, 500, 256, 128, 32), 256, "bf16", "cuda_cores"),  # a hidden width the tensor cores do not take
     ((768, 512, 256, 128, 24), 256, "bf16", "cuda_cores"), ((768, 512, 256, 128, 32), 100, "bf16", "cuda_cores"),
     ((768, 512, 256, 128, 32), 512, "bf16", "cuda_cores"), ((32, 24, 16, 8), 16, "bf16", "cuda_cores"),
     ((2048, 512, 256, 128, 32), 256, "bf16", "cuda_cores")],  # an x tile past the shared memory
)
def test_route_by_widths(dims, K, precision, want):
    assert R.rq_encode_route(dims, K, dims[-1], precision) == want


def test_route_refuses_an_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        R.rq_encode_route((768, 512, 32), 256, 32, "fp16")


@pytest.mark.parametrize("dims,K", [((786, 512, 256, 128, 32), 256), ((768, 512, 256, 128, 32), 256),
                                    ((64, 128, 64, 16), 64), ((31, 20, 12), 10)])
def test_prepared_widths(dims, K):
    widths, kp = R.prepared_widths(dims, K)
    assert widths[0] % 4 == 0 and all(w % 16 == 0 for w in widths[1:]) and kp % 16 == 0
    assert all(0 <= w - d < (4 if i == 0 else 16) for i, (w, d) in enumerate(zip(widths, dims))) and 0 <= kp - K < 16


def _operands(dims, K, L=3, n=300, seed=0):
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randn(n, dims[0]).astype(np.float32))
    weights = [torch.from_numpy((r.randn(a, b) / np.sqrt(a)).astype(np.float32)) for a, b in zip(dims[:-1], dims[1:])]
    cbs = torch.from_numpy(r.randn(L, K, dims[-1]).astype(np.float32))
    return x, weights, cbs


@pytest.mark.parametrize("precision", R.PRECISIONS)
@pytest.mark.parametrize("dims,K", [((786, 512, 256, 128, 32), 64), ((31, 20, 12), 10), ((40, 24, 8), 16)])
def test_padding_gives_the_unpadded_ids(dims, K, precision):
    x, weights, cbs = _operands(dims, K)
    px, pw, pc = R.pad_operands(x, weights, cbs)
    widths, _ = R.prepared_widths(dims, K)
    assert [px.shape[1], *(w.shape[1] for w in pw)] == list(widths) and pc.shape == (3, K, widths[-1])
    np.testing.assert_array_equal(R.fused_encode_quantize_plain(px, pw, pc, 3, precision).numpy(),
                                  R.fused_encode_quantize_plain(x, weights, cbs, 3, precision).numpy())


def test_padding_leaves_prepared_tensors_alone():
    x, weights, cbs = _operands((768, 512, 32), 256)
    px, pw, pc = R.pad_operands(x, weights, cbs)
    assert px is x and pc is cbs and all(a is b for a, b in zip(pw, weights))


@pytest.mark.parametrize("route,precision", [("tensor_cores", "bf16"), ("cuda_cores", "bf16"), ("cuda_cores", "f32")])
def test_kernel_operands(route, precision):
    """What the library reads: storage type by route, bf16 values in bf16
    mode, the codebooks and their transposes, cb2 from the unrounded
    codebooks, +inf for the codes past the codebook size."""
    x, weights, cbs = _operands((786, 512, 32), 40, L=4)
    xk, wk, cb, cb_t, cb2 = R.kernel_operands(x, weights, cbs, 3, precision, route)
    store = torch.bfloat16 if route == "tensor_cores" else torch.float32
    rnd = R.round_bf16 if precision == "bf16" else torch.Tensor.float
    assert xk.dtype == torch.float32 and xk.shape == (300, 788) and torch.equal(xk[:, :786], x)
    assert all(w.dtype == store and w.is_contiguous() and w.data_ptr() % 16 == 0 for w in wk)
    assert torch.equal(wk[0][:786].float(), rnd(weights[0])) and not wk[0][786:].any()
    assert cb.shape == (3, 48, 32) and cb_t.shape == (3, 32, 48) and torch.equal(cb_t, cb.transpose(1, 2))
    assert torch.equal(cb[:, :40].float(), rnd(cbs[:3])) and not cb[:, 40:].float().any()
    torch.testing.assert_close(cb2[:, :40], (cbs[:3] ** 2).sum(-1), rtol=1e-6, atol=0)
    assert torch.isinf(cb2[:, 40:]).all()


def test_ml1m_f32_ids_equal_the_jax_xla_path_and_the_pallas_kernel():
    """ML-1M's widths, which the card wrapper refused before: the plain
    version (what the wrapper runs for CPU tensors) gives the JAX package's
    ids through its XLA path and through the Pallas kernel in interpret mode."""
    jm, params, tm, x = _pair(seed=2, n=256, **ML1M)
    want = jm.apply(params, jnp.asarray(x), training=False, method=JRqVae.get_semantic_ids)
    assert _min_gap(np.asarray(want.residuals), np.asarray(params["params"]["codebooks"])) > 1e-4
    weights, cbs = tm.encoder.kernels(), tm.codebooks.detach()
    assert [tuple(w.shape) for w in weights] == [(786, 512), (512, 256), (256, 128), (128, 32)]
    got = R.fused_encode_quantize(torch.from_numpy(x), weights, cbs, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.sem_ids))
    pallas = j_fused(jnp.asarray(x), encoder_weights_from_params(params), params["params"]["codebooks"], n_levels=3,
                     block_rows=x.shape[0], precision="f32", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_ml1m_bf16_ids_equal_the_pallas_kernel_outside_near_ties():
    jm, params, tm, x = _pair(seed=5, n=256, **ML1M)
    want = np.asarray(j_fused(jnp.asarray(x), encoder_weights_from_params(params), params["params"]["codebooks"],
                              n_levels=3, block_rows=x.shape[0], precision="bf16", interpret=True))
    weights, cbs = tm.encoder.kernels(), tm.codebooks.detach()
    got = R.fused_encode_quantize(torch.from_numpy(x), weights, cbs, 3, precision="bf16").numpy()
    near = bf16_near_tie_rows(torch.from_numpy(x), weights, cbs).numpy()
    differ = (got != want).any(1)
    assert not (differ & ~near).any(), f"{int((differ & ~near).sum())} rows differ outside the near-tie set"
    assert near.sum() < x.shape[0] // 4, f"near-tie set of {int(near.sum())} rows of {x.shape[0]}"


@pytest.mark.parametrize("seed", [0, 2])
def test_wide_integer_case_is_exact_and_decisive(seed):
    """The card tests' integer case at the Amazon widths: every float32 sum
    below 2^24 (exact in any order and alignment, so any correct route gives
    these ids bit for bit), the plain version equal to the Pallas kernel on
    every row, exact argmin ties present, and every variant with one rounding
    point changed, or the other tie, differing on some row."""
    x, weights, cbs = integer_bf16_case_wide(seed)
    assert [x.shape[1], *(w.shape[1] for w in weights)] == [768, 512, 256, 128, 32] and cbs.shape == (3, 256, 32)
    assert R.rq_encode_route((768, 512, 256, 128, 32), 256, 32, "bf16") == "tensor_cores"
    ref, biggest, ties = _variant(x, weights, cbs, 3)
    assert biggest < EXACT_LIMIT and ties > 0
    got = R.fused_encode_quantize(x, weights, cbs, 3, precision="bf16")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    want = np.asarray(j_fused(jnp.asarray(x.numpy()), tuple(jnp.asarray(w.numpy()) for w in weights),
                              jnp.asarray(cbs.numpy()), n_levels=3, block_rows=x.shape[0], precision="bf16",
                              interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    for name, kw in {"cb2 from rounded codebooks": dict(cb2_rounded=True),
                     "last layer not rounded": dict(last_round=False),
                     "residual update not rounded": dict(res_round=False),
                     "no rounding (f32)": dict(rounding=False),
                     "last index on ties": dict(last_on_ties=True)}.items():
        assert (_variant(x, weights, cbs, 3, **kw)[0].numpy() != want).any(), f"cannot tell '{name}'"
