"""Kernel 1's emit_packed epilogue on the CPU: the plain version's [N, L+1]
output against the Pallas kernel's in interpret mode (emit_packed=True, as
tests/test_pallas_kernels.py runs it), exact: in f32 on random inputs, in
bf16 on integer-valued ones (every float32 sum exact, so the rounding points
alone decide). The kernel's own column is held on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py phase rq_encode_packed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops.pallas.rq_encode import fused_encode_quantize as j_fused

from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize, fused_encode_quantize_plain
from rqvae_tpu_torch.ops.dedup import pack_sem_id_tuples

from test_torch_kernels_gpu import integer_bf16_case


def _random_case(seed, n=256, widths=(32, 24, 16, 8), k=16):
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randn(n, widths[0]).astype(np.float32))
    weights = [torch.from_numpy((r.randn(a, b) / np.sqrt(a)).astype(np.float32)) for a, b in zip(widths, widths[1:])]
    return x, weights, torch.from_numpy(r.randn(3, k, widths[-1]).astype(np.float32))


def _pallas(x, weights, cbs, precision):
    return np.asarray(j_fused(jnp.asarray(x.numpy()), tuple(jnp.asarray(w.numpy()) for w in weights),
                              jnp.asarray(cbs.numpy()), n_levels=3, block_rows=x.shape[0], precision=precision,
                              interpret=True, emit_packed=True))


@pytest.mark.parametrize("precision,case", [("f32", 0), ("f32", 1), ("bf16", 0), ("bf16", 2)])
def test_packed_column_equals_the_pallas_epilogue(precision, case):
    x, weights, cbs = _random_case(case) if precision == "f32" else integer_bf16_case(case)
    want = _pallas(x, weights, cbs, precision)
    got = fused_encode_quantize(x, weights, cbs, 3, precision=precision, emit_packed=True)  # CPU: the plain version
    assert got.shape == (x.shape[0], 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ids = fused_encode_quantize_plain(x, weights, cbs, 3, precision=precision)
    assert torch.equal(got[:, :3], ids)
    assert torch.equal(got[:, 3], pack_sem_id_tuples(ids, cbs.shape[1]))


def test_packed_key_needs_31_bits_or_fewer():
    x, weights, cbs = _random_case(0, k=16)
    with pytest.raises(ValueError, match="31"):
        fused_encode_quantize_plain(x, weights, cbs.repeat(3, 1, 1), 9, emit_packed=True)  # 9 x 4 bits
