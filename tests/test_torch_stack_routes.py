"""The two stack kernels' routes, on the CPU: which routine CUDA tensors of a
given shape and dtype launch (`encoder_stack_route` for the encoder's rows
kernel, `decoder_stack_route` for the decoder; the C libraries make the same
choice, checked against them in tests/test_torch_kernels_gpu.py, which also
holds the shared memory each route asks for: the C libraries compute it),
the wrappers' refusals, before the library is loaded, of what neither route
takes, and the operand preparation: a copy of an operand that is strided or
does not start on a 16-byte boundary.
Nothing here compiles or launches a kernel."""

import pytest
import torch

from rqvae_tpu_torch.ops.cuda import decoder_stack as D
from rqvae_tpu_torch.ops.cuda import encoder_stack as E
from rqvae_tpu_torch.ops.cuda._build import aligned16, launch_operand
from rqvae_tpu_torch.ops.cuda.decoder_stack import decoder_stack_route
from rqvae_tpu_torch.ops.cuda.encoder_stack import encoder_stack_route
from rqvae_tpu_torch.ops.cuda.rows_core import tensor_core_widths


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "d,dk,inner,dff,dtype,want",
    [(384, 64, 384, 1024, BF16, "tensor_cores"),  # Amazon and ML-32M (configs/decoder_{amazon,ml32m}.gin)
     (384, 64, 384, 1024, F32, "cuda_cores"),  # float32 never drops to TF32
     (64, 64, 256, 128, BF16, "tensor_cores"),  # configs/decoder_synthetic.gin
     (32, 8, 32, 64, BF16, "cuda_cores"),  # SMALL_T5 of the card tests
     (384, 32, 384, 1024, BF16, "cuda_cores"),  # head width other than 64
     (320, 64, 384, 1024, BF16, "tensor_cores"), (416, 64, 384, 1024, BF16, "cuda_cores"),  # d past 384
     (384, 64, 448, 1024, BF16, "cuda_cores"),  # 7 heads: H*dk past 384
     (384, 64, 384, 1000, BF16, "cuda_cores"), (384, 64, 384, 64, BF16, "tensor_cores"),
     (100, 64, 384, 1024, BF16, "cuda_cores"), (384, 64, 384, 1024, torch.float16, "cuda_cores")],
)
def test_encoder_route(d, dk, inner, dff, dtype, want):
    assert encoder_stack_route(d, dk, inner, dff, dtype) == want


@pytest.mark.parametrize(
    "kT,d,dk,inner,dff,Le,dtype,want",
    [(kt, 384, 64, 384, 1024, 80, BF16, "tensor_cores") for kt in (1, 20, 30)]  # the Amazon levels
    + [(30, 384, 64, 384, 1024, 80, F32, "cuda_cores"),
       (32, 384, 64, 384, 1024, 80, BF16, "tensor_cores"), (33, 384, 64, 384, 1024, 80, BF16, "cuda_cores"),
       (30, 384, 64, 384, 1024, 128, BF16, "tensor_cores"),  # FUSED_DECODE_MAX_LEN
       (30, 384, 64, 384, 1024, 129, BF16, "cuda_cores"), (30, 384, 64, 384, 1024, 1, BF16, "tensor_cores"),
       (6, 64, 64, 256, 128, 12, BF16, "cuda_cores"),  # configs/decoder_synthetic.gin: d = 64 does not halve
       (30, 256, 64, 256, 1024, 80, BF16, "tensor_cores"), (30, 128, 64, 128, 128, 80, BF16, "tensor_cores"),
       (30, 320, 64, 384, 1024, 80, BF16, "cuda_cores"), (30, 384, 64, 320, 1024, 80, BF16, "cuda_cores"),
       (30, 384, 64, 384, 1088, 80, BF16, "cuda_cores"),  # multiples of 64, not of 128
       (6, 32, 8, 32, 64, 7, BF16, "cuda_cores"),  # SMALL_T5 of the card tests
       (30, 384, 32, 384, 1024, 80, BF16, "cuda_cores"), (30, 448, 64, 384, 1024, 80, BF16, "cuda_cores"),
       (30, 384, 64, 384, 1056, 80, BF16, "cuda_cores")],
)
def test_decoder_route(kT, d, dk, inner, dff, Le, dtype, want):
    assert decoder_stack_route(kT, d, dk, inner, dff, Le, dtype) == want


@pytest.mark.parametrize("d,inner,dff,want", [(384, 384, 1024, 2), (64, 256, 128, 1), (256, 128, 1024, 2),
                                              (384, 320, 1024, 1), (384, 384, 1088, 1), (128, 64, 128, 1)])
def test_decoder_blocks_per_batch_row(d, inner, dff, want):
    """Two blocks per batch row (the tensor-core route's pair) where every
    product halves into whole 64-column blocks: the published widths; else
    the CUDA-core kernel's one block."""
    blocks = 2 if decoder_stack_route(30, d, 64, inner, dff, 80, BF16) == "tensor_cores" else 1
    assert blocks == want


@pytest.mark.parametrize(
    "unit,d,inner,dff,want",
    [(64, 384, 384, 1024, True), (64, 64, 256, 128, True), (64, 448, 384, 1024, False), (64, 384, 448, 1024, False),
     (64, 384, 384, 1000, False), (64, 0, 384, 1024, False), (128, 384, 384, 1024, True),
     (128, 64, 256, 128, False), (128, 384, 384, 1088, False), (128, 384, 384, 4096, True)],
)
def test_tensor_core_widths(unit, d, inner, dff, want):
    """The widths one output pass of rows_core.cuh takes, shared by both
    routes: multiples of the unit, d and H*dk at most 384, dff any multiple."""
    assert tensor_core_widths(unit, d, inner, dff) is want


def _encoder_args(B, L, d, NL, H, dk, dff, dtype):
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt)
    f = torch.float32
    return (z(B, L, d), z(NL, H, d, dk), z(NL, H, d, dk), z(NL, H, d, dk), z(NL, H, dk, d), z(NL, d, dff),
            z(NL, dff, d), z(NL, d, dt=f), z(NL, d, dt=f), z(d, dt=f), z(H, L, L, dt=f), z(B, L, dt=f))


def _decoder_args(B, kT, d, NL, H, dk, dff, Le, dtype):
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt)
    f = torch.float32
    return (z(B, kT, d), z(NL, H, d, dk), z(NL, H, d, dk), z(NL, H, d, dk), z(NL, H, dk, d), z(NL, H, d, dk),
            z(NL, H, dk, d), z(NL, d, dff), z(NL, dff, d), z(NL, d, dt=f), z(NL, d, dt=f), z(NL, d, dt=f),
            z(d, dt=f), z(H, kT, kT, dt=f), z(NL, B, H, Le, dk), z(NL, B, H, Le, dk), z(B, Le, dt=f))


@pytest.mark.parametrize(
    "dims,dtype,match",
    [((1, 2, 64, 1, 1, 132, 128), BF16, "dk"), ((1, 2, 66, 1, 1, 64, 128), BF16, "multiples of 4"),
     ((1, 2, 64, 1, 1, 64, 128), torch.float16, "float32 or bfloat16")],
)
def test_encoder_refuses_what_neither_route_takes(dims, dtype, match):
    with pytest.raises(ValueError, match=match):
        E._check_cuda(*_encoder_args(*dims, dtype))


@pytest.mark.parametrize(
    "dims,dtype,match",
    [((1, 4, 66, 1, 1, 64, 128, 8), BF16, "multiples of 4"),
     ((1, 4, 64, 1, 1, 64, 128, 8), torch.float16, "float32 or bfloat16")],
)
def test_decoder_refuses_what_neither_route_takes(dims, dtype, match):
    with pytest.raises(ValueError, match=match):
        D._check_cuda(*_decoder_args(*dims, dtype))


def test_wrappers_copy_unaligned_tensors():
    """Both routes read 16 bytes at a time: a contiguous view that starts
    mid-vector passes the checks, and the wrappers launch on a copy of it in a
    fresh allocation, as the reference computes on any array."""
    enc = list(_encoder_args(1, 4, 64, 1, 1, 64, 128, BF16))
    enc[0] = torch.arange(1 * 4 * 64 + 1, dtype=BF16)[1:].reshape(1, 4, 64)
    assert enc[0].data_ptr() % 16 and E._check_cuda(*enc) == (1, 4, 64, 1, 1, 64, 128)
    dec = list(_decoder_args(1, 4, 64, 1, 1, 64, 128, 8, BF16))
    dec[14] = torch.arange(8 * 64 + 1, dtype=BF16)[1:].reshape(1, 1, 1, 8, 64)
    assert dec[14].data_ptr() % 16 and D._check_cuda(*dec) == (1, 4, 64, 1, 1, 64, 128, 8)
    for t in (enc[0], dec[14]):
        copy = aligned16(t)
        assert copy.data_ptr() % 16 == 0 and copy.is_contiguous() and torch.equal(copy, t)
    aligned = enc[1]
    assert aligned16(aligned) is aligned  # an aligned operand is launched as it is


def test_wrappers_refuse_strided_tensors():
    """Strided operands are not refused: they pass the checks, and the
    operand preparation both wrappers launch from (`launch_operand`) returns
    contiguous tensors on a 16-byte boundary holding the same values, as the
    reference computes on arrays of any layout."""
    enc = list(_encoder_args(1, 4, 64, 1, 1, 64, 128, BF16))
    enc[0] = torch.arange(64 * 4, dtype=BF16).reshape(1, 64, 4).transpose(1, 2)
    assert not enc[0].is_contiguous() and E._check_cuda(*enc) == (1, 4, 64, 1, 1, 64, 128)
    dec = list(_decoder_args(1, 4, 64, 1, 1, 64, 128, 8, BF16))
    dec[7] = torch.arange(128 * 64, dtype=BF16).reshape(1, 128, 64).transpose(1, 2)
    assert not dec[7].is_contiguous() and D._check_cuda(*dec) == (1, 4, 64, 1, 1, 64, 128, 8)
    for t in (enc[0], dec[7]):
        ready = launch_operand(t)
        assert ready.is_contiguous() and ready.data_ptr() % 16 == 0 and torch.equal(ready, t)


@pytest.mark.parametrize("dtype", [BF16, F32, torch.int32])
@pytest.mark.parametrize("layout", ["transposed", "offset", "transposed_and_offset", "sliced_rows"])
def test_launch_operand_is_contiguous_aligned_and_equal(layout, dtype):
    """Every layout a caller may hand a wrapper becomes a contiguous tensor
    on a 16-byte boundary with the caller's values; a tensor already so is
    passed through without a copy."""
    base = torch.arange(1 + 6 * 10, dtype=torch.float32).to(dtype)
    t = {
        "transposed": base[:60].reshape(6, 10).T,
        "offset": base[1:61].reshape(6, 10),
        "transposed_and_offset": base[1:61].reshape(6, 10).T,
        "sliced_rows": base[:60].reshape(6, 10)[:, 2:7],
    }[layout]
    ready = launch_operand(t)
    assert ready.is_contiguous() and ready.data_ptr() % 16 == 0 and ready.dtype == dtype
    assert torch.equal(ready, t)
    assert launch_operand(ready) is ready


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_wrappers_take_the_repo_widths(dtype):
    """One layer at the published widths passes every check (tensors on the
    CPU: only the checks run)."""
    assert E._check_cuda(*_encoder_args(1, 8, 384, 1, 6, 64, 1024, dtype)) == (1, 8, 384, 1, 6, 64, 1024)
    assert D._check_cuda(*_decoder_args(2, 30, 384, 1, 6, 64, 1024, 80, dtype)) == (2, 30, 384, 1, 6, 64, 1024, 80)
