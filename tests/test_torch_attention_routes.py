"""The attention kernels' routes and the backward's batch-group plan, on the
CPU: which routine a CUDA tensor of a given shape and dtype launches
(`attention_route`, mirrored by the C libraries and checked against them in
tests/test_torch_kernels_gpu.py), and how the backward splits the batch into
groups whose partial dbias sums are added in order. Nothing here compiles or
launches a kernel."""

import pytest
import torch

from rqvae_tpu_torch.ops.cuda import attention as A
from rqvae_tpu_torch.ops.cuda.attention import attention_route, backward_groups


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "Lq,Lk,dk,dtype,backward,want",
    [(80, 127, 64, BF16, False, "whole_row"), (80, 128, 64, BF16, False, "whole_row"),
     (80, 129, 64, BF16, False, "tiled"), (800, 80, 64, BF16, False, "whole_row"),
     (800, 800, 64, BF16, False, "tiled"), (1, 1, 64, BF16, False, "whole_row"),
     (127, 127, 64, BF16, True, "whole_row"), (128, 128, 64, BF16, True, "whole_row"),
     (129, 128, 64, BF16, True, "tiled"), (128, 129, 64, BF16, True, "tiled"),
     (200, 80, 64, BF16, True, "tiled"), (80, 80, 32, BF16, False, "cuda_cores"),
     (80, 80, 128, BF16, True, "cuda_cores"), (80, 80, 64, F32, False, "cuda_cores"),
     (800, 800, 64, F32, True, "cuda_cores")],
)
def test_route_boundaries(Lq, Lk, dk, dtype, backward, want):
    assert attention_route(Lq, Lk, dk, dtype, backward=backward) == want


@pytest.mark.parametrize(
    "B,H,Lq,Lk,dk,dtype",
    [(640, 6, 80, 80, 64, BF16), (64, 6, 800, 800, 64, BF16), (9, 2, 200, 80, 64, BF16), (7, 6, 80, 80, 64, BF16),
     (1, 6, 16, 16, 64, BF16), (640, 6, 80, 80, 64, F32), (64, 6, 800, 800, 64, F32), (33, 1, 24, 24, 8, F32)],
)
def test_batch_group_plan_covers_the_batch_in_order(B, H, Lq, Lk, dk, dtype):
    """Group i holds rows i*r .. i*r + r - 1 (r = ceil(B / groups)): together
    they hold every row once, in order, and none is empty; at most B / 4 groups,
    and no more blocks than the route aims at (on the tiled route, no more
    partial dbias than the L2 budget)."""
    groups = backward_groups(B, H, Lq, Lk, dk, dtype)
    r = -(-B // groups)
    rows = [b for i in range(groups) for b in range(i * r, min(B, i * r + r))]
    assert rows == list(range(B))
    assert all(min(B, i * r + r) > i * r for i in range(groups))
    assert 1 <= groups <= max(1, B // 4)
    route = attention_route(Lq, Lk, dk, dtype, backward=True)
    if route == "tiled":  # the groups' partial dbias within the L2 budget
        assert groups == 1 or groups * H * Lq * Lk * 4 <= A.TILED_PARTIAL_BYTES
    else:
        per_group = H if route == "whole_row" else H * -(-Lq // A.QUERY_TILE)
        assert groups == 1 or groups * per_group <= A.GROUP_TARGET_BLOCKS[route]


def test_batch_group_plan_at_the_training_shapes():
    """About two whole-row blocks on each of 132 SMs at the Amazon shape; at
    the ML-32M shape the tiled route's partial dbias (15.4 MB a group) in L2."""
    assert backward_groups(640, 6, 80, 80, 64, BF16) == 43  # 15 batch rows each, 258 blocks
    assert backward_groups(64, 6, 800, 800, 64, BF16) == 3  # 22 rows each, 46 MB of partials


@pytest.mark.parametrize("groups", [0, 10, 4])
def test_backward_refuses_a_plan_with_an_empty_group(groups):
    """9 rows: 0 or 10 groups, or 4 groups of 3 rows (the last one empty), are
    refused before anything is launched."""
    B, H, L = 9, 2, 16
    q, k, v, do = (torch.zeros(B, H, L, 64) for _ in range(4))
    bias, mask = torch.zeros(H, L, L), torch.ones(B, L, dtype=torch.int32)
    stats = torch.zeros(B, H, L)
    with pytest.raises(ValueError, match="empty"):
        A._backward_cuda(q, k, v, bias, mask, 0, do, stats, stats, False, 0.0, groups=groups)


@pytest.mark.parametrize("Lk,rate,shape", [(800, 0.1, None), (800, 0.0, (2, 2, 16, 13, 2)), (80, 0.1, (2, 2, 16, 2, 2)),
                                           (800, 0.1, (2, 2, 16, 12, 2))])
def test_backward_refuses_keep_bits_it_cannot_use(Lk, rate, shape):
    """Keep bits are the tiled forward's, one 64-bit word per row and 64-key
    tile, written with dropout: other shapes, routes or rates are refused
    before anything is launched (shape None: int64 words)."""
    B, H, Lq = 2, 2, 16
    q, do = torch.zeros(B, H, Lq, 64, dtype=BF16), torch.zeros(B, H, Lq, 64, dtype=BF16)
    k = v = torch.zeros(B, H, Lk, 64, dtype=BF16)
    bias, mask, stats = torch.zeros(H, Lq, Lk), torch.ones(B, Lk, dtype=torch.int32), torch.zeros(B, H, Lq)
    bits = torch.zeros(B, H, Lq, 13, 2, dtype=torch.int64) if shape is None else torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="keep_bits"):
        A._backward_cuda(q, k, v, bias, mask, 0, do, stats, stats, False, rate, keep_bits=bits)
