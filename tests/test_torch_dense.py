"""`models/t5.py::dense` at bf16 on the card's route (ops/amp.py), on the CPU.

The card's route runs the products of bf16 operands on the tensor cores with
float32 sums; here `emulated_card` (tests/test_torch_amp.py) stands a float32
product of the same bf16 operands in for the card's. The route then equals
the CPU's formula, `F.linear(x.to(bf16).float(), w.to(bf16).float()).to(bf16)`,
bit for bit: the output, dX and dW, with x in bf16 or float32, 2-D or 3-D,
with and without the weight's gradient, inside `torch.utils.checkpoint`, at a
tensor-parallel column or row split of the weight, and through a whole T5
stack with remat. The Function keeps only bf16 tensors for the backward (the
formula keeps float32 copies), and the "dense.bf16" counter counts the
multiply-adds it launches, and nothing on the CPU's or the float32 route.

The card's own products are held to the float32 formula on the card, at the
training cells' shapes, in tests/test_torch_kernels_gpu.py.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rqvae_tpu_torch.models.t5 import T5Stack, T5StackConfig, dense
from rqvae_tpu_torch.ops import amp
from tests.test_torch_amp import counted, emulated_card  # noqa: F401

BF16 = torch.bfloat16
M, K, N = 24, 40, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def formula(x, w):
    """The CPU's dense at bf16."""
    return F.linear(x.to(BF16).float(), w.to(BF16).float()).to(BF16)


def _inputs(case: str, seed: int = 0):
    """(x, leaf weight, the weight as dense sees it, upstream gradient)."""
    g = torch.Generator().manual_seed(seed)
    shape = {"2d": (M, K), "no_weight_grad": (M, K)}.get(case, (3, M // 3, K))
    x = torch.randn(shape, generator=g)
    if case != "x_f32":
        x = x.to(BF16)
    x.requires_grad_(True)
    leaf = (torch.randn(2 * N, 2 * K, generator=g) * 0.1).requires_grad_(case != "no_weight_grad")
    if case == "tp_column":  # a rank's output columns: rows of the torch weight
        w = leaf[N:, :K]
    elif case == "tp_row":  # a rank's input rows: a strided window of the torch weight's columns
        w = leaf[:N, K:]
    else:
        w = leaf[:N, :K]
    gy = torch.randn(*shape[:-1], N, generator=g).to(BF16)
    return x, leaf, w, gy


def _run(fn, case: str):
    x, leaf, w, gy = _inputs(case)
    y = checkpoint(fn, x, w, use_reentrant=False) if case == "checkpoint" else fn(x, w)
    y.backward(gy)
    return y.detach(), x.grad, leaf.grad


CASES = ["2d", "3d", "x_f32", "no_weight_grad", "checkpoint", "tp_column", "tp_row"]


@pytest.mark.parametrize("case", CASES)
def test_the_bf16_route_equals_the_cpu_formula_bit_for_bit(case, emulated_card):
    """Output, dX and dW of the route against the formula, bit for bit, and
    each in the formula's dtype; the route's products and counter."""
    n0, c0 = len(emulated_card), counted("dense.bf16")
    got = _run(lambda x, w: dense(x, w, BF16), case)
    launched, macs = emulated_card[n0:], counted("dense.bf16") - c0
    want = _run(formula, case)
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), (name, (a.float() - b.float()).abs().max())
    forward = 2 if case == "checkpoint" else 1  # the checkpoint runs the forward again in the backward
    products = forward + 1 + (case != "no_weight_grad")
    assert launched == [BF16] * products
    assert macs == products * M * K * N


def test_the_route_keeps_only_bf16_tensors_for_the_backward(emulated_card):
    """The Function saves the bf16 x and W and nothing else; the formula
    keeps float32 copies of both."""

    def saved_by(fn):
        x, _, w, _ = _inputs("x_f32")
        kept = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: kept.append(t) or t, lambda t: t):
            fn(x, w)
        return kept

    kept = saved_by(lambda x, w: dense(x, w, BF16))
    assert [t.dtype for t in kept] == [BF16, BF16]
    assert sorted(tuple(t.shape) for t in kept) == sorted([(M, K), (K, N)])
    assert {t.dtype for t in saved_by(formula)} == {torch.float32}


def test_the_counter_stays_at_zero_off_the_card_and_at_float32(emulated_card, monkeypatch):
    """On the CPU's route, and at float32 (with amp on the emulated card
    too), no product is counted under dense.bf16."""
    x, _, w, gy = _inputs("3d")
    c0, n0 = counted("dense.bf16"), len(emulated_card)
    with amp.bf16_products(True):
        dense(x, w, torch.float32).backward(gy.float())
    assert counted("dense.bf16") == c0 and emulated_card[n0:] == [torch.float32] * 3  # amp's route
    monkeypatch.setattr(amp, "on_card", lambda t: False)
    dense(x, w, BF16).backward(gy)
    assert counted("dense.bf16") == c0 and len(emulated_card) == n0 + 3


@pytest.mark.parametrize("outer", [True, False])
def test_each_bf16_product_runs_with_reduced_precision_reductions_off(outer, emulated_card, monkeypatch):
    """The flag is off at each product, in the forward, in autograd's
    backward thread and in the checkpoint's second forward, and back at its
    value after every call, inside an amp step body (off) or outside (on)."""
    matmul = torch.backends.cuda.matmul
    seen = []

    def mm(a, b, out_dtype):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return (a.float() @ b.float()).to(out_dtype)

    monkeypatch.setattr(amp, "_mm", mm)
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = outer
    try:
        x, _, w, gy = _inputs("checkpoint")
        y = checkpoint(lambda x, w: dense(x, w, BF16), x, w, use_reentrant=False)
        assert matmul.allow_bf16_reduced_precision_reduction == outer
        y.backward(gy)
        assert matmul.allow_bf16_reduced_precision_reduction == outer
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    assert seen == [False] * 4


@pytest.mark.parametrize("remat", [False, True])
def test_a_bf16_stack_on_the_route_equals_the_cpu_stack(remat, emulated_card, monkeypatch):
    """A 2-layer bf16 encoder and decoder with dropout 0.1, forward and
    backward: every gradient through the route equals the CPU's, bit for
    bit, with and without remat."""
    cfg = T5StackConfig(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2, dtype="bfloat16", dropout=0.1,
                        remat=remat)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 10, 32, generator=g)
    mask = (torch.arange(10)[None] < torch.tensor([[10], [7], [3], [9]])).to(torch.int32)
    seeds = torch.randint(0, 2**31 - 1, (64,), generator=g, dtype=torch.int32)
    enc, dec = T5Stack(cfg, device="cpu"), T5Stack(cfg, is_decoder=True, device="cpu", site0=20)

    def grads():
        for p in (*enc.parameters(), *dec.parameters()):
            p.grad = None
        out = enc(x, mask, training=True, seeds=seeds)
        y = dec(x[:, :6], None, out, mask, training=True, seeds=seeds)
        y.square().mean().backward()
        return [p.grad.clone() for p in (*enc.parameters(), *dec.parameters())], y.detach()

    with monkeypatch.context() as m:
        m.setattr(amp, "on_card", lambda t: False)
        want, y_want = grads()
    c0 = counted("dense.bf16")
    got, y_got = grads()
    assert counted("dense.bf16") > c0
    assert torch.equal(y_got, y_want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
