"""Kernel 4, the fused T5 attention forward (csrc/attention.cu): the least
work its function needs, from its shapes.

  out = dropout(softmax(q k^T + bias + mask)) v   per (batch row, head)

Operations: the two products, 2 * 2 * B * H * Lq * Lk * dk. Bytes: q, k, v
and the output at the compute dtype, the float32 [H, Lq, Lk] bias and the
int32 [B, Lk] key mask, each read or written once.
"""

ELEMENT = {"bfloat16": 2, "float32": 4}


def work(shape: dict) -> tuple:
    """(operations, bytes) of one call at `shape`: B, H, Lq, Lk, dk, dtype."""
    B, H, Lq, Lk, dk = (shape[k] for k in ("B", "H", "Lq", "Lk", "dk"))
    e = ELEMENT[shape["dtype"]]
    flops = 4.0 * B * H * Lq * Lk * dk
    nbytes = e * B * H * (2 * Lq + 2 * Lk) * dk + 4.0 * H * Lq * Lk + 4.0 * B * Lk
    return flops, nbytes
