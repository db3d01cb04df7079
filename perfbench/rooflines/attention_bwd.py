"""Kernel 5, the fused T5 attention backward (csrc/attention_bwd.cu): the
least work its function needs, from its shapes.

Given q, k, v, the bias, the mask and d(out), it returns dq, dk, dv and the
bias gradient summed over the batch. Operations: the four products a
backward needs once the weights are known (d(v) = p^T d(out),
d(p) = d(out) v^T, dq = ds k, dk = ds^T q), 4 * 2 * B * H * Lq * Lk * dk;
recomputing the weights is the implementation's choice and is not counted.
Bytes: q, k, v, d(out) read and dq, dk, dv written at the compute dtype, the
float32 bias read and its gradient written, the int32 mask read.
"""

ELEMENT = {"bfloat16": 2, "float32": 4}


def work(shape: dict) -> tuple:
    """(operations, bytes) of one call at `shape`: B, H, Lq, Lk, dk, dtype."""
    B, H, Lq, Lk, dk = (shape[k] for k in ("B", "H", "Lq", "Lk", "dk"))
    e = ELEMENT[shape["dtype"]]
    flops = 8.0 * B * H * Lq * Lk * dk
    nbytes = e * B * H * (4 * Lq + 4 * Lk) * dk + 8.0 * H * Lq * Lk + 4.0 * B * Lk
    return flops, nbytes
