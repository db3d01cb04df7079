"""Kernel 3, the T5 encoder stack at inference (csrc/encoder_stack.cu): one
call runs every encoder layer and the final norm over B rows of L tokens.
The least work its function needs, from its shapes:

Operations, per layer: the q, k, v, o projections (4 * 2 * B * L * d * H dk),
attention (2 * 2 * B * H * L * L * dk), the feed-forward
(2 * 2 * B * L * d * d_ff). Bytes: every layer's weights at the compute
dtype, the input at the compute dtype, the float32 [H, L, L] bias and [B, L]
mask, the float32 output.
"""

ELEMENT = {"bfloat16": 2, "float32": 4}


def work(shape: dict) -> tuple:
    """(operations, bytes) of one call: B, L, d, H, dk, dff, layers, dtype."""
    B, L, d, H, dk, dff, NL = (shape[k] for k in ("B", "L", "d", "H", "dk", "dff", "layers"))
    e = ELEMENT[shape["dtype"]]
    inner = H * dk
    flops = NL * (8.0 * B * L * d * inner + 4.0 * B * H * L * L * dk + 4.0 * B * L * d * dff)
    weights = NL * (4 * d * inner + 2 * d * dff) * e + NL * 2 * d * 4 + d * 4
    nbytes = weights + B * L * d * e + 4.0 * H * L * L + 4.0 * B * L + 4.0 * B * L * d
    return flops, nbytes
