"""Kernel 2, the T5 decoder stack at inference (csrc/decoder_stack.cu): one
call runs every decoder layer and the final norm for B batch rows, each of
`beams` beams of T positions, against cached cross-attention K and V over
Le encoder rows. The least work its function needs, from its shapes:

Operations, per layer and per position: the q, k, v, o projections of
self-attention (4 * 2 * d * H dk), causal attention within its beam
(2 * 2 * (T + 1) / 2 * H dk on average over its T positions), the cross-attention's q and o projections
(2 * 2 * d * H dk) and its attention over Le (2 * 2 * Le * H dk), the
feed-forward (2 * 2 * d * d_ff). Bytes: every layer's weights at the
compute dtype, the inputs at the compute dtype, the cached K and V, the
float32 bias over the folded positions and the key mask, the float32 output.
"""

ELEMENT = {"bfloat16": 2, "float32": 4}


def work(shape: dict) -> tuple:
    """(operations, bytes) of one call: B, beams, T, Le, d, H, dk, dff, layers, dtype."""
    B, beams, T, Le = shape["B"], shape["beams"], shape["T"], shape["Le"]
    d, H, dk, dff, NL = shape["d"], shape["H"], shape["dk"], shape["dff"], shape["layers"]
    e = ELEMENT[shape["dtype"]]
    inner, kT = H * dk, beams * T
    per_pos = 8.0 * d * inner + 2.0 * (T + 1) * inner + 4.0 * d * inner + 4.0 * Le * inner + 4.0 * d * dff
    flops = NL * B * kT * per_pos
    weights = NL * (6 * d * inner + 2 * d * dff) * e + NL * 3 * d * 4 + d * 4
    nbytes = weights + B * kT * d * e + NL * 2 * B * H * Le * dk * e + 4.0 * H * kT * kT + 4.0 * B * Le \
        + 4.0 * B * kT * d
    return flops, nbytes
