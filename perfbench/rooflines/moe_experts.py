"""A MoE block's expert products (rqvae_tpu_torch/models/moe.py, the three
`torch._grouped_mm` calls over the held experts, forward and backward): the
least work of one block's call, from its shapes.

  forward   gate, up = rows @ W_gate[e], rows @ W_up[e];  y = a @ W_down[e]
  backward  each product's two gradients (of its rows and of its weights)

Operations: 9 products of 2 * rows * d * f each (rows: the rows routed to
the held experts, `moe.rows`). Bytes, at the compute dtype: each of the 9
products reads or writes every held expert's weight or weight gradient
([E_held, d, f]) once, and its row operands once: rows x (d + f) elements
read or written per product.
"""

ELEMENT = {"bfloat16": 2, "float32": 4}


def work(shape: dict) -> tuple:
    """(operations, bytes) of one block's call at `shape`: rows, d, f, experts, dtype."""
    rows, d, f, e = shape["rows"], shape["d"], shape["f"], shape["experts"]
    flops = 9 * 2.0 * rows * d * f
    nbytes = ELEMENT[shape["dtype"]] * 9 * (e * d * f + rows * (d + f))
    return flops, nbytes
