"""Debug mode: NaN guards and finite checks (port of rqvae_tpu/utils/debug.py).

`RQVAE_TPU_DEBUG=1` is honoured as the JAX package honours it: the trainers
call `maybe_init_debug()` at start-up, which turns on autograd's anomaly
detection (`torch.autograd.set_detect_anomaly`, the counterpart of
`jax_debug_nans`: a NaN made in the backward pass raises at the op that made
it, with the forward's trace), and `assert_finite` checks each logged metric
dict. Anomaly mode cannot be captured in a CUDA graph, so with debug on the
trainers run one step per chunk (`steps_per_loop=1`), eagerly, and say so.
"""

from __future__ import annotations

import math
import os

import torch


def debug_enabled() -> bool:
    return os.environ.get("RQVAE_TPU_DEBUG", "0") not in ("0", "", "false")


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd anomaly detection: a backward op that makes a NaN raises."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def assert_finite(tree, context: str = "") -> None:
    """Host-side finite check over a dict / list of tensors and floats."""
    for name, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf.detach()).all())
        elif isinstance(leaf, float):
            bad = not math.isfinite(leaf)
        else:
            continue
        if bad:
            raise FloatingPointError(f"non-finite values in {context}:{name}")


def maybe_init_debug() -> bool:
    """Called by the trainers at start-up; honours RQVAE_TPU_DEBUG=1.
    Returns whether debug mode is on."""
    on = debug_enabled()
    if on:
        enable_nan_checks(True)
    return on
