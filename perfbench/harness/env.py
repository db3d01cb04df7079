"""The run's surroundings: when the process started, the build and kernel
caches at fixed paths inside the checkout, the card, and the modules that
must not be loaded."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

BANNED = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "rqvae_tpu"})
CACHE = ".perfbench_cache"


def process_start_time() -> float:
    """time.time() at which this process started (Linux /proc), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def set_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path in the checkout (the
    port's nvcc builds sit in rqvae_tpu_torch/_build/ there already), and
    no library loads JAX by itself."""
    base = root / CACHE
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def banned_loaded() -> list:
    """Top-level names, compared whole, of banned modules in sys.modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def card_limits() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not read"
