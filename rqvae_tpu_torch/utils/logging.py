"""Metric logging: rolling means, JSONL sink, optional wandb (the port's own
copy of rqvae_tpu/utils/logging.py).

1000-sample rolling loss windows; JSONL is the always-on local sink, so runs
are inspectable without external services; wandb is used only when asked for
and present.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        use_wandb: bool = False,
        wandb_project: str = "rqvae-tpu-torch",
        wandb_config: Optional[dict] = None,
        window: int = 1000,
        is_main: bool = True,
    ):
        self.is_main = is_main
        self.window = window
        self.rolling: Dict[str, collections.deque] = {}
        self._jsonl = None
        self._wandb = None
        if not is_main:
            return
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb

                wandb.login()
                self._wandb = wandb.init(project=wandb_project, config=wandb_config)
            except Exception as e:  # wandb absent or offline: degrade gracefully
                print(f"[logging] wandb unavailable ({e}); continuing with JSONL only")

    def push_rolling(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self.rolling.setdefault(k, collections.deque(maxlen=self.window)).append(float(v))

    def rolling_means(self) -> Dict[str, float]:
        return {k: sum(d) / len(d) for k, d in self.rolling.items() if d}

    def log(self, step: int, metrics: Dict[str, float], echo: bool = False) -> None:
        if not self.is_main:
            return
        record = {"step": int(step), "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if echo:
            # record already coerced every value with float(); reuse it so
            # numpy and tensor scalars echo too
            parts = ", ".join(
                f"{k}: {v:.4f}" for k, v in record.items() if k not in ("step", "time")
            )
            print(f"[{step}] {parts}", file=sys.stderr)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
