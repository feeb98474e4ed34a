"""Training metrics: one `metrics.jsonl` line per iteration (`step`, `t`
seconds since the logger opened, then the stats), and TensorBoard scalars
when `tensorboardX` imports (counterpart of handarm_tpu/utils/logging.py,
without its wandb sink)."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(os.path.join(run_dir, "tb"))
        self.t0 = time.time()

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "t": round(time.time() - self.t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
