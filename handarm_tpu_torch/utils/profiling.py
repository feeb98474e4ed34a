"""Tracing and phase timing (counterpart of handarm_tpu/utils/profiling.py).

- `trace(logdir)`: a `torch.profiler` trace of the CPU and, where there is
  one, the card, written as a Chrome trace file under `logdir`.
- `annotate(name)`: a named range in such a trace
  (`torch.profiler.record_function`).
- `PhaseTimer`: wall-clock means of named phases; a phase given a
  `sync_result` waits for that tensor's device before the clock is read.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str = "runs/profile"):
    """Profile the block; on exit write `<logdir>/trace_<pid>.json` (open it
    in chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """A named range visible in `trace`'s output."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Wall-clock phase timing with device sync and running means."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_result=None):
        """Time the block; the devices of `sync_result`'s tensors (a tensor
        or a tree of them) finish their work before the clock is read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in {x.device for x in tree_leaves(sync_result)
                        if torch.is_tensor(x) and x.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def means_ms(self) -> dict[str, float]:
        return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f}ms" for k, v in sorted(self.means_ms().items()))

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
