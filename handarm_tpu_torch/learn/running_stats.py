"""Running mean/std observation normalization (counterpart of
handarm_tpu/learn/running_stats.py; the update belongs to the learner and
is not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningStats(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # scalar


def normalize(stats: RunningStats, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    return torch.clamp((x - stats.mean) / torch.sqrt(stats.var + 1e-5), -clip, clip)
