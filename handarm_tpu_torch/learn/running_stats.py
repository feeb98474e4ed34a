"""Running mean/std normalization of observations and values (counterpart of
handarm_tpu/learn/running_stats.py): a Welford merge of one batch per
update, with its guards against non-finite and exploded samples."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningStats(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # scalar


def init_stats(shape, device="cpu") -> RunningStats:
    return RunningStats(mean=torch.zeros(shape, device=device),
                        var=torch.ones(shape, device=device),
                        count=torch.tensor(1e-4, device=device))


def update_stats(stats: RunningStats, batch: torch.Tensor) -> RunningStats:
    """batch: [N, ...shape] (leading axes are flattened).

    Non-finite samples become the current mean. Once the stats have seen
    more than 2N samples, finite ones are winsorized to mean +- 10 sigma
    (sigma = sqrt(var + 1e-2)), so one exploded env cannot inflate the
    variance. The batch variance is the population one, as `jnp.var`."""
    x = clean_batch(stats, batch)
    return merge_stats(stats, x.mean(dim=0), x.var(dim=0, correction=0), x.shape[0])


def clean_batch(stats: RunningStats, batch: torch.Tensor, n: int | None = None):
    """The samples `update_stats` merges: non-finite ones replaced by the
    mean, winsorized once the stats have seen more than 2n samples. `n` is
    the batch's sample count, the global one where ranks each hold a part
    of the batch (default: this batch's)."""
    x = batch.reshape((-1,) + tuple(stats.mean.shape))
    x = torch.where(torch.isfinite(x), x, stats.mean)
    sigma = torch.sqrt(stats.var + 1e-2)
    lo, hi = stats.mean - 10.0 * sigma, stats.mean + 10.0 * sigma
    n = x.shape[0] if n is None else n
    return torch.where(stats.count > 2.0 * n, torch.minimum(torch.maximum(x, lo), hi), x)


def merge_stats(stats: RunningStats, b_mean, b_var, n: int) -> RunningStats:
    """The Welford merge of a batch of n samples of mean b_mean and
    population variance b_var into the stats."""
    delta = b_mean - stats.mean
    tot = stats.count + n
    new_mean = stats.mean + delta * n / tot
    m2 = stats.var * stats.count + b_var * n + delta ** 2 * stats.count * n / tot
    return RunningStats(mean=new_mean, var=m2 / tot, count=tot)


def normalize(stats: RunningStats, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    return torch.clamp((x - stats.mean) / torch.sqrt(stats.var + 1e-5), -clip, clip)


def denormalize(stats: RunningStats, x: torch.Tensor) -> torch.Tensor:
    return x * torch.sqrt(stats.var + 1e-5) + stats.mean
