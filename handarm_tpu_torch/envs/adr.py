"""Adaptive domain randomization (counterpart of handarm_tpu/envs/adr.py:
DeXtreme's ADR, OpenAI's Algorithm 1).

The whole ADR state is a few tensors updated inside the env step:

- every env is a worker: a rollout worker draws each parameter uniformly
  in the current [lo, hi] range; a boundary worker pins one parameter at
  one of its bounds (mode = 2 p + side) and measures the objective there;
- finished boundary episodes add their objective into per-(parameter,
  side) queues;
- when a queue holds `queue_len` samples, its bound moves: a mean above
  `objective_hi` pushes it outward by `delta`, below `objective_lo` pulls
  it back in, clipped between `limit_*` and `init_*`; the queues that
  moved are cleared;
- finished envs are recycled with fresh modes and values, drawn from the
  new range.

The random functions take a `torch.Generator` or the draws themselves
(`AdrDraws`), so a test can pass in the JAX package's. `worker_mode` is
int64 here and int32 in a checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class AdrConfig:
    enabled: bool = False
    # the per-env physical parameters, in this order: mass_scale,
    # friction_scale, gain_scale (multipliers, init 1.0) and gravity_z
    # (additive m/s^2, init 0.0)
    names: tuple = ("mass_scale", "friction_scale", "gain_scale", "gravity_z")
    init_lo: tuple = (1.0, 1.0, 1.0, 0.0)
    init_hi: tuple = (1.0, 1.0, 1.0, 0.0)
    limit_lo: tuple = (0.3, 0.3, 0.6, -2.0)
    limit_hi: tuple = (3.0, 3.0, 1.6, 2.0)
    delta: tuple = (0.05, 0.05, 0.04, 0.1)
    boundary_fraction: float = 0.4  # share of boundary workers
    queue_len: int = 256  # samples that move a bound
    objective_lo: float = 0.05  # pull the bound back in below this
    objective_hi: float = 0.5  # push the bound outward above this

    @property
    def P(self) -> int:
        return len(self.names)


class AdrState(NamedTuple):
    lo: torch.Tensor  # [P] the ranges' lower bounds
    hi: torch.Tensor  # [P]
    worker_mode: torch.Tensor  # [B] int64: -1 rollout, else 2 p + side
    values: torch.Tensor  # [B, P] the parameters in play
    q_sum: torch.Tensor  # [2P] objective sums per (parameter, side)
    q_cnt: torch.Tensor  # [2P]


class AdrDraws(NamedTuple):
    """The draws of one recycling: U(0, 1) against the boundary fraction,
    the boundary mode in [0, 2P), U(0, 1) per parameter value."""

    boundary_u: torch.Tensor  # [B]
    mode: torch.Tensor  # [B] integer
    values_u: torch.Tensor  # [B, P]


def adr_draws(cfg: AdrConfig, B: int, gen: torch.Generator, device) -> AdrDraws:
    return AdrDraws(torch.rand((B,), generator=gen, device=device),
                    torch.randint(0, 2 * cfg.P, (B,), generator=gen, device=device),
                    torch.rand((B, cfg.P), generator=gen, device=device))


def _assign_modes(cfg: AdrConfig, d: AdrDraws) -> torch.Tensor:
    return torch.where(d.boundary_u < cfg.boundary_fraction, d.mode.to(torch.int64),
                       torch.full_like(d.mode, -1, dtype=torch.int64))


def _sample_values(cfg: AdrConfig, lo, hi, mode, u) -> torch.Tensor:
    """values[b, p] ~ U(lo_p, hi_p), but env b's own boundary parameter,
    which is pinned to the bound it evaluates."""
    vals = lo[None] + u * (hi - lo)[None]
    p_idx = torch.clamp(torch.div(mode, 2, rounding_mode="floor"), 0, cfg.P - 1)
    pinned = torch.where(mode % 2 == 0, lo[p_idx], hi[p_idx])
    onehot = torch.nn.functional.one_hot(p_idx, cfg.P).to(vals.dtype) * (mode >= 0)[:, None]
    return vals * (1.0 - onehot) + onehot * pinned[:, None]


def init_adr_state(cfg: AdrConfig, B: int, gen=None, draws: AdrDraws | None = None,
                   device=None) -> AdrState:
    """Ranges at their initial bounds, empty queues, B workers assigned."""
    if draws is None:
        draws = adr_draws(cfg, B, gen, device)
    dev = draws.values_u.device
    lo = torch.tensor(cfg.init_lo, dtype=torch.float32, device=dev)
    hi = torch.tensor(cfg.init_hi, dtype=torch.float32, device=dev)
    mode = _assign_modes(cfg, draws)
    zeros = torch.zeros(2 * cfg.P, device=dev)
    return AdrState(lo, hi, mode, _sample_values(cfg, lo, hi, mode, draws.values_u),
                    zeros, zeros.clone())


def adr_step(cfg: AdrConfig, s: AdrState, done, objective, gen=None,
             draws: AdrDraws | None = None, group=None) -> AdrState:
    """One env step of ADR: queue the finished boundary episodes' objective,
    move the ranges whose queues are full, recycle the finished envs. Every
    leaf of the result replaces the old state's (none is merged by done).
    `group`: the rank's DataParallel when `done` holds one rank's envs; the
    queues then take every rank's contributions (one all-reduce of [4P]),
    so the ranges move alike on every rank."""
    P, dev = cfg.P, done.device
    if draws is None:
        draws = adr_draws(cfg, done.shape[0], gen, dev)
    contrib = (done & (s.worker_mode >= 0)).to(torch.float32)
    slot = torch.clamp(s.worker_mode, 0, 2 * P - 1)
    if group is None:
        q_sum = s.q_sum.scatter_add(0, slot, contrib * objective)
        q_cnt = s.q_cnt.scatter_add(0, slot, contrib)
    else:
        zero = torch.zeros_like(s.q_sum)
        adds = group.all_reduce(torch.cat([zero.scatter_add(0, slot, contrib * objective),
                                           zero.scatter_add(0, slot, contrib)]), "adr")
        q_sum, q_cnt = s.q_sum + adds[:2 * P], s.q_cnt + adds[2 * P:]

    ready = q_cnt >= cfg.queue_len
    mean = q_sum / torch.clamp(q_cnt, min=1.0)
    expand = ready & (mean > cfg.objective_hi)
    shrink = ready & (mean < cfg.objective_lo)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    delta = t(cfg.delta)
    ex, sh = expand.reshape(P, 2).to(torch.float32), shrink.reshape(P, 2).to(torch.float32)
    # a low bound (even mode) moves down to expand and up to shrink
    lo = s.lo - delta * ex[:, 0] + delta * sh[:, 0]
    hi = s.hi + delta * ex[:, 1] - delta * sh[:, 1]
    lo = torch.minimum(torch.maximum(lo, t(cfg.limit_lo)), t(cfg.init_lo))
    hi = torch.minimum(torch.maximum(hi, t(cfg.init_hi)), t(cfg.limit_hi))
    moved = ready & (expand | shrink)
    q_sum = torch.where(moved, torch.zeros_like(q_sum), q_sum)
    q_cnt = torch.where(moved, torch.zeros_like(q_cnt), q_cnt)

    mode = torch.where(done, _assign_modes(cfg, draws), s.worker_mode)
    fresh = _sample_values(cfg, lo, hi, mode, draws.values_u)
    values = torch.where(done[:, None], fresh, s.values)
    return AdrState(lo, hi, mode, values, q_sum, q_cnt)


def adr_entropy(s: AdrState) -> torch.Tensor:
    """Sum of the log range widths (floored at 1e-6): ADR's progress in
    nats."""
    return torch.sum(torch.log(torch.clamp(s.hi - s.lo, min=1e-6)))
