"""Domain randomization as per-env tensors (counterpart of
handarm_tpu/envs/randomization.py).

Every randomized quantity is a per-env tensor drawn at reset and read by
the step: object mass and friction scales, PD gain scales and a gravity
offset (`DRState`, frozen per episode), and observation and action noise
(a per-episode correlated draw plus a fresh per-step draw), ramped by a
linear schedule over env steps.

Every random function takes either a `torch.Generator` or the standard
draws themselves: N(0, 1) for a gaussian channel and the gravity offset,
U(0, 1) for a uniform channel and the scale ranges. The draws are mapped
exactly as the JAX package maps its own (`jax.random.uniform` returns
`max(lo, u * (hi - lo) + lo)`), so a test can pass in the JAX package's
draws and compare.

`AdrConfig` lives in `envs/adr.py`; it is re-exported here for the imports
that found it here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from handarm_tpu_torch.envs.adr import AdrConfig  # noqa: F401  (re-export)


@dataclass(frozen=True)
class NoiseSpec:
    """One noise channel. op: 'additive' | 'scaling';
    dist: 'gaussian' | 'uniform'."""

    dist: str = "gaussian"
    op: str = "additive"
    amount: float = 0.0  # std (gaussian) or half-range (uniform)
    correlated: float = 0.0  # per-episode-frozen component


@dataclass(frozen=True)
class DRConfig:
    enabled: bool = False
    observation_noise: NoiseSpec = field(default_factory=NoiseSpec)
    action_noise: NoiseSpec = field(default_factory=NoiseSpec)
    mass_scale_range: tuple = (1.0, 1.0)  # uniform multiplier per env x object
    friction_scale_range: tuple = (1.0, 1.0)
    gain_scale_range: tuple = (1.0, 1.0)  # PD gain multiplier per env x dof
    gravity_noise: float = 0.0  # additive m/s^2 per env (z)
    disturbance_probability: float = 0.0
    disturbance_magnitude: float = 0.0
    schedule_steps: int = 0  # strength ramps 0 -> 1 over this many env steps (0: full)


class DRState(NamedTuple):
    """Per-env frozen randomizations, drawn anew on reset. The same record
    carries the standard draws a state is made from (`init_dr_state`)."""

    mass_scale: torch.Tensor  # [B, K]
    friction_scale: torch.Tensor  # [B]
    gain_scale: torch.Tensor  # [B, nv]
    gravity_z: torch.Tensor  # [B]
    obs_corr: torch.Tensor  # [B, obs_dim] correlated observation-noise draw
    act_corr: torch.Tensor  # [B, act_dim]


def standard_draws(dist: str, shape, gen: torch.Generator, device) -> torch.Tensor:
    """N(0, 1) for 'gaussian', else U(0, 1), from `gen`."""
    if dist == "gaussian":
        return torch.randn(shape, generator=gen, device=device)
    return torch.rand(shape, generator=gen, device=device)


def uniform_range(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """U(lo, hi) from U(0, 1) draws, as `jax.random.uniform` maps them."""
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def draw(spec: NoiseSpec, shape, gen=None, std=None, device=None, corr: bool = False):
    """One draw of a noise channel: the correlated amount with `corr`, else
    the per-step one; 1 + x for a scaling channel. `std` holds the standard
    draws, else they come from `gen`."""
    if std is None:
        std = standard_draws(spec.dist, shape, gen, device)
    amt = spec.correlated if corr else spec.amount
    x = amt * std if spec.dist == "gaussian" else uniform_range(std, -amt, amt)
    return 1.0 + x if spec.op == "scaling" else x


def init_dr_state(cfg: DRConfig, B: int, K: int, nv: int, obs_dim: int, act_dim: int,
                  gen=None, std: DRState | None = None, device=None) -> DRState:
    """A fresh DRState for B envs; `std` (a DRState of standard draws:
    U(0, 1) for the three scales, N(0, 1) for gravity, the channels' own
    for the two correlated draws) replaces the generator's."""
    if std is None:
        u = lambda *s: torch.rand(s, generator=gen, device=device)
        std = DRState(u(B, K), u(B), u(B, nv), torch.randn((B,), generator=gen, device=device),
                      standard_draws(cfg.observation_noise.dist, (B, obs_dim), gen, device),
                      standard_draws(cfg.action_noise.dist, (B, act_dim), gen, device))
    return DRState(
        mass_scale=uniform_range(std.mass_scale, *cfg.mass_scale_range),
        friction_scale=uniform_range(std.friction_scale, *cfg.friction_scale_range),
        gain_scale=uniform_range(std.gain_scale, *cfg.gain_scale_range),
        gravity_z=cfg.gravity_noise * std.gravity_z,
        obs_corr=draw(cfg.observation_noise, None, std=std.obs_corr, corr=True),
        act_corr=draw(cfg.action_noise, None, std=std.act_corr, corr=True),
    )


def schedule_strength(cfg: DRConfig, total_steps):
    """The schedule's strength in [0, 1] after `total_steps` env steps (1.0
    without a schedule)."""
    if cfg.schedule_steps <= 0:
        return 1.0
    return torch.clamp(total_steps / cfg.schedule_steps, 0.0, 1.0)


def apply_noise(spec: NoiseSpec, x, corr_draw, strength=1.0, gen=None, std=None):
    """x with a per-call draw (from `std`, else `gen`) and the episode's
    correlated draw; x itself when the channel has no noise."""
    if spec.amount == 0.0 and spec.correlated == 0.0:
        return x
    un = draw(spec, x.shape, gen, std, x.device)
    if spec.op == "scaling":
        return x * (1.0 + strength * (un - 1.0)) * (1.0 + strength * (corr_draw - 1.0))
    return x + strength * (un + corr_draw)


def merge_on_reset(done, fresh: DRState, old: DRState) -> DRState:
    """The fresh draws where an env is done, the old elsewhere."""
    def w(new, prev):
        return torch.where(done.reshape(done.shape + (1,) * (new.dim() - 1)), new, prev)

    return DRState(*(w(n, o) for n, o in zip(fresh, old)))
