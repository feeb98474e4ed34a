"""The domain-randomization and ADR configuration records (copies of the
dataclasses of handarm_tpu/envs/randomization.py and handarm_tpu/envs/adr.py,
with their defaults). Only the records are ported: `HandArmConfig` holds
them, and refuses `enabled=True` until DR and ADR are (ROADMAP §1.2a)."""

from __future__ import annotations

from dataclasses import dataclass, field


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
    mass_scale_range: tuple = (1.0, 1.0)
    friction_scale_range: tuple = (1.0, 1.0)
    gain_scale_range: tuple = (1.0, 1.0)
    gravity_noise: float = 0.0
    disturbance_probability: float = 0.0
    disturbance_magnitude: float = 0.0
    schedule_steps: int = 0


@dataclass(frozen=True)
class AdrConfig:
    enabled: bool = False
    names: tuple = ("mass_scale", "friction_scale", "gain_scale", "gravity_z")
    init_lo: tuple = (1.0, 1.0, 1.0, 0.0)
    init_hi: tuple = (1.0, 1.0, 1.0, 0.0)
    limit_lo: tuple = (0.3, 0.3, 0.6, -2.0)
    limit_hi: tuple = (3.0, 3.0, 1.6, 2.0)
    delta: tuple = (0.05, 0.05, 0.04, 0.1)
    boundary_fraction: float = 0.4
    queue_len: int = 256
    objective_lo: float = 0.05
    objective_hi: float = 0.5
