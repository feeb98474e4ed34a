"""Genesis: drop-initialized object pose pools (counterpart of
handarm_tpu/envs/genesis.py).

Each configuration drops every env's objects from staggered randomized
poses above the drop point with the robot parked in its bringup pose,
simulates `drop_steps` sim steps, then settles in chunks until the fastest
object of the whole batch moves at most 0.01 m/s (or `settle_steps` pass).
Objects that settled outside the bin are dropped again, twice, with the
others kept in place; anything still outside the workspace is placed on
the table at a spawn pose. Step counts are rounded up to whole chunks of
CHUNK sim steps (fewer when a drop or settle count is smaller, so that a
short genesis stays short) and the settle test runs once per chunk, as in
the JAX package. Every sim step
is `engine.step_exact`: dynamics, contacts (the mesh-SDF kernel) and the
solver prep (the deff kernel at fleet batch) at its own start.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import quat_from_axis_angle
from handarm_tpu_torch.physics.engine import (
    ObjectState,
    PhysicsState,
    RobotState,
    step_exact,
)

SETTLE_SPEED = 0.01  # m/s, the reference's settle criterion
CHUNK = 50  # sim steps between settle checks, as in the JAX package


class InitialPool(NamedTuple):
    """Settled object configurations: [num_configs, B, K, ...]."""

    pos: torch.Tensor
    quat: torch.Tensor
    sim_steps: int = 0  # sim steps genesis ran to build the pool


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _sample_drop_poses(env, gen: torch.Generator):
    cfg, dev = env.cfg, env.device
    B, K = cfg.num_envs, env.num_objects
    noise = _uniform(gen, (B, K, 3), -1.0, 1.0, dev) * torch.tensor(cfg.drop_noise, device=dev)
    pos = torch.tensor(cfg.drop_pos, device=dev) + noise
    # stagger the drop heights so objects do not start interpenetrating
    stagger = torch.arange(K, dtype=torch.float32, device=dev) * (
        2.5 * env.scene.shapes.bound_radius.max() + 0.02)
    pos[..., 2] += stagger
    yaw = _uniform(gen, (B, K), -np.pi, np.pi, dev)
    axis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(B, K, 3)
    return pos, quat_from_axis_angle(axis, yaw)


def objects_in_bin(env, pos: torch.Tensor) -> torch.Tensor:
    """[B, K] bool: inside the bin's box (without a bin: +/-0.25 around the
    drop point, table height - 0.01 to + 0.2)."""
    cfg = env.cfg
    cx, cy = cfg.bin_center if cfg.bin_center else cfg.drop_pos[:2]
    e = cfg.bin_half_extent if cfg.use_bin else 0.25
    zh = cfg.bin_wall_height if cfg.use_bin else 0.2
    lo = torch.tensor([cx - e, cy - e, cfg.table_height - 0.01], device=pos.device)
    hi = torch.tensor([cx + e, cy + e, cfg.table_height + zh], device=pos.device)
    return torch.all((pos >= lo) & (pos <= hi), dim=-1)


def outside_workspace(env, pos: torch.Tensor) -> torch.Tensor:
    """[B, K] bool: more than 5 cm outside the workspace box."""
    lo = torch.tensor(env.cfg.workspace_lo, device=pos.device)
    hi = torch.tensor(env.cfg.workspace_hi, device=pos.device)
    return torch.any((pos < lo - 0.05) | (pos > hi + 0.05), dim=-1)


def _sim_chunk(env, state: PhysicsState, chunk: int):
    """`chunk` sim steps; returns (state, max object speed of the batch)."""
    for _ in range(chunk):
        state, _ = step_exact(env.scene, state)
    return state, torch.linalg.vector_norm(state.objects.linvel, dim=-1).max()


def _drop_once(env, gen, drop_steps: int, settle_steps: int, chunk: int,
               pos0=None, quat0=None, keep=None):
    """Drop and settle once. With `keep` [B, K], kept objects start from
    (pos0, quat0) instead of a fresh drop pose. Returns (pos, quat, steps)."""
    B, K, nv, dev = env.cfg.num_envs, env.num_objects, env.art.nv, env.device
    pos, quat = _sample_drop_poses(env, gen)
    if keep is not None:
        pos = torch.where(keep[..., None], pos0, pos)
        quat = torch.where(keep[..., None], quat0, quat)
    q0 = torch.as_tensor(env.robot.bringup_q, dtype=torch.float32, device=dev).expand(B, nv)
    state = PhysicsState(
        robot=RobotState(q=q0.clone(), qd=torch.zeros(B, nv, device=dev), targets=q0.clone()),
        objects=ObjectState(pos=pos, quat=quat, linvel=torch.zeros(B, K, 3, device=dev),
                            angvel=torch.zeros(B, K, 3, device=dev)),
        contact_impulse=torch.zeros(B, env.scene.slots.num_slots, 3, device=dev),
    )
    steps = 0
    for _ in range(-(-drop_steps // chunk)):
        state, _ = _sim_chunk(env, state, chunk)
        steps += chunk
    for _ in range(-(-settle_steps // chunk)):
        state, speed = _sim_chunk(env, state, chunk)
        steps += chunk
        if float(speed) <= SETTLE_SPEED:
            break
    return state.objects.pos, state.objects.quat, steps


def build_initial_pool(env, gen: torch.Generator, num_configurations: int = 1,
                       drop_steps: int = 100, settle_steps: int = 600) -> InitialPool:
    """`num_configurations` settled configurations of every env's objects."""
    chunk = max(1, min(CHUNK, drop_steps, settle_steps))
    pos_all, quat_all, steps = [], [], 0
    for _ in range(num_configurations):
        pos, quat, n = _drop_once(env, gen, drop_steps, settle_steps, chunk)
        steps += n
        for _attempt in range(2):  # re-drop what landed outside the bin
            pos, quat, n = _drop_once(env, gen, drop_steps, settle_steps, chunk,
                                      pos0=pos, quat0=quat, keep=objects_in_bin(env, pos))
            steps += n
        bad = outside_workspace(env, pos)
        fb_pos, fb_quat = env._sample_object_poses(env.cfg.num_envs, gen)
        pos_all.append(torch.where(bad[..., None], fb_pos, pos))
        quat_all.append(torch.where(bad[..., None], fb_quat, quat))
    return InitialPool(torch.stack(pos_all), torch.stack(quat_all), steps)
