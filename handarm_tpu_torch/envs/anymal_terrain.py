"""ANYmal rough-terrain locomotion with a curriculum (counterpart of
handarm_tpu/envs/anymal_terrain.py; reference IsaacGymEnvs
tasks/anymal_terrain.py, cfg/task/AnymalTerrain.yaml).

The flat ANYmal task (`envs/anymal.py`) over a procedural heightfield
(`physics/terrain.py`, on the device: 2.46 MB at the default 6 levels x 10
types), which the contacts sample bilinearly (`physics.contacts`
`_heightfield_surface`), with:

- 188 observations, 140 of them the terrain heights under a yaw-rotated
  14 x 10 grid about the base;
- the full reward set: velocity tracking, z and roll-pitch penalties,
  torque, joint acceleration, knee contacts, action rate and the feet's air
  time, clamped at 0;
- the terrain curriculum: an env that times out after walking over half a
  patch moves a level up, one that walked under a quarter of its commanded
  distance a level down;
- a push every `push_interval` steps, which overwrites qd[:, 0:2]: the
  origin-Plücker linear velocity, as the JAX package does, not the base
  point's velocity.

The env holds its state on one device and draws from its own
torch.Generator, seeded by `reset(seed)`; `reset` takes `ATDraws` (and the
episodes' random progress) and `step` takes `ATDraws` and the push
velocities in place of those draws (a test hands over the JAX package's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.anymal import (
    anymal_scene,
    applied_torque,
    base_velocities,
    projected_gravity,
)
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, where_done
from handarm_tpu_torch.physics.contacts import StaticGeom, heightfield_taps
from handarm_tpu_torch.physics.engine import PhysicsState, initial_state, step as engine_step
from handarm_tpu_torch.physics.terrain import Heightfield, generate_terrain


@dataclass(frozen=True)
class AnymalTerrainConfig:
    num_envs: int = 256
    episode_length: int = 1000
    dt: float = 1.0 / 60.0
    substeps: int = 2
    action_scale: float = 0.5
    kp: float = 80.0  # AnymalTerrain.yaml control block
    kd: float = 2.0
    # terrain
    num_levels: int = 6
    num_types: int = 10
    map_length: float = 8.0
    curriculum: bool = True
    max_init_level: int = 0
    # commands (yaml randomCommandVelocityRanges)
    cmd_lin_x: tuple = (-1.0, 1.0)
    cmd_lin_y: tuple = (-1.0, 1.0)
    cmd_yaw: tuple = (-3.14, 3.14)
    # reward scales (yaml learn block), dt-scaled
    r_lin_xy: float = 1.0
    r_lin_z: float = -4.0
    r_ang_xy: float = -0.05
    r_ang_z: float = 0.5
    r_torque: float = -0.00002
    r_joint_acc: float = -0.0005
    r_air_time: float = 1.0
    r_knee_collision: float = -0.25
    r_action_rate: float = -0.01
    allow_knee_contacts: bool = True
    # obs scales
    lin_vel_scale: float = 2.0
    ang_vel_scale: float = 0.25
    dof_pos_scale: float = 1.0
    dof_vel_scale: float = 0.05
    height_scale: float = 5.0
    base_height: float = 0.62
    push_interval: int = 900  # steps (15 s)
    push_vel: float = 1.0


class ATState(NamedTuple):
    """The JAX package's ATState without its PRNG key."""

    physics: PhysicsState
    progress: torch.Tensor  # [B] int64
    commands: torch.Tensor  # [B, 3]
    actions: torch.Tensor  # [B, 12]
    last_qd: torch.Tensor  # [B, 12]
    feet_air_time: torch.Tensor  # [B, 4]
    terrain_level: torch.Tensor  # [B] int64
    spawn_xy: torch.Tensor  # [B, 2] the episode's start


class ATDraws(NamedTuple):
    """The draws of fresh episodes: `cmd` [B, 3] uniform in [0, 1) (scaled
    into the command ranges, then zeroed under 0.25 m/s), `scale` [B, nv]
    in [0.5, 1.5) (the default joint angles' scale), `xy` [B, 2] in [-0.5,
    0.5) (the spawn's offset from its patch centre) and `level` [B] int in
    [0, max_init_level] (read only by a reset: a step restarts an episode at
    its env's curriculum level)."""

    cmd: torch.Tensor
    scale: torch.Tensor
    xy: torch.Tensor
    level: torch.Tensor


class AnymalTerrainEnv:
    """Engine-backed ANYmal over the curriculum terrain (the PPO contract:
    reset, step, num_obs, num_actions, cfg.num_envs)."""

    state_type = ATState

    def __init__(self, cfg: AnymalTerrainConfig = AnymalTerrainConfig(), device=None,
                 group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.terrain: Heightfield = generate_terrain(
            num_levels=cfg.num_levels, num_types=cfg.num_types, length=cfg.map_length,
            width=cfg.map_length)
        t = self.terrain

        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        # the heightfield replaces the table and the plane
        geom = StaticGeom(table_lo=f32([-1e4, -1e4]), table_hi=f32([-9e3, -9e3]),
                          table_height=0.0, hf_height=f32(t.height),
                          hf_cell=float(t.cell), hf_origin=f32(t.origin))
        self.art, self.scene, self.default_q, self._effort = anymal_scene(cfg, geom, dev)
        art = self.art
        nj = art.nv - 6
        feet = [art.sites[n].body for n in art.sites if "FOOT" in n and art.sites[n].body >= 0]
        self.feet_bodies = np.unique(np.array(feet, np.int32))
        knees = [art.sites[n].body for n in art.sites
                 if "THIGH" in n and art.sites[n].body >= 0]
        self.knee_bodies = np.unique(np.array(knees, np.int32))
        self._feet = torch.as_tensor(self.feet_bodies.astype(np.int64), device=dev)
        self._knees = torch.as_tensor(self.knee_bodies.astype(np.int64), device=dev)
        self.base_body = 0
        self.env_origins = torch.as_tensor(t.env_origins.reshape(-1, 3), device=dev)
        # the height grid: x in +-(0.2..0.8), y in +-(0.1..0.5): 14 x 10 points
        hx = 0.1 * np.array([-8, -7, -6, -5, -4, -3, -2, 2, 3, 4, 5, 6, 7, 8])
        hy = 0.1 * np.array([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5])
        gx, gy = np.meshgrid(hx, hy, indexing="ij")
        self.height_points = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1),
                                             dtype=torch.float32, device=dev)
        self.num_height_points = 140
        self.num_actions = nj
        self.num_obs = 12 + 3 * nj + self.num_height_points  # 188
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self._cmd_lo = torch.tensor([cfg.cmd_lin_x[0], cfg.cmd_lin_y[0], cfg.cmd_yaw[0]],
                                    device=dev)
        self._cmd_hi = torch.tensor([cfg.cmd_lin_x[1], cfg.cmd_lin_y[1], cfg.cmd_yaw[1]],
                                    device=dev)
        self._cmd_scale = torch.tensor([cfg.lin_vel_scale, cfg.lin_vel_scale,
                                        cfg.ang_vel_scale], device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- terrain helpers ---------------------------------------------------

    def _terrain_height(self, xy):
        """Bilinear terrain height at world xy [..., 2] (from the field's
        pixel (0, 0) at the world origin, as the JAX env reads it: it does
        not offset by hf_origin, which the generator sets to 0)."""
        cell = self.terrain.cell
        return heightfield_taps(self.scene.geom.hf_height, xy[..., 0] / cell,
                                xy[..., 1] / cell)[-1]

    def _origin_for(self, level, type_idx):
        return self.env_origins[level * self.cfg.num_types + type_idx]

    def _types(self, B: int):
        return torch.arange(B, device=self.device) % self.cfg.num_types

    # --- state construction ---------------------------------------------

    def draw(self, B: int) -> ATDraws:
        u = lambda *s: torch.rand(s, generator=self.gen, device=self.device)
        return ATDraws(cmd=u(B, 3), scale=0.5 + u(B, self.art.nv), xy=u(B, 2) - 0.5,
                       level=torch.randint(0, self.cfg.max_init_level + 1, (B,),
                                           generator=self.gen, device=self.device))

    def draw_push(self, B: int):
        """[B, 2] push velocities, uniform in +-push_vel."""
        v = self.cfg.push_vel
        return torch.rand(B, 2, generator=self.gen, device=self.device) * (2 * v) - v

    def _fresh(self, B: int, draws: ATDraws | None = None, level=None) -> ATState:
        cfg = self.cfg
        d = draws if draws is not None else self.draw(B)
        if level is None:
            level = d.level
        origin = self._origin_for(level, self._types(B))
        base_pos = torch.cat([origin[:, :2] + d.xy, (origin[:, 2] + cfg.base_height)[:, None]],
                             -1)
        phys = initial_state(self.scene, B, q0=self.default_q[None], base_pos0=base_pos)
        q0 = self.default_q[None] * d.scale
        q0[:, :6] = 0.0
        phys = phys._replace(robot=phys.robot._replace(q=q0, targets=q0))
        cmd = self._cmd_lo[None] + d.cmd * (self._cmd_hi - self._cmd_lo)[None]
        keep = torch.linalg.vector_norm(cmd[:, :2], dim=-1) > 0.25  # small commands: 0
        z = q0.new_zeros(B, self.num_actions)
        return ATState(physics=phys,
                       progress=torch.zeros(B, dtype=torch.int64, device=self.device),
                       commands=cmd * keep[:, None], actions=z, last_qd=z.clone(),
                       feet_air_time=q0.new_zeros(B, 4), terrain_level=level.long(),
                       spawn_xy=base_pos[:, :2])

    def reset(self, seed: int = 0, draws: ATDraws | None = None, progress=None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`, each at a random point of its episode (`progress` [B]
        int in [0, episode_length), drawn when None)."""
        self.gen.manual_seed(seed)
        B = self.cfg.num_envs
        s = self._fresh(B, draws)
        if progress is None:
            progress = torch.randint(0, self.cfg.episode_length, (B,), generator=self.gen,
                                     device=self.device)
        s = s._replace(progress=progress.long())
        return s, self._obs(s)

    # --- observation ------------------------------------------------------

    def _measured_heights(self, robot):
        """[B, 140] terrain heights under the yaw-rotated height grid."""
        bq, bp = robot.base_quat, robot.base_pos
        yaw = torch.atan2(2.0 * (bq[:, 0] * bq[:, 3] + bq[:, 1] * bq[:, 2]),
                          1.0 - 2.0 * (bq[:, 2] ** 2 + bq[:, 3] ** 2))
        c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        px, py = self.height_points[None, :, 0], self.height_points[None, :, 1]
        wx = bp[:, 0:1] + c * px - s * py
        wy = bp[:, 1:2] + s * px + c * py
        return self._terrain_height(torch.stack([wx, wy], -1))

    def _obs(self, s: ATState):
        cfg = self.cfg
        rob = s.physics.robot
        lin, ang = base_velocities(rob)
        q, qd = rob.q[:, 6:], rob.qd[:, 6:]
        heights = torch.clamp(rob.base_pos[:, 2:3] - 0.5 - self._measured_heights(rob),
                              -1.0, 1.0) * cfg.height_scale
        return torch.cat([lin * cfg.lin_vel_scale, ang * cfg.ang_vel_scale,
                          projected_gravity(rob.base_quat), s.commands * self._cmd_scale[None],
                          (q - self.default_q[None, 6:]) * cfg.dof_pos_scale,
                          qd * cfg.dof_vel_scale, heights, s.actions], -1)

    # --- step ---------------------------------------------------------------

    def step(self, state: ATState, actions, draws: ATDraws | None = None, push=None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart, `push` [B, 2] its push
        velocities."""
        cfg = self.cfg
        B = actions.shape[0]
        dt = cfg.dt
        actions = torch.clamp(actions, -1.0, 1.0)
        targets = self.default_q[None].expand(B, -1).clone()
        targets[:, 6:] += cfg.action_scale * actions
        # the push: the origin-Plücker linear velocity's x and y overwritten
        push_now = (state.progress % cfg.push_interval) == (cfg.push_interval - 1)
        push = self.draw_push(B) if push is None else push
        qd = state.physics.robot.qd.clone()
        qd[:, 0:2] = torch.where(push_now[:, None], push, qd[:, 0:2])
        phys = state.physics._replace(robot=state.physics.robot._replace(targets=targets, qd=qd))
        phys, info = engine_step(self.scene, phys)

        progress = state.progress + 1
        lin, ang = base_velocities(phys.robot)
        q, qd = phys.robot.q, phys.robot.qd
        tau = applied_torque(self.scene, self._effort, targets, q, qd)
        force = info.body_contact_force
        lin_err = torch.sum((state.commands[:, :2] - lin[:, :2]) ** 2, -1)
        ang_err = (state.commands[:, 2] - ang[:, 2]) ** 2
        rew = torch.exp(-lin_err / 0.25) * cfg.r_lin_xy * dt
        rew = rew + torch.exp(-ang_err / 0.25) * cfg.r_ang_z * dt
        rew = rew + lin[:, 2] ** 2 * cfg.r_lin_z * dt
        rew = rew + torch.sum(ang[:, :2] ** 2, -1) * cfg.r_ang_xy * dt
        rew = rew + torch.sum(tau ** 2, -1) * cfg.r_torque * dt
        rew = rew + torch.sum((state.last_qd - qd[:, 6:]) ** 2, -1) * cfg.r_joint_acc * dt
        knee_contact = torch.linalg.vector_norm(force[:, self._knees], dim=-1) > 1.0
        rew = rew + torch.sum(knee_contact, -1) * cfg.r_knee_collision * dt
        rew = rew + torch.sum((state.actions - actions) ** 2, -1) * cfg.r_action_rate * dt
        # the feet's air time, rewarded at their first contact
        contact = force[:, self._feet, 2] > 1.0
        air = state.feet_air_time + dt
        first_contact = (state.feet_air_time > 0.0) & contact
        air_rew = torch.sum((air - 0.5) * first_contact, -1)
        air_rew = air_rew * (torch.linalg.vector_norm(state.commands[:, :2], dim=-1) > 0.1)
        rew = rew + air_rew * cfg.r_air_time
        feet_air_time = air * ~contact
        rew = torch.clamp(rew, min=0.0)

        crashed = torch.linalg.vector_norm(force[:, self.base_body], dim=-1) > 1.0
        if not cfg.allow_knee_contacts:
            crashed = crashed | knee_contact.any(-1)
        finite = torch.isfinite(q).all(-1) & torch.isfinite(phys.robot.base_pos).all(-1)
        timeout = progress >= cfg.episode_length
        done = crashed | timeout | ~finite
        rew = torch.where(torch.isfinite(rew), rew, torch.zeros_like(rew))

        # the terrain curriculum on timeouts
        walked = torch.linalg.vector_norm(phys.robot.base_pos[:, :2] - state.spawn_xy, dim=-1)
        cmd_dist = (torch.linalg.vector_norm(state.commands[:, :2], dim=-1)
                    * cfg.episode_length * cfg.dt * 0.25)
        lvl = state.terrain_level
        if cfg.curriculum:
            lvl = torch.where(timeout & (walked > self.terrain.patch_length / 2), lvl + 1, lvl)
            lvl = torch.where(timeout & (walked < cmd_dist), lvl - 1, lvl)
            lvl = torch.clamp(lvl, 0, cfg.num_levels - 1)

        mid = ATState(physics=phys, progress=progress, commands=state.commands,
                      actions=actions, last_qd=qd[:, 6:], feet_air_time=feet_air_time,
                      terrain_level=lvl, spawn_xy=state.spawn_xy)
        new_state = where_done(done, self._fresh(B, draws, level=lvl), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=rew, done=done,
            info={"terrain_level_mean": lvl.float().mean(), "lin_vel_err": lin_err.mean()},
            teacher_obs=obs.new_zeros(B, 0))


def anymal_terrain_config(num_envs: int = 256, episode_length: int = 1000,
                          **kw) -> AnymalTerrainConfig:
    return AnymalTerrainConfig(num_envs=num_envs, episode_length=episode_length, **kw)


def make_anymal_terrain(num_envs: int = 256, episode_length: int = 1000, device=None,
                        **kw) -> AnymalTerrainEnv:
    return AnymalTerrainEnv(anymal_terrain_config(num_envs, episode_length, **kw), device)
