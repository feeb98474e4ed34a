"""ANYmal-C commanded-velocity locomotion (counterpart of
handarm_tpu/envs/anymal.py; reference IsaacGymEnvs tasks/anymal.py,
cfg/task/Anymal.yaml).

A floating-base URDF quadruped over the ground plane: per-episode velocity
commands (vx, vy, yaw rate), PD position targets about the default stance,
velocity-tracking rewards with a torque penalty (clamped at 0), and resets
when the base or a thigh carries a contact force over 1 N. The step is
batched over [B, ...] envs: one contact-coupled engine step (the SPD-inverse
kernel at n = 18, the sweep kernel against the ground), observation
assembly, reward and the fused auto-reset.

The env holds its state on one device and draws from its own
torch.Generator, seeded by `reset(seed)`; `reset` and `step` take
`AnymalDraws` in place of those draws (a test hands over the JAX
package's). The URDF is the in-repo stand-in
`assets/classic_standin/anymal_c/anymal.urdf` (`ANYMAL_URDF`; the JAX
package's module constant names the reference asset tree's file, which this
repository does not carry); its collision spheres are fitted by
`robots.spherefit`, two a link.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.classic import STANDIN_ROOT
from handarm_tpu_torch.envs.quadcopter import (
    ClassicStepResult,
    base_velocity,
    ground_geom,
    where_done,
)
from handarm_tpu_torch.math.quat import quat_rotate_inv
from handarm_tpu_torch.physics.contacts import StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.model import compile_urdf
from handarm_tpu_torch.physics.shapes import stack_objects
from handarm_tpu_torch.physics.solver import SolverParams
from handarm_tpu_torch.robots.spherefit import make_generic_spheres

ANYMAL_URDF = os.path.join(STANDIN_ROOT, "anymal_c", "anymal.urdf")

# cfg/task/Anymal.yaml defaultJointAngles
DEFAULT_ANGLES = {
    "LF_HAA": 0.03, "LH_HAA": 0.03, "RF_HAA": -0.03, "RH_HAA": -0.03,
    "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
    "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
}


@dataclass(frozen=True)
class AnymalConfig:
    num_envs: int = 256
    episode_length: int = 1000
    dt: float = 1.0 / 60.0
    substeps: int = 2
    action_scale: float = 0.5
    kp: float = 85.0
    kd: float = 2.0
    # command ranges (yaml randomCommandVelocityRanges)
    cmd_lin_x: tuple = (-2.0, 2.0)
    cmd_lin_y: tuple = (-1.0, 1.0)
    cmd_yaw: tuple = (-1.0, 1.0)
    # reward scales (yaml learn block)
    lin_vel_scale_rew: float = 1.0
    ang_vel_scale_rew: float = 0.5
    torque_scale_rew: float = -0.000025
    # obs scales
    lin_vel_scale: float = 2.0
    ang_vel_scale: float = 0.25
    dof_pos_scale: float = 1.0
    dof_vel_scale: float = 0.05
    base_height: float = 0.62


class AnymalState(NamedTuple):
    """The JAX package's AnymalState without its PRNG key."""

    physics: PhysicsState
    progress: torch.Tensor  # [B] int64
    commands: torch.Tensor  # [B, 3] vx, vy, yaw rate
    actions: torch.Tensor  # [B, 12]


class AnymalDraws(NamedTuple):
    """The draws of fresh episodes: `cmd` [B, 3] uniform in [0, 1) (scaled
    into the command ranges) and `scale` [B, nv] uniform in [0.5, 1.5) (the
    default joint angles' scale)."""

    cmd: torch.Tensor
    scale: torch.Tensor


def anymal_scene(cfg, geom: StaticGeom, device):
    """(Articulation, Scene, default q [nv], effort limits [nv]) of the
    ANYmal under PD gains cfg.kp / cfg.kd over the static geometry
    `geom`."""
    art = compile_urdf(ANYMAL_URDF, floating_base=True)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    spheres = make_generic_spheres(ANYMAL_URDF, art, spheres_per_link=2, device=device)
    kp, kd = np.zeros(art.nv), np.zeros(art.nv)
    kp[6:] = cfg.kp
    kd[6:] = cfg.kd
    scene = build_scene(art, stack_objects([], device=device), spheres, geom,
                        kp=kp, kd=kd,
                        params=SimParams(dt=cfg.dt, substeps=cfg.substeps,
                                         solver=SolverParams(iterations=8)), device=device)
    default_q = f32([0.0] * 6 + [DEFAULT_ANGLES[n] for n in art.joint_names[6:]])
    return art, scene, default_q, f32(art.effort_limit)


def base_velocities(robot):
    """The base point's linear and the angular velocity in the base frame."""
    v, w = base_velocity(robot)
    return quat_rotate_inv(robot.base_quat, v), quat_rotate_inv(robot.base_quat, w)


def projected_gravity(base_quat):
    g = torch.zeros(base_quat.shape[0], 3, dtype=base_quat.dtype, device=base_quat.device)
    g[:, 2] = -1.0
    return quat_rotate_inv(base_quat, g)


def applied_torque(scene, effort, targets, q, qd):
    """The leg joints' stable-PD torque estimate, clamped by the effort
    limits `effort` [nv]."""
    tau = scene.kp[None] * (targets - q) - scene.kd[None] * qd
    return torch.minimum(torch.maximum(tau, -effort[None]), effort[None])[:, 6:]


class AnymalEnv:
    """Engine-backed ANYmal (the PPO contract: reset, step, num_obs,
    num_actions, cfg.num_envs)."""

    state_type = AnymalState

    def __init__(self, cfg: AnymalConfig = AnymalConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.art, self.scene, self.default_q, self._effort = anymal_scene(
            cfg, ground_geom(dev), dev)
        art = self.art
        nj = art.nv - 6
        self.base_body = 0
        # reset-triggering contacts: the base and the thighs
        crash = [art.sites[n].body for n in art.sites
                 if "THIGH" in n and art.sites[n].body >= 0]
        self.crash_bodies = np.unique(np.array([0] + crash, np.int32))
        self._crash = torch.as_tensor(self.crash_bodies.astype(np.int64), device=dev)
        self.num_actions = nj
        self.num_obs = 12 + 3 * nj  # 48
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

    # --- state construction ---------------------------------------------

    def draw(self, B: int) -> AnymalDraws:
        u = lambda *s: torch.rand(s, generator=self.gen, device=self.device)
        return AnymalDraws(cmd=u(B, 3), scale=0.5 + u(B, self.art.nv))

    def _fresh(self, B: int, draws: AnymalDraws | None = None) -> AnymalState:
        d = draws if draws is not None else self.draw(B)
        phys = initial_state(self.scene, B, q0=self.default_q[None],
                             base_pos0=[0.0, 0.0, self.cfg.base_height])
        q0 = self.default_q[None] * d.scale
        q0[:, :6] = 0.0
        phys = phys._replace(robot=phys.robot._replace(q=q0, targets=q0))
        cmds = self._cmd_lo[None] + d.cmd * (self._cmd_hi - self._cmd_lo)[None]
        return AnymalState(physics=phys,
                           progress=torch.zeros(B, dtype=torch.int64, device=self.device),
                           commands=cmds, actions=q0.new_zeros(B, self.num_actions))

    def reset(self, seed: int = 0, draws: AnymalDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        state = self._fresh(self.cfg.num_envs, draws)
        return state, self._obs(state)

    # --- observation ------------------------------------------------------

    def _obs(self, s: AnymalState):
        cfg = self.cfg
        rob = s.physics.robot
        lin, ang = base_velocities(rob)
        q, qd = rob.q[:, 6:], rob.qd[:, 6:]
        return torch.cat([lin * cfg.lin_vel_scale, ang * cfg.ang_vel_scale,
                          projected_gravity(rob.base_quat), s.commands * self._cmd_scale[None],
                          (q - self.default_q[None, 6:]) * cfg.dof_pos_scale,
                          qd * cfg.dof_vel_scale, s.actions], -1)

    # --- step ---------------------------------------------------------------

    def step(self, state: AnymalState, actions, draws: AnymalDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg = self.cfg
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        targets = self.default_q[None].expand(B, -1).clone()
        targets[:, 6:] += cfg.action_scale * actions
        phys = state.physics._replace(robot=state.physics.robot._replace(targets=targets))
        phys, info = engine_step(self.scene, phys)

        progress = state.progress + 1
        lin, ang = base_velocities(phys.robot)
        q, qd = phys.robot.q, phys.robot.qd
        tau = applied_torque(self.scene, self._effort, targets, q, qd)
        lin_err = torch.sum((state.commands[:, :2] - lin[:, :2]) ** 2, -1)
        ang_err = (state.commands[:, 2] - ang[:, 2]) ** 2
        reward = (torch.exp(-lin_err / 0.25) * cfg.lin_vel_scale_rew
                  + torch.exp(-ang_err / 0.25) * cfg.ang_vel_scale_rew
                  + torch.sum(tau ** 2, -1) * cfg.torque_scale_rew)
        reward = torch.clamp(reward, min=0.0)

        crash_f = torch.linalg.vector_norm(info.body_contact_force[:, self._crash], dim=-1)
        crashed = (crash_f > 1.0).any(-1)
        finite = torch.isfinite(q).all(-1) & torch.isfinite(phys.robot.base_pos).all(-1)
        done = crashed | (progress >= cfg.episode_length) | ~finite
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        mid = AnymalState(physics=phys, progress=progress, commands=state.commands,
                          actions=actions)
        new_state = where_done(done, self._fresh(B, draws), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done, info={"lin_vel_err": lin_err.mean()},
            teacher_obs=obs.new_zeros(B, 0))


def anymal_config(num_envs: int = 256, episode_length: int = 1000, **kw) -> AnymalConfig:
    return AnymalConfig(num_envs=num_envs, episode_length=episode_length, **kw)


def make_anymal(num_envs: int = 256, episode_length: int = 1000, device=None,
                **kw) -> AnymalEnv:
    return AnymalEnv(anymal_config(num_envs, episode_length, **kw), device)
