"""BallBalance: keep a ball centred on a tripod's tray (counterpart of
handarm_tpu/envs/ball_balance.py; reference IsaacGymEnvs
tasks/ball_balance.py, cfg/task/BallBalance.yaml, mjcf/balance_bot.xml).

A floating-base balance bot (a free tray on three two-hinge legs standing on
the ground) and a free ball dropped onto the tray: the first scene with a
floating-base robot and an object (K = 1, a sphere with rolling friction
0.002). Actions integrate the 3 lower-leg joints' position targets (dt x
action_speed_scale, clamped to the joint limits); reward =
1 / (1 + |ball - (0, 0, 0.7)|) / (1 + |ball velocity|); an episode ends when
the ball falls below 1.5 radii, its state turns non-finite, or it times out.

The step is batched over [B, ...] envs: one contact-coupled engine step
(`physics.engine.step`: dynamics with the SPD-inverse kernel at n = 12, the
sweep kernel on the robot-ground, ball-ground and robot-ball slots),
observation assembly, reward and the fused auto-reset. The reference's tray
force sensors become the tray body's row of the engine's
`StepInfo.body_contact_force` (which includes the ball's push on the tray)
and its torques about the three leg attachment points.

The env holds its state on one device and draws from its own
torch.Generator, seeded by `reset(seed)`; `reset` and `step` take
`BallDraws` in place of those draws (a test hands over the JAX package's).
The MJCF is the in-repo stand-in `assets/classic_standin/balance_bot.xml`
(`BBOT_MJCF`; the JAX package's module constant names the reference asset
tree's file, which this repository does not carry).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.classic import STANDIN_ROOT
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, mjcf_scene, where_done
from handarm_tpu_torch.math.quat import cross
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.mjcf import parse_mjcf
from handarm_tpu_torch.physics.shapes import make_sphere_object
from handarm_tpu_torch.physics.solver import SolverParams

BBOT_MJCF = os.path.join(STANDIN_ROOT, "balance_bot.xml")
BALL_RADIUS = 0.1
BALL_MASS = 200.0 * 4.0 / 3.0 * np.pi * BALL_RADIUS**3  # density 200


@dataclass(frozen=True)
class BallBalanceConfig:
    num_envs: int = 256
    episode_length: int = 500
    dt: float = 1.0 / 60.0
    substeps: int = 2
    action_speed_scale: float = 20.0  # yaml actionSpeedScale
    tray_height: float = 0.559117


class BBotState(NamedTuple):
    """The JAX package's BBotState without its PRNG key."""

    physics: PhysicsState
    targets: torch.Tensor  # [B, nv] PD position targets
    progress: torch.Tensor  # [B] int64
    actions: torch.Tensor  # [B, 3]


class BallDraws(NamedTuple):
    """The draws of fresh episodes, [B] each: the ball's spawn angle `ang`
    and radius `r` (one uniform draw u gives both, ang = 2 pi u and r = 0.15
    u, as the JAX package draws them from one key), its height `h` in [1,
    2) and its inward speed scale `hs` in [0, 2)."""

    ang: torch.Tensor
    r: torch.Tensor
    h: torch.Tensor
    hs: torch.Tensor


class BallBalanceEnv:
    """Engine-backed balance bot (the PPO contract: reset, step, num_obs,
    num_actions, cfg.num_envs)."""

    state_type = BBotState

    def __init__(self, cfg: BallBalanceConfig = BallBalanceConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        kp, kd = np.zeros(12), np.zeros(12)
        kp[6:] = 100.0  # position-driven legs (the reference's DOF_MODE_POS)
        kd[6:] = 10.0
        self.art, self.scene = mjcf_scene(
            *parse_mjcf(BBOT_MJCF), kp, kd,
            SimParams(dt=cfg.dt, substeps=cfg.substeps,
                      solver=SolverParams(iterations=8, rolling_friction=0.002)),
            dev, objects=[make_sphere_object(BALL_RADIUS, mass=float(BALL_MASS))])
        art = self.art
        names = art.joint_names[6:]
        self.actuated = np.array([6 + i for i, n in enumerate(names) if "lower" in n], np.int32)
        assert len(self.actuated) == 3, names
        self._act = torch.as_tensor(self.actuated.astype(np.int64), device=dev)
        self.q_lo = f32(art.q_min)
        self.q_hi = f32(art.q_max)
        self.tray_body = art.sites["tray"].body
        # the three leg attachment points on the tray (the sensor poses)
        self.attach = f32([[0.272721, 0.0, -0.1], [-0.13636, 0.236183, -0.1],
                           [-0.13636, -0.236183, -0.1]])
        self.num_actions = 3
        self.num_obs = 24
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- state construction ---------------------------------------------

    def draw(self, B: int) -> BallDraws:
        u = lambda: torch.rand(B, generator=self.gen, device=self.device)
        pos = u()
        return BallDraws(ang=pos * (2 * math.pi), r=pos * 0.15, h=1.0 + u(), hs=2.0 * u())

    def _fresh(self, B: int, draws: BallDraws | None = None) -> BBotState:
        d = draws if draws is not None else self.draw(B)
        phys = initial_state(self.scene, B, base_pos0=[0.0, 0.0, self.cfg.tray_height])
        # the ball over the tray within 0.15 m of its centre, falling at 5 m/s
        # and moving inwards (the reference's reset_idx)
        c, s = torch.cos(d.ang), torch.sin(d.ang)
        pos = torch.stack([d.r * c, d.r * s, d.h], -1)
        inward = d.r / 0.15 * d.hs
        vel = torch.stack([-inward * c, -inward * s, torch.full_like(d.r, -5.0)], -1)
        phys = phys._replace(objects=phys.objects._replace(pos=pos[:, None],
                                                           linvel=vel[:, None]))
        z = torch.zeros(B, self.art.nv, device=self.device)
        return BBotState(physics=phys, targets=z,
                         progress=torch.zeros(B, dtype=torch.int64, device=self.device),
                         actions=z.new_zeros(B, 3))

    def reset(self, seed: int = 0, draws: BallDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        state = self._fresh(self.cfg.num_envs, draws)
        return state, self._obs(state, None)

    # --- observation ------------------------------------------------------

    def _obs(self, s: BBotState, tray_force):
        """The 24 observations; `tray_force` [B, 3] is the net contact force
        on the tray body (None: zero, at a reset)."""
        rob, obj = s.physics.robot, s.physics.objects
        B = rob.q.shape[0]
        ball_p, ball_v = obj.pos[:, 0], obj.linvel[:, 0]
        F = torch.zeros_like(ball_p) if tray_force is None else tray_force
        torques = cross(self.attach[None].expand(B, 3, 3), F[:, None, :])
        return torch.cat([rob.q[:, self._act], rob.qd[:, self._act], ball_p, ball_v, F / 20.0,
                          (torques / 20.0).reshape(B, 9)], -1)

    # --- step ---------------------------------------------------------------

    def step(self, state: BBotState, actions, draws: BallDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg = self.cfg
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        targets = state.targets.clone()
        targets[:, self._act] += cfg.dt * cfg.action_speed_scale * actions
        targets = torch.minimum(torch.maximum(targets, self.q_lo[None]), self.q_hi[None])
        phys = state.physics._replace(robot=state.physics.robot._replace(targets=targets))
        phys, info = engine_step(self.scene, phys)

        progress = state.progress + 1
        ball_p, ball_v = phys.objects.pos[:, 0], phys.objects.linvel[:, 0]
        ball_dist = torch.sqrt(ball_p[:, 0] ** 2 + (ball_p[:, 2] - 0.7) ** 2 + ball_p[:, 1] ** 2)
        ball_speed = torch.linalg.vector_norm(ball_v, dim=-1)
        reward = 1.0 / (1.0 + ball_dist) / (1.0 + ball_speed)
        finite = torch.isfinite(ball_p).all(-1) & torch.isfinite(phys.robot.q).all(-1)
        done = (ball_p[:, 2] < BALL_RADIUS * 1.5) | (progress >= cfg.episode_length) | ~finite
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        mid = BBotState(physics=phys, targets=targets, progress=progress, actions=actions)
        new_state = where_done(done, self._fresh(B, draws), mid)
        # the step's tray force, fresh episodes included (as the JAX env)
        obs = self._obs(new_state, info.body_contact_force[:, self.tray_body])
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done, info={"ball_dist": ball_dist.mean()},
            teacher_obs=obs.new_zeros(B, 0))


def make_ball_balance(num_envs: int = 256, episode_length: int = 500, device=None,
                      **kw) -> BallBalanceEnv:
    return BallBalanceEnv(ball_balance_config(num_envs, episode_length, **kw), device)


def ball_balance_config(num_envs: int = 256, episode_length: int = 500,
                        **kw) -> BallBalanceConfig:
    return BallBalanceConfig(num_envs=num_envs, episode_length=episode_length, **kw)
