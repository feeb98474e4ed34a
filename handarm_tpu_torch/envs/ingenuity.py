"""Ingenuity Mars-helicopter waypoint task (counterpart of
handarm_tpu/envs/ingenuity.py; reference IsaacGymEnvs tasks/ingenuity.py).

A coaxial twin-rotor craft under Mars gravity (-3.721): the reference's
procedural MJCF (a free chassis, two rotor bodies on locked hinges: nv =
6 + 2) with per-rotor thrusts in the rotor frame, a bounded lateral part,
applied through `RobotState.tau_ext`. The waypoint re-samples every 500
steps inside a 10 m box. Draws come from the env's torch.Generator, or
from `IngenuityDraws` given to `reset` and `step`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.quadcopter import (
    ClassicStepResult,
    base_velocity,
    craft_scene,
    thrust_torque,
    up_z,
    where_done,
)
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.solver import SolverParams


def _ingenuity_mjcf() -> str:
    """Reference procedural asset (ingenuity.py:120-215), collision geoms
    only (the display meshes are contype 0)."""
    cs = 0.06
    rr, rt = 0.15, 0.01
    rotors = []
    for i in range(2):
        z = 0.025 * i
        rotors.append(f"""
        <body name="rotor_physics_{i}" pos="0 0 {z:g}">
          <geom type="cylinder" size="{rr:g} {0.5 * rt:g}" density="1000"/>
          <joint name="rotor_roll{i}" type="hinge" limited="true"
                 range="0 0" pos="0 0 0"/>
        </body>""")
    return f"""
    <mujoco model="Ingenuity">
      <compiler angle="degree" coordinate="local" inertiafromgeom="true"/>
      <worldbody>
        <body name="chassis" pos="0 0 0">
          <geom type="box" size="{cs:g} {cs:g} {cs:g}" density="50"/>
          <joint name="root_joint" type="free"/>
          {''.join(rotors)}
        </body>
      </worldbody>
    </mujoco>"""


@dataclass(frozen=True)
class IngenuityConfig:
    num_envs: int = 256
    episode_length: int = 2000
    dt: float = 1.0 / 60.0
    substeps: int = 2
    thrust_scale: float = 2000.0
    thrust_limit: float = 2000.0
    lateral_fraction: float = 0.2
    gravity_z: float = -3.721  # Mars


class IngenuityState(NamedTuple):
    """The JAX package's IngenuityState without its PRNG key."""

    physics: PhysicsState
    target: torch.Tensor  # [B, 3]
    progress: torch.Tensor  # [B] int64


class IngenuityDraws(NamedTuple):
    """Draws in [0, 1) or [-1, 1): `root` [B, 2] in [-1, 1) places fresh
    bases, `target` [B, 3] in [0, 1) their waypoints, and at a step
    `retarget` [B, 3] in [0, 1) the waypoints that re-sample (None: from
    the generator)."""

    root: torch.Tensor
    target: torch.Tensor
    retarget: torch.Tensor | None = None


class IngenuityEnv:
    state_type = IngenuityState

    def __init__(self, cfg: IngenuityConfig = IngenuityConfig(), device=None, group=None):
        """`group`: as QuadcopterEnv's, accepted and unused."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.art, scene = craft_scene(
            _ingenuity_mjcf(), kp=np.zeros(8), kd=np.zeros(8),
            params=SimParams(dt=cfg.dt, substeps=cfg.substeps,
                             solver=SolverParams(iterations=4)),
            device=dev)
        self.scene = replace(scene, gravity=torch.tensor([0.0, 0.0, cfg.gravity_z],
                                                         dtype=torch.float32, device=dev))
        self.rotor_bodies = np.array(
            [self.art.sites[f"rotor_physics_{i}"].body for i in range(2)], np.int32)
        self.num_actions = 6
        self.num_obs = 13
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    def draw(self, B: int) -> IngenuityDraws:
        u = lambda *s: torch.rand(s, generator=self.gen, device=self.device)
        return IngenuityDraws(root=u(B, 2) * 2.0 - 1.0, target=u(B, 3), retarget=u(B, 3))

    @staticmethod
    def _targets(u):
        return torch.stack([u[:, 0] * 10.0 - 5.0, u[:, 1] * 10.0 - 5.0, u[:, 2] + 1.0], -1)

    def _fresh(self, B: int, draws: IngenuityDraws) -> IngenuityState:
        u = draws.root
        base = torch.stack([u[:, 0] * 1.5, u[:, 1] * 1.5, torch.ones_like(u[:, 0])], -1)
        phys = initial_state(self.scene, B)
        phys = phys._replace(robot=phys.robot._replace(base_pos=base))
        return IngenuityState(physics=phys, target=self._targets(draws.target),
                              progress=torch.zeros(B, dtype=torch.int64, device=self.device))

    def reset(self, seed: int = 0, draws: IngenuityDraws | None = None):
        self.gen.manual_seed(seed)
        B = self.cfg.num_envs
        s = self._fresh(B, draws if draws is not None else self.draw(B))
        return s, self._obs(s)

    def _obs(self, s: IngenuityState):
        rob = s.physics.robot
        v, w = base_velocity(rob)
        return torch.cat([(s.target - rob.base_pos) / 3.0, rob.base_quat, v / 2.0, w / np.pi],
                         -1)

    def step(self, state: IngenuityState, actions, draws: IngenuityDraws | None = None):
        cfg = self.cfg
        B = actions.shape[0]
        draws = draws if draws is not None else self.draw(B)
        actions = torch.clamp(actions, -1.0, 1.0)
        # thrust assembly (ingenuity.py:338-352): vertical components scaled
        # by dt * 2000, lateral fraction clamped to 0.2
        vert = torch.clamp(actions[:, [2, 5]] * cfg.thrust_scale, -cfg.thrust_limit,
                           cfg.thrust_limit)
        latf0 = torch.clamp(actions[:, 0:2], -cfg.lateral_fraction, cfg.lateral_fraction)
        latf1 = torch.clamp(actions[:, 3:5], -cfg.lateral_fraction, cfg.lateral_fraction)
        tz = cfg.dt * vert  # [B, 2]
        f_local = torch.stack([torch.cat([tz[:, 0:1] * latf0, tz[:, 0:1]], -1),
                               torch.cat([tz[:, 1:2] * latf1, tz[:, 1:2]], -1)], 1)
        tau = thrust_torque(self.scene, state.physics, self.rotor_bodies, f_local)
        phys = state.physics._replace(robot=state.physics.robot._replace(tau_ext=tau))
        phys, _ = engine_step(self.scene, phys)
        phys = phys._replace(robot=phys.robot._replace(tau_ext=None))

        progress = state.progress + 1
        # targets re-sample every 500 steps (ingenuity.py:324-327)
        retarget = (progress % 500) == 0
        target = torch.where(retarget[:, None], self._targets(draws.retarget), state.target)

        pos = phys.robot.base_pos
        target_dist = torch.linalg.vector_norm(target - pos, dim=-1)
        pos_reward = 1.0 / (1.0 + target_dist ** 2)
        up_reward = 5.0 / (1.0 + (1.0 - up_z(phys.robot.base_quat)) ** 2)
        spin = torch.abs(phys.robot.qd[:, 5])
        spin_reward = 1.0 / (1.0 + spin ** 2)
        reward = pos_reward + pos_reward * (up_reward + spin_reward)

        finite = torch.isfinite(pos).all(-1)
        done = ((progress >= cfg.episode_length) | (target_dist > 8.0) | (pos[:, 2] < 0.3)
                | ~finite)
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        mid = IngenuityState(physics=phys, target=target, progress=progress)
        new_state = where_done(done, self._fresh(B, draws), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done, info={"target_dist": target_dist.mean()},
            teacher_obs=obs.new_zeros(B, 0))


def make_ingenuity(num_envs=256, episode_length=2000, device=None, **kw) -> IngenuityEnv:
    return IngenuityEnv(IngenuityConfig(num_envs=num_envs, episode_length=episode_length,
                                        **kw), device)
