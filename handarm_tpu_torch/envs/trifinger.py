"""Trifinger cube repositioning (counterpart of handarm_tpu/envs/trifinger.py;
reference IsaacGymEnvs tasks/trifinger.py, cfg/task/Trifinger.yaml).

Three 3-dof fingers (nv = 9, the fingers mounted at height in the URDF, no
robot gravity) around a 6.5 cm, 94 g box cube on a table at z = 0, fenced
by four wall AABBs at +-0.195 m that stand in for the circular arena
boundary. Torque command mode: zero PD gains, the action times 0.36 N m
minus 0.1 times the joint velocity (safety damping), clipped to +-0.36,
reaches the engine as `RobotState.tau_ext`, set before the sim step and
cleared after it. Observations (41): q, 0.1 qd, the cube's pose, the goal
pose, the last actions. The reward: a fingertip-movement penalty, a reach
term on the change of the tips' distance to the cube, and the keypoint
reward (a logistic kernel of the 8 cube corners' distances to the goal's).
An episode ends at its length or on a non-finite state; the fused
auto-reset draws a fresh cube and goal.

The env holds its state on one device and draws from its own
torch.Generator, seeded by `reset(seed)`; `reset` and `step` take
`TrifingerDraws` in place of those draws (a test hands over the JAX
package's). The URDF is the in-repo stand-in
`assets/classic_standin/trifinger/robot_properties_fingers/urdf/pro/
trifingerpro.urdf` (`TRIFINGER_URDF`), its collision spheres fitted by
`robots.spherefit`, two a link.
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
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, where_done
from handarm_tpu_torch.math.quat import quat_from_axis_angle, quat_rotate
from handarm_tpu_torch.physics.contacts import StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.kinematics import forward_kinematics, site_poses
from handarm_tpu_torch.physics.model import compile_urdf
from handarm_tpu_torch.physics.shapes import make_box_object, stack_objects
from handarm_tpu_torch.physics.solver import SolverParams
from handarm_tpu_torch.robots.spherefit import make_generic_spheres

TRIFINGER_URDF = os.path.join(STANDIN_ROOT, "trifinger", "robot_properties_fingers", "urdf",
                              "pro", "trifingerpro.urdf")
CUBE = 0.065
DEFAULT_Q = np.array([0.0, 0.9, -2.0] * 3, np.float32)
MAX_TORQUE = 0.36
ARENA_R = 0.195
TIP_SITES = ("finger_tip_link_0", "finger_tip_link_120", "finger_tip_link_240")


def _lgsk(x, scale: float = 30.0, eps: float = 2.0):
    """Logistic kernel (reference trifinger.py lgsk_kernel)."""
    s = x * scale
    return 1.0 / (torch.exp(s) + eps + torch.exp(-s))


def gen_keypoints(pos, quat, size: float = CUBE):
    """The 8 cube-corner keypoints [B, 8, 3] in the world frame."""
    corners = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                           dtype=pos.dtype, device=pos.device) * (size / 2.0)
    B = pos.shape[0]
    return pos[:, None] + quat_rotate(quat[:, None].expand(B, 8, 4), corners[None].expand(B, 8, 3))


def arena_walls() -> tuple[np.ndarray, np.ndarray]:
    """The four boundary walls' (lo [4, 3], hi [4, 3]): 1 cm thick, 0.15 m
    high, just outside +-ARENA_R."""
    t, zh, r = 0.01, 0.15, ARENA_R
    boxes = (((-r - t, -r - t, 0.0), (-r, r + t, zh)), ((r, -r - t, 0.0), (r + t, r + t, zh)),
             ((-r - t, -r - t, 0.0), (r + t, -r, zh)), ((-r - t, r, 0.0), (r + t, r + t, zh)))
    return (np.asarray([lo for lo, _ in boxes], np.float32),
            np.asarray([hi for _, hi in boxes], np.float32))


@dataclass(frozen=True)
class TrifingerConfig:
    num_envs: int = 256
    episode_length: int = 750
    dt: float = 1.0 / 60.0
    substeps: int = 2
    # reward weights (Trifinger.yaml reward_terms)
    finger_move_penalty: float = -0.05
    finger_reach_weight: float = -250.0
    object_dist_weight: float = 2000.0
    safety_damping: float = 0.1


class TrifingerState(NamedTuple):
    """The JAX package's TrifingerState without its PRNG key."""

    physics: PhysicsState
    progress: torch.Tensor  # [B] int64
    goal_pos: torch.Tensor  # [B, 3]
    goal_quat: torch.Tensor  # [B, 4]
    actions: torch.Tensor  # [B, 9]
    prev_tips: torch.Tensor  # [B, 3, 3]
    prev_obj: torch.Tensor  # [B, 3]


class TrifingerDraws(NamedTuple):
    """The draws of fresh episodes: `obj` [B, 2] uniform in [0, 1) (the
    cube's radius and angle), `goal` [B, 3] uniform in [0, 1) (the goal's
    radius, angle and height), `yaw` [B] uniform in [-pi, pi) (the goal's
    yaw)."""

    obj: torch.Tensor
    goal: torch.Tensor
    yaw: torch.Tensor


class TrifingerEnv:
    """Engine-backed Trifinger (the PPO contract: reset, step, num_obs,
    num_actions, cfg.num_envs)."""

    state_type = TrifingerState

    def __init__(self, cfg: TrifingerConfig = TrifingerConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        self.art = art = compile_urdf(TRIFINGER_URDF)
        nv = art.nv  # 9
        shapes = stack_objects([make_box_object([CUBE / 2] * 3, mass=0.094)], device=dev)
        spheres = make_generic_spheres(TRIFINGER_URDF, art, spheres_per_link=2, device=dev)
        wall_lo, wall_hi = arena_walls()
        geom = StaticGeom(table_lo=f32([-10.0, -10.0]), table_hi=f32([10.0, 10.0]),
                          table_height=0.0, wall_lo=wall_lo, wall_hi=wall_hi)
        # torque mode: zero PD (tau_ext carries the command); the URDF mounts
        # the fingers at height
        self.scene = build_scene(
            art, shapes, spheres, geom, kp=np.zeros(nv), kd=np.zeros(nv),
            params=SimParams(dt=cfg.dt, substeps=cfg.substeps,
                             solver=SolverParams(iterations=8, rolling_friction=0.002),
                             robot_gravity=False),
            device=dev)
        self.tip_body = np.array([art.sites[n].body for n in TIP_SITES])
        self.tip_pos = f32([art.sites[n].pos for n in TIP_SITES])
        self.tip_quat = f32([art.sites[n].quat for n in TIP_SITES])
        self.q_default = f32(DEFAULT_Q)
        self.num_actions = nv
        self.num_obs = 9 + 9 + 7 + 7 + 9  # 41
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- state construction -------------------------------------------------

    def draw(self, B: int) -> TrifingerDraws:
        u = lambda *s: torch.rand(*s, generator=self.gen, device=self.device)
        return TrifingerDraws(obj=u(B, 2), goal=u(B, 3), yaw=u(B) * (2 * math.pi) - math.pi)

    def tips(self, phys: PhysicsState) -> torch.Tensor:
        """The fingertips' world positions [B, 3, 3]."""
        B = phys.robot.q.shape[0]
        bq = self.scene.base_quat[None].expand(B, 4)
        bp = self.scene.base_pos[None].expand(B, 3)
        fk = forward_kinematics(self.scene.model, phys.robot.q, bq, bp)
        _, tp = site_poses(fk, self.tip_body, self.tip_pos, self.tip_quat, base_quat=bq,
                           base_pos=bp)
        return tp

    def _goal(self, d: TrifingerDraws):
        B = d.yaw.shape[0]
        r = 0.11 * torch.sqrt(d.goal[:, 0])
        th = 2 * math.pi * d.goal[:, 1]
        pos = torch.stack([r * torch.cos(th), r * torch.sin(th), CUBE / 2 + d.goal[:, 2] * 0.2],
                          -1)
        z = torch.zeros(B, 3, device=self.device)
        z[:, 2] = 1.0
        return pos, quat_from_axis_angle(z, d.yaw)

    def _fresh(self, B: int, draws: TrifingerDraws | None = None) -> TrifingerState:
        d = draws if draws is not None else self.draw(B)
        r = 0.11 * torch.sqrt(d.obj[:, 0])
        th = 2 * math.pi * d.obj[:, 1]
        opos = torch.stack([r * torch.cos(th), r * torch.sin(th),
                            torch.full((B,), CUBE / 2, device=self.device)], -1)
        phys = initial_state(self.scene, B, q0=self.q_default[None], obj_pos0=opos[:, None])
        gp, gq = self._goal(d)
        return TrifingerState(physics=phys,
                              progress=torch.zeros(B, dtype=torch.int64, device=self.device),
                              goal_pos=gp, goal_quat=gq,
                              actions=torch.zeros(B, self.num_actions, device=self.device),
                              prev_tips=self.tips(phys), prev_obj=opos)

    def reset(self, seed: int = 0, draws: TrifingerDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        state = self._fresh(self.cfg.num_envs, draws)
        return state, self._obs(state)

    def grasp_actions(self, state: TrifingerState, close: bool) -> torch.Tensor:
        """Scripted actions [B, 9] (not the task's policy; the checks build
        contact states with them): a Jacobian-transpose spring of 80 N/m on
        each fingertip toward the cube's side that faces its finger, 2 cm
        off the face while not `close`, 1 cm into it when `close`, at the
        cube's height (3 cm above it while not `close`), less 0.05 qd. The
        tips' Jacobian is a forward difference of the FK (1e-3 rad)."""
        phys = state.physics
        q = phys.robot.q
        tips = self.tips(phys)
        J = torch.stack([(self.tips(phys._replace(robot=phys.robot._replace(
            q=q + 1e-3 * torch.eye(9, device=q.device)[j]))) - tips) / 1e-3 for j in range(9)],
            -1)  # [B, 3, 3, 9]
        ang = torch.arange(3, device=q.device) * (2 * math.pi / 3)
        toward = torch.stack([-torch.sin(ang), torch.cos(ang), torch.zeros_like(ang)], -1)
        c = phys.objects.pos[:, 0]
        reach = CUBE / 2 + 0.0095 + (-0.01 if close else 0.02)
        target = c[:, None] + toward[None] * reach
        target[..., 2] = c[:, None, 2] + (0.0 if close else 0.03)
        tau = torch.einsum("bfij,bfi->bj", J, 80.0 * (target - tips)) - 0.05 * phys.robot.qd
        return torch.clamp(tau / MAX_TORQUE, -1.0, 1.0)

    def _obs(self, s: TrifingerState):
        phys = s.physics
        return torch.cat([phys.robot.q, phys.robot.qd * 0.1, phys.objects.pos[:, 0],
                          phys.objects.quat[:, 0], s.goal_pos, s.goal_quat, s.actions], -1)

    # --- step -------------------------------------------------------------------

    def step(self, state: TrifingerState, actions, draws: TrifingerDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg = self.cfg
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        # torque command + safety damping (trifinger.py:1014-1037)
        phys = state.physics
        tau = torch.clamp(MAX_TORQUE * actions - cfg.safety_damping * phys.robot.qd,
                          -MAX_TORQUE, MAX_TORQUE)
        phys = phys._replace(robot=phys.robot._replace(tau_ext=tau))
        phys, _ = engine_step(self.scene, phys)
        phys = phys._replace(robot=phys.robot._replace(tau_ext=None))

        progress = state.progress + 1
        opos, oquat = phys.objects.pos[:, 0], phys.objects.quat[:, 0]
        tips = self.tips(phys)
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
        # the keypoint variant of compute_trifinger_reward
        tip_vel = (tips - state.prev_tips) / cfg.dt
        move_pen = cfg.finger_move_penalty * (tip_vel ** 2).sum((-1, -2))
        curr_n = norm(tips - opos[:, None])
        prev_n = norm(state.prev_tips - state.prev_obj[:, None])
        reach = cfg.finger_reach_weight * (curr_n - prev_n).sum(-1)
        d = norm(gen_keypoints(opos, oquat) - gen_keypoints(state.goal_pos, state.goal_quat))
        pose_reward = cfg.object_dist_weight * cfg.dt * _lgsk(d, 30.0, 2.0).mean(-1)
        reward = move_pen + reach + pose_reward

        finite = torch.isfinite(opos).all(-1) & torch.isfinite(phys.robot.q).all(-1)
        done = (progress >= cfg.episode_length) | ~finite
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        mid = TrifingerState(physics=phys, progress=progress, goal_pos=state.goal_pos,
                             goal_quat=state.goal_quat, actions=actions, prev_tips=tips,
                             prev_obj=opos)
        new_state = where_done(done, self._fresh(B, draws), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done, info={"keypoint_dist": d.mean(-1).mean()},
            teacher_obs=obs.new_zeros(B, 0))


def trifinger_config(num_envs: int = 256, episode_length: int = 750, **kw) -> TrifingerConfig:
    return TrifingerConfig(num_envs=num_envs, episode_length=episode_length, **kw)


def make_trifinger(num_envs: int = 256, episode_length: int = 750, device=None,
                   **kw) -> TrifingerEnv:
    return TrifingerEnv(trifinger_config(num_envs, episode_length, **kw), device)
