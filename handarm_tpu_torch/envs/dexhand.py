"""In-hand cube reorientation with a fixed-base dexterous hand: AllegroHand and
ShadowHand (counterpart of handarm_tpu/envs/dexhand.py; reference
IsaacGymEnvs tasks/allegro_hand.py and tasks/shadow_hand.py,
cfg/task/AllegroHand.yaml, ShadowHand.yaml, ShadowHandOpenAI_FF.yaml).

A gravity-free hand holds a box cube and turns it to sampled goal
orientations. The actions are joint position targets scaled to the limits
(a moving average with the last targets; 1.0 keeps none of them). A goal
reached (rotation distance at most 0.1 rad) earns the bonus and is
resampled in place; the env resets when the cube falls (0.24 m from the
goal's anchor), at the episode's length or on a non-finite state. The
consecutive-success average is a scalar over all envs, updated where
episodes end (av_factor 0.1), and kept out of the per-env reset.

- AllegroHandEnv: the 16-dof Allegro hand (`ALLEGRO_URDF`) at z = 0.5 under
  Ry(pi) Rx(0.47 pi) Rz(0.25 pi), a 6.5 cm cube at density 400, PD gains 3
  and 0.1 with effort 0.5 on every joint (over the URDF's), 2 engine steps
  a control step; observations `full_no_vel` (50), `full` (72) or
  `full_state` (88, with the applied PD torque as the dof-force sensor).
- ShadowHandEnv: the 24-dof Shadow hand from MJCF (`SHADOW_MJCF`), its
  mount's pose cancelled so that the mount sits at (0, 0, 0.5) unrotated,
  its collision spheres from the MJCF geoms, a 5 cm cube at density 567,
  kp 5 / 1 and kd 0.5 / 0.1 (wrist / fingers) with per-joint efforts, 20
  actuated joints (the distal J0s take their J1 neighbour's target, the
  MJCF's coupling tendon), one engine step a control step; observations
  `full_state` (211: with the fingertips' poses and velocities and their
  contact forces from the engine's step info) or `openai` (42: fingertip
  positions, the cube's position, the goal-relative rotation, the
  actions; the 211-dim state as the teacher observations of the
  asymmetric critic, through `observe`).

The env holds its state on one device and draws from its own
torch.Generator, seeded by `reset(seed)`; `reset` and `step` take
`DexDraws` in place of those draws (a test hands over the JAX package's).
The assets are the in-repo stand-ins under `assets/classic_standin/`
(`urdf/kuka_allegro_description/allegro_touch_sensor.urdf`,
`mjcf/open_ai_assets/hand/shadow_hand.xml`).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.classic import STANDIN_ROOT
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, where_done
from handarm_tpu_torch.math.quat import (
    cross,
    quat_conj,
    quat_from_axis_angle,
    quat_mul,
    quat_to_matrix,
)
from handarm_tpu_torch.physics.contacts import RobotSpheres, StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.kinematics import body_velocities, forward_kinematics
from handarm_tpu_torch.physics.model import compile_mjcf, compile_urdf
from handarm_tpu_torch.physics.shapes import make_box_object, stack_objects
from handarm_tpu_torch.physics.solver import SolverParams
from handarm_tpu_torch.physics.urdf import rpy_to_matrix
from handarm_tpu_torch.robots.spherefit import make_generic_spheres

ALLEGRO_URDF = os.path.join(STANDIN_ROOT, "urdf", "kuka_allegro_description",
                            "allegro_touch_sensor.urdf")
SHADOW_MJCF = os.path.join(STANDIN_ROOT, "mjcf", "open_ai_assets", "hand", "shadow_hand.xml")


@dataclass(frozen=True)
class DexHandConfig:
    num_envs: int = 256
    episode_length: int = 600
    control_freq_inv: int = 2  # 30 Hz policy on the 60 Hz sim
    obs_type: str = "full_state"  # full_no_vel | full | full_state (| openai: ShadowHand)
    # reward (AllegroHand.yaml env block)
    dist_reward_scale: float = -10.0
    rot_reward_scale: float = 1.0
    rot_eps: float = 0.1
    action_penalty_scale: float = -0.0002
    reach_goal_bonus: float = 250.0
    success_tolerance: float = 0.1
    fall_dist: float = 0.24
    fall_penalty: float = 0.0
    av_factor: float = 0.1
    # reset noise (yaml resetPositionNoise / resetDofPosRandomInterval)
    reset_position_noise: float = 0.01
    reset_dof_pos_interval: float = 0.2
    act_moving_average: float = 1.0
    vel_obs_scale: float = 0.2
    force_obs_scale: float = 10.0
    start_object_dy: float = -0.19
    start_object_dz: float = 0.06


@dataclass(frozen=True)
class ShadowHandConfig(DexHandConfig):
    episode_length: int = 600
    control_freq_inv: int = 1  # 60 Hz (ShadowHand.yaml)
    start_object_dy: float = -0.39
    start_object_dz: float = 0.10


class DexState(NamedTuple):
    """The JAX package's DexState without its PRNG key."""

    physics: PhysicsState
    targets: torch.Tensor  # [B, nv] position targets (persist across steps)
    progress: torch.Tensor  # [B] int64
    goal_quat: torch.Tensor  # [B, 4]
    actions: torch.Tensor  # [B, na]
    successes: torch.Tensor  # [B] goal hits this episode
    cons_successes: torch.Tensor  # [] the consecutive-success average


class DexDraws(NamedTuple):
    """The draws of a step. Of fresh episodes: `dof` [B, nv] uniform in [-1,
    1) (the joints' offsets from their defaults), `pos` [B, 3] standard
    normal (the cube's position noise), `rot` and `goal` [B, 2] uniform in
    [-1, 1) (the cube's and the goal's rotations, `rand_quat`); of the goals
    resampled in place on success: `resample` [B, 2], the same."""

    dof: torch.Tensor
    pos: torch.Tensor
    rot: torch.Tensor
    goal: torch.Tensor
    resample: torch.Tensor


def rand_quat(u: torch.Tensor) -> torch.Tensor:
    """Reference randomize_rotation: u[:, 0] pi about x, then u[:, 1] pi
    about y (allegro_hand.py:540-542); u [B, 2] in [-1, 1)."""
    B = u.shape[0]
    axis = lambda i: torch.eye(3, dtype=u.dtype, device=u.device)[i].expand(B, 3)
    return quat_mul(quat_from_axis_angle(axis(0), u[:, 0] * math.pi),
                    quat_from_axis_angle(axis(1), u[:, 1] * math.pi))


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """The JAX package's branch-free Shepperd quaternion (wxyz, w >= 0) of a
    rotation matrix, in float32."""
    m = np.asarray(m, np.float32)
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = m
    one = np.float32(1.0)
    cand = np.array([[one + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01],
                     [m21 - m12, one + m00 - m11 - m22, m01 + m10, m02 + m20],
                     [m02 - m20, m01 + m10, one - m00 + m11 - m22, m12 + m21],
                     [m10 - m01, m02 + m20, m12 + m21, one - m00 - m11 + m22]], np.float32)
    q = cand[int(np.argmax([m00 + m11 + m22, m00, m11, m22]))]
    q = -q if q[0] < 0 else q
    return q / max(np.float32(np.sqrt(np.sum(q * q))), np.float32(1e-9))


def hand_geom(device) -> StaticGeom:
    """The bare ground plane: a table top at z = 0 over +-10 m."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return StaticGeom(table_lo=f32([-10.0, -10.0]), table_hi=f32([10.0, 10.0]), table_height=0.0)


def hand_params() -> SimParams:
    return SimParams(dt=1.0 / 60.0, substeps=2,
                     solver=SolverParams(iterations=8, rolling_friction=0.002),
                     robot_gravity=False)


class _DexHandEnv:
    """The two hands' shared state construction, reward and step (the PPO
    contract: reset, step, num_obs, num_actions, cfg.num_envs)."""

    state_type = DexState

    def _setup(self, cfg: DexHandConfig, device):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        # reward / goal anchor: the object's start + goal_displacement (-0.2,
        # -0.06, 0.12) - 0.04 z (allegro_hand.py:300-307)
        self.goal_pos_const = f32([0.0 - 0.2, cfg.start_object_dy - 0.06,
                                   0.5 + cfg.start_object_dz + 0.08])
        self.obj_start = f32([0.0, cfg.start_object_dy, 0.5 + cfg.start_object_dz])
        self.q_lo, self.q_hi = f32(self.art.q_min), f32(self.art.q_max)
        self.q_default = torch.clamp(torch.zeros(self.art.nv, device=dev), self.q_lo, self.q_hi)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    def _scale(self, a):
        return self.q_lo + (a + 1.0) * 0.5 * (self.q_hi - self.q_lo)

    def _unscale(self, q):
        return 2.0 * (q - self.q_lo) / (self.q_hi - self.q_lo) - 1.0

    # --- state construction -------------------------------------------------

    def draw(self, B: int) -> DexDraws:
        u = lambda *s: torch.rand(*s, generator=self.gen, device=self.device) * 2.0 - 1.0
        return DexDraws(dof=u(B, self.art.nv),
                        pos=torch.randn(B, 3, generator=self.gen, device=self.device),
                        rot=u(B, 2), goal=u(B, 2), resample=u(B, 2))

    def _fresh(self, B: int, draws: DexDraws | None = None) -> DexState:
        cfg = self.cfg
        d = draws if draws is not None else self.draw(B)
        q0 = torch.clamp(self.q_default[None] + cfg.reset_dof_pos_interval * d.dof,
                         self.q_lo, self.q_hi)
        pos = self.obj_start[None] + cfg.reset_position_noise * d.pos
        phys = initial_state(self.scene, B, obj_pos0=pos[:, None])
        phys = phys._replace(objects=phys.objects._replace(quat=rand_quat(d.rot)[:, None]),
                             robot=phys.robot._replace(q=q0, targets=q0))
        return DexState(physics=phys, targets=q0,
                        progress=torch.zeros(B, dtype=torch.int64, device=self.device),
                        goal_quat=rand_quat(d.goal),
                        actions=torch.zeros(B, self.num_actions, device=self.device),
                        successes=torch.zeros(B, device=self.device),
                        cons_successes=torch.zeros((), device=self.device))

    def reset(self, seed: int = 0, draws: DexDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        state = self._fresh(self.cfg.num_envs, draws)
        return state, self._obs(state)

    def observe(self, state: DexState):
        """(obs, teacher_obs, obs_dict) without stepping (the asymmetric
        critic's hook at the learner's init)."""
        obs = self._obs(state)
        teacher = (self._teacher_obs(state) if self.num_teacher_obs
                   else obs.new_zeros(obs.shape[0], 0))
        return obs, teacher, {"obs": obs}

    def _pd_torque(self, s: DexState, limit):
        rob = s.physics.robot
        tau = self.scene.kp[None] * (s.targets - rob.q) - self.scene.kd[None] * rob.qd
        return torch.minimum(torch.maximum(tau, -limit), limit)

    # --- step -------------------------------------------------------------------

    def step(self, state: DexState, actions, draws: DexDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the goals resampled on success and of the episodes that
        restart."""
        cfg = self.cfg
        B = actions.shape[0]
        d = draws if draws is not None else self.draw(B)
        actions = torch.clamp(actions, -1.0, 1.0)
        targets = self._targets(actions, state.targets)
        phys = state.physics
        phys = phys._replace(robot=phys.robot._replace(targets=targets))
        info = None
        for _ in range(cfg.control_freq_inv):
            phys, info = engine_step(self.scene, phys)

        opos, oquat = phys.objects.pos[:, 0], phys.objects.quat[:, 0]
        progress = state.progress + 1
        # compute_hand_reward (allegro_hand.py, shadow_hand.py)
        goal_dist = torch.linalg.vector_norm(opos - self.goal_pos_const[None], dim=-1)
        quat_diff = quat_mul(oquat, quat_conj(state.goal_quat))
        rot_dist = 2.0 * torch.asin(torch.clamp(
            torch.linalg.vector_norm(quat_diff[:, 1:4], dim=-1), 0.0, 1.0))
        reward = (goal_dist * cfg.dist_reward_scale
                  + cfg.rot_reward_scale / (torch.abs(rot_dist) + cfg.rot_eps)
                  + cfg.action_penalty_scale * (actions ** 2).sum(-1))
        goal_hit = torch.abs(rot_dist) <= cfg.success_tolerance
        reward = torch.where(goal_hit, reward + cfg.reach_goal_bonus, reward)
        fell = goal_dist >= cfg.fall_dist
        reward = torch.where(fell, reward + cfg.fall_penalty, reward)

        successes = state.successes + goal_hit
        finite = torch.isfinite(phys.robot.q).all(-1) & torch.isfinite(opos).all(-1)
        done = fell | (progress >= cfg.episode_length) | ~finite
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        # the consecutive-success average over the episodes that end
        num_resets = done.sum()
        fin = torch.where(done, successes, torch.zeros_like(successes)).sum()
        cons = torch.where(num_resets > 0,
                           cfg.av_factor * fin / torch.clamp(num_resets, min=1)
                           + (1.0 - cfg.av_factor) * state.cons_successes,
                           state.cons_successes)
        # goals resampled in place on success (no reset)
        goal_quat = torch.where(goal_hit[:, None], rand_quat(d.resample), state.goal_quat)

        mid = DexState(physics=phys, targets=targets, progress=progress, goal_quat=goal_quat,
                       actions=actions, successes=successes, cons_successes=cons)
        new_state = where_done(done, self._fresh(B, d), mid)  # the average is kept
        obs = self._obs(new_state, info)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        if self.num_teacher_obs:
            teacher = self._teacher_obs(new_state, info)
            teacher = torch.where(torch.isfinite(teacher), teacher, torch.zeros_like(teacher))
        else:
            teacher = obs.new_zeros(B, 0)
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done,
            info={"consecutive_successes": cons, "rot_dist_mean": rot_dist.mean(),
                  "goal_hits": goal_hit.sum()},
            teacher_obs=teacher)


class AllegroHandEnv(_DexHandEnv):
    """The 16-dof Allegro hand and its cube (tasks/allegro_hand.py)."""

    def __init__(self, cfg: DexHandConfig = DexHandConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks; the
        consecutive-success average stays each rank's own."""
        self.art = art = compile_urdf(ALLEGRO_URDF)
        nv = art.nv
        dev = resolve_device(device)
        # z = 0.5, Ry(pi) * Rx(0.47 pi) * Rz(0.25 pi) (allegro_hand.py:284-286;
        # gym's a * b applies b first)
        axis = lambda i: torch.eye(3)[i][None]
        qy = quat_from_axis_angle(axis(1), torch.tensor([math.pi]))[0]
        qx = quat_from_axis_angle(axis(0), torch.tensor([0.47 * math.pi]))[0]
        qz = quat_from_axis_angle(axis(2), torch.tensor([0.25 * math.pi]))[0]
        base_quat = quat_mul(qy, quat_mul(qx, qz))
        half = 0.0325  # cube_multicolor_allegro.urdf: 6.5 cm at density 400
        shapes = stack_objects([make_box_object([half] * 3, mass=400.0 * (2 * half) ** 3)],
                               device=dev)
        spheres = make_generic_spheres(ALLEGRO_URDF, art, spheres_per_link=4, device=dev)
        # dof props: stiffness 3, damping 0.1 (allegro_hand.py:263-269); the
        # hand's gravity off (:229)
        scene = build_scene(art, shapes, spheres, hand_geom(dev), kp=np.full(nv, 3.0),
                            kd=np.full(nv, 0.1), base_pos=(0.0, 0.0, 0.5),
                            base_quat=tuple(base_quat.tolist()), params=hand_params(),
                            device=dev)
        # effort 0.5 over the URDF's (allegro_hand.py:264)
        scene.model = replace(scene.model, effort_limit=torch.full((nv,), 0.5, device=dev))
        self.scene = scene
        self._setup(cfg, dev)
        self.num_actions = nv
        self.num_obs = {"full_no_vel": 50, "full": 72, "full_state": 88}[cfg.obs_type]
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}

    def _targets(self, a, prev):
        cfg = self.cfg
        t = cfg.act_moving_average * self._scale(a) + (1.0 - cfg.act_moving_average) * prev
        return torch.minimum(torch.maximum(t, self.q_lo), self.q_hi)

    def _obs(self, s: DexState, info=None):
        cfg = self.cfg
        rob, obj = s.physics.robot, s.physics.objects
        opos, oquat = obj.pos[:, 0], obj.quat[:, 0]
        goal = self.goal_pos_const[None].expand_as(opos)
        quat_diff = quat_mul(oquat, quat_conj(s.goal_quat))
        obj_pose = torch.cat([opos, oquat], -1)
        goal_pose = torch.cat([goal, s.goal_quat], -1)
        uq = self._unscale(rob.q)
        if cfg.obs_type == "full_no_vel":
            parts = [uq, obj_pose, goal_pose, quat_diff, s.actions]
        elif cfg.obs_type == "full":
            parts = [uq, cfg.vel_obs_scale * rob.qd, obj_pose, obj.linvel[:, 0],
                     cfg.vel_obs_scale * obj.angvel[:, 0], goal_pose, quat_diff, s.actions]
        else:  # full_state: + the applied PD torque as the dof-force sensor
            tau = self._pd_torque(s, torch.full_like(self.q_lo, 0.5))
            parts = [uq, cfg.vel_obs_scale * rob.qd, cfg.force_obs_scale * tau, obj_pose,
                     obj.linvel[:, 0], cfg.vel_obs_scale * obj.angvel[:, 0], goal_pose,
                     quat_diff, s.actions]
        return torch.clamp(torch.cat(parts, -1), -5.0, 5.0)


# ShadowHand (tasks/shadow_hand.py, cfg/task/ShadowHand.yaml)
SHADOW_ACTUATED = [
    "robot0:WRJ1", "robot0:WRJ0",
    "robot0:FFJ3", "robot0:FFJ2", "robot0:FFJ1",
    "robot0:MFJ3", "robot0:MFJ2", "robot0:MFJ1",
    "robot0:RFJ3", "robot0:RFJ2", "robot0:RFJ1",
    "robot0:LFJ4", "robot0:LFJ3", "robot0:LFJ2", "robot0:LFJ1",
    "robot0:THJ4", "robot0:THJ3", "robot0:THJ2", "robot0:THJ1", "robot0:THJ0",
]
# the distal J0 joints follow their J1 neighbour (the MJCF's fixed tendons
# T_FFJ1c etc.; IsaacGym drives them through the tendon): their targets
# mimic J1's
SHADOW_COUPLED = {"robot0:FFJ0": "robot0:FFJ1", "robot0:MFJ0": "robot0:MFJ1",
                  "robot0:RFJ0": "robot0:RFJ1", "robot0:LFJ0": "robot0:LFJ1"}
SHADOW_EFFORT = {"robot0:WRJ1": 4.785, "robot0:WRJ0": 2.175, "robot0:THJ4": 2.3722,
                 "robot0:THJ3": 1.45, "robot0:THJ2": 0.99, "robot0:THJ1": 0.99,
                 "robot0:THJ0": 0.81}
SHADOW_FINGERTIPS = ["robot0:ffdistal", "robot0:mfdistal", "robot0:rfdistal",
                     "robot0:lfdistal", "robot0:thdistal"]
SHADOW_MOUNT_RPY = (1.5708, 0.0, 3.14159)
SHADOW_MOUNT_POS = (1.0, 1.25, 0.15)


def shadow_spheres(art, extras, device) -> RobotSpheres:
    """The collision spheres of the MJCF's geoms (contype > 0) on the moving
    bodies, in their body frames, with each body's geom friction."""
    bodies, offs, rads, mus = [], [], [], []
    for bname, sph in extras.link_spheres.items():
        site = art.sites[bname]
        if site.body < 0:
            continue
        Rl = quat_to_matrix(torch.as_tensor(site.quat, dtype=torch.float32)).numpy()
        mu = float(extras.geom_friction.get(bname, 1.0))
        for pos, r in sph:
            bodies.append(site.body)
            offs.append(Rl @ np.asarray(pos) + site.pos)
            rads.append(r)
            mus.append(mu)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    return RobotSpheres(body=np.asarray(bodies, np.int32), offset=f32(offs), radius=f32(rads),
                        friction=np.asarray(mus, np.float32))


class ShadowHandEnv(_DexHandEnv):
    """The 24-dof Shadow hand and its cube (tasks/shadow_hand.py); with
    `obs_type="openai"` the asymmetric ShadowHandOpenAI_FF / _LSTM tasks."""

    def __init__(self, cfg: ShadowHandConfig = ShadowHandConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks; the
        consecutive-success average stays each rank's own."""
        art, extras = compile_mjcf(SHADOW_MJCF)
        self.art = art
        nv = art.nv  # 24
        dev = resolve_device(device)
        # IsaacGym drops the asset root body's transform (the MJCF mount's
        # pos / euler): cancel it so that the mount sits at (0, 0, 0.5)
        # unrotated (shadow_hand.py:305-307)
        R_scene = rpy_to_matrix(np.array(SHADOW_MOUNT_RPY)).T
        p_scene = np.array([0.0, 0.0, 0.5]) - R_scene @ np.array(SHADOW_MOUNT_POS)
        half = 0.025  # urdf/objects/cube_multicolor.urdf: 5 cm at density 567
        shapes = stack_objects([make_box_object([half] * 3, mass=567.0 * (2 * half) ** 3)],
                               device=dev)
        # PD gains of the MJCF's position actuators (kp 5 wrist / 1 fingers),
        # damping as the joint defaults
        names = art.joint_names
        kp = np.array([5.0 if "WRJ" in n else 1.0 for n in names])
        kd = np.array([0.5 if "WRJ" in n else 0.1 for n in names])
        effort = np.array([SHADOW_EFFORT.get(n, 0.7245 if (n[-1] in "01" and "THJ" not in n)
                                             else 0.9) for n in names], np.float32)
        scene = build_scene(art, shapes, shadow_spheres(art, extras, dev), hand_geom(dev),
                            kp=kp, kd=kd, base_pos=tuple(p_scene),
                            base_quat=tuple(quat_from_matrix(R_scene).tolist()),
                            params=hand_params(), device=dev)
        scene.model = replace(scene.model, effort_limit=torch.as_tensor(effort, device=dev))
        self.scene = scene
        self._setup(cfg, dev)
        idx = {n: i for i, n in enumerate(names)}
        self.actuated_idx = torch.as_tensor([idx[n] for n in SHADOW_ACTUATED], device=dev)
        self.coupled_idx = torch.as_tensor([[idx[a], idx[b]] for a, b in SHADOW_COUPLED.items()],
                                           device=dev)
        self.fingertip_bodies = np.array([art.sites[n].body for n in SHADOW_FINGERTIPS],
                                         np.int64)
        self.num_actions = len(SHADOW_ACTUATED)  # 20
        # "openai": the actor sees 42 dims, the central value the 211-dim
        # state (shadow_hand.py:125-128, 481-485)
        if cfg.obs_type == "openai":
            self.num_obs, self.num_teacher_obs = 42, 211
        else:
            self.num_obs, self.num_teacher_obs = 211, 0
        self.obs_slices = {"obs": (0, self.num_obs)}

    def _targets(self, a, prev):
        cfg = self.cfg
        act = self.actuated_idx
        lo, hi = self.q_lo[act], self.q_hi[act]
        targets = prev.clone()
        targets[:, act] = (cfg.act_moving_average * (lo + (a + 1.0) * 0.5 * (hi - lo))
                           + (1.0 - cfg.act_moving_average) * prev[:, act])
        targets[:, self.coupled_idx[:, 0]] = targets[:, self.coupled_idx[:, 1]]
        return torch.minimum(torch.maximum(targets, self.q_lo), self.q_hi)

    def _obs(self, s: DexState, info=None):
        if self.cfg.obs_type == "openai":
            return self._obs_openai(s, info)
        return self._obs_full_state(s, info)

    def _teacher_obs(self, s: DexState, info=None):
        """The privileged full state of the asymmetric central value."""
        return self._obs_full_state(s, info)

    def _obs_openai(self, s: DexState, info=None):
        """42 dims (compute_fingertip_observations, shadow_hand.py:481-485)."""
        obj = s.physics.objects
        opos, oquat = obj.pos[:, 0], obj.quat[:, 0]
        B = opos.shape[0]
        ft_state, _ = self.fingertip_state(s, info)
        parts = [ft_state[..., :3].reshape(B, -1), opos,
                 quat_mul(oquat, quat_conj(s.goal_quat)), s.actions]
        return torch.clamp(torch.cat(parts, -1), -5.0, 5.0)

    def _obs_full_state(self, s: DexState, info=None):
        cfg = self.cfg
        rob, obj = s.physics.robot, s.physics.objects
        B = rob.q.shape[0]
        opos, oquat = obj.pos[:, 0], obj.quat[:, 0]
        goal = self.goal_pos_const[None].expand_as(opos)
        tau = self._pd_torque(s, self.scene.model.effort_limit[None])
        ft_state, ft_force = self.fingertip_state(s, info)
        parts = [self._unscale(rob.q), cfg.vel_obs_scale * rob.qd,  # 24, 24
                 cfg.force_obs_scale * tau, torch.cat([opos, oquat], -1),  # 24, 7
                 obj.linvel[:, 0], cfg.vel_obs_scale * obj.angvel[:, 0],  # 3, 3
                 torch.cat([goal, s.goal_quat], -1),  # 7
                 quat_mul(oquat, quat_conj(s.goal_quat)),  # 4
                 ft_state.reshape(B, -1), ft_force.reshape(B, -1), s.actions]  # 65, 30, 20
        return torch.clamp(torch.cat(parts, -1), -5.0, 5.0)

    def fingertip_state(self, s: DexState, info):
        """([B, 5, 13] pos / quat / linvel / scaled angvel, [B, 5, 6] scaled
        force-torque): the force from the step's contact impulses, the
        torque zero; zero forces without a step's info."""
        m = self.scene.model
        rob = s.physics.robot
        B = rob.q.shape[0]
        fk = forward_kinematics(m, rob.q, self.scene.base_quat[None], self.scene.base_pos[None])
        bv = body_velocities(m, fk, rob.qd)  # [B, nb, 6] (angular, linear at the origin)
        fb = self.fingertip_bodies
        pos, quat = fk.body_pos[:, fb], fk.body_quat[:, fb]
        w = bv[:, fb, :3]
        v = bv[:, fb, 3:] + cross(w, pos)
        state13 = torch.cat([pos, quat, v, self.cfg.vel_obs_scale * w], -1)
        force = (info.body_contact_force[:, fb] if info is not None
                 else torch.zeros(B, 5, 3, device=rob.q.device))
        ft = torch.cat([force, torch.zeros_like(force)], -1)
        return state13, self.cfg.force_obs_scale * ft


def allegro_config(num_envs: int = 256, **kw) -> DexHandConfig:
    return DexHandConfig(num_envs=num_envs, **kw)


def shadow_config(num_envs: int = 256, **kw) -> ShadowHandConfig:
    return ShadowHandConfig(num_envs=num_envs, **kw)


def make_allegro(num_envs: int = 256, device=None, **kw) -> AllegroHandEnv:
    return AllegroHandEnv(allegro_config(num_envs, **kw), device)


def make_shadow(num_envs: int = 256, device=None, **kw) -> ShadowHandEnv:
    return ShadowHandEnv(shadow_config(num_envs, **kw), device)
