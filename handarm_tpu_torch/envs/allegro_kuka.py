"""AllegroKuka, the DexPBT tasks on one arm and on two (counterpart of
handarm_tpu/envs/allegro_kuka.py; reference IsaacGymEnvs
tasks/allegro_kuka/allegro_kuka_base.py, _reorientation.py,
_regrasping.py, _throw.py, allegro_kuka_two_arms*.py,
cfg/task/AllegroKuka.yaml).

A KUKA iiwa 7 (7 dofs) with an Allegro hand (16) on a narrow table lifts a
cuboid and brings its keypoints to a goal:

- "reorientation": the goal a random position in the target volume and a
  random orientation; 4 corner keypoints (scaled by keypoint_scale).
- "regrasping": the goal a position in the volume, one centre keypoint; a
  success returns the object to the table, to be grasped again.
- "throw": the goal beside or behind the table (the reference's bucket
  mouth), one centre keypoint; a success returns the object too.

K = 3 box slots (mass 0.3 kg) stand in for the reference's set of
cuboids: env b's active slot is b % K, the others parked along the
table's far edge. The arm's targets move relative to the last ones
(dof_speed_scale * dt * action), the hand's are its actions scaled to the
joint limits; PD gains 40 / 5 on every joint, no robot gravity. The
reward is DexPBT's: fingertip approach deltas until lifted, lifting, the
lift bonus, keypoint approach deltas once lifted, joint-speed penalties
and the goal bonus. A success resamples the goal only (and restarts the
episode's clock); an episode ends when the object falls off, a fingertip
is 1.5 m from it, at the episode's length, at 50 successes or on a
non-finite state. The success tolerance shrinks by a curriculum on the
batch's EWMA of the successes of the episodes that end, kept on the
device with the EWMA and its frame count, out of the per-env reset.

The env draws from its own torch.Generator, seeded by `reset(seed)`;
`reset` and `step` take `AKDraws` in place of those draws (a test hands
over the JAX package's). A step consumes every draw whether or not an env
succeeds or restarts. The URDF is the in-repo stand-in
`assets/classic_standin/urdf/kuka_allegro_description/kuka_allegro_touch_sensor.urdf`
(`KUKA_ALLEGRO_URDF`), its collision spheres fitted by `robots.spherefit`,
two a link.

The two-arm tasks (`AllegroKukaTwoArmsEnv`: reorientation and regrasping,
as the JAX package's) mount that robot twice under one root, `a0_` at x =
-1.1 turned +90 degrees about z and `a1_` at x = +1.1 turned -90 degrees,
facing each other across the table (`generate_two_arms_urdf`, written
under the checkout's `build/` directory): nv 46, 46 actions, the arm
blocks' targets relative and the hand blocks' absolute, fingertip terms
over all 8 tips, three larger boxes of 0.5 kg spawned over the table's
centre. As in the JAX package, the palm's pose, velocity and offset are
arm 0's alone, the default joints set both arms' first 7 dofs, the joint
penalties split the dofs at 7 (arm 0's against the other 39), and a fresh
goal is shifted by -0.05 m in y where a goal resampled on success is not.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

import hashlib
import xml.etree.ElementTree as ET

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.classic import STANDIN_ROOT
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, where_done
from handarm_tpu_torch.math.quat import cross, quat_rotate
from handarm_tpu_torch.physics.contacts import StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.kinematics import body_velocities, forward_kinematics, site_poses
from handarm_tpu_torch.physics.model import compile_urdf
from handarm_tpu_torch.physics.shapes import make_box_object, stack_objects
from handarm_tpu_torch.ops.build import BUILD_ROOT
from handarm_tpu_torch.physics.solver import SolverParams
from handarm_tpu_torch.robots.spherefit import make_generic_spheres

KUKA_ALLEGRO_URDF = os.path.join(STANDIN_ROOT, "urdf", "kuka_allegro_description",
                                 "kuka_allegro_touch_sensor.urdf")
ARM_DOFS = 7
HAND_DOFS = 16
# allegro_kuka_base.py:284, pose v1
DEFAULT_KUKA = np.array([-1.571, 1.571, 0.0, 1.376, 0.0, 1.485, 2.358])
FINGERTIPS = ("index_link_3", "middle_link_3", "ring_link_3", "thumb_link_3")
# in the distal links' frames; the palm's in the flange link's
FINGERTIP_OFFSETS = np.array(
    [[0.05, 0.005, 0], [0.05, 0.005, 0], [0.05, 0.005, 0], [0.06, 0.005, 0]], np.float32)
PALM_OFFSET = np.array([-0.00, -0.02, 0.16], np.float32)
ARM_BASE = np.array([0.0, 0.8, 0.0])
TABLE_CENTER = np.array([0.0, 0.0])
TABLE_HALF = np.array([0.475 / 2, 0.4 / 2])  # table_narrow.urdf
TABLE_TOP = 0.38 + 0.15  # the table's z plus its half height
OBJECT_START = np.array([0.0, 0.0, 0.63])  # allegro_kuka_base.py:402-412
# the target volume (allegro_kuka_base.py:252-254)
TVOL_ORIGIN = np.array([0.0, 0.05, 0.8])
TVOL_MIN = TVOL_ORIGIN + np.array([-0.4, -0.05, -0.12])
TVOL_MAX = TVOL_ORIGIN + np.array([0.4, 0.3, 0.25])
VARIANTS = ("reorientation", "regrasping", "throw")
# the two-arm scene (allegro_kuka_two_arms.py:598-610): each arm's prefix,
# mount x and yaw about z; the composed file goes under TWO_ARMS_DIR
TWO_ARMS_MOUNTS = (("a0_", -1.1, 1.5707963), ("a1_", 1.1, -1.5707963))
TWO_ARMS_DIR = os.path.join(str(BUILD_ROOT), "urdf")
# its three boxes: a 10 cm cube, a 12.5 cm cube, a stick
TWO_ARMS_HALVES = ((0.05, 0.05, 0.05), (0.0625, 0.0625, 0.0625), (0.125, 0.025, 0.025))


@dataclass(frozen=True)
class AllegroKukaConfig:
    variant: str = "reorientation"  # reorientation | regrasping | throw
    num_envs: int = 256
    episode_length: int = 600
    dt: float = 1.0 / 60.0
    substeps: int = 2
    # the object slots' half extents: a 5 cm cube, a 6.5 cm cube, a stick
    object_halves: tuple = (
        (0.025, 0.025, 0.025),
        (0.0325, 0.0325, 0.0325),
        (0.075, 0.015, 0.015),
    )
    # reward scales (AllegroKuka.yaml:43-50)
    distance_delta_rew_scale: float = 50.0
    lifting_rew_scale: float = 20.0
    lifting_bonus: float = 300.0
    lifting_bonus_threshold: float = 0.15
    keypoint_rew_scale: float = 200.0
    kuka_actions_penalty_scale: float = 0.003
    allegro_actions_penalty_scale: float = 0.0003
    reach_goal_bonus: float = 1000.0
    keypoint_scale: float = 1.5
    success_tolerance: float = 0.075
    target_tolerance: float = 0.01
    tolerance_curriculum_increment: float = 0.9
    tolerance_curriculum_interval: int = 3000
    success_steps: int = 1
    max_consecutive_successes: int = 50
    fall_height: float = 0.1  # the object's z below this: it fell off the table
    # control (AllegroKuka.yaml:25-26)
    dof_speed_scale: float = 10.0
    act_moving_average: float = 1.0
    # reset noise (AllegroKuka.yaml:29-35)
    reset_position_noise: tuple = (0.1, 0.1, 0.02)
    reset_dof_pos_noise_arm: float = 0.1
    reset_dof_pos_noise_fingers: float = 0.1
    reset_dof_vel_noise: float = 0.5


class AKState(NamedTuple):
    """The JAX package's AKState without its PRNG key."""

    physics: PhysicsState
    targets: torch.Tensor  # [B, nv] persistent dof targets (23 a arm)
    progress: torch.Tensor  # [B] int64
    actions: torch.Tensor  # [B, nv]
    goal_pos: torch.Tensor  # [B, 3]
    goal_quat: torch.Tensor  # [B, 4]
    lifted: torch.Tensor  # [B] bool
    obj_init_z: torch.Tensor  # [B] the object's spawn height
    closest_kp_dist: torch.Tensor  # [B]
    closest_fingertip_dist: torch.Tensor  # [B, tips] (4 a arm; -1: not yet measured)
    furthest_hand_dist: torch.Tensor  # [B]
    near_goal_steps: torch.Tensor  # [B] int64
    successes: torch.Tensor  # [B] int64
    success_ewma: torch.Tensor  # [] the batch EWMA of the ended episodes' successes
    tolerance: torch.Tensor  # [] the curriculum's success tolerance
    frames_since_curriculum: torch.Tensor  # [] int64
    last_reward: torch.Tensor  # [B]


class AKGoalDraws(NamedTuple):
    """A goal's draws: `u` uniform in [0, 1), [B, 4] for throw ([B, 3]
    otherwise), and `rot` [B, 4] standard normal (read by reorientation)."""

    u: torch.Tensor
    rot: torch.Tensor


class AKObjectDraws(NamedTuple):
    """An object pose's draws: `pos` [B, 3] uniform in [-1, 1), `rot` [B, 4]
    standard normal."""

    pos: torch.Tensor
    rot: torch.Tensor


class AKDraws(NamedTuple):
    """The draws of fresh episodes (`dof` [B, nv] uniform in [0, 1), `dof_vel`
    [B, nv] uniform in [-1, 1), `obj`, `goal`), of the goals resampled on
    success (`resample`) and of the objects returned to the table on
    success (`ret`, regrasping and throw)."""

    dof: torch.Tensor
    dof_vel: torch.Tensor
    obj: AKObjectDraws
    goal: AKGoalDraws
    resample: AKGoalDraws
    ret: AKObjectDraws


class AllegroKukaEnv:
    """The PPO contract: reset, step, num_obs, num_actions, cfg.num_envs."""

    state_type = AKState
    arms = ("",)  # the arms' name prefixes in the URDF (23 dofs each, in this order)
    object_mass = 0.3  # kg, every box slot
    base_pos = tuple(ARM_BASE)
    object_start = OBJECT_START  # the spawn point, before the noise

    def urdf(self) -> str:
        return KUKA_ALLEGRO_URDF

    def __init__(self, cfg: AllegroKukaConfig = AllegroKukaConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks; the tolerance
        curriculum stays each rank's own."""
        if cfg.variant not in VARIANTS:
            raise ValueError(f"unknown AllegroKuka variant {cfg.variant!r}; known: {VARIANTS}")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        urdf = self.urdf()
        self.art = art = compile_urdf(urdf)
        nv = art.nv  # 23 a arm
        shapes = stack_objects([make_box_object(list(h), mass=self.object_mass)
                                for h in cfg.object_halves], device=dev)
        self.K = len(cfg.object_halves)
        self.obj_halves = f32(np.array(cfg.object_halves, np.float32))
        geom = StaticGeom(table_lo=f32(TABLE_CENTER - TABLE_HALF),
                          table_hi=f32(TABLE_CENTER + TABLE_HALF), table_height=TABLE_TOP)
        spheres = make_generic_spheres(urdf, art, spheres_per_link=2, device=dev)
        # stiffness 40, damping 5 on every joint (AllegroKuka.yaml:61-68)
        self.scene = build_scene(art, shapes, spheres, geom, kp=np.full(nv, 40.0),
                                 kd=np.full(nv, 5.0), base_pos=self.base_pos,
                                 base_quat=(1.0, 0.0, 0.0, 0.0),
                                 params=SimParams(dt=cfg.dt, substeps=cfg.substeps,
                                                  solver=SolverParams(iterations=8),
                                                  robot_gravity=False),
                                 device=dev)
        self.q_lo, self.q_hi = f32(art.q_min), f32(art.q_max)
        # every arm's four fingertips, then the palm of the first arm alone
        # (the JAX package's two-arm env reads a0_palm_link only)
        tips = [a + t for a in self.arms for t in FINGERTIPS]
        palm = art.sites[self.arms[0] + "palm_link"]
        self.site_bodies = np.array([art.sites[t].body for t in tips] + [palm.body])
        # the offsets in the sites' bodies' frames, summed in float32
        self.site_pos = f32(np.stack(
            [art.sites[t].pos.astype(np.float32) + FINGERTIP_OFFSETS[i % len(FINGERTIPS)]
             for i, t in enumerate(tips)] + [palm.pos.astype(np.float32) + PALM_OFFSET]))
        self.site_quat = f32(np.stack([art.sites[t].quat for t in tips] + [palm.quat]))
        self.palm_body = int(palm.body)
        self.num_tips = nt = len(tips)
        # per arm block: the KUKA's 7 dofs, then the hand's 16
        arm_dof = np.tile(np.arange(ARM_DOFS + HAND_DOFS) < ARM_DOFS, len(self.arms))
        dq = np.zeros(nv, np.float32)
        dq[arm_dof] = np.tile(DEFAULT_KUKA, len(self.arms))
        self.default_q = f32(np.clip(dq, art.q_min, art.q_max))
        self.dof_noise = f32(np.where(arm_dof, cfg.reset_dof_pos_noise_arm,
                                      cfg.reset_dof_pos_noise_fingers))
        # corner offsets (scaled by the slot's half extents and keypoint_scale),
        # or one centre point for regrasping and throw
        corners = [[1, 1, 1], [1, 1, -1], [-1, -1, 1], [-1, -1, -1]]
        self.kp_offsets = f32(corners if cfg.variant == "reorientation" else [[0, 0, 0]])
        self.num_keypoints = nk = int(self.kp_offsets.shape[0])
        self.num_actions = nv
        # the full_state layout (allegro_kuka_base.py:196-221; two arms: 8 tips)
        self.num_obs = nv + nv + 3 + 10 + 10 + 3 * nt + nk * 3 + nk * 3 + 3 + 1 + 1 + 2 + nt + 1
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- kinematics ---------------------------------------------------------

    def hand(self, phys: PhysicsState):
        """(fingertips [B, tips, 3], palm position [B, 3], palm quat [B, 4], palm
        linear and angular velocity [B, 3]), in the world frame."""
        sc = self.scene
        bq, bp = sc.base_quat[None], sc.base_pos[None]
        fk = forward_kinematics(sc.model, phys.robot.q, bq, bp)
        sq, sp = site_poses(fk, self.site_bodies, self.site_pos, self.site_quat, bq, bp)
        bv = body_velocities(sc.model, fk, phys.robot.qd)
        nt = self.num_tips
        palm_w = bv[:, self.palm_body, :3]
        palm_v = bv[:, self.palm_body, 3:] + cross(palm_w, sp[:, nt])
        return sp[:, :nt], sp[:, nt], sq[:, nt], palm_v, palm_w

    def active(self, B: int) -> torch.Tensor:
        """[B] each env's active object slot, b % K."""
        return torch.arange(B, device=self.device) % self.K

    def object_state(self, phys: PhysicsState, slot):
        """The active objects' (pos, quat, linvel, angvel)."""
        i = torch.arange(slot.shape[0], device=slot.device)
        o = phys.objects
        return o.pos[i, slot], o.quat[i, slot], o.linvel[i, slot], o.angvel[i, slot]

    def keypoints(self, pos, quat, slot):
        """[B, nk, 3] world keypoints of a pose of the slot's object."""
        half = self.obj_halves[slot]  # [B, 3]
        offs = self.kp_offsets[None] * half[:, None] * self.cfg.keypoint_scale
        return pos[:, None] + quat_rotate(quat[:, None], offs)

    # --- draws and resets ------------------------------------------------------

    def draw(self, B: int) -> AKDraws:
        dev, g = self.device, self.gen
        uniform = lambda *s: torch.rand(s, generator=g, device=dev)
        normal = lambda *s: torch.randn(s, generator=g, device=dev)
        width = 4 if self.cfg.variant == "throw" else 3
        goal = lambda: AKGoalDraws(u=uniform(B, width), rot=normal(B, 4))
        obj = lambda: AKObjectDraws(pos=uniform(B, 3) * 2.0 - 1.0, rot=normal(B, 4))
        nv = self.art.nv
        return AKDraws(dof=uniform(B, nv), dof_vel=uniform(B, nv) * 2.0 - 1.0, obj=obj(),
                       goal=goal(), resample=goal(), ret=obj())

    def sample_goal(self, d: AKGoalDraws):
        """(goal pos [B, 3], goal quat [B, 4])."""
        B = d.u.shape[0]
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device).expand(B, 4)
        if self.cfg.variant == "throw":
            # the bucket mouth beside or behind the table
            u = d.u
            sign = torch.where(u[:, 0] > 0.5, 1.0, -1.0)
            pos = torch.stack([sign * (0.5 + 0.4 * u[:, 1]), -1.0 + 1.7 * u[:, 2],
                               u[:, 3] + 0.05], -1)
            return pos, ident
        lo = torch.as_tensor(TVOL_MIN, dtype=torch.float32, device=self.device)
        span = torch.as_tensor(TVOL_MAX - TVOL_MIN, dtype=torch.float32, device=self.device)
        pos = lo + d.u[:, :3] * span
        if self.cfg.variant == "reorientation":
            return pos, d.rot / torch.linalg.vector_norm(d.rot, dim=-1, keepdim=True)
        return pos, ident

    def object_reset_pose(self, d: AKObjectDraws):
        """(pos [B, 3], quat [B, 4]) over the table: the start plus noise, a
        uniform random orientation."""
        noise = d.pos * torch.as_tensor(self.cfg.reset_position_noise, dtype=torch.float32,
                                        device=self.device)
        pos = torch.as_tensor(self.object_start, dtype=torch.float32, device=self.device) + noise
        return pos, d.rot / torch.linalg.vector_norm(d.rot, dim=-1, keepdim=True)

    def park_positions(self, B: int) -> torch.Tensor:
        """[B, K, 3]: the K slots in a row along the table's far edge."""
        ks = torch.arange(self.K, dtype=torch.float32, device=self.device)
        px = float(-TABLE_HALF[0] + 0.08) + 0.16 * ks
        py = torch.full((self.K,), float(TABLE_HALF[1] - 0.06), device=self.device)
        pz = TABLE_TOP + self.obj_halves[:, 2] + 0.002
        return torch.stack([px, py, pz], -1).expand(B, self.K, 3)

    def _fresh(self, B: int, d: AKDraws) -> AKState:
        cfg, dev = self.cfg, self.device
        slot = self.active(B)
        i = torch.arange(B, device=dev)
        # the default joints plus noise times a uniform point of the limits
        delta = self.q_lo[None] + d.dof * (self.q_hi - self.q_lo)[None]
        q0 = self.default_q[None] + self.dof_noise[None] * (delta - self.default_q[None])
        q0 = torch.minimum(torch.maximum(q0, self.q_lo[None]), self.q_hi[None])
        phys = initial_state(self.scene, B, q0=q0)
        qd0 = cfg.reset_dof_vel_noise * d.dof_vel
        obj_pos, obj_quat = self.object_reset_pose(d.obj)
        opos = self.park_positions(B).clone()
        opos[i, slot] = obj_pos
        oquat = phys.objects.quat.clone()
        oquat[i, slot] = obj_quat
        phys = phys._replace(robot=phys.robot._replace(qd=qd0, targets=q0),
                             objects=phys.objects._replace(pos=opos, quat=oquat))
        goal_pos, goal_quat = self.sample_goal(d.goal)
        zeros = torch.zeros(B, device=dev)
        izeros = torch.zeros(B, dtype=torch.int64, device=dev)
        return AKState(
            physics=phys, targets=q0, progress=izeros,
            actions=torch.zeros(B, self.num_actions, device=dev),
            goal_pos=goal_pos, goal_quat=goal_quat,
            lifted=torch.zeros(B, dtype=torch.bool, device=dev), obj_init_z=obj_pos[:, 2],
            closest_kp_dist=torch.full((B,), 1e6, device=dev),
            closest_fingertip_dist=torch.full((B, self.num_tips), -1.0, device=dev),
            furthest_hand_dist=torch.full((B,), -1.0, device=dev),
            near_goal_steps=izeros.clone(), successes=izeros.clone(),
            success_ewma=torch.zeros((), device=dev),
            tolerance=torch.tensor(cfg.success_tolerance, dtype=torch.float32, device=dev),
            frames_since_curriculum=torch.zeros((), dtype=torch.int64, device=dev),
            last_reward=zeros)

    def reset(self, seed: int = 0, draws: AKDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        B = self.cfg.num_envs
        state = self._fresh(B, draws if draws is not None else self.draw(B))
        return state, self._obs(state)

    def observe(self, state: AKState):
        obs = self._obs(state)
        return obs, obs.new_zeros(obs.shape[0], 0), {"obs": obs}

    # --- observation --------------------------------------------------------

    def _obs(self, s: AKState) -> torch.Tensor:
        phys = s.physics
        B = phys.robot.q.shape[0]
        slot = self.active(B)
        tips, palm_p, palm_q, palm_v, palm_w = self.hand(phys)
        opos, oquat, olin, oang = self.object_state(phys, slot)
        obj_kp = self.keypoints(opos, oquat, slot)
        goal_kp = self.keypoints(s.goal_pos, s.goal_quat, slot)
        max_kp_dist = torch.linalg.vector_norm(obj_kp - goal_kp, dim=-1).amax(-1)
        half = self.obj_halves[slot]
        progress = s.progress.to(torch.float32)
        obs = torch.cat([
            phys.robot.q, phys.robot.qd, palm_p, palm_q, palm_v, palm_w, oquat, olin, oang,
            (tips - opos[:, None]).reshape(B, -1),
            (obj_kp - goal_kp).reshape(B, -1),
            goal_kp.reshape(B, -1) - opos.repeat(1, self.num_keypoints),
            half * 2.0,  # the object's dimensions
            max_kp_dist[:, None], s.lifted.to(torch.float32)[:, None],
            (progress / self.cfg.episode_length)[:, None],
            s.tolerance.expand(B)[:, None], s.closest_fingertip_dist, s.last_reward[:, None],
        ], -1)
        return torch.clamp(obs, -10.0, 10.0)

    # --- step -------------------------------------------------------------------

    def step(self, state: AKState, actions, draws: AKDraws | None = None):
        """(new state, ClassicStepResult)."""
        cfg = self.cfg
        d = draws if draws is not None else self.draw(actions.shape[0])
        actions = torch.clamp(actions, -1.0, 1.0)
        # per arm block, the arm's targets move relative to the last ones, the
        # hand's are the actions scaled to the limits, with a moving average
        blocks = []
        for k in range(len(self.arms)):
            a0 = k * (ARM_DOFS + HAND_DOFS)
            a, h = slice(a0, a0 + ARM_DOFS), slice(a0 + ARM_DOFS, a0 + ARM_DOFS + HAND_DOFS)
            arm_t = state.targets[:, a] + cfg.dof_speed_scale * cfg.dt * actions[:, a]
            hand_scaled = self.q_lo[h][None] + 0.5 * (actions[:, h] + 1.0) * (
                self.q_hi[h] - self.q_lo[h])[None]
            blocks += [arm_t, cfg.act_moving_average * hand_scaled
                       + (1.0 - cfg.act_moving_average) * state.targets[:, h]]
        targets = torch.minimum(torch.maximum(torch.cat(blocks, -1), self.q_lo[None]),
                                self.q_hi[None])
        return self._step_with_targets(state, actions, targets, d)

    def _step_with_targets(self, state: AKState, actions, targets, d: AKDraws):
        cfg, dev = self.cfg, self.device
        B = actions.shape[0]
        slot = self.active(B)
        i = torch.arange(B, device=dev)
        phys = state.physics
        phys = phys._replace(robot=phys.robot._replace(targets=targets))
        phys, _ = engine_step(self.scene, phys)

        progress = state.progress + 1
        tips, *_ = self.hand(phys)
        opos, oquat, _, _ = self.object_state(phys, slot)

        # the DexPBT reward (allegro_kuka_base.py:759-895)
        tip_dist = torch.linalg.vector_norm(tips - opos[:, None], dim=-1)  # [B, tips]
        cfd = torch.where(state.closest_fingertip_dist < 0, tip_dist,
                          state.closest_fingertip_dist)
        fingertip_deltas = torch.clamp(cfd - tip_dist, 0.0, 10.0)
        closest_fingertip_dist = torch.minimum(cfd, tip_dist)
        fingertip_delta_rew = fingertip_deltas.sum(-1) * (~state.lifted)

        z_lift = 0.05 + opos[:, 2] - state.obj_init_z
        lifting_rew = torch.clamp(z_lift, 0.0, 0.5)
        lifted = (z_lift > cfg.lifting_bonus_threshold) | state.lifted
        just_lifted = lifted & ~state.lifted
        lift_bonus_rew = cfg.lifting_bonus * just_lifted
        lifting_rew = lifting_rew * (~lifted)

        obj_kp = self.keypoints(opos, oquat, slot)
        goal_kp = self.keypoints(state.goal_pos, state.goal_quat, slot)
        kp_max_dist = torch.linalg.vector_norm(obj_kp - goal_kp, dim=-1).amax(-1)
        kp_deltas = torch.clamp(state.closest_kp_dist - kp_max_dist, 0.0, 100.0)
        closest_kp_dist = torch.minimum(state.closest_kp_dist, kp_max_dist)
        keypoint_rew = kp_deltas * lifted

        qd = phys.robot.qd  # split at 7 on two arms too, as in the JAX package
        kuka_pen = qd[:, :ARM_DOFS].abs().sum(-1) * cfg.kuka_actions_penalty_scale
        allegro_pen = qd[:, ARM_DOFS:].abs().sum(-1) * cfg.allegro_actions_penalty_scale

        near_goal = kp_max_dist <= state.tolerance * cfg.keypoint_scale
        near_goal_steps = state.near_goal_steps + near_goal
        is_success = near_goal_steps >= cfg.success_steps
        successes = state.successes + is_success
        bonus_rew = near_goal * (cfg.reach_goal_bonus / cfg.success_steps)

        reward = (cfg.distance_delta_rew_scale * fingertip_delta_rew
                  + cfg.lifting_rew_scale * lifting_rew + lift_bonus_rew
                  + cfg.keypoint_rew_scale * keypoint_rew - kuka_pen - allegro_pen + bonus_rew)
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        # a success resamples the goal only
        ok = is_success[:, None]
        new_goal_pos, new_goal_quat = self.sample_goal(d.resample)
        goal_pos = torch.where(ok, new_goal_pos, state.goal_pos)
        goal_quat = torch.where(ok, new_goal_quat, state.goal_quat)
        obj_init_z = state.obj_init_z
        rp, rq = self.object_reset_pose(d.ret)  # drawn for every variant, as in JAX
        if cfg.variant in ("regrasping", "throw"):
            # the object returns to the table, to be grasped again
            o = phys.objects
            pos, quat, linvel, angvel = (x.clone() for x in o)
            pos[i, slot] = torch.where(ok, rp, o.pos[i, slot])
            quat[i, slot] = torch.where(ok, rq, o.quat[i, slot])
            linvel[i, slot] = torch.where(ok, 0.0, o.linvel[i, slot])
            angvel[i, slot] = torch.where(ok, 0.0, o.angvel[i, slot])
            phys = phys._replace(objects=o._replace(pos=pos, quat=quat, linvel=linvel,
                                                    angvel=angvel))
            lifted = lifted & ~is_success
            obj_init_z = torch.where(is_success, rp[:, 2], obj_init_z)
        closest_kp_dist = torch.where(is_success, 1e6, closest_kp_dist)
        closest_fingertip_dist = torch.where(ok, -1.0, closest_fingertip_dist)
        near_goal_steps = torch.where(is_success, 0, near_goal_steps)
        # a success restarts the episode's clock (allegro_kuka_base.py:844-846)
        progress = torch.where(is_success, 0, progress)

        fell = opos[:, 2] < cfg.fall_height
        too_far = tip_dist.amax(-1) > 1.5
        finite = torch.isfinite(phys.robot.q).all(-1)
        done = (fell | too_far | (progress >= cfg.episode_length)
                | (successes >= cfg.max_consecutive_successes) | ~finite)

        # the tolerance curriculum (allegro_kuka_utils.py:86-116), on the
        # device: the EWMA of the ended episodes' successes
        ended = done.to(torch.float32)
        n_ended = ended.sum()
        end_succ = (successes.to(torch.float32) * ended).sum() / torch.clamp(n_ended, min=1.0)
        alpha = 0.05 * torch.clamp(n_ended / B, 0.0, 1.0)
        success_ewma = (1 - alpha) * state.success_ewma + alpha * end_succ
        frames = state.frames_since_curriculum + 1
        update = (frames >= cfg.tolerance_curriculum_interval) & (success_ewma >= 3.0)
        tolerance = torch.where(update, torch.clamp(
            state.tolerance * cfg.tolerance_curriculum_increment, cfg.target_tolerance,
            cfg.success_tolerance), state.tolerance)
        frames = torch.where(update, 0, frames)

        # the per-env fields restart where done; the three scalars carry on
        fresh = self._fresh(B, d)
        keep = lambda new, cur: where_done(done, new, cur)
        new_state = AKState(
            physics=keep(fresh.physics, phys), targets=keep(fresh.targets, targets),
            progress=keep(fresh.progress, progress), actions=keep(fresh.actions, actions),
            goal_pos=keep(fresh.goal_pos, goal_pos), goal_quat=keep(fresh.goal_quat, goal_quat),
            lifted=keep(fresh.lifted, lifted), obj_init_z=keep(fresh.obj_init_z, obj_init_z),
            closest_kp_dist=keep(fresh.closest_kp_dist, closest_kp_dist),
            closest_fingertip_dist=keep(fresh.closest_fingertip_dist, closest_fingertip_dist),
            furthest_hand_dist=keep(fresh.furthest_hand_dist, state.furthest_hand_dist),
            near_goal_steps=keep(fresh.near_goal_steps, near_goal_steps),
            successes=keep(fresh.successes, successes), success_ewma=success_ewma,
            tolerance=tolerance, frames_since_curriculum=frames,
            last_reward=keep(fresh.last_reward, reward))
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        f = lambda x: x.to(torch.float32).mean()
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done,
            info={"successes_mean": f(successes), "success_ewma": success_ewma,
                  "tolerance": tolerance, "lifted_frac": f(lifted)},
            teacher_obs=obs.new_zeros(B, 0))


def allegro_kuka_config(num_envs: int = 256, variant: str = "reorientation",
                        **kw) -> AllegroKukaConfig:
    return AllegroKukaConfig(variant=variant, num_envs=num_envs, **kw)


def make_allegro_kuka(variant: str = "reorientation", num_envs: int = 256,
                      episode_length: int = 600, device=None, **kw) -> AllegroKukaEnv:
    return AllegroKukaEnv(allegro_kuka_config(num_envs, variant,
                                              episode_length=episode_length, **kw), device)


# --- the two-arm tasks ---------------------------------------------------------


def generate_two_arms_urdf() -> str:
    """The two-arm file: the links and joints of `KUKA_ALLEGRO_URDF` twice,
    named with the `a0_` / `a1_` prefixes, each copy's `iiwa7_base_link`
    fixed to one `world_root` at its mount (TWO_ARMS_MOUNTS); relative mesh
    paths made absolute under the stand-in's parent directory. The same
    elements, in the same order, as the JAX package's
    `_generate_two_arms_urdf` writes from that file. Written once a
    content under TWO_ARMS_DIR, atomically; returns its path."""
    src = ET.parse(KUKA_ALLEGRO_URDF).getroot()
    mesh_root = os.path.dirname(os.path.dirname(KUKA_ALLEGRO_URDF))
    robot = ET.Element("robot", name="kuka_allegro_two_arms")
    ET.SubElement(robot, "link", name="world_root")
    for prefix, x_ofs, yaw in TWO_ARMS_MOUNTS:
        for el in src:
            if el.tag not in ("link", "joint"):
                continue
            el2 = ET.fromstring(ET.tostring(el))
            el2.set("name", prefix + el2.get("name"))
            for sub in el2.iter():
                if sub.tag in ("parent", "child") and sub.get("link"):
                    sub.set("link", prefix + sub.get("link"))
                fn = sub.get("filename") if sub.tag == "mesh" else None
                if fn and not os.path.isabs(fn):
                    sub.set("filename", os.path.normpath(os.path.join(mesh_root, fn)))
            robot.append(el2)
        j = ET.SubElement(robot, "joint", name=f"{prefix}mount", type="fixed")
        ET.SubElement(j, "parent", link="world_root")
        ET.SubElement(j, "child", link=prefix + "iiwa7_base_link")
        ET.SubElement(j, "origin", xyz=f"{x_ofs} 0 0", rpy=f"0 0 {yaw}")
    text = ET.tostring(robot)
    path = os.path.join(TWO_ARMS_DIR,
                        f"kuka_allegro_two_arms_{hashlib.sha256(text).hexdigest()[:16]}.urdf")
    if not os.path.exists(path):
        os.makedirs(TWO_ARMS_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(text)
        os.replace(tmp, path)
    return path


@dataclass(frozen=True)
class AllegroKukaTwoArmsConfig(AllegroKukaConfig):
    """AllegroKukaConfig with the two-arm scene's larger boxes."""

    object_halves: tuple = TWO_ARMS_HALVES


class AllegroKukaTwoArmsEnv(AllegroKukaEnv):
    """Two KUKA + Allegro arms facing each other across the table, one object
    (counterpart of the JAX package's AllegroKukaTwoArmsEnv; reference
    allegro_kuka_two_arms_reorientation.py / _regrasping.py): the one-arm
    env's step and state at nv 46, with 8 fingertips, 0.5 kg boxes spawned
    over the table's centre, the table at the origin, and a fresh goal
    shifted by -0.05 in y."""

    arms = tuple(p for p, _, _ in TWO_ARMS_MOUNTS)
    object_mass = 0.5
    base_pos = (0.0, 0.0, 0.0)
    object_start = np.array([0.0, 0.0, TABLE_TOP + 0.25])

    def urdf(self) -> str:
        return generate_two_arms_urdf()

    def _fresh(self, B: int, d: AKDraws) -> AKState:
        s = super()._fresh(B, d)  # a fresh goal shifted by -0.05 m in y, a resampled one not
        return s._replace(goal_pos=s.goal_pos - torch.tensor([0.0, 0.05, 0.0],
                                                             device=self.device))


def allegro_kuka_two_arms_config(num_envs: int = 256, variant: str = "reorientation",
                                 **kw) -> AllegroKukaTwoArmsConfig:
    # the boxes are the scene's: an `object_halves` override raises TypeError,
    # as the JAX package's make_allegro_kuka_two_arms does
    return AllegroKukaTwoArmsConfig(variant=variant, num_envs=num_envs,
                                    object_halves=TWO_ARMS_HALVES, **kw)


def make_allegro_kuka_two_arms(variant: str = "reorientation", num_envs: int = 256,
                               episode_length: int = 600, device=None,
                               **kw) -> AllegroKukaTwoArmsEnv:
    return AllegroKukaTwoArmsEnv(allegro_kuka_two_arms_config(
        num_envs, variant, episode_length=episode_length, **kw), device)
