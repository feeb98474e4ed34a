"""The Factory tasks (counterpart of handarm_tpu/envs/factory.py; reference
IsaacGymEnvs tasks/factory/: factory_env_nut_bolt.py, factory_env_gears.py,
factory_env_insertion.py, factory_task_nut_bolt_{pick,place,screw}.py,
factory_control.py).

The Franka Panda with its gripper over a table, and the reference's own
parts baked to voxel SDFs at R = 40 (`envs/objects.py` `PART_RECORD_KEYS`,
read as tracked, their mass and inertia rescaled to the task's steel
masses here): the M16 nut and bolt, the medium and small gears with the
gear base, or the round 8 mm peg and its hole. The arm is torque-driven by
task-space impedance on the grip site (`physics/osc.py`, kp 300); 12
actions (a 6D dpose and a 6D force half the reference leaves unused), the
gripper open or closed on action 6 (the pick task closes it on a clock,
past 3/4 of the episode).

Variants (`FactoryConfig.task`):
- "pick": the keypoint reward between the gripper's and the nut-grasp
  frame's keypoint lines; success latches once the nut is lifted three
  bolt-head heights.
- "place": the nut starts in the closed gripper; keypoints nut vs the bolt
  tip.
- "screw": the nut rides a cylindrical rail on the bolt (`engine.RailSpec`
  with `spin`); after each engine step its yaw is unwrapped and drives its
  height down the thread (2 mm a turn). Its observation carries the
  fingertips' contact forces (`StepInfo.body_contact_force`).
- "gears" (gear base + medium and small gears, K = 3) and "insertion" (peg
  + hole): observed like pick; the reference's rewards are scaffolds, so
  zero reward and timeout-only episodes. These scenes run the solver
  without warm start (their mm-scale parts relocate their contacts every
  substep).

One env step evaluates the dynamics twice at the same q (OSC here, and the
engine's sim step), as the JAX package does. The env holds its state on
one device and draws from its own torch.Generator, seeded by `reset(seed)`;
`reset` and `step` take `FactoryDraws` in place of those draws (a test
hands over the JAX package's). The robot is the in-repo stand-in Franka
(`envs/franka.py` `FRANKA_URDF`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs import objects as object_records
from handarm_tpu_torch.envs.franka import franka_eef, franka_osc_tau, franka_robot, franka_sites
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, where_done
from handarm_tpu_torch.math.quat import quat_rotate, quat_to_matrix
from handarm_tpu_torch.physics.contacts import StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    RailSpec,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.shapes import stack_objects
from handarm_tpu_torch.physics.solver import SolverParams

TABLE_HEIGHT = 0.4  # FactoryBase.yaml:41
# m16 geometry (assets/factory/yaml/factory_asset_info_nut_bolt.yaml)
BOLT_HEAD_HEIGHT = 0.02
BOLT_SHANK_LENGTH = 0.08
NUT_HEIGHT = 0.016
THREAD_PITCH = 0.002  # m per revolution
FRANKA_INIT_DOF = np.array(
    # FactoryTaskNutBoltPick.yaml:25 + open gripper
    [0.3413, -0.8011, -0.0670, -1.8299, 0.0266, 1.0185, 1.0927, 0.04, 0.04],
    np.float32,
)
# each variant's parts and their masses (kg); object 0 is the grasped one
PARTS = {
    "nut_bolt": (("factory_nut_m16_loose", 0.03), ("factory_bolt_m16_loose", 0.1)),
    "gears": (("factory_gear_medium", 0.05), ("factory_gear_base_loose", 0.5),
              ("factory_gear_small", 0.03)),
    "insertion": (("factory_round_peg_8mm_loose", 0.02), ("factory_round_hole_8mm", 0.5)),
}


def load_part(name: str, mass: float) -> dict:
    """A part's tracked record with its mass set and its inertia scaled alike
    (the JAX package's `_load_factory_mesh` / industreal `_load_ir_mesh`)."""
    rec = object_records.load_object(name)
    scale = mass / max(rec["mass"], 1e-9)
    rec["mass"] = mass
    rec["inertia_diag"] = np.asarray(rec["inertia_diag"]) * scale
    return rec


def body_z_half_extent(rec) -> float:
    """Height of the body origin above the mesh's bottom along body z: the
    OBB rotated into the body frame (|R[2, :]| . half-extents), less the OBB
    centre's offset. A part spawned at table + this value rests on it."""
    R = quat_to_matrix(torch.as_tensor(np.asarray(rec["obb_quat"], np.float32))).numpy()
    half = np.abs(R[2, :]) @ np.asarray(rec["size"], np.float64)
    return float(half - np.asarray(rec["obb_pos"])[2])


@dataclass(frozen=True)
class FactoryConfig:
    task: str = "pick"  # pick | place | screw | gears | insertion
    num_envs: int = 128
    episode_length: int = 100  # FactoryTaskNutBoltPick.yaml max_episode_length
    dt: float = 1.0 / 60.0
    substeps: int = 2
    num_keypoints: int = 4
    keypoint_scale: float = 0.5
    keypoint_reward_scale: float = 1.0
    action_penalty_scale: float = 0.0
    success_bonus: float = 1.0
    # task-space impedance gains (FactoryControl.yaml task_space_impedance)
    task_prop_gain: tuple = (300.0, 300.0, 300.0, 50.0, 50.0, 50.0)
    pos_action_scale: float = 0.1
    rot_action_scale: float = 0.05
    nut_xy: tuple = (0.0, -0.3)
    nut_xy_noise: float = 0.1
    bolt_xy: tuple = (0.0, 0.0)
    bolt_xy_noise: float = 0.02


class FactoryState(NamedTuple):
    """The JAX package's FactoryState without its PRNG key."""

    physics: PhysicsState
    progress: torch.Tensor  # [B] int64
    actions: torch.Tensor  # [B, 12]
    lifted: torch.Tensor  # [B] bool: the pick-success latch
    theta: torch.Tensor  # [B] the nut's unwrapped rotation (screw)
    prev_yaw: torch.Tensor  # [B]
    finger_force: torch.Tensor  # [B, 6] left / right fingertip contact force
    bolt_pos: torch.Tensor  # [B, 3] the bolt's (or base's, hole's) spawn position


class FactoryDraws(NamedTuple):
    """The draws of fresh episodes: `nut` and `bolt` [B, 2], uniform in
    [-1, 1), the object-0 and object-1 xy noise before scaling."""

    nut: torch.Tensor
    bolt: torch.Tensor


class FactoryNutBoltEnv:
    """Engine-backed Factory task (the PPO contract: reset, step, num_obs,
    num_actions, cfg.num_envs)."""

    state_type = FactoryState

    def __init__(self, cfg: FactoryConfig = FactoryConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        if cfg.task not in ("pick", "place", "screw", "gears", "insertion"):
            raise ValueError(f"unknown Factory task {cfg.task!r}")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        self.art, spheres, self.sites = franka_robot(dev)
        nv = self.art.nv
        parts = PARTS.get(cfg.task, PARTS["nut_bolt"])
        recs = [load_part(f"factory/{name}", mass) for name, mass in parts]
        self.K = len(recs)
        # each part's com over the table at rest: the body-frame z
        # half-extent of its rotated OBB (not size[2], the half-extent along
        # the OBB's own smallest axis)
        self.spawn_h = [body_z_half_extent(r) for r in recs]
        self.grasp_h = (NUT_HEIGHT if cfg.task in ("pick", "place", "screw")
                        else 2.0 * self.spawn_h[0])
        rails = None
        if cfg.task == "screw":
            # the nut rides the bolt: a cylindrical rail about world z at the
            # bolt's axis (the screw task draws no bolt noise)
            axis, origin = np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32)
            axis[0] = [0.0, 0.0, 1.0]
            origin[0] = [cfg.bolt_xy[0], cfg.bolt_xy[1], 0.0]
            rails = RailSpec(
                axis=axis, origin=origin,
                quat=np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1)),
                lo=np.array([TABLE_HEIGHT + BOLT_HEAD_HEIGHT, 0.0]),
                hi=np.array([TABLE_HEIGHT + BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH, 0.0]),
                damping=np.array([4.0, 0.0]), mask=np.array([1.0, 0.0]),
                spin=np.array([1.0, 0.0]))
        geom = StaticGeom(table_lo=f32([-0.4, -0.6]), table_hi=f32([0.6, 0.6]),
                          table_height=TABLE_HEIGHT)
        kp, kd = np.zeros(nv), np.zeros(nv)
        kp[7:], kd[7:] = 800.0, 40.0
        self.scene = build_scene(
            self.art, stack_objects(recs, device=dev), spheres, geom, kp=kp, kd=kd,
            base_pos=(-0.45, 0.0, TABLE_HEIGHT),
            params=SimParams(
                dt=cfg.dt, substeps=cfg.substeps,
                # 16 iterations: the reference factory budget
                # (cfg/task/FactoryBase.yaml:25); no warm start in the
                # free-tumbling-parts scenes, whose mm-scale parts relocate
                # their contacts every substep
                solver=SolverParams(iterations=16, warm_start=(
                    0.0 if cfg.task in ("gears", "insertion") else 0.9)),
                # the mm-scale parts' tiny inertias: caps and damping that
                # let tipped parts come to rest
                max_obj_angvel=20.0, obj_angular_damping=1.0, obj_linear_damping=0.2,
                robot_gravity=False),
            rails=rails, device=dev)
        self.q_lo, self.q_hi = f32(self.art.q_min), f32(self.art.q_max)
        self._effort = f32(self.art.effort_limit)
        self.arm_mask = f32([1.0] * 7 + [0.0] * 2)
        self.default_q = f32(FRANKA_INIT_DOF)
        # the keypoint line along local z (factory_task_nut_bolt_pick.py:95)
        ks = np.zeros((cfg.num_keypoints, 3), np.float32)
        ks[:, 2] = (np.linspace(0.0, 1.0, cfg.num_keypoints) - 0.5) * cfg.keypoint_scale * 0.1
        self.kp_offsets = f32(ks)
        self.finger_bodies = torch.as_tensor(self.sites.body[1:].astype(np.int64), device=dev)
        # the grip site at the initial pose (the place task's nut spawns there)
        _, _, sp = franka_sites(self.scene, self.sites, self.default_q[None])
        self.grip_home = sp[0, 0]
        self.num_actions = 12
        # gears and insertion observe like pick: the eef and object 0's grasp frame
        self.obs_mode = {"pick": "pick", "gears": "pick", "insertion": "pick",
                         "place": "place", "screw": "screw"}[cfg.task]
        self.num_obs = {"pick": 20, "place": 27, "screw": 32}[self.obs_mode]
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- helpers -----------------------------------------------------------------

    def _eef(self, phys: PhysicsState):
        """(FK, grip position, grip quat, its linear and angular velocity)."""
        return franka_eef(self.scene, self.sites, phys)[:5]

    def osc_tau(self, phys: PhysicsState, dpose: torch.Tensor) -> torch.Tensor:
        """The arm's task-space impedance torques [B, nv] (kp 300)."""
        return franka_osc_tau(self.scene, self.sites, phys, dpose,
                              kp=float(self.cfg.task_prop_gain[0]),
                              h=self.cfg.dt / self.cfg.substeps, default_q=self.default_q,
                              arm_mask=self.arm_mask, effort=self._effort)

    def _keypoints(self, pos, quat):
        """[B, num_keypoints, 3]: the keypoint line at a pose."""
        n = self.kp_offsets.shape[0]
        return pos[:, None] + quat_rotate(quat[:, None].expand(-1, n, 4),
                                          self.kp_offsets[None].expand(pos.shape[0], n, 3))

    def _nut_grasp_frame(self, phys: PhysicsState):
        """The grasp frame over object 0 at its grasp height."""
        pos = phys.objects.pos[:, 0] + pos_z(self.grasp_h, self.device)
        return pos, phys.objects.quat[:, 0]

    # --- reset ---------------------------------------------------------------------

    def draw(self, B: int) -> FactoryDraws:
        u = lambda: torch.rand(B, 2, generator=self.gen, device=self.device) * 2.0 - 1.0
        return FactoryDraws(nut=u(), bolt=u())

    def _fresh(self, B: int, draws: FactoryDraws | None = None) -> FactoryState:
        cfg, dev = self.cfg, self.device
        d = draws if draws is not None else self.draw(B)
        phys = initial_state(self.scene, B, q0=self.default_q[None])
        xy = lambda c: torch.tensor(c, dtype=torch.float32, device=dev)[None]
        col = lambda z: torch.full((B, 1), z, dtype=torch.float32, device=dev)
        nut_xy = xy(cfg.nut_xy) + cfg.nut_xy_noise * d.nut
        bolt_xy = xy(cfg.bolt_xy) + cfg.bolt_xy_noise * d.bolt
        if cfg.task == "screw":
            bolt_xy = xy(cfg.bolt_xy).expand(B, 2)
        bolt_z = (TABLE_HEIGHT + self.spawn_h[1] if cfg.task in ("gears", "insertion")
                  else TABLE_HEIGHT + BOLT_HEAD_HEIGHT / 2 + BOLT_SHANK_LENGTH / 2)
        bolt_pos = torch.cat([bolt_xy, col(bolt_z)], -1)
        if cfg.task in ("pick", "gears", "insertion"):
            nut_pos = torch.cat([nut_xy, col(TABLE_HEIGHT + self.spawn_h[0])], -1)
        elif cfg.task == "place":
            # the nut inside the closed gripper (the reference scripts a grasp
            # during reset, factory_task_nut_bolt_place.py)
            nut_pos = self.grip_home[None].expand(B, 3)
            q0, tg = self.default_q.clone(), self.default_q.clone()
            q0[7:], tg[7:] = 0.011, 0.0
            phys = phys._replace(robot=phys.robot._replace(
                q=q0[None].expand(B, -1).clone(), targets=tg[None].expand(B, -1).clone()))
        else:  # screw: the nut on top of the bolt's thread
            nut_pos = torch.cat([bolt_xy, col(TABLE_HEIGHT + BOLT_HEAD_HEIGHT
                                              + BOLT_SHANK_LENGTH)], -1)
        cols = [nut_pos, bolt_pos]
        if cfg.task == "gears":  # the small gear on the table beside the base
            cols.append(torch.cat([bolt_xy + xy((-0.08, 0.0)),
                                   col(TABLE_HEIGHT + self.spawn_h[2])], -1))
        phys = phys._replace(objects=phys.objects._replace(pos=torch.stack(cols, 1)))
        z = lambda *s: torch.zeros(*s, device=dev)
        return FactoryState(physics=phys, progress=torch.zeros(B, dtype=torch.int64, device=dev),
                            actions=z(B, self.num_actions),
                            lifted=torch.zeros(B, dtype=torch.bool, device=dev), theta=z(B),
                            prev_yaw=z(B), finger_force=z(B, 6), bolt_pos=bolt_pos)

    def reset(self, seed: int = 0, draws: FactoryDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        state = self._fresh(self.cfg.num_envs, draws)
        return state, self._obs(state)

    # --- observations --------------------------------------------------------------

    def _obs(self, s: FactoryState):
        phys = s.physics
        _, gp, gq, v, w = self._eef(phys)
        objs = phys.objects
        parts = [gp, gq, v, w]
        if self.obs_mode == "pick":
            parts += list(self._nut_grasp_frame(phys))
        elif self.obs_mode == "place":
            parts += [objs.pos[:, 0], objs.quat[:, 0], s.bolt_pos, objs.quat[:, 1]]
        else:  # 32 = 13 + the nut's com state (13) + the fingertip forces (6)
            parts += [objs.pos[:, 0], objs.quat[:, 0], objs.linvel[:, 0], objs.angvel[:, 0],
                      s.finger_force]
        return torch.cat(parts, -1)[:, :self.num_obs]

    # --- step ------------------------------------------------------------------------

    def step(self, state: FactoryState, actions, draws: FactoryDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg, dev = self.cfg, self.device
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        phys = state.physics
        dpose = torch.cat([actions[:, :3] * cfg.pos_action_scale,
                           actions[:, 3:6] * cfg.rot_action_scale], -1)
        tau = self.osc_tau(phys, dpose)
        if cfg.task == "pick":  # closes on a clock, past 3/4 of the episode
            grip_open = state.progress < cfg.episode_length * 3 // 4
        else:
            grip_open = actions[:, 6] >= 0.0
        targets = phys.robot.targets.clone()
        targets[:, 7:] = torch.where(grip_open[:, None], self.q_hi[None, 7:], self.q_lo[None, 7:])
        phys = phys._replace(robot=phys.robot._replace(targets=targets, tau_ext=tau))
        phys, info = engine_step(self.scene, phys)
        phys = phys._replace(robot=phys.robot._replace(tau_ext=None))
        finger_force = info.body_contact_force[:, self.finger_bodies].reshape(B, 6)

        # screw: the nut's yaw drives its travel down the thread
        theta, prev_yaw = state.theta, state.prev_yaw
        if cfg.task == "screw":
            q = phys.objects.quat[:, 0]
            yaw = 2.0 * torch.atan2(q[:, 3], q[:, 0])
            dyaw = torch.atan2(torch.sin(yaw - prev_yaw), torch.cos(yaw - prev_yaw))
            theta, prev_yaw = theta + dyaw, yaw
            z_top = TABLE_HEIGHT + BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH
            # a right-hand thread: clockwise (negative) rotation descends
            z = torch.clamp(z_top + THREAD_PITCH * theta / (2 * math.pi),
                            TABLE_HEIGHT + BOLT_HEAD_HEIGHT, z_top)
            opos = phys.objects.pos.clone()
            opos[:, 0, 2] = z
            phys = phys._replace(objects=phys.objects._replace(pos=opos))

        progress = state.progress + 1
        _, gp, gq, _, _ = self._eef(phys)
        nut_pos, oquat = phys.objects.pos[:, 0], phys.objects.quat
        bolt_tip = state.bolt_pos + pos_z(BOLT_SHANK_LENGTH / 2 + NUT_HEIGHT, dev)
        # the keypoint reward (factory_task_nut_bolt_*.py _update_rew_buf)
        if cfg.task in ("pick", "gears", "insertion"):
            kp_a = self._keypoints(gp, gq)
            kp_b = self._keypoints(*self._nut_grasp_frame(phys))
        elif cfg.task == "place":
            kp_a = self._keypoints(nut_pos, oquat[:, 0])
            kp_b = self._keypoints(bolt_tip, oquat[:, 1])
        else:
            bottom = state.bolt_pos.clone()
            bottom[:, 2] = TABLE_HEIGHT + BOLT_HEAD_HEIGHT
            kp_a = self._keypoints(nut_pos, oquat[:, 0])
            kp_b = self._keypoints(bottom, oquat[:, 1])
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
        kp_dist = norm(kp_a - kp_b).mean(-1)
        reward = (-kp_dist * cfg.keypoint_reward_scale
                  - norm(actions) * cfg.action_penalty_scale)

        lifted = state.lifted
        if cfg.task in ("gears", "insertion"):
            # the reference's FactoryTaskGears / FactoryTaskInsertion are
            # reward scaffolds: zero task reward, timeout-only episodes
            reward = torch.zeros_like(reward)
            success = torch.zeros(B, dtype=torch.bool, device=dev)
        elif cfg.task == "pick":
            lifted = lifted | (nut_pos[:, 2] > TABLE_HEIGHT + 3.0 * BOLT_HEAD_HEIGHT)
            success = lifted
        elif cfg.task == "place":
            success = norm(nut_pos - bolt_tip) < 0.02
        else:
            success = nut_pos[:, 2] < TABLE_HEIGHT + BOLT_HEAD_HEIGHT + 0.005
        reward = reward + success * cfg.success_bonus
        finite = torch.isfinite(phys.robot.q).all(-1) & torch.isfinite(nut_pos).all(-1)
        reward = torch.where(torch.isfinite(reward) & finite, reward, torch.zeros_like(reward))
        done = (progress >= cfg.episode_length) | ~finite

        mid = FactoryState(physics=phys, progress=progress, actions=actions, lifted=lifted,
                           theta=theta, prev_yaw=prev_yaw, finger_force=finger_force,
                           bolt_pos=state.bolt_pos)
        new_state = where_done(done, self._fresh(B, draws), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done,
            info={"success_frac": success.float().mean(), "kp_dist": kp_dist.mean()},
            teacher_obs=obs.new_zeros(B, 0))


def pos_z(z: float, device) -> torch.Tensor:
    """[1, 3]: (0, 0, z)."""
    return torch.tensor([[0.0, 0.0, z]], dtype=torch.float32, device=device)


def factory_config(num_envs: int = 128, episode_length: int = 100, task: str = "pick",
                   **kw) -> FactoryConfig:
    return FactoryConfig(task=task, num_envs=num_envs, episode_length=episode_length, **kw)


def make_factory(task: str = "pick", num_envs: int = 128, episode_length: int = 100,
                 device=None, **kw) -> FactoryNutBoltEnv:
    return FactoryNutBoltEnv(factory_config(num_envs, episode_length, task, **kw), device)
