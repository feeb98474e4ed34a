"""Locomotion task family (counterpart of handarm_tpu/envs/locomotion.py;
reference IsaacGymEnvs tasks/ant.py and humanoid.py, cfg/task/{Ant,
Humanoid}.yaml): floating-base MJCF robots walking to a far target over a
ground plane.

The whole step is batched over [B, ...] envs: effort actuation through
`RobotState.tau_ext` (each joint's action times its motor gear), one
contact-coupled engine step (`physics.engine.step`: dynamics with the
SPD-inverse kernel at n = 6 + joints, the sweep kernel at K = 0 against the
ground), observation assembly, reward and the fused auto-reset. The
reference's force-torque sensors at the feet become slices of the engine's
`StepInfo.body_contact_force` (net contact force per foot body, zero
torque).

Observation layout (ant.py:401-407, the humanoid's obs_buf):
  [z, vel_loc(3), angvel_loc(3)*avs, yaw, roll, angle_to_target,
   up_proj, heading_proj, dof_pos_scaled(n), dof_vel*dvs(n),
   (dof_force*cfs(n): humanoid only), feet force-torque*cfs(6*F),
   actions(n)]

The env holds its state on one device and draws from its own
torch.Generator, seeded by `reset(seed)`; `reset` and `step` take
`LocoDraws` in place of those draws (a test hands over the JAX package's).
The MJCFs default to the in-repo stand-ins `assets/classic_standin/
nv_ant.xml` and `nv_humanoid.xml` (the JAX package's defaults are the
reference asset tree's `mjcf/` files, which this repository does not
carry); the Ant takes `mjcf=`, and `make_humanoid` passes its own, as the
JAX factory does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.classic import STANDIN_ROOT
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, where_done
from handarm_tpu_torch.math.quat import cross, quat_rotate, quat_rotate_inv, quat_to_matrix
from handarm_tpu_torch.physics.contacts import RobotSpheres, StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.model import compile_mjcf
from handarm_tpu_torch.physics.shapes import stack_objects

ANT_MJCF = os.path.join(STANDIN_ROOT, "nv_ant.xml")
HUMANOID_MJCF = os.path.join(STANDIN_ROOT, "nv_humanoid.xml")


@dataclass(frozen=True)
class LocomotionConfig:
    mjcf: str = ANT_MJCF
    num_envs: int = 512
    episode_length: int = 1000
    dt: float = 1.0 / 60.0
    substeps: int = 2
    power_scale: float = 1.0
    start_height: float = 0.44
    termination_height: float = 0.31
    heading_weight: float = 0.5
    up_weight: float = 0.1
    actions_cost: float = 0.005
    energy_cost: float = 0.05
    joints_at_limit_cost: float = 0.1
    death_cost: float = -2.0
    dof_vel_scale: float = 0.2
    contact_force_scale: float = 0.1
    angular_velocity_scale: float = 1.0
    alive_reward: float = 0.5
    reset_noise_q: float = 0.2
    reset_noise_qd: float = 0.1
    # force-sensor bodies (the reference's feet), by exact name: a substring
    # would catch the virtual links the MJCF parser inserts for multi-joint
    # bodies
    sensor_bodies: tuple = (
        "front_left_foot", "front_right_foot",
        "left_back_foot", "right_back_foot",
    )
    include_dof_force: bool = False  # the humanoid observes the joint torques
    graded_limit_cost: bool = False  # the humanoid grades the at-limit cost
    target: tuple = (1000.0, 0.0, 0.0)
    ground_friction: float = 1.0


class LocoState(NamedTuple):
    """The JAX package's LocoState without its PRNG key (a checkpoint writes
    the key leaf as the JAX file has it). The physics keeps the last step's
    `tau_ext` (the humanoid observes it)."""

    physics: PhysicsState
    progress: torch.Tensor  # [B] int64
    potentials: torch.Tensor  # [B]
    actions: torch.Tensor  # [B, n] last applied actions (observed)
    feet_force: torch.Tensor  # [B, F, 3] last net contact force per foot


class LocoDraws(NamedTuple):
    """The draws of fresh episodes: `dq` [B, n] uniform in +-reset_noise_q
    (the joints' offsets), `qd` [B, nv] uniform in +-reset_noise_qd."""

    dq: torch.Tensor
    qd: torch.Tensor


def euler_xyz(q):
    """wxyz quaternion -> (roll, pitch, yaw), extrinsic x-y-z (the
    reference's get_euler_xyz)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def _norm_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


class LocomotionEnv:
    """Engine-backed floating-base locomotion env (the PPO contract: reset,
    step, num_obs, num_actions, cfg.num_envs)."""

    state_type = LocoState

    def __init__(self, cfg: LocomotionConfig = LocomotionConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        art, extras = compile_mjcf(cfg.mjcf)
        assert art.floating, f"{cfg.mjcf} has no freejoint"
        self.art = art
        nj = art.nv - 6  # actuated joint dofs
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

        # collision spheres from the MJCF geoms; a welded link (the
        # humanoid's head, its hands) resolves through its link frame on
        # the moving body that carries it
        bodies, offs, rads, mus = [], [], [], []
        for bname, sph in extras.link_spheres.items():
            site = art.sites[bname]
            Rl = quat_to_matrix(torch.as_tensor(site.quat, dtype=torch.float32)).numpy()
            mu = float(extras.geom_friction.get(bname, 1.0))
            for pos, r in sph:
                bodies.append(site.body)
                offs.append(Rl @ np.asarray(pos) + site.pos)
                rads.append(r)
                mus.append(mu)
        spheres = RobotSpheres(body=np.asarray(bodies, np.int32), offset=f32(offs),
                               radius=f32(rads), friction=np.asarray(mus, np.float32))
        # the ground plane only: the table column parked far away
        geom = StaticGeom(table_lo=f32([1e6, 1e6]), table_hi=f32([1e6 + 1.0, 1e6 + 1.0]),
                          table_height=0.0)
        self.scene = build_scene(art, stack_objects([], device=dev), spheres, geom,
                                 kp=np.zeros(art.nv), kd=np.zeros(art.nv),
                                 base_pos=(0.0, 0.0, cfg.start_height),
                                 params=SimParams(dt=cfg.dt, substeps=cfg.substeps), device=dev)
        # effort map: the motor gear of each actuated joint (ant.py:160-161, 283)
        gears = np.zeros(art.nv, np.float32)
        for i, jn in enumerate(art.joint_names):
            if jn in extras.motor_gears:
                gears[i] = extras.motor_gears[jn]
        self.gears = f32(gears)
        self.motor_effort_ratio = f32(gears[6:] / max(gears[6:].max(), 1e-9))

        self.feet_bodies = np.asarray([art.body_names.index(n) for n in cfg.sensor_bodies],
                                      np.int32)
        self._feet = torch.as_tensor(self.feet_bodies.astype(np.int64), device=dev)
        F = len(self.feet_bodies)
        self.num_actions = nj
        self.num_obs = 12 + nj + nj + (nj if cfg.include_dof_force else 0) + 6 * F + nj
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        # the initial joint pose: zeros clamped into the limits (the ant's
        # ankles start at their 30 degree bound, as the reference's
        # initial_dof_pos)
        self.q_init = f32(np.concatenate([np.zeros(6),
                                          np.clip(0.0, art.q_min[6:], art.q_max[6:])]))
        self.target = f32(cfg.target)
        self._jlo = f32(art.q_min[6:])
        self._jhi = f32(art.q_max[6:])
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- state construction ---------------------------------------------

    def draw(self, B: int) -> LocoDraws:
        cfg = self.cfg
        u = lambda *s: torch.rand(s, generator=self.gen, device=self.device)
        return LocoDraws(dq=u(B, self.num_actions) * (2 * cfg.reset_noise_q) - cfg.reset_noise_q,
                         qd=u(B, self.art.nv) * (2 * cfg.reset_noise_qd) - cfg.reset_noise_qd)

    def _fresh(self, B: int, draws: LocoDraws | None = None) -> LocoState:
        cfg = self.cfg
        d = draws if draws is not None else self.draw(B)
        q = torch.minimum(torch.maximum(self.q_init[None, 6:] + d.dq, self._jlo), self._jhi)
        phys = initial_state(self.scene, B)
        q_full = torch.cat([q.new_zeros(B, 6), q], -1)
        phys = phys._replace(robot=phys.robot._replace(
            q=q_full, qd=d.qd, targets=q_full, tau_ext=q.new_zeros(B, self.art.nv)))
        to_t = self.target[None, :2] - phys.robot.base_pos[:, :2]
        return LocoState(
            physics=phys,
            progress=torch.zeros(B, dtype=torch.int64, device=self.device),
            potentials=-torch.linalg.norm(to_t, dim=-1) / cfg.dt,
            actions=q.new_zeros(B, self.num_actions),
            feet_force=q.new_zeros(B, len(self.feet_bodies), 3),
        )

    def reset(self, seed: int = 0, draws: LocoDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        state = self._fresh(self.cfg.num_envs, draws)
        return state, self._obs(state)

    # --- observation ------------------------------------------------------

    def _obs(self, s: LocoState):
        cfg = self.cfg
        rob = s.physics.robot
        p, quat = rob.base_pos, rob.base_quat
        w = rob.qd[:, 3:6]
        v = rob.qd[:, 0:3] + cross(w, p)  # origin-Plücker -> the torso point's velocity

        to_target = self.target[None] - p
        to_target = torch.cat([to_target[:, :2], torch.zeros_like(to_target[:, 2:])], -1)
        tdir = to_target / (torch.linalg.norm(to_target, dim=-1, keepdim=True) + 1e-8)
        # the body axes in the world frame
        ex = torch.zeros_like(p)
        ex[:, 0] = 1.0
        ez = torch.zeros_like(p)
        ez[:, 2] = 1.0
        heading_vec = quat_rotate(quat, ex)
        up_proj = quat_rotate(quat, ez)[:, 2]
        heading_proj = torch.sum(heading_vec * tdir, dim=-1)

        vel_loc = quat_rotate_inv(quat, v)
        angvel_loc = quat_rotate_inv(quat, w) * cfg.angular_velocity_scale
        roll, _, yaw = euler_xyz(quat)
        walk_angle = torch.atan2(to_target[:, 1], to_target[:, 0])
        angle_to_target = _norm_angle(walk_angle - yaw)

        qj, qdj = rob.q[:, 6:], rob.qd[:, 6:]
        dof_pos_scaled = (2.0 * qj - self._jhi - self._jlo) / (self._jhi - self._jlo)
        parts = [p[:, 2:3], vel_loc, angvel_loc, _norm_angle(yaw)[:, None],
                 _norm_angle(roll)[:, None], angle_to_target[:, None], up_proj[:, None],
                 heading_proj[:, None], dof_pos_scaled, qdj * cfg.dof_vel_scale]
        if cfg.include_dof_force:
            parts.append(rob.tau_ext[:, 6:] * cfg.contact_force_scale)
        ft = torch.cat([s.feet_force, torch.zeros_like(s.feet_force)], -1)  # force, zero torque
        parts.append(ft.reshape(ft.shape[0], -1) * cfg.contact_force_scale)
        parts.append(s.actions)
        return torch.cat(parts, -1)

    # --- step ---------------------------------------------------------------

    def step(self, state: LocoState, actions, draws: LocoDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg = self.cfg
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        tau = torch.cat([actions.new_zeros(B, 6),
                         actions * self.gears[None, 6:] * cfg.power_scale], -1)
        phys = state.physics._replace(robot=state.physics.robot._replace(tau_ext=tau))
        phys, info = engine_step(self.scene, phys)
        feet_force = info.body_contact_force[:, self._feet]

        progress = state.progress + 1
        p = phys.robot.base_pos
        to_t = self.target[None] - p
        to_t = torch.cat([to_t[:, :2], torch.zeros_like(to_t[:, 2:])], -1)
        potentials = -torch.linalg.norm(to_t, dim=-1) / cfg.dt
        progress_reward = potentials - state.potentials

        mid = LocoState(physics=phys, progress=progress, potentials=potentials,
                        actions=actions, feet_force=feet_force)
        obs = self._obs(mid)
        reward, terminated = self._reward(obs, actions, progress_reward)
        # a non-finite env (a rare contact or gyroscopic blow-up under extreme
        # flailing) terminates and restarts instead of poisoning the batch
        rob = phys.robot
        finite = (torch.isfinite(rob.q).all(-1) & torch.isfinite(rob.qd).all(-1)
                  & torch.isfinite(rob.base_pos).all(-1) & torch.isfinite(rob.base_quat).all(-1))
        done = terminated | (progress >= cfg.episode_length) | ~finite
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))

        new_state = where_done(done, self._fresh(B, draws), mid)
        obs = torch.where(done[:, None], self._obs(new_state), obs)
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done,
            info={"progress_reward": progress_reward.mean()},
            teacher_obs=obs.new_zeros(B, 0))

    def _reward(self, obs, actions, progress_reward):
        """compute_ant_reward / compute_humanoid_reward (ant.py:326-372,
        humanoid.py:330-375): (reward, fallen)."""
        cfg = self.cfg
        nj = self.num_actions
        up_proj = obs[:, 10]
        heading_proj = obs[:, 11]
        dof_pos_scaled = obs[:, 12:12 + nj]
        dof_vel = obs[:, 12 + nj:12 + 2 * nj] / max(cfg.dof_vel_scale, 1e-9)

        heading_reward = torch.where(heading_proj > 0.8,
                                     torch.full_like(heading_proj, cfg.heading_weight),
                                     cfg.heading_weight * heading_proj / 0.8)
        up_reward = torch.where(up_proj > 0.93, torch.full_like(up_proj, cfg.up_weight),
                                torch.zeros_like(up_proj))
        actions_cost = torch.sum(actions ** 2, dim=-1)
        if cfg.graded_limit_cost:
            over = (torch.abs(dof_pos_scaled) > 0.98).to(obs.dtype)
            graded = (torch.abs(dof_pos_scaled) - 0.98) / 0.02
            dof_at_limit = torch.sum(over * cfg.joints_at_limit_cost * graded
                                     * self.motor_effort_ratio[None], dim=-1)
            electricity = torch.sum(torch.abs(actions * dof_vel * cfg.dof_vel_scale)
                                    * self.motor_effort_ratio[None], dim=-1)
        else:
            dof_at_limit = cfg.joints_at_limit_cost * torch.sum(dof_pos_scaled > 0.99, dim=-1)
            electricity = torch.sum(torch.abs(actions * dof_vel * cfg.dof_vel_scale), dim=-1)

        total = (progress_reward + cfg.alive_reward + up_reward + heading_reward
                 - cfg.actions_cost * actions_cost - cfg.energy_cost * electricity
                 - dof_at_limit)
        fallen = obs[:, 0] < cfg.termination_height
        total = torch.where(fallen, torch.full_like(total, cfg.death_cost), total)
        return total, fallen


def ant_config(num_envs: int = 512, episode_length: int = 1000, **kw) -> LocomotionConfig:
    """Reference Ant (cfg/task/Ant.yaml)."""
    return LocomotionConfig(num_envs=num_envs, episode_length=episode_length,
                            **{"mjcf": ANT_MJCF, **kw})


def humanoid_config(num_envs: int = 512, episode_length: int = 1000,
                    **kw) -> LocomotionConfig:
    """Reference Humanoid (cfg/task/Humanoid.yaml: power 1.0, termination
    0.8, start 1.34, angular_velocity_scale 0.25, energy 0.05, dof force
    obs, graded limit cost weighted by motor gear ratios). Its MJCF is its
    own: `mjcf=` is refused (TypeError), as by the JAX package's factory;
    `dataclasses.replace` sets another."""
    return LocomotionConfig(
        mjcf=HUMANOID_MJCF, num_envs=num_envs, episode_length=episode_length,
        start_height=1.34, termination_height=0.8, up_weight=0.1, heading_weight=0.5,
        actions_cost=0.01, energy_cost=0.05, joints_at_limit_cost=0.25, death_cost=-1.0,
        dof_vel_scale=0.1, angular_velocity_scale=0.25, contact_force_scale=0.01,
        alive_reward=2.0, include_dof_force=True, graded_limit_cost=True,
        reset_noise_qd=0.1, sensor_bodies=("right_foot", "left_foot"), **kw)


def make_ant(num_envs: int = 512, episode_length: int = 1000, device=None,
             **kw) -> LocomotionEnv:
    return LocomotionEnv(ant_config(num_envs, episode_length, **kw), device)


def make_humanoid(num_envs: int = 512, episode_length: int = 1000, device=None,
                  **kw) -> LocomotionEnv:
    return LocomotionEnv(humanoid_config(num_envs, episode_length, **kw), device)
