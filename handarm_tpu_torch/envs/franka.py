"""FrankaCubeStack (counterpart of handarm_tpu/envs/franka.py; reference
IsaacGymEnvs tasks/franka_cube_stack.py, cfg/task/FrankaCubeStack.yaml).

A fixed-base Franka Panda with its gripper stacks cubeA (5 cm) on cubeB
(7 cm), two analytic boxes on a table (rolling friction 0.002, no robot
gravity). The arm is torque-driven by operational-space control: the 6D
dpose action becomes task-space impedance torques (`physics/osc.py`) on
the 7 arm dofs through `RobotState.tau_ext`, clipped to the effort limits;
the gripper action is a binary open / close position target of the finger
PD. Observations (19): cubeA's pose, cubeA -> cubeB, the grip site's pose,
the finger q. The staged reward: reach -> lift -> align -> stack; an
episode ends when cubeA stands on cubeB with the gripper away.

One env step evaluates the dynamics twice at the same q, gains, h and zero
gravity: once for OSC (`compute_dyn` here), once in the engine's own sim
step, so it launches the SPD-inverse kernel (n = 9) twice, as the JAX
package computes it twice.

The env holds its state on one device and draws from its own
torch.Generator, seeded by `reset(seed)`; `reset` and `step` take
`FrankaDraws` in place of those draws (a test hands over the JAX
package's). The URDF is the in-repo stand-in
`assets/classic_standin/franka_description/robots/franka_panda_gripper.urdf`
(`FRANKA_URDF`; the JAX package's module constant names the reference
asset tree's file, which this repository does not carry), its collision
spheres fitted by `robots.spherefit`, three a link.
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
from handarm_tpu_torch.math.quat import cross
from handarm_tpu_torch.physics.contacts import StaticGeom
from handarm_tpu_torch.physics.dynamics import compute_dyn
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.kinematics import body_velocities, forward_kinematics, site_poses
from handarm_tpu_torch.physics.model import compile_urdf
from handarm_tpu_torch.physics.osc import eef_jacobian, osc_torques
from handarm_tpu_torch.physics.shapes import make_box_object, stack_objects
from handarm_tpu_torch.physics.solver import SolverParams
from handarm_tpu_torch.robots.spherefit import make_generic_spheres

FRANKA_URDF = os.path.join(STANDIN_ROOT, "franka_description", "robots",
                           "franka_panda_gripper.urdf")
DEFAULT_DOF = np.array([0, 0.1963, 0, -2.6180, 0, 2.9416, 0.7854, 0.035, 0.035], np.float32)
CUBE_A, CUBE_B = 0.050, 0.070


@dataclass(frozen=True)
class FrankaCubeStackConfig:
    num_envs: int = 256
    episode_length: int = 300
    dt: float = 1.0 / 60.0
    substeps: int = 2
    action_scale: float = 1.0
    start_position_noise: float = 0.25
    # reward scales (FrankaCubeStack.yaml)
    r_dist_scale: float = 0.1
    r_lift_scale: float = 1.5
    r_align_scale: float = 2.0
    r_stack_scale: float = 16.0
    osc_kp: float = 150.0
    table_height: float = 1.025  # table top (1.0 + 0.05 / 2)


class FrankaState(NamedTuple):
    """The JAX package's FrankaState without its PRNG key."""

    physics: PhysicsState
    progress: torch.Tensor  # [B] int64
    actions: torch.Tensor  # [B, 7]


class FrankaDraws(NamedTuple):
    """The draws of fresh episodes: `cube_a` and `cube_b` [B, 2], uniform in
    [-1, 1), the cubes' xy noise before scaling."""

    cube_a: torch.Tensor
    cube_b: torch.Tensor


class FrankaSites(NamedTuple):
    """The grip site and the fingertips, (bodies [3], pos [3, 3], quat [3, 4])
    in that order, and the hand's body."""

    body: np.ndarray
    pos: torch.Tensor
    quat: torch.Tensor
    hand_body: int


def franka_robot(device):
    """(Articulation, RobotSpheres, FrankaSites) of the stand-in Franka."""
    art = compile_urdf(FRANKA_URDF)
    spheres = make_generic_spheres(FRANKA_URDF, art, spheres_per_link=3, device=device)
    names = ("panda_grip_site", "panda_leftfinger_tip", "panda_rightfinger_tip")
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    sites = FrankaSites(body=np.array([art.sites[n].body for n in names]),
                        pos=f32([art.sites[n].pos for n in names]),
                        quat=f32([art.sites[n].quat for n in names]),
                        hand_body=art.sites["panda_hand"].body)
    return art, spheres, sites


def franka_sites(scene, sites: FrankaSites, q):
    """(FK, site quats [B, 3, 4], site positions [B, 3, 3]) of the grip site
    and the fingertips at joint positions q on the scene's base."""
    B = q.shape[0]
    bq, bp = scene.base_quat[None].expand(B, 4), scene.base_pos[None].expand(B, 3)
    fk = forward_kinematics(scene.model, q, bq, bp)
    sq, sp = site_poses(fk, sites.body, sites.pos, sites.quat, base_quat=bq, base_pos=bp)
    return fk, sq, sp


def franka_eef(scene, sites: FrankaSites, phys: PhysicsState):
    """(FK, grip position [B, 3], grip quat [B, 4], its linear and angular
    velocity [B, 3] each, site positions [B, 3, 3]) of the Franka's grip
    site (and its fingertips)."""
    fk, sq, sp = franka_sites(scene, sites, phys.robot.q)
    bv = body_velocities(scene.model, fk, phys.robot.qd)
    w = bv[:, sites.hand_body, :3]
    v = bv[:, sites.hand_body, 3:] + cross(w, sp[:, 0])
    return fk, sp[:, 0], sq[:, 0], v, w, sp


def franka_osc_tau(scene, sites: FrankaSites, phys: PhysicsState, dpose: torch.Tensor, *,
                   kp: float, h: float, default_q: torch.Tensor, arm_mask: torch.Tensor,
                   effort: torch.Tensor) -> torch.Tensor:
    """The arm's OSC torques [B, nv] for the twist error `dpose` [B, 6] at
    gain `kp` (the mass matrix at substep `h`), on the dofs of `arm_mask`
    and clipped to `effort`."""
    rob = phys.robot
    fk, gp, _, v, w, _ = franka_eef(scene, sites, phys)
    dyn = compute_dyn(scene.model, fk, rob.qd, torch.zeros(3, device=rob.q.device), scene.kp,
                      scene.kd, h)
    J = eef_jacobian(scene.model, fk, sites.hand_body, gp) * arm_mask[None, None]
    tau = osc_torques(dyn.Minv, J, dpose, torch.cat([v, w], -1), rob.q, rob.qd, default_q,
                      kp=kp, arm_mask=arm_mask)
    return torch.minimum(torch.maximum(tau * arm_mask[None], -effort[None]), effort[None])


class FrankaCubeStackEnv:
    """Engine-backed FrankaCubeStack (the PPO contract: reset, step, num_obs,
    num_actions, cfg.num_envs)."""

    state_type = FrankaState

    def __init__(self, cfg: FrankaCubeStackConfig = FrankaCubeStackConfig(), device=None,
                 group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        self.art, spheres, self.sites = franka_robot(dev)
        nv = self.art.nv  # 9
        shapes = stack_objects([make_box_object([CUBE_A / 2] * 3, mass=0.1),
                                make_box_object([CUBE_B / 2] * 3, mass=0.2)], device=dev)
        geom = StaticGeom(table_lo=f32([-0.6, -0.6]), table_hi=f32([0.6, 0.6]),
                          table_height=cfg.table_height)
        # the arm's dofs are torque-driven (OSC): zero PD; the fingers' PD
        kp, kd = np.zeros(nv), np.zeros(nv)
        kp[7:], kd[7:] = 800.0, 40.0
        self.scene = build_scene(
            self.art, shapes, spheres, geom, kp=kp, kd=kd,
            base_pos=(-0.45, 0.0, 1.125),  # the base on its stand
            params=SimParams(dt=cfg.dt, substeps=cfg.substeps,
                             solver=SolverParams(iterations=8, rolling_friction=0.002),
                             robot_gravity=False),
            device=dev)
        self.q_lo, self.q_hi = f32(self.art.q_min), f32(self.art.q_max)
        self._effort = f32(self.art.effort_limit)
        self.arm_mask = f32([1.0] * 7 + [0.0] * 2)
        self.default_q = f32(DEFAULT_DOF)
        self.cmd_limit = f32([0.1, 0.1, 0.1, 0.5, 0.5, 0.5])  # franka_cube_stack.py:160
        self._offset_a = f32([0.1, 0.15])
        self._offset_b = f32([0.1, -0.15])
        self._stack_offset = f32([0.0, 0.0, (CUBE_A + CUBE_B) / 2])
        self.num_actions = 7  # 6 dpose + 1 gripper
        self.num_obs = 19
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- state construction -------------------------------------------------

    def draw(self, B: int) -> FrankaDraws:
        u = lambda: torch.rand(B, 2, generator=self.gen, device=self.device) * 2.0 - 1.0
        return FrankaDraws(cube_a=u(), cube_b=u())

    def _fresh(self, B: int, draws: FrankaDraws | None = None) -> FrankaState:
        cfg = self.cfg
        d = draws if draws is not None else self.draw(B)
        phys = initial_state(self.scene, B, q0=self.default_q[None])
        z = lambda h: torch.full((B, 1), cfg.table_height + h / 2, device=self.device)
        pos_a = torch.cat([cfg.start_position_noise * d.cube_a + self._offset_a[None],
                           z(CUBE_A)], -1)
        pos_b = torch.cat([cfg.start_position_noise * 0.5 * d.cube_b + self._offset_b[None],
                           z(CUBE_B)], -1)
        phys = phys._replace(objects=phys.objects._replace(pos=torch.stack([pos_a, pos_b], 1)))
        return FrankaState(physics=phys,
                           progress=torch.zeros(B, dtype=torch.int64, device=self.device),
                           actions=torch.zeros(B, self.num_actions, device=self.device))

    def reset(self, seed: int = 0, draws: FrankaDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        state = self._fresh(self.cfg.num_envs, draws)
        return state, self._obs(state)

    # --- the end effector -----------------------------------------------------

    def _eef(self, phys: PhysicsState):
        """(FK, grip position [B, 3], grip quat [B, 4], grip twist [B, 6]
        (linear; angular), left and right fingertip positions [B, 3])."""
        fk, gp, gq, v, w, sp = franka_eef(self.scene, self.sites, phys)
        return fk, gp, gq, torch.cat([v, w], -1), sp[:, 1], sp[:, 2]

    def _obs(self, s: FrankaState):
        phys = s.physics
        _, eef_p, eef_q, _, _, _ = self._eef(phys)
        pA, qA, pB = phys.objects.pos[:, 0], phys.objects.quat[:, 0], phys.objects.pos[:, 1]
        return torch.cat([qA, pA, pB - pA, eef_p, eef_q, phys.robot.q[:, 7:]], -1)

    def osc_tau(self, phys: PhysicsState, dpose: torch.Tensor) -> torch.Tensor:
        """The arm's OSC torques [B, nv] for the twist error `dpose` [B, 6],
        clipped to the effort limits (zero on the fingers)."""
        return franka_osc_tau(self.scene, self.sites, phys, dpose, kp=self.cfg.osc_kp,
                              h=self.cfg.dt / self.cfg.substeps, default_q=self.default_q,
                              arm_mask=self.arm_mask, effort=self._effort)

    # --- step -------------------------------------------------------------------

    def step(self, state: FrankaState, actions, draws: FrankaDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg = self.cfg
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        phys = state.physics
        tau = self.osc_tau(phys, actions[:, :6] * self.cmd_limit[None] / cfg.action_scale)
        # the gripper: binary open / close position targets
        grip_open = actions[:, 6:7] >= 0.0
        targets = phys.robot.targets.clone()
        targets[:, 7:] = torch.where(grip_open, self.q_hi[None, 7:], self.q_lo[None, 7:])
        phys = phys._replace(robot=phys.robot._replace(targets=targets, tau_ext=tau))
        phys, _ = engine_step(self.scene, phys)
        phys = phys._replace(robot=phys.robot._replace(tau_ext=None))

        progress = state.progress + 1
        _, eef_p, _, _, lf, rf = self._eef(phys)
        pA, pB = phys.objects.pos[:, 0], phys.objects.pos[:, 1]
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
        # the staged reward (compute_franka_reward)
        d = norm(pA - eef_p)
        dist_reward = 1.0 - torch.tanh(10.0 * (d + norm(pA - lf) + norm(pA - rf)) / 3.0)
        heightA = pA[:, 2] - cfg.table_height
        lifted = (heightA - CUBE_A) > 0.04
        align_reward = (1.0 - torch.tanh(10.0 * norm(pB - pA + self._stack_offset[None]))) * lifted
        dist_reward = torch.maximum(dist_reward, align_reward)
        # stacked: cubeA over cubeB at its height, the gripper away
        cubeA_on_cubeB = ((norm((pB - pA)[:, :2]) < 0.02)
                          & (torch.abs(heightA - (CUBE_B + CUBE_A / 2)) < 0.02))
        stacked = cubeA_on_cubeB & (d > 0.04)
        reward = torch.where(stacked, cfg.r_stack_scale * stacked.float(),
                             cfg.r_dist_scale * dist_reward + cfg.r_lift_scale * lifted
                             + cfg.r_align_scale * align_reward)
        finite = torch.isfinite(phys.robot.q).all(-1) & torch.isfinite(pA).all(-1)
        done = (progress >= cfg.episode_length) | stacked | ~finite
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        mid = FrankaState(physics=phys, progress=progress, actions=actions)
        new_state = where_done(done, self._fresh(B, draws), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done,
            info={"stacked_frac": stacked.float().mean()}, teacher_obs=obs.new_zeros(B, 0))


def franka_cube_stack_config(num_envs: int = 256, episode_length: int = 300,
                             **kw) -> FrankaCubeStackConfig:
    return FrankaCubeStackConfig(num_envs=num_envs, episode_length=episode_length, **kw)


def make_franka_cube_stack(num_envs: int = 256, episode_length: int = 300, device=None,
                           **kw) -> FrankaCubeStackEnv:
    return FrankaCubeStackEnv(franka_cube_stack_config(num_envs, episode_length, **kw), device)
