"""FrankaCabinet (counterpart of handarm_tpu/envs/franka_cabinet.py;
reference IsaacGymEnvs tasks/franka_cabinet.py, cfg/task/FrankaCabinet.yaml).

The fixed-base Franka Panda (the stand-in of `envs/franka.py`) opens the
top drawer of a cabinet. The drawer is one rigid body, a union of five
boxes (tub, front panel, two handle posts, the handle bar) baked into a
32^3 distance field (`shapes.make_compound_box_object`), re-centred on its
centre of mass and held on a +x prismatic rail (`engine.RailSpec`: limits
[0, 0.4] m, damping 2 /s). The cabinet shell is four static wall AABBs;
the table is parked out of reach and the robot base turned by yaw pi to
face the cabinet. Contact generation samples the drawer's field with the
sdf_gather kernel, once a sim step.

- Actions (9): joint position-target deltas, targets += speed_scales * dt
  * action * action_scale (1.0 on the arm, 0.1 on the fingers; 7.5).
- Observations (23): the joint positions scaled to [-1, 1], the joint
  velocities times 0.1, the vector from the grip site to the handle's
  grasp point, the drawer's opening and its speed.
- The reward (franka_cabinet.py:489-555) term for term; an episode ends
  when the drawer opens past 0.39 m or at its length.

`num_props` (0 by default) adds free boxes resting in the drawer. The env
holds its state on one device and draws from its own torch.Generator,
seeded by `reset(seed)`; `reset` and `step` take `CabinetDraws` in place of
those draws (a test hands over the JAX package's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.franka import franka_robot, franka_sites
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, where_done
from handarm_tpu_torch.math.quat import quat_rotate
from handarm_tpu_torch.physics.contacts import StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    RailSpec,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.shapes import (
    make_box_object,
    make_compound_box_object,
    stack_objects,
)
from handarm_tpu_torch.physics.solver import SolverParams

# franka_cabinet.py:92
DEFAULT_DOF = np.array([1.157, -1.066, -0.155, -2.239, -1.841, 1.003, 0.469, 0.035, 0.035],
                       np.float32)
# the cabinet at (0, 0, 0.4), the drawer_top joint's origin (0.0515, 0, 0.3172)
DRAWER_JOINT_WORLD = np.array([0.0515, 0.0, 0.7172])
DRAWER_TRAVEL = 0.4
# the drawer's boxes (centre, half extents) in the joint-child frame: a tub
# behind a front panel carrying two posts and a graspable bar
DRAWER_PARTS = [
    ((0.00, 0.0, -0.040), (0.250, 0.200, 0.055)),  # tub slab
    ((0.285, 0.0, 0.000), (0.015, 0.210, 0.085)),  # front panel
    ((0.315, 0.060, 0.010), (0.018, 0.010, 0.010)),  # post R
    ((0.315, -0.060, 0.010), (0.018, 0.010, 0.010)),  # post L
    ((0.340, 0.0, 0.010), (0.010, 0.085, 0.012)),  # handle bar
]
HANDLE_GRASP_D = np.array([0.33, 0.0, 0.01])  # the grasp point, drawer frame
DRAWER_MASS = 5.0


@dataclass(frozen=True)
class FrankaCabinetConfig:
    num_envs: int = 256
    episode_length: int = 500
    dt: float = 1.0 / 60.0
    substeps: int = 2
    num_props: int = 0
    action_scale: float = 7.5
    dof_vel_scale: float = 0.1
    start_position_noise: float = 0.25  # the joints' reset noise
    # reward scales (FrankaCabinet.yaml)
    dist_reward_scale: float = 2.0
    rot_reward_scale: float = 0.5
    around_handle_reward_scale: float = 0.25
    open_reward_scale: float = 7.5
    finger_dist_reward_scale: float = 5.0
    action_penalty_scale: float = 0.01
    dist_x_offset: float = 0.04
    open_target: float = 0.39


class CabinetState(NamedTuple):
    """The JAX package's CabinetState without its PRNG key."""

    physics: PhysicsState
    targets: torch.Tensor  # [B, 9] the joints' persistent targets
    progress: torch.Tensor  # [B] int64
    actions: torch.Tensor  # [B, 9]


class CabinetDraws(NamedTuple):
    """The draws of fresh episodes: `q` [B, 9] uniform in [0, 1) (the joints'
    reset noise before centring and scaling)."""

    q: torch.Tensor


def _drawer_record():
    """The compound drawer re-centred on its centre of mass: (record, com
    in the joint-child frame)."""
    vols = np.array([8.0 * np.prod(h) for _, h in DRAWER_PARTS])
    centers = np.array([c for c, _ in DRAWER_PARTS])
    com = (vols[:, None] * centers).sum(0) / vols.sum()
    parts = [(np.asarray(c) - com, h) for c, h in DRAWER_PARTS]
    return make_compound_box_object(parts, mass=DRAWER_MASS), com


def cabinet_walls() -> tuple[np.ndarray, np.ndarray]:
    """The cabinet shell's AABBs (lo [4, 3], hi [4, 3]): the side panels, the
    top panel over the drawer's opening and the front face under it."""
    z_top = DRAWER_JOINT_WORLD[2] + 0.095
    z_bot = DRAWER_JOINT_WORLD[2] - 0.095
    lo = np.array([[-0.35, 0.215, 0.05], [-0.35, -0.265, 0.05],
                   [-0.35, -0.265, z_top + 0.005], [0.30, -0.265, 0.05]], np.float32)
    hi = np.array([[0.33, 0.265, 1.20], [0.33, -0.215, 1.20],
                   [0.33, 0.265, z_top + 0.055], [0.345, 0.265, z_bot - 0.005]], np.float32)
    return lo, hi


class FrankaCabinetEnv:
    """Engine-backed FrankaCabinet (the PPO contract: reset, step, num_obs,
    num_actions, cfg.num_envs)."""

    state_type = CabinetState

    def __init__(self, cfg: FrankaCabinetConfig = FrankaCabinetConfig(), device=None,
                 group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        self.art, spheres, self.sites = franka_robot(dev)
        nv = self.art.nv  # 9
        drawer, self.com_d = _drawer_record()
        objs = [drawer] + [make_box_object([0.04, 0.04, 0.04], mass=0.08)
                           for _ in range(cfg.num_props)]
        K = len(objs)
        # the drawer's rail: +x from the closed pose
        self.drawer_closed_pos = DRAWER_JOINT_WORLD + self.com_d
        axis, origin = np.zeros((K, 3), np.float32), np.zeros((K, 3), np.float32)
        axis[0], origin[0] = [1.0, 0.0, 0.0], self.drawer_closed_pos
        mask = np.zeros(K, np.float32)
        mask[0] = 1.0
        rails = RailSpec(
            axis=axis, origin=origin, quat=np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1)),
            lo=np.zeros(K), hi=np.where(mask > 0, DRAWER_TRAVEL, 0.0).astype(np.float32),
            # cabinet_dof_props damping 10 (franka_cabinet.py:202) on a 5 kg
            # drawer: a decay of 2 /s
            damping=np.full((K,), 2.0), mask=mask)
        wall_lo, wall_hi = cabinet_walls()
        geom = StaticGeom(table_lo=f32([-200.0, -200.0]), table_hi=f32([-199.0, -199.0]),
                          table_height=0.0, wall_lo=wall_lo, wall_hi=wall_hi)
        kp, kd = np.full(nv, 400.0), np.full(nv, 80.0)
        kp[7:], kd[7:] = 7000.0, 50.0  # franka_cabinet.py:186
        self.scene = build_scene(
            self.art, stack_objects(objs, device=dev), spheres, geom, kp=kp, kd=kd,
            # the base at (1, 0, 0) facing the cabinet (yaw pi), franka_cabinet.py:209-211
            base_pos=(1.0, 0.0, 0.0), base_quat=(0.0, 0.0, 0.0, 1.0),
            params=SimParams(dt=cfg.dt, substeps=cfg.substeps,
                             solver=SolverParams(iterations=8), robot_gravity=False),
            rails=rails, device=dev)
        self.q_lo, self.q_hi = f32(self.art.q_min), f32(self.art.q_max)
        self.speed_scales = f32([1.0] * 7 + [0.1, 0.1])  # franka_cabinet.py:194-195
        self.default_q = f32(DEFAULT_DOF)
        self._closed = f32(self.drawer_closed_pos)
        self._grasp_offset = f32(HANDLE_GRASP_D) - f32(self.com_d)
        self._y, self._z = f32([0.0, 1.0, 0.0]), f32([0.0, 0.0, 1.0])
        self.num_actions = 9
        self.num_obs = 23
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- state construction -------------------------------------------------

    def draw(self, B: int) -> CabinetDraws:
        return CabinetDraws(q=torch.rand(B, 9, generator=self.gen, device=self.device))

    def _fresh(self, B: int, draws: CabinetDraws | None = None) -> CabinetState:
        cfg = self.cfg
        d = draws if draws is not None else self.draw(B)
        q0 = self.default_q[None] + cfg.start_position_noise * (d.q - 0.5)
        q0 = torch.minimum(torch.maximum(q0, self.q_lo[None]), self.q_hi[None])
        phys = initial_state(self.scene, B, q0=q0)
        opos = phys.objects.pos.clone()
        opos[:, 0] = self._closed
        if cfg.num_props:  # the props rest in the drawer's tub in a grid
            n = cfg.num_props
            g = torch.arange(n, device=self.device)
            px = self.drawer_closed_pos[0] - 0.15 + 0.09 * (g % 4)
            py = -0.14 + 0.09 * (g // 4)
            pz = torch.full((n,), DRAWER_JOINT_WORLD[2] + 0.065, device=self.device)
            opos[:, 1:] = torch.stack([px, py, pz], -1)[None]
        phys = phys._replace(objects=phys.objects._replace(pos=opos))
        return CabinetState(physics=phys, targets=q0,
                            progress=torch.zeros(B, dtype=torch.int64, device=self.device),
                            actions=torch.zeros(B, self.num_actions, device=self.device))

    def reset(self, seed: int = 0, draws: CabinetDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        state = self._fresh(self.cfg.num_envs, draws)
        return state, self._obs(state)

    # --- observation ------------------------------------------------------------

    def _hand(self, phys: PhysicsState):
        """(grip quat [B, 4], grip position, left and right fingertip
        positions [B, 3])."""
        _, sq, sp = franka_sites(self.scene, self.sites, phys.robot.q)
        return sq[:, 0], sp[:, 0], sp[:, 1], sp[:, 2]

    def drawer_opening(self, phys: PhysicsState) -> torch.Tensor:
        return phys.objects.pos[:, 0, 0] - self._closed[0]

    def _grasp(self, phys: PhysicsState) -> torch.Tensor:
        return phys.objects.pos[:, 0] + self._grasp_offset[None]

    def _obs(self, s: CabinetState):
        phys, cfg = s.physics, self.cfg
        _, grip_p, _, _ = self._hand(phys)
        q, qd = phys.robot.q, phys.robot.qd
        dof_scaled = 2.0 * (q - self.q_lo[None]) / (self.q_hi[None] - self.q_lo[None]) - 1.0
        return torch.cat([dof_scaled, qd * cfg.dof_vel_scale, self._grasp(phys) - grip_p,
                          self.drawer_opening(phys)[:, None],
                          phys.objects.linvel[:, 0, 0:1]], -1)

    # --- step -------------------------------------------------------------------

    def step(self, state: CabinetState, actions, draws: CabinetDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg = self.cfg
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        targets = state.targets + self.speed_scales[None] * cfg.dt * actions * cfg.action_scale
        targets = torch.minimum(torch.maximum(targets, self.q_lo[None]), self.q_hi[None])
        phys = state.physics
        phys = phys._replace(robot=phys.robot._replace(targets=targets))
        phys, _ = engine_step(self.scene, phys)

        progress = state.progress + 1
        grip_q, grip_p, lf, rf = self._hand(phys)
        grasp = self._grasp(phys)
        s_draw = self.drawer_opening(phys)

        # compute_franka_reward (franka_cabinet.py:489-555)
        d = torch.linalg.vector_norm(grip_p - grasp, dim=-1)
        dist_reward = 1.0 / (1.0 + d ** 2)
        dist_reward = dist_reward * dist_reward
        dist_reward = torch.where(d <= 0.02, dist_reward * 2.0, dist_reward)
        fwd = quat_rotate(grip_q, self._z[None].expand(B, 3))
        up = quat_rotate(grip_q, self._y[None].expand(B, 3))
        dot1 = -fwd[:, 0]  # the drawer's inward axis is world -x
        dot2 = up[:, 2]  # its up axis world +z
        rot_reward = 0.5 * (torch.sign(dot1) * dot1 ** 2 + torch.sign(dot2) * dot2 ** 2)
        around = (lf[:, 2] > grasp[:, 2]) & (rf[:, 2] < grasp[:, 2])
        around_handle_reward = 0.5 * around.float()
        lf_d = torch.abs(lf[:, 2] - grasp[:, 2])
        rf_d = torch.abs(rf[:, 2] - grasp[:, 2])
        finger_dist_reward = torch.where(around, (0.04 - lf_d) + (0.04 - rf_d),
                                         torch.zeros_like(lf_d))
        action_penalty = torch.sum(actions ** 2, dim=-1)
        open_reward = s_draw * around_handle_reward + s_draw
        reward = (cfg.dist_reward_scale * dist_reward + cfg.rot_reward_scale * rot_reward
                  + cfg.around_handle_reward_scale * around_handle_reward
                  + cfg.open_reward_scale * open_reward
                  + cfg.finger_dist_reward_scale * finger_dist_reward
                  - cfg.action_penalty_scale * action_penalty)
        reward = torch.where(s_draw > 0.01, reward + 0.5, reward)
        reward = torch.where(s_draw > 0.2, reward + around_handle_reward, reward)
        opened = s_draw > cfg.open_target
        reward = torch.where(opened, reward + 2.0 * around_handle_reward, reward)
        # style: the fingers stay in front of the handle's plane
        bad = ((lf[:, 0] < grasp[:, 0] - cfg.dist_x_offset)
               | (rf[:, 0] < grasp[:, 0] - cfg.dist_x_offset))
        reward = torch.where(bad, torch.full_like(reward, -1.0), reward)

        finite = torch.isfinite(phys.robot.q).all(-1)
        done = opened | (progress >= cfg.episode_length) | ~finite
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        mid = CabinetState(physics=phys, targets=targets, progress=progress, actions=actions)
        new_state = where_done(done, self._fresh(B, draws), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done,
            info={"drawer_pos_mean": s_draw.mean(), "opened_frac": opened.float().mean()},
            teacher_obs=obs.new_zeros(B, 0))


def franka_cabinet_config(num_envs: int = 256, episode_length: int = 500,
                          **kw) -> FrankaCabinetConfig:
    return FrankaCabinetConfig(num_envs=num_envs, episode_length=episode_length, **kw)


def make_franka_cabinet(num_envs: int = 256, episode_length: int = 500, device=None,
                        **kw) -> FrankaCabinetEnv:
    return FrankaCabinetEnv(franka_cabinet_config(num_envs, episode_length, **kw), device)
