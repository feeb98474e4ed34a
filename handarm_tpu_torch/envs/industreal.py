"""IndustRealTaskPegsInsert (counterpart of handarm_tpu/envs/industreal.py;
reference IsaacGymEnvs tasks/industreal/: industreal_env_pegs.py,
industreal_task_pegs_insert.py, industreal_algo_utils.py).

The Franka holds a round 8 mm plug over its hole plate and inserts it. The
plug is welded to the gripper kinematically (its pose follows the grip
site every step, the fingers squeezing it); the socket is pinned by a rail
of zero travel (`engine.RailSpec`, mask [0, 1], lo = hi = 0, no spin: in
the contact solve a free 1 kg body, then projected back). Both parts are
the reference's meshes baked at R = 40 (`envs/objects.py`
`PART_RECORD_KEYS`). The arm's base is placed so that the home pose's grip
site starts on the plug-over-socket pose. 6 actions (a dpose into
task-space impedance, kp 300), 8 solver sweeps. The algorithmic pieces:

- `sdf_reward` (algo_utils.py:239-283): the plug's surface points at its
  pose sampled in its own SDF placed at the goal pose; -log of the mean
  distance outside.
- `sapu_scale` (:158-198): the reward weight 1 - tanh(max interpenetration
  / thresh) between the plug's points and the socket's SDF, zero past the
  threshold.
- SBC (:284-333): the curriculum on the plug's initial engagement depth,
  driven by the batch success EWMA every `curriculum_interval` steps, on
  the device (no host branch in `step`).

Observations: the actor's 24 (the goal seen through per-episode socket
noise), the asymmetric critic's 47 (`_teacher_obs`, `observe`). The SDFs
are sampled by `physics/sdf.py` `sample_sdf`, plain torch, as the JAX
package computes them outside any kernel. The env holds its state on one
device and draws from its own torch.Generator, seeded by `reset(seed)`;
`reset` and `step` take `IRDraws` in place of those draws (a test hands
over the JAX package's). The gears variant's meshes were never baked:
`task="gears"` raises (ROADMAP §1.7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.factory import load_part, pos_z
from handarm_tpu_torch.envs.franka import franka_eef, franka_osc_tau, franka_robot
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult, where_done
from handarm_tpu_torch.math.quat import quat_conj, quat_mul, quat_rotate, quat_rotate_inv
from handarm_tpu_torch.physics.contacts import StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    RailSpec,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.kinematics import forward_kinematics, model_arrays, site_poses
from handarm_tpu_torch.physics.sdf import sample_sdf
from handarm_tpu_torch.physics.shapes import stack_objects
from handarm_tpu_torch.physics.solver import SolverParams

TABLE_HEIGHT = 0.4
# FrankX home pose (IndustRealTaskPegsInsert.yaml:26) + closed gripper
FRANKA_INIT_DOF = np.array(
    [-1.757, 0.840, 2.016, -2.092, -0.738, 1.626, 1.269, 0.009, 0.009], np.float32)
PEG_ASSETS = {"pegs": ("industreal_round_peg_8mm", "industreal_round_hole_8mm")}


@dataclass(frozen=True)
class IndustRealConfig:
    task: str = "pegs"  # pegs (gears: not ported, its meshes were never baked)
    num_envs: int = 128
    episode_length: int = 128
    dt: float = 1.0 / 60.0
    substeps: int = 2
    num_keypoints: int = 4
    sdf_reward_scale: float = 10.0
    interpen_thresh: float = 0.001  # SAPU
    engagement_bonus: float = 10.0
    success_bonus: float = 0.0
    # SBC (IndustRealTaskPegsInsert.yaml:65-68)
    curriculum_success_thresh: float = 0.75
    curriculum_failure_thresh: float = 0.5
    curriculum_height_step: tuple = (-0.005, 0.003)
    curriculum_height_bound: tuple = (-0.01, 0.01)
    curriculum_interval: int = 128  # steps between SBC updates
    pos_action_scale: float = 0.02
    rot_action_scale: float = 0.05
    task_prop_gain: float = 300.0
    socket_xy: tuple = (0.5, 0.0)
    socket_xy_noise: float = 0.002
    # the perceived socket position's noise, drawn per episode
    # (IndustRealTaskPegsInsert.yaml:22 socket_pos_obs_noise): the actor sees
    # the noisy goal, the critic the true one and the residual
    socket_pos_obs_noise: tuple = (0.001, 0.001, 0.0)


class IRState(NamedTuple):
    """The JAX package's IRState without its PRNG key."""

    physics: PhysicsState
    progress: torch.Tensor  # [B] int64
    actions: torch.Tensor  # [B, 6]
    socket_pos: torch.Tensor  # [B, 3] the socket's base position
    weld_p: torch.Tensor  # [B, 3] the plug's offset in the gripper frame
    weld_q: torch.Tensor  # [B, 4]
    inserted: torch.Tensor  # [B] bool: the success latch
    socket_obs_noise: torch.Tensor  # [B, 3] the episode's perception error
    success_ewma: torch.Tensor  # [] the batch success EWMA, which moves SBC's bound
    max_disp: torch.Tensor  # [] SBC's current initial engagement bound
    steps_since_sbc: torch.Tensor  # [] int64


class IRDraws(NamedTuple):
    """The draws of fresh episodes: `socket` [B, 2] and `obs_noise` [B, 3]
    uniform in [-1, 1), `engage` [B] uniform in [0, 1) (the engagement
    depth's fraction of SBC's bound), and `progress` [B] int64 in [0,
    episode_length) (the reset's staggered episode clocks; a step ignores
    them)."""

    socket: torch.Tensor
    engage: torch.Tensor
    obs_noise: torch.Tensor
    progress: torch.Tensor


class IndustRealEnv:
    """Engine-backed IndustReal insertion (the PPO contract, with the
    asymmetric critic's `observe` and `num_teacher_obs`)."""

    state_type = IRState

    def __init__(self, cfg: IndustRealConfig = IndustRealConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks: SBC's
        statistics are this process's envs'."""
        if cfg.task not in PEG_ASSETS:
            raise NotImplementedError(
                f"IndustReal task {cfg.task!r}: its meshes were never baked, so it is not "
                "ported yet (ROADMAP §1.7)")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        self.art, spheres, self.sites = franka_robot(dev)
        nv = self.art.nv
        plug_name, socket_name = PEG_ASSETS[cfg.task]
        plug = load_part(f"industreal/{plug_name}", 0.02)
        socket = load_part(f"industreal/{socket_name}", 1.0)
        # the meshes are z-up in their own frames: vertical extents from the
        # surface samples
        pz, sz = np.asarray(plug["points"])[:, 2], np.asarray(socket["points"])[:, 2]
        self.plug_half_height = float(pz.max())
        self.socket_height = float(sz.max() - sz.min())
        # the socket pinned rigid: a rail with zero travel
        axis, origin = np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32)
        axis[1] = [0.0, 0.0, 1.0]
        origin[1] = [cfg.socket_xy[0], cfg.socket_xy[1], TABLE_HEIGHT + self.socket_height / 2]
        rails = RailSpec(axis=axis, origin=origin,
                         quat=np.tile([1.0, 0, 0, 0], (2, 1)).astype(np.float32),
                         lo=np.zeros(2), hi=np.zeros(2), damping=np.zeros(2),
                         mask=np.array([0.0, 1.0]))
        geom = StaticGeom(table_lo=f32([-0.2, -0.5]), table_hi=f32([0.9, 0.5]),
                          table_height=TABLE_HEIGHT)
        kp, kd = np.zeros(nv), np.zeros(nv)
        kp[7:], kd[7:] = 800.0, 40.0
        # the base placed so that the home pose's grip site starts on the
        # plug-over-socket pose (the reference scripts an IK move there)
        bq, bp = f32([[1.0, 0.0, 0.0, 0.0]]), f32(np.zeros((1, 3)))
        fk0 = forward_kinematics(model_arrays(self.art, torch.float32, dev),
                                 f32(FRANKA_INIT_DOF)[None], bq, bp)
        _, gp0 = site_poses(fk0, self.sites.body[:1], self.sites.pos[:1], self.sites.quat[:1],
                            base_quat=bq, base_pos=bp)
        grip_local = gp0[0, 0].cpu().numpy()  # the grip site in the base frame
        plug_top_z = TABLE_HEIGHT + self.socket_height + 2.0 * self.plug_half_height - 0.01
        base_pos = (cfg.socket_xy[0] - grip_local[0], cfg.socket_xy[1] - grip_local[1],
                    plug_top_z - grip_local[2])
        self.scene = build_scene(
            self.art, stack_objects([plug, socket], device=dev), spheres, geom, kp=kp, kd=kd,
            base_pos=base_pos,
            params=SimParams(dt=cfg.dt, substeps=cfg.substeps,
                             solver=SolverParams(iterations=8), robot_gravity=False),
            rails=rails, device=dev)
        self.q_lo, self.q_hi = f32(self.art.q_min), f32(self.art.q_max)
        self._effort = f32(self.art.effort_limit)
        self.arm_mask = f32([1.0] * 7 + [0.0] * 2)
        self.default_q = f32(FRANKA_INIT_DOF)
        # the plug's goal: centred in the socket, its bottom on the table
        self.plug_goal_pos = f32([cfg.socket_xy[0], cfg.socket_xy[1],
                                  TABLE_HEIGHT + self.plug_half_height])
        self._goal_offset = pos_z(self.socket_height + self.plug_half_height, dev)
        self._ident = f32([1.0, 0.0, 0.0, 0.0])
        self.num_actions = 6
        self.num_obs = 24
        self.num_teacher_obs = 47  # the privileged central-value state
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    # --- helpers -----------------------------------------------------------------

    def _eef(self, phys: PhysicsState):
        """(FK, grip position, grip quat, its linear and angular velocity)."""
        return franka_eef(self.scene, self.sites, phys)[:5]

    def osc_tau(self, phys: PhysicsState, dpose: torch.Tensor) -> torch.Tensor:
        """The arm's task-space impedance torques [B, nv]."""
        return franka_osc_tau(self.scene, self.sites, phys, dpose, kp=self.cfg.task_prop_gain,
                              h=self.cfg.dt / self.cfg.substeps, default_q=self.default_q,
                              arm_mask=self.arm_mask, effort=self._effort)

    def _plug_points_world(self, pos, quat):
        """The plug's surface samples at a pose [B, P, 3], and their mask [P]."""
        sh = self.scene.shapes
        pts = sh.points[0]
        P = pts.shape[0]
        w = pos[:, None] + quat_rotate(quat[:, None].expand(-1, P, 4),
                                       pts[None].expand(pos.shape[0], P, 3))
        return w, sh.point_mask[0] > 0

    def _sdf_at(self, k: int, obj_pos, obj_quat, pts_world):
        """Object k's SDF, placed at a pose, at world points [B, P]."""
        P = pts_world.shape[1]
        p_body = quat_rotate_inv(obj_quat[:, None].expand(-1, P, 4), pts_world - obj_pos[:, None])
        sh = self.scene.shapes
        return sample_sdf(sh.sdf_field[k, ..., 0], sh.sdf_lo[k], sh.sdf_spacing[k], p_body)

    def sdf_reward(self, plug_pos, plug_quat):
        """The IndustReal SDF reward (algo_utils.py:239-283), batched: -log of
        the plug points' mean distance outside the plug placed at its goal."""
        pts, mask = self._plug_points_world(plug_pos, plug_quat)
        B = plug_pos.shape[0]
        d = self._sdf_at(0, self.plug_goal_pos[None].expand(B, 3),
                         self._ident[None].expand(B, 4), pts)
        out = torch.where(mask[None], torch.clamp(d, min=0.0), torch.zeros_like(d))
        mean_out = out.sum(-1) / torch.clamp(mask.sum(), min=1)
        return -torch.log(torch.clamp(mean_out, min=1e-6))

    def sapu_scale(self, plug_pos, plug_quat, socket_pos, socket_quat):
        """SAPU's reward weight (algo_utils.py:158-198) and the plug's deepest
        interpenetration of the socket [B]."""
        pts, mask = self._plug_points_world(plug_pos, plug_quat)
        d = self._sdf_at(1, socket_pos, socket_quat, pts)
        pen = torch.where(mask[None], torch.clamp(-d, min=0.0), torch.zeros_like(d))
        max_pen = pen.amax(-1)
        thresh = self.cfg.interpen_thresh
        scale = 1.0 - torch.tanh(max_pen / thresh)
        return torch.where(max_pen <= thresh, scale, torch.zeros_like(scale)), max_pen

    # --- reset ---------------------------------------------------------------------

    def draw(self, B: int) -> IRDraws:
        g, dev = self.gen, self.device
        u = lambda *s: torch.rand(*s, generator=g, device=dev)
        return IRDraws(socket=u(B, 2) * 2.0 - 1.0, engage=u(B), obs_noise=u(B, 3) * 2.0 - 1.0,
                       progress=torch.randint(0, self.cfg.episode_length, (B,), generator=g,
                                              device=dev))

    def _fresh(self, B: int, draws: IRDraws | None = None, max_disp=None) -> IRState:
        cfg, dev = self.cfg, self.device
        d = draws if draws is not None else self.draw(B)
        if max_disp is None:
            max_disp = torch.tensor(cfg.curriculum_height_bound[1], device=dev)
        sxy = torch.tensor(cfg.socket_xy, dtype=torch.float32, device=dev)[None]
        col = lambda z: torch.full((B, 1), z, dtype=torch.float32, device=dev)
        socket_pos = torch.cat([sxy + cfg.socket_xy_noise * d.socket, col(TABLE_HEIGHT)], -1)
        phys = initial_state(self.scene, B, q0=self.default_q[None])
        # SBC's initial engagement: the plug's bottom at the socket's top less
        # U(0, 1) x the bound (a positive bound may start it engaged)
        plug_z = TABLE_HEIGHT + self.socket_height + self.plug_half_height - d.engage * max_disp
        plug_pos = torch.cat([sxy.expand(B, 2), plug_z[:, None]], -1)
        socket_center = socket_pos + pos_z(self.socket_height / 2, dev)
        phys = phys._replace(objects=phys.objects._replace(
            pos=torch.stack([plug_pos, socket_center], 1)))
        # the weld: the plug's pose in the gripper's frame at reset
        _, gp, gq, _, _ = self._eef(phys)
        noise = torch.tensor(cfg.socket_pos_obs_noise, dtype=torch.float32, device=dev)
        return IRState(
            physics=phys, progress=torch.zeros(B, dtype=torch.int64, device=dev),
            actions=torch.zeros(B, self.num_actions, device=dev), socket_pos=socket_pos,
            weld_p=quat_rotate_inv(gq, plug_pos - gp),
            weld_q=quat_mul(quat_conj(gq), phys.objects.quat[:, 0]),
            inserted=torch.zeros(B, dtype=torch.bool, device=dev),
            socket_obs_noise=noise[None] * d.obs_noise,
            success_ewma=torch.zeros((), device=dev), max_disp=max_disp.clone(),
            steps_since_sbc=torch.zeros((), dtype=torch.int64, device=dev))

    def reset(self, seed: int = 0, draws: IRDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes with staggered clocks,
        the generator seeded with `seed`."""
        self.gen.manual_seed(seed)
        d = draws if draws is not None else self.draw(self.cfg.num_envs)
        s = self._fresh(self.cfg.num_envs, d)
        s = s._replace(progress=d.progress.to(torch.int64))
        return s, self._obs(s)

    # --- observations --------------------------------------------------------------

    def _goal(self, s: IRState):
        return s.socket_pos + self._goal_offset

    def _obs(self, s: IRState):
        """24: the arm's q (7), the grip pose (7), the noisy goal pose (7), the
        plug's offset from the noisy goal (3)."""
        phys = s.physics
        _, gp, gq, _, _ = self._eef(phys)
        noisy_goal = self._goal(s) + s.socket_obs_noise
        return torch.cat([phys.robot.q[:, :7], gp, gq, noisy_goal,
                          self._ident[None].expand(gp.shape[0], 4),
                          noisy_goal - phys.objects.pos[:, 0]], -1)

    def _teacher_obs(self, s: IRState):
        """47: the arm's q and qd, the grip pose and velocities, the true goal
        pose, the plug's offset from it, the plug's pose, the noise residual
        (industreal_task_pegs_insert.py:315-345)."""
        phys = s.physics
        _, gp, gq, v, w = self._eef(phys)
        plug = phys.objects.pos[:, 0]
        goal = self._goal(s)
        return torch.cat([phys.robot.q[:, :7], phys.robot.qd[:, :7], gp, gq, v, w, goal,
                          self._ident[None].expand(gp.shape[0], 4), goal - plug, plug,
                          phys.objects.quat[:, 0], s.socket_obs_noise], -1)

    def observe(self, state: IRState):
        """(obs, teacher_obs, obs_dict) without stepping (the asymmetric
        critic's hook at the learner's init)."""
        obs = self._obs(state)
        return obs, self._teacher_obs(state), {"obs": obs}

    # --- step ------------------------------------------------------------------------

    def sbc_update(self, state: IRState, done, inserted):
        """(success EWMA, max_disp, steps since the last update): SBC's
        device-side update from the envs that ended this step."""
        cfg = self.cfg
        B = done.shape[0]
        ended = done.float()
        n_end = torch.clamp(ended.sum(), min=1.0)
        succ = (inserted.float() * ended).sum() / n_end
        alpha = 0.1 * torch.clamp(ended.sum() / B, 0.0, 1.0)
        ewma = (1 - alpha) * state.success_ewma + alpha * succ
        t_sbc = state.steps_since_sbc + 1
        do_sbc = t_sbc >= cfg.curriculum_interval
        lo, hi = cfg.curriculum_height_bound
        new_disp = torch.where(
            ewma > cfg.curriculum_success_thresh, state.max_disp + cfg.curriculum_height_step[0],
            torch.where(ewma < cfg.curriculum_failure_thresh,
                        state.max_disp + cfg.curriculum_height_step[1], state.max_disp))
        max_disp = torch.where(do_sbc, torch.clamp(new_disp, lo, hi), state.max_disp)
        return ewma, max_disp, torch.where(do_sbc, torch.zeros_like(t_sbc), t_sbc)

    def step(self, state: IRState, actions, draws: IRDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg = self.cfg
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        phys = state.physics
        dpose = torch.cat([actions[:, :3] * cfg.pos_action_scale,
                           actions[:, 3:6] * cfg.rot_action_scale], -1)
        tau = self.osc_tau(phys, dpose)
        targets = phys.robot.targets.clone()
        targets[:, 7:] = 0.0  # the gripper squeezes the plug throughout
        phys = phys._replace(robot=phys.robot._replace(targets=targets, tau_ext=tau))
        phys, _ = engine_step(self.scene, phys)
        phys = phys._replace(robot=phys.robot._replace(tau_ext=None))
        # the kinematic weld: the plug follows the gripper
        _, gp, gq, v, w = self._eef(phys)
        plug_pos = gp + quat_rotate(gq, state.weld_p)
        plug_quat = quat_mul(gq, state.weld_q)
        objs = phys.objects
        pos, quat, lin, ang = (x.clone() for x in objs)
        pos[:, 0], quat[:, 0], lin[:, 0], ang[:, 0] = plug_pos, plug_quat, v, w
        phys = phys._replace(objects=objs._replace(pos=pos, quat=quat, linvel=lin, angvel=ang))
        progress = state.progress + 1

        # the rewards
        sdf_r = self.sdf_reward(plug_pos, plug_quat)
        sapu, max_pen = self.sapu_scale(plug_pos, plug_quat, pos[:, 1], quat[:, 1])
        lo, hi = cfg.curriculum_height_bound
        curr_scale = (hi - state.max_disp) / (hi - lo) + 1.0
        # engagement and insertion (algo_utils.py:364-421): the plug's tip
        # below the socket's top, centred in xy
        goal = self._goal(state)
        xy_err = torch.linalg.vector_norm((plug_pos - goal)[:, :2], dim=-1)
        tip_z = plug_pos[:, 2] - self.plug_half_height
        engaged = (tip_z < state.socket_pos[:, 2] + self.socket_height) & (xy_err < 0.004)
        inserted = state.inserted | (engaged & (tip_z < state.socket_pos[:, 2] + 0.003))
        reward = (sdf_r * cfg.sdf_reward_scale * curr_scale * sapu
                  + engaged * cfg.engagement_bonus + inserted * cfg.success_bonus)
        finite = torch.isfinite(phys.robot.q).all(-1) & torch.isfinite(plug_pos).all(-1)
        reward = torch.where(torch.isfinite(reward) & finite, reward, torch.zeros_like(reward))
        done = (progress >= cfg.episode_length) | ~finite

        ewma, max_disp, t_sbc = self.sbc_update(state, done, inserted)
        mid = IRState(physics=phys, progress=progress, actions=actions,
                      socket_pos=state.socket_pos, weld_p=state.weld_p, weld_q=state.weld_q,
                      inserted=inserted, socket_obs_noise=state.socket_obs_noise,
                      success_ewma=ewma, max_disp=max_disp, steps_since_sbc=t_sbc)
        # the scalars stay out of the merge (no env axis): the fresh episodes
        # start under the updated bound
        new_state = where_done(done, self._fresh(B, draws, max_disp=max_disp), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        teacher = self._teacher_obs(new_state)
        teacher = torch.where(torch.isfinite(teacher), teacher, torch.zeros_like(teacher))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done,
            info={"success_ewma": ewma, "max_disp": max_disp, "sapu_mean": sapu.mean(),
                  "max_interpen": max_pen.mean(), "inserted_frac": inserted.float().mean()},
            teacher_obs=teacher)


def industreal_config(num_envs: int = 128, episode_length: int = 128, task: str = "pegs",
                      **kw) -> IndustRealConfig:
    return IndustRealConfig(task=task, num_envs=num_envs, episode_length=episode_length, **kw)


def make_industreal(task: str = "pegs", num_envs: int = 128, episode_length: int = 128,
                    device=None, **kw) -> IndustRealEnv:
    return IndustRealEnv(industreal_config(num_envs, episode_length, task, **kw), device)
