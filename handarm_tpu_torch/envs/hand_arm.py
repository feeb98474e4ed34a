"""Hand-arm manipulation environment of the UR5+SIH or the Hello-Robot
Stretch (`robot`): the lift, reposition, oriented_reposition, repose and
throw goals (counterpart of handarm_tpu/envs/hand_arm.py).

One `step(state, actions)` does: the action noise of domain randomization
(`dr`), actionables -> control -> PD targets, the random object
disturbance impulses (with `randomize`), `control_freq_inv` sim steps at
the engine cadence the config picks (the heavy mass structure once per
control step with FK carried across its sim steps, the default; with
exact FK and fresh contacts every sim step, `carry_fk=False`; or all of it
every sim step, `heavy_prep_per_control=False`), under the per-env
physical parameters of DR or of ADR (`adr`, which then replaces DR's),
reward, termination, the NaN finite
guard, success-rate EWMAs, the auto-reset merged per env, the ADR
transition on the episodes that ended, and the sanitized observations:
the flat vector (clipped, with DR's observation noise), the teacher's flat
vector (`teacher_observations`, for a distilled student's teacher), and the
synthetic point clouds and each camera's depth, segmentation and color
images and clouds (`cameras`, `envs/camera.py`), which go to `obs_dict`
under their own names, unclipped. Resets draw object poses from the
genesis pool (`use_drop_init`, built by the first `reset`, or read from
HANDARM_POOL_CACHE) or spawn them on the table, the target object
uniformly or (`balanced_target_sampling`) by failure rate, for the
orientation goals a goal quaternion, and with DR a fresh `DRState`. The
robot's collision spheres cover the hand's links (the Stretch's wrist and
gripper), or with `hand_only_collision=False` the arm's as well. The robot
is mounted on the table at its adapter's xy offset and yaw (the Stretch
at (0.2, 0.175), turned by pi).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.math.quat import (
    cross,
    quat_diff_rad,
    quat_from_axis_angle,
    quat_mul,
    quat_rotate,
)
from handarm_tpu_torch.envs import genesis, objects as object_records, pointcloud as pc
from handarm_tpu_torch.envs.camera import render_points, visible_pointcloud
from handarm_tpu_torch.envs.adr import AdrConfig, AdrDraws, AdrState, adr_step, init_adr_state
from handarm_tpu_torch.envs.randomization import (
    DRConfig,
    DRState,
    apply_noise,
    init_dr_state,
    merge_on_reset,
    schedule_strength,
)
from handarm_tpu_torch.envs.spec import Observable, Registry, obs_layout
from handarm_tpu_torch.physics.contacts import StaticGeom
from handarm_tpu_torch.physics.engine import (
    EnvOverrides,
    ObjectState,
    PhysicsState,
    RobotState,
    SimParams,
    build_scene,
    compute_heavy,
    step as physics_step,
)
from handarm_tpu_torch.physics.kinematics import body_velocities, forward_kinematics, site_poses
from handarm_tpu_torch.physics.shapes import (
    BOX,
    SPHERE,
    make_box_object,
    make_sphere_object,
    sphere_points,
    stack_objects,
)
from handarm_tpu_torch.physics.solver import SolverParams
from handarm_tpu_torch.robots import get_robot
from handarm_tpu_torch.robots.ur5sih import SERVO_LOWER, SERVO_UPPER


GOALS = ("lift", "reposition", "oriented_reposition", "throw", "repose")


@dataclass(frozen=True)
class HandArmConfig:
    """A robot (ur5sih or stretch) with hand-only collision spheres; one of
    the goals; primitive objects or a dataset of baked mesh records. Fields
    and defaults as the JAX package's; `settle_num_steps` is the port's
    own. A Stretch config that keeps the default (UR5+SIH) actions takes
    the Stretch's."""

    robot: str = "ur5sih"  # one of robots.ROBOTS
    num_envs: int = 1024
    episode_length: int = 200
    control_freq_inv: int = 3  # 20 Hz policy on a 60 Hz sim
    dt: float = 1.0 / 60.0
    substeps: int = 2
    observations: tuple[str, ...] = (
        "ur5_joint_pos", "ur5_flange_pose", "sih_fingertip_pos",
        "sih_fingertip_quat", "sih_fingertip_linvel", "dof_position_targets",
        "object_pos", "object_bounding_box", "target_object_bounding_box",
        "sih_fingertip_to_target_object_pos", "target_object_to_goal_pos",
    )
    teacher_observations: tuple[str, ...] = ()
    actions: tuple[str, ...] = (
        "ur5_relative_joint_pos", "sih_smoothed_relative_servo_pos",
    )
    goal: str = "lift"  # one of GOALS
    goal_threshold: float = 0.05
    repose_threshold: float = 0.1  # rad
    lifting_threshold: float = 0.05
    lift_goal_height_above_table: float = 0.3
    reward: dict = field(default_factory=lambda: {
        "reaching": 1.0, "lifting": 5.0, "goal": 50.0, "success": 50.0,
    })
    objects: tuple = (("box", (0.03, 0.03, 0.045), 0.15),)  # (kind, half-extents, mass)
    object_dataset: tuple = ()  # e.g. (("ycb", ("015_peach", ...)),); replaces objects
    num_objects: int = 0  # objects per env from the dataset (0 = all)
    table_height: float = 0.5
    rolling_friction: float = 0.003
    use_bin: bool = False
    bin_center: tuple = ()
    bin_half_extent: float = 0.15
    bin_wall_height: float = 0.10
    bin_wall_thickness: float = 0.01
    table_lo: tuple = (-0.5, -0.5)
    table_hi: tuple = (0.9, 1.1)
    workspace_lo: tuple = (-0.07, 0.33, 0.0)
    workspace_hi: tuple = (0.63, 0.83, 0.6)
    drop_pos: tuple = (0.28, 0.58, 1.5)
    drop_noise: tuple = (0.1, 0.1, 0.0)
    goal_pos: tuple = (0.28, 0.58, 0.8)
    goal_noise: tuple = (0.15, 0.15, 0.1)
    spawn_noise: tuple = (0.1, 0.1, 0.0)
    arm_action_scale: float = 1.0
    servo_smoothing_alpha: float = 0.8
    solver_iterations: int = 8
    solver_prep_dtype: str = "bf16"
    # engine cadence: the mass structure once per control step (else every
    # sim step), FK carried across its sim steps (else exact FK and fresh
    # contacts every sim step); collision spheres on the hand only (else
    # the arm's too)
    heavy_prep_per_control: bool = True
    carry_fk: bool = True
    hand_only_collision: bool = True
    # random object disturbance impulses (off unless randomize)
    randomize: bool = False
    disturbance_probability: float = 0.2
    disturbance_magnitude: float = 15.0
    dr: DRConfig = field(default_factory=DRConfig)  # domain randomization
    adr: AdrConfig = field(default_factory=AdrConfig)  # adaptive DR; replaces DR's scales
    clip_observations: float = 100.0
    clip_actions: float = 1.0
    # reset targets drawn by per-object failure rate instead of uniformly
    balanced_target_sampling: bool = False
    pointcloud_average_points: int = 100
    pointcloud_max_points: int = 128  # points of every subsampled cloud
    # genesis drop initialization (envs/genesis.py)
    use_drop_init: bool = False
    num_initial_poses: int = 1
    drop_num_steps: int = 100
    settle_num_steps: int = 600  # most settle steps per drop
    cameras: tuple = ()  # camera sensors (envs.camera.CameraConfig)

    def __post_init__(self):
        if self.goal not in GOALS:
            raise ValueError(f"unknown goal {self.goal!r} (goals: {', '.join(GOALS)})")


class TaskState(NamedTuple):
    progress: torch.Tensor  # [B] int64
    goal_pos: torch.Tensor  # [B, 3]
    goal_quat: torch.Tensor  # [B, 4]
    target_obj: torch.Tensor  # [B] int64
    goal_reached_before: torch.Tensor  # [B] bool
    initial_obj_pos: torch.Tensor  # [B, K, 3]
    total_steps: torch.Tensor  # scalar
    dr: DRState | None = None  # per-env frozen randomizations (with `dr`)
    adr: AdrState | None = None  # ADR's ranges, queues and workers (with `adr`)


class Metrics(NamedTuple):
    success_ewma: torch.Tensor  # scalar
    per_object_ewma: torch.Tensor  # [K]
    total_resets: torch.Tensor
    total_successes: torch.Tensor
    end_success_ewma: torch.Tensor


class EnvState(NamedTuple):
    physics: PhysicsState
    control: Any  # robot control state
    task: TaskState
    metrics: Metrics


class StepDraws(NamedTuple):
    """Draws of one `step` or `reset` that replace the env generator's
    (None: from the generator): the standard draws of the per-step action
    and observation noise ([B, num_actions], [B, num_obs]), of the fresh
    DRState (`randomization.init_dr_state`'s `std`) and of ADR (the
    recycling of `adr_step`, or at reset `init_adr_state`)."""

    act_noise: torch.Tensor | None = None
    obs_noise: torch.Tensor | None = None
    dr: DRState | None = None
    adr: AdrDraws | None = None


class StepResult(NamedTuple):
    obs: torch.Tensor  # [B, num_obs]
    teacher_obs: torch.Tensor  # [B, num_teacher_obs] ([B, 0] without teacher observations)
    reward: torch.Tensor  # [B]
    done: torch.Tensor  # [B] bool
    info: dict
    obs_dict: dict  # the point clouds, by observable name


def tree_map(fn, *trees):
    """Map over nested NamedTuples of tensors (None leaves pass through)."""
    t0 = trees[0]
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if t0 is None:
        return None
    return fn(*trees)


class ObsContext:
    """Lazily computed quantities shared by observation and reward terms;
    `info` is the last sim step's StepInfo (None on a reset). `scores`
    maps a point count P to the [B, P] uniform scores of every cloud
    subsampled from P points in this context; a count it lacks is drawn
    from the env's generator, once."""

    def __init__(self, env: "HandArmEnv", state: EnvState, info=None, scores=None):
        self.env, self.state, self.info = env, state, info
        self._cache: dict[str, Any] = {}
        self._scores = dict(scores or {})

    def uniform(self, num_points: int) -> torch.Tensor:
        """[B, num_points] scores of this context's subsampling: one draw
        per point count, shared by every cloud of that count (as the JAX
        package's clouds share one observation key)."""
        if num_points not in self._scores:
            self._scores[num_points] = torch.rand(
                (self.batch, num_points), generator=self.env.gen, device=self.env.device)
        return self._scores[num_points]

    def subsample(self, cloud: torch.Tensor) -> torch.Tensor:
        out = self.env.cfg.pointcloud_max_points
        return pc.subsample_pad(cloud, self.uniform(pc.padded_points(cloud.shape[1], out)), out)

    def _get(self, name, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    @property
    def batch(self) -> int:
        return self.state.physics.robot.q.shape[0]

    @property
    def fk(self):
        sc = self.env.scene
        return self._get("fk", lambda: forward_kinematics(
            sc.model, self.state.physics.robot.q, sc.base_quat[None], sc.base_pos[None]))

    def camera_scene_points(self):
        """(points [B, P, 3], segmentation ids [B, P], point types [B, P])
        of what the cameras see: the robot's cloud (id 1, REGULAR), then
        each object's samples (id 3 + k; TARGET for the target object's,
        REGULAR for the others; 0 on padding rows)."""
        def compute():
            env, B = self.env, self.batch
            bodies, offsets = env.robot_cloud
            fk = self.fk
            rob = fk.body_pos[:, bodies] + quat_rotate(fk.body_quat[:, bodies], offsets[None])
            shapes, objs = env.scene.shapes, self.state.physics.objects
            K, Pk = shapes.points.shape[:2]
            obj = objs.pos[:, :, None] + quat_rotate(objs.quat[:, :, None], shapes.points[None])
            ids = torch.arange(K, dtype=rob.dtype, device=rob.device)[:, None]
            target = (self.state.task.target_obj[:, None] == torch.arange(
                K, device=rob.device)).to(rob.dtype)[..., None]
            types = (float(pc.REGULAR) + float(pc.TARGET - pc.REGULAR) * target) \
                * shapes.point_mask
            return (torch.cat([rob, obj.reshape(B, K * Pk, 3)], dim=1),
                    torch.cat([rob.new_ones(B, rob.shape[1]),
                               ((3.0 + ids) * shapes.point_mask).reshape(1, -1).expand(B, -1)],
                              dim=1),
                    torch.cat([torch.full_like(rob[..., 0], float(pc.REGULAR)),
                               types.reshape(B, -1)], dim=1))
        return self._get("camera_scene_points", compute)

    def _sites(self, key, sites):
        sc = self.env.scene
        return self._get(key, lambda: site_poses(
            self.fk, *sites, base_quat=sc.base_quat[None], base_pos=sc.base_pos[None]))

    @property
    def fingertips(self):
        return self._sites("tips", self.env.fingertip_sites)

    @property
    def flange(self):
        return self._sites("flange", self.env.flange_site)

    def _target(self, x):
        t = self.state.task.target_obj
        return torch.gather(x, 1, t[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]

    @property
    def target_object_pos(self):
        return self._target(self.state.physics.objects.pos)

    @property
    def target_object_quat(self):
        return self._target(self.state.physics.objects.quat)

    def fingertip_vel(self):
        """(linear [B, 5, 3], angular [B, 5, 3]) velocity of the fingertip
        sites."""
        def compute():
            bv = body_velocities(self.env.scene.model, self.fk,
                                 self.state.physics.robot.qd)
            v = bv[:, self.env.fingertip_body_idx]
            ang = v[..., :3]
            return v[..., 3:] + cross(ang, self.fingertips[1]), ang
        return self._get("tipvel", compute)


def _obb(ctx: ObsContext, pos, quat, idx=None):
    """[pos, quat, full extents] of the oriented bounding box(es)."""
    shapes = ctx.env.scene.shapes
    obb_p = shapes.obb_pos if idx is None else shapes.obb_pos[idx]
    obb_q = shapes.obb_quat if idx is None else shapes.obb_quat[idx]
    ext = 2.0 * (shapes.size if idx is None else shapes.size[idx])
    p = pos + quat_rotate(quat, obb_p.expand_as(pos))
    q = quat_mul(quat, obb_q.expand_as(quat))
    return torch.cat([p, q, ext.expand(p.shape[:-1] + (3,))], dim=-1)


# OBB corner signs, sz fastest: the keypoints' order
_CORNERS = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]


def _keypoints(ctx: ObsContext, pos, quat):
    """[B, 24]: the 8 corners of the target object's OBB posed at
    (pos, quat), in the world frame."""
    shapes, t = ctx.env.scene.shapes, ctx.state.task.target_obj
    corners = pos.new_tensor(_CORNERS)
    half = shapes.size[t]
    pts = shapes.obb_pos[t][:, None, :] + quat_rotate(
        shapes.obb_quat[t][:, None, :], corners[None] * half[:, None, :])
    world = quat_rotate(quat[:, None, :], pts) + pos[:, None, :]
    return world.reshape(ctx.batch, -1)


def _register_observables(reg: Registry, nv: int, K: int) -> None:
    def obs(name, size, fn):
        reg.observables[name] = Observable(name, size, fn)

    phys = lambda c: c.state.physics
    flat = lambda c, x: x.reshape(c.batch, -1)
    obs("ur5_joint_pos", 6, lambda c: phys(c).robot.q[:, :6])
    obs("ur5_joint_vel", 6, lambda c: phys(c).robot.qd[:, :6])
    obs("ur5_joint_state", 12, lambda c: torch.cat(
        [phys(c).robot.q[:, :6], phys(c).robot.qd[:, :6]], -1))
    obs("ur5_flange_pose", 7, lambda c: torch.cat([c.flange[1][:, 0], c.flange[0][:, 0]], -1))
    obs("sih_fingertip_pos", 15, lambda c: flat(c, c.fingertips[1]))
    obs("sih_fingertip_quat", 20, lambda c: flat(c, c.fingertips[0]))
    obs("sih_fingertip_linvel", 15, lambda c: flat(c, c.fingertip_vel()[0]))
    obs("sih_fingertip_angvel", 15, lambda c: flat(c, c.fingertip_vel()[1]))
    obs("dof_position_targets", nv, lambda c: phys(c).robot.targets)
    obs("dof_pos", nv, lambda c: phys(c).robot.q)
    obs("dof_vel", nv, lambda c: phys(c).robot.qd)
    obs("object_pos", 3 * K, lambda c: flat(c, phys(c).objects.pos))
    obs("object_quat", 4 * K, lambda c: flat(c, phys(c).objects.quat))
    obs("object_linvel", 3 * K, lambda c: flat(c, phys(c).objects.linvel))
    obs("object_angvel", 3 * K, lambda c: flat(c, phys(c).objects.angvel))
    obs("object_mass", K, lambda c: c.env.scene.shapes.mass[None].expand(c.batch, K))
    # object body frames are COM-centred: the local COM offset is zero
    obs("object_com", 3 * K, lambda c: phys(c).objects.pos.new_zeros(c.batch, 3 * K))
    obs("object_inertia", 9 * K, lambda c: torch.diag_embed(
        c.env.scene.shapes.inertia_diag).reshape(1, -1).expand(c.batch, 9 * K))
    obs("object_bounding_box", 10 * K, lambda c: flat(c, _obb(
        c, phys(c).objects.pos, phys(c).objects.quat)))
    obs("target_object_bounding_box", 10, lambda c: _obb(
        c, c.target_object_pos, c.target_object_quat, c.state.task.target_obj))
    obs("target_object_pos", 3, lambda c: c.target_object_pos)
    obs("target_object_quat", 4, lambda c: c.target_object_quat)
    obs("goal_pos", 3, lambda c: c.state.task.goal_pos)
    obs("goal_quat", 4, lambda c: c.state.task.goal_quat)
    obs("target_object_keypoints", 24, lambda c: _keypoints(
        c, c.target_object_pos, c.target_object_quat))
    obs("goal_keypoints", 24, lambda c: _keypoints(
        c, c.state.task.goal_pos, c.state.task.goal_quat))
    obs("sih_fingertip_to_target_object_pos", 15, lambda c: flat(
        c, c.target_object_pos[:, None, :] - c.fingertips[1]))
    obs("target_object_to_goal_pos", 3,
        lambda c: c.state.task.goal_pos - c.target_object_pos)


def _register_pointcloud_observables(reg: Registry, K: int, P_out: int) -> None:
    """The synthetic point clouds, each routed to `obs_dict` under its own
    name: every object's samples (REGULAR), the target object's (TARGET),
    the target's cloud and position blanked on 3 of every 4 steps, the
    robot's surface samples, the goal's sphere (GOAL, not subsampled) and
    the objects with the goal. All but the goal's are subsampled to
    `pointcloud_max_points`."""
    def obs(name, size, fn, routed=True):
        reg.observables[name] = Observable(name, size, fn, name if routed else "obs")

    def object_cloud(c):
        shapes, objs = c.env.scene.shapes, c.state.physics.objects
        return pc.merge_clouds(*(pc.transform_cloud(
            shapes.points[k], shapes.point_mask[k], objs.quat[:, k], objs.pos[:, k], pc.REGULAR)
            for k in range(K)))

    def target_cloud(c):
        shapes, t = c.env.scene.shapes, c.state.task.target_obj
        return c.subsample(pc.transform_cloud(shapes.points[t], shapes.point_mask[t],
                                              c.target_object_quat, c.target_object_pos,
                                              pc.TARGET))

    def robot_cloud(c):
        bodies, offsets = c.env.robot_cloud
        fk = c.fk
        pts = fk.body_pos[:, bodies] + quat_rotate(fk.body_quat[:, bodies], offsets[None])
        return c.subsample(torch.cat([pts, torch.full_like(pts[..., :1], float(pc.REGULAR))], -1))

    def goal_cloud(c):
        pts = c.env.goal_cloud_points
        ident = pts.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(c.batch, 4)
        return pc.transform_cloud(pts, torch.ones_like(pts[:, 0]), ident,
                                  c.state.task.goal_pos, pc.GOAL)

    progress = lambda c: c.state.task.progress
    obs("object_synthetic_pointcloud", P_out * 4, lambda c: c.subsample(object_cloud(c)))
    obs("target_object_synthetic_pointcloud", P_out * 4, target_cloud)
    obs("target_object_interval_pos", 3, lambda c: pc.interval_sample(
        c.target_object_pos, progress(c), 4), routed=False)
    obs("target_object_synthetic_interval_pointcloud", P_out * 4,
        lambda c: pc.interval_sample(target_cloud(c), progress(c), 4))
    obs("ur5sih_synthetic_pointcloud", P_out * 4, robot_cloud)
    obs("goal_synthetic_pointcloud", 0, goal_cloud)
    obs("scene_synthetic_pointcloud", P_out * 4, lambda c: c.subsample(
        pc.merge_clouds(object_cloud(c), goal_cloud(c))))


def _register_camera_observables(reg: Registry, cam, P_out: int) -> None:
    """A camera's five observables, each routed to `obs_dict` under its own
    name: `<cam>_depth` [B, H, W], `<cam>_segmentation` [B, H, W] int32,
    `<cam>_color` [B, H, W, 3], `<cam>_pointcloud` (the visible scene
    points with their types) and `<cam>_target_object_pointcloud` (the
    visible points of the target object, TARGET; the others padding), both
    [B, P_out, 4]. Color has a render of its own, so the others do not pay
    for its scatter."""
    def render(c, color: bool = False):
        def compute():
            pts, segs, _ = c.camera_scene_points()
            return render_points(cam, pts, segs.to(torch.int32), valid=segs,
                                 colors=c.env.scene_point_rgb if color else None)
        return c._get(f"render_{'color_' if color else ''}{cam.name}", compute)

    def cloud(c, types):
        pts = c.camera_scene_points()[0]
        return visible_pointcloud(render(c), pts, types,
                                  c.uniform(pc.padded_points(pts.shape[1], P_out)), P_out)

    def target_cloud(c):
        segs = c.camera_scene_points()[1]
        target = 3.0 + c.state.task.target_obj.to(segs.dtype)
        return cloud(c, float(pc.TARGET) * (segs == target[:, None]).to(segs.dtype))

    def obs(name, fn):
        reg.observables[f"{cam.name}_{name}"] = Observable(
            f"{cam.name}_{name}", 0, fn, f"{cam.name}_{name}")

    obs("depth", lambda c: render(c).depth)
    obs("segmentation", lambda c: render(c).segmentation)
    obs("color", lambda c: render(c, color=True).color)
    obs("pointcloud", lambda c: cloud(c, c.camera_scene_points()[2]))
    obs("target_object_pointcloud", target_cloud)


# the cameras' albedo: the robot's gray, and per object slot a palette colour
ROBOT_RGB = 0.35
PALETTE = np.array([[0.86, 0.37, 0.34], [0.35, 0.61, 0.84], [0.48, 0.77, 0.46],
                    [0.91, 0.72, 0.32], [0.66, 0.49, 0.77], [0.55, 0.78, 0.78]])


def _register_actionables(reg: Registry) -> None:
    def act_arm_rel(env, control, a):
        new_target = control.arm_target + env.cfg.dt * env.cfg.arm_action_scale * a
        return control._replace(arm_target=torch.minimum(
            torch.maximum(new_target, env.arm_limits[0]), env.arm_limits[1]))

    def act_servo_smooth(env, control, a):
        alpha = env.cfg.servo_smoothing_alpha
        smoothed = alpha * a + (1 - alpha) * control.sih_smoothed
        ticks = torch.minimum(torch.maximum(
            control.servo_ticks + 100.0 * smoothed, env.servo_lo), env.servo_hi)
        return control._replace(servo_ticks=ticks, sih_smoothed=smoothed)

    def act_servo_abs(env, control, a):
        return control._replace(servo_ticks=env.servo_lo + (a * 0.5 + 0.5) * (
            env.servo_hi - env.servo_lo))

    def act_servo_rel(env, control, a):
        return control._replace(servo_ticks=torch.minimum(torch.maximum(
            control.servo_ticks + 100.0 * a, env.servo_lo), env.servo_hi))

    reg.actionable("ur5_relative_joint_pos", 6)(act_arm_rel)
    reg.actionable("sih_absolute_servo_pos", 5)(act_servo_abs)
    reg.actionable("sih_relative_servo_pos", 5)(act_servo_rel)
    reg.actionable("sih_smoothed_relative_servo_pos", 5)(act_servo_smooth)


class HandArmEnv:
    """Vectorized hand-arm env on one device. Random draws (resets,
    disturbances, DR and ADR) come from the env's own torch.Generator, seeded
    by `reset(seed)`, unless `draws` are given; genesis draws from its own,
    seeded with 23 + num_envs."""

    def __init__(self, cfg: HandArmConfig, device=None, urdf_path: str | None = None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.robot = get_robot(cfg.robot, urdf_path, dev)
        art = self.art = self.robot.art
        objs = []
        self.object_names: list[str] = []
        if cfg.object_dataset:
            names = object_records.resolve_object_set(cfg.object_dataset)
            if cfg.num_objects:
                names = names[:cfg.num_objects]
            for name in names:
                objs.append(object_records.load_object(name))
                self.object_names.append(name)
        for kind, size, mass in cfg.objects if not cfg.object_dataset else ():
            if kind == "box":
                objs.append(make_box_object(list(size), mass))
            elif kind == "sphere":
                objs.append(make_sphere_object(size[0], mass))
            else:
                raise NotImplementedError(kind)
            self.object_names.append(f"{kind}_{len(self.object_names)}")
        shapes = stack_objects(objs, device=dev)
        self._object_rgb = [o.get("point_rgb") for o in objs]
        self._scene_point_rgb = None
        spheres = self.robot.make_spheres(cfg.hand_only_collision, dev)
        walls = []
        if cfg.use_bin:
            cx, cy = cfg.bin_center if cfg.bin_center else cfg.drop_pos[:2]
            e, th = cfg.bin_half_extent, cfg.bin_wall_thickness
            z0, z1 = cfg.table_height, cfg.table_height + cfg.bin_wall_height
            walls = [
                ((cx - e - th, cy - e - th, z0), (cx - e, cy + e + th, z1)),
                ((cx + e, cy - e - th, z0), (cx + e + th, cy + e + th, z1)),
                ((cx - e - th, cy - e - th, z0), (cx + e + th, cy - e, z1)),
                ((cx - e - th, cy + e, z0), (cx + e + th, cy + e + th, z1)),
            ]
        geom = StaticGeom(
            table_lo=torch.tensor(cfg.table_lo, device=dev),
            table_hi=torch.tensor(cfg.table_hi, device=dev),
            table_height=float(cfg.table_height),
            wall_lo=np.asarray([w[0] for w in walls], np.float32).reshape(-1, 3),
            wall_hi=np.asarray([w[1] for w in walls], np.float32).reshape(-1, 3),
        )
        (bx, by), yaw = self.robot.base_xy, self.robot.base_yaw
        self.scene = build_scene(
            art, shapes, spheres, geom, kp=self.robot.kp, kd=self.robot.kd,
            base_pos=(bx, by, cfg.table_height),
            base_quat=(float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))),
            params=SimParams(
                dt=cfg.dt, substeps=cfg.substeps,
                solver=SolverParams(iterations=cfg.solver_iterations,
                                    rolling_friction=cfg.rolling_friction,
                                    prep_dtype=cfg.solver_prep_dtype),
                robot_gravity=False,
            ),
            device=dev,
        )
        self.fingertip_sites = self._sites(self.robot.fingertip_site_names)
        self.fingertip_body_idx = torch.as_tensor(self.fingertip_sites[0], device=dev)
        self.flange_site = self._sites([self.robot.flange_site_name])
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        self.joint_limits = (f32(art.q_min), f32(art.q_max))
        if cfg.robot == "ur5sih":  # the UR5+SIH actionables' bounds
            self.arm_limits = (f32(art.q_min[:6]), f32(art.q_max[:6]))
            self.servo_lo, self.servo_hi = f32(SERVO_LOWER), f32(SERVO_UPPER)
        self.num_objects = shapes.num_objects
        self.goal_cloud_points = f32(sphere_points(0.02, 16))
        self._robot_cloud = None
        self.registry = Registry()
        _register_observables(self.registry, art.nv, self.num_objects)
        _register_pointcloud_observables(self.registry, self.num_objects,
                                         cfg.pointcloud_max_points)
        for cam in cfg.cameras:
            _register_camera_observables(self.registry, cam, cfg.pointcloud_max_points)
        _register_actionables(self.registry)
        if self.robot.register_terms is not None:
            self.robot.register_terms(self.registry)
        self.active_obs = self.registry.resolve_observables(list(cfg.observations))
        self.obs_slices, self.num_obs = obs_layout(self.active_obs, list(cfg.observations))
        self.active_teacher_obs = self.registry.resolve_observables(
            list(cfg.teacher_observations))
        self.teacher_obs_slices, self.num_teacher_obs = obs_layout(
            self.active_teacher_obs, list(cfg.teacher_observations))
        actions = cfg.actions
        if cfg.robot != "ur5sih" and actions == HandArmConfig.actions:
            actions = self.robot.default_actions
        self.active_actions = self.registry.resolve_actionables(list(actions))
        self.num_actions = sum(a.size for a in self.active_actions)
        self.reset_q = f32(self.robot.reset_q)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)
        self.initial_pool: genesis.InitialPool | None = None
        self.genesis_seconds: float | None = None

    def initialize_pool(self) -> None:
        """Run genesis once and keep its pose pool (first-reset drop init).
        With the environment variable HANDARM_POOL_CACHE naming a
        directory, a pool that genesis built there for the same config on
        the same kind of device is read instead, and a new one is written
        there (`pool_cache_path`); `genesis_seconds` is then the read's."""
        import time

        t0 = time.perf_counter()
        path = self.pool_cache_path()
        if path is not None and os.path.exists(path):
            self.initial_pool = genesis.InitialPool(
                **torch.load(path, map_location=self.device))
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(23 + self.cfg.num_envs)
            self.initial_pool = genesis.build_initial_pool(
                self, gen, num_configurations=self.cfg.num_initial_poses,
                drop_steps=self.cfg.drop_num_steps, settle_steps=self.cfg.settle_num_steps)
            if path is not None:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                torch.save(self.initial_pool._asdict(), path + ".tmp")
                os.replace(path + ".tmp", path)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.genesis_seconds = time.perf_counter() - t0

    def pool_cache_path(self) -> str | None:
        """Where HANDARM_POOL_CACHE keeps this env's genesis pool (None when
        unset): a file named by a hash of the config and the device type.
        Domain randomization and ADR are left out of the hash: genesis
        steps the scene without them."""
        root = os.environ.get("HANDARM_POOL_CACHE")
        if not root:
            return None
        cfg = dataclasses.replace(self.cfg, dr=DRConfig(), adr=AdrConfig())
        key = hashlib.sha1(repr((cfg, self.device.type)).encode()).hexdigest()[:16]
        return os.path.join(root, f"pool_{key}.pt")

    @property
    def robot_cloud(self):
        """(body index [P], body-frame offsets [P, 3]) of the robot's surface
        samples, `pointcloud_max_points` of them spread by link area; loaded
        on first use."""
        if self._robot_cloud is None:
            bodies, offsets = self.robot.surface_cloud(self.cfg.pointcloud_max_points)
            self._robot_cloud = (torch.as_tensor(bodies, dtype=torch.int64, device=self.device),
                                 torch.as_tensor(offsets, dtype=torch.float32,
                                                 device=self.device))
        return self._robot_cloud

    @property
    def scene_point_rgb(self) -> torch.Tensor:
        """[P, 3] albedo of the cameras' scene points, in
        `ObsContext.camera_scene_points` order: the robot's gray, then per
        object its record's `point_rgb` (a baked texture), its rows past
        those and analytic shapes' a palette colour; built on first use."""
        if self._scene_point_rgb is None:
            P_obj = self.scene.shapes.points.shape[1]
            parts = [np.full((len(self.robot_cloud[1]), 3), ROBOT_RGB)]
            for k, rgb in enumerate(self._object_rgb):
                block = np.tile(PALETTE[k % len(PALETTE)], (P_obj, 1))
                if rgb is not None:
                    block[:len(rgb)] = rgb
                parts.append(block)
            self._scene_point_rgb = torch.as_tensor(
                np.concatenate(parts), dtype=torch.float32, device=self.device)
        return self._scene_point_rgb

    def _sites(self, names):
        body, pos, quat = self.art.site_array(names)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return body, f32(pos), f32(quat)

    # --- reset draws ---------------------------------------------------------

    def _uniform(self, shape, lo, hi, gen=None):
        u = torch.rand(shape, generator=self.gen if gen is None else gen, device=self.device)
        return lo + (hi - lo) * u

    def _rest_heights(self):
        shp = self.scene.shapes
        return torch.stack([
            shp.size[k, 2] if shp.kind[k] == BOX else
            shp.size[k, 0] if shp.kind[k] == SPHERE else shp.bound_radius[k]
            for k in range(self.num_objects)
        ])

    def _sample_object_poses(self, B: int, gen=None):
        """Objects resting on the table around the drop point, in a random
        slot order along x."""
        K, cfg = self.num_objects, self.cfg
        gen = self.gen if gen is None else gen
        noise = self._uniform((B, K, 2), -1.0, 1.0, gen) * torch.tensor(
            cfg.spawn_noise[:2], device=self.device)
        spread = (torch.arange(K, device=self.device, dtype=torch.float32) - (K - 1) / 2.0) * 0.12
        perm = torch.argsort(torch.rand((B, K), generator=gen, device=self.device), dim=1)
        xy = torch.tensor(cfg.drop_pos[:2], device=self.device) + noise
        xy[..., 0] += spread[perm]
        z = (cfg.table_height + self._rest_heights())[None].expand(B, K)
        pos = torch.cat([xy, z[..., None]], dim=-1)
        yaw = self._uniform((B, K), -np.pi, np.pi, gen)
        axis = torch.tensor([0.0, 0.0, 1.0], device=self.device).expand(B, K, 3)
        return pos, quat_from_axis_angle(axis, yaw)

    def sample_target(self, B: int, per_object_ewma=None) -> torch.Tensor:
        """[B] target objects: uniform, or with `balanced_target_sampling`
        (given the metrics' per-object success EWMAs, K > 1) drawn with
        weights `target_weights`."""
        K = self.num_objects
        if per_object_ewma is None or not self.cfg.balanced_target_sampling or K <= 1:
            return torch.randint(0, K, (B,), generator=self.gen, device=self.device)
        return torch.multinomial(target_weights(per_object_ewma), B, replacement=True,
                                 generator=self.gen)

    def sample_goal_quat(self, B: int) -> torch.Tensor:
        """[B, 4] goals of the orientation goals (oriented_reposition,
        repose), from u ~ U(-1, 1)^2; the identity for the others."""
        if self.cfg.goal not in ("oriented_reposition", "repose"):
            return torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device).expand(B, 4).clone()
        return goal_quat_from_uniform(self._uniform((B, 2), -1.0, 1.0))

    def fresh_state(self, B: int, per_object_ewma=None, dr_draws=None) -> EnvState:
        """A new episode's state for B envs (drawn from the env's generator):
        each env takes one of the pool's settled configurations, else spawns.
        `per_object_ewma` feeds balanced target sampling; with DR, a fresh
        DRState (from the standard draws `dr_draws` if given). No ADR state:
        `reset` and `step` make it."""
        if self.initial_pool is not None:
            pool = self.initial_pool
            idx = torch.randint(0, pool.pos.shape[0], (B,), generator=self.gen,
                                device=self.device)
            envs = torch.arange(B, device=self.device)
            pos, quat = pool.pos[idx, envs], pool.quat[idx, envs]
        else:
            pos, quat = self._sample_object_poses(B)
        K, nv, C = self.num_objects, self.art.nv, self.scene.slots.num_slots
        dev = self.device
        goal = torch.tensor(self.cfg.goal_pos, device=dev) + self._uniform(
            (B, 3), -1.0, 1.0) * torch.tensor(self.cfg.goal_noise, device=dev)
        goal_quat = self.sample_goal_quat(B)
        target = self.sample_target(B, per_object_ewma)
        physics = PhysicsState(
            robot=RobotState(q=self.reset_q.expand(B, nv).clone(),
                             qd=torch.zeros(B, nv, device=dev),
                             targets=self.reset_q.expand(B, nv).clone()),
            objects=ObjectState(pos=pos, quat=quat,
                                linvel=torch.zeros(B, K, 3, device=dev),
                                angvel=torch.zeros(B, K, 3, device=dev)),
            contact_impulse=torch.zeros(B, C, 3, device=dev),
        )
        task = TaskState(
            progress=torch.zeros(B, dtype=torch.int64, device=dev),
            goal_pos=goal,
            goal_quat=goal_quat,
            target_obj=target,
            goal_reached_before=torch.zeros(B, dtype=torch.bool, device=dev),
            initial_obj_pos=pos,
            total_steps=torch.zeros((), dtype=torch.int64, device=dev),
            dr=init_dr_state(self.cfg.dr, B, K, nv, self.num_obs, self.num_actions, self.gen,
                             dr_draws, dev) if self.cfg.dr.enabled else None,
        )
        z = lambda *s: torch.zeros(s, device=dev)
        metrics = Metrics(z(), z(K), z(), z(), z())
        return EnvState(physics, self.robot.init_control(B, dev), task, metrics)

    def reset(self, seed: int = 0, draws: StepDraws | None = None):
        """(state, obs) for cfg.num_envs envs with staggered episode clocks,
        with ADR's initial state when it is on; `draws.dr` and `draws.adr`
        replace the generator's DR and ADR draws. The first reset of a
        drop-init task runs genesis."""
        if self.cfg.use_drop_init and self.initial_pool is None:
            self.initialize_pool()
        self.gen.manual_seed(seed)
        draws = draws or StepDraws()
        B = self.cfg.num_envs
        state = self.fresh_state(B, dr_draws=draws.dr)
        prog0 = torch.randint(0, self.cfg.episode_length, (B,),
                              generator=self.gen, device=self.device)
        adr = (init_adr_state(self.cfg.adr, B, self.gen, draws.adr, self.device)
               if self.cfg.adr.enabled else None)
        state = state._replace(task=state.task._replace(progress=prog0, adr=adr))
        return state, self._compute_obs(ObsContext(self, state))

    def observe(self, state: EnvState, scores=None):
        """(obs, teacher_obs, obs_dict) of a state, without stepping;
        `scores` as `step`'s."""
        ctx = ObsContext(self, state, None, scores)
        obs, obs_dict = self._compute_obs(ctx, self.active_obs, self.cfg.observations,
                                          with_dict=True)
        teacher = self._compute_obs(ctx, self.active_teacher_obs,
                                    self.cfg.teacher_observations)
        return obs, teacher, obs_dict

    # --- step ----------------------------------------------------------------

    def step(self, state: EnvState, actions: torch.Tensor, scores=None,
             draws: StepDraws | None = None):
        """(new state, StepResult). `scores` {P: [B, P]} replaces the
        uniform draws of the point-cloud subsampling (`ObsContext`), `draws`
        those of DR and ADR."""
        cfg = self.cfg
        draws = draws or StepDraws()
        B = actions.shape[0]
        clip = cfg.clip_actions
        actions = torch.clamp(actions, -clip, clip)
        strength = None
        if cfg.dr.enabled:  # with the episode's correlated draw, then clipped again
            strength = schedule_strength(cfg.dr, state.task.total_steps)
            actions = torch.clamp(apply_noise(
                cfg.dr.action_noise, actions, state.task.dr.act_corr, strength, self.gen,
                draws.act_noise), -clip, clip)

        control = state.control
        off = 0
        for act in self.active_actions:
            control = act.apply(self, control, actions[:, off:off + act.size])
            off += act.size
        targets = self.robot.compute_targets(control, state.physics.robot.q)
        physics = state.physics._replace(
            robot=state.physics.robot._replace(targets=targets))
        if cfg.randomize and cfg.disturbance_probability > 0:
            physics = physics._replace(objects=physics.objects._replace(
                linvel=physics.objects.linvel + self._disturbance(B)))

        ovr = self.overrides(state.task, B)
        physics, info_last = self._physics(physics, ovr)

        progress = state.task.progress + 1
        task = state.task._replace(progress=progress,
                                   total_steps=state.task.total_steps + 1)
        state2 = state._replace(physics=physics, task=task)

        reward, goal_reached, terms = self._compute_reward(ObsContext(self, state2, info_last))
        goal_reached_before = task.goal_reached_before | goal_reached
        finite = torch.ones(B, dtype=torch.bool, device=self.device)
        for x in (physics.robot.q, physics.robot.qd, physics.objects.pos,
                  physics.objects.quat, physics.objects.linvel,
                  physics.objects.angvel, physics.contact_impulse):
            finite &= torch.isfinite(x.reshape(B, -1)).all(dim=-1)
        reward = torch.where(finite & torch.isfinite(reward), reward,
                             torch.zeros_like(reward))
        goal_reached = goal_reached & finite
        done = (progress >= cfg.episode_length) | ~finite
        task = task._replace(goal_reached_before=goal_reached_before)
        metrics = self._update_metrics(state.metrics, done, goal_reached_before,
                                       task.target_obj, goal_reached)

        fresh = self.fresh_state(B, metrics.per_object_ewma, draws.dr)
        no_rand = dict(dr=None, adr=None)  # merged below, not by tree_map
        merged = tree_map(
            lambda new, old: _where_done(done, new, old),
            EnvState(fresh.physics, fresh.control, fresh.task._replace(**no_rand), metrics),
            EnvState(physics, control, task._replace(**no_rand), metrics),
        )._replace(metrics=metrics)
        # ADR moves on the pre-reset outcomes; its result replaces the state
        # whole (ranges and queues are not per env: never merged by done)
        merged = merged._replace(task=merged.task._replace(
            dr=merge_on_reset(done, fresh.task.dr, task.dr) if cfg.dr.enabled else None,
            adr=adr_step(cfg.adr, state.task.adr, done, goal_reached_before.to(torch.float32),
                         self.gen, draws.adr) if cfg.adr.enabled else None))

        ctx = ObsContext(self, merged, info_last, scores)
        obs, obs_dict = self._compute_obs(ctx, self.active_obs, cfg.observations,
                                          with_dict=True)
        if cfg.dr.enabled:  # with the post-reset correlated draw, then clipped again
            c = cfg.clip_observations
            obs = torch.clamp(apply_noise(
                cfg.dr.observation_noise, obs, merged.task.dr.obs_corr, strength, self.gen,
                draws.obs_noise), -c, c)
        teacher_obs = self._compute_obs(ctx, self.active_teacher_obs, cfg.teacher_observations)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        teacher_obs = torch.where(torch.isfinite(teacher_obs), teacher_obs,
                                  torch.zeros_like(teacher_obs))
        info = dict(
            success_rate_ewma=metrics.success_ewma,
            end_success_rate_ewma=metrics.end_success_ewma,
            per_object_success_ewma=metrics.per_object_ewma,
            max_penetration=info_last.max_penetration,
            **terms,
        )
        return merged, StepResult(obs=obs, teacher_obs=teacher_obs, reward=reward, done=done,
                                  info=info, obs_dict=obs_dict)

    # --- internals -------------------------------------------------------------

    def _physics(self, physics: PhysicsState, ovr: EnvOverrides):
        """`control_freq_inv` sim steps at the config's cadence: (state, the
        last sim step's info)."""
        cfg, sc, n = self.cfg, self.scene, self.cfg.control_freq_inv
        if not cfg.heavy_prep_per_control:  # dynamics and prep every sim step
            for _ in range(n):
                physics, info = physics_step(sc, physics, ovr=ovr)
            return physics, info
        heavy = compute_heavy(sc, physics, ovr)
        if not cfg.carry_fk:  # exact FK and contacts every sim step
            for _ in range(n):
                physics, info = physics_step(sc, physics, heavy, ovr=ovr)
            return physics, info
        # sim step 1 on compute_heavy's FK and contacts, the rest on the
        # FK the previous sim step propagated
        physics, info, fk = physics_step(sc, physics, heavy, heavy.fk0, heavy.contacts0, ovr)
        for _ in range(n - 1):
            physics, info, fk = physics_step(sc, physics, heavy, fk, ovr=ovr)
        return physics, info

    def overrides(self, task: TaskState, B: int) -> EnvOverrides:
        """The physical parameters in play: ADR's values (mass, friction,
        gain, gravity z: one each per env) when ADR is on, else DR's scales
        and, with gravity noise, its gravity; none without either."""
        cfg = self.cfg
        g = self.scene.gravity.expand(B, 3)
        with_z = lambda dz: torch.cat([g[:, :2], g[:, 2:] + dz[:, None]], dim=-1)
        if cfg.adr.enabled:
            v = task.adr.values
            return EnvOverrides(gain_scale=v[:, 2:3].expand(B, self.art.nv),
                                gravity=with_z(v[:, 3]),
                                mass_scale=v[:, 0:1].expand(B, self.num_objects),
                                friction_scale=v[:, 1])
        if cfg.dr.enabled:
            d = task.dr
            return EnvOverrides(gain_scale=d.gain_scale,
                                gravity=with_z(d.gravity_z) if cfg.dr.gravity_noise > 0 else None,
                                mass_scale=d.mass_scale, friction_scale=d.friction_scale)
        return EnvOverrides()

    def _disturbance(self, B: int) -> torch.Tensor:
        """[B, K, 3] object velocity kicks: with probability p per object, a
        uniform direction times magnitude * dt (a mass-proportional force
        for one sim step), else 0."""
        cfg, K = self.cfg, self.num_objects
        hit = torch.rand((B, K, 1), generator=self.gen, device=self.device) \
            < cfg.disturbance_probability
        u = torch.randn((B, K, 3), generator=self.gen, device=self.device)
        u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=1e-9)
        return torch.where(hit, u * (cfg.disturbance_magnitude * cfg.dt), torch.zeros_like(u))

    def _compute_obs(self, ctx: ObsContext, active=None, requested=None,
                     with_dict: bool = False):
        """The flat vector of the `requested` observables (default: the
        env's observations) routed to it, in that order, clipped to
        `clip_observations` ([B, 0] if none); with `with_dict`, also the
        others by name, unclipped (without it they are not computed)."""
        if active is None:
            active, requested = self.active_obs, self.cfg.observations
        flat = {o.name: o.fn(ctx) for o in active if o.key == "obs"}
        parts = [flat[n] for n in requested if n in flat]
        obs = torch.cat(parts, dim=-1) if parts else torch.zeros(ctx.batch, 0, device=self.device)
        c = self.cfg.clip_observations
        obs = torch.clamp(obs, -c, c)
        if not with_dict:
            return obs
        return obs, {o.key: o.fn(ctx) for o in active if o.key != "obs"}

    def _compute_reward(self, ctx: ObsContext):
        cfg = self.cfg
        tip_pos = ctx.fingertips[1]
        tgt_pos = ctx.target_object_pos
        goal_pos = ctx.state.task.goal_pos
        if cfg.goal == "lift":
            goal_height = cfg.table_height + cfg.lift_goal_height_above_table
            object_goal_distance = torch.clamp(goal_height - tgt_pos[:, 2], min=0.0)
            goal_reached = tgt_pos[:, 2] > goal_height
        elif cfg.goal == "repose":  # the target's orientation to the goal's
            object_goal_distance = quat_diff_rad(ctx.state.task.goal_quat,
                                                 ctx.target_object_quat)
            goal_reached = object_goal_distance < cfg.repose_threshold
        else:  # reposition, oriented_reposition, throw
            object_goal_distance = torch.linalg.vector_norm(tgt_pos - goal_pos, dim=-1)
            if cfg.goal == "oriented_reposition":  # plus the flange's rotation
                object_goal_distance = object_goal_distance + 0.1 * quat_diff_rad(
                    ctx.state.task.goal_quat, ctx.flange[0][:, 0])
            goal_reached = object_goal_distance < cfg.goal_threshold
        init_pos = ctx._target(ctx.state.task.initial_obj_pos)
        delta_z = (tgt_pos - init_pos)[:, 2]
        lifted = delta_z > cfg.lifting_threshold
        phys = ctx.state.physics
        reward = torch.zeros(ctx.batch, device=self.device)
        terms = {}
        for term, scale in cfg.reward.items():
            if term == "reaching":
                d = torch.linalg.vector_norm(tip_pos - tgt_pos[:, None, :], dim=-1)
                if cfg.robot == "ur5sih":  # the thumb weighs 4x
                    d = torch.cat([d[:, :1] * 4.0, d[:, 1:]], dim=1)
                r = scale * torch.exp(-3.0 * d.sum(-1))
            elif term == "lifting":
                thr = cfg.lifting_threshold
                delta_h = torch.clamp(thr - delta_z, 0.0, thr) / thr
                r = scale * (torch.exp(-3.0 * delta_h) - np.exp(-3.0))
            elif term == "goal":
                gate = 1.0 if cfg.goal == "repose" else lifted
                r = scale * gate * torch.exp(-5.0 * object_goal_distance)
            elif term == "success":
                r = scale * goal_reached
            elif term == "object_velocity_penalty":
                v = torch.linalg.vector_norm(phys.objects.linvel, dim=-1).sum(-1)
                r = -scale * _soft_excess(v, 0.25, 10.0)
            elif term == "dof_velocity_penalty":
                v = phys.robot.qd[:, :6].abs().amax(-1)
                r = -scale * _soft_excess(v, 0.5, 10.0)
            elif term == "collision_penalty":
                f = torch.linalg.vector_norm(ctx.info.body_contact_force, dim=-1).amax(-1)
                r = -scale * _soft_excess(f, 1.0, 1.0)
            else:
                raise ValueError(f"unknown reward term {term}")
            reward = reward + r
            terms[f"reward_terms/{term}"] = r.mean()
        return reward, goal_reached, terms

    def _update_metrics(self, metrics: Metrics, done, goal_reached_before,
                        target_obj, goal_reached_now) -> Metrics:
        K, B = self.num_objects, done.shape[0]
        f = lambda x: x.to(torch.float32)
        num_resets = f(done).sum()
        num_succ = f(done & goal_reached_before).sum()
        any_reset = num_resets > 0
        alpha = 0.2 * num_resets / B
        cur = num_succ / torch.clamp(num_resets, min=1)
        ewma = torch.where(any_reset, alpha * cur + (1 - alpha) * metrics.success_ewma,
                           metrics.success_ewma)
        end_cur = f(done & goal_reached_now).sum() / torch.clamp(num_resets, min=1)
        end_ewma = torch.where(any_reset,
                               alpha * end_cur + (1 - alpha) * metrics.end_success_ewma,
                               metrics.end_success_ewma)
        onehot = torch.nn.functional.one_hot(target_obj, K).to(torch.float32)
        resets_k = (onehot * f(done)[:, None]).sum(0)
        succ_k = (onehot * f(done & goal_reached_before)[:, None]).sum(0)
        cur_k = succ_k / torch.clamp(resets_k, min=1)
        alpha_k = 0.2 * resets_k / B * K
        ewma_k = torch.where(resets_k > 0, alpha_k * cur_k + (1 - alpha_k) * metrics.per_object_ewma,
                             metrics.per_object_ewma)
        return Metrics(ewma, ewma_k, metrics.total_resets + num_resets,
                       metrics.total_successes + num_succ, end_ewma)


def target_weights(per_object_ewma: torch.Tensor) -> torch.Tensor:
    """Balanced target sampling's weights: the failure rate plus a 0.15
    floor that keeps mastered objects in play."""
    return 1.0 - per_object_ewma + 0.15


def goal_quat_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """[B, 4] goal quaternions qx(u0 pi) * qy(u1 pi) of u [B, 2] in [-1, 1]."""
    B = u.shape[0]
    qx = quat_from_axis_angle(u.new_tensor([1.0, 0.0, 0.0]).expand(B, 3), u[:, 0] * np.pi)
    qy = quat_from_axis_angle(u.new_tensor([0.0, 1.0, 0.0]).expand(B, 3), u[:, 1] * np.pi)
    return quat_mul(qx, qy)


def _soft_excess(v, thr: float, cap: float):
    """clip(exp(v - thr) - 1 where v > thr, else 0, 0, cap)."""
    return torch.clamp(torch.where(v > thr, torch.exp(v - thr) - 1.0, torch.zeros_like(v)),
                       0.0, cap)


def _where_done(done, new, old):
    """Per-env where; leaves without a leading env axis keep the old value."""
    if new.ndim == 0 or new.shape[0] != done.shape[0]:
        return old
    return torch.where(done.reshape(done.shape + (1,) * (new.ndim - 1)), new, old)
