"""The lockstep physics engine (counterpart of handarm_tpu/physics/engine.py):
`build_scene`, `initial_state`, `compute_heavy`, `step` with every cadence
of the JAX package's, and `substep`.

One sim step (dt) is `substeps` contact-resolved substeps. Its cadences:

- `step(scene, state, heavy, fk0, contacts0)`, the env's default: the
  heavy mass structure of a control step (`compute_heavy`: exact FK,
  dynamics with the SPD-inverse kernel, contacts, solver prep) reused over
  its sim steps, FK carried from one sim step to the next (`fk0`, and the
  propagated FK returned), the contact geometry refreshed once per sim
  step;
- `step(scene, state, heavy)`: exact FK and fresh contacts every sim step
  against the control step's mass structure;
- `step(scene, state)`: dynamics and solver prep every sim step (genesis,
  the JAX physics suite; `step_exact` is its alias);
- `SimParams.substep_contacts`: contacts regenerated every substep from
  the propagated FK, each solve through `solver.solve_prepared`;
- `step(..., shared_prep=False)`: `substep` `substeps` times, everything
  evaluated per substep (`solver.solve_contacts`).

Without `substep_contacts` the substeps are anchored: they solve against
the contact set frozen at step start, with depths advanced from the
post-clamp normal velocity. The fused form (`anchored_pack` once per sim
step, warm start in the frozen basis, `solve_anchored` through the sweep
kernel) runs where the JAX package's conditions for its TPU fast path hold
(Jacobi, `jacobi_impl="soa"`, no restitution), on CUDA and CPU tensors
alike (the kernels' plain versions run on the CPU); otherwise the generic
anchored loop, which carries world-frame impulses into `solve_prepared`.

A floating base (an MJCF <freejoint>: the classic tasks' craft) keeps its
pose in `RobotState.base_pos` / `base_quat`; its 6 dofs (q[:, :6], held
at 0) carry the world-origin Plücker velocity: qd[:, 0:3] is the velocity
of the world origin carried by the base (v_point - w x p), qd[:, 3:6] the
world angular velocity. Every substep clamps the base's physical point
velocity and angular velocity (`SimParams.max_base_*`) and integrates the
pose from them. `RobotState.tau_ext` is a generalized torque added to the
stable-PD torque (the craft's thrust), set by the env before a step and
cleared after it. The FK carried between sim steps stays fixed-base only.

`Scene.rails` (a `RailSpec`, from `build_scene(..., rails=)`) holds
selected objects on prismatic or cylindrical rails: every cadence
integrates its substeps through `_integrate`, which projects those
objects onto their rails right after the free-body integration
(FrankaCabinet's drawer).

`EnvOverrides` carries the per-env physical parameters of domain
randomization: PD gain scales (kp and kd, in the SPD inverse's matrices
and every substep's PD torque), per-env gravity, and object mass and
friction scales (in the solver prep, hence in the sweep kernel's planes
and the robot effective masses).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import cross, quat_integrate, quat_rotate
from handarm_tpu_torch.physics.contacts import (
    Contacts,
    ContactSlots,
    RobotSpheres,
    StaticGeom,
    generate_contacts,
    make_contact_slots,
)
from handarm_tpu_torch.physics.dynamics import (
    Dyn,
    compute_dyn,
    free_body_integrate,
    gyroscopic_delta,
    stable_pd_torque,
)
from handarm_tpu_torch.physics.kinematics import (
    FK,
    ModelArrays,
    forward_kinematics,
    model_arrays,
)
from handarm_tpu_torch.physics.model import PRISMATIC, REVOLUTE, Articulation
from handarm_tpu_torch.physics.shapes import ObjectShapes
from handarm_tpu_torch.physics.solver import (
    Prep,
    SlotMaps,
    SolverParams,
    anchored_impulse_world,
    anchored_pack,
    anchored_vn,
    build_slot_maps,
    contact_bias,
    prepare,
    refresh_prep,
    rel_velocity,
    solve_anchored,
    solve_contacts,
    solve_prepared,
)


class SimParams(NamedTuple):
    dt: float = 1.0 / 60.0
    substeps: int = 2
    solver: SolverParams = SolverParams()
    joint_limit_margin: float = 0.0
    max_obj_linvel: float = 20.0
    max_obj_angvel: float = 100.0
    # floating-base caps on the base's physical point velocity and angular
    # velocity (not on the origin-Plücker coordinates)
    max_base_linvel: float = 20.0
    max_base_angvel: float = 64.0
    obj_linear_damping: float = 0.03
    obj_angular_damping: float = 0.1
    robot_gravity: bool = True
    # contacts regenerated every substep (from the propagated FK) instead of
    # frozen at step start
    substep_contacts: bool = False


class RobotState(NamedTuple):
    q: torch.Tensor  # [B, nv]
    qd: torch.Tensor  # [B, nv]; floating base: origin-Plücker base velocity in 0-5
    targets: torch.Tensor  # [B, nv]
    # floating-base pose (None for a fixed base)
    base_pos: torch.Tensor | None = None  # [B, 3]
    base_quat: torch.Tensor | None = None  # [B, 4] wxyz
    # generalized torque on top of the stable-PD torque (None: none)
    tau_ext: torch.Tensor | None = None  # [B, nv]


class ObjectState(NamedTuple):
    pos: torch.Tensor  # [B, K, 3]
    quat: torch.Tensor  # [B, K, 4]
    linvel: torch.Tensor  # [B, K, 3]
    angvel: torch.Tensor  # [B, K, 3]


class PhysicsState(NamedTuple):
    robot: RobotState
    objects: ObjectState
    contact_impulse: torch.Tensor  # [B, C, 3] world frame, warm-start cache


class EnvOverrides(NamedTuple):
    """Per-env physical parameters over the scene's (None: the scene's)."""

    gain_scale: torch.Tensor | None = None  # [B, nv] multiplies kp and kd
    gravity: torch.Tensor | None = None  # [B, 3]
    mass_scale: torch.Tensor | None = None  # [B, K] object mass multiplier
    friction_scale: torch.Tensor | None = None  # [B] contact friction multiplier


class RailSpec(NamedTuple):
    """Prismatic (or, with `spin`, cylindrical) rails of selected objects:
    the object takes part in the contact solve as a free body, then every
    substep its pose and velocity are projected onto its rail line (a
    post-stabilized 1-dof joint; FrankaCabinet's drawer)."""

    axis: torch.Tensor  # [K, 3] unit slide axis, world frame
    origin: torch.Tensor  # [K, 3] world position at s = 0
    quat: torch.Tensor  # [K, 4] fixed orientation (wxyz)
    lo: torch.Tensor  # [K] lower limit (m)
    hi: torch.Tensor  # [K] upper limit (m)
    damping: torch.Tensor  # [K] viscous decay rate (1/s)
    mask: torch.Tensor  # [K] 1 = on a rail, 0 = free
    # cylindrical rails (world-z axis only): the object keeps its rotation
    # about the axis and its axial travel (a nut on a bolt); None: all
    # rails prismatic
    spin: torch.Tensor | None = None  # [K] 1 = cylindrical, 0 = fixed orientation


class StepInfo(NamedTuple):
    body_contact_force: torch.Tensor  # [B, nb, 3]
    obj_contact_force: torch.Tensor  # [B, K, 3]
    max_penetration: torch.Tensor  # [B]


@dataclass
class Scene:
    model: ModelArrays
    shapes: ObjectShapes
    spheres: RobotSpheres
    geom: StaticGeom
    slots: ContactSlots
    maps: SlotMaps
    kp: torch.Tensor  # [nv]
    kd: torch.Tensor  # [nv]
    gravity: torch.Tensor  # [3]
    base_pos: torch.Tensor  # [3]
    base_quat: torch.Tensor  # [4]
    params: SimParams
    slot_to_body: torch.Tensor  # [C, nb]
    slot_to_obj: torch.Tensor  # [C, K] signed incidence
    rails: RailSpec | None = None  # objects held on rails


class HeavyPrep(NamedTuple):
    """Mass structure of one control step, reused by its sim steps."""

    dyn: Dyn
    prep: Prep
    bias_acc: torch.Tensor  # Mtilde^-1 bias
    fk0: FK
    contacts0: Contacts
    kp: torch.Tensor  # [nv], or [B, nv] under a gain scale
    kd: torch.Tensor


def build_scene(art: Articulation, shapes: ObjectShapes, spheres: RobotSpheres,
                geom: StaticGeom, kp, kd, base_pos=(0.0, 0.0, 0.0),
                base_quat=(1.0, 0.0, 0.0, 0.0), params: SimParams = SimParams(),
                rails: RailSpec | None = None, dtype=torch.float32, device="cpu") -> Scene:
    m = model_arrays(art, dtype, device)
    slots = make_contact_slots(shapes, spheres, static_friction=1.0,
                               num_walls=geom.num_walls)
    C, nb, K = slots.num_slots, art.nb, shapes.num_objects
    s2b = np.zeros((C, nb), np.float32)
    s2o = np.zeros((C, max(K, 1)), np.float32)
    for c in range(C):
        if slots.robot_body[c] >= 0:
            s2b[c, slots.robot_body[c]] = 1.0
        if slots.obj_a[c] >= 0:
            s2o[c, slots.obj_a[c]] = 1.0
        if slots.obj_b[c] >= 0:
            s2o[c, slots.obj_b[c]] -= 1.0
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return Scene(
        model=m, shapes=shapes, spheres=spheres, geom=geom, slots=slots,
        maps=build_slot_maps(slots, art.ancestor_mask, K, dtype, device),
        kp=t(kp), kd=t(kd), gravity=t([0.0, 0.0, -9.81]), base_pos=t(base_pos),
        base_quat=t(base_quat), params=params, slot_to_body=t(s2b),
        slot_to_obj=t(s2o),
        rails=None if rails is None else RailSpec(*(None if x is None else t(x) for x in rails)),
    )


def _base_pose(scene: Scene, rob: RobotState):
    """(quat, pos) of the fixed base frame, or of a floating base body."""
    if scene.model.floating:
        return rob.base_quat, rob.base_pos
    return scene.base_quat[None], scene.base_pos[None]


def _gravity(scene: Scene, ovr: EnvOverrides) -> torch.Tensor:
    return scene.gravity if ovr.gravity is None else ovr.gravity


def _gains(scene: Scene, ovr: EnvOverrides):
    """kp and kd, scaled per env under a gain scale."""
    if ovr.gain_scale is None:
        return scene.kp, scene.kd
    return scene.kp[None] * ovr.gain_scale, scene.kd[None] * ovr.gain_scale


def _robot_gravity(scene: Scene, ovr: EnvOverrides) -> torch.Tensor:
    gravity = _gravity(scene, ovr)
    return gravity if scene.params.robot_gravity else torch.zeros_like(gravity)


def initial_state(scene: Scene, B: int, q0=None, obj_pos0=None, obj_quat0=None,
                  base_pos0=None, base_quat0=None,
                  dtype=torch.float32) -> PhysicsState:
    """A state at rest: q = q0 (zeros) with its targets, objects at obj_pos0
    (the origin) and obj_quat0 (identity), no impulses. A floating base
    starts at base_pos0 / base_quat0 (the scene's base pose); a fixed base
    ignores them, as the JAX package does."""
    nv, K = scene.model.nv, scene.shapes.num_objects
    dev = scene.kp.device

    def full(x, shape, default=0.0):
        x = default if x is None else x
        return torch.as_tensor(x, dtype=dtype, device=dev).expand(shape).clone()

    q = full(q0, (B, nv))
    bp = bq = None
    if scene.model.floating:
        bp = full(scene.base_pos if base_pos0 is None else base_pos0, (B, 3))
        bq = full(scene.base_quat if base_quat0 is None else base_quat0, (B, 4))
    return PhysicsState(
        robot=RobotState(q=q, qd=full(None, (B, nv)), targets=q, base_pos=bp, base_quat=bq),
        objects=ObjectState(pos=full(obj_pos0, (B, K, 3)),
                            quat=full(obj_quat0, (B, K, 4), [1.0, 0.0, 0.0, 0.0]),
                            linvel=full(None, (B, K, 3)), angvel=full(None, (B, K, 3))),
        contact_impulse=full(None, (B, scene.slots.num_slots, 3)),
    )


def compute_heavy(scene: Scene, state: PhysicsState,
                  ovr: EnvOverrides = EnvOverrides()) -> HeavyPrep:
    """Exact FK, dynamics (SPD-inverse kernel), contacts and solver prep at
    the start of a control step, under the overrides `ovr`."""
    m, p = scene.model, scene.params
    h = p.dt / p.substeps
    rob = state.robot
    kp, kd = _gains(scene, ovr)
    fk0 = forward_kinematics(m, rob.q, *_base_pose(scene, rob))
    dyn = compute_dyn(m, fk0, rob.qd, _robot_gravity(scene, ovr), kp, kd, h)
    opos, oquat = state.objects.pos, state.objects.quat
    contacts0 = generate_contacts(scene.slots, scene.shapes, scene.spheres,
                                  scene.geom, opos, oquat, fk0.body_quat,
                                  fk0.body_pos)
    prep0 = prepare(m, fk0, dyn.Minv, scene.maps, scene.slots, contacts0,
                    scene.shapes, opos, oquat, h, p.solver,
                    mass_scale=ovr.mass_scale, friction_scale=ovr.friction_scale)
    return HeavyPrep(dyn=dyn, prep=prep0, bias_acc=dyn.solve(dyn.bias),
                     fk0=fk0, contacts0=contacts0, kp=kp, kd=kd)


def step_exact(scene: Scene, state: PhysicsState):
    """`step(scene, state)`: the sim step that evaluates the dynamics,
    contacts and solver prep at its own start, which genesis drives.
    Returns (state, info)."""
    return step(scene, state)


def _propagate_fk(m: ModelArrays, body_quat, body_pos, screw, qd, h: float):
    """First-order propagation of body poses and joint screws by the body
    twists (replaces the sequential FK chain between control steps)."""
    sv = screw * qd[..., None]
    bv = torch.einsum("nj,bja->bna", m.ancestor_mask, sv)
    w, v0 = bv[..., :3], bv[..., 3:]
    new_pos = body_pos + h * (v0 + cross(w, body_pos))
    new_quat = quat_integrate(body_quat, w, h)
    if m.floating:  # each dof's screw from its body's pose; the base's stay constant
        d = torch.as_tensor(m.dof_body.astype(np.int64), device=qd.device)
        dq, dp = new_quat[:, d], new_pos[:, d]
    else:
        dq, dp = new_quat, new_pos
    axis_w = quat_rotate(dq, m.axis[None].expand_as(dp))
    rev = torch.cat([axis_w, cross(dp, axis_w)], dim=-1)
    pri = torch.cat([torch.zeros_like(axis_w), axis_w], dim=-1)
    jt = m.joint_type
    is_rev = torch.as_tensor((jt == REVOLUTE).astype(np.float32), device=qd.device)[None, :, None]
    is_pri = torch.as_tensor((jt == PRISMATIC).astype(np.float32), device=qd.device)[None, :, None]
    return new_quat, new_pos, rev * is_rev + pri * is_pri + screw * (1.0 - is_rev - is_pri)


def _cap_contact_gain(v_out, v_free, w_out, w_free, shapes: ObjectShapes,
                      p: SolverParams):
    """|v_out| <= |v_free| + cap; |w_out| <= |w_free| + cap / bound_radius."""
    cap = p.max_contact_gain
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    v_scale = torch.clamp((norm(v_free) + cap) / torch.clamp(norm(v_out), min=1e-9), max=1.0)
    allow_w = norm(w_free) + cap / torch.clamp(shapes.bound_radius, min=1e-3)
    w_scale = torch.clamp(allow_w / torch.clamp(norm(w_out), min=1e-9), max=1.0)
    return v_out * v_scale[..., None], w_out * w_scale[..., None]


def _rolling_resistance(oav, impulse, normal, slot_to_obj, inertia_diag,
                        mu_roll: float):
    """Reduce each object's angular speed by at most
    mu_roll * (total normal impulse) / I_max."""
    lam_n = torch.clamp(torch.sum(impulse * normal, dim=-1), min=0.0)
    ln_obj = lam_n @ slot_to_obj.abs()
    cap = mu_roll * ln_obj / inertia_diag.max(dim=-1).values[None]
    w_mag = torch.linalg.vector_norm(oav, dim=-1)
    return oav * torch.clamp(1.0 - cap / torch.clamp(w_mag, min=1e-9), min=0.0)[..., None]


def _clip(x, lim):
    return torch.minimum(torch.maximum(x, -lim), lim)


def _clamp_base_velocity(qd, base_pos, p: SimParams):
    """Clamp a floating base's physical velocities: the point velocity of
    the base v_b = v_o + w x p and w, then back to origin Plücker (v_o can
    be large far from the origin, legitimately)."""
    w = qd[:, 3:6]
    v_b = qd[:, 0:3] + cross(w, base_pos)
    w_c = torch.clamp(w, -p.max_base_angvel, p.max_base_angvel)
    v_c = torch.clamp(v_b, -p.max_base_linvel, p.max_base_linvel)
    return torch.cat([v_c - cross(w_c, base_pos), w_c, qd[:, 6:]], dim=-1)


def _integrate_base(qd, base_pos, base_quat, h: float):
    """The base pose after one substep at the origin-Plücker velocity: the
    base point at p moves at v_o + w x p."""
    v_o, w = qd[:, 0:3], qd[:, 3:6]
    return base_pos + h * (v_o + cross(w, base_pos)), quat_integrate(base_quat, w, h)


def _zero_base_dofs(q):
    """q with the floating base's 6 freedoms at 0 (they live in the pose)."""
    return torch.cat([q.new_zeros(q.shape[0], 6), q[:, 6:]], dim=-1)


def _free_velocities(scene: Scene, q, qd, targets, kp, kd, dyn: Dyn, bias_acc,
                     olin, oang, oquat, g_obj, h: float, tau_ext=None):
    """Velocities after one substep of PD (plus `tau_ext`), bias, gravity and
    damping, before contacts: (qd_free, olin_free, oang_free)."""
    m, p = scene.model, scene.params
    tau = stable_pd_torque(q, qd, targets, kp, kd, h, m.effort_limit)
    if tau_ext is not None:
        tau = tau + tau_ext
    qd_free = qd - h * bias_acc + h * dyn.solve(tau)
    olin_free = olin * (1.0 - h * p.obj_linear_damping) + h * g_obj
    oang_free = oang * (1.0 - h * p.obj_angular_damping) + gyroscopic_delta(
        oquat, scene.shapes.inertia_diag, oang, h)
    return qd_free, olin_free, oang_free


def _integrate(scene: Scene, q, qd_s, olv, oav, olin_free, oang_free, opos, oquat,
               h: float, rolling=None, base_pos=None):
    """Clamp the solved velocities (joint velocity and position limits, a
    floating base's caps at its position `base_pos`, the contact-gain cap,
    object speed limits, rolling resistance from `rolling` = (world
    impulses, normals) thunk) and integrate one substep, then hold the
    railed objects on their rails (every cadence integrates here). Returns
    (q, qd, opos, oquat, olv, oav)."""
    m, p = scene.model, scene.params
    sp = p.solver
    low = m.q_min + p.joint_limit_margin
    high = m.q_max - p.joint_limit_margin
    qd_new = _clip(qd_s, m.velocity_limit)
    if m.floating:
        qd_new = _clamp_base_velocity(qd_new, base_pos, p)
    q_new = q + h * qd_new
    below, above = q_new < low, q_new > high
    q_new = torch.minimum(torch.maximum(q_new, low), high)
    qd_new = torch.where(below, torch.clamp(qd_new, min=0.0), qd_new)
    qd_new = torch.where(above, torch.clamp(qd_new, max=0.0), qd_new)
    olv, oav = _cap_contact_gain(olv, olin_free, oav, oang_free, scene.shapes, sp)
    olv = torch.clamp(olv, -p.max_obj_linvel, p.max_obj_linvel)
    oav = torch.clamp(oav, -p.max_obj_angvel, p.max_obj_angvel)
    if sp.rolling_friction > 0.0:
        impulse, normal = rolling()
        oav = _rolling_resistance(oav, impulse, normal, scene.slot_to_obj,
                                  scene.shapes.inertia_diag, sp.rolling_friction)
    opos, oquat = free_body_integrate(opos, oquat, olv, oav, h)
    if scene.rails is not None:
        opos, oquat, olv, oav = _apply_rails(scene.rails, opos, oquat, olv, oav, h)
    return q_new, qd_new, opos, oquat, olv, oav


def _apply_rails(rails: RailSpec, opos, oquat, olv, oav, h: float):
    """Project the railed objects' poses and velocities onto their rails:
    the position onto the line, clamped to [lo, hi] (the outward axial
    velocity killed at a limit), the axial velocity damped, the
    orientation fixed (or, on a cylindrical rail, reduced to its rotation
    about world z with the axial spin damped)."""
    m_rail = rails.mask[None, :, None] > 0  # [1, K, 1]
    s = torch.einsum("bki,ki->bk", opos - rails.origin[None], rails.axis)
    at_lo, at_hi = s <= rails.lo[None], s >= rails.hi[None]
    s = torch.minimum(torch.maximum(s, rails.lo[None]), rails.hi[None])
    pos_rail = rails.origin[None] + s[..., None] * rails.axis[None]
    decay = torch.clamp(1.0 - h * rails.damping[None], min=0.0)
    v_ax = torch.einsum("bki,ki->bk", olv, rails.axis)
    v_ax = torch.where(at_lo, torch.clamp(v_ax, min=0.0), v_ax)
    v_ax = torch.where(at_hi, torch.clamp(v_ax, max=0.0), v_ax)
    olv = torch.where(m_rail, (v_ax * decay)[..., None] * rails.axis[None], olv)
    opos = torch.where(m_rail, pos_rail, opos)
    fixed_quat = rails.quat[None].expand_as(oquat)
    if rails.spin is None:
        return opos, torch.where(m_rail, fixed_quat, oquat), olv, torch.where(
            m_rail, torch.zeros_like(oav), oav)
    m_spin = (rails.spin[None, :, None] > 0) & m_rail
    w_ax = torch.einsum("bki,ki->bk", oav, rails.axis) * decay
    oav = torch.where(m_spin, w_ax[..., None] * rails.axis[None],
                      torch.where(m_rail, torch.zeros_like(oav), oav))
    qw, qz = oquat[..., 0], oquat[..., 3]
    inv = torch.rsqrt(qw * qw + qz * qz + 1e-12)
    zero = torch.zeros_like(qw)
    q_yaw = torch.stack([qw * inv, zero, zero, qz * inv], dim=-1)
    oquat = torch.where(m_spin, q_yaw, torch.where(m_rail, fixed_quat, oquat))
    return opos, oquat, olv, oav


def _info(scene: Scene, impulse, depth, h: float) -> StepInfo:
    f_slot = impulse / h
    return StepInfo(
        body_contact_force=torch.einsum("bci,cn->bni", f_slot, scene.slot_to_body),
        obj_contact_force=torch.einsum("bci,ck->bki", -f_slot, scene.slot_to_obj),
        max_penetration=torch.clamp(depth, min=0.0).amax(dim=-1),
    )


def _state(rob: RobotState, q, qd, opos, oquat, olin, oang, impulse,
           base=None) -> PhysicsState:
    """The state after a step from robot state `rob`: its targets and
    tau_ext kept, a floating base at `base` = (pos, quat)."""
    bp, bq = base if base is not None else (rob.base_pos, rob.base_quat)
    return PhysicsState(
        robot=rob._replace(q=q, qd=qd, base_pos=bp, base_quat=bq),
        objects=ObjectState(pos=opos, quat=oquat, linvel=olin, angvel=oang),
        contact_impulse=impulse,
    )


def substep(scene: Scene, state: PhysicsState, ovr: EnvOverrides = EnvOverrides()):
    """One substep (dt / substeps) that evaluates everything at its own
    start: exact FK, dynamics (SPD-inverse kernel), contacts (the SDF kernel
    on mesh objects) and a whole contact solve (`solver.solve_contacts`:
    the deff kernel at its threshold, then the sweep kernel). Returns
    (state, info)."""
    m, p = scene.model, scene.params
    h = p.dt / p.substeps
    rob = state.robot
    q, qd, targets = rob.q, rob.qd, rob.targets
    opos, oquat, olin, oang = state.objects
    kp, kd = _gains(scene, ovr)
    gravity = _gravity(scene, ovr)
    fk = forward_kinematics(m, q, *_base_pose(scene, rob))
    dyn = compute_dyn(m, fk, qd, _robot_gravity(scene, ovr), kp, kd, h)
    tau = stable_pd_torque(q, qd, targets, kp, kd, h, m.effort_limit)
    if rob.tau_ext is not None:
        tau = tau + rob.tau_ext
    qd_free = qd + h * dyn.solve(tau - dyn.bias)
    g_obj = gravity if gravity.dim() == 1 else gravity[:, None, :]
    olin_free = olin * (1.0 - h * p.obj_linear_damping) + h * g_obj
    oang_free = oang * (1.0 - h * p.obj_angular_damping) + gyroscopic_delta(
        oquat, scene.shapes.inertia_diag, oang, h)
    contacts = generate_contacts(scene.slots, scene.shapes, scene.spheres, scene.geom,
                                 opos, oquat, fk.body_quat, fk.body_pos)
    out = solve_contacts(m, fk, dyn.Minv, scene.maps, scene.slots, contacts, scene.shapes,
                         opos, oquat, qd_free, olin_free, oang_free, h, p.solver,
                         warm_lam=state.contact_impulse, mass_scale=ovr.mass_scale,
                         friction_scale=ovr.friction_scale)
    q, qd, opos, oquat, olv, oav = _integrate(
        scene, q, out.qd, out.obj_linvel, out.obj_angvel, olin_free, oang_free, opos,
        oquat, h, rolling=lambda: (out.impulse, contacts.normal), base_pos=rob.base_pos)
    base = None
    if m.floating:
        base = _integrate_base(qd, rob.base_pos, rob.base_quat, h)
        q = _zero_base_dofs(q)
    return (_state(rob, q, qd, opos, oquat, olv, oav, out.impulse, base),
            _info(scene, out.impulse, contacts.depth, h))


def fused_anchored(params: SimParams) -> bool:
    """Whether the anchored substeps take the fused form: the conditions of
    the JAX package's TPU fast path (`engine._step_anchored`), read on CUDA
    and CPU tensors alike."""
    sp = params.solver
    return sp.mode == "jacobi" and sp.jacobi_impl == "soa" and sp.restitution == 0.0


def step(scene: Scene, state: PhysicsState, heavy: HeavyPrep | None = None,
         fk0: FK | None = None, contacts0: Contacts | None = None,
         ovr: EnvOverrides = EnvOverrides(), shared_prep: bool = True,
         carry_fk: bool | None = None):
    """One sim step (dt) of `substeps` substeps.

    `heavy` (from `compute_heavy`) supplies the control step's mass
    structure; without it the dynamics and solver prep are evaluated here.
    `fk0` is this step's start kinematics: compute_heavy's exact FK for the
    first sim step of a control step (then `contacts0` may pass its contact
    set), else the propagated FK the previous step returned; without it the
    exact FK is evaluated, and without `contacts0` the contacts. `ovr` must
    be the overrides `heavy` was computed under: the gains and the scaled
    masses and friction come from `heavy`, the gravity from `ovr`.
    `shared_prep=False` runs `substep` `substeps` times. `carry_fk` (by
    default: whether `fk0` was given) returns, third, the FK propagated to
    the step's end for the next sim step. Returns (state, info[, fk])."""
    if carry_fk is None:
        carry_fk = fk0 is not None
    if not shared_prep:
        if carry_fk or heavy is not None:
            raise ValueError("shared_prep=False evaluates everything per substep: no heavy "
                             "prep, no carried FK")
        for _ in range(scene.params.substeps):
            state, info = substep(scene, state, ovr)
        return state, info

    m, p = scene.model, scene.params
    h = p.dt / p.substeps
    sp = p.solver
    rob = state.robot
    opos, oquat = state.objects.pos, state.objects.quat
    if fk0 is None:
        fk0 = forward_kinematics(m, rob.q, *_base_pose(scene, rob))
    if contacts0 is None:
        contacts0 = generate_contacts(scene.slots, scene.shapes, scene.spheres,
                                      scene.geom, opos, oquat, fk0.body_quat,
                                      fk0.body_pos)
    if heavy is not None:
        dyn, bias_acc, kp, kd = heavy.dyn, heavy.bias_acc, heavy.kp, heavy.kd
        prep0 = refresh_prep(heavy.prep, fk0, scene.maps, contacts0, opos, h, sp)
    else:
        kp, kd = _gains(scene, ovr)
        dyn = compute_dyn(m, fk0, rob.qd, _robot_gravity(scene, ovr), kp, kd, h)
        prep0 = prepare(m, fk0, dyn.Minv, scene.maps, scene.slots, contacts0, scene.shapes,
                        opos, oquat, h, sp, mass_scale=ovr.mass_scale,
                        friction_scale=ovr.friction_scale)
        bias_acc = dyn.solve(dyn.bias)
    gravity = _gravity(scene, ovr)
    g_obj = gravity if gravity.dim() == 1 else gravity[:, None, :]
    run = (_step_substep_contacts if p.substep_contacts
           else _step_anchored_fused if fused_anchored(p) else _step_anchored)
    new_state, info, fk_next = run(scene, state, fk0, dyn, bias_acc, kp, kd, g_obj,
                                   contacts0, prep0)
    if not carry_fk:
        return new_state, info
    if m.floating:
        raise ValueError("the carried FK takes fixed-base models only")
    if fk_next is None:  # propagate by the realized joint displacement
        fk_next = FK(*_propagate_fk(m, fk0.body_quat, fk0.body_pos, fk0.screw,
                                    (new_state.robot.q - rob.q) / p.dt, p.dt))
    return new_state, info, fk_next


def _step_anchored_fused(scene: Scene, state: PhysicsState, fk0: FK, dyn: Dyn, bias_acc,
                         kp, kd, g_obj, contacts0: Contacts, prep0: Prep):
    """Anchored substeps in the fused form: one `anchored_pack` per sim step,
    impulses carried in the frozen basis, every solve one sweep-kernel
    launch with the warm start applied in the kernel."""
    m, p = scene.model, scene.params
    h = p.dt / p.substeps
    sp = p.solver
    rob = state.robot
    q, qd, targets = rob.q, rob.qd, rob.targets
    bpos, bquat = rob.base_pos, rob.base_quat
    opos, oquat, olin, oang = state.objects
    pack = anchored_pack(prep0)
    # previous step's world impulses -> this step's (frozen) basis
    lam = tuple(torch.sum(state.contact_impulse * prep0.basis[:, :, d], dim=-1)
                for d in range(3))
    depth = contacts0.depth
    for _ in range(p.substeps):
        bias = torch.where(
            depth >= 0.0,
            torch.clamp(sp.baumgarte / h * torch.clamp(depth - sp.slop, min=0.0),
                        max=sp.max_depenetration_vel),
            depth / h,
        )
        qd_free, olin_free, oang_free = _free_velocities(
            scene, q, qd, targets, kp, kd, dyn, bias_acc, olin, oang, oquat, g_obj, h,
            rob.tau_ext)
        qd_s, olv, oav, lam = solve_anchored(pack, scene.maps, bias, qd_free,
                                             olin_free, oang_free, lam, sp)
        n0 = lambda: torch.stack([pack.planes[i] for i in (0, 1, 2)], dim=-1)
        q, qd, opos, oquat, olin, oang = _integrate(
            scene, q, qd_s, olv, oav, olin_free, oang_free, opos, oquat, h,
            rolling=lambda: (anchored_impulse_world(pack, lam), n0()), base_pos=bpos)
        # TGS anchor advance from the post-clamp velocities
        depth = depth - h * anchored_vn(pack, scene.maps, qd, olin, oang)
        if m.floating:
            bpos, bquat = _integrate_base(qd, bpos, bquat, h)
            q = _zero_base_dofs(q)

    impulse = anchored_impulse_world(pack, lam)
    return (_state(rob, q, qd, opos, oquat, olin, oang, impulse, (bpos, bquat)),
            _info(scene, impulse, depth, h), None)


def _step_anchored(scene: Scene, state: PhysicsState, fk0: FK, dyn: Dyn, bias_acc,
                   kp, kd, g_obj, contacts0: Contacts, prep0: Prep):
    """Anchored substeps in the generic form: world-frame impulses carried
    from solve to solve, each solve `solve_prepared` against the frozen
    prep with this substep's depth bias (restitution, Gauss-Seidel and the
    jacobi_impl values other than "soa" take it)."""
    m, p = scene.model, scene.params
    h = p.dt / p.substeps
    sp = p.solver
    rob = state.robot
    q, qd, targets = rob.q, rob.qd, rob.targets
    bpos, bquat = rob.base_pos, rob.base_quat
    opos, oquat, olin, oang = state.objects
    lam = state.contact_impulse
    depth, n0 = contacts0.depth, contacts0.normal
    for _ in range(p.substeps):
        prep = replace(prep0, bias=contact_bias(depth, h, sp))
        qd_free, olin_free, oang_free = _free_velocities(
            scene, q, qd, targets, kp, kd, dyn, bias_acc, olin, oang, oquat, g_obj, h,
            rob.tau_ext)
        out = solve_prepared(prep, scene.maps, qd_free, olin_free, oang_free, sp, lam)
        q, qd, opos, oquat, olin, oang = _integrate(
            scene, q, out.qd, out.obj_linvel, out.obj_angvel, olin_free, oang_free, opos,
            oquat, h, rolling=lambda: (out.impulse, n0), base_pos=bpos)
        # TGS anchor advance (A side minus B side along the frozen normal)
        vrel = rel_velocity(prep, scene.maps, qd, olin, oang)
        depth = depth - h * torch.sum(vrel * n0, dim=-1)
        lam = out.impulse
        if m.floating:
            bpos, bquat = _integrate_base(qd, bpos, bquat, h)
            q = _zero_base_dofs(q)
    return (_state(rob, q, qd, opos, oquat, olin, oang, lam, (bpos, bquat)),
            _info(scene, lam, depth, h), None)


def _step_substep_contacts(scene: Scene, state: PhysicsState, fk0: FK, dyn: Dyn, bias_acc,
                           kp, kd, g_obj, contacts0: Contacts, prep0: Prep):
    """Substeps that regenerate the contacts from the propagated FK (the SDF
    kernel on mesh objects) and refresh the prep against its frozen mass
    terms, each solve `solve_prepared` with world-frame impulses. Returns
    the FK propagated to the step's end as well."""
    m, p = scene.model, scene.params
    h = p.dt / p.substeps
    sp = p.solver
    rob = state.robot
    q, qd, targets = rob.q, rob.qd, rob.targets
    opos, oquat, olin, oang = state.objects
    lam = state.contact_impulse
    bq, bp, screw = fk0
    for _ in range(p.substeps):
        fk = FK(bq, bp, screw)
        contacts = generate_contacts(scene.slots, scene.shapes, scene.spheres, scene.geom,
                                     opos, oquat, fk.body_quat, fk.body_pos)
        prep = refresh_prep(prep0, fk, scene.maps, contacts, opos, h, sp)
        qd_free, olin_free, oang_free = _free_velocities(
            scene, q, qd, targets, kp, kd, dyn, bias_acc, olin, oang, oquat, g_obj, h,
            rob.tau_ext)
        out = solve_prepared(prep, scene.maps, qd_free, olin_free, oang_free, sp, lam)
        q, qd, opos, oquat, olin, oang = _integrate(
            scene, q, out.qd, out.obj_linvel, out.obj_angvel, olin_free, oang_free, opos,
            oquat, h, rolling=lambda: (out.impulse, contacts.normal), base_pos=bp[:, 0])
        bq, bp, screw = _propagate_fk(m, bq, bp, screw, qd, h)
        lam = out.impulse
    base = None
    if m.floating:  # the propagated pose of body 0 is the integrated base pose
        base = (bp[:, 0], bq[:, 0])
        q = _zero_base_dofs(q)
    return (_state(rob, q, qd, opos, oquat, olin, oang, lam, base),
            _info(scene, lam, contacts.depth, h), FK(bq, bp, screw))
