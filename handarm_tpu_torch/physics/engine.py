"""The lockstep physics engine (counterpart of handarm_tpu/physics/engine.py:
`build_scene`, `compute_heavy`, the heavy + carried-FK `step`, its
anchored-substep loop in the fused form, and `step_exact`, the heavy-less
`step(scene, state)` that genesis drives).

A control step evaluates the heavy mass structure once (`compute_heavy`:
exact FK, dynamics with the SPD-inverse kernel, contacts, solver prep);
each sim step refreshes the contact geometry against it and runs
`substeps` anchored substeps, each one solve through the contact-sweep
kernel, with the contact set frozen at step start and depths advanced from
the post-clamp normal velocity. The JAX package takes this fused form only
on a TPU; here it is the only form, and on CPU tensors the kernels' plain
versions run inside it.

`EnvOverrides` carries the per-env physical parameters of domain
randomization: PD gain scales (kp and kd, in the SPD inverse's matrices
and every substep's PD torque), per-env gravity on the objects, and object
mass and friction scales (in the solver prep, hence in the sweep kernel's
planes and the robot effective masses). `step_exact` takes none: genesis
builds its pose pool without randomization, as the JAX package's does.
"""

from __future__ import annotations

from dataclasses import dataclass
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
    prepare,
    refresh_prep,
    solve_anchored,
)


class SimParams(NamedTuple):
    dt: float = 1.0 / 60.0
    substeps: int = 2
    solver: SolverParams = SolverParams()
    joint_limit_margin: float = 0.0
    max_obj_linvel: float = 20.0
    max_obj_angvel: float = 100.0
    obj_linear_damping: float = 0.03
    obj_angular_damping: float = 0.1
    robot_gravity: bool = True


class RobotState(NamedTuple):
    q: torch.Tensor  # [B, nv]
    qd: torch.Tensor  # [B, nv]
    targets: torch.Tensor  # [B, nv]


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
                dtype=torch.float32, device="cpu") -> Scene:
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
    )


def _base_pose(scene: Scene):
    return scene.base_quat[None], scene.base_pos[None]


def _gravity(scene: Scene, ovr: EnvOverrides) -> torch.Tensor:
    return scene.gravity if ovr.gravity is None else ovr.gravity


def compute_heavy(scene: Scene, state: PhysicsState,
                  ovr: EnvOverrides = EnvOverrides()) -> HeavyPrep:
    """Exact FK, dynamics (SPD-inverse kernel), contacts and solver prep at
    the start of a control step, under the overrides `ovr`."""
    m, p = scene.model, scene.params
    h = p.dt / p.substeps
    rob = state.robot
    kp, kd = scene.kp, scene.kd
    if ovr.gain_scale is not None:
        kp, kd = kp[None] * ovr.gain_scale, kd[None] * ovr.gain_scale
    bq, bp = _base_pose(scene)
    fk0 = forward_kinematics(m, rob.q, bq, bp)
    gravity = _gravity(scene, ovr)
    g_rob = gravity if p.robot_gravity else torch.zeros_like(gravity)
    dyn = compute_dyn(m, fk0, rob.qd, g_rob, kp, kd, h)
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
    """One sim step that evaluates the dynamics, contacts and solver prep at
    its own start: the JAX package's `engine.step(scene, state)` without a
    HeavyPrep, which genesis drives. Returns (state, info)."""
    heavy = compute_heavy(scene, state)
    new_state, info, _ = step(scene, state, heavy, heavy.fk0, heavy.contacts0)
    return new_state, info


def _propagate_fk(m: ModelArrays, body_quat, body_pos, screw, qd, h: float):
    """First-order propagation of body poses and joint screws by the body
    twists (replaces the sequential FK chain between control steps)."""
    sv = screw * qd[..., None]
    bv = torch.einsum("nj,bja->bna", m.ancestor_mask, sv)
    w, v0 = bv[..., :3], bv[..., 3:]
    new_pos = body_pos + h * (v0 + cross(w, body_pos))
    new_quat = quat_integrate(body_quat, w, h)
    axis_w = quat_rotate(new_quat, m.axis[None].expand_as(new_pos))
    rev = torch.cat([axis_w, cross(new_pos, axis_w)], dim=-1)
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


def step(scene: Scene, state: PhysicsState, heavy: HeavyPrep, fk0: FK,
         contacts0: Contacts | None = None, ovr: EnvOverrides = EnvOverrides()):
    """One sim step (dt) of `substeps` anchored substeps against `heavy`.

    `fk0` is this step's start kinematics: compute_heavy's exact FK for the
    first sim step of a control step (then `contacts0` may pass its contact
    set), else the propagated FK the previous step returned. `ovr` must be
    the overrides `heavy` was computed under: the gains and the scaled
    masses and friction come from `heavy`, the gravity from `ovr`. Returns
    (state, info, fk_next)."""
    m, p = scene.model, scene.params
    h = p.dt / p.substeps
    sp = p.solver
    rob = state.robot
    q, qd, targets = rob.q, rob.qd, rob.targets
    opos, oquat, olin, oang = state.objects
    gravity = _gravity(scene, ovr)
    g_obj = gravity if gravity.dim() == 1 else gravity[:, None, :]
    if contacts0 is None:
        contacts0 = generate_contacts(scene.slots, scene.shapes, scene.spheres,
                                      scene.geom, opos, oquat, fk0.body_quat,
                                      fk0.body_pos)
    prep0 = refresh_prep(heavy.prep, fk0, scene.maps, contacts0, opos, h, sp)
    dyn, bias_acc = heavy.dyn, heavy.bias_acc

    pack = anchored_pack(prep0)
    # previous step's world impulses -> this step's (frozen) basis
    lam = tuple(torch.sum(state.contact_impulse * prep0.basis[:, :, d], dim=-1)
                for d in range(3))
    depth = contacts0.depth
    q0 = q
    low = m.q_min + p.joint_limit_margin
    high = m.q_max - p.joint_limit_margin
    for _ in range(p.substeps):
        bias = torch.where(
            depth >= 0.0,
            torch.clamp(sp.baumgarte / h * torch.clamp(depth - sp.slop, min=0.0),
                        max=sp.max_depenetration_vel),
            depth / h,
        )
        tau = stable_pd_torque(q, qd, targets, heavy.kp, heavy.kd, h, m.effort_limit)
        qd_free = qd - h * bias_acc + h * dyn.solve(tau)
        olin_free = olin * (1.0 - h * p.obj_linear_damping) + h * g_obj
        oang_free = oang * (1.0 - h * p.obj_angular_damping) + gyroscopic_delta(
            oquat, scene.shapes.inertia_diag, oang, h)
        qd_s, olv, oav, lam = solve_anchored(pack, scene.maps, bias, qd_free,
                                             olin_free, oang_free, lam, sp)
        qd_new = _clip(qd_s, m.velocity_limit)
        q_new = q + h * qd_new
        below, above = q_new < low, q_new > high
        q_new = torch.minimum(torch.maximum(q_new, low), high)
        qd_new = torch.where(below, torch.clamp(qd_new, min=0.0), qd_new)
        qd_new = torch.where(above, torch.clamp(qd_new, max=0.0), qd_new)
        olv, oav = _cap_contact_gain(olv, olin_free, oav, oang_free, scene.shapes, sp)
        olv = torch.clamp(olv, -p.max_obj_linvel, p.max_obj_linvel)
        oav = torch.clamp(oav, -p.max_obj_angvel, p.max_obj_angvel)
        if sp.rolling_friction > 0.0:
            n0 = torch.stack([pack.planes[i] for i in (0, 1, 2)], dim=-1)
            oav = _rolling_resistance(oav, anchored_impulse_world(pack, lam), n0,
                                      scene.slot_to_obj, scene.shapes.inertia_diag,
                                      sp.rolling_friction)
        opos, oquat = free_body_integrate(opos, oquat, olv, oav, h)
        # TGS anchor advance from the post-clamp velocities
        depth = depth - h * anchored_vn(pack, scene.maps, qd_new, olv, oav)
        q, qd, olin, oang = q_new, qd_new, olv, oav

    impulse = anchored_impulse_world(pack, lam)
    f_slot = impulse / h
    info = StepInfo(
        body_contact_force=torch.einsum("bci,cn->bni", f_slot, scene.slot_to_body),
        obj_contact_force=torch.einsum("bci,ck->bki", -f_slot, scene.slot_to_obj),
        max_penetration=torch.clamp(depth, min=0.0).amax(dim=-1),
    )
    new_state = PhysicsState(
        robot=RobotState(q=q, qd=qd, targets=targets),
        objects=ObjectState(pos=opos, quat=oquat, linvel=olin, angvel=oang),
        contact_impulse=impulse,
    )
    # propagate by the realized joint displacement
    bq2, bp2, screw2 = _propagate_fk(m, fk0.body_quat, fk0.body_pos, fk0.screw,
                                     (q - q0) / p.dt, p.dt)
    return new_state, info, FK(bq2, bp2, screw2)
