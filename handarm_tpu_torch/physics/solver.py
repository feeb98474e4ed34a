"""Batched contact solver (counterpart of handarm_tpu/physics/solver.py):
relaxed Jacobi (default) or sequential-impulse Gauss-Seidel.

`prepare` builds the solver quantities of one contact set (`refresh_prep`
refreshes their geometry against frozen mass terms). The engine's fast
path lays them out as [B, C] planes once per sim step (`anchored_pack`)
and every substep runs all the sweeps of one solve through
`ops.contact_sweep` (`solve_anchored`; a CUDA kernel on the card), with
the depth advance `anchored_vn` in plain tensor code on the post-clamp
velocities. The general entry points are `solve_prepared` and
`solve_contacts` (prepare, then solve), with the JAX package's dispatch:
`mode="jacobi"` with `jacobi_impl="soa"` takes `solve_jacobi_soa`
(restitution, the world-frame warm start reprojected and pre-applied,
then the sweep kernel with `apply_warm=False`); any other `jacobi_impl`
takes the [B, C, 3] formulation `solve_jacobi`, and `mode="gs"` the
sequential `solve_gs`, both plain tensor code as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import cross, skew
from handarm_tpu_torch.ops import contact_sweep as sweep_op
from handarm_tpu_torch.ops import prep_deff as deff_op
from handarm_tpu_torch.ops.contact_sweep import BASE, MAX_DOFS, NBASE, NSIDE, SlotGroups
from handarm_tpu_torch.physics.contacts import Contacts, ContactSlots
from handarm_tpu_torch.physics.dynamics import free_body_inv_inertia_world
from handarm_tpu_torch.physics.kinematics import FK, ModelArrays, point_jacobian


class SolverParams(NamedTuple):
    iterations: int = 8
    baumgarte: float = 0.3
    slop: float = 0.001
    warm_start: float = 0.9
    max_depenetration_vel: float = 0.5
    max_contact_gain: float = 1.0
    rolling_friction: float = 0.0
    relaxation: float = 1.0
    speculative_margin: float = 0.02
    prep_dtype: str = "f32"  # "bf16": effective-mass chain in bfloat16
    # "soa": [B, C] planes, the sweep kernel (the plain sweep on CPU
    # tensors), and the deff kernel (float32) on CUDA at B * C >= 2^21, as
    # the JAX package does on its TPU, else the chunked chain in
    # prep_dtype. "pallas": the deff path at any size. solve_prepared takes
    # solve_jacobi_soa for "soa" only, as the JAX package does: "pallas",
    # "pallas_off" and "aos" take the [B, C, 3] solve_jacobi.
    jacobi_impl: str = "soa"
    mode: str = "jacobi"  # "jacobi" (vectorized) | "gs" (sequential impulses)
    # Newtonian bounce: the target separating velocity is -restitution x
    # the pre-solve approach velocity, for approaches faster than the
    # threshold
    restitution: float = 0.0
    restitution_threshold: float = 0.2
    activation_margin: float = 0.0  # read nowhere, as in the JAX package


DEFF_KERNEL_MIN_BC = 2 ** 21


@dataclass
class SlotMaps:
    """Static slot couplings, built once per scene from ContactSlots."""

    anc_slot: torch.Tensor  # [C, nv] dof u moves slot c's robot body
    anc_bits: torch.Tensor  # [C] int64 bitmask of anc_slot (bit u: dof u)
    robot_mask: torch.Tensor  # [C]
    group_onehot: torch.Tensor  # [C, G]
    group_obj: torch.Tensor  # [G, K]
    slot_obj: tuple  # ([C, K], [C, K]) per side (a, b)
    side_kidx: tuple  # per present side: [C] object index (0 where absent)
    side_mask: tuple  # per present side: [C] 1.0 where the slot has that side
    side_onehot: tuple  # per present side: [C, K]
    obj_idx: torch.Tensor  # [S, C] int32 object per side, -1 where absent
    signs: tuple  # per present side: +1.0 (a) / -1.0 (b)
    groups: SlotGroups  # the kernels' per-link and per-object slot lists


def _group_onehot(slots: ContactSlots) -> np.ndarray:
    keys, gid = {}, []
    for c in range(slots.num_slots):
        a, b = int(slots.obj_a[c]), int(slots.obj_b[c])
        key = (int(slots.robot_body[c]), (min(a, b), max(a, b)))
        gid.append(keys.setdefault(key, len(keys)))
    onehot = np.zeros((slots.num_slots, len(keys)), np.float32)
    onehot[np.arange(slots.num_slots), gid] = 1.0
    return onehot


def build_slot_groups(anc_bits: np.ndarray, obj_idx: np.ndarray, num_objects: int,
                      device="cpu") -> SlotGroups:
    """The slot groups the sweep and deff kernels reduce over: one group per
    distinct nonzero dof mask (grouped by the mask itself, so any tree and
    slot layout stay exact; on a kinematic tree one per hand link), and one
    per (side, object) bin, each as an ascending CSR list of slots. The
    masks are 64-bit words (int64, bit u for dof u), ordered as unsigned."""
    anc_bits = np.asarray(anc_bits, np.int64)
    obj_idx = np.asarray(obj_idx, np.int64).reshape(-1, anc_bits.shape[0])
    masks = anc_bits.view(np.uint64)  # bit 63 set stays a mask, not a sign
    link_bits, inverse = np.unique(masks, return_inverse=True)
    inverse = inverse.reshape(-1) - int(link_bits[0] == 0)
    link_bits = link_bits[link_bits != 0]
    slot_link = np.where(masks != 0, inverse, -1)

    def csr(lists):
        ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
        return ptr, np.concatenate(lists + [np.zeros(0, np.int64)])

    K = max(num_objects, 1)
    link_ptr, link_slots = csr([np.flatnonzero(slot_link == g) for g in range(len(link_bits))])
    # bin q * K + k: the slots whose side q holds object k
    obj_ptr, obj_slots = csr([np.flatnonzero(row == k) for row in obj_idx for k in range(K)])
    i32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)
    return SlotGroups(torch.as_tensor(link_bits.view(np.int64), device=device),
                      i32(slot_link), i32(link_ptr), i32(link_slots), i32(obj_ptr),
                      i32(obj_slots))


def build_slot_maps(slots: ContactSlots, ancestor_mask: np.ndarray,
                    num_objects: int, dtype=torch.float32,
                    device="cpu") -> SlotMaps:
    C = slots.num_slots
    K = max(num_objects, 1)
    t = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    has_robot = slots.robot_body >= 0
    body = np.where(has_robot, slots.robot_body, 0)
    anc = np.asarray(ancestor_mask)[body] * has_robot[:, None]
    if anc.shape[1] > MAX_DOFS:
        raise ValueError(f"{anc.shape[1]} dofs: the sweep and deff kernels' 64-bit dof masks "
                         f"hold at most {MAX_DOFS}")
    bits = ((anc > 0).astype(np.uint64)
            @ np.left_shift(np.uint64(1), np.arange(anc.shape[1], dtype=np.uint64))
            ).view(np.int64)
    onehot = _group_onehot(slots)
    slot_a = np.zeros((C, K), np.float32)
    slot_b = np.zeros((C, K), np.float32)
    for c in range(C):
        if slots.obj_a[c] >= 0:
            slot_a[c, slots.obj_a[c]] = 1.0
        if slots.obj_b[c] >= 0:
            slot_b[c, slots.obj_b[c]] = 1.0
    group_obj = (onehot.T @ (slot_a + slot_b) > 0).astype(np.float32)
    kidx, masks, onehots, idx_rows, signs = [], [], [], [], []
    for idx_arr, sign, oh in ((slots.obj_a, 1.0, slot_a), (slots.obj_b, -1.0, slot_b)):
        has = idx_arr >= 0
        if num_objects == 0 or not has.any():
            continue
        kidx.append(torch.as_tensor(np.where(has, idx_arr, 0), device=device))
        masks.append(t(has))
        onehots.append(t(oh))
        idx_rows.append(np.where(has, idx_arr, -1))
        signs.append(sign)
    obj_idx = np.stack(idx_rows) if idx_rows else np.zeros((0, C), np.int64)
    return SlotMaps(
        anc_slot=t(anc), anc_bits=t(bits, torch.int64), robot_mask=t(has_robot),
        group_onehot=t(onehot), group_obj=t(group_obj),
        slot_obj=(t(slot_a), t(slot_b)), side_kidx=tuple(kidx),
        side_mask=tuple(masks), side_onehot=tuple(onehots),
        obj_idx=t(obj_idx, torch.int32), signs=tuple(signs),
        groups=build_slot_groups(bits, obj_idx, num_objects, device),
    )


def mass_split(active, maps: SlotMaps):
    """Two-level mass splitting: within contact groups, then across the
    distinct active groups touching each slot's objects."""
    counts = active @ maps.group_onehot  # [B, G]
    counts_c = counts @ maps.group_onehot.T  # [B, C]
    split = 1.0 / torch.clamp(counts_c, min=1.0)
    g_active = (counts > 0.0).to(active.dtype)
    groups_on_obj = g_active @ maps.group_obj  # [B, K]
    fa = groups_on_obj @ maps.slot_obj[0].T
    fb = groups_on_obj @ maps.slot_obj[1].T
    return split / torch.clamp(torch.maximum(fa, fb), min=1.0)


def _tangent_basis(n: torch.Tensor):
    e_x = n.new_tensor([1.0, 0.0, 0.0])
    e_y = n.new_tensor([0.0, 1.0, 0.0])
    ax = torch.where(n[..., 0:1].abs() < 0.9, e_x, e_y)
    t1 = cross(n, ax)
    t1 = t1 * torch.rsqrt(torch.sum(t1 * t1, dim=-1, keepdim=True) + 1e-18)
    return t1, cross(n, t1)


def contact_bias(depth, h: float, params: SolverParams):
    return torch.where(
        depth >= 0.0,
        torch.clamp(params.baumgarte / h * torch.clamp(depth - params.slop, min=0.0),
                    max=params.max_depenetration_vel),
        depth / h,
    )


def use_deff_kernel(params: SolverParams, B: int, C: int, device) -> bool:
    """The gate of handarm_tpu/physics/solver.py `_prepare`, with the card in
    place of the TPU: never under Gauss-Seidel."""
    if params.mode == "gs":
        return False
    if params.jacobi_impl == "pallas":
        return True
    return (params.jacobi_impl == "soa" and torch.device(device).type == "cuda"
            and B * C >= DEFF_KERNEL_MIN_BC)


@dataclass
class Prep:
    """Solver quantities: heavy terms (d_eff, Minv, inverse inertias) once per
    control step, geometry refreshed per sim step by `refresh_prep`."""

    active: torch.Tensor  # [B, C]
    basis: torch.Tensor  # [B, C, 3(dir), 3]
    inv_d: torch.Tensor  # [B, C, 3]
    split: torch.Tensor  # [B, C]
    bias: torch.Tensor  # [B, C]
    mu: torch.Tensor  # [B, C]
    pos: torch.Tensor  # [B, C, 3]
    screw: torch.Tensor  # [B, nv, 6]
    Minv: torch.Tensor  # [B, nv, nv]
    d_eff: torch.Tensor  # [B, C, 3]
    # per present side: (r [B, C, 3], Iinv_c [B, C, 3, 3], invm_c [B, C])
    sides: tuple
    J: torch.Tensor | None = None  # [B, C, 3, nv] (mode "gs" only)
    MinvJT: torch.Tensor | None = None  # [B, C, nv, 3] (mode "gs" only)


def prepare(m: ModelArrays, fk: FK, Minv, maps: SlotMaps, slots: ContactSlots,
            contacts: Contacts, shapes, obj_pos, obj_quat, h: float,
            params: SolverParams, mass_scale=None, friction_scale=None) -> Prep:
    """The solver quantities of one control step. `mass_scale` [B, K]
    divides each object's inverse mass and inverse inertia, `friction_scale`
    [B] multiplies every slot's friction (domain randomization)."""
    B, C = contacts.depth.shape
    dtype = contacts.depth.dtype
    active = (contacts.depth > -params.speculative_margin).to(dtype)
    n = contacts.normal
    t1, t2 = _tangent_basis(n)
    basis = torch.stack([n, t1, t2], dim=2)

    J = MinvJT = None
    if params.mode == "gs":
        # Gauss-Seidel reads each slot's Jacobian and its Minv J^T columns
        body = torch.as_tensor(np.where(slots.robot_body >= 0, slots.robot_body, 0),
                               device=n.device)
        J = point_jacobian(m, fk, body[None].expand(B, C), contacts.pos) \
            * maps.robot_mask[None, :, None, None]
        f_unit = torch.cat([skew(contacts.pos),
                            torch.eye(3, dtype=dtype, device=n.device).expand(B, C, 3, 3)],
                           dim=-2)  # [B, C, 6, 3]
        Bc = torch.einsum("bua,bcai->bcui", fk.screw, f_unit) * maps.anc_slot[None, :, :, None]
        MinvJT = torch.einsum("buv,bcvi->bcui", Minv, Bc)

    if not bool((slots.robot_body >= 0).any()):
        d_robot = torch.zeros(B, C, 3, dtype=dtype, device=n.device)
    elif use_deff_kernel(params, B, C, n.device):
        # d[c, d] = v_d^T Minv v_d, v_d[u] = anc[c,u] (s_ang_u x p_c + s_lin_u) . w_d
        # in float32, without the [B, C, nv, 3] intermediates (ops/prep_deff.py)
        nv = Minv.shape[-1]
        d_robot = deff_op.robot_deff(
            fk.screw.permute(2, 0, 1).contiguous(),
            contacts.pos.permute(2, 0, 1).contiguous(),
            basis.permute(2, 3, 0, 1).reshape(9, B, C).contiguous(),
            maps.anc_slot, maps.groups, Minv.reshape(B, nv * nv).contiguous(),
        ).permute(1, 2, 0)
    else:
        pd = torch.bfloat16 if params.prep_dtype == "bf16" else dtype
        d_robot = deff_op.deff_chain(fk.screw, contacts.pos, basis, maps.anc_slot,
                                     Minv, pd)

    d_obj_acc = torch.zeros_like(d_robot)
    sides = []
    if maps.signs:
        Iinv_w = free_body_inv_inertia_world(obj_quat, shapes.inertia_diag)
    for kidx, mask in zip(maps.side_kidx, maps.side_mask):
        r = contacts.pos - obj_pos[:, kidx]
        Iinv_c = Iinv_w[:, kidx]
        invm_c = shapes.inv_mass[kidx].expand(B, C)
        if mass_scale is not None:
            ms = mass_scale[:, kidx]  # [B, C]
            invm_c = invm_c / ms
            Iinv_c = Iinv_c / ms[..., None, None]
        cr = cross(r[:, :, None, :], basis)  # [B, C, 3(dir), 3]
        Icr = torch.sum(Iinv_c[:, :, None] * cr[:, :, :, None, :], dim=-1)
        d_obj = invm_c[..., None] + torch.sum(cr * Icr, dim=-1)
        d_obj_acc = d_obj_acc + d_obj * mask[None, :, None]
        sides.append((r, Iinv_c, invm_c))

    d_eff = torch.clamp(d_robot + d_obj_acc, min=1e-8)
    mu = torch.as_tensor(slots.friction, dtype=dtype, device=n.device)[None].expand(B, C)
    if friction_scale is not None:
        mu = mu * friction_scale[:, None]
    return Prep(
        active=active, basis=basis, inv_d=active[..., None] / d_eff,
        split=mass_split(active, maps),
        bias=contact_bias(contacts.depth, h, params), mu=mu,
        pos=contacts.pos, screw=fk.screw, Minv=Minv, d_eff=d_eff,
        sides=tuple(sides), J=J, MinvJT=MinvJT,
    )


def refresh_prep(prep: Prep, fk: FK, maps: SlotMaps, contacts: Contacts,
                 obj_pos, h: float, params: SolverParams) -> Prep:
    """Fresh geometry against the frozen mass terms of `prep`. The friction
    `prep.mu` is kept: it depends on the slots and the per-episode friction
    scale alone, so it equals the JAX package's re-multiplication by the
    scale here."""
    dtype = contacts.depth.dtype
    active = (contacts.depth > -params.speculative_margin).to(dtype)
    n = contacts.normal
    t1, t2 = _tangent_basis(n)
    sides = tuple(
        (contacts.pos - obj_pos[:, kidx], Iinv_c, invm_c)
        for kidx, (_, Iinv_c, invm_c) in zip(maps.side_kidx, prep.sides)
    )
    return replace(
        prep, active=active, basis=torch.stack([n, t1, t2], dim=2),
        inv_d=active[..., None] / prep.d_eff,
        bias=contact_bias(contacts.depth, h, params),
        split=mass_split(active, maps), pos=contacts.pos, screw=fk.screw,
        sides=sides,
    )


class AnchoredPack(NamedTuple):
    """The sweep kernel's inputs, laid out once per sim step."""

    planes: torch.Tensor  # [NP, B, C]; layout in ops.contact_sweep.BASE
    screws: torch.Tensor  # [6, B, nv]
    minv2: torch.Tensor  # [B, nv*nv]
    active: torch.Tensor  # [B, C]


def anchored_pack(prep: Prep) -> AnchoredPack:
    comps = lambda x: [x[..., 0], x[..., 1], x[..., 2]]
    planes = (
        comps(prep.basis[:, :, 0]) + comps(prep.basis[:, :, 1])
        + comps(prep.basis[:, :, 2]) + comps(prep.pos) + [prep.mu]
        + comps(prep.inv_d) + [prep.active * prep.split]
    )
    for r, Ic, invm in prep.sides:
        planes += comps(r) + [Ic[..., 0, 0], Ic[..., 0, 1], Ic[..., 0, 2],
                              Ic[..., 1, 1], Ic[..., 1, 2], Ic[..., 2, 2], invm]
    B, nv = prep.Minv.shape[:2]
    return AnchoredPack(
        planes=torch.stack(planes).contiguous(),
        screws=prep.screw.permute(2, 0, 1).contiguous(),
        minv2=prep.Minv.reshape(B, nv * nv).contiguous(),
        active=prep.active,
    )


def solve_anchored(pack: AnchoredPack, maps: SlotMaps, bias, qd, lv, av,
                   warm_lam3, params: SolverParams):
    """All sweeps of one anchored solve. warm_lam3: 3 x [B, C] impulses of the
    previous substep in the frozen basis. Returns (qd, lv, av, lam3)."""
    planes = pack.planes
    mu = planes[BASE["mu"]]
    ln = torch.clamp(warm_lam3[0], min=0.0)
    lt1, lt2 = warm_lam3[1], warm_lam3[2]
    fmag = torch.sqrt(lt1 * lt1 + lt2 * lt2)
    fmax = mu * ln
    sc = torch.where(fmag > fmax, fmax / torch.clamp(fmag, min=1e-9), torch.ones_like(fmag))
    w = params.warm_start * pack.active
    lam0 = torch.stack([w * ln, w * lt1 * sc, w * lt2 * sc])
    obj = torch.stack([lv[..., 0], lv[..., 1], lv[..., 2],
                       av[..., 0], av[..., 1], av[..., 2]]).contiguous()
    qd_o, obj_o, lam_o = sweep_op.contact_sweep(
        planes, bias.contiguous(), pack.screws, qd.contiguous(), pack.minv2,
        obj, lam0, maps.anc_slot, maps.groups, maps.obj_idx, maps.signs,
        params.iterations, params.relaxation, apply_warm=params.warm_start > 0.0,
    )
    if maps.signs:
        lv = obj_o[0:3].permute(1, 2, 0)
        av = obj_o[3:6].permute(1, 2, 0)
    return qd_o, lv, av, (lam_o[0], lam_o[1], lam_o[2])


def anchored_vn(pack: AnchoredPack, maps: SlotMaps, qd, lv, av):
    """Normal relative velocity [B, C] at the frozen anchors."""
    planes, screws = pack.planes, pack.screws
    ancT = maps.anc_slot.T
    wx, wy, wz, lx, ly, lz = ((screws[a] * qd) @ ancT for a in range(6))
    px, py, pz = (planes[i] for i in BASE["pos"])
    vx = lx + wy * pz - wz * py
    vy = ly + wz * px - wx * pz
    vz = lz + wx * py - wy * px
    for s, (sg, oh) in enumerate(zip(maps.signs, maps.side_onehot)):
        base = NBASE + s * NSIDE
        rx, ry, rz = planes[base], planes[base + 1], planes[base + 2]
        ox = [lv[..., i] @ oh.T for i in range(3)]
        aw = [av[..., i] @ oh.T for i in range(3)]
        vx = vx + sg * (ox[0] + aw[1] * rz - aw[2] * ry)
        vy = vy + sg * (ox[1] + aw[2] * rx - aw[0] * rz)
        vz = vz + sg * (ox[2] + aw[0] * ry - aw[1] * rx)
    nx, ny, nz = (planes[i] for i in BASE["n"])
    return vx * nx + vy * ny + vz * nz


def anchored_impulse_world(pack: AnchoredPack, lam3):
    """World-frame impulse [B, C, 3] from basis components."""
    p = pack.planes
    n, t1, t2 = ([p[i] for i in BASE[k]] for k in ("n", "t1", "t2"))
    return torch.stack(
        [lam3[0] * n[i] + lam3[1] * t1[i] + lam3[2] * t2[i] for i in range(3)],
        dim=-1,
    )


# --- the general solve: solve_prepared, solve_contacts -----------------------


class SolverOut(NamedTuple):
    qd: torch.Tensor  # [B, nv]
    obj_linvel: torch.Tensor  # [B, K, 3]
    obj_angvel: torch.Tensor  # [B, K, 3]
    impulse: torch.Tensor  # [B, C, 3] accumulated impulses, world frame


def rel_velocity(prep: Prep, maps: SlotMaps, qd, lv, av):
    """World relative velocity at every slot (A side minus B side): [B, C, 3].
    The robot side from the dof -> slot coupling `anc_slot`."""
    bvc = torch.einsum("cu,bua->bca", maps.anc_slot, prep.screw * qd[..., None])
    v = bvc[..., 3:] + cross(bvc[..., :3], prep.pos)
    for sg, kidx, mask, (r, _, _) in zip(maps.signs, maps.side_kidx, maps.side_mask,
                                         prep.sides):
        v = v + sg * (lv[:, kidx] + cross(av[:, kidx], r)) * mask[None, :, None]
    return v


def apply_impulses(prep: Prep, maps: SlotMaps, qd, lv, av, dP):
    """Apply world impulses dP [B, C, 3] (+ to the robot and side a, - to
    side b): the robot's through generalized impulses and Minv."""
    f = torch.cat([cross(prep.pos, dP), dP], dim=-1)  # [B, C, 6]
    W = torch.einsum("cu,bca->bua", maps.anc_slot, f)  # [B, nv, 6]
    gi = torch.sum(prep.screw * W, dim=-1)
    qd = qd + torch.einsum("buv,bv->bu", prep.Minv, gi)
    for sg, mask, oh, (r, Iinv_c, invm_c) in zip(maps.signs, maps.side_mask,
                                                 maps.side_onehot, prep.sides):
        dPm = dP * mask[None, :, None]
        lv = lv + sg * torch.einsum("bci,ck->bki", dPm * invm_c[..., None], oh)
        dw = torch.einsum("bcij,bcj->bci", Iinv_c, cross(r, dPm))
        av = av + sg * torch.einsum("bci,ck->bki", dw, oh)
    return qd, lv, av


def _cone(ln, lt1, lt2, mu):
    """The friction-disk scale of tangential impulses (1 inside the cone)."""
    fmag = torch.sqrt(lt1 * lt1 + lt2 * lt2)
    fmax = mu * ln
    return torch.where(fmag > fmax, fmax / torch.clamp(fmag, min=1e-9), torch.ones_like(fmag))


def project(prep: Prep, lam, v):
    """One projected update of the accumulated impulses lam [B, C, 3] (n, t1,
    t2) given the slot velocities v: the new lambda before relaxation."""
    vn, vt1, vt2 = (torch.sum(v * prep.basis[:, :, d], dim=-1) for d in range(3))
    new_n = torch.clamp(lam[..., 0] + (prep.bias - vn) * prep.inv_d[..., 0], min=0.0)
    ft1 = lam[..., 1] - vt1 * prep.inv_d[..., 1]
    ft2 = lam[..., 2] - vt2 * prep.inv_d[..., 2]
    sc = _cone(new_n, ft1, ft2, prep.mu)
    return torch.stack([new_n, ft1 * sc, ft2 * sc], dim=-1)


def solve_jacobi(prep: Prep, maps: SlotMaps, qd, lv, av, lam, params: SolverParams):
    """The [B, C, 3] relaxed-Jacobi sweeps (`jacobi_impl` other than "soa")."""
    gate = (prep.active * prep.split)[..., None]
    for _ in range(params.iterations):
        lam_new = project(prep, lam, rel_velocity(prep, maps, qd, lv, av))
        dlam = params.relaxation * (lam_new - lam) * gate
        lam = lam + dlam
        dP = torch.einsum("bcd,bcdi->bci", dlam, prep.basis)
        qd, lv, av = apply_impulses(prep, maps, qd, lv, av, dP)
    return qd, lv, av, lam


def solve_gs(prep: Prep, maps: SlotMaps, qd, lv, av, lam, params: SolverParams):
    """Sequential impulses, one slot at a time in slot order (`mode="gs"`):
    a Python loop over the slots, as the JAX package's scan over them."""
    C = prep.active.shape[1]
    sides = [(sg, kidx.tolist(), mask.tolist(), r, Iinv_c, invm_c)
             for sg, kidx, mask, (r, Iinv_c, invm_c)
             in zip(maps.signs, maps.side_kidx, maps.side_mask, prep.sides)]
    lam = list(lam.unbind(1))
    lvs, avs = list(lv.unbind(1)), list(av.unbind(1))  # per object
    for _ in range(params.iterations):
        for c in range(C):
            basis_c = prep.basis[:, c]  # [B, 3, 3]
            v = torch.einsum("biv,bv->bi", prep.J[:, c], qd)
            # a side the slot lacks adds nothing (the JAX package adds it
            # times a zero mask)
            for sg, kidx, mask, r, _, _ in sides:
                if mask[c]:
                    k = kidx[c]
                    v = v + sg * (lvs[k] + cross(avs[k], r[:, c]))
            vn, vt1, vt2 = (torch.sum(v * basis_c[:, d], dim=-1) for d in range(3))
            lam_c = lam[c]
            new_n = torch.clamp(lam_c[:, 0] + (prep.bias[:, c] - vn) * prep.inv_d[:, c, 0],
                                min=0.0)
            ft1 = lam_c[:, 1] - vt1 * prep.inv_d[:, c, 1]
            ft2 = lam_c[:, 2] - vt2 * prep.inv_d[:, c, 2]
            sc = _cone(new_n, ft1, ft2, prep.mu[:, c])
            dlam = (torch.stack([new_n, ft1 * sc, ft2 * sc], dim=-1) - lam_c) \
                * prep.active[:, c, None]
            lam[c] = lam_c + dlam
            dP = torch.einsum("bd,bdi->bi", dlam, basis_c)
            qd = qd + torch.einsum("bvi,bi->bv", prep.MinvJT[:, c], dP)
            for sg, kidx, mask, r, Iinv_c, invm_c in sides:
                if mask[c]:
                    k = kidx[c]
                    lvs[k] = lvs[k] + sg * dP * invm_c[:, c, None]
                    avs[k] = avs[k] + sg * torch.einsum("bij,bj->bi", Iinv_c[:, c],
                                                        cross(r[:, c], dP))
    if lvs:
        lv, av = torch.stack(lvs, dim=1), torch.stack(avs, dim=1)
    return qd, lv, av, torch.stack(lam, dim=1)


def solve_jacobi_soa(prep: Prep, maps: SlotMaps, qd, lv, av, params: SolverParams,
                     warm_lam=None):
    """The [B, C]-plane Jacobi solve: the restitution bias from the pre-solve
    normal velocity, the world-frame warm start `warm_lam` [B, C, 3]
    reprojected onto this basis, clipped to the cone and applied, then
    every sweep through the sweep op with `apply_warm=False`. Returns (qd,
    lv, av, world impulses)."""
    pack = anchored_pack(prep)
    P = pack.planes
    n, t1, t2 = ([P[i] for i in BASE[k]] for k in ("n", "t1", "t2"))
    B, C = prep.bias.shape
    bias = prep.bias
    if params.restitution > 0.0:
        vn0 = anchored_vn(pack, maps, qd, lv, av)
        bounce = params.restitution * torch.where(vn0 < -params.restitution_threshold, -vn0,
                                                  torch.zeros_like(vn0))
        bias = torch.maximum(bias, bounce)
    if maps.signs:
        obj = torch.stack([lv[..., 0], lv[..., 1], lv[..., 2],
                           av[..., 0], av[..., 1], av[..., 2]]).contiguous()
    else:
        obj = qd.new_zeros(6, B, 1)
    if warm_lam is None or params.warm_start <= 0.0:
        lam = qd.new_zeros(3, B, C)
    else:
        w = [warm_lam[..., i] for i in range(3)]
        ln = torch.clamp(w[0] * n[0] + w[1] * n[1] + w[2] * n[2], min=0.0)
        lt1 = w[0] * t1[0] + w[1] * t1[1] + w[2] * t1[2]
        lt2 = w[0] * t2[0] + w[1] * t2[1] + w[2] * t2[2]
        sc = _cone(ln, lt1, lt2, prep.mu)
        ws, act = params.warm_start, prep.active
        lam = torch.stack([ws * ln * act, ws * lt1 * sc * act, ws * lt2 * sc * act])
        dP0 = tuple(lam[0] * n[i] + lam[1] * t1[i] + lam[2] * t2[i] for i in range(3))
        qd, obj = sweep_op.apply_impulse_plain(P, pack.screws, qd, pack.minv2, obj,
                                               maps.anc_slot, maps.obj_idx, maps.signs, dP0)
    # the JAX package's `_use_pallas_sweeps` with "on the TPU" read as on
    # CUDA and CPU tensors alike (the op takes its plain version on the
    # CPU); a scene past the kernel's size limits raises in the op
    qd, obj, lam = sweep_op.contact_sweep(
        P, bias.contiguous(), pack.screws, qd.contiguous(), pack.minv2, obj.contiguous(),
        lam.contiguous(), maps.anc_slot, maps.groups, maps.obj_idx, maps.signs,
        params.iterations, params.relaxation, apply_warm=False)
    if maps.signs:
        lv, av = obj[0:3].permute(1, 2, 0), obj[3:6].permute(1, 2, 0)
    return qd, lv, av, anchored_impulse_world(pack, lam)


def solve_prepared(prep: Prep, maps: SlotMaps, qd, obj_linvel, obj_angvel,
                   params: SolverParams, warm_lam=None) -> SolverOut:
    """The impulse iterations against a prepared contact set; `warm_lam`
    [B, C, 3]: the previous solve's world-frame impulses."""
    B, C = prep.active.shape
    if params.mode == "jacobi" and params.jacobi_impl == "soa":
        return SolverOut(*solve_jacobi_soa(prep, maps, qd, obj_linvel, obj_angvel, params,
                                           warm_lam))
    if params.mode not in ("jacobi", "gs"):
        raise ValueError(params.mode)
    if params.restitution > 0.0:
        # the bounce from the pre-solve (and pre-warm-start) approach speed
        vn0 = torch.sum(rel_velocity(prep, maps, qd, obj_linvel, obj_angvel)
                        * prep.basis[:, :, 0], dim=-1)
        bounce = params.restitution * torch.where(vn0 < -params.restitution_threshold, -vn0,
                                                  torch.zeros_like(vn0))
        prep = replace(prep, bias=torch.maximum(prep.bias, bounce))
    if warm_lam is None or params.warm_start <= 0.0:
        lam0 = qd.new_zeros(B, C, 3)
    else:
        # the world impulse onto this basis, clipped to the cone, re-applied
        ln, lt1, lt2 = (torch.sum(warm_lam * prep.basis[:, :, d], dim=-1) for d in range(3))
        ln = torch.clamp(ln, min=0.0)
        sc = _cone(ln, lt1, lt2, prep.mu)
        lam0 = params.warm_start * torch.stack([ln, lt1 * sc, lt2 * sc], dim=-1) \
            * prep.active[..., None]
        dP0 = torch.einsum("bcd,bcdi->bci", lam0, prep.basis)
        qd, obj_linvel, obj_angvel = apply_impulses(prep, maps, qd, obj_linvel, obj_angvel, dP0)
    solve = solve_jacobi if params.mode == "jacobi" else solve_gs
    qd, lv, av, lam = solve(prep, maps, qd, obj_linvel, obj_angvel, lam0, params)
    return SolverOut(qd, lv, av, torch.einsum("bcd,bcdi->bci", lam, prep.basis))


def solve_contacts(m: ModelArrays, fk: FK, Minv, maps: SlotMaps, slots: ContactSlots,
                   contacts: Contacts, shapes, obj_pos, obj_quat, qd, obj_linvel,
                   obj_angvel, h: float, params: SolverParams = SolverParams(),
                   warm_lam=None, mass_scale=None, friction_scale=None) -> SolverOut:
    """`prepare`, then `solve_prepared`: one whole contact solve."""
    prep = prepare(m, fk, Minv, maps, slots, contacts, shapes, obj_pos, obj_quat, h, params,
                   mass_scale=mass_scale, friction_scale=friction_scale)
    return solve_prepared(prep, maps, qd, obj_linvel, obj_angvel, params, warm_lam)
