"""Batched relaxed-Jacobi contact solver, anchored-substep form (counterpart
of handarm_tpu/physics/solver.py on the lift path).

Per sim step `prepare` (or `refresh_prep` against frozen mass terms)
builds the solver quantities, `anchored_pack` lays them out as [B, C]
planes once, and every substep `solve_anchored` runs all the sweeps of one
solve through `ops.contact_sweep` (a CUDA kernel on the card). The depth
advance `anchored_vn` stays plain tensor code and reads the post-clamp
velocities.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import cross
from handarm_tpu_torch.ops import contact_sweep as sweep_op
from handarm_tpu_torch.ops import prep_deff as deff_op
from handarm_tpu_torch.ops.contact_sweep import BASE, NBASE, NSIDE, SlotGroups
from handarm_tpu_torch.physics.contacts import Contacts, ContactSlots
from handarm_tpu_torch.physics.dynamics import free_body_inv_inertia_world
from handarm_tpu_torch.physics.kinematics import FK, ModelArrays


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
    # robot effective mass: "soa" takes the deff kernel (float32) on CUDA at
    # B * C >= 2^21, as the JAX package does on its TPU, else the chunked
    # chain in prep_dtype; "pallas" takes the deff path at any size (the
    # plain version on the CPU)
    jacobi_impl: str = "soa"


DEFF_KERNEL_MIN_BC = 2 ** 21


@dataclass
class SlotMaps:
    """Static slot couplings, built once per scene from ContactSlots."""

    anc_slot: torch.Tensor  # [C, nv] dof u moves slot c's robot body
    anc_bits: torch.Tensor  # [C] int32 bitmask of anc_slot
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
    per (side, object) bin, each as an ascending CSR list of slots."""
    anc_bits = np.asarray(anc_bits, np.int64)
    obj_idx = np.asarray(obj_idx, np.int64).reshape(-1, anc_bits.shape[0])
    link_bits, inverse = np.unique(anc_bits, return_inverse=True)
    inverse = inverse.reshape(-1) - int(link_bits[0] == 0)
    link_bits = link_bits[link_bits != 0]
    slot_link = np.where(anc_bits != 0, inverse, -1)

    def csr(lists):
        ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
        return ptr, np.concatenate(lists + [np.zeros(0, np.int64)])

    K = max(num_objects, 1)
    link_ptr, link_slots = csr([np.flatnonzero(slot_link == g) for g in range(len(link_bits))])
    # bin q * K + k: the slots whose side q holds object k
    obj_ptr, obj_slots = csr([np.flatnonzero(row == k) for row in obj_idx for k in range(K)])
    i32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)
    return SlotGroups(i32(link_bits), i32(slot_link), i32(link_ptr), i32(link_slots),
                      i32(obj_ptr), i32(obj_slots))


def build_slot_maps(slots: ContactSlots, ancestor_mask: np.ndarray,
                    num_objects: int, dtype=torch.float32,
                    device="cpu") -> SlotMaps:
    C = slots.num_slots
    K = max(num_objects, 1)
    t = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    has_robot = slots.robot_body >= 0
    body = np.where(has_robot, slots.robot_body, 0)
    anc = np.asarray(ancestor_mask)[body] * has_robot[:, None]
    if anc.shape[1] > 31:
        raise ValueError("the sweep kernel's slot bitmask holds at most 31 dofs")
    bits = (anc > 0).astype(np.int64) @ (1 << np.arange(anc.shape[1]))
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
        anc_slot=t(anc), anc_bits=t(bits, torch.int32), robot_mask=t(has_robot),
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


def _contact_bias(depth, h: float, params: SolverParams):
    return torch.where(
        depth >= 0.0,
        torch.clamp(params.baumgarte / h * torch.clamp(depth - params.slop, min=0.0),
                    max=params.max_depenetration_vel),
        depth / h,
    )


def use_deff_kernel(params: SolverParams, B: int, C: int, device) -> bool:
    """The gate of handarm_tpu/physics/solver.py `_prepare`, with the card in
    place of the TPU."""
    if params.jacobi_impl == "pallas":
        return True
    if params.jacobi_impl != "soa":
        raise ValueError(f"jacobi_impl {params.jacobi_impl!r} is not ported")
    return torch.device(device).type == "cuda" and B * C >= DEFF_KERNEL_MIN_BC


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
        bias=_contact_bias(contacts.depth, h, params), mu=mu,
        pos=contacts.pos, screw=fk.screw, Minv=Minv, d_eff=d_eff,
        sides=tuple(sides),
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
        bias=_contact_bias(contacts.depth, h, params),
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
