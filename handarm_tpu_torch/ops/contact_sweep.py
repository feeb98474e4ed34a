"""All relaxed-Jacobi sweeps of one anchored contact solve.

Counterpart of handarm_tpu/ops/contact_sweep.py (`fused_jacobi_sweeps`,
the Pallas `_sweep_kernel`) with `apply_warm`: the same update order and
the same projection. On CUDA tensors the hand-written kernel in
csrc/contact_sweep.cu runs (one thread block per env, one thread per slot,
reductions over per-link and per-object slot groups); on CPU tensors the
plain version below runs, a tensor transcription of the same sweeps (the
counterpart of `solver._solve_jacobi_soa`).

Inputs keep the JAX package's layout: planes [NP, B, C] stacked as BASE
then NSIDE planes per object side, bias [B, C], screws [6, B, nv], qd
[B, nv], minv2 [B, nv*nv] (row-major Minv), obj [6, B, K] (linear then
angular velocity), lam0 [3, B, C]. The slot couplings come as `anc`
[C, nv] (0/1, plain version), `obj_idx` [S, C] int32 (object of each side,
-1 where the slot has none; `signs` gives +1 / -1 per side) and, for the
kernel, the `SlotGroups` tables built by physics/solver.py
`build_slot_groups`. A scene without objects (K = 0) has no sides (S = 0):
obj is [6, B, 0], and the solve touches the robot alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from handarm_tpu_torch.ops import build

BASE = dict(n=(0, 1, 2), t1=(3, 4, 5), t2=(6, 7, 8), pos=(9, 10, 11),
            mu=12, inv_d=(13, 14, 15), gate=16)
NBASE = 17
NSIDE = 10  # r(3) + Iinv sym(6) + invm(1)

MAX_DOFS = 64  # dofs a mask holds: one 64-bit word
MAX_LINKS = 64  # distinct dof masks; a kinematic tree has at most nv

launches = 0  # kernel launches since the last reset (CUDA path only)


class SlotGroups(NamedTuple):
    """A scene's static slot groups on its device: one group per distinct
    nonzero dof mask (a hand link) and one per (side, object) bin, each an
    ascending CSR list of slots. The masks are int64 (bit u: dof u, up to
    MAX_DOFS), every other table int32."""

    link_bits: torch.Tensor  # [L] int64, the distinct nonzero dof masks
    slot_link: torch.Tensor  # [C] group of each slot's mask, -1 without a robot dof
    link_ptr: torch.Tensor  # [L + 1] offsets of each group's slots in link_slots
    link_slots: torch.Tensor  # [NL]
    obj_ptr: torch.Tensor  # [S * K + 1] offsets of bin q * K + k in obj_slots
    obj_slots: torch.Tensor  # [NO]


def check_groups(groups: SlotGroups, C: int, device, who: str,
                 bins: tuple[int, int] | None = None) -> None:
    """Raise unless the tables have the shapes and types the kernels take:
    the masks (int64) and each slot's group, and with `bins` = (S, K) the
    slot lists (int32)."""
    L = groups.link_bits.shape[0]
    expect = {"link_bits": (L,), "slot_link": (C,)}
    if bins is not None:
        expect.update(link_ptr=(L + 1,), link_slots=(groups.link_slots.shape[0],),
                      obj_ptr=(bins[0] * bins[1] + 1,), obj_slots=(groups.obj_slots.shape[0],))
    for name, shape in expect.items():
        t = getattr(groups, name)
        dtype = torch.int64 if name == "link_bits" else torch.int32
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{who}: groups.{name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {shape} {dtype} contiguous on {device}")
    if L > MAX_LINKS:
        raise ValueError(f"{who}: {L} distinct dof masks, the kernels take {MAX_LINKS}")
    if bins is not None and (groups.link_slots.shape[0] > C
                             or groups.obj_slots.shape[0] > bins[0] * C):
        raise ValueError(f"{who}: slot lists longer than the slots they group")


def contact_sweep(planes, bias, screws, qd, minv2, obj, lam0, anc, groups,
                  obj_idx, signs, iterations: int, omega: float,
                  apply_warm: bool = True):
    """Returns (qd [B, nv], obj [6, B, K], lam [3, B, C]). CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if planes.device.type == "cpu":
        return contact_sweep_plain(planes, bias, screws, qd, minv2, obj, lam0,
                                   anc, obj_idx, signs, iterations, omega,
                                   apply_warm)
    return contact_sweep_cuda(planes, bias, screws, qd, minv2, obj, lam0,
                              groups, obj_idx, signs, iterations, omega,
                              apply_warm)


class _Soa(NamedTuple):
    """The planes of one solve, unpacked for the plain version."""

    n: tuple  # 3 x [B, C]
    t1: tuple
    t2: tuple
    pos: tuple
    mu: torch.Tensor
    inv_d: tuple
    gate: torch.Tensor
    sides: list  # per side: (sign, r (3), Iinv sym (6), invm, onehot [C, K])
    screws: list  # 6 x [B, nv]
    anc: torch.Tensor  # [C, nv]
    Minv: torch.Tensor  # [B, nv, nv]


def _soa(planes, screws, minv2, anc, obj_idx, signs, K: int) -> _Soa:
    _, B, C = planes.shape
    nv = screws.shape[2]
    P = lambda k: planes[k]
    kk = torch.arange(K, device=planes.device)
    sides = []
    for s, sg in enumerate(signs):
        b = NBASE + s * NSIDE
        onehot = (obj_idx[s].long()[:, None] == kk[None]).to(planes.dtype)
        sides.append((sg, (P(b), P(b + 1), P(b + 2)),
                      tuple(P(b + 3 + i) for i in range(6)), P(b + 9), onehot))
    return _Soa(
        n=tuple(P(k) for k in BASE["n"]), t1=tuple(P(k) for k in BASE["t1"]),
        t2=tuple(P(k) for k in BASE["t2"]), pos=tuple(P(k) for k in BASE["pos"]),
        mu=P(BASE["mu"]), inv_d=tuple(P(k) for k in BASE["inv_d"]), gate=P(BASE["gate"]),
        sides=sides, screws=[screws[a] for a in range(6)], anc=anc,
        Minv=minv2.reshape(B, nv, nv),
    )


def _rel_velocity(s: _Soa, qd, lv, av):
    """Relative velocity components (A side minus B side): 3 x [B, C]."""
    ancT = s.anc.T
    px, py, pz = s.pos
    wx, wy, wz, lx, ly, lz = ((s.screws[a] * qd) @ ancT for a in range(6))
    vx = lx + wy * pz - wz * py
    vy = ly + wz * px - wx * pz
    vz = lz + wx * py - wy * px
    for sg, (rx, ry, rz), _, _, oh in s.sides:
        ox = [lv[i] @ oh.T for i in range(3)]
        aw = [av[i] @ oh.T for i in range(3)]
        vx = vx + sg * (ox[0] + aw[1] * rz - aw[2] * ry)
        vy = vy + sg * (ox[1] + aw[2] * rx - aw[0] * rz)
        vz = vz + sg * (ox[2] + aw[0] * ry - aw[1] * rx)
    return vx, vy, vz


def _apply_impulse(s: _Soa, qd, lv, av, dP):
    """Apply world impulse components dP (3 x [B, C]): + to the robot and
    side a, - to side b."""
    dPx, dPy, dPz = dP
    px, py, pz = s.pos
    sc = s.screws
    mx = py * dPz - pz * dPy
    my = pz * dPx - px * dPz
    mz = px * dPy - py * dPx
    T = [c @ s.anc for c in (mx, my, mz, dPx, dPy, dPz)]
    gi = (sc[0] * T[0] + sc[1] * T[1] + sc[2] * T[2]
          + sc[3] * T[3] + sc[4] * T[4] + sc[5] * T[5])
    qd = qd + torch.sum(s.Minv * gi[:, None, :], dim=-1)
    for sg, (rx, ry, rz), (ixx, ixy, ixz, iyy, iyz, izz), invm, oh in s.sides:
        lv = [lv[i] + sg * ((dP[i] * invm) @ oh) for i in range(3)]
        tx = ry * dPz - rz * dPy
        ty = rz * dPx - rx * dPz
        tz = rx * dPy - ry * dPx
        dw = (ixx * tx + ixy * ty + ixz * tz,
              ixy * tx + iyy * ty + iyz * tz,
              ixz * tx + iyz * ty + izz * tz)
        av = [av[i] + sg * (dw[i] @ oh) for i in range(3)]
    return qd, lv, av


def apply_impulse_plain(planes, screws, qd, minv2, obj, anc, obj_idx, signs, dP):
    """The plain version's impulse application on its own: world impulse
    components dP (3 x [B, C]) through the planes' couplings. Returns
    (qd [B, nv], obj [6, B, K]); the warm start of a solve whose sweeps
    run with `apply_warm=False`."""
    s = _soa(planes, screws, minv2, anc, obj_idx, signs, obj.shape[2])
    qd, lv, av = _apply_impulse(s, qd, [obj[i] for i in range(3)],
                                [obj[3 + i] for i in range(3)], dP)
    return qd, torch.stack(lv + av)


def contact_sweep_plain(planes, bias, screws, qd, minv2, obj, lam0, anc,
                        obj_idx, signs, iterations: int, omega: float,
                        apply_warm: bool = True):
    s = _soa(planes, screws, minv2, anc, obj_idx, signs, obj.shape[2])
    nx, ny, nz = s.n
    t1x, t1y, t1z = s.t1
    t2x, t2y, t2z = s.t2
    id0, id1, id2 = s.inv_d
    lv = [obj[i] for i in range(3)]
    av = [obj[3 + i] for i in range(3)]
    lam = [lam0[i] for i in range(3)]

    if apply_warm:
        dP0 = (lam[0] * nx + lam[1] * t1x + lam[2] * t2x,
               lam[0] * ny + lam[1] * t1y + lam[2] * t2y,
               lam[0] * nz + lam[1] * t1z + lam[2] * t2z)
        qd, lv, av = _apply_impulse(s, qd, lv, av, dP0)

    for _ in range(iterations):
        vx, vy, vz = _rel_velocity(s, qd, lv, av)
        vn = vx * nx + vy * ny + vz * nz
        vt1 = vx * t1x + vy * t1y + vz * t1z
        vt2 = vx * t2x + vy * t2y + vz * t2z
        new_n = torch.clamp(lam[0] + (bias - vn) * id0, min=0.0)
        ft1 = lam[1] - vt1 * id1
        ft2 = lam[2] - vt2 * id2
        fmag = torch.sqrt(ft1 * ft1 + ft2 * ft2)
        fmax = s.mu * new_n
        scale = torch.where(fmag > fmax, fmax / torch.clamp(fmag, min=1e-9),
                            torch.ones_like(fmag))
        new = (new_n, ft1 * scale, ft2 * scale)
        dlam = [omega * (new[i] - lam[i]) * s.gate for i in range(3)]
        lam = [lam[i] + dlam[i] for i in range(3)]
        dP = (dlam[0] * nx + dlam[1] * t1x + dlam[2] * t2x,
              dlam[0] * ny + dlam[1] * t1y + dlam[2] * t2y,
              dlam[0] * nz + dlam[1] * t1z + dlam[2] * t2z)
        qd, lv, av = _apply_impulse(s, qd, lv, av, dP)

    return qd, torch.stack(lv + av), torch.stack(lam)


def contact_sweep_cuda(planes, bias, screws, qd, minv2, obj, lam0, groups,
                       obj_idx, signs, iterations: int, omega: float,
                       apply_warm: bool = True):
    global launches
    NP, B, C = planes.shape
    nv = qd.shape[1]
    K = obj.shape[2]
    S = len(signs)
    expect = {
        "planes": (planes, (NBASE + NSIDE * S, B, C), torch.float32),
        "bias": (bias, (B, C), torch.float32),
        "screws": (screws, (6, B, nv), torch.float32),
        "qd": (qd, (B, nv), torch.float32),
        "minv2": (minv2, (B, nv * nv), torch.float32),
        "obj": (obj, (6, B, K), torch.float32),
        "lam0": (lam0, (3, B, C), torch.float32),
        "obj_idx": (obj_idx, (S, C), torch.int32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != planes.device or t.device.type != "cuda":
            raise ValueError(f"contact_sweep_cuda: {name} on {t.device}, "
                             f"expected the CUDA device of planes")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"contact_sweep_cuda: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"contact_sweep_cuda: {name} is not contiguous")
    # K = 0 (no objects, the classic tasks' craft) only without object sides
    if not (1 <= nv <= MAX_DOFS and (1 if S else 0) <= K <= 8 and S <= 2 and C <= 1024):
        raise ValueError(f"contact_sweep_cuda: unsupported sizes nv={nv} K={K} "
                         f"sides={S} C={C}")
    check_groups(groups, C, planes.device, "contact_sweep_cuda", bins=(S, K))
    qd_out = torch.empty_like(qd)
    obj_out = torch.empty_like(obj)
    lam_out = torch.empty_like(lam0)
    if B == 0:
        return qd_out, obj_out, lam_out
    sign_bits = sum(1 << s for s, sg in enumerate(signs) if sg < 0)
    lib = build.library()
    err = lib.contact_sweep_f32(
        planes.data_ptr(), bias.data_ptr(), screws.data_ptr(), qd.data_ptr(),
        minv2.data_ptr(), obj.data_ptr(), lam0.data_ptr(),
        groups.link_bits.data_ptr(), groups.slot_link.data_ptr(),
        groups.link_ptr.data_ptr(), groups.link_slots.data_ptr(), obj_idx.data_ptr(),
        groups.obj_ptr.data_ptr(), groups.obj_slots.data_ptr(),
        qd_out.data_ptr(), obj_out.data_ptr(), lam_out.data_ptr(),
        B, C, nv, K, S, groups.link_bits.shape[0], groups.link_slots.shape[0],
        groups.obj_slots.shape[0], sign_bits, int(iterations), float(omega),
        int(bool(apply_warm)), torch.cuda.current_stream(planes.device).cuda_stream,
    )
    build.check(err, "contact_sweep_f32")
    launches += 1
    return qd_out, obj_out, lam_out


def launch_info(C: int, nv: int, K: int, S: int, groups: SlotGroups) -> dict:
    """The kernel's launch at these sizes: threads per block, dynamic shared
    bytes and resident blocks per SM (CUDA's occupancy calculator)."""
    info = (ctypes.c_int * 3)()
    build.check(build.library().contact_sweep_launch_info(
        C, nv, K, S, groups.link_bits.shape[0], groups.link_slots.shape[0],
        groups.obj_slots.shape[0], info), "contact_sweep_launch_info")
    return dict(threads=info[0], shared_bytes=info[1], blocks_per_sm=info[2])
