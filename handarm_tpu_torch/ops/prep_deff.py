"""Robot-side effective mass of every contact slot and basis direction:

    d[b, c, d] = v^T Minv v,  v[u] = anc[c, u] * ((s_ang_u x p_c + s_lin_u) . w_d)

Counterpart of handarm_tpu/ops/prep_deff.py (`robot_deff`, the Pallas
`_deff_kernel`), in its layout: screws [6, B, nv] (angular xyz, linear
xyz), pos [3, B, C], basis [9, B, C] (w_0 xyz, w_1 xyz, w_2 xyz), Minv as
[B, nv * nv] (row-major) -> [3, B, C], all float32. The dof mask comes as
`anc` [C, nv] (0/1, plain version) and, for the kernel, as the scene's
`SlotGroups` (ops/contact_sweep.py): the distinct masks and each slot's
mask. On CUDA tensors the hand-written kernel in csrc/prep_deff.cu runs;
on CPU tensors the plain version runs, the chunked tensor chain of
solver._prepare (`deff_chain`) in float32.
"""

from __future__ import annotations

import ctypes

import torch

from handarm_tpu_torch.math.quat import cross
from handarm_tpu_torch.ops import build
from handarm_tpu_torch.ops.contact_sweep import MAX_DOFS, check_groups

launches = 0  # kernel launches since the last reset (CUDA path only)
CHUNK = 128  # slots per step of the plain chain


def deff_chain(screw, pos, basis, anc, Minv, dtype) -> torch.Tensor:
    """d [B, C, 3] from screw [B, nv, 6], pos [B, C, 3], basis [B, C, 3, 3],
    anc [C, nv], Minv [B, nv, nv]; the products in `dtype`. Chunked over the
    slots to bound the [B, chunk, nv, 3] working set."""
    B, C = pos.shape[:2]
    sa, sl = screw[..., :3], screw[..., 3:]
    Minv_pd = Minv.to(dtype)
    out = torch.empty(B, C, 3, dtype=pos.dtype, device=pos.device)
    for c0 in range(0, C, CHUNK):
        c1 = min(C, c0 + CHUNK)
        arm = (cross(sa[:, None], pos[:, c0:c1, None]) + sl[:, None]) \
            * anc[None, c0:c1, :, None]  # [B, ch, nv, 3]
        v = torch.sum(arm[:, :, :, None, :].to(dtype)
                      * basis[:, c0:c1, None].to(dtype), dim=-1)  # [B, ch, nv, 3]
        Minv_v = torch.einsum("buv,bcvd->bcud", Minv_pd, v)
        out[:, c0:c1] = torch.sum(v * Minv_v, dim=2).to(pos.dtype)
    return out


def robot_deff(screws, pos, basis, anc, groups, minv2) -> torch.Tensor:
    """[3, B, C]. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if pos.device.type == "cpu":
        return robot_deff_plain(screws, pos, basis, anc, minv2)
    return robot_deff_cuda(screws, pos, basis, groups, minv2)


def robot_deff_plain(screws, pos, basis, anc, minv2) -> torch.Tensor:
    _, B, nv = screws.shape
    C = pos.shape[2]
    d = deff_chain(screws.permute(1, 2, 0), pos.permute(1, 2, 0),
                   basis.reshape(3, 3, B, C).permute(2, 3, 0, 1), anc,
                   minv2.reshape(B, nv, nv), torch.float32)
    return d.permute(2, 0, 1)


def robot_deff_cuda(screws, pos, basis, groups, minv2) -> torch.Tensor:
    global launches
    _, B, nv = screws.shape
    C = pos.shape[2]
    expect = {
        "screws": (screws, (6, B, nv), torch.float32),
        "pos": (pos, (3, B, C), torch.float32),
        "basis": (basis, (9, B, C), torch.float32),
        "minv2": (minv2, (B, nv * nv), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != pos.device or t.device.type != "cuda":
            raise ValueError(f"robot_deff_cuda: {name} on {t.device}, expected "
                             f"the CUDA device of pos")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"robot_deff_cuda: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"robot_deff_cuda: {name} is not contiguous")
    if not 1 <= nv <= MAX_DOFS:
        raise ValueError(f"robot_deff_cuda: nv={nv}, the dof masks hold 1 to {MAX_DOFS} dofs")
    check_groups(groups, C, pos.device, "robot_deff_cuda")
    out = torch.empty(3, B, C, dtype=torch.float32, device=pos.device)
    if B == 0 or C == 0:
        return out
    lib = build.library()
    err = lib.prep_deff_f32(
        screws.data_ptr(), pos.data_ptr(), basis.data_ptr(),
        groups.link_bits.data_ptr(), groups.slot_link.data_ptr(),
        minv2.data_ptr(), out.data_ptr(), B, C, nv, groups.link_bits.shape[0],
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    build.check(err, "prep_deff_f32")
    launches += 1
    return out


def launch_info(nv: int, L: int) -> dict:
    """The kernel's launch at these sizes: threads per block, dynamic shared
    bytes and resident blocks per SM (CUDA's occupancy calculator)."""
    info = (ctypes.c_int * 3)()
    build.check(build.library().prep_deff_launch_info(nv, L, info), "prep_deff_launch_info")
    return dict(threads=info[0], shared_bytes=info[1], blocks_per_sm=info[2])
