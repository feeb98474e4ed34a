"""Trilinear sampling of voxel SDF fields (distance + 3 gradient channels)
for every mesh-SDF query of one contact generation, each query against its
own object: p [B, L, 3] -> [B, L, 4].

Counterpart of handarm_tpu/ops/sdf_gather.py (`sdf_sample_pallas`, the
Pallas `_kernel`), which the JAX package launches once per object and
query block: coordinates u = (p - lo) / spacing clamped to [0, R - 1.001],
an 8-corner gather, and the out-of-grid excess (meters) on the distance
channel; the gradient channels stay unnormalized (the caller,
shapes.objects_sdf, normalizes them). Which object a query samples comes
from a static table [Lq, 2] of (position in the row, object), built once
per scene by shapes.sdf_queries; positions the table does not name hold 0.
On CUDA tensors the hand-written kernel in csrc/sdf_gather.cu runs (one
launch for all B * Lq queries); on CPU tensors the plain version runs (a
loop over the objects of physics/sdf.py `sample_sdf_plain`).
"""

from __future__ import annotations

import torch

from handarm_tpu_torch.ops import build
from handarm_tpu_torch.physics.sdf import sample_sdf_plain

launches = 0  # kernel launches since the last reset (CUDA path only)


def sdf_sample_plain(field: torch.Tensor, lo: torch.Tensor, spacing: torch.Tensor,
                     p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The plain version: each object's queries through the per-object
    sampler."""
    out = p.new_zeros(p.shape[:-1] + (field.shape[-1],))
    pos, obj = table[:, 0].long(), table[:, 1].long()
    for k in torch.unique(obj).tolist():
        j = pos[obj == k]
        out[:, j] = sample_sdf_plain(field[k], lo[k], spacing[k], p[:, j])
    return out


def sdf_sample(field: torch.Tensor, lo: torch.Tensor, spacing: torch.Tensor,
               p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """field [K, R, R, R, 4], lo [K, 3], spacing [K], p [B, L, 3], table
    [Lq, 2] int32 of distinct positions -> [B, L, 4]. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if p.device.type == "cpu":
        return sdf_sample_plain(field, lo, spacing, p, table)
    return sdf_sample_cuda(field, lo, spacing, p, table)


def sdf_sample_cuda(field: torch.Tensor, lo: torch.Tensor, spacing: torch.Tensor,
                    p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    global launches
    K, R = field.shape[0], field.shape[1]
    B, L = (p.shape[0], p.shape[1]) if p.ndim == 3 else (-1, -1)
    Lq = table.shape[0] if table.ndim == 2 else -1
    expect = {
        "field": (field, (K, R, R, R, 4), torch.float32),
        "lo": (lo, (K, 3), torch.float32),
        "spacing": (spacing, (K,), torch.float32),
        "p": (p, (B, L, 3), torch.float32),
        "table": (table, (Lq, 2), torch.int32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != p.device or t.device.type != "cuda":
            raise ValueError(f"sdf_sample_cuda: {name} on {t.device}, expected "
                             f"the CUDA device of p")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"sdf_sample_cuda: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sdf_sample_cuda: {name} is not contiguous")
    if R < 2 or field.data_ptr() % 16 or table.data_ptr() % 8:
        raise ValueError("sdf_sample_cuda: the field needs R >= 2 and 16-byte "
                         "alignment, the table 8-byte alignment")
    if B * Lq >= 2 ** 31 or Lq > L:
        raise ValueError(f"sdf_sample_cuda: {B} rows of {Lq} queries in rows of {L}")
    # every position of the row is written when the table names them all
    alloc = torch.empty if Lq == L else torch.zeros
    out = alloc(B, L, 4, dtype=torch.float32, device=p.device)
    if B * Lq == 0:
        return out
    lib = build.library()
    err = lib.sdf_gather_f32(
        field.data_ptr(), lo.data_ptr(), spacing.data_ptr(), p.data_ptr(),
        table.data_ptr(), out.data_ptr(), B, L, Lq, K, R,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    build.check(err, "sdf_gather_f32")
    launches += 1
    return out
