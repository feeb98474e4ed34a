"""Trilinear sampling of a voxel SDF field (distance + 3 gradient channels)
at body-frame points: p [N, 3] -> [N, 4].

Counterpart of handarm_tpu/ops/sdf_gather.py (`sdf_sample_pallas`, the
Pallas `_kernel`): coordinates u = (p - lo) / spacing clamped to
[0, R - 1.001], an 8-corner gather, and the out-of-grid excess (meters) on
the distance channel; the gradient channels stay unnormalized (the caller,
shapes.object_sdf, normalizes them). On CUDA tensors the hand-written
kernel in csrc/sdf_gather.cu runs (one thread per point, f32 gather from
the [R, R, R, 4] field); on CPU tensors the plain version
(physics/sdf.py `sample_sdf_plain`) runs.
"""

from __future__ import annotations

import torch

from handarm_tpu_torch.ops import build
from handarm_tpu_torch.physics.sdf import sample_sdf_plain

launches = 0  # kernel launches since the last reset (CUDA path only)


def sdf_sample(field: torch.Tensor, lo: torch.Tensor, spacing: torch.Tensor,
               p: torch.Tensor) -> torch.Tensor:
    """field [R, R, R, 4], lo [3], spacing [1], p [N, 3] -> [N, 4]. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if p.device.type == "cpu":
        return sample_sdf_plain(field, lo, spacing.reshape(()), p)
    return sdf_sample_cuda(field, lo, spacing, p)


def sdf_sample_cuda(field: torch.Tensor, lo: torch.Tensor, spacing: torch.Tensor,
                    p: torch.Tensor) -> torch.Tensor:
    global launches
    R = field.shape[0]
    N = p.shape[0] if p.ndim == 2 else -1
    expect = {
        "field": (field, (R, R, R, 4)),
        "lo": (lo, (3,)),
        "spacing": (spacing, (1,)),
        "p": (p, (N, 3)),
    }
    for name, (t, shape) in expect.items():
        if t.device != p.device or t.device.type != "cuda":
            raise ValueError(f"sdf_sample_cuda: {name} on {t.device}, expected "
                             f"the CUDA device of p")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"sdf_sample_cuda: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} float32")
        if not t.is_contiguous():
            raise ValueError(f"sdf_sample_cuda: {name} is not contiguous")
    if R < 2 or field.data_ptr() % 16:
        raise ValueError("sdf_sample_cuda: the field needs R >= 2 and 16-byte alignment")
    out = torch.empty(N, 4, dtype=torch.float32, device=p.device)
    if N == 0:
        return out
    lib = build.library()
    err = lib.sdf_gather_f32(
        field.data_ptr(), lo.data_ptr(), spacing.data_ptr(), p.data_ptr(),
        out.data_ptr(), N, R, torch.cuda.current_stream(p.device).cuda_stream,
    )
    build.check(err, "sdf_gather_f32")
    launches += 1
    return out
