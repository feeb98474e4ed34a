"""Batched inverse of small SPD matrices: M [B, n, n] -> M^-1 [B, n, n].

Counterpart of handarm_tpu/ops/spd_inverse.py (`spd_inverse`, the Pallas
`_chol_inv_kernel` plus the caller-side W^T W). On CUDA tensors the
hand-written kernel in csrc/spd_inverse.cu runs: the unrolled Cholesky
with the same rsqrt(max(s, 1e-12)) pivot floor, W = L^-1, and Minv = W^T W,
all in one launch, compiled for the n in `KERNEL_N` only, in three
layouts: one thread per matrix up to n = 18; one warp per matrix (a lane
per row) at n = 23, 24 and 27 (at the even 24 the rows sit 25 words apart
in shared memory); and past a warp's 32 lanes, at n = 46 (the two-arm
AllegroKuka), one block of two warps per matrix, a thread per row, the
matrix in shared memory at rows 47 words apart (`spd_inverse_block_kernel`;
it takes any 33 <= n <= 64 at its own instantiation). On CPU tensors the
plain version runs: a Cholesky
factorization and two triangular solves, as the JAX package does off the
TPU.
"""

from __future__ import annotations

import torch

from handarm_tpu_torch.ops import build

launches = 0  # kernel launches since the last reset (CUDA path only)
# matrix sizes the kernel is instantiated for: the Cartpole, the Ingenuity,
# the Stretch (the Franka, the Trifinger), BallBalance, the Quadcopter and
# the Ant, the Allegro hand, the UR5+SIH, the ANYmal, the KUKA arm with the
# Allegro hand, the Shadow hand, the Humanoid, the two KUKA arms with their
# Allegro hands
KERNEL_N = (2, 8, 9, 12, 14, 16, 17, 18, 23, 24, 27, 46)


def spd_inverse_plain(M: torch.Tensor) -> torch.Tensor:
    n = M.shape[-1]
    L, _ = torch.linalg.cholesky_ex(M)
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    Y = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if M.device.type == "cpu":
        return spd_inverse_plain(M)
    return spd_inverse_cuda(M)


def spd_inverse_cuda(M: torch.Tensor) -> torch.Tensor:
    global launches
    if M.device.type != "cuda":
        raise ValueError(f"spd_inverse_cuda needs a CUDA tensor, got {M.device}")
    if M.dtype != torch.float32:
        raise TypeError(f"spd_inverse_cuda takes float32, got {M.dtype}")
    if M.ndim != 3 or M.shape[1] != M.shape[2] or M.shape[1] not in KERNEL_N:
        raise ValueError(f"spd_inverse_cuda takes [B, n, n] with n in {KERNEL_N} (the "
                         f"kernel's instantiations), got {tuple(M.shape)}")
    if not M.is_contiguous() or M.data_ptr() % 16:
        raise ValueError("spd_inverse_cuda takes a contiguous, 16-byte aligned tensor")
    B, n, _ = M.shape
    out = torch.empty_like(M)
    if B == 0:
        return out
    lib = build.library()
    err = lib.spd_inverse_f32(
        M.data_ptr(), out.data_ptr(), B, n,
        torch.cuda.current_stream(M.device).cuda_stream,
    )
    build.check(err, "spd_inverse_f32")
    launches += 1
    return out
