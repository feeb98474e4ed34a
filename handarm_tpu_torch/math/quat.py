"""Batched quaternion math on tensors (counterpart of handarm_tpu/math/quat.py).

Quaternions are stored wxyz (scalar first), unit norm; every function
broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3-vector cross product over the last axis, broadcasting like jnp.cross."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-20) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def safe_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)


def quat_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return safe_normalize(q, eps)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (first b, then a)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v' = v + 2w (u x v) + 2 u x (u x v)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Exponential-map step q' = exp(0.5*omega*dt) * q, renormalized."""
    w = omega * (0.5 * dt)
    angle = safe_norm(w, keepdim=True)
    small = angle < 1e-8
    k = torch.where(
        small,
        1.0 - angle * angle / 6.0,
        torch.sin(angle) / torch.where(small, torch.ones_like(angle), angle),
    )
    dq = torch.cat([torch.cos(angle), k * w], dim=-1)
    return quat_normalize(quat_mul(dq, q))



def quat_to_axis_angle(q: torch.Tensor, eps: float = 1e-8):
    """(axis, angle) with the angle in [0, pi]: the sign of q flips where
    w < 0."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    sin_half = safe_norm(q[..., 1:4])
    angle = 2.0 * torch.atan2(sin_half, q[..., 0])
    axis = q[..., 1:4] / torch.clamp(sin_half[..., None], min=eps)
    return axis, angle


def quat_diff_rad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angular distance between two rotations, in radians."""
    return quat_to_axis_angle(quat_mul(a, quat_conj(b)))[1]
