"""Natural cubic splines: host-side coefficient solve + tensor evaluation
(counterpart of handarm_tpu/math/spline.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class CubicSpline:
    """Piecewise cubic y(t) = a + b*dt + c*dt^2 + d*dt^3 on knots[i] <= t."""

    knots: torch.Tensor  # [n]
    a: torch.Tensor  # [n-1]
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor

    def evaluate(self, t: torch.Tensor) -> torch.Tensor:
        """Outside the knot range the boundary polynomial extrapolates."""
        idx = torch.clamp(
            torch.searchsorted(self.knots, t.contiguous(), right=True) - 1,
            0, self.knots.shape[0] - 2,
        )
        dt = t - self.knots[idx]
        return self.a[idx] + dt * (
            self.b[idx] + dt * (self.c[idx] + dt * self.d[idx])
        )

    def to(self, device) -> "CubicSpline":
        return CubicSpline(*(x.to(device) for x in
                             (self.knots, self.a, self.b, self.c, self.d)))


def natural_cubic_spline(x, y, dtype=torch.float32, device="cpu") -> CubicSpline:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    n = len(x)
    if n == 2:
        b = np.array([(y[1] - y[0]) / (x[1] - x[0])])
        return CubicSpline(t(x), t(y[:1]), t(b), t(np.zeros(1)), t(np.zeros(1)))
    h = np.diff(x)
    A = np.zeros((n, n))
    rhs = np.zeros(n)
    A[0, 0] = A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        rhs[i] = 3 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
    c_full = np.linalg.solve(A, rhs)
    a = y[:-1]
    b = (np.diff(y) / h) - h * (2 * c_full[:-1] + c_full[1:]) / 3
    d = np.diff(c_full) / (3 * h)
    return CubicSpline(t(x), t(a), t(b), t(c_full[:-1]), t(d))
