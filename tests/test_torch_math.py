"""Port math (handarm_tpu_torch.math) against the JAX package, elementwise.

Inputs come from a numpy seed and go through both. float32 on both sides:
tolerance 1e-6 absolute (a handful of rounding steps on O(1) values)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handarm_tpu.math import quat as jq
from handarm_tpu.math import spatial as js
from handarm_tpu.math.spline import natural_cubic_spline as j_spline
from handarm_tpu_torch.math import quat as tq
from handarm_tpu_torch.math import spatial as ts
from handarm_tpu_torch.math.spline import natural_cubic_spline as t_spline

torch.set_num_threads(1)
RNG = np.random.default_rng(0)
N = 64


def _unit_quats(n):
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


Q1, Q2 = _unit_quats(N), _unit_quats(N)
V1 = RNG.normal(size=(N, 3)).astype(np.float32)
V6A, V6B = (RNG.normal(size=(N, 6)).astype(np.float32) for _ in range(2))
ANG = RNG.uniform(-4, 4, N).astype(np.float32)
AXIS = V1 / np.linalg.norm(V1, axis=-1, keepdims=True)

CASES = {
    "quat_mul": ("quat_mul", (Q1, Q2)),
    "quat_conj": ("quat_conj", (Q1,)),
    "quat_rotate": ("quat_rotate", (Q1, V1)),
    "quat_rotate_inv": ("quat_rotate_inv", (Q1, V1)),
    "quat_from_axis_angle": ("quat_from_axis_angle", (AXIS, ANG)),
    "quat_to_matrix": ("quat_to_matrix", (Q1,)),
    "quat_integrate": ("quat_integrate", (Q1, V1 * 5.0, np.float32(1 / 120))),
    "quat_integrate_small": ("quat_integrate", (Q1, V1 * 1e-7, np.float32(1 / 120))),
    "quat_normalize": ("quat_normalize", (Q1 * 3.0,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quat_matches(case):
    name, args = CASES[case]
    want = np.asarray(getattr(jq, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(tq, name)(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name", ["motion_cross", "force_cross"])
def test_spatial_matches(name):
    want = np.asarray(getattr(js, name)(jnp.asarray(V6A), jnp.asarray(V6B)))
    got = getattr(ts, name)(torch.as_tensor(V6A), torch.as_tensor(V6B)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("knots", [2, 4, 8])
def test_spline_matches(knots):
    """Natural cubic spline through servo-like knots, evaluated inside and
    outside the knot range (boundary polynomials extrapolate)."""
    x = np.sort(RNG.uniform(-2000, 2500, knots))
    y = RNG.uniform(-1.6, 0.0, knots)
    t = RNG.uniform(-2500, 3000, 256).astype(np.float32)
    want = np.asarray(j_spline(x, y).evaluate(jnp.asarray(t)))
    got = t_spline(x, y).evaluate(torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
