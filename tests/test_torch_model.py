"""Host model compile, kinematics and dynamics: the port against the JAX
package on the inline test URDFs and on the stand-in UR5+SIH.

The compile is numpy on both sides and must give identical arrays. The
batched functions take the same q / qd from a numpy seed; float32 on both
sides, tolerances stated per quantity."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handarm_tpu.physics import dynamics as jd
from handarm_tpu.physics import kinematics as jk
from handarm_tpu.physics.model import compile_urdf as j_compile
from handarm_tpu.robots import ur5sih as j_ur5sih
from handarm_tpu_torch.physics import dynamics as td
from handarm_tpu_torch.physics import kinematics as tk
from handarm_tpu_torch.physics.model import compile_urdf as t_compile
from handarm_tpu_torch.robots import ur5sih as t_ur5sih
from tests.test_dynamics import BRANCHED_TREE, DOUBLE_PENDULUM
from tests.test_engine import TINY_ARM

torch.set_num_threads(1)
STANDIN = t_ur5sih.UR5SIH_URDF
INLINE = {"tiny": TINY_ARM, "dp": DOUBLE_PENDULUM, "tree": BRANCHED_TREE}
MODELS = ["tiny", "dp", "tree", "standin"]
ARRAYS = ("parent", "joint_type", "ancestor_mask", "tree_pos", "tree_quat",
          "axis", "mass", "com", "inertia", "q_min", "q_max", "effort_limit",
          "velocity_limit", "joint_damping", "joint_friction", "armature",
          "body_parent", "body_dof", "dof_body")


@pytest.fixture(scope="module")
def urdf_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("urdf")
    paths = {"standin": STANDIN}
    for name, text in INLINE.items():
        p = d / f"{name}.urdf"
        p.write_text(text)
        paths[name] = str(p)
    return paths


@pytest.mark.parametrize("model", MODELS)
def test_compile_identical(urdf_paths, model):
    a, b = j_compile(urdf_paths[model]), t_compile(urdf_paths[model])
    assert a.joint_names == b.joint_names and a.body_names == b.body_names
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    assert a.sites.keys() == b.sites.keys()
    for k in a.sites:
        assert a.sites[k].body == b.sites[k].body
        np.testing.assert_array_equal(a.sites[k].pos, b.sites[k].pos)
        np.testing.assert_array_equal(a.sites[k].quat, b.sites[k].quat)


def test_standin_spheres_and_cloud_identical():
    """Sphere proxies and the surface cloud fitted to the stand-in's meshes:
    33 hand spheres (3 on each of the 11 hand links)."""
    for fn in ("ur5sih_collision_spheres",):
        for x, y in zip(getattr(j_ur5sih, fn)(STANDIN), getattr(t_ur5sih, fn)(STANDIN)):
            np.testing.assert_array_equal(y, x)
    for x, y in zip(j_ur5sih.ur5sih_surface_cloud(128, STANDIN),
                    t_ur5sih.ur5sih_surface_cloud(128, STANDIN)):
        np.testing.assert_array_equal(y, x)
    bodies = t_ur5sih.ur5sih_collision_spheres(STANDIN)[0]
    assert (bodies >= 6).sum() == 33


def _inputs(nv, B=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.2, 1.2, (B, nv)).astype(np.float32)
    qd = rng.uniform(-2.0, 2.0, (B, nv)).astype(np.float32)
    return q, qd


def _pair(urdf_paths, model):
    art = t_compile(urdf_paths[model])
    jm = jk.model_arrays(j_compile(urdf_paths[model]))
    tm = tk.model_arrays(art)
    base_q = np.array([[0.9, 0.1, -0.2, 0.37]], np.float32)
    base_q /= np.linalg.norm(base_q)
    base_p = np.array([[0.1, -0.2, 0.5]], np.float32)
    return art, jm, tm, base_q, base_p


@pytest.mark.parametrize("model", MODELS)
def test_kinematics_match(urdf_paths, model):
    """FK poses and screws, body velocities, site poses, point Jacobians.
    Tolerance 2e-5: float32 chains of up to 17 joints."""
    art, jm, tm, bq, bp = _pair(urdf_paths, model)
    q, qd = _inputs(art.nv)
    jfk = jk.forward_kinematics(jm, jnp.asarray(q), jnp.asarray(bq), jnp.asarray(bp))
    tfk = tk.forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(bq), torch.as_tensor(bp))
    for a, b in zip(jfk, tfk):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)
    np.testing.assert_allclose(
        tk.body_velocities(tm, tfk, torch.as_tensor(qd)).numpy(),
        np.asarray(jk.body_velocities(jm, jfk, jnp.asarray(qd))), atol=2e-5)
    names = list(art.sites)
    sb, sp, sq = art.site_array(names)
    ws = jk.site_poses(jfk, sb, jnp.asarray(sp, jnp.float32), jnp.asarray(sq, jnp.float32),
                       jnp.broadcast_to(jnp.asarray(bq), (16, 4)),
                       jnp.broadcast_to(jnp.asarray(bp), (16, 3)))
    ts = tk.site_poses(tfk, sb, torch.as_tensor(sp, dtype=torch.float32),
                       torch.as_tensor(sq, dtype=torch.float32), torch.as_tensor(bq),
                       torch.as_tensor(bp))
    for a, b in zip(ws, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)
    rng = np.random.default_rng(1)
    body = rng.integers(0, art.nb, (16, 5))
    pts = rng.normal(size=(16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tk.point_jacobian(tm, tfk, torch.as_tensor(body), torch.as_tensor(pts)).numpy(),
        np.asarray(jk.point_jacobian(jm, jfk, jnp.asarray(body), jnp.asarray(pts))),
        atol=2e-5)


@pytest.mark.parametrize("model", MODELS)
def test_dynamics_match(urdf_paths, model):
    """Mass matrix, bias torques, PD-augmented mass and its inverse (the
    port's plain SPD inverse vs the JAX package's CPU path), stable-PD
    torque. Tolerances relative to each quantity's largest entry: 1e-5 for
    M, Mtilde and bias, 1e-4 for Minv (an inverse at the stand-in's
    conditioning, arm inertia O(1) vs finger armature O(1e-3))."""
    art, jm, tm, bq, bp = _pair(urdf_paths, model)
    q, qd = _inputs(art.nv, seed=2)
    rng = np.random.default_rng(3)
    kp = rng.uniform(5, 120, art.nv).astype(np.float32)
    kd = rng.uniform(1, 20, art.nv).astype(np.float32)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    h = 1.0 / 120.0
    jfk = jk.forward_kinematics(jm, jnp.asarray(q), jnp.asarray(bq), jnp.asarray(bp))
    tfk = tk.forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(bq), torch.as_tensor(bp))
    jdyn = jd.compute_dyn(jm, jfk, jnp.asarray(qd), jnp.asarray(g), jnp.asarray(kp),
                          jnp.asarray(kd), h)
    tdyn = td.compute_dyn(tm, tfk, torch.as_tensor(qd), torch.as_tensor(g),
                          torch.as_tensor(kp), torch.as_tensor(kd), h)
    for name, tol in (("Mtilde", 1e-5), ("bias", 1e-5), ("Minv", 1e-4)):
        want = np.asarray(getattr(jdyn, name))
        got = getattr(tdyn, name).numpy()
        np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), err_msg=name)
    qt = q + 0.1
    eff = np.asarray(jm.effort_limit)
    want = jd.stable_pd_torque(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(qt),
                               jnp.asarray(kp), jnp.asarray(kd), h, jnp.asarray(eff))
    got = td.stable_pd_torque(torch.as_tensor(q), torch.as_tensor(qd), torch.as_tensor(qt),
                              torch.as_tensor(kp), torch.as_tensor(kd), h,
                              torch.as_tensor(np.array(eff), dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_free_body_match():
    """Object integration, gyroscopic increment and world inverse inertia on
    random poses / spins, including a thin body (inertia ratio ~26)."""
    rng = np.random.default_rng(4)
    quat = rng.normal(size=(16, 2, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    w = rng.normal(size=(16, 2, 3)).astype(np.float32) * 20
    v = rng.normal(size=(16, 2, 3)).astype(np.float32)
    pos = rng.normal(size=(16, 2, 3)).astype(np.float32)
    I = np.array([[1e-4, 1e-4, 2e-4], [2.6e-4, 2.6e-4, 1e-5]], np.float32)
    h = 1.0 / 120.0
    J = lambda x: jnp.asarray(x)
    T = lambda x: torch.as_tensor(x)
    for a, b in zip(jd.free_body_integrate(J(pos), J(quat), J(v), J(w), h),
                    td.free_body_integrate(T(pos), T(quat), T(v), T(w), h)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(
        td.gyroscopic_delta(T(quat), T(I), T(w), h).numpy(),
        np.asarray(jd.gyroscopic_delta(J(quat), J(I), J(w), h)), atol=1e-4, rtol=1e-4)
    want = np.asarray(jd.free_body_inv_inertia_world(J(quat), J(I)))
    np.testing.assert_allclose(td.free_body_inv_inertia_world(T(quat), T(I)).numpy(),
                               want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
