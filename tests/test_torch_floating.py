"""The floating base and MJCF: the port against the JAX package on the CPU.

- `parse_mjcf` / `compile_mjcf` of the Quadcopter's and Ingenuity's inline
  MJCFs: the documents, links, joints, extras and link spheres equal
  exactly, the compiled floats and model arrays within 1e-6.
- Floating FK, `body_velocities`, the COM mass matrix and bias forces and
  `compute_dyn` on tests/test_floating.py's `flyer` and `brick` URDFs
  (read from that file) and on both craft, from random states with the
  base 3 m from the origin: within 1e-5 of each quantity's largest value
  (float32 in two libraries; the base's origin-Plücker coordinates carry
  |p| ~ 3 m lever arms).
- spd_inverse's plain version at n = 14 and 8 against the JAX package's
  fallback and its Pallas kernel in interpret mode (atol 1e-5, the bound
  of tests/test_pallas_ops.py).
- `engine.step` on both craft from states handed to both packages, with a
  thrust torque in `tau_ext`: airborne, grounded (the craft tilted a few
  mm over the ground plane and falling: every env has an active slot and
  impulses flow) and capped (the base 4 m from the origin, spinning past
  the Quadcopter's 4 pi rad/s and moving past 20 m/s: the clamp acts on
  the point velocity, and the env's observation velocity v = qd[:3] + w x p
  agrees there). On each path: the port's fused anchored form (the sweep
  op's plain version on CPU tensors) against the JAX package's generic
  loop (its CPU path); with jacobi_impl="pallas", the port's generic
  anchored loop against the JAX package's Pallas route (the interpreted
  sweep kernel at K = 0); contacts regenerated every substep; and
  `substep` twice (shared_prep=False). Tolerances: 2e-4 on q and the base pose, 2e-3 on velocities and impulses,
  both times max(1, the largest value): the craft weigh 3.4 g (the
  Quadcopter) and 0.1 kg, and far from the origin their mass matrices'
  conditioning (~4e4) brings float32 Cholesky rounding up to ~5e-4 of the
  velocities (measured 2.4e-4 relative here).
- The sweep op's plain version at K = 0, S = 0 on the grounded solve
  against the JAX package's `_solve_jacobi_soa` on the same prep (2e-3
  times max(1, scale)).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.envs import ingenuity as jing
from handarm_tpu.envs import quadcopter as jquad
from handarm_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from handarm_tpu.physics import contacts as jc
from handarm_tpu.physics import dynamics as jdy
from handarm_tpu.physics import engine as je
from handarm_tpu.physics import kinematics as jk
from handarm_tpu.physics import mjcf as jmjcf
from handarm_tpu.physics import model as jmodel
from handarm_tpu.physics import solver as jsv
from handarm_tpu_torch.envs import ingenuity as ting
from handarm_tpu_torch.envs import quadcopter as tquad
from handarm_tpu_torch.ops import contact_sweep as tsw
from handarm_tpu_torch.ops import spd_inverse as tspd
from handarm_tpu_torch.physics import contacts as tc
from handarm_tpu_torch.physics import dynamics as tdy
from handarm_tpu_torch.physics import engine as te
from handarm_tpu_torch.physics import kinematics as tk
from handarm_tpu_torch.physics import mjcf as tmjcf
from handarm_tpu_torch.physics import model as tmodel
from handarm_tpu_torch.physics import solver as tsv
from tests.test_floating import FREE_BODY, FREE_PENDULUM
from tests.test_pallas_ops import spd_batch

torch.set_num_threads(1)
B = 8
POS_TOL, VEL_TOL = 2e-4, 2e-3
CRAFT = {
    "quadcopter": (jquad, "QuadcopterEnv", "QuadcopterConfig", "_quad_mjcf", tquad),
    "ingenuity": (jing, "IngenuityEnv", "IngenuityConfig", "_ingenuity_mjcf", ting),
}


def jax_env(kind: str, tmp_dir: str, **cfg):
    """The JAX package's env of a craft, its MJCF written under `tmp_dir`
    (the JAX env writes to the temp directory's fixed name)."""
    mod, env_cls, cfg_cls, _, _ = CRAFT[kind]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.tempfile, "gettempdir", lambda: tmp_dir)
        return getattr(mod, env_cls)(getattr(mod, cfg_cls)(**cfg))


def port_env(kind: str, **cfg):
    _, env_cls, cfg_cls, _, tmod = CRAFT[kind]
    return getattr(tmod, env_cls)(getattr(tmod, cfg_cls)(**cfg), device="cpu")


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("craft"))
    return {k: (jax_env(k, d, num_envs=B), port_env(k, num_envs=B)) for k in CRAFT}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, err_msg=name)


# --- MJCF ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CRAFT))
def test_mjcf_parse_and_compile_match(kind, tmp_path):
    mod, _, _, xml_fn, tmod = CRAFT[kind]
    xml = getattr(mod, xml_fn)()
    assert getattr(tmod, xml_fn)() == xml
    path = tmp_path / f"{kind}.xml"
    path.write_text(xml)
    ju, jx = jmjcf.parse_mjcf(str(path))
    tu, tx = tmjcf.parse_mjcf_string(xml, str(path))
    tu2, tx2 = tmjcf.parse_mjcf(str(path))
    assert (tu.name, tu.root_link, tu.actuated_joint_names) == (
        ju.name, ju.root_link, ju.actuated_joint_names)
    assert list(tu.links) == list(ju.links) and list(tu2.links) == list(ju.links)
    for name, jl in ju.links.items():
        tl = tu.links[name]
        assert tl.mass == jl.mass, name
        for f in ("com", "com_rot", "inertia"):
            np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f), err_msg=name)
        assert len(tl.collisions) == len(jl.collisions)
        for a, b in zip(tl.collisions, jl.collisions):
            np.testing.assert_array_equal(a.origin_pos, b.origin_pos)
            np.testing.assert_array_equal(a.origin_rot, b.origin_rot)
            assert (a.geometry.kind, a.geometry.radius, a.geometry.length) == (
                b.geometry.kind, b.geometry.radius, b.geometry.length)
    assert [j.name for j in tu.joints] == [j.name for j in ju.joints]
    for a, b in zip(tu.joints, ju.joints):
        for f in ("joint_type", "parent", "child", "lower", "upper", "effort", "velocity",
                  "damping", "friction"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        for f in ("origin_pos", "origin_rot", "axis"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=a.name)
    for x in (tx, tx2):
        assert (x.floating, x.root_body, x.motor_gears, x.joint_stiffness,
                x.joint_armature, x.geom_friction) == (
            jx.floating, jx.root_body, jx.motor_gears, jx.joint_stiffness,
            jx.joint_armature, jx.geom_friction)
        np.testing.assert_array_equal(x.root_pos, jx.root_pos)
        assert list(x.link_spheres) == list(jx.link_spheres)
        for name, sph in jx.link_spheres.items():
            for (p, r), (jp, jr) in zip(x.link_spheres[name], sph, strict=True):
                np.testing.assert_array_equal(p, jp)
                assert r == jr
    assert jx.floating

    ja, _ = jmodel.compile_mjcf(str(path), default_density=1000.0)
    ta, _ = tmodel.compile_mjcf(str(path), default_density=1000.0)
    for f in ("parent", "joint_type", "body_parent", "body_dof", "dof_body"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), err_msg=f)
    assert (ta.joint_names, ta.body_names, ta.floating, ta.nv, ta.nb) == (
        ja.joint_names, ja.body_names, ja.floating, ja.nv, ja.nb)
    for f in ("ancestor_mask", "tree_pos", "tree_quat", "axis", "mass", "com", "inertia",
              "q_min", "q_max", "effort_limit", "velocity_limit", "joint_damping", "armature"):
        np.testing.assert_allclose(getattr(ta, f), getattr(ja, f), atol=1e-6, err_msg=f)
    assert list(ta.sites) == list(ja.sites)
    for name, s in ja.sites.items():
        assert ta.sites[name].body == s.body
        np.testing.assert_allclose(ta.sites[name].pos, s.pos, atol=1e-6)
        np.testing.assert_allclose(ta.sites[name].quat, s.quat, atol=1e-6)
    jm, tm = jk.model_arrays(ja), tk.model_arrays(ta)
    assert (tm.nv, tm.nb, tm.floating) == (jm.nv, jm.nb, jm.floating) == (ja.nv, ja.nb, True)
    for f in ("dof_body", "body_parent", "joint_type"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    for f in ("tree_pos", "tree_quat", "axis", "mass", "com", "inertia", "ancestor_mask",
              "inertia_chol", "armature", "q_min", "q_max", "velocity_limit"):
        np.testing.assert_allclose(_np(getattr(tm, f)), np.asarray(getattr(jm, f)), atol=1e-6,
                                   err_msg=f)


# --- kinematics and dynamics -------------------------------------------------------


def _articulations(which: str, tmp_path):
    if which in ("flyer", "brick"):
        p = tmp_path / f"{which}.urdf"
        p.write_text(FREE_PENDULUM if which == "flyer" else FREE_BODY)
        return (jmodel.compile_urdf(str(p), floating_base=True),
                tmodel.compile_urdf(str(p), floating_base=True))
    mod, _, _, xml_fn, _ = CRAFT[which]
    p = tmp_path / f"{which}.xml"
    p.write_text(getattr(mod, xml_fn)())
    ju, _ = jmjcf.parse_mjcf(str(p))
    tu, _ = tmjcf.parse_mjcf(str(p))
    return (jmodel.compile_model(ju, floating_base=True, default_density=1000.0),
            tmodel.compile_model(tu, floating_base=True, default_density=1000.0))


def random_floating_state(art, n: int, seed: int, dist: float = 3.0):
    """(q, qd, base_quat, base_pos) as float32 numpy: joints within their
    limits (+-1 rad where unlimited), the base dofs' q at 0, a random base
    orientation, the base `dist` m from the origin."""
    rng = np.random.default_rng(seed)
    lo = np.maximum(art.q_min, -1.0)
    hi = np.minimum(art.q_max, 1.0)
    q = lo + (hi - lo) * rng.uniform(size=(n, art.nv))
    q[:, :6] = 0.0
    qd = rng.standard_normal((n, art.nv))
    quat = rng.standard_normal((n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pos = rng.standard_normal((n, 3))
    pos *= dist / np.linalg.norm(pos, axis=-1, keepdims=True)
    return [x.astype(np.float32) for x in (q, qd, quat, pos)]


def _jax_kin_dyn(jm, q, qd, quat, pos, g, kp, kd):
    """The JAX package's floating FK, body velocities, COM mass matrix and
    bias forces, its spatial mass matrix, and compute_dyn, in one jit."""
    def f(q, qd, quat, pos, g, kp, kd):
        fk = jk.forward_kinematics(jm, q, quat, pos)
        com = jdy.body_coms_world(jm, fk)
        bv = jk.body_velocities(jm, fk, qd)
        M_sp = jdy.mass_matrix(jm, fk, jdy.world_spatial_inertias(jm, fk))
        return (fk, bv, com, jdy.mass_matrix_com(jm, fk, com),
                jdy.bias_forces_com(jm, fk, qd, g, com, bv), M_sp,
                jdy.compute_dyn(jm, fk, qd, g, kp, kd, 1 / 120))
    return jax.jit(f)(*(jnp.asarray(x) for x in (q, qd, quat, pos, g, kp, kd)))


@pytest.mark.parametrize("which", ["flyer", "brick", "quadcopter", "ingenuity"])
def test_floating_kinematics_dynamics_match(which, tmp_path):
    ja, ta = _articulations(which, tmp_path)
    jm, tm = jk.model_arrays(ja), tk.model_arrays(ta)
    q, qd, quat, pos = random_floating_state(ja, B, seed=len(which))
    g = np.asarray([0.0, 0.0, -9.81], np.float32)
    kp = np.linspace(0.0, 50.0, ja.nv).astype(np.float32)
    kd = np.linspace(0.0, 2.0, ja.nv).astype(np.float32)
    jf, jbv, jcom, want_M, want_b, M_sp, jdyn = _jax_kin_dyn(jm, q, qd, quat, pos, g, kp, kd)
    t = lambda x: torch.as_tensor(x)
    tf = tk.forward_kinematics(tm, t(q), t(quat), t(pos))
    for name, got, want in zip(("body_quat", "body_pos", "screw"), tf, jf):
        _close(got, want, 1e-6, name)
    # the base body's pose is the state's; the base dofs' screws constant
    np.testing.assert_array_equal(_np(tf.body_pos[:, 0]), pos)
    np.testing.assert_array_equal(_np(tf.screw[0, :6]),
                                  np.roll(np.eye(6), 3, axis=1).astype(np.float32))
    tbv = tk.body_velocities(tm, tf, t(qd))
    _close(tbv, jbv, 1e-5, "body_velocities")
    tcom = tdy.body_coms_world(tm, tf)
    _close(tcom, jcom, 1e-6, "com_w")
    rel = lambda got, want, name: _close(got / float(np.abs(want).max()),
                                         np.asarray(want) / float(np.abs(want).max()), 1e-5,
                                         name)
    rel(tdy.mass_matrix_com(tm, tf, tcom), want_M, "mass_matrix_com")
    rel(tdy.bias_forces_com(tm, tf, t(qd), t(g), tcom, tbv), want_b, "bias_forces_com")
    # the composite-rigid-body spatial form of the JAX package agrees too
    np.testing.assert_allclose(np.asarray(want_M), np.asarray(M_sp),
                               atol=1e-5 * np.abs(np.asarray(want_M)).max())
    tdyn = tdy.compute_dyn(tm, tf, t(qd), t(g), t(kp), t(kd), 1 / 120)
    rel(tdyn.Mtilde, jdyn.Mtilde, "Mtilde")
    rel(tdyn.bias, jdyn.bias, "bias")
    ident = torch.bmm(tdyn.Minv, tdyn.Mtilde) - torch.eye(ja.nv)
    assert float(ident.abs().max()) < 5e-3


@pytest.mark.parametrize("n,seed", [(14, 1), (8, 2)], ids=["n14", "n8"])
@pytest.mark.parametrize("force_pallas", [True, False], ids=["pallas-interpret", "jnp-fallback"])
def test_spd_inverse_plain_matches(n, seed, force_pallas):
    """The plain version at the craft's sizes against the Pallas kernel (+
    W^T W, interpret mode) and the jnp fallback (atol 1e-5)."""
    M = spd_batch(64, n, seed=seed)
    want = np.asarray(j_spd_inverse(M, force_pallas=force_pallas))
    got = tspd.spd_inverse(torch.tensor(np.asarray(M))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# --- the engine --------------------------------------------------------------------


def _jax_physics(p):
    """A port PhysicsState as the JAX package's (numpy leaves)."""
    r, o = p.robot, p.objects
    f = lambda x: None if x is None else jnp.asarray(_np(x))
    return je.PhysicsState(
        robot=je.RobotState(q=f(r.q), qd=f(r.qd), targets=f(r.targets), base_pos=f(r.base_pos),
                            base_quat=f(r.base_quat), tau_ext=f(r.tau_ext)),
        objects=je.ObjectState(*(f(x) for x in o)), contact_impulse=f(p.contact_impulse))


def craft_state(kind: str, env, case: str) -> te.PhysicsState:
    """A port PhysicsState of B craft with a thrust torque in tau_ext."""
    rng = np.random.default_rng({"airborne": 0, "grounded": 1, "capped": 2}[case])
    if case == "grounded":
        phys = tquad.grounded_physics(env, B, seed=3, height=0.004)
    else:
        s, _ = env.reset(5)
        phys = s.physics
        if case == "capped":  # 4 m out, spinning past 4 pi rad/s, moving past 20 m/s;
            # 1-2 m up, clear of the ground (a base 3 m under it, in a deep
            # contact on the substep-contacts path, puts the JAX package's
            # float32 qd 0.21 from float64 and the port's 0.04: measured)
            z = rng.uniform(1.0, 2.0, B)
            ang = rng.uniform(0.0, 2 * np.pi, B)
            r = np.sqrt(16.0 - z * z)
            bp = torch.tensor(np.stack([r * np.cos(ang), r * np.sin(ang), z], -1),
                              dtype=torch.float32)
            sign = lambda: rng.choice([-1.0, 1.0], (B, 1))
            w = torch.tensor(np.concatenate([rng.uniform(-2.0, 2.0, (B, 2)),
                                             rng.uniform(13.0, 15.0, (B, 1)) * sign()], -1),
                             dtype=torch.float32)
            v = torch.tensor(np.concatenate([rng.uniform(21.0, 24.0, (B, 1)) * sign(),
                                             rng.uniform(-5.0, 5.0, (B, 2))], -1),
                             dtype=torch.float32)
            qd = phys.robot.qd.clone()
            qd[:, 0:3] = v - torch.cross(w, bp, dim=-1)
            qd[:, 3:6] = w
            phys = phys._replace(robot=phys.robot._replace(base_pos=bp, qd=qd))
        else:
            qd = phys.robot.qd + torch.tensor(rng.normal(0, 0.5, phys.robot.qd.shape),
                                              dtype=torch.float32)
            phys = phys._replace(robot=phys.robot._replace(qd=qd))
    n_rot = 4 if kind == "quadcopter" else 2
    f_local = torch.zeros(B, n_rot, 3)
    f_local[..., 2] = torch.tensor(rng.uniform(0.0, 0.02 if kind == "quadcopter" else 0.2,
                                               (B, n_rot)), dtype=torch.float32)
    tau = tquad.thrust_torque(env.scene, phys, env.rotor_bodies, f_local)
    return phys._replace(robot=phys.robot._replace(tau_ext=tau))


# path -> (SimParams and SolverParams keywords of both packages' scenes,
# step's shared_prep). "default": the port's fused anchored loop against
# the JAX package's generic one; "pallas": the port's generic anchored loop
# ([B, C, 3] Jacobi) against the JAX package's Pallas route; then the
# contacts regenerated every substep, and `substep` twice.
PATHS = {"default": ({}, {}, True), "pallas": ({}, dict(jacobi_impl="pallas"), True),
         "substep_contacts": (dict(substep_contacts=True), {}, True),
         "substep": ({}, {}, False)}
_JAX_STEPS = {}


def _with_path(scene, path: str, nt: bool):
    """The scene with the path's params (`nt`: the JAX package's NamedTuple
    Scene, else the port's dataclass)."""
    sim, solver, _ = PATHS[path]
    p = scene.params
    params = p._replace(solver=p.solver._replace(**solver), **sim)
    return scene._replace(params=params) if nt else dataclasses.replace(scene, params=params)


def _jax_step(kind: str, jenv, path: str):
    if (kind, path) not in _JAX_STEPS:
        scene = _with_path(jenv.scene, path, True)
        shared = PATHS[path][2]
        _JAX_STEPS[kind, path] = jax.jit(lambda s: je.step(scene, s, shared_prep=shared))
    return _JAX_STEPS[kind, path]


def _active_envs(scene, phys) -> int:
    fk = tk.forward_kinematics(scene.model, phys.robot.q, phys.robot.base_quat,
                               phys.robot.base_pos)
    c = tc.generate_contacts(scene.slots, scene.shapes, scene.spheres, scene.geom,
                             phys.objects.pos, phys.objects.quat, fk.body_quat, fk.body_pos)
    return int((c.depth > -scene.params.solver.speculative_margin).any(-1).sum())


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("case", ["airborne", "grounded", "capped"])
@pytest.mark.parametrize("kind", sorted(CRAFT))
def test_engine_step_matches(kind, case, path, envs):
    jenv, tenv = envs[kind]
    phys = craft_state(kind, tenv, case)
    active = _active_envs(tenv.scene, phys)
    if path == "pallas":
        p = jenv.scene.params.solver._replace(jacobi_impl="pallas")
        assert jsv._use_pallas_sweeps(p, B, jenv.scene.slots.num_slots)
    want = _jax_step(kind, jenv, path)(_jax_physics(phys))[0]
    scene = _with_path(tenv.scene, path, False)
    assert te.fused_anchored(scene.params) == (path != "pallas")  # the generic loop there
    got, info = te.step(scene, phys, shared_prep=PATHS[path][2])
    r, wr = got.robot, want.robot
    assert r.tau_ext is phys.robot.tau_ext  # kept: the env clears it after the step
    _close(r.q, wr.q, POS_TOL, "q")
    np.testing.assert_array_equal(_np(r.q[:, :6]), 0.0)
    _close(r.base_pos, wr.base_pos, POS_TOL, "base_pos")
    _close(r.base_quat, wr.base_quat, POS_TOL, "base_quat")
    _close(r.qd, wr.qd, VEL_TOL, "qd")
    _close(got.contact_impulse, want.contact_impulse, VEL_TOL, "impulse")
    if case == "grounded":
        assert active == B, active
        assert float(got.contact_impulse.abs().max()) > 0.0
    if case == "capped":
        cap = tenv.scene.params
        h = cap.dt / cap.substeps
        v_o, w = r.qd[:, 0:3].double(), r.qd[:, 3:6].double()
        # the last substep clamped the point velocity at its start p1 and
        # moved the base to p2 = p1 + h (v_o + w x p1)
        skew = torch.zeros(B, 3, 3, dtype=torch.float64)
        skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
        skew = skew - skew.transpose(1, 2)
        p1 = torch.linalg.solve(torch.eye(3, dtype=torch.float64) + h * skew,
                                r.base_pos.double() - h * v_o)
        v1 = v_o + torch.cross(w, p1, dim=-1)
        assert float(w.abs().max()) <= cap.max_base_angvel + 1e-5
        assert float(v1.abs().max()) <= cap.max_base_linvel + 1e-2
        v = (r.qd[:, 0:3] + torch.cross(r.qd[:, 3:6], r.base_pos, dim=-1))
        assert float(phys.robot.qd[:, 3:6].abs().max()) > cap.max_base_angvel or \
            kind == "ingenuity"
        # the env's observation velocity there
        if kind == "quadcopter":
            ts = tquad.QuadState(got._replace(robot=r._replace(tau_ext=None)),
                                 r.targets, torch.zeros(B, 4),
                                 torch.zeros(B, dtype=torch.int64))
            js = jquad.QuadState(_jax_physics(ts.physics), wr.targets, jnp.zeros((B, 4)),
                                 jnp.zeros(B, jnp.int32), jax.random.PRNGKey(0))
            _close(tenv._obs(ts), jenv._obs(js), VEL_TOL, "obs")
            np.testing.assert_allclose(_np(tenv._obs(ts)[:, 7:10]), _np(v / 2.0), rtol=1e-6)


@pytest.mark.parametrize("kind", sorted(CRAFT))
def test_sweep_plain_without_objects_matches(kind, envs):
    """The sweep op's plain version with K = 0 objects and S = 0 sides (obj
    [6, B, 0]) on the grounded solve, against `_solve_jacobi_soa` from the
    same prep without a warm start."""
    jenv, tenv = envs[kind]
    phys = craft_state(kind, tenv, "grounded")
    ts, js = tenv.scene, jenv.scene
    h = ts.params.dt / ts.params.substeps
    r = phys.robot
    tf = tk.forward_kinematics(ts.model, r.q, r.base_quat, r.base_pos)
    tdyn = tdy.compute_dyn(ts.model, tf, r.qd, ts.gravity, ts.kp, ts.kd, h)
    tcon = tc.generate_contacts(ts.slots, ts.shapes, ts.spheres, ts.geom, phys.objects.pos,
                                phys.objects.quat, tf.body_quat, tf.body_pos)
    tprep = tsv.prepare(ts.model, tf, tdyn.Minv, ts.maps, ts.slots, tcon, ts.shapes,
                        phys.objects.pos, phys.objects.quat, h, ts.params.solver)
    @jax.jit
    def jax_solve(jp):
        jr = jp.robot
        jf = jk.forward_kinematics(js.model, jr.q, jr.base_quat, jr.base_pos)
        jdyn = jdy.compute_dyn(js.model, jf, jr.qd, js.gravity, js.kp, js.kd, h)
        jcon = jc.generate_contacts(js.slots, js.shapes, js.spheres, js.geom, jp.objects.pos,
                                    jp.objects.quat, jf.body_quat, jf.body_pos)
        jprep = jsv._prepare(js.model, jf, jdyn.Minv, js.slots, jcon, js.shapes,
                             jp.objects.pos, jp.objects.quat, h, js.params.solver)
        return jsv._solve_jacobi_soa(jprep, jr.qd, jp.objects.linvel, jp.objects.angvel,
                                     js.params.solver)
    C = ts.slots.num_slots
    assert int((tprep.active > 0).sum()) > 0
    pack = tsv.anchored_pack(tprep)
    assert pack.planes.shape[0] == tsw.NBASE and ts.maps.obj_idx.shape == (0, C)
    obj = torch.zeros(6, B, 0)
    qd, obj_out, lam = tsw.contact_sweep(
        pack.planes, tprep.bias.contiguous(), pack.screws, r.qd.contiguous(), pack.minv2,
        obj, torch.zeros(3, B, C), ts.maps.anc_slot, ts.maps.groups, ts.maps.obj_idx,
        ts.maps.signs, ts.params.solver.iterations, ts.params.solver.relaxation,
        apply_warm=False)
    assert obj_out.shape == (6, B, 0)
    want = jax_solve(_jax_physics(phys))
    _close(qd, want[0], VEL_TOL, "qd")
    _close(tsv.anchored_impulse_world(pack, lam), want[3], VEL_TOL, "impulse")
    assert float(lam[0].max()) > 0.0
