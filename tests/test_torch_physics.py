"""Contacts, solver prep and one engine step: the port against the JAX
package on a small contact-rich scene.

The scene is the one-joint TINY_ARM of tests/test_engine.py mounted low
(base at z = 0.15) so its sphere presses on the first of three objects: a
box resting on the table, a second box, and a sphere object touching the
first box's side. Robot-vs-object, object-vs-table and object-vs-object
slots are all active. Velocities and warm-start impulses come from a numpy
seed; float32 on both sides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handarm_tpu.physics import contacts as jc
from handarm_tpu.physics import engine as je
from handarm_tpu.physics import shapes as jsh
from handarm_tpu.physics import solver as jsv
from handarm_tpu.physics.model import compile_urdf
from handarm_tpu_torch.physics import contacts as tc
from handarm_tpu_torch.physics import engine as te
from handarm_tpu_torch.physics import shapes as tsh
from handarm_tpu_torch.physics import solver as tsv
from tests.test_engine import TINY_ARM

torch.set_num_threads(1)
B = 8
OBJ_POS = [[0.38, 0.0, 0.05], [0.38, 0.25, 0.04], [0.38, 0.08, 0.03]]
OBJS = (("box", [0.05, 0.05, 0.05], 0.3), ("box", [0.04, 0.04, 0.04], 0.2),
        ("sphere", 0.03, 0.1))


def _objs(mod):
    return [mod.make_box_object(s, mass=m) if k == "box" else mod.make_sphere_object(s, mass=m)
            for k, s, m in OBJS]


def _params(mod_engine, mod_solver, prep_dtype):
    return mod_engine.SimParams(substeps=2, solver=mod_solver.SolverParams(
        iterations=8, rolling_friction=0.003, prep_dtype=prep_dtype),
        robot_gravity=False)


def build_scenes(tmp_path, prep_dtype="f32"):
    """(jax_scene, port_scene, jax_state) of the same scene and state."""
    p = tmp_path / "tiny.urdf"
    p.write_text(TINY_ARM)
    art = compile_urdf(str(p))
    sph = dict(body=np.array([0], np.int32), offset=[[0.4, 0.0, 0.0]], radius=[0.05])
    geom_kw = dict(table_lo=[-10.0, -10.0], table_hi=[10.0, 10.0])
    walls = (np.array([[0.2, 0.3, 0.0]], np.float32), np.array([[0.6, 0.4, 0.2]], np.float32))
    jscene = je.build_scene(
        art, jsh.stack_objects(_objs(jsh)),
        jc.RobotSpheres(body=sph["body"], offset=jnp.asarray(sph["offset"], jnp.float32),
                        radius=jnp.asarray(sph["radius"], jnp.float32),
                        friction=jnp.ones(1, jnp.float32)),
        jc.StaticGeom(table_lo=jnp.asarray(geom_kw["table_lo"]),
                      table_hi=jnp.asarray(geom_kw["table_hi"]),
                      table_height=jnp.asarray(0.0), friction=jnp.asarray(1.0),
                      wall_lo=walls[0], wall_hi=walls[1]),
        kp=np.full(1, 50.0), kd=np.full(1, 5.0), base_pos=(0.0, 0.0, 0.15),
        params=_params(je, jsv, prep_dtype))
    from handarm_tpu_torch.physics.model import compile_urdf as t_compile

    tscene = te.build_scene(
        t_compile(str(p)), tsh.stack_objects(_objs(tsh)),
        tc.RobotSpheres(body=sph["body"], offset=torch.tensor(sph["offset"]),
                        radius=torch.tensor(sph["radius"]), friction=np.ones(1, np.float32)),
        tc.StaticGeom(table_lo=torch.tensor(geom_kw["table_lo"]),
                      table_hi=torch.tensor(geom_kw["table_hi"]), table_height=0.0,
                      wall_lo=walls[0], wall_hi=walls[1]),
        kp=np.full(1, 50.0), kd=np.full(1, 5.0), base_pos=(0.0, 0.0, 0.15),
        params=_params(te, tsv, prep_dtype))
    rng = np.random.default_rng(0)
    C = jscene.slots.num_slots
    q = 0.3 + 0.02 * rng.standard_normal((B, 1))
    pos = np.asarray(OBJ_POS)[None] + 0.003 * rng.standard_normal((B, 3, 3))
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (B, 3, 1)) + 0.02 * rng.standard_normal((B, 3, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    f = lambda x: jnp.asarray(x, jnp.float32)
    state = je.PhysicsState(
        robot=je.RobotState(q=f(q), qd=f(rng.standard_normal((B, 1))), targets=f(q + 0.5)),
        objects=je.ObjectState(pos=f(pos), quat=f(quat),
                               linvel=f(0.3 * rng.standard_normal((B, 3, 3))),
                               angvel=f(2.0 * rng.standard_normal((B, 3, 3)))),
        contact_impulse=f(0.01 * np.abs(rng.standard_normal((B, C, 3)))),
    )
    return jscene, tscene, state


def to_port(state):
    from handarm_tpu_torch.convert import physics_state_from_leaves

    r, o = state.robot, state.objects
    return physics_state_from_leaves([np.asarray(x) for x in (
        r.q, r.qd, r.targets, o.pos, o.quat, o.linvel, o.angvel, state.contact_impulse)])


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return build_scenes(tmp_path_factory.mktemp("scene"))


def test_slots_identical(scenes):
    js, ts, _ = scenes
    for name in ("robot_body", "obj_a", "obj_b", "friction"):
        np.testing.assert_array_equal(getattr(ts.slots, name), getattr(js.slots, name))
    assert ts.slots.num_slots == js.slots.num_slots


def _fk_contacts(js, ts, state):
    from handarm_tpu.physics.kinematics import forward_kinematics as jfk
    from handarm_tpu_torch.physics.kinematics import forward_kinematics as tfk

    pst = to_port(state)
    jf = jfk(js.model, state.robot.q, js.base_quat[None], js.base_pos[None])
    tf = tfk(ts.model, pst.robot.q, ts.base_quat[None], ts.base_pos[None])
    o, to = state.objects, pst.objects
    jcon = jc.generate_contacts(js.slots, js.shapes, js.spheres, js.geom, o.pos, o.quat,
                                jf.body_quat, jf.body_pos)
    tcon = tc.generate_contacts(ts.slots, ts.shapes, ts.spheres, ts.geom, to.pos, to.quat,
                                tf.body_quat, tf.body_pos)
    return jf, tf, jcon, tcon, pst


def test_contacts_match(scenes):
    """Normals, points and depths of every slot (table, walls, box and
    sphere SDFs); 1e-5: a few float32 rotations of O(1) values."""
    js, ts, state = scenes
    _, _, jcon, tcon, _ = _fk_contacts(js, ts, state)
    for a, b in zip(jcon, tcon):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    depth = np.asarray(jcon.depth)
    assert (depth > -0.02).sum(-1).min() >= 8  # contact-rich: many active slots
    robot_obj = (js.slots.robot_body >= 0) & (js.slots.obj_b >= 0)
    assert (depth[:, robot_obj] > 0).any()  # the arm presses on an object
    pair = (js.slots.obj_a >= 0) & (js.slots.obj_b >= 0)
    assert (depth[:, pair] > -0.02).any()  # object-object contact


@pytest.mark.parametrize("prep_dtype", ["f32", "bf16"])
def test_prepare_and_pack_match(tmp_path, prep_dtype):
    """The sweep kernel's inputs: the packed [NP, B, C] planes (basis,
    points, friction, inverse effective masses, gates, lever arms, inverse
    inertias), screws and Minv. f32 prep: 1e-4 relative to each plane's
    scale; the bf16 effective-mass chain rounds in both frameworks: 2e-2 on
    the inverse effective masses."""
    js, ts, state = build_scenes(tmp_path, prep_dtype)
    jf, tf, jcon, tcon, pst = _fk_contacts(js, ts, state)
    from handarm_tpu.physics.dynamics import compute_dyn as jdyn
    from handarm_tpu_torch.physics.dynamics import compute_dyn as tdyn

    h = js.params.dt / js.params.substeps
    jd = jdyn(js.model, jf, state.robot.qd, jnp.zeros(3), js.kp, js.kd, h)
    td = tdyn(ts.model, tf, pst.robot.qd, torch.zeros(3), ts.kp, ts.kd, h)
    o, to = state.objects, pst.objects
    jprep = jsv._prepare(js.model, jf, jd.Minv, js.slots, jcon, js.shapes, o.pos, o.quat,
                         h, js.params.solver)
    tprep = tsv.prepare(ts.model, tf, td.Minv, ts.maps, ts.slots, tcon, ts.shapes, to.pos,
                        to.quat, h, ts.params.solver)
    (jplanes, jscrews, jminv2, *_), signs = jsv.anchored_pack(jprep)
    tpack = tsv.anchored_pack(tprep)
    assert tuple(signs) == ts.maps.signs
    jplanes = np.asarray(jplanes)
    inv_d = {13, 14, 15}
    for k in range(jplanes.shape[0]):
        tol = (2e-2 if prep_dtype == "bf16" and k in inv_d else 1e-4)
        block = [k]
        if k >= 17 and (k - 17) % 10 in range(3, 9):  # a side's inverse inertia:
            first = k - (k - 17) % 10 + 3  # off-diagonals cancel O(diagonal) terms
            block = range(first, first + 6)
        scale = max(1.0, np.abs(jplanes[list(block)]).max())
        np.testing.assert_allclose(tpack.planes[k].numpy(), jplanes[k], atol=tol * scale,
                                   rtol=tol, err_msg=f"plane {k}")
    np.testing.assert_allclose(tpack.screws.numpy(), np.asarray(jscrews), atol=1e-5)
    np.testing.assert_allclose(tpack.minv2.numpy(), np.asarray(jminv2), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jminv2)).max())
    # refresh against the frozen mass terms (geometry of the same state)
    tref = tsv.refresh_prep(tprep, tf, ts.maps, tcon, to.pos, h, ts.params.solver)
    for name in ("inv_d", "bias", "split", "basis"):
        np.testing.assert_allclose(getattr(tref, name).numpy(),
                                   getattr(tprep, name).numpy(), rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("prep_dtype", ["f32", "bf16"])
def test_engine_step_matches(tmp_path, prep_dtype):
    """One sim step with the heavy mass structure and carried FK, as the
    env runs it: compute_heavy, then step(heavy, fk0, contacts0) with 2
    anchored substeps x 8 sweeps. The port runs the fused form (plain sweep
    on the CPU), the JAX package its generic anchored path; they agree to
    the JAX package's own sweep-parity bounds (2e-4 positions, 2e-3
    velocities and impulses), the bf16 prep to 2x those."""
    js, ts, state = build_scenes(tmp_path, prep_dtype)
    pst = to_port(state)
    jh = je.compute_heavy(js, state)
    th = te.compute_heavy(ts, pst)
    jout, jinfo, jfk = je.step(js, state, heavy=jh, fk0=jh.fk0, contacts0=jh.contacts0,
                               carry_fk=True)
    tout, tinfo, tfk = te.step(ts, pst, th, th.fk0, th.contacts0)
    k = 2.0 if prep_dtype == "bf16" else 1.0
    for name, a, b, tol in (
        ("q", jout.robot.q, tout.robot.q, 2e-4), ("qd", jout.robot.qd, tout.robot.qd, 2e-3),
        ("pos", jout.objects.pos, tout.objects.pos, 2e-4),
        ("quat", jout.objects.quat, tout.objects.quat, 2e-4),
        ("linvel", jout.objects.linvel, tout.objects.linvel, 2e-3),
        ("angvel", jout.objects.angvel, tout.objects.angvel, 2e-3),
        ("impulse", jout.contact_impulse, tout.contact_impulse, 2e-3),
        ("max_penetration", jinfo.max_penetration, tinfo.max_penetration, 2e-4),
    ):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=k * tol, err_msg=name)
    for a, b in zip(jfk, tfk):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-4)
    assert np.abs(np.asarray(jout.contact_impulse)).max() > 1e-3  # impulses flowed


def test_carried_fk_within_bound(scenes):
    """The propagated FK that the next sim step consumes stays within 5e-3 m
    of the exact FK (the bound of tests/test_carry_fk.py)."""
    _, ts, state = scenes
    pst = to_port(state)
    h = te.compute_heavy(ts, pst)
    out, _, fk1 = te.step(ts, pst, h, h.fk0, h.contacts0)
    from handarm_tpu_torch.physics.kinematics import forward_kinematics

    exact = forward_kinematics(ts.model, out.robot.q, ts.base_quat[None], ts.base_pos[None])
    assert float((fk1.body_pos - exact.body_pos).abs().max()) < 5e-3
