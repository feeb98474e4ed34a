"""The Factory tasks (pick, place, screw, gears, insertion): the port against
the JAX package on the CPU, on the in-repo stand-in Franka
(handarm_tpu_torch/assets/classic_standin/franka_description/robots/
franka_panda_gripper.urdf; the JAX env reads it through a monkeypatched
`handarm_tpu.envs.factory.FRANKA_URDF`) with the parts' tracked records
(`.sdf_cache/`: the JAX loader reads them through a monkeypatched
`handarm_tpu.envs.objects.CACHE_DIR`, keyed by the reference's URDF paths,
and never parses a URDF). Each variant's JAX env is built once at B = 4 and
its step jitted once.

- `PART_RECORD_KEYS` are the JAX package's keys (sha1 of
  '<FACTORY_URDF_DIR or IR_URDF_DIR>/<name>.urdf:40:96:v4'), every record
  the port reads equals the JAX loader's field for field, and
  IndustRealTaskGearsInsert's two meshes have no record.
- Both packages' scenes, per variant: nv 9, the contact slots (298 with two
  parts, 456 with the three of gears) and their tables, K, the SDF fields
  at R = 40, the masses and inertias after the rescale, `spawn_h` and the
  grasp height, the screw's cylindrical rail, the solver's parameters (16
  sweeps, warm start 0.9, or 0 for gears and insertion), the grip site's
  home position, the observation and action widths (20 / 27 / 32, 12).
- Per variant, the reset from the JAX package's draws (re-derived from its
  keys and handed to the port's `reset` / `step`): observations within
  1e-6, every state leaf as below; then 3 steps at B = 4 from the
  converted JAX state with uniform actions in [-1, 1] and the JAX package's
  draws, env 0 timing out at the first (its fresh episode from the injected
  draws) and, on pick, env 1 at the step where the clock closes the
  gripper. Observations and rewards within 2e-3 times max(1, the largest
  value), done flags and the info exactly / within 2e-3 of scale, every
  state leaf within 2e-4 (positions) or 2e-3 (velocities, impulses, the
  fingertip forces) of max(1, its largest value), integer and bool leaves
  exactly.
- The placed nut stays in the closed gripper (over the table by more than
  5 cm) after 6 zero-action steps in both packages, as
  tests/test_factory.py checks the JAX package alone.
- The screw's descent over a spun nut (tests/test_factory.py:48-75): 30
  steps with the nut's spin forced to -20 rad/s at B = 4 in both packages;
  the unwrapped yaw and the height within 1e-3 of each other, the height
  the thread pitch's within 1e-3, the nut on the bolt's axis.
- The sweep's and sdf_gather's plain versions on Factory contact states
  at R = 40: the place state after 3 steps (the fingers on the nut; warm
  start 0.9) and the gears state after 3 (no warm start), the port's
  `prepare` + `solve_jacobi_soa` against the JAX package's `_prepare` +
  `_solve_jacobi_soa` (solver.py:1024) on the same state: qd, object
  velocities and world impulses within 2e-3 times max(1, scale), and held
  against a float64 run of the port's own solve (within 1e-3 of scale: the
  mm-scale parts' inverse inertias reach ~1e5); the SDF samples of every
  robot sphere and every part's surface samples in each part's frame
  against the JAX package's `sample_sdf_channels` plus the out-of-grid
  excess, every channel within 1e-5.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.envs import factory as jfac
from handarm_tpu.envs import industreal as jir
from handarm_tpu.envs import objects as jobj
from handarm_tpu.physics import contacts as jc
from handarm_tpu.physics import dynamics as jdy
from handarm_tpu.physics import kinematics as jk
from handarm_tpu.physics import solver as jsv
from handarm_tpu.physics.sdf import sample_sdf_channels
from handarm_tpu_torch.convert import classic_state_from_leaves
from handarm_tpu_torch.envs import factory as tfac
from handarm_tpu_torch.envs import franka as tfr
from handarm_tpu_torch.envs import objects as tobj
from handarm_tpu_torch.math.quat import quat_rotate, quat_rotate_inv, quat_to_matrix
from handarm_tpu_torch.physics import contacts as tc
from handarm_tpu_torch.physics import dynamics as tdyn
from handarm_tpu_torch.physics import kinematics as tkin
from handarm_tpu_torch.physics import solver as tsv
from handarm_tpu_torch.physics.sdf import sample_sdf_plain

torch.set_num_threads(1)
B = 4
STEPS = 3
POS_TOL, VEL_TOL = 2e-4, 2e-3
VARIANTS = ("pick", "place", "screw", "gears", "insertion")
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def factory():
    """variant -> (JAX env, its jitted step, port env) at B = 4, built on
    first use, with the JAX package pointed at the stand-in and the records
    for the module."""
    built = {}

    def get(task):
        if task not in built:
            jenv = jfac.make_factory(task=task, num_envs=B)
            built[task] = (jenv, jax.jit(jenv.step), tfac.make_factory(task, num_envs=B,
                                                                        device="cpu"))
        return built[task]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfac, "FRANKA_URDF", tfr.FRANKA_URDF)
        mp.setattr(jobj, "CACHE_DIR", str(tobj.CACHE_DIR))
        yield get


def fresh_draws(key, n: int = B) -> tfac.FactoryDraws:
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, n)`
    makes."""
    kn, kb, _ = jax.random.split(key, 3)
    u = lambda k: _t(jax.random.uniform(k, (n, 2), minval=-1.0, maxval=1.0))
    return tfac.FactoryDraws(nut=u(kn), bolt=u(kb))


def step_draws(state_key, n: int = B) -> tfac.FactoryDraws:
    return fresh_draws(jax.random.split(state_key)[1], n)


def port_state(jstate) -> tfac.FactoryState:
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     tfac.FactoryState)


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


NAMES = ("q", "qd", "targets", "opos", "oquat", "olin", "oang", "impulse", "progress",
         "actions", "lifted", "theta", "prev_yaw", "finger_force", "bolt_pos")
VELOCITY_LEAVES = ("qd", "olin", "oang", "impulse", "finger_force")


def assert_state_close(got, want):
    p = got.physics
    leaves = [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        got[1:])
    g = jax.tree.leaves(want)
    assert len(leaves) == len(g) - 1 == len(NAMES)  # the JAX key
    for name, a, b in zip(NAMES, leaves, g):
        b = np.asarray(b)
        if a.dtype in (torch.int64, torch.bool):
            assert b.dtype == (np.bool_ if a.dtype == torch.bool else np.int32), name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            _close(a, b, VEL_TOL if name in VELOCITY_LEAVES else POS_TOL, name)


# --- the records -----------------------------------------------------------------


def test_part_records_follow_jax_key_scheme(factory):
    """The keys, the records field for field, and the unbaked gears."""
    dirs = {"factory": jfac.FACTORY_URDF_DIR, "industreal": jir.IR_URDF_DIR}
    for name, key in tobj.PART_RECORD_KEYS.items():
        set_name, part = name.split("/")
        path = f"{dirs[set_name]}/{part}.urdf"
        assert hashlib.sha1(f"{path}:40:96:v4".encode()).hexdigest()[:16] == key, name
        got, want = tobj.load_object(name), jobj.load_object(path, 40, 96)
        assert sorted(got) == sorted(want), name
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert got["sdf_grid"].shape == (40, 40, 40) and got["points"].shape == (96, 3)
    assert len(tobj.PART_RECORD_KEYS) == 9
    for part in jir.PEG_ASSETS["gears"]:
        assert f"industreal/{part}" not in tobj.PART_RECORD_KEYS
        path = f"{jir.IR_URDF_DIR}/{part}.urdf"
        key = hashlib.sha1(f"{path}:40:96:v4".encode()).hexdigest()[:16]
        assert not (tobj.CACHE_DIR / f"{key}.npz").exists(), part
    with pytest.raises(KeyError, match="no baked record"):
        tobj.load_object("industreal/industreal_gear_medium")


# --- the scenes -------------------------------------------------------------------


def compare_scenes(jenv, tenv):
    """The two packages' scenes of one Franka task, field by field."""
    js, ts = jenv.scene, tenv.scene
    assert ts.model.nv == js.model.nv == 9
    assert ts.slots.num_slots == js.slots.num_slots
    for f in ("robot_body", "obj_a", "obj_b"):
        np.testing.assert_array_equal(getattr(ts.slots, f), np.asarray(getattr(js.slots, f)),
                                      err_msg=f)
    np.testing.assert_allclose(ts.slots.friction, np.asarray(js.slots.friction), rtol=1e-6)
    jsh, tsh = js.shapes, ts.shapes
    for f in ("size", "points", "point_mask", "point_radius", "bound_radius", "mass",
              "inv_mass", "inertia_diag", "friction", "obb_pos", "obb_quat", "sdf_lo",
              "sdf_spacing"):
        np.testing.assert_allclose(getattr(tsh, f).numpy(), np.asarray(getattr(jsh, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tsh.kind, np.asarray(jsh.kind))
    jfield = np.asarray(jsh.sdf_field) if hasattr(jsh, "sdf_field") else None
    if jfield is not None:
        np.testing.assert_allclose(tsh.sdf_field.numpy(), jfield, atol=1e-6)
    assert tsh.sdf_field.shape[1:] == (40, 40, 40, 4)
    for f in ("kp", "kd", "base_pos", "base_quat"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    tp, jp = ts.params, js.params
    for f in ("dt", "substeps", "max_obj_angvel", "obj_angular_damping", "obj_linear_damping",
              "robot_gravity"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("iterations", "warm_start", "baumgarte", "max_depenetration_vel", "relaxation"):
        assert getattr(tp.solver, f) == getattr(jp.solver, f), f
    assert (ts.rails is None) == (js.rails is None)
    if ts.rails is not None:
        for f, g in ts.rails._asdict().items():
            w = getattr(js.rails, f)
            assert (g is None) == (w is None), f
            if g is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7, err_msg=f)
    assert (tenv.num_obs, tenv.num_actions, tenv.num_teacher_obs) == (
        jenv.num_obs, jenv.num_actions, jenv.num_teacher_obs)


@pytest.mark.parametrize("task", VARIANTS)
def test_scenes_match(task, factory):
    jenv, _, tenv = factory(task)
    compare_scenes(jenv, tenv)
    C = 456 if task == "gears" else 298
    assert tenv.scene.slots.num_slots == C and tenv.K == jenv.K == (3 if task == "gears" else 2)
    np.testing.assert_allclose(tenv.spawn_h, jenv.spawn_h, rtol=1e-6)
    assert tenv.grasp_h == pytest.approx(jenv.grasp_h, rel=1e-6)
    np.testing.assert_allclose(tenv.grip_home.numpy(), jenv.grip_home, atol=1e-6)
    np.testing.assert_allclose(tenv.kp_offsets.numpy(), np.asarray(jenv.kp_offsets))
    np.testing.assert_array_equal(tenv.finger_bodies.numpy(), jenv.finger_bodies)
    assert tenv.num_obs == {"place": 27, "screw": 32}.get(task, 20) and tenv.num_actions == 12
    assert tenv.scene.params.solver.warm_start == (0.0 if task in ("gears", "insertion") else 0.9)


# --- env steps ---------------------------------------------------------------------


def _forced(jenv, js, task):
    """Env 0 times out at the first step; on pick, env 1's clock reaches the
    step where the gripper closes."""
    prog = np.asarray(js.progress).copy()
    prog[0] = jenv.cfg.episode_length - 1
    if task == "pick":
        prog[1] = jenv.cfg.episode_length * 3 // 4 - 1
    return js._replace(progress=jnp.asarray(prog))


@pytest.mark.parametrize("task", VARIANTS)
def test_reset_and_steps_match(task, factory):
    jenv, jstep, tenv = factory(task)
    key = jax.random.PRNGKey(VARIANTS.index(task) + 3)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key))
    _close(tobs, jobs, 1e-6, "reset obs")
    assert_state_close(ts, js)
    js = _forced(jenv, js, task)
    ts = port_state(js)
    rng = np.random.default_rng(VARIANTS.index(task))
    for i in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (B, 12)).astype(np.float32)
        draws = step_draws(js.key)
        js, jr = jstep(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"success_frac", "kp_dist"}
        for k in tr.info:
            _close(tr.info[k], jr.info[k], VEL_TOL, k)
        assert tr.teacher_obs.shape == (B, 0)
        assert_state_close(ts, js)
        if i == 0:
            np.testing.assert_array_equal(tr.done.numpy(), np.arange(B) == 0)
    if task == "pick":  # env 1's gripper closed on the clock, the others' open
        fingers = ts.physics.robot.targets[:, 7:]
        assert (fingers[1] == tenv.q_lo[7:]).all() and (fingers[2:] == tenv.q_hi[7:]).all()


def test_placed_nut_stays_in_gripper(factory):
    jenv, jstep, tenv = factory("place")
    key = jax.random.PRNGKey(1)
    js, _ = jenv.reset(key)
    ts, _ = tenv.reset(0, fresh_draws(key))
    for _ in range(6):
        js, _ = jstep(js, jnp.zeros((B, 12)))
        ts, _ = tenv.step(ts, torch.zeros(B, 12))
    for name, z in (("jax", np.asarray(js.physics.objects.pos[:, 0, 2])),
                    ("port", ts.physics.objects.pos[:, 0, 2].numpy())):
        assert (z > jfac.TABLE_HEIGHT + 0.05).all(), (name, z)
    _close(ts.physics.objects.pos, js.physics.objects.pos, POS_TOL, "nut and bolt")


def test_screw_descends_by_the_pitch(factory):
    """tests/test_factory.py:48-75 in both packages, side by side."""
    jenv, step, tenv = factory("screw")
    n = B
    key = jax.random.PRNGKey(2)
    js = jenv._fresh(key, n)
    ts = tenv._fresh(n, fresh_draws(key, n))
    z0 = float(ts.physics.objects.pos[0, 0, 2])
    for _ in range(30):
        o = js.physics.objects
        js = js._replace(physics=js.physics._replace(
            objects=o._replace(angvel=o.angvel.at[:, 0, 2].set(-20.0))))
        to = ts.physics.objects
        av = to.angvel.clone()
        av[:, 0, 2] = -20.0
        ts = ts._replace(physics=ts.physics._replace(objects=to._replace(angvel=av)))
        draws = step_draws(js.key, n)
        js, _ = step(js, jnp.zeros((n, 12)))
        ts, _ = tenv.step(ts, torch.zeros(n, 12), draws)
    for name, z1, theta, xy in (
            ("jax", np.asarray(js.physics.objects.pos[:, 0, 2]), np.asarray(js.theta),
             np.asarray(js.physics.objects.pos[:, 0, :2])),
            ("port", ts.physics.objects.pos[:, 0, 2].numpy(), ts.theta.numpy(),
             ts.physics.objects.pos[:, 0, :2].numpy())):
        assert (theta < -5.0).all(), (name, theta)
        expect = np.clip(z0 + tfac.THREAD_PITCH * theta / (2 * np.pi),
                         tfac.TABLE_HEIGHT + tfac.BOLT_HEAD_HEIGHT,
                         tfac.TABLE_HEIGHT + tfac.BOLT_HEAD_HEIGHT + tfac.BOLT_SHANK_LENGTH)
        np.testing.assert_allclose(z1, expect, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(xy, 0.0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(ts.theta.numpy(), np.asarray(js.theta), atol=1e-3)
    np.testing.assert_allclose(ts.physics.objects.pos[:, 0, 2].numpy(),
                               np.asarray(js.physics.objects.pos[:, 0, 2]), atol=1e-3)


# --- the sweep and sdf_gather on Factory contact states ---------------------------


def _contact_state(factory, task):
    """(JAX env, port env, the port's state): 3 steps of the port from the
    JAX package's reset, the arm still and the gripper closed."""
    jenv, _, tenv = factory(task)
    key = jax.random.PRNGKey(7)
    ts, _ = tenv.reset(0, fresh_draws(key))
    closed = torch.zeros(B, 12)
    closed[:, 6] = -1.0
    for _ in range(3):
        ts, _ = tenv.step(ts, closed)
    return jenv, tenv, ts.physics


@pytest.mark.parametrize("task", ["place", "gears"])
def test_sweep_plain_matches_jax(task, factory):
    jenv, tenv, phys = _contact_state(factory, task)
    ts, js = tenv.scene, jenv.scene
    h = ts.params.dt / ts.params.substeps
    r, o = phys.robot, phys.objects

    def port_solve(dtype):
        c = lambda x: x.to(dtype)
        m = tkin.model_arrays(tenv.art, dtype)
        maps = tsv.build_slot_maps(ts.slots, tenv.art.ancestor_mask, tenv.K, dtype)
        sh = dataclasses.replace(ts.shapes, **{
            k: c(v) for k, v in vars(ts.shapes).items() if isinstance(v, torch.Tensor)})
        spheres = dataclasses.replace(ts.spheres, offset=c(ts.spheres.offset),
                                      radius=c(ts.spheres.radius))
        tf = tkin.forward_kinematics(m, c(r.q), c(ts.base_quat[None]), c(ts.base_pos[None]))
        td = tdyn.compute_dyn(m, tf, c(r.qd), torch.zeros(3, dtype=dtype), c(ts.kp), c(ts.kd),
                              h)
        con = tc.generate_contacts(ts.slots, sh, spheres, ts.geom, c(o.pos), c(o.quat),
                                   tf.body_quat, tf.body_pos)
        prep = tsv.prepare(m, tf, td.Minv, maps, ts.slots, con, sh, c(o.pos), c(o.quat), h,
                           ts.params.solver)
        return tsv.solve_jacobi_soa(prep, maps, c(r.qd), c(o.linvel), c(o.angvel),
                                    ts.params.solver, c(phys.contact_impulse))

    got = port_solve(torch.float32)
    f64 = port_solve(torch.float64)
    f = lambda x: jnp.asarray(x.numpy())

    @jax.jit
    def jax_side(q, qd, pos, quat, lv, av, warm):
        jf = jk.forward_kinematics(js.model, q, js.base_quat[None], js.base_pos[None])
        jd = jdy.compute_dyn(js.model, jf, qd, jnp.zeros(3), js.kp, js.kd, h)
        jcon = jc.generate_contacts(js.slots, js.shapes, js.spheres, js.geom, pos, quat,
                                    jf.body_quat, jf.body_pos)
        jprep = jsv._prepare(js.model, jf, jd.Minv, js.slots, jcon, js.shapes, pos, quat, h,
                             js.params.solver)
        return jsv._solve_jacobi_soa(jprep, qd, lv, av, js.params.solver, warm)

    want = jax_side(f(r.q), f(r.qd), f(o.pos), f(o.quat), f(o.linvel), f(o.angvel),
                    f(phys.contact_impulse))
    # the place state's fingers push on the nut; the gears rest on the table
    slots = ts.slots
    kind = ((slots.robot_body >= 0) & (slots.obj_b == 0) if task == "place"
            else (slots.robot_body < 0) & ((slots.obj_a >= 0) | (slots.obj_b >= 0)))
    pushed = (got[3].norm(dim=-1) > 0)[:, torch.as_tensor(kind)].any(-1)
    print(f"{task}: envs with impulses on {'robot-nut' if task == 'place' else 'part'} "
          f"slots {int(pushed.sum())} of {B}; max |impulse| {float(got[3].abs().max()):.3e}")
    assert int(pushed.sum()) == B
    for name, g, w, d in zip(("qd", "linvel", "angvel", "impulse"), got, want, f64):
        _close(g, w, VEL_TOL, name)
        _close(g, d.float(), 1e-3, f"{name} vs float64")


@pytest.mark.parametrize("task", ["place", "gears"])
def test_sdf_plain_matches_jax_at_r40(task, factory):
    jenv, tenv, phys = _contact_state(factory, task)
    sh = tenv.scene.shapes
    fk = tkin.forward_kinematics(tenv.scene.model, phys.robot.q, tenv.scene.base_quat[None],
                                 tenv.scene.base_pos[None])
    centres = fk.body_pos[:, tenv.scene.spheres.body] + torch.einsum(
        "bsij,sj->bsi", quat_to_matrix(fk.body_quat[:, tenv.scene.spheres.body]),
        tenv.scene.spheres.offset)
    o = phys.objects
    jfield = np.asarray(jenv.scene.shapes.sdf_field)
    inside = 0
    for k in range(tenv.K):
        world = torch.cat([centres] + [o.pos[:, j, None] + quat_rotate(
            o.quat[:, j, None].expand(-1, sh.points.shape[1], 4), sh.points[j][None].expand(
                B, -1, 3)) for j in range(tenv.K)], 1)
        p = quat_rotate_inv(o.quat[:, k, None].expand(-1, world.shape[1], 4),
                            world - o.pos[:, k, None])
        got = sample_sdf_plain(sh.sdf_field[k], sh.sdf_lo[k], sh.sdf_spacing[k], p)
        lo, sp = np.asarray(jenv.scene.shapes.sdf_lo[k]), float(jenv.scene.shapes.sdf_spacing[k])
        jp = jnp.asarray(p.numpy())
        want = np.array(sample_sdf_channels(jnp.asarray(jfield[k]), lo, sp, jp))
        u = (p.numpy() - lo) / sp
        excess = np.linalg.norm(np.maximum(np.abs(u - 39 / 2) - 39 / 2, 0.0), axis=-1)
        want[..., 0] += excess * sp
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=f"part {k}")
        inside += int(((u >= 0) & (u <= 39)).all(-1).sum())
    print(f"{task}: {inside} queries inside the R = 40 grids")
    assert inside > 0
