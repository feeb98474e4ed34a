"""The general contact solver and every engine cadence: the port against the
JAX package on the test scenes of tests/test_engine.py, and the JAX
physics suite's behaviour probes run through the port's engine.

The scenes are tests/test_engine.py's: its one-joint TINY_ARM (copied
here) mounted at z = 1 over a table, built by `tiny_scenes` as its
`tiny_scene` builds them, once for each package. The parity scene sets the
arm's sphere down on a box resting on the table (robot-object contact), a
sphere object beside the box, moving into it (object-pair contact) and
falling onto the table faster than the restitution threshold; poses,
velocities and warm-start impulses jitter from a numpy seed over B = 8
envs. Float32 on both sides; the JAX package runs on the
CPU, where its engine takes its generic anchored loop and its solver the
SoA scan.

Tolerances are the existing engine parity tests' (tests/test_torch_physics.py):
2e-4 on positions, quaternions and penetrations, 2e-3 on velocities and
impulses (and on contact forces, impulse / h, scaled by 1 / h).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handarm_tpu.physics import contacts as jc
from handarm_tpu.physics import engine as je
from handarm_tpu.physics import shapes as jsh
from handarm_tpu.physics import solver as jsv
from handarm_tpu.physics.model import compile_urdf
from handarm_tpu_torch.convert import physics_state_from_leaves
from handarm_tpu_torch.physics import contacts as tc
from handarm_tpu_torch.physics import engine as te
from handarm_tpu_torch.physics import shapes as tsh
from handarm_tpu_torch.physics import solver as tsv
from handarm_tpu_torch.physics.model import compile_urdf as t_compile

torch.set_num_threads(1)

TINY_ARM = """
<robot name="tiny">
  <link name="base"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="-3" upper="3" effort="50" velocity="10"/>
  </joint>
  <link name="l1">
    <inertial><mass value="1.0"/><origin xyz="0.2 0 0"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.01"/></inertial>
  </link>
</robot>
"""
B = 8
POS_TOL, VEL_TOL = 2e-4, 2e-3


def _params(eng, sol, substeps=2, substep_contacts=False, **solver):
    return eng.SimParams(substeps=substeps, substep_contacts=substep_contacts,
                         solver=sol.SolverParams(**solver))


def tiny_scenes(tmp_path, objs, table_height=0.0, params=None, substeps=2):
    """(JAX scene, port scene) of tests/test_engine.py's `tiny_scene`: the
    arm at (0, 0, 1), its sphere of radius 5 cm 0.4 m along the link, a
    20 x 20 m table at `table_height`, kp 50 and kd 5. `objs`: (kind,
    size, mass) of box half extents or a sphere radius; `params`: keyword
    arguments of both packages' SimParams and SolverParams (`_params`)."""
    p = tmp_path / "tiny.urdf"
    p.write_text(TINY_ARM)
    params = params or {}
    make = lambda mod: [mod.make_box_object(s, mass=m) if k == "box"
                        else mod.make_sphere_object(s, mass=m) for k, s, m in objs]
    kw = dict(kp=np.full(1, 50.0), kd=np.full(1, 5.0), base_pos=(0.0, 0.0, 1.0))
    js = je.build_scene(
        compile_urdf(str(p)), jsh.stack_objects(make(jsh)),
        jc.RobotSpheres(body=np.array([0], np.int32),
                        offset=jnp.asarray([[0.4, 0.0, 0.0]], jnp.float32),
                        radius=jnp.asarray([0.05], jnp.float32),
                        friction=jnp.asarray([1.0], jnp.float32)),
        jc.StaticGeom(table_lo=jnp.asarray([-10.0, -10.0]), table_hi=jnp.asarray([10.0, 10.0]),
                      table_height=jnp.asarray(table_height), friction=jnp.asarray(1.0)),
        params=_params(je, jsv, substeps, **params), **kw)
    ts = te.build_scene(
        t_compile(str(p)), tsh.stack_objects(make(tsh)),
        tc.RobotSpheres(body=np.array([0], np.int32), offset=torch.tensor([[0.4, 0.0, 0.0]]),
                        radius=torch.tensor([0.05]), friction=np.ones(1, np.float32)),
        tc.StaticGeom(table_lo=torch.tensor([-10.0, -10.0]), table_hi=torch.tensor([10.0, 10.0]),
                      table_height=float(table_height), wall_lo=np.zeros((0, 3), np.float32),
                      wall_hi=np.zeros((0, 3), np.float32)),
        params=_params(te, tsv, substeps, **params), **kw)
    return js, ts


# the parity scene: the arm's sphere bottom 6 mm into the top of a box
# resting on the table (q = 0.76 puts the sphere at (0.295, 0, 0.824)); a
# sphere object 1 mm beside the box and 5 mm above the table, moving into
# the box at 0.3 m/s and falling at 1 m/s
PUSH_OBJS = (("box", [0.04, 0.04, 0.04], 0.05), ("sphere", 0.04, 0.1))
PUSH_POS = [[0.27, 0.0, 0.74], [0.27, 0.081, 0.745]]


def push_state(js, seed=0):
    """The parity scene's jittered state (a JAX PhysicsState)."""
    rng = np.random.default_rng(seed)
    C = js.slots.num_slots
    f = lambda x: jnp.asarray(x, jnp.float32)
    q = 0.76 + 0.01 * rng.standard_normal((B, 1))
    pos = np.asarray(PUSH_POS)[None] + 0.002 * rng.standard_normal((B, 2, 3))
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (B, 2, 1)) + 0.02 * rng.standard_normal((B, 2, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    lin = 0.1 * rng.standard_normal((B, 2, 3))
    lin[:, 1] += [0.0, -0.3, -1.0]
    return je.PhysicsState(
        robot=je.RobotState(q=f(q), qd=f(0.5 * rng.standard_normal((B, 1))),
                            targets=f(q + 0.3)),
        objects=je.ObjectState(pos=f(pos), quat=f(quat), linvel=f(lin),
                               angvel=f(rng.standard_normal((B, 2, 3)))),
        contact_impulse=f(0.005 * np.abs(rng.standard_normal((B, C, 3)))),
    )


def to_port(state):
    r, o = state.robot, state.objects
    return physics_state_from_leaves([np.asarray(x) for x in (
        r.q, r.qd, r.targets, o.pos, o.quat, o.linvel, o.angvel, state.contact_impulse)])


def _close(got, want, tol, name, scale=1.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol * scale,
                               err_msg=name)


# --- the solver ----------------------------------------------------------------


def _prepared(tmp_path, **solver):
    """Both packages' prep of the parity scene's contact set, and the
    velocities and warm start to solve from."""
    from handarm_tpu.physics.dynamics import compute_dyn as jdyn
    from handarm_tpu.physics.kinematics import forward_kinematics as jfk
    from handarm_tpu_torch.physics.dynamics import compute_dyn as tdyn
    from handarm_tpu_torch.physics.kinematics import forward_kinematics as tfk

    js, ts = tiny_scenes(tmp_path, PUSH_OBJS, table_height=0.7, params=solver)
    state = push_state(js)
    pst = to_port(state)
    h = js.params.dt / js.params.substeps
    jf = jfk(js.model, state.robot.q, js.base_quat[None], js.base_pos[None])
    tf = tfk(ts.model, pst.robot.q, ts.base_quat[None], ts.base_pos[None])
    o, to = state.objects, pst.objects
    jcon = jc.generate_contacts(js.slots, js.shapes, js.spheres, js.geom, o.pos, o.quat,
                                jf.body_quat, jf.body_pos)
    tcon = tc.generate_contacts(ts.slots, ts.shapes, ts.spheres, ts.geom, to.pos, to.quat,
                                tf.body_quat, tf.body_pos)
    jd = jdyn(js.model, jf, state.robot.qd, js.gravity, js.kp, js.kd, h)
    td = tdyn(ts.model, tf, pst.robot.qd, ts.gravity, ts.kp, ts.kd, h)
    sp_j, sp_t = js.params.solver, ts.params.solver
    jprep = jsv._prepare(js.model, jf, jd.Minv, js.slots, jcon, js.shapes, o.pos, o.quat, h,
                         sp_j)
    tprep = tsv.prepare(ts.model, tf, td.Minv, ts.maps, ts.slots, tcon, ts.shapes, to.pos,
                        to.quat, h, sp_t)
    return (js, jprep, state), (ts, tprep, pst)


SOLVER_CASES = {
    "soa": dict(),
    "soa, restitution 0.8": dict(restitution=0.8),
    "soa, no warm start": dict(),
    "aos": dict(jacobi_impl="aos"),
    "aos, restitution 0.8": dict(jacobi_impl="aos", restitution=0.8),
    "gs": dict(mode="gs"),
    "gs, restitution 0.8": dict(mode="gs", restitution=0.8),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solve_prepared_matches(tmp_path, case):
    """`solve_prepared` on one prepared contact set (8 sweeps) against the
    JAX package's: joint velocities, object velocities and world-frame
    impulses. "soa" runs the port's [B, C]-plane solve (the warm start
    reprojected and pre-applied, the sweep op with apply_warm=False: its
    plain version on CPU tensors), "aos" the [B, C, 3] Jacobi, "gs" sequential
    impulses; warm start from the previous impulses unless said. Impulses
    flowed on robot-object and object-pair slots; with restitution some
    slot approached faster than the threshold."""
    (js, jprep, state), (ts, tprep, pst) = _prepared(tmp_path, **SOLVER_CASES[case])
    warm = None if "no warm" in case else state.contact_impulse
    lv, av = state.objects.linvel, state.objects.angvel
    jout = jsv.solve_prepared(jprep, state.robot.qd, lv, av, js.params.solver, warm)
    tout = tsv.solve_prepared(tprep, ts.maps, pst.robot.qd, pst.objects.linvel,
                              pst.objects.angvel, ts.params.solver,
                              None if warm is None else pst.contact_impulse)
    for name, g, w in zip(("qd", "linvel", "angvel", "impulse"), tout, jout):
        _close(g, w, VEL_TOL, name)
    imp = np.abs(np.asarray(jout.impulse)).sum(-1)
    slots = js.slots
    assert imp[:, (slots.robot_body >= 0) & (slots.obj_b >= 0)].max() > 1e-4
    assert imp[:, (slots.obj_a >= 0) & (slots.obj_b >= 0)].max() > 1e-4
    if "restitution" in case:
        v = tsv.rel_velocity(tprep, ts.maps, pst.robot.qd, pst.objects.linvel,
                             pst.objects.angvel)
        vn0 = torch.sum(v * tprep.basis[:, :, 0], -1)
        assert bool(((vn0 < -0.2) & (tprep.active > 0)).any())


def test_solve_contacts_matches(tmp_path):
    """`solve_contacts` (prepare, then solve) from FK, Minv and the contact
    set, with DR's mass and friction scales, against the JAX package's."""
    from handarm_tpu.physics.dynamics import compute_dyn as jdyn
    from handarm_tpu.physics.kinematics import forward_kinematics as jfk
    from handarm_tpu_torch.physics.dynamics import compute_dyn as tdyn
    from handarm_tpu_torch.physics.kinematics import forward_kinematics as tfk

    js, ts = tiny_scenes(tmp_path, PUSH_OBJS, table_height=0.7)
    state = push_state(js, seed=1)
    pst = to_port(state)
    rng = np.random.default_rng(2)
    ms = rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32)
    fs = rng.uniform(0.7, 1.3, B).astype(np.float32)
    h = js.params.dt / js.params.substeps
    jf = jfk(js.model, state.robot.q, js.base_quat[None], js.base_pos[None])
    tf = tfk(ts.model, pst.robot.q, ts.base_quat[None], ts.base_pos[None])
    o, to = state.objects, pst.objects
    jcon = jc.generate_contacts(js.slots, js.shapes, js.spheres, js.geom, o.pos, o.quat,
                                jf.body_quat, jf.body_pos)
    tcon = tc.generate_contacts(ts.slots, ts.shapes, ts.spheres, ts.geom, to.pos, to.quat,
                                tf.body_quat, tf.body_pos)
    jd = jdyn(js.model, jf, state.robot.qd, js.gravity, js.kp, js.kd, h)
    td = tdyn(ts.model, tf, pst.robot.qd, ts.gravity, ts.kp, ts.kd, h)
    jout = jsv.solve_contacts(js.model, jf, jd.Minv, js.slots, jcon, js.shapes, o.pos,
                              o.quat, state.robot.qd, o.linvel, o.angvel, h,
                              js.params.solver, state.contact_impulse,
                              mass_scale=jnp.asarray(ms), friction_scale=jnp.asarray(fs))
    tout = tsv.solve_contacts(ts.model, tf, td.Minv, ts.maps, ts.slots, tcon, ts.shapes,
                              to.pos, to.quat, pst.robot.qd, to.linvel, to.angvel, h,
                              ts.params.solver, pst.contact_impulse,
                              mass_scale=torch.as_tensor(ms), friction_scale=torch.as_tensor(fs))
    for name, g, w in zip(("qd", "linvel", "angvel", "impulse"), tout, jout):
        _close(g, w, VEL_TOL, name)


def test_soa_sweep_without_warm_apply_matches_pallas_route(tmp_path):
    """The port's `solve_jacobi_soa` (the warm start applied before the
    sweeps, then the sweep op's plain version with apply_warm=False)
    against the JAX package's `_solve_jacobi_soa` with
    jacobi_impl="pallas": its `_pallas_sweeps` route, the Pallas sweep
    kernel in interpret mode."""
    (js, jprep, state), (ts, tprep, pst) = _prepared(tmp_path, restitution=0.8)
    sp = js.params.solver._replace(jacobi_impl="pallas")
    assert jsv._use_pallas_sweeps(sp, B, js.slots.num_slots)
    want = jsv._solve_jacobi_soa(jprep, state.robot.qd, state.objects.linvel,
                                 state.objects.angvel, sp, state.contact_impulse)
    got = tsv.solve_jacobi_soa(tprep, ts.maps, pst.robot.qd, pst.objects.linvel,
                               pst.objects.angvel, ts.params.solver, pst.contact_impulse)
    for name, g, w in zip(("qd", "linvel", "angvel", "impulse"), got, want):
        _close(g, w, VEL_TOL, name)


def test_gs_prep_matches(tmp_path):
    """Gauss-Seidel's per-slot Jacobian and Minv J^T columns, and no deff
    kernel under mode="gs" (the JAX rule)."""
    (js, jprep, _), (ts, tprep, _) = _prepared(tmp_path, mode="gs", jacobi_impl="pallas")
    _close(tprep.J, jprep.J, 1e-5, "J")
    _close(tprep.MinvJT, jprep.MinvJT, 1e-5, "MinvJT",
           scale=float(np.abs(np.asarray(jprep.MinvJT)).max()))
    assert not tsv.use_deff_kernel(ts.params.solver, B, ts.slots.num_slots, "cpu")


# --- the engine ------------------------------------------------------------------


def test_initial_state_matches(tmp_path):
    """`initial_state` of a fixed-base scene, with and without poses (a base
    pose is ignored there, as in the JAX package), and of the Quadcopter's
    floating base, with and without base_pos0 / base_quat0: bit for bit."""
    js, ts = tiny_scenes(tmp_path, PUSH_OBJS, table_height=0.7)
    for kw in (dict(), dict(q0=[0.3], obj_pos0=PUSH_POS,
                            obj_quat0=[[0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]]),
               dict(base_pos0=[0.1, 0.2, 0.3])):
        want = je.initial_state(js, 3, **{k: jnp.asarray(v) for k, v in kw.items()})
        got = te.initial_state(ts, 3, **{k: torch.tensor(v) for k, v in kw.items()})
        assert got.robot.base_pos is None and want.robot.base_pos is None
        _assert_same_leaves(got, want)
    from handarm_tpu_torch.envs.quadcopter import QuadcopterEnv as TQuad
    from test_torch_floating import jax_env

    jq, tq = jax_env("quadcopter", str(tmp_path), num_envs=3), TQuad(device="cpu")
    rng = np.random.default_rng(2)
    quat = rng.standard_normal(4)
    for kw in (dict(), dict(q0=np.r_[np.zeros(6), rng.uniform(-0.2, 0.2, 8)]),
               dict(base_pos0=rng.standard_normal(3), base_quat0=quat / np.linalg.norm(quat)),
               dict(base_pos0=rng.standard_normal((3, 3)))):
        kw = {k: np.asarray(v, np.float32) for k, v in kw.items()}
        want = je.initial_state(jq.scene, 3, **{k: jnp.asarray(v) for k, v in kw.items()})
        got = te.initial_state(tq.scene, 3, **{k: torch.tensor(v) for k, v in kw.items()})
        assert got.robot.base_pos.shape == (3, 3) and got.robot.base_quat.shape == (3, 4)
        _assert_same_leaves(got, want)


def physics_state_leaves(s):
    return [s.robot.q, s.robot.qd, s.robot.targets, *s.objects, s.contact_impulse]


def _jax_leaves(s):
    return [np.asarray(x) for x in (s.robot.q, s.robot.qd, s.robot.targets, *s.objects,
                                    s.contact_impulse)]


def _assert_same_leaves(got, want):
    """Every leaf of a port PhysicsState equal, dtype and all, to the JAX
    state's (None fields absent on both sides)."""
    g = [x for x in (*got.robot, *got.objects, got.contact_impulse) if x is not None]
    w = [np.asarray(x) for x in (*want.robot, *want.objects, want.contact_impulse)
         if x is not None]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


# path -> (SimParams / SolverParams keywords, how the two sim steps are run)
ENGINE_PATHS = {
    "heavy every sim step": (dict(), "plain"),
    "heavy once, exact FK": (dict(), "heavy"),
    "substep contacts": (dict(substep_contacts=True), "plain"),
    "substep": (dict(), "substep"),
    "generic anchored, restitution 0.8": (dict(restitution=0.8), "plain"),
    "generic anchored, gs": (dict(mode="gs"), "plain"),
}


def _two_steps(eng, scene, state, how):
    """Two sim steps of a path: `step(scene, state)` ("plain"), against one
    compute_heavy ("heavy"), or `step(..., shared_prep=False)`."""
    if how == "heavy":
        heavy = eng.compute_heavy(scene, state)
        for _ in range(2):
            state, info = eng.step(scene, state, heavy=heavy)[:2]
        return state, info
    for _ in range(2):
        state, info = eng.step(scene, state, shared_prep=how != "substep")[:2]
    return state, info


@pytest.mark.parametrize("path", list(ENGINE_PATHS))
def test_engine_path_matches(tmp_path, path):
    """Two sim steps of each cadence from the parity scene's state: the state
    and StepInfo against the JAX package's. The port's "heavy every sim
    step" and "exact FK" paths take the fused anchored form, the JAX
    package on the CPU its generic loop (as tests/test_torch_physics.py
    holds the default path); restitution and Gauss-Seidel take the generic
    loop on both sides."""
    kw, how = ENGINE_PATHS[path]
    js, ts = tiny_scenes(tmp_path, PUSH_OBJS, table_height=0.7, params=kw)
    state = push_state(js)
    jout, jinfo = _two_steps(je, js, state, how)
    tout, tinfo = _two_steps(te, ts, to_port(state), how)
    if path.startswith(("heavy", "generic")):  # the anchored paths' form
        assert te.fused_anchored(ts.params) == path.startswith("heavy")
    tols = (POS_TOL, VEL_TOL, POS_TOL, POS_TOL, POS_TOL, VEL_TOL, VEL_TOL, VEL_TOL)
    names = ("q", "qd", "targets", "pos", "quat", "linvel", "angvel", "impulse")
    for name, g, w, tol in zip(names, physics_state_leaves(tout), _jax_leaves(jout), tols):
        _close(g, w, tol, name)
    h = js.params.dt / js.params.substeps
    _close(tinfo.body_contact_force, jinfo.body_contact_force, VEL_TOL / h, "body force")
    _close(tinfo.obj_contact_force, jinfo.obj_contact_force, VEL_TOL / h, "object force")
    _close(tinfo.max_penetration, jinfo.max_penetration, POS_TOL, "max_penetration")
    assert np.abs(np.asarray(jout.contact_impulse)).max() > 1e-3


def test_step_returns_carried_fk(tmp_path):
    """`carry_fk`: the propagated FK comes back third where asked (by
    default where `fk0` is given), and under substep_contacts it is the
    substep loop's own; shared_prep=False refuses a heavy prep."""
    js, ts = tiny_scenes(tmp_path, PUSH_OBJS, table_height=0.7,
                         params=dict(substep_contacts=True))
    state = push_state(js)
    _, _, jfk = je.step(js, state, carry_fk=True)
    out = te.step(ts, to_port(state), carry_fk=True)
    assert len(out) == 3 and len(te.step(ts, to_port(state))) == 2
    for g, w in zip(out[2], jfk):
        _close(g, w, POS_TOL, "fk")
    with pytest.raises(ValueError):
        te.step(ts, to_port(state), te.compute_heavy(ts, to_port(state)), shared_prep=False)


# --- behaviour probes of tests/test_engine.py through the port ----------------


def _port_scene(tmp_path, objs, table_height=0.0, **params):
    return tiny_scenes(tmp_path, objs, table_height, params)[1]


def _run(scene, state, n, heavy_every=None):
    """n sim steps of `step(scene, state)`, or with the mass structure
    refreshed every `heavy_every` steps (`step(scene, state, heavy)`)."""
    for i in range(n):
        if heavy_every is None:
            state, _ = te.step(scene, state)
        else:
            if i % heavy_every == 0:
                heavy = te.compute_heavy(scene, state)
            state, _ = te.step(scene, state, heavy)
    return state


@pytest.mark.parametrize("heavy_every", [None, 3])
def test_box_drop_settles(tmp_path, heavy_every):
    """A box dropped from 0.3 m settles on the table at its half height
    within 1 cm and comes to rest (tests/test_engine.py, every sim step and
    under the heavy cadence)."""
    scene = _port_scene(tmp_path, [("box", [0.03, 0.04, 0.05], 0.2)], table_height=0.5)
    state = te.initial_state(scene, 4, obj_pos0=torch.tensor([[0.5, 0.0, 0.8]]))
    state = _run(scene, state, 90, heavy_every)
    np.testing.assert_allclose(state.objects.pos[:, 0, 2].numpy(), 0.55, atol=0.01)
    assert float(state.objects.linvel.abs().max()) < 0.05


def _apex(scene, t0):
    state = te.initial_state(scene, 2, obj_pos0=torch.tensor([[0.5, 0.2, 0.54]]))
    apex = 0.0
    for t in range(70):
        state, _ = te.step(scene, state)
        if t > t0:
            apex = max(apex, float(state.objects.pos[:, 0, 2].min()) - 0.04)
    return apex


def test_restitution_bounce(tmp_path):
    """A sphere dropped 0.5 m with restitution 0.8 rebounds to an apex of
    0.18-0.45 m (~0.8^2 of its fall); at 0 it stays within 5 cm."""
    bounce = _apex(_port_scene(tmp_path, [("sphere", 0.04, 0.1)], restitution=0.8), 22)
    dead = _apex(_port_scene(tmp_path, [("sphere", 0.04, 0.1)]), 26)
    assert 0.18 < bounce < 0.45, bounce
    assert dead < 0.05, dead


STACK = [("box", [0.05, 0.05, 0.05], 0.3), ("box", [0.04, 0.04, 0.04], 0.2)]
STACK_POS = torch.tensor([[0.5, 0.0, 0.06], [0.5, 0.0, 0.2]])


def test_jacobi_vs_gs(tmp_path):
    """Jacobi and Gauss-Seidel settle the same two-box stack (120 sim steps)
    to within 0.02 m and the arm to within 0.05 rad, both as stacks."""
    finals = {}
    for mode in ("jacobi", "gs"):
        scene = _port_scene(tmp_path, STACK, mode=mode)
        state = _run(scene, te.initial_state(scene, 1, obj_pos0=STACK_POS), 120)
        finals[mode] = (state.objects.pos[0].numpy(), state.robot.q[0].numpy())
    np.testing.assert_allclose(finals["jacobi"][0], finals["gs"][0], atol=0.02)
    np.testing.assert_allclose(finals["jacobi"][1], finals["gs"][1], atol=0.05)
    np.testing.assert_allclose(finals["jacobi"][0][:, 2], [0.05, 0.14], atol=0.015)


@pytest.mark.parametrize("heavy_every", [None, 3])
def test_two_box_stack(tmp_path, heavy_every):
    """Two boxes stacked stay stacked over 150 sim steps: the lower at 0.05 m,
    the upper at 0.14 m (every sim step and under the heavy cadence)."""
    scene = _port_scene(tmp_path, STACK)
    state = _run(scene, te.initial_state(scene, 2, obj_pos0=STACK_POS), 150, heavy_every)
    z = state.objects.pos[0, :, 2].numpy()
    np.testing.assert_allclose(z[0], 0.05, atol=0.01)
    np.testing.assert_allclose(z[1], 0.14, atol=0.015)
