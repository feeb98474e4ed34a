"""FrankaCabinet, the engine's rails and the compound-box drawer: the port
against the JAX package on the CPU, on the in-repo stand-in Franka (the
JAX env reads it through a monkeypatched
`handarm_tpu.envs.franka_cabinet.FRANKA_URDF`).

- `shapes.make_compound_box_object` equal to the JAX function, array for
  array (the 32^3 grid, the contact points, the inertia, the bounds and
  the grid's corner and spacing), on the drawer's five boxes re-centred on
  their centre of mass (`_drawer_record`) and on a seeded L of three boxes.
- `engine._apply_rails` against the JAX function on a synthetic [B = 6, K
  = 3] state: a prismatic rail along a tilted axis, a free object, and a
  rail along world z, prismatic or cylindrical (`spin`); the envs' rail
  coordinates lie below the lower limit, between the limits and above the
  upper one, with velocities into and out of each limit (within 1e-6).
- One engine step of the cabinet scene at B = 4 (the drawer on its rail:
  closed and pushed in past its lower limit, mid-travel, against the
  fingers, past its upper limit) under every cadence (the engine's own
  sim step, one heavy prep with exact FK, with the carried FK, contacts
  regenerated every substep, `substep`), and with the drawer on a
  cylindrical z rail instead (its yaw kept, its tilt projected out),
  against the JAX engine: every state leaf within 2e-4 (positions) or
  2e-3 (velocities, impulses) of max(1, its largest value). The port's
  own sim step takes the fused anchored form, the JAX package's on the CPU
  its generic loop (as tests/test_torch_engine.py holds them).
- The reset from the JAX package's draws (re-derived from its keys and
  handed to the port's `reset` / `step`), exactly; then, from the JAX
  state with the drawer placed per env (closed, mid-travel, against the
  gripper at 0.25-0.36 m, just past the 0.39 m success line), 2 steps at B
  = 8 with random actions on both, env 1 timing out at the first and env
  6 opening: observations and rewards within 2e-3 times max(1, the
  largest value), every state leaf within 2e-4 (positions) or 2e-3
  (velocities, impulses) of the same scale, done flags exactly, the info
  within 2e-4. The drawer's field is sampled through the sdf_gather
  wrapper's plain version here (CPU tensors), which launches nothing.
- The JAX package's own check of tests/test_franka.py:73-110, in both
  packages: the drawer stays closed and unrotated under 30 zero-action
  steps, a shove slides it along +x only, clamped at 0.4, and the opened
  drawer scores above the closed one.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.envs import franka_cabinet as jcab
from handarm_tpu.physics import engine as je
from handarm_tpu.physics import shapes as jsh
from handarm_tpu_torch.convert import classic_state_from_leaves, physics_state_from_leaves
from handarm_tpu_torch.envs import franka as tfr
from handarm_tpu_torch.envs import franka_cabinet as tcab
from handarm_tpu_torch.ops import sdf_gather as tsdf
from handarm_tpu_torch.physics import engine as te
from handarm_tpu_torch.physics import shapes as tsh

torch.set_num_threads(1)
B = 8
POS_TOL, VEL_TOL = 2e-4, 2e-3
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def jax_cabinet():
    """The JAX package's FrankaCabinet at B = 8 on the stand-in, and its
    jitted step (compiled once for the module)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcab, "FRANKA_URDF", tfr.FRANKA_URDF)
        env = jcab.make_franka_cabinet(num_envs=B)
    return env, jax.jit(env.step)


def fresh_draws(key, B: int):
    kq, _ = jax.random.split(key)
    return tcab.CabinetDraws(_t(jax.random.uniform(kq, (B, 9))))


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


PHYSICS = (("q", POS_TOL), ("qd", VEL_TOL), ("targets", POS_TOL), ("opos", POS_TOL),
           ("oquat", POS_TOL), ("olin", VEL_TOL), ("oang", VEL_TOL), ("impulse", VEL_TOL))


def _physics_close(got, want, tag):
    g = [x for x in (*got.robot, *got.objects, got.contact_impulse) if x is not None]
    w = [x for x in (*want.robot, *want.objects, want.contact_impulse) if x is not None]
    assert len(g) == len(w) == len(PHYSICS)
    for (name, tol), a, b in zip(PHYSICS, g, w):
        _close(a, b, tol, f"{name} ({tag})")


# --- the compound box and the rails -------------------------------------------------


def _l_parts():
    rng = np.random.default_rng(11)
    return [(rng.uniform(-0.05, 0.05, 3), rng.uniform(0.01, 0.06, 3)) for _ in range(3)]


@pytest.mark.parametrize("shape", ["drawer", "L"])
def test_compound_box_matches(shape):
    if shape == "drawer":
        (want, jcom), (got, tcom) = jcab._drawer_record(), tcab._drawer_record()
        np.testing.assert_array_equal(tcom, jcom)
    else:
        want = jsh.make_compound_box_object(_l_parts(), mass=0.7, sdf_resolution=24)
        got = tsh.make_compound_box_object(_l_parts(), mass=0.7, sdf_resolution=24)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    R = 32 if shape == "drawer" else 24
    assert got["kind"] == tsh.MESH_SDF and got["sdf_grid"].shape == (R, R, R)
    assert (got["sdf_grid"] < 0).any() and (got["sdf_grid"] > 0).any()
    if shape == "drawer":  # re-centred: the parts' com at the body origin
        assert len(got["points"]) == 50


def _rails(pkg, spin: bool):
    """K = 3: a rail along a tilted axis, a free object, a rail along z."""
    ax = np.array([[0.6, 0.0, 0.8], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    kw = dict(axis=ax, origin=np.array([[0.1, 0.2, 0.3], [0, 0, 0], [-0.2, 0.1, 0.5]],
                                       np.float32),
              quat=np.array([[1, 0, 0, 0], [1, 0, 0, 0], [0.8, 0.6, 0, 0]], np.float32),
              lo=np.array([-0.1, 0.0, -0.05], np.float32),
              hi=np.array([0.2, 0.0, 0.15], np.float32),
              damping=np.array([2.0, 0.0, 5.0], np.float32),
              mask=np.array([1.0, 0.0, 1.0], np.float32),
              spin=np.array([0.0, 0.0, 1.0], np.float32) if spin else None)
    conv = jnp.asarray if pkg is je else torch.as_tensor
    return pkg.RailSpec(**{k: None if v is None else conv(v) for k, v in kw.items()})


@pytest.mark.parametrize("mode", ["prismatic", "spin"])
def test_apply_rails_matches(mode):
    rng = np.random.default_rng(12)
    n = 6
    jr = _rails(je, mode == "spin")
    # rail coordinates below lo, between, above hi (both rails), off-line offsets
    s = np.array([-0.3, -0.1, 0.05, 0.1, 0.2, 0.5], np.float32)
    origin, axis = np.asarray(jr.origin), np.asarray(jr.axis)
    opos = origin[None] + s[:, None, None] * axis[None] + rng.normal(0, 0.02, (n, 3, 3))
    q = rng.normal(size=(n, 3, 4))
    oquat = q / np.linalg.norm(q, axis=-1, keepdims=True)
    olv = rng.normal(0, 0.5, (n, 3, 3))
    olv[:3] -= 2.0 * axis[None]  # into the lower limit, then out of the upper one
    olv[3:] += 2.0 * axis[None]
    oav = rng.normal(0, 2.0, (n, 3, 3))
    args = [x.astype(np.float32) for x in (opos, oquat, olv, oav)]
    want = je._apply_rails(types.SimpleNamespace(rails=jr), *map(jnp.asarray, args), 1 / 120)
    got = te._apply_rails(_rails(te, mode == "spin"), *map(_t, args), 1 / 120)
    for name, g, w in zip(("pos", "quat", "linvel", "angvel"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=name)
    got_s = torch.einsum("bki,ki->bk", got[0] - _t(origin), _t(axis))
    assert (got_s[:, 0] >= -0.1 - 1e-6).all() and (got_s[:, 0] <= 0.2 + 1e-6).all()
    np.testing.assert_array_equal(got[0][:, 1].numpy(), args[0][:, 1])  # the free one
    if mode == "spin":  # the z rail keeps its yaw and its spin about z
        assert (got[1][:, 2, 1:3].abs() < 1e-7).all() and (got[3][:, 2, :2] == 0).all()
        assert (got[3][:, 2, 2].abs() > 0).all()


# --- one engine step of the railed scene under every cadence --------------------------


def _scenes(jenv, tenv, how):
    js, ts = jenv.scene, tenv.scene
    if how == "substep contacts":
        js = js._replace(params=js.params._replace(substep_contacts=True))
        ts = dataclasses.replace(ts, params=ts.params._replace(substep_contacts=True))
    elif how == "spin":  # the drawer on a cylindrical z rail through its closed pose
        c = np.asarray(jenv.drawer_closed_pos, np.float32)
        kw = dict(axis=[[0.0, 0.0, 1.0]], origin=[c], quat=[[1.0, 0, 0, 0]], lo=[-0.05],
                  hi=[0.05], damping=[2.0], mask=[1.0], spin=[1.0])
        js = js._replace(rails=je.RailSpec(**{k: jnp.asarray(np.float32(v))
                                              for k, v in kw.items()}))
        ts = dataclasses.replace(ts, rails=te.RailSpec(**{k: torch.tensor(np.float32(v))
                                                          for k, v in kw.items()}))
    return js, ts


def _cadence_state(jenv):
    """The cabinet at B = 4: the drawer per env pushed in past its lower
    limit, mid-travel, against the fingers, past its upper limit, moving,
    tilted and spinning."""
    js, _ = jenv.reset(jax.random.PRNGKey(7))
    p = js.physics
    rng = np.random.default_rng(13)
    c = np.asarray(jenv.drawer_closed_pos, np.float32)
    s = np.array([-0.01, 0.15, 0.33, 0.42], np.float32)
    pos = c[None, None] + np.stack([s, 0.01 * rng.normal(size=4), 0.01 * rng.normal(size=4)],
                                   -1)[:, None]
    q = np.concatenate([np.ones((4, 1, 1)), 0.1 * rng.normal(size=(4, 1, 3))], -1)
    f = lambda x: jnp.asarray(np.asarray(x, np.float32)[:4])
    objects = p.objects._replace(
        pos=f(pos), quat=f(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        linvel=f(rng.normal(0, 0.4, (4, 1, 3))), angvel=f(rng.normal(0, 1.0, (4, 1, 3))))
    r = p.robot
    robot = r._replace(q=r.q[:4], qd=f(rng.normal(0, 0.3, (4, 9))), targets=r.targets[:4])
    return p._replace(robot=robot, objects=objects, contact_impulse=p.contact_impulse[:4])


CADENCES = ["the sim step", "heavy once, exact FK", "carried FK", "substep contacts",
            "substep", "spin"]


def _one_step(eng, scene, state, how):
    if how in ("heavy once, exact FK", "carried FK"):
        heavy = eng.compute_heavy(scene, state)
        if how == "carried FK":
            return eng.step(scene, state, heavy=heavy, fk0=heavy.fk0,
                            contacts0=heavy.contacts0, carry_fk=True)[0]
        return eng.step(scene, state, heavy=heavy)[0]
    return eng.step(scene, state, shared_prep=how != "substep")[0]


@pytest.mark.parametrize("how", CADENCES)
def test_railed_step_matches(jax_cabinet, how):
    jenv, _ = jax_cabinet
    tenv = tcab.make_franka_cabinet(num_envs=4, device="cpu")
    js, ts = _scenes(jenv, tenv, how)
    state = _cadence_state(jenv)
    want = _one_step(je, js, state, how)
    got = _one_step(te, ts, physics_state_from_leaves(
        [np.asarray(x) for x in jax.tree.leaves(state)]), how)
    _physics_close(got, want, how)
    pos, quat = got.objects.pos[:, 0], got.objects.quat[:, 0]
    c = torch.as_tensor(np.float32(tenv.drawer_closed_pos))
    if how == "spin":  # on the z line, within its limits, only yawed
        assert torch.allclose(pos[:, :2], c[:2].expand(4, 2))
        assert ((pos[:, 2] - c[2]).abs() <= 0.05 + 1e-6).all()
        assert (quat[:, 1:3].abs() < 1e-7).all()
    else:  # on the +x line within [0, 0.4], unrotated
        assert torch.allclose(pos[:, 1:], c[1:].expand(4, 2))
        s = pos[:, 0] - c[0]
        assert (s >= 0).all() and (s <= 0.4 + 1e-6).all()
        assert torch.equal(quat, torch.tensor([[1.0, 0, 0, 0]]).expand(4, 4))
    assert float(np.abs(np.asarray(want.contact_impulse)).max()) > 1e-3


# --- env steps ----------------------------------------------------------------------


def test_cabinet_reset_and_steps_match(jax_cabinet):
    jenv, step = jax_cabinet
    tenv = tcab.make_franka_cabinet(num_envs=B, device="cpu")
    sc = tenv.scene
    assert (tenv.num_obs, tenv.num_actions, sc.slots.num_slots, sc.shapes.num_objects) == (
        jenv.num_obs, jenv.num_actions, jenv.scene.slots.num_slots, 1) == (23, 9, 190, 1)
    assert sc.geom.num_walls == 4 and sc.slots.queries.sdf.table is not None
    np.testing.assert_array_equal(tenv.drawer_closed_pos, jenv.drawer_closed_pos)
    key = jax.random.PRNGKey(2)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key, B))
    _close(tobs, jobs, 1e-6, "reset obs")
    _physics_close(ts.physics, js.physics, "reset")

    # the drawer per env: closed, mid-travel, against the gripper, past the line
    s = np.array([0.0, 0.0, 0.12, 0.25, 0.3, 0.33, 0.395, 0.36], np.float32)
    opos = np.asarray(js.physics.objects.pos).copy()
    opos[:, 0, 0] += s
    olin = np.zeros_like(opos)
    olin[:, 0, 0] = np.array([0.0, 0.2, -0.3, 0.4, 0.0, 0.3, 0.0, -0.2])
    prog = np.asarray(js.progress).copy()
    prog[1] = jenv.cfg.episode_length - 1  # env 1 times out at the first step
    objects = js.physics.objects._replace(pos=jnp.asarray(opos), linvel=jnp.asarray(olin))
    js = js._replace(progress=jnp.asarray(prog), physics=js.physics._replace(objects=objects))
    ts = classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(js)],
                                   tcab.CabinetState)
    slots = jenv.scene.slots
    robot_drawer = (slots.robot_body >= 0) & (slots.obj_b == 0)
    rng = np.random.default_rng(6)
    before = tsdf.launches
    for i in range(2):
        a = rng.uniform(-1.0, 1.0, (B, 9)).astype(np.float32)
        draws = fresh_draws(jax.random.split(js.key)[1], B)
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"drawer_pos_mean", "opened_frac"}
        for k in tr.info:
            _close(tr.info[k], jr.info[k], POS_TOL, k)
        _physics_close(ts.physics, js.physics, f"step {i}")
        for name, a_, b_ in (("targets", ts.targets, js.targets),
                             ("actions", ts.actions, js.actions)):
            _close(a_, b_, POS_TOL, name)
        np.testing.assert_array_equal(ts.progress.numpy(), np.asarray(js.progress))
        if i == 0:
            np.testing.assert_array_equal(tr.done.numpy(), np.isin(np.arange(B), [1, 6]))
            imp = np.abs(np.asarray(js.physics.contact_impulse)).sum(-1)
            assert (imp[:, robot_drawer].sum(-1) > 0).sum() >= 2  # fingers on the drawer
    assert tsdf.launches == before  # the plain version on CPU tensors


# --- the JAX package's own check, in both packages -----------------------------------


def test_drawer_rail_in_both(jax_cabinet):
    jenv, step = jax_cabinet
    tenv = tcab.make_franka_cabinet(num_envs=B, device="cpu")
    key = jax.random.PRNGKey(0)
    js, _ = jenv.reset(key)
    ts, _ = tenv.reset(0, fresh_draws(key, B))
    for _ in range(30):
        js, jr = step(js, jnp.zeros((B, 9)))
        ts, tr = tenv.step(ts, torch.zeros(B, 9))
    closed = np.tile(jenv.drawer_closed_pos, (B, 1))
    shove = np.tile(np.array([0.6, 0.3, 0.3], np.float32), (B, 1))
    runs = {}
    for name, env, state, res, run in (("jax", jenv, js, jr, lambda s: step(s, jnp.zeros((B, 9)))),
                                       ("port", tenv, ts, tr,
                                        lambda s: tenv.step(s, torch.zeros(B, 9)))):
        p = np.asarray(state.physics.objects.pos[:, 0])
        np.testing.assert_allclose(p, closed, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(np.asarray(state.physics.objects.quat[:, 0]),
                                   np.tile([1.0, 0, 0, 0], (B, 1)), atol=1e-5, err_msg=name)
        assert np.isfinite(np.asarray(res.obs)).all(), name
        lv = state.physics.objects.linvel
        lv = lv.at[:, 0].set(jnp.asarray(shove)) if name == "jax" else torch.cat(
            [_t(shove)[:, None], lv[:, 1:]], 1)
        s2 = state._replace(physics=state.physics._replace(
            objects=state.physics.objects._replace(linvel=lv)))
        for _ in range(60):
            s2, r2 = run(s2)
        p2 = np.asarray(s2.physics.objects.pos[:, 0])
        s_open = p2[:, 0] - env.drawer_closed_pos[0]
        assert (s_open > 0.05).all() and (s_open <= 0.4 + 1e-4).all(), (name, s_open)
        np.testing.assert_allclose(p2[:, 1:], closed[:, 1:], atol=1e-3, err_msg=name)
        _, r_closed = run(state)
        _, r_open = run(s2)
        assert float(r_open.reward.mean()) > float(r_closed.reward.mean()), name
        runs[name] = s_open
    np.testing.assert_allclose(runs["port"], runs["jax"], atol=1e-3)
