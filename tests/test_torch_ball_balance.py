"""BallBalance: the port against the JAX package on the CPU, on the in-repo
stand-in balance bot (handarm_tpu_torch/assets/classic_standin/
balance_bot.xml; the JAX env reads it through a monkeypatched
`handarm_tpu.envs.ball_balance.BBOT_MJCF`).

- The stand-in parses and compiles alike in both packages (links, joints,
  extras and the 80 collision spheres exactly; the compiled arrays within
  1e-6) and gives the task's widths: nv 12, 24 observations, 3 actions
  (the three `lower` joints), 161 contact slots (the ball's point, 80
  spheres vs the ground, 80 vs the ball), 2.701 kg.
- The reset from the JAX package's draws (re-derived from its keys and
  handed to the port's `reset` / `step`: one uniform draw gives the spawn's
  angle and radius, as the JAX package draws both from one key), exactly;
  then the JAX env steps with zero actions until the balls lie on the
  trays, its state goes to the port, env 0's ball is put below the fall
  height off the tray, and 2 steps at B = 8 with random actions run on
  both: env 0 restarts from the injected draws at the first, the others'
  balls push on their trays (robot-ball impulses in all 7 other envs before
  the first step and in 5 or more before the second, the random actions
  making balls hop; non-zero tray-force observations in the same 5 or more
  envs after each step on both sides, asserted). Tolerances as
  tests/test_torch_locomotion.py states them: observations and rewards
  within 2e-3 times max(1, the largest value), every state leaf within
  2e-4 (positions) or 2e-3 (velocities, impulses) of the same scale, done
  flags exactly.
- The tripod check of tests/test_anymal.py::test_ball_balance_spaces_and_physics
  in both packages from the same reset (B = 8, 240 zero-action steps): the
  tray stays above 0.3 m, the observations finite, and at least one ball
  rolls off and respawns.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.envs import ball_balance as jbb
from handarm_tpu.physics import mjcf as jmjcf
from handarm_tpu.physics import model as jmodel
from handarm_tpu_torch.convert import classic_state_from_leaves
from handarm_tpu_torch.envs import ball_balance as tbb
from handarm_tpu_torch.physics import mjcf as tmjcf
from handarm_tpu_torch.physics import model as tmodel
from test_torch_locomotion import _compare_models

torch.set_num_threads(1)
B = 8
POS_TOL, VEL_TOL = 2e-4, 2e-3
SETTLE = 40  # zero-action steps until the balls lie on the trays
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture
def jax_env(monkeypatch):
    """The JAX package's env factory on the stand-in."""
    monkeypatch.setattr(jbb, "BBOT_MJCF", tbb.BBOT_MJCF)
    return jbb.make_ball_balance


def fresh_draws(key, B: int) -> tbb.BallDraws:
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, B)`
    makes."""
    k_pos, k_h, k_v, _ = jax.random.split(key, 4)
    u = jax.random.uniform
    return tbb.BallDraws(_t(u(k_pos, (B,), minval=0.0, maxval=2 * np.pi)),
                         _t(u(k_pos, (B,), minval=0.0, maxval=0.15)),
                         _t(u(k_h, (B,), minval=1.0, maxval=2.0)),
                         _t(u(k_v, (B,), minval=0.0, maxval=2.0)))


def port_state(jstate):
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     tbb.BBotState)


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


LEAF_NAMES = ("q", "qd", "targets", "base_pos", "base_quat", "opos", "oquat", "olin", "oang",
              "impulse", "env targets", "progress", "actions")
VELOCITY_LEAVES = ("qd", "olin", "oang", "impulse")


def assert_state_close(got, want):
    p = got.physics
    leaves = [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        got[1:])
    g = jax.tree.leaves(want)
    assert len(leaves) == len(g) - 1 == len(LEAF_NAMES)  # the JAX key
    for name, a, b in zip(LEAF_NAMES, leaves, g):
        if a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            _close(a, b, VEL_TOL if name in VELOCITY_LEAVES else POS_TOL, name)


def robot_ball_impulse(env, impulse):
    """[B] summed |impulse| of the robot-ball slots."""
    sl = env.scene.slots
    rb = (np.asarray(sl.robot_body) >= 0) & (np.asarray(sl.obj_b) >= 0)
    return np.abs(np.asarray(impulse)[:, rb]).sum((1, 2))


def test_standin_compiles_alike(jax_env):
    path = tbb.BBOT_MJCF
    ju, jx = jmjcf.parse_mjcf(path)
    tu, tx = tmjcf.parse_mjcf(path)
    assert list(tu.links) == list(ju.links)
    assert [j.name for j in tu.joints] == [j.name for j in ju.joints]
    assert (tx.floating, tx.root_body) == (jx.floating, jx.root_body) == (True, "tray")
    assert list(tx.link_spheres) == list(jx.link_spheres)
    for name, sph in jx.link_spheres.items():
        for (p, r), (jp, jr) in zip(tx.link_spheres[name], sph, strict=True):
            np.testing.assert_array_equal(p, jp)
            assert r == jr
    ja = jmodel.compile_model(ju, floating_base=True, default_density=1000.0)
    ta = tmodel.compile_model(tu, floating_base=True, default_density=1000.0)
    _compare_models(ta, ja)
    assert abs(float(ta.mass.sum()) - 2.701) < 1e-3

    jenv, tenv = jax_env(num_envs=4), tbb.make_ball_balance(num_envs=4, device="cpu")
    assert (tenv.art.nv, tenv.num_obs, tenv.num_actions, tenv.scene.slots.num_slots) == (
        jenv.art.nv, jenv.num_obs, jenv.num_actions, jenv.scene.slots.num_slots) == (
        12, 24, 3, 161)
    np.testing.assert_array_equal(tenv.actuated, jenv.actuated)
    assert tenv.tray_body == jenv.tray_body == 0
    js, ts = jenv.scene, tenv.scene
    assert len(ts.spheres.body) == 80
    np.testing.assert_array_equal(ts.spheres.body, np.asarray(js.spheres.body))
    np.testing.assert_allclose(ts.spheres.offset.numpy(), np.asarray(js.spheres.offset),
                               atol=1e-7)
    np.testing.assert_array_equal(ts.spheres.radius.numpy(), np.asarray(js.spheres.radius))
    for f in ("robot_body", "obj_a", "obj_b", "friction"):
        np.testing.assert_array_equal(getattr(ts.slots, f), np.asarray(getattr(js.slots, f)))
    for f in ("mass", "inertia_diag", "point_radius", "bound_radius"):
        np.testing.assert_allclose(getattr(ts.shapes, f).numpy(),
                                   np.asarray(getattr(js.shapes, f)), rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(ts.kp.numpy(), np.asarray(js.kp))
    assert ts.params.solver.rolling_friction == js.params.solver.rolling_friction == 0.002


def test_reset_and_steps_match(jax_env):
    jenv, tenv = jax_env(num_envs=B), tbb.make_ball_balance(num_envs=B, device="cpu")
    key = jax.random.PRNGKey(5)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key, B))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert_state_close(ts, js)
    d = fresh_draws(key, B)  # the shared key: every spawn radius is 0.15 ang / 2 pi
    np.testing.assert_allclose(d.r.numpy(), 0.15 * d.ang.numpy() / (2 * np.pi), rtol=1e-6)

    step = jax.jit(jenv.step)
    for _ in range(SETTLE):  # the balls down onto the trays
        js, jr = step(js, jnp.zeros((B, 3)))
    assert not np.asarray(jr.done).any()
    pos = np.asarray(js.physics.objects.pos).copy()
    pos[0, 0] = [1.0, 0.0, 0.12]  # env 0's ball off its tray, below the fall height
    js = js._replace(physics=js.physics._replace(
        objects=js.physics.objects._replace(pos=jnp.asarray(pos))))
    ts = port_state(js)
    rng = np.random.default_rng(6)
    dones = []
    for i in range(2):
        on_tray = robot_ball_impulse(jenv, js.physics.contact_impulse)
        assert (on_tray[1:] > 0).sum() >= 7 - 2 * i, f"step {i}: balls off their trays {on_tray}"
        a = rng.uniform(-1.0, 1.0, (B, 3)).astype(np.float32)
        draws = fresh_draws(jax.random.split(js.key)[1], B)
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"ball_dist"}
        _close(tr.info["ball_dist"], jr.info["ball_dist"], VEL_TOL, "ball_dist")
        assert tr.teacher_obs.shape == (B, 0)
        assert_state_close(ts, js)
        # the tray force (obs 12:15) of the balls pushing on their trays, in
        # the same envs on both sides (a ball may be off its tray for a step)
        pushing = np.abs(np.asarray(jr.obs)[:, 12:15]).sum(-1) > 0
        np.testing.assert_array_equal(tr.obs[:, 12:15].abs().sum(-1).numpy() > 0, pushing)
        assert pushing[1:].sum() >= 5, pushing
        dones.append(tr.done.numpy())
    assert dones[0][0] and not dones[0][1:].any() and not dones[1].any()
    assert int(ts.progress[0]) == 1 and float(ts.physics.robot.base_pos[0, 2]) < 0.6


def test_tripod_stands_in_both(jax_env):
    """tests/test_anymal.py::test_ball_balance_spaces_and_physics on the
    stand-in, in both packages from the same reset."""
    jenv = jax_env(num_envs=B, episode_length=300)
    tenv = tbb.make_ball_balance(num_envs=B, episode_length=300, device="cpu")
    key = jax.random.PRNGKey(0)
    js, jobs = jax.jit(jenv.reset)(key)
    ts, _ = tenv.reset(0, fresh_draws(key, B))
    assert jobs.shape == (B, 24)
    step = jax.jit(jenv.step)
    resets = {"jax": 0, "port": 0}
    for _ in range(240):  # 4 s
        js, jr = step(js, jnp.zeros((B, 3)))
        ts, tr = tenv.step(ts, torch.zeros(B, 3))
        resets["jax"] += int(jr.done.sum())
        resets["port"] += int(tr.done.sum())
    for name, z, obs in (("jax", np.asarray(js.physics.robot.base_pos[:, 2]), np.asarray(jr.obs)),
                         ("port", ts.physics.robot.base_pos[:, 2].numpy(), tr.obs.numpy())):
        assert (z > 0.3).all(), (name, z)  # the tripod never collapsed
        assert np.isfinite(obs).all(), name
        assert resets[name] >= 1, (name, resets)  # a ball rolled off and respawned
