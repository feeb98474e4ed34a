"""IndustRealTaskPegsInsert: the port against the JAX package on the CPU, on
the in-repo stand-in Franka (the JAX env reads it through a monkeypatched
`handarm_tpu.envs.industreal.FRANKA_URDF`) with the plug's and the hole's
tracked records (the JAX loader through a monkeypatched
`handarm_tpu.envs.objects.CACHE_DIR`). The JAX env is built once at B = 4
and its step jitted once.

- The scenes as tests/test_torch_factory.py compares them (298 slots, the
  socket's zero-travel rail, 8 sweeps), the base placed from the stand-in's
  FK at its home pose within 1e-6, the plug's half height, the socket's
  height and the plug's goal, the widths (24 observations, 47 for the
  critic, 6 actions).
- The reset from the JAX package's draws (the socket's xy, the engagement
  draw, the observation noise and the staggered clocks, re-derived from
  its keys): observations and teacher observations (`observe`) within
  1e-6, every state leaf as below; then 3 steps at B = 4 with uniform
  actions in [-1, 1], env 0 timing out at the first: observations, teacher
  observations and rewards within 2e-3 times max(1, the largest value),
  done flags exactly, the info (SBC's EWMA and bound, SAPU's mean, the
  interpenetration, the insertion share) within 2e-3 of scale, every state
  leaf within 2e-4 (positions) or 2e-3 (velocities, impulses) of max(1,
  its largest value), the integer and bool leaves exactly, SBC's scalars
  within 1e-6. The weld: after the steps the plug sits at the grip site's
  pose composed with the weld (within 1e-5) in both packages.
- `sdf_reward` and `sapu_scale` on plug poses at the goal, displaced (up,
  sideways, tilted, far) and interpenetrating the hole's plate: within
  1e-4 of scale (the reward) and 1e-6 (the interpenetration; SAPU's
  weight within 1e-4); the reward falls away from the goal and SAPU's
  weight is 1 in free space and 0 inside the plate in both packages (the
  JAX package's tests/test_industreal.py checks, which fail here for want
  of its default assets). `physics/sdf.py` `sample_sdf` against the JAX
  package's on points inside and outside the plug's grid within 1e-6.
- An SBC update: the step where `steps_since_sbc` reaches
  `curriculum_interval`, once with every ending episode inserted (the EWMA
  over 0.75: the bound falls by 5 mm) and once with none (under 0.5: it
  rises, clamped at 1 cm), against the JAX package: the bound, the EWMA
  and the counter within 1e-6, and the fresh episodes' plugs placed under
  the new bound.
- One asymmetric `train_iter` at IndustReal's composed learner
  (256-128-64, the 47-dim critic, gamma 0.998, reward scale 0.01; horizon
  8, minibatches of 16 samples, 2 mini-epochs: 4 Adam steps at B = 4) on a
  table of the port env's own observations, teacher observations, rewards
  and done flags, both learners from the JAX package's init carried over by
  `convert.py`: the new TrainState as tests/test_torch_rnn.py holds it.
- `task="gears"` and IndustRealTaskGearsInsert are refused (ROADMAP §1.7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_rnn as trnn
from handarm_tpu.envs import industreal as jir
from handarm_tpu.envs import objects as jobj
from handarm_tpu.physics.sdf import sample_sdf as j_sample_sdf
from handarm_tpu_torch.convert import classic_state_from_leaves
from handarm_tpu_torch.envs import franka as tfr
from handarm_tpu_torch.envs import industreal as tir
from handarm_tpu_torch.envs import objects as tobj
from handarm_tpu_torch.envs import registry as treg
from handarm_tpu_torch.math.quat import quat_from_axis_angle, quat_rotate
from handarm_tpu_torch.physics.sdf import sample_sdf
from test_torch_factory import compare_scenes

torch.set_num_threads(1)
B = 4
STEPS = 3
POS_TOL, VEL_TOL = 2e-4, 2e-3
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def pegs():
    """(JAX env, its jitted step, port env) at B = 4."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jir, "FRANKA_URDF", tfr.FRANKA_URDF)
        mp.setattr(jobj, "CACHE_DIR", str(tobj.CACHE_DIR))
        jenv = jir.make_industreal(task="pegs", num_envs=B)
    return jenv, jax.jit(jenv.step), tir.make_industreal("pegs", num_envs=B, device="cpu")


def fresh_draws(key, episode_length: int, reset: bool = False) -> tir.IRDraws:
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, B)`
    makes; with `reset`, the clocks its `reset(key)` staggers."""
    ks, kd, _, kon = jax.random.split(key, 4)
    prog = (jax.random.randint(jax.random.fold_in(key, 31), (B,), 0, episode_length)
            if reset else jnp.zeros(B, jnp.int32))
    return tir.IRDraws(socket=_t(jax.random.uniform(ks, (B, 2), minval=-1.0, maxval=1.0)),
                       engage=_t(jax.random.uniform(kd, (B,))),
                       obs_noise=_t(jax.random.uniform(kon, (B, 3), minval=-1.0, maxval=1.0)),
                       progress=_t(prog).long())


def step_draws(state_key, episode_length: int) -> tir.IRDraws:
    return fresh_draws(jax.random.split(state_key)[1], episode_length)


def port_state(jstate) -> tir.IRState:
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     tir.IRState)


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


NAMES = ("q", "qd", "targets", "opos", "oquat", "olin", "oang", "impulse", "progress",
         "actions", "socket_pos", "weld_p", "weld_q", "inserted", "socket_obs_noise",
         "success_ewma", "max_disp", "steps_since_sbc")
VELOCITY_LEAVES = ("qd", "olin", "oang", "impulse")


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
        elif name in ("success_ewma", "max_disp"):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-7, err_msg=name)
        else:
            _close(a, b, VEL_TOL if name in VELOCITY_LEAVES else POS_TOL, name)


# --- the scene ----------------------------------------------------------------------


def test_scene_matches(pegs):
    jenv, _, tenv = pegs
    compare_scenes(jenv, tenv)
    assert tenv.scene.slots.num_slots == 298 and tenv.scene.params.solver.iterations == 8
    assert (tenv.num_obs, tenv.num_teacher_obs, tenv.num_actions) == (24, 47, 6)
    assert tenv.plug_half_height == jenv.plug_half_height
    assert tenv.socket_height == jenv.socket_height
    np.testing.assert_allclose(tenv.plug_goal_pos.numpy(), np.asarray(jenv.plug_goal_pos))
    np.testing.assert_array_equal(tenv.scene.rails.mask.numpy(), [0.0, 1.0])
    np.testing.assert_array_equal(tenv.scene.rails.hi.numpy(), [0.0, 0.0])


# --- env steps ----------------------------------------------------------------------


def test_reset_and_steps_match(pegs):
    jenv, jstep, tenv = pegs
    L = jenv.cfg.episode_length
    key = jax.random.PRNGKey(5)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key, L, reset=True))
    _close(tobs, jobs, 1e-6, "reset obs")
    _close(tenv.observe(ts)[1], jenv.observe(js)[1], 1e-6, "reset teacher obs")
    assert_state_close(ts, js)
    prog = np.asarray(js.progress).copy()
    prog[0] = L - 1  # env 0 times out at the first step
    prog[1:] = np.minimum(prog[1:], L - STEPS - 1)
    js = js._replace(progress=jnp.asarray(prog))
    ts = port_state(js)
    rng = np.random.default_rng(6)
    for i in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (B, 6)).astype(np.float32)
        draws = step_draws(js.key, L)
        js, jr = jstep(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.teacher_obs, jr.teacher_obs, VEL_TOL, f"teacher obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info)
        for k in tr.info:
            _close(tr.info[k], jr.info[k], VEL_TOL, k)
        assert_state_close(ts, js)
        if i == 0:
            np.testing.assert_array_equal(tr.done.numpy(), np.arange(B) == 0)
    # the weld: the plug at the grip site's pose composed with the weld
    for name, env, s in (("jax", jenv, js), ("port", tenv, ts)):
        _, gp, gq, _, _ = env._eef(s.physics)
        gp, gq, wp = (torch.as_tensor(np.array(x)) for x in (gp, gq, s.weld_p))
        np.testing.assert_allclose(np.asarray(s.physics.objects.pos[:, 0]),
                                   (gp + quat_rotate(gq, wp)).numpy(), atol=1e-5, err_msg=name)


# --- the rewards --------------------------------------------------------------------


def _plug_poses(env):
    """(name, plug pos [B, 3], quat [B, 4]) cases: at the goal, 3 cm up, 2 mm
    sideways, tilted 0.2 rad, far off, and rammed 12 mm sideways into the
    hole's plate."""
    goal = torch.as_tensor(np.asarray(env.plug_goal_pos))[None].expand(B, 3)
    ident = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(B, 4)
    tilt = quat_from_axis_angle(torch.tensor([[1.0, 0.0, 0.0]]), torch.tensor([0.2]))
    off = lambda x, y, z: goal + torch.tensor([[x, y, z]])
    sock = torch.tensor([[0.5, 0.0, jir.TABLE_HEIGHT + env.socket_height / 2]])
    return [("goal", goal, ident), ("up", off(0.0, 0.0, 0.03), ident),
            ("side", off(0.002, 0.0, 0.0), ident), ("tilted", goal, tilt.expand(B, 4)),
            ("far", off(0.1, 0.0, 0.1), ident),
            ("inside", (sock + torch.tensor([[0.012, 0.0, 0.0]])).expand(B, 3), ident)]


def test_sdf_reward_and_sapu_match(pegs):
    jenv, _, tenv = pegs
    sock = torch.tensor([[0.5, 0.0, jir.TABLE_HEIGHT + tenv.socket_height / 2]]).expand(B, 3)
    ident = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(B, 4)
    j = lambda x: jnp.asarray(x.numpy())
    rewards, weights = {}, {}
    for name, pos, quat in _plug_poses(tenv):
        got_r = tenv.sdf_reward(pos, quat)
        want_r = jenv.sdf_reward(j(pos), j(quat))
        _close(got_r, want_r, 1e-4, f"sdf_reward {name}")
        got_s, got_pen = tenv.sapu_scale(pos, quat, sock, ident)
        want_s, want_pen = jenv.sapu_scale(j(pos), j(quat), j(sock), j(ident))
        _close(got_s, want_s, 1e-4, f"sapu {name}")
        np.testing.assert_allclose(got_pen.numpy(), np.asarray(want_pen), atol=1e-6,
                                   err_msg=f"interpenetration {name}")
        rewards[name], weights[name] = float(got_r[0]), (float(got_s[0]), float(got_pen[0]))
    print(f"sdf_reward {rewards}; sapu (weight, interpenetration) {weights}")
    assert rewards["goal"] > rewards["up"] > rewards["far"]
    assert rewards["goal"] > rewards["side"] and rewards["goal"] > rewards["tilted"]
    assert weights["far"][0] == pytest.approx(1.0, abs=1e-3)
    assert weights["inside"][1] > 0.001 and weights["inside"][0] < 0.1


def test_sample_sdf_matches(pegs):
    jenv, _, tenv = pegs
    sh = tenv.scene.shapes
    rng = np.random.default_rng(8)
    lo, sp = sh.sdf_lo[0].numpy(), float(sh.sdf_spacing[0])
    p = (lo + sp * rng.uniform(-5.0, 44.0, (3, 257, 3))).astype(np.float32)
    got = sample_sdf(sh.sdf_field[0, ..., 0], sh.sdf_lo[0], sh.sdf_spacing[0], _t(p))
    js = jenv.scene.shapes
    want = j_sample_sdf(js.sdf_grid[0], js.sdf_lo[0], js.sdf_spacing[0], jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# --- SBC ----------------------------------------------------------------------------


@pytest.mark.parametrize("inserted", [True, False])
def test_sbc_update_matches(inserted, pegs):
    jenv, jstep, tenv = pegs
    cfg = jenv.cfg
    key = jax.random.PRNGKey(9)
    js, _ = jenv.reset(key)
    # every episode ends at this step, at the update's step
    js = js._replace(inserted=jnp.full(B, inserted), success_ewma=jnp.float32(
        0.9 if inserted else 0.1), progress=jnp.full(B, cfg.episode_length - 1, jnp.int32),
        steps_since_sbc=jnp.int32(cfg.curriculum_interval - 1))
    ts = port_state(js)
    draws = step_draws(js.key, cfg.episode_length)
    js2, jr = jstep(js, jnp.zeros((B, 6)))
    ts2, tr = tenv.step(ts, torch.zeros(B, 6), draws)
    assert_state_close(ts2, js2)
    want = min(cfg.curriculum_height_bound[1],
               0.01 + cfg.curriculum_height_step[0 if inserted else 1])
    for name, s in (("jax", js2), ("port", ts2)):
        assert float(s.max_disp) == pytest.approx(want, abs=1e-6), name
        assert int(s.steps_since_sbc) == 0, name
    # the fresh plugs lie under the new bound
    top = tir.TABLE_HEIGHT + tenv.socket_height + tenv.plug_half_height
    z = ts2.physics.objects.pos[:, 0, 2]
    np.testing.assert_allclose(z.numpy(), top - draws.engage.numpy() * want, atol=1e-6)
    _close(tr.info["max_disp"], jr.info["max_disp"], 1e-6, "info max_disp")


# --- the learner --------------------------------------------------------------------


def test_asymmetric_train_iter_matches(pegs, monkeypatch):
    _, _, tenv = pegs
    T = 8
    ts, obs = tenv.reset(3)
    rng = np.random.default_rng(10)
    rows = {"obs": [obs], "teacher": [tenv.observe(ts)[1]], "reward": [], "done": []}
    for _ in range(T):
        ts, r = tenv.step(ts, _t(rng.uniform(-1.0, 1.0, (B, 6)).astype(np.float32)))
        rows["obs"].append(r.obs)
        rows["teacher"].append(r.teacher_obs)
        rows["reward"].append(r.reward)
        rows["done"].append(r.done)
    tables = tuple(torch.stack(rows[k]).numpy() for k in ("obs", "teacher", "reward", "done"))
    tables[3][3, 0] = True  # an episode end inside the horizon
    for name, value in (("NUM_OBS", 24), ("NUM_TEACHER", 47), ("NUM_ACTIONS", 6), ("B", B),
                        ("T", T), ("_tables", lambda rng: tables)):
        monkeypatch.setattr(trnn, name, value)
    cfg, over = treg.resolve_task("IndustRealTaskPegsInsert", [f"num_envs={B}"])
    assert (over["asymmetric_critic"], tuple(over["hidden"])) == (True, (256, 128, 64))
    ppo = dict(over, hidden=tuple(over["hidden"]), horizon=T, minibatch_size=16,
               mini_epochs=2)
    j_new, j_stats, j_traj, t_new, t_stats, t_traj, kls, _, tcfg = trnn._run_both(ppo, 12)
    assert len(kls) == 4
    for k, tol in (("mu", 1e-5), ("logp", 1e-5), ("value", 1e-5), ("reward", 1e-5)):
        np.testing.assert_allclose(getattr(t_traj, k).numpy(), np.asarray(getattr(j_traj, k)),
                                   atol=tol, err_msg=k)
    np.testing.assert_array_equal(t_traj.teacher_obs.numpy(), np.asarray(j_traj.teacher_obs))
    trnn._assert_state_matches(j_new, t_new, tcfg, kls)
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


# --- the refused variant ------------------------------------------------------------


def test_gears_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP §1.7"):
        tir.IndustRealEnv(tir.IndustRealConfig(task="gears"), device="cpu")
    with pytest.raises(NotImplementedError, match="IndustRealTaskGearsInsert"):
        treg.resolve_task("IndustRealTaskGearsInsert", ["num_envs=8"])
    assert "IndustRealTaskGearsInsert" in treg.UNPORTED_CLASSIC
