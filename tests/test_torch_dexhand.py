"""AllegroHand and ShadowHand (with the ShadowHandOpenAI observations): the
port against the JAX package on the CPU, on the in-repo stand-ins
(handarm_tpu_torch/assets/classic_standin/urdf/kuka_allegro_description/
allegro_touch_sensor.urdf and mjcf/open_ai_assets/hand/shadow_hand.xml;
the JAX envs read them through monkeypatched
`handarm_tpu.envs.dexhand.ALLEGRO_URDF` / `SHADOW_MJCF`). Each hand's envs
are built once for the module at B = 16 (the Allegro with `full_state`
observations, the Shadow with `openai` ones, whose teacher observations
are its `full_state`), the JAX step jitted once.

- Each stand-in compiles alike in both packages (arrays within 1e-6; nv 16
  and 24, the Shadow's 20 actuated joints, its four coupled J0s and five
  fingertip bodies), both fit the same collision spheres (68 on the
  Allegro; the Shadow's from its MJCF geoms, with their friction), and the
  scenes agree: base pose within 1e-6, gains, effort limits, 150 and 160
  contact slots.
- The observation widths: Trifinger 41, the Allegro's `full_no_vel` 50,
  `full` 72 and `full_state` 88 (each against the JAX `_obs` of one state
  within 1e-6), the Shadow's `full_state` 211 and `openai` 42 + 211.
- The cube rests in each hand: from a reset without joint or position
  noise, 30 steps holding the default joints leave every env's cube
  within 2 cm of where it started, still, and no episode ended, in both
  packages, which step alike (within the tolerances below).
- From that rested state (the JAX package's, through numpy; the Shadow's
  envs 3-7 first close their fingers on the cube for 10 steps, so that
  its fingertips push on it), env 0 set to reach its goal at the next
  step (the goal set to the cube's orientation), env 1's cube 0.3 m below
  the hand (it falls: a reset), env 2 set to time out with 3 successes: 3
  steps at B = 16 with those actions plus U(-0.1, 0.1) and the JAX
  package's draws (re-derived from its keys). Observations, the Shadow's
  teacher observations and rewards within 2e-3 times max(1, the largest
  value); the 30 fingertip force-torque entries of the teacher
  observations (10 times an impulse sum over 1/120 s, clipped at 5) need
  no bound of their own: they agree to 2.4e-4 at a scale of 5 (printed
  with -s); done flags, goal hits and the resampled goals exactly; every
  state leaf within 2e-4 (positions) or 2e-3 (velocities, impulses) of
  the same scale; the consecutive-success average within 1e-6.
- The Shadow's J0 targets follow J1 (tests/test_dexhand.py's coupling
  check, in both packages, for random actions).
- spd_inverse's plain version at n = 16 and 24 against the JAX package's
  jnp path on each hand's PD-augmented mass matrices (the default joints'
  and random joints'), within 1e-5 of the largest entry. Their cond is
  small (printed with -s: 1.3-1.8 and 7.9-8.9): the gram-scale distal
  links' masses lie under the PD terms h^2 kp + h kd and the armature
  that the augmentation adds to the diagonal; and a
  numpy emulation of the n = 24 warp layout's padded staging (rows 25
  words apart): the index map is a bijection and puts the 24 lanes on 24
  banks.
- One PPO update of ShadowHandOpenAI_FF and of ShadowHandOpenAI_LSTM
  (their composed learners, narrowed to 32 units and LSTM 16) against the
  JAX learner, on tables of the hand's own observations (42), teacher
  observations (211) and rewards, with tests/test_torch_rnn.py's harness.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_rnn as trnn
from handarm_tpu.envs import dexhand as jdex
from handarm_tpu.envs import trifinger as jtri
from handarm_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from handarm_tpu.physics import dynamics as jdyn
from handarm_tpu.physics import kinematics as jkin
from handarm_tpu.physics import model as jmodel
from handarm_tpu.robots import spherefit as jsf
from handarm_tpu_torch.convert import classic_state_from_leaves, classic_state_to_leaves
from handarm_tpu_torch.envs import dexhand as tdex
from handarm_tpu_torch.envs import registry as treg
from handarm_tpu_torch.envs import trifinger as ttri
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.ops import spd_inverse as tspd
from handarm_tpu_torch.physics import model as tmodel
from handarm_tpu_torch.robots import spherefit as tsf
from test_pallas_ops import spd_batch
from test_torch_locomotion import _compare_models, _warp_layout

torch.set_num_threads(1)
B = 16
POS_TOL, VEL_TOL = 2e-4, 2e-3
REST_STEPS, GRIP_STEPS, STEPS = 30, 10, 3
GRIP = slice(3, 8)  # the envs whose fingers close on the cube
FORCES = slice(161, 191)  # the fingertip force-torque entries of the 211 dims
_t = lambda x: torch.as_tensor(np.array(x))


def _jax_hand(hand: str, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdex, "ALLEGRO_URDF", tdex.ALLEGRO_URDF)
        mp.setattr(jdex, "SHADOW_MJCF", tdex.SHADOW_MJCF)
        return (jdex.make_allegro if hand == "allegro" else jdex.make_shadow)(**kw)


def _port_hand(hand: str, **kw):
    return (tdex.make_allegro if hand == "allegro" else tdex.make_shadow)(device="cpu", **kw)


@pytest.fixture(scope="module")
def hands():
    """hand -> (JAX env, its jitted step, the port's env), at B = 16."""
    out = {}
    for hand, kw in (("allegro", {}), ("shadow", {"obs_type": "openai"})):
        jenv = _jax_hand(hand, num_envs=B, **kw)
        out[hand] = (jenv, jax.jit(jenv.step), _port_hand(hand, num_envs=B, **kw))
    return out


def _rq(key, n):
    k0, k1 = jax.random.split(key)
    return _t(np.stack([np.asarray(jax.random.uniform(k, (n,), minval=-1.0, maxval=1.0))
                        for k in (k0, k1)], -1))


def fresh_draws(key, nv: int, resample=None, n: int = B) -> tdex.DexDraws:
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, n)`
    makes (and the goals resampled in place, `resample`)."""
    k_phys, k_goal, _ = jax.random.split(key, 3)
    k_dof, k_pos, k_rot = jax.random.split(k_phys, 3)
    return tdex.DexDraws(
        dof=_t(jax.random.uniform(k_dof, (n, nv), minval=-1.0, maxval=1.0)),
        pos=_t(jax.random.normal(k_pos, (n, 3))), rot=_rq(k_rot, n), goal=_rq(k_goal, n),
        resample=torch.zeros(n, 2) if resample is None else resample)


def step_draws(state_key, nv: int) -> tdex.DexDraws:
    _, k_goal, k_reset = jax.random.split(state_key, 3)
    return fresh_draws(k_reset, nv, resample=_rq(k_goal, B))


def port_state(jstate):
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     tdex.DexState)


def jax_state(tstate, like):
    """The port's state as the JAX package's, with `like`'s PRNG key."""
    leaves = [jnp.asarray(x) for x in classic_state_to_leaves(tstate)[:-1]] + [like.key]
    return jax.tree.unflatten(jax.tree.structure(like), leaves)


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


NAMES = ("q", "qd", "targets", "opos", "oquat", "olin", "oang", "impulse", "targets",
         "progress", "goal_quat", "actions", "successes", "cons_successes")
VELOCITY_LEAVES = ("qd", "olin", "oang", "impulse")


def assert_state_close(got, want):
    p = got.physics
    leaves = [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        got[1:])
    g = jax.tree.leaves(want)
    assert len(leaves) == len(g) - 1 == len(NAMES)  # the JAX key
    for name, a, b in zip(NAMES, leaves, g):
        if a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            _close(a, b, VEL_TOL if name in VELOCITY_LEAVES else POS_TOL, name)


def hold_actions(tenv) -> np.ndarray:
    """The actions [B, na] whose targets are the default joints."""
    a = tenv._unscale(tenv.q_default)
    if hasattr(tenv, "actuated_idx"):
        a = a[tenv.actuated_idx]
    return a[None].expand(B, -1).numpy().copy()


# --- the stand-ins ---------------------------------------------------------------


@pytest.mark.parametrize("hand", ["allegro", "shadow"])
def test_standins_compile_alike(hand, hands):
    jenv, _, tenv = hands[hand]
    if hand == "allegro":
        path = tdex.ALLEGRO_URDF
        ja, ta = jmodel.compile_urdf(path), tmodel.compile_urdf(path)
        assert ta.joint_names == [f"joint_{i}.0" for i in range(16)]
        jb, jc, jr = jsf.generic_collision_spheres(path, ja, 4)
        tb, tc, tr = tsf.generic_collision_spheres(path, ta, 4)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tr, jr)
        assert len(tb) == 68 and sorted(set(tb.tolist())) == list(range(16))
    else:
        path = tdex.SHADOW_MJCF
        (ja, jx), (ta, tx) = jmodel.compile_mjcf(path), tmodel.compile_mjcf(path)
        assert set(tdex.SHADOW_ACTUATED) | set(tdex.SHADOW_COUPLED) == set(ta.joint_names)
        assert tdex.SHADOW_ACTUATED == jdex._SHADOW_ACTUATED
        assert tdex.SHADOW_COUPLED == jdex._SHADOW_COUPLED
        np.testing.assert_array_equal(tenv.fingertip_bodies, jenv.fingertip_bodies)
        np.testing.assert_array_equal(tenv.actuated_idx.numpy(), jenv.actuated_idx)
        np.testing.assert_array_equal(tenv.coupled_idx.numpy(), jenv.coupled_idx)
        assert list(tx.link_spheres) == list(jx.link_spheres) and tx.link_spheres
        for name, sph in jx.link_spheres.items():
            for (tp, trad), (jp, jrad) in zip(tx.link_spheres[name], sph, strict=True):
                np.testing.assert_array_equal(tp, jp)
                assert trad == jrad
        assert tx.geom_friction == jx.geom_friction and set(tx.geom_friction.values()) == {1.0}
        np.testing.assert_array_equal(tenv.scene.spheres.friction,
                                      np.asarray(jenv.scene.spheres.friction))
    _compare_models(ta, ja)
    assert ta.nv == {"allegro": 16, "shadow": 24}[hand] and not ta.floating
    assert ((tenv.q_default.numpy() >= ta.q_min) & (tenv.q_default.numpy() <= ta.q_max)).all()
    js, ts = jenv.scene, tenv.scene
    np.testing.assert_array_equal(ts.spheres.body, js.spheres.body)
    np.testing.assert_allclose(ts.spheres.offset.numpy(), np.asarray(js.spheres.offset),
                               atol=1e-7)
    np.testing.assert_array_equal(ts.spheres.radius.numpy(), np.asarray(js.spheres.radius))
    np.testing.assert_allclose(ts.base_pos.numpy(), np.asarray(js.base_pos), atol=1e-6)
    np.testing.assert_allclose(ts.base_quat.numpy(), np.asarray(js.base_quat), atol=1e-6)
    for f in ("kp", "kd"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(ts.model.effort_limit.numpy(),
                                  np.asarray(js.model.effort_limit))
    assert ts.slots.num_slots == js.slots.num_slots == {"allegro": 150, "shadow": 160}[hand]
    np.testing.assert_array_equal(ts.slots.friction, np.asarray(js.slots.friction))


def test_obs_widths_match(hands):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtri, "TRIFINGER_URDF", ttri.TRIFINGER_URDF)
        assert jtri.make_trifinger(num_envs=2).num_obs == 41
    assert ttri.make_trifinger(num_envs=2, device="cpu").num_obs == 41
    jenv, _, tenv = hands["allegro"]
    js, _ = jenv.reset(jax.random.PRNGKey(1))
    js = js._replace(physics=js.physics._replace(robot=js.physics.robot._replace(
        qd=jnp.asarray(np.random.default_rng(1).normal(0, 0.5, (B, 16)).astype(np.float32)))))
    ts = port_state(js)
    for obs_type, width in (("full_no_vel", 50), ("full", 72), ("full_state", 88)):
        je, te = _jax_hand("allegro", num_envs=B, obs_type=obs_type), _port_hand(
            "allegro", num_envs=B, obs_type=obs_type)
        assert je.num_obs == te.num_obs == width
        _close(te._obs(ts), je._obs(js), 1e-6, obs_type)
    for kw, width, teacher in (({}, 211, 0), ({"obs_type": "openai"}, 42, 211)):
        je, te = _jax_hand("shadow", num_envs=2, **kw), _port_hand("shadow", num_envs=2, **kw)
        assert (je.num_obs, je.num_teacher_obs) == (te.num_obs, te.num_teacher_obs) == (
            width, teacher)
    obs, teacher, d = hands["shadow"][2].observe(hands["shadow"][2].reset(0)[0])
    assert obs.shape == (B, 42) and teacher.shape == (B, 211) and d["obs"] is obs


# --- the env steps ---------------------------------------------------------------


@pytest.mark.parametrize("hand", ["allegro", "shadow"])
def test_cube_rests_and_steps_match(hand, hands):
    jenv, step, tenv = hands[hand]
    nv, na = tenv.art.nv, tenv.num_actions
    key = jax.random.PRNGKey(7)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key, nv))
    _close(tobs, jobs, 1e-6, "reset obs")
    assert_state_close(ts, js)

    # the cube rests in the hand: no joint or position noise, default joints held
    quiet = fresh_draws(key, nv)._replace(dof=torch.zeros(B, nv), pos=torch.zeros(B, 3),
                                          rot=torch.zeros(B, 2))
    ts, _ = tenv.reset(0, quiet)
    js = jax_state(ts, js)
    hold = hold_actions(tenv)
    start = ts.physics.objects.pos[:, 0].numpy().copy()
    for i in range(REST_STEPS):
        draws = step_draws(js.key, nv)
        js, jr = step(js, jnp.asarray(hold))
        ts, tr = tenv.step(ts, _t(hold), draws)
        assert not tr.done.any() and not np.asarray(jr.done).any(), i
    assert_state_close(ts, js)
    for name, p, v in (("port", ts.physics.objects.pos[:, 0].numpy(),
                        ts.physics.objects.linvel[:, 0].numpy()),
                       ("jax", np.asarray(js.physics.objects.pos[:, 0]),
                        np.asarray(js.physics.objects.linvel[:, 0]))):
        assert (np.linalg.norm(p - start, axis=-1) < 0.02).all(), (name, p - start)
        assert (np.linalg.norm(v, axis=-1) < 0.02).all(), (name, v)

    # the Shadow's envs 3-7 close their fingers on the cube (their own steps,
    # then the compared ones), so that its fingertips push on it (the
    # Allegro's cube lies on its fingers: flexing them throws it off)
    grip = hold.copy()
    if hand == "shadow":  # every finger fully flexed, the wrist held
        grip[GRIP, 2:] = 1.0
    for _ in range(GRIP_STEPS):
        js, jr = step(js, jnp.asarray(grip))
    assert not np.asarray(jr.done).any()
    # env 0 reaches its goal, env 1's cube falls, env 2 times out with 3 successes
    phys = js.physics
    opos = np.asarray(phys.objects.pos).copy()
    opos[1, 0, 2] -= 0.3
    goal = np.asarray(js.goal_quat).copy()
    goal[0] = np.asarray(phys.objects.quat[0, 0])
    prog, succ = np.asarray(js.progress).copy(), np.asarray(js.successes).copy()
    prog[2], succ[2] = jenv.cfg.episode_length - 1, 3.0
    js = js._replace(physics=phys._replace(objects=phys.objects._replace(pos=jnp.asarray(opos))),
                     goal_quat=jnp.asarray(goal), progress=jnp.asarray(prog),
                     successes=jnp.asarray(succ), cons_successes=jnp.float32(0.5))
    ts = port_state(js)
    rng = np.random.default_rng(3)
    for i in range(STEPS):
        a = np.clip(grip + rng.uniform(-0.1, 0.1, (B, na)), -1.0, 1.0).astype(np.float32)
        draws = step_draws(js.key, nv)
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"consecutive_successes", "rot_dist_mean",
                                                 "goal_hits"}
        assert int(tr.info["goal_hits"]) == int(jr.info["goal_hits"])
        _close(tr.info["consecutive_successes"], jr.info["consecutive_successes"], 1e-6, "cons")
        _close(tr.info["rot_dist_mean"], jr.info["rot_dist_mean"], VEL_TOL, "rot_dist")
        if hand == "shadow":
            tt, jt = tr.teacher_obs.numpy(), np.asarray(jr.teacher_obs)
            assert tt.shape == (B, 211)
            _close(tt, jt, VEL_TOL, f"teacher obs {i}")
            keep = np.ones(211, bool)
            keep[FORCES] = False
            print(f"shadow step {i}: fingertip force-torque entries up to "
                  f"{np.abs(tt[:, FORCES] - jt[:, FORCES]).max():.3e} apart (largest "
                  f"{np.abs(jt[:, FORCES]).max():.3e}), the other 181 teacher entries "
                  f"{np.abs(tt[:, keep] - jt[:, keep]).max():.3e}")
        else:
            assert tr.teacher_obs.shape == (B, 0)
        assert_state_close(ts, js)
        slots = tenv.scene.slots
        robot_cube = torch.as_tensor((slots.robot_body >= 0) & (slots.obj_b == 0))
        pushed = ((ts.physics.contact_impulse.norm(dim=-1) > 0) & robot_cube).any(-1)
        assert pushed[GRIP].all(), pushed
        if hand == "shadow":
            assert (np.abs(jt[GRIP, FORCES]).max(-1) > 0).sum() >= 3
        if i == 0:
            done = tr.done.numpy()
            assert done[1] and done[2] and not done[0], done
            assert int(jr.info["goal_hits"]) >= 1
            np.testing.assert_array_equal(ts.goal_quat[0].numpy(), np.asarray(js.goal_quat[0]))
            assert not np.allclose(ts.goal_quat[0].numpy(), goal[0])  # resampled in place
            assert float(ts.successes[0]) == 1.0 and float(ts.successes[2]) == 0.0
            # 0.1 of the 3 successes over the 2 ended episodes, 0.9 of 0.5
            np.testing.assert_allclose(float(ts.cons_successes), 0.1 * 1.5 + 0.45, rtol=1e-6)


def test_shadow_coupled_targets(hands):
    jenv, _, tenv = hands["shadow"]
    rng = np.random.default_rng(4)
    prev = rng.uniform(tenv.art.q_min, tenv.art.q_max, (B, 24)).astype(np.float32)
    a = rng.uniform(-1.0, 1.0, (B, 20)).astype(np.float32)
    a[:, 4] = 1.0  # FFJ1's actuator fully flexed (tests/test_dexhand.py:92)
    got = tenv._targets(_t(a), _t(prev)).numpy()
    want = np.asarray(jenv._targets_from_actions(jnp.asarray(a), jnp.asarray(prev)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    names = tenv.art.joint_names
    for j0, j1 in tdex.SHADOW_COUPLED.items():
        np.testing.assert_array_equal(got[:, names.index(j0)], got[:, names.index(j1)])
    np.testing.assert_allclose(got[:, names.index("robot0:FFJ0")], tenv.art.q_max[
        names.index("robot0:FFJ1")], rtol=1e-6)


# --- spd_inverse ---------------------------------------------------------------


@pytest.mark.parametrize("hand", ["allegro", "shadow"])
def test_spd_inverse_plain_matches_hand_matrices(hand, hands):
    jenv, _, tenv = hands[hand]
    sc, n = jenv.scene, tenv.art.nv
    rng = np.random.default_rng(6)
    q = np.concatenate([np.broadcast_to(np.asarray(jenv.q_default), (4, n)),
                        rng.uniform(tenv.art.q_min, tenv.art.q_max, (12, n))]).astype(np.float32)
    fk = jkin.forward_kinematics(sc.model, jnp.asarray(q), jnp.broadcast_to(sc.base_quat, (B, 4)),
                                 jnp.broadcast_to(sc.base_pos, (B, 3)))
    dyn = jdyn.compute_dyn(sc.model, fk, jnp.zeros((B, n)), jnp.zeros(3), sc.kp, sc.kd,
                           sc.params.dt / sc.params.substeps)
    M = np.asarray(dyn.Mtilde)
    cond = np.linalg.cond(M.astype(np.float64))
    print(f"{hand}: n = {n}, cond(Mtilde) {cond.min():.3e} to {cond.max():.3e}")
    want = np.asarray(j_spd_inverse(jnp.asarray(M), force_pallas=False))
    got = tspd.spd_inverse_plain(torch.tensor(M)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert n in tspd.KERNEL_N and cond.max() < 1e3


def _padded(e, n, ld):
    """csrc/spd_inverse.cu `padded<N, LD>`: element e's word in shared memory."""
    return e + (e // n) * (ld - n)


def test_spd_inverse_warp_layout_padded_n24():
    """The n = 24 warp layout: each row at a stride of LD = 25 words in
    shared memory. The staging map is a bijection onto the rows' first 24
    words, a lane's row reads back its row, the 24 lanes reading one
    column fall on 24 banks (at a stride of 24 they would share 3 of 8),
    and the warp's arithmetic on the staged rows holds to the plain
    version."""
    n, ld = 24, 24 | 1
    e = np.arange(n * n)
    words = _padded(e, n, ld)
    assert len(set(words.tolist())) == n * n and words.max() < n * ld
    np.testing.assert_array_equal(words.reshape(n, n), np.arange(n)[:, None] * ld + np.arange(n))
    for j in range(n):
        assert len({(i * ld + j) % 32 for i in range(n)}) == n
    assert len({(i * n) % 32 for i in range(n)}) == 4
    M = np.asarray(spd_batch(4, n, seed=8))
    want = tspd.spd_inverse_plain(torch.tensor(M)).numpy()
    for b in range(M.shape[0]):
        S = np.zeros(n * ld, np.float32)
        S[words] = M[b].reshape(-1)
        rows = np.stack([S[i * ld:i * ld + n] for i in range(n)])
        got = _warp_layout(rows)
        S[np.arange(n)[:, None] * ld + np.arange(n)] = got
        out = S[words].reshape(n, n)
        np.testing.assert_allclose(out, want[b], atol=1e-5 * np.abs(want[b]).max())


# --- the asymmetric learners -------------------------------------------------------


def _hand_tables(tenv, rng):
    """trnn._tables' shapes from the Shadow hand's own rollout: observations
    (42) and teacher observations (211) of T + 1 states, rewards of T steps,
    under random actions; done flags as trnn's (inside sequences and at
    their ends)."""
    state, obs = tenv.reset(2)
    obs_l, teacher_l, reward_l = [obs], [tenv.observe(state)[1]], []
    for _ in range(trnn.T):
        a = torch.as_tensor(rng.uniform(-1.0, 1.0, (trnn.B, 20)).astype(np.float32))
        state, res = tenv.step(state, a)
        obs_l.append(res.obs)
        teacher_l.append(res.teacher_obs)
        reward_l.append(res.reward)
    done = rng.uniform(size=(trnn.T, trnn.B)) < 0.15
    done[1, 0] = done[3, 1] = done[6, 2] = True
    return (torch.stack(obs_l).numpy(), torch.stack(teacher_l).numpy(),
            torch.stack(reward_l).numpy(), done)


@pytest.mark.parametrize("task", ["ShadowHandOpenAI_FF", "ShadowHandOpenAI_LSTM"])
def test_openai_update_matches(task, monkeypatch):
    """One train_iter of the task's composed learner (gamma 0.998, the
    asymmetric critic; the LSTM's 4-step sequences), narrowed to hidden 32
    and LSTM 16 / 24 units, against the JAX learner as
    tests/test_torch_rnn.py holds it (same flax init, Adam moments, stats,
    carry and draws): the trajectory's mu, logp, values within 1e-5, the
    new TrainState leaf by leaf."""
    _, over = treg.resolve_task(task, ["num_envs=8"])
    fields = set(tppo.PPOConfig._fields)
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in over.items() if k in fields}
    assert cfg["asymmetric_critic"] and cfg["gamma"] == 0.998
    cfg.update(trnn._cfg(), hidden=(32,) if "LSTM" in task else (32, 32))
    if "LSTM" in task:
        assert (cfg["rnn_units"], cfg["critic_rnn_units"], cfg["seq_len"]) == (1024, 1024, 4)
        cfg.update(rnn_units=16, critic_rnn_units=24)
    tenv = tdex.make_shadow(num_envs=trnn.B, obs_type="openai", device="cpu")
    tables = _hand_tables(tenv, np.random.default_rng(9))
    for name, v in (("NUM_OBS", 42), ("NUM_TEACHER", 211), ("NUM_ACTIONS", 20)):
        monkeypatch.setattr(trnn, name, v)
    monkeypatch.setattr(trnn, "_tables", lambda rng: tables)
    j_new, j_stats, j_traj, t_new, t_stats, t_traj, kls, _, tcfg = trnn._run_both(cfg, 12)
    for k in ("mu", "logp", "value"):
        np.testing.assert_allclose(getattr(t_traj, k).numpy(), np.asarray(getattr(j_traj, k)),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(t_traj.teacher_obs.numpy(), np.asarray(j_traj.teacher_obs))
    trnn._assert_state_matches(j_new, t_new, tcfg, kls)
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
