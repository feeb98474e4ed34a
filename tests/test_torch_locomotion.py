"""The locomotion family (Ant, Humanoid) and the Cartpole's and Humanoid's
SPD-inverse sizes: the port against the JAX package on the CPU, on the
in-repo stand-in assets (handarm_tpu_torch/assets/classic_standin/).

- The stand-ins parse and compile alike in both packages (links, joints,
  extras and collision spheres exactly; the compiled arrays within 1e-6)
  and give the reference's widths: the Ant 60 observations and 8 actions
  (tests/test_locomotion.py), 37 spheres of 15-gear motors, 0.911 kg; the
  Humanoid 108 and 21, 51 spheres, its motor-effort ratios; the Cartpole
  nv = 2, a slider and a pole. Each env's scene has the same slots.
- Each env's reset from the JAX package's draws (re-derived from its keys
  and handed to the port's `reset` / `step`), exactly; then the JAX env
  steps with zero actions until every env stands on the ground (Ant 12
  control steps, Humanoid 14), its state goes to the port, and 2 steps at
  B = 8 with random actions run on both, env 0 timing out at the second
  (its fresh episode from the injected draws). Every env carries ground
  impulses in the state each compared step starts from (asserted).
  Tolerances as tests/test_torch_classic.py states them: observations
  within 2e-3 times max(1, the largest value), every state leaf within
  2e-4 (positions) or 2e-3 (velocities, impulses, forces) of the same
  scale, done flags exactly; rewards within 2e-3 of max(1, scale) plus two
  float32 ulps of the potentials (the progress reward is a difference of
  two potentials of ~6e4, whose ulp is 3.9e-3).
- The Ant settles upright in both packages from the same reset (90
  control steps of zero torque at B = 32): what
  tests/test_locomotion.py::test_ant_settles_upright asks of the
  reference asset (the torso between 0.2 and 0.5 m, up_proj > 0.9, the
  feet carrying half the weight in 90 % of the envs), and the torso heights
  of the two agree within 5 mm.
- spd_inverse's plain version at n = 27 and n = 2 against the JAX
  package's jnp fallback (atol 1e-5, the bound of tests/test_pallas_ops.py,
  on its `spd_batch`), and a numpy emulation of the n = 27 kernel's warp
  layout (a lane per row, the rows of L and W broadcast step by step,
  Minv's row formed with W's) against it within 1e-5 of scale.
- One Ant `train_iter` at B = 16 (hidden 32-32, horizon 2, minibatch 8),
  two envs timing out in it, held as tests/test_torch_classic.py holds the
  Quadcopter's: the rollout on each side with the JAX package's noise and
  reset draws, then the update from the JAX package's trajectory with its
  permutations. The params are held within 1e-5, not the Quadcopter's
  1e-6: one mu.kernel entry of the 256 lies 4.2e-6 apart (the rest within
  7.5e-8, the Adam moments within 1e-8; measured), an entry whose gradient
  is ~1e-9, where Adam's m / (sqrt(v) + eps) carries the float32 rounding
  of m into each of the 16 steps of lr ~3e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import handarm_tpu.learn.ppo as jppo
from handarm_tpu.envs import locomotion as jl
from handarm_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from handarm_tpu.physics import mjcf as jmjcf
from handarm_tpu.physics import model as jmodel
from handarm_tpu_torch.convert import (
    classic_state_from_leaves,
    learner_to_leaves,
    train_state_from_leaves,
)
from handarm_tpu_torch.envs import classic as tcl
from handarm_tpu_torch.envs import locomotion as tl
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.ops import spd_inverse as tspd
from handarm_tpu_torch.physics import mjcf as tmjcf
from handarm_tpu_torch.physics import model as tmodel
from test_pallas_ops import spd_batch
from test_torch_classic import _DrawnEnv
from test_torch_ppo import TRAJ_FIELDS, _perms, _port_traj
from test_torch_train import assert_same_lr, record_kls

torch.set_num_threads(1)
B = 8
POS_TOL, VEL_TOL = 2e-4, 2e-3
POTENTIAL_ULPS = 2 * 2.0 ** -8  # two float32 ulps of a potential in [2^15, 2^16)
SETTLE = {"ant": 12, "humanoid": 14}  # zero-action steps until every env stands
MJCF = {"ant": tl.ANT_MJCF, "humanoid": tl.HUMANOID_MJCF}
_t = lambda x: torch.as_tensor(np.array(x))


def jax_env(kind: str, **kw):
    """The JAX package's env on the stand-in: the Ant through its factory's
    `mjcf=`, the Humanoid (whose factory sets its own MJCF) through its
    LocomotionEnv wrapped to read the stand-in."""
    if kind == "ant":
        return jl.make_ant(mjcf=tl.ANT_MJCF, **kw)
    with pytest.MonkeyPatch.context() as mp:
        env_cls = jl.LocomotionEnv
        mp.setattr(jl, "LocomotionEnv",
                   lambda cfg: env_cls(dataclasses.replace(cfg, mjcf=tl.HUMANOID_MJCF)))
        return jl.make_humanoid(**kw)


def port_env(kind: str, **kw):
    make = tl.make_ant if kind == "ant" else tl.make_humanoid
    return make(device="cpu", **kw)


def fresh_draws(jenv, key, B: int) -> tl.LocoDraws:
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, B)`
    makes."""
    c, nv = jenv.cfg, jenv.art.nv
    k1, k2, _ = jax.random.split(key, 3)
    u = jax.random.uniform
    return tl.LocoDraws(
        _t(u(k1, (B, nv - 6), minval=-c.reset_noise_q, maxval=c.reset_noise_q)),
        _t(u(k2, (B, nv), minval=-c.reset_noise_qd, maxval=c.reset_noise_qd)))


def step_draws(jenv, state_key, B: int):
    """The port's draws of the JAX env's `step` from a state with key
    `state_key`."""
    _, k_reset = jax.random.split(state_key)
    return fresh_draws(jenv, k_reset, B)


def port_state(jstate):
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     tl.LocoState)


def _close(got, want, tol, name, extra=0.0):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale + extra, err_msg=name)


LEAF_NAMES = ("q", "qd", "targets", "base_pos", "base_quat", "tau_ext", "opos", "oquat",
              "olin", "oang", "impulse", "progress", "potentials", "actions", "feet_force")
VELOCITY_LEAVES = ("qd", "tau_ext", "olin", "oang", "impulse", "feet_force")


def assert_state_close(got, want):
    p = got.physics
    leaves = [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        got[1:])
    g = jax.tree.leaves(want)
    assert len(leaves) == len(g) - 1 == len(LEAF_NAMES)  # the JAX key
    for name, a, b in zip(LEAF_NAMES, leaves, g):
        if a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        elif name == "potentials":  # ~6e4: an ulp is 3.9e-3
            _close(a, b, 0.0, name, extra=POTENTIAL_ULPS)
        else:
            _close(a, b, VEL_TOL if name in VELOCITY_LEAVES else POS_TOL, name)


# --- the stand-ins -------------------------------------------------------------------


def _compare_models(ta, ja):
    for f in ("parent", "joint_type", "body_parent", "body_dof", "dof_body"):
        if getattr(ja, f) is not None:
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


@pytest.mark.parametrize("kind", ["ant", "humanoid", "cartpole"])
def test_standins_compile_alike(kind):
    if kind == "cartpole":
        from handarm_tpu.envs import classic as jcl

        ja = jmodel.compile_urdf(tcl.CARTPOLE_URDF, default_armature=0.0)
        ta = tmodel.compile_urdf(tcl.CARTPOLE_URDF, default_armature=0.0)
        _compare_models(ta, ja)
        assert ta.joint_names == ["slider_to_cart", "cart_to_pole"] and ta.nv == 2
        jenv = jcl.make_cartpole(num_envs=4, urdf=tcl.CARTPOLE_URDF)
        tenv = tcl.make_cartpole(num_envs=4, device="cpu")
        assert (tenv.num_obs, tenv.num_actions) == (jenv.num_obs, jenv.num_actions) == (4, 1)
        np.testing.assert_array_equal(tenv.effort_map.numpy(), np.asarray(jenv.effort_map))
        return
    path = MJCF[kind]
    ju, jx = jmjcf.parse_mjcf(path)
    tu, tx = tmjcf.parse_mjcf(path)
    assert list(tu.links) == list(ju.links)
    assert [j.name for j in tu.joints] == [j.name for j in ju.joints]
    for a, b in zip(tu.joints, ju.joints):
        for f in ("joint_type", "parent", "child", "lower", "upper", "damping"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        for f in ("origin_pos", "origin_rot", "axis"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=a.name)
    assert (tx.floating, tx.root_body, tx.motor_gears, tx.joint_armature, tx.geom_friction) == (
        jx.floating, jx.root_body, jx.motor_gears, jx.joint_armature, jx.geom_friction)
    assert list(tx.link_spheres) == list(jx.link_spheres)
    for name, sph in jx.link_spheres.items():
        for (p, r), (jp, jr) in zip(tx.link_spheres[name], sph, strict=True):
            np.testing.assert_array_equal(p, jp)
            assert r == jr
    ja, _ = jmodel.compile_mjcf(path)
    ta, _ = tmodel.compile_mjcf(path)
    _compare_models(ta, ja)

    jenv, tenv = jax_env(kind, num_envs=4), port_env(kind, num_envs=4)
    widths = {"ant": (60, 8, 37, 4), "humanoid": (108, 21, 51, 2)}[kind]
    assert (tenv.num_obs, tenv.num_actions, tenv.scene.slots.num_slots,
            len(tenv.feet_bodies)) == widths
    assert (jenv.num_obs, jenv.num_actions, jenv.scene.slots.num_slots) == widths[:3]
    np.testing.assert_array_equal(tenv.feet_bodies, jenv.feet_bodies)
    np.testing.assert_array_equal(tenv.gears.numpy(), np.asarray(jenv.gears))
    np.testing.assert_array_equal(tenv.motor_effort_ratio.numpy(),
                                  np.asarray(jenv.motor_effort_ratio))
    np.testing.assert_array_equal(tenv.q_init.numpy(), np.asarray(jenv.q_init))
    js, ts = jenv.scene, tenv.scene
    np.testing.assert_array_equal(ts.spheres.body, np.asarray(js.spheres.body))
    np.testing.assert_allclose(ts.spheres.offset.numpy(), np.asarray(js.spheres.offset),
                               atol=1e-7)
    np.testing.assert_array_equal(ts.spheres.radius.numpy(), np.asarray(js.spheres.radius))
    np.testing.assert_array_equal(ts.slots.friction, np.asarray(js.slots.friction))
    np.testing.assert_array_equal(ts.slots.robot_body, np.asarray(js.slots.robot_body))
    if kind == "ant":
        np.testing.assert_array_equal(tenv.gears[6:].numpy(), 15.0)
        assert abs(float(ta.mass.sum()) - 0.911) < 1e-3
    else:
        assert set(tu.links) >= {"head", "right_foot", "left_foot"}
        assert ta.sites["head"].body == ta.body_names.index("torso")  # welded


# --- env steps --------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ant", "humanoid"])
def test_env_reset_and_steps_match(kind):
    jenv, tenv = jax_env(kind, num_envs=B), port_env(kind, num_envs=B)
    key = jax.random.PRNGKey(11)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(jenv, key, B))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert_state_close(ts, js)

    step = jax.jit(jenv.step)
    for _ in range(SETTLE[kind]):  # down onto the ground
        js, jr = step(js, jnp.zeros((B, tenv.num_actions)))
    assert not np.asarray(jr.done).any()
    prog = np.asarray(js.progress).copy()
    prog[0] = jenv.cfg.episode_length - 2  # env 0 times out at the second step
    js = js._replace(progress=jnp.asarray(prog))
    ts = port_state(js)
    rng = np.random.default_rng(4)
    dones = []
    for i in range(2):
        impulse = np.abs(np.asarray(js.physics.contact_impulse)).sum((1, 2))
        assert (impulse > 0).all(), f"step {i}: envs off the ground {impulse}"
        assert (ts.physics.contact_impulse.abs().sum((1, 2)) > 0).all()
        a = rng.uniform(-1.0, 1.0, (B, tenv.num_actions)).astype(np.float32)
        draws = step_draws(jenv, js.key, B)
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}", extra=POTENTIAL_ULPS)
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"progress_reward"}
        _close(tr.info["progress_reward"], jr.info["progress_reward"], VEL_TOL,
               "progress_reward", extra=POTENTIAL_ULPS)
        assert tr.teacher_obs.shape == (B, 0)
        assert_state_close(ts, js)
        dones.append(tr.done.numpy())
    assert not dones[0].any() and dones[1][0]
    assert int(ts.progress[0]) == 0 and float(ts.physics.robot.base_pos[0, 2]) == \
        pytest.approx(tenv.cfg.start_height, abs=1e-6)  # the fresh episode


def test_ant_settles_upright():
    """Zero torque from the same reset in both packages (B = 32, 90 steps):
    the Ant comes to rest standing on its feet."""
    n = 32
    jenv, tenv = jax_env("ant", num_envs=n), port_env("ant", num_envs=n)
    key = jax.random.PRNGKey(0)
    js, _ = jenv.reset(key)
    ts, _ = tenv.reset(0, fresh_draws(jenv, key, n))
    step = jax.jit(jenv.step)
    for _ in range(90):
        js, jr = step(js, jnp.zeros((n, 8)))
        ts, tr = tenv.step(ts, torch.zeros(n, 8))
    weight = 0.5 * 0.911 * 9.81
    for name, z, up, fz, obs in (
            ("jax", np.asarray(js.physics.robot.base_pos[:, 2]), np.asarray(jr.obs[:, 10]),
             np.asarray(js.feet_force[..., 2]).sum(-1), np.asarray(jr.obs)),
            ("port", ts.physics.robot.base_pos[:, 2].numpy(), tr.obs[:, 10].numpy(),
             ts.feet_force[..., 2].sum(-1).numpy(), tr.obs.numpy())):
        assert (z > 0.2).all() and (z < 0.5).all(), (name, z)
        assert (up > 0.9).all(), (name, up)
        assert (fz > weight).mean() >= 0.9, (name, np.sort(fz)[:4])
        assert np.isfinite(obs).all(), name
    # the same rest: the torso heights agree to 5 mm (90 contact steps of
    # float32 in two libraries: one env of the 32 lies 1.9 mm apart, the
    # rest within 1e-5 m; measured)
    np.testing.assert_allclose(ts.physics.robot.base_pos[:, 2].numpy(),
                               np.asarray(js.physics.robot.base_pos[:, 2]), atol=5e-3)


# --- spd_inverse at the Cartpole's and the Humanoid's n ---------------------------------


@pytest.mark.parametrize("n,seed", [(27, 3), (2, 4)], ids=["n27", "n2"])
def test_spd_inverse_plain_matches(n, seed):
    """The plain version against the JAX package's jnp fallback (atol 1e-5)."""
    M = spd_batch(64, n, seed=seed)
    want = np.asarray(j_spd_inverse(M, force_pallas=False))
    got = tspd.spd_inverse(torch.tensor(np.asarray(M))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert tspd.launches == 0


def _warp_layout(M):
    """The n = 27 kernel's data flow in numpy float32 for one matrix: lane
    i holds row i (32 lanes, rows past n zero); Cholesky step j takes row j
    of L from lane j and its pivot's inverse; lane k's sums for W's row k
    are broadcast, scaled by 1 / L_kk, and taken by every lane's sums and
    Minv's rows."""
    n, lanes = M.shape[0], 32
    i = np.arange(lanes)
    R = np.zeros((lanes, n), np.float32)
    R[:n] = M
    for j in range(n):
        a = R[:, j].copy()
        for k in range(j):
            a = a - R[:, k] * R[j, k]
        inv = np.float32(1.0) / np.sqrt(np.maximum(a[j], np.float32(1e-12)))
        R[:, j] = np.where(i == j, inv, np.where(i > j, a * inv, np.float32(0.0)))
    T = np.zeros((lanes, n), np.float32)
    G = np.zeros((lanes, n), np.float32)
    for k in range(n):
        dk = R[k, k]  # 1 / L_kk
        v = np.append(T[k, :k] * dk, dk)  # row k of W, broadcast and scaled
        wka = np.where(i <= k, v[np.minimum(i, k)], np.float32(0.0))
        for r in range(k + 1):
            T[:, r] = T[:, r] - R[:, k] * v[r]
        for c in range(k + 1):
            G[:, c] += wka * v[c]
    return G[:n]


def test_spd_inverse_warp_layout_matches_plain():
    M = np.asarray(spd_batch(4, 27, seed=5))
    want = tspd.spd_inverse_plain(torch.tensor(M)).numpy()
    for b in range(M.shape[0]):
        got = _warp_layout(M[b])
        np.testing.assert_array_equal(got, got.T)  # symmetric by construction
        np.testing.assert_allclose(got, want[b], atol=1e-5 * np.abs(want[b]).max())


# --- the learner -----------------------------------------------------------------


def test_ant_train_iter_matches():
    n, T = 16, 2
    cfg = dict(hidden=(32, 32), horizon=T, minibatch_size=8)
    jenv, tenv = jax_env("ant", num_envs=n), port_env("ant", num_envs=n)
    jp = jppo.PPO(jenv, jppo.PPOConfig(**cfg))
    jts = jp.init(jax.random.PRNGKey(5))
    # envs 0 and 1 time out at the rollout's first and second steps
    prog = np.zeros(n, np.int32)
    prog[:2] = jenv.cfg.episode_length - np.array([1, 2])
    jts = jts._replace(env_state=jts.env_state._replace(progress=jnp.asarray(prog)))
    captured = {}
    update = jp._update_from_traj

    def capture(ts_, traj, env_state, last_obs, *args, **kw):
        captured["traj"], captured["last_obs"] = traj, last_obs
        return update(ts_, traj, env_state, last_obs, *args, **kw)

    jp._update_from_traj = capture
    j_new, j_stats = jp.train_iter(jts)
    k_next, k_roll, _ = jax.random.split(jts.key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (n, 8)))
                      for k in jax.random.split(k_roll, T)])
    draws, key = [], jts.env_state.key
    for _ in range(T):
        draws.append(step_draws(jenv, key, n))
        key = jax.random.split(key)[0]

    leaves = [np.asarray(x) for x in jax.tree.leaves(jts)]
    n_env = len(jax.tree.leaves(jts.env_state))
    assert n_env == 16
    env_state = port_state(jts.env_state)
    tcfg = tppo.PPOConfig(**cfg)
    tp = tppo.PPO(_DrawnEnv(tenv, draws), tcfg, device="cpu")
    tts = train_state_from_leaves(leaves, env_state, _t(jts.last_obs), cfg=tcfg, n_env=n_env)
    traj, env_state, last_obs = tp.rollout(tts, _t(noise))[:3]
    want = captured["traj"]
    assert np.asarray(want.done)[[0, 1], [0, 1]].all()  # restarts from the draws
    for k, tol in (("obs", 2e-3), ("mu", 2e-3), ("logp", 1e-4), ("value", 2e-3)):
        _close(getattr(traj, k), getattr(want, k), tol, k)
    _close(traj.reward, want.reward, VEL_TOL, "reward", extra=POTENTIAL_ULPS)
    np.testing.assert_array_equal(traj.done.numpy(), np.asarray(want.done))

    kls = record_kls(tp)
    _close(last_obs, captured["last_obs"], 2e-3, "last obs")
    t_new, t_stats = tp._update_from_traj(
        tts, _port_traj({k: np.asarray(getattr(want, k)) for k in TRAJ_FIELDS}),
        env_state, _t(captured["last_obs"]), perms=_t(_perms(k_next, 4, T * n)).long())
    got = learner_to_leaves(t_new, tcfg)
    want_leaves = [np.asarray(x) for x in jax.tree.leaves(
        (j_new.params, j_new.opt_state, j_new.obs_stats, j_new.value_stats, j_new.lr))]
    P = len(tppo.param_names(tcfg))
    assert len(got) == len(want_leaves) == 3 * P + 4 + 7
    for i, w in enumerate(want_leaves):
        assert got[i].dtype == w.dtype and got[i].shape == w.shape, i
        if i < P:  # 1e-5: see the module docstring
            np.testing.assert_allclose(got[i], w, atol=1e-5, err_msg=f"leaf {i}")
        elif P + 4 <= i < 3 * P + 4:
            tol = max(1e-6, 1e-4 * float(np.abs(w).max()))
            np.testing.assert_allclose(got[i], w, atol=tol, err_msg=f"leaf {i}")
        elif i < P + 4:
            np.testing.assert_array_equal(got[i], w, err_msg=f"leaf {i}")
        elif i < 3 * P + 4 + 6:  # stats: 1e-5 relative, 1e-7 where a mean is near 0
            np.testing.assert_allclose(got[i], w, rtol=1e-5, atol=1e-7, err_msg=f"leaf {i}")
    assert_same_lr(float(got[-1]), float(want_leaves[-1]), kls)
    assert bool(t_stats["kl_guard_triggered"]) == bool(j_stats["kl_guard_triggered"])
    for k in ("reward_mean", "episode_done_frac", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
