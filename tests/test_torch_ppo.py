"""The port's learner against the JAX package, piece by piece: running
statistics, GAE with the bootstrap value and the env-major flatten, the
optimizer against optax, one `_update_from_traj` from ckpt_5200's learner
(and one that trips the KL guard), the flax-default init, and checkpoints
the JAX loader reads. Inputs come from numpy seeds; the learner state from
docs/evidence/lift_r3a/ckpt_5200.npz. No asset is needed: the learners get
a stub env."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import handarm_tpu.learn.ppo as jppo
from handarm_tpu.learn import running_stats as jrs
from handarm_tpu.learn.networks import ActorCritic as JaxActorCritic
from handarm_tpu.utils.checkpoint import load_checkpoint
from handarm_tpu_torch.convert import learner_to_leaves, train_state_from_leaves
from handarm_tpu_torch.learn import optim
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.learn import running_stats as trs
from handarm_tpu_torch.learn.networks import TRUNCATED_STD, ActorCritic, flax_names
from handarm_tpu_torch.utils import checkpoint as tck
from test_torch_train import assert_same_lr, record_kls

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "evidence", "lift_r3a", "ckpt_5200.npz")
NUM_OBS, NUM_ACTIONS = 121, 11


@pytest.fixture(scope="module")
def jax_ts():
    return load_checkpoint(CKPT)


@pytest.fixture(scope="module")
def leaves():
    return tck.read_leaves(CKPT)


def _stub(num_envs):
    return SimpleNamespace(num_obs=NUM_OBS, num_actions=NUM_ACTIONS,
                           cfg=SimpleNamespace(num_envs=num_envs))


def _t(x):
    return torch.as_tensor(np.array(x))


# --- running statistics -----------------------------------------------------

STATS_CASES = {
    # fresh stats: count 1e-4 < 2N, no winsorizing
    "fresh": dict(count=None, outlier=False, nonfinite=False),
    # seasoned stats (count > 2N): a 1e6 outlier is winsorized to mean+10 sigma
    "winsorized": dict(count=1e5, outlier=True, nonfinite=False),
    # NaN and inf samples become the current mean
    "nonfinite": dict(count=1e5, outlier=False, nonfinite=True),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_running_stats_match(case):
    """init_stats, update_stats and denormalize on [64, 5] batches. float32
    means and variances of 64 samples in two libraries: 1e-6 relative."""
    c = STATS_CASES[case]
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, (64, 5)).astype(np.float32)
    if c["outlier"]:
        x[3, 1] = 1e6
    if c["nonfinite"]:
        x[5, 0], x[7, 4] = np.nan, np.inf
    j = jrs.init_stats((5,))
    t = trs.init_stats((5,))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if c["count"] is not None:
        mean = rng.normal(0, 1, 5).astype(np.float32)
        var = rng.uniform(0.5, 2.0, 5).astype(np.float32)
        j = jrs.RunningStats(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(c["count"],
                                                                              jnp.float32))
        t = trs.RunningStats(_t(mean), _t(var), torch.tensor(c["count"], dtype=torch.float32))
    j2 = jrs.update_stats(j, jnp.asarray(x))
    t2 = trs.update_stats(t, _t(x))
    for a, b in zip(t2, j2):
        assert np.all(np.isfinite(a.numpy()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    if c["outlier"]:  # the outlier is clipped: the variance stays O(1)
        assert float(t2.var[1]) < 10.0
    v = rng.normal(0, 1, (7, 5)).astype(np.float32)
    np.testing.assert_allclose(trs.denormalize(t2, _t(v)).numpy(),
                               np.asarray(jrs.denormalize(j2, jnp.asarray(v))), rtol=1e-6)


# --- GAE, bootstrap, flatten ------------------------------------------------

def _trajectory(jax_ts, rng, T, B, offset=0, mu_shift=0.0):
    """A [T, B] trajectory of ckpt_5200's policy on the checkpoint's own
    observations (envs offset + t*B ...), computed by the JAX package: noise,
    rewards and done flags from `rng`; numpy arrays."""
    net = JaxActorCritic(num_actions=NUM_ACTIONS)
    all_obs = np.asarray(jax_ts.last_obs)
    obs = np.stack([all_obs[offset + t * B: offset + (t + 1) * B] for t in range(T)])
    mu, log_std, value = net.apply(jax_ts.params,
                                   jrs.normalize(jax_ts.obs_stats, jnp.asarray(obs)))
    eps = rng.normal(size=mu.shape).astype(np.float32)
    action = mu + jnp.exp(log_std) * eps
    logp = jppo._gaussian_logp(mu, log_std, action)
    value = jrs.denormalize(jax_ts.value_stats, value)
    reward = rng.uniform(0.0, 0.06, (T, B)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.05
    return dict(obs=obs, action=np.asarray(action), logp=np.asarray(logp),
                value=np.asarray(value), reward=reward, done=done,
                mu=np.asarray(mu) + np.float32(mu_shift), sigma=np.asarray(jnp.exp(log_std)),
                last_obs=all_obs[offset + T * B: offset + (T + 1) * B].copy())


def _jax_traj(tr):
    T, B = tr["reward"].shape
    return jppo.Transition(
        obs=jnp.asarray(tr["obs"]), action=jnp.asarray(tr["action"]),
        logp=jnp.asarray(tr["logp"]), value=jnp.asarray(tr["value"]),
        reward=jnp.asarray(tr["reward"]), done=jnp.asarray(tr["done"]),
        mu=jnp.asarray(tr["mu"]), sigma=jnp.asarray(tr["sigma"]),
        teacher_obs=jnp.zeros((T, B, 0), jnp.float32))


TRAJ_FIELDS = ("obs", "action", "logp", "value", "reward", "done", "mu", "sigma")


def _port_traj(tr):
    return tppo.Transition(*(_t(tr[k]) for k in TRAJ_FIELDS))


def _jax_ppo(jax_ts, B, **cfg):
    ppo = jppo.PPO(_stub(B), jppo.PPOConfig(**cfg))
    return ppo, jax_ts._replace(env_state=None, last_obs=None)


def _port_ppo(leaves, B, **cfg):
    ppo = tppo.PPO(_stub(B), tppo.PPOConfig(**cfg), device="cpu")
    return ppo, train_state_from_leaves(leaves, None, None)


def test_gae_bootstrap_flatten_match(jax_ts, leaves, monkeypatch):
    """A [16, 8] trajectory with done flags; one env's last observation is
    NaN, so its bootstrap value is non-finite and must count as 0. The
    returns the JAX package hands to its value-stats update (captured) are
    GAE + values, flattened env-major; the port's must agree within 1e-3
    (its bootstrap values are the policy's, 1e-4 before the value stats'
    sigma of 7.6), and the flattened observations exactly."""
    T, B = 16, 8
    tr = _trajectory(jax_ts, np.random.default_rng(2), T, B)
    tr["last_obs"][3] = np.nan
    assert tr["done"].any()
    seen = []
    update = jppo.update_stats

    def recording(stats, batch):
        seen.append(np.asarray(batch))
        return update(stats, batch)

    monkeypatch.setattr(jppo, "update_stats", recording)
    jp, jts = _jax_ppo(jax_ts, B, horizon=T, minibatch_size=64, mini_epochs=1)
    jp._update_from_traj(jts, _jax_traj(tr), None, jnp.asarray(tr["last_obs"]), None,
                         jax.random.PRNGKey(0))
    obs_flat, returns_flat = seen

    tp, tts = _port_ppo(leaves, B, horizon=T, minibatch_size=64, mini_epochs=1)
    _, _, raw = tp.policy_value(tts.params, tts.obs_stats, _t(tr["last_obs"]))
    assert not torch.isfinite(raw[3])
    last_value = tp.value_of(tts.value_stats, raw)
    assert float(last_value[3]) == 0.0
    adv = tppo.gae(_t(tr["reward"]), _t(tr["value"]), _t(tr["done"]), last_value,
                   tp.cfg.gamma, tp.cfg.tau)
    returns = tppo.flatten_env_major(adv + _t(tr["value"]))
    np.testing.assert_array_equal(tppo.flatten_env_major(_t(tr["obs"])).numpy(), obs_flat)
    np.testing.assert_allclose(returns.numpy(), returns_flat.reshape(-1), atol=1e-3)
    # the NaN env's returns are finite: its bootstrap counted as 0
    assert np.all(np.isfinite(returns.numpy()))


# --- optimizer --------------------------------------------------------------

OPT_CASES = ("plain", "clipped", "nonfinite")


@pytest.mark.parametrize("case", OPT_CASES)
def test_optimizer_matches_optax(case, jax_ts, leaves):
    """One step of the optax chain the JAX learner builds, from ckpt_5200's
    params and Adam state (count 332,800), on gradients from a numpy seed:
    global norm 0.3 (passes unclipped), 7 (clipped to 1), or with a NaN
    (skipped: zero updates, Adam state unchanged, counters up). Moments in
    float32 by the same formulas: 1e-5 relative, 1e-8 absolute. Updates are
    O(1) (mu_hat / sqrt(nu_hat)) and lose relative precision where the new
    moment nearly cancels (XLA fuses the moment update into an FMA): 1e-5
    relative, 1e-6 absolute."""
    rng = np.random.default_rng(3)
    names = flax_names(3)
    flat = jax.tree_util.tree_flatten_with_path(jax_ts.params)[0]
    assert [".".join(str(k.key) for k in p[1:]) for p, _ in flat] == [f for f, _ in names]
    grads = [rng.normal(size=np.shape(x)).astype(np.float32) for _, x in flat]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    scale = {"plain": 0.3, "clipped": 7.0, "nonfinite": 1.0}[case]
    grads = [g * np.float32(scale / norm) for g in grads]
    if case == "nonfinite":
        grads[4][2] = np.nan
    jp = jppo.PPO(_stub(8), jppo.PPOConfig())
    j_grads = jax.tree_util.tree_unflatten(jax.tree.structure(jax_ts.params),
                                           [jnp.asarray(g) for g in grads])
    j_upd, j_state = jp.optimizer.update(j_grads, jax_ts.opt_state, jax_ts.params)

    ts = train_state_from_leaves(leaves, None, None)
    t_grads = {t: _t(g).T.contiguous() if f.endswith(".kernel") else _t(g)
               for (f, t), g in zip(names, grads)}
    t_upd, t_state = optim.update(t_grads, ts.opt_state, max_norm=1.0)
    new_leaves = learner_to_leaves(ts._replace(opt_state=t_state))[11:37]
    want_state = jax.tree.leaves(j_state)
    for i, (g, w) in enumerate(zip(new_leaves, want_state)):
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w)
        if i < 4:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"opt leaf {i}")
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-8)
    for (f, t), w in zip(names, jax.tree.leaves(j_upd)):
        g = t_upd[t].T if f.endswith(".kernel") else t_upd[t]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=f)
    count = int(t_state.count)
    if case == "nonfinite":
        assert count == 332800 and not bool(t_state.last_finite)
        assert int(t_state.notfinite_count) == int(t_state.total_notfinite) == 1
        assert all(float(u.abs().max()) == 0.0 for u in t_upd.values())
        for k in t_state.mu:
            assert torch.equal(t_state.mu[k], ts.opt_state.mu[k])
            assert torch.equal(t_state.nu[k], ts.opt_state.nu[k])
    else:
        assert count == 332801 and bool(t_state.last_finite)


# --- one update from ckpt_5200 ----------------------------------------------

def _perms(key, epochs, n, shards=1):
    """The permutations _update_from_traj draws from `key`: [epochs, shards,
    n / shards], one per data shard of each mini-epoch."""
    return np.stack([
        np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, n // shards))(
            jax.random.split(k, shards)))
        for k in jax.random.split(jax.random.fold_in(key, 1), epochs)])


UPDATE_CASES = {
    # the checkpoint's own policy: small KLs, the adaptive lr moves
    "update": 0.0,
    # the recorded mu shifted by 2: KL ~22 > kl_guard, the update is discarded
    "kl_guard": 2.0,
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_from_traj_matches(case, jax_ts, leaves):
    """One `_update_from_traj` from ckpt_5200's TrainState at B = 64, T = 16,
    minibatch 256 (4 minibatches x 4 mini-epochs = 16 Adam steps) on a
    trajectory of its own policy, with the JAX package's permutations.
    Params and Adam moments within 1e-6 (the update moves them by up to
    ~1e-3), counters and epoch exact, stats within 1e-5 relative, the lr
    equal (or a KL at a branch threshold, printed). The guard case must
    give back the old learner bit for bit and half the lr."""
    T, B, key = 16, 64, jax.random.PRNGKey(7)
    tr = _trajectory(jax_ts, np.random.default_rng(4), T, B, offset=100,
                     mu_shift=UPDATE_CASES[case])
    cfg = dict(horizon=T, minibatch_size=256)
    jp, jts = _jax_ppo(jax_ts, B, **cfg)
    j_new, j_stats = jax.jit(jp._update_from_traj)(
        jts._replace(key=key), _jax_traj(tr), None, jnp.asarray(tr["last_obs"]), None, key)
    tp, tts = _port_ppo(leaves, B, **cfg)
    kls = record_kls(tp)
    t_new, t_stats = tp._update_from_traj(tts, _port_traj(tr), None, _t(tr["last_obs"]),
                                          perms=_t(_perms(key, 4, T * B)).long())
    assert len(kls) == 16
    got, old = learner_to_leaves(t_new), learner_to_leaves(tts)
    want = jax.tree.leaves((j_new.params, j_new.opt_state, j_new.obs_stats,
                            j_new.value_stats, j_new.lr))
    guard = bool(t_stats["kl_guard_triggered"])
    assert guard == bool(j_stats["kl_guard_triggered"]) == (case == "kl_guard")
    for i, w in enumerate(want):
        w = np.asarray(w)
        assert got[i].dtype == w.dtype and got[i].shape == w.shape, i
        if guard and i < 43:
            np.testing.assert_array_equal(got[i], old[i], err_msg=f"leaf {i} not reverted")
        if i < 11 or 15 <= i < 37:  # params, Adam moments
            np.testing.assert_allclose(got[i], w, atol=1e-6, err_msg=f"leaf {i}")
        elif i < 15:  # optax counters
            np.testing.assert_array_equal(got[i], w, err_msg=f"leaf {i}")
        elif i < 43:  # running stats
            np.testing.assert_allclose(got[i], w, rtol=1e-5, err_msg=f"leaf {i}")
    assert_same_lr(float(got[43]), float(want[43]), kls)
    assert int(t_new.epoch) == int(j_new.epoch) == 5201
    if guard:
        assert float(got[43]) == np.float32(float(old[43]) / 2.0)
    else:
        moved = max(float(np.abs(got[i] - old[i]).max()) for i in range(11))
        assert moved > 1e-5 and int(t_new.opt_state.count) == 332800 + 16
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


# --- flax-default init ------------------------------------------------------

def test_flax_default_init():
    """Shapes as flax's (kernels transposed), zero biases and log_std,
    kernels truncated at +-2 sigma with sigma = sqrt(1/fan_in)/0.8796, and
    each kernel's sample std within 6 standard errors (1/sqrt(2n) relative,
    for n entries) of sqrt(1/fan_in), the std of the truncated draw; flax's
    own kernels pass the same check. One generator seed gives one init.
    """
    hidden = (256, 128, 64)
    gen = torch.Generator().manual_seed(0)
    net = ActorCritic(48, 6, hidden).init_flax_default(gen)
    flax = JaxActorCritic(num_actions=6, hidden=hidden).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 48)))["params"]
    params = net.param_dict()
    for f, t in flax_names(3):
        layer, leaf = f.split(".") if "." in f else (f, None)
        w = np.asarray(flax[layer] if leaf is None else flax[layer][leaf])
        p = params[t].numpy()
        p = p.T if f.endswith(".kernel") else p
        assert p.shape == w.shape, f
        if not f.endswith(".kernel"):
            assert not p.any(), f
            continue
        fan_in = p.shape[0]
        sigma = np.sqrt(1.0 / fan_in) / TRUNCATED_STD
        assert np.abs(p).max() <= 2 * sigma * (1 + 1e-6), f
        tol = 6.0 / np.sqrt(2.0 * p.size)
        assert abs(p.std() / np.sqrt(1.0 / fan_in) - 1) < tol, (f, p.std())
        assert abs(w.std() / np.sqrt(1.0 / fan_in) - 1) < tol, (f, w.std())
    again = ActorCritic(48, 6, hidden).init_flax_default(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(params.values(), again.param_dict().values()))


# --- checkpoints ------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path, jax_ts, leaves):
    """The port reads ckpt_5200 and writes it back: every leaf but the two
    PRNG keys bit-identical, all 71 with the JAX file's shapes and dtypes;
    the keys are the seed's [0, seed]."""
    ts = tck.load_train_state(CKPT)
    path = tck.save_checkpoint(str(tmp_path), ts, 5200, seed=9)
    tck.wait_for_pending_saves()
    assert os.path.basename(path) == "ckpt_5200.npz"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    back = tck.read_leaves(path)
    assert len(back) == len(leaves) == 71
    for i, (g, w) in enumerate(zip(back, leaves)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if i in (61, 69):
            np.testing.assert_array_equal(g, np.asarray([0, 9], np.uint32))
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
    assert tck.latest_checkpoint(str(tmp_path)) == path


def test_jax_loader_reads_port_checkpoint(tmp_path, jax_ts):
    """`handarm_tpu.utils.checkpoint.load_checkpoint(port_file,
    example_tree=<ckpt_5200>)` loads a checkpoint the port wrote after one
    update; its params and optimizer state equal the port's."""
    ts = tck.load_train_state(CKPT)
    ts = ts._replace(params={k: p + 0.5 for k, p in ts.params.items()},
                     epoch=ts.epoch + 1)
    path = tck.save_checkpoint(str(tmp_path), ts, 5201, sync=True)
    assert not os.path.exists(path + ".tree")
    loaded = load_checkpoint(path, example_tree=jax_ts)
    names = flax_names(3)
    for (f, t), w in zip(names, jax.tree.leaves(loaded.params)):
        p = ts.params[t].numpy()
        np.testing.assert_array_equal(p.T if f.endswith(".kernel") else p, np.asarray(w))
    assert int(loaded.epoch) == 5201 and int(loaded.opt_state.inner_state[1].count) == 332800
    assert loaded.env_state.physics.robot.q.shape == (8192, 17)



# --- the PPOConfig switches, each at its non-default value --------------------

FLAG_CASES = {
    "num_minibatches": dict(num_minibatches=2),  # 2 minibatches of 512, not 4 of 256
    "lr_schedule": dict(lr_schedule="fixed"),
    "clip_value": dict(clip_value=False),
    "normalize_input": dict(normalize_input=False),
    "normalize_value": dict(normalize_value=False),
    "normalize_advantage": dict(normalize_advantage=False),
    "value_bootstrap": dict(value_bootstrap=False),
}


class _JaxTableEnv:
    """An env whose step t returns row t of fixed tables, whatever the
    action: observations obs[t + 1], rewards, done flags. Its state is t."""

    def __init__(self, obs, reward, done):
        self.obs, self.reward, self.done = (jnp.asarray(x) for x in (obs, reward, done))
        self.num_obs, self.num_actions, self.num_teacher_obs = NUM_OBS, NUM_ACTIONS, 0
        self.cfg = SimpleNamespace(num_envs=obs.shape[1])

    def step(self, t, a):
        B = self.cfg.num_envs
        return t + 1, SimpleNamespace(obs=self.obs[t + 1], reward=self.reward[t],
                                      done=self.done[t], info={},
                                      teacher_obs=jnp.zeros((B, 0), jnp.float32))


class _TorchTableEnv(_JaxTableEnv):
    def __init__(self, obs, reward, done):
        self.obs, self.reward, self.done = _t(obs), _t(reward), _t(done)
        self.num_obs, self.num_actions = NUM_OBS, NUM_ACTIONS
        self.cfg = SimpleNamespace(num_envs=obs.shape[1])

    def step(self, t, a):
        return t + 1, SimpleNamespace(obs=self.obs[t + 1], reward=self.reward[t],
                                      done=self.done[t], info={})


@pytest.mark.parametrize("flag", sorted(FLAG_CASES))
def test_ppo_flags_match(flag, jax_ts, leaves):
    """One train iteration from ckpt_5200's learner at B = 64, T = 16,
    minibatch 256, with one PPOConfig switch at its non-default value, on a
    table env (observations from the checkpoint's own, rewards 0-6 and 10 %
    done flags from a numpy seed). The rollout on each side, with the JAX
    package's noise: every observation the same, so mu and logp within
    1e-4 and values and rewards within 1e-3 (float32 matmuls in two
    libraries; values denormalized by a sigma of 7.6). Then one
    `_update_from_traj` on the JAX package's trajectory with its
    permutations, held as `test_update_from_traj_matches` holds it, but
    Adam's moments within 1e-6 or 1e-4 of each one's largest value, the
    larger: without input normalization the raw observations drive the mu
    head's gradient moments to 4e-2, float32 sums of 256 per-sample terms
    taken in another order by each library (measured: 3.1e-5 of that
    scale; every other case within 1e-6)."""
    T, B, key = 16, 64, jax.random.PRNGKey(9)
    rng = np.random.default_rng(5)
    all_obs = np.asarray(jax_ts.last_obs)
    obs = np.stack([all_obs[200 + t * B: 200 + (t + 1) * B] for t in range(T + 1)])
    reward = rng.uniform(0.0, 6.0, (T, B)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.1
    cfg = dict(horizon=T, minibatch_size=256, **FLAG_CASES[flag])
    jp = jppo.PPO(_JaxTableEnv(obs, reward, done), jppo.PPOConfig(**cfg))
    captured = {}
    update = jp._update_from_traj

    def capture(ts_, traj, *args, **kw):
        captured["traj"] = traj
        return update(ts_, traj, *args, **kw)

    jp._update_from_traj = capture
    jts = jax_ts._replace(env_state=jnp.int32(0), last_obs=jnp.asarray(obs[0]), key=key)
    j_new, j_stats = jp.train_iter(jts)
    k_next, k_roll, _ = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, NUM_ACTIONS)))
                      for k in jax.random.split(k_roll, T)])

    tp = tppo.PPO(_TorchTableEnv(obs, reward, done), tppo.PPOConfig(**cfg), device="cpu")
    tts = train_state_from_leaves(leaves, 0, _t(obs[0]))
    traj, env_state, last_obs = tp.rollout(tts, _t(noise))[:3]
    want = captured["traj"]
    assert env_state == T and torch.equal(last_obs, _t(obs[T]))
    for k, tol in (("mu", 1e-4), ("logp", 1e-4), ("value", 1e-3), ("reward", 1e-3)):
        np.testing.assert_allclose(getattr(traj, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=tol, err_msg=k)
    if flag == "value_bootstrap":  # no done step earns its value
        np.testing.assert_allclose(traj.reward.numpy(), reward * 0.01, rtol=1e-6)

    kls = record_kls(tp)
    t_new, t_stats = tp._update_from_traj(
        tts, _port_traj({k: np.asarray(getattr(want, k)) for k in TRAJ_FIELDS}),
        env_state, last_obs, perms=_t(_perms(k_next, 4, T * B)).long())
    assert tp.num_minibatches == jp.num_minibatches == (2 if flag == "num_minibatches" else 4)
    got = learner_to_leaves(t_new)
    want_leaves = jax.tree.leaves((j_new.params, j_new.opt_state, j_new.obs_stats,
                                   j_new.value_stats, j_new.lr))
    assert bool(t_stats["kl_guard_triggered"]) == bool(j_stats["kl_guard_triggered"])
    for i, w in enumerate(want_leaves):
        w = np.asarray(w)
        assert got[i].dtype == w.dtype and got[i].shape == w.shape, i
        if i < 11:  # params
            np.testing.assert_allclose(got[i], w, atol=1e-6, err_msg=f"leaf {i}")
        elif 15 <= i < 37:  # Adam moments
            tol = max(1e-6, 1e-4 * float(np.abs(w).max()))
            np.testing.assert_allclose(got[i], w, atol=tol, err_msg=f"leaf {i}")
        elif i < 15:  # optax counters
            np.testing.assert_array_equal(got[i], w, err_msg=f"leaf {i}")
        elif i < 43:  # running stats
            np.testing.assert_allclose(got[i], w, rtol=1e-5, err_msg=f"leaf {i}")
    if flag == "lr_schedule":
        assert float(got[43]) == float(want_leaves[43]) == np.float32(float(jax_ts.lr))
    assert_same_lr(float(got[43]), float(want_leaves[43]), kls)
    if flag in ("normalize_input", "normalize_value"):  # those stats stay as they were
        old = learner_to_leaves(tts)
        idx = range(37, 40) if flag == "normalize_input" else range(40, 43)
        for i in idx:
            np.testing.assert_array_equal(got[i], old[i], err_msg=f"leaf {i}")
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
