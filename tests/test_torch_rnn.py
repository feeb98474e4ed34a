"""The port's recurrent and asymmetric learner against the JAX package:
the ValueNet, RecurrentActorCritic and RecurrentValueNet forward passes,
their flax names, leaves and default init; one `train_iter` of each new
PPO layout (MLP with an asymmetric critic; recurrent with and without
`zero_rnn_on_done`; recurrent with an asymmetric critic) and a KL-guard
revert; `act` with its carry; and checkpoints of the three layouts both
ways.

Weights come from flax `init` (keys from numpy seeds) and are carried
across with the port's converters; the JAX package's random draws (policy
noise, sequence permutations) are re-derived from its keys and passed to
the port. The learners get table envs: step t returns row t + 1 of fixed
observation and teacher-observation tables, and row t of rewards and
done flags, whatever the action; done flags fall inside BPTT sequences
and at their ends. No asset is needed.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import handarm_tpu.learn.ppo as jppo
from handarm_tpu.learn import networks as jnets
from handarm_tpu.learn.running_stats import RunningStats as JaxStats
from handarm_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from handarm_tpu_torch.convert import (
    extra_from_leaves,
    extra_to_leaves,
    learner_from_leaves,
    learner_to_leaves,
    params_from_leaves,
)
from handarm_tpu_torch.learn import networks as tnets
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.utils import checkpoint as tck
from test_torch_train import assert_same_lr, record_kls

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "evidence", "lift_r3a", "ckpt_5200.npz")
NUM_OBS, NUM_TEACHER, NUM_ACTIONS = 12, 20, 5
R, HIDDEN = 16, (32,)
B, T, L = 8, 8, 4

LAYOUTS = {
    "mlp asymmetric": dict(asymmetric_critic=True),
    "recurrent": dict(rnn_units=R),
    "recurrent no zeroing": dict(rnn_units=R, zero_rnn_on_done=False),
    "recurrent asymmetric": dict(asymmetric_critic=True, rnn_units=R, critic_rnn_units=R + 8),
}


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _cfg(**kw):
    """The PPOConfig fields of a case: small widths, horizon 8, minibatches
    of 16 samples (4 sequences of 4), 2 mini-epochs: 8 Adam steps."""
    return dict(horizon=T, minibatch_size=16, mini_epochs=2, seq_len=L, hidden=HIDDEN, **kw)


# --- the nets ---------------------------------------------------------------

NETS = {
    "actor": (True, True), "actor no layer norm": (True, False),
    "critic": (False, True), "critic no layer norm": (False, False),
}


def _jax_net(actor: bool, layer_norm: bool):
    if actor:
        return jnets.RecurrentActorCritic(num_actions=NUM_ACTIONS, rnn_units=R, hidden=HIDDEN,
                                          layer_norm=layer_norm)
    return jnets.RecurrentValueNet(rnn_units=R, hidden=HIDDEN, layer_norm=layer_norm)


def _port_net(actor: bool, layer_norm: bool):
    if actor:
        return tnets.RecurrentActorCritic(NUM_OBS, NUM_ACTIONS, R, HIDDEN, layer_norm)
    return tnets.RecurrentValueNet(NUM_OBS, R, HIDDEN, layer_norm)


@pytest.mark.parametrize("case", sorted(NETS))
def test_recurrent_nets_match_flax(case):
    """RecurrentActorCritic and RecurrentValueNet (LSTM 16, hidden (32,),
    with and without the LayerNorm) over 5 steps, each step's carry fed to
    the next, from a nonzero first carry: mu, value and both carry halves
    within 2e-6 of flax (float32 matmuls of 16-32 terms in two libraries;
    measured 4e-7), log_std exact."""
    actor, ln = NETS[case]
    rng = np.random.default_rng(1)
    obs = rng.normal(0.0, 1.5, (5, 7, NUM_OBS)).astype(np.float32)
    c0, h0 = (rng.normal(0.0, 0.5, (7, R)).astype(np.float32) for _ in range(2))
    jnet, tnet = _jax_net(actor, ln), _port_net(actor, ln)
    jparams = jnet.init(jax.random.PRNGKey(int(rng.integers(1 << 30))), obs[0], (c0, h0))
    params = params_from_leaves(tnet, _np(jparams))
    jc, tc = (jnp.asarray(c0), jnp.asarray(h0)), (_t(c0), _t(h0))
    for s in range(5):
        jout = jnet.apply(jparams, jnp.asarray(obs[s]), jc)
        tout = torch.func.functional_call(tnet, params, (_t(obs[s]), tc))
        jc, tc = jout[-1], tout[-1]
        for got, want in zip(tout[:-1], jout[:-1]):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6)
        for got, want in zip(tc, jc):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6)
    if actor:
        np.testing.assert_array_equal(tout[1].detach().numpy(), np.asarray(jout[1]))


def test_value_net_matches_flax():
    """ValueNet (hidden (32, 16)) on [7, 20] teacher observations: within
    1e-6 of flax (measured 1e-7)."""
    rng = np.random.default_rng(2)
    x = rng.normal(0.0, 2.0, (7, NUM_TEACHER)).astype(np.float32)
    jnet = jnets.ValueNet(hidden=(32, 16))
    jparams = jnet.init(jax.random.PRNGKey(5), x)
    tnet = tnets.ValueNet(NUM_TEACHER, (32, 16))
    params = params_from_leaves(tnet, _np(jparams))
    got = torch.func.functional_call(tnet, params, (_t(x),)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(jparams, jnp.asarray(x))), atol=1e-6)


def test_layer_norm_matches_flax():
    """LayerNorm as flax's (epsilon 1e-6, variance E[x^2] - E[x]^2) on rows
    of spread 1e-3 to 1e3 about a mean 5 times the spread, and a constant
    row: within 1e-5 of the output's largest value. E[x^2] is 26 times the
    variance here, so float32 sums in another order move the variance by
    ~26 ulps and the output by half that relative (measured 2.2e-6).
    torch's own layer_norm (epsilon 1e-5, two-pass variance) is over 1e-3
    away on the 1e-3 row."""
    rng = np.random.default_rng(3)
    x = rng.normal(5.0, 1.0, (6, R)) * np.asarray([1e-3, 1e-2, 1, 10, 1e3, 0])[:, None]
    x = x.astype(np.float32)
    scale, bias = (rng.normal(1.0, 0.3, R).astype(np.float32) for _ in range(2))
    import flax.linen as fnn

    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x)))
    ln = tnets.LayerNorm(R)
    got = torch.func.functional_call(ln, {"scale": _t(scale), "bias": _t(bias)},
                                     (_t(x),)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    other = torch.nn.functional.layer_norm(_t(x), (R,), _t(scale), _t(bias)).numpy()
    assert np.abs(other - want).max() > 1e-3


# --- names and leaves -------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_param_names_and_leaves_round_trip(layout):
    """`param_names(cfg)` lists the JAX learner's params in its flattening
    order, by their flax paths; flax leaves carried to the port and back
    are bit-identical, and so are the port's own (param_dict) carried to
    flax's layout and back."""
    cfg = _cfg(**LAYOUTS[layout])
    jp = jppo.PPO(_JaxTableEnv(*_tables(np.random.default_rng(0))), jppo.PPOConfig(**cfg))
    jts = jp.init(jax.random.PRNGKey(4))
    flat = jax.tree_util.tree_flatten_with_path(jts.params)[0]
    paths = ["/".join(str(k.key) for k in p if str(k.key) != "params") for p, _ in flat]
    names = tppo.param_names(tppo.PPOConfig(**cfg))
    assert [f.replace(".", "/") for f, _ in names] == paths
    tp = tppo.PPO(_TorchTableEnv(*_tables(np.random.default_rng(0))), tppo.PPOConfig(**cfg),
                  device="cpu")
    assert [t for _, t in names] == list(tp.net.param_dict())
    leaves = _np(jts.params)
    params = params_from_leaves(tp.net, leaves)  # checks every shape
    back = learner_to_leaves(tppo.TrainState(params, *_opt_and_stats(params)),
                             tppo.PPOConfig(**cfg))[:len(names)]
    for a, b in zip(back, leaves):
        np.testing.assert_array_equal(a, b)
    mine = tp.net.param_dict()
    again = learner_from_leaves(learner_to_leaves(
        tppo.TrainState(mine, *_opt_and_stats(mine)), tppo.PPOConfig(**cfg)), names)[0]
    assert all(torch.equal(mine[k], again[k]) for k in mine)


def _opt_and_stats(params):
    from handarm_tpu_torch.learn import optim
    from handarm_tpu_torch.learn.running_stats import init_stats

    return (optim.init(params), init_stats((NUM_OBS,)), init_stats(()), torch.tensor(3e-4),
            None, None, torch.tensor(0, dtype=torch.int32))


# --- the flax-default init --------------------------------------------------

def test_recurrent_flax_default_init():
    """RecurrentActorCritic (LSTM 64 on 48 observations, hidden (32,)):
    every recurrent kernel orthogonal (W W^T = I within 1e-5; flax's too),
    each its own draw; the input and dense kernels truncated at +-2 sigma
    with sigma = sqrt(1/fan_in)/0.8796 and a sample std within 6 standard
    errors of sqrt(1/fan_in), as flax's; biases and log_std 0, LayerNorm
    scale 1; one generator seed gives one init."""
    units, n_in = 64, 48
    net = tnets.RecurrentActorCritic(n_in, 6, units, (32,)).init_flax_default(
        torch.Generator().manual_seed(0))
    jparams = jnets.RecurrentActorCritic(num_actions=6, rnn_units=units, hidden=(32,)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, n_in)), (jnp.zeros((1, units)),) * 2)
    params = net.param_dict()
    recurrent = []
    for (f, t), w in zip(net.flax_names(), _np(jparams)):
        p = params[t].numpy()
        p = p.T if f.endswith(".kernel") else p
        assert p.shape == w.shape, f
        if f == "rnn_ln.scale":
            assert (p == 1).all() and (w == 1).all()
        elif not f.endswith(".kernel"):
            assert not p.any() and not w.any(), f
        elif f.startswith("lstm/h"):
            for m in (p, w):
                np.testing.assert_allclose(m @ m.T, np.eye(units), atol=1e-5, err_msg=f)
            recurrent.append(p)
        else:
            fan_in = p.shape[0]
            sigma = np.sqrt(1.0 / fan_in) / tnets.TRUNCATED_STD
            assert np.abs(p).max() <= 2 * sigma * (1 + 1e-6), f
            tol = 6.0 / np.sqrt(2.0 * p.size)
            for m in (p, w):
                assert abs(m.std() / np.sqrt(1.0 / fan_in) - 1) < tol, (f, m.std())
    assert len(recurrent) == 4
    assert all(np.abs(a - b).max() > 0.1 for i, a in enumerate(recurrent)
               for b in recurrent[i + 1:])
    again = tnets.RecurrentActorCritic(n_in, 6, units, (32,)).init_flax_default(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(params.values(), again.param_dict().values()))


# --- one train iteration against the JAX package -----------------------------

def _tables(rng):
    """Observation and teacher tables [T + 1, B, ...], rewards and done flags
    [T, B]: 15 % random dones plus env 0 at step 1 (inside a sequence), env
    1 at step 3 (a sequence's last step) and env 2 at step 6."""
    obs = rng.normal(0.0, 2.0, (T + 1, B, NUM_OBS)).astype(np.float32)
    teacher = rng.normal(1.0, 3.0, (T + 1, B, NUM_TEACHER)).astype(np.float32)
    reward = rng.uniform(0.0, 6.0, (T, B)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.15
    done[1, 0] = done[3, 1] = done[6, 2] = True
    return obs, teacher, reward, done


class _JaxTableEnv:
    def __init__(self, obs, teacher, reward, done):
        self.obs, self.teacher, self.reward, self.done = (
            jnp.asarray(x) for x in (obs, teacher, reward, done))
        self.num_obs, self.num_actions, self.num_teacher_obs = NUM_OBS, NUM_ACTIONS, NUM_TEACHER
        self.cfg = SimpleNamespace(num_envs=obs.shape[1])

    def reset(self, key):
        return jnp.int32(0), self.obs[0]

    def observe(self, t):
        return self.obs[t], self.teacher[t], {}

    def step(self, t, a):
        return t + 1, SimpleNamespace(obs=self.obs[t + 1], teacher_obs=self.teacher[t + 1],
                                      reward=self.reward[t], done=self.done[t], info={})


class _TorchTableEnv(_JaxTableEnv):
    def __init__(self, obs, teacher, reward, done):
        self.obs, self.teacher, self.reward, self.done = (
            _t(x) for x in (obs, teacher, reward, done))
        self.num_obs, self.num_actions, self.num_teacher_obs = NUM_OBS, NUM_ACTIONS, NUM_TEACHER
        self.cfg = SimpleNamespace(num_envs=obs.shape[1])
        self.device = torch.device("cpu")


def _jax_state(jp, rng, epoch: int, key):
    """A JAX TrainState: flax-init params (key from `rng`), Adam moments and
    running stats from `rng`, a nonzero carry, lr 3e-4."""
    ts = jp.init(jax.random.PRNGKey(int(rng.integers(1 << 30))))
    params = ts.params
    noise = lambda x, s: jnp.asarray(rng.normal(0.0, s, np.shape(x)).astype(np.float32))
    inner = ts.opt_state.inner_state
    adam = inner[1]._replace(
        count=jnp.int32(40),
        mu=jax.tree.map(lambda x: noise(x, 1e-3), params),
        nu=jax.tree.map(lambda x: jnp.asarray(rng.uniform(1e-6, 1e-5, np.shape(x))
                                              .astype(np.float32)), params))
    opt = ts.opt_state._replace(inner_state=(inner[0], adam) + tuple(inner[2:]))

    def stats(n, loc, s):
        return JaxStats(jnp.asarray(rng.normal(loc, 0.3, n).astype(np.float32)),
                        jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32) * s * s),
                        jnp.float32(500.0))

    hidden = None if ts.hidden is None else jax.tree.map(lambda x: noise(x, 0.3), ts.hidden)
    return ts._replace(
        opt_state=opt, obs_stats=stats(NUM_OBS, 0.0, 2.0), value_stats=stats((), 3.0, 5.0),
        lr=jnp.float32(3e-4), key=key, epoch=jnp.int32(epoch), hidden=hidden,
        teacher_obs_stats=stats(NUM_TEACHER, 1.0, 3.0) if jp.cfg.asymmetric_critic else None)


def _port_state(jts, cfg: tppo.PPOConfig) -> tppo.TrainState:
    """The port's TrainState of a JAX one (its table env at step 0)."""
    learner = _np((jts.params, jts.opt_state, jts.obs_stats, jts.value_stats, jts.lr))
    params, opt, obs_stats, value_stats, lr = learner_from_leaves(learner, tppo.param_names(cfg))
    extra = _np((jts.teacher_obs_stats, jts.last_teacher_obs, jts.hidden))
    return tppo.TrainState(params, opt, obs_stats, value_stats, lr, 0, _t(jts.last_obs),
                           torch.tensor(int(jts.epoch), dtype=torch.int32),
                           **(extra_from_leaves(extra, cfg) if extra else {}))


def _jax_draws(jts, jp, recurrent: bool):
    """The policy noise [T, B, A] and permutations [mini_epochs, rows] that
    the JAX train_iter draws from ts.key (one data shard)."""
    if recurrent:
        key, k_roll = jax.random.split(jts.key)
        rows = T // L * B
    else:
        key, k_roll, _ = jax.random.split(jts.key, 3)
        rows = T * B
    noise = np.stack([np.asarray(jax.random.normal(k, (B, NUM_ACTIONS)))
                      for k in jax.random.split(k_roll, T)])
    perms = np.stack([
        np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, rows))(
            jax.random.split(k, 1))[0])
        for k in jax.random.split(jax.random.fold_in(key, 1), jp.cfg.mini_epochs)])
    return noise, perms


def _run_both(cfg: dict, seed: int, epoch: int = 3):
    """One train_iter of each side from the same state and draws: (JAX new
    state, JAX stats, JAX trajectory, port new state, port stats, port
    trajectory, the port's minibatch KLs, the port's start state)."""
    rng = np.random.default_rng(seed)
    tables = _tables(rng)
    jp = jppo.PPO(_JaxTableEnv(*tables), jppo.PPOConfig(**cfg))
    jts = _jax_state(jp, rng, epoch, jax.random.PRNGKey(seed))
    captured = {}
    name = "_update_from_traj_rnn" if jp.recurrent else "_update_from_traj"
    update = getattr(jp, name)

    def capture(ts_, traj, *args, **kw):
        captured["traj"] = traj
        return update(ts_, traj, *args, **kw)

    setattr(jp, name, capture)
    j_new, j_stats = jp.train_iter(jts)
    noise, perms = _jax_draws(jts, jp, jp.recurrent)

    tcfg = tppo.PPOConfig(**cfg)
    tp = tppo.PPO(_TorchTableEnv(*tables), tcfg, device="cpu")
    tts = _port_state(jts, tcfg)
    kls = record_kls(tp)
    rollout = tp.rollout
    seen = {}

    def keep(*a, **k):
        seen["r"] = rollout(*a, **k)
        return seen["r"]

    tp.rollout = keep
    t_new, t_stats = tp.train_iter(tts, noise=_t(noise), perms=_t(perms).long())
    return j_new, j_stats, captured["traj"], t_new, t_stats, seen["r"].traj, kls, tts, tcfg


def _assert_state_matches(j_new, t_new, tcfg, kls, moments_rel=1e-4, param_atol=1e-6):
    got = learner_to_leaves(t_new, tcfg)
    want = _np((j_new.params, j_new.opt_state, j_new.obs_stats, j_new.value_stats, j_new.lr))
    P = len(tppo.param_names(tcfg))
    assert len(got) == len(want) == 3 * P + 11
    for i, w in enumerate(want):
        assert got[i].dtype == w.dtype and got[i].shape == w.shape, i
        if i < P:  # params
            np.testing.assert_allclose(got[i], w, atol=param_atol, err_msg=f"param leaf {i}")
        elif i < P + 4:  # optax counters
            np.testing.assert_array_equal(got[i], w, err_msg=f"leaf {i}")
        elif i < 3 * P + 4:  # Adam moments
            tol = max(1e-7, moments_rel * float(np.abs(w).max()))
            np.testing.assert_allclose(got[i], w, atol=tol, err_msg=f"moment leaf {i}")
        elif i < 3 * P + 10:  # running stats
            np.testing.assert_allclose(got[i], w, rtol=1e-5, err_msg=f"stats leaf {i}")
    assert_same_lr(float(got[-1]), float(want[-1]), kls)
    got_x = extra_to_leaves(t_new)
    want_x = _np((j_new.teacher_obs_stats, j_new.last_teacher_obs, j_new.hidden))
    assert len(got_x) == len(want_x) == (4 if tcfg.asymmetric_critic else 0) + (
        (2 + 2 * tcfg.asymmetric_critic) if tcfg.rnn_units else 0)
    for i, (g, w) in enumerate(zip(got_x, want_x)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-6, err_msg=f"extra leaf {i}")
    assert int(t_new.epoch) == int(j_new.epoch)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_train_iter_matches(layout):
    """One train_iter (horizon 8, B = 8, 8 Adam steps over minibatches of 16
    samples: 4 sequences of 4 on the recurrent path) from the same
    flax-init learner, random Adam moments and stats, a nonzero carry and
    the JAX package's draws, on a table env whose done flags fall inside
    sequences and at their ends. The trajectory: mu, logp, values and
    rewards within 1e-5 (float32 nets of 16-32 units in two libraries;
    values denormalized by a sigma near 5), each stored pre-step carry and
    the teacher observations as JAX's (within 2e-6; the table's exactly).
    Then the whole new TrainState: params within 1e-6 (the 8 steps move
    them by up to 2e-3), Adam moments within 1e-4 of each one's largest
    value, the optax counters and epoch exact, every running stat (obs,
    value, teacher) within 1e-5 relative, the lr equal unless a KL lay at a
    branch threshold, the last teacher observations and the last carry
    (zeroed where done, with zero_rnn_on_done) within 2e-6; the stats dict
    within 1e-4 relative."""
    cfg = _cfg(**LAYOUTS[layout])
    j_new, j_stats, j_traj, t_new, t_stats, t_traj, kls, tts, tcfg = _run_both(cfg, 11)
    assert len(kls) == 8
    for k, tol in (("mu", 1e-5), ("logp", 1e-5), ("value", 1e-5), ("reward", 1e-5),
                   ("sigma", 1e-7)):
        np.testing.assert_allclose(getattr(t_traj, k).numpy(), np.asarray(getattr(j_traj, k)),
                                   atol=tol, err_msg=k)
    if tcfg.asymmetric_critic:
        np.testing.assert_array_equal(t_traj.teacher_obs.numpy(), np.asarray(j_traj.teacher_obs))
    else:
        assert t_traj.teacher_obs is None
    if tcfg.rnn_units:
        for g, w in zip(jax.tree.leaves(tppo.carry_map(lambda x: x.numpy(), t_traj.hidden)),
                        _np(j_traj.hidden)):
            np.testing.assert_allclose(g, w, atol=2e-6)
    _assert_state_matches(j_new, t_new, tcfg, kls)
    assert not bool(t_stats["kl_guard_triggered"])
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    if tcfg.rnn_units:
        done = t_traj.done[-1]
        h_last = t_new.hidden["actor"] if tcfg.asymmetric_critic else t_new.hidden
        zeroed = (h_last[0][done] == 0).all() and (h_last[1][done] == 0).all()
        assert bool(zeroed) == tcfg.zero_rnn_on_done or not bool(done.any())


def test_first_iteration_full_width_matches(monkeypatch):
    """ShadowHandOpenAI_LSTM's widths (LSTM 1024 actor and critic, MLP
    [512]) from the JAX package's own init: fresh Adam state and stats, a
    zero carry, epoch 0. One train_iter (8 Adam steps, the table env) on
    each side: Adam's first step moves every one of the 10M parameters by
    lr * g / (|g| + 1e-8), so the policy jumps: the iteration's mean KL
    passes 1 on both sides and the adaptive lr falls, alike (stats dict
    within 1e-4 relative, the lr as assert_same_lr). Params within 1e-4
    (a gradient near the 1e-8 of Adam's epsilon turns a float32 rounding
    difference into a step difference of up to lr: measured 1.5e-5 on 7 of
    524,288 entries of one kernel), Adam moments within 1e-4 of each one's
    largest value (measured 1.8e-5), the rest as test_train_iter_matches."""
    fresh = _jax_state

    def init_state(jp, rng, epoch, key):
        ts, new = fresh(jp, rng, epoch, key), jp.init(jax.random.PRNGKey(0))
        return ts._replace(opt_state=new.opt_state, obs_stats=new.obs_stats,
                           value_stats=new.value_stats, hidden=new.hidden,
                           teacher_obs_stats=new.teacher_obs_stats)

    monkeypatch.setattr(sys.modules[__name__], "_jax_state", init_state)
    cfg = _cfg(asymmetric_critic=True, rnn_units=1024)
    cfg["hidden"] = (512,)
    j_new, j_stats, _, t_new, t_stats, _, kls, _, tcfg = _run_both(cfg, 11, epoch=0)
    assert float(j_stats["kl"]) > 1 and float(t_stats["kl"]) > 1
    _assert_state_matches(j_new, t_new, tcfg, kls, param_atol=1e-4)
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_kl_guard_reverts_teacher_stats():
    """The recurrent asymmetric learner at epoch 9 with kl_guard 1e-6: the
    iteration's KL trips the guard on both sides; the port gives back its
    old params, Adam state, obs, value and teacher-observation stats bit
    for bit and half the lr, while the env state, last observations, last
    teacher observations and carry move on (as JAX's, within 2e-6)."""
    cfg = _cfg(**LAYOUTS["recurrent asymmetric"], kl_guard=1e-6)
    j_new, j_stats, _, t_new, t_stats, _, kls, tts, tcfg = _run_both(cfg, 12, epoch=9)
    assert bool(j_stats["kl_guard_triggered"]) and bool(t_stats["kl_guard_triggered"])
    old, new = learner_to_leaves(tts, tcfg), learner_to_leaves(t_new, tcfg)
    for i, (a, b) in enumerate(zip(old[:-1], new[:-1])):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i} not reverted")
    for a, b in zip(tts.teacher_obs_stats, t_new.teacher_obs_stats):
        assert torch.equal(a, b)
    assert float(new[-1]) == np.float32(float(old[-1]) / 2.0)
    _assert_state_matches(j_new, t_new, tcfg, kls)
    assert t_new.env_state == T and not torch.equal(t_new.last_teacher_obs, tts.last_teacher_obs)


# --- act ----------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["mlp asymmetric", "recurrent", "recurrent asymmetric"])
def test_act_matches(layout):
    """PPO.act over 3 steps, the carry threaded from step to step (from
    None: zeros), deterministic and with the JAX package's noise (drawn
    from its key): actions and carries within 2e-6 of JAX act; with an
    asymmetric critic only the actor's carry changes."""
    cfg = _cfg(**LAYOUTS[layout])
    rng = np.random.default_rng(13)
    obs, *_ = _tables(rng)
    jp = jppo.PPO(_JaxTableEnv(*_tables(rng)), jppo.PPOConfig(**cfg))
    jts = _jax_state(jp, rng, 3, jax.random.PRNGKey(0))
    tcfg = tppo.PPOConfig(**cfg)
    tp = tppo.PPO(_TorchTableEnv(*_tables(rng)), tcfg, device="cpu")
    tts = _port_state(jts, tcfg)
    jh = th = None
    for s in range(3):
        for det in (True, False):
            key = jax.random.PRNGKey(100 + s)
            eps = jax.random.normal(key, (B, NUM_ACTIONS))
            j = jp.act(jts, jnp.asarray(obs[s]), det, key, jh)
            t = tp.act(tts, _t(obs[s]), det, th, noise=_t(eps))
            ja, ta = (j[0], t[0]) if jp.recurrent else (j, t)
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-6)
        if jp.recurrent:
            if tcfg.asymmetric_critic and th is not None:
                assert t[1]["critic"] is th["critic"]
            jh, th = j[1], t[1]
            for g, w in zip(jax.tree.leaves(tppo.carry_map(lambda x: x.numpy(), th)), _np(jh)):
                np.testing.assert_allclose(g, w, atol=2e-6)


# --- checkpoints ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_env():
    """ckpt_5200's env state: as the JAX package loads it, and the port."""
    return load_checkpoint(CKPT).env_state, tck.load_train_state(CKPT).env_state


@pytest.mark.parametrize("layout", ["mlp asymmetric", "recurrent", "recurrent asymmetric"])
def test_checkpoints_both_ways(layout, tmp_path, ckpt_env):
    """A checkpoint of the layout (with ckpt_5200's env state): the port
    writes it and `handarm_tpu.utils.checkpoint.load_checkpoint(path,
    example_tree=PPO(env, cfg).init(...))` reads it, every learner leaf,
    teacher stat, last teacher observation and carry leaf equal to the
    port's; the JAX package saves one and the port's `load_train_state`
    reads it with the PPOConfig, every leaf but the PRNG keys equal to the
    JAX file's when written back. Read without the config, the port's
    file is refused (not an MLP ActorCritic's), and the eval's policy
    reader refuses both files: not an MLP ActorCritic checkpoint."""
    cfg = _cfg(**LAYOUTS[layout])
    jenv_state, tenv_state = ckpt_env
    rng = np.random.default_rng(14)
    jp = jppo.PPO(_JaxTableEnv(*_tables(rng)), jppo.PPOConfig(**cfg))
    jts = _jax_state(jp, rng, 3, jax.random.PRNGKey(1))
    tcfg = tppo.PPOConfig(**cfg)
    tts = _port_state(jts, tcfg)._replace(env_state=tenv_state)
    tts = tts._replace(params={k: p * 1.5 for k, p in tts.params.items()}, epoch=tts.epoch + 1)
    path = tck.save_checkpoint(str(tmp_path / "port"), tts, 4, seed=3, sync=True, cfg=tcfg)
    example = jp.init(jax.random.PRNGKey(0))._replace(env_state=jenv_state)
    loaded = load_checkpoint(path, example_tree=example)
    want = learner_to_leaves(tts, tcfg) + extra_to_leaves(tts)
    got = _np((loaded.params, loaded.opt_state, loaded.obs_stats, loaded.value_stats,
               loaded.lr)) + _np((loaded.teacher_obs_stats, loaded.last_teacher_obs,
                                 loaded.hidden))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
    assert int(loaded.epoch) == 4 and loaded.env_state.physics.robot.q.shape == (8192, 17)
    with pytest.raises(NotImplementedError, match="not an MLP ActorCritic"):
        tck.load_train_state(path)
    with pytest.raises(NotImplementedError, match="eval_policy"):
        tck.read_policy(path)

    jpath = save_checkpoint(str(tmp_path / "jax"), jts._replace(env_state=jenv_state), 3,
                            sync=True)
    back = tck.load_train_state(jpath, cfg=tcfg)
    assert torch.equal(back.env_state.physics.robot.q, tenv_state.physics.robot.q)
    rewritten = tck.read_leaves(tck.save_checkpoint(str(tmp_path / "again"), back, 3, seed=0,
                                                    sync=True, cfg=tcfg))
    original = tck.read_leaves(jpath)
    assert len(rewritten) == len(original)
    keys = {i for i, x in enumerate(original) if x.dtype == np.uint32}
    assert len(keys) == 2
    for i, (g, w) in enumerate(zip(rewritten, original)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if i not in keys:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
    with pytest.raises(NotImplementedError, match="eval_policy"):
        tck.read_policy(jpath)
