"""The recurrent asymmetric learner on Ur5SihLift, composed as the user
composes it: ShadowHandOpenAI_LSTM's learner (an LSTM actor on the
student's four non-cloud observables, an LSTM central-value critic on the
Lift's eleven default observables) at a small size. The composed config
against the JAX package's, field by field; one whole train_iter against
the JAX package on the stand-in robot; the train entry point on the CPU
with a resume; and the eval's refusal of such a checkpoint.

The JAX package reads its asset root when `handarm_tpu.robots.ur5sih` is
imported, so its train_iter runs in a subprocess with HANDARM_ASSET_ROOT
set to the stand-in (this file run as a script): it composes the task at
B = 8, resets, sets every episode clock to 0 (no env times out in the
compared rollout, so no reset draws), runs one train_iter from its own
flax init with a nonzero carry, and writes the pre-iteration state, the
noise and sequence permutations it drew (re-derived from the iteration's
key), the trajectory and the new TrainState to an npz.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from handarm_tpu_torch.envs.tasks import LSTM_LIFT
from shared_jax_cache import shared_jax_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
B = 8
# ShadowHandOpenAI_LSTM's learner on Ur5SihLift (envs/tasks.py LSTM_LIFT:
# the student's four observables for the actor, the Lift's eleven defaults
# for the critic) cut to LSTM 16, hidden (32,); horizon 8, minibatches of
# 16 samples (4 sequences of 4), 2 mini-epochs: 8 Adam steps
OBSERVABLES = [o for o in LSTM_LIFT if "observations=" in o]
OVERRIDES = [
    f"num_envs={B}", *OBSERVABLES,
    "ppo.asymmetric_critic=true", "ppo.rnn_units=16", "ppo.critic_rnn_units=16",
    "ppo.hidden=[32]", "ppo.seq_len=4", "ppo.minibatch_size=16", "ppo.gamma=0.998",
    "ppo.horizon=8", "ppo.mini_epochs=2",
]
# the learner at its full widths, on 8192 envs, as chip_smoke.py trains it
FULL_WIDTH = ["num_envs=8192", *LSTM_LIFT]
TRAJ_FIELDS = ("obs", "action", "logp", "value", "reward", "done", "mu", "sigma",
               "teacher_obs")


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.registry import compose_task
    from handarm_tpu.learn.ppo import PPO, PPOConfig
    from handarm_tpu.robots.ur5sih import ASSET_ROOT

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    env, over = compose_task("Ur5SihLift", OVERRIDES)
    ppo = PPO(env, PPOConfig(**over))
    ts = ppo.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    hidden = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0.0, 0.3, x.shape).astype(np.float32)), ts.hidden)
    state = ts.env_state._replace(task=ts.env_state.task._replace(
        progress=jnp.zeros_like(ts.env_state.task.progress)))
    ts = ts._replace(env_state=state, hidden=hidden, key=jax.random.PRNGKey(11))

    key, k_roll = jax.random.split(ts.key)
    horizon, L = ppo.cfg.horizon, ppo.cfg.seq_len
    noise = np.stack([np.asarray(jax.random.normal(k, (B, env.num_actions)))
                      for k in jax.random.split(k_roll, horizon)])
    n_seq = horizon // L * B
    perms = np.stack([
        np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, n_seq))(
            jax.random.split(k, 1))[0])
        for k in jax.random.split(jax.random.fold_in(key, 1), ppo.cfg.mini_epochs)])

    captured = {}
    update = ppo._update_from_traj_rnn

    def capture(ts_, traj, *args, **kw):
        captured["traj"] = traj
        return update(ts_, traj, *args, **kw)

    ppo._update_from_traj_rnn = capture
    new_ts, stats = ppo.train_iter(ts)
    out = dict(noise=noise, perms=perms, last_obs=np.asarray(ts.last_obs),
               sizes=np.asarray([env.num_obs, env.num_teacher_obs, env.num_actions]))
    for name in TRAJ_FIELDS:
        out[f"traj_{name}"] = np.asarray(getattr(captured["traj"], name))
    tree = lambda t: (t.params, t.opt_state, t.obs_stats, t.value_stats, t.lr)
    extra = lambda t: (t.teacher_obs_stats, t.last_teacher_obs, t.hidden)
    for tag, t in (("pre", ts), ("new", new_ts)):
        for i, leaf in enumerate(jax.tree.leaves(tree(t))):
            out[f"{tag}learner_{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(extra(t))):
            out[f"{tag}extra_{i}"] = np.asarray(leaf)
    for i, leaf in enumerate(jax.tree.leaves(state)):
        out[f"env_{i}"] = np.asarray(leaf)
    for k, v in stats.items():
        out[f"stat_{k}"] = np.asarray(v)
    out["epoch"] = np.asarray(new_ts.epoch)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("asym") / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1", PYTHONPATH=REPO,
               **shared_jax_env(out.parent))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_")])
    return [ref[f"{tag}_{i}"] for i in range(n)]


def test_composed_config_matches(monkeypatch):
    """The overrides compose to the same HandArmConfig as the JAX
    package's `compose_task` (every field, value and type) and the same
    PPO overrides; the PPOConfig built from them has the JAX one's fields
    and equals it field by field (`data_shards` too). The critic sees 121
    observations, the actor 33."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import handarm_tpu.envs.registry as jreg
    from handarm_tpu.learn.ppo import PPOConfig as JaxPPOConfig
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import ppo_config

    monkeypatch.setattr(jreg, "HandArmEnv", lambda cfg: cfg)
    for over in (OVERRIDES, FULL_WIDTH):
        jcfg, jover = jreg.compose_task("Ur5SihLift", over)
        tcfg, tover = resolve_task("Ur5SihLift", over)
        want, got = ({f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
                     for c in (jcfg, tcfg))
        for d in (want, got):  # the randomization records: the port's own classes
            d.update(dr=dataclasses.asdict(d["dr"]), adr=dataclasses.asdict(d["adr"]))
        for k in want:
            assert type(got[k]) is type(want[k]) and got[k] == want[k], k
        assert tover == jover
        jppo, tppo = JaxPPOConfig(**jover), ppo_config(tover)
        assert set(jppo._fields) == set(tppo._fields)
        for k in tppo._fields:  # the JAX config keeps `hidden` as the list given
            want_k = getattr(jppo, k)
            assert getattr(tppo, k) == (tuple(want_k) if k == "hidden" else want_k), k
        assert tppo.asymmetric_critic and tppo.seq_len == 4 and tppo.gamma == 0.998
        assert len(tcfg.observations) == 4 and len(tcfg.teacher_observations) == 11
    assert (tppo.rnn_units, tppo.critic_rnn_units, tppo.hidden, tppo.minibatch_size,
            tppo.horizon, tppo.mini_epochs, tcfg.num_envs) == (1024, 1024, (512,), 32768, 16, 4,
                                                               8192)


@pytest.fixture(scope="module")
def port(ref):
    """The port's train_iter from the JAX package's state, noise and
    permutations: (ppo, start TrainState, trajectory, new TrainState,
    stats, KLs)."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import (env_state_from_leaves, extra_from_leaves,
                                           learner_from_leaves)
    from handarm_tpu_torch.envs.hand_arm import HandArmEnv
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, TrainState, param_names, ppo_config
    from test_torch_train import record_kls

    env_cfg, over = resolve_task("Ur5SihLift", OVERRIDES)
    env = HandArmEnv(env_cfg, "cpu")
    cfg = ppo_config(over)
    ppo = PPO(env, cfg)
    assert [env.num_obs, env.num_teacher_obs, env.num_actions] == ref["sizes"].tolist() == \
        [33, 121, 11]
    params, opt, obs_stats, value_stats, lr = learner_from_leaves(
        _leaves(ref, "prelearner"), param_names(cfg))
    ts = TrainState(params, opt, obs_stats, value_stats, lr,
                    env_state_from_leaves(_leaves(ref, "env")),
                    torch.as_tensor(ref["last_obs"]), torch.tensor(0, dtype=torch.int32),
                    **extra_from_leaves(_leaves(ref, "preextra"), cfg))
    seen, rollout = {}, ppo.rollout
    ppo.rollout = lambda *a, **k: seen.setdefault("r", rollout(*a, **k))
    kls = record_kls(ppo)
    new_ts, stats = ppo.train_iter(ts, noise=torch.as_tensor(ref["noise"]),
                                   perms=torch.as_tensor(ref["perms"]).long())
    return ppo, ts, seen["r"].traj, new_ts, stats, kls


def test_lift_trajectory_matches(ref, port):
    """The 8-step trajectory of the LSTM policy through the Lift physics.
    Step 0's observations are the same; its mu, logp and values differ only
    by float32 nets in two libraries (1e-4; values, denormalized, 1e-3).
    Later steps start from observations that went through the physics, held
    to the env-step bound of tests/test_torch_lift.py (2e-3), the policy's
    outputs there to 1e-3, as tests/test_torch_train.py holds the MLP's;
    rewards within 1e-6 of JAX's, done flags exact (none: clocks at 0)."""
    traj = port[2]
    got = {k: getattr(traj, k).numpy() for k in TRAJ_FIELDS}
    want = {k: ref[f"traj_{k}"] for k in TRAJ_FIELDS}
    np.testing.assert_array_equal(got["done"], want["done"])
    for k in ("obs", "teacher_obs"):
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_allclose(got[k], want[k], atol=2e-3, err_msg=k)
    for k in ("mu", "action", "logp", "value"):
        np.testing.assert_allclose(got[k][0], want[k][0], atol=1e-3 if k == "value" else 1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["reward"], want["reward"], atol=1e-6)


def test_lift_update_matches(ref, port):
    """The whole new TrainState after the 8 Adam steps: params within 1e-6
    (the steps move them by up to 2e-3), Adam moments within 1e-4 of each
    one's largest value, counters and epoch exact, obs and value stats
    within 1e-5 relative, the teacher stats within 1e-5 relative plus 1e-6
    (means of observations that went through the physics: measured 3.1e-8
    apart at an entry of 2e-4), the lr equal unless a KL lay at a branch
    threshold, the last teacher observations within 2e-3 (the env-step
    bound) and the last carry within 1e-4 (8 LSTM steps on observations
    within 2e-3); the stats dict within 1e-4 relative."""
    from handarm_tpu_torch.convert import extra_to_leaves, learner_to_leaves
    from test_torch_train import assert_same_lr

    ppo, start, _, new_ts, stats, kls = port
    got, old = learner_to_leaves(new_ts, ppo.cfg), learner_to_leaves(start, ppo.cfg)
    want = _leaves(ref, "newlearner")
    P = (len(want) - 11) // 3
    assert len(got) == len(want) and len(kls) == 8
    for i, w in enumerate(want):
        assert got[i].dtype == w.dtype and got[i].shape == w.shape, i
        if i < P:
            np.testing.assert_allclose(got[i], w, atol=1e-6, err_msg=f"param leaf {i}")
        elif i < P + 4:
            np.testing.assert_array_equal(got[i], w, err_msg=f"leaf {i}")
        elif i < 3 * P + 4:
            np.testing.assert_allclose(got[i], w, atol=1e-4 * float(np.abs(w).max()) + 1e-12,
                                       err_msg=f"moment leaf {i}")
        elif i < 3 * P + 10:
            np.testing.assert_allclose(got[i], w, rtol=1e-5, err_msg=f"stats leaf {i}")
    assert_same_lr(float(got[-1]), float(want[-1]), kls)
    assert max(float(np.abs(got[i] - old[i]).max()) for i in range(P)) > 1e-5
    got_x, want_x = extra_to_leaves(new_ts), _leaves(ref, "newextra")
    assert len(got_x) == len(want_x) == 8
    for i in range(3):  # teacher stats
        np.testing.assert_allclose(got_x[i], want_x[i], rtol=1e-5, atol=1e-6,
                                   err_msg=f"extra {i}")
    np.testing.assert_allclose(got_x[3], want_x[3], atol=2e-3)
    for i in range(4, 8):  # the carry
        np.testing.assert_allclose(got_x[i], want_x[i], atol=1e-4, err_msg=f"carry {i}")
    assert int(new_ts.epoch) == int(ref["epoch"]) == 1
    for k in ("kl", "policy_loss", "value_loss", "reward_mean"):
        np.testing.assert_allclose(float(stats[k]), ref[f"stat_{k}"], rtol=1e-4, err_msg=k)


def test_train_entry_point_recurrent_asymmetric(tmp_path, monkeypatch):
    """`python -m handarm_tpu_torch.train task=Ur5SihLift` with the
    recurrent asymmetric overrides (LSTM 16, hidden (32,), 8 envs, horizon
    8) on the CPU for 1 iteration, then resume=auto for a second: the
    checkpoint holds the teacher stats, the last teacher observations and
    the carry (8 leaves after the epoch); the resumed run starts from them
    (the TrainState it is given equals the file's) and writes ckpt_2
    (epoch 2, 16 Adam steps); config.json holds the composed PPOConfig.
    The eval entry point refuses the checkpoint."""
    torch.set_num_threads(1)
    from handarm_tpu_torch import train
    from handarm_tpu_torch.eval_policy import evaluate
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.utils.checkpoint import load_train_state, read_leaves

    monkeypatch.chdir(tmp_path)
    args = ["task=Ur5SihLift", "device=cpu", "seed=2", "experiment=rnn"] + [
        o for o in OVERRIDES if "minibatch" not in o]
    train.main(args + ["max_iterations=1"])
    run = tmp_path / "runs" / "rnn"
    saved = json.loads((run / "config.json").read_text())["ppo"]
    cfg = ppo_config({k: saved[k] for k in ("asymmetric_critic", "rnn_units",
                                            "critic_rnn_units", "hidden", "seq_len",
                                            "horizon", "mini_epochs", "minibatch_size")})
    assert (cfg.rnn_units, cfg.hidden, cfg.asymmetric_critic) == (16, (32,), True)
    ck1 = str(run / "nn" / "ckpt_1.npz")
    ts1 = load_train_state(ck1, cfg=cfg)
    assert len(read_leaves(ck1)) == 3 * len(ts1.params) + 11 + 27 + 8
    assert int(ts1.epoch) == 1 and int(ts1.opt_state.count) == 2
    assert ts1.last_teacher_obs.shape == (B, 121) and ts1.hidden["critic"][0].shape == (B, 16)
    assert float(ts1.teacher_obs_stats.count) > 1

    seen, train_iter = [], PPO.train_iter
    monkeypatch.setattr(PPO, "train_iter", lambda self, t, *a, **k: (
        seen.append(t), train_iter(self, t, *a, **k))[1])
    train.main(args + ["max_iterations=2", "resume=auto"])
    (resumed,) = seen
    for a, b in zip(*(tuple(x.hidden[k][j] for k in ("actor", "critic") for j in (0, 1))
                      for x in (resumed, ts1))):
        assert torch.equal(a, b)
    assert torch.equal(resumed.last_teacher_obs, ts1.last_teacher_obs)
    assert torch.equal(resumed.teacher_obs_stats.mean, ts1.teacher_obs_stats.mean)
    ts2 = load_train_state(str(run / "nn" / "ckpt_2.npz"), cfg=cfg)
    assert int(ts2.epoch) == 2 and int(ts2.opt_state.count) == 4
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    with pytest.raises(NotImplementedError, match="scripts/eval_policy.py cannot evaluate"):
        evaluate(ckpt=ck1, envs=B, steps=1, device="cpu")


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
