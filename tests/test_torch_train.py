"""The port's training slice: one whole `train_iter` of Ur5SihLift against
the JAX package on the stand-in robot, and the `train`, `eval_policy` and
`update_precision` entry points on the CPU.

The JAX package reads its asset root when `handarm_tpu.robots.ur5sih` is
imported, so its side runs in a subprocess with HANDARM_ASSET_ROOT set to
the stand-in (this file run as a script). It builds Ur5SihLift at B = 8,
resets, sets every episode clock to 0 (no env times out in the compared
rollout, so no reset draws), loads ckpt_5200's params, optimizer state,
running stats, lr and epoch into its TrainState and runs one train_iter
(horizon 4, minibatch 16, 2 mini-epochs: 4 Adam steps), capturing the
trajectory. It writes the pre-rollout state, its rollout noise and minibatch
permutations (recomputed from the iteration's key as train_iter draws
them), the trajectory and the updated learner to an npz. The port then
runs its own train_iter from the same state with that noise and those
permutations. The subprocess also takes one Ur5SihReach env step from a
reset state, for the reach smoke's preset.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shared_jax_cache import shared_jax_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
CKPT = os.path.join(REPO, "docs", "evidence", "lift_r3a", "ckpt_5200.npz")
B, HORIZON, MINIBATCH, EPOCHS = 8, 4, 16, 2
TRAJ_FIELDS = ("obs", "action", "logp", "value", "reward", "done", "mu", "sigma")


def _ppo_config(cls):
    return cls(horizon=HORIZON, minibatch_size=MINIBATCH, mini_epochs=EPOCHS)


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.learn.ppo import PPO, PPOConfig
    from handarm_tpu.robots.ur5sih import ASSET_ROOT
    from handarm_tpu.utils.checkpoint import load_checkpoint

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    env, _ = make_env("Ur5SihLift", [f"num_envs={B}"])
    ppo = PPO(env, _ppo_config(PPOConfig))
    ts = ppo.init(jax.random.PRNGKey(3))
    ck = load_checkpoint(CKPT, example_tree=ts)
    state = ts.env_state._replace(task=ts.env_state.task._replace(
        progress=jnp.zeros_like(ts.env_state.task.progress)))
    ts = ck._replace(env_state=state, last_obs=ts.last_obs, key=jax.random.PRNGKey(11))

    # the draws train_iter makes from ts.key
    key, k_roll, _ = jax.random.split(ts.key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, env.num_actions)))
                      for k in jax.random.split(k_roll, HORIZON)])
    n = B * HORIZON
    perms = np.stack([
        np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, n))(
            jax.random.split(k, 1))[0])
        for k in jax.random.split(jax.random.fold_in(key, 1), EPOCHS)])

    captured = {}
    update = ppo._update_from_traj

    def capture(ts_, traj, *args, **kw):
        captured["traj"] = traj
        return update(ts_, traj, *args, **kw)

    ppo._update_from_traj = capture
    new_ts, stats = ppo.train_iter(ts)
    out = dict(noise=noise, perms=perms, last_obs=np.asarray(ts.last_obs),
               )
    for name in TRAJ_FIELDS:
        out[f"traj_{name}"] = np.asarray(getattr(captured["traj"], name))
    for i, leaf in enumerate(jax.tree.leaves(state)):
        out[f"pre_{i}"] = np.asarray(leaf)
    learner = (new_ts.params, new_ts.opt_state, new_ts.obs_stats, new_ts.value_stats,
               new_ts.lr, new_ts.epoch)
    for i, leaf in enumerate(jax.tree.leaves(learner)):
        out[f"learner_{i}"] = np.asarray(leaf)
    for k, v in stats.items():
        out[f"stat_{k}"] = np.asarray(v)

    # the reach smoke's env: one step from a reset state, clocks at 0
    reach, _ = make_env("Ur5SihReach", [f"num_envs={B}"])
    state, obs = jax.jit(reach.reset)(jax.random.PRNGKey(4))
    state = state._replace(task=state.task._replace(
        progress=jnp.zeros_like(state.task.progress)))
    actions = np.random.default_rng(1).uniform(-1, 1, (B, reach.num_actions))
    _, res = jax.jit(reach.step)(state, jnp.asarray(actions, jnp.float32))
    out.update(reach_actions=actions, reach_obs_pre=np.asarray(reach.observe(state)[0]),
               reach_obs=np.asarray(res.obs), reach_reward=np.asarray(res.reward),
               reach_sizes=np.asarray([reach.num_obs, reach.num_actions,
                                       reach.scene.slots.num_slots]))
    for i, leaf in enumerate(jax.tree.leaves(state)):
        out[f"reachpre_{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("train") / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1",
               **shared_jax_env(out.parent))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_")])
    return [ref[f"{tag}_{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def port(ref):
    """The port's train_iter from the same state, noise and permutations;
    (trajectory, new TrainState, stats)."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.tasks import make_env
    from handarm_tpu_torch.learn.ppo import PPO, PPOConfig
    from handarm_tpu_torch.utils.checkpoint import load_train_state

    env = make_env("Ur5SihLift", device="cpu", num_envs=B)
    ppo = PPO(env, _ppo_config(PPOConfig))
    ts = load_train_state(CKPT, "cpu", env_state_from_leaves(_leaves(ref, "pre")),
                          torch.as_tensor(ref["last_obs"]))
    captured = {}
    update = ppo._update_from_traj

    def capture(ts_, traj, *args, **kw):
        captured["traj"] = traj
        return update(ts_, traj, *args, **kw)

    ppo._update_from_traj = capture
    kls = record_kls(ppo)
    new_ts, stats = ppo.train_iter(ts, noise=torch.as_tensor(ref["noise"]),
                                   perms=torch.as_tensor(ref["perms"]).long())
    return captured["traj"], new_ts, stats, kls


def record_kls(ppo) -> list:
    """The KL of each minibatch step of `ppo`, appended as it runs."""
    kls, loss = [], ppo._loss

    def recording(*args):
        total, aux = loss(*args)
        kls.append(float(aux["kl"]))
        return total, aux

    ppo._loss = recording
    return kls


def assert_same_lr(got: float, want: float, kls: list, kl_threshold: float = 0.016):
    """The adaptive lr's branches (x1.5 below 0.5 kl_threshold, /1.5 above 2
    kl_threshold) are discontinuous: the port's lr must equal the JAX
    package's, to the float32 rounding of its chain of steps (1e-6
    relative: XLA divides by 1.5 as a multiply by its reciprocal, one ulp
    per step at most), unless some KL lay within 1e-6 relative of a
    threshold."""
    if got == pytest.approx(want, rel=1e-6):
        return
    margins = [min(abs(k - t) / t for t in (0.5 * kl_threshold, 2 * kl_threshold)) for k in kls]
    print(f"lr {got} vs {want}; minibatch KLs {kls}; relative margins {margins}")
    assert min(margins) < 1e-6, f"lr {got} != {want} with no KL at a threshold: {kls}"


def test_trajectory_matches(ref, port):
    """The 4-step trajectory. Step 0 starts from the same observations, so
    its mu, action, logp and value differ only by float32 matmuls in two
    libraries (1e-4, as tests/test_torch_policy.py; the value, denormalized
    by the value stats' sigma of 7.6, gets 1e-3). Later steps start from
    observations that went through the physics, held to the env-step bound
    of tests/test_torch_lift.py (2e-3); the policy's outputs there get 1e-3
    (measured: observations within 1e-6, actions 5e-6, values 3e-5).
    Rewards (scaled by 0.01) within 1e-6; done flags exact."""
    traj = port[0]
    got = {k: getattr(traj, k).numpy() for k in TRAJ_FIELDS}
    want = {k: ref[f"traj_{k}"] for k in TRAJ_FIELDS}
    np.testing.assert_array_equal(got["done"], want["done"])
    np.testing.assert_array_equal(got["obs"][0], want["obs"][0])
    np.testing.assert_allclose(got["obs"], want["obs"], atol=2e-3)
    for k in ("mu", "action", "logp", "value"):
        np.testing.assert_allclose(got[k][0], want[k][0], atol=1e-3 if k == "value" else 1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-6)
    np.testing.assert_allclose(got["reward"], want["reward"], atol=1e-6)


def test_update_matches(ref, port):
    """The learner after the update. The 4 Adam steps move the params by up
    to 6e-4; params within 1e-6 of the JAX package's and Adam's moments
    within 1e-6 (measured: 6e-8 and 1.5e-7), from trajectories that agree as
    above. Step count and epoch exact; running stats within 1e-5 relative;
    the stats dict within 1e-4 relative. The learning rate must be equal
    unless a minibatch KL lay within 1e-6 relative of a branch threshold
    (0.5 or 2 x kl_threshold); the port's KLs are printed when it differs."""
    from handarm_tpu_torch.convert import learner_to_leaves

    _, new_ts, stats, kls = port
    got = learner_to_leaves(new_ts) + [new_ts.epoch.numpy()]
    want = _leaves(ref, "learner")
    n_params = 11
    for i in range(n_params):  # params
        np.testing.assert_allclose(got[i], want[i], atol=1e-6, err_msg=f"leaf {i}")
    for i in range(n_params, n_params + 4):  # optax counters
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"leaf {i}")
    for i in range(n_params + 4, 3 * n_params + 4):  # Adam moments
        np.testing.assert_allclose(got[i], want[i], atol=1e-6, err_msg=f"leaf {i}")
    for i in range(37, 43):  # running stats
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, err_msg=f"leaf {i}")
    assert_same_lr(float(got[43]), float(want[43]), kls)
    assert int(got[-1]) == int(want[-1]) == 5201
    for k in ("kl", "policy_loss", "value_loss", "reward_mean"):
        np.testing.assert_allclose(float(stats[k]), ref[f"stat_{k}"], rtol=1e-4, err_msg=k)


def test_reach_env_step_matches(ref):
    """Ur5SihReach, the training smoke's preset (reaching reward only, 5
    observables: 48 observations, arm actions only: 6): its observations of
    the JAX package's reset state (1e-4, float32 FK in another order) and
    one env step from it with actions from a numpy seed (the env-step
    bounds of tests/test_torch_lift.py: 2e-3 on observations and rewards)."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.hand_arm import ObsContext
    from handarm_tpu_torch.envs.tasks import make_env

    env = make_env("Ur5SihReach", device="cpu", num_envs=B)
    assert [env.num_obs, env.num_actions, env.scene.slots.num_slots] == \
        ref["reach_sizes"].tolist() == [48, 6, 80]
    state = env_state_from_leaves(_leaves(ref, "reachpre"))
    obs = env._compute_obs(ObsContext(env, state))
    np.testing.assert_allclose(obs.numpy(), ref["reach_obs_pre"], atol=1e-4, rtol=1e-4)
    _, res = env.step(state, torch.as_tensor(ref["reach_actions"], dtype=torch.float32))
    assert not res.done.any()
    np.testing.assert_allclose(res.obs.numpy(), ref["reach_obs"], atol=2e-3)
    np.testing.assert_allclose(res.reward.numpy(), ref["reach_reward"], atol=2e-3, rtol=1e-4)


def test_train_entry_point_on_cpu(tmp_path, monkeypatch):
    """`python -m handarm_tpu_torch.train task=Ur5SihReach num_envs=8
    max_iterations=3 device=cpu`: metrics.jsonl holds one line per
    iteration; the periodic and final checkpoints are written; resume=auto
    continues from the newest one with its learner (epoch and Adam count)."""
    torch.set_num_threads(1)
    from handarm_tpu_torch import train
    from handarm_tpu_torch.utils.checkpoint import load_train_state

    monkeypatch.chdir(tmp_path)
    args = ["task=Ur5SihReach", "num_envs=8", "device=cpu", "save_every=2", "seed=5"]
    train.main(args + ["max_iterations=3"])
    run = tmp_path / "runs" / "Ur5SihReach"
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2]
    assert all(np.isfinite(x["reward_mean"]) and np.isfinite(x["kl"]) for x in lines)
    assert sorted(os.listdir(run / "nn")) == ["ckpt_2.npz", "ckpt_3.npz"]
    ts2 = load_train_state(str(run / "nn" / "ckpt_2.npz"))
    ts3 = load_train_state(str(run / "nn" / "ckpt_3.npz"))
    # 8 envs x horizon 16 is one minibatch: 4 Adam steps per iteration
    assert int(ts2.epoch) == 2 and int(ts3.epoch) == 3
    assert int(ts2.opt_state.count) == 8 and int(ts3.opt_state.count) == 12
    train.main(args + ["max_iterations=5", "resume=auto"])
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2, 3, 4]
    ts5 = load_train_state(str(run / "nn" / "ckpt_5.npz"))
    assert int(ts5.epoch) == 5 and int(ts5.opt_state.count) == 20


def test_train_rejects_unknown_keys():
    """The arguments compose the task as the root train.py composes it: the
    top keys apart, every other key an override of the composition. An
    unknown HandArmConfig field raises KeyError, as the JAX package's
    make_env; every PPOConfig field composes (data_shards too), an unknown
    one raises KeyError; `pbt.*` keys are top-level; values parse as
    yaml."""
    from handarm_tpu_torch import train

    with pytest.raises(ValueError, match="key=value"):
        train.parse_args(["num_envs"])
    with pytest.raises(KeyError, match="unknown config key"):
        train.compose(["task=Ur5SihReach", "num_env=8"])
    assert train.compose(["task=Ur5SihReach", "ppo.data_shards=2"])[4].data_shards == 2
    assert train.parse_args(["pbt.policy_idx=1", "seed=2"]) == (
        {"pbt.policy_idx": "1", "seed": "2"}, [])
    with pytest.raises(KeyError, match="PPOConfig field"):
        train.compose(["task=Ur5SihReach", "ppo.rnn_unit=8"])
    args = ["task=Ur5SihReach", "num_envs=8", "ppo.hidden=[256,128,64]", "ppo.e_clip=0.2",
            "ppo.mini_epochs=2", "seed=3"]
    top, over = train.parse_args(args)
    assert top == {"task": "Ur5SihReach", "seed": "3"}
    assert over == args[1:5]
    _, _, env_cfg, _, cfg = train.compose(args)
    assert env_cfg.num_envs == 8 and env_cfg.actions == ("ur5_relative_joint_pos",)
    assert (cfg.hidden, cfg.e_clip, cfg.mini_epochs, cfg.minibatch_size) == \
        ((256, 128, 64), 0.2, 2, 256)


def test_train_entry_point_composes_family_task(tmp_path, monkeypatch):
    """`python -m handarm_tpu_torch.train task=Ur5SihReposition
    env.num_envs=8 max_iterations=2 device=cpu`: the task composed from its
    yaml group (the reposition goal, the registry's minibatch 8192, which
    8 x 16 samples cut to one minibatch); config.json holds the task, the
    overrides, the resolved env fields and the PPO overrides; two
    iterations logged and the final checkpoint written. Resumed from that
    checkpoint, the run starts from its whole TrainState, env state and
    last observations included; at 4 envs from its learner only."""
    torch.set_num_threads(1)
    from handarm_tpu_torch import train
    from handarm_tpu_torch.utils.checkpoint import load_train_state

    monkeypatch.chdir(tmp_path)
    train.main(["task=Ur5SihReposition", "env.num_envs=8", "max_iterations=2", "device=cpu"])
    run = tmp_path / "runs" / "Ur5SihReposition"
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["task"] == "Ur5SihReposition" and cfg["cli_overrides"] == {"env.num_envs": "8"}
    assert cfg["env"]["goal"] == "reposition" and cfg["env"]["num_envs"] == 8
    assert cfg["env"]["solver_iterations"] == 8 and cfg["ppo_overrides"] == {"minibatch_size": 8192}
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    assert all(np.isfinite(x["reward_mean"]) for x in lines)
    ts = load_train_state(str(run / "nn" / "ckpt_2.npz"))
    assert int(ts.epoch) == 2 and int(ts.opt_state.count) == 8
    assert ts.last_obs.shape == (8, 121)

    # resuming restores the whole TrainState, env state included, as the
    # root train.py does; at another env count only the learner
    from handarm_tpu_torch.learn.ppo import PPO

    seen, train_iter = [], PPO.train_iter
    monkeypatch.setattr(PPO, "train_iter", lambda self, t, *a, **k: (
        seen.append(t), train_iter(self, t, *a, **k))[1])
    ckpt = str(run / "nn" / "ckpt_2.npz")
    for envs in (8, 4):
        train.main(["task=Ur5SihReposition", f"env.num_envs={envs}", "max_iterations=3",
                    "device=cpu", f"resume={ckpt}", f"experiment=resumed{envs}"])
    same, fresh = seen
    assert torch.equal(same.last_obs, ts.last_obs) and int(same.epoch) == 2
    assert torch.equal(same.env_state.physics.robot.q, ts.env_state.physics.robot.q)
    assert fresh.last_obs.shape == (4, 121) and int(fresh.epoch) == 2
    assert torch.equal(fresh.params["mu.weight"], ts.params["mu.weight"])


MULTI_CKPT = os.path.join(REPO, "docs", "evidence", "multiobj_r5a", "ckpt_2700.npz")


def test_multiobject_update_matches():
    """One `_update_from_traj` with the PPOConfig that
    Ur5SihMultiObjectManipulation composes to (its train yaml: every switch
    on, 4 mini-epochs, the adaptive lr) but its minibatch cut with the env
    count, 64 envs x horizon 16 in 4 minibatches of 256 as 8192 x 16 are 4
    of 32768, from ckpt_2700's learner, against the JAX package's composed
    config. The trajectory is ckpt_2700's policy on its own observations,
    with noise, rewards and done flags from a numpy seed (no genesis). Held
    as tests/test_torch_ppo.py holds the PPOConfig switches: params within
    1e-6, Adam moments within 1e-6 or 1e-4 of each one's largest value (the
    mu head's gradient moment reaches 1.6e-2 here; measured 1.3e-6 apart,
    float32 sums of 256 per-sample terms in another order), counters exact,
    stats 1e-5 relative, the lr equal unless a KL lay at a branch
    threshold, the stats dict 1e-4 relative."""
    torch.set_num_threads(1)
    import jax
    import jax.numpy as jnp

    import handarm_tpu.learn.ppo as jppo
    from handarm_tpu.utils.checkpoint import load_checkpoint
    from handarm_tpu_torch.convert import learner_to_leaves, train_state_from_leaves
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn import ppo as tppo
    from handarm_tpu_torch.utils.checkpoint import read_leaves
    from test_torch_ppo import _jax_traj, _perms, _port_traj, _trajectory

    T, B, key = 16, 64, jax.random.PRNGKey(21)
    over = [f"env.num_envs={B}", "ppo.minibatch_size=256"]
    import handarm_tpu.envs.registry as jreg

    build = jreg.HandArmEnv
    jreg.HandArmEnv = lambda cfg: cfg
    try:
        _, jover = jreg.compose_task("Ur5SihMultiObjectManipulation", over)
    finally:
        jreg.HandArmEnv = build
    env_cfg, tover = resolve_task("Ur5SihMultiObjectManipulation", over)
    assert tover == jover and env_cfg.num_envs == B and env_cfg.solver_iterations == 16
    stub = lambda: type("Stub", (), dict(num_obs=147, num_actions=11, cfg=env_cfg))()
    jax_ts = load_checkpoint(MULTI_CKPT)
    leaves = read_leaves(MULTI_CKPT)
    tr = _trajectory(jax_ts, np.random.default_rng(8), T, B, offset=300)
    jp = jppo.PPO(stub(), jppo.PPOConfig(**jover))
    j_new, j_stats = jax.jit(jp._update_from_traj)(
        jax_ts._replace(env_state=None, last_obs=None, key=key), _jax_traj(tr), None,
        jnp.asarray(tr["last_obs"]), None, key)
    tp = tppo.PPO(stub(), tppo.ppo_config(tover), device="cpu")
    assert tp.num_minibatches == jp.num_minibatches == 4 and tp.mb_size == 256
    tts = train_state_from_leaves(leaves, None, None)
    kls = record_kls(tp)
    t_new, t_stats = tp._update_from_traj(
        tts, _port_traj(tr), None, torch.as_tensor(tr["last_obs"]),
        perms=torch.as_tensor(_perms(key, 4, T * B)).long())
    assert len(kls) == 16
    got = learner_to_leaves(t_new)
    want = jax.tree.leaves((j_new.params, j_new.opt_state, j_new.obs_stats,
                            j_new.value_stats, j_new.lr))
    for i, w in enumerate(want):
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
    assert_same_lr(float(got[43]), float(want[43]), kls)
    assert int(t_new.epoch) == int(j_new.epoch) == int(tts.epoch) + 1
    assert not bool(t_stats["kl_guard_triggered"])
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_jax_loader_reads_port_multiobject_checkpoint(tmp_path):
    """The port reads ckpt_2700 and writes `ckpt_2701.npz` after a change
    of its params, as the train entry point resumed from it writes one;
    `handarm_tpu.utils.checkpoint.load_checkpoint(path,
    example_tree=<ckpt_2700>)` loads it, params and epoch equal to the
    port's, its env state the multi-object one (8192 envs, 372 slots)."""
    import jax

    from handarm_tpu.utils.checkpoint import load_checkpoint
    from handarm_tpu_torch.learn.networks import flax_names
    from handarm_tpu_torch.utils import checkpoint as tck

    ts = tck.load_train_state(MULTI_CKPT)
    ts = ts._replace(params={k: p * 0.5 for k, p in ts.params.items()}, epoch=ts.epoch + 1)
    path = tck.save_checkpoint(str(tmp_path), ts, 2701, sync=True)
    assert os.path.basename(path) == "ckpt_2701.npz"
    loaded = load_checkpoint(path, example_tree=load_checkpoint(MULTI_CKPT))
    for (f, t), w in zip(flax_names(3), jax.tree.leaves(loaded.params)):
        p = ts.params[t].numpy()
        np.testing.assert_array_equal(p.T if f.endswith(".kernel") else p, np.asarray(w))
    assert int(loaded.epoch) == int(ts.epoch)
    assert loaded.env_state.physics.contact_impulse.shape == (8192, 372, 3)
    assert loaded.last_obs.shape == (8192, 147)


def test_eval_policy_on_cpu():
    """ckpt_5200 on Ur5SihLift at 8 envs, episodes of 5 steps: a burn-in of
    one episode, then 10 steps count exactly 2 episodes per env."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.eval_policy import evaluate

    out, state = evaluate(envs=8, steps=10, device="cpu", episode_length=5)
    assert out["episodes"] == 16 and 0 <= out["successes"] <= 16
    assert out["success_rate"] == out["successes"] / 16
    assert out["policy"].endswith("ckpt_5200.npz") and len(out["per_object_ewma"]) == 1
    tree_map(lambda x: None if not x.is_floating_point() else
             np.testing.assert_(bool(torch.isfinite(x).all())), state)


def test_eval_policy_without_burn_in_on_cpu():
    """The same with every env's clock zeroed at the reset and no burn-in:
    a window of one episode (5 steps) counts exactly one whole episode per
    env, and two windows two."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.eval_policy import evaluate

    for steps, episodes in ((5, 8), (10, 16)):
        out, _ = evaluate(envs=8, steps=steps, device="cpu", episode_length=5, burn_in=False)
        assert out["episodes"] == episodes and 0 <= out["successes"] <= episodes


def test_update_precision_on_cpu():
    """`python -m handarm_tpu_torch.update_precision` at 8 envs, minibatch
    32 (4 per mini-epoch), 4 chained steps: float32 lies within
    chip_smoke.py's card-against-CPU tolerances of float64 (prepared
    samples 1e-5 of each tensor's largest value, stats 4 float32 ulps,
    params 1e-6, Adam moments 1e-5); the lr within float32 rounding of the
    float64 one (1e-6 relative) unless a KL lies within 1e-6 of a branch."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.update_precision import measure

    r = measure(envs=8, minibatch=32, steps=4, device="cpu")
    assert r["minibatch"] == 32 and len(r["kl_float32"]) == len(r["kl_float64"]) == 4
    assert max(r["samples"].values()) <= 1e-5, r["samples"]
    assert all(v["ulps"] <= 4 for v in r["stats"].values()), r["stats"]
    assert r["param"]["over_scale"] <= 1e-6, r["param"]
    assert r["adam mu"]["over_scale"] <= 1e-5 and r["adam nu"]["over_scale"] <= 1e-5, r
    lr32, lr64 = r["lr_float32"], r["lr_float64"]
    assert abs(lr32 - lr64) <= 1e-6 * lr64 or r["kl_min_margin"] < 1e-6, r


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
