"""The port's parallel layer against the JAX package and against itself.

- `data_shards` as a layout: one `_update_from_traj` (the MLP from
  ckpt_5200, and the recurrent asymmetric learner) at D = 2 and 4 against
  the JAX package's, on the same trajectory with the JAX package's own
  per-shard permutations.
- Ranks against one process: 2 gloo ranks on the CPU (spawned processes,
  `parallel.launch.spawn`) each update their half of the envs; the result
  equals the one-process `data_shards=2` update, the replicated leaves are
  bit-identical across ranks, and the collectives are the expected ones
  (one gradient all-reduce per minibatch step, a fixed number per
  iteration, no gather of batch data: the port's counterpart of
  tests/test_sharding.py:83).
- One env step on 2 ranks under ADR with two objects: the metrics and
  ADR's queues and ranges equal the one-process step's.
- Checkpoints: a 2-rank checkpoint is the one-process file, and the JAX
  package's loader reads it.
- The launch helpers (as tests/test_misc.py:81), `dryrun_multichip(2)`
  tiny on the CPU, and the train entry point under torchrun.

Every rank process imports torch and the port only
(tests/torch_parallel_ranks.py); each spawn has its own timeout and kills
its ranks on failure.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import handarm_tpu.learn.ppo as jppo
import torch_parallel_ranks as ranks
from handarm_tpu.utils.checkpoint import load_checkpoint
from handarm_tpu_torch.convert import learner_to_leaves
from handarm_tpu_torch.envs.adr import adr_draws
from handarm_tpu_torch.envs.hand_arm import HandArmEnv, StepDraws
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.parallel import launch
from handarm_tpu_torch.parallel.mesh import is_env_local, leaves_with_paths
from handarm_tpu_torch.utils import checkpoint as tck
from test_torch_ppo import (
    CKPT,
    NUM_ACTIONS,
    _jax_ppo,
    _jax_traj,
    _perms,
    _port_ppo,
    _port_traj,
    _trajectory,
)
from test_torch_train import assert_same_lr, record_kls

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN = dict(backend="gloo", device="cpu", threads=1, timeout_s=240)


@pytest.fixture(scope="module")
def jax_ts():
    return load_checkpoint(CKPT)


@pytest.fixture(scope="module")
def leaves():
    return tck.read_leaves(CKPT)


def _scale_err(got, want) -> float:
    """max |got - want| over max(|want|, 1e-30)."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- data_shards as a layout, against the JAX package -------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_update_matches_jax(shards, jax_ts, leaves):
    """`_update_from_traj` of ckpt_5200's learner at B = 64, T = 16,
    minibatch 256 (4 x 4 Adam steps) with data_shards = D: each minibatch
    takes 256 / D samples of each shard, the JAX package's permutations
    per shard. Tolerances as tests/test_torch_ppo.py's update test: params
    and Adam moments within 1e-6, counters exact, stats within 1e-5
    relative, the lr equal (or a KL at a branch threshold), the stats dict
    within 1e-4 relative."""
    T, B, key = 16, 64, jax.random.PRNGKey(11)
    tr = _trajectory(jax_ts, np.random.default_rng(12), T, B, offset=200)
    cfg = dict(horizon=T, minibatch_size=256, data_shards=shards)
    jp, jts = _jax_ppo(jax_ts, B, **cfg)
    j_new, j_stats = jax.jit(jp._update_from_traj)(
        jts._replace(key=key), _jax_traj(tr), None, jnp.asarray(tr["last_obs"]), None, key)
    tp, tts = _port_ppo(leaves, B, **cfg)
    kls = record_kls(tp)
    perms = _perms(key, 4, T * B, shards)
    assert perms.shape == (4, shards, T * B // shards)
    t_new, t_stats = tp._update_from_traj(tts, _port_traj(tr), None, _t(tr["last_obs"]),
                                          perms=_t(perms).long())
    assert len(kls) == 16
    got = learner_to_leaves(t_new)
    want = jax.tree.leaves((j_new.params, j_new.opt_state, j_new.obs_stats,
                            j_new.value_stats, j_new.lr))
    for i, w in enumerate(want):
        w = np.asarray(w)
        if i < 11 or 15 <= i < 37:
            np.testing.assert_allclose(got[i], w, atol=1e-6, err_msg=f"leaf {i}")
        elif i < 15:
            np.testing.assert_array_equal(got[i], w, err_msg=f"leaf {i}")
        elif i < 43:
            np.testing.assert_allclose(got[i], w, rtol=1e-5, err_msg=f"leaf {i}")
    assert_same_lr(float(got[43]), float(want[43]), kls)
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    # the layout matters: the one-shard update of the same trajectory differs
    one, _ = _port_ppo(leaves, B, horizon=T, minibatch_size=256)
    other, _ = one._update_from_traj(tts, _port_traj(tr), None, _t(tr["last_obs"]),
                                     perms=_t(perms.reshape(4, -1)).long())
    assert not np.allclose(learner_to_leaves(other)[0], got[0], atol=1e-9, rtol=0)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_recurrent_update_matches_jax(shards):
    """One train_iter of the recurrent asymmetric learner (LSTM 16, critic
    LSTM 24, B = 8, horizon 8, sequences of 4, minibatches of 4 sequences x
    2 mini-epochs) with data_shards = D, the JAX package's noise and
    per-shard sequence permutations: tests/test_torch_rnn.py's tolerances."""
    from test_torch_rnn import (
        B as RB,
        NUM_ACTIONS as RA,
        T as RT,
        L,
        _JaxTableEnv,
        _TorchTableEnv,
        _assert_state_matches,
        _cfg,
        _jax_state,
        _port_state,
        _tables,
    )

    cfg = _cfg(asymmetric_critic=True, rnn_units=16, critic_rnn_units=24, data_shards=shards)
    rng = np.random.default_rng(21)
    tables = _tables(rng)
    jp = jppo.PPO(_JaxTableEnv(*tables), jppo.PPOConfig(**cfg))
    jts = _jax_state(jp, rng, 3, jax.random.PRNGKey(21))
    j_new, j_stats = jp.train_iter(jts)
    key, k_roll = jax.random.split(jts.key)
    noise = np.stack([np.asarray(jax.random.normal(k, (RB, RA)))
                      for k in jax.random.split(k_roll, RT)])
    perms = _perms(key, cfg["mini_epochs"], RT // L * RB, shards)
    tcfg = tppo.PPOConfig(**cfg)
    tp = tppo.PPO(_TorchTableEnv(*tables), tcfg, device="cpu")
    kls = record_kls(tp)
    t_new, t_stats = tp.train_iter(_port_state(jts, tcfg), noise=_t(noise),
                                   perms=_t(perms).long())
    assert len(kls) == 8
    _assert_state_matches(j_new, t_new, tcfg, kls)
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_default_draw_per_shard():
    """Without `perms`, the learner draws one permutation per shard and
    mini-epoch from its generator: [mini_epochs, D, rows / D]; at D = 1
    the draws of the one-shard learner."""
    env = ranks.stub_env(8, 5, 2)
    p = tppo.PPO(env, tppo.PPOConfig(horizon=4, minibatch_size=8, mini_epochs=3,
                                     hidden=(8,), data_shards=4), device="cpu")
    p.gen.manual_seed(3)
    perms = p.draw_perms("cpu")
    assert perms.shape == (3, 4, 8)
    assert all(sorted(x.tolist()) == list(range(8)) for x in perms.reshape(-1, 8))
    rows = p.minibatch_rows(perms)
    assert rows.shape == (12, 8)  # 4 minibatches x 3 epochs, 2 rows of each shard
    np.testing.assert_array_equal(rows[0].numpy(),
                                  (perms[0, :, :2] + torch.arange(4)[:, None] * 8).reshape(-1))
    one = tppo.PPO(env, tppo.PPOConfig(horizon=4, minibatch_size=8, mini_epochs=3,
                                       hidden=(8,)), device="cpu")
    one.gen.manual_seed(3)
    want = torch.randperm(32, generator=torch.Generator().manual_seed(3))
    assert torch.equal(one.draw_perms("cpu")[0, 0], want)
    with pytest.raises(ValueError, match="data_shards"):
        tppo.PPO(env, tppo.PPOConfig(horizon=4, minibatch_size=8, data_shards=3), device="cpu")


# --- ranks against one process ---------------------------------------------

def test_two_ranks_match_one_process(jax_ts, leaves):
    """2 gloo ranks, each updating its 32 of B = 64 envs (T = 16, minibatch
    256: 4 x 4 steps) with the shared [4, 2, 512] permutations, against the
    one-process data_shards=2 update of the same trajectory: params,
    running stats and lr within 1e-6 of each leaf's scale (its largest
    magnitude), Adam moments within 1e-5 (the ranks average per-rank
    gradients where one process takes the mean of the whole minibatch: a
    float32 rounding apart, which the first moment of a near-cancelling
    bias gradient carries as is; measured 2.1e-6), counters and epoch
    exact, the stats dict within 1e-5
    relative; both ranks' learners bit-identical; and the collectives: one
    gradient all-reduce per minibatch step (16), two for the batch
    moments, one for the reward and done means, and no gather of batch
    data (the one all-gather is assert_sharded's checksums)."""
    T, B, key = 16, 64, jax.random.PRNGKey(5)
    tr = _trajectory(jax_ts, np.random.default_rng(6), T, B, offset=300)
    cfg = dict(horizon=T, minibatch_size=256, data_shards=2)
    perms = _perms(key, 4, T * B, 2)
    tp, tts = _port_ppo(leaves, B, **cfg)
    one, one_stats = tp._update_from_traj(tts, _port_traj(tr), None, _t(tr["last_obs"]),
                                          perms=_t(perms).long())
    want = learner_to_leaves(one)
    traj = {k: np.asarray(tr[k]) for k in ranks.TRAJ_FIELDS}
    recs = launch.spawn(ranks.update_rank, 2, (cfg, leaves, traj, tr["last_obs"], perms,
                                               NUM_ACTIONS), **SPAWN)
    r0, r1 = recs
    for a, b in zip(r0["leaves"], r1["leaves"]):
        np.testing.assert_array_equal(a, b)  # replicated: bit-identical
    assert r0["sharding"] == r1["sharding"]
    worst = {"params": 0.0, "moments": 0.0, "stats and lr": 0.0}
    for i, (g, w) in enumerate(zip(r0["leaves"], want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if 11 <= i < 15:  # optax counters
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
            continue
        kind = "params" if i < 11 else "moments" if i < 37 else "stats and lr"
        err = _scale_err(g, w)
        worst[kind] = max(worst[kind], err)
        assert err <= (1e-5 if kind == "moments" else 1e-6), (i, err)
    print(f"ranks vs one process, worst error of scale: {worst}")
    assert r0["epoch"] == int(one.epoch)
    for k, v in one_stats.items():
        np.testing.assert_allclose(r0["stats"][k], float(v), rtol=1e-5, atol=1e-8, err_msg=k)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(want[:11], learner_to_leaves(tts)))
    assert moved > 1e-5
    assert r0["collectives"] == {"all_reduce grads": 16, "all_reduce moments": 2,
                                 "all_reduce means": 1, "all_gather_object checksums": 1}


# --- env-global reductions ----------------------------------------------------

def test_two_rank_env_step_metrics_and_adr():
    """One control step of 16 envs with two boxes under ADR (2-step
    episodes: half the envs finish, some at the goal; queues of two
    samples), once in one process and once on 2 ranks of 8 envs from the
    same state, actions and ADR draws: the success metrics (success,
    end-success, the per-object EWMAs and the totals), the step count and
    ADR's q_sum, q_cnt, lo and hi are bit-identical to the one-process
    step's on both ranks, and ADR's workers and values are the one-process
    rows of each rank."""
    B = 16
    env = HandArmEnv(ranks.env_config(B), "cpu")
    state, _ = env.reset(4)
    rng = np.random.default_rng(8)
    act = lambda: torch.as_tensor(rng.uniform(-1, 1, (B, env.num_actions)).astype(np.float32))
    state, _ = env.step(state, act())  # staggered clocks, a first ADR move
    actions = act()
    draws = adr_draws(env.cfg.adr, B, torch.Generator().manual_seed(9), "cpu")
    new, _ = env.step(state, actions, draws=StepDraws(adr=draws))
    want = dict(leaves_with_paths(new))
    done_envs = int((new.task.progress == 0).sum())
    assert 0 < done_envs < B, done_envs
    po = want["metrics.per_object_ewma"]
    assert bool((po > 0).all()) and float(po[0]) != float(po[1])  # both objects, apart
    assert 0 < float(want["metrics.success_ewma"]) < 1
    assert float(want["task.adr.q_cnt"].sum()) > 0  # queues filling
    moved = (want["task.adr.lo"] != state.task.adr.lo) | (want["task.adr.hi"] != state.task.adr.hi)
    assert bool(moved.any())  # ranges moving
    recs = launch.spawn(ranks.env_step_rank, 2, (B, state, actions, draws), **SPAWN)
    replicated = [p for p in want if not is_env_local("env_state." + p)]
    assert {"metrics.success_ewma", "metrics.end_success_ewma", "metrics.per_object_ewma",
            "task.adr.lo", "task.adr.hi", "task.adr.q_sum", "task.adr.q_cnt",
            "task.total_steps"} <= set(replicated)
    half = B // 2
    for r, got in enumerate(recs):
        for p in replicated:
            assert torch.equal(got[p], want[p]), (r, p, got[p], want[p])
        sl = slice(half * r, half * (r + 1))
        for p in ("task.adr.worker_mode", "task.adr.values", "task.progress"):
            assert torch.equal(got[p], want[p][sl]), (r, p)


# --- checkpoints ---------------------------------------------------------------

def test_two_rank_checkpoint_is_the_one_process_file(tmp_path):
    """The stand-in lift's TrainState at B = 8 (768-512-256, one iteration
    in): written by one process, and by 2 ranks each holding 4 envs (rank
    0 writes the gathered state): the two files are leaf for leaf equal,
    and the JAX package's `load_checkpoint` reads the ranks' file with an
    unsharded example tree (ckpt_5200's TrainState layout): its env state
    holds all 8 envs."""
    from handarm_tpu_torch.envs.tasks import make_env

    env = make_env("Ur5SihLift", device="cpu", num_envs=8, solver_iterations=2)
    ppo = tppo.PPO(env, tppo.PPOConfig(horizon=2, minibatch_size=8, mini_epochs=1))
    ts, _ = ppo.train_iter(ppo.init(1))
    one = tck.save_checkpoint(str(tmp_path / "one"), ts, 3, seed=5, sync=True)
    two = launch.spawn(ranks.checkpoint_rank, 2, (ts, str(tmp_path / "two"), {}), **SPAWN)
    assert two[0] == two[1] and os.path.basename(two[0]) == "ckpt_3.npz"
    a, b = tck.read_leaves(one), tck.read_leaves(two[0])
    assert len(a) == len(b) == 71
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    loaded = load_checkpoint(two[0], example_tree=load_checkpoint(CKPT))
    assert loaded.last_obs.shape == (8, env.num_obs)
    assert loaded.env_state.physics.robot.q.shape == (8, 17)
    np.testing.assert_array_equal(np.asarray(loaded.last_obs), ts.last_obs.numpy())
    # resuming into 2 ranks: each rank's slice of the file
    back = tck.load_train_state(two[0], "cpu")
    from handarm_tpu_torch.parallel.mesh import DataParallel, scatter_train_state

    for r in range(2):
        part = scatter_train_state(DataParallel(r, 2, "cpu", "gloo"), back)
        assert torch.equal(part.last_obs, ts.last_obs[4 * r:4 * r + 4])
        assert torch.equal(part.env_state.physics.robot.q,
                           ts.env_state.physics.robot.q[4 * r:4 * r + 4])
        assert torch.equal(part.env_state.metrics.success_ewma,
                           ts.env_state.metrics.success_ewma)


# --- launch helpers, dry run and the entry point -------------------------------

def test_launch_helpers_single_process():
    """As tests/test_misc.py tests the JAX package's: one process joins no
    group, is the main process and keeps all envs; nccl on the CPU and an
    unknown backend raise."""
    info = launch.init_distributed("gloo", "cpu")
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] == 1 and str(info["device"]) == "cpu"
    assert launch.is_main_process()
    assert launch.per_host_envs(1024) == 1024
    with pytest.raises(ValueError, match="nccl"):
        launch.rank_device(0, "nccl", "cpu")
    with pytest.raises(ValueError, match="dist_backend"):
        launch.rank_device(0, "mpi", "cpu")


def test_dryrun_multichip_tiny(monkeypatch):
    """`graft_entry.dryrun_multichip(2)` at its tiny shape on 2 gloo ranks
    on the CPU: one whole train iteration each, every replicated leaf
    bit-identical across ranks, the per-env leaves 8 rows each, the
    collectives of the iteration."""
    from handarm_tpu_torch import graft_entry

    monkeypatch.setenv("HANDARM_DRYRUN_TINY", "1")
    out = graft_entry.dryrun_multichip(2, backend="gloo", device="cpu", timeout_s=240)
    assert out["envs"] == 16 and out["envs_per_rank"] == 8
    assert out["sharding"]["sharded"] > 10 and out["sharding"]["replicated"] > 30
    assert out["ranks"][0]["stats"] == out["ranks"][1]["stats"]
    assert np.isfinite(out["stats"]["kl"]) and np.isfinite(out["stats"]["value_loss"])
    assert out["collectives"]["all_reduce grads"] == 1  # 1 minibatch x 1 mini-epoch
    assert out["collectives"]["all_reduce metrics"] == 2  # one per control step


def test_train_entry_point_under_torchrun(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node=2 -m
    handarm_tpu_torch.train task=Ur5SihReach num_envs=8 max_iterations=2
    device=cpu dist_backend=gloo`: each rank builds 4 envs, data_shards is
    2, rank 0 alone prints and writes; its ckpt_2.npz holds all 8 envs and
    one process resumes it whole."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "handarm_tpu_torch.train", "task=Ur5SihReach", "num_envs=8",
           "max_iterations=2", "device=cpu", "dist_backend=gloo", "experiment=ddp"]
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("task=Ur5SihReach envs=8") == 1, res.stdout
    assert "ranks=2 data_shards=2" in res.stdout
    path = tmp_path / "runs" / "ddp" / "nn" / "ckpt_2.npz"
    leaves = tck.read_leaves(str(path))
    assert leaves[-3].shape[0] == 8 and int(leaves[-1]) == 2  # last_obs, epoch
    res = subprocess.run([sys.executable, "-m", "handarm_tpu_torch.train", "task=Ur5SihReach",
                          "num_envs=8", "max_iterations=3", "device=cpu", "experiment=ddp",
                          "resume=auto"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert f"resumed from runs/ddp/nn/ckpt_2.npz at iter 2\n" in res.stdout
    assert "reset fresh" not in res.stdout


def test_scaling_report_on_the_cpu(tmp_path):
    """`graft_entry.scaling_report` for 1 and 2 gloo ranks on the CPU at 8
    envs a rank (the production shape otherwise: 8 sweeps, 768-512-256,
    horizon 16, 4 mini-epochs): a row per rank count with its seconds per
    iteration and global env-steps/s, every leaf's placement counted, the
    report written as JSON with the platform named."""
    import json

    from handarm_tpu_torch import graft_entry

    out = tmp_path / "scaling.json"
    rep = graft_entry.scaling_report(device_counts=(1, 2), envs_per_device=8, iters=1,
                                     out_path=str(out), backend="gloo", device="cpu")
    assert rep["platform"] == "cpu" and [r["devices"] for r in rep["rows"]] == [1, 2]
    for r in rep["rows"]:
        assert r["num_envs"] == 8 * r["devices"] and r["iter_seconds"] > 0
        assert r["env_steps_per_s"] == pytest.approx(r["num_envs"] * 16 / r["iter_seconds"])
        assert r["sharded_leaves"] > 10 and r["replicated_leaves"] > 30
    assert json.loads(out.read_text()) == rep
