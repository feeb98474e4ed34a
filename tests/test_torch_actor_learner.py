"""The port's actor/learner split (parallel/actor_learner.py) against the JAX
package's: the learner's merge of two actors' trajectories and its update
from them against `ActorLearner._learner_update` (ckpt_5200's learner,
trajectories of its policy computed by the JAX package, the JAX package's
permutations), and a 2-actor run of 3 learner iterations on Ur5SihReach on
the CPU (staleness, finite stats, every thread stopped)."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import handarm_tpu.learn.ppo as jppo
from handarm_tpu.parallel.actor_learner import ActorLearner as JaxActorLearner
from handarm_tpu.utils.checkpoint import load_checkpoint
from handarm_tpu_torch.convert import learner_to_leaves, train_state_from_leaves
from handarm_tpu_torch.envs.tasks import make_env
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.parallel.actor_learner import ActorLearner, snapshot_of
from handarm_tpu_torch.utils import checkpoint as tck
from test_torch_ppo import CKPT, NUM_ACTIONS, NUM_OBS, _perms, _trajectory
from test_torch_train import assert_same_lr, record_kls

torch.set_num_threads(1)
FIELDS = ("obs", "action", "logp", "value", "reward", "done", "mu", "sigma")


def _stub(num_envs):
    return SimpleNamespace(num_obs=NUM_OBS, num_actions=NUM_ACTIONS, num_teacher_obs=0,
                           cfg=SimpleNamespace(num_envs=num_envs), device=torch.device("cpu"))


def test_merge_and_learner_update_match_jax():
    """Two actors of 32 envs (T = 16) with their last-step infos (a success
    EWMA and a one-object per-object EWMA each): the port's merge equals the
    JAX learner's concatenation (trajectories on the env axis, per-env
    planes concatenated, per-actor scalars averaged), and one learner update
    from ckpt_5200 (minibatch 256, 4 x 4 steps) equals
    `ActorLearner._learner_update`'s at tests/test_torch_ppo.py's update
    tolerances, its stats dict (with both objects' EWMAs) within 1e-4
    relative."""
    jax_ts = load_checkpoint(CKPT)
    leaves = tck.read_leaves(CKPT)
    T, Ba = 16, 32
    rng = np.random.default_rng(31)
    trs = [_trajectory(jax_ts, rng, T, Ba, offset=500 + 600 * a) for a in range(2)]
    ewma = [np.float32(0.2 + 0.1 * a) for a in range(2)]
    po = [np.array([0.3 + 0.2 * a], np.float32) for a in range(2)]
    # the JAX side: [T, ...] infos, merged by its run loop's rule
    jparts = []
    for a, tr in enumerate(trs):
        traj = jppo.Transition(**{k: jnp.asarray(tr[k]) for k in FIELDS},
                               teacher_obs=jnp.zeros((T, Ba, 0), jnp.float32))
        infos = {"success_rate_ewma": jnp.full((T,), ewma[a]),
                 "per_object_success_ewma": jnp.tile(jnp.asarray(po[a])[None], (T, 1))}
        jparts.append((traj, jnp.asarray(tr["last_obs"]), jnp.zeros((Ba, 0)), infos))
    j_traj = jax.tree.map(lambda *ls: jnp.concatenate(ls, axis=1), *[p[0] for p in jparts])
    j_last = jnp.concatenate([p[1] for p in jparts], axis=0)
    j_teacher = jnp.concatenate([p[2] for p in jparts], axis=0)
    j_infos = jax.tree.map(lambda *ls: (jnp.concatenate(ls, axis=1) if ls[0].ndim >= 2
                                        else jnp.mean(jnp.stack(ls), axis=0)),
                           *[p[3] for p in jparts])
    cfg = dict(horizon=T, minibatch_size=256)
    jp = jppo.PPO(_stub(2 * Ba), jppo.PPOConfig(**cfg))
    devs = jax.devices()
    jal = JaxActorLearner(jp, lambda n: _stub(n), Ba, devs[:2], devs[0])
    key = jax.random.PRNGKey(13)
    j_new, j_stats = jax.jit(jal._learner_update)(
        jax_ts._replace(key=key), j_traj, j_last, j_teacher, j_infos)
    # the port: the last step's info per actor, merged by ActorLearner.merge
    parts = []
    for a, tr in reversed(list(enumerate(trs))):  # out of order: merge sorts by actor
        traj = tppo.Transition(*(torch.as_tensor(np.array(tr[k])) for k in FIELDS))
        info = {"success_rate_ewma": torch.tensor(ewma[a]),
                "per_object_success_ewma": torch.as_tensor(po[a])}
        parts.append((a, traj, torch.as_tensor(tr["last_obs"]), None, info, 0, None))
    traj, last_obs, last_teacher, info = ActorLearner.merge(parts)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(traj, k).numpy(), np.asarray(getattr(j_traj, k)))
    np.testing.assert_array_equal(last_obs.numpy(), np.asarray(j_last))
    assert last_teacher is None and traj.teacher_obs is None
    np.testing.assert_allclose(float(info["success_rate_ewma"]),
                               float(j_infos["success_rate_ewma"][-1]), rtol=1e-7)
    np.testing.assert_array_equal(info["per_object_success_ewma"].numpy(),
                                  np.asarray(j_infos["per_object_success_ewma"][-1]))
    tp = tppo.PPO(_stub(2 * Ba), tppo.PPOConfig(**cfg), device="cpu")
    tal = ActorLearner.__new__(ActorLearner)
    tal.ppo = tp
    ts = train_state_from_leaves(leaves, None, None)
    kls = record_kls(tp)
    _, k = jax.random.split(key)
    t_new, t_stats = tal.learner_update(ts, traj, last_obs, last_teacher, info,
                                        perms=torch.as_tensor(_perms(k, 4, T * 2 * Ba)).long())
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
    assert set(t_stats) == set(j_stats) and "success_ewma_obj1" in t_stats
    for k_, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k_]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k_)


def test_two_actor_run_on_reach():
    """Ur5SihReach on the CPU: 2 actors of 16 envs and the learner (horizon
    16, minibatch 256: 2 x 4 steps) for 3 learner iterations: staleness at
    most the queue depth (1) each iteration, every stat finite, the learner's
    epoch and Adam count advanced 3 and 24, the params moved, one rollout
    per actor per iteration, and every actor thread stopped. A
    snapshot is a copy of the learner's params, in storage of its own."""
    n = 16
    cfg = tppo.PPOConfig(horizon=16, minibatch_size=256, mini_epochs=4, hidden=(32, 32))
    ppo = tppo.PPO(make_env("Ur5SihReach", device="cpu", num_envs=2 * n), cfg)
    al = ActorLearner(ppo, lambda k: make_env("Ur5SihReach", device="cpu", num_envs=k), n,
                      num_actors=2, queue_depth=1)
    ts0 = ppo.init(0)
    snap = snapshot_of(ts0, 0)
    k0 = next(iter(ts0.params))
    assert torch.equal(snap.params[k0], ts0.params[k0])
    assert snap.params[k0].data_ptr() != ts0.params[k0].data_ptr()  # its own storage
    before = threading.active_count()
    ts, stats = al.run(ts0, 3, seed=4, timeout_s=240)
    assert threading.active_count() == before
    assert len(stats) == 3
    for it, s in enumerate(stats):
        assert 0 <= float(s["staleness"]) <= 1, (it, float(s["staleness"]))
        assert all(np.isfinite(float(v)) for v in s.values()), s
    assert int(ts.epoch) == 3 and int(ts.opt_state.count) == 3 * 8
    assert max(float((ts.params[k] - ts0.params[k]).abs().max()) for k in ts.params) > 0
    assert al.rollouts == [3, 3]
    with pytest.raises(NotImplementedError, match="MLP"):
        ActorLearner(tppo.PPO(make_env("Ur5SihReach", device="cpu", num_envs=8),
                              tppo.PPOConfig(horizon=8, minibatch_size=32, rnn_units=8,
                                             hidden=(8,))), lambda k: None, 4)
