"""The Ur5SihMultiObjectManipulation policy, docs/evidence/multiobj_r5a/ckpt_2700.npz:
the port's leaf-index reader against the JAX package's own loader, its
ActorCritic + normalize against the flax network on the checkpoint's own
147-wide observations, and a reader that touches only the leaves it needs."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.learn.networks import ActorCritic as JaxActorCritic
from handarm_tpu.learn.running_stats import normalize as j_normalize
from handarm_tpu.utils.checkpoint import load_checkpoint
from handarm_tpu_torch.convert import actor_critic_from_params, running_stats_from_leaves
from handarm_tpu_torch.learn.running_stats import normalize as t_normalize
from handarm_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "docs", "evidence", "multiobj_r5a", "ckpt_2700.npz")


@pytest.fixture(scope="module")
def jax_ts():
    return load_checkpoint(CKPT)


def test_leaf_map_matches_jax_loader(jax_ts):
    """Leaves 0-10 are the params (147 -> 768 -> 512 -> 256 -> 11) and
    37-39 the 147-wide obs running stats, as in the lift checkpoint."""
    params, (mean, var, count) = tck.read_policy(CKPT)
    flat = jax.tree_util.tree_flatten_with_path(jax_ts.params)[0]
    names = [".".join(str(k.key) for k in path[1:]) for path, _ in flat]
    assert tuple(names) == tck.PARAM_NAMES
    for (_, leaf), name in zip(flat, tck.PARAM_NAMES):
        np.testing.assert_array_equal(params[name], np.asarray(leaf))
    assert params["dense_0.kernel"].shape == (147, 768)
    for got, want in zip((mean, var, count), jax_ts.obs_stats):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert mean.shape == (147,)


def test_policy_outputs_match(jax_ts):
    """mu and value on the checkpoint's own last observations (64 envs),
    normalized with its running stats: 1e-4 absolute, as for the lift."""
    obs = np.asarray(jax_ts.last_obs)[:64]
    assert obs.shape == (64, 147)
    net = JaxActorCritic(num_actions=11)
    mu, log_std, value = net.apply(jax_ts.params, j_normalize(jax_ts.obs_stats, jnp.asarray(obs)))
    params, stats = tck.read_policy(CKPT)
    tnet = actor_critic_from_params(params)
    with torch.no_grad():
        tmu, tlog_std, tvalue = tnet(t_normalize(running_stats_from_leaves(*stats),
                                                 torch.as_tensor(obs)))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=1e-4)
    np.testing.assert_allclose(tvalue.numpy(), np.asarray(value), atol=1e-4)
    np.testing.assert_array_equal(tlog_std.detach().numpy(), np.asarray(log_std))


def test_read_policy_touches_only_its_leaves(monkeypatch):
    """read_policy decompresses leaves 0-10 and 37-39 and no other member of
    the 71-leaf archive."""
    touched = []
    orig = np.lib.npyio.NpzFile.__getitem__

    def spy(self, key):
        touched.append(key)
        return orig(self, key)

    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", spy)
    tck.read_policy(CKPT)
    want = [f"leaf_{i}" for i in list(range(11)) + [37, 38, 39]]
    assert sorted(touched) == sorted(want)
