"""The policy from docs/evidence/lift_r3a/ckpt_5200.npz: the port's leaf-index
reader against the JAX package's own loader, and the port's ActorCritic +
normalize against the flax network on the same observations."""

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
                    "docs", "evidence", "lift_r3a", "ckpt_5200.npz")


@pytest.fixture(scope="module")
def jax_ts():
    return load_checkpoint(CKPT)


def test_leaf_map_matches_jax_loader(jax_ts):
    """Leaves 0-10 are the params, 37-39 the obs running stats, 44-67 the env
    state, as utils/checkpoint.py documents."""
    params, (mean, var, count) = tck.read_policy(CKPT)
    flat = jax.tree_util.tree_flatten_with_path(jax_ts.params)[0]
    names = [".".join(str(k.key) for k in path[1:]) for path, _ in flat]
    assert tuple(names) == tck.PARAM_NAMES
    for (_, leaf), name in zip(flat, tck.PARAM_NAMES):
        np.testing.assert_array_equal(params[name], np.asarray(leaf))
    for got, want in zip((mean, var, count), jax_ts.obs_stats):
        np.testing.assert_array_equal(got, np.asarray(want))
    leaves = tck.read_leaves(CKPT)
    env_leaves = jax.tree.leaves(jax_ts.env_state)
    lo, hi = tck.ENV_STATE_LEAVES
    assert len(env_leaves) == hi - lo
    for got, want in zip(leaves[lo:hi], env_leaves):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_policy_outputs_match(jax_ts):
    """mu and value of the checkpoint's own last observations (64 envs),
    normalized with its running stats. float32 matmuls of width 768 in two
    libraries: 1e-4 absolute on mu and value."""
    obs = np.asarray(jax_ts.last_obs)[:64]
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


def test_env_state_converts(jax_ts):
    """The checkpoint's 8192-env EnvState leaves become the port's EnvState."""
    from handarm_tpu_torch.convert import env_state_from_leaves

    lo, hi = tck.ENV_STATE_LEAVES
    st = env_state_from_leaves(tck.read_leaves(CKPT)[lo:hi])
    np.testing.assert_array_equal(st.physics.robot.q.numpy(),
                                  np.asarray(jax_ts.env_state.physics.robot.q))
    assert st.physics.contact_impulse.shape == (8192, 127, 3)
    assert st.task.progress.dtype == torch.int64


def test_rollout_entry_point_on_cpu():
    """`python -m handarm_tpu_torch.rollout --device cpu` at a tiny size: the
    checkpoint's policy drives the stand-in lift env; on CPU tensors no
    kernel launches."""
    from handarm_tpu_torch import rollout

    out = rollout.run(envs=4, steps=2, device="cpu")
    assert out["slots"] == 127 and out["env_steps_per_s"] > 0
    assert np.isfinite(out["mean_reward"])
    assert out["launches"] == {"spd_inverse": 0, "contact_sweep": 0,
                               "prep_deff": 0, "sdf_gather": 0}


def test_default_device_is_cuda():
    """Entry points run on the card unless the caller asks for the CPU; with
    no CUDA they raise instead of falling back."""
    from handarm_tpu_torch import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
