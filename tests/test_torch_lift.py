"""The port's Ur5SihLift slice against the JAX package, on the stand-in robot.

The JAX package reads its asset root when `handarm_tpu.robots.ur5sih` is
imported, and other test files import that module at collection, so the
JAX side runs in a subprocess with HANDARM_ASSET_ROOT pointing at the
stand-in (this file run as a script). It builds Ur5SihLift at B = 8, resets,
lets the ckpt_5200 policy drive the hand into contact for 30 steps, sets
every episode clock to 0 (so no env times out and auto-resets in the
compared step), takes one env step with actions from a numpy seed, and
writes the states, observations and rewards to an npz. The port then starts
from the same pre-step state (converted leaf by leaf) and must land on the
same post-step state.
"""

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
B = 8
WARM_STEPS = 30


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.robots.ur5sih import ASSET_ROOT

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    from handarm_tpu.learn.networks import ActorCritic
    from handarm_tpu.learn.running_stats import normalize
    from handarm_tpu.utils.checkpoint import load_checkpoint

    env, _ = make_env("Ur5SihLift", [f"num_envs={B}"])
    state, obs = env.reset(jax.random.PRNGKey(3))
    # the checkpoint's policy drives the hand down into contact first
    ts = load_checkpoint(CKPT)
    net = ActorCritic(num_actions=env.num_actions)
    step = jax.jit(env.step)
    for _ in range(WARM_STEPS):
        mu = net.apply(ts.params, normalize(ts.obs_stats, obs))[0]
        state, res = step(state, mu)
        obs = res.obs
    state = state._replace(task=state.task._replace(
        progress=jnp.zeros_like(state.task.progress)))
    actions = np.random.default_rng(0).uniform(-1, 1, (B, env.num_actions))
    post, res = step(state, jnp.asarray(actions, jnp.float32))
    out = dict(actions=actions, obs_pre=np.asarray(env.observe(state)[0]),
               obs=np.asarray(res.obs), reward=np.asarray(res.reward),
               done=np.asarray(res.done), num_slots=env.scene.slots.num_slots,
               num_obs=env.num_obs, num_actions=env.num_actions)
    for tag, st in (("pre", state), ("post", post)):
        for i, leaf in enumerate(jax.tree.leaves(st)):
            out[f"{tag}_{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("lift") / "ref.npz"
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
def port_env():
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.tasks import make_env

    return make_env("Ur5SihLift", device="cpu", num_envs=B)


def test_jax_package_builds_lift_on_standin(ref, port_env):
    """The stand-in gives the JAX package a working Ur5SihLift, with the
    scene sizes the port builds: 127 contact slots (14 box points vs table
    and vs the bin walls, 33 hand spheres vs table, box and walls), 121
    observations and 11 actions."""
    assert int(ref["num_slots"]) == port_env.scene.slots.num_slots == 127
    assert int(ref["num_obs"]) == port_env.num_obs == 121
    assert int(ref["num_actions"]) == port_env.num_actions == 11
    assert np.all(np.isfinite(ref["obs"]))


def test_observations_match(ref, port_env):
    """The 121 observations of the same state. Tolerance 1e-4: float32 FK
    chains of 17 joints evaluated in another order of operations."""
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.hand_arm import ObsContext

    state = env_state_from_leaves(_leaves(ref, "pre"))
    obs = port_env._compute_obs(ObsContext(port_env, state))
    np.testing.assert_allclose(obs.numpy(), ref["obs_pre"], atol=1e-4, rtol=1e-4)


def test_env_step_matches(ref, port_env):
    """One Ur5SihLift env step (3 sim steps x 2 anchored substeps x 8
    sweeps, bf16 solver prep, heavy prep per control step, carried FK) from
    the same state and actions. No env resets in this step (clocks at 0,
    all finite), so every env is compared. Tolerances: the JAX package's
    own sweep-parity bounds, 2e-4 on positions and 2e-3 on velocities and
    impulses (tests/test_contact_sweep.py), with the bf16 effective-mass
    chain rounded by two frameworks."""
    from handarm_tpu_torch.convert import env_state_from_leaves

    state = env_state_from_leaves(_leaves(ref, "pre"))
    post, res = port_env.step(state, torch.as_tensor(ref["actions"], dtype=torch.float32))
    assert not ref["done"].any() and not res.done.any()
    got = post.physics
    want = _leaves(ref, "post")
    for name, g, w, tol in (
        ("q", got.robot.q, want[0], 2e-4), ("qd", got.robot.qd, want[1], 2e-3),
        ("targets", got.robot.targets, want[2], 2e-4),
        ("obj pos", got.objects.pos, want[3], 2e-4),
        ("obj quat", got.objects.quat, want[4], 2e-4),
        ("obj linvel", got.objects.linvel, want[5], 2e-3),
        ("obj angvel", got.objects.angvel, want[6], 2e-3),
        ("impulse", got.contact_impulse, want[7], 2e-3),
    ):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
    robot = torch.as_tensor(port_env.scene.slots.robot_body >= 0)
    assert float(got.contact_impulse[:, robot].abs().max()) > 1e-4  # the hand pushes
    np.testing.assert_allclose(res.obs.numpy(), ref["obs"], atol=2e-3)
    np.testing.assert_allclose(res.reward.numpy(), ref["reward"], atol=2e-3, rtol=1e-4)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
