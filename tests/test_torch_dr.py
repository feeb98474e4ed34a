"""The port's domain randomization against the JAX package.

The functions of `envs/randomization.py` run in this process on both
sides, the port given the JAX package's standard draws (rebuilt here from
its keys, as its functions split them). The env steps need the stand-in
robot: the JAX side runs once in a subprocess (this file run as a script,
HANDARM_ASSET_ROOT at the stand-in). It builds Ur5SihLift at B = 8, lets
the ckpt_5200 policy drive the hand into contact for 30 steps, zeroes
every episode clock (no env resets in the compared step), and then, for
each DR field alone (IsaacGymEnvs' ShadowHand.yaml amounts, the rest at
their defaults), draws that config's DRState into the state and takes one
env step with actions from a numpy seed. It writes the states, the
observations and the step's standard draws (action and observation noise,
from the step's key splits) to an npz; the port steps from the same state
with the same draws.
"""

import dataclasses
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # the JAX side's subprocess
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from handarm_tpu.envs import randomization as jr  # noqa: E402
from handarm_tpu_torch.envs import randomization as tr  # noqa: E402
from shared_jax_cache import shared_jax_env  # noqa: E402

STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
CKPT = os.path.join(REPO, "docs", "evidence", "lift_r3a", "ckpt_5200.npz")
B = 8
WARM_STEPS = 30
# one DR field each, at ShadowHand.yaml's amounts (envs.tasks.DR_SHADOWHAND)
FIELDS = {
    "observation_noise": {"observation_noise": {"amount": 0.002, "correlated": 0.001}},
    "action_noise": {"action_noise": {"amount": 0.05, "correlated": 0.015}},
    "mass_scale_range": {"mass_scale_range": (0.5, 1.5)},
    "friction_scale_range": {"friction_scale_range": (0.7, 1.3)},
    "gain_scale_range": {"gain_scale_range": (0.75, 1.5)},
    "gravity_noise": {"gravity_noise": 0.4},
}


def dr_config(mod, **kw):
    """`mod.DRConfig(enabled=True, ...)` with noise channels given as dicts."""
    kw = {k: mod.NoiseSpec(**v) if isinstance(v, dict) else v for k, v in kw.items()}
    return mod.DRConfig(enabled=True, **kw)


def standard(key, dist: str, shape):
    """The standard draws the JAX package's `_draw` maps: N(0, 1) or U(0, 1)."""
    fn = jax.random.normal if dist == "gaussian" else jax.random.uniform
    return torch.tensor(np.asarray(fn(key, shape)))


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("op", ["additive", "scaling"])
@pytest.mark.parametrize("dist", ["gaussian", "uniform"])
def test_draw_and_apply_noise_match(dist, op):
    """`draw` (per-step and correlated amounts) and `apply_noise` at strength
    1 and 0.3 from the JAX package's standard draws: within 1e-6 (the same
    float32 arithmetic)."""
    spec_j = jr.NoiseSpec(dist, op, 0.05, 0.015)
    spec_t = tr.NoiseSpec(dist, op, 0.05, 0.015)
    shape = (B, 11)
    k_draw, k_corr, k_noise = jax.random.split(jax.random.PRNGKey(4), 3)
    for corr in (False, True):
        want = jr._draw(spec_j, k_draw, shape, corr=corr)
        got = tr.draw(spec_t, shape, std=standard(k_draw, dist, shape), corr=corr)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    corr_draw = jr._draw(spec_j, k_corr, shape, corr=True)
    for strength in (1.0, 0.3):
        want = jr.apply_noise(spec_j, k_noise, jnp.asarray(x), corr_draw, strength)
        got = tr.apply_noise(spec_t, torch.as_tensor(x), t(corr_draw), strength,
                             std=standard(k_noise, dist, shape))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        assert float(np.abs(np.asarray(want) - x).max()) > 1e-3  # the noise is there


def test_apply_noise_zero_amount_is_identity():
    """A channel with both amounts 0 returns x itself, draws nothing, on
    both sides."""
    x = torch.arange(6.0).reshape(2, 3)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    assert tr.apply_noise(tr.NoiseSpec(), x, None, 1.0, gen) is x
    assert torch.equal(gen.get_state(), state)
    xj = jnp.arange(6.0).reshape(2, 3)
    assert jr.apply_noise(jr.NoiseSpec(), jax.random.PRNGKey(0), xj, None) is xj


@pytest.mark.parametrize("steps", [0, 50, 200])
def test_schedule_strength_matches(steps):
    """Without a schedule the strength is 1 whatever the step count; with
    100 steps it is the clipped ramp (0, 0.5, 1 at 0, half, twice):
    exact."""
    assert tr.schedule_strength(tr.DRConfig(), torch.tensor(steps)) == 1.0
    assert float(jr.schedule_strength(jr.DRConfig(), steps)) == 1.0
    got = tr.schedule_strength(tr.DRConfig(schedule_steps=100), torch.tensor(steps))
    want = jr.schedule_strength(jr.DRConfig(schedule_steps=100), jnp.asarray(steps))
    assert float(got) == float(want) == min(steps / 100, 1.0)


def _dr_std(cfg_j, key, K, nv, obs, act):
    """The standard draws of the JAX `init_dr_state(cfg, key, ...)`."""
    k = jax.random.split(key, 6)
    u = lambda kk, s: t(jax.random.uniform(kk, s))
    return tr.DRState(u(k[0], (B, K)), u(k[1], (B,)), u(k[2], (B, nv)),
                      t(jax.random.normal(k[3], (B,))),
                      standard(k[4], cfg_j.observation_noise.dist, (B, obs)),
                      standard(k[5], cfg_j.action_noise.dist, (B, act)))


@pytest.mark.parametrize("dist", ["gaussian", "uniform"])
def test_init_dr_state_and_merge_match(dist):
    """`init_dr_state` at ShadowHand's ranges (the noise channels in
    `dist`, one scaling) from the JAX package's standard draws, every leaf
    within 1e-6; then `merge_on_reset` of two states by a done mask:
    exact. From the generator the draws lie in their ranges."""
    kw = dict(FIELDS["mass_scale_range"], **FIELDS["friction_scale_range"],
              **FIELDS["gain_scale_range"], **FIELDS["gravity_noise"],
              observation_noise=dict(dist=dist, amount=0.002, correlated=0.001),
              action_noise=dict(dist=dist, op="scaling", amount=0.05, correlated=0.015))
    cfg_j, cfg_t = dr_config(jr, **kw), dr_config(tr, **kw)
    K, nv, obs, act = 3, 17, 147, 11
    states = []
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        want = jr.init_dr_state(cfg_j, key, B, K, nv, obs, act)
        got = tr.init_dr_state(cfg_t, B, K, nv, obs, act, std=_dr_std(cfg_j, key, K, nv, obs, act))
        for name, g, w in zip(tr.DRState._fields, got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0, err_msg=name)
        states.append((got, want))
    done = np.arange(B) % 3 == 0
    want = jr.merge_on_reset(jnp.asarray(done), states[1][1], states[0][1])
    got = tr.merge_on_reset(torch.as_tensor(done), states[1][0], states[0][0])
    for name, g, w in zip(tr.DRState._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0, err_msg=name)
    gen = torch.Generator().manual_seed(0)
    s = tr.init_dr_state(cfg_t, 4096, K, nv, obs, act, gen)
    for name, (lo, hi) in (("mass_scale", (0.5, 1.5)), ("friction_scale", (0.7, 1.3)),
                           ("gain_scale", (0.75, 1.5))):
        x = getattr(s, name)
        assert lo <= float(x.min()) and float(x.max()) <= hi, name
        assert float(x.max() - x.min()) > 0.9 * (hi - lo), name
    assert abs(float(s.gravity_z.std()) - 0.4) < 0.04


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    jax.config.update("jax_platforms", "cpu")
    from handarm_tpu.envs.hand_arm import HandArmEnv
    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.learn.networks import ActorCritic
    from handarm_tpu.learn.running_stats import normalize
    from handarm_tpu.robots.ur5sih import ASSET_ROOT
    from handarm_tpu.utils.checkpoint import load_checkpoint

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    env, _ = make_env("Ur5SihLift", [f"num_envs={B}"])
    state, obs = env.reset(jax.random.PRNGKey(3))
    ts = load_checkpoint(CKPT)
    net = ActorCritic(num_actions=env.num_actions)
    step = jax.jit(env.step)
    for _ in range(WARM_STEPS):
        state, res = step(state, net.apply(ts.params, normalize(ts.obs_stats, obs))[0])
        obs = res.obs
    state = state._replace(task=state.task._replace(
        progress=jnp.zeros_like(state.task.progress)))
    actions = np.random.default_rng(0).uniform(-1, 1, (B, env.num_actions))
    act = jnp.asarray(actions, jnp.float32)
    base, base_res = step(state, act)
    out = {"actions": actions, "base_obs": np.asarray(base_res.obs)}
    for i, leaf in enumerate(jax.tree.leaves(base.physics)):
        out[f"base_{i}"] = np.asarray(leaf)
    K, nv = env.cfg_num_objects, env.art.nv
    for n, (field, kw) in enumerate(sorted(FIELDS.items())):
        fenv = HandArmEnv(dataclasses.replace(env.cfg, dr=dr_config(jr, **kw)))
        dr = jr.init_dr_state(fenv.cfg.dr, jax.random.PRNGKey(10 + n), B, K, nv,
                              fenv.num_obs, fenv.num_actions)
        pre = state._replace(task=state.task._replace(dr=dr))
        post, res = jax.jit(fenv.step)(pre, act)
        # the step's key splits: (key, dist, reset, action noise), then on
        # the merged key (key, observation key), (key, observation noise)
        key, _, _, k_act = jax.random.split(pre.task.key, 4)
        key, _ = jax.random.split(key)
        _, k_obs = jax.random.split(key)
        out[f"{field}_act_std"] = np.asarray(jax.random.normal(k_act, (B, fenv.num_actions)))
        out[f"{field}_obs_std"] = np.asarray(jax.random.normal(k_obs, (B, fenv.num_obs)))
        out[f"{field}_obs"] = np.asarray(res.obs)
        out[f"{field}_reward"] = np.asarray(res.reward)
        out[f"{field}_done"] = np.asarray(res.done)
        for tag, st in (("pre", pre), ("post", post)):
            for i, leaf in enumerate(jax.tree.leaves(st)):
                out[f"{field}_{tag}_{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dr") / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1",
               **shared_jax_env(out.parent))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_") and k[len(tag) + 1:].isdigit()])
    return [ref[f"{tag}_{i}"] for i in range(n)]


PHYSICS_BOUNDS = (("q", 0, 2e-4), ("qd", 1, 2e-3), ("targets", 2, 2e-4), ("obj pos", 3, 2e-4),
                  ("obj quat", 4, 2e-4), ("obj linvel", 5, 2e-3), ("obj angvel", 6, 2e-3),
                  ("impulse", 7, 2e-3))


def check_physics(got, want, keep=slice(None)):
    """The 8 physics leaves at tests/test_torch_lift.py's bounds: 2e-4 on
    positions and quaternions, 2e-3 on velocities and impulses."""
    from handarm_tpu_torch.envs.hand_arm import tree_map

    flat = []
    tree_map(flat.append, got)
    for name, i, tol in PHYSICS_BOUNDS:
        np.testing.assert_allclose(flat[i].numpy()[keep], want[i][keep], atol=tol, err_msg=name)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_env_step_per_dr_field_matches(ref, field):
    """One Ur5SihLift env step at B = 8 with that DR field alone, from the
    same pre-step state (its DRState included) and the same action and
    observation noise draws; no env resets. Physics at the lift test's
    bounds (2e-4 positions, 2e-3 velocities and impulses), observations and
    rewards within 2e-3, the DRState leaves exact (no env was done). The
    field moved the JAX package's step away from its step without DR by
    more than a twentieth of a bound (gravity's 0.4 m/s^2 moves the resting
    box's impulses least), far above float32 rounding."""
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.hand_arm import StepDraws
    from handarm_tpu_torch.envs.tasks import make_env

    torch.set_num_threads(1)
    env = make_env("Ur5SihLift", device="cpu", num_envs=B, dr=dr_config(tr, **FIELDS[field]))
    state = env_state_from_leaves(leaves(ref, f"{field}_pre"), env_cfg=env.cfg)
    draws = StepDraws(act_noise=torch.as_tensor(ref[f"{field}_act_std"]),
                      obs_noise=torch.as_tensor(ref[f"{field}_obs_std"]))
    post, res = env.step(state, torch.as_tensor(ref["actions"], dtype=torch.float32),
                         draws=draws)
    assert not ref[f"{field}_done"].any() and not res.done.any()
    want = leaves(ref, f"{field}_post")
    check_physics(post.physics, want)
    np.testing.assert_allclose(res.obs.numpy(), ref[f"{field}_obs"], atol=2e-3)
    np.testing.assert_allclose(res.reward.numpy(), ref[f"{field}_reward"], atol=2e-3, rtol=1e-4)
    for i, (name, g) in enumerate(zip(tr.DRState._fields, post.task.dr)):
        np.testing.assert_array_equal(g.numpy(), want[19 + i], err_msg=name)
    if field == "observation_noise":
        moved = float(np.abs(ref[f"{field}_obs"] - ref["base_obs"]).max()) / 2e-3
    else:
        base = leaves(ref, "base")
        moved = max(float(np.abs(want[i] - base[i]).max()) / tol for _, i, tol in PHYSICS_BOUNDS)
    print(f"{field}: the step moved by {moved:.1f} x the bound")
    assert moved > 0.05, f"{field} did not move the step"


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
