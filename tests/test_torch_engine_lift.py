"""The engine's cadences and the arm's collision spheres on Ur5SihLift: one
env step under each engine option of HandArmConfig, the port against the
JAX package on the stand-in robot.

The JAX side runs once in a subprocess (this file run as a script,
HANDARM_ASSET_ROOT at the stand-in). It builds Ur5SihLift at B = 8, lets
the ckpt_5200 policy drive the hand into the box for 30 steps and zeroes
every episode clock (no env resets in the compared step). From that state
it takes one env step with actions from a numpy seed under each option:
`heavy_prep_per_control=False`, `carry_fk=False` (also with domain
randomization's physical scales, a DRState drawn into the state),
`hand_only_collision=False` (zero impulses on its 190 slots). It records
the arm-sphere scene's sphere set and slots, the effective masses of its
contact set and one step of it, and how its step fails on a state of the
hand-only slot count. The port starts from the same states (converted
leaf by leaf).

With the arm's spheres the shoulder link's two lowest spheres sit 2.6 cm
into the table the arm is mounted on, on the axis of the shoulder's
vertical joint: their effective mass along the table's normal is 0 (the
solver's 1e-8 floor), so their impulses grow past 1e9 and the joints run
at their velocity limits, in both packages alike (held below); a step
from such a state cannot be compared to float tolerance. The compared
arm-sphere step therefore moves the table's edge off the mount
(`table_lo` y from -0.5 to 0.15: the bin and the box stay on it), in
both packages.

Tolerances are the existing parity tests' (tests/test_torch_lift.py): 2e-4
on positions and quaternions, 2e-3 on velocities, impulses, observations
and rewards (float32 sums in other orders, the bf16 effective-mass chain
rounded by two frameworks).
"""

import dataclasses
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
# DR's physical scales at ShadowHand.yaml's ranges, no noise channel
DR = dict(mass_scale_range=(0.5, 1.5), friction_scale_range=(0.7, 1.3),
          gain_scale_range=(0.75, 1.5), gravity_noise=0.4)
OPTIONS = {
    "heavy every sim step": dict(heavy_prep_per_control=False),
    "exact FK": dict(carry_fk=False),
    "exact FK, DR": dict(carry_fk=False, dr=DR),
    "arm spheres": dict(hand_only_collision=False, table_lo=(-0.5, 0.15)),
}
LEAF_TOLS = (("q", 2e-4), ("qd", 2e-3), ("targets", 2e-4), ("obj pos", 2e-4),
             ("obj quat", 2e-4), ("obj linvel", 2e-3), ("obj angvel", 2e-3),
             ("impulse", 2e-3))


def env_config(mod, cfg, over: dict):
    """`cfg` with an option's fields, DR's given as DRConfig keywords."""
    over = dict(over)
    if "dr" in over:
        over["dr"] = mod.DRConfig(enabled=True, **over["dr"])
    return dataclasses.replace(cfg, **over)


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs import randomization as jr
    from handarm_tpu.envs.hand_arm import HandArmEnv
    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.learn.networks import ActorCritic
    from handarm_tpu.learn.running_stats import normalize
    from handarm_tpu.physics import engine as je
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
    out = {"actions": actions}
    K, nv = env.cfg_num_objects, env.art.nv
    arm = lambda s, C: s._replace(physics=s.physics._replace(
        contact_impulse=jnp.zeros((B, C, 3), jnp.float32)))
    for n, (name, over) in enumerate(OPTIONS.items()):
        oenv = HandArmEnv(env_config(jr, env.cfg, over))
        C = oenv.scene.slots.num_slots
        pre = state if C == env.scene.slots.num_slots else arm(state, C)
        if oenv.cfg.dr.enabled:
            pre = pre._replace(task=pre.task._replace(dr=jr.init_dr_state(
                oenv.cfg.dr, jax.random.PRNGKey(10 + n), B, K, nv, oenv.num_obs,
                oenv.num_actions)))
        ostep = jax.jit(oenv.step)
        post, res = ostep(pre, act)
        out[f"{name}/slots"] = C
        out[f"{name}/obs"] = np.asarray(res.obs)
        out[f"{name}/reward"] = np.asarray(res.reward)
        out[f"{name}/done"] = np.asarray(res.done)
        for tag, st in (("pre", pre), ("post", post)):
            for i, leaf in enumerate(jax.tree.leaves(st)):
                out[f"{name}/{tag}_{i}"] = np.asarray(leaf)
        if name == "arm spheres":
            sp = oenv.scene.spheres
            out["arm_sphere_body"] = np.asarray(sp.body)
            out["arm_sphere_offset"] = np.asarray(sp.offset)
            out["arm_sphere_radius"] = np.asarray(sp.radius)
            for k in ("robot_body", "obj_a", "obj_b", "friction"):
                out[f"arm_slot_{k}"] = np.asarray(getattr(oenv.scene.slots, k))
            # a state of the hand-only slot count: the JAX package cannot step it
            try:
                ostep(state, act)
                out["mismatch_error"] = "none"
            except (TypeError, ValueError) as e:
                out["mismatch_error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    # the composed arm-sphere scene (the table under the mount): its contact
    # set's effective masses and one step
    aenv = HandArmEnv(env_config(jr, env.cfg, dict(hand_only_collision=False)))
    pre = arm(state, aenv.scene.slots.num_slots)
    heavy = je.compute_heavy(aenv.scene, pre.physics)
    out["composed_arm/depth"] = np.asarray(heavy.contacts0.depth)
    out["composed_arm/d_eff"] = np.asarray(heavy.prep.d_eff)
    post, _ = jax.jit(aenv.step)(pre, act)
    out["composed_arm/qd"] = np.asarray(post.physics.robot.qd)
    out["composed_arm/impulse"] = np.asarray(post.physics.contact_impulse)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine_lift") / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1",
               **shared_jax_env(out.parent))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag) and k[len(tag):].isdigit()])
    return [ref[f"{tag}{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def base_env():
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.tasks import make_env

    return make_env("Ur5SihLift", device="cpu", num_envs=B)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_env_step_under_option_matches(ref, base_env, option):
    """One Ur5SihLift env step under the option from the same state and
    actions: the physics state, observations and rewards (tolerances in
    the module docstring). The hand pushes the box in the compared step;
    under DR the scales moved the result away from the same cadence's
    without them by more than the bound."""
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs import randomization as tr
    from handarm_tpu_torch.envs.hand_arm import HandArmEnv

    env = HandArmEnv(env_config(tr, base_env.cfg, OPTIONS[option]), "cpu")
    assert env.scene.slots.num_slots == int(ref[f"{option}/slots"])
    state = env_state_from_leaves(_leaves(ref, f"{option}/pre_"), env_cfg=env.cfg)
    post, res = env.step(state, torch.as_tensor(ref["actions"], dtype=torch.float32))
    assert not ref[f"{option}/done"].any() and not res.done.any()
    got = post.physics
    want = _leaves(ref, f"{option}/post_")
    leaves = [got.robot.q, got.robot.qd, got.robot.targets, *got.objects, got.contact_impulse]
    for (name, tol), g, w in zip(LEAF_TOLS, leaves, want):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
    np.testing.assert_allclose(res.obs.numpy(), ref[f"{option}/obs"], atol=2e-3)
    np.testing.assert_allclose(res.reward.numpy(), ref[f"{option}/reward"], atol=2e-3,
                               rtol=1e-4)
    robot = torch.as_tensor(env.scene.slots.robot_body >= 0)
    assert float(got.contact_impulse[:, robot].abs().max()) > 1e-4  # the hand pushes
    if option.endswith("DR"):
        plain = _leaves(ref, f"{option[:-4]}/post_")
        moved = max(float(np.abs(w - p).max()) / tol
                    for (_, tol), w, p in zip(LEAF_TOLS, want, plain))
        assert moved > 1.0, f"DR did not move the {option[:-4]} step"


def test_arm_sphere_set_matches(ref, base_env):
    """`hand_only_collision=False`: the port's sphere set and slots equal the
    JAX package's `make_spheres(False)` on the stand-in: 54 spheres (21 on
    the arm's six links), 190 slots against the hand-only 127."""
    from handarm_tpu_torch.envs.tasks import make_env

    env = make_env("Ur5SihLift", device="cpu", num_envs=B, hand_only_collision=False)
    sp = env.scene.spheres
    np.testing.assert_array_equal(sp.body, ref["arm_sphere_body"])
    np.testing.assert_allclose(sp.offset.numpy(), ref["arm_sphere_offset"], atol=1e-6)
    np.testing.assert_allclose(sp.radius.numpy(), ref["arm_sphere_radius"], atol=1e-6)
    for k in ("robot_body", "obj_a", "obj_b", "friction"):
        np.testing.assert_array_equal(getattr(env.scene.slots, k), ref[f"arm_slot_{k}"])
    assert len(sp.body) == 54 and int((sp.body < 6).sum()) == 21
    assert env.scene.slots.num_slots == 190 and base_env.scene.slots.num_slots == 127


def test_composed_arm_scene_degenerate_in_both(ref):
    """The composed arm-sphere scene (the table under the mount), in both
    packages: the shoulder's two lowest spheres 2.6 cm into the table with
    their effective mass at the solver's 1e-8 floor in every env; after
    one step impulses past 1e9 and most joint velocities at their limits,
    all finite (see the module docstring)."""
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.tasks import make_env
    from handarm_tpu_torch.physics import engine as te

    torch.set_num_threads(1)
    env = make_env("Ur5SihLift", device="cpu", num_envs=B, hand_only_collision=False)
    state = env_state_from_leaves(_leaves(ref, "arm spheres/pre_"))
    heavy = te.compute_heavy(env.scene, state.physics)
    slots = env.scene.slots
    table = np.flatnonzero((slots.robot_body == 0) & (slots.obj_a < 0)
                           & (slots.obj_b < 0))[:2]  # the shoulder's spheres vs the table
    for depth, d_eff in ((heavy.contacts0.depth.numpy(), heavy.prep.d_eff.numpy()),
                         (ref["composed_arm/depth"], ref["composed_arm/d_eff"])):
        np.testing.assert_allclose(depth[:, table], 0.026, atol=1e-3)
        assert np.all(d_eff[:, table, 0] <= 1.0001e-8)
    post, _ = env.step(state, torch.as_tensor(ref["actions"], dtype=torch.float32))
    lim = env.scene.model.velocity_limit.numpy()
    for qd, imp in ((post.physics.robot.qd.numpy(), post.physics.contact_impulse.numpy()),
                    (ref["composed_arm/qd"], ref["composed_arm/impulse"])):
        assert np.isfinite(imp).all() and np.abs(imp).max() > 1e9
        assert np.mean(np.isclose(np.abs(qd), lim, rtol=1e-6)) > 0.5


def test_arm_sphere_checkpoint_round_trips(tmp_path):
    """An arm-sphere TrainState (190-slot impulses) written and read back:
    every env leaf equal, the slot count read from the file."""
    from handarm_tpu_torch.convert import env_state_to_leaves
    from handarm_tpu_torch.envs.tasks import make_env
    from handarm_tpu_torch.learn.ppo import PPO, PPOConfig
    from handarm_tpu_torch.utils.checkpoint import (
        file_contact_slots,
        load_train_state,
        save_checkpoint,
    )

    torch.set_num_threads(1)
    env = make_env("Ur5SihLift", device="cpu", num_envs=4, hand_only_collision=False)
    ts = PPO(env, PPOConfig(minibatch_size=16)).init(0)
    ts = ts._replace(env_state=ts.env_state._replace(physics=ts.env_state.physics._replace(
        contact_impulse=torch.rand(4, 190, 3))))
    path = save_checkpoint(str(tmp_path), ts, 1, sync=True)
    back = load_train_state(path)
    assert file_contact_slots(path) == 190
    for a, b in zip(env_state_to_leaves(ts.env_state), env_state_to_leaves(back.env_state)):
        np.testing.assert_array_equal(a, b)


def test_resume_across_slot_counts_refused(ref, tmp_path, monkeypatch):
    """A hand-only checkpoint (ckpt_5200: 127 slots) resumed into an
    arm-sphere run (190): the JAX package loads it into the run's tree and
    then cannot step it (recorded in the subprocess); the port's train
    entry point refuses it before any iteration, naming both counts."""
    from handarm_tpu_torch import train

    assert str(ref["mismatch_error"]) != "none", "the JAX package stepped a 127-slot state"
    torch.set_num_threads(1)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=r"127 contact slots.*190"):
        train.main(["task=Ur5SihLift", "num_envs=4", "hand_only_collision=false",
                    "device=cpu", f"resume={CKPT}", "max_iterations=1"])


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
