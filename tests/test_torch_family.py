"""The rest of the UR5+SIH task family against the JAX package, on the
stand-in robot: Ur5SihReposition, OrientedReposition, Repose and Throw,
each with the default box; every observable and actionable the port added
for them; the goal-quaternion draw; balanced target sampling.

The JAX package reads its asset root when `handarm_tpu.robots.ur5sih` is
imported, so its side runs in a subprocess with HANDARM_ASSET_ROOT at the
stand-in (this file run as a script), which writes one npz:

- per task at B = 8, with the reward extended by the three penalty terms
  (object_velocity_penalty, dof_velocity_penalty, collision_penalty): a
  reset, then a state made to exercise every term (each env's target
  object put between the fingertips, at their mean x and y and the lowest
  one's height, moving at up to 0.3 m/s along each axis; the arm's joint
  velocities at 0.8-1.5 rad/s; every episode clock at 0, so no env
  resets), one env step with actions from a numpy seed: the
  pre- and post-step states, observations, rewards, reward terms and done;
- a probe env (oriented_reposition, a box and a sphere) observing every
  observable the port registers, acting through ur5_relative_joint_pos,
  sih_absolute_servo_pos and sih_relative_servo_pos: its observations of
  that state, by name, and the control state after one step;
- the uniform draw and the goal quaternions of `_fresh_state` for the
  orientation goals;
- 10^5 target draws of `_sample_target` with balanced sampling.
The port starts from the same states (converted leaf by leaf).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from shared_jax_cache import shared_jax_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
B = 8
TASKS = ("Ur5SihReposition", "Ur5SihOrientedReposition", "Ur5SihRepose", "Ur5SihThrow")
PENALTIES = {"object_velocity_penalty": 1.0, "dof_velocity_penalty": 1.0,
             "collision_penalty": 1.0}
PENALTY_NAMES = tuple(PENALTIES)
PROBE_OBS = (
    "ur5_joint_pos", "ur5_joint_vel", "ur5_joint_state", "ur5_flange_pose",
    "sih_fingertip_pos", "sih_fingertip_quat", "sih_fingertip_linvel",
    "sih_fingertip_angvel", "dof_position_targets", "dof_pos", "dof_vel",
    "object_pos", "object_quat", "object_linvel", "object_angvel", "object_mass",
    "object_com", "object_inertia", "object_bounding_box", "target_object_bounding_box",
    "target_object_pos", "target_object_quat", "goal_pos", "goal_quat",
    "target_object_keypoints", "goal_keypoints", "sih_fingertip_to_target_object_pos",
    "target_object_to_goal_pos",
)
PROBE_ACTIONS = ("ur5_relative_joint_pos", "sih_absolute_servo_pos", "sih_relative_servo_pos")
PROBE_OBJECTS = (("box", (0.03, 0.03, 0.045), 0.15), ("sphere", (0.03,), 0.1))
BALANCED_EWMA = (0.9, 0.2, 0.55)
DRAWS = 100_000


def _task_reward(task):
    from handarm_tpu_torch.envs.tasks import TASKS as PRESETS

    return {**PRESETS[task][0].reward, **PENALTIES}


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.robots.ur5sih import ASSET_ROOT

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    out = {}
    rng = np.random.default_rng(0)

    def exercised(env, state):
        """The reset state with the box in the hand, falling, the arm moving
        and every clock at 0."""
        a, b = env.obs_slices["sih_fingertip_pos"]
        tips = np.asarray(env.observe(state)[0])[:, a:b].reshape(B, 5, 3)
        t = np.asarray(state.task.target_obj)
        pos = np.asarray(state.physics.objects.pos).copy()
        pos[np.arange(B), t] = np.concatenate([tips[..., :2].mean(1), tips[..., 2:].min(1)], -1)
        lin = np.asarray(state.physics.objects.linvel).copy()
        lin[np.arange(B), t] = rng.uniform(-0.3, 0.3, (B, 3))
        qd = np.asarray(state.physics.robot.qd).copy()
        qd[:, :6] = rng.uniform(0.8, 1.5, (B, 6)) * rng.choice([-1.0, 1.0], (B, 6))
        o, r = state.physics.objects, state.physics.robot
        f = lambda x: jnp.asarray(x, jnp.float32)
        return state._replace(
            physics=state.physics._replace(
                objects=o._replace(pos=f(pos), linvel=f(lin)), robot=r._replace(qd=f(qd))),
            task=state.task._replace(progress=jnp.zeros_like(state.task.progress)))

    for task in TASKS:
        env, _ = make_env(task, [f"num_envs={B}", f"reward={json.dumps(_task_reward(task))}"])
        state, _ = env.reset(jax.random.PRNGKey(3))
        state = exercised(env, state)
        actions = rng.uniform(-1, 1, (B, env.num_actions))
        post, res = jax.jit(env.step)(state, jnp.asarray(actions, jnp.float32))
        out.update({f"{task}_actions": actions, f"{task}_obs_pre": np.asarray(env.observe(state)[0]),
                    f"{task}_obs": np.asarray(res.obs), f"{task}_reward": np.asarray(res.reward),
                    f"{task}_done": np.asarray(res.done),
                    f"{task}_sizes": np.asarray([env.num_obs, env.num_actions,
                                                 env.scene.slots.num_slots])})
        for k, v in res.info.items():
            if k.startswith("reward_terms/"):
                out[f"{task}_term_{k[13:]}"] = np.asarray(v)
        for tag, st in (("pre", state), ("post", post)):
            for i, leaf in enumerate(jax.tree.leaves(st)):
                out[f"{task}_{tag}_{i}"] = np.asarray(leaf)
        if env.cfg.goal in ("oriented_reposition", "repose"):
            key = jax.random.PRNGKey(17)
            fresh = env._fresh_state(key, B)
            _, kgoal, _, _ = jax.random.split(key, 4)
            ku1, _ = jax.random.split(jax.random.fold_in(kgoal, 1))
            out[f"{task}_u"] = np.asarray(jax.random.uniform(ku1, (B, 2), minval=-1.0,
                                                              maxval=1.0))
            out[f"{task}_goal_quat"] = np.asarray(fresh.task.goal_quat)

    probe, _ = make_env("Ur5SihReposition", [
        f"num_envs={B}", "goal=oriented_reposition", f"observations={json.dumps(PROBE_OBS)}",
        f"actions={json.dumps(PROBE_ACTIONS)}", f"objects={json.dumps(PROBE_OBJECTS)}"])
    state, _ = probe.reset(jax.random.PRNGKey(5))
    state = exercised(probe, state)
    obs = np.asarray(probe.observe(state)[0])
    for name, (a, b) in probe.obs_slices.items():
        out[f"probe_obs_{name}"] = obs[:, a:b]
    actions = rng.uniform(-1, 1, (B, probe.num_actions))
    post, _ = jax.jit(probe.step)(state, jnp.asarray(actions, jnp.float32))
    out["probe_actions"] = actions
    out["probe_control"] = np.concatenate([np.asarray(x) for x in post.control], -1)
    for i, leaf in enumerate(jax.tree.leaves(state)):
        out[f"probe_pre_{i}"] = np.asarray(leaf)

    from handarm_tpu.envs.hand_arm import HandArmEnv

    ns = SimpleNamespace(cfg_num_objects=len(BALANCED_EWMA),
                         cfg=SimpleNamespace(balanced_target_sampling=True))
    draws = HandArmEnv._sample_target(ns, jax.random.PRNGKey(0), DRAWS,
                                      jnp.asarray(BALANCED_EWMA, jnp.float32))
    out["balanced_counts"] = np.bincount(np.asarray(draws), minlength=len(BALANCED_EWMA))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("family") / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1",
               **shared_jax_env(out.parent))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_") and k[len(tag) + 1:].isdigit()])
    return [ref[f"{tag}_{i}"] for i in range(n)]


def _penalty_slopes(linvel, qd):
    """[2, B]: d(penalty)/d(velocity) of the object and joint velocity
    penalties at these velocities (0 where a penalty is off or clipped)."""
    out = []
    for v, thr, name in ((np.linalg.norm(linvel, axis=-1).sum(-1), 0.25, PENALTY_NAMES[0]),
                         (np.abs(qd[:, :6]).max(-1), 0.5, PENALTY_NAMES[1])):
        g = np.exp(v - thr)
        out.append(np.where((v > thr) & (g - 1.0 < 10.0), PENALTIES[name] * g, 0.0))
    return np.stack(out)


@pytest.mark.parametrize("task", TASKS)
def test_family_env_step_matches(ref, task):
    """One env step of the task from the same state and actions at B = 8,
    every reward term exercised. Tolerances as tests/test_torch_lift.py:
    2e-4 on positions, 2e-3 on velocities and impulses, 1e-4 on the
    observations of the pre-step state, 2e-3 on the post-step ones; rewards
    2e-3 absolute plus 1e-4 relative, each term's batch mean likewise; done
    exact. Each penalty term must be non-zero somewhere.

    The box's angular velocity also gets 1e-3 of its largest value: the
    fingers spin
    it to 10-20 rad/s, and its inverse inertia (up to 1.1e4 per kg m^2
    about its long axis) turns the impulses' float32 disagreement (under
    1e-5 N s, measured) at lever arms up to 0.06 m into up to 6e-3 rad/s
    per sim step; measured 4.6e-4 of the largest angular velocity. The
    rewards' absolute tolerance adds, per env, the velocity tolerance
    (2e-3) times the slope of the object and joint velocity penalties at
    the JAX state, scale * exp(v - threshold) where unclipped: the penalty
    passes a velocity's rounding on multiplied by up to ~16 here."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.hand_arm import ObsContext
    from handarm_tpu_torch.envs.tasks import make_env

    env = make_env(task, device="cpu", num_envs=B, reward=_task_reward(task))
    assert [env.num_obs, env.num_actions, env.scene.slots.num_slots] == \
        ref[f"{task}_sizes"].tolist()
    state = env_state_from_leaves(_leaves(ref, f"{task}_pre"))
    obs = env._compute_obs(ObsContext(env, state))
    np.testing.assert_allclose(obs.numpy(), ref[f"{task}_obs_pre"], atol=1e-4, rtol=1e-4)
    post, res = env.step(state, torch.as_tensor(ref[f"{task}_actions"], dtype=torch.float32))
    np.testing.assert_array_equal(res.done.numpy(), ref[f"{task}_done"])
    assert not res.done.any()
    want = _leaves(ref, f"{task}_post")
    got = post.physics
    for name, g, w, tol in (
        ("q", got.robot.q, want[0], 2e-4), ("qd", got.robot.qd, want[1], 2e-3),
        ("targets", got.robot.targets, want[2], 2e-4),
        ("obj pos", got.objects.pos, want[3], 2e-4),
        ("obj quat", got.objects.quat, want[4], 2e-4),
        ("obj linvel", got.objects.linvel, want[5], 2e-3),
        ("obj angvel", got.objects.angvel, want[6], 2e-3),
        ("impulse", got.contact_impulse, want[7], 2e-3),
    ):
        if name == "obj angvel":
            tol += 1e-3 * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
    np.testing.assert_allclose(post.task.goal_quat.numpy(), want[13], atol=1e-6)
    np.testing.assert_allclose(res.obs.numpy(), ref[f"{task}_obs"], atol=2e-3)
    slope = _penalty_slopes(want[5], want[1])
    err = np.abs(res.reward.numpy() - ref[f"{task}_reward"])
    allowed = 2e-3 + slope.sum(0) * 2e-3 + 1e-4 * np.abs(ref[f"{task}_reward"])
    assert np.all(err <= allowed), f"reward errors {err} over {allowed}"
    for term in env.cfg.reward:
        want_t = ref[f"{task}_term_{term}"]
        got_t = float(res.info[f"reward_terms/{term}"])
        s = slope[PENALTY_NAMES.index(term)].mean() if term in PENALTY_NAMES[:2] else 0.0
        np.testing.assert_allclose(got_t, want_t, atol=2e-3 + s * 2e-3, rtol=1e-4,
                                   err_msg=term)
        if term in PENALTIES:
            assert want_t < 0 and got_t < 0, (term, want_t, got_t)
    print(task, {t: float(res.info[f"reward_terms/{t}"]) for t in env.cfg.reward})


def test_new_observables_and_actionables_match(ref):
    """Every observable the port registers, by name, on the same state of a
    two-object oriented_reposition env (1e-4: float32 FK of 17 joints in
    another order; the static ones exact to 1e-6), and the control state
    after one step through ur5_relative_joint_pos, sih_absolute_servo_pos
    and sih_relative_servo_pos (1e-4 of servo ticks, which run to ~1000)."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.hand_arm import ObsContext
    from handarm_tpu_torch.envs.tasks import make_env

    env = make_env("Ur5SihReposition", device="cpu", num_envs=B, goal="oriented_reposition",
                   observations=PROBE_OBS, actions=PROBE_ACTIONS, objects=PROBE_OBJECTS)
    # every observable but the point clouds and target_object_interval_pos,
    # which tests/test_torch_pointcloud.py holds
    clouds = {"object_synthetic_pointcloud", "target_object_synthetic_pointcloud",
              "target_object_interval_pos", "target_object_synthetic_interval_pointcloud",
              "ur5sih_synthetic_pointcloud", "goal_synthetic_pointcloud",
              "scene_synthetic_pointcloud"}
    assert sorted(set(env.registry.observables) - clouds) == sorted(PROBE_OBS)
    assert clouds <= set(env.registry.observables)
    state = env_state_from_leaves(_leaves(ref, "probe_pre"))
    ctx = ObsContext(env, state)
    for name in PROBE_OBS:
        got = env.registry.observables[name].fn(ctx).numpy()
        a, b = env.obs_slices[name]
        assert b - a == got.shape[1], name
        np.testing.assert_allclose(got, ref[f"probe_obs_{name}"], atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    post, _ = env.step(state, torch.as_tensor(ref["probe_actions"], dtype=torch.float32))
    control = torch.cat(list(post.control), -1).numpy()
    np.testing.assert_allclose(control, ref["probe_control"], rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("task", ("Ur5SihOrientedReposition", "Ur5SihRepose"))
def test_goal_quat_draw_matches(ref, task):
    """The orientation goals' draw: qx(u0 pi) qy(u1 pi) of the JAX package's
    own uniform draw u, within float32 rounding (1e-6)."""
    from handarm_tpu_torch.envs.hand_arm import goal_quat_from_uniform

    q = goal_quat_from_uniform(torch.as_tensor(ref[f"{task}_u"]))
    np.testing.assert_allclose(q.numpy(), ref[f"{task}_goal_quat"], atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(q.numpy(), axis=-1), 1.0, atol=1e-6)


def test_balanced_target_sampling_matches(ref):
    """Weights 1 - per-object EWMA + 0.15, drawn categorically: the port's
    and the JAX package's frequencies over 10^5 draws each lie within 5
    binomial standard errors of the normalized weights (the generators
    differ); with the flag off, or one object, the draw is uniform."""
    from handarm_tpu_torch.envs.hand_arm import HandArmEnv, target_weights

    ewma = torch.tensor(BALANCED_EWMA)
    w = target_weights(ewma)
    np.testing.assert_allclose(w.numpy(), 1.15 - np.asarray(BALANCED_EWMA), rtol=1e-6)
    p = (w / w.sum()).numpy()
    se = np.sqrt(p * (1 - p) / DRAWS)

    def env(balanced, K):
        return SimpleNamespace(num_objects=K, cfg=SimpleNamespace(balanced_target_sampling=balanced),
                               gen=torch.Generator().manual_seed(0), device=torch.device("cpu"))

    draws = HandArmEnv.sample_target(env(True, 3), DRAWS, ewma)
    freq = np.bincount(draws.numpy(), minlength=3) / DRAWS
    jfreq = ref["balanced_counts"] / DRAWS
    print("weights", p, "port", freq, "jax", jfreq)
    assert np.all(np.abs(freq - p) < 5 * se) and np.all(np.abs(jfreq - p) < 5 * se)
    uniform = HandArmEnv.sample_target(env(False, 3), DRAWS, ewma)
    assert np.all(np.abs(np.bincount(uniform.numpy(), minlength=3) / DRAWS - 1 / 3) < 0.01)
    assert int(HandArmEnv.sample_target(env(True, 1), 50, ewma[:1]).max()) == 0


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
