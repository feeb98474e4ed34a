"""The port's Stretch tasks against the JAX package, on the in-repo Stretch
stand-in: StretchLift and StretchMultiObjectManipulation at B = 8.

The JAX package reads its asset root when its robot modules are imported,
so its side runs once in a subprocess (this file run as a script,
HANDARM_ASSET_ROOT at the stand-in). For each task it builds the env as
the registry composes it, with float32 solver prep (`OVERRIDES`), resets
it, zeroes every episode clock, brings the gripper around the target
object with a scripted controller that reads only the observations (the
grasp center's and the target's positions) for 200 control steps, zeroes
the clocks again (no env resets in the compared steps) and takes 2 control
steps with actions from a numpy seed. It writes the reset state and observations, the states and
observations before and after each compared step, the rewards, and the
deepest robot-table penetration at reset of both collision sets, to an
npz. The port takes the same reset and pre-step states (converted leaf by
leaf) and the same actions.
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
TASKS = ("StretchLift", "StretchMultiObjectManipulation")
B = 8
WARM_STEPS = 200
SIZES = {"StretchLift": (100, 63, 5, 1), "StretchMultiObjectManipulation": (116, 76, 5, 2)}
# float32 solver prep on both sides: with the composed bf16 prep the two
# frameworks round the effective-mass chain to neighbouring bf16 values,
# and a finger pressed between the box and the table amplifies that
# (measured: a finger's qd 1.1e-2 apart after 2 steps at bf16, 9.5e-5 at
# f32); the bf16 prep itself is held by tests/test_torch_physics.py
OVERRIDES = [f"num_envs={B}", "solver_prep_dtype=f32"]
STRETCH_OBS = {"stretch_joint_pos": (0, 9), "stretch_flange_pose": (9, 16),
               "stretch_fingertip_pos": (16, 22), "stretch_fingertip_linvel": (22, 28)}


def scripted_actions(obs: np.ndarray, K: int) -> np.ndarray:
    """Bring the grasp center over the target object and down to 2 cm above
    its center (the open fingertips clear of the table): the mast moves it
    along world -x, the arm along world +y (the mount is yawed by pi), the
    lift down; then close the fingers."""
    grasp = obs[:, 9:12]
    target = obs[:, 37 + 13 * K:40 + 13 * K]  # the target's bounding-box center
    d = target - grasp
    a = np.zeros((obs.shape[0], 5), np.float32)
    a[:, 0] = np.clip(-20.0 * d[:, 0], -1, 1)
    a[:, 2] = np.clip(20.0 * d[:, 1], -1, 1)
    over = (np.abs(d[:, 0]) < 0.04) & (np.abs(d[:, 1]) < 0.04)
    a[:, 1] = np.where(over & (d[:, 2] < -0.02), -1.0, 0.0)  # stop 2 cm above
    a[:, 4] = np.where(d[:, 2] > -0.03, -1.0, 0.0)
    return a


def table_depth(fk_pos, fk_quat, spheres, table_height, rotate):
    """Deepest sphere bottom below the table top at one pose (negative:
    clear of the table)."""
    body = np.asarray(spheres.body)
    c = fk_pos[0, body] + rotate(fk_quat[0, body], spheres.offset)
    return float((table_height - (c[:, 2] - spheres.radius)).max())


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.math.quat import quat_rotate
    from handarm_tpu.physics.kinematics import forward_kinematics
    from handarm_tpu.robots.ur5sih import ASSET_ROOT

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    out = {}
    zero_clocks = lambda s: s._replace(task=s.task._replace(
        progress=jnp.zeros_like(s.task.progress)))
    for task in TASKS:
        env, _ = make_env(task, OVERRIDES)
        K = env.cfg_num_objects
        out[f"{task}_sizes"] = np.asarray([env.scene.slots.num_slots, env.num_obs,
                                           env.num_actions, K])
        state, _ = jax.jit(env.reset)(jax.random.PRNGKey(3))
        out[f"{task}_reset_obs"] = np.asarray(env.observe(state)[0])
        for i, leaf in enumerate(jax.tree.leaves(state)):
            out[f"{task}_reset_{i}"] = np.asarray(leaf)
        state = zero_clocks(state)
        step = jax.jit(env.step)
        obs = np.asarray(env.observe(state)[0])
        for _ in range(WARM_STEPS):
            state, res = step(state, jnp.asarray(scripted_actions(obs, K)))
            obs = np.asarray(res.obs)
        state = zero_clocks(state)
        actions = np.random.default_rng(0).uniform(-1, 1, (2, B, 5)).astype(np.float32)
        out[f"{task}_actions"] = actions
        for k in range(3):
            for i, leaf in enumerate(jax.tree.leaves(state)):
                out[f"{task}_step{k}_{i}"] = np.asarray(leaf)
            if k == 2:
                break
            state, res = step(state, jnp.asarray(actions[k]))
            out[f"{task}_obs{k}"] = np.asarray(res.obs)
            out[f"{task}_reward{k}"] = np.asarray(res.reward)
            out[f"{task}_done{k}"] = np.asarray(res.done)
    for hand_only in (True, False):
        env, _ = make_env("StretchLift", ["num_envs=1",
                                          f"hand_only_collision={str(hand_only).lower()}"])
        sc = env.scene
        fk = forward_kinematics(sc.model, env.reset_q[None], sc.base_quat[None],
                                sc.base_pos[None])
        out[f"depth_{hand_only}"] = np.asarray(table_depth(
            fk.body_pos, fk.body_quat, sc.spheres, env.cfg.table_height,
            lambda q, v: quat_rotate(q, jnp.broadcast_to(v, q.shape[:-1] + (3,)))))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("stretch_env") / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               **shared_jax_env(out.parent))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_") and k[len(tag) + 1:].isdigit()])
    return [ref[f"{tag}_{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def envs():
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.registry import compose_task

    return {task: compose_task(task, OVERRIDES, device="cpu")[0] for task in TASKS}


def _state(ref, tag, env):
    from handarm_tpu_torch.convert import env_state_from_leaves

    return env_state_from_leaves(_leaves(ref, tag), env_cfg=env.cfg)


@pytest.mark.parametrize("task", TASKS)
def test_reset_matches(ref, envs, task):
    """Scene sizes (contact slots: 14 box points against the table and the
    bin's walls, 24 hand spheres against the table, the objects and the
    walls; observations; the grouped action), the reset's deterministic
    part (joints, targets and control at the reset pose, no velocity or
    impulse, objects resting on the table) and the observations of the
    JAX package's reset state: the four Stretch observables within 1e-6,
    all within 1e-5."""
    from handarm_tpu_torch.envs.hand_arm import ObsContext

    env = envs[task]
    C, n_obs, n_act, K = SIZES[task]
    assert tuple(ref[f"{task}_sizes"]) == SIZES[task]
    assert (env.scene.slots.num_slots, env.num_obs, env.num_actions, env.num_objects) == \
        (C, n_obs, n_act, K)
    want = _state(ref, f"{task}_reset", env)
    fresh = env.fresh_state(B)
    for name, g, w in (("q", fresh.physics.robot.q, want.physics.robot.q),
                       ("qd", fresh.physics.robot.qd, want.physics.robot.qd),
                       ("targets", fresh.physics.robot.targets, want.physics.robot.targets),
                       ("control", fresh.control.joint_target, want.control.joint_target),
                       ("impulse", fresh.physics.contact_impulse, want.physics.contact_impulse),
                       ("object z", fresh.physics.objects.pos[..., 2],
                        want.physics.objects.pos[..., 2])):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    obs = env._compute_obs(ObsContext(env, want)).numpy()
    wobs = ref[f"{task}_reset_obs"]
    for name, (lo, hi) in STRETCH_OBS.items():
        np.testing.assert_allclose(obs[:, lo:hi], wobs[:, lo:hi], atol=1e-6, err_msg=name)
    np.testing.assert_allclose(obs, wobs, atol=1e-5)


def test_yawed_mount_world_poses(ref, envs):
    """The mount at (0.2, 0.175) on the table, yawed by pi: at the reset pose
    the grasp center lies at (0.28, 0.475, 0.96) in the world, above the
    bin, and the two fingertips straddle it along x, 0.82 m above the
    table's origin plane; the JAX package's observations agree."""
    from handarm_tpu_torch.envs.hand_arm import ObsContext

    env = envs["StretchLift"]
    ctx = ObsContext(env, _state(ref, "StretchLift_reset", env))
    grasp = ctx.flange[1][:, 0].numpy()
    tips = ctx.fingertips[1].numpy()
    np.testing.assert_allclose(grasp, np.tile([0.28, 0.475, 0.96], (B, 1)), atol=1e-5)
    np.testing.assert_allclose(tips[:, :, 1:], np.tile([0.475, 0.93394554], (B, 2, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(tips[:, :, 0].mean(1), 0.28, atol=1e-5)
    assert np.all(tips[:, 1, 0] - tips[:, 0, 0] > 0.15)  # open fingers
    wobs = ref["StretchLift_reset_obs"]
    np.testing.assert_allclose(tips.reshape(B, 6), wobs[:, 16:22], atol=1e-6)
    np.testing.assert_allclose(grasp, wobs[:, 9:12], atol=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_two_control_steps_match(ref, envs, task):
    """2 control steps (3 sim steps x 2 anchored substeps x 8 sweeps)
    from the JAX package's state with the gripper closing on the target
    object, the same actions: q and positions within 2e-4,
    velocities and impulses within 2e-3 (tests/test_torch_lift.py's
    bounds), observations within 2e-3, rewards within 2e-3; no env resets.
    The hand pushes in the compared steps (a robot-object slot carries an
    impulse)."""
    from tests.test_torch_dr import check_physics

    env = envs[task]
    state = _state(ref, f"{task}_step0", env)
    slots = env.scene.slots
    robot_obj = torch.as_tensor((slots.robot_body >= 0) & (slots.obj_b >= 0))
    pushed = 0.0
    for k in range(2):
        state, res = env.step(state, torch.as_tensor(ref[f"{task}_actions"][k]))
        assert not ref[f"{task}_done{k}"].any() and not res.done.any()
        check_physics(state.physics, _leaves(ref, f"{task}_step{k + 1}"))
        np.testing.assert_allclose(state.control.joint_target.numpy(),
                                   _leaves(ref, f"{task}_step{k + 1}")[8], atol=2e-4)
        np.testing.assert_allclose(res.obs.numpy(), ref[f"{task}_obs{k}"], atol=2e-3)
        np.testing.assert_allclose(res.reward.numpy(), ref[f"{task}_reward{k}"], atol=2e-3)
        pushed = max(pushed, float(state.physics.contact_impulse[:, robot_obj].abs().max()))
    print(f"{task}: largest robot-object impulse in the compared steps {pushed:.3e}")
    assert pushed > 1e-4


def test_standin_table_depth_matches(ref):
    """The deepest robot-table penetration at the reset pose, hand-only (24
    spheres) and with the arm's (36), equal in both packages and clear of
    the table by more than a centimetre."""
    from handarm_tpu_torch.envs.registry import compose_task
    from handarm_tpu_torch.math.quat import quat_rotate
    from handarm_tpu_torch.physics.kinematics import forward_kinematics

    for hand_only in (True, False):
        env, _ = compose_task("StretchLift", ["num_envs=1",
                                              f"hand_only_collision={str(hand_only).lower()}"],
                              device="cpu")
        sc = env.scene
        fk = forward_kinematics(sc.model, env.reset_q[None], sc.base_quat[None],
                                sc.base_pos[None])
        depth = table_depth(fk.body_pos, fk.body_quat, sc.spheres, env.cfg.table_height,
                            lambda q, v: quat_rotate(q, v.expand(q.shape[:-1] + (3,))))
        print(f"hand_only_collision={hand_only}: deepest robot-table penetration at reset "
              f"{depth:.4f} m (JAX {float(ref[f'depth_{hand_only}']):.4f} m)")
        assert depth == pytest.approx(float(ref[f"depth_{hand_only}"]), abs=1e-6)
        assert depth < -0.01


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
