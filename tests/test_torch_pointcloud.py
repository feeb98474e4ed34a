"""The port's synthetic point clouds against the JAX package: every
function of `envs/pointcloud.py` (and `sphere_points`) on inputs from a
numpy seed, with `subsample_pad` given the JAX package's own uniform
scores; and one Ur5SihLift env step at B = 8 observing all seven cloud
observables, with the teacher observations, from a transferred state.

The env's JAX side runs in a subprocess with HANDARM_ASSET_ROOT at the
in-repo stand-in robot (this file run as a script), as
tests/test_torch_family.py does. It resets, sets the episode clocks to
0..7 (no env times out; after the step, clocks 4 and 8 show the interval
observables), observes that state, steps it with actions from a numpy
seed, and writes the states, the observations by key, the teacher
observations, their slices and the subsampling scores its observation
keys give: for a step, k_obs = split(split(task.key, 4)[0])[1], for
`observe`, fold_in(task.key, 3), uniform over [B, P] for each padded point
count P. The port runs both from the same state with those scores.
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
B = 8
CLOUDS = ("object_synthetic_pointcloud", "target_object_synthetic_pointcloud",
          "target_object_synthetic_interval_pointcloud", "ur5sih_synthetic_pointcloud",
          "goal_synthetic_pointcloud", "scene_synthetic_pointcloud")
OBSERVATIONS = ("ur5_joint_pos", "ur5_flange_pose", "dof_position_targets",
                "target_object_interval_pos", "target_object_to_goal_pos") + CLOUDS


def _jax_pc():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from handarm_tpu.envs import pointcloud as jpc

    return jax, jpc


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_pad_cloud_and_area_counts_match():
    """pad_cloud (points and mask) and area_sample_counts: numpy on both
    sides, exact."""
    _, jpc = _jax_pc()
    from handarm_tpu_torch.envs import pointcloud as pc

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(20, 3))
    for n in (10, 20, 32):
        for a, b in zip(pc.pad_cloud(pts, n), jpc.pad_cloud(pts, n)):
            np.testing.assert_array_equal(a, b)
    areas = rng.uniform(0.001, 0.2, 7)
    for avg in (1, 100, 1500):
        np.testing.assert_array_equal(pc.area_sample_counts(areas, avg),
                                      jpc.area_sample_counts(areas, avg))


@pytest.mark.parametrize("batched", (False, True), ids=("body-frame", "per-env"))
def test_transform_cloud_matches(batched):
    """A [P, 3] (or [B, P, 3]) cloud with a padding mask, rotated and moved
    per env, with the type channel: within 1e-6 (float32 rotations of
    sub-metre points); padding rows exactly zero."""
    jax, jpc = _jax_pc()
    import jax.numpy as jnp

    from handarm_tpu_torch.envs import pointcloud as pc

    rng = np.random.default_rng(1)
    P = 14
    pts = rng.uniform(-0.05, 0.05, (B, P, 3) if batched else (P, 3))
    mask = (rng.uniform(size=(B, P) if batched else P) < 0.7).astype(np.float64)
    quat, pos = _unit_quats(rng, B), rng.uniform(-1, 1, (B, 3))
    f = lambda x: jnp.asarray(x, jnp.float32)
    want = np.asarray(jpc.transform_cloud(f(pts), f(mask), f(quat), f(pos), jpc.TARGET))
    got = pc.transform_cloud(_t(pts), _t(mask), _t(quat), _t(pos), pc.TARGET).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    m = np.broadcast_to(mask, (B, P))
    assert np.all(got[m == 0] == 0) and np.all(got[m > 0][:, 3] == pc.TARGET)


def test_merge_flatten_relative_frame_match():
    """merge_clouds and flatten_cloud exact; to_relative_frame within 1e-6,
    padding rows zero."""
    jax, jpc = _jax_pc()
    import jax.numpy as jnp

    from handarm_tpu_torch.envs import pointcloud as pc

    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (B, 5, 4)).astype(np.float32)
    b = rng.uniform(-1, 1, (B, 3, 4)).astype(np.float32)
    a[:, :2, 3] = 0.0  # padding rows: type 0
    a[:, :2, :3] = 0.0
    want = np.asarray(jpc.merge_clouds(jnp.asarray(a), jnp.asarray(b)))
    got = pc.merge_clouds(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pc.flatten_cloud(got).numpy(),
                                  np.asarray(jpc.flatten_cloud(jnp.asarray(want))))
    quat, pos = _unit_quats(rng, B).astype(np.float32), rng.uniform(-1, 1, (B, 3))
    want = np.asarray(jpc.to_relative_frame(jnp.asarray(want), jnp.asarray(quat),
                                            jnp.asarray(pos, jnp.float32)))
    got = pc.to_relative_frame(got, torch.as_tensor(quat), _t(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(got[:, :2] == 0)


@pytest.mark.parametrize("P", (14, 128, 129, 300))
def test_subsample_pad_matches(P):
    """With the JAX package's own uniform draw of its key (over the cloud
    padded to 128 points), the same rows in the same order: exact. Clouds
    of 14 (the lift box, padded), 128, 129 (the stand-in robot) and 300
    points, some rows padding."""
    jax, jpc = _jax_pc()
    import jax.numpy as jnp

    from handarm_tpu_torch.envs import pointcloud as pc

    rng = np.random.default_rng(P)
    cloud = rng.uniform(-1, 1, (B, P, 4)).astype(np.float32)
    cloud[..., 3] = rng.integers(1, 4, (B, P))
    pad = rng.uniform(size=(B, P)) < 0.2
    cloud[pad] = 0.0
    key = jax.random.PRNGKey(P)
    want = np.asarray(jpc.subsample_pad(jnp.asarray(cloud), key, 128))
    n = pc.padded_points(P, 128)
    scores = torch.as_tensor(np.array(jax.random.uniform(key, (B, n))))
    got = pc.subsample_pad(torch.as_tensor(cloud), scores, 128).numpy()
    assert got.shape == (B, 128, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal((got[..., 3] > 0).sum(1),
                                  np.minimum((cloud[..., 3] > 0).sum(1), 128))


def test_interval_sample_and_sphere_points_match():
    """interval_sample exact on 1-d and 3-d values over clocks 0..11;
    sphere_points (the goal cloud: radius 0.02, 16 points) exact."""
    jax, jpc = _jax_pc()
    import jax.numpy as jnp

    from handarm_tpu.physics.shapes import sphere_points as jsphere
    from handarm_tpu_torch.envs import pointcloud as pc
    from handarm_tpu_torch.physics.shapes import sphere_points

    rng = np.random.default_rng(3)
    progress = np.arange(12)
    for shape in ((12, 3), (12, 5, 4)):
        v = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jpc.interval_sample(jnp.asarray(v), jnp.asarray(progress), 4))
        got = pc.interval_sample(torch.as_tensor(v), torch.as_tensor(progress), 4).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sphere_points(0.02, 16), jsphere(0.02, 16))


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.robots.ur5sih import ASSET_ROOT

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    teacher, _ = make_env("Ur5SihLift", [f"num_envs={B}"])
    env, _ = make_env("Ur5SihLift", [
        f"num_envs={B}", f"observations={json.dumps(OBSERVATIONS)}",
        f"teacher_observations={json.dumps(teacher.cfg.observations)}"])
    state, _ = env.reset(jax.random.PRNGKey(7))
    state = state._replace(task=state.task._replace(
        progress=jnp.arange(B, dtype=state.task.progress.dtype)))
    counts = sorted({128, max(128, len(env.robot_cloud_offsets))})
    out = {"counts": np.asarray(counts),
           "slices": np.asarray([env.teacher_obs_slices[n] for n in teacher.cfg.observations]),
           "sizes": np.asarray([env.num_obs, env.num_teacher_obs, env.num_actions])}
    obs, tobs, od = env.observe(state)
    k_obs = jax.random.fold_in(state.task.key, 3)
    out.update(observe_obs=np.asarray(obs), observe_teacher=np.asarray(tobs))
    for P in counts:
        out[f"observe_scores_{P}"] = np.asarray(jax.random.uniform(k_obs, (B, P)))
    for k, v in od.items():
        out[f"observe_dict_{k}"] = np.asarray(v)
    actions = np.random.default_rng(4).uniform(-1, 1, (B, env.num_actions))
    post, res = jax.jit(env.step)(state, jnp.asarray(actions, jnp.float32))
    k0 = jax.random.split(state.task.key, 4)[0]
    k_obs = jax.random.split(k0)[1]
    for P in counts:
        out[f"step_scores_{P}"] = np.asarray(jax.random.uniform(k_obs, (B, P)))
    out.update(actions=actions, obs=np.asarray(res.obs), teacher=np.asarray(res.teacher_obs),
               done=np.asarray(res.done), progress=np.asarray(post.task.progress))
    for k, v in res.obs_dict.items():
        out[f"dict_{k}"] = np.asarray(v)
    for i, leaf in enumerate(jax.tree.leaves(state)):
        out[f"pre_{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("clouds") / "ref.npz"
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


def _port_env():
    from handarm_tpu_torch.envs.tasks import make_env

    teacher_obs = make_env("Ur5SihLift", device="cpu", num_envs=B).cfg.observations
    return make_env("Ur5SihLift", device="cpu", num_envs=B, observations=OBSERVATIONS,
                    teacher_observations=teacher_obs)


def _scores(ref, tag):
    return {int(P): torch.as_tensor(ref[f"{tag}_scores_{P}"]) for P in ref["counts"]}


def _check_dict(got: dict, ref, tag: str, atol: float):
    assert sorted(got) == sorted(CLOUDS)
    for k in CLOUDS:
        g, w = got[k].numpy(), ref[f"{tag}_{k}"]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g[..., 3], w[..., 3], err_msg=f"{k} types")
        np.testing.assert_allclose(g[..., :3], w[..., :3], atol=atol, err_msg=k)


def test_clouds_and_teacher_obs_of_a_state_match(ref):
    """`observe` of the transferred state: the flat and teacher vectors and
    every cloud by key, with the JAX package's scores. Types and the
    choice and order of rows exact; xyz within 1e-5 (float32 FK of 17
    joints and quaternion rotations in another order, at metre scale); the
    vectors within 1e-4 (tests/test_torch_family.py's bound on the
    observations of a state). The box's target cloud has 14 valid rows;
    the interval cloud is blank where the clock is not a multiple of 4."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import env_state_from_leaves

    env = _port_env()
    assert [env.num_obs, env.num_teacher_obs, env.num_actions] == ref["sizes"].tolist()
    assert [env.teacher_obs_slices[n] for n in env.cfg.teacher_observations] == \
        [tuple(s) for s in ref["slices"].tolist()]
    state = env_state_from_leaves(_leaves(ref, "pre"))
    obs, teacher, od = env.observe(state, _scores(ref, "observe"))
    np.testing.assert_allclose(obs.numpy(), ref["observe_obs"], atol=1e-4)
    np.testing.assert_allclose(teacher.numpy(), ref["observe_teacher"], atol=1e-4)
    _check_dict(od, ref, "observe_dict", 1e-5)
    target = od["target_object_synthetic_pointcloud"].numpy()
    assert np.all((target[..., 3] > 0).sum(1) == 14)
    blank = (state.task.progress.numpy() % 4) != 0
    assert np.all(od["target_object_synthetic_interval_pointcloud"].numpy()[blank] == 0)


def test_env_step_clouds_and_teacher_obs_match(ref):
    """One env step with the JAX package's actions and subsampling scores:
    every cloud of the post-step state by key, the flat and teacher
    observations. Types and row order exact; xyz and both vectors within
    2e-3 (the env-step bound on observations of tests/test_torch_lift.py:
    positions after the physics agree to 2e-4); no env resets."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import env_state_from_leaves

    env = _port_env()
    state = env_state_from_leaves(_leaves(ref, "pre"))
    post, res = env.step(state, torch.as_tensor(ref["actions"], dtype=torch.float32),
                         _scores(ref, "step"))
    np.testing.assert_array_equal(res.done.numpy(), ref["done"])
    assert not res.done.any()
    np.testing.assert_array_equal(post.task.progress.numpy(), ref["progress"])
    np.testing.assert_allclose(res.obs.numpy(), ref["obs"], atol=2e-3)
    np.testing.assert_allclose(res.teacher_obs.numpy(), ref["teacher"], atol=2e-3)
    _check_dict(res.obs_dict, ref, "dict", 2e-3)
    shown = (post.task.progress.numpy() % 4) == 0
    assert shown.any() and (~shown).any()


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
