"""The cameras in the env against the JAX package: Ur5SihLift (this file)
and Ur5SihMultiObjectManipulation (tests/test_torch_camera_multiobj.py)
at B = 4 with the topview camera (`CameraConfig()`) and its five
observables, and the `CameraRecorder`'s frames.

The JAX side runs in a subprocess (this file run as a script) with
HANDARM_ASSET_ROOT at the in-repo stand-in, as
tests/test_torch_pointcloud.py does. It resets, observes the reset state
and takes 2 control steps with actions from a numpy seed, and writes each
of the three states, the camera observables JAX gives for it (`observe`
for the reset, the step's `obs_dict` after a step), the subsampling scores
of its observation keys (for `observe` fold_in(task.key, 3), for a step
split(split(task.key, 4)[0])[1]; uniform over [B, P] at the scene's padded
point count), the pixel coordinates of every scene point, the flat
observations and `scene_point_rgb`; then a `CameraRecorder` of a B = 2 env
(envs 0 and 1 of the three states) writes its buffered frames and, flushed,
its files.

The port computes the observables of each transferred state with the same
scores and is held at tests/test_torch_camera.py's tolerances and pixel
rule (depth 1e-6; segmentation, color and visibility exact outside the
points within 1e-4 px of a pixel edge; the reset's color, which the JAX
package renders eagerly, in its 8-bit values: see
tests/test_torch_camera.py `eight_bit`); the clouds, which depend on every
point's visibility, exactly in types and within 1e-5 in xyz in each env
the pixel rule leaves whole.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_camera import eight_bit, excluded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
B = 4
STEPS = 2
IMAGES = ("topview_depth", "topview_segmentation", "topview_color")
CLOUDS = ("topview_pointcloud", "topview_target_object_pointcloud")
CAMERA_OBS = IMAGES + CLOUDS
TAGS = ("reset",) + tuple(f"step{t + 1}" for t in range(STEPS))


def jax_reference(out_path: str, task: str, env_overrides: list, pool_seed=None,
                  record_dir: str | None = None) -> None:
    """The JAX side (see the module docstring); `pool_seed` makes a one-pose
    genesis pool from the package's spawn poses, `record_dir` runs the
    recorder."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.camera import CameraConfig, render_points
    from handarm_tpu.envs.genesis import InitialPool
    from handarm_tpu.envs.hand_arm import HandArmEnv, ObsContext
    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.robots.ur5sih import ASSET_ROOT

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    base, _ = make_env(task, [f"num_envs={B}"] + env_overrides)
    cfg = dataclasses.replace(base.cfg, cameras=(CameraConfig(),),
                              observations=base.cfg.observations + CAMERA_OBS)
    env = HandArmEnv(cfg)
    out = {"num_obs": np.asarray([base.num_obs, env.num_obs]),
           "scene_point_rgb": np.asarray(env.scene_point_rgb)}
    if pool_seed is not None:
        pos, quat = env._sample_object_poses(jax.random.PRNGKey(pool_seed), B)
        env.initial_pool = InitialPool(pos=pos[None], quat=quat[None])
        out.update(pool_pos=np.asarray(pos), pool_quat=np.asarray(quat))
    state, _ = env.reset(jax.random.PRNGKey(7))
    n_points = int(env._camera_scene_points(ObsContext(env, state, None))[0].shape[1])
    P = max(n_points, cfg.pointcloud_max_points)
    out["padded_points"] = np.asarray(P)
    step = jax.jit(env.step)
    rng = np.random.default_rng(4)
    states = []
    for tag in TAGS:
        if tag == "reset":
            obs, _, od = env.observe(state)
            k_obs = jax.random.fold_in(state.task.key, 3)
        else:
            k_obs = jax.random.split(jax.random.split(state.task.key, 4)[0])[1]
            actions = rng.uniform(-1, 1, (B, env.num_actions))
            state, res = step(state, jnp.asarray(actions, jnp.float32))
            obs, od = res.obs, res.obs_dict
            out[f"{tag}_actions"] = actions
            out[f"{tag}_done"] = np.asarray(res.done)
        states.append(state)
        out[f"{tag}_scores"] = np.asarray(jax.random.uniform(k_obs, (B, P)))
        out[f"{tag}_obs"] = np.asarray(obs)
        for k in CAMERA_OBS:
            out[f"{tag}_{k}"] = np.asarray(od[k])
        pts, segs, types = env._camera_scene_points(ObsContext(env, state, None))
        r = render_points(cfg.cameras[0], pts, segs.astype(jnp.int32), valid=segs)
        out[f"{tag}_uvz"] = np.asarray(r.points_uvz)
        out[f"{tag}_scene_points"] = np.asarray(pts)
        out[f"{tag}_scene_segs"] = np.asarray(segs)
        out[f"{tag}_scene_types"] = np.asarray(types)
        for i, leaf in enumerate(jax.tree.leaves(state)):
            out[f"{tag}_state_{i}"] = np.asarray(leaf)
    if record_dir is not None:
        from handarm_tpu.utils.visualization import CameraRecorder

        env2 = HandArmEnv(dataclasses.replace(cfg, num_envs=2))
        rec = CameraRecorder(env2, record_dir, env_ids=(0, 1))
        for st in states:
            rec.add(jax.tree.map(lambda x: x[:2] if x.ndim and x.shape[0] == B else x, st))
        for typ in ("depth", "segmentation", "color"):
            out[f"frames_{typ}"] = np.asarray(rec.frames["topview"][typ][0]
                                              + rec.frames["topview"][typ][1])
        written = rec.flush(0) + rec.flush(1)
        out["written"] = np.asarray([os.path.basename(p) for p in written])
    np.savez(out_path, **out)


def run_reference(tmp, script: str, env_extra: dict | None = None, timeout: int = 900) -> dict:
    out = tmp / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1", JAX_COMPILATION_CACHE_DIR=str(tmp / "jax_cache"),
               PYTHONPATH=REPO, **(env_extra or {}))
    res = subprocess.run([sys.executable, script, str(out), str(tmp)], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("camera_lift"), __file__)


def state_of(ref, tag):
    from handarm_tpu_torch.convert import env_state_from_leaves

    n = len([k for k in ref if k.startswith(f"{tag}_state_")])
    return env_state_from_leaves([ref[f"{tag}_state_{i}"] for i in range(n)])


def port_env(task: str, **overrides):
    from handarm_tpu_torch.envs.camera import CameraConfig
    from handarm_tpu_torch.envs.tasks import make_env

    base = make_env(task, device="cpu", num_envs=B, **overrides)
    env = make_env(task, device="cpu", num_envs=B, cameras=(CameraConfig(),),
                   observations=base.cfg.observations + CAMERA_OBS, **overrides)
    return base, env


def check_camera_observables(ref, env, tag: str) -> dict:
    """The port's five observables of the transferred state `tag` against
    the JAX package's; returns what the check left out."""
    from handarm_tpu_torch.envs.hand_arm import ObsContext

    state = state_of(ref, tag)
    P = int(ref["padded_points"])
    scores = {P: torch.as_tensor(ref[f"{tag}_scores"])}
    ctx = ObsContext(env, state, None, scores)
    pts, segs, types = ctx.camera_scene_points()
    np.testing.assert_allclose(pts.numpy(), ref[f"{tag}_scene_points"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(segs.numpy(), ref[f"{tag}_scene_segs"])
    np.testing.assert_array_equal(types.numpy(), ref[f"{tag}_scene_types"])
    obs, _, od = env.observe(state, scores)
    assert sorted(od) == sorted(CAMERA_OBS)
    cam = env.cfg.cameras[0]
    drop_pts, drop_pix = excluded(cam, ref[f"{tag}_uvz"])
    keep = ~drop_pix
    np.testing.assert_allclose(od["topview_depth"].numpy()[keep], ref[f"{tag}_topview_depth"][keep],
                               atol=1e-6, rtol=0)
    seg = od["topview_segmentation"].numpy()
    assert seg.dtype == np.int32 and seg.shape == (B, cam.height, cam.width)
    np.testing.assert_array_equal(seg[keep], ref[f"{tag}_topview_segmentation"][keep])
    color, want = od["topview_color"].numpy(), ref[f"{tag}_topview_color"]
    np.testing.assert_array_equal(eight_bit(color[keep]), eight_bit(want[keep]))
    if tag != "reset":  # the step's render ran under jit: the same float scaling
        np.testing.assert_array_equal(color[keep], want[keep])
    whole = ~drop_pts.any(axis=1)  # envs whose every point is compared
    for k in CLOUDS:
        g, w = od[k].numpy()[whole], ref[f"{tag}_{k}"][whole]
        np.testing.assert_array_equal(g[..., 3], w[..., 3], err_msg=k)
        np.testing.assert_allclose(g[..., :3], w[..., :3], atol=1e-5, rtol=0, err_msg=k)
    print(f"{tag}: {int(drop_pts.sum())} of {drop_pts.size} scene points and "
          f"{int(drop_pix.sum())} pixels left out; clouds compared in {int(whole.sum())} of "
          f"{B} envs")
    assert whole.sum() >= B // 2
    return dict(seg=ref[f"{tag}_topview_segmentation"], obs=obs)


def test_scene_albedo_and_obs_width(ref):
    """`scene_point_rgb` exact (the robot's gray, the box's palette colour);
    the five observables are size 0, so the flat observations keep their
    width (121)."""
    torch.set_num_threads(1)
    base, env = port_env("Ur5SihLift")
    np.testing.assert_array_equal(env.scene_point_rgb.numpy(), ref["scene_point_rgb"])
    assert [base.num_obs, env.num_obs] == ref["num_obs"].tolist() == [121, 121]
    assert all(env.registry.observables[k].size == 0 and env.registry.observables[k].key == k
               for k in CAMERA_OBS)


@pytest.mark.parametrize("tag", TAGS)
def test_lift_camera_observables_match(ref, tag):
    """Each state's five observables with the JAX package's scores (see the
    module docstring); the segmentation shows the empty-pixel value (int32
    min), the robot (1) and the box (3); the flat observations within
    1e-4."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.camera import INT32_MIN

    _, env = port_env("Ur5SihLift")
    got = check_camera_observables(ref, env, tag)
    assert set(np.unique(got["seg"])) == {INT32_MIN, 1, 3}
    np.testing.assert_allclose(got["obs"].numpy(), ref[f"{tag}_obs"], atol=1e-4)


def test_lift_step_routes_camera_observables(ref):
    """The port's own control step from the transferred reset state with
    the JAX package's actions and scores: no env resets, the flat
    observations within 2e-3 of the JAX step's (tests/test_torch_lift.py's
    bound), the five observables in `obs_dict` at their shapes, depth within
    5e-3 (positions after the physics agree to 2e-4)."""
    torch.set_num_threads(1)
    _, env = port_env("Ur5SihLift")
    P = int(ref["padded_points"])
    post, res = env.step(state_of(ref, "reset"),
                         torch.as_tensor(ref["step1_actions"], dtype=torch.float32),
                         {P: torch.as_tensor(ref["step1_scores"])})
    assert not res.done.any() and not ref["step1_done"].any()
    np.testing.assert_allclose(res.obs.numpy(), ref["step1_obs"], atol=2e-3)
    cam = env.cfg.cameras[0]
    shapes = {"topview_depth": (B, cam.height, cam.width),
              "topview_segmentation": (B, cam.height, cam.width),
              "topview_color": (B, cam.height, cam.width, 3),
              "topview_pointcloud": (B, 128, 4), "topview_target_object_pointcloud": (B, 128, 4)}
    assert {k: tuple(v.shape) for k, v in res.obs_dict.items()} == shapes
    d, w = res.obs_dict["topview_depth"].numpy(), ref["step1_topview_depth"]
    both = (d < cam.max_depth) & (w < cam.max_depth)
    assert both.mean() > 0.5 * (w < cam.max_depth).mean()
    np.testing.assert_allclose(d[both], w[both], atol=5e-3, rtol=0)


def test_camera_recorder_matches(ref, tmp_path):
    """The port's `CameraRecorder` of a B = 2 env (envs 0 and 1 of the three
    states): every buffered uint8 frame (depth gray, segmentation colours,
    color) equal to the JAX recorder's outside the pixel rule's pixels;
    flushing writes the same six files, non-empty."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.utils.visualization import CameraRecorder

    _, env4 = port_env("Ur5SihLift")
    env = type(env4)(dataclasses.replace(env4.cfg, num_envs=2), "cpu")
    rec = CameraRecorder(env, str(tmp_path), env_ids=(0, 1))
    drops = []
    for tag in TAGS:
        st = tree_map(lambda x: x[:2] if x.dim() and x.shape[0] == B else x, state_of(ref, tag))
        assert rec.add(st) == []
        drops.append(excluded(env.cfg.cameras[0], ref[f"{tag}_uvz"][:2])[1])
    keep = ~np.concatenate([np.stack(drops)[:, 0], np.stack(drops)[:, 1]])  # env 0, then 1
    for typ in ("depth", "segmentation", "color"):
        got = np.asarray(rec.frames["topview"][typ][0] + rec.frames["topview"][typ][1])
        want = ref[f"frames_{typ}"]
        assert got.dtype == np.uint8 and got.shape == want.shape == (6, 90, 160, 3), typ
        np.testing.assert_array_equal(got[keep], want[keep], err_msg=typ)
    written = rec.flush(0) + rec.flush(1)
    assert [os.path.basename(p) for p in written] == ref["written"].tolist()
    assert len(written) == 6
    for p in written:
        assert os.path.getsize(p) > 0, p
    assert all(not rec.frames["topview"][t][i] for t in ("depth", "color") for i in (0, 1))


def test_render_state_pointcloud_and_episode_recorder(ref, tmp_path):
    """The matplotlib views write their files: `render_state` of a state
    (whole and zoomed on the target object), `render_pointcloud` of its
    camera cloud, and an `EpisodeRecorder` of 2 frames."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.utils.visualization import (EpisodeRecorder, render_pointcloud,
                                                       render_state)

    _, env = port_env("Ur5SihLift")
    state = state_of(ref, "step2")
    for name, kw in (("state.png", {}), ("zoom.png", dict(center="object", extent=0.1))):
        render_state(env, state, 1, path=str(tmp_path / name), **kw)
        assert os.path.getsize(tmp_path / name) > 0
    render_pointcloud(ref["step2_topview_pointcloud"][0], path=str(tmp_path / "cloud.png"))
    assert os.path.getsize(tmp_path / "cloud.png") > 0
    rec = EpisodeRecorder(env, str(tmp_path / "episode.mp4"), env_idx=2)
    for tag in TAGS[1:]:
        rec.add(state_of(ref, tag))
    assert len(rec.frames) == 2 and rec.frames[0].dtype == np.uint8
    assert os.path.getsize(rec.save()) > 0


if __name__ == "__main__":
    jax_reference(sys.argv[1], "Ur5SihLift", [], record_dir=sys.argv[2])
