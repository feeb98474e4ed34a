"""A DAgger student on the camera's cloud against the JAX package: one
whole `DAgger.train_iter` of Ur5SihLift at B = 8 (horizon 4, minibatch 16,
2 mini-epochs: 4 Adam steps) whose student reads
`topview_target_object_pointcloud`, the topview camera's segmented cloud
of the target object, in place of train_distill's synthetic target cloud;
teacher ckpt_5200, the JAX package's flax-default student init.

As tests/test_torch_distill.py: the JAX side runs in a subprocess (this
file run as a script) with HANDARM_ASSET_ROOT at the in-repo stand-in. It
builds the student env as scripts/train_distill.py does, with
`cameras=(CameraConfig(),)` added (the library route of
tests/test_camera.py; no yaml sets cameras), runs `DAgger.init`, sets the
episode clocks to 0, the iteration to 4 of an 8-iteration decay (beta 0.5)
and the key to PRNGKey(11), and writes that state, the draws the
iteration makes from its keys (the mix, the permutations, and the cloud's
subsampling scores at the camera scene's padded point count) and its
result. The port runs its own train_iter from the same state with those
draws, at that file's tolerances.
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
CLOUD = "topview_target_object_pointcloud"
STUDENT_OBS = ("ur5_joint_pos", "ur5_flange_pose", "dof_position_targets", CLOUD,
               "target_object_to_goal_pos")
AUX = ("object_pos", "sih_fingertip_pos")
B, HORIZON, MINIBATCH, EPOCHS, DECAY, ITERATION = 8, 4, 16, 2, 8, 4


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.camera import CameraConfig
    from handarm_tpu.envs.hand_arm import HandArmEnv, ObsContext
    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.learn.distill import DAgger, DistillConfig
    from handarm_tpu.learn.ppo import PPO, PPOConfig
    from handarm_tpu.robots.ur5sih import ASSET_ROOT
    from handarm_tpu.utils.checkpoint import load_checkpoint

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    teacher_env, ppo_over = make_env("Ur5SihLift", [f"num_envs={B}"])
    teacher = PPO(teacher_env, PPOConfig(**ppo_over))
    teacher_ts = load_checkpoint(CKPT, example_tree=teacher.init(jax.random.PRNGKey(0)))
    env = HandArmEnv(dataclasses.replace(teacher_env.cfg, observations=STUDENT_OBS,
                                         teacher_observations=teacher_env.cfg.observations,
                                         cameras=(CameraConfig(),)))
    aux = {k: tuple(env.teacher_obs_slices[k]) for k in AUX}
    cloud_keys = tuple(s for s in STUDENT_OBS if "pointcloud" in s)  # train_distill's rule
    assert cloud_keys == (CLOUD,)
    cfg = DistillConfig(horizon=HORIZON, minibatch_size=MINIBATCH, mini_epochs=EPOCHS,
                        beta_decay_iters=DECAY, cloud_keys=cloud_keys)
    dagger = DAgger(env, teacher, teacher_ts, cfg, aux_from_obs=aux)
    ds = dagger.init(jax.random.PRNGKey(5))
    state = ds.env_state._replace(task=ds.env_state.task._replace(
        progress=jnp.zeros_like(ds.env_state.task.progress)))
    ds = ds._replace(env_state=state, key=jax.random.PRNGKey(11),
                     iteration=jnp.asarray(ITERATION, jnp.int32))
    P = max(int(env._camera_scene_points(ObsContext(env, state, None))[0].shape[1]), 128)

    beta = dagger.beta(ds.iteration)
    _, k_roll, k_perm = jax.random.split(ds.key, 3)
    mix = np.stack([np.asarray(jax.random.bernoulli(k, beta, (B, 1)))
                    for k in jax.random.split(k_roll, HORIZON)])
    N = B * HORIZON
    perms = np.stack([np.asarray(jax.random.permutation(k, N))
                      for k in jax.random.split(k_perm, EPOCHS)])
    scores, key = [], state.task.key
    for _ in range(HORIZON):
        key, k_obs = jax.random.split(jax.random.split(key, 4)[0])
        scores.append(np.asarray(jax.random.uniform(k_obs, (B, P))))

    new, stats = jax.jit(dagger.train_iter)(ds)
    out = dict(mix=mix, perms=perms, scores=np.stack(scores), padded_points=np.asarray(P),
               last_obs=np.asarray(ds.last_obs),
               last_teacher_obs=np.asarray(ds.last_teacher_obs),
               last_cloud=np.asarray(ds.last_obs_dict[CLOUD]),
               new_obs=np.asarray(new.last_obs), new_teacher_obs=np.asarray(new.last_teacher_obs),
               new_cloud=np.asarray(new.last_obs_dict[CLOUD]),
               aux=np.asarray([aux[k] for k in AUX]), iteration=np.asarray(new.iteration))
    for k, v in stats.items():
        out[f"stat_{k}"] = np.asarray(v)
    for tag, params in (("init", ds.params), ("params", new.params)):
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{tag}_{i}"] = np.asarray(leaf)
    for tag, st in (("pre", state), ("post", new.env_state)):
        for i, leaf in enumerate(jax.tree.leaves(st)):
            out[f"{tag}_{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("camera_distill")
    out = tmp / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1", **shared_jax_env(tmp))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_") and k[len(tag) + 1:].isdigit()])
    return [ref[f"{tag}_{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def port(ref):
    """The port's camera student built as `train_distill.student_setup`
    builds it (cameras added through its config overrides) and its
    train_iter from the same state and draws: (dagger, start params, new
    DistillState, stats)."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import env_state_from_leaves, params_from_leaves
    from handarm_tpu_torch.envs.camera import CameraConfig
    from handarm_tpu_torch.learn import optim
    from handarm_tpu_torch.learn.distill import DAgger, DistillConfig, DistillState
    from handarm_tpu_torch.train_distill import student_setup

    env, teacher, cloud_keys, aux = student_setup(
        "Ur5SihLift", B, CKPT, ",".join(STUDENT_OBS), "cpu", cameras=(CameraConfig(),))
    assert cloud_keys == (CLOUD,)
    assert [aux[k] for k in AUX] == [tuple(s) for s in ref["aux"].tolist()]
    cfg = DistillConfig(horizon=HORIZON, minibatch_size=MINIBATCH, mini_epochs=EPOCHS,
                        beta_decay_iters=DECAY, cloud_keys=cloud_keys)
    dagger = DAgger(env, teacher, cfg, aux_from_obs={k: aux[k] for k in AUX})
    params = params_from_leaves(dagger.net, _leaves(ref, "init"))
    t = torch.as_tensor
    ds = DistillState(params, optim.init(params), env_state_from_leaves(_leaves(ref, "pre")),
                      t(ref["last_obs"]), t(ref["last_teacher_obs"]),
                      {CLOUD: t(ref["last_cloud"])}, torch.tensor(ITERATION, dtype=torch.int32))
    P = int(ref["padded_points"])
    scores = [{P: t(np.array(s))} for s in ref["scores"]]
    new, stats = dagger.train_iter(ds, mix=t(ref["mix"]), perms=t(ref["perms"]).long(),
                                   scores=scores)
    return dagger, params, new, stats


def test_camera_dagger_rollout_matches(ref, port):
    """The 4 beta-mixed steps end in the same env state and observations
    (q and object positions 2e-4; velocities and impulses, the flat and
    teacher observations 2e-3); the next camera cloud's types and row
    order exact, its xyz within 2e-3; the cloud holds target points."""
    _, _, new, stats = port
    want = _leaves(ref, "post")
    got = new.env_state.physics
    for name, g, w, tol in (("q", got.robot.q, want[0], 2e-4), ("qd", got.robot.qd, want[1], 2e-3),
                            ("obj pos", got.objects.pos, want[3], 2e-4),
                            ("obj linvel", got.objects.linvel, want[5], 2e-3),
                            ("impulse", got.contact_impulse, want[7], 2e-3)):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
    np.testing.assert_allclose(new.last_obs.numpy(), ref["new_obs"], atol=2e-3)
    np.testing.assert_allclose(new.last_teacher_obs.numpy(), ref["new_teacher_obs"], atol=2e-3)
    cloud = new.last_obs_dict[CLOUD].numpy()
    np.testing.assert_array_equal(cloud[..., 3], ref["new_cloud"][..., 3])
    np.testing.assert_allclose(cloud[..., :3], ref["new_cloud"][..., :3], atol=2e-3)
    assert (cloud[..., 3] == 2).sum(1).min() > 0
    assert ref["mix"].any() and not ref["mix"].all()
    assert int(new.iteration) == int(ref["iteration"]) == ITERATION + 1
    assert float(stats["beta"]) == pytest.approx(float(ref["stat_beta"]), abs=1e-7)


def test_camera_dagger_update_matches(ref, port):
    """The student after the 4 Adam steps and the losses: params within
    1e-5 of the JAX package's (each moved by more than 1e-4), bc_loss and
    aux_loss within 1e-4 relative."""
    from handarm_tpu_torch.convert import params_to_leaves

    dagger, start, new, stats = port
    got = params_to_leaves(dagger.net, new.params)
    moved = params_to_leaves(dagger.net, start)
    want = _leaves(ref, "params")
    assert len(got) == len(want) == 18
    print("params: max |port - jax|", max(float(np.abs(g - w).max()) for g, w in zip(got, want)),
          "max |step|", max(float(np.abs(w - s).max()) for w, s in zip(want, moved)))
    for i, (g, w, s) in enumerate(zip(got, want, moved)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=f"leaf {i}")
        assert np.abs(w - s).max() > 1e-4, f"leaf {i} did not move"
    for k in ("bc_loss", "aux_loss"):
        np.testing.assert_allclose(float(stats[k]), ref[f"stat_{k}"], rtol=1e-4, err_msg=k)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
