"""The port's teacher-student distillation against the JAX package:

- `StudentPolicy` with the trained student of docs/evidence/distill_r5a
  (18 leaves read by the port's reader) against flax's `apply` of the same
  file, on the same observations and clouds, an all-padding cloud among
  them;
- the beta schedule;
- one whole `DAgger.train_iter` of Ur5SihLift at B = 8 (horizon 4,
  minibatch 16, 2 mini-epochs: 4 Adam steps) from a transferred state, the
  fixture's student and teacher ckpt_5200, at iteration 4 of an 8-iteration
  decay (beta 0.5: both actors act);
- the `train_distill` and `eval_policy --student` entry points on the CPU
  at a tiny size, and the JAX package's `scripts/eval_policy.py --student`
  reading the `student.npz` the port wrote.

The JAX env reads its asset root when `handarm_tpu.robots.ur5sih` is
imported, so the train_iter's JAX side runs in a subprocess with
HANDARM_ASSET_ROOT at the in-repo stand-in (this file run as a script). It
builds the student env as scripts/train_distill.py does, runs
`DAgger.init`, puts the fixture's params in, sets the episode clocks to 0
(no env resets in the 4 steps), the iteration to 4 and the key to
PRNGKey(11), and writes that state, the draws the iteration makes from its
keys (the Bernoulli mix per step from the rollout keys, one permutation
per mini-epoch, and the clouds' subsampling scores along the env's key
chain: k_obs = split(split(task.key, 4)[0])[1] per step) and its result.
The port runs its own train_iter from the same state with those draws.
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
CKPT = os.path.join(REPO, "docs", "evidence", "lift_r3a", "ckpt_5200.npz")
STUDENT = os.path.join(REPO, "docs", "evidence", "distill_r5a", "student.npz")
CLOUD = "target_object_synthetic_pointcloud"
STUDENT_OBS = ("ur5_joint_pos", "ur5_flange_pose", "dof_position_targets", CLOUD,
               "target_object_to_goal_pos")
AUX = ("object_pos", "sih_fingertip_pos")
B, HORIZON, MINIBATCH, EPOCHS, DECAY, ITERATION = 8, 4, 16, 2, 8, 4


def _port_net():
    from handarm_tpu_torch.learn.distill import StudentPolicy

    return StudentPolicy(33, 11, (CLOUD,), aux_heads={"object_pos": 3, "sih_fingertip_pos": 15})


def _clouds(rng, n):
    """[n, 128, 4] clouds: 14 valid rows (types 2) at random places, the
    rest padding; the last cloud all padding."""
    c = np.zeros((n, 128, 4), np.float32)
    for i in range(n - 1):
        rows = rng.choice(128, 14, replace=False)
        c[i, rows, :3] = rng.uniform(-0.1, 0.1, (14, 3)) + np.array([0.3, 0.6, 0.55])
        c[i, rows, 3] = 2.0
    return c


@pytest.mark.parametrize("case", ("clouds", "all padding"))
def test_student_policy_matches_flax(case):
    """docs/evidence/distill_r5a/student.npz through the port's reader and
    StudentPolicy against flax's apply of the same leaves (as the JAX
    package's eval_policy.py builds it): mu and both aux heads within 1e-5
    relative plus 1e-5 absolute (float32 matmuls in two libraries; 161
    inputs). A cloud with no valid point encodes to -1e9 in every feature
    on both sides, which drives the outputs to ~1e8-1e9 through sums of
    128 terms of ~1e9 that cancel: each term's float32 rounding is ~60,
    so those rows are held to 1e-4 of their largest output (measured
    5.9e-5 relative on one element)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.learn.distill import StudentPolicy as FlaxStudent
    from handarm_tpu_torch.learn.distill import PointcloudEncoder
    from handarm_tpu_torch.utils.checkpoint import read_student

    rng = np.random.default_rng(0)
    n = 6
    obs = rng.normal(size=(n, 33)).astype(np.float32)
    clouds = _clouds(rng, n)
    if case == "all padding":
        clouds[:] = 0.0
    flax_net = FlaxStudent(num_actions=11, cloud_keys=(CLOUD,),
                           aux_heads={"object_pos": 3, "sih_fingertip_pos": 15})
    example = flax_net.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]),
                            {CLOUD: jnp.asarray(clouds[:1])})
    with np.load(STUDENT) as data:
        flat = [data[str(i)] for i in range(len(data.files))]
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(example), flat)
    want_mu, want_aux = flax_net.apply(params, jnp.asarray(obs), {CLOUD: jnp.asarray(clouds)})

    net = _port_net()
    p = read_student(STUDENT, net)
    got_mu, got_aux = torch.func.functional_call(
        net, p, (torch.as_tensor(obs), {CLOUD: torch.as_tensor(clouds)}))
    empty = (clouds[..., 3] > 0).sum(1) == 0
    assert empty[-1] and (case == "all padding") == empty.all()
    for g, w in [(got_mu, want_mu)] + [(got_aux[k], want_aux[k]) for k in AUX]:
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[~empty], w[~empty], rtol=1e-5, atol=1e-5)
        scale = np.abs(w[empty]).max()
        assert np.abs(g[empty] - w[empty]).max() <= 1e-4 * scale
    enc = PointcloudEncoder()
    enc_params = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith("enc_")}
    e = torch.func.functional_call(enc, enc_params, (torch.as_tensor(clouds),))
    assert bool((e[-1] == -1e9).all())
    if case == "all padding":
        assert float(got_mu.abs().min()) > 1e6


def test_beta_matches():
    """The fraction of teacher actions by iteration, for two schedules:
    within float32 rounding (1e-7)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from types import SimpleNamespace

    from handarm_tpu.learn.distill import DAgger as JDAgger, DistillConfig as JConfig
    from handarm_tpu_torch.learn.distill import DAgger, DistillConfig

    env = SimpleNamespace(num_obs=33, num_actions=11, device=torch.device("cpu"))
    for kw in (dict(), dict(beta_start=0.9, beta_end=0.2, beta_decay_iters=7)):
        jd = JDAgger(SimpleNamespace(num_actions=11), None, None, JConfig(**kw))
        td = DAgger(env, None, DistillConfig(**kw))
        for it in (0, 1, 3, 7, 250, 499, 500, 1000):
            want = float(jd.beta(jnp.asarray(it, jnp.int32)))
            got = float(td.beta(torch.tensor(it, dtype=torch.int32)))
            assert got == pytest.approx(want, abs=1e-7), (kw, it)


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.hand_arm import HandArmEnv
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
                                         teacher_observations=teacher_env.cfg.observations))
    aux = {k: tuple(env.teacher_obs_slices[k]) for k in AUX}
    cfg = DistillConfig(horizon=HORIZON, minibatch_size=MINIBATCH, mini_epochs=EPOCHS,
                        beta_decay_iters=DECAY, cloud_keys=(CLOUD,))
    dagger = DAgger(env, teacher, teacher_ts, cfg, aux_from_obs=aux)
    ds = dagger.init(jax.random.PRNGKey(5))
    with np.load(STUDENT) as data:
        flat = [data[str(i)] for i in range(len(data.files))]
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(ds.params), flat)
    state = ds.env_state._replace(task=ds.env_state.task._replace(
        progress=jnp.zeros_like(ds.env_state.task.progress)))
    ds = ds._replace(params=params, opt_state=dagger.optimizer.init(params), env_state=state,
                     key=jax.random.PRNGKey(11), iteration=jnp.asarray(ITERATION, jnp.int32))

    # the draws train_iter makes
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
        scores.append(np.asarray(jax.random.uniform(k_obs, (B, 128))))

    new, stats = jax.jit(dagger.train_iter)(ds)
    out = dict(mix=mix, perms=perms, scores=np.stack(scores), last_obs=np.asarray(ds.last_obs),
               last_teacher_obs=np.asarray(ds.last_teacher_obs),
               last_cloud=np.asarray(ds.last_obs_dict[CLOUD]),
               new_obs=np.asarray(new.last_obs), new_teacher_obs=np.asarray(new.last_teacher_obs),
               new_cloud=np.asarray(new.last_obs_dict[CLOUD]),
               aux=np.asarray([aux[k] for k in AUX]), iteration=np.asarray(new.iteration))
    for k, v in stats.items():
        out[f"stat_{k}"] = np.asarray(v)
    for i, leaf in enumerate(jax.tree.leaves(new.params)):
        out[f"params_{i}"] = np.asarray(leaf)
    for tag, st in (("pre", state), ("post", new.env_state)):
        for i, leaf in enumerate(jax.tree.leaves(st)):
            out[f"{tag}_{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


def _subprocess_env(tmp):
    return dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
                HANDARM_DISABLE_GENESIS="1", **shared_jax_env(tmp))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("distill") / "ref.npz"
    res = subprocess.run([sys.executable, __file__, str(out)], env=_subprocess_env(out.parent),
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_") and k[len(tag) + 1:].isdigit()])
    return [ref[f"{tag}_{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def port(ref):
    """The port's DAgger and its train_iter from the same state and draws:
    (dagger, start params, new DistillState, stats)."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.tasks import make_env
    from handarm_tpu_torch.learn import optim
    from handarm_tpu_torch.learn.distill import DAgger, DistillConfig, DistillState
    from handarm_tpu_torch.rollout import load_policy
    from handarm_tpu_torch.utils.checkpoint import read_student

    teacher_obs = make_env("Ur5SihLift", device="cpu", num_envs=B).cfg.observations
    env = make_env("Ur5SihLift", device="cpu", num_envs=B, observations=STUDENT_OBS,
                   teacher_observations=teacher_obs)
    aux = {k: env.teacher_obs_slices[k] for k in AUX}
    assert [aux[k] for k in AUX] == [tuple(s) for s in ref["aux"].tolist()]
    cfg = DistillConfig(horizon=HORIZON, minibatch_size=MINIBATCH, mini_epochs=EPOCHS,
                        beta_decay_iters=DECAY, cloud_keys=(CLOUD,))
    dagger = DAgger(env, load_policy(CKPT, "cpu"), cfg, aux_from_obs=aux)
    params = read_student(STUDENT, dagger.net)
    t = torch.as_tensor
    ds = DistillState(params, optim.init(params), env_state_from_leaves(_leaves(ref, "pre")),
                      t(ref["last_obs"]), t(ref["last_teacher_obs"]),
                      {CLOUD: t(ref["last_cloud"])}, torch.tensor(ITERATION, dtype=torch.int32))
    scores = [{128: t(np.array(s))} for s in ref["scores"]]
    new, stats = dagger.train_iter(ds, mix=t(ref["mix"]), perms=t(ref["perms"]).long(),
                                   scores=scores)
    return dagger, params, new, stats


def test_dagger_rollout_matches(ref, port):
    """The 4 beta-mixed steps end in the same env state and observations:
    q and object positions within 2e-4, velocities and impulses 2e-3, the
    flat and teacher observations 2e-3, the next cloud's xyz 2e-3 and its
    types and row order exact (tests/test_torch_lift.py's env-step bounds);
    the mix executed both actors' actions; the iteration counted."""
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
    assert ref["mix"].any() and not ref["mix"].all()
    assert int(new.iteration) == int(ref["iteration"]) == ITERATION + 1
    assert float(stats["beta"]) == pytest.approx(float(ref["stat_beta"]), abs=1e-7)
    assert float(stats["success_rate_ewma"]) == pytest.approx(
        float(ref["stat_success_rate_ewma"]), abs=1e-6)


def test_dagger_update_matches(ref, port):
    """The student after the 4 Adam steps (lr 1e-3) and the losses. The
    samples agree as above (teacher targets and the student's actions are
    float32 matmuls of observations within 2e-3), so bc_loss and aux_loss
    agree within 1e-4 relative; the params within 1e-5 of the JAX
    package's, against steps of up to 4e-3 (Adam moves each element by up
    to lr = 1e-3 per step, whatever its gradient's size, so an element
    whose gradient is mostly rounding passes that rounding on at lr scale;
    measured 3.1e-6)."""
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


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory):
    """`python -m handarm_tpu_torch.train_distill` on the CPU at 8 envs for
    2 iterations (its own process); its output directory."""
    out = tmp_path_factory.mktemp("entry") / "distill"
    res = subprocess.run(
        [sys.executable, "-m", "handarm_tpu_torch.train_distill", "--teacher", CKPT,
         "--envs", "8", "--iters", "2", "--out", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return out


def test_train_distill_entry_point_on_cpu(entry_run):
    """config.yaml as the JAX script writes it; one metrics row (the last
    iteration's) with finite losses and beta 1 - 1/400; student.npz with the
    18 leaves of the fixture's layout."""
    cfg = (entry_run / "config.yaml").read_text()
    assert "task: Ur5SihLift" in cfg and "aux: ['object_pos', 'sih_fingertip_pos']" in cfg
    rows = [json.loads(x) for x in (entry_run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2]
    assert np.isfinite([rows[0]["bc_loss"], rows[0]["aux_loss"]]).all()
    assert rows[0]["beta"] == pytest.approx(1 - 1 / 400)
    with np.load(entry_run / "student.npz") as got, np.load(STUDENT) as want:
        assert sorted(got.files, key=int) == sorted(want.files, key=int)
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32


@pytest.mark.parametrize("which", ("port's", "fixture"))
def test_eval_student_entry_point_on_cpu(entry_run, which):
    """`python -m handarm_tpu_torch.eval_policy --student ... --teacher
    ckpt_5200 --envs 8 --steps 10 --episode-length 5 --device cpu`, for the
    port's student.npz and the fixture's: one JSON line, 16 episodes in the
    window (8 envs, 10 steps of 5-step episodes), a rate in [0, 1]."""
    from handarm_tpu_torch.eval_policy import main

    student = entry_run / "student.npz" if which == "port's" else STUDENT
    torch.set_num_threads(1)
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--student", str(student), "--teacher", CKPT, "--envs", "8", "--steps", "10",
              "--episode-length", "5", "--device", "cpu"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["episodes"] == 16 and 0.0 <= out["success_rate"] <= 1.0
    assert out["policy"] == str(student)


def test_jax_eval_reads_the_ports_student(entry_run, tmp_path):
    """The JAX package's scripts/eval_policy.py --student reads the
    student.npz the port wrote (its leaves unflattened into the flax
    student) and evaluates it on the stand-in: 2 envs, the burn-in of one
    200-step episode and 10 more steps, one JSON line naming the file."""
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "eval_policy.py"), "--platform", "cpu",
         "--student", str(entry_run / "student.npz"), "--teacher", CKPT, "--envs", "2",
         "--steps", "10"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=_subprocess_env(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["policy"] == str(entry_run / "student.npz")
    assert 0.0 <= out["success_rate"] <= 1.0


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
