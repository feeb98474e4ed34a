"""The port's Stretch robot against the JAX package: the host compile,
kinematics, dynamics and carried FK with prismatic joints (the inline
prismatic URDFs of tests/test_dynamics.py and tests/test_dynamics_com.py,
and the in-repo Stretch stand-in on its yawed mount), the collision
spheres and surface cloud, the grouped actionable,
docs/evidence/stretch_r5d/ckpt_4000.npz both ways, the train entry point
resuming it, and one PPO `train_iter` of StretchLift at a tiny width.

The model-level functions take the URDF's path, so the JAX side runs in
this process. The train iteration needs the JAX package's StretchLift,
which reads the asset root when its robot module is imported: that side
runs once in a subprocess (this file run as a script, HANDARM_ASSET_ROOT
at the stand-in). It builds StretchLift at B = 8, zeroes every episode
clock (no env resets in the rollout), runs one train_iter (horizon 4,
minibatch 16, 2 mini-epochs, one hidden layer of 32) from a fresh init and
writes its initial TrainState as a checkpoint, the rollout's noise and
the minibatch permutations (recomputed from the iteration's key), the
trajectory and the updated learner to an npz; the port runs its own
train_iter from that checkpoint with that noise and those permutations.
"""

import os
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # the JAX side's subprocess
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from handarm_tpu.physics import dynamics as jd  # noqa: E402
from handarm_tpu.physics import engine as je  # noqa: E402
from handarm_tpu.physics import kinematics as jk  # noqa: E402
from handarm_tpu.physics.model import compile_urdf as j_compile  # noqa: E402
from handarm_tpu.robots import stretch as j_stretch  # noqa: E402
from handarm_tpu_torch.physics import dynamics as td  # noqa: E402
from handarm_tpu_torch.physics import engine as te  # noqa: E402
from handarm_tpu_torch.physics import kinematics as tk  # noqa: E402
from handarm_tpu_torch.physics.model import PRISMATIC  # noqa: E402
from handarm_tpu_torch.physics.model import compile_urdf as t_compile  # noqa: E402
from handarm_tpu_torch.robots import stretch as t_stretch  # noqa: E402
from tests.test_dynamics import BRANCHED_TREE  # noqa: E402
from tests.test_dynamics_com import FLYER  # noqa: E402
from shared_jax_cache import shared_jax_env  # noqa: E402

STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
STRETCH = t_stretch.STRETCH_URDF
CKPT = os.path.join(REPO, "docs", "evidence", "stretch_r5d", "ckpt_4000.npz")
MODELS = ["tree", "flyer", "stretch"]
# tests/test_torch_model.py holds the tree's compile, kinematics and dynamics
NEW_MODELS = ["flyer", "stretch"]
# the Stretch's mount: (0.2, 0.175) on a 0.5 m table, yawed by pi
MOUNT_QUAT = np.array([[np.cos(np.pi / 2), 0.0, 0.0, np.sin(np.pi / 2)]], np.float32)
MOUNT_POS = np.array([[0.2, 0.175, 0.5]], np.float32)
B, HORIZON, MINIBATCH, EPOCHS, HIDDEN = 8, 4, 16, 2, (32,)
TRAJ_FIELDS = ("obs", "action", "logp", "value", "reward", "done", "mu", "sigma")


@pytest.fixture(scope="module")
def urdf_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("prismatic")
    paths = {"stretch": STRETCH}
    for name, text in (("tree", BRANCHED_TREE), ("flyer", FLYER)):
        p = d / f"{name}.urdf"
        p.write_text(text)
        paths[name] = str(p)
    return paths


def _pair(urdf_paths, model):
    """(articulation, JAX model arrays, port model arrays, base quat, base
    pos): the stand-in on its mount, the inline models (fixed base) on an
    arbitrary pose."""
    art = t_compile(urdf_paths[model])
    jm = jk.model_arrays(j_compile(urdf_paths[model]))
    tm = tk.model_arrays(art)
    if model == "stretch":
        return art, jm, tm, MOUNT_QUAT, MOUNT_POS
    bq = np.array([[0.9, 0.1, -0.2, 0.37]], np.float32)
    return art, jm, tm, bq / np.linalg.norm(bq), np.array([[0.1, -0.2, 0.5]], np.float32)


def _inputs(art, B=16, seed=0):
    """q inside the joint limits, qd in [-2, 2] (prismatic: [-0.5, 0.5] m/s)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.maximum(art.q_min, -1.2), np.minimum(art.q_max, 1.2)
    q = rng.uniform(lo, hi, (B, art.nv)).astype(np.float32)
    scale = np.where(art.joint_type == PRISMATIC, 0.5, 2.0)
    qd = (rng.uniform(-1.0, 1.0, (B, art.nv)) * scale).astype(np.float32)
    return q, qd


def _fk(jm, tm, q, bq, bp):
    jfk = jk.forward_kinematics(jm, jnp.asarray(q), jnp.asarray(bq), jnp.asarray(bp))
    tfk = tk.forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(bq), torch.as_tensor(bp))
    return jfk, tfk


@pytest.mark.parametrize("model", NEW_MODELS)
def test_prismatic_models_compile_identical(urdf_paths, model):
    """The host compile of each prismatic model gives the same arrays on
    both sides; the Stretch stand-in has the JAX package's nine joints in
    order, six of them prismatic."""
    a, b = j_compile(urdf_paths[model]), t_compile(urdf_paths[model])
    assert a.joint_names == b.joint_names and a.body_names == b.body_names
    for name in ("parent", "joint_type", "ancestor_mask", "tree_pos", "tree_quat", "axis",
                 "mass", "com", "inertia", "q_min", "q_max", "armature"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    assert (b.joint_type == PRISMATIC).sum() == {"flyer": 1, "stretch": 6}[model]
    if model == "stretch":
        assert b.joint_names == j_stretch.STRETCH_JOINTS == t_stretch.STRETCH_JOINTS
        assert j_stretch.load_stretch(STRETCH).joint_names == t_stretch.load_stretch().joint_names
        for q in (t_stretch.RESET_JOINT_CONFIG, t_stretch.BRINGUP_JOINT_CONFIG):
            assert np.all(b.q_min <= q) and np.all(np.asarray(q) <= b.q_max)
        for s in ("fingertip_left", "fingertip_right", "link_grasp_center"):
            assert b.sites[s].body == a.sites[s].body >= 6


@pytest.mark.parametrize("model", NEW_MODELS)
def test_prismatic_kinematics_match(urdf_paths, model):
    """FK poses and screws (a prismatic screw has no angular part), body
    velocities, every site's world pose and point Jacobians: within 1e-5."""
    art, jm, tm, bq, bp = _pair(urdf_paths, model)
    q, qd = _inputs(art)
    jfk, tfk = _fk(jm, tm, q, bq, bp)
    for a, b in zip(jfk, tfk):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    pri = art.joint_type == PRISMATIC
    assert float(tfk.screw[:, pri, :3].abs().max()) == 0.0
    np.testing.assert_allclose(
        tk.body_velocities(tm, tfk, torch.as_tensor(qd)).numpy(),
        np.asarray(jk.body_velocities(jm, jfk, jnp.asarray(qd))), atol=1e-5)
    sb, sp, sq = art.site_array(list(art.sites))
    ws = jk.site_poses(jfk, sb, jnp.asarray(sp, jnp.float32), jnp.asarray(sq, jnp.float32),
                       jnp.broadcast_to(jnp.asarray(bq), (16, 4)),
                       jnp.broadcast_to(jnp.asarray(bp), (16, 3)))
    ts = tk.site_poses(tfk, sb, torch.as_tensor(sp, dtype=torch.float32),
                       torch.as_tensor(sq, dtype=torch.float32), torch.as_tensor(bq),
                       torch.as_tensor(bp))
    for a, b in zip(ws, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    body = np.random.default_rng(1).integers(0, art.nb, (16, 5))
    pts = np.random.default_rng(2).normal(size=(16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tk.point_jacobian(tm, tfk, torch.as_tensor(body), torch.as_tensor(pts)).numpy(),
        np.asarray(jk.point_jacobian(jm, jfk, jnp.asarray(body), jnp.asarray(pts))), atol=1e-5)


@pytest.mark.parametrize("model", NEW_MODELS)
def test_prismatic_dynamics_match(urdf_paths, model):
    """The PD-augmented mass matrix and the bias torques (gravity on) at the
    model's gains (the Stretch's own), 1e-5 of each one's largest entry;
    the inverse, 1e-4 of its largest entry (finger armature 1e-3 against
    kilograms on the prismatic joints)."""
    art, jm, tm, bq, bp = _pair(urdf_paths, model)
    q, qd = _inputs(art, seed=2)
    if model == "stretch":
        kp = np.asarray(t_stretch.DEFAULT_PROP_GAIN, np.float32)
        kd = np.asarray(t_stretch.DEFAULT_DERIV_GAIN, np.float32)
    else:
        kp = np.random.default_rng(3).uniform(5, 120, art.nv).astype(np.float32)
        kd = np.random.default_rng(4).uniform(1, 20, art.nv).astype(np.float32)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    h = 1.0 / 120.0
    jfk, tfk = _fk(jm, tm, q, bq, bp)
    jdyn = jd.compute_dyn(jm, jfk, jnp.asarray(qd), jnp.asarray(g), jnp.asarray(kp),
                          jnp.asarray(kd), h)
    tdyn = td.compute_dyn(tm, tfk, torch.as_tensor(qd), torch.as_tensor(g),
                          torch.as_tensor(kp), torch.as_tensor(kd), h)
    for name, tol in (("Mtilde", 1e-5), ("bias", 1e-5), ("Minv", 1e-4)):
        want = np.asarray(getattr(jdyn, name))
        np.testing.assert_allclose(getattr(tdyn, name).numpy(), want,
                                   atol=tol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("model", MODELS)
def test_prismatic_carried_fk_matches(urdf_paths, model):
    """The engine's carried FK (first-order propagation of the body poses,
    joint screws regenerated per joint type), chained over 3 sim steps of
    1/60 s: within 1e-5."""
    art, jm, tm, bq, bp = _pair(urdf_paths, model)
    q, qd = _inputs(art, seed=5)
    jfk, tfk = _fk(jm, tm, q, bq, bp)
    jq, jp, js = jfk.body_quat, jfk.body_pos, jfk.screw
    tq, tp, ts = tfk.body_quat, tfk.body_pos, tfk.screw
    for _ in range(3):
        jq, jp, js = je._propagate_fk(jm, jq, jp, js, jnp.asarray(qd), 1.0 / 60.0)
        tq, tp, ts = te._propagate_fk(tm, tq, tp, ts, torch.as_tensor(qd), 1.0 / 60.0)
        for a, b in ((jq, tq), (jp, tp), (js, ts)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_stretch_spheres_identical():
    """The spheres fitted to the stand-in's link meshes, exactly the JAX
    package's: 2 on each of the 12 other links, 8 along each finger; the
    hand-only set (bodies >= 6, the wrist and gripper) has 24."""
    want = j_stretch.stretch_collision_spheres(STRETCH)
    got = t_stretch.stretch_collision_spheres(STRETCH)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y, x)
    bodies = got[0]
    assert len(bodies) == 36 and (bodies >= 6).sum() == 24
    assert list(np.bincount(bodies)) == [2, 2, 2, 2, 2, 2, 8, 8, 8]
    hand = t_stretch.make_stretch_spheres(hand_only=True)
    assert len(hand.body) == 24 and hand.offset.shape == (24, 3)


def test_stretch_surface_cloud_identical(monkeypatch):
    """The robot's surface cloud (rng seed 11, area-proportional over the
    moving links' meshes): exactly the JAX package's. Its function reads the
    module's default path, pointed here at the stand-in."""
    from handarm_tpu.robots import stretch_adapter as jsa
    from handarm_tpu_torch.robots import stretch_adapter as tsa

    monkeypatch.setattr(jsa, "STRETCH_URDF", STRETCH)
    monkeypatch.setattr(jsa, "load_stretch", lambda: j_stretch.load_stretch(STRETCH))
    want = jsa.stretch_surface_cloud.__wrapped__(128)
    got = tsa.stretch_surface_cloud(128)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y, x)
    assert len(got[0]) == 128


def test_grouped_actionable_matches():
    """`stretch_relative_joint_pos` on random targets and actions (some
    pushing past the limits): slot 2 moves the four arm segments together,
    slot 3 the wrist x8, slot 4 both fingers x6, clamped to the limits;
    within 1e-6 of the JAX package's."""
    from handarm_tpu.envs.hand_arm import REGISTRY
    from handarm_tpu.robots import stretch_adapter as jsa
    from handarm_tpu_torch.robots import stretch_adapter as tsa

    jsa._register_stretch_actionable()
    art = j_stretch.load_stretch(STRETCH)
    rng = np.random.default_rng(6)
    target = rng.uniform(art.q_min - 0.01, art.q_max + 0.01, (16, 9)).astype(np.float32)
    a = rng.uniform(-1, 1, (16, 5)).astype(np.float32)
    cfg = types.SimpleNamespace(dt=1.0 / 60.0)
    jenv = types.SimpleNamespace(cfg=cfg, art=art)
    want = REGISTRY.actionables["stretch_relative_joint_pos"].apply(
        jenv, jsa.StretchControl(jnp.asarray(target)), jnp.asarray(a)).joint_target
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    tenv = types.SimpleNamespace(cfg=cfg, joint_limits=(f32(art.q_min), f32(art.q_max)))
    got = tsa.act_relative_joint_pos(tenv, tsa.StretchControl(torch.as_tensor(target)),
                                     torch.as_tensor(a)).joint_target
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    inside = (target > art.q_min + 0.02) & (target < art.q_max - 0.02)
    d = (got.numpy() - target)[inside.all(1)]
    np.testing.assert_allclose(d[:, 2:6], d[:, 2:3].repeat(4, 1), atol=1e-7)


def test_ckpt_4000_policy_matches():
    """docs/evidence/stretch_r5d/ckpt_4000.npz: the port reads all 69 leaves
    (22 env-state leaves: the Stretch's control is one) into StretchLift's
    TrainState, and its policy's mean actions on observations from a
    numpy seed lie within 1e-5 of the JAX loader's."""
    from handarm_tpu.learn.networks import ActorCritic
    from handarm_tpu.learn.running_stats import normalize
    from handarm_tpu.utils.checkpoint import load_checkpoint
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.rollout import TASK_CKPTS, load_policy
    from handarm_tpu_torch.utils.checkpoint import file_contact_slots, file_env_leaves, \
        load_train_state

    assert os.path.samefile(TASK_CKPTS["StretchLift"], CKPT)
    cfg, _ = resolve_task("StretchLift")
    assert file_env_leaves(CKPT) == 22 and file_contact_slots(CKPT) == 100
    ts = load_train_state(CKPT, env_cfg=cfg)
    assert ts.env_state.control.joint_target.shape == (1024, 9)
    assert ts.env_state.physics.contact_impulse.shape == (1024, 100, 3)
    assert ts.last_obs.shape == (1024, 63) and int(ts.epoch) == 4000
    obs = np.random.default_rng(7).normal(size=(32, 63)).astype(np.float32)
    jts = load_checkpoint(CKPT)
    want = ActorCritic(num_actions=5).apply(jts.params, normalize(jts.obs_stats,
                                                                  jnp.asarray(obs)))[0]
    got = load_policy(CKPT, "cpu").act(torch.as_tensor(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ts.env_state.physics.robot.q.numpy(),
                                  np.asarray(jts.env_state.physics.robot.q))


def test_ckpt_4000_written_back_reads_in_jax(tmp_path):
    """The port writes ckpt_4000 (halved params, epoch 4001) as the train
    entry point resumed from it does; the JAX loader reads the file given
    ckpt_4000 as its example tree: params, control state, impulses and
    epoch equal to the port's."""
    from handarm_tpu.utils.checkpoint import load_checkpoint
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.networks import flax_names
    from handarm_tpu_torch.utils import checkpoint as tck

    cfg, _ = resolve_task("StretchLift")
    ts = tck.load_train_state(CKPT, env_cfg=cfg)
    ts = ts._replace(params={k: p * 0.5 for k, p in ts.params.items()}, epoch=ts.epoch + 1)
    path = tck.save_checkpoint(str(tmp_path), ts, 4001, sync=True, env_cfg=cfg)
    loaded = load_checkpoint(path, example_tree=load_checkpoint(CKPT))
    for (f, t), w in zip(flax_names(3), jax.tree.leaves(loaded.params)):
        p = ts.params[t].numpy()
        np.testing.assert_array_equal(p.T if f.endswith(".kernel") else p, np.asarray(w))
    np.testing.assert_array_equal(np.asarray(loaded.env_state.control.joint_target),
                                  ts.env_state.control.joint_target.numpy())
    assert loaded.env_state.physics.contact_impulse.shape == (1024, 100, 3)
    assert int(loaded.epoch) == 4001


def test_train_entry_point_resumes_ckpt_4000(tmp_path, monkeypatch):
    """`python -m handarm_tpu_torch.train task=StretchLift` at 8 envs
    resumes ckpt_4000's learner (its 1,024 envs' state is not this run's:
    the env is reset fresh) for one iteration and writes ckpt_4001.npz,
    which the port's reader reads back with 22 env leaves."""
    from handarm_tpu_torch import train
    from handarm_tpu_torch.utils.checkpoint import file_env_leaves, read_leaves

    monkeypatch.chdir(tmp_path)
    torch.manual_seed(0)
    train.main(["task=StretchLift", "num_envs=8", "device=cpu", "max_iterations=4001",
                f"resume={CKPT}", "ppo.minibatch_size=64", "experiment=stretch"])
    out = tmp_path / "runs" / "stretch" / "nn" / "ckpt_4001.npz"
    assert file_env_leaves(str(out)) == 22
    leaves = read_leaves(str(out))
    assert len(leaves) == 69 and int(leaves[-1]) == 4001
    assert leaves[51].shape == (8, 100, 3)


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    jax.config.update("jax_platforms", "cpu")
    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.learn.ppo import PPO, PPOConfig
    from handarm_tpu.robots.ur5sih import ASSET_ROOT
    from handarm_tpu.utils.checkpoint import save_checkpoint

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    env, _ = make_env("StretchLift", [f"num_envs={B}"])
    ppo = PPO(env, PPOConfig(horizon=HORIZON, minibatch_size=MINIBATCH, mini_epochs=EPOCHS,
                             hidden=HIDDEN))
    ts = ppo.init(jax.random.PRNGKey(3))
    state = ts.env_state._replace(task=ts.env_state.task._replace(
        progress=jnp.zeros_like(ts.env_state.task.progress)))
    ts = ts._replace(env_state=state, key=jax.random.PRNGKey(11))
    ckpt = save_checkpoint(os.path.dirname(out_path), ts, 0, sync=True)
    key, k_roll, _ = jax.random.split(ts.key, 3)  # the draws train_iter makes
    noise = np.stack([np.asarray(jax.random.normal(k, (B, env.num_actions)))
                      for k in jax.random.split(k_roll, HORIZON)])
    n = B * HORIZON
    perms = np.stack([
        np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, n))(
            jax.random.split(k, 1))[0])
        for k in jax.random.split(jax.random.fold_in(key, 1), EPOCHS)])
    captured = {}
    update = ppo._update_from_traj

    def capture(ts_, traj, *args, **kw):
        captured["traj"] = traj
        return update(ts_, traj, *args, **kw)

    ppo._update_from_traj = capture
    new_ts, stats = ppo.train_iter(ts)
    out = dict(noise=noise, perms=perms, ckpt=ckpt)
    for name in TRAJ_FIELDS:
        out[f"traj_{name}"] = np.asarray(getattr(captured["traj"], name))
    learner = (new_ts.params, new_ts.opt_state, new_ts.obs_stats, new_ts.value_stats,
               new_ts.lr, new_ts.epoch)
    for i, leaf in enumerate(jax.tree.leaves(learner)):
        out[f"learner_{i}"] = np.asarray(leaf)
    for k, v in stats.items():
        out[f"stat_{k}"] = np.asarray(v)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("stretch_train") / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               **shared_jax_env(out.parent))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def test_train_iter_matches(ref):
    """One StretchLift train_iter from the JAX package's fresh init (its
    checkpoint read whole by the port): the trajectory at
    tests/test_torch_train.py's bounds (the env-step bound 2e-3 on later
    observations, 1e-4 on the first step's policy outputs, 1e-3 on later
    ones), then the updated params and Adam moments within 1e-6, counters
    and epoch exact, running stats within 1e-5 relative (1e-7 absolute
    near 0), the stats dict within 1e-4 relative."""
    from handarm_tpu_torch.convert import learner_to_leaves
    from handarm_tpu_torch.envs.registry import compose_task
    from handarm_tpu_torch.learn.ppo import PPO, PPOConfig
    from handarm_tpu_torch.utils.checkpoint import load_train_state
    from tests.test_torch_train import assert_same_lr, record_kls

    torch.set_num_threads(1)
    env, _ = compose_task("StretchLift", [f"num_envs={B}"], device="cpu")
    ppo = PPO(env, PPOConfig(horizon=HORIZON, minibatch_size=MINIBATCH, mini_epochs=EPOCHS,
                             hidden=HIDDEN))
    ts = load_train_state(str(ref["ckpt"]), "cpu", env_cfg=env.cfg)
    captured = {}
    update = ppo._update_from_traj

    def capture(ts_, traj, *args, **kw):
        captured["traj"] = traj
        return update(ts_, traj, *args, **kw)

    ppo._update_from_traj = capture
    kls = record_kls(ppo)
    new_ts, stats = ppo.train_iter(ts, noise=torch.as_tensor(ref["noise"]),
                                   perms=torch.as_tensor(ref["perms"]).long())
    traj = captured["traj"]
    got = {k: getattr(traj, k).numpy() for k in TRAJ_FIELDS}
    want = {k: ref[f"traj_{k}"] for k in TRAJ_FIELDS}
    np.testing.assert_array_equal(got["done"], want["done"])
    np.testing.assert_allclose(got["obs"], want["obs"], atol=2e-3)
    for k in ("mu", "action", "logp", "value"):
        np.testing.assert_allclose(got[k][0], want[k][0], atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["reward"], want["reward"], atol=1e-6)
    leaves = learner_to_leaves(new_ts) + [new_ts.epoch.numpy()]
    wl = [ref[f"learner_{i}"] for i in range(len(leaves))]
    P = len(new_ts.params)
    for i in range(P):
        np.testing.assert_allclose(leaves[i], wl[i], atol=1e-6, err_msg=f"param leaf {i}")
    for i in range(P, P + 4):
        np.testing.assert_array_equal(leaves[i], wl[i], err_msg=f"optax leaf {i}")
    for i in range(P + 4, 3 * P + 4):
        np.testing.assert_allclose(leaves[i], wl[i], atol=1e-6, err_msg=f"moment leaf {i}")
    for i in range(3 * P + 4, 3 * P + 10):
        # 1e-5 relative, and 1e-7 absolute (an ulp of the largest means, ~1)
        # where a mean sits near 0: a barely moving arm segment's 3e-4
        np.testing.assert_allclose(leaves[i], wl[i], rtol=1e-5, atol=1e-7,
                                   err_msg=f"stats leaf {i}")
    assert_same_lr(float(leaves[3 * P + 10]), float(wl[3 * P + 10]), kls)
    assert int(leaves[-1]) == int(wl[-1]) == 1
    for k in ("kl", "policy_loss", "value_loss", "reward_mean"):
        np.testing.assert_allclose(float(stats[k]), ref[f"stat_{k}"], rtol=1e-4, err_msg=k)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
