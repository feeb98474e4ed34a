"""The port's Ur5SihMultiObjectManipulation slice against the JAX package, on
the stand-in robot with the three tracked YCB records.

The JAX package reads its asset, object and cache roots when its modules
are imported, so its side runs once, in a subprocess (this file run as a
script), with HANDARM_ASSET_ROOT at the stand-in robot, HANDARM_OBJECT_ROOT
at a temporary directory of empty `ycb/<name>.urdf` files (object
resolution only lists names) and HANDARM_SDF_CACHE at a temporary directory
holding copies of the three records under the keys that root gives
(`load_object` then hits its cache and never parses a URDF). Genesis is
off there (HANDARM_DISABLE_GENESIS=1): the pool is made by the test from
the JAX package's spawn poses and handed to both packages. At B = 8 it
writes to one npz: the scene sizes and slots, a reset + policy warm-up +
one env step (randomize=False, every episode clock at 0), one contact
generation, a few heavy-less sim steps from a mid-drop state (genesis's
`engine.step(scene, state)`), and `objects_in_bin` on test positions.
"""

import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
CKPT = os.path.join(REPO, "docs", "evidence", "multiobj_r5a", "ckpt_2700.npz")
TASK = "Ur5SihMultiObjectManipulation"
B = 8
WARM_STEPS = 30
DROP_STEPS = 3


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs import objects as jobj
    from handarm_tpu.envs.genesis import InitialPool, objects_in_bin
    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.learn.networks import ActorCritic
    from handarm_tpu.learn.running_stats import normalize
    from handarm_tpu.physics import engine as je
    from handarm_tpu.physics.contacts import generate_contacts
    from handarm_tpu.physics.kinematics import forward_kinematics
    from handarm_tpu.robots.ur5sih import ASSET_ROOT
    from handarm_tpu.utils.checkpoint import load_checkpoint

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    assert os.environ["HANDARM_SDF_CACHE"] == jobj.CACHE_DIR
    env, _ = make_env(TASK, [f"num_envs={B}", "randomize=False"])
    pos, quat = env._sample_object_poses(jax.random.PRNGKey(5), B)
    env.initial_pool = InitialPool(pos=pos[None], quat=quat[None])
    state, obs = env.reset(jax.random.PRNGKey(3))
    ts = load_checkpoint(CKPT)
    net = ActorCritic(num_actions=env.num_actions)
    step = jax.jit(env.step)
    for _ in range(WARM_STEPS):
        mu = net.apply(ts.params, normalize(ts.obs_stats, obs))[0]
        state, res = step(state, mu)
        obs = res.obs
    # the policy's hand hovers over the pile after the warm-up: put each
    # env's target object (at rest) 3 cm below its lowest fingertip, so the
    # compared step has the hand pressing on a mesh object
    a, b = env.obs_slices["sih_fingertip_pos"]
    tips = np.asarray(env.observe(state)[0])[:, a:b].reshape(B, 5, 3)
    low = tips[np.arange(B), tips[..., 2].argmin(-1)] - [0.0, 0.0, 0.03]
    t = np.asarray(state.task.target_obj)
    o = state.physics.objects
    put = lambda x, v: jnp.asarray(np.asarray(x)).at[jnp.arange(B), t].set(v)
    state = state._replace(
        physics=state.physics._replace(objects=o._replace(
            pos=put(o.pos, low), linvel=put(o.linvel, 0.0), angvel=put(o.angvel, 0.0))),
        task=state.task._replace(progress=jnp.zeros_like(state.task.progress)))
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (B, env.num_actions))
    post, res = step(state, jnp.asarray(actions, jnp.float32))
    sc = env.scene
    fk = forward_kinematics(sc.model, state.physics.robot.q, sc.base_quat[None], sc.base_pos[None])
    o = state.physics.objects
    con = generate_contacts(sc.slots, sc.shapes, sc.spheres, sc.geom, o.pos, o.quat,
                            fk.body_quat, fk.body_pos)
    out = dict(
        actions=actions, obs_pre=np.asarray(env.observe(state)[0]), obs=np.asarray(res.obs),
        reward=np.asarray(res.reward), done=np.asarray(res.done),
        num_slots=sc.slots.num_slots, num_obs=env.num_obs, num_actions=env.num_actions,
        object_names=np.asarray(env.object_names), pool_pos=np.asarray(pos),
        pool_quat=np.asarray(quat), contact_normal=np.asarray(con.normal),
        contact_pos=np.asarray(con.pos), contact_depth=np.asarray(con.depth),
        **{f"slot_{k}": np.asarray(getattr(sc.slots, k))
           for k in ("robot_body", "obj_a", "obj_b", "friction")},
    )
    for tag, st in (("pre", state), ("post", post)):
        for i, leaf in enumerate(jax.tree.leaves(st)):
            out[f"{tag}_{i}"] = np.asarray(leaf)

    # genesis's heavy-less sim step from a mid-drop state: the robot parked
    # in its bringup pose, the objects falling onto the table and each other
    K, nv, C = env.cfg_num_objects, env.art.nv, sc.slots.num_slots
    q0 = jnp.broadcast_to(jnp.asarray(env.robot.bringup_q, jnp.float32), (B, nv))
    xy = np.asarray(env.cfg.drop_pos[:2]) + rng.uniform(-0.03, 0.03, (B, K, 2))
    z = env.cfg.table_height + np.asarray(sc.shapes.bound_radius) * rng.uniform(0.7, 1.2, (B, K))
    q = rng.standard_normal((B, K, 4))
    f = lambda x: jnp.asarray(x, jnp.float32)
    g0 = je.PhysicsState(
        robot=je.RobotState(q=q0, qd=jnp.zeros_like(q0), targets=q0),
        objects=je.ObjectState(
            pos=f(np.concatenate([xy, z[..., None]], -1)),
            quat=f(q / np.linalg.norm(q, axis=-1, keepdims=True)),
            linvel=f(rng.normal(scale=0.3, size=(B, K, 3)) - [0, 0, 1.0]),
            angvel=f(rng.normal(scale=1.0, size=(B, K, 3)))),
        contact_impulse=jnp.zeros((B, C, 3), jnp.float32),
    )
    estep = jax.jit(lambda s: je.step(sc, s)[0])
    g = g0
    for _ in range(DROP_STEPS):
        g = estep(g)
    for tag, st in (("drop0", g0), ("drop", g)):
        for i, leaf in enumerate(jax.tree.leaves(st)):
            out[f"{tag}_{i}"] = np.asarray(leaf)
    test_pos = np.asarray(env.cfg.drop_pos) + rng.uniform(-0.4, 0.4, (B, K, 3))
    test_pos[..., 2] = rng.uniform(0.4, 0.8, (B, K))
    out["bin_test_pos"] = test_pos
    out["in_bin"] = np.asarray(objects_in_bin(env, f(test_pos)))
    np.savez(out_path, **out)


def _record_copies(tmp):
    """Object root with empty URDFs and a cache of the records renamed to
    the keys that root gives."""
    from handarm_tpu_torch.envs.objects import CACHE_DIR, RECORD_KEYS

    root, cache = tmp / "objects", tmp / "cache"
    cache.mkdir()
    for name, key in RECORD_KEYS.items():
        set_name, obj = name.split("/")
        (root / set_name).mkdir(parents=True, exist_ok=True)
        (root / set_name / f"{obj}.urdf").write_text("")
        path = f"{root}/{set_name}/{obj}.urdf"
        new_key = hashlib.sha1(f"{path}:32:64:v4".encode()).hexdigest()[:16]
        shutil.copyfile(CACHE_DIR / f"{key}.npz", cache / f"{new_key}.npz")
    return root, cache


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiobj")
    root, cache = _record_copies(tmp)
    out = tmp / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, HANDARM_OBJECT_ROOT=str(root),
               HANDARM_SDF_CACHE=str(cache), JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1",
               JAX_COMPILATION_CACHE_DIR=str(tmp / "jax_cache"))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_")])
    return [ref[f"{tag}_{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def port_env(ref):
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.genesis import InitialPool
    from handarm_tpu_torch.envs.tasks import make_env

    env = make_env(TASK, device="cpu", num_envs=B, randomize=False)
    env.initial_pool = InitialPool(torch.as_tensor(ref["pool_pos"])[None],
                                   torch.as_tensor(ref["pool_quat"])[None])
    return env


def test_scene_and_slots_match(ref, port_env):
    """The JAX package builds Ur5SihMultiObjectManipulation on the stand-in
    with the port's scene: the three YCB objects in the registry's order,
    C = 372 contact slots (3 x 64 object points vs table, 33 hand spheres
    vs table, 33 x 3 spheres vs the mesh SDFs, 3 x 2 x 8 object-pair
    points; no walls), 147 observations, 11 actions, identical slots."""
    slots = port_env.scene.slots
    print(f"Ur5SihMultiObjectManipulation on the stand-in: C = {slots.num_slots}")
    assert int(ref["num_slots"]) == slots.num_slots == 372
    assert int(ref["num_obs"]) == port_env.num_obs == 147
    assert int(ref["num_actions"]) == port_env.num_actions == 11
    assert list(ref["object_names"]) == port_env.object_names
    for k in ("robot_body", "obj_a", "obj_b", "friction"):
        np.testing.assert_array_equal(getattr(slots, k), ref[f"slot_{k}"], err_msg=k)


def test_contacts_match(ref, port_env):
    """One contact generation on the transferred pre-step state: spheres vs
    the mesh SDFs and the object-pair points through the SDF sampler.
    Tolerance 1e-4: float32 FK of 17 joints in another order."""
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.physics.contacts import generate_contacts
    from handarm_tpu_torch.physics.kinematics import forward_kinematics

    st = env_state_from_leaves(_leaves(ref, "pre")).physics
    sc = port_env.scene
    fk = forward_kinematics(sc.model, st.robot.q, sc.base_quat[None], sc.base_pos[None])
    con = generate_contacts(sc.slots, sc.shapes, sc.spheres, sc.geom, st.objects.pos,
                            st.objects.quat, fk.body_quat, fk.body_pos)
    depth = ref["contact_depth"]
    near = depth > -0.5  # masked slots carry a 1e6 sentinel distance
    np.testing.assert_allclose(con.depth.numpy()[near], depth[near], atol=1e-4)
    np.testing.assert_allclose(con.normal.numpy(), ref["contact_normal"], atol=1e-4)
    np.testing.assert_allclose(con.pos.numpy()[near], ref["contact_pos"][near], atol=1e-4)
    assert (depth > -0.02).sum() > 0  # some slots are active


def test_observations_match(ref, port_env):
    """The 147 observations of the same state (three objects' positions and
    OBBs). Tolerance 1e-4, as for the lift."""
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.hand_arm import ObsContext

    state = env_state_from_leaves(_leaves(ref, "pre"))
    obs = port_env._compute_obs(ObsContext(port_env, state))
    np.testing.assert_allclose(obs.numpy(), ref["obs_pre"], atol=1e-4, rtol=1e-4)


def test_env_step_matches(ref, port_env):
    """One Ur5SihMultiObjectManipulation env step (3 sim steps x 2 anchored
    substeps x 8 sweeps, bf16 solver prep, heavy prep per control step,
    carried FK, reposition reward) after the ckpt_2700 policy's warm-up,
    with every target object placed under the hand, from the same state and
    actions. No env resets in this step, so every
    env is compared, at the lift test's bounds: 2e-4 on positions, 2e-3 on
    velocities, impulses and observations."""
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


def test_genesis_step_matches(ref, port_env):
    """`engine.step_exact` (compute_heavy + step on its contact set) against
    the JAX package's heavy-less `engine.step(scene, state)` over 3 sim
    steps from a mid-drop state: objects falling onto the table and into
    each other. Bounds as for the env step."""
    from handarm_tpu_torch.convert import physics_state_from_leaves
    from handarm_tpu_torch.physics.engine import step_exact

    g = physics_state_from_leaves(_leaves(ref, "drop0"))
    for _ in range(DROP_STEPS):
        g, _ = step_exact(port_env.scene, g)
    want = _leaves(ref, "drop")
    for name, x, w, tol in (
        ("q", g.robot.q, want[0], 2e-4), ("qd", g.robot.qd, want[1], 2e-3),
        ("obj pos", g.objects.pos, want[3], 2e-4), ("obj quat", g.objects.quat, want[4], 2e-4),
        ("obj linvel", g.objects.linvel, want[5], 2e-3),
        ("obj angvel", g.objects.angvel, want[6], 2e-3),
        ("impulse", g.contact_impulse, want[7], 2e-3),
    ):
        np.testing.assert_allclose(x.numpy(), w, atol=tol, err_msg=name)
    assert float(g.contact_impulse.abs().max()) > 1e-4  # the objects landed


def test_objects_in_bin_and_workspace_match(ref, port_env):
    """`objects_in_bin` on the same positions as the JAX package, and the
    workspace fallback's test (more than 5 cm outside workspace_lo/hi) as
    handarm_tpu/envs/genesis.py writes it."""
    from handarm_tpu_torch.envs.genesis import objects_in_bin, outside_workspace

    pos = torch.as_tensor(ref["bin_test_pos"], dtype=torch.float32)
    got = objects_in_bin(port_env, pos).numpy()
    np.testing.assert_array_equal(got, ref["in_bin"])
    assert got.any() and not got.all()
    lo, hi = np.asarray(port_env.cfg.workspace_lo), np.asarray(port_env.cfg.workspace_hi)
    p = ref["bin_test_pos"].astype(np.float32)
    want = np.any((p < lo - 0.05) | (p > hi + 0.05), axis=-1)
    np.testing.assert_array_equal(outside_workspace(port_env, pos).numpy(), want)


def test_build_initial_pool_settles():
    """Genesis at B = 4 on the CPU with shortened drops (30 sim steps) and
    settles (up to 150, checked every 30): every object ends inside the
    workspace and at rest, with its quaternion normalized."""
    from handarm_tpu_torch.envs.genesis import build_initial_pool, outside_workspace
    from handarm_tpu_torch.envs.tasks import make_env
    from handarm_tpu_torch.physics.engine import ObjectState, step_exact

    torch.set_num_threads(1)
    env = make_env(TASK, device="cpu", num_envs=4)
    gen = torch.Generator().manual_seed(23 + 4)
    pool = build_initial_pool(env, gen, drop_steps=30, settle_steps=150)
    assert pool.pos.shape == (1, 4, 3, 3) and pool.quat.shape == (1, 4, 3, 4)
    assert 3 * 60 <= pool.sim_steps <= 3 * 180
    assert not outside_workspace(env, pool.pos[0]).any()
    np.testing.assert_allclose(torch.linalg.vector_norm(pool.quat, dim=-1).numpy(), 1.0, atol=1e-5)
    # at rest: from the pool with zero velocities, 5 sim steps move nothing
    st = env.fresh_state(4).physics
    st = st._replace(objects=ObjectState(pool.pos[0], pool.quat[0],
                                         torch.zeros(4, 3, 3), torch.zeros(4, 3, 3)))
    for _ in range(5):
        st, _ = step_exact(env.scene, st)
    assert float((st.objects.pos - pool.pos[0]).abs().max()) < 2e-3
    assert float(torch.linalg.vector_norm(st.objects.linvel, dim=-1).max()) < 0.05


def test_pool_cache_reads_what_genesis_wrote(tmp_path, monkeypatch):
    """With HANDARM_POOL_CACHE naming a directory, the first env of a config
    runs genesis (shortened here) and writes its pool; an env of the same
    config under domain randomization (left out of the hash: genesis steps
    the scene without it) reads that file back, equal; another drop count
    gets a file of its own; unset, nothing is cached."""
    from handarm_tpu_torch.envs.randomization import DRConfig
    from handarm_tpu_torch.envs.tasks import make_env

    torch.set_num_threads(1)
    short = dict(device="cpu", num_envs=4, drop_num_steps=10, settle_num_steps=10)
    monkeypatch.setenv("HANDARM_POOL_CACHE", str(tmp_path))
    env = make_env(TASK, **short)
    env.initialize_pool()
    assert os.listdir(tmp_path) == [os.path.basename(env.pool_cache_path())]
    dr = make_env(TASK, dr=DRConfig(enabled=True, gravity_noise=0.4), **short)
    assert dr.pool_cache_path() == env.pool_cache_path()
    dr.initialize_pool()
    for a, b in zip(env.initial_pool, dr.initial_pool):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert env.initial_pool.sim_steps > 0
    other = make_env(TASK, **dict(short, drop_num_steps=12))
    assert other.pool_cache_path() != env.pool_cache_path()
    monkeypatch.delenv("HANDARM_POOL_CACHE")
    assert env.pool_cache_path() is None


@pytest.mark.parametrize("prob", [1.0, 0.0])
def test_disturbance(prob):
    """The object disturbance: with probability 1 every object's velocity
    kick has norm magnitude * dt (15 / 60 m/s), with probability 0 none."""
    from handarm_tpu_torch.envs.tasks import make_env

    env = make_env(TASK, device="cpu", num_envs=4, disturbance_probability=prob)
    assert env.cfg.randomize
    dv = env._disturbance(64)
    norms = torch.linalg.vector_norm(dv, dim=-1).numpy()
    np.testing.assert_allclose(norms, 15.0 / 60.0 * prob, rtol=1e-6, atol=1e-7)


def test_rollout_entry_point_multiobj_on_cpu():
    """`python -m handarm_tpu_torch.rollout --task Ur5SihMultiObjectManipulation
    --envs 4 --steps 2 --device cpu` with genesis shortened by its
    arguments: genesis runs first, then the ckpt_2700 policy drives the
    372-slot scene; on CPU tensors no kernel launches."""
    from handarm_tpu_torch import rollout

    torch.set_num_threads(1)
    out = rollout.run(envs=4, steps=2, device="cpu", task=TASK, drop_num_steps=10,
                      settle_num_steps=10)
    assert out["task"] == TASK and out["slots"] == 372
    assert out["genesis_sim_steps"] == 3 * 20 and out["genesis_seconds"] > 0
    assert np.isfinite(out["mean_reward"]) and out["env_steps_per_s"] > 0
    assert set(out["launches"].values()) == {0}


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
