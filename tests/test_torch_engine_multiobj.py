"""The engine's cadences and the arm's collision spheres on
Ur5SihMultiObjectManipulation: one env step under each engine option of
HandArmConfig, the port against the JAX package on the stand-in robot
with the three tracked YCB records.

The JAX side runs once in a subprocess (this file run as a script), set up
as tests/test_torch_multiobj.py sets it up: HANDARM_ASSET_ROOT at the
stand-in, the records copied under the keys of a temporary object root,
genesis off and the pose pool made from the JAX package's spawn poses. At
B = 8 (randomize=False, every episode clock at 0) it resets and puts each
env's target object, at rest, 3 cm below the lowest fingertip, so the
compared step has the hand pressing on a mesh object. From that state it
takes one env step with actions from a numpy seed under each option:
`heavy_prep_per_control=False` (also with domain randomization's physical
scales, a DRState drawn into the state), `carry_fk=False`, and
`hand_only_collision=False` (zero impulses on its 456 slots; the table's
edge moved off the arm's mount, as tests/test_torch_engine_lift.py says
why). The port starts from the same state (converted leaf by leaf).

Tolerances are tests/test_torch_multiobj.py's: 2e-4 on positions and
quaternions, 2e-3 on velocities, impulses, observations and rewards.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # the JAX side's subprocess
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tests.test_torch_engine_lift import DR, LEAF_TOLS, _leaves, env_config  # noqa: E402
from shared_jax_cache import shared_jax_env  # noqa: E402

STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
TASK = "Ur5SihMultiObjectManipulation"
B = 8
OPTIONS = {
    "heavy every sim step": dict(heavy_prep_per_control=False),
    "heavy every sim step, DR": dict(heavy_prep_per_control=False, dr=DR),
    "exact FK": dict(carry_fk=False),
    "arm spheres": dict(hand_only_collision=False, table_lo=(-0.5, 0.15)),
}


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs import randomization as jr
    from handarm_tpu.envs.genesis import InitialPool
    from handarm_tpu.envs.hand_arm import HandArmEnv
    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.robots.ur5sih import ASSET_ROOT

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    env, _ = make_env(TASK, [f"num_envs={B}", "randomize=False"])
    pos, quat = env._sample_object_poses(jax.random.PRNGKey(5), B)
    env.initial_pool = InitialPool(pos=pos[None], quat=quat[None])
    state, obs = env.reset(jax.random.PRNGKey(3))
    a, b = env.obs_slices["sih_fingertip_pos"]
    tips = np.asarray(obs)[:, a:b].reshape(B, 5, 3)
    low = tips[np.arange(B), tips[..., 2].argmin(-1)] - [0.0, 0.0, 0.03]
    t = np.asarray(state.task.target_obj)
    o = state.physics.objects
    put = lambda x, v: jnp.asarray(np.asarray(x)).at[jnp.arange(B), t].set(v)
    state = state._replace(
        physics=state.physics._replace(objects=o._replace(
            pos=put(o.pos, low), linvel=put(o.linvel, 0.0), angvel=put(o.angvel, 0.0))),
        task=state.task._replace(progress=jnp.zeros_like(state.task.progress)))
    actions = np.random.default_rng(0).uniform(-1, 1, (B, env.num_actions))
    act = jnp.asarray(actions, jnp.float32)
    out = {"actions": actions, "pool_pos": np.asarray(pos), "pool_quat": np.asarray(quat)}
    K, nv = env.cfg_num_objects, env.art.nv
    for n, (name, over) in enumerate(OPTIONS.items()):
        oenv = HandArmEnv(env_config(jr, env.cfg, over))
        oenv.initial_pool = env.initial_pool
        C = oenv.scene.slots.num_slots
        pre = state
        if C != env.scene.slots.num_slots:
            pre = pre._replace(physics=pre.physics._replace(
                contact_impulse=jnp.zeros((B, C, 3), jnp.float32)))
        if oenv.cfg.dr.enabled:
            pre = pre._replace(task=pre.task._replace(dr=jr.init_dr_state(
                oenv.cfg.dr, jax.random.PRNGKey(10 + n), B, K, nv, oenv.num_obs,
                oenv.num_actions)))
        post, res = jax.jit(oenv.step)(pre, act)
        out[f"{name}/slots"] = C
        out[f"{name}/obs"] = np.asarray(res.obs)
        out[f"{name}/reward"] = np.asarray(res.reward)
        out[f"{name}/done"] = np.asarray(res.done)
        for tag, st in (("pre", pre), ("post", post)):
            for i, leaf in enumerate(jax.tree.leaves(st)):
                out[f"{name}/{tag}_{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    from tests.test_torch_multiobj import _record_copies

    tmp = tmp_path_factory.mktemp("engine_multiobj")
    root, cache = _record_copies(tmp)
    out = tmp / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, HANDARM_OBJECT_ROOT=str(root),
               HANDARM_SDF_CACHE=str(cache), JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1",
               **shared_jax_env(tmp))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def base_env():
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.tasks import make_env

    return make_env(TASK, device="cpu", num_envs=B, randomize=False)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_env_step_under_option_matches(ref, base_env, option):
    """One Ur5SihMultiObjectManipulation env step (16 sweeps, the mesh SDFs)
    under the option from the same state and actions: the physics state,
    observations and rewards (tolerances in the module docstring). The
    hand pushes a mesh object; under DR the scales moved the result away
    from the same cadence's without them by more than the bound."""
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs import randomization as tr
    from handarm_tpu_torch.envs.genesis import InitialPool
    from handarm_tpu_torch.envs.hand_arm import HandArmEnv

    env = HandArmEnv(env_config(tr, base_env.cfg, OPTIONS[option]), "cpu")
    env.initial_pool = InitialPool(torch.as_tensor(ref["pool_pos"])[None],
                                   torch.as_tensor(ref["pool_quat"])[None])
    assert env.scene.slots.num_slots == int(ref[f"{option}/slots"])
    assert env.scene.slots.num_slots == (456 if option == "arm spheres" else 372)
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
    robot_obj = torch.as_tensor((env.scene.slots.robot_body >= 0)
                                & (env.scene.slots.obj_b >= 0))
    assert float(got.contact_impulse[:, robot_obj].abs().max()) > 1e-4  # the hand pushes
    if option.endswith("DR"):
        plain = _leaves(ref, f"{option[:-4]}/post_")
        moved = max(float(np.abs(w - p).max()) / tol
                    for (_, tol), w, p in zip(LEAF_TOLS, want, plain))
        assert moved > 1.0, f"DR did not move the {option[:-4]} step"


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
