"""Every engine path on the stand-in Ur5SihLift scene: two sim steps of the
port's engine against the JAX package's, states and StepInfo.

The JAX side runs once in a subprocess (this file run as a script,
HANDARM_ASSET_ROOT at the stand-in). It builds Ur5SihLift at B = 8 (127
slots, 8 sweeps, bf16 prep), resets, and sets up the compared state from a
numpy seed: in envs 0-3 the box 3 cm below the lowest fingertip (1 cm
into the hand's spheres), moving up into the hand at 0.5 m/s; in envs 4-7 the box on
the bin's floor, sliding and pressed down at 0.5 m/s (table contact); the
robot's joints moving and its PD targets off its pose. Both approaches
pass the restitution threshold. It then runs two sim steps of each path:
`step(scene, state)` (the mass structure every sim step), one
`compute_heavy` and `step(scene, state, heavy)` twice (exact FK against a
control step's mass structure), `SimParams.substep_contacts`,
`step(..., shared_prep=False)` (`substep`), and the generic anchored loop
under restitution 0.8 and under Gauss-Seidel. The port starts from the
same state (converted leaf by leaf).

Tolerances are the existing parity tests' (tests/test_torch_lift.py): 2e-4
on positions, quaternions and penetrations, 2e-3 on velocities and
impulses, and on the contact forces (impulse / h) 2e-3 / h.
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
B = 8
# path -> (SimParams fields, SolverParams fields, how the two sim steps run)
PATHS = {
    "heavy every sim step": (dict(), dict(), "plain"),
    "heavy once, exact FK": (dict(), dict(), "heavy"),
    "substep contacts": (dict(substep_contacts=True), dict(), "plain"),
    "substep": (dict(), dict(), "substep"),
    "restitution 0.8": (dict(), dict(restitution=0.8), "plain"),
    "gs": (dict(), dict(mode="gs"), "plain"),
}
LEAF_TOLS = (("q", 2e-4), ("qd", 2e-3), ("targets", 2e-4), ("obj pos", 2e-4),
             ("obj quat", 2e-4), ("obj linvel", 2e-3), ("obj angvel", 2e-3),
             ("impulse", 2e-3))


def path_scene(scene, sim: dict, solver: dict):
    """The scene with a path's SimParams and SolverParams fields (a JAX
    Scene is a NamedTuple, the port's a dataclass)."""
    p = scene.params._replace(solver=scene.params.solver._replace(**solver), **sim)
    if hasattr(scene, "_replace"):
        return scene._replace(params=p)
    return dataclasses.replace(scene, params=p)


def two_steps(eng, scene, state, how):
    """Two sim steps of a path (see the module docstring)."""
    heavy = eng.compute_heavy(scene, state) if how == "heavy" else None
    for _ in range(2):
        kw = dict(heavy=heavy) if heavy is not None else dict(shared_prep=how != "substep")
        state, info = eng.step(scene, state, **kw)[:2]
    return state, info


def _jax_reference(out_path: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.physics import engine as je
    from handarm_tpu.robots.ur5sih import ASSET_ROOT

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    env, _ = make_env("Ur5SihLift", [f"num_envs={B}"])
    state, obs = env.reset(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    a, b = env.obs_slices["sih_fingertip_pos"]
    tips = np.asarray(obs)[:, a:b].reshape(B, 5, 3)
    low = tips[np.arange(B), tips[..., 2].argmin(-1)] - [0.0, 0.0, 0.03]
    o, r = state.physics.objects, state.physics.robot
    pos = np.asarray(o.pos).copy()
    pos[:4, 0] = low[:4]
    lin = rng.uniform(-0.3, 0.3, (B, 1, 3)) * [1.0, 1.0, 0.0]
    lin[:4, 0, 2] = 0.5
    lin[4:, 0, 2] = -0.5
    f = lambda x: jnp.asarray(x, jnp.float32)
    physics = state.physics._replace(
        objects=o._replace(pos=f(pos), linvel=f(lin)),
        robot=r._replace(qd=f(rng.normal(scale=0.1, size=r.q.shape)),
                         targets=r.q + f(rng.uniform(-0.2, 0.2, r.q.shape))))
    out = {}
    for i, leaf in enumerate(jax.tree.leaves(physics)):
        out[f"pre_{i}"] = np.asarray(leaf)
    for name, (sim, solver, how) in PATHS.items():
        psc = path_scene(env.scene, sim, solver)
        post, info = jax.jit(lambda s, psc=psc, how=how: two_steps(je, psc, s, how))(physics)
        for i, leaf in enumerate(jax.tree.leaves(post)):
            out[f"{name}/{i}"] = np.asarray(leaf)
        for k, x in zip(info._fields, info):
            out[f"{name}/{k}"] = np.asarray(x)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine_paths") / "ref.npz"
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
def scene():
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.tasks import make_env

    return make_env("Ur5SihLift", device="cpu", num_envs=B).scene


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_path_on_lift_scene_matches(ref, scene, path):
    """Two sim steps of the path from the same state: the state and StepInfo
    against the JAX package's (tolerances in the module docstring). The
    hand starts 1 cm into the box in envs 0-3, and the box ends pressing on
    the bin's floor in envs 4-7."""
    from handarm_tpu_torch.convert import physics_state_from_leaves
    from handarm_tpu_torch.physics import engine as te
    from handarm_tpu_torch.physics.contacts import generate_contacts
    from handarm_tpu_torch.physics.kinematics import forward_kinematics

    sim, solver, how = PATHS[path]
    sc = path_scene(scene, sim, solver)
    pre = physics_state_from_leaves(_leaves(ref, "pre_"))
    state, info = two_steps(te, sc, pre, how)
    want = _leaves(ref, f"{path}/")
    leaves = [state.robot.q, state.robot.qd, state.robot.targets, *state.objects,
              state.contact_impulse]
    for (name, tol), g, w in zip(LEAF_TOLS, leaves, want):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
    h = sc.params.dt / sc.params.substeps
    for k, tol in (("body_contact_force", 2e-3 / h), ("obj_contact_force", 2e-3 / h),
                   ("max_penetration", 2e-4)):
        np.testing.assert_allclose(getattr(info, k).numpy(), ref[f"{path}/{k}"], atol=tol,
                                   err_msg=k)
    slots = sc.slots
    fk = forward_kinematics(sc.model, pre.robot.q, sc.base_quat[None], sc.base_pos[None])
    depth = generate_contacts(slots, sc.shapes, sc.spheres, sc.geom, pre.objects.pos,
                              pre.objects.quat, fk.body_quat, fk.body_pos).depth
    robot_obj = torch.as_tensor((slots.robot_body >= 0) & (slots.obj_b >= 0))
    assert bool((depth[:4][:, robot_obj].amax(-1) > 0.005).all())
    floor = torch.as_tensor((slots.obj_a >= 0) & (slots.robot_body < 0))
    assert float(state.contact_impulse[4:][:, floor].abs().max()) > 1e-4


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
