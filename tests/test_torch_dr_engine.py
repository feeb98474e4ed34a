"""The engine under domain randomization's per-env overrides: the port's
`compute_heavy` + `step` against the JAX package's `compute_heavy` +
`step(..., heavy=, fk0=, carry_fk=True)`, for each `EnvOverrides` field
alone and all four together, on two scenes of the stand-in robot at B = 8:

- Ur5SihLift's, from a reset, the box sliding on its walled bin's floor;
- Ur5SihMultiObjectManipulation's three YCB meshes in a mid-drop pile, so
  that object pairs are in contact and a mass scale acts on both sides of
  a slot (the records set up as tests/test_torch_multiobj.py sets them up).

In both the robot's PD targets are moved off its pose, so that the gains
act. The JAX side runs once in a subprocess (this file run as a script);
the overrides come from a numpy seed: gain scales U(0.75, 1.5) per dof,
gravity -9.81 + 0.4 N(0, 1) on z, mass scales U(0.5, 1.5) per object,
friction scales U(0.7, 1.3). Two sim steps: the first on compute_heavy's
FK and contacts, the second on the carried FK against the same heavy
prep.
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
MULTI = "Ur5SihMultiObjectManipulation"
B = 8
CASES = ("gain_scale", "gravity", "mass_scale", "friction_scale", "all")
SCENES = ("lift", "multiobj")


def overrides(case: str, nv: int, K: int) -> dict:
    """The override arrays of a case (float32, from a numpy seed)."""
    rng = np.random.default_rng(3)
    g = np.tile([0.0, 0.0, -9.81], (B, 1))
    g[:, 2] += 0.4 * rng.standard_normal(B)
    every = dict(gain_scale=rng.uniform(0.75, 1.5, (B, nv)), gravity=g,
                 mass_scale=rng.uniform(0.5, 1.5, (B, K)),
                 friction_scale=rng.uniform(0.7, 1.3, B))
    pick = every if case == "all" else {case: every[case]}
    return {k: v.astype(np.float32) for k, v in pick.items()}


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
    rng = np.random.default_rng(0)
    f = lambda x: jnp.asarray(x, jnp.float32)
    out = {}
    for name in SCENES:
        if name == "lift":
            env, _ = make_env("Ur5SihLift", [f"num_envs={B}"])
            state = env.reset(jax.random.PRNGKey(3))[0].physics
            # the box slides on the bin's floor, so that friction acts
            v = rng.uniform(-0.3, 0.3, state.objects.linvel.shape) * [1.0, 1.0, 0.0]
            state = state._replace(objects=state.objects._replace(linvel=f(v)))
        else:
            env, _ = make_env(MULTI, [f"num_envs={B}", "randomize=False"])
            K, C = env.cfg_num_objects, env.scene.slots.num_slots
            q0 = jnp.broadcast_to(jnp.asarray(env.robot.bringup_q, jnp.float32), (B, env.art.nv))
            xy = np.asarray(env.cfg.drop_pos[:2]) + rng.uniform(-0.03, 0.03, (B, K, 2))
            z = env.cfg.table_height + np.asarray(env.scene.shapes.bound_radius) * \
                rng.uniform(0.7, 1.2, (B, K))
            q = rng.standard_normal((B, K, 4))
            state = je.PhysicsState(
                robot=je.RobotState(q=q0, qd=jnp.zeros_like(q0), targets=q0),
                objects=je.ObjectState(
                    pos=f(np.concatenate([xy, z[..., None]], -1)),
                    quat=f(q / np.linalg.norm(q, axis=-1, keepdims=True)),
                    linvel=f(rng.normal(scale=0.3, size=(B, K, 3)) - [0, 0, 1.0]),
                    angvel=f(rng.normal(scale=1.0, size=(B, K, 3)))),
                contact_impulse=jnp.zeros((B, C, 3), jnp.float32))
        rob = state.robot
        state = state._replace(robot=rob._replace(
            targets=rob.q + f(rng.uniform(-0.2, 0.2, rob.q.shape)),
            qd=f(rng.normal(scale=0.1, size=rob.q.shape))))
        sc = env.scene

        def run(s, ovr):
            h = je.compute_heavy(sc, s, ovr)
            s1, _, fk1 = je.step(sc, s, ovr, heavy=h, fk0=h.fk0, contacts0=h.contacts0,
                                 carry_fk=True)
            s2, info, _ = je.step(sc, s1, ovr, heavy=h, fk0=fk1, carry_fk=True)
            return s2, info.max_penetration

        run = jax.jit(run)
        for i, leaf in enumerate(jax.tree.leaves(state)):
            out[f"{name}_pre_{i}"] = np.asarray(leaf)
        for case in CASES + ("none",):
            kw = {} if case == "none" else overrides(case, env.art.nv, env.cfg_num_objects)
            post, pen = run(state, je.EnvOverrides(**{k: f(v) for k, v in kw.items()}))
            for i, leaf in enumerate(jax.tree.leaves(post)):
                out[f"{name}_{case}_{i}"] = np.asarray(leaf)
            out[f"{name}_{case}_pen"] = np.asarray(pen)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    from tests.test_torch_multiobj import _record_copies

    tmp = tmp_path_factory.mktemp("dr_engine")
    root, cache = _record_copies(tmp)
    out = tmp / "ref.npz"
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, HANDARM_OBJECT_ROOT=str(root),
               HANDARM_SDF_CACHE=str(cache), JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1", **shared_jax_env(tmp))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def scenes():
    from handarm_tpu_torch.envs.tasks import make_env

    return {"lift": make_env("Ur5SihLift", device="cpu", num_envs=B).scene,
            "multiobj": make_env(MULTI, device="cpu", num_envs=B, randomize=False).scene}


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_") and k[len(tag) + 1:].isdigit()])
    return [ref[f"{tag}_{i}"] for i in range(n)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("scene", SCENES)
def test_engine_overrides_match(ref, scenes, scene, case):
    """Two sim steps under the overrides, from the same state: q, object
    positions and quaternions and the penetration within 2e-4, velocities
    and impulses within 2e-3 (tests/test_torch_multiobj.py's bounds). The
    overrides moved the JAX package's result away from the one without
    them by more than a bound; on the multi-object pile some object-pair
    slots carry impulses."""
    from handarm_tpu_torch.convert import physics_state_from_leaves
    from handarm_tpu_torch.physics import engine as te

    torch.set_num_threads(1)
    sc = scenes[scene]
    state = physics_state_from_leaves(_leaves(ref, f"{scene}_pre"))
    ovr = te.EnvOverrides(**{k: torch.as_tensor(v) for k, v in overrides(
        case, state.robot.q.shape[1], state.objects.pos.shape[1]).items()})
    h = te.compute_heavy(sc, state, ovr)
    s1, _, fk1 = te.step(sc, state, h, h.fk0, h.contacts0, ovr)
    s2, info, _ = te.step(sc, s1, h, fk1, ovr=ovr)
    want, base = _leaves(ref, f"{scene}_{case}"), _leaves(ref, f"{scene}_none")
    got = [s2.robot.q, s2.robot.qd, s2.robot.targets, *s2.objects, s2.contact_impulse]
    bounds = (2e-4, 2e-3, 2e-4, 2e-4, 2e-4, 2e-3, 2e-3, 2e-3)
    names = ("q", "qd", "targets", "obj pos", "obj quat", "obj linvel", "obj angvel", "impulse")
    for name, g, w, tol in zip(names, got, want, bounds):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
    np.testing.assert_allclose(info.max_penetration.numpy(), ref[f"{scene}_{case}_pen"],
                               atol=2e-4)
    moved = max(float(np.abs(w - b).max()) / tol for w, b, tol in zip(want, base, bounds))
    print(f"{scene} {case}: moved {moved:.2f} x the bound")
    assert moved > 1.0, f"{case} did not move the {scene} step"
    if scene == "multiobj":
        pair = torch.as_tensor((sc.slots.obj_a >= 0) & (sc.slots.obj_b >= 0))
        assert float(s2.contact_impulse[:, pair].abs().max()) > 1e-4


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
