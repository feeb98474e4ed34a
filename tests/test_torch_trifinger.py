"""Trifinger: the port against the JAX package on the CPU, on the in-repo
stand-in TriFingerPro
(handarm_tpu_torch/assets/classic_standin/trifinger/robot_properties_fingers/
urdf/pro/trifingerpro.urdf; the JAX env reads it through a monkeypatched
`handarm_tpu.envs.trifinger.TRIFINGER_URDF`). Both packages' envs are built
once for the module at B = 16, the JAX step jitted once.

- The stand-in compiles alike in both packages (arrays within 1e-6; nv 9,
  the three fingers' joints and the three fingertip sites the env reads),
  the default joints lie inside its limits, `robots.spherefit` fits the
  same 21 spheres at 2 a link, and both envs build the same scene: the
  four walls, 91 contact slots, 41 observations and 9 actions.
- The reset from the JAX package's draws (re-derived from its keys and
  handed to the port's `reset` / `step`), exactly. Then the port's scripted
  grasp (`TrifingerEnv.grasp_actions`: 12 steps toward the cube's faces,
  12 closing on them) builds a contact state, which goes to the JAX
  package (its leaves through numpy, the JAX key kept), env 0 set to time
  out at the next step; 3 steps at B = 16 with random torques and the same
  draws then run on both. Observations and rewards within 2e-3 times
  max(1, the largest value), done flags exactly, every state leaf within
  2e-4 (positions) or 2e-3 (velocities, impulses) of the same scale. Every
  env's fingertips push on the cube at the start (robot-cube impulses),
  and env 0 restarts from the injected draws.
- The keypoints and the logistic kernel against the JAX functions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.envs import trifinger as jtri
from handarm_tpu.physics import model as jmodel
from handarm_tpu.robots import spherefit as jsf
from handarm_tpu_torch.convert import classic_state_from_leaves, classic_state_to_leaves
from handarm_tpu_torch.envs import trifinger as ttri
from handarm_tpu_torch.physics import model as tmodel
from handarm_tpu_torch.robots import spherefit as tsf
from test_torch_locomotion import _compare_models

torch.set_num_threads(1)
B = 16
POS_TOL, VEL_TOL = 2e-4, 2e-3
GRASP_STEPS = 12  # steps toward the faces, then as many closing on them
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def envs():
    """(JAX env, its jitted step, the port's env), all at B = 16."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtri, "TRIFINGER_URDF", ttri.TRIFINGER_URDF)
        jenv = jtri.make_trifinger(num_envs=B)
    return jenv, jax.jit(jenv.step), ttri.make_trifinger(num_envs=B, device="cpu")


def fresh_draws(key, n: int = B) -> ttri.TrifingerDraws:
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, n)`
    makes."""
    k_obj, k_goal, _ = jax.random.split(key, 3)
    kp_, kq = jax.random.split(k_goal)
    return ttri.TrifingerDraws(obj=_t(jax.random.uniform(k_obj, (n, 2))),
                               goal=_t(jax.random.uniform(kp_, (n, 3))),
                               yaw=_t(jax.random.uniform(kq, (n,), minval=-np.pi,
                                                         maxval=np.pi)))


def step_draws(state_key) -> ttri.TrifingerDraws:
    return fresh_draws(jax.random.split(state_key)[1])


def port_state(jstate):
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     ttri.TrifingerState)


def jax_state(tstate, like):
    """The port's state as the JAX package's, with `like`'s PRNG key."""
    leaves = [jnp.asarray(x) for x in classic_state_to_leaves(tstate)[:-1]] + [like.key]
    return jax.tree.unflatten(jax.tree.structure(like), leaves)


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


PHYSICS_NAMES = ("q", "qd", "targets", "opos", "oquat", "olin", "oang", "impulse")
VELOCITY_LEAVES = ("qd", "olin", "oang", "impulse")
OWN_NAMES = ("progress", "goal_pos", "goal_quat", "actions", "prev_tips", "prev_obj")


def assert_state_close(got, want):
    p = got.physics
    leaves = [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        got[1:])
    g = jax.tree.leaves(want)
    assert len(leaves) == len(g) - 1 == len(PHYSICS_NAMES + OWN_NAMES)  # the JAX key
    for name, a, b in zip(PHYSICS_NAMES + OWN_NAMES, leaves, g):
        if a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            _close(a, b, VEL_TOL if name in VELOCITY_LEAVES else POS_TOL, name)


def test_standin_compiles_alike(envs):
    jenv, _, tenv = envs
    path = ttri.TRIFINGER_URDF
    ja, ta = jmodel.compile_urdf(path), tmodel.compile_urdf(path)
    _compare_models(ta, ja)
    assert ta.nv == 9 and not ta.floating
    assert ta.joint_names == [f"finger_{j}_joint_{a}" for a in (0, 120, 240)
                              for j in ("base_to_upper", "upper_to_middle", "middle_to_lower")]
    assert set(ttri.TIP_SITES) <= set(ta.sites)
    assert ((ttri.DEFAULT_Q >= ta.q_min) & (ttri.DEFAULT_Q <= ta.q_max)).all()
    np.testing.assert_array_equal(ttri.DEFAULT_Q, jtri.DEFAULT_Q)
    jb, jc, jr = jsf.generic_collision_spheres(path, ja, 2)
    tb, tc, tr = tsf.generic_collision_spheres(path, ta, 2)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr, jr)
    assert len(tb) == 21 and sorted(set(tb.tolist())) == list(range(9))
    js, ts = jenv.scene, tenv.scene
    np.testing.assert_array_equal(ts.spheres.offset.numpy(), np.asarray(js.spheres.offset))
    np.testing.assert_array_equal(ts.geom.wall_lo, np.asarray(js.geom.wall_lo))
    np.testing.assert_array_equal(ts.geom.wall_hi, np.asarray(js.geom.wall_hi))
    assert (ts.slots.num_slots, ts.geom.num_walls) == (js.slots.num_slots, 4) == (91, 4)
    assert (tenv.num_obs, tenv.num_actions) == (jenv.num_obs, jenv.num_actions) == (41, 9)
    np.testing.assert_array_equal(tenv.tip_body, [s.body for s in jenv.tip_sites])


def test_keypoints_and_kernel_match():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(8, 3)).astype(np.float32)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(ttri.gen_keypoints(_t(pos), _t(q)).numpy(),
                               np.asarray(jtri.gen_keypoints(jnp.asarray(pos), jnp.asarray(q))),
                               atol=1e-6)
    x = rng.uniform(-0.3, 0.3, (8, 8)).astype(np.float32)
    np.testing.assert_allclose(ttri._lgsk(_t(x)).numpy(), np.asarray(jtri._lgsk(jnp.asarray(x))),
                               rtol=1e-6)


def test_reset_grasp_and_steps_match(envs):
    jenv, step, tenv = envs
    key = jax.random.PRNGKey(3)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key))
    _close(tobs, jobs, 1e-6, "reset obs")
    assert_state_close(ts, js)

    for i in range(2 * GRASP_STEPS):  # the port's scripted grasp
        ts, _ = tenv.step(ts, tenv.grasp_actions(ts, close=i >= GRASP_STEPS))
    slots = tenv.scene.slots
    robot_cube = torch.as_tensor((slots.robot_body >= 0) & (slots.obj_b == 0))
    pushed = ((ts.physics.contact_impulse.norm(dim=-1) > 0) & robot_cube).sum(-1)
    assert (pushed > 0).all(), pushed  # every env's fingertips on the cube
    ts = ts._replace(progress=ts.progress.clone())
    ts.progress[0] = jenv.cfg.episode_length - 1  # env 0 times out at the first step
    js = jax_state(ts, js)
    assert_state_close(port_state(js), js)

    rng = np.random.default_rng(5)
    for i in range(3):
        a = rng.uniform(-1.0, 1.0, (B, 9)).astype(np.float32)
        draws = step_draws(js.key)
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"keypoint_dist"}
        _close(tr.info["keypoint_dist"], jr.info["keypoint_dist"], POS_TOL, f"keypoints {i}")
        assert tr.teacher_obs.shape == (B, 0)
        assert_state_close(ts, js)
        if i == 0:
            np.testing.assert_array_equal(tr.done.numpy(), np.arange(B) == 0)
            np.testing.assert_array_equal(ts.physics.robot.q[0].numpy(), ttri.DEFAULT_Q)
            np.testing.assert_array_equal(ts.goal_pos[0].numpy(), np.asarray(js.goal_pos[0]))
