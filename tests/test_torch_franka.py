"""FrankaCubeStack and operational-space control: the port against the JAX
package on the CPU, on the in-repo stand-in Franka
(handarm_tpu_torch/assets/classic_standin/franka_description/robots/
franka_panda_gripper.urdf; the JAX envs read it through monkeypatched
`handarm_tpu.envs.franka.FRANKA_URDF` and
`handarm_tpu.envs.franka_cabinet.FRANKA_URDF`).

- The stand-in compiles alike in both packages (arrays within 1e-6; nv 9,
  the seven revolute and two prismatic joints, the four sites the tasks
  read), both tasks' default joint positions lie inside its limits, and
  `robots.spherefit` fits the same 30 spheres, entry for entry, at 3 a
  link.
- `physics.osc.eef_jacobian` and `osc_torques` against the JAX functions
  on seeded numpy states of the stand-in (the same FK and Minv handed to
  both): the Jacobian within 1e-6, the torques within 1e-4 of max(1, their
  largest value) (a 6 x 6 inverse and a 9 x 9 solve in float32 in two
  libraries), at random joint positions, at joint positions whose
  posture error wraps (q_default - q + pi < 0, where a truncating modulo
  would keep the sign), and with a NaN row of Minv, which must not raise
  and must leave that env's torques non-finite in both packages and the
  others finite.
- The reset from the JAX package's draws (re-derived from its keys and
  handed to the port's `reset` / `step`), exactly; then the JAX env drives
  the grip site toward cubeA with the gripper open for 45 steps (a
  scripted OSC approach, so that spheres of the hand touch the cube and
  the table), its state goes to the port, and 2 steps at B = 8 with random
  actions (the gripper opening and closing) run on both, env 0 timing out
  at the first (its fresh episode from the injected draws). Observations
  and rewards within 2e-3 times max(1, the largest value), every state
  leaf within 2e-4 (positions) or 2e-3 (velocities, impulses) of the same
  scale, done flags exactly.
- The JAX package's own checks of tests/test_franka.py, in both packages:
  the cubes rest on the table after 60 zero-action steps
  (`test_franka_spaces_and_rest`), and a constant downward dpose with the
  gripper open for 40 steps moves the grip site down by more than 5 cm
  (`test_franka_osc_tracks_dpose`). The stand-in's grip site starts 0.19 m
  over the table and its fingertips reach it after 18-20 steps; pushed on
  into the table, the wrist (no orientation stiffness in the dpose action)
  turns and the fingertips slide 0.2-0.4 m by step 40, in both packages.
  So the sideways check is held over the free descent, the steps before
  the first robot impulse (at least 10): down by more than 5 cm, sideways
  by less than that and under 1 cm.
- spd_inverse's plain version at n = 9 against the JAX package's jnp
  fallback (atol 1e-5, the bound of tests/test_pallas_ops.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.envs import franka as jfr
from handarm_tpu.envs import franka_cabinet as jcab
from handarm_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from handarm_tpu.physics import dynamics as jdyn
from handarm_tpu.physics import kinematics as jkin
from handarm_tpu.physics import model as jmodel
from handarm_tpu.physics import osc as josc
from handarm_tpu.robots import spherefit as jsf
from handarm_tpu_torch.convert import classic_state_from_leaves
from handarm_tpu_torch.envs import franka as tfr
from handarm_tpu_torch.envs import franka_cabinet as tcab
from handarm_tpu_torch.ops import spd_inverse as tspd
from handarm_tpu_torch.physics import model as tmodel
from handarm_tpu_torch.physics import osc as tosc
from handarm_tpu_torch.physics.kinematics import FK
from handarm_tpu_torch.robots import spherefit as tsf
from test_pallas_ops import spd_batch
from test_torch_locomotion import _compare_models

torch.set_num_threads(1)
B = 8
POS_TOL, VEL_TOL = 2e-4, 2e-3
APPROACH = 45  # scripted steps toward cubeA before the compared steps
SITES = ("panda_hand", "panda_grip_site", "panda_leftfinger_tip", "panda_rightfinger_tip")
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def jax_stack():
    """The JAX package's FrankaCubeStack at B = 8 on the stand-in, and its
    jitted step (compiled once for the module)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfr, "FRANKA_URDF", tfr.FRANKA_URDF)
        env = jfr.make_franka_cube_stack(num_envs=B)
    return env, jax.jit(env.step)


def fresh_draws(key, B: int):
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, B)`
    makes."""
    kA, kB, _, _ = jax.random.split(key, 4)
    u = lambda k: _t(jax.random.uniform(k, (B, 2), minval=-1.0, maxval=1.0))
    return tfr.FrankaDraws(u(kA), u(kB))


def step_draws(state_key, B: int):
    return fresh_draws(jax.random.split(state_key)[1], B)


def port_state(jstate):
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     tfr.FrankaState)


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


PHYSICS_NAMES = ("q", "qd", "targets", "opos", "oquat", "olin", "oang", "impulse")
VELOCITY_LEAVES = ("qd", "olin", "oang", "impulse")


def assert_state_close(got, want, own_names):
    """Every leaf of a Franka state within 2e-4 (positions) or 2e-3
    (velocities) of max(1, its largest value); integers exactly."""
    p = got.physics
    leaves = [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        got[1:])
    names = PHYSICS_NAMES + own_names
    g = jax.tree.leaves(want)
    assert len(leaves) == len(g) - 1 == len(names)  # the JAX key
    for name, a, b in zip(names, leaves, g):
        if a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            _close(a, b, VEL_TOL if name in VELOCITY_LEAVES else POS_TOL, name)


# --- the stand-in ------------------------------------------------------------------


def test_standin_compiles_alike():
    path = tfr.FRANKA_URDF
    ja, ta = jmodel.compile_urdf(path), tmodel.compile_urdf(path)
    _compare_models(ta, ja)
    assert ta.nv == 9 and not ta.floating
    assert ta.joint_names == [f"panda_joint{i}" for i in range(1, 8)] + [
        "panda_finger_joint1", "panda_finger_joint2"]
    assert list(ta.joint_type) == [tmodel.REVOLUTE] * 7 + [tmodel.PRISMATIC] * 2
    assert set(SITES) <= set(ta.sites)
    hand = ta.sites["panda_hand"].body
    assert hand == ta.sites["panda_grip_site"].body == 6  # link 7's body
    for dof in (tfr.DEFAULT_DOF, tcab.DEFAULT_DOF, jfr.DEFAULT_DOF, jcab.DEFAULT_DOF):
        assert ((dof >= ta.q_min) & (dof <= ta.q_max)).all(), dof
    np.testing.assert_array_equal(tfr.DEFAULT_DOF, jfr.DEFAULT_DOF)
    np.testing.assert_array_equal(tcab.DEFAULT_DOF, jcab.DEFAULT_DOF)
    np.testing.assert_array_equal(ta.effort_limit, [87.0] * 4 + [12.0] * 3 + [20.0] * 2)
    jb, jc, jr = jsf.generic_collision_spheres(path, ja, 3)
    tb, tc, tr = tsf.generic_collision_spheres(path, ta, 3)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr, jr)
    assert len(tb) == 30 and sorted(set(tb.tolist())) == list(range(9))
    spheres = tsf.make_generic_spheres(path, ta, spheres_per_link=3)
    jspheres = jsf.make_generic_spheres(path, ja, spheres_per_link=3)
    np.testing.assert_array_equal(spheres.offset.numpy(), np.asarray(jspheres.offset))
    np.testing.assert_array_equal(spheres.radius.numpy(), np.asarray(jspheres.radius))


# --- operational-space control --------------------------------------------------------


def _osc_inputs(case: str, seed: int = 0):
    """(JAX env, FK leaves, Minv, dpose, eef_vel, q, qd, grip point) of a
    seeded state of the stand-in at B = 16."""
    rng = np.random.default_rng(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfr, "FRANKA_URDF", tfr.FRANKA_URDF)
        env = jfr.make_franka_cube_stack(num_envs=4)
    art = env.art
    n = 16
    q = rng.uniform(art.q_min, art.q_max, (n, 9)).astype(np.float32)
    if case == "wrap":  # q_default - q + pi < 0 on the arm's joints
        q[:, :7] = (jfr.DEFAULT_DOF[:7] + np.pi + rng.uniform(0.1, 1.5, (n, 7))).astype(
            np.float32)
    qd = rng.normal(0.0, 0.5, (n, 9)).astype(np.float32)
    sc = env.scene
    fk = jkin.forward_kinematics(sc.model, jnp.asarray(q),
                                 jnp.broadcast_to(sc.base_quat, (n, 4)),
                                 jnp.broadcast_to(sc.base_pos, (n, 3)))
    dyn = jdyn.compute_dyn(sc.model, fk, jnp.asarray(qd), jnp.zeros(3), sc.kp, sc.kd,
                           env.cfg.dt / env.cfg.substeps)
    minv = np.asarray(dyn.Minv).copy()
    if case == "nan":
        minv[3, 2, 5] = np.nan
    p = np.asarray(fk.body_pos[:, env.hand_body]) + rng.normal(0.0, 0.05, (n, 3))
    return (env, fk, minv, rng.uniform(-0.1, 0.1, (n, 6)).astype(np.float32),
            rng.normal(0.0, 0.3, (n, 6)).astype(np.float32), q, qd, p.astype(np.float32))


@pytest.mark.parametrize("case", ["random", "wrap", "nan"])
def test_osc_matches(case):
    env, jfk, minv, dpose, eef_v, q, qd, p = _osc_inputs(case, seed=["random", "wrap",
                                                                   "nan"].index(case))
    tfk = FK(*(_t(x) for x in jfk))
    tm = tmodel.compile_urdf(tfr.FRANKA_URDF)
    from handarm_tpu_torch.physics.kinematics import model_arrays

    m = model_arrays(tm)
    mask = np.array([1.0] * 7 + [0.0] * 2, np.float32)
    jJ = josc.eef_jacobian(env.scene.model, jfk, env.hand_body, jnp.asarray(p))
    tJ = tosc.eef_jacobian(m, tfk, env.hand_body, _t(p))
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=1e-6)
    jJ = jJ * jnp.asarray(mask)[None, None]
    want = np.asarray(josc.osc_torques(jnp.asarray(minv), jJ, jnp.asarray(dpose),
                                       jnp.asarray(eef_v), jnp.asarray(q), jnp.asarray(qd),
                                       jnp.asarray(jfr.DEFAULT_DOF), kp=150.0,
                                       arm_mask=jnp.asarray(mask)))
    got = tosc.osc_torques(_t(minv), _t(jJ), _t(dpose), _t(eef_v), _t(q), _t(qd),
                           _t(jfr.DEFAULT_DOF), kp=150.0, arm_mask=_t(mask)).numpy()
    finite = np.isfinite(want).all(-1)
    np.testing.assert_array_equal(np.isfinite(got).all(-1), finite)
    if case == "nan":
        assert not finite[3] and finite[np.arange(16) != 3].all()
    else:
        assert finite.all()
    _close(got[finite], want[finite], 1e-4, f"osc torques ({case})")
    if case == "wrap":  # the wrapped posture error is what the torques hold
        err = np.remainder(jfr.DEFAULT_DOF[None] - q + np.pi, 2 * np.pi) - np.pi
        assert (np.abs(err) <= np.pi).all()
        assert (jfr.DEFAULT_DOF[None, :7] - q[:, :7] + np.pi < 0).all()


# --- env steps ----------------------------------------------------------------------


def _toward_cube(obs):
    """The scripted approach: the grip site toward cubeA's top (dpose from
    the observation's cubeA and grip positions), the gripper open."""
    obs = np.asarray(obs)
    err = obs[:, 4:7] + np.array([0.0, 0.0, 0.01]) - obs[:, 10:13]
    a = np.zeros((len(obs), 7), np.float32)
    a[:, :3] = np.clip(err * 10.0, -1.0, 1.0)
    a[:, 6] = 1.0
    return jnp.asarray(a)


def test_cube_stack_reset_and_steps_match(jax_stack):
    jenv, step = jax_stack
    tenv = tfr.make_franka_cube_stack(num_envs=B, device="cpu")
    assert (tenv.num_obs, tenv.num_actions, tenv.scene.slots.num_slots) == (
        jenv.num_obs, jenv.num_actions, jenv.scene.slots.num_slots) == (19, 7, 134)
    key = jax.random.PRNGKey(4)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key, B))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert_state_close(ts, js, ("progress", "actions"))

    obs = jobs
    for _ in range(APPROACH):
        js, jr = step(js, _toward_cube(obs))
        obs = jr.obs
    assert not np.asarray(jr.done).any()
    # spheres of the hand on cubeA in most envs, and impulses on the robot
    slots = jenv.scene.slots
    robot_cube = (slots.robot_body >= 0) & (slots.obj_b == 0)
    imp = np.abs(np.asarray(js.physics.contact_impulse)).sum(-1)
    assert (imp[:, robot_cube].sum(-1) > 0).sum() >= B // 2, imp[:, robot_cube].sum(-1)
    prog = np.asarray(js.progress).copy()
    prog[0] = jenv.cfg.episode_length - 1  # env 0 times out at the first step
    js = js._replace(progress=jnp.asarray(prog))
    ts = port_state(js)
    rng = np.random.default_rng(5)
    for i in range(2):
        a = rng.uniform(-1.0, 1.0, (B, 7)).astype(np.float32)
        draws = step_draws(js.key, B)
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"stacked_frac"}
        _close(tr.info["stacked_frac"], jr.info["stacked_frac"], 0.0, "stacked")
        assert tr.teacher_obs.shape == (B, 0)
        assert_state_close(ts, js, ("progress", "actions"))
        if i == 0:
            np.testing.assert_array_equal(tr.done.numpy(), np.arange(B) == 0)


# --- the JAX package's own checks, in both packages ---------------------------------


def test_cubes_rest_and_osc_tracks_in_both(jax_stack):
    jenv, step = jax_stack
    tenv = tfr.make_franka_cube_stack(num_envs=B, device="cpu")
    key = jax.random.PRNGKey(0)
    js, _ = jenv.reset(key)
    ts, _ = tenv.reset(0, fresh_draws(key, B))
    for _ in range(60):  # tests/test_franka.py:10-22
        js, jr = step(js, jnp.zeros((B, 7)))
        ts, tr = tenv.step(ts, torch.zeros(B, 7))
    for name, z, obs in (("jax", np.asarray(js.physics.objects.pos[:, :, 2]), jr.obs),
                         ("port", ts.physics.objects.pos[:, :, 2].numpy(), tr.obs)):
        np.testing.assert_allclose(z[:, 0], 1.05, atol=0.01, err_msg=name)
        np.testing.assert_allclose(z[:, 1], 1.06, atol=0.01, err_msg=name)
        assert np.isfinite(np.asarray(obs)).all(), name

    key = jax.random.PRNGKey(1)  # tests/test_franka.py:25-40
    js, _ = jenv.reset(key)
    ts, _ = tenv.reset(0, fresh_draws(key, B))
    down = np.zeros((B, 7), np.float32)
    down[:, 2], down[:, 6] = -1.0, 1.0
    robot = torch.as_tensor(jenv.scene.slots.robot_body >= 0)
    runs = {"jax": [np.asarray(jenv._eef(js.physics)[1])],
            "port": [tenv._eef(ts.physics)[1].numpy()]}
    touched = {"jax": [], "port": []}
    for _ in range(40):
        js, _ = step(js, jnp.asarray(down))
        ts, _ = tenv.step(ts, _t(down))
        runs["jax"].append(np.asarray(jenv._eef(js.physics)[1]))
        runs["port"].append(tenv._eef(ts.physics)[1].numpy())
        for name, imp in (("jax", _t(js.physics.contact_impulse)),
                          ("port", ts.physics.contact_impulse)):
            touched[name].append(((imp.norm(dim=-1) > 0) & robot).any(-1).numpy())
    for name in runs:
        p = np.stack(runs[name])  # [41, B, 3]
        hit = np.stack(touched[name])  # [40, B]: a robot slot carries an impulse
        assert (p[-1, :, 2] - p[0, :, 2] < -0.05).all(), name
        # the free descent: the steps before the fingers reach the table
        free = hit.argmax(0)
        assert hit.any(0).all() and (free >= 10).all(), (name, free)
        pf = p[free, np.arange(B)]
        dz = pf[:, 2] - p[0, :, 2]
        dxy = np.linalg.norm(pf[:, :2] - p[0, :, :2], axis=-1)
        assert (dz < -0.05).all(), (name, dz)
        assert (dxy < np.abs(dz)).all(), (name, dxy, dz)
        assert (dxy < 0.01).all(), (name, dxy)


def test_spd_inverse_plain_matches_n9():
    """The plain version against the JAX package's jnp fallback (atol 1e-5)."""
    M = spd_batch(64, 9, seed=9)
    want = np.asarray(j_spd_inverse(M, force_pallas=False))
    got = tspd.spd_inverse(torch.tensor(np.asarray(M))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert 9 in tspd.KERNEL_N and tspd.launches == 0
