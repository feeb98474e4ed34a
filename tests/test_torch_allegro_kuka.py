"""The one-arm AllegroKuka tasks (reorientation, regrasping, throw): the port
against the JAX package on the CPU, on the in-repo KUKA iiwa 7 + Allegro
stand-in (handarm_tpu_torch/assets/classic_standin/urdf/
kuka_allegro_description/kuka_allegro_touch_sensor.urdf; the JAX env reads
it through a monkeypatched `handarm_tpu.envs.allegro_kuka.KUKA_ALLEGRO_URDF`).
The three variants' envs are built once for the module at B = 8 (neither K
= 3 nor 1, so every object slot is active in some env). The JAX envs run
their steps with the engine step, the hand's kinematics, the fresh-state
draw and the observation jitted (one engine compile for the three: their
scenes are one), the rest of the step op by op.

- The stand-in compiles alike in both packages (arrays within 1e-6): nv 23,
  the 7 arm joints first, the palm and four distal-link sites; both fit
  the same 52 spheres (2 a link, the tip spheres as they are); the scenes
  agree (base pose, gains, 298 contact slots). At the default pose the
  palm point lands at the same place in both (printed with -s), over the
  narrow table within 7.5 cm of the object's start.
- The observation widths: 117 with 4 keypoints (reorientation), 99 with 1.
- Each variant: the reset's observations from the JAX package's draws
  (re-derived from its keys), then 3 steps at B = 8 from the converted JAX
  state, with uniform actions in [-0.3, 0.3] and the JAX package's draws:
  env 0's goal set to its object's pose (a success at the first step: the
  goal resampled, and for regrasping and throw the object returned to the
  table, unlifted), env 1's object dropped under the fall height (a
  reset), env 2 one step from its episode's end (a timeout), env 3 at 49
  successes with its goal on its object (the 50th ends it), the
  curriculum one frame from its interval with an EWMA over 3 (the
  tolerance shrinks at the first step). Observations and rewards within
  2e-3 times max(1, the largest value), done flags exactly, every state
  leaf within 2e-4 (positions) or 2e-3 (velocities, impulses, rewards) of
  the same scale, the integer and bool leaves exactly, the curriculum
  scalars within 1e-6. The envs whose objects touch one another after the
  first step are counted (printed with -s).
- spd_inverse's plain version at n = 23 against the JAX package's jnp path
  on the stand-in's PD-augmented mass matrices (the default pose's and
  random poses', from the port's dynamics), within 1e-5 of the largest
  entry; their cond (printed
  with -s) is 1e2-1e3: the KUKA's kilograms against the Allegro's grams
  and the augmentation's h kd + h^2 kp on the diagonal. And the n = 23
  warp layout's data flow in numpy (rows 23 words apart, odd) against the
  plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.envs import allegro_kuka as jak
from handarm_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from handarm_tpu.physics import model as jmodel
from handarm_tpu.robots import spherefit as jsf
from handarm_tpu_torch.convert import classic_state_from_leaves
from handarm_tpu_torch.envs import allegro_kuka as tak
from handarm_tpu_torch.ops import spd_inverse as tspd
from handarm_tpu_torch.physics import dynamics as tdyn
from handarm_tpu_torch.physics import kinematics as tkin
from handarm_tpu_torch.physics import model as tmodel
from handarm_tpu_torch.robots import spherefit as tsf
from test_pallas_ops import spd_batch
from test_torch_locomotion import _compare_models, _warp_layout

torch.set_num_threads(1)
B = 8
NV = 23
POS_TOL, VEL_TOL = 2e-4, 2e-3
STEPS = 3
VARIANTS = ("reorientation", "regrasping", "throw")
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def kuka():
    """variant -> (JAX env, port env), at B = 8."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jak, "KUKA_ALLEGRO_URDF", tak.KUKA_ALLEGRO_URDF)
        jenvs = {v: jak.make_allegro_kuka(variant=v, num_envs=B) for v in VARIANTS}
        scene = jenvs["reorientation"].scene
        orig = jak.engine_step
        engine = jax.jit(lambda phys: orig(scene, phys))
        mp.setattr(jak, "engine_step", lambda sc, phys: engine(phys))
        hand = jax.jit(jenvs["reorientation"]._hand)
        for jenv in jenvs.values():
            jenv.scene = scene  # the same scene in the three variants
            jenv._hand = hand
            jenv._fresh = jax.jit(jenv._fresh, static_argnums=1)
            jenv._obs = jax.jit(jenv._obs)
        yield {v: (jenvs[v], tak.make_allegro_kuka(v, num_envs=B, device="cpu"))
               for v in VARIANTS}


def _object_draws(key) -> tak.AKObjectDraws:
    kp, kq = jax.random.split(key)
    return tak.AKObjectDraws(pos=_t(jax.random.uniform(kp, (B, 3), minval=-1.0, maxval=1.0)),
                             rot=_t(jax.random.normal(kq, (B, 4))))


def _goal_draws(key, variant) -> tak.AKGoalDraws:
    kp, kq, _ = jax.random.split(key, 3)
    width = 4 if variant == "throw" else 3
    return tak.AKGoalDraws(u=_t(jax.random.uniform(kp, (B, width))),
                           rot=_t(jax.random.normal(kq, (B, 4))))


def fresh_draws(key, variant) -> tak.AKDraws:
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, B)`
    makes (the success draws zero: a reset reads none)."""
    k1, k2, k3, k4, _ = jax.random.split(key, 5)
    zero_goal = tak.AKGoalDraws(u=torch.zeros(B, 4), rot=torch.ones(B, 4))
    return tak.AKDraws(
        dof=_t(jax.random.uniform(k1, (B, NV))),
        dof_vel=_t(jax.random.uniform(k2, (B, NV), minval=-1.0, maxval=1.0)),
        obj=_object_draws(k3), goal=_goal_draws(k4, variant), resample=zero_goal,
        ret=tak.AKObjectDraws(pos=torch.zeros(B, 3), rot=torch.ones(B, 4)))


def step_draws(state_key, variant) -> tak.AKDraws:
    _, k_goal, k_obj, k_reset = jax.random.split(state_key, 4)
    return fresh_draws(k_reset, variant)._replace(resample=_goal_draws(k_goal, variant),
                                                  ret=_object_draws(k_obj))


def port_state(jstate) -> tak.AKState:
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     tak.AKState)


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


NAMES = ("q", "qd", "phys_targets", "opos", "oquat", "olin", "oang", "impulse", "targets",
         "progress", "actions", "goal_pos", "goal_quat", "lifted", "obj_init_z",
         "closest_kp_dist", "closest_fingertip_dist", "furthest_hand_dist", "near_goal_steps",
         "successes", "success_ewma", "tolerance", "frames_since_curriculum", "last_reward")
VELOCITY_LEAVES = ("qd", "olin", "oang", "impulse", "last_reward")


def assert_state_close(got, want):
    p = got.physics
    leaves = [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        got[1:])
    g = jax.tree.leaves(want)
    assert len(leaves) == len(g) - 1 == len(NAMES)  # the JAX key
    for name, a, b in zip(NAMES, leaves, g):
        b = np.asarray(b)
        if a.dtype in (torch.int64, torch.bool):
            assert b.dtype == (np.bool_ if a.dtype == torch.bool else np.int32), name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        elif name == "closest_kp_dist":  # 1e6 until measured
            np.testing.assert_array_equal(a.numpy() >= 1e5, b >= 1e5, err_msg=name)
            far = b >= 1e5
            _close(a[torch.as_tensor(~far)], b[~far], POS_TOL, name)
        elif name in ("success_ewma", "tolerance"):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-7, err_msg=name)
        else:
            _close(a, b, VEL_TOL if name in VELOCITY_LEAVES else POS_TOL, name)


# --- the stand-in ----------------------------------------------------------------


def test_standin_compiles_alike(kuka):
    jenv, tenv = kuka["reorientation"]
    path = tak.KUKA_ALLEGRO_URDF
    ja, ta = jmodel.compile_urdf(path), tmodel.compile_urdf(path)
    _compare_models(ta, ja)
    assert ta.nv == NV and not ta.floating
    assert ta.joint_names[:7] == [f"iiwa7_joint_{i}" for i in range(1, 8)]
    assert ta.joint_names[7:] == [f"{f}_joint_{k}" for f in ("index", "middle", "ring", "thumb")
                                  for k in range(4)]
    assert "iiwa7_base_link" in ta.sites and ta.sites["iiwa7_base_link"].body < 0
    for name in ("palm_link",) + tak.FINGERTIPS:
        assert ta.sites[name].body >= 0, name
    assert ta.sites["palm_link"].body == ta.body_names.index("iiwa7_link_7")
    np.testing.assert_allclose(np.degrees(ta.q_max[:7]), [170, 120, 170, 120, 170, 120, 175],
                               atol=1e-4)
    jb, jc, jr = jsf.generic_collision_spheres(path, ja, 2)
    tb, tc, tr = tsf.generic_collision_spheres(path, ta, 2)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr, jr)
    assert len(tb) == 52 and sorted(set(tb.tolist())) == list(range(NV))
    assert (np.asarray(tr) == 0.012).sum() == 4  # the tip spheres, as they are
    js, ts = jenv.scene, tenv.scene
    np.testing.assert_array_equal(ts.spheres.body, js.spheres.body)
    np.testing.assert_allclose(ts.spheres.offset.numpy(), np.asarray(js.spheres.offset),
                               atol=1e-7)
    np.testing.assert_array_equal(ts.spheres.radius.numpy(), np.asarray(js.spheres.radius))
    np.testing.assert_allclose(ts.base_pos.numpy(), tak.ARM_BASE, atol=1e-7)
    np.testing.assert_allclose(ts.base_pos.numpy(), np.asarray(js.base_pos), atol=1e-7)
    for f in ("kp", "kd"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    assert ts.slots.num_slots == js.slots.num_slots == 298
    assert tenv.K == jenv.K == 3
    np.testing.assert_array_equal(ts.shapes.mass.numpy(), np.asarray(js.shapes.mass))
    np.testing.assert_array_equal(tenv.default_q.numpy(), np.asarray(jenv.default_q))

    # the palm at the default pose, in both packages
    from handarm_tpu_torch.physics.engine import initial_state as t_initial
    from handarm_tpu.physics.engine import initial_state as j_initial

    tq = tenv.default_q[None].expand(B, NV)
    tips, palm, *_ = tenv.hand(t_initial(ts, B, q0=tq))
    jtips, jpalm, *_ = jenv._hand(j_initial(js, B, q0=jnp.asarray(tq.numpy())))
    _close(palm, jpalm, 1e-6, "palm")
    _close(tips, jtips, 1e-6, "tips")
    p = palm[0].numpy()
    print(f"the palm point at the default pose: {p} (both packages; the object starts at "
          f"{tak.OBJECT_START}); the fingertips at z {tips[0, :, 2].numpy()}")
    assert np.linalg.norm(p - tak.OBJECT_START) < 0.075
    assert (np.abs(p[:2]) <= tak.TABLE_HALF).all() and p[2] > tak.TABLE_TOP + 0.1


def test_obs_widths_match(kuka):
    for v in VARIANTS:
        jenv, tenv = kuka[v]
        assert tenv.num_obs == jenv.num_obs == (117 if v == "reorientation" else 99)
        assert tenv.num_keypoints == jenv.num_keypoints == (4 if v == "reorientation" else 1)
        assert tenv.num_actions == jenv.num_actions == NV
        assert tenv.num_teacher_obs == jenv.num_teacher_obs == 0


# --- the env steps ---------------------------------------------------------------


def _forced(jenv, js):
    """The JAX state with the events the docstring lists."""
    cfg, phys = jenv.cfg, js.physics
    slot = np.arange(B) % jenv.K
    opos, oquat = np.asarray(phys.objects.pos).copy(), np.asarray(phys.objects.quat)
    gp, gq = np.asarray(js.goal_pos).copy(), np.asarray(js.goal_quat).copy()
    for b in (0, 3):
        gp[b], gq[b] = opos[b, slot[b]], oquat[b, slot[b]]
    opos[1, slot[1], 2] = 0.05
    prog, succ = np.asarray(js.progress).copy(), np.asarray(js.successes).copy()
    prog[2], succ[3] = cfg.episode_length - 1, cfg.max_consecutive_successes - 1
    return js._replace(
        physics=phys._replace(objects=phys.objects._replace(pos=jnp.asarray(opos))),
        goal_pos=jnp.asarray(gp), goal_quat=jnp.asarray(gq), progress=jnp.asarray(prog),
        successes=jnp.asarray(succ), success_ewma=jnp.float32(3.2),
        frames_since_curriculum=jnp.int32(cfg.tolerance_curriculum_interval - 1))


@pytest.mark.parametrize("variant", VARIANTS)
def test_steps_match(variant, kuka):
    jenv, tenv = kuka[variant]
    key = jax.random.PRNGKey(11)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key, variant))
    _close(tobs, jobs, 1e-6, "reset obs")
    assert_state_close(ts, js)

    js = _forced(jenv, js)
    ts = port_state(js)
    slot = np.arange(B) % jenv.K
    start = ts.physics.objects.pos[np.arange(B), slot].clone()
    rng = np.random.default_rng(5)
    slots = tenv.scene.slots
    pair = torch.as_tensor((slots.obj_a >= 0) & (slots.obj_b >= 0))
    for i in range(STEPS):
        a = rng.uniform(-0.3, 0.3, (B, NV)).astype(np.float32)
        draws = step_draws(js.key, variant)
        js, jr = jenv.step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info)
        for k, v in jr.info.items():
            np.testing.assert_allclose(float(tr.info[k]), float(v), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        assert_state_close(ts, js)
        if i == 0:
            done = tr.done.numpy()
            assert done[1] and done[2] and done[3] and not done[0], done
            assert int(ts.successes[0]) == 1 and float(tr.reward[0]) > 500.0
            assert not np.allclose(ts.goal_pos[0].numpy(), start[0].numpy())  # resampled
            np.testing.assert_allclose(float(ts.tolerance), 0.075 * 0.9, rtol=1e-6)
            assert int(ts.frames_since_curriculum) == 0
            obj0 = ts.physics.objects.pos[0, 0]
            if variant == "throw":  # beside or behind the table
                assert abs(float(ts.goal_pos[0, 0])) >= 0.5
            if variant in ("regrasping", "throw"):  # returned to the table, unlifted
                np.testing.assert_array_equal(ts.physics.objects.linvel[0, 0].numpy(), 0.0)
                assert abs(float(obj0[2]) - tak.OBJECT_START[2]) <= 0.02 + 1e-6
                assert not bool(ts.lifted[0]) and float(ts.obj_init_z[0]) == float(obj0[2])
            touching = (ts.physics.contact_impulse.norm(dim=-1) > 0) & pair
            print(f"{variant}: envs with object-object impulses after the first step: "
                  f"{int(touching.any(-1).sum())} of {B}; the episodes ended {done.tolist()}")


# --- spd_inverse ---------------------------------------------------------------


def test_spd_inverse_plain_matches_kuka_matrices(kuka):
    jenv, tenv = kuka["reorientation"]
    sc, n = tenv.scene, NV
    rng = np.random.default_rng(6)
    q = np.concatenate([np.broadcast_to(np.asarray(jenv.default_q), (4, n)),
                        rng.uniform(tenv.art.q_min, tenv.art.q_max, (12, n))]).astype(np.float32)
    # the matrices from the port's dynamics (the packages' mass matrices
    # agree: tests/test_torch_model.py, and the steps above)
    fk = tkin.forward_kinematics(sc.model, torch.tensor(q), sc.base_quat[None], sc.base_pos[None])
    dyn = tdyn.compute_dyn(sc.model, fk, torch.zeros(q.shape), torch.zeros(3), sc.kp, sc.kd,
                           sc.params.dt / sc.params.substeps)
    M = dyn.Mtilde.numpy()
    cond = np.linalg.cond(M.astype(np.float64))
    print(f"kuka: n = {n}, cond(Mtilde) {cond.min():.3e} to {cond.max():.3e}")
    want = np.asarray(j_spd_inverse(jnp.asarray(M), force_pallas=False))
    got = tspd.spd_inverse_plain(torch.tensor(M)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert n in tspd.KERNEL_N and cond.max() < 1e4


def test_spd_inverse_warp_layout_n23():
    """The n = 23 warp layout: rows at an odd stride of LD = 23 words (the
    23 lanes reading a column fall on 23 banks), lanes 23-31 zero; its
    arithmetic on the staged rows holds to the plain version."""
    n = 23
    assert n | 1 == n and len({(i * n) % 32 for i in range(n)}) == n
    M = np.asarray(spd_batch(4, n, seed=9))
    want = tspd.spd_inverse_plain(torch.tensor(M)).numpy()
    for b in range(M.shape[0]):
        got = _warp_layout(M[b].copy())
        np.testing.assert_allclose(got, want[b], atol=1e-5 * np.abs(want[b]).max())
