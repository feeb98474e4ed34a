"""Anymal and AnymalTerrain: the port against the JAX package on the CPU, on
the in-repo stand-in ANYmal C (handarm_tpu_torch/assets/classic_standin/
anymal_c/anymal.urdf; the JAX envs read it through monkeypatched
`handarm_tpu.envs.anymal.ANYMAL_URDF` and
`handarm_tpu.envs.anymal_terrain.ANYMAL_URDF`).

- The stand-in compiles alike in both packages (arrays within 1e-6; nv 18,
  50.892 kg), and `robots.spherefit.generic_collision_spheres` fits the
  same spheres, entry for entry, at 2 and 3 spheres a link (the box
  branch's 8 corners, the cylinder's 48-point ring, the foot spheres as
  they are; 30 spheres at 2 a link).
- `physics.terrain.generate_terrain` is bit-identical at (3, 4) and at the
  default (6, 10) levels x types; `physics.contacts._heightfield_surface`
  matches the JAX function on random points over the (3, 4) field's
  slopes, rough slopes, stairs, obstacles and stones (distance and normal
  within 1e-5; a fifth of the normals or more not vertical, asserted), and
  `_static_surface` takes the heightfield whenever one is set.
- Each env's reset from the JAX package's draws (re-derived from its keys
  and handed to the port's `reset` / `step`; AnymalTerrain's random
  episode progress too), exactly; then the JAX env steps with zero actions
  until the feet carry the robots, its state goes to the port, and 2 steps
  at B = 8 with random actions run on both. Anymal: env 0's base dropped
  onto the ground (a crash at the first step, its fresh episode from the
  injected draws), env 1 timing out at the second. AnymalTerrain (3 x 4
  field): env 1 times out having walked over half a patch (a level up),
  env 2 times out short of a quarter of its commanded distance (a level
  down), env 3 is pushed at the first step (the push overwrites qd[:,
  0:2], the origin-Plücker linear part, on both sides), and envs 0 and 4
  stand on rough slopes (feet impulses along normals that are not
  vertical, asserted). Tolerances as tests/test_torch_locomotion.py states
  them: observations and rewards within 2e-3 times max(1, the largest
  value), every state leaf within 2e-4 (positions) or 2e-3 (velocities,
  impulses) of the same scale, done flags, levels and clocks exactly. On
  the terrain each step starts from the JAX state, and each env's leaves
  are held within twice the port's own spread where that is larger: the
  most its step's outputs move when every float of the input state is
  scaled by 1 + U(-1e-7, 1e-7) (6 draws). The patches lie 12-52 m from
  the world origin, the base's rotation dofs are screws about that origin,
  so its mass-matrix rows grow with the squared distance (m |p|^2 ~ 7e4 kg
  m^2 at 38 m against hip inertias of ~0.01), and a step there is
  sensitive to rounding in either package (measured from the same state:
  one-ulp perturbations move the origin-Plücker qd of env 7, 38 m out, by
  up to 0.88 in the port and 0.91 in the JAX package; the two packages'
  steps lie 0.91 apart there, and within 0.2 in every other env).
- The stance check of tests/test_anymal.py (120 zero-action steps at B =
  8: the base between 0.3 and 0.7 m, no reset) and the stand-on-patch
  check of tests/test_anymal_terrain.py (60 steps on the 3 x 4 field: the
  base 0.1-0.8 m over its patch's origin, the height observations within
  +-5 and varying), in both packages from the same reset.
- spd_inverse's plain version at n = 12 (BallBalance) and n = 18 (the
  ANYmal) against the JAX package's jnp fallback (atol 1e-5, the bound of
  tests/test_pallas_ops.py, on its `spd_batch`).
- One Anymal `train_iter` at B = 16 (hidden 32-32, horizon 2, minibatch 8),
  env 0 timing out in it, held as tests/test_torch_locomotion.py holds the
  Ant's: the rollout on each side with the JAX package's noise and reset
  draws, then the update from the JAX package's trajectory with its
  permutations; the params within 1e-5, the Adam moments within 1e-4 of
  their largest, the stats 1e-5 relative, the lr equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import handarm_tpu.learn.ppo as jppo
from handarm_tpu.envs import anymal as jan
from handarm_tpu.envs import anymal_terrain as jat
from handarm_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from handarm_tpu.physics import contacts as jcontacts
from handarm_tpu.physics import model as jmodel
from handarm_tpu.physics import terrain as jterrain
from handarm_tpu.robots import spherefit as jsf
from handarm_tpu_torch.convert import (
    classic_state_from_leaves,
    learner_to_leaves,
    train_state_from_leaves,
)
from handarm_tpu_torch.envs import anymal as tan
from handarm_tpu_torch.envs import anymal_terrain as tat
from handarm_tpu_torch.envs.hand_arm import tree_map
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.ops import spd_inverse as tspd
from handarm_tpu_torch.physics import contacts as tcontacts
from handarm_tpu_torch.physics import model as tmodel
from handarm_tpu_torch.physics import terrain as tterrain
from handarm_tpu_torch.physics.kinematics import forward_kinematics
from handarm_tpu_torch.robots import spherefit as tsf
from test_pallas_ops import spd_batch
from test_torch_classic import _DrawnEnv
from test_torch_locomotion import _compare_models
from test_torch_ppo import TRAJ_FIELDS, _perms, _port_traj
from test_torch_train import assert_same_lr, record_kls

torch.set_num_threads(1)
B = 8
POS_TOL, VEL_TOL = 2e-4, 2e-3
SETTLE = 15  # zero-action steps until the feet carry the robots
SMALL = dict(num_levels=3, num_types=4)  # tests/test_anymal_terrain.py's field
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture
def jax_envs(monkeypatch):
    """The JAX package's two factories on the stand-in."""
    monkeypatch.setattr(jan, "ANYMAL_URDF", tan.ANYMAL_URDF)
    monkeypatch.setattr(jat, "ANYMAL_URDF", tan.ANYMAL_URDF)
    return {"anymal": jan.make_anymal, "terrain": jat.make_anymal_terrain}


def fresh_draws(kind: str, key, B: int, nv: int = 18):
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, B)`
    makes."""
    u = jax.random.uniform
    if kind == "anymal":
        k_cmd, k_q, _ = jax.random.split(key, 3)
        return tan.AnymalDraws(_t(u(k_cmd, (B, 3))), _t(u(k_q, (B, nv), minval=0.5, maxval=1.5)))
    k_cmd, k_q, k_xy, k_lvl, _ = jax.random.split(key, 5)
    return tat.ATDraws(_t(u(k_cmd, (B, 3))), _t(u(k_q, (B, nv), minval=0.5, maxval=1.5)),
                       _t(u(k_xy, (B, 2), minval=-0.5, maxval=0.5)),
                       _t(jax.random.randint(k_lvl, (B,), 0, 1)).long())


def step_draws(kind: str, state_key, B: int, push_vel: float = 1.0):
    """The port's draws of the JAX env's `step` from a state with key
    `state_key` (and AnymalTerrain's push velocities)."""
    if kind == "anymal":
        return fresh_draws(kind, jax.random.split(state_key)[1], B), None
    _, k_push, k_reset = jax.random.split(state_key, 3)
    return fresh_draws(kind, k_reset, B), _t(jax.random.uniform(
        k_push, (B, 2), minval=-push_vel, maxval=push_vel))


def port_state(jstate, state_type):
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     state_type)


def _close(got, want, tol, name, floor=1.0):
    want = np.asarray(want)
    scale = max(floor, float(np.abs(want).max())) if want.size else floor
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


PHYSICS_NAMES = ("q", "qd", "targets", "base_pos", "base_quat", "opos", "oquat", "olin",
                 "oang", "impulse")
OWN_NAMES = {tan.AnymalState: ("progress", "commands", "actions"),
             tat.ATState: ("progress", "commands", "actions", "last_qd", "feet_air_time",
                           "terrain_level", "spawn_xy")}
VELOCITY_LEAVES = ("qd", "olin", "oang", "impulse", "last_qd")


def _leaves(state):
    p = state.physics
    return [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        state[1:])


def assert_state_close(got, want, spread=None):
    """Every leaf within 2e-4 (positions) or 2e-3 (velocities) of max(1,
    its largest value); with `spread` (`perturbed_spread`) per env within
    twice the port's own spread where that is larger."""
    leaves = _leaves(got)
    names = PHYSICS_NAMES + OWN_NAMES[type(got)]
    g = jax.tree.leaves(want)
    assert len(leaves) == len(g) - 1 == len(names)  # the JAX key
    for k, (name, a, b) in enumerate(zip(names, leaves, g)):
        tol = VEL_TOL if name in VELOCITY_LEAVES else POS_TOL
        if a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        elif spread is None:
            _close(a, b, tol, name)
        else:
            _close_spread(a, b, spread[k], tol, name)


def _close_spread(got, want, spread, tol, name):
    """Per env: |got - want| <= max(tol max(1, |want|), 2 spread), `spread`
    the port's own output change under one-ulp perturbations of its input
    state (`perturbed_spread`)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy()
    bound = np.maximum(tol * scale, 2 * spread.numpy()).reshape((-1,) + (1,) * (g.ndim - 1))
    bad = np.abs(g - want) > bound
    assert not bad.any(), (f"{name}: {bad.sum()} entries off; max |got - want| per env "
                           f"{np.abs(g - want).reshape(len(g), -1).max(1)}, bound per env "
                           f"{bound.ravel()}")


def perturbed_spread(env, state, step, n: int = 6, rel: float = 1e-7):
    """The per-env spread (max over `n` runs) of `step(state)`'s outputs and
    state leaves when every float leaf of `state` is scaled by 1 + U(-rel,
    rel): how far float32 rounding alone moves each env's step."""
    _, res0 = out0 = step(state)
    leaves0 = _leaves(out0[0]) + [res0.obs, res0.reward]
    g = torch.Generator().manual_seed(0)
    spread = [torch.zeros(len(x)) for x in leaves0]

    def jitter(x):
        if not x.is_floating_point():
            return x
        return x * (1 + (torch.rand(x.shape, generator=g) * 2 - 1) * rel)

    for _ in range(n):
        st, res = step(tree_map(jitter, state))
        for k, (a, b) in enumerate(zip(_leaves(st) + [res.obs, res.reward], leaves0)):
            if a.is_floating_point():
                d = (a - b).abs().reshape(len(a), -1).amax(1) if a.numel() else spread[k]
                spread[k] = torch.maximum(spread[k], d)
    return spread


# --- the stand-in, the spheres, the terrain ----------------------------------------


@pytest.mark.parametrize("per_link", [2, 3])
def test_standin_and_spheres_alike(per_link):
    path = tan.ANYMAL_URDF
    ja = jmodel.compile_urdf(path, floating_base=True)
    ta = tmodel.compile_urdf(path, floating_base=True)
    _compare_models(ta, ja)
    assert ta.nv == 18 and abs(float(ta.mass.sum()) - 50.892) < 1e-3
    assert [n for n in ta.joint_names[6:]] == list(ja.joint_names[6:])
    assert set(ta.joint_names[6:]) == set(tan.DEFAULT_ANGLES)
    feet = {ta.sites[n].body for n in ta.sites if "FOOT" in n}
    assert len(feet) == 4
    jb, jc, jr = jsf.generic_collision_spheres(path, ja, per_link)
    tb, tc, tr = tsf.generic_collision_spheres(path, ta, per_link)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr, jr)
    assert len(tb) == per_link + 4 * (3 * per_link + 1)  # base, hips, thighs, shanks, feet
    # the box and cylinder samples the fitter covers
    np.testing.assert_array_equal(tsf._cylinder_points(0.05, 0.08).shape, (48, 3))
    spheres = tsf.make_generic_spheres(path, ta, spheres_per_link=per_link)
    jspheres = jsf.make_generic_spheres(path, ja, spheres_per_link=per_link)
    np.testing.assert_array_equal(spheres.offset.numpy(), np.asarray(jspheres.offset))
    np.testing.assert_array_equal(spheres.friction, np.asarray(jspheres.friction))


@pytest.mark.parametrize("grid", [(3, 4), (6, 10)])
def test_generate_terrain_bit_identical(grid):
    kw = dict(num_levels=grid[0], num_types=grid[1])
    want, got = jterrain.generate_terrain(**kw), tterrain.generate_terrain(**kw)
    assert got.height.dtype == want.height.dtype == np.float32
    np.testing.assert_array_equal(got.height, want.height)
    np.testing.assert_array_equal(got.env_origins, want.env_origins)
    np.testing.assert_array_equal(got.origin, want.origin)
    assert (got.cell, got.num_levels, got.num_types, got.patch_length) == (
        want.cell, want.num_levels, want.num_types, want.patch_length)
    assert got.height.shape == (grid[0] * 80 + 160, grid[1] * 80 + 160)
    assert np.ptp(got.height) > 0.3


def test_heightfield_surface_matches():
    t = tterrain.generate_terrain(**SMALL)
    jgeom = jcontacts.StaticGeom(
        table_lo=jnp.asarray([-1e4, -1e4]), table_hi=jnp.asarray([-9e3, -9e3]),
        table_height=jnp.asarray(0.0), friction=jnp.asarray(1.0),
        hf_height=jnp.asarray(t.height), hf_cell=float(t.cell), hf_origin=jnp.asarray(t.origin))
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    tgeom = tcontacts.StaticGeom(
        table_lo=f32([-1e4, -1e4]), table_hi=f32([-9e3, -9e3]), table_height=0.0,
        wall_lo=np.zeros((0, 3), np.float32), wall_hi=np.zeros((0, 3), np.float32),
        hf_height=f32(t.height), hf_cell=float(t.cell), hf_origin=f32(t.origin))
    rng = np.random.default_rng(9)
    R, C = t.height.shape
    # over the patches (stairs, slopes, obstacles, stones: past the 8 m
    # border), then over the whole field and past its edges (the clamp)
    lo, hi = np.full(2, 8.0), np.array([R, C]) * t.cell - 8.0
    xy = np.concatenate([rng.uniform(lo, hi, (3584, 2)),
                         rng.uniform(-1.0, hi + 9.0, (512, 2))])
    p = np.concatenate([xy, rng.uniform(-0.6, 0.6, (4096, 1))], -1).astype(np.float32)
    jd, jn = jcontacts._heightfield_surface(jgeom, jnp.asarray(p))
    td, tn = tcontacts._heightfield_surface(tgeom, f32(p))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    assert (tn[:3584, 2] < 0.999).float().mean() > 0.2  # sloped and stepped cells
    sd, sn = tcontacts._static_surface(tgeom, f32(p))
    np.testing.assert_array_equal(sd.numpy(), td.numpy())
    np.testing.assert_array_equal(sn.numpy(), tn.numpy())


# --- env steps --------------------------------------------------------------------


def test_anymal_reset_and_steps_match(jax_envs):
    jenv = jax_envs["anymal"](num_envs=B)
    tenv = tan.make_anymal(num_envs=B, device="cpu")
    assert (tenv.num_obs, tenv.num_actions, tenv.scene.slots.num_slots) == (
        jenv.num_obs, jenv.num_actions, jenv.scene.slots.num_slots) == (48, 12, 30)
    np.testing.assert_array_equal(tenv.crash_bodies, jenv.crash_bodies)
    key = jax.random.PRNGKey(2)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws("anymal", key, B))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert_state_close(ts, js)

    step = jax.jit(jenv.step)
    for _ in range(SETTLE):
        js, jr = step(js, jnp.zeros((B, 12)))
    assert not np.asarray(jr.done).any()
    bp = np.asarray(js.physics.robot.base_pos).copy()
    bp[0, 2] = 0.17  # env 0's base onto the ground: a crash
    prog = np.asarray(js.progress).copy()
    prog[1] = jenv.cfg.episode_length - 2  # env 1 times out at the second step
    js = js._replace(progress=jnp.asarray(prog), physics=js.physics._replace(
        robot=js.physics.robot._replace(base_pos=jnp.asarray(bp))))
    ts = port_state(js, tan.AnymalState)
    rng = np.random.default_rng(4)
    dones = []
    for i in range(2):
        impulse = np.abs(np.asarray(js.physics.contact_impulse)).sum((1, 2))
        assert (impulse[1:] > 0).all(), f"step {i}: robots off the ground {impulse}"
        a = rng.uniform(-1.0, 1.0, (B, 12)).astype(np.float32)
        draws, _ = step_draws("anymal", js.key, B)
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"lin_vel_err"}
        assert tr.teacher_obs.shape == (B, 0)
        assert_state_close(ts, js)
        dones.append(tr.done.numpy())
    assert dones[0][0] and not dones[0][1:].any()
    assert dones[1][1] and not dones[1][2:].any()


def _feet_on_slopes(env, state):
    """[B] the count of foot slots with impulses whose normal is not
    vertical."""
    sc, r = env.scene, state.physics.robot
    fk = forward_kinematics(sc.model, r.q, r.base_quat, r.base_pos)
    con = tcontacts.generate_contacts(sc.slots, sc.shapes, sc.spheres, sc.geom,
                                      state.physics.objects.pos, state.physics.objects.quat,
                                      fk.body_quat, fk.body_pos)
    feet = torch.as_tensor(np.isin(sc.slots.robot_body, env.feet_bodies))
    pushed = state.physics.contact_impulse.norm(dim=-1) > 0
    return (feet[None] & pushed & (con.normal[..., 2] < 0.9999)).sum(-1)


def test_anymal_terrain_reset_and_steps_match(jax_envs):
    jenv = jax_envs["terrain"](num_envs=B, **SMALL)
    tenv = tat.make_anymal_terrain(num_envs=B, device="cpu", **SMALL)
    assert (tenv.num_obs, tenv.num_actions) == (jenv.num_obs, jenv.num_actions) == (188, 12)
    np.testing.assert_array_equal(tenv.feet_bodies, jenv.feet_bodies)
    np.testing.assert_array_equal(tenv.knee_bodies, jenv.knee_bodies)
    np.testing.assert_array_equal(tenv.height_points.numpy(), np.asarray(jenv.height_points))
    key = jax.random.PRNGKey(3)
    js, jobs = jenv.reset(key)
    prog = _t(jax.random.randint(jax.random.fold_in(key, 23), (B,), 0,
                                 jenv.cfg.episode_length)).long()
    ts, tobs = tenv.reset(0, fresh_draws("terrain", key, B), progress=prog)
    _close(tobs, jobs, 1e-6, "reset obs")
    assert_state_close(ts, js)

    step = jax.jit(jenv.step)
    js = js._replace(progress=jnp.zeros(B, jnp.int32))
    for _ in range(SETTLE):
        js, jr = step(js, jnp.zeros((B, 12)))
    assert not np.asarray(jr.done).any()
    L = jenv.cfg.episode_length
    prog = np.asarray(js.progress).copy()
    prog[[1, 2]] = L - 1  # timeouts at the first step
    prog[3] = jenv.cfg.push_interval - 1  # pushed at the first step
    spawn = np.asarray(js.spawn_xy).copy()
    spawn[1, 0] -= 5.0  # env 1 walked over half a patch: a level up
    lvl = np.asarray(js.terrain_level).copy()
    lvl[2] = 1  # env 2 walked short of its commanded distance: a level down
    cmd = np.asarray(js.commands).copy()
    cmd[2] = [1.0, 0.0, 0.0]
    js = js._replace(progress=jnp.asarray(prog), spawn_xy=jnp.asarray(spawn),
                     terrain_level=jnp.asarray(lvl), commands=jnp.asarray(cmd))
    ts = port_state(js, tat.ATState)
    assert (_feet_on_slopes(tenv, ts)[[0, 4]] > 0).all()  # rough slopes under envs 0, 4
    rng = np.random.default_rng(8)
    for i in range(2):
        impulse = np.abs(np.asarray(js.physics.contact_impulse)).sum((1, 2))
        standing = np.delete(impulse, [1, 2] if i else [])  # envs 1, 2 restarted
        assert (standing > 0).all(), f"step {i}: robots off the ground {impulse}"
        a = rng.uniform(-1.0, 1.0, (B, 12)).astype(np.float32)
        draws, push = step_draws("terrain", js.key, B)
        ts = port_state(js, tat.ATState)  # each step from the JAX state
        if i == 0:  # the push replaces the origin-Plücker velocity's x and y
            assert not torch.allclose(push[3], ts.physics.robot.qd[3, :2])
        spread = perturbed_spread(tenv, ts, lambda s_: tenv.step(s_, _t(a), draws, push))
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws, push)
        _close_spread(tr.obs, jr.obs, spread[-2], VEL_TOL, f"obs {i}")
        _close_spread(tr.reward, jr.reward, spread[-1], VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info) == {"terrain_level_mean", "lin_vel_err"}
        _close(tr.info["terrain_level_mean"], jr.info["terrain_level_mean"], 0.0, "levels")
        assert_state_close(ts, js, spread)
        if i == 0:
            np.testing.assert_array_equal(tr.done.numpy(), np.isin(np.arange(B), [1, 2]))
            assert ts.terrain_level[1] == 1 and ts.terrain_level[2] == 0
            assert int(ts.progress[3]) == jenv.cfg.push_interval


# --- the JAX package's own checks, in both packages --------------------------------


def test_stance_and_patch_in_both(jax_envs):
    jenv = jax_envs["anymal"](num_envs=B, episode_length=200)
    tenv = tan.make_anymal(num_envs=B, episode_length=200, device="cpu")
    key = jax.random.PRNGKey(0)
    js, _ = jax.jit(jenv.reset)(key)
    ts, _ = tenv.reset(0, fresh_draws("anymal", key, B))
    step = jax.jit(jenv.step)
    for _ in range(120):  # 2 s at the default stance
        js, jr = step(js, jnp.zeros((B, 12)))
        ts, tr = tenv.step(ts, torch.zeros(B, 12))
    for name, z, done, obs in (
            ("jax", np.asarray(js.physics.robot.base_pos[:, 2]), np.asarray(jr.done),
             np.asarray(jr.obs)),
            ("port", ts.physics.robot.base_pos[:, 2].numpy(), tr.done.numpy(), tr.obs.numpy())):
        assert (z > 0.3).all() and (z < 0.7).all(), (name, z)
        assert not done.any() and np.isfinite(obs).all(), name

    jenv = jax_envs["terrain"](num_envs=B, **SMALL)
    tenv = tat.make_anymal_terrain(num_envs=B, device="cpu", **SMALL)
    js, jobs = jax.jit(jenv.reset)(key)
    prog = _t(jax.random.randint(jax.random.fold_in(key, 23), (B,), 0,
                                 jenv.cfg.episode_length)).long()
    ts, _ = tenv.reset(0, fresh_draws("terrain", key, B), progress=prog)
    assert jobs.shape == (B, 188)
    step = jax.jit(jenv.step)
    for _ in range(60):
        js, jr = step(js, jnp.zeros((B, 12)))
        ts, tr = tenv.step(ts, torch.zeros(B, 12))
    for name, z, org, obs in (
            ("jax", np.asarray(js.physics.robot.base_pos[:, 2]),
             np.asarray(jenv._origin_for(js.terrain_level, jenv._types(B))), np.asarray(jr.obs)),
            ("port", ts.physics.robot.base_pos[:, 2].numpy(),
             tenv._origin_for(ts.terrain_level, tenv._types(B)).numpy(), tr.obs.numpy())):
        rel = z - org[:, 2]
        assert (rel > 0.1).all() and (rel < 0.8).all(), (name, rel)
        heights = obs[:, 27:167]
        assert np.isfinite(obs).all() and np.abs(heights).max() <= 5.0 + 1e-5, name
        assert heights.std() > 1e-3, name


# --- spd_inverse at BallBalance's and the ANYmal's n ------------------------------


@pytest.mark.parametrize("n,seed", [(12, 6), (18, 7)], ids=["n12", "n18"])
def test_spd_inverse_plain_matches(n, seed):
    """The plain version against the JAX package's jnp fallback (atol 1e-5)."""
    M = spd_batch(64, n, seed=seed)
    want = np.asarray(j_spd_inverse(M, force_pallas=False))
    got = tspd.spd_inverse(torch.tensor(np.asarray(M))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert n in tspd.KERNEL_N and tspd.launches == 0


# --- the learner -----------------------------------------------------------------


def test_anymal_train_iter_matches(jax_envs):
    n, T = 16, 2
    cfg = dict(hidden=(32, 32), horizon=T, minibatch_size=8)
    jenv = jax_envs["anymal"](num_envs=n)
    tenv = tan.make_anymal(num_envs=n, device="cpu")
    jp = jppo.PPO(jenv, jppo.PPOConfig(**cfg))
    jts = jp.init(jax.random.PRNGKey(5))
    prog = np.zeros(n, np.int32)
    prog[0] = jenv.cfg.episode_length - 1  # env 0 times out at the rollout's first step
    jts = jts._replace(env_state=jts.env_state._replace(progress=jnp.asarray(prog)))
    captured = {}
    update = jp._update_from_traj

    def capture(ts_, traj, env_state, last_obs, *args, **kw):
        captured["traj"], captured["last_obs"] = traj, last_obs
        return update(ts_, traj, env_state, last_obs, *args, **kw)

    jp._update_from_traj = capture
    j_new, j_stats = jp.train_iter(jts)
    k_next, k_roll, _ = jax.random.split(jts.key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (n, 12)))
                      for k in jax.random.split(k_roll, T)])
    draws, key = [], jts.env_state.key
    for _ in range(T):
        draws.append(step_draws("anymal", key, n)[0])
        key = jax.random.split(key)[0]

    leaves = [np.asarray(x) for x in jax.tree.leaves(jts)]
    n_env = len(jax.tree.leaves(jts.env_state))
    assert n_env == 14
    env_state = port_state(jts.env_state, tan.AnymalState)
    tcfg = tppo.PPOConfig(**cfg)
    tp = tppo.PPO(_DrawnEnv(tenv, draws), tcfg, device="cpu")
    tts = train_state_from_leaves(leaves, env_state, _t(jts.last_obs), cfg=tcfg, n_env=n_env)
    traj, env_state, last_obs = tp.rollout(tts, _t(noise))[:3]
    want = captured["traj"]
    assert np.asarray(want.done)[0, 0]  # a restart from the draws
    for k, tol in (("obs", 2e-3), ("mu", 2e-3), ("logp", 1e-4), ("value", 2e-3),
                   ("reward", 2e-3)):
        _close(getattr(traj, k), getattr(want, k), tol, k)
    np.testing.assert_array_equal(traj.done.numpy(), np.asarray(want.done))

    kls = record_kls(tp)
    _close(last_obs, captured["last_obs"], 2e-3, "last obs")
    t_new, t_stats = tp._update_from_traj(
        tts, _port_traj({k: np.asarray(getattr(want, k)) for k in TRAJ_FIELDS}),
        env_state, _t(captured["last_obs"]), perms=_t(_perms(k_next, 4, T * n)).long())
    got = learner_to_leaves(t_new, tcfg)
    want_leaves = [np.asarray(x) for x in jax.tree.leaves(
        (j_new.params, j_new.opt_state, j_new.obs_stats, j_new.value_stats, j_new.lr))]
    P = len(tppo.param_names(tcfg))
    assert len(got) == len(want_leaves) == 3 * P + 4 + 7
    for i, w in enumerate(want_leaves):
        assert got[i].dtype == w.dtype and got[i].shape == w.shape, i
        if i < P:
            np.testing.assert_allclose(got[i], w, atol=1e-5, err_msg=f"leaf {i}")
        elif P + 4 <= i < 3 * P + 4:
            tol = max(1e-6, 1e-4 * float(np.abs(w).max()))
            np.testing.assert_allclose(got[i], w, atol=tol, err_msg=f"leaf {i}")
        elif i < P + 4:
            np.testing.assert_array_equal(got[i], w, err_msg=f"leaf {i}")
        elif i < 3 * P + 4 + 6:
            np.testing.assert_allclose(got[i], w, rtol=1e-5, atol=1e-7, err_msg=f"leaf {i}")
    assert_same_lr(float(got[-1]), float(want_leaves[-1]), kls)
    assert bool(t_stats["kl_guard_triggered"]) == bool(j_stats["kl_guard_triggered"])
    for k in ("reward_mean", "episode_done_frac", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
