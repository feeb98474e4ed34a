"""The two-arm AllegroKuka tasks (reorientation, regrasping): the port against
the JAX package on the CPU, on two copies of the in-repo KUKA iiwa 7 + Allegro
stand-in mounted facing each other. The JAX env composes its file from the
stand-in through a monkeypatched `handarm_tpu.envs.allegro_kuka.
KUKA_ALLEGRO_URDF`, and writes it to this module's temp dir through a
monkeypatched `TWO_ARMS_URDF` (the committed `assets/gen/` file names
reference meshes and stays untouched). Both variants' envs are built once
at B = 8; the JAX envs run their steps with the engine step (one compile
for both: their scenes are one), the hand's kinematics, the fresh-state draw
and the observation jitted, the rest of the step op by op.

- The composed file is the JAX generator's, element for element (links,
  joints, origins, the two mounts). It compiles alike in both packages
  (arrays within 1e-6): nv 46, arm 0's 23 dofs then arm 1's; both fit the
  same 104 spheres (2 a link); the scenes agree (base at the origin, gains,
  506 contact slots, 416 of them on the robot's 46 moving bodies, three 0.5
  kg boxes).
- The observation widths: 179 with 4 keypoints (reorientation), 161 with 1;
  46 actions, 8 fingertips.
- Each variant: the reset's observations from the JAX package's draws
  (re-derived from its keys), then 3 steps at B = 8 from the converted JAX
  state, with uniform actions in [-0.3, 0.3] and the JAX package's draws,
  with the events of tests/test_torch_allegro_kuka.py: a success at the
  first step in env 0, a fall in env 1, a timeout in env 2, the 50th success
  in env 3, and a curriculum step. Observations and rewards within 2e-3
  times max(1, the largest value), done flags exactly, every state leaf
  within 2e-4 (positions) or 2e-3 (velocities, impulses, rewards) of the
  same scale, the integer and bool leaves exactly, the curriculum scalars
  within 1e-6.
- spd_inverse's plain version at n = 46 against the JAX package's jnp path,
  on the two-arm PD-augmented mass matrices (block-diagonal: the arms share
  no moving link) and on a dense SPD batch, within 1e-5 of the largest
  entry; and a numpy model of the n = 46 block layout's data flow (rows 47
  words apart, a thread per row, W = L^-1 row by row, the lower triangle
  of W^T W a thread per entry) against the plain version on the dense
  batch.
- `build_slot_maps` on the two-arm scene: 46 distinct int64 masks, arm 1's
  at bits 23-45 (past an int32), each slot's mask its body's ancestors.
- The sweep's and prep_deff's plain versions at nv 46 against the JAX
  package's `_solve_jacobi_soa` and chunked prep on a built two-arm state:
  each env's active box 1 mm over one hand's fingers (even envs arm 0's,
  odd envs arm 1's) and falling at 0.5 m/s onto them. The effective masses
  within 1e-4 of their scale, the solve's qd, object velocities and world
  impulses within 2e-3 times max(1, scale); both arms' slots carry
  impulses.
"""

import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handarm_tpu.envs import allegro_kuka as jak
from handarm_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from handarm_tpu.physics import contacts as jc
from handarm_tpu.physics import dynamics as jdy
from handarm_tpu.physics import kinematics as jk
from handarm_tpu.physics import model as jmodel
from handarm_tpu.physics import solver as jsv
from handarm_tpu.robots import spherefit as jsf
from handarm_tpu_torch.envs import allegro_kuka as tak
from handarm_tpu_torch.math.quat import quat_rotate
from handarm_tpu_torch.ops import contact_sweep as tsw
from handarm_tpu_torch.ops import prep_deff as tdeff
from handarm_tpu_torch.ops import spd_inverse as tspd
from handarm_tpu_torch.physics import contacts as tc
from handarm_tpu_torch.physics import dynamics as tdyn
from handarm_tpu_torch.physics import kinematics as tkin
from handarm_tpu_torch.physics import model as tmodel
from handarm_tpu_torch.physics import solver as tsv
from handarm_tpu_torch.physics.engine import initial_state as t_initial
from handarm_tpu_torch.robots import spherefit as tsf
from test_pallas_ops import spd_batch
from test_torch_allegro_kuka import _close, _forced, assert_state_close, port_state
from test_torch_locomotion import _compare_models

torch.set_num_threads(1)
B = 8
NV = 46
ARM = 23  # dofs a arm
POS_TOL, VEL_TOL = 2e-4, 2e-3
STEPS = 3
VARIANTS = ("reorientation", "regrasping")
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def two_arms(tmp_path_factory):
    """(variant -> (JAX env, port env), the JAX package's composed file), at
    B = 8."""
    jax_file = tmp_path_factory.mktemp("two_arms") / "kuka_allegro_two_arms.urdf"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jak, "KUKA_ALLEGRO_URDF", tak.KUKA_ALLEGRO_URDF)
        mp.setattr(jak, "TWO_ARMS_URDF", str(jax_file))
        jenvs = {v: jak.make_allegro_kuka_two_arms(variant=v, num_envs=B) for v in VARIANTS}
        scene = jenvs["reorientation"].scene
        orig = jak.engine_step
        engine = jax.jit(lambda phys: orig(scene, phys))
        mp.setattr(jak, "engine_step", lambda sc, phys: engine(phys))
        hand = jax.jit(jenvs["reorientation"]._hand)
        for jenv in jenvs.values():
            jenv.scene = scene  # the same scene in both variants
            jenv._hand = hand
            jenv._fresh = jax.jit(jenv._fresh, static_argnums=1)
            jenv._obs = jax.jit(jenv._obs)
        yield ({v: (jenvs[v], tak.make_allegro_kuka_two_arms(v, num_envs=B, device="cpu"))
                for v in VARIANTS}, str(jax_file))


def _object_draws(key) -> tak.AKObjectDraws:
    kp, kq = jax.random.split(key)
    return tak.AKObjectDraws(pos=_t(jax.random.uniform(kp, (B, 3), minval=-1.0, maxval=1.0)),
                             rot=_t(jax.random.normal(kq, (B, 4))))


def _goal_draws(key) -> tak.AKGoalDraws:
    kp, kq, _ = jax.random.split(key, 3)
    return tak.AKGoalDraws(u=_t(jax.random.uniform(kp, (B, 3))),
                           rot=_t(jax.random.normal(kq, (B, 4))))


def fresh_draws(key) -> tak.AKDraws:
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, B)`
    makes (the success draws zero: a reset reads none)."""
    k1, k2, k3, k4, _ = jax.random.split(key, 5)
    return tak.AKDraws(
        dof=_t(jax.random.uniform(k1, (B, NV))),
        dof_vel=_t(jax.random.uniform(k2, (B, NV), minval=-1.0, maxval=1.0)),
        obj=_object_draws(k3), goal=_goal_draws(k4),
        resample=tak.AKGoalDraws(u=torch.zeros(B, 3), rot=torch.ones(B, 4)),
        ret=tak.AKObjectDraws(pos=torch.zeros(B, 3), rot=torch.ones(B, 4)))


def step_draws(state_key) -> tak.AKDraws:
    _, k_goal, k_obj, k_reset = jax.random.split(state_key, 4)
    return fresh_draws(k_reset)._replace(resample=_goal_draws(k_goal), ret=_object_draws(k_obj))


# --- the composed robot ------------------------------------------------------------


def test_composed_urdf_matches_jax(two_arms):
    """The port's file holds the JAX generator's elements, in order, with the
    same attributes: the links, joints and origins of both copies and the
    two mounts."""
    _, jax_file = two_arms
    path = tak.generate_two_arms_urdf()
    assert ET.canonicalize(from_file=path) == ET.canonicalize(from_file=jax_file)
    root = ET.parse(path).getroot()
    mounts = {j.get("name"): (j.find("child").get("link"), j.find("origin").attrib)
              for j in root.findall("joint") if j.get("name").endswith("mount")}
    assert mounts == {
        "a0_mount": ("a0_iiwa7_base_link", {"xyz": "-1.1 0 0", "rpy": "0 0 1.5707963"}),
        "a1_mount": ("a1_iiwa7_base_link", {"xyz": "1.1 0 0", "rpy": "0 0 -1.5707963"})}
    one = ET.parse(tak.KUKA_ALLEGRO_URDF).getroot()
    n_links = len(one.findall("link"))
    assert len(root.findall("link")) == 2 * n_links + 1  # and world_root
    assert tak.generate_two_arms_urdf() == path  # written once a content


def test_two_arms_compile_alike(two_arms):
    envs, jax_file = two_arms
    jenv, tenv = envs["reorientation"]
    ja, ta = jmodel.compile_urdf(jax_file), tmodel.compile_urdf(jax_file)
    _compare_models(ta, ja)
    _compare_models(tenv.art, ja)
    assert ta.nv == NV and not ta.floating
    one = tmodel.compile_urdf(tak.KUKA_ALLEGRO_URDF).joint_names
    assert ta.joint_names == [f"a{a}_{n}" for a in (0, 1) for n in one]
    for a in (0, 1):
        for name in ("palm_link",) + tak.FINGERTIPS:
            assert ta.sites[f"a{a}_{name}"].body >= 0
    jb, jcn, jr = jsf.generic_collision_spheres(jax_file, ja, 2)
    tb, tcn, tr = tsf.generic_collision_spheres(jax_file, ta, 2)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tcn, jcn)
    np.testing.assert_array_equal(tr, jr)
    assert len(tb) == 104 and sorted(set(tb.tolist())) == list(range(NV))
    js, ts = jenv.scene, tenv.scene
    np.testing.assert_array_equal(ts.spheres.body, js.spheres.body)
    np.testing.assert_allclose(ts.spheres.offset.numpy(), np.asarray(js.spheres.offset),
                               atol=1e-7)
    np.testing.assert_array_equal(ts.spheres.radius.numpy(), np.asarray(js.spheres.radius))
    np.testing.assert_array_equal(ts.base_pos.numpy(), np.zeros(3))
    np.testing.assert_allclose(ts.base_pos.numpy(), np.asarray(js.base_pos), atol=1e-7)
    for f in ("kp", "kd"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    for f in ("robot_body", "obj_a", "obj_b", "friction"):
        np.testing.assert_array_equal(getattr(ts.slots, f), getattr(js.slots, f))
    assert ts.slots.num_slots == js.slots.num_slots == 506
    assert int((ts.slots.robot_body >= 0).sum()) == 416
    assert len(set(ts.slots.robot_body[ts.slots.robot_body >= 0].tolist())) == NV
    assert tenv.K == jenv.K == 3
    np.testing.assert_array_equal(ts.shapes.mass.numpy(), np.asarray(js.shapes.mass))
    np.testing.assert_array_equal(ts.shapes.mass.numpy(), np.full(3, 0.5, np.float32))
    np.testing.assert_array_equal(tenv.obj_halves.numpy(), np.asarray(jenv.obj_halves))
    np.testing.assert_array_equal(tenv.default_q.numpy(), np.asarray(jenv.default_q))
    np.testing.assert_array_equal(tenv.default_q[ARM:ARM + 7].numpy(),
                                  tenv.default_q[:7].numpy())  # both arms' first 7 dofs
    # the palm and the 8 tips at the default pose, in both packages
    from handarm_tpu.physics.engine import initial_state as j_initial

    tq = tenv.default_q[None].expand(B, NV)
    tips, palm, pq, pv, pw = tenv.hand(t_initial(ts, B, q0=tq))
    jtips, jpalm, jpq, jpv, jpw = jenv._hand(j_initial(js, B, q0=jnp.asarray(tq.numpy())))
    for name, a, b in (("tips", tips, jtips), ("palm", palm, jpalm), ("palm quat", pq, jpq)):
        _close(a, b, 1e-6, name)
    assert tips.shape == (B, 8, 3)
    print(f"two arms at the default pose: arm 0's palm point {palm[0].numpy()}; the tips' x "
          f"{tips[0, :, 0].numpy()}")


def test_obs_widths_match(two_arms):
    envs, _ = two_arms
    for v in VARIANTS:
        jenv, tenv = envs[v]
        assert tenv.num_obs == jenv.num_obs == (179 if v == "reorientation" else 161)
        assert tenv.num_keypoints == jenv.num_keypoints == (4 if v == "reorientation" else 1)
        assert tenv.num_actions == jenv.num_actions == NV
        assert tenv.num_teacher_obs == jenv.num_teacher_obs == 0
        assert tenv.num_tips == 8


# --- the env steps ---------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_steps_match(variant, two_arms):
    jenv, tenv = two_arms[0][variant]
    key = jax.random.PRNGKey(11)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(key))
    _close(tobs, jobs, 1e-6, "reset obs")
    assert_state_close(ts, js)
    # a fresh goal is the volume's draw shifted by -0.05 in y
    assert float(ts.goal_pos[:, 1].min()) >= float(tak.TVOL_MIN[1]) - 0.05 - 1e-6

    js = _forced(jenv, js)
    ts = port_state(js)
    rng = np.random.default_rng(5)
    for i in range(STEPS):
        a = rng.uniform(-0.3, 0.3, (B, NV)).astype(np.float32)
        draws = step_draws(js.key)
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
            np.testing.assert_allclose(float(ts.tolerance), 0.075 * 0.9, rtol=1e-6)
            assert int(ts.frames_since_curriculum) == 0
            if variant == "regrasping":  # returned over the table's centre, unlifted
                obj0 = ts.physics.objects.pos[0, 0]
                np.testing.assert_array_equal(ts.physics.objects.linvel[0, 0].numpy(), 0.0)
                assert abs(float(obj0[2]) - (tak.TABLE_TOP + 0.25)) <= 0.02 + 1e-6
                assert not bool(ts.lifted[0]) and float(ts.obj_init_z[0]) == float(obj0[2])


# --- spd_inverse at n = 46 ---------------------------------------------------------


def _mtilde(tenv, q):
    sc = tenv.scene
    fk = tkin.forward_kinematics(sc.model, torch.tensor(q), sc.base_quat[None],
                                 sc.base_pos[None])
    return tdyn.compute_dyn(sc.model, fk, torch.zeros(q.shape), torch.zeros(3), sc.kp, sc.kd,
                            sc.params.dt / sc.params.substeps).Mtilde.numpy()


def test_spd_inverse_plain_matches_two_arm_matrices(two_arms):
    jenv, tenv = two_arms[0]["reorientation"]
    rng = np.random.default_rng(6)
    q = np.concatenate([np.broadcast_to(np.asarray(jenv.default_q), (4, NV)),
                        rng.uniform(tenv.art.q_min, tenv.art.q_max, (12, NV))]).astype(np.float32)
    M = _mtilde(tenv, q)
    # the arms share no moving link: the two 23 x 23 blocks never couple
    assert np.abs(M[:, :ARM, ARM:]).max() == 0.0
    dense = np.asarray(spd_batch(8, NV, seed=12))
    assert np.abs(dense[:, :ARM, ARM:]).min() > 0.0
    for name, m in (("two-arm", M), ("dense", dense)):
        cond = np.linalg.cond(m.astype(np.float64))
        print(f"{name}: n = {NV}, cond {cond.min():.3e} to {cond.max():.3e}")
        want = np.asarray(j_spd_inverse(jnp.asarray(m), force_pallas=False))
        got = tspd.spd_inverse_plain(torch.tensor(m)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), err_msg=name)
    assert NV in tspd.KERNEL_N


def _block_layout(M):
    """The n = 46 kernel's data flow in numpy float32 for one matrix: the
    matrix at rows LD = 47 words apart, thread i holding row i (64
    threads, rows past n zero); Cholesky column j: each thread's sum
    against row j of L, the pivot published by thread j, then every
    thread's 1 / L_jj and its scaled entry; W = L^-1 row by row (thread k
    writes row k of W over row k of L, the threads below take it into
    their running sums); Minv's lower triangle a thread per entry from W,
    mirrored."""
    n, threads, ld = M.shape[0], 64, M.shape[0] | 1
    assert ld % 2 == 1 and len({(i * ld) % 32 for i in range(32)}) == 32
    S = np.zeros((n, ld), np.float32)
    S[:, :n] = M
    i = np.arange(threads)
    R = np.zeros((threads, n), np.float32)
    R[:n] = S[:, :n]
    for j in range(n):
        a = R[:, j].copy()
        for k in range(j):
            a = a - R[:, k] * S[j, k]
        inv = np.float32(1.0) / np.sqrt(np.maximum(a[j], np.float32(1e-12)))
        R[:, j] = np.where(i == j, inv, np.where(i > j, a * inv, np.float32(0.0)))
        S[j:, j] = R[j:n, j]
    T = np.zeros((threads, n), np.float32)
    for k in range(n):
        S[k, :k] = T[k, :k] * R[k, k]
        S[k, k] = R[k, k]
        below = (i > k) & (i < n)
        for r in range(k + 1):
            T[:, r] = np.where(below, T[:, r] - R[:, k] * S[k, r], T[:, r])
    G = np.zeros((n, n), np.float32)
    for e in range(n * (n + 1) // 2):
        a = int((np.sqrt(8 * e + 1) - 1) // 2)
        c = e - a * (a + 1) // 2
        s = np.float32(0.0)
        for k in range(a, n):
            s = s + S[k, a] * S[k, c]
        G[a, c] = G[c, a] = s
    return G


def test_spd_inverse_block_layout_n46():
    M = np.asarray(spd_batch(3, NV, seed=13))
    want = tspd.spd_inverse_plain(torch.tensor(M)).numpy()
    for b in range(M.shape[0]):
        got = _block_layout(M[b])
        np.testing.assert_array_equal(got, got.T)  # mirrored by construction
        np.testing.assert_allclose(got, want[b], atol=1e-5 * np.abs(want[b]).max())


# --- the slot maps and the two kernels' plain versions -------------------------------


def test_slot_maps_two_arms(two_arms):
    _, tenv = two_arms[0]["reorientation"]
    sc = tenv.scene
    m, slots = sc.maps, sc.slots
    assert m.anc_bits.dtype == torch.int64 and m.groups.link_bits.dtype == torch.int64
    bits = m.anc_bits.numpy().view(np.uint64)
    anc = np.asarray(tenv.art.ancestor_mask)
    robot = slots.robot_body >= 0
    # each slot's mask: its body's ancestors, bit u for dof u
    for c in np.flatnonzero(robot):
        want = sum(1 << u for u in np.flatnonzero(anc[slots.robot_body[c]] > 0))
        assert int(bits[c]) == want, c
    assert (bits[~robot] == 0).all()
    link = m.groups.link_bits.numpy().view(np.uint64)
    assert len(link) == len(set(link.tolist())) == NV <= tsw.MAX_LINKS
    arm1 = (link >> np.uint64(ARM)) != 0
    assert arm1.sum() == ARM  # arm 1's 23 bodies
    assert all(int(x) < (1 << ARM) for x in link[~arm1])  # arm 0's below bit 23
    assert all((int(x) & ((1 << ARM) - 1)) == 0 for x in link[arm1])  # no coupling
    assert (link >= np.uint64(1 << 32)).any()  # an int32 would drop them
    # every robot slot's group mask is its own
    sl = m.groups.slot_link.numpy()
    np.testing.assert_array_equal(link[sl[robot]], bits[robot])
    assert (sl[~robot] == -1).all()


def _rest_on_hands(tenv, B):
    """A port state of every env with its active box 1 mm over the index,
    middle and ring fingers' last two links of one hand (arm b % 2), flat,
    falling at 0.5 m/s, the arms at their default pose with small random
    joint velocities."""
    sc = tenv.scene
    q = tenv.default_q[None].expand(B, NV).clone()
    phys = t_initial(sc, B, q0=q)
    fk = tkin.forward_kinematics(sc.model, q, sc.base_quat[None], sc.base_pos[None])
    body = torch.as_tensor(sc.spheres.body)
    ctr = fk.body_pos[:, body] + quat_rotate(fk.body_quat[:, body], sc.spheres.offset[None])
    names = tenv.art.body_names
    arm_of = np.array([int(names[b][1]) for b in sc.spheres.body])
    finger = np.array([names[b][3:].split("_link_")[0] in ("index", "middle", "ring")
                       and names[b][-1] in "23" for b in sc.spheres.body])
    i = torch.arange(B)
    under = torch.as_tensor(finger[None] & (arm_of[None] == (np.arange(B) % 2)[:, None]))
    xy = (ctr[..., :2] * under[..., None]).sum(1) / under.sum(1, keepdim=True)
    slot = tenv.active(B)
    half = tenv.obj_halves[slot]
    r = sc.spheres.radius[None]
    gap = torch.clamp((ctr[..., :2] - xy[:, None]).abs() - half[:, None, :2], min=0.0)
    d2 = (gap ** 2).sum(-1)
    top = torch.where(d2 < r ** 2, ctr[..., 2] + torch.sqrt(torch.clamp(r ** 2 - d2, min=0.0)),
                      torch.tensor(-1.0)).amax(-1)
    o = phys.objects
    pos, linvel = tenv.park_positions(B).clone(), o.linvel.clone()
    pos[i, slot] = torch.cat([xy, (top + half[:, 2] + 0.001)[:, None]], -1)
    linvel[i, slot, 2] = -0.5
    g = torch.Generator().manual_seed(3)
    qd = 0.2 * (torch.rand(B, NV, generator=g) * 2 - 1)
    return phys._replace(robot=phys.robot._replace(qd=qd),
                         objects=o._replace(pos=pos, linvel=linvel))


def test_sweep_and_deff_plain_match_jax(two_arms):
    """prep_deff's plain version (robot effective masses, slots with object
    sides taken away on the JAX side so that its d_eff is the robot's alone)
    and the sweep's plain version (8 sweeps, no warm start) at nv 46 against
    the JAX package's chunked prep and `_solve_jacobi_soa` on the same
    built state."""
    jenv, tenv = two_arms[0]["reorientation"]
    ts, js = tenv.scene, jenv.scene
    phys = _rest_on_hands(tenv, B)
    h = ts.params.dt / ts.params.substeps
    r, o = phys.robot, phys.objects
    tf = tkin.forward_kinematics(ts.model, r.q, ts.base_quat[None], ts.base_pos[None])
    td = tdyn.compute_dyn(ts.model, tf, r.qd, torch.zeros(3), ts.kp, ts.kd, h)
    tcon = tc.generate_contacts(ts.slots, ts.shapes, ts.spheres, ts.geom, o.pos, o.quat,
                                tf.body_quat, tf.body_pos)
    tprep = tsv.prepare(ts.model, tf, td.Minv, ts.maps, ts.slots, tcon, ts.shapes, o.pos,
                        o.quat, h, ts.params.solver)
    C = ts.slots.num_slots
    d_robot = tdeff.robot_deff_plain(
        tf.screw.permute(2, 0, 1).contiguous(), tcon.pos.permute(2, 0, 1).contiguous(),
        tprep.basis.permute(2, 3, 0, 1).reshape(9, B, C).contiguous(), ts.maps.anc_slot,
        td.Minv.reshape(B, NV * NV).contiguous())
    pack = tsv.anchored_pack(tprep)
    qd, obj, lam = tsw.contact_sweep_plain(
        pack.planes, tprep.bias.contiguous(), pack.screws, r.qd.contiguous(), pack.minv2,
        torch.stack([o.linvel[..., k] for k in range(3)] + [o.angvel[..., k] for k in range(3)]),
        torch.zeros(3, B, C), ts.maps.anc_slot, ts.maps.obj_idx, ts.maps.signs,
        ts.params.solver.iterations, ts.params.solver.relaxation, apply_warm=False)

    f = lambda x: jnp.asarray(x.numpy())
    jq, jqd, jpos, jquat, jlv, jav = (f(x) for x in (r.q, r.qd, o.pos, o.quat, o.linvel,
                                                     o.angvel))
    robot_only = js.slots._replace(obj_a=np.full(C, -1, np.int32),
                                   obj_b=np.full(C, -1, np.int32))

    @jax.jit
    def jax_side(jq, jqd, jpos, jquat, jlv, jav):
        jf = jk.forward_kinematics(js.model, jq, js.base_quat[None], js.base_pos[None])
        jd = jdy.compute_dyn(js.model, jf, jqd, jnp.zeros(3), js.kp, js.kd, h)
        jcon = jc.generate_contacts(js.slots, js.shapes, js.spheres, js.geom, jpos, jquat,
                                    jf.body_quat, jf.body_pos)
        jprep = jsv._prepare(js.model, jf, jd.Minv, js.slots, jcon, js.shapes, jpos, jquat, h,
                             js.params.solver)
        jrob = jsv._prepare(js.model, jf, jd.Minv, robot_only, jcon, js.shapes, jpos, jquat,
                            h, js.params.solver)
        return jrob.d_eff, jsv._solve_jacobi_soa(jprep, jqd, jlv, jav, js.params.solver)

    jd_robot, (wqd, wlv, wav, wimp) = jax_side(jq, jqd, jpos, jquat, jlv, jav)
    has = torch.as_tensor(ts.slots.robot_body >= 0)
    got_d = torch.clamp(d_robot.permute(1, 2, 0), min=1e-8)
    want_d = np.asarray(jd_robot)
    np.testing.assert_allclose(got_d[:, has].numpy(), want_d[:, has.numpy()],
                               atol=1e-4 * np.abs(want_d[:, has.numpy()]).max(), rtol=1e-4)
    np.testing.assert_array_equal(d_robot[:, :, ~has].numpy(), 0.0)
    _close(qd, wqd, VEL_TOL, "qd")
    _close(obj[:3].permute(1, 2, 0), wlv, VEL_TOL, "object linvel")
    _close(obj[3:].permute(1, 2, 0), wav, VEL_TOL, "object angvel")
    imp = tsv.anchored_impulse_world(pack, lam)
    _close(imp, wimp, VEL_TOL, "impulse")
    # both arms' robot slots carry impulses (arm 1's masks at bits 23-45)
    pushed = (imp.norm(dim=-1) > 0) & has[None]
    arm1 = torch.as_tensor((ts.maps.anc_bits.numpy().view(np.uint64) >> np.uint64(ARM)) != 0)
    per_arm = [int((pushed & ~arm1[None]).any(-1).sum()), int((pushed & arm1[None]).any(-1).sum())]
    print(f"two arms: envs whose robot slots carry impulses, arm 0 / arm 1: {per_arm} of {B}")
    assert per_arm[0] >= B // 4 and per_arm[1] >= B // 4
