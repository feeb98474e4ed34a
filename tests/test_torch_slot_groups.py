"""The static slot groups that the sweep and deff kernels reduce over
(physics/solver.py `build_slot_groups`), and the kernels' grouped algebra.

For the slots of the two UR5+SIH scenes, with the hand's collision
spheres and with the arm's as well (`hand_only_collision=False`: 190 and
456 slots, 17 dof masks), of the classic tasks' floating-base robots
with no objects (K = 0, no object sides: the Quadcopter's 4 rotor-arm
slots in 4 masks of 7 dofs, the 6 base dofs and the arm's pitch hinge;
Ingenuity's 8 chassis slots in one mask of the 6 base dofs; the Ant
stand-in's 37 slots in 9 masks, the torso's and each leg's hip and
ankle; the Humanoid stand-in's 51 in 13 masks over 27 dofs; the ANYmal
stand-in's 30 in 13 masks over 18 dofs, the base's and each leg's hip,
thigh and shank, alike on the flat ground and the terrain), of the balance
bot with its ball (K = 1, two object sides: 161 slots, 80 robot-ball and
the ball's ground slot; 7 masks, the tray's and each leg's two), of the
Franka stand-in's fixed base (9 masks over 9 dofs: links 1-7 and each
finger) with the two cubes (134 slots, K = 2) and with the drawer against
the cabinet's walls (190 slots, K = 1), of the Trifinger's three 3-dof
fingers with the cube and four walls (91 slots in 9 masks), the Allegro
hand's four 4-dof fingers (150 slots in 16 masks) and the Shadow hand's
wrist, palm and five fingers (160 slots in 18 masks, none on a knuckle or
the thumb's base and hub), each with one cube, of the KUKA arm with the
Allegro hand on its flange (AllegroKuka: 298 slots in 23 masks over 23
dofs, the arm's 7 links and the fingers' 16, with three boxes: 52
robot-table, 156 robot-object, 42 object-table and 48 object-pair slots),
of two such arms facing each other (the two-arm AllegroKuka: 506 slots in
46 masks over 46 dofs, arm 1's at bits 23-45 of the 64-bit masks: 104
robot-table, 312 robot-object, 42 object-table and 48 object-pair slots),
and of a random scene with an
arbitrary set of dof masks, the tables must list every robot slot under
exactly the group of its mask and every object side under exactly its
(side, object) bin, in ascending slot order. A torch emulation of the
kernels' data flow, written here and reading only those tables (link
velocities V_l = S_l qd gathered per slot, sums over the groups' slot
lists, qd += Minv J F_l with J the screws under the link masks,
d = xi^T Phi_l xi),
must agree with the plain versions `contact_sweep_plain` and
`robot_deff_plain` within 1e-5 of each output's largest value (float32
sums in another order). The CUDA kernels themselves are held against the
plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from handarm_tpu_torch.envs.tasks import make_env
from handarm_tpu_torch.ops import contact_sweep as tsw
from handarm_tpu_torch.ops import prep_deff as tdeff
from handarm_tpu_torch.physics.solver import build_slot_groups

torch.set_num_threads(1)
SCENES = ["Ur5SihLift", "Ur5SihMultiObjectManipulation", "random",
          "Ur5SihLift arm", "Ur5SihMultiObjectManipulation arm", "Quadcopter", "Ingenuity",
          "Ant", "Humanoid", "BallBalance", "Anymal", "AnymalTerrain", "FrankaCubeStack",
          "FrankaCabinet", "Trifinger", "AllegroHand", "ShadowHand", "AllegroKukaReorientation",
          "AllegroKukaTwoArmsReorientation"]
ARM_SLOTS = {"Ur5SihLift arm": 190, "Ur5SihMultiObjectManipulation arm": 456}


def _mask(*dofs):
    """A dof mask: the floating base's 6 dofs and the given joint dofs."""
    return 0x3F | sum(1 << d for d in dofs)


# the classic tasks' scenes: (slots, dof masks, dofs, objects). The
# Humanoid's dofs: abdomen 6-8, right leg 9-14 (hip x z y, knee, ankle y x),
# left leg 15-20, right arm 21-23, left arm 24-26; the ANYmal's: HAA, HFE,
# KFE of LF 6-8, LH 9-11, RF 12-14, RH 15-17
# the Franka's fixed base: links 1-7 (the hand rides on link 7), each finger
_FRANKA = [(1 << k) - 1 for k in range(1, 8)] + [0x7F | 1 << 7, 0x7F | 1 << 8]
# chains of a fixed base: each link's mask holds the dofs from the chain's
# first to its own. The Trifinger's three 3-dof fingers and the Allegro's four
# 4-dof fingers (every link fitted); the Shadow hand's wrist (dofs 0, 1) under
# the palm's spheres, then the first, middle and ring fingers' J3-J0 (2-5,
# 6-9, 10-13; the knuckle J3 bodies carry no geom), the little finger's
# metacarpal J4 and J3-J0 (14-18) and the thumb's J4-J0 (19-23; its base and
# hub carry none)
_chain = lambda first, links, skip=(): [((1 << (k + 1)) - 1) << first for k in range(links)
                                        if k not in skip]
_WRIST = 0b11
_SHADOW = sorted([0b1, _WRIST] + [_WRIST | m for f in (2, 6, 10) for m in _chain(f, 4, (0,))]
                 + [_WRIST | m for m in _chain(14, 5, (1,))]
                 + [_WRIST | m for m in _chain(19, 5, (0, 2))])
# the KUKA arm's 7 links (the palm rides on link 7), then the Allegro's four
# 4-dof fingers on it (dofs 7-10, 11-14, 15-18, 19-22): 23 masks
_KUKA = _chain(0, 7) + [0x7F | m for f in (7, 11, 15, 19) for m in _chain(f, 4)]
_ANYMAL = (30, sorted([_mask()] + [_mask(*range(a, a + k)) for a in (6, 9, 12, 15)
                                   for k in (1, 2, 3)]), 18, 0)
CRAFT = {"Quadcopter": (4, [_mask(u) for u in (6, 8, 10, 12)], 14, 0),
         "Ingenuity": (8, [_mask()], 8, 0),
         "Ant": (37, sorted([_mask()] + [_mask(h) for h in (6, 8, 10, 12)]
                            + [_mask(h, h + 1) for h in (6, 8, 10, 12)]), 14, 0),
         "Humanoid": (51, sorted([_mask(), _mask(6, 7), _mask(6, 7, 8)]
                                 + [_mask(6, 7, 8, *range(a, a + k))
                                    for a in (9, 15) for k in (3, 4, 6)]
                                 + [_mask(*range(a, a + k)) for a in (21, 24) for k in (2, 3)]),
                      27, 0),
         "BallBalance": (161, sorted([_mask()] + [_mask(u) for u in (6, 8, 10)]
                                     + [_mask(u, u + 1) for u in (6, 8, 10)]), 12, 1),
         "Anymal": _ANYMAL, "AnymalTerrain": _ANYMAL,
         "FrankaCubeStack": (134, _FRANKA, 9, 2), "FrankaCabinet": (190, _FRANKA, 9, 1),
         "Trifinger": (91, sorted(sum((_chain(f, 3) for f in (0, 3, 6)), [])), 9, 1),
         "AllegroHand": (150, sorted(sum((_chain(f, 4) for f in (0, 4, 8, 12)), [])), 16, 1),
         "ShadowHand": (160, _SHADOW, 24, 1),
         "AllegroKukaReorientation": (298, _KUKA, 23, 3),
         # arm 1's 23 masks are arm 0's shifted past its dofs
         "AllegroKukaTwoArmsReorientation": (506, sorted(_KUKA + [m << 23 for m in _KUKA]), 46,
                                             3)}
# the object bins' slot counts of the scenes with objects, (side, object) in order
BINS = {"BallBalance": [1, 80], "FrankaCubeStack": [22, 22, 38, 38], "FrankaCabinet": [100, 30],
        "Trifinger": [28, 21], "AllegroHand": [14, 68], "ShadowHand": [14, 73],
        "AllegroKukaReorientation": [30, 30, 30, 68, 68, 68],
        "AllegroKukaTwoArmsReorientation": [30, 30, 30, 120, 120, 120]}
B = 6


def _scene(name):
    """(anc [C, nv] float, anc_bits [C], obj_idx [S, C], K, signs, groups)."""
    if name == "random":
        rng = np.random.default_rng(3)
        C, nv, K = 70, 20, 3
        masks = rng.integers(1, 1 << nv, size=6)
        bits = np.where(rng.uniform(size=C) < 0.3, 0, masks[rng.integers(0, 6, C)])
        obj_idx = np.where(rng.uniform(size=(2, C)) < 0.4, -1, rng.integers(0, K, (2, C)))
        anc = ((bits[:, None] >> np.arange(nv)) & 1).astype(np.float32)
        return (torch.tensor(anc), bits, obj_idx, K, (1.0, -1.0),
                build_slot_groups(bits, obj_idx, K))
    if name in CRAFT:
        from handarm_tpu_torch.envs.registry import make_env as make_task

        env, _ = make_task(name, ["num_envs=1"], device="cpu")
        m = env.scene.maps
        return (m.anc_slot, m.anc_bits.numpy(), m.obj_idx.numpy(),
                env.scene.shapes.num_objects, m.signs, m.groups)
    task, _, arm = name.partition(" ")
    env = make_env(task, device="cpu", num_envs=1, use_drop_init=False, randomize=False,
                   hand_only_collision=not arm)
    m = env.scene.maps
    return (m.anc_slot, m.anc_bits.numpy(), m.obj_idx.numpy(), max(env.num_objects, 1),
            m.signs, m.groups)


@pytest.fixture(scope="module", params=SCENES)
def scene(request):
    return request.param, _scene(request.param)


def _lists(ptr, slots):
    ptr, slots = ptr.numpy(), slots.numpy()
    return [slots[ptr[g]:ptr[g + 1]] for g in range(len(ptr) - 1)]


def test_tables_group_every_slot_once(scene):
    name, (anc, bits, obj_idx, K, signs, g) = scene
    C = bits.shape[0]
    link_bits, slot_link = g.link_bits.numpy(), g.slot_link.numpy()
    # the 64-bit dof masks, every other table int32
    assert g.link_bits.dtype == torch.int64 and all(t.dtype == torch.int32 for t in g[1:])
    assert len(set(link_bits.tolist())) == len(link_bits) and np.all(link_bits != 0)
    assert len(link_bits) <= tsw.MAX_LINKS
    if name in CRAFT:  # a floating base's 6 dofs in every mask; the Franka's chain
        assert sorted(link_bits.tolist()) == CRAFT[name][1]
    elif name != "random":  # one group per hand link, and per arm link with the arm's spheres
        assert len(link_bits) == (17 if name in ARM_SLOTS else 11) <= anc.shape[1]
    links = _lists(g.link_ptr, g.link_slots)
    seen = np.concatenate(links)
    assert sorted(seen.tolist()) == np.flatnonzero(bits != 0).tolist()  # each once
    for l, lst in enumerate(links):
        assert np.all(np.diff(lst) > 0) and np.all(bits[lst] == link_bits[l])
        assert np.all(slot_link[lst] == l)
    assert np.all(slot_link[bits == 0] == -1)
    bins = _lists(g.obj_ptr, g.obj_slots)
    assert len(bins) == len(obj_idx) * K
    for j, lst in enumerate(bins):
        q, k = divmod(j, K)
        assert np.all(np.diff(lst) > 0)
        assert lst.tolist() == np.flatnonzero(obj_idx[q] == k).tolist()
    assert len(g.obj_slots) == int((obj_idx >= 0).sum()) and len(g.slot_link) == C


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _link_mask(g, nv):
    return ((g.link_bits.long()[:, None] >> torch.arange(nv)) & 1).float()  # [L, nv]


def emulate_sweep(planes, bias, screws, qd, minv2, obj, lam0, g, signs, iterations, omega):
    """The sweep kernel's data flow in torch (warm apply + `iterations`
    sweeps), reading the slot couplings only from the group tables."""
    NP, Bn, C = planes.shape
    nv, K, S = qd.shape[1], obj.shape[2], len(signs)
    mask = _link_mask(g, nv)
    slot_link = g.slot_link.long()
    robot = (slot_link >= 0).float()
    links = _lists(g.link_ptr, g.link_slots)
    bins = _lists(g.obj_ptr, g.obj_slots)
    side_obj = torch.full((S, C), -1, dtype=torch.long)
    for j, lst in enumerate(bins):
        side_obj[j // K, torch.as_tensor(lst, dtype=torch.long)] = j % K
    P = [planes[i] for i in range(NP)]
    n, t1, t2, p = P[0:3], P[3:6], P[6:9], P[9:12]
    mu, inv_d, gate = P[12], P[13:16], P[16]
    Minv = minv2.reshape(Bn, nv, nv)
    ob = obj.clone()
    lam = [lam0[i] for i in range(3)]

    def group_sum(x, lst):  # [..., C] -> [...] over one group's slots
        return x[..., torch.as_tensor(lst, dtype=torch.long)].sum(-1)

    # W = Minv J with J_u(a, l) = s_au for the dofs u of link l: qd += W Fl
    J = screws.permute(1, 2, 0)[:, :, :, None] * mask.T[None, :, None, :]  # [B, nv, 6, L]
    W = torch.einsum("buv,bvk->buk", Minv, J.reshape(Bn, nv, -1))

    def apply(qd, ob, dP):
        F = torch.stack(list(_cross(p, dP)) + list(dP))  # [6, B, C]
        Fl = torch.stack([group_sum(F, lst) for lst in links], -1)  # [6, B, L]
        qd = qd + torch.einsum("buk,bk->bu", W, Fl.permute(1, 0, 2).reshape(Bn, -1))
        ob = ob.clone()
        for q in range(S):
            base = 17 + 10 * q
            r, Iv, invm = P[base:base + 3], P[base + 3:base + 9], P[base + 9]
            tq = _cross(r, dP)
            G = torch.stack([dP[0] * invm, dP[1] * invm, dP[2] * invm,
                             Iv[0] * tq[0] + Iv[1] * tq[1] + Iv[2] * tq[2],
                             Iv[1] * tq[0] + Iv[3] * tq[1] + Iv[4] * tq[2],
                             Iv[2] * tq[0] + Iv[4] * tq[1] + Iv[5] * tq[2]])
            for k in range(K):
                ob[:, :, k] += signs[q] * group_sum(G, bins[q * K + k])
        return qd, ob

    def velocity(qd, ob):
        V = torch.stack([(screws[a] * qd) @ mask.T for a in range(6)])  # [6, B, L]
        w = V[:, :, slot_link.clamp(min=0)] * robot  # [6, B, C]
        wx = _cross(w[0:3], p)
        v = [w[3 + i] + wx[i] for i in range(3)]
        for q in range(S):
            k, has = side_obj[q].clamp(min=0), (side_obj[q] >= 0).float()
            r = P[17 + 10 * q:20 + 10 * q]
            lin, ang = ob[0:3][:, :, k], ob[3:6][:, :, k]
            aw = _cross(ang, r)
            v = [v[i] + signs[q] * has * (lin[i] + aw[i]) for i in range(3)]
        return v

    comb = lambda c: tuple(c[0] * n[i] + c[1] * t1[i] + c[2] * t2[i] for i in range(3))
    qd, ob = apply(qd, ob, comb(lam))
    for _ in range(iterations):
        v = velocity(qd, ob)
        dot = lambda e: v[0] * e[0] + v[1] * e[1] + v[2] * e[2]
        new_n = torch.clamp(lam[0] + (bias - dot(n)) * inv_d[0], min=0.0)
        ft1, ft2 = lam[1] - dot(t1) * inv_d[1], lam[2] - dot(t2) * inv_d[2]
        fmag, fmax = torch.sqrt(ft1 * ft1 + ft2 * ft2), mu * new_n
        sc = torch.where(fmag > fmax, fmax / torch.clamp(fmag, min=1e-9), torch.ones_like(fmag))
        dl = [omega * (new - old) * gate for new, old in zip((new_n, ft1 * sc, ft2 * sc), lam)]
        lam = [a + b for a, b in zip(lam, dl)]
        qd, ob = apply(qd, ob, comb(dl))
    return qd, ob, torch.stack(lam)


def emulate_deff(screws, pos, basis, g, minv2):
    """d = xi^T Phi_l xi with Phi_l = S_l Minv S_l^T over each link's mask."""
    _, Bn, nv = screws.shape
    mask = _link_mask(g, nv)
    Sl = screws.permute(1, 0, 2)[:, None] * mask[None, :, None]  # [B, L, 6, nv]
    Phi = torch.einsum("blau,buv,blev->blae", Sl, minv2.reshape(Bn, nv, nv), Sl)
    slot_link = g.slot_link.long()
    Phi_c = Phi[:, slot_link.clamp(min=0)]  # [B, C, 6, 6]
    out = []
    for d in range(3):
        w = basis[3 * d:3 * d + 3]
        xi = torch.stack(list(_cross(pos, w)) + list(w), -1)  # [B, C, 6]
        out.append(torch.einsum("bca,bcae,bce->bc", xi, Phi_c, xi) * (slot_link >= 0))
    return torch.stack(out)


def _unit(x):
    return x / np.linalg.norm(x, axis=0, keepdims=True)


def _sweep_inputs(C, nv, K, S, seed):
    rng = np.random.default_rng(seed)
    n = _unit(rng.standard_normal((3, B, C)))
    t1 = _unit(np.cross(n, rng.standard_normal((3, B, C)), axis=0))
    t2 = np.cross(n, t1, axis=0)
    pos = rng.normal(0.0, 0.3, (3, B, C)) + np.array([0.5, 0.0, 0.6])[:, None, None]
    mu = rng.uniform(0.3, 1.0, (1, B, C))
    inv_d = rng.uniform(0.5, 5.0, (3, B, C))
    gate = np.where(rng.uniform(size=(1, B, C)) < 0.3, 0.0, rng.uniform(0.2, 1.0, (1, B, C)))
    planes = [n, t1, t2, pos, mu, inv_d, gate]
    for _ in range(S):
        A = rng.standard_normal((B, C, 3, 3))
        I = A @ np.swapaxes(A, -1, -2) + np.eye(3)
        sym = np.stack([I[..., i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))])
        planes += [rng.normal(0.0, 0.05, (3, B, C)), sym, rng.uniform(1.0, 10.0, (1, B, C))]
    A = rng.standard_normal((B, nv, nv))
    minv = (A @ A.transpose(0, 2, 1) + nv * np.eye(nv)) / nv
    ln = np.abs(rng.normal(0.0, 0.05, (B, C)))
    lt = rng.normal(0.0, 0.05, (2, B, C))
    fmag = np.sqrt((lt ** 2).sum(0))
    sc = np.where(fmag > mu[0] * ln, mu[0] * ln / np.maximum(fmag, 1e-9), 1.0)
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    return dict(planes=f(np.concatenate(planes)), bias=f(rng.normal(0.0, 0.1, (B, C))),
                screws=f(rng.standard_normal((6, B, nv))), qd=f(rng.normal(0.0, 0.5, (B, nv))),
                minv2=f(minv.reshape(B, nv * nv)), obj=f(rng.normal(0.0, 0.2, (6, B, K))),
                lam0=f(np.stack([ln, lt[0] * sc, lt[1] * sc])))


def test_grouped_sweep_matches_plain(scene):
    """Warm apply + 2 sweeps with both object sides, at B = 6."""
    name, (anc, bits, obj_idx, K, signs, g) = scene
    C, nv, S = anc.shape[0], anc.shape[1], len(signs)
    a = _sweep_inputs(C, nv, K, S, seed=SCENES.index(name))
    args = (a["planes"], a["bias"], a["screws"], a["qd"], a["minv2"], a["obj"], a["lam0"])
    want = tsw.contact_sweep_plain(*args, anc, torch.as_tensor(obj_idx, dtype=torch.int32),
                                   signs, 2, 1.0, apply_warm=True)
    got = emulate_sweep(*args, g, signs, 2, 1.0)
    for out, gt, wt in zip(("qd", "obj", "lam"), got, want):
        if out == "obj" and K == 0:  # no objects: [6, B, 0] both
            assert gt.shape == wt.shape == (6, B, 0)
            continue
        scale = float(wt.abs().max())
        assert scale > 0, out
        err = float((gt - wt).abs().max())
        assert err <= 1e-5 * scale, f"{out}: {err:.3e} at scale {scale:.3e}"
    assert float(want[2].abs().max()) > 1e-3  # impulses flowed
    assert tsw.launches == 0  # CPU tensors: no kernel


def test_grouped_deff_matches_plain(scene):
    name, (anc, bits, obj_idx, K, signs, g) = scene
    C, nv = anc.shape
    rng = np.random.default_rng(10 + SCENES.index(name))
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    A = rng.standard_normal((B, nv, nv))
    minv2 = f(((A @ A.transpose(0, 2, 1) + nv * np.eye(nv)) / nv).reshape(B, nv * nv))
    screws = f(rng.standard_normal((6, B, nv)))
    pos = f(rng.normal(0.0, 0.3, (3, B, C)) + np.array([0.5, 0.0, 0.6])[:, None, None])
    basis = f(rng.standard_normal((9, B, C)))
    want = tdeff.robot_deff(screws, pos, basis, anc, g, minv2)
    got = emulate_deff(screws, pos, basis, g, minv2)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert np.all(want[:, :, bits == 0].numpy() == 0.0)
    assert tdeff.launches == 0


def test_arm_spheres_within_kernel_limits(scene):
    """The tables pass the kernels' own check (`check_groups`: at most
    MAX_LINKS = 64 masks, int64 masks and int32 lists, shapes, list lengths)
    and the sweep's size limits (C <= 1024, nv <= 64, K <= 8 and K >= 1
    with object sides, 2 sides) at the scene's slots, as the card will see
    them: the craft's K = 0 scenes have no sides."""
    name, (anc, bits, obj_idx, K, signs, g) = scene
    C, nv = anc.shape
    tsw.check_groups(g, C, torch.device("cpu"), name, bins=(len(signs), K))
    assert tsw.MAX_LINKS == tsw.MAX_DOFS == 64 and g.link_bits.dtype == torch.int64
    assert C <= 1024 and nv <= 64 and len(g.link_bits) <= 64 and K <= 8 and len(signs) <= 2
    if name in CRAFT and CRAFT[name][3] == 0:
        assert (C, K, len(signs), nv) == (CRAFT[name][0], 0, 0, CRAFT[name][2])
        assert tuple(g.obj_ptr.shape) == (1,) and g.obj_slots.numel() == 0
    elif name in CRAFT:  # the balance bot's ball: its ground slot, 80 robot-ball slots;
        # the cubes' table and pair points, 30 spheres on each; the drawer's
        # points on the walls and 30 spheres on it
        assert (C, K, len(signs), nv) == (CRAFT[name][0], CRAFT[name][3], 2, CRAFT[name][2])
        assert [len(b) for b in _lists(g.obj_ptr, g.obj_slots)] == BINS[name]
    else:
        assert K >= 1
    if name in ARM_SLOTS:
        assert C == ARM_SLOTS[name]


def test_past_64_dofs_refused():
    """A 65th dof has no bit in a 64-bit mask: `build_slot_maps` refuses a
    robot of 65 dofs, naming the kernels' limit, and `check_groups` refuses
    65 distinct masks (and int32 masks); 64 dofs build, dof 63's bit set."""
    from handarm_tpu_torch.physics.contacts import ContactSlots
    from handarm_tpu_torch.physics.solver import build_slot_maps

    def maps(nv):
        # a chain: slot c on body c, whose ancestors are dofs 0..c
        slots = ContactSlots(robot_body=np.arange(nv), obj_a=np.full(nv, -1),
                             obj_b=np.full(nv, -1), friction=np.ones(nv, np.float32),
                             num_slots=nv, queries=None)
        return build_slot_maps(slots, np.tril(np.ones((nv, nv), np.float32)), 0)

    with pytest.raises(ValueError, match="at most 64"):
        maps(65)
    m = maps(64)
    assert m.groups.link_bits.dtype == torch.int64 and len(m.groups.link_bits) == 64
    assert int(m.anc_bits[63]) == -1  # all 64 bits set: every dof an ancestor of the last
    assert sorted(m.groups.link_bits.numpy().view(np.uint64).tolist()) == [
        (1 << (c + 1)) - 1 for c in range(64)]  # ordered as unsigned: the full mask last
    g = m.groups
    tsw.check_groups(g, 64, torch.device("cpu"), "64 dofs", bins=(0, 0))
    over = g._replace(link_bits=torch.arange(1, 66, dtype=torch.int64),
                      slot_link=torch.zeros(65, dtype=torch.int32))
    with pytest.raises(ValueError, match="65 distinct dof masks"):
        tsw.check_groups(over, 65, torch.device("cpu"), "65 masks")
    with pytest.raises(ValueError, match="int64"):
        tsw.check_groups(g._replace(link_bits=g.link_bits.int()), 64, torch.device("cpu"),
                         "int32 masks")
