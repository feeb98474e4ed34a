"""One sdf_gather pass per contact generation: the multi-object plain
sampler against the JAX package's per-object reference and the port's
per-object plain sampler, the static query table against the slots the
per-object loops visited, and the batched `generate_contacts` against a
copy of those loops, bit for bit on the CPU. The three YCB records come
from the tracked `.sdf_cache`; the CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handarm_tpu.physics import shapes as jsh
from handarm_tpu.physics.sdf import sample_sdf_channels
from handarm_tpu_torch.envs import objects as tobj
from handarm_tpu_torch.math.quat import quat_rotate, quat_rotate_inv
from handarm_tpu_torch.ops import sdf_gather as tsdf
from handarm_tpu_torch.physics import contacts as tc
from handarm_tpu_torch.physics import shapes as tsh
from handarm_tpu_torch.physics.sdf import sample_sdf_plain

torch.set_num_threads(1)
NAMES = sorted(tobj.RECORD_KEYS)


@pytest.fixture(scope="module")
def records():
    return [tobj.load_object(n) for n in NAMES]


def _mixed_points(records, obj, B, seed):
    """[B, L, 3] body-frame points, query j near object obj[j]: inside the
    mesh, on its surface samples, or up to 5 voxels off the grid."""
    rng = np.random.default_rng(seed)
    p = np.zeros((B, len(obj), 3))
    for j, k in enumerate(obj):
        rec = records[k]
        R, lo, sp = rec["sdf_grid"].shape[0], np.asarray(rec["sdf_lo"]), float(rec["sdf_spacing"])
        kind = j % 3
        if kind == 0:
            p[:, j] = rng.normal(scale=0.3 * np.asarray(rec["size"]), size=(B, 3))
        elif kind == 1:
            p[:, j] = np.asarray(rec["points"])[rng.integers(0, len(rec["points"]), B)]
        else:
            p[:, j] = lo + sp * rng.uniform(-5.0, R + 4.0, size=(B, 3))
    return p.astype(np.float32)


def test_multi_object_plain_matches_jax_and_per_object(records):
    """A row of 61 queries over the three records in a mixed order (8 rows):
    every query equals the JAX package's `sample_sdf_channels` + out-of-grid
    excess on its own object within the 1e-5 of
    tests/test_torch_sdf_deff.py (the same f32 gather), and the port's
    per-object plain sampler exactly."""
    shapes = tsh.stack_objects(records)
    rng = np.random.default_rng(3)
    obj = rng.integers(0, 3, 61)
    q = tsh.sdf_queries(shapes, obj)
    p = torch.as_tensor(_mixed_points(records, obj, 8, seed=4))
    got = tsdf.sdf_sample(shapes.sdf_field, shapes.sdf_lo, shapes.sdf_spacing, p, q.table)
    assert got.shape == (8, 61, 4)
    off_grid = 0
    for k in range(3):
        j = np.flatnonzero(obj == k)
        f, lo, sp = shapes.sdf_field[k], shapes.sdf_lo[k], shapes.sdf_spacing[k]
        assert torch.equal(got[:, j], sample_sdf_plain(f, lo, sp, p[:, j]))
        pk = jnp.asarray(p[:, j].numpy())
        R = f.shape[0]
        u = (pk - lo.numpy()) / sp.item()
        excess = jnp.linalg.norm(jnp.maximum(jnp.abs(u - (R - 1) / 2) - (R - 1) / 2, 0.0), axis=-1)
        want = sample_sdf_channels(jnp.asarray(f.numpy()), lo.numpy(), sp.item(), pk)
        want = np.asarray(want.at[..., 0].add(excess * sp.item()))
        np.testing.assert_allclose(got[:, j].numpy(), want, atol=1e-5)
        off_grid += int((np.asarray(excess) > 0).sum())
    assert off_grid > 0
    assert got[..., 0].max() > 0.01 and got[..., 0].min() < 0.0  # outside and inside


def test_plain_leaves_unnamed_positions_zero(records):
    """Positions the table does not name hold 0 (the contract the kernel
    keeps for rows that mix mesh and analytic objects)."""
    shapes = tsh.stack_objects(records)
    table = torch.tensor([[3, 1], [0, 2]], dtype=torch.int32)
    p = torch.as_tensor(_mixed_points(records, [2, 0, 0, 1, 0], 2, seed=5))
    got = tsdf.sdf_sample(shapes.sdf_field, shapes.sdf_lo, shapes.sdf_spacing, p, table)
    assert torch.all(got[:, [1, 2, 4]] == 0.0)
    assert torch.all(got[:, [0, 3], 1:].abs().sum(-1) > 0)


def _scene(objs, S, seed):
    """Shapes, random robot spheres on 5 bodies, and their contact slots."""
    rng = np.random.default_rng(seed)
    shapes = tsh.stack_objects(objs)
    spheres = tc.RobotSpheres(
        body=rng.integers(0, 5, S).astype(np.int32),
        offset=torch.as_tensor(0.03 * rng.standard_normal((S, 3)), dtype=torch.float32),
        radius=torch.as_tensor(rng.uniform(0.005, 0.02, S), dtype=torch.float32),
        friction=np.ones(S, np.float32))
    return shapes, spheres, tc.make_contact_slots(shapes, spheres)


def _objects(records, kinds):
    out = []
    for i, kind in enumerate(kinds):
        if kind == "box":
            out.append(tsh.make_box_object([0.03, 0.04, 0.05], mass=0.2))
        elif kind == "sphere":
            out.append(tsh.make_sphere_object(0.035, mass=0.1))
        else:
            out.append(records[i % len(records)])
    return out


SCENES = {"three-meshes": ("mesh", "mesh", "mesh"), "one-box": ("box",),
          "mixed": ("box", "mesh", "sphere", "mesh")}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_query_table_covers_old_loops(records, name):
    """The static table visits each (sphere, object) and each (object-pair
    point, object) query of the per-object loops once, at its slot; the
    kernel's table names each mesh query once, grouped by object."""
    kinds = SCENES[name]
    shapes, spheres, slots = _scene(_objects(records, kinds), 33, seed=0)
    K, S, Q = len(kinds), 33, slots.queries.pair_points
    old = [(s, k) for s in range(S) for k in range(K)]
    old += [(S + ka * Q + q, kb) for ka in range(K) for kb in range(K) if ka != kb
            for q in range(Q)]
    qr = slots.queries
    assert list(zip(qr.src.tolist(), qr.sdf.obj.tolist())) == old
    # the query block sits after the object-vs-table and sphere-vs-table slots
    start = K * shapes.points_per_object + S
    assert np.array_equal(slots.obj_b[start:start + len(old)], [k for _, k in old])
    mesh = [j for j, (_, k) in enumerate(old) if kinds[k] == "mesh"]
    if not mesh:
        assert qr.sdf.table is None
        return
    table = qr.sdf.table.numpy()
    assert sorted(table[:, 0].tolist()) == mesh
    assert all(old[j][1] == k for j, k in table)
    assert np.all(np.diff(table[:, 1]) >= 0)  # grouped by object


def _old_object_sdf(shapes, k, p_body):
    """The per-object SDF of the loops (the plain path on the CPU)."""
    kind = int(shapes.kind[k])
    if kind == tsh.BOX:
        return tsh.sdf_box(p_body, shapes.size[k])
    if kind == tsh.SPHERE:
        return tsh.sdf_sphere(p_body, shapes.size[k, 0])
    out = sample_sdf_plain(shapes.sdf_field[k], shapes.sdf_lo[k], shapes.sdf_spacing[k],
                           p_body.reshape(-1, 3)).reshape(p_body.shape[:-1] + (4,))
    g = out[..., 1:4]
    return out[..., 0], g * torch.rsqrt(torch.sum(g * g, dim=-1, keepdim=True) + 1e-18)


def _old_object_blocks(shapes, spheres, obj_pos, obj_quat, centers, pts_w, Q):
    """Spheres vs objects [S*K] and object-pair points, one object at a time."""
    B, K, _ = obj_pos.shape
    S = spheres.body.shape[0]
    big = torch.full((), 1e6)
    normals, poss, depths = [], [], []
    per_n, per_d, per_p = [], [], []
    for k in range(K):
        qk = obj_quat[:, k:k + 1, :].expand(B, S, 4)
        c_body = quat_rotate_inv(qk, centers - obj_pos[:, k:k + 1, :])
        d_k, g_k = _old_object_sdf(shapes, k, c_body)
        n_w = quat_rotate(qk, g_k)
        per_n.append(n_w)
        per_d.append(spheres.radius[None] - d_k)
        per_p.append(centers - n_w * d_k[..., None])
    normals.append(torch.stack(per_n, 2).reshape(B, S * K, 3))
    depths.append(torch.stack(per_d, 2).reshape(B, S * K))
    poss.append(torch.stack(per_p, 2).reshape(B, S * K, 3))
    for ka in range(K):
        for kb in range(K):
            if ka == kb:
                continue
            pts_a = pts_w[:, ka, :Q]
            qb = obj_quat[:, kb:kb + 1, :].expand(B, Q, 4)
            d_ab, g_ab = _old_object_sdf(
                shapes, kb, quat_rotate_inv(qb, pts_a - obj_pos[:, kb:kb + 1, :]))
            d_ab = torch.where(shapes.point_mask[ka, :Q][None] > 0, d_ab, big)
            normals.append(quat_rotate(qb, g_ab))
            poss.append(pts_a)
            depths.append(shapes.point_radius[ka, :Q][None] - d_ab)
    return torch.cat(normals, 1), torch.cat(poss, 1), torch.cat(depths, 1)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_batched_contacts_match_old_loops(records, name):
    """generate_contacts (one objects_sdf pass) against the per-object loops
    on 6 envs of random poses: the object-SDF slots' normals, positions and
    depths are bit-identical, so the slot order is unchanged."""
    kinds = SCENES[name]
    K, S, B = len(kinds), 33, 6
    shapes, spheres, slots = _scene(_objects(records, kinds), S, seed=1)
    rng = np.random.default_rng(2)
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    # objects near each other and the hand, so contacts of every kind are near
    obj_pos = f(np.array([0.0, 0.0, 0.55]) + 0.05 * rng.standard_normal((B, K, 3)))
    qn = lambda q: q / np.linalg.norm(q, axis=-1, keepdims=True)
    obj_quat = f(qn(rng.standard_normal((B, K, 4))))
    body_pos = f(np.array([0.0, 0.0, 0.58]) + 0.05 * rng.standard_normal((B, 5, 3)))
    body_quat = f(qn(rng.standard_normal((B, 5, 4))))
    geom = tc.StaticGeom(table_lo=f([-0.5, -0.5]), table_hi=f([0.5, 0.5]), table_height=0.5,
                         wall_lo=np.zeros((0, 3)), wall_hi=np.zeros((0, 3)))
    con = tc.generate_contacts(slots, shapes, spheres, geom, obj_pos, obj_quat,
                               body_quat, body_pos)
    P = shapes.points_per_object
    pts_w = obj_pos[:, :, None, :] + quat_rotate(
        obj_quat[:, :, None, :].expand(B, K, P, 4), shapes.points[None].expand(B, K, P, 3))
    sb = torch.as_tensor(spheres.body)
    centers = body_pos[:, sb] + quat_rotate(body_quat[:, sb], spheres.offset[None].expand(B, S, 3))
    n, p, d = _old_object_blocks(shapes, spheres, obj_pos, obj_quat, centers, pts_w,
                                 slots.queries.pair_points)
    start = K * P + S
    block = slice(start, start + n.shape[1])
    assert n.shape[1] == slots.queries.src.shape[0]
    assert torch.equal(con.normal[:, block], n)
    assert torch.equal(con.pos[:, block], p)
    assert torch.equal(con.depth[:, block], d)
    assert con.normal.shape == (B, slots.num_slots, 3)
    assert bool((d[d < 1e5] > -0.05).any())  # some query is near its object
