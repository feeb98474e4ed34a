"""The mesh-SDF sampler and the robot effective mass (the plain versions of
the port's sdf_gather and prep_deff kernels) against the JAX package: its
jnp reference (`sample_sdf_channels` + excess, the chunked XLA prep), its
Pallas kernels in interpret mode, and its `stack_objects` / `_prepare`.
The three YCB records of Ur5SihMultiObjectManipulation come from the
tracked `.sdf_cache`; the CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handarm_tpu.envs import objects as jobj
from handarm_tpu.ops.prep_deff import robot_deff as j_robot_deff
from handarm_tpu.ops.sdf_gather import sdf_sample_pallas
from handarm_tpu.physics import engine as je
from handarm_tpu.physics import shapes as jsh
from handarm_tpu.physics.sdf import sample_sdf_channels
from handarm_tpu_torch.envs import objects as tobj
from handarm_tpu_torch.ops import prep_deff as tdeff
from handarm_tpu_torch.ops import sdf_gather as tsdf
from handarm_tpu_torch.physics import engine as te
from handarm_tpu_torch.physics import shapes as tsh
from handarm_tpu_torch.physics import solver as tsv
from tests.test_prep_deff import _reference as dense_deff
from tests.test_torch_physics import build_scenes, to_port

torch.set_num_threads(1)
NAMES = sorted(tobj.RECORD_KEYS)


@pytest.fixture(scope="module")
def records():
    return [tobj.load_object(n) for n in NAMES]


def test_record_keys_follow_jax_key_scheme():
    """RECORD_KEYS are the JAX package's cache keys under its default object
    root (sha1 of '<root>/<set>/<name>.urdf:32:64:v4')."""
    for name in NAMES:
        set_name, obj = name.split("/")
        path = f"{jobj.OBJECT_SET_ROOT}/{set_name}/{obj}.urdf"
        key = hashlib.sha1(f"{path}:32:64:v4".encode()).hexdigest()[:16]
        assert tobj.RECORD_KEYS[name] == key, name


def test_loader_is_read_only_and_raises_on_unknown(records):
    assert [r["sdf_grid"].shape for r in records] == [(32, 32, 32)] * 3
    with pytest.raises(KeyError, match="no baked record"):
        tobj.resolve_object_set((("ycb", ("002_master_chef_can",)),))
    assert tobj.resolve_object_set((("ycb", ("015_peach", "015_peach")),)) == ["ycb/015_peach"]


def _query_points(rec, n, seed):
    """Points inside the mesh, on its surface samples and outside the grid
    (up to 5 voxels beyond every face)."""
    rng = np.random.default_rng(seed)
    R, lo, sp = rec["sdf_grid"].shape[0], np.asarray(rec["sdf_lo"]), float(rec["sdf_spacing"])
    inside = rng.normal(scale=0.3 * np.asarray(rec["size"]), size=(n, 3))
    surface = np.asarray(rec["points"])[rng.integers(0, len(rec["points"]), n)]
    wide = lo + sp * rng.uniform(-5.0, R + 4.0, size=(n, 3))
    return np.concatenate([inside, surface, wide]).astype(np.float32)


@pytest.mark.parametrize("k", range(3), ids=NAMES)
def test_sdf_plain_matches_jax(records, k):
    """The plain sampler of the port against `sample_sdf_channels` + the
    out-of-grid excess (the same f32 gather: 1e-5) on each real record, 3 x
    257 points (not a multiple of the Pallas tile or of the CUDA block);
    and the distance channel against the Pallas kernel in interpret mode at
    the JAX package's bound for it (1e-3). The unit gradient channels of a
    real record are 10x the scale of the field that bounds the Pallas
    kernel's gradients in tests/test_pallas_ops.py, and its bf16 weights
    put them up to ~2.5e-3 off the f32 sample here: they are held against
    Pallas on that file's own field (next test)."""
    shapes = jsh.stack_objects(records)
    R = shapes.sdf_field.shape[1]
    p = _query_points(records[k], 257, seed=k)
    field, lo, sp = shapes.sdf_field[k], shapes.sdf_lo[k], shapes.sdf_spacing[k]
    want = _jax_sample_with_excess(field, lo, sp, p)
    t = lambda x: torch.tensor(np.asarray(x))
    got = _sample_one(t(field), t(lo), t(sp), torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[:, 0].max() > 0.01 and got[:, 0].min() < 0.0  # outside and inside
    pal = np.asarray(sdf_sample_pallas(shapes.sdf_table_hi[k], shapes.sdf_table_lo[k], lo, sp,
                                       jnp.asarray(p), R=R, interpret=True))
    np.testing.assert_allclose(got[:, 0], pal[:, 0], atol=1e-3)


def _sample_one(field, lo, sp, p):
    """The port's sampler (the plain version on the CPU) on one object's
    field: a row of N queries, all of object 0."""
    table = torch.stack([torch.arange(p.shape[0], dtype=torch.int32),
                         torch.zeros(p.shape[0], dtype=torch.int32)], 1)
    return tsdf.sdf_sample(field[None], lo[None], sp.reshape(1), p[None], table)[0]


def _jax_sample_with_excess(field, lo, sp, p):
    R = field.shape[0]
    want = sample_sdf_channels(jnp.asarray(field), lo, sp, jnp.asarray(p))
    u = (jnp.asarray(p) - lo) / sp
    excess = jnp.linalg.norm(jnp.maximum(jnp.abs(u - (R - 1) / 2) - (R - 1) / 2, 0.0), axis=-1)
    return np.asarray(want.at[..., 0].add(excess * sp))


def test_sdf_plain_matches_pallas_on_its_test_field():
    """The inputs of tests/test_pallas_ops.py::test_sdf_gather_matches_reference
    (a 0.1-scale random 4-channel field, 7 x 513 points in and out of the
    grid): the port's plain sampler against the Pallas kernel in interpret
    mode at that test's bounds, 2e-3 on every channel and 1e-3 on the
    distance, and against the f32 reference at 1e-5."""
    from handarm_tpu.ops.sdf_gather import pack_sdf_tables

    rng = np.random.default_rng(0)
    R = 32
    field = (0.1 * rng.normal(size=(R, R, R, 4))).astype(np.float32)
    lo, spacing = jnp.asarray([-0.06, -0.05, -0.04]), jnp.float32(0.004)
    hi, lo_t = pack_sdf_tables(field)
    p = np.asarray(rng.uniform(-0.09, 0.09, size=(7, 513, 3)), np.float32).reshape(-1, 3)
    pal = np.asarray(sdf_sample_pallas(jnp.asarray(hi), jnp.asarray(lo_t), lo, spacing,
                                       jnp.asarray(p), R=R, interpret=True))
    got = _sample_one(torch.as_tensor(field), torch.tensor(np.asarray(lo, np.float32)),
                      torch.tensor(0.004, dtype=torch.float32), torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, pal, atol=2e-3)
    np.testing.assert_allclose(got[:, 0], pal[:, 0], atol=1e-3)
    np.testing.assert_allclose(got, _jax_sample_with_excess(field, lo, spacing, p), atol=1e-5)


def test_stack_objects_and_object_sdf_match(records):
    """stack_objects of the three records gives the JAX package's fields,
    grid corners, spacings, OBB poses and point sets; the port's
    objects_sdf (sample + gradient normalization) on a row of queries of one
    object agrees with its object_sdf within 1e-5."""
    js = jsh.stack_objects(records)
    ts = tsh.stack_objects(records)
    for name in ("sdf_field", "sdf_lo", "sdf_spacing", "obb_pos", "obb_quat", "size",
                 "points", "point_mask", "point_radius", "bound_radius", "mass",
                 "inertia_diag", "friction"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(ts.kind, js.kind)
    for k in range(3):
        p = _query_points(records[k], 64, seed=10 + k)
        dj, gj = jsh.object_sdf(js, k, jnp.asarray(p))
        dt, gt = tsh.objects_sdf(ts, tsh.sdf_queries(ts, [k] * len(p)), torch.as_tensor(p)[None])
        np.testing.assert_allclose(dt[0].numpy(), np.asarray(dj), atol=1e-5)
        np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj), atol=1e-5)


def _deff_inputs(B, C, nv, seed):
    rng = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, np.float32)
    screws = f(rng.standard_normal((6, B, nv)))
    pos = f(rng.standard_normal((3, B, C)))
    basis = f(rng.standard_normal((9, B, C)))
    anc = f(rng.uniform(size=(C, nv)) > 0.4)
    anc[: C // 4] = 0.0  # slots without a robot body
    A = rng.standard_normal((B, nv, nv))
    minv2 = f((A @ A.transpose(0, 2, 1) + 3.0 * np.eye(nv)).reshape(B, nv * nv))
    return screws, pos, basis, anc, minv2


@pytest.mark.parametrize("B,C,nv,seed", [(8, 40, 9, 0), (4, 372, 17, 1)],
                         ids=["tests-size", "multiobj-width"])
def test_deff_plain_matches_jax(B, C, nv, seed):
    """The plain deff against `robot_deff(interpret=True)` and against the
    dense formula of tests/test_prep_deff.py, at that file's bounds
    (rtol/atol 2e-4, float32 sums in other orders)."""
    screws, pos, basis, anc, minv2 = _deff_inputs(B, C, nv, seed)
    bits = (anc > 0).astype(np.int64) @ (1 << np.arange(nv))
    groups = tsv.build_slot_groups(bits, np.zeros((0, C), np.int64), 0)
    t = torch.as_tensor
    got = tdeff.robot_deff(t(screws), t(pos), t(basis), t(anc), groups, t(minv2)).numpy()
    want = np.asarray(j_robot_deff(*map(jnp.asarray, (screws, pos, basis, anc, minv2)),
                                   interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    dense = np.asarray(dense_deff(*map(jnp.asarray, (screws, pos, basis, anc, minv2))))
    np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-4)
    assert np.all(got[:, :, : C // 4] == 0.0)


@pytest.mark.parametrize("impl", ["pallas", "soa"])
def test_prepare_deff_paths_match_jax(tmp_path, impl):
    """`prepare` with jacobi_impl="pallas" (the deff path; the plain version
    on the CPU) and "soa" (the chunked chain) against the JAX `_prepare`
    with the same setting, on the contact-rich scene of
    tests/test_torch_physics.py: the effective masses within 2e-4."""
    js, ts, state = build_scenes(tmp_path)
    js = js._replace(params=js.params._replace(
        solver=js.params.solver._replace(jacobi_impl=impl)))
    ts = dataclasses.replace(ts, params=ts.params._replace(
        solver=ts.params.solver._replace(jacobi_impl=impl)))
    assert tsv.use_deff_kernel(ts.params.solver, 8, ts.slots.num_slots, "cpu") == (impl == "pallas")
    want = je.compute_heavy(js, state).prep
    got = te.compute_heavy(ts, to_port(state)).prep
    d_want = np.asarray(want.inv_d)
    np.testing.assert_allclose(got.inv_d.numpy(), d_want, rtol=2e-4, atol=2e-4)
    robot = ts.slots.robot_body >= 0
    assert np.abs(d_want[:, robot]).max() > 0  # the robot slots are active


def test_deff_gate():
    """"soa" takes the kernel only on the card at B * C >= 2^21 (the
    multi-object scene at 8192 envs, not the lift); "pallas" always; the
    other `jacobi_impl` values ("aos", "pallas_off") and Gauss-Seidel
    never, as the JAX package's `_prepare` rules."""
    soa, pallas = tsv.SolverParams(), tsv.SolverParams(jacobi_impl="pallas")
    assert tsv.use_deff_kernel(soa, 8192, 372, "cuda")
    assert not tsv.use_deff_kernel(soa, 8192, 127, "cuda")
    assert not tsv.use_deff_kernel(soa, 8192, 372, "cpu")
    assert tsv.use_deff_kernel(pallas, 4, 10, "cpu")
    for other in (tsv.SolverParams(jacobi_impl="aos"), tsv.SolverParams(jacobi_impl="pallas_off"),
                  tsv.SolverParams(jacobi_impl="pallas", mode="gs"), soa._replace(mode="gs")):
        assert not tsv.use_deff_kernel(other, 8192, 372, "cuda")
