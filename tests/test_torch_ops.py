"""The two kernels' plain versions against the JAX package's Pallas kernels
(run in interpret mode on the CPU) and its CPU fallbacks.

On the CPU the port's wrappers take their plain versions; the CUDA kernels
themselves are held against those plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handarm_tpu.ops.contact_sweep import fused_jacobi_sweeps
from handarm_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from handarm_tpu.physics import engine as je
from handarm_tpu.physics import solver as jsv
from handarm_tpu_torch.ops import contact_sweep as tsw
from handarm_tpu_torch.ops import spd_inverse as tspd
from tests.test_pallas_ops import spd_batch
from tests.test_torch_physics import build_scenes

torch.set_num_threads(1)


@pytest.mark.parametrize("force_pallas,B,n,seed", [(True, 128, 17, 0), (False, 64, 9, 3)],
                         ids=["pallas-interpret", "jnp-fallback"])
def test_spd_inverse_matches(force_pallas, B, n, seed):
    """Plain version vs the Pallas kernel (+ W^T W) and vs the jnp fallback,
    at the bounds of tests/test_pallas_ops.py (atol 1e-5)."""
    M = spd_batch(B, n, seed=seed)
    want = np.asarray(j_spd_inverse(M, force_pallas=force_pallas))
    got = tspd.spd_inverse(torch.tensor(np.asarray(M))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_spd_inverse_standin_conditioning():
    """The stand-in's PD-augmented mass matrices (arm inertia O(1) against
    finger armature O(1e-3)): Minv Mtilde = I within 5e-3, and the plain
    version within 1e-4 (relative to the largest entry) of the Pallas kernel."""
    from handarm_tpu_torch.physics import kinematics as tk
    from handarm_tpu_torch.physics.dynamics import compute_dyn
    from handarm_tpu_torch.robots.ur5sih import RESET_JOINT_CONFIG, load_ur5sih
    from handarm_tpu_torch.robots.ur5sih import DEFAULT_DERIV_GAIN, DEFAULT_PROP_GAIN

    m = tk.model_arrays(load_ur5sih())
    rng = np.random.default_rng(5)
    q = torch.tensor(np.asarray(RESET_JOINT_CONFIG) + 0.3 * rng.standard_normal((16, 17)),
                     dtype=torch.float32)
    fk = tk.forward_kinematics(m, q, torch.tensor([[1.0, 0, 0, 0]]), torch.tensor([[0, 0, 0.5]]))
    dyn = compute_dyn(m, fk, torch.zeros(16, 17), torch.zeros(3),
                      torch.tensor(DEFAULT_PROP_GAIN), torch.tensor(DEFAULT_DERIV_GAIN), 1 / 120)
    ident = torch.bmm(dyn.Minv, dyn.Mtilde)
    np.testing.assert_allclose(ident.numpy(), np.broadcast_to(np.eye(17), (16, 17, 17)), atol=5e-3)
    want = np.asarray(j_spd_inverse(jnp.asarray(dyn.Mtilde.numpy()), force_pallas=True))
    np.testing.assert_allclose(dyn.Minv.numpy(), want, atol=1e-4 * np.abs(want).max())


def _sweep_inputs(tmp_path):
    """The anchored-solve inputs of one sim step of the contact-rich scene,
    packed by the JAX package, plus the port's slot couplings."""
    js, ts, state = build_scenes(tmp_path)
    heavy = je.compute_heavy(js, state)
    (planes, screws, minv2, _, anc, _, active, _), signs = jsv.anchored_pack(heavy.prep)
    rng = np.random.default_rng(7)
    B, C = active.shape
    # warm impulses in basis components, cone-clipped as solve_anchored does
    ln = np.abs(rng.standard_normal((B, C))) * 0.02
    lt = rng.standard_normal((2, B, C)) * 0.02
    mu = np.asarray(planes[12])
    fmag = np.sqrt((lt ** 2).sum(0))
    sc = np.where(fmag > mu * ln, mu * ln / np.maximum(fmag, 1e-9), 1.0)
    lam0 = 0.9 * np.asarray(active) * np.stack([ln, lt[0] * sc, lt[1] * sc])
    o = state.objects
    obj = np.concatenate([np.moveaxis(np.asarray(o.linvel), -1, 0),
                          np.moveaxis(np.asarray(o.angvel), -1, 0)])
    depth = np.asarray(heavy.contacts0.depth)
    bias = np.where(depth >= 0, np.minimum(0.3 * 120 * np.maximum(depth - 0.001, 0), 0.5),
                    depth * 120)
    f32 = lambda x: np.asarray(x, np.float32)
    arrays = dict(planes=f32(planes), bias=f32(bias), screws=f32(screws),
                  qd=f32(state.robot.qd), minv2=f32(minv2), obj=f32(obj), lam0=f32(lam0))
    return arrays, f32(anc), tuple(signs), ts.maps


def test_contact_sweep_matches_pallas(tmp_path):
    """The plain sweep (warm apply + 8 sweeps) vs the Pallas kernel in
    interpret mode on identical packed inputs, robot, object-table and
    object-object slots active. Bounds of tests/test_contact_sweep.py:
    2e-4 on qd, 2e-3 on object velocities and impulses."""
    a, anc, signs, maps = _sweep_inputs(tmp_path)
    onehots = [((maps.obj_idx[s].numpy()[:, None] == np.arange(3)[None]).astype(np.float32),)
               for s in range(len(signs))]
    side_onehots = [(jnp.asarray(oh[0]), jnp.asarray(oh[0].T)) for oh in onehots]
    j = {k: jnp.asarray(v) for k, v in a.items()}
    fold = np.zeros((1, 1), np.float32)
    fold[0, 0] = 1.0
    want = fused_jacobi_sweeps(
        planes=j["planes"], bias=j["bias"], screws=j["screws"], qd=j["qd"],
        minv2=j["minv2"], obj=j["obj"], lam0=j["lam0"], ancT=jnp.asarray(anc.T),
        anc=jnp.asarray(anc), fold=jnp.asarray(fold), side_onehots=side_onehots,
        signs=signs, iterations=8, omega=1.0, interpret=True, apply_warm=True)
    t = {k: torch.tensor(v) for k, v in a.items()}
    got = tsw.contact_sweep(t["planes"], t["bias"], t["screws"], t["qd"], t["minv2"],
                            t["obj"], t["lam0"], torch.tensor(anc), maps.groups,
                            maps.obj_idx, signs, 8, 1.0, apply_warm=True)
    for name, g, w, tol in zip(("qd", "obj", "lam"), got, want, (2e-4, 2e-3, 2e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=name)
    assert np.abs(np.asarray(want[2])).max() > 1e-3  # impulses flowed
    assert tsw.launches == 0 and tspd.launches == 0  # CPU tensors: no kernel



def test_solve_anchored_matches_jax(tmp_path):
    """One anchored solve end to end through each package's own solver:
    prep, pack, the warm impulses' cone clip and the sweeps (the JAX
    package's `solve_anchored`, Pallas in interpret mode) on the same state
    and warm impulses. f32 prep; bounds of tests/test_contact_sweep.py."""
    from handarm_tpu_torch.physics import engine as te
    from handarm_tpu_torch.physics import solver as tsv
    from tests.test_torch_physics import to_port

    js, ts, state = build_scenes(tmp_path)
    jh = je.compute_heavy(js, state)
    th = te.compute_heavy(ts, to_port(state))
    arrays, signs = jsv.anchored_pack(jh.prep)
    tpack = tsv.anchored_pack(th.prep)
    rng = np.random.default_rng(11)
    B, C = np.asarray(jh.contacts0.depth).shape
    warm = [0.02 * rng.standard_normal((B, C)).astype(np.float32) for _ in range(3)]
    bias = 0.1 * np.abs(rng.standard_normal((B, C))).astype(np.float32)
    o = state.objects
    want = jsv.solve_anchored(arrays, signs, jnp.asarray(bias), state.robot.qd, o.linvel,
                              o.angvel, tuple(jnp.asarray(w) for w in warm), js.params.solver)
    T = lambda x: torch.tensor(np.asarray(x))
    got = tsv.solve_anchored(tpack, ts.maps, T(bias), T(state.robot.qd), T(o.linvel),
                             T(o.angvel), tuple(T(w) for w in warm), ts.params.solver)
    for name, g, w, tol in (("qd", got[0], want[0], 2e-4), ("lv", got[1], want[1], 2e-3),
                            ("av", got[2], want[2], 2e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=name)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, err_msg="lam")
