"""DeXtreme (AllegroHandDextremeADR, AllegroHandADR, AllegroHandManualDR):
the random network adversary and the ADR wrapper of AllegroHand, the port
against the JAX package on the CPU, on the in-repo Allegro stand-in (the
JAX package's `handarm_tpu.envs.dexhand.ALLEGRO_URDF` monkeypatched to
it). The wrapper envs are built once for the module at B = 16; the JAX
wrapper's inner AllegroHand steps and resets jitted, the wrapper's own
operations op by op.

- `rna_masks` and `rna_apply` against the JAX functions at B = 64, with the
  JAX env's RNAParams carried across (`convert.rna_params_from_arrays`)
  and the masks' uniforms re-derived from its key: the masks exactly; the
  binned logits within 1e-5 of their largest magnitude; the decoded
  actions exactly wherever a channel's two largest logits lie more than
  1e-4 of that magnitude apart (the near-ties are counted and printed
  with -s; a tie within float32 round-off may pick either bin).
- Three wrapper steps from a converted JAX state, with the JAX package's
  draws (the inner env's, ADR's, the masks' uniforms and both noises,
  re-derived from the keys), the ranges opened to hi = (0.05, 0.05, 0.2)
  with values drawn in them (so the noise and the adversary act), the
  queues one sample short of full (means 0.5 on the low sides and the
  mixing weight's high side, 4 on the noises' high sides), envs 0-5
  boundary workers of the six modes timing out at the first step with 0
  or 4 goals (so `adr_step` widens both noises' ranges by their delta,
  narrows alpha's by its delta and clears the queues, and the six envs'
  masks refresh), env 6's cube dropped out of the hand: observations and
  rewards within 2e-3 times max(1, the largest value); done flags, the
  ADR modes and the masks exactly; lo, hi, the queues and values within
  1e-6; the inner state as tests/test_torch_dexhand.py holds it. The
  adversary's near-ties in these steps are counted (2 of 768 channels,
  printed with -s); at them too both packages decode the same bin.
- AllegroHandManualDR's fixed ranges: the config equals the JAX package's,
  its ranges start at hi = (0.04, 0.04, 0.25), and full queues move
  nothing (zero deltas).
- One PPO update of the DeXtreme learner (the composed LSTM-before-MLP
  config, its carry kept across episode ends, narrowed to hidden 32-32 and
  LSTM 16) against the JAX learner, on tables of the env's widths (88
  observations, 16 actions), with tests/test_torch_rnn.py's harness.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_rnn as trnn
from handarm_tpu.envs import adr as jadr
from handarm_tpu.envs import dexhand as jdex
from handarm_tpu.envs import dextreme as jdx
from handarm_tpu.learn import rna as jrna
from handarm_tpu_torch.convert import (
    classic_state_from_leaves,
    classic_state_to_leaves,
    rna_params_from_arrays,
)
from handarm_tpu_torch.envs import adr as tadr
from handarm_tpu_torch.envs import dexhand as tdex
from handarm_tpu_torch.envs import dextreme as tdx
from handarm_tpu_torch.envs import registry as treg
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.learn import rna as trna
from test_torch_dexhand import _close, assert_state_close, fresh_draws, step_draws

torch.set_num_threads(1)
B = 16
NV = 16
P = 3
TIE = 1e-4  # a channel's two largest logits this close, relative: a near-tie
STEPS = 3
_t = lambda x: torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def dextreme():
    """(JAX wrapper env, port wrapper env) at B = 16."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdex, "ALLEGRO_URDF", tdex.ALLEGRO_URDF)
        jenv = jdx.make_allegro_dextreme(num_envs=B)
    jenv.env.step = jax.jit(jenv.env.step)
    jenv.env.reset = jax.jit(jenv.env.reset)
    tenv = tdx.make_allegro_dextreme(num_envs=B, device="cpu")
    tenv.rna_params = rna_params_from_arrays(jenv.rna_params)
    return jenv, tenv


def adr_draws(key, n: int = B) -> tadr.AdrDraws:
    """The draws `adr_step(..., key)` / `init_adr_state(..., key)` make at P = 3."""
    k_mode, k_vals = jax.random.split(key)
    k1, k2 = jax.random.split(k_mode)
    return tadr.AdrDraws(_t(jax.random.uniform(k1, (n,))),
                         _t(jax.random.randint(k2, (n,), 0, 2 * P)),
                         _t(jax.random.uniform(k_vals, (n, P))))


def mask_draws(key, H: int, n: int = B) -> trna.MaskDraws:
    k1, k2 = jax.random.split(key)
    return trna.MaskDraws(_t(jax.random.uniform(k1, (n, H))), _t(jax.random.uniform(k2, (n, H))))


def reset_draws(key, H: int) -> tdx.DextremeDraws:
    k_in, k_adr, k_rna, _ = jax.random.split(key, 4)
    return tdx.DextremeDraws(inner=fresh_draws(k_in, NV), adr=adr_draws(k_adr),
                             rna=mask_draws(k_rna, H), act=None, obs=None)


def wrapper_step_draws(js, H: int) -> tdx.DextremeDraws:
    _, k_act, k_obs, k_adr, k_rna = jax.random.split(js.key, 5)
    return tdx.DextremeDraws(inner=step_draws(js.inner.key, NV), adr=adr_draws(k_adr),
                             rna=mask_draws(k_rna, H),
                             act=_t(jax.random.normal(k_act, (B, NV))),
                             obs=_t(jax.random.normal(k_obs, (B, 88))))


def port_state(jstate) -> tdx.DextremeState:
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     tdx.DextremeState)


def jax_logits(p, state, obs):
    """The JAX rna_apply's logits (learn/rna.py), before its argmax."""
    x = jax.nn.relu((obs @ p.w1 + p.b1) * state.mask1)
    x = jax.nn.relu((x @ p.w2 + p.b2) * state.mask2)
    return (x @ p.w3).reshape(obs.shape[0], p.num_actions, p.bins)


def near_ties(logits: np.ndarray) -> np.ndarray:
    """[B, A] bool: the channel's two largest logits within TIE of the
    logits' largest magnitude."""
    top = np.sort(logits, axis=-1)
    return (top[..., -1] - top[..., -2]) <= TIE * np.abs(logits).max()


def check_rna(tp, ts_rna, t_obs, jp, js_rna, j_obs, tag: str) -> int:
    """Logits and decoded actions as the docstring holds them; returns the
    near-tie count."""
    got = trna.rna_logits(tp, ts_rna, t_obs).numpy()
    want = np.asarray(jax_logits(jp, js_rna, j_obs))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), err_msg=tag)
    ties = near_ties(want)
    ta_, ja_ = trna.rna_apply(tp, ts_rna, t_obs).numpy(), np.asarray(
        jrna.rna_apply(jp, js_rna, j_obs))
    np.testing.assert_array_equal(ta_[~ties], ja_[~ties], err_msg=tag)
    flips = int((ta_ != ja_).sum())
    print(f"{tag}: {int(ties.sum())} near-ties of {ties.size} channels, {flips} decoded apart")
    return int(ties.sum()), flips


# --- the adversary ------------------------------------------------------------------


def test_rna_matches(dextreme):
    jenv, tenv = dextreme
    jp, tp = jenv.rna_params, tenv.rna_params
    H = tp.b1.shape[0]
    assert (tp.num_actions, tp.bins, H) == (16, 32, 256) and tp.w1.shape == (88, 256)
    n = 64
    key = jax.random.PRNGKey(4)
    jm = jrna.rna_masks(key, n, jp)
    tm = trna.rna_masks(tp, n, draws=mask_draws(key, H, n))
    np.testing.assert_array_equal(tm.mask1.numpy(), np.asarray(jm.mask1))
    np.testing.assert_array_equal(tm.mask2.numpy(), np.asarray(jm.mask2))
    assert set(np.unique(tm.mask1.numpy())) == {0.0, 2.0}
    obs = np.random.default_rng(3).normal(0.0, 1.5, (n, 88)).astype(np.float32)
    check_rna(tp, tm, _t(obs), jp, jm, jnp.asarray(obs), "rna at B = 64")
    a = trna.rna_apply(tp, tm, _t(obs)).numpy()
    assert a.min() >= -1.0 and a.max() <= 1.0 and len(np.unique(a)) > 8
    # the port's own init: the JAX shapes and scales
    own = trna.rna_init(torch.Generator().manual_seed(0), 88, 16)
    for f in ("w1", "b1", "w2", "b2", "w3"):
        assert getattr(own, f).shape == getattr(tp, f).shape
    assert abs(float(own.w1.std()) * 88 ** 0.5 - 1.0) < 0.05


# --- the wrapper's steps -------------------------------------------------------------


def _forced(jenv, js):
    """Open ranges, nearly full queues, envs 0-5 boundary workers timing out,
    env 6's cube dropped (the docstring's setting)."""
    rng = np.random.default_rng(8)
    hi = np.array([0.05, 0.05, 0.2], np.float32)
    mode = np.asarray(js.adr.worker_mode).copy()
    mode[:6] = np.arange(6)
    values = (rng.uniform(size=(B, P)) * hi).astype(np.float32)
    q_cnt = np.full(2 * P, 63.0, np.float32)
    q_sum = (63.0 * np.array([0.5, 4.0, 0.5, 4.0, 0.5, 0.5])).astype(np.float32)
    adr = js.adr._replace(hi=jnp.asarray(hi), worker_mode=jnp.asarray(mode),
                          values=jnp.asarray(values), q_sum=jnp.asarray(q_sum),
                          q_cnt=jnp.asarray(q_cnt))
    inner = js.inner
    prog, succ = np.asarray(inner.progress).copy(), np.asarray(inner.successes).copy()
    prog[:6] = jenv.cfg.episode_length - 1
    succ[:6] = [0.0, 4.0, 0.0, 4.0, 0.0, 0.0]
    opos = np.asarray(inner.physics.objects.pos).copy()
    opos[6, 0, 2] -= 0.3
    phys = inner.physics
    inner = inner._replace(progress=jnp.asarray(prog), successes=jnp.asarray(succ),
                           physics=phys._replace(objects=phys.objects._replace(
                               pos=jnp.asarray(opos))))
    return js._replace(adr=adr, inner=inner)


def assert_adr_close(got: tadr.AdrState, want, tag: str):
    np.testing.assert_array_equal(got.worker_mode.numpy(), np.asarray(want.worker_mode),
                                  err_msg=tag)
    for f in ("lo", "hi", "values", "q_sum", "q_cnt"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f"{tag} {f}")


def test_wrapper_steps_match(dextreme):
    jenv, tenv = dextreme
    H = tenv.rna_params.b1.shape[0]
    key = jax.random.PRNGKey(5)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, reset_draws(key, H))
    _close(tobs, jobs, 1e-6, "reset obs")
    assert_state_close(ts.inner, js.inner)
    assert_adr_close(ts.adr, js.adr, "reset")
    np.testing.assert_array_equal(ts.rna.mask1.numpy(), np.asarray(js.rna.mask1))
    # the converted state writes back the JAX leaves
    back = classic_state_to_leaves(port_state(js))
    for a, b in zip(back[:-1], jax.tree.leaves(js)[:-1], strict=True):
        if a.dtype != np.uint32:
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))

    js = _forced(jenv, js)
    ts = port_state(js)
    hi0 = np.asarray(js.adr.hi)
    rng = np.random.default_rng(2)
    ties = flips = 0
    for i in range(STEPS):
        a = rng.uniform(-0.5, 0.5, (B, NV)).astype(np.float32)
        n_ties, n_flips = check_rna(tenv.rna_params, ts.rna, ts.obs, jenv.rna_params, js.rna,
                                    js.obs, f"step {i} adversary")
        ties, flips = ties + n_ties, flips + n_flips
        draws = wrapper_step_draws(js, H)
        masks_before = ts.rna.mask1.clone()
        js, jr = jenv.step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, 2e-3, f"obs {i}")
        _close(ts.obs, js.obs, 2e-3, f"state obs {i}")
        _close(tr.reward, jr.reward, 2e-3, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert_state_close(ts.inner, js.inner)
        assert_adr_close(ts.adr, js.adr, f"step {i}")
        np.testing.assert_array_equal(ts.rna.mask1.numpy(), np.asarray(js.rna.mask1))
        np.testing.assert_array_equal(ts.rna.mask2.numpy(), np.asarray(js.rna.mask2))
        assert set(tr.info) == set(jr.info)
        for k in ("adr_range_width", "rna_alpha_mean", "consecutive_successes"):
            np.testing.assert_allclose(float(tr.info[k]), float(jr.info[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        if i == 0:
            done = tr.done.numpy()
            assert done[:7].all(), done
            np.testing.assert_allclose(ts.adr.hi.numpy(), hi0 + [0.005, 0.005, -0.02],
                                       rtol=1e-6)
            np.testing.assert_array_equal(ts.adr.q_cnt.numpy(), 0.0)
            changed = (ts.rna.mask1 != masks_before).any(-1).numpy()
            assert changed[:7].all() and not changed[~done].any()
    print(f"the steps' adversary: {ties} near-ties of {STEPS * B * NV} channels, {flips} "
          "decoded apart")
    assert flips == 0  # else the steps below the tie would not compare


def test_manual_dr_fixed_ranges():
    cfg, _ = treg.resolve_task("AllegroHandManualDR", ["num_envs=8"])
    assert dataclasses.asdict(cfg.adr) == dataclasses.asdict(jdx.DEXTREME_MANUAL_DR)
    assert dataclasses.asdict(tdx.DEXTREME_ADR) == dataclasses.asdict(jdx.DEXTREME_ADR)
    s = tadr.init_adr_state(cfg.adr, 8, draws=adr_draws(jax.random.PRNGKey(1), 8))
    np.testing.assert_array_equal(s.hi.numpy(), np.float32([0.04, 0.04, 0.25]))
    np.testing.assert_array_equal(s.lo.numpy(), 0.0)
    full = s._replace(q_cnt=torch.full((6,), 64.0), q_sum=torch.full((6,), 64.0 * 5.0))
    done = torch.ones(8, dtype=torch.bool)
    moved = tadr.adr_step(cfg.adr, full, done, torch.full((8,), 5.0),
                          draws=adr_draws(jax.random.PRNGKey(2), 8))
    jmoved = jadr.adr_step(jdx.DEXTREME_MANUAL_DR, jadr.AdrState(
        *(jnp.asarray(x.numpy().astype(np.int32 if x.dtype == torch.int64 else np.float32))
          for x in full)), jnp.ones(8, bool), jnp.full(8, 5.0), jax.random.PRNGKey(2))
    np.testing.assert_array_equal(moved.hi.numpy(), s.hi.numpy())
    np.testing.assert_array_equal(moved.lo.numpy(), s.lo.numpy())
    assert_adr_close(moved, jmoved, "manual")
    assert ((moved.values >= moved.lo) & (moved.values <= moved.hi)).all()


# --- the learner ------------------------------------------------------------------


def test_dextreme_update_matches(monkeypatch):
    """One train_iter of the composed DeXtreme learner (LSTM before the MLP,
    gamma 0.998, the carry kept across episode ends), narrowed to hidden
    32-32 and LSTM 16 with trnn's horizon, sequences and minibatches,
    against the JAX learner (same flax init, Adam moments, stats, carry and
    draws): the trajectory's mu, logp and values within 1e-5, the new
    TrainState leaf by leaf."""
    _, over = treg.resolve_task("AllegroHandDextremeADR", ["num_envs=8"])
    fields = set(tppo.PPOConfig._fields)
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in over.items() if k in fields}
    assert (cfg["rnn_units"], cfg["seq_len"], cfg["zero_rnn_on_done"], cfg["gamma"]) == (
        512, 16, False, 0.998)
    assert cfg["hidden"] == (512, 512) and not cfg.get("asymmetric_critic", False)
    cfg.update(trnn._cfg(), hidden=(32, 32), rnn_units=16)
    for name, v in (("NUM_OBS", 88), ("NUM_ACTIONS", 16)):
        monkeypatch.setattr(trnn, name, v)
    j_new, j_stats, j_traj, t_new, t_stats, t_traj, kls, _, tcfg = trnn._run_both(cfg, 14)
    for k in ("mu", "logp", "value"):
        np.testing.assert_allclose(getattr(t_traj, k).numpy(), np.asarray(getattr(j_traj, k)),
                                   atol=1e-5, err_msg=k)
    trnn._assert_state_matches(j_new, t_new, tcfg, kls)
    for k, v in j_stats.items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
