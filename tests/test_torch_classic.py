"""The classic-task surface: Quadcopter and Ingenuity against the JAX
package on the CPU.

- Each env's reset observations from the same draws (the JAX package's,
  re-derived from its keys and handed to the port's `reset` / `step`),
  then 2 steps at B = 8 (random actions; the Quadcopter's thrusts up to
  0.17 N a rotor, 50 m/s^2 on its 3.4 g) with one env's episode timing
  out at the first
  (its fresh episode from the injected draws; for Ingenuity also one
  env's waypoint re-sampling at its 500th step): observations and rewards
  within 2e-3 times max(1, the largest value) (the craft's ill-conditioned
  mass matrices, see tests/test_torch_floating.py), done flags and the
  info exactly / within 2e-3, every state leaf within 2e-4 (positions)
  or 2e-3 (velocities) of the same scale.
- `compose_task` of both tasks against the JAX package's: the env config
  field by field and the PPO overrides, with the Ingenuity 500 -> 2000
  episode rule; an unported classic task raises NotImplementedError
  naming ROADMAP §1.7.
- One Quadcopter `train_iter` at B = 16 (hidden 32-32, horizon 2,
  minibatch 8: 4 minibatches x 4 mini-epochs), two envs timing out in it: the rollout on each side with
  the JAX package's noise and reset draws (observations, mu and values
  within 5e-3 of max(1, scale), rewards 2e-3, logp 1e-4: at the fresh
  policy's thrusts float32 itself is that far from float64, see the
  test), then the update from the JAX package's
  trajectory with its permutations, held as tests/test_torch_ppo.py holds
  the MLP update (params and Adam moments 1e-6 or 1e-4 of the largest
  moment, counters exact, stats 1e-5 relative (1e-7 absolute about 0), the lr
  equal).
- The train entry point on the CPU: 1 iteration, its checkpoint read by
  the JAX package's `load_checkpoint` with its own example tree; and a
  JAX-written checkpoint resumed whole by the port's entry point.
- Cartpole, Ant and Humanoid on the in-repo stand-ins
  (handarm_tpu_torch/assets/classic_standin/; the Humanoid's JAX env
  through its LocomotionEnv wrapped to read it, see
  tests/test_torch_locomotion.py): the Cartpole's reset and 2 steps at B =
  8 from the JAX package's draws, env 0 timing out at the first (2 sim
  substeps of a 2-dof model: q within 2e-4 and qd, observations and
  rewards within 2e-3, each times max(1, the largest value)); their
  `compose_task` against the JAX package's (the asset path is the
  stand-in's on both sides: the port's default, the JAX package's
  override); the refusal list without them; and checkpoints both ways
  for each (4, 16 and 16 env-state leaves).
- BallBalance, Anymal and AnymalTerrain on theirs (the JAX package's
  module constants `BBOT_MJCF` and `ANYMAL_URDF` monkeypatched to the
  port's stand-ins; tests/test_torch_ball_balance.py and
  tests/test_torch_anymal.py hold their envs): `compose_task` against the
  JAX package's, with the ANYmal tasks' 500 -> 1000 episode rule, and
  checkpoints both ways (14, 14 and 18 env-state leaves: the ball's and
  the base's, the commands, the terrain level and the spawn point among
  them).
- FrankaCubeStack and FrankaCabinet on the stand-in Franka (the JAX
  package's `FRANKA_URDF` constants monkeypatched;
  tests/test_torch_franka.py and tests/test_torch_franka_cabinet.py hold
  their envs): `compose_task` against the JAX package's, with
  FrankaCubeStack's 500 -> 300 episode rule and the Cabinet's props, and
  checkpoints both ways (11 and 12 env-state leaves: the fixed base's
  physics, the cubes or the drawer, the Cabinet's persistent targets).
- Trifinger, AllegroHand, ShadowHand, ShadowHandOpenAI_FF and
  ShadowHandOpenAI_LSTM on theirs (the JAX package's `TRIFINGER_URDF`,
  `ALLEGRO_URDF` and `SHADOW_MJCF` monkeypatched;
  tests/test_torch_trifinger.py and tests/test_torch_dexhand.py hold their
  envs): `compose_task` against the JAX package's, with the 500 -> 750 and
  500 -> 600 episode rules and the OpenAI tasks' 42 + 211 observations and
  asymmetric learners, and checkpoints both ways of Trifinger and
  AllegroHand (15 env-state leaves each: the fixed base's physics, the
  goal, the last tips; the hand's targets, successes and the scalar
  consecutive-success average).
- The DeXtreme tasks (AllegroHandDextremeADR, AllegroHandADR,
  AllegroHandManualDR) and the one-arm AllegroKuka tasks
  (AllegroKukaReorientation, AllegroKukaRegrasping, AllegroKukaThrow, and
  AllegroKuka with its `env.subtask` resolver) on theirs (the JAX
  package's `ALLEGRO_URDF` and `KUKA_ALLEGRO_URDF` monkeypatched;
  tests/test_torch_dextreme.py and tests/test_torch_allegro_kuka.py hold
  their envs): `compose_task` against the JAX package's, with the 500 ->
  600 episode rule, the DeXtreme learner (LSTM 512 before a 512-512 MLP,
  seq_len 16, its carry kept across episode ends; the JAX wrapper's cfg
  is its inner AllegroHand's, held against the port's inner env's, the
  ADR config beside it) and the variant from the name or the subtask;
  checkpoints both ways of AllegroHandDextremeADR (25 env-state leaves:
  the inner DexState's 15, the last observation, the AdrState's 6, the
  two RNA masks, the key; its recurrent learner read with its PPOConfig)
  and AllegroKukaReorientation (25: the fixed base's physics, the bool
  lifted flags and the tolerance curriculum's scalars among them).
- The two-arm AllegroKuka tasks (AllegroKukaTwoArmsReorientation,
  AllegroKukaTwoArmsRegrasping, and AllegroKukaTwoArms with its
  `env.subtask` resolver; the JAX package's `KUKA_ALLEGRO_URDF` and
  `TWO_ARMS_URDF` pointed at the stand-in and the port's composed file;
  tests/test_torch_allegro_kuka_two_arms.py holds their envs and that
  file): `compose_task` against the JAX package's, with the 500 -> 600
  episode rule and the variant from the name or the subtask, 506 slots.
- The Factory tasks (FactoryTaskNutBoltPick, FactoryTaskNutBoltPlace,
  FactoryTaskNutBoltScrew, FactoryTaskGears, FactoryTaskInsertion) and
  IndustRealTaskPegsInsert on the stand-in Franka with the parts' tracked
  records (the JAX package's `FRANKA_URDF` constants and its loader's
  `CACHE_DIR` monkeypatched; tests/test_torch_factory.py and
  tests/test_torch_industreal.py hold their envs): `compose_task` against
  the JAX package's, with the 500 -> 100 and 500 -> 128 episode rules,
  every other env key dropped as the JAX factories drop it, and
  IndustReal's asymmetric learner.
  The refusal list keeps two refused cases: HumanoidAMP and
  IndustRealTaskGearsInsert.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import handarm_tpu.learn.ppo as jppo
from handarm_tpu.envs import registry as jreg
from handarm_tpu.utils.checkpoint import load_checkpoint
from handarm_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from handarm_tpu_torch.convert import (
    classic_state_from_leaves,
    learner_to_leaves,
    train_state_from_leaves,
)
from handarm_tpu_torch.envs import classic as tcl
from handarm_tpu_torch.envs import locomotion as tl
from handarm_tpu_torch.envs import registry as treg
from handarm_tpu_torch.envs.ingenuity import IngenuityDraws, IngenuityState
from handarm_tpu_torch.envs.quadcopter import QuadcopterConfig, QuadDraws, QuadState
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.utils import checkpoint as tck
from test_torch_floating import jax_env, port_env
from test_torch_ppo import TRAJ_FIELDS, _perms, _port_traj
from test_torch_train import assert_same_lr, record_kls

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS_TOL, VEL_TOL = 2e-4, 2e-3
_t = lambda x: torch.as_tensor(np.array(x))


def _close(got, want, tol, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, atol=tol * scale, err_msg=name)


def fresh_draws(kind: str, key, B: int, nv: int):
    """The port's draws of the fresh episodes the JAX env's `_fresh(key, B)`
    makes."""
    u = jax.random.uniform
    if kind == "quadcopter":
        k_root, k_dof, _ = jax.random.split(key, 3)
        return QuadDraws(_t(u(k_root, (B, 3), minval=-1.0, maxval=1.0)),
                         _t(u(k_dof, (B, nv), minval=-0.2, maxval=0.2)))
    k_root, k_tgt, _ = jax.random.split(key, 3)
    return IngenuityDraws(_t(u(k_root, (B, 2), minval=-1.0, maxval=1.0)),
                          _t(u(k_tgt, (B, 3))))


def step_draws(kind: str, state_key, B: int, nv: int):
    """The port's draws of the JAX env's `step` from a state with key
    `state_key`, and that step's next key."""
    if kind == "quadcopter":
        key, k_reset = jax.random.split(state_key)
        return fresh_draws(kind, k_reset, B, nv), key
    key, k_tgt, k_reset = jax.random.split(state_key, 3)
    return fresh_draws(kind, k_reset, B, nv)._replace(
        retarget=_t(jax.random.uniform(k_tgt, (B, 3)))), key


def port_state(jstate, state_type):
    """A JAX classic env state handed to the port (its leaves, key last)."""
    return classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                     state_type)


def assert_state_close(got, want):
    g = jax.tree.leaves(want)
    leaves = tck_leaves(got)
    assert len(leaves) == len(g) - 1  # the JAX key
    names = ("q", "qd", "targets", "base_pos", "base_quat", "opos", "oquat", "olin", "oang",
             "impulse")
    for i, (a, b) in enumerate(zip(leaves, g)):
        name = names[i] if i < len(names) else f"own {i}"
        tol = VEL_TOL if name in ("qd", "impulse", "olin", "oang") else POS_TOL
        if a.dtype in (torch.int64,):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            _close(a, b, tol, name)


def tck_leaves(state):
    p = state.physics
    return [x for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None] + list(
        state[1:])


@pytest.mark.parametrize("kind", ["quadcopter", "ingenuity"])
def test_env_reset_and_steps_match(kind, tmp_path):
    B = 8
    jenv, tenv = jax_env(kind, str(tmp_path), num_envs=B), port_env(kind, num_envs=B)
    nv = tenv.art.nv
    state_type = QuadState if kind == "quadcopter" else IngenuityState
    key = jax.random.PRNGKey(11)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, fresh_draws(kind, key, B, nv))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert_state_close(ts, js)
    # env 0 times out at the next step; for Ingenuity env 1 re-samples its
    # waypoint there
    length = tenv.cfg.episode_length
    prog = np.zeros(B, np.int32)
    prog[0] = length - 1
    if kind == "ingenuity":
        prog[1] = 499
    js = js._replace(progress=jnp.asarray(prog))
    ts = ts._replace(progress=torch.as_tensor(prog, dtype=torch.int64))
    rng = np.random.default_rng(4)
    step = jax.jit(jenv.step)
    dones = []
    for i in range(2):
        a = rng.uniform(-1.0, 1.0, (B, tenv.num_actions)).astype(np.float32)
        if kind == "quadcopter":  # thrusts up to 0.17 N a rotor on the 3.4 g craft
            a[:, 8:] = rng.uniform(-1.0, 0.05, (B, 4))
        draws, _ = step_draws(kind, js.key, B, nv)
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), draws)
        _close(tr.obs, jr.obs, VEL_TOL, f"obs {i}")
        _close(tr.reward, jr.reward, VEL_TOL, f"reward {i}")
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert set(tr.info) == set(jr.info)
        _close(tr.info["target_dist"], jr.info["target_dist"], POS_TOL, "target_dist")
        assert tr.teacher_obs.shape == (B, 0)
        assert_state_close(ts, js)
        dones.append(tr.done.numpy())
    assert dones[0][0] and int(ts.progress[0]) == 1  # restarted, then one step
    if kind == "ingenuity":
        assert not dones[0][1]


# --- the registry ---------------------------------------------------------------


@pytest.mark.parametrize("task,overrides", [
    ("Quadcopter", []),
    ("Quadcopter", ["env.num_envs=64", "max_thrust=3.0", "ppo.minibatch_size=512"]),
    ("Ingenuity", []),
    ("Ingenuity", ["num_envs=32", "env.episode_length=300", "ppo.hidden=[64,64]"]),
])
def test_compose_task_matches(task, overrides, tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    jenv, jppo_over = jreg.compose_task(task, list(overrides))
    cfg, ppo_over = treg.resolve_task(task, list(overrides))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jenv.cfg)
    norm = lambda d: {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}
    assert norm(ppo_over) == norm(jppo_over)
    if task == "Ingenuity" and not overrides:
        assert cfg.episode_length == 2000
    assert type(treg.make_env(task, list(overrides), device="cpu")[0]).__name__ == \
        type(jenv).__name__
    assert treg.all_task_names() == [n for n in jreg.all_task_names()
                                     if n in treg.TASKS or n in treg.CLASSIC_TASKS]


DEXTREME = ("AllegroHandDextremeADR", "AllegroHandADR", "AllegroHandManualDR")
KUKA = ("AllegroKukaReorientation", "AllegroKukaRegrasping", "AllegroKukaThrow", "AllegroKuka")
KUKA2 = ("AllegroKukaTwoArmsReorientation", "AllegroKukaTwoArmsRegrasping", "AllegroKukaTwoArms")
FACTORY = ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace", "FactoryTaskNutBoltScrew",
           "FactoryTaskGears", "FactoryTaskInsertion")
PORTED_STANDINS = ("Ant", "Cartpole", "Humanoid", "Anymal", "BallBalance", "FrankaCabinet",
                   "FrankaCubeStack", "Trifinger", "AllegroHand", "ShadowHand",
                   "ShadowHandOpenAI_FF", "ShadowHandOpenAI_LSTM") + DEXTREME + KUKA + KUKA2 + (
                       FACTORY + ("IndustRealTaskPegsInsert",))


@pytest.mark.parametrize("task", ["Ant", "Cartpole", "ShadowHandOpenAI_LSTM", "Humanoid",
                                  "Anymal", "BallBalance", "FrankaCabinet", "Trifinger",
                                  "FrankaCubeStack", "ShadowHand", "FactoryTaskGears",
                                  "AllegroHand", "ShadowHandOpenAI_FF", "AllegroKuka",
                                  "AllegroHandADR", "HumanoidAMP", "AllegroKukaTwoArms",
                                  "IndustRealTaskPegsInsert", "AllegroHandDextremeADR",
                                  "AllegroHandManualDR", "AllegroKukaReorientation",
                                  "AllegroKukaRegrasping", "AllegroKukaThrow",
                                  "AllegroKukaTwoArmsReorientation",
                                  "AllegroKukaTwoArmsRegrasping", "FactoryTaskNutBoltPick",
                                  "FactoryTaskNutBoltPlace", "FactoryTaskNutBoltScrew",
                                  "FactoryTaskInsertion", "IndustRealTaskGearsInsert"])
def test_unported_classic_task_raises(task):
    """The refusal list: the JAX package's classic tasks the port lacks raise
    NotImplementedError naming ROADMAP §1.7 (HumanoidAMP,
    IndustRealTaskGearsInsert); Ant, Cartpole, Humanoid, Anymal,
    BallBalance, FrankaCabinet, FrankaCubeStack, Trifinger, AllegroHand,
    ShadowHand, the ShadowHandOpenAI tasks, the DeXtreme tasks, the
    AllegroKuka tasks on one arm and on two, the Factory tasks and
    IndustRealTaskPegsInsert are ported and off it."""
    assert task in jreg.CLASSIC_TASKS
    with pytest.raises(TypeError):
        treg.resolve_task("Quadcopter", ["no_such_field=1"])
    if task in PORTED_STANDINS:
        assert task not in treg.UNPORTED_CLASSIC and task in treg.CLASSIC_TASKS
        cfg, _ = treg.resolve_task(task, ["num_envs=8"])
        assert cfg.num_envs == 8
        return
    with pytest.raises(NotImplementedError, match="ROADMAP §1.7"):
        treg.resolve_task(task, ["num_envs=8"])
    with pytest.raises(NotImplementedError, match=task):
        treg.make_config(task)
    assert set(treg.UNPORTED_CLASSIC) == set(jreg.CLASSIC_TASKS) - set(treg.CLASSIC_TASKS)


# --- the learner --------------------------------------------------------------


class _DrawnEnv:
    """A port env whose steps take the next of the given draws."""

    def __init__(self, env, draws):
        self.env, self.draws = env, iter(draws)
        self.num_obs, self.num_actions, self.cfg = env.num_obs, env.num_actions, env.cfg
        self.device = env.device

    def step(self, state, a):
        return self.env.step(state, a, next(self.draws))


def test_quadcopter_train_iter_matches(tmp_path):
    B, T = 16, 2
    cfg = dict(hidden=(32, 32), horizon=T, minibatch_size=8)
    jenv, tenv = jax_env("quadcopter", str(tmp_path), num_envs=B), port_env(
        "quadcopter", num_envs=B)
    jp = jppo.PPO(jenv, jppo.PPOConfig(**cfg))
    jts = jp.init(jax.random.PRNGKey(5))
    # envs 0 and 1 time out at the rollout's first and second steps
    prog = np.zeros(B, np.int32)
    prog[:2] = jenv.cfg.episode_length - np.array([1, 2])
    jts = jts._replace(env_state=jts.env_state._replace(progress=jnp.asarray(prog)))
    captured = {}
    update = jp._update_from_traj

    def capture(ts_, traj, env_state, last_obs, *args, **kw):
        captured["traj"], captured["last_obs"] = traj, last_obs
        return update(ts_, traj, env_state, last_obs, *args, **kw)

    jp._update_from_traj = capture
    j_new, j_stats = jp.train_iter(jts)
    k_next, k_roll, _ = jax.random.split(jts.key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 12)))
                      for k in jax.random.split(k_roll, T)])
    draws, key = [], jts.env_state.key
    for _ in range(T):
        d, key = step_draws("quadcopter", key, B, 14)
        draws.append(d)

    leaves = [np.asarray(x) for x in jax.tree.leaves(jts)]
    n_env = len(jax.tree.leaves(jts.env_state))
    assert n_env == 14
    env_state = port_state(jts.env_state, QuadState)
    tcfg = tppo.PPOConfig(**cfg)
    tp = tppo.PPO(_DrawnEnv(tenv, draws), tcfg, device="cpu")
    tts = train_state_from_leaves(leaves, env_state, _t(jts.last_obs), cfg=tcfg, n_env=n_env)
    traj, env_state, last_obs = tp.rollout(tts, _t(noise))[:3]
    want = captured["traj"]
    assert np.asarray(want.done)[[0, 1], [0, 1]].all()  # restarts from the draws
    # the fresh policy's unit noise drives the 3.4 g craft's thrusts to 2 N a
    # rotor within 2 steps (22 m/s by the 4th): there the float64 step of
    # the same actions lies 6.4e-3 from the JAX package's float32
    # observations and 1.2e-2 from the port's (largest value 12, after 3
    # steps; measured): 5e-3 times max(1, scale) on what follows from the
    # observations
    for k, tol in (("obs", 5e-3), ("mu", 5e-3), ("logp", 1e-4), ("value", 5e-3),
                   ("reward", 2e-3)):
        _close(getattr(traj, k), getattr(want, k), tol, k)
    np.testing.assert_array_equal(traj.done.numpy(), np.asarray(want.done))

    kls = record_kls(tp)
    _close(last_obs, captured["last_obs"], 5e-3, "last obs")
    t_new, t_stats = tp._update_from_traj(
        tts, _port_traj({k: np.asarray(getattr(want, k)) for k in TRAJ_FIELDS}),
        env_state, _t(captured["last_obs"]), perms=_t(_perms(k_next, 4, T * B)).long())
    got = learner_to_leaves(t_new, tcfg)
    want_leaves = [np.asarray(x) for x in jax.tree.leaves(
        (j_new.params, j_new.opt_state, j_new.obs_stats, j_new.value_stats, j_new.lr))]
    P = len(tppo.param_names(tcfg))
    assert len(got) == len(want_leaves) == 3 * P + 4 + 7
    for i, w in enumerate(want_leaves):
        assert got[i].dtype == w.dtype and got[i].shape == w.shape, i
        if i < P:
            np.testing.assert_allclose(got[i], w, atol=1e-6, err_msg=f"leaf {i}")
        elif P + 4 <= i < 3 * P + 4:
            tol = max(1e-6, 1e-4 * float(np.abs(w).max()))
            np.testing.assert_allclose(got[i], w, atol=tol, err_msg=f"leaf {i}")
        elif i < P + 4:
            np.testing.assert_array_equal(got[i], w, err_msg=f"leaf {i}")
        elif i < 3 * P + 4 + 6:  # stats: 1e-5 relative, 1e-7 where a mean is near 0
            np.testing.assert_allclose(got[i], w, rtol=1e-5, atol=1e-7, err_msg=f"leaf {i}")
    assert_same_lr(float(got[-1]), float(want_leaves[-1]), kls)
    assert bool(t_stats["kl_guard_triggered"]) == bool(j_stats["kl_guard_triggered"])
    for k in ("reward_mean", "episode_done_frac", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(t_stats["success_rate_ewma"]) == 0.0


# --- the train entry point and checkpoints ----------------------------------------


def _train(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "handarm_tpu_torch.train", "device=cpu",
                          *args], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


ENTRY = ["task=Quadcopter", "env.num_envs=16", "ppo.hidden=[32,32]", "ppo.minibatch_size=64"]


def test_train_entry_checkpoints_cross(tmp_path):
    os.symlink(os.path.join(REPO, "configs"), tmp_path / "configs")
    out = _train([*ENTRY, "max_iterations=1"], tmp_path)
    run = tmp_path / "runs" / "Quadcopter"
    cfgj = json.loads((run / "config.json").read_text())
    assert cfgj["env"]["num_envs"] == 16 and cfgj["ppo"]["hidden"] == [32, 32]
    assert "succ 0.000" in out
    path = str(run / "nn" / "ckpt_1.npz")

    jenv = jax_env("quadcopter", str(tmp_path), num_envs=16)
    jp = jppo.PPO(jenv, jppo.PPOConfig(hidden=(32, 32), minibatch_size=64))
    example = jp.init(jax.random.PRNGKey(0))
    back = load_checkpoint(path, example_tree=example)
    mine = tck.read_leaves(path)
    theirs = jax.tree.leaves(back)
    assert len(mine) == len(theirs) == len(jax.tree.leaves(example))
    for a, b, e in zip(mine, theirs, jax.tree.leaves(example)):
        assert a.dtype == np.asarray(e).dtype and a.shape == np.asarray(e).shape
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(back.epoch) == 1 and back.env_state.physics.robot.tau_ext is None

    # the reverse: a JAX-written TrainState, resumed whole by the port
    jdir = tmp_path / "jax_ckpt"
    jpath = jax_save_checkpoint(str(jdir), example, step=3, sync=True)
    tts = tck.load_train_state(jpath, cfg=None, env_cfg=QuadcopterConfig(num_envs=16))
    assert isinstance(tts.env_state, QuadState)
    np.testing.assert_array_equal(tts.env_state.physics.robot.base_pos.numpy(),
                                  np.asarray(example.env_state.physics.robot.base_pos))
    out = _train([*ENTRY, "max_iterations=4", f"resume={jpath}", "experiment=resumed"],
                 tmp_path)
    assert f"resumed from {jpath} at iter 3\n" in out, out
    assert (tmp_path / "runs" / "resumed" / "nn" / "ckpt_4.npz").exists()


# --- Cartpole, Ant and Humanoid on the stand-ins -------------------------------------


def jax_standin_env(task: str, **kw):
    """The JAX package's env of a task on the in-repo stand-in."""
    from handarm_tpu.envs import classic as jcl

    from test_torch_locomotion import jax_env

    if task == "Cartpole":
        return jcl.make_cartpole(urdf=tcl.CARTPOLE_URDF, **kw)
    if task in STANDIN_CONSTANTS:
        with pytest.MonkeyPatch.context() as mp:
            _patch_standins(mp)
            make = STANDIN_CONSTANTS[task][0]
            return getattr(make[0], make[1])(**kw)
    return jax_env(task.lower(), **kw)


def _standin_constants():
    """task -> ((JAX module, factory name), the JAX module constants that
    name its asset, the port's path) of the tasks whose asset is a module
    constant."""
    from handarm_tpu.envs import anymal as jan
    from handarm_tpu.envs import anymal_terrain as jat
    from handarm_tpu.envs import allegro_kuka as jak
    from handarm_tpu.envs import ball_balance as jbb
    from handarm_tpu.envs import dexhand as jdex
    from handarm_tpu.envs import dextreme as jdx
    from handarm_tpu.envs import factory as jfac
    from handarm_tpu.envs import franka as jfr
    from handarm_tpu.envs import franka_cabinet as jcab
    from handarm_tpu.envs import industreal as jir
    from handarm_tpu.envs import objects as jobj
    from handarm_tpu.envs import trifinger as jtri
    from handarm_tpu_torch.envs import allegro_kuka as tak
    from handarm_tpu_torch.envs import anymal as tan
    from handarm_tpu_torch.envs import ball_balance as tbb
    from handarm_tpu_torch.envs import dexhand as tdex
    from handarm_tpu_torch.envs import franka as tfr
    from handarm_tpu_torch.envs import objects as tobj
    from handarm_tpu_torch.envs import trifinger as ttri

    shadow = [(jdex, "SHADOW_MJCF", tdex.SHADOW_MJCF)]
    allegro = [(jdex, "ALLEGRO_URDF", tdex.ALLEGRO_URDF)]
    kuka = ((jak, "make_allegro_kuka"), [(jak, "KUKA_ALLEGRO_URDF", tak.KUKA_ALLEGRO_URDF)])
    # the JAX generator returns an existing file: the port's, composed alike
    kuka2 = ((jak, "make_allegro_kuka_two_arms"),
             [(jak, "KUKA_ALLEGRO_URDF", tak.KUKA_ALLEGRO_URDF),
              (jak, "TWO_ARMS_URDF", tak.generate_two_arms_urdf)])
    # the parts' records: the tracked ones, under the reference's URDF paths
    records = (jobj, "CACHE_DIR", str(tobj.CACHE_DIR))
    factory = ((jfac, "make_factory"), [(jfac, "FRANKA_URDF", tfr.FRANKA_URDF), records])

    return {"BallBalance": ((jbb, "make_ball_balance"), [(jbb, "BBOT_MJCF", tbb.BBOT_MJCF)]),
            "Anymal": ((jan, "make_anymal"), [(jan, "ANYMAL_URDF", tan.ANYMAL_URDF)]),
            "AnymalTerrain": ((jat, "make_anymal_terrain"),
                              [(jat, "ANYMAL_URDF", tan.ANYMAL_URDF)]),
            "FrankaCubeStack": ((jfr, "make_franka_cube_stack"),
                                [(jfr, "FRANKA_URDF", tfr.FRANKA_URDF)]),
            "FrankaCabinet": ((jcab, "make_franka_cabinet"),
                              [(jcab, "FRANKA_URDF", tfr.FRANKA_URDF)]),
            "Trifinger": ((jtri, "make_trifinger"),
                          [(jtri, "TRIFINGER_URDF", ttri.TRIFINGER_URDF)]),
            "AllegroHand": ((jdex, "make_allegro"), [(jdex, "ALLEGRO_URDF", tdex.ALLEGRO_URDF)]),
            "ShadowHand": ((jdex, "make_shadow"), shadow),
            "ShadowHandOpenAI_FF": ((jdex, "make_shadow"), shadow),
            "ShadowHandOpenAI_LSTM": ((jdex, "make_shadow"), shadow),
            "AllegroHandDextremeADR": ((jdx, "make_allegro_dextreme"), allegro),
            "AllegroHandADR": ((jdx, "make_allegro_dextreme"), allegro),
            "AllegroHandManualDR": ((jdx, "make_allegro_dextreme_manual"), allegro),
            **{task: kuka for task in KUKA}, **{task: kuka2 for task in KUKA2},
            **{task: factory for task in FACTORY},
            "IndustRealTaskPegsInsert": ((jir, "make_industreal"),
                                         [(jir, "FRANKA_URDF", tfr.FRANKA_URDF), records])}


STANDIN_CONSTANTS = _standin_constants()


def _patch_standins(mp):
    """Point the JAX package's asset constants at the in-repo stand-ins (a
    callable path: the file it writes)."""
    for _, consts in STANDIN_CONSTANTS.values():
        for mod, name, path in consts:
            mp.setattr(mod, name, path() if callable(path) else path)


def test_cartpole_reset_and_steps_match():
    B = 8
    jenv = jax_standin_env("Cartpole", num_envs=B)
    tenv = tcl.make_cartpole(num_envs=B, device="cpu")
    n = jenv.cfg.reset_noise

    def draws(key):
        k1, k2, _ = jax.random.split(key, 3)
        u = lambda k: _t(jax.random.uniform(k, (B, 2), minval=-n, maxval=n))
        return tcl.ClassicDraws(u(k1), u(k2))

    key = jax.random.PRNGKey(7)
    js, jobs = jenv.reset(key)
    ts, tobs = tenv.reset(0, draws(key))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    prog = np.zeros(B, np.int32)
    prog[0] = jenv.cfg.episode_length - 1  # env 0 times out at the first step
    js = js._replace(progress=jnp.asarray(prog))
    ts = classic_state_from_leaves([np.asarray(x) for x in jax.tree.leaves(js)],
                                   tcl.ClassicState)
    rng = np.random.default_rng(5)
    step = jax.jit(jenv.step)
    for i in range(2):
        a = rng.uniform(-1.0, 1.0, (B, 1)).astype(np.float32)
        d = draws(jax.random.split(js.key)[1])
        js, jr = step(js, jnp.asarray(a))
        ts, tr = tenv.step(ts, _t(a), d)
        for name, got, want, tol in (("obs", tr.obs, jr.obs, VEL_TOL),
                                     ("reward", tr.reward, jr.reward, VEL_TOL),
                                     ("q", ts.q, js.q, POS_TOL), ("qd", ts.qd, js.qd, VEL_TOL)):
            _close(got, want, tol, f"{name} {i}")
        np.testing.assert_array_equal(ts.progress.numpy(), np.asarray(js.progress))
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        assert tr.info == jr.info == {} and tr.teacher_obs.shape == (B, 0)
        if i == 0:
            assert bool(tr.done[0]) and not bool(tr.done[1:].any())
    assert float(np.abs(np.asarray(js.qd)).max()) > 1.0  # the effort moved the carts


@pytest.mark.parametrize("task,overrides", [
    ("Cartpole", []),
    ("Cartpole", ["env.num_envs=64", "reset_noise=0.2", "ppo.minibatch_size=512"]),
    ("Ant", []),
    ("Ant", ["num_envs=32", "env.episode_length=300", "power_scale=0.5"]),
    ("Humanoid", []),
    ("Humanoid", ["env.num_envs=16", "ppo.hidden=[64,64]"]),
    ("BallBalance", []),
    ("BallBalance", ["num_envs=32", "action_speed_scale=10.0", "ppo.minibatch_size=512"]),
    ("Anymal", []),
    ("Anymal", ["env.num_envs=16", "env.episode_length=300", "kp=60.0"]),
    ("AnymalTerrain", []),
    ("AnymalTerrain", ["num_envs=16", "num_levels=3", "num_types=4", "ppo.hidden=[64,64]"]),
    ("FrankaCubeStack", []),
    ("FrankaCubeStack", ["num_envs=32", "osc_kp=100.0", "ppo.minibatch_size=512"]),
    ("FrankaCabinet", []),
    ("FrankaCabinet", ["env.num_envs=16", "num_props=2", "ppo.hidden=[64,64]"]),
    ("Trifinger", []),
    ("Trifinger", ["num_envs=32", "safety_damping=0.2", "ppo.minibatch_size=512"]),
    ("AllegroHand", []),
    ("AllegroHand", ["env.num_envs=16", "obs_type=full", "env.episode_length=300"]),
    ("ShadowHand", []),
    ("ShadowHand", ["num_envs=16", "obs_type=full_no_vel", "ppo.hidden=[64,64]"]),
    ("ShadowHandOpenAI_FF", []),
    ("ShadowHandOpenAI_LSTM", []),
    ("ShadowHandOpenAI_LSTM", ["num_envs=16", "ppo.rnn_units=64", "ppo.seq_len=8"]),
    ("AllegroHandDextremeADR", []),
    ("AllegroHandADR", ["num_envs=16", "ppo.rnn_units=64", "env.episode_length=300"]),
    ("AllegroHandManualDR", []),
    ("AllegroKukaReorientation", []),
    ("AllegroKukaRegrasping", ["num_envs=32", "env.episode_length=300",
                               "ppo.minibatch_size=512"]),
    ("AllegroKukaThrow", ["env.num_envs=16", "keypoint_scale=2.0"]),
    ("AllegroKuka", []),
    ("AllegroKuka", ["env.num_envs=16", "env.subtask=throw"]),
    ("AllegroKukaTwoArmsReorientation", []),
    ("AllegroKukaTwoArmsRegrasping", ["num_envs=32", "env.episode_length=300"]),
    ("AllegroKukaTwoArms", ["env.num_envs=16", "env.subtask=regrasping"]),
    ("FactoryTaskNutBoltPick", []),
    ("FactoryTaskNutBoltPlace", ["num_envs=16", "env.episode_length=50"]),
    ("FactoryTaskNutBoltScrew", ["env.num_envs=16", "keypoint_scale=2.0",
                                 "ppo.minibatch_size=512"]),
    ("FactoryTaskGears", []),
    ("FactoryTaskInsertion", ["num_envs=32", "nut_xy_noise=0.2"]),
    ("IndustRealTaskPegsInsert", []),
    ("IndustRealTaskPegsInsert", ["env.num_envs=16", "env.episode_length=64",
                                  "curriculum_interval=1", "ppo.hidden=[64,64]"]),
])
def test_compose_task_matches_standins(task, overrides, monkeypatch):
    from handarm_tpu.envs import locomotion as jl

    jover = list(overrides)
    if task == "Cartpole":
        jover.append(f"urdf={tcl.CARTPOLE_URDF}")
    elif task == "Ant":
        jover.append(f"mjcf={tl.ANT_MJCF}")
    elif task in STANDIN_CONSTANTS:  # their factories take no path: the constants point
        _patch_standins(monkeypatch)
    else:  # its factory takes no mjcf=: its env is wrapped to read the stand-in
        env_cls = jl.LocomotionEnv
        monkeypatch.setattr(jl, "LocomotionEnv",
                            lambda c: env_cls(dataclasses.replace(c, mjcf=tl.HUMANOID_MJCF)))
    jenv, jppo_over = jreg.compose_task(task, jover)
    cfg, ppo_over = treg.resolve_task(task, list(overrides))
    tenv = treg.build_env(cfg, "cpu")
    if task in DEXTREME:  # the JAX wrapper's cfg is its inner AllegroHand's
        assert dataclasses.asdict(tenv.env.cfg) == dataclasses.asdict(jenv.cfg)
        assert dataclasses.asdict(cfg.adr) == dataclasses.asdict(jenv.adr_cfg)
        assert cfg.rna_seed == 0 and (cfg.adr.delta == (0.0,) * 3) == ("Manual" in task)
    else:
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jenv.cfg)
    norm = lambda d: {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}
    assert norm(ppo_over) == norm(jppo_over)
    assert (tenv.num_obs, tenv.num_actions) == (jenv.num_obs, jenv.num_actions)
    assert type(tenv).__name__ == type(jenv).__name__.replace("ClassicEnv", "CartpoleEnv")
    if task in ("Anymal", "AnymalTerrain") and "env.episode_length=300" not in overrides:
        assert cfg.episode_length == 1000  # the registry's 500 -> 1000
    if task == "FrankaCubeStack":
        assert cfg.episode_length == 300  # the registry's 500 -> 300
    if task == "Trifinger":
        assert cfg.episode_length == 750  # the registry's 500 -> 750
    if task in ("AllegroHand", "ShadowHand", "ShadowHandOpenAI_FF", "ShadowHandOpenAI_LSTM",
                *DEXTREME, *KUKA, *KUKA2):
        # the registry's 500 -> 600; the OpenAI tasks: 42 observations, the
        # 211-dim state as the critic's
        assert cfg.episode_length == (300 if "env.episode_length=300" in overrides else 600)
        if "OpenAI" in task:
            assert (tenv.num_obs, tenv.num_teacher_obs) == (jenv.num_obs, jenv.num_teacher_obs)
            assert (tenv.num_obs, tenv.num_teacher_obs, ppo_over["asymmetric_critic"]) == (
                42, 211, True)
    if task in DEXTREME:  # an LSTM 512 before a 512-512 MLP, its carry kept
        assert (ppo_over["rnn_units"], ppo_over["seq_len"], ppo_over["zero_rnn_on_done"],
                tuple(ppo_over["hidden"])) == (64 if overrides else 512, 16, False, (512, 512))
    if task in KUKA:  # the variant from the name, or from env.subtask
        want = {"AllegroKukaRegrasping": "regrasping", "AllegroKukaThrow": "throw"}.get(
            task, "throw" if "env.subtask=throw" in overrides else "reorientation")
        assert cfg.variant == jenv.cfg.variant == want
        assert tuple(ppo_over["hidden"]) == (768, 512, 256)
        assert tenv.scene.slots.num_slots == jenv.scene.slots.num_slots == 298
    if task in KUKA2:  # the variant from the name, or from env.subtask; two arms
        want = "regrasping" if "Regrasping" in task or "env.subtask=regrasping" in overrides \
            else "reorientation"
        assert cfg.variant == jenv.cfg.variant == want
        assert tuple(ppo_over["hidden"]) == (768, 512, 256)
        assert tenv.scene.slots.num_slots == jenv.scene.slots.num_slots == 506
        assert tenv.art.nv == jenv.art.nv == 46
    if task == "FrankaCabinet" and overrides:  # the props ride in the drawer
        assert tenv.scene.shapes.num_objects == jenv.scene.shapes.num_objects == 3
        assert tenv.scene.slots.num_slots == jenv.scene.slots.num_slots
    if task in FACTORY or task == "IndustRealTaskPegsInsert":
        # the registry's 500 -> 100 (Factory) or 128; every other env key
        # dropped (the config's defaults), as the JAX factories drop them
        assert cfg.episode_length == (50 if "env.episode_length=50" in overrides else 64
                                      if "env.episode_length=64" in overrides else
                                      100 if task in FACTORY else 128)
        defaults = type(cfg)(num_envs=cfg.num_envs, episode_length=cfg.episode_length,
                             task=cfg.task)
        assert cfg == defaults
        assert tenv.scene.slots.num_slots == jenv.scene.slots.num_slots == (
            456 if task == "FactoryTaskGears" else 298)
        assert ppo_over.get("asymmetric_critic", False) == (task == "IndustRealTaskPegsInsert")
    if task == "Humanoid":
        with pytest.raises(TypeError, match="mjcf"):  # as the JAX factory refuses it
            treg.resolve_task(task, [f"mjcf={tl.ANT_MJCF}"])


STANDIN_ENTRY = {"Cartpole": ["ppo.hidden=[32,32]", "ppo.minibatch_size=64"],
                 "Ant": ["ppo.hidden=[32,32]", "ppo.minibatch_size=64"],
                 "Humanoid": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32", "ppo.horizon=4"],
                 "BallBalance": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32", "ppo.horizon=4"],
                 "Anymal": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32", "ppo.horizon=4"],
                 "AnymalTerrain": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32",
                                   "ppo.horizon=4"],
                 "FrankaCubeStack": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32",
                                     "ppo.horizon=4"],
                 "FrankaCabinet": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32",
                                   "ppo.horizon=4"],
                 "Trifinger": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32", "ppo.horizon=4"],
                 "AllegroHand": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32",
                                 "ppo.horizon=4"],
                 "AllegroHandDextremeADR": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32",
                                            "ppo.horizon=4", "ppo.rnn_units=16",
                                            "ppo.seq_len=4"],
                 "AllegroKukaReorientation": ["ppo.hidden=[32,32]", "ppo.minibatch_size=32",
                                              "ppo.horizon=4"]}


@pytest.mark.parametrize("task,n_env", [("Cartpole", 4), ("Ant", 16), ("Humanoid", 16),
                                        ("BallBalance", 14), ("Anymal", 14),
                                        ("AnymalTerrain", 18), ("FrankaCubeStack", 11),
                                        ("FrankaCabinet", 12), ("Trifinger", 15),
                                        ("AllegroHand", 15), ("AllegroHandDextremeADR", 25),
                                        ("AllegroKukaReorientation", 25)])
def test_standin_checkpoints_cross(task, n_env, tmp_path):
    """The train entry point's checkpoint (1 iteration at 8 envs) read by the
    JAX loader with its own example tree, leaf for leaf; a JAX-written
    TrainState resumed whole by the port's loader and entry point."""
    os.symlink(os.path.join(REPO, "configs"), tmp_path / "configs")
    args = [f"task={task}", "env.num_envs=8", *STANDIN_ENTRY[task]]
    out = _train([*args, "max_iterations=1"], tmp_path)
    assert "succ 0.000" in out
    path = str(tmp_path / "runs" / task / "nn" / "ckpt_1.npz")

    cfg, over = treg.resolve_task(task, ["env.num_envs=8", *STANDIN_ENTRY[task]])
    pcfg = {k: tuple(v) if isinstance(v, list) else v for k, v in over.items()}
    jenv = jax_standin_env(task, num_envs=8, episode_length=cfg.episode_length)
    jp = jppo.PPO(jenv, jppo.PPOConfig(**pcfg))
    example = jp.init(jax.random.PRNGKey(0))
    assert len(jax.tree.leaves(example.env_state)) == n_env
    back = load_checkpoint(path, example_tree=example)
    mine = tck.read_leaves(path)
    for a, b, e in zip(mine, jax.tree.leaves(back), jax.tree.leaves(example), strict=True):
        assert a.dtype == np.asarray(e).dtype and a.shape == np.asarray(e).shape
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(back.epoch) == 1

    jpath = jax_save_checkpoint(str(tmp_path / "jax_ckpt"), example, step=3, sync=True)
    # the recurrent learner's layout comes from its PPOConfig
    tts = tck.load_train_state(jpath, cfg=tppo.ppo_config(over) if task in DEXTREME else None,
                               env_cfg=cfg)
    assert isinstance(tts.env_state, type(treg.build_env(cfg, "cpu")).state_type)
    got_s, want_s = tts.env_state, example.env_state
    if task in DEXTREME:  # the wrapper's own leaves, then its inner DexState's
        pairs = [(got_s.obs, want_s.obs), *zip(got_s.adr, want_s.adr),
                 *zip(got_s.rna, want_s.rna)]
        for got, want in pairs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got_s, want_s = got_s.inner, want_s.inner
    np.testing.assert_array_equal(got_s.progress.numpy(), np.asarray(want_s.progress))
    if task in ("Ant", "Humanoid"):
        np.testing.assert_array_equal(tts.env_state.physics.robot.tau_ext.numpy(),
                                      np.asarray(example.env_state.physics.robot.tau_ext))
    elif task != "Cartpole":  # the objects, a floating base's pose, the Cabinet's targets
        pairs = list(zip(got_s.physics.objects, want_s.physics.objects))
        if want_s.physics.robot.base_pos is not None:
            pairs.append((got_s.physics.robot.base_pos, want_s.physics.robot.base_pos))
        else:
            assert got_s.physics.robot.base_pos is None
        if task in ("FrankaCabinet", "AllegroHand", *DEXTREME, *KUKA):
            pairs.append((got_s.targets, want_s.targets))
        if task in ("AllegroHand", *DEXTREME):  # the scalar consecutive-success average
            pairs.append((got_s.cons_successes, want_s.cons_successes))
        if task in KUKA:  # the goal, the bool lifted flags, the curriculum's scalars
            pairs += [(getattr(got_s, f), getattr(want_s, f)) for f in (
                "goal_pos", "goal_quat", "lifted", "success_ewma", "tolerance",
                "frames_since_curriculum")]
        if task == "Trifinger":
            pairs += [(got_s.goal_pos, want_s.goal_pos), (got_s.prev_tips, want_s.prev_tips)]
        for got, want in pairs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = _train([*args, "max_iterations=4", f"resume={jpath}", "experiment=resumed"],
                 tmp_path)
    assert f"resumed from {jpath} at iter 3\n" in out, out
    assert (tmp_path / "runs" / "resumed" / "nn" / "ckpt_4.npz").exists()
