"""The port's ADR against the JAX package, and checkpoints of a DR + ADR run.

`envs/adr.py`'s functions run in this process on both sides, the port
given the JAX package's draws (rebuilt here from its keys as `adr_step`
and `init_adr_state` split them). One env step of DR + ADR across an
episode boundary needs the stand-in robot: the JAX side runs in a
subprocess (this file run as a script, HANDARM_ASSET_ROOT at the stand-in).
It builds Ur5SihLift at B = 8 = 2P with ShadowHand's DR
(`envs.tasks.DR_SHADOWHAND`) and ADR at its defaults, episode length 4;
from a reset it sets the episode clocks so that 4 envs end in the step,
every env a boundary worker, the ranges wider than their initial ones and
every queue one sample short of full (low sides full of successes, high
sides of failures), and takes one step. It writes the states, the step's
draws (action noise, the fresh DRState, ADR's recycling, observation
noise) and a JAX checkpoint of ckpt_5200's learner with that step's env
state (83 leaves: 36 of them the env's).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # the JAX side's subprocess
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from handarm_tpu.envs import adr as ja  # noqa: E402
from handarm_tpu_torch.envs import adr as ta  # noqa: E402
from shared_jax_cache import shared_jax_env  # noqa: E402

STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
CKPT = os.path.join(REPO, "docs", "evidence", "lift_r3a", "ckpt_5200.npz")
B = 8
EPISODE = 4
PROGRESS = [3, 0, 3, 1, 3, 2, 0, 3]  # envs 0, 2, 4 and 7 end in the step
REACHED = [1, 0, 0, 0, 0, 1, 0, 1]  # goal_reached_before going in
# tight limits and short queues, so that a short chain expands, shrinks and
# clips at both ends
CHAIN = dict(limit_lo=(0.9, 0.95, 0.6, -0.15), limit_hi=(1.1, 1.05, 1.6, 0.25),
             boundary_fraction=0.8, queue_len=2)
CHAIN_STEPS = 36  # 12 of successes, 12 of failures, 12 of one success in four
P = 4


def t(x):
    return torch.tensor(np.asarray(x))


def jax_draws(key, B: int) -> ta.AdrDraws:
    """The draws `adr_step(..., key)` and `init_adr_state(..., key)` make:
    their first key split twice for the boundary test and the mode, the
    second for the values."""
    k_mode, k_vals = jax.random.split(key)
    k1, k2 = jax.random.split(k_mode)
    return ta.AdrDraws(t(jax.random.uniform(k1, (B,))),
                       t(jax.random.randint(k2, (B,), 0, 2 * P)),
                       t(jax.random.uniform(k_vals, (B, P))))


def check_state(got: ta.AdrState, want, tag=""):
    """lo, hi, the queues and the modes exact; values within 1e-6."""
    for name, g, w in zip(ta.AdrState._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, (tag, name)
        if name == "values":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0, err_msg=f"{tag} {name}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{tag} {name}")


def to_jax(s: ta.AdrState):
    return ja.AdrState(*(jnp.asarray(x.numpy().astype(np.int32) if x.dtype == torch.int64
                                     else x.numpy()) for x in s))


@pytest.mark.parametrize("Bn", [16, 4])
def test_init_adr_state_matches(Bn):
    """`init_adr_state` from the JAX package's draws: ranges at init, empty
    queues, the same boundary workers (exact) and values (1e-6); the port's
    modes are int64."""
    cfg_j, cfg_t = ja.AdrConfig(enabled=True), ta.AdrConfig(enabled=True)
    key = jax.random.PRNGKey(Bn)
    got = ta.init_adr_state(cfg_t, Bn, draws=jax_draws(key, Bn))
    check_state(got, ja.init_adr_state(cfg_j, key, Bn))
    assert got.worker_mode.dtype == torch.int64 and bool((got.worker_mode >= 0).any())


def _events(states, cfg):
    """What a chain of states did: bounds moved out and in, a queue consumed
    while its bound stayed at its limit or at its initial value, and a
    queue consumed while another kept its samples."""
    lim = dict(lo=torch.tensor(cfg.limit_lo), hi=torch.tensor(cfg.limit_hi))
    init = dict(lo=torch.tensor(cfg.init_lo), hi=torch.tensor(cfg.init_hi))
    ev = dict(expand=False, shrink=False, clip_limit=False, clip_init=False, partial_clear=False)
    for a, b in zip(states, states[1:]):
        cleared = (a.q_cnt > 0) & (b.q_cnt == 0)
        kept = b.q_cnt >= a.q_cnt
        ev["expand"] |= bool(((b.lo < a.lo).any() | (b.hi > a.hi).any()))
        ev["shrink"] |= bool(((b.lo > a.lo).any() | (b.hi < a.hi).any()))
        ev["partial_clear"] |= bool(cleared.any() and (kept & (b.q_cnt > 0)).any())
        for side, k in (("lo", 0), ("hi", 1)):
            same = getattr(a, side) == getattr(b, side)
            c = cleared.reshape(P, 2)[:, k] & same
            ev["clip_limit"] |= bool((c & (getattr(b, side) == lim[side])).any())
            ev["clip_init"] |= bool((c & (getattr(b, side) == init[side])).any())
    return ev


@pytest.mark.parametrize("Bn", [16, 8, 4])
def test_adr_step_chain_matches(Bn):
    """36 chained `adr_step`s, every env done each step, objective 1 for 12
    steps, 0 for 12, then one success in four, from the same states and
    draws on both sides (objectives 0 or 1, so every queue sum is exact in
    any order): lo, hi, q_sum, q_cnt and worker_mode exact at every step,
    values within 1e-6. At B = 8 = 2P and B = 4 = P a queue or a range
    has the env axis's length: the env step must not merge them by done.
    The chain (at B = 16 all of it) expands and shrinks bounds, consumes a
    queue whose bound stays at its limit and one at its initial value, and
    clears a queue while another keeps its samples."""
    cfg_j, cfg_t = ja.AdrConfig(enabled=True, **CHAIN), ta.AdrConfig(enabled=True, **CHAIN)
    key = jax.random.PRNGKey(100 + Bn)
    sj = ja.init_adr_state(cfg_j, key, Bn)
    st = ta.init_adr_state(cfg_t, Bn, draws=jax_draws(key, Bn))
    rng = np.random.default_rng(Bn)
    done = np.ones(Bn, bool)
    states = [st]
    for i in range(CHAIN_STEPS):
        p = (1.0, 0.0, 0.25)[i // 12]
        obj = (rng.uniform(size=Bn) < p).astype(np.float32)
        k = jax.random.fold_in(key, i)
        sj = ja.adr_step(cfg_j, sj, jnp.asarray(done), jnp.asarray(obj), k)
        st = ta.adr_step(cfg_t, st, torch.as_tensor(done), torch.as_tensor(obj),
                         draws=jax_draws(k, Bn))
        check_state(st, sj, f"step {i}")
        states.append(st)
    ev = _events(states, cfg_t)
    assert ev["expand"] and ev["shrink"], ev
    if Bn == 16:
        assert all(ev.values()), ev


def test_adr_entropy_matches():
    """`adr_entropy`: the sum of log widths, a zero width floored at 1e-6;
    within 1e-5 (log of float32)."""
    s = ta.AdrState(torch.tensor([1.0, 0.9, 1.0, -0.2]), torch.tensor([1.0, 1.2, 1.3, 0.3]),
                    torch.zeros(2, dtype=torch.int64), torch.zeros(2, P), torch.zeros(8),
                    torch.zeros(8))
    want = float(ja.adr_entropy(to_jax(s)))
    got = float(ta.adr_entropy(s))
    assert abs(got - want) < 1e-5 and abs(want - (np.log(1e-6) + np.log(0.3 * 0.3 * 0.5))) < 1e-4


@pytest.mark.parametrize("Bn", [8, 4])
def test_env_step_replaces_adr_state_whole(Bn):
    """At B = 2P and B = P the port's env step gives the ADR state that
    the JAX package's `adr_step` gives from the pre-step state, the step's
    done flags and its pre-reset goal flags, with the same draws: exact
    (values within 1e-6). A merge of lo, hi or the queues by done would
    keep old entries there."""
    from handarm_tpu_torch.envs.hand_arm import StepDraws
    from handarm_tpu_torch.envs.tasks import make_env

    torch.set_num_threads(1)
    env = make_env("Ur5SihLift", device="cpu", num_envs=Bn, episode_length=EPISODE,
                   adr=ta.AdrConfig(enabled=True, queue_len=2))
    state, _ = env.reset(0)
    adr = state.task.adr._replace(
        lo=torch.tensor([0.9, 0.9, 0.9, -0.2]), hi=torch.tensor([1.1, 1.1, 1.1, 0.2]),
        worker_mode=torch.arange(Bn) % (2 * P),
        q_sum=torch.tensor([1.0, 0.0] * P), q_cnt=torch.ones(2 * P))
    task = state.task._replace(
        progress=torch.tensor(PROGRESS[:Bn]), adr=adr,
        goal_reached_before=torch.tensor(REACHED[:Bn], dtype=torch.bool))
    state = state._replace(task=task)
    key = jax.random.PRNGKey(7)
    post, res = env.step(state, torch.zeros(Bn, env.num_actions),
                         draws=StepDraws(adr=jax_draws(key, Bn)))
    done = np.asarray(PROGRESS[:Bn]) + 1 >= EPISODE
    np.testing.assert_array_equal(res.done.numpy(), done)
    want = ja.adr_step(ja.AdrConfig(enabled=True, queue_len=2), to_jax(adr), jnp.asarray(done),
                       jnp.asarray(REACHED[:Bn], jnp.float32), key)
    check_state(post.task.adr, want)
    assert bool((post.task.adr.q_cnt == 0).any()) and bool((post.task.adr.q_cnt > 0).any())


SHADOWHAND = dict(
    observation_noise={"amount": 0.002, "correlated": 0.001},
    action_noise={"amount": 0.05, "correlated": 0.015},
    mass_scale_range=(0.5, 1.5), friction_scale_range=(0.7, 1.3),
    gain_scale_range=(0.75, 1.5), gravity_noise=0.4)


def _jax_reference(out_dir: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    import dataclasses

    jax.config.update("jax_platforms", "cpu")
    from handarm_tpu.envs import randomization as jr
    from handarm_tpu.envs.hand_arm import HandArmEnv
    from handarm_tpu.envs.registry import make_env
    from handarm_tpu.robots.ur5sih import ASSET_ROOT
    from handarm_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
    from tests.test_torch_dr import dr_config

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    base, _ = make_env("Ur5SihLift", [f"num_envs={B}"])
    env = HandArmEnv(dataclasses.replace(
        base.cfg, episode_length=EPISODE, dr=dr_config(jr, **SHADOWHAND),
        adr=ja.AdrConfig(enabled=True)))
    state, _ = env.reset(jax.random.PRNGKey(5))
    cfg = env.cfg.adr
    lo = np.maximum(np.asarray(cfg.init_lo) - [0.1, 0.1, 0.08, 0.2], cfg.limit_lo)
    hi = np.minimum(np.asarray(cfg.init_hi) + [0.1, 0.1, 0.08, 0.2], cfg.limit_hi)
    u = np.random.default_rng(1).uniform(size=(B, P))
    f = lambda x: jnp.asarray(x, jnp.float32)
    adr = ja.AdrState(lo=f(lo), hi=f(hi), worker_mode=jnp.arange(B, dtype=jnp.int32),
                      values=f(lo + u * (hi - lo)), q_sum=f([255.0, 0.0] * P),
                      q_cnt=f([255.0] * 2 * P))
    state = state._replace(task=state.task._replace(
        progress=jnp.asarray(PROGRESS, state.task.progress.dtype),
        goal_reached_before=jnp.asarray(REACHED, bool), adr=adr))
    actions = np.random.default_rng(2).uniform(-1, 1, (B, env.num_actions))
    post, res = jax.jit(env.step)(state, jnp.asarray(actions, jnp.float32))
    # the step's key splits: (key, dist, reset, action noise); the fresh
    # DRState from fold_in(reset, 7) split 6 ways; on the merged key (key,
    # ADR), (key, observation key), (key, observation noise)
    key, _, k_reset, k_act = jax.random.split(state.task.key, 4)
    k = jax.random.split(jax.random.fold_in(k_reset, 7), 6)
    K, nv, A, O = env.cfg_num_objects, env.art.nv, env.num_actions, env.num_obs
    out = dict(actions=actions, done=np.asarray(res.done), obs=np.asarray(res.obs),
               act_std=np.asarray(jax.random.normal(k_act, (B, A))),
               dr_std_0=np.asarray(jax.random.uniform(k[0], (B, K))),
               dr_std_1=np.asarray(jax.random.uniform(k[1], (B,))),
               dr_std_2=np.asarray(jax.random.uniform(k[2], (B, nv))),
               dr_std_3=np.asarray(jax.random.normal(k[3], (B,))),
               dr_std_4=np.asarray(jax.random.normal(k[4], (B, O))),
               dr_std_5=np.asarray(jax.random.normal(k[5], (B, A))))
    key, k_adr = jax.random.split(key)
    for name, x in zip(ta.AdrDraws._fields, jax_draws(k_adr, B)):
        out[f"adr_{name}"] = x.numpy()
    key, _ = jax.random.split(key)
    _, k_obs = jax.random.split(key)
    out["obs_std"] = np.asarray(jax.random.normal(k_obs, (B, O)))
    for tag, st in (("pre", state), ("post", post)):
        for i, leaf in enumerate(jax.tree.leaves(st)):
            out[f"{tag}_{i}"] = np.asarray(leaf)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
    ts = load_checkpoint(CKPT)._replace(env_state=post, last_obs=res.obs)
    save_checkpoint(out_dir, ts, 1, sync=True)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("adr")
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1", **shared_jax_env(out),
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out / "ref.npz")), out


def _leaves(ref, tag):
    n = len([k for k in ref if k.startswith(tag + "_") and k[len(tag) + 1:].isdigit()])
    return [ref[f"{tag}_{i}"] for i in range(n)]


def _port_env():
    from handarm_tpu_torch.envs import randomization as tr
    from handarm_tpu_torch.envs.tasks import make_env
    from tests.test_torch_dr import dr_config

    return make_env("Ur5SihLift", device="cpu", num_envs=B, episode_length=EPISODE,
                    dr=dr_config(tr, **SHADOWHAND), adr=ta.AdrConfig(enabled=True))


def test_env_step_across_episode_boundary_matches(ref):
    """One Ur5SihLift step with ShadowHand's DR and ADR at B = 8 in which
    envs 0, 2, 4 and 7 end, from the same state with the same draws: done
    flags equal; the ADR state exact (values within 1e-6): the mass,
    friction and gain low bounds move out by delta, gravity's high bound in,
    the other queues keep their 255 samples; the DRState within 1e-6 (fresh
    draws where done); the physics and observations of the envs that did
    not reset at the lift test's bounds (2e-4 positions, 2e-3 velocities,
    impulses and observations)."""
    from handarm_tpu_torch.convert import env_state_from_leaves
    from handarm_tpu_torch.envs.hand_arm import StepDraws
    from handarm_tpu_torch.envs.randomization import DRState
    from tests.test_torch_dr import check_physics

    torch.set_num_threads(1)
    r, _ = ref
    env = _port_env()
    state = env_state_from_leaves(_leaves(r, "pre"), env_cfg=env.cfg)
    draws = StepDraws(
        act_noise=t(r["act_std"]), obs_noise=t(r["obs_std"]),
        dr=DRState(*(t(r[f"dr_std_{i}"]) for i in range(6))),
        adr=ta.AdrDraws(*(t(r[f"adr_{n}"]) for n in ta.AdrDraws._fields)))
    post, res = env.step(state, torch.as_tensor(r["actions"], dtype=torch.float32), draws=draws)
    done = r["done"]
    np.testing.assert_array_equal(res.done.numpy(), done)
    np.testing.assert_array_equal(done, np.asarray(PROGRESS) + 1 >= EPISODE)
    want = _leaves(r, "post")
    check_state(post.task.adr, want[25:31])
    pre = state.task.adr
    np.testing.assert_allclose((pre.lo - post.task.adr.lo).numpy(), [0.05, 0.05, 0.04, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose((pre.hi - post.task.adr.hi).numpy(), [0, 0, 0, 0.1], atol=1e-6)
    np.testing.assert_array_equal(post.task.adr.q_cnt.numpy(), [0, 255, 0, 255, 0, 255, 255, 0])
    for i, (name, g) in enumerate(zip(DRState._fields, post.task.dr)):
        np.testing.assert_allclose(g.numpy(), want[19 + i], atol=1e-6, rtol=0, err_msg=name)
    keep = ~done
    check_physics(post.physics, want, keep)
    np.testing.assert_allclose(res.obs.numpy()[keep], r["obs"][keep], atol=2e-3)


def test_port_reads_jax_dr_adr_checkpoint(ref):
    """A TrainState with the DR + ADR env state at B = 8, written by the JAX
    package's `save_checkpoint`, read by the port given the env's config:
    36 env leaves, 83 in all; the DRState float32, the AdrState's lo, hi,
    values and queues float32 and its worker_mode int32 in the file (int64
    in the port), every leaf equal to the step's. A reader given a config
    without DR or without ADR refuses it."""
    from handarm_tpu_torch.convert import env_leaf_count
    from handarm_tpu_torch.utils.checkpoint import file_env_leaves, load_train_state, read_leaves

    r, out = ref
    path = str(out / "ckpt_1.npz")
    env_cfg = _port_env().cfg
    file_leaves = read_leaves(path)
    assert len(file_leaves) == 83 and file_env_leaves(path) == env_leaf_count(env_cfg) == 36
    env_leaves = file_leaves[44:80]
    assert [x.dtype for x in env_leaves[19:31]] == [np.float32] * 6 + [
        np.float32, np.float32, np.int32, np.float32, np.float32, np.float32]
    ts = load_train_state(path, env_cfg=env_cfg)
    want = _leaves(r, "post")
    for name, g, w in zip(ta.AdrState._fields, ts.env_state.task.adr, want[25:31]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert ts.env_state.task.adr.worker_mode.dtype == torch.int64
    for g, w in zip(ts.env_state.task.dr, want[19:25]):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(ts.env_state.metrics.success_ewma.numpy(), want[31])
    import dataclasses

    for other in (dataclasses.replace(env_cfg, dr=type(env_cfg.dr)()),
                  dataclasses.replace(env_cfg, adr=ta.AdrConfig()), None):
        with pytest.raises(ValueError, match="env state"):
            load_train_state(path, env_cfg=other)


def test_jax_loader_reads_port_dr_adr_checkpoint(ref, tmp_path):
    """The port writes that TrainState back (given the env's config): the
    JAX package's `load_checkpoint(path, example_tree=<its own file>)`
    loads it, every leaf equal to the JAX file's in value and dtype, but
    the PRNG keys (the port writes its seed's). A writer given a config
    without ADR refuses the state."""
    import dataclasses

    from handarm_tpu.utils.checkpoint import load_checkpoint
    from handarm_tpu_torch.utils import checkpoint as tck

    _, out = ref
    jpath = str(out / "ckpt_1.npz")
    env_cfg = _port_env().cfg
    ts = tck.load_train_state(jpath, env_cfg=env_cfg)
    path = tck.save_checkpoint(str(tmp_path), ts, 2, sync=True, env_cfg=env_cfg)
    jts = load_checkpoint(jpath)
    loaded = load_checkpoint(path, example_tree=jts)
    got, want = jax.tree.leaves(loaded), jax.tree.leaves(jts)
    assert len(got) == len(want) == 83
    keys = {61, 69 + 12}  # the env state's and the TrainState's PRNG keys
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.asarray(g).dtype == np.asarray(w).dtype, i
        if i not in keys:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(i))
    with pytest.raises(ValueError, match="DR and ADR"):
        tck.save_checkpoint(str(tmp_path), ts, 3, sync=True,
                            env_cfg=dataclasses.replace(env_cfg, adr=ta.AdrConfig()))


def test_dr_less_file_resumed_into_dr_run_keeps_learner(tmp_path, monkeypatch, capsys):
    """The train entry point on a full-config task yaml (one box on the
    table, 4 envs, CPU): 1 iteration without DR, then resumed from that
    file with DR and ADR on: the file's env state (24 leaves) is not the
    run's (36), so only its learner is kept and the env is reset fresh
    (the JAX loader cannot read such a file into the DR run's tree); the
    run writes a 36-leaf env state, epoch 2, and its params start from the
    file's."""
    from handarm_tpu_torch import train
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.utils.checkpoint import file_env_leaves, load_train_state

    torch.set_num_threads(1)
    monkeypatch.chdir(tmp_path)
    task = tmp_path / "tiny.yaml"
    task.write_text("env:\n  num_envs: 4\nsim:\n  solver_iterations: 4\n"
                    "rl:\n  reset:\n    max_episode_length: 8\n")
    common = [f"task={task}", "device=cpu", "experiment=dr", "ppo.minibatch_size=64",
              "ppo.hidden=[32,32]"]
    train.main(common + ["max_iterations=1"])
    first = tmp_path / "runs" / "dr" / "nn" / "ckpt_1.npz"
    assert file_env_leaves(str(first)) == 24
    dr = ["rl.randomization_params.dr.gravity_noise=0.4",
          "rl.randomization_params.dr.mass_scale_range=[0.5,1.5]",
          "rl.randomization_params.adr.enabled=true"]
    capsys.readouterr()
    train.main(common + dr + [f"resume={first}", "max_iterations=2"])
    assert "the env is reset fresh" in capsys.readouterr().out
    second = tmp_path / "runs" / "dr" / "nn" / "ckpt_2.npz"
    assert file_env_leaves(str(second)) == 36
    env_cfg, _ = resolve_task(str(task), dr)
    ts = load_train_state(str(second), env_cfg=env_cfg)
    assert int(ts.epoch) == 2 and ts.env_state.task.adr is not None
    assert float(ts.env_state.task.dr.gravity_z.abs().max()) > 0
    with pytest.raises(ValueError, match="env state"):
        load_train_state(str(first), env_cfg=env_cfg)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
