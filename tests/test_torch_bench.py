"""The port's benchmark entry (`python -m handarm_tpu_torch.bench`), its
flagship forward step (`graft_entry.entry`) and its phase timer and trace
(`utils/profiling.py`) against the repository's bench.py,
__graft_entry__.py and the JAX package's profiling module.

- bench: subprocesses on the CPU at 8 envs (random actions, ckpt_5200's
  policy, and the multi-object preset with genesis shortened to 10 + 10
  sim steps) print only JSON lines with the keys bench.py's `emit` prints;
  the order of the 1,024-env line and the headline, and the insurance
  run's fault being logged while the headline's propagates, with the
  measurement replaced by a stub.
- graft_entry: the JAX package's `entry()` runs in a subprocess with
  HANDARM_ASSET_ROOT at the in-repo stand-in; its TrainState (flax-default
  params, fresh stats, the reset env state) is written with the package's
  `save_checkpoint` and read by the port's loader, and the port's
  forward step from that state is held against the JAX one at
  tests/test_torch_lift.py's env-step bounds.
- PhaseTimer: the same phases under a scripted clock give both packages'
  means and counts; `trace` writes a trace holding an `annotate` range.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shared_jax_cache import shared_jax_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = os.path.join(REPO, "handarm_tpu_torch", "assets", "ur5sih_standin")
CKPT = os.path.join(REPO, "docs", "evidence", "lift_r3a", "ckpt_5200.npz")


def _jax_bench():
    """The repository's bench.py, loaded by path (it imports no JAX at
    module level)."""
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_keys(capsys, scene: str) -> list:
    capsys.readouterr()
    _jax_bench().emit(1.0, 8, scene)
    return list(json.loads(capsys.readouterr().out))


BENCH_RUNS = {
    "lift": ([], "lift"),
    "lift policy": (["--policy", CKPT], "lift"),
    "multiobj": (["--scene", "multiobj", "--override", "drop_num_steps=10",
                  "--override", "settle_num_steps=10"], "multiobj"),
}


@pytest.mark.parametrize("case", sorted(BENCH_RUNS))
def test_bench_prints_json_lines(case, capsys):
    """`--device cpu --envs 8 --steps 2 --warmup 1`: stdout holds only the
    headline JSON line (8 envs: no 1,024-env line), with bench.py's keys
    in its order and a positive rate; progress goes to stderr."""
    args, scene = BENCH_RUNS[case]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "handarm_tpu_torch.bench", "--device", "cpu",
                          "--envs", "8", "--steps", "2", "--warmup", "1"] + args,
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[-1])
    assert list(rec) == _jax_keys(capsys, scene)
    assert rec["metric"] == "env_steps_per_s" and rec["unit"] == "env-steps/s"
    assert rec["envs"] == 8 and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 1e6, 4)
    assert rec.get("scene", "lift") == scene
    assert "[bench] envs=8" in res.stderr


def test_bench_insurance_line_first_and_faults(monkeypatch, capsys):
    """With more than 1,024 envs the 1,024-env line comes first and the
    headline last; a fault of the 1,024-env run is logged and the headline
    still printed; a fault of the headline run propagates. The
    measurement is a stub here (its arguments are checked)."""
    from handarm_tpu_torch import bench

    calls = []

    def fake(envs, steps, warmup, scene, policy, overrides, device):
        calls.append((envs, steps, warmup, scene, policy, list(overrides), device.type))
        if envs in fail:
            raise RuntimeError(f"stub fault at {envs}")
        return 1000.0 * envs

    monkeypatch.setattr(bench, "measure", fake)
    fail = ()
    bench.main(["--device", "cpu", "--envs", "2048", "--steps", "30"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["envs"] for r in out] == [1024, 2048]
    assert calls == [(1024, 15, 2, "lift", None, [], "cpu"), (2048, 30, 2, "lift", None, [], "cpu")]
    fail = (1024,)
    bench.main(["--device", "cpu", "--envs", "2048", "--scene", "multiobj",
                "--override", "solver_iterations=4"])
    cap = capsys.readouterr()
    assert [json.loads(x)["envs"] for x in cap.out.splitlines()] == [2048]
    assert "small-shape run failed" in cap.err and "stub fault at 1024" in cap.err
    fail = (2048,)
    with pytest.raises(RuntimeError, match="2048"):
        bench.main(["--device", "cpu", "--envs", "2048", "--skip-small"])
    assert capsys.readouterr().out == ""


def _jax_entry(out_dir: str) -> None:
    """Runs in the subprocess (see the module docstring)."""
    sys.path.insert(0, REPO)
    import inspect

    import jax

    jax.config.update("jax_platforms", "cpu")
    import __graft_entry__ as graft

    from handarm_tpu.robots.ur5sih import ASSET_ROOT
    from handarm_tpu.utils.checkpoint import save_checkpoint

    assert os.path.samefile(ASSET_ROOT, STANDIN), ASSET_ROOT
    forward_step, (env_state, obs) = graft.entry()
    ts = inspect.getclosurevars(forward_step).nonlocals["ts"]
    save_checkpoint(out_dir, ts, 0, sync=True)
    state, new_obs, reward, done = jax.jit(forward_step)(env_state, obs)
    out = dict(obs=np.asarray(new_obs), reward=np.asarray(reward), done=np.asarray(done),
               start_obs=np.asarray(obs))
    for i, leaf in enumerate(jax.tree.leaves(state)):
        out[f"post_{i}"] = np.asarray(leaf)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)


@pytest.fixture(scope="module")
def entry_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graft_entry")
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, JAX_PLATFORMS="cpu",
               HANDARM_DISABLE_GENESIS="1", **shared_jax_env(tmp))
    res = subprocess.run([sys.executable, __file__, str(tmp)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return tmp, dict(np.load(tmp / "ref.npz"))


def test_graft_entry_forward_step_matches(entry_ref):
    """The port's workload is the JAX entry's (64 envs, 121 observations,
    11 actions, 25-step episodes, 8 sweeps, PPO horizon 4 / minibatch 128 /
    one mini-epoch); its forward step from the JAX entry's TrainState,
    read by the port's loader: done and reward (within 2e-3) of every env;
    in the envs the step did not reset, q and object positions within
    2e-4, velocities and observations 2e-3. `entry`
    itself returns a forward step and a state of that shape."""
    torch.set_num_threads(1)
    from handarm_tpu_torch import graft_entry
    from handarm_tpu_torch.utils.checkpoint import load_train_state

    tmp, ref = entry_ref
    env, ppo, ts = graft_entry.build(device="cpu")
    assert (env.cfg.num_envs, env.num_obs, env.num_actions) == (64, 121, 11)
    assert (env.cfg.episode_length, env.cfg.solver_iterations) == (25, 8)
    assert (ppo.cfg.horizon, ppo.cfg.minibatch_size, ppo.cfg.mini_epochs) == (4, 128, 1)
    jts = load_train_state(str(tmp / "ckpt_0.npz"))
    np.testing.assert_array_equal(jts.last_obs.numpy(), ref["start_obs"])
    step = graft_entry.make_forward_step(env, ppo, jts)
    state, obs, reward, done = step(jts.env_state, jts.last_obs)
    np.testing.assert_array_equal(done.numpy(), ref["done"])
    kept = ~ref["done"]  # an env that ended was reset from each package's own draws
    print(f"envs reset by the step: {np.flatnonzero(ref['done']).tolist()}")
    assert kept.sum() >= 60
    want = [ref[f"post_{i}"] for i in range(8)]
    got = state.physics
    for name, g, w, tol in (("q", got.robot.q, want[0], 2e-4), ("qd", got.robot.qd, want[1], 2e-3),
                            ("obj pos", got.objects.pos, want[3], 2e-4),
                            ("obj linvel", got.objects.linvel, want[5], 2e-3)):
        np.testing.assert_allclose(g.numpy()[kept], w[kept], atol=tol, err_msg=name)
    np.testing.assert_allclose(obs.numpy()[kept], ref["obs"][kept], atol=2e-3)
    np.testing.assert_allclose(reward.numpy(), ref["reward"], atol=2e-3, rtol=1e-4)
    fs, (st0, obs0) = graft_entry.entry(device="cpu")
    _, obs1, r1, d1 = fs(st0, obs0)
    assert obs1.shape == (64, 121) and r1.shape == d1.shape == (64,)


def test_phase_timer_matches(monkeypatch):
    """The same phases under a scripted clock: equal means and counts in
    both packages, and the same report."""
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    from handarm_tpu.utils.profiling import PhaseTimer as JaxTimer

    from handarm_tpu_torch.utils.profiling import PhaseTimer

    def drive(timer, ticks):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        for name in ("rollout", "update", "rollout"):
            with timer.phase(name, sync_result=torch.zeros(2)):
                pass
        return timer

    ticks = [0.0, 0.25, 1.0, 1.75, 2.0, 2.5]
    got = drive(PhaseTimer(), ticks)
    want = drive(JaxTimer(), ticks)
    assert dict(got.counts) == dict(want.counts) == {"rollout": 2, "update": 1}
    assert got.means_ms() == pytest.approx(want.means_ms())
    assert got.means_ms() == pytest.approx({"rollout": 375.0, "update": 750.0})
    assert got.report() == want.report()
    got.reset()
    assert got.means_ms() == {}


def test_trace_writes_annotated_trace(tmp_path):
    """`trace` writes a Chrome trace holding the `annotate` range."""
    from handarm_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)):
        with annotate("camera_render"):
            torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "camera_render" for e in events)


if __name__ == "__main__":
    _jax_entry(sys.argv[1])
