"""The port's population-based training and its launcher (parallel/pbt.py,
parallel/launch_pbt.py, the train entry point's `pbt.*` keys), as
tests/test_learn.py tests the JAX package's, and the workspace both ways:
a workspace the JAX package wrote is read by the port's `pbt_step`, and the
reverse. Learners are the stand-in lift scene's at 8 envs on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from handarm_tpu.parallel import pbt as jpbt
from handarm_tpu.utils.checkpoint import latest_checkpoint as jax_latest
from handarm_tpu.utils.checkpoint import load_checkpoint
from handarm_tpu_torch import train as ttrain
from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv
from handarm_tpu_torch.learn.networks import flax_names
from handarm_tpu_torch.learn.ppo import PPO, PPOConfig
from handarm_tpu_torch.parallel import launch_pbt
from handarm_tpu_torch.parallel.pbt import (
    PbtConfig,
    load_population,
    maybe_save_best_policy,
    pbt_step,
    save_pbt_checkpoint,
)
from handarm_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "evidence", "lift_r3a", "ckpt_5200.npz")
SMALL = PPOConfig(horizon=4, minibatch_size=16, mini_epochs=2, hidden=(32, 32))


@pytest.fixture(scope="module")
def tiny_ppo():
    """tests/test_learn.py's tiny env on the port: 8 envs, 6-step episodes,
    the arm's relative joint action, 4 solver sweeps."""
    cfg = HandArmConfig(
        num_envs=8, episode_length=6,
        observations=("ur5_joint_pos", "target_object_pos", "dof_position_targets"),
        actions=("ur5_relative_joint_pos",), solver_iterations=4)
    return PPO(HandArmEnv(cfg, "cpu"), SMALL)


def test_pbt_exchange(tiny_ppo, tmp_path):
    """Four policies checkpoint once; the three healthy ones keep their
    weights, and policy 0, far behind, adopts one of the two best peers'
    params (tests/test_learn.py test_pbt_exchange)."""
    rng = np.random.default_rng(0)
    states = [tiny_ppo.init(10 + i) for i in range(4)]
    hp = {"learning_rate": 3e-4, "e_clip": 0.15}
    objectives = [0.1, 0.9, 0.88, 0.87]
    cfgs = [PbtConfig(workspace=str(tmp_path), policy_idx=i, num_policies=4, frames_slack=0.5)
            for i in range(4)]
    kw = dict(rng=rng, ppo_cfg=SMALL, env_cfg=tiny_ppo.env.cfg)
    for i in (1, 2, 3):
        _, _, restarted = pbt_step(cfgs[i], states[i], hp, 1000, objectives[i], **kw)
        assert not restarted
    new_state, new_hp, restarted = pbt_step(cfgs[0], states[0], hp, 1000, objectives[0], **kw)
    assert restarted and set(new_hp) == set(hp)
    donor = [i for i in (1, 2) if all(torch.equal(new_state.params[k], states[i].params[k])
                                      for k in new_state.params)]
    assert len(donor) == 1  # a best peer's params, and its whole state
    assert torch.equal(new_state.env_state.physics.robot.q,
                       states[donor[0]].env_state.physics.robot.q)
    assert all(m is not None for m in load_population(cfgs[0]))


def test_pbt_launcher_and_best_archive(tiny_ppo, tmp_path):
    """The process launcher and grid (reference pbt/launcher/run_processes.py)
    and the best-policy archive (pbt.py:564-610)."""
    cmds = launch_pbt.experiment_grid([sys.executable, "-c", "pass"],
                                      {"seed": [1, 2], "lr": [0.1]})
    assert len(cmds) == 2 and cmds[0][-2:] == ["seed=1", "lr=0.1"]
    assert launch_pbt.run_processes(cmds, max_parallel=2, poll_s=0.05) == [0, 0]
    cfg = PbtConfig(workspace=str(tmp_path), policy_idx=1)
    ts = tiny_ppo.init(3)
    kw = dict(ppo_cfg=SMALL, env_cfg=tiny_ppo.env.cfg)
    assert maybe_save_best_policy(cfg, ts, objective=0.5, frames=100, **kw)
    assert not maybe_save_best_policy(cfg, ts, objective=0.4, frames=200, **kw)
    assert maybe_save_best_policy(cfg, ts, objective=0.9, frames=300, **kw)
    best = tmp_path / "best"
    metas = sorted(f.name for f in best.iterdir() if f.suffix == ".json")
    assert len(metas) == 2
    meta = json.loads((best / metas[-1]).read_text())
    back = tck.load_train_state(str(best / meta["checkpoint"]), cfg=SMALL,
                                env_cfg=tiny_ppo.env.cfg)
    assert all(torch.equal(back.params[k], ts.params[k]) for k in ts.params)


def test_pbt_slurm_ngc_backends(tmp_path):
    """sbatch scripts and command lines, print-only by default, one GPU per
    job and no TPU; the NGC template substitution as the reference's."""
    cmds = launch_pbt.experiment_grid(
        ["python", "-m", "handarm_tpu_torch.train", "task=Ur5SihLift"], {"seed": [1, 2]})
    jobs = launch_pbt.emit_slurm(cmds, str(tmp_path / "slurm"), partition="gpu",
                                 timeout="12:00:00")
    assert len(jobs) == 2
    for script, cmdline in jobs:
        body = open(script).read()
        assert body.startswith("#!/bin/bash") and "handarm_tpu_torch.train" in body
        assert "--gres=gpu:1" in cmdline and "--gres=tpu" not in cmdline
        assert "-p gpu" in cmdline and "--time 12:00:00" in cmdline
        assert cmdline.startswith("sbatch")
    tmpl = "ngc batch run --name {{ name }} \\\n  --command '{{ experiment_cmd }}'"
    lines = launch_pbt.emit_ngc(cmds, tmpl, names=["a", "b"])
    assert "--name a" in lines[0] and "seed=2" in lines[1] and "\\" not in lines[0]
    assert launch_pbt.main(["--backend", "slurm", "--workdir", str(tmp_path / "w"),
                            "--num-policies", "2", "--", "echo", "{policy_idx}"]) == 0


def test_pbt_restart_argv_rebuild():
    """The restart's argv: stale mutable overrides and resume= replaced,
    everything else kept (tests/test_learn.py's case on the port's train)."""
    argv = ["task=Ur5SihLift", "experiment=p0", "ppo.learning_rate=3e-4",
            "pbt.policy_idx=0", "pbt.num_policies=4", "resume=auto", "seed=5"]
    new = ttrain.pbt_restart_argv(argv, {"learning_rate": 0.001, "e_clip": 0.2})
    assert "ppo.learning_rate=0.001" in new and "ppo.e_clip=0.2" in new
    assert "ppo.learning_rate=3e-4" not in new
    assert new.count("resume=auto") == 1
    assert "pbt.policy_idx=0" in new and "seed=5" in new


def _shift(jax_ts, d):
    return jax_ts._replace(params=jax.tree.map(lambda x: x + d, jax_ts.params))


def test_workspace_both_ways(tmp_path):
    """ckpt_5200's TrainState in both packages, params shifted apart. A JAX
    workspace (policy 1 at objective 0.9, its `meta.json` and `pbt_1000.npz`)
    is read by the port's pbt_step for policy 0 at 0.1: it restarts from
    the JAX file, params as the JAX policy's, hyperparameters from its meta.
    The reverse: the port writes policy 1, the JAX package's pbt_step for
    policy 0 adopts the port's params. Both packages' `meta.json` have the
    same keys in the same order."""
    jax_ts = load_checkpoint(CKPT)
    port_ts = tck.load_train_state(CKPT)
    hp = {"learning_rate": 3e-4, "e_clip": 0.15}
    names = flax_names(3)

    def port_params_of(jts):
        return {t: np.asarray(w).T if f.endswith(".kernel") else np.asarray(w)
                for (f, t), w in zip(names, jax.tree.leaves(jts.params))}

    ws = tmp_path / "jax_written"
    donor = _shift(jax_ts, 0.25)
    jpbt.save_pbt_checkpoint(jpbt.PbtConfig(workspace=str(ws), policy_idx=1, num_policies=2),
                             donor, hp, 1000, 0.9)
    jax_latest(str(ws / "policy_01"), "pbt")  # joins the JAX package's writer
    cfg0 = PbtConfig(workspace=str(ws), policy_idx=0, num_policies=2)
    new, new_hp, restarted = pbt_step(cfg0, port_ts, hp, 1000, 0.1,
                                      rng=np.random.default_rng(1))
    assert restarted and set(new_hp) == set(hp)
    for k, w in port_params_of(donor).items():
        np.testing.assert_array_equal(new.params[k].numpy(), w, err_msg=k)
    jmeta = json.loads((ws / "policy_01" / "meta.json").read_text())
    pmeta = json.loads((ws / "policy_00" / "meta.json").read_text())
    assert list(jmeta) == list(pmeta)
    assert (jmeta["checkpoint"], pmeta["checkpoint"]) == ("pbt_1000.npz", "pbt_1000.npz")

    ws = tmp_path / "port_written"
    shifted = port_ts._replace(params={k: v - 0.5 for k, v in port_ts.params.items()})
    save_pbt_checkpoint(PbtConfig(workspace=str(ws), policy_idx=1, num_policies=2), shifted,
                        hp, 1000, 0.9)
    jnew, jhp, restarted = jpbt.pbt_step(
        jpbt.PbtConfig(workspace=str(ws), policy_idx=0, num_policies=2), jax_ts, hp, 1000,
        0.1, example_tree=jax_ts, rng=np.random.default_rng(1))
    assert restarted and set(jhp) == set(hp)
    for k, w in port_params_of(jnew).items():
        np.testing.assert_array_equal(w, shifted.params[k].numpy(), err_msg=k)


def test_train_entry_point_pbt_restart(tmp_path):
    """Two Ur5SihReach policies (8 envs, CPU) in one workspace, exchanging
    every iteration's frames on `pbt.objective=total_env_steps`: policy 1
    runs 3 iterations first; policy 0 then finds itself worst after its
    first iteration, prints its restart, writes the donor's state as
    ckpt_1.npz and `os.execv`s itself, which resumes that file under the
    mutated hyperparameters (every one mutated: mutation_rate 1) and exits
    0; its config.json holds them; ckpt_1's params are the donor's."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    ws = tmp_path / "ws"
    common = ["task=Ur5SihReach", "num_envs=8", "device=cpu", "max_iterations=3",
              f"pbt.workspace={ws}", "pbt.num_policies=2", "pbt.interval_steps=128",
              "pbt.objective=total_env_steps", "pbt.replace_threshold_abs=0",
              "pbt.replace_threshold_rel=0", "pbt.mutation_rate=1"]
    run = lambda *a: subprocess.run([sys.executable, "-m", "handarm_tpu_torch.train",
                                     *common, *a], cwd=tmp_path, env=env, capture_output=True,
                                    text=True, timeout=300)
    p1 = run("experiment=p1", "pbt.policy_idx=1", "seed=2")
    assert p1.returncode == 0, p1.stdout[-2000:] + p1.stderr[-2000:]
    assert "[pbt]" not in p1.stdout
    p0 = run("experiment=p0", "pbt.policy_idx=0", "seed=3")
    assert p0.returncode == 0, p0.stdout[-2000:] + p0.stderr[-2000:]
    assert "[pbt] policy 0 restarts from donor at iter 1" in p0.stdout
    assert "resumed from runs/p0/nn/ckpt_1.npz at iter 1\n" in p0.stdout
    meta = json.loads((ws / "policy_01" / "meta.json").read_text())
    donor = tck.read_leaves(str(ws / "policy_01" / meta["checkpoint"]))
    adopted = tck.read_leaves(str(tmp_path / "runs" / "p0" / "nn" / "ckpt_1.npz"))
    for i in range(11):
        np.testing.assert_array_equal(adopted[i], donor[i])
    cfg = json.loads((tmp_path / "runs" / "p0" / "config.json").read_text())
    for k in PbtConfig().mutable:
        assert cfg["ppo"][k] == float(cfg["cli_overrides"][f"ppo.{k}"])
        if meta["hparams"][k]:  # a zero (entropy_coef) stays zero
            assert cfg["ppo"][k] != meta["hparams"][k], k
    assert (tmp_path / "runs" / "p0" / "nn" / "ckpt_3.npz").exists()
