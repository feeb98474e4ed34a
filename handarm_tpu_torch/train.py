"""Training entry point of the port (counterpart of the root `train.py`):

    python -m handarm_tpu_torch.train [task=Ur5SihLift] [max_iterations=1000]
        [seed=42] [experiment=NAME] [resume=auto|PATH] [save_every=100]
        [device=cpu] [dist_backend=nccl|gloo] [pbt.KEY=VALUE ...] [OVERRIDE ...]

The task is composed as the root `train.py` composes it (`envs/registry.py`
`compose_task`): its yaml config group under `configs/`, or a yaml path
given as `task=`. Every other `key=value` is an override of that
composition: `env.<field>=`, `<field>=`, `rl.<key>=`, `sim.<key>=` and
`ppo.<field>=` (values parse as yaml: `ppo.hidden=[256,128,64]`). A
full-config yaml (Ur5SihMultiObjectManipulation) takes dotted yaml keys
only, so its env count is `env.num_envs=N`; a preset-backed yaml (Ur5SihLift,
the family, Ur5SihReach) also takes a bare `num_envs=N`. An unknown key
raises.

The run writes `runs/<experiment>/` (relative to the working directory):
`config.json` (the task, the overrides, the resolved env config and PPO
overrides), `metrics.jsonl` (and TensorBoard scalars when tensorboardX
imports), and checkpoints in `nn/`: `ckpt_<i>.npz` every `save_every`
iterations, `best_0.npz` when the reward improves (after iteration 50, at
most every 25 iterations), and `ckpt_<max_iterations>.npz` at the end. The
checkpoint named step i holds the learner after exactly i iterations.

`resume=auto` continues from the newest periodic checkpoint of the
experiment, `resume=PATH` from any PPO checkpoint in the JAX package's
format of the run's learner (for example docs/evidence/lift_r3a/ckpt_5200.npz
for the MLP). As the root `train.py` resumes, the whole TrainState is
restored: params, optimizer state, running stats, lr, epoch, and the env
state, last observations, last teacher observations and LSTM carry the
run stopped at (the env's random draws restart from `seed`); a file whose
env count is not the run's, or whose env state was saved with other
domain randomization or ADR settings (a file without DR resumed into a DR
run), keeps only its learner, and the env is reset fresh. The JAX
package's loader cannot do the last: it reads a file only into a tree of
the same layout. A file whose contact-slot count is not the run's (a
hand-only collision set resumed into an arm-sphere run) raises
ValueError, as the JAX package's first step on such a state does. The
iteration count starts at the file's step.

The classic tasks Quadcopter, Ingenuity, Cartpole, Ant, Humanoid,
BallBalance, Anymal, AnymalTerrain, FrankaCubeStack, FrankaCabinet,
Trifinger, AllegroHand, ShadowHand, ShadowHandOpenAI_FF,
ShadowHandOpenAI_LSTM, AllegroHandDextremeADR, AllegroHandADR,
AllegroHandManualDR, AllegroKukaReorientation, AllegroKukaRegrasping,
AllegroKukaThrow, AllegroKuka, AllegroKukaTwoArmsReorientation,
AllegroKukaTwoArmsRegrasping, AllegroKukaTwoArms, the Factory tasks
(FactoryTaskNutBoltPick, FactoryTaskNutBoltPlace, FactoryTaskNutBoltScrew,
FactoryTaskGears, FactoryTaskInsertion) and IndustRealTaskPegsInsert (its
asymmetric critic on the 47-dim state) compose the same way
(their task yamls' `env` block and train yamls' `ppo` block;
`env.num_envs=N` or `num_envs=N`, and any field of the task's config
dataclass: QuadcopterConfig, IngenuityConfig, ClassicConfig,
LocomotionConfig, BallBalanceConfig, AnymalConfig, AnymalTerrainConfig,
FrankaCubeStackConfig, FrankaCabinetConfig, TrifingerConfig,
DexHandConfig, ShadowHandConfig, DextremeConfig, AllegroKukaConfig,
AllegroKukaTwoArmsConfig; `AllegroKuka` and `AllegroKukaTwoArms` take
`env.subtask=` reorientation, regrasping or throw and no other field;
the Factory and IndustReal tasks keep `num_envs` and `episode_length`
and drop every other env key, as the JAX package's factories do):

    python -m handarm_tpu_torch.train task=Quadcopter env.num_envs=8192
    python -m handarm_tpu_torch.train task=Ingenuity env.num_envs=4096
    python -m handarm_tpu_torch.train task=Ant env.num_envs=4096
    python -m handarm_tpu_torch.train task=Humanoid env.num_envs=4096
    python -m handarm_tpu_torch.train task=Cartpole env.num_envs=512
    python -m handarm_tpu_torch.train task=BallBalance env.num_envs=4096
    python -m handarm_tpu_torch.train task=Anymal env.num_envs=4096
    python -m handarm_tpu_torch.train task=AnymalTerrain env.num_envs=4096
    python -m handarm_tpu_torch.train task=FrankaCubeStack env.num_envs=8192
    python -m handarm_tpu_torch.train task=FrankaCabinet env.num_envs=4096
    python -m handarm_tpu_torch.train task=Trifinger env.num_envs=16384
    python -m handarm_tpu_torch.train task=AllegroHand env.num_envs=16384
    python -m handarm_tpu_torch.train task=ShadowHand env.num_envs=16384
    python -m handarm_tpu_torch.train task=ShadowHandOpenAI_FF env.num_envs=16384
    python -m handarm_tpu_torch.train task=ShadowHandOpenAI_LSTM env.num_envs=8192
    python -m handarm_tpu_torch.train task=AllegroHandDextremeADR env.num_envs=8192
    python -m handarm_tpu_torch.train task=AllegroHandManualDR env.num_envs=8192
    python -m handarm_tpu_torch.train task=AllegroKukaReorientation env.num_envs=8192
    python -m handarm_tpu_torch.train task=AllegroKuka env.subtask=regrasping env.num_envs=8192
    python -m handarm_tpu_torch.train task=AllegroKukaTwoArms env.subtask=regrasping env.num_envs=8192
    python -m handarm_tpu_torch.train task=FactoryTaskNutBoltPick env.num_envs=512
    python -m handarm_tpu_torch.train task=FactoryTaskNutBoltScrew env.num_envs=512
    python -m handarm_tpu_torch.train task=IndustRealTaskPegsInsert env.num_envs=512

Cartpole, the Ant, the Humanoid, BallBalance, the ANYmal tasks, the
Franka tasks, Trifinger, the hands, DeXtreme and AllegroKuka (a KUKA iiwa 7
with an Allegro hand; two of them facing each other in the two-arm tasks)
run on the in-repo stand-in assets
(`assets/classic_standin/`), the Factory and IndustReal tasks on the
stand-in Franka with the reference's parts as tracked SDF records
(`.sdf_cache/`, `envs/objects.py` `PART_RECORD_KEYS`); `urdf=PATH`
(Cartpole) and `mjcf=PATH` (Ant) take others. Their stats carry no success rate (`succ` prints 0).
The JAX package's other classic tasks (HumanoidAMP,
IndustRealTaskGearsInsert) raise NotImplementedError (ROADMAP §1.7).

Domain randomization and ADR come through the composition as well, as
`rl.randomization_params.dr.<key>=` and `rl.randomization_params.adr.<key>=`
overrides of a full-config yaml; `envs.tasks.DR_SHADOWHAND` lists
IsaacGymEnvs' ShadowHand randomization in that form:

    python -m handarm_tpu_torch.train task=Ur5SihMultiObjectManipulation
        env.num_envs=8192 <DR_SHADOWHAND> [rl.randomization_params.adr.enabled=true]

The recurrent and asymmetric learners compose from `ppo.` overrides, as
ShadowHandOpenAI_LSTM's on Ur5SihLift (the observables are listed in
`envs.tasks.LSTM_LIFT`):

    python -m handarm_tpu_torch.train task=Ur5SihLift num_envs=8192
        observations='[<the actor's observables>]'
        teacher_observations='[<the critic's observables>]'
        ppo.asymmetric_critic=true ppo.rnn_units=1024 ppo.critic_rnn_units=1024
        ppo.hidden='[512]' ppo.seq_len=4 ppo.minibatch_size=32768 ppo.gamma=0.998

Stats are read back one iteration behind, in one host transfer, after the
next iteration has been queued, so no iteration waits on a host read. It
runs on `cuda` unless given `device=cpu`.

Data parallel under torchrun, one process per rank:

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m handarm_tpu_torch.train task=Ur5SihLift env.num_envs=8192 [dist_backend=gloo]

Each rank builds num_envs / N envs (`parallel.mesh`: its slice of the
batch) and `data_shards` defaults to N, as the root train.py sets it to
the mesh's size. Rank r runs on `cuda:LOCAL_RANK` with `nccl` (the
default); ranks that share a card need `dist_backend=gloo` (NCCL refuses
two ranks on one card and the run raises: it is not turned into gloo), or
`device=cpu` with gloo. The learner is replicated (broadcast from rank 0
at the start) and every global reduction is an all-reduce, so every rank
holds the same learner and stats. Rank 0 alone prints, logs and writes
`config.json`; checkpoints gather every rank's envs and rank 0 writes them
(the file one process of num_envs envs writes). A resumed file of the run's
env count gives each rank its envs; of another count, its learner alone.
The printed env-steps/s count the global batch.

Population-based training (`parallel.pbt`, the root train.py's `pbt.*`
keys): `pbt.policy_idx=`, `pbt.num_policies=`, `pbt.workspace=` (default
runs/<experiment>/pbt_workspace), `pbt.interval_steps=`, `pbt.objective=`
(a stats key, default success_rate_ewma) and PbtConfig's float fields.
Every `interval_steps` env frames the run exchanges with its population;
a policy that is replaced writes the donor's state as its newest periodic
checkpoint and `os.execv`s `python -m handarm_tpu_torch.train` with its
argv, the mutated `ppo.<hyperparameter>=` values and `resume=auto`
(`pbt_restart_argv`). PBT runs one process per policy: with WORLD_SIZE > 1
the `pbt.*` keys raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.convert import env_leaf_count
from handarm_tpu_torch.envs.registry import build_env, resolve_task
from handarm_tpu_torch.learn.ppo import PPO, PPOConfig, ppo_config
from handarm_tpu_torch.parallel.launch import init_distributed, per_host_envs
from handarm_tpu_torch.parallel.mesh import (
    DataParallel,
    scatter_train_state,
    shard_train_state,
)
from handarm_tpu_torch.parallel.pbt import PbtConfig, pbt_step
from handarm_tpu_torch.utils.checkpoint import (
    checkpoint_step,
    file_contact_slots,
    file_env_leaves,
    latest_checkpoint,
    load_train_state,
    save_checkpoint,
)
from handarm_tpu_torch.utils.logging import MetricsLogger

TOP_KEYS = ("task", "max_iterations", "seed", "experiment", "resume", "save_every", "device",
            "dist_backend")


def pbt_restart_argv(argv: list[str], new_hparams: dict) -> list[str]:
    """The argv of a PBT restart (reference pbt.py:123-177): the stale
    `ppo.<mutable>=` and `resume=` arguments dropped, the mutated values
    appended, and `resume=auto`: the newest periodic checkpoint, which the
    caller has just written with the donor's state."""
    stale = {f"ppo.{k}" for k in new_hparams} | {"resume"}
    kept = [a for a in argv if a.split("=", 1)[0] not in stale]
    return kept + [f"ppo.{k}={v}" for k, v in new_hparams.items()] + ["resume=auto"]


def parse_args(argv: list[str]) -> tuple[dict, list[str]]:
    """(top-level keys, composition overrides) of `key=value` arguments; the
    `pbt.*` keys are top-level."""
    top, overrides = {}, []
    for arg in argv:
        key, sep, val = arg.partition("=")
        if not sep:
            raise ValueError(f"arguments are key=value, got {arg!r}")
        if key in TOP_KEYS or key.startswith("pbt."):
            top[key] = val
        else:
            overrides.append(arg)
    return top, overrides


def compose(argv: list[str]) -> tuple[dict, list[str], object, dict, PPOConfig]:
    """(top-level keys, overrides, env config (a HandArmConfig or a classic
    task's), PPO overrides, PPOConfig) of the arguments; nothing is
    built."""
    top, overrides = parse_args(argv)
    env_cfg, ppo_over = resolve_task(top.get("task", "Ur5SihLift"), overrides)
    return top, overrides, env_cfg, ppo_over, ppo_config(ppo_over)


def resolved_config(top: dict, overrides: list[str], env_cfg, ppo_over: dict,
                    cfg: PPOConfig, device) -> dict:
    """What `config.json` holds, as the root train.py's `config.yaml`: the
    task, the overrides, the env config's plain fields and the PPO
    overrides (and the whole PPOConfig and the device)."""
    task = top.get("task", "Ur5SihLift")
    plain = (int, float, str, bool, tuple, list, dict)  # dict: reward, dr, adr
    return {
        "task": task, "experiment": top.get("experiment", task),
        "seed": int(top.get("seed", 42)), "max_iterations": int(top.get("max_iterations", 1000)),
        "cli_overrides": dict(o.split("=", 1) for o in overrides),
        "env": {k: v for k, v in dataclasses.asdict(env_cfg).items() if isinstance(v, plain)},
        "ppo_overrides": ppo_over, "ppo": cfg._asdict(), "device": str(device),
    }


def drain_stats(stats: dict) -> dict:
    """The device stats of one iteration as floats: one host transfer."""
    vals = torch.stack([v.to(torch.float32).reshape(()) for v in stats.values()]).tolist()
    return dict(zip(stats, vals))


def _pbt_config(top: dict, run_dir: str):
    """(PbtConfig, objective key) of the `pbt.*` keys, or (None, None)."""
    kv = {k[len("pbt."):]: v for k, v in top.items() if k.startswith("pbt.")}
    if not kv:
        return None, None
    objective = kv.pop("objective", "success_rate_ewma")
    return PbtConfig(
        workspace=kv.pop("workspace", os.path.join(run_dir, "pbt_workspace")),
        policy_idx=int(kv.pop("policy_idx", 0)),
        num_policies=int(kv.pop("num_policies", 8)),
        interval_steps=int(float(kv.pop("interval_steps", 10_000_000))),
        **{k: float(v) for k, v in kv.items()},
    ), objective


def main(argv: list[str]) -> None:
    top, overrides, env_cfg, ppo_over, cfg = compose(argv)
    task = top.get("task", "Ur5SihLift")
    max_iterations = int(top.get("max_iterations", 1000))
    seed = int(top.get("seed", 42))
    exp_name = top.get("experiment", task)
    resume = top.get("resume", "")
    save_every = int(top.get("save_every", 100))
    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torchrun
        info = init_distributed(top.get("dist_backend", "nccl"), top.get("device"))
        group = DataParallel.current(info["device"], info["backend"])
        dev = info["device"]
    else:
        dev = resolve_device(top.get("device"))
    W = group.world_size if group is not None else 1
    main_rank = group is None or group.rank == 0
    say = (lambda msg: print(msg, flush=True)) if main_rank else (lambda msg: None)
    num_envs = env_cfg.num_envs  # the global batch
    if "data_shards" not in ppo_over:
        cfg = cfg._replace(data_shards=W)

    run_dir = os.path.join("runs", exp_name)
    nn_dir = os.path.join(run_dir, "nn")
    pbt_cfg, pbt_objective = _pbt_config(top, run_dir)
    if pbt_cfg is not None and W > 1:
        raise ValueError("PBT runs one process per policy: pbt.* keys take no torchrun ranks")
    env = build_env(dataclasses.replace(env_cfg, num_envs=per_host_envs(num_envs)), dev,
                    group=group)  # a drop-init task runs genesis at its first reset
    ppo = PPO(env, cfg, group=group)

    os.makedirs(run_dir, exist_ok=True)
    logger = None
    if main_rank:
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(resolved_config(top, overrides, env_cfg, ppo_over, cfg, dev), f, indent=1)
        logger = MetricsLogger(run_dir)

    ts = ppo.init(seed)
    start_it = 0
    path = latest_checkpoint(nn_dir) if resume == "auto" else resume
    if path:
        slots = file_contact_slots(path, cfg)
        run_slots = env.scene.slots.num_slots if hasattr(env, "scene") else 0
        if slots != run_slots:
            raise ValueError(
                f"{path}: its env state holds {slots} contact slots, this run's env "
                f"{run_slots} (hand_only_collision="
                f"{getattr(env_cfg, 'hand_only_collision', None)}); the JAX "
                f"package cannot step such a state either")
        if file_env_leaves(path, cfg) == env_leaf_count(env_cfg):
            ck = load_train_state(path, dev, cfg=cfg, env_cfg=env_cfg)
            same = (ck.last_obs.shape[0] == num_envs  # the env count
                    and ck.last_obs.shape[1:] == ts.last_obs.shape[1:])
            if same:
                ck = scatter_train_state(group, ck)  # this rank's envs
        else:  # its env state has another DR / ADR layout
            ck = load_train_state(path, dev, ts.env_state, ts.last_obs, cfg=cfg)
            same = False
        ts = ck if same else ck._replace(env_state=ts.env_state, last_obs=ts.last_obs,
                                         last_teacher_obs=ts.last_teacher_obs,
                                         hidden=ts.hidden)
        start_it = checkpoint_step(path)
        say(f"resumed from {path} at iter {start_it}"
            + ("" if same else " (its env state is another size or layout: the env is reset "
                                 "fresh)"))
    ts = shard_train_state(group, ts)  # the replicated leaves: rank 0's

    steps_per_iter = num_envs * cfg.horizon
    say(f"task={task} envs={num_envs} obs={env.num_obs} act={env.num_actions} device={dev} "
        f"ranks={W} data_shards={cfg.data_shards} steps/iter={steps_per_iter}")

    def report(it, stats):
        say(f"it {it:5d} | {stats['env_steps_per_s']:>10,.0f} sps | "
            f"rew {stats['reward_mean']:.4f} | kl {stats['kl']:.4f} | "
            f"lr {stats['lr']:.2e} | succ {stats['success_rate_ewma']:.3f}")

    def save(state, step, **kw):
        return save_checkpoint(nn_dir, state, step=step, seed=seed, cfg=cfg, env_cfg=env_cfg,
                               group=group, **kw)

    if pbt_cfg is not None:
        pbt_rng = np.random.default_rng(seed * 997 + pbt_cfg.policy_idx)
        pbt_hparams = {k: float(getattr(cfg, k)) for k in pbt_cfg.mutable}
        pbt_last_interval = (start_it * steps_per_iter) // pbt_cfg.interval_steps

    best_reward, last_best_it = float("-inf"), -(10**9)
    t_start = time.time()
    pending = None  # (iteration, device stats, its dispatch time)

    def drain(next_t0):
        p_it, p_stats, p_t0 = pending
        s = drain_stats(p_stats)
        s["env_steps_per_s"] = steps_per_iter / max(next_t0 - p_t0, 1e-9)
        s["total_env_steps"] = (p_it + 1) * steps_per_iter
        return p_it, s

    for loop_it in range(start_it, max_iterations):
        t0 = time.time()
        # the learner after exactly loop_it iterations: what a checkpoint
        # named step=loop_it holds (the drained stats below are loop_it-1's)
        ts_at_loop_it = ts
        ts, stats_d = ppo.train_iter(ts)
        if pending is None:
            drain_stats({"kl": stats_d["kl"]})  # the first: an honest timing base
            pending = (loop_it, stats_d, t0)
            continue
        it, stats = drain(t0)
        pending = (loop_it, stats_d, t0)
        if logger is not None:
            logger.log(it, stats)
        if pbt_cfg is not None:
            frames = int(stats["total_env_steps"])
            if frames // pbt_cfg.interval_steps > pbt_last_interval:
                pbt_last_interval = frames // pbt_cfg.interval_steps
                objective = float(stats.get(pbt_objective, stats["reward_mean"]))
                new_ts, new_hp, restarted = pbt_step(
                    pbt_cfg, ts, pbt_hparams, frames, objective, rng=pbt_rng, device=dev,
                    seed=seed, ppo_cfg=cfg, env_cfg=env_cfg)
                if restarted:
                    # the reference's restart (pbt.py:123-177): the donor's state
                    # becomes this run's newest periodic checkpoint, and the process
                    # image is replaced by a run resuming it under the mutated
                    # hyperparameters
                    save(new_ts, it + 1, sync=True)
                    new_argv = pbt_restart_argv(argv, new_hp)
                    say(f"[pbt] policy {pbt_cfg.policy_idx} restarts from donor at iter "
                        f"{it + 1}: {new_hp}")
                    logger.close()
                    sys.stdout.flush()
                    os.execv(sys.executable,
                             [sys.executable, "-m", "handarm_tpu_torch.train"] + new_argv)
        if it % 10 == 0 or it == max_iterations - 1:
            report(it, stats)
        if (it + 1) % save_every == 0:
            save(ts_at_loop_it, it + 1)
        if it > 50 and stats["reward_mean"] > best_reward and it - last_best_it >= 25:
            best_reward, last_best_it = stats["reward_mean"], it
            save(ts_at_loop_it, 0, name="best")
    if pending is not None:
        it, stats = drain(time.time())
        if logger is not None:
            logger.log(it, stats)
        report(it, stats)
    say(f"done in {time.time() - t_start:.0f}s")
    if logger is not None:
        logger.close()
    save(ts, max_iterations, sync=True)
    if group is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
