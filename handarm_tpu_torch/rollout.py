"""Deterministic policy rollout of a task: the serving path.

Counterpart of `__graft_entry__.entry().forward_step` with
`PPO.act(deterministic=True)`: obs -> normalize -> ActorCritic.mu ->
env.step, once per control step. A distilled student (`Student`) acts on
the flat observations and the clouds of `obs_dict` instead.

    python -m handarm_tpu_torch.rollout [--task NAME] --envs N --steps S [--device cpu]

Tasks: Ur5SihLift (default), Ur5SihMultiObjectManipulation and StretchLift,
each with its trained checkpoint, composed from its yaml config group as
the training entry point composes it (the multi-object task: 16 solver
sweeps; StretchLift: the Stretch on its in-repo stand-in, 100 contact
slots). A drop-init task first runs genesis
(`--drop-steps` and `--settle-steps` shorten it). Prints one
JSON line: the task, contact slots, genesis seconds and sim steps, the
env-steps per second and the kernel launch counts of the timed steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.convert import actor_critic_from_params, running_stats_from_leaves
from handarm_tpu_torch.envs.hand_arm import HandArmEnv
from handarm_tpu_torch.envs.registry import resolve_task
from handarm_tpu_torch.learn.networks import ActorCritic
from handarm_tpu_torch.learn.running_stats import RunningStats, normalize
from handarm_tpu_torch.ops import contact_sweep, prep_deff, sdf_gather, spd_inverse
from handarm_tpu_torch.utils.checkpoint import read_policy

EVIDENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "docs", "evidence")
DEFAULT_TASK = "Ur5SihLift"
TASK_CKPTS = {
    "Ur5SihLift": os.path.join(EVIDENCE, "lift_r3a", "ckpt_5200.npz"),
    "Ur5SihMultiObjectManipulation": os.path.join(EVIDENCE, "multiobj_r5a", "ckpt_2700.npz"),
    "StretchLift": os.path.join(EVIDENCE, "stretch_r5d", "ckpt_4000.npz"),
}
KERNEL_OPS = {"spd_inverse": spd_inverse, "contact_sweep": contact_sweep,
              "prep_deff": prep_deff, "sdf_gather": sdf_gather}


class Policy:
    """Observation normalization + the ActorCritic mean action."""

    def __init__(self, net: ActorCritic, obs_stats: RunningStats):
        self.net, self.obs_stats = net, obs_stats

    @torch.no_grad()
    def act(self, obs: torch.Tensor) -> torch.Tensor:
        return self.net(normalize(self.obs_stats, obs))[0]

    @staticmethod
    def observe(res):
        """What `act` reads of a StepResult: the flat observations."""
        return res.obs


class Student:
    """A distilled StudentPolicy's mean action; it reads the flat
    observations and the clouds of `obs_dict`."""

    def __init__(self, net, params: dict):
        self.net, self.params = net, params

    @torch.no_grad()
    def act(self, obs) -> torch.Tensor:
        flat, obs_dict = obs
        return torch.func.functional_call(self.net, self.params, (flat, obs_dict))[0]

    @staticmethod
    def observe(res):
        return res.obs, res.obs_dict


def load_policy(ckpt: str, device) -> Policy:
    """The policy of a JAX PPO checkpoint (.npz) of the MLP ActorCritic; an
    asymmetric or recurrent learner's raises NotImplementedError
    (`utils.checkpoint.read_policy`)."""
    params, (mean, var, count) = read_policy(ckpt)
    return Policy(actor_critic_from_params(params, device),
                  running_stats_from_leaves(mean, var, count, device))


def forward_step(env, policy, state, obs):
    """One policy-in-the-loop env step: (state, what the policy reads next
    (`policy.observe`: the flat observations, or for a Student those and
    `obs_dict`), reward, done)."""
    state, res = env.step(state, policy.act(obs))
    return state, policy.observe(res), res.reward, res.done


def reset_launch_counts() -> None:
    for op in KERNEL_OPS.values():
        op.launches = 0


def launch_counts() -> dict:
    return {name: op.launches for name, op in KERNEL_OPS.items()}


def make_task_env(task: str, envs: int | None, device, pool=None, compose=(), **overrides):
    """The task's env, composed as the entry points compose it
    (`envs/registry.py` `resolve_task`, with the `compose` overrides, such
    as `envs.tasks.DR_SHADOWHAND`), at `envs` envs (None: the composed
    count); keyword overrides then replace config fields. A drop-init task
    takes `pool` (a genesis.InitialPool) if given, else runs genesis here
    (the pool is built once, before the first reset)."""
    cfg, _ = resolve_task(task, list(compose) + ([] if envs is None
                                                  else [f"env.num_envs={envs}"]))
    env = HandArmEnv(dataclasses.replace(cfg, **overrides), device)
    if env.cfg.use_drop_init:
        if pool is not None:
            env.initial_pool = pool
        else:
            env.initialize_pool()
    return env


def run(envs: int, steps: int, device=None, ckpt: str | None = None,
        seed: int = 0, task: str = DEFAULT_TASK, **overrides) -> dict:
    dev = resolve_device(device)
    policy = load_policy(ckpt or TASK_CKPTS[task], dev)
    env = make_task_env(task, envs, dev, **overrides)
    state, obs = env.reset(seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    state, obs, _, _ = forward_step(env, policy, state, obs)  # warm-up
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    reward_sum = torch.zeros((), device=dev)
    for _ in range(steps):
        state, obs, reward, _ = forward_step(env, policy, state, obs)
        reward_sum += reward.mean()
    sync()
    seconds = time.perf_counter() - t0
    pool = env.initial_pool
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "task": task, "envs": envs, "steps": steps, "slots": env.scene.slots.num_slots,
        "genesis_seconds": env.genesis_seconds,
        "genesis_sim_steps": pool.sim_steps if pool is not None else 0,
        "seconds": seconds, "env_steps_per_s": envs * steps / seconds,
        "mean_reward": float(reward_sum) / steps, "launches": launch_counts(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default=DEFAULT_TASK, choices=sorted(TASK_CKPTS))
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--ckpt", default=None,
                    help="JAX PPO checkpoint (.npz); default: the task's own")
    ap.add_argument("--seed", type=int, default=0)
    add_genesis_args(ap)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.envs, a.steps, a.device, a.ckpt, a.seed, a.task,
                         **genesis_overrides(a))), flush=True)


def add_genesis_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--drop-steps", type=int, default=None,
                    help="genesis drop steps (default: the task's, 100)")
    ap.add_argument("--settle-steps", type=int, default=None,
                    help="most genesis settle steps per drop (default: the task's, 600)")


def genesis_overrides(a: argparse.Namespace) -> dict:
    """The config fields that --drop-steps and --settle-steps replace."""
    over = {"drop_num_steps": a.drop_steps, "settle_num_steps": a.settle_steps}
    return {k: v for k, v in over.items() if v is not None}


if __name__ == "__main__":
    main()
