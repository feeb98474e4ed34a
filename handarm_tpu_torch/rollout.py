"""Deterministic policy rollout on Ur5SihLift: the serving path.

Counterpart of `__graft_entry__.entry().forward_step` with
`PPO.act(deterministic=True)`: obs -> normalize -> ActorCritic.mu ->
env.step, once per control step.

    python -m handarm_tpu_torch.rollout --envs N --steps S [--device cpu]

prints one JSON line with the env-steps per second and the kernel launch
counts of the run.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.convert import actor_critic_from_params, running_stats_from_leaves
from handarm_tpu_torch.envs.tasks import make_env
from handarm_tpu_torch.learn.networks import ActorCritic
from handarm_tpu_torch.learn.running_stats import RunningStats, normalize
from handarm_tpu_torch.ops import contact_sweep, spd_inverse
from handarm_tpu_torch.utils.checkpoint import read_policy

DEFAULT_CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "docs", "evidence", "lift_r3a", "ckpt_5200.npz",
)


class Policy:
    """Observation normalization + the ActorCritic mean action."""

    def __init__(self, net: ActorCritic, obs_stats: RunningStats):
        self.net, self.obs_stats = net, obs_stats

    @torch.no_grad()
    def act(self, obs: torch.Tensor) -> torch.Tensor:
        return self.net(normalize(self.obs_stats, obs))[0]


def load_policy(ckpt: str, device) -> Policy:
    """The policy of a JAX PPO checkpoint (.npz)."""
    params, (mean, var, count) = read_policy(ckpt)
    return Policy(actor_critic_from_params(params, device),
                  running_stats_from_leaves(mean, var, count, device))


def forward_step(env, policy: Policy, state, obs):
    """One policy-in-the-loop env step."""
    state, res = env.step(state, policy.act(obs))
    return state, res.obs, res.reward, res.done


def reset_launch_counts() -> None:
    spd_inverse.launches = 0
    contact_sweep.launches = 0


def launch_counts() -> dict:
    return {"spd_inverse": spd_inverse.launches,
            "contact_sweep": contact_sweep.launches}


def run(envs: int, steps: int, device=None, ckpt: str = DEFAULT_CKPT,
        seed: int = 0) -> dict:
    dev = resolve_device(device)
    env = make_env("Ur5SihLift", device=dev, num_envs=envs)
    policy = load_policy(ckpt, dev)
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
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "envs": envs, "steps": steps, "slots": env.scene.slots.num_slots,
        "seconds": seconds, "env_steps_per_s": envs * steps / seconds,
        "mean_reward": float(reward_sum) / steps, "launches": launch_counts(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT,
                    help="JAX PPO checkpoint (.npz)")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.envs, a.steps, a.device, a.ckpt, a.seed)), flush=True)


if __name__ == "__main__":
    main()
