"""Carry weights and state from the JAX package's numpy leaves to the port.

- flax `Dense` kernels are [in, out]; `nn.Linear` weights are [out, in].
- PhysicsState / EnvState leaves arrive in JAX's flattening order (NamedTuple
  fields in order, None fields absent): physics (q, qd, targets, object pos,
  quat, linvel, angvel, contact_impulse), control (arm_target, servo_ticks,
  sih_smoothed), task (progress, goal_pos, goal_quat, target_obj,
  goal_reached_before, initial_obj_pos, PRNG key, total_steps), metrics
  (success_ewma, per_object_ewma, total_resets, total_successes,
  end_success_ewma). The PRNG key is dropped: the port draws from a
  torch.Generator.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from handarm_tpu_torch.envs.hand_arm import EnvState, Metrics, TaskState
from handarm_tpu_torch.learn.networks import ActorCritic
from handarm_tpu_torch.learn.running_stats import RunningStats
from handarm_tpu_torch.physics.engine import ObjectState, PhysicsState, RobotState
from handarm_tpu_torch.robots.ur5sih_adapter import ControlState

N_PHYSICS_LEAVES = 8
N_ENV_LEAVES = 24


def actor_critic_from_params(params: dict, device="cpu") -> ActorCritic:
    """Build an ActorCritic from flax params named as in utils.checkpoint."""
    kernels = [params[f"dense_{i}.kernel"] for i in range(3)]
    net = ActorCritic(kernels[0].shape[0], params["mu.kernel"].shape[1],
                      hidden=[k.shape[1] for k in kernels])
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    with torch.no_grad():
        for i, layer in enumerate(net.trunk):
            layer.weight.copy_(t(params[f"dense_{i}.kernel"]).T)
            layer.bias.copy_(t(params[f"dense_{i}.bias"]))
        for name in ("mu", "value"):
            getattr(net, name).weight.copy_(t(params[f"{name}.kernel"]).T)
            getattr(net, name).bias.copy_(t(params[f"{name}.bias"]))
        net.log_std.copy_(t(params["log_std"]))
    return net.to(device)


def running_stats_from_leaves(mean, var, count, device="cpu") -> RunningStats:
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    return RunningStats(t(mean), t(var), t(count))


def physics_state_from_leaves(leaves: Sequence[np.ndarray], device="cpu") -> PhysicsState:
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    q, qd, tg, pos, quat, lv, av, imp = (t(x) for x in leaves[:N_PHYSICS_LEAVES])
    return PhysicsState(RobotState(q, qd, tg), ObjectState(pos, quat, lv, av), imp)


def env_state_from_leaves(leaves: Sequence[np.ndarray], device="cpu") -> EnvState:
    if len(leaves) != N_ENV_LEAVES:
        raise ValueError(f"expected {N_ENV_LEAVES} EnvState leaves, got {len(leaves)}")
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    i = lambda x: torch.tensor(np.asarray(x).astype(np.int64), device=device)
    physics = physics_state_from_leaves(leaves[:N_PHYSICS_LEAVES], device)
    control = ControlState(*(f(x) for x in leaves[8:11]))
    (progress, goal_pos, goal_quat, target, reached, init_pos, _key,
     total) = leaves[11:19]
    task = TaskState(
        progress=i(progress), goal_pos=f(goal_pos), goal_quat=f(goal_quat),
        target_obj=i(target),
        goal_reached_before=torch.tensor(np.asarray(reached), device=device),
        initial_obj_pos=f(init_pos), total_steps=i(total),
    )
    metrics = Metrics(*(f(x) for x in leaves[19:24]))
    return EnvState(physics, control, task, metrics)
