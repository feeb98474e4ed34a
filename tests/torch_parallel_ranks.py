"""Rank functions of tests/test_torch_parallel.py, run in spawned processes
(`handarm_tpu_torch.parallel.launch.spawn`): they import the port and
torch only, never JAX."""

from types import SimpleNamespace

import numpy as np
import torch

from handarm_tpu_torch.convert import learner_to_leaves, train_state_from_leaves
from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv, StepDraws
from handarm_tpu_torch.learn import ppo as tppo
from handarm_tpu_torch.parallel.mesh import (
    assert_sharded,
    leaves_with_paths,
    scatter_train_state,
)
from handarm_tpu_torch.utils.checkpoint import save_checkpoint

TRAJ_FIELDS = ("obs", "action", "logp", "value", "reward", "done", "mu", "sigma")


def stub_env(num_envs: int, num_obs: int, num_actions: int):
    return SimpleNamespace(num_obs=num_obs, num_actions=num_actions,
                           cfg=SimpleNamespace(num_envs=num_envs),
                           device=torch.device("cpu"))


def update_rank(group, cfg_kw: dict, leaves: list, traj: dict, last_obs: np.ndarray,
                perms: np.ndarray, num_actions: int) -> dict:
    """This rank's `_update_from_traj` on its envs of a [T, B] trajectory
    (numpy), from the learner of `leaves`, with the shared permutations
    [mini_epochs, D, rows / D]. Returns its learner leaves, stats,
    placement counts and collectives."""
    B = traj["reward"].shape[1]
    sl = group.env_slice(B)
    ppo = tppo.PPO(stub_env(B // group.world_size, last_obs.shape[1], num_actions),
                   tppo.PPOConfig(**cfg_kw), device="cpu", group=group)
    ts = train_state_from_leaves(leaves, None, None)
    local = tppo.Transition(*(torch.as_tensor(traj[k][:, sl]) for k in TRAJ_FIELDS))
    obs = torch.as_tensor(last_obs[sl])
    new, stats = ppo._update_from_traj(ts, local, None, obs, perms=torch.as_tensor(perms))
    sharding = assert_sharded(group, new)
    return dict(leaves=learner_to_leaves(new), stats={k: float(v) for k, v in stats.items()},
                sharding=sharding, collectives={f"{op} {tag}": n
                                                for (op, tag), n in group.counts.items()},
                epoch=int(new.epoch))


def env_config(num_envs: int) -> HandArmConfig:
    """Two boxes on the stand-in lift scene under ADR: 2-step episodes, a
    reposition goal about half the targets start within, every env a
    boundary worker, queues of two samples, and thresholds that expand a
    range on any objective, so one step moves some ranges and fills
    others' queues."""
    from handarm_tpu_torch.envs.adr import AdrConfig

    return HandArmConfig(
        num_envs=num_envs, episode_length=2, solver_iterations=2, goal="reposition",
        goal_threshold=0.31,
        objects=(("box", (0.03, 0.03, 0.03), 0.1), ("box", (0.025, 0.025, 0.025), 0.08)),
        adr=AdrConfig(enabled=True, boundary_fraction=1.0, queue_len=2,
                      objective_hi=-1.0, objective_lo=-2.0))


def env_step_rank(group, num_envs: int, state, actions: torch.Tensor, adr_draws) -> dict:
    """One env step of this rank's envs of the whole `state` (all `num_envs`),
    with its rows of the actions and ADR draws. Returns the state's leaves
    by path."""
    env = HandArmEnv(env_config(num_envs // group.world_size), "cpu", group=group)
    sl = group.env_slice(num_envs)
    ts = tppo.TrainState({}, None, None, None, None, state, actions, None)
    local = scatter_train_state(group, ts).env_state
    draws = StepDraws(adr=type(adr_draws)(*(x[sl] for x in adr_draws)))
    new, _ = env.step(local, actions[sl], draws=draws)
    return {p: x for p, x in leaves_with_paths(new)}


def checkpoint_rank(group, ts, path: str, cfg_kw: dict) -> str:
    """Write the whole TrainState `ts` from this rank's slice of it (every
    rank calls; rank 0 writes)."""
    local = scatter_train_state(group, ts)
    rows = local.last_obs.shape[0]
    bad = [p for p, x in leaves_with_paths(local)
           if p.startswith(("env_state.physics", "last_obs")) and x.shape[0] != rows]
    assert not bad, bad
    return save_checkpoint(path, local, 3, seed=5, sync=True,
                           cfg=tppo.PPOConfig(**cfg_kw), group=group)

