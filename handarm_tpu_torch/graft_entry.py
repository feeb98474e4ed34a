"""The flagship forward step as a callable, and the multi-rank dry run and
scaling table (counterparts of `entry()`, `dryrun_multichip` and
`scaling_report` of the repository's __graft_entry__.py).

`entry()` returns `(forward_step, (env_state, obs))`: one UR5+SIH lift env
step driven by the PPO policy's deterministic action, for 64 envs with
25-step episodes, 8 solver sweeps and a PPO learner of horizon 4,
minibatch 128 and one mini-epoch from a flax-default init. forward_step
(env_state, obs) -> (env_state, obs, reward, done).
"""

from __future__ import annotations

import os

from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv
from handarm_tpu_torch.learn.ppo import PPO, PPOConfig


def build(device=None):
    """(env, PPO, TrainState) of the entry's workload."""
    env = HandArmEnv(HandArmConfig(num_envs=64, episode_length=25, solver_iterations=8), device)
    ppo = PPO(env, PPOConfig(horizon=4, minibatch_size=128, mini_epochs=1))
    return env, ppo, ppo.init(0)


def make_forward_step(env, ppo, ts):
    """One policy-in-the-loop env step of `ts`'s policy."""
    def forward_step(env_state, obs):
        state, res = env.step(env_state, ppo.act(ts, obs, deterministic=True))
        return state, res.obs, res.reward, res.done

    return forward_step


def entry(device=None):
    """(forward_step, (env_state, obs)) on `device` (default: cuda)."""
    env, ppo, ts = build(device=device)
    return make_forward_step(env, ppo, ts), (ts.env_state, ts.last_obs)


def _dryrun_shape(n: int, envs_per_device: int, tiny: bool):
    """(HandArmConfig of one rank's envs, PPOConfig) of dryrun_multichip."""
    if tiny:
        num_envs = 8 * n
        return (HandArmConfig(num_envs=num_envs // n, episode_length=25, solver_iterations=2),
                PPOConfig(horizon=2, minibatch_size=num_envs * 2, mini_epochs=1,
                          hidden=(64, 64), data_shards=n))
    num_envs = envs_per_device * n
    return (HandArmConfig(num_envs=envs_per_device, episode_length=25, solver_iterations=8),
            PPOConfig(horizon=16, minibatch_size=num_envs * 4, mini_epochs=2,
                      hidden=(768, 512, 256), data_shards=n))


def _dryrun_rank(group, envs_per_device: int, tiny: bool) -> dict:
    """One rank of dryrun_multichip: its envs, the replicated learner, one
    whole train iteration, then the placement check of every leaf."""
    from handarm_tpu_torch import rollout
    from handarm_tpu_torch.parallel.mesh import assert_sharded, shard_train_state
    from handarm_tpu_torch.train import drain_stats

    env_cfg, cfg = _dryrun_shape(group.world_size, envs_per_device, tiny)
    env = HandArmEnv(env_cfg, group.device, group=group)
    ppo = PPO(env, cfg, group=group)
    ts = shard_train_state(group, ppo.init(0))
    rollout.reset_launch_counts()
    ts, stats = ppo.train_iter(ts)
    launches = rollout.launch_counts()
    counts = assert_sharded(group, ts)
    return dict(stats=drain_stats(stats), sharding=counts, launches=launches,
                envs=env_cfg.num_envs * group.world_size, envs_per_rank=env_cfg.num_envs,
                collectives={f"{op} {tag}": n for (op, tag), n in group.counts.items()})


def dryrun_multichip(n_devices: int, envs_per_device: int = 256, backend: str = "nccl",
                     device=None, timeout_s: float = 900.0) -> dict:
    """One whole PPO train iteration over `n_devices` ranks (spawned
    processes, `parallel.launch.spawn`, with the backend given) at a
    realistic shape per rank: 256 envs, the production 8 solver sweeps,
    horizon 16 and the 768-512-256 policy, `data_shards=n_devices`, the env
    batch split over the ranks and the learner replicated. With the
    environment variable HANDARM_DRYRUN_TINY set: 8 envs per rank, 2
    sweeps, horizon 2, hidden (64, 64). Prints and returns rank 0's stats,
    `assert_sharded`'s counts (every replicated leaf bit-identical across
    the ranks), its kernel launches and collectives by tag, and the per-rank
    records under "ranks". Ranks that share a card need backend="gloo";
    `device="cpu"` (with gloo) runs them on the CPU."""
    from handarm_tpu_torch.parallel.launch import spawn

    tiny = bool(os.environ.get("HANDARM_DRYRUN_TINY"))
    recs = spawn(_dryrun_rank, n_devices, (envs_per_device, tiny), backend=backend,
                 device=device, timeout_s=timeout_s)
    out = dict(recs[0], ranks=recs)
    print("dryrun_multichip ok:", out["stats"], flush=True)
    print(f"sharding verified: {out['sharding']}", flush=True)
    return out


def _scaling_rank(group, envs_per_device: int, iters: int) -> dict:
    import time

    import torch

    from handarm_tpu_torch.parallel.mesh import assert_sharded, shard_train_state

    n = group.world_size
    num_envs = envs_per_device * n
    env = HandArmEnv(HandArmConfig(num_envs=envs_per_device, episode_length=25,
                                   solver_iterations=8), group.device, group=group)
    ppo = PPO(env, PPOConfig(horizon=16, minibatch_size=num_envs * 4, mini_epochs=4,
                             hidden=(768, 512, 256), data_shards=n), group=group)
    ts = shard_train_state(group, ppo.init(0))
    counts = assert_sharded(group, ts)
    sync = torch.cuda.synchronize if group.device.type == "cuda" else (lambda: None)
    ts, stats = ppo.train_iter(ts)  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, stats = ppo.train_iter(ts)
    float(stats["kl"])
    sync()
    return dict(seconds=(time.perf_counter() - t0) / iters, sharding=counts)


def scaling_report(device_counts=(1, 2, 4, 8), envs_per_device: int = 1024, iters: int = 3,
                   out_path: str | None = None, backend: str = "nccl", device=None) -> dict:
    """Multi-rank scaling table at a realistic shape (8 solver sweeps, the
    768-512-256 policy, horizon 16, `envs_per_device` envs per rank, 4
    mini-epochs, every leaf's placement checked): for each rank count up
    to the host's cards (its CPUs with `device="cpu"`), one warm-up and
    `iters` timed train iterations, rank 0's seconds per iteration and the
    global env-steps/s. `platform` names the card (or "cpu"). Written to
    `out_path` as JSON when given."""
    import json

    import torch

    from handarm_tpu_torch.parallel.launch import spawn

    on_cpu = device is not None and str(device) == "cpu"
    available = (os.cpu_count() or 1) if on_cpu else torch.cuda.device_count()
    rows = []
    for n in device_counts:
        if n > available:
            break
        rec = spawn(_scaling_rank, n, (envs_per_device, iters), backend=backend,
                    device=device)[0]
        steps = envs_per_device * n * 16
        row = dict(devices=n, num_envs=envs_per_device * n, envs_per_device=envs_per_device,
                   iter_seconds=rec["seconds"], env_steps_per_s=steps / rec["seconds"],
                   env_steps_per_s_per_device=steps / rec["seconds"] / n,
                   sharded_leaves=rec["sharding"]["sharded"],
                   replicated_leaves=rec["sharding"]["replicated"])
        rows.append(row)
        print(row, flush=True)
    report = dict(platform="cpu" if on_cpu else torch.cuda.get_device_name(0),
                  backend=backend,
                  shape=dict(horizon=16, hidden=[768, 512, 256], solver_iterations=8,
                             mini_epochs=4),
                  rows=rows)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report
