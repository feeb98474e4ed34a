"""Where the time goes in a task's rollout on the card.

    python -m handarm_tpu_torch.profile_rollout [--task NAME] --envs 8192 --steps 5

Runs warm-up control steps, then traces `--steps` policy-in-the-loop
control steps with torch.profiler and prints one JSON line: the wall time
per control step, the device's busy share of that time (summed kernel
time over wall time; kernels do not overlap on one stream), the number of
kernel launches per control step, the kernels with the most device
time, and the launches of the port's hand-written kernels per control
step. A drop-init task runs genesis first (untraced; `--drop-steps` and
`--settle-steps` shorten it).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from handarm_tpu_torch import resolve_device, rollout


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default=rollout.DEFAULT_TASK, choices=sorted(rollout.TASK_CKPTS))
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=25)
    ap.add_argument("--top", type=int, default=15)
    rollout.add_genesis_args(ap)
    a = ap.parse_args(argv)
    dev = resolve_device(None)
    env = rollout.make_task_env(a.task, a.envs, dev, **rollout.genesis_overrides(a))
    policy = rollout.load_policy(rollout.TASK_CKPTS[a.task], dev)
    state, obs = env.reset(0)
    for _ in range(a.warmup):  # the policy brings the hand into contact
        state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
    torch.cuda.synchronize()
    rollout.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.steps):
            state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict[str, list] = {}
    for e in kernels:
        s = by_name.setdefault(e.name, [0.0, 0])
        s[0] += e.time_range.elapsed_us() / 1e3
        s[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: a.top]
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev), "task": a.task, "envs": a.envs,
        "steps": a.steps, "slots": env.scene.slots.num_slots,
        "genesis_seconds": env.genesis_seconds,
        "wall_ms_per_step": wall_ms / a.steps,
        "device_busy_ms_per_step": busy_ms / a.steps,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / a.steps,
        "env_steps_per_s": a.envs * a.steps / (wall_ms / 1e3),
        "port_kernel_launches_per_step": {
            k: n / a.steps for k, n in rollout.launch_counts().items()},
        "top_kernels": [
            {"name": n[:90], "ms_per_step": t / a.steps, "launches_per_step": c / a.steps}
            for n, (t, c) in top
        ],
    }), flush=True)


if __name__ == "__main__":
    main()
