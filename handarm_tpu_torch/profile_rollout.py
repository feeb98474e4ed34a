"""Where the time goes in the Ur5SihLift rollout on the card.

    python -m handarm_tpu_torch.profile_rollout --envs 8192 --steps 5

Runs warm-up control steps, then traces `--steps` policy-in-the-loop
control steps with torch.profiler and prints one JSON line: the wall time
per control step, the device's busy share of that time (summed kernel
time over wall time; kernels do not overlap on one stream), the number of
kernel launches per control step, and the kernels with the most device
time, the port's two hand-written kernels among them.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from handarm_tpu_torch import resolve_device, rollout
from handarm_tpu_torch.envs.tasks import make_env


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=25)
    ap.add_argument("--top", type=int, default=15)
    a = ap.parse_args(argv)
    dev = resolve_device(None)
    env = make_env("Ur5SihLift", device=dev, num_envs=a.envs)
    policy = rollout.load_policy(rollout.DEFAULT_CKPT, dev)
    state, obs = env.reset(0)
    for _ in range(a.warmup):  # the policy brings the hand into contact
        state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
    torch.cuda.synchronize()
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
        "device": torch.cuda.get_device_name(dev), "envs": a.envs, "steps": a.steps,
        "wall_ms_per_step": wall_ms / a.steps,
        "device_busy_ms_per_step": busy_ms / a.steps,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / a.steps,
        "env_steps_per_s": a.envs * a.steps / (wall_ms / 1e3),
        "top_kernels": [
            {"name": n[:90], "ms_per_step": t / a.steps, "launches_per_step": c / a.steps}
            for n, (t, c) in top
        ],
    }), flush=True)


if __name__ == "__main__":
    main()
