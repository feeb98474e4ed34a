"""Benchmark: UR5+SIH env throughput on the card (counterpart of the
repository's bench.py).

    python -m handarm_tpu_torch.bench [--envs 8192] [--steps 30] [--warmup 2]
        [--scene lift|multiobj] [--policy CKPT] [--override K=V ...]
        [--skip-small] [--device cuda]

stdout carries only JSON lines, one per finished measurement, flushed at
once; the last is the headline:
  {"metric": "env_steps_per_s", "value": N, "unit": "env-steps/s",
   "vs_baseline": N / 1e6, "envs": B} (and "scene" for multiobj)
vs_baseline is against the target of 1M env-steps/s at 8192 envs
(BASELINE.md). Unless `--skip-small` or `--envs` <= 1024, a 1,024-env
line comes first, so that a run cut short still gives a number; a fault
there is logged and the headline run goes on. Progress goes to stderr.

One env-step is one 20 Hz control step: 3 sim steps x 2 substeps, each
with the contact solve. The lift scene is `HandArmConfig(num_envs=B)`;
multiobj is the Ur5SihMultiObjectManipulation preset (`--override` takes
its `key=value` fields), whose genesis pose pool is built before the
timed region. Without `--policy` the env steps a fixed action of 0.1 x a
normal draw; with it, the checkpoint's deterministic mean acts on each
step's observations (inference + env step). The clock is read after
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from handarm_tpu_torch import resolve_device


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(sps: float, envs: int, scene: str = "lift") -> None:
    rec = {"metric": "env_steps_per_s", "value": round(sps, 1), "unit": "env-steps/s",
           "vs_baseline": round(sps / 1e6, 4), "envs": envs}
    if scene != "lift":
        rec["scene"] = scene
    print(json.dumps(rec), flush=True)


def build_env(envs: int, scene: str, overrides=(), device=None):
    """The benchmarked env, its genesis pool built if it drops its objects."""
    from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv
    from handarm_tpu_torch.envs.registry import make_env

    if scene == "multiobj":
        env, _ = make_env("Ur5SihMultiObjectManipulation",
                          [f"num_envs={envs}"] + list(overrides), device)
    else:
        env = HandArmEnv(HandArmConfig(num_envs=envs), device)
    if env.cfg.use_drop_init:  # a dataset build, outside the timed region
        env.initialize_pool()
    return env


def measure(envs: int, steps: int, warmup: int, scene: str = "lift",
            policy: str | None = None, overrides=(), device=None) -> float:
    """env-steps/s over `steps` control steps after `warmup` of them."""
    from handarm_tpu_torch.rollout import load_policy

    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    env = build_env(envs, scene, overrides, dev)
    state, obs = env.reset(0)
    if policy:
        pol = load_policy(policy, dev)

        def tick(state, obs):
            state, res = env.step(state, pol.act(obs))
            return state, res.obs
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        actions = 0.1 * torch.randn((envs, env.num_actions), generator=gen, device=dev)

        def tick(state, obs):
            return env.step(state, actions)[0], obs

    for _ in range(warmup):
        state, obs = tick(state, obs)
    sync()
    log(f"[bench] envs={envs} build+warmup {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for _ in range(steps):
        state, obs = tick(state, obs)
    sync()
    return envs * steps / (time.perf_counter() - t0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs", type=int, default=int(os.environ.get("BENCH_ENVS", 8192)))
    p.add_argument("--steps", type=int, default=int(os.environ.get("BENCH_STEPS", 30)))
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--scene", default="lift", choices=["lift", "multiobj"],
                   help="lift (the headline) or multiobj (372 contact slots)")
    p.add_argument("--skip-small", action="store_true",
                   help="skip the 1,024-env measurement")
    p.add_argument("--policy", default=None, metavar="CKPT",
                   help="time the checkpoint's policy in the loop (inference + env step)")
    p.add_argument("--override", action="append", default=[], metavar="K=V",
                   help="task config overrides (e.g. solver_iterations=8); multiobj only")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    log(f"[bench] device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    if not a.skip_small and a.envs > 1024:
        try:
            emit(measure(1024, max(10, a.steps // 2), a.warmup, a.scene, a.policy,
                         a.override, dev), 1024, a.scene)
        except Exception as e:  # the insurance run never stops the headline run
            log(f"[bench] small-shape run failed: {e!r}")
    emit(measure(a.envs, a.steps, a.warmup, a.scene, a.policy, a.override, dev),
         a.envs, a.scene)


if __name__ == "__main__":
    main()
