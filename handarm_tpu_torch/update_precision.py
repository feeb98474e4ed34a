"""How far float32 rounding alone moves the PPO update: float32 against
float64 on one device.

    python -m handarm_tpu_torch.update_precision [--task Ur5SihLift] --envs 512
        --minibatch 8192 --steps 4

From the task's checkpoint's learner (Ur5SihLift: ckpt_5200,
Ur5SihMultiObjectManipulation: ckpt_2700, its genesis run first) on a
fresh reset of the task composed as the train entry point composes it,
with its PPO overrides but `--minibatch`: one train iteration,
then one more rollout whose update is computed twice, in float32 and in
float64 (the learner, the trajectory and the last observations converted):
the prepared samples and stats (`PPO._prepare`), then `--steps` minibatch
steps chained (`PPO._sgd`) on the same permutations. Prints one JSON line:
the largest difference of each prepared tensor over its largest value, of
each stats tensor in float32 ulps of its largest value and over its change,
of params and Adam moments over their largest value and over their change,
the minibatch KLs, both lrs, and the smallest relative distance of a KL to
a branch of the adaptive lr. chip_smoke.py's card-against-CPU tolerances
are set from it: two float32 computations each lie this far from float64.
"""

from __future__ import annotations

import argparse
import json

import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.registry import resolve_task
from handarm_tpu_torch.learn.ppo import PPO, ppo_config
from handarm_tpu_torch.rollout import TASK_CKPTS, make_task_env
from handarm_tpu_torch.utils.checkpoint import load_train_state

FLOAT32_EPS = 2.0 ** -23  # one ulp of a float32 in [1, 2)


def to_float64(x):
    """Floating tensors of nested tuples, NamedTuples and dicts as float64."""
    if isinstance(x, dict):
        return {k: to_float64(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [to_float64(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def kl_margin(kls, kl_threshold: float) -> float:
    """The smallest relative distance of a KL to a branch of the adaptive lr
    (0.5 and 2 x kl_threshold)."""
    return min(abs(k - t) / t for k in kls for t in (0.5 * kl_threshold, 2 * kl_threshold))


def measure(envs: int, minibatch: int, steps: int, device=None,
            task: str = "Ur5SihLift") -> dict:
    dev = resolve_device(device)
    env = make_task_env(task, envs, dev)
    ppo = PPO(env, ppo_config({**resolve_task(task)[1], "minibatch_size": minibatch}))
    if steps > ppo.cfg.mini_epochs * ppo.num_minibatches:
        raise ValueError(f"{steps} steps: the update has {ppo.cfg.mini_epochs} mini-epochs of "
                         f"{ppo.num_minibatches} minibatches")
    fresh = ppo.init(0)
    ts = load_train_state(TASK_CKPTS[task], dev, fresh.env_state, fresh.last_obs)
    ts, _ = ppo.train_iter(ts)
    traj, _, last_obs, _ = ppo.rollout(ts)
    n = envs * ppo.cfg.horizon
    perms = torch.stack([torch.randperm(n, generator=ppo.gen, device=dev)
                         for _ in range(ppo.cfg.mini_epochs)])
    minibatches = perms.reshape(-1, ppo.mb_size)[:steps]
    l32 = ts._replace(env_state=None, last_obs=None)
    l64 = to_float64(l32)
    data32, obs32, value32 = ppo._prepare(l32, traj, last_obs)
    data64, obs64, value64 = ppo._prepare(l64, to_float64(traj), to_float64(last_obs))
    scale = lambda x: float(x.abs().max())
    diff = lambda a, b: float((a.double() - b).abs().max())

    report = {"task": task, "envs": envs, "minibatch": ppo.mb_size, "steps": steps,
              "device": str(dev)}
    report["samples"] = {k: diff(data32[k], data64[k]) / scale(data64[k])
                         for k in ("adv", "return_n", "value_n")}
    stats = {}
    for tag, a, b, old in (("obs", obs32, obs64, ts.obs_stats),
                           ("value", value32, value64, ts.value_stats)):
        for field, x, y, z in zip(a._fields, a, b, old):
            err = diff(x, y)
            stats[f"{tag} {field}"] = dict(ulps=err / (scale(y) * FLOAT32_EPS),
                                           over_change=err / max(diff(z, y), 1e-300))
    report["stats"] = stats

    p32, s32, lr32, aux32 = ppo._sgd(l32, data32, minibatches)
    p64, s64, lr64, aux64 = ppo._sgd(l64, data64, minibatches)
    for kind, a, b, start in (("param", p32, p64, l32.params),
                              ("adam mu", s32.mu, s64.mu, l32.opt_state.mu),
                              ("adam nu", s32.nu, s64.nu, l32.opt_state.nu)):
        over_scale = over_change = 0.0
        for name, y in b.items():
            err = diff(a[name], y)
            over_scale = max(over_scale, err / scale(y))
            over_change = max(over_change, err / max(diff(start[name], y), 1e-300))
        report[kind] = dict(over_scale=over_scale, over_change=over_change)
    kls32, kls64 = aux32["kl"].tolist(), aux64["kl"].tolist()
    report.update(kl_float32=kls32, kl_float64=kls64, lr_float32=float(lr32),
                  lr_float64=float(lr64),
                  kl_min_margin=kl_margin(kls32 + kls64, ppo.cfg.kl_threshold))
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="Ur5SihLift", choices=sorted(TASK_CKPTS))
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--minibatch", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda unless given, e.g. cpu")
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.envs, a.minibatch, a.steps, a.device, a.task)), flush=True)


if __name__ == "__main__":
    main()
