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

    python -m handarm_tpu_torch.update_precision --recurrent --envs 64 --seqs 256

measures the recurrent asymmetric learner the same way, at its full widths
(`envs.tasks.LSTM_LIFT`: ShadowHandOpenAI_LSTM's learner on Ur5SihLift):
from a flax-default init and one train iteration, one minibatch of `--seqs`
sequences of a second rollout, its loss terms and gradients (`PPO._grads`)
in float32 and float64 (`grad_errors`; on the card, chip_smoke.py's
rnn-train phase calls it on the card's own first minibatch).
"""

from __future__ import annotations

import argparse
import json

import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.hand_arm import HandArmEnv
from handarm_tpu_torch.envs.registry import resolve_task
from handarm_tpu_torch.envs.tasks import LSTM_LIFT
from handarm_tpu_torch.learn.ppo import PPO, ppo_config
from handarm_tpu_torch.rollout import TASK_CKPTS, make_task_env
from handarm_tpu_torch.utils.checkpoint import load_train_state

FLOAT32_EPS = 2.0 ** -23  # one ulp of a float32 in [1, 2)


def tree_apply(fn, x):
    """fn of every tensor of nested tuples, NamedTuples and dicts."""
    if isinstance(x, dict):
        return {k: tree_apply(fn, v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [tree_apply(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return fn(x) if torch.is_tensor(x) else x


def to_float64(x):
    """Floating tensors of nested tuples, NamedTuples and dicts as float64."""
    return tree_apply(lambda t: t.double() if t.is_floating_point() else t, x)


def grad_errors(ppo, args) -> dict:
    """One minibatch's loss terms and gradients (`ppo._grads(*args)`, args
    = (stats, params, minibatch)) computed on the args' device, on the CPU
    in float32 and on the CPU in float64. For each pair (device and CPU
    against float64, and against each other): each loss term's absolute
    difference ("loss", with the float64 values under "loss_f64"), and the
    largest over the tensors of each gradient's largest difference over
    the float64 gradient's largest value ("grad"; a tensor whose float64
    gradient is 0 everywhere, as the asymmetric actor's value head's, counts
    its largest difference itself)."""
    cpu_args = tree_apply(lambda t: t.cpu(), args)
    outs = {"device": ppo._grads(*args), "cpu": ppo._grads(*cpu_args),
            "f64": ppo._grads(*to_float64(cpu_args))}
    g64, t64 = outs["f64"]
    report = {"loss_f64": {k: float(v) for k, v in t64.items()}}
    for a, b in (("device", "f64"), ("cpu", "f64"), ("device", "cpu")):
        (ga, ta), (gb, tb) = outs[a], outs[b]
        grad = 0.0
        for k, g in g64.items():
            scale = float(g.abs().max())
            err = float((ga[k].cpu().double() - gb[k].cpu().double()).abs().max())
            grad = max(grad, err / scale if scale > 0 else err)
        report[f"{a} vs {b}"] = {
            "loss": {k: abs(float(ta[k]) - float(tb[k])) for k in tb}, "grad": grad}
    report["sequences"] = int(args[2]["adv"].shape[0])
    return report


def measure_recurrent(envs: int, seqs: int, device=None) -> dict:
    """`grad_errors` of one minibatch of `seqs` sequences of the LSTM_LIFT
    learner at `envs` envs, from a flax-default init after one iteration."""
    dev = resolve_device(device)
    env_cfg, over = resolve_task("Ur5SihLift", [f"num_envs={envs}", *LSTM_LIFT])
    ppo = PPO(HandArmEnv(env_cfg, dev), ppo_config(over))
    ts, _ = ppo.train_iter(ppo.init(0))
    r = ppo.rollout(ts)
    data = ppo._prepare(ts, r.traj, r.last_obs, r.last_teacher_obs, r.last_hidden)[0]
    n = data["adv"].shape[0]
    if seqs > n:
        raise ValueError(f"{seqs} sequences: the rollout has {n}")
    idx = torch.randperm(n, generator=ppo.gen, device=dev)[:seqs]
    mb = {k: v.index_select(0, idx) for k, v in data.items()}
    report = grad_errors(ppo, ((ts.obs_stats, ts.teacher_obs_stats), ts.params, mb))
    return dict(envs=envs, device=str(dev), **report)


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
    traj, _, last_obs = ppo.rollout(ts)[:3]
    n = envs * ppo.cfg.horizon
    perms = torch.stack([torch.randperm(n, generator=ppo.gen, device=dev)
                         for _ in range(ppo.cfg.mini_epochs)])
    minibatches = perms.reshape(-1, ppo.mb_size)[:steps]
    l32 = ts._replace(env_state=None, last_obs=None)
    l64 = to_float64(l32)
    data32, obs32, value32, _ = ppo._prepare(l32, traj, last_obs)
    data64, obs64, value64, _ = ppo._prepare(l64, to_float64(traj), to_float64(last_obs))
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
    ap.add_argument("--recurrent", action="store_true",
                    help="the LSTM_LIFT learner's gradients instead (--envs, --seqs)")
    ap.add_argument("--seqs", type=int, default=256, help="sequences of the --recurrent minibatch")
    ap.add_argument("--device", default=None, help="cuda unless given, e.g. cpu")
    a = ap.parse_args(argv)
    out = (measure_recurrent(a.envs, a.seqs, a.device) if a.recurrent
           else measure(a.envs, a.minibatch, a.steps, a.device, a.task))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
