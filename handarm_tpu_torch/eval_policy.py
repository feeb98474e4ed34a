"""Deterministic evaluation of a PPO checkpoint or a distilled student:
success rate over the episodes completed in a window (counterpart of
scripts/eval_policy.py):

    python -m handarm_tpu_torch.eval_policy [--ckpt PATH] [--task Ur5SihLift]
        [--envs 1024] [--steps 600] [--seed 123] [--episode-length N] [--device cpu]
    python -m handarm_tpu_torch.eval_policy --student runs/distill/student.npz
        --teacher PATH [--student-obs NAME,NAME,...] [the options above]

The task is composed from its yaml config group as the training entry
point composes it (the multi-object task: 16 solver sweeps, as
scripts/eval_policy.py evaluates it); `--ckpt` defaults to the task's own
checkpoint (`rollout.TASK_CKPTS`: Ur5SihLift, Ur5SihMultiObjectManipulation,
StretchLift). The policy's mean action drives
the env; a student (`student.npz` of train_distill, or of the JAX
package's) acts in the env that train_distill builds: the student's
observations, the teacher's as teacher observations (the teacher's
checkpoint only defines those; its width is checked). One zero-action
step, then a burn-in of one episode length,
after which the env's `total_resets` and `total_successes` counters are
zeroed, then `--steps` more control steps; the rate is total_successes /
total_resets over that window. (`evaluate(..., burn_in=False)` zeroes every
env's clock at the reset instead, so that the first episodes are whole and
policy-driven from the start and no burn-in is needed: the same count of
whole episodes in a window of one episode length.) Prints one JSON line: task, policy,
episodes, successes, success_rate, success_ewma, per_object_ewma. Runs on
`cuda` unless given `--device cpu`.

A checkpoint of the asymmetric or recurrent learner raises
NotImplementedError: the JAX package's scripts/eval_policy.py cannot
evaluate one either (it feeds the critic no teacher observations and
carries no LSTM state), so the port offers no other way. A recurrent
policy is served through `PPO.act`, which threads its carry.
"""

from __future__ import annotations

import argparse
import json

import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.learn.distill import StudentPolicy
from handarm_tpu_torch.rollout import (
    TASK_CKPTS,
    Student,
    forward_step,
    load_policy,
    make_task_env,
)
from handarm_tpu_torch.train_distill import DEFAULT_STUDENT_OBS, student_setup
from handarm_tpu_torch.utils.checkpoint import read_student


def evaluate(ckpt: str | None = None, task: str = "Ur5SihLift", envs: int = 1024,
             steps: int = 600, seed: int = 123, device=None,
             episode_length: int | None = None, pool=None, student: str | None = None,
             teacher: str | None = None, student_obs: str = DEFAULT_STUDENT_OBS,
             burn_in: bool = True):
    """(the JSON record, the env's final state). `pool`: a genesis pose
    pool to use instead of running genesis (drop-init tasks). With
    `student`, that student.npz is evaluated (`teacher` required). Without
    `burn_in`, every env's episode clock starts at 0 at the reset and the
    `steps` are counted from there (each env ends one whole episode in a
    window of one episode length)."""
    dev = resolve_device(device)
    over = {} if episode_length is None else {"episode_length": episode_length}
    if student:
        if not teacher:
            raise ValueError("a student's evaluation needs its --teacher")
        env, _, cloud_keys, aux = student_setup(task, envs, teacher, student_obs, dev, pool,
                                                **over)
        net = StudentPolicy(env.num_obs, env.num_actions, cloud_keys,
                            aux_heads={k: e - s for k, (s, e) in aux.items()}).to(dev)
        policy, ckpt = Student(net, read_student(student, net, dev)), student
    else:
        ckpt = ckpt or TASK_CKPTS[task]
        policy = load_policy(ckpt, dev)
        env = make_task_env(task, envs, dev, pool=pool, **over)
    state, _ = env.reset(seed)
    if not burn_in:
        state = state._replace(task=state.task._replace(
            progress=torch.zeros_like(state.task.progress)))
    state, res = env.step(state, torch.zeros(envs, env.num_actions, device=dev))
    obs = policy.observe(res)
    ep = env.cfg.episode_length if burn_in else 0
    for t in range(steps + ep):
        state, obs, _, _ = forward_step(env, policy, state, obs)
        if t == ep - 1:  # burn-in done: count only policy-driven episodes
            zero = torch.zeros_like(state.metrics.total_resets)
            state = state._replace(metrics=state.metrics._replace(
                total_resets=zero, total_successes=zero.clone()))
    m = state.metrics
    resets, succ, ewma, *per_object = torch.cat(
        [m.total_resets[None], m.total_successes[None], m.success_ewma[None],
         m.per_object_ewma]).tolist()
    return {
        "task": task, "policy": ckpt, "episodes": int(resets), "successes": int(succ),
        "success_rate": succ / max(resets, 1.0), "success_ewma": ewma,
        "per_object_ewma": per_object,
    }, state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None, help="PPO checkpoint .npz (default: the task's)")
    ap.add_argument("--student", default=None, help="distilled student.npz")
    ap.add_argument("--teacher", default=None,
                    help="the student's teacher checkpoint (defines its observations)")
    ap.add_argument("--student-obs", default=DEFAULT_STUDENT_OBS)
    ap.add_argument("--task", default="Ur5SihLift")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=600,
                    help="control steps after the burn-in (600 = 3 episodes of 200)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--episode-length", type=int, default=None,
                    help="default: the task's (200; the Stretch's 400)")
    ap.add_argument("--device", default=None, help="default: cuda")
    a = ap.parse_args(argv)
    out, _ = evaluate(a.ckpt, a.task, a.envs, a.steps, a.seed, a.device, a.episode_length,
                      student=a.student, teacher=a.teacher, student_obs=a.student_obs)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
