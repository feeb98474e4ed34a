"""Teacher-student distillation entry point (counterpart of
scripts/train_distill.py):

    python -m handarm_tpu_torch.train_distill --teacher PATH [--task Ur5SihLift]
        [--envs 8192] [--iters 800] [--seed 42] [--out runs/distill]
        [--beta-decay-iters 400] [--student-obs NAME,NAME,...] [--device cpu]

The teacher is a PPO checkpoint in the JAX package's format, acting
deterministically on the task's observations as `compose_task` composes
them. The student's env is the same task with the deployable observation
list (`--student-obs`; its point clouds go to `obs_dict`) and the
teacher's list as `teacher_observations`, so both come out of one env
step. Auxiliary heads regress `target_object_pos`, `object_pos` and
`sih_fingertip_pos` where the teacher observes them. DAgger runs with
horizon 16, minibatch min(32768, 4 x envs) and 2 mini-epochs.

Writes `--out`/config.yaml (as the JAX script writes it), appends a row
of stats to metrics.jsonl every 10 iterations and after the last (the only
host reads), and writes student.npz (the JAX package's layout, which its
`scripts/eval_policy.py --student` reads). Runs on `cuda` unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.registry import resolve_task
from handarm_tpu_torch.learn.distill import DAgger, DistillConfig
from handarm_tpu_torch.rollout import load_policy, make_task_env
from handarm_tpu_torch.train import drain_stats
from handarm_tpu_torch.utils.checkpoint import save_student

DEFAULT_STUDENT_OBS = ("ur5_joint_pos,ur5_flange_pose,dof_position_targets,"
                       "target_object_synthetic_pointcloud,target_object_to_goal_pos")
AUX_TARGETS = ("target_object_pos", "object_pos", "sih_fingertip_pos")


def student_setup(task: str, envs: int, teacher: str, student_obs: str, device, pool=None,
                  **overrides):
    """(student env, teacher Policy, cloud keys, aux slices) of a task, as
    scripts/train_distill.py builds them; `overrides` replace fields of the
    student env's config, `pool` is a genesis pose pool to use."""
    cfg, _ = resolve_task(task, [f"env.num_envs={envs}"])
    names = tuple(s for s in student_obs.split(",") if s)
    env = make_task_env(task, envs, device, pool=pool, observations=names,
                        teacher_observations=cfg.observations, **overrides)
    policy = load_policy(teacher, env.device)
    width = policy.net.trunk[0].in_features
    if width != env.num_teacher_obs:
        raise ValueError(f"the teacher {teacher} reads {width} observations; {task}'s "
                         f"are {env.num_teacher_obs}")
    cloud_keys = tuple(s for s in names if "pointcloud" in s)
    aux = {k: env.teacher_obs_slices[k] for k in AUX_TARGETS if k in env.teacher_obs_slices}
    return env, policy, cloud_keys, aux


def distill_config(envs: int, beta_decay_iters: int, cloud_keys: tuple) -> DistillConfig:
    return DistillConfig(horizon=16, minibatch_size=min(32768, envs * 4), mini_epochs=2,
                         beta_decay_iters=beta_decay_iters, cloud_keys=cloud_keys)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--teacher", required=True, help="teacher PPO checkpoint (.npz)")
    ap.add_argument("--task", default="Ur5SihLift")
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="runs/distill")
    ap.add_argument("--beta-decay-iters", type=int, default=400)
    ap.add_argument("--student-obs", default=DEFAULT_STUDENT_OBS,
                    help="the student's observations, comma-separated")
    ap.add_argument("--device", default=None, help="default: cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    env, teacher, cloud_keys, aux = student_setup(a.task, a.envs, a.teacher, a.student_obs,
                                                  dev)
    print(f"teacher loaded from {a.teacher}", flush=True)
    dagger = DAgger(env, teacher, distill_config(a.envs, a.beta_decay_iters, cloud_keys),
                    aux_from_obs=aux)
    ds = dagger.init(a.seed + 1)

    os.makedirs(a.out, exist_ok=True)
    student_obs = [s for s in a.student_obs.split(",") if s]
    with open(os.path.join(a.out, "config.yaml"), "w") as f:
        f.write(f"task: {a.task}\nteacher: {a.teacher}\nenvs: {a.envs}\niters: {a.iters}\n"
                f"seed: {a.seed}\nstudent_obs: {student_obs}\naux: {list(aux)}\n")
    t_start = time.time()
    with open(os.path.join(a.out, "metrics.jsonl"), "a") as mf:
        for it in range(a.iters):
            ds, stats = dagger.train_iter(ds)
            if (it + 1) % 10 == 0 or it == a.iters - 1:
                row = dict(step=it + 1, t=round(time.time() - t_start, 1), **drain_stats(stats))
                mf.write(json.dumps(row) + "\n")
                mf.flush()
                print(json.dumps(row), flush=True)
    path = save_student(os.path.join(a.out, "student.npz"), dagger.net, ds.params)
    print("saved student to", path, flush=True)


if __name__ == "__main__":
    main()
