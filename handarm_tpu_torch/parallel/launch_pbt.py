"""Local multi-process experiment launcher and parameter grids
(counterpart of handarm_tpu/parallel/launch_pbt.py; IsaacGymEnvs'
pbt/launcher/run_processes.py and run_description.py ParamGrid): the
cross-product of parameter values as command lines, run with bounded
parallelism, nothing restarted (each PBT job is fault-tolerant on its own,
parallel/pbt.py), exit codes collected.

CLI:
    python -m handarm_tpu_torch.parallel.launch_pbt \
        --max-parallel 2 --num-policies 4 \
        -- python -m handarm_tpu_torch.train task=Ur5SihLift pbt.policy_idx={policy_idx}

Library:
    cmds = experiment_grid(["python", "-m", "handarm_tpu_torch.train"], {"seed": [1, 2, 3]})
    run_processes(cmds, max_parallel=2)

Policies that share one card run side by side as separate processes (each
its own CUDA context). The slurm backend asks for one GPU per job and no
TPU by default (`gpus_per_job=1`, `tpus_per_job=0`).
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys
import time


def experiment_grid(base_cmd: list[str], params: dict[str, list]) -> list[list[str]]:
    """Cross-product of `params` appended to base_cmd as key=value args
    (reference ParamGrid, launcher/run_description.py)."""
    keys = list(params)
    cmds = []
    for combo in itertools.product(*(params[k] for k in keys)):
        cmds.append(
            list(base_cmd) + [f"{k}={v}" for k, v in zip(keys, combo)]
        )
    return cmds


def run_processes(
    cmds: list[list[str]],
    max_parallel: int = 2,
    poll_s: float = 0.5,
    env=None,
) -> list[int]:
    """Run all commands with at most `max_parallel` alive at once
    (reference launcher/run_processes.py run()). Returns exit codes in
    cmds order."""
    pending = list(enumerate(cmds))
    running: list[tuple[int, subprocess.Popen]] = []
    codes = [None] * len(cmds)
    while pending or running:
        while pending and len(running) < max_parallel:
            idx, cmd = pending.pop(0)
            running.append((idx, subprocess.Popen(cmd, env=env)))
        still = []
        for idx, p in running:
            rc = p.poll()
            if rc is None:
                still.append((idx, p))
            else:
                codes[idx] = rc
        running = still
        if running:
            time.sleep(poll_s)
    return codes


SBATCH_HEADER_DEFAULT = "#!/bin/bash\n"


def emit_slurm(
    cmds: list[list[str]],
    workdir: str,
    partition: str | None = None,
    gpus_per_job: int = 1,
    tpus_per_job: int = 0,
    cpus_per_job: int = 16,
    timeout: str = "0",
    header: str | None = None,
    submit: bool = False,
) -> list[tuple[str, str]]:
    """Slurm backend (reference launcher/run_slurm.py): write one sbatch
    script per experiment into `workdir` and return
    [(script_path, sbatch_cmdline)]; one GPU per job by default. With
    submit=True, also runs sbatch (the reference's default; its
    slurm_print_only flag maps to submit=False here, the safer default for
    a library call)."""
    os.makedirs(workdir, exist_ok=True)
    header = header if header is not None else SBATCH_HEADER_DEFAULT
    out = []
    for i, cmd in enumerate(cmds):
        script = os.path.join(workdir, f"job_{i:03d}.sh")
        with open(script, "w") as f:
            f.write(header)
            if not header.endswith("\n"):
                f.write("\n")
            f.write(" ".join(cmd) + "\n")
        os.chmod(script, 0o755)
        sbatch = ["sbatch", f"--cpus-per-task={cpus_per_job}",
                  f"--output={workdir}/job_{i:03d}.out"]
        if gpus_per_job:
            sbatch.append(f"--gres=gpu:{gpus_per_job}")
        if tpus_per_job:
            # TPU slices are exposed to Slurm as generic resources (a JAX job's)
            sbatch.append(f"--gres=tpu:{tpus_per_job}")
        if partition:
            sbatch += ["-p", partition]
        if timeout != "0":
            sbatch += ["--time", timeout]
        sbatch.append(script)
        cmdline = " ".join(sbatch)
        if submit:
            subprocess.run(sbatch, check=False)
        out.append((script, cmdline))
    return out


def emit_ngc(
    cmds: list[list[str]],
    job_template: str,
    names: list[str] | None = None,
    submit: bool = False,
) -> list[str]:
    """NGC-class backend (reference launcher/run_ngc.py): fill the user's
    job template ({{ name }} / {{ experiment_cmd }} placeholders,
    whitespace-normalized like the reference) and return the job command
    lines; submit=True shells them out."""
    tmpl = " ".join(job_template.replace("\\", " ").split())
    out = []
    for i, cmd in enumerate(cmds):
        name = names[i] if names else f"job_{i:03d}"
        line = tmpl.replace("{{ name }}", name).replace(
            "{{ experiment_cmd }}", " ".join(cmd)
        )
        if submit:
            subprocess.run(line, shell=True, check=False)
        out.append(line)
    return out


def main(argv):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--max-parallel", type=int, default=2)
    p.add_argument("--num-policies", type=int, default=4)
    p.add_argument("--backend", choices=("processes", "slurm", "ngc"),
                   default="processes")
    p.add_argument("--workdir", default="pbt_jobs",
                   help="slurm backend: where sbatch scripts/logs go")
    p.add_argument("--partition", default=None)
    p.add_argument("--timeout", default="0")
    p.add_argument("--submit", action="store_true",
                   help="slurm/ngc: actually submit instead of print-only")
    p.add_argument("--job-template", default=None,
                   help="ngc backend: template file with {{ name }} and "
                   "{{ experiment_cmd }} placeholders")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command template after --; {policy_idx} is filled in")
    args = p.parse_args(argv)
    template = [a for a in args.cmd if a != "--"]
    cmds = [
        [part.format(policy_idx=i) for part in template]
        for i in range(args.num_policies)
    ]
    if args.backend == "slurm":
        for script, cmdline in emit_slurm(
            cmds, args.workdir, partition=args.partition,
            timeout=args.timeout, submit=args.submit,
        ):
            print(cmdline)
        return 0
    if args.backend == "ngc":
        if not args.job_template:
            p.error("--backend ngc requires --job-template")
        with open(args.job_template) as f:
            tmpl = f.read()
        for line in emit_ngc(cmds, tmpl, submit=args.submit):
            print(line)
        return 0
    codes = run_processes(cmds, max_parallel=args.max_parallel)
    print("exit codes:", codes)
    return max(c or 0 for c in codes)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
