#!/usr/bin/env python3
"""Some phases of chip_smoke.py alone, on one GPU, each timed: the kernels'
build, then the named phases in this process, in the order given.

    python3 chip_phases.py franka-cube-stack franka-cabinet quad \\
        entry:FrankaCabinet entry:Quadcopter subprocess-entry:Quadcopter

Phases: a classic task's chip_smoke phase by its name (quad, ingenuity,
franka-cube-stack, franka-cabinet, trifinger, allegro-hand, shadow-hand,
dextreme, allegro-kuka, allegro-kuka-two-arms, factory, industreal),
`entry:TASK` (the task's train entry
point as `train.main` in this process, its checkpoint read back whole:
chip_smoke's `classic_entry`; `entry:TASK,KEY=VALUE,...` adds overrides,
as `entry:AllegroKukaTwoArms,env.subtask=regrasping`) and `subprocess-entry:TASK` (the same
command in a process of its own, `python -m handarm_tpu_torch.train`).
The seconds of each and their records go to chiprun_out/chip_phases.json.
A phase run first in its process pays the process's first cuBLAS,
allocator and profiler costs: its seconds read high against chip_smoke's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import chip_smoke as cs

CLASSIC_PHASES = {"quad": "Quadcopter", "ingenuity": "Ingenuity",
                  "franka-cube-stack": "FrankaCubeStack", "franka-cabinet": "FrankaCabinet",
                  "trifinger": "Trifinger", "allegro-hand": "AllegroHand",
                  "shadow-hand": "ShadowHand", "allegro-kuka": "AllegroKukaReorientation",
                  "allegro-kuka-two-arms": "AllegroKukaTwoArmsReorientation"}


def main(names: list[str]) -> int:
    threading.Thread(target=cs._watchdog, daemon=True).start()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_phases: torch.cuda.is_available() is False\n")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    cs.log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from handarm_tpu_torch import rollout
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.ops import build
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import prep_deff as deff_op
    from handarm_tpu_torch.ops import sdf_gather as sdf_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    with cs.phase("build"):
        build.library()
        for line in cs.ptxas_summary(build.ptxas_report()):
            cs.log(line)
    ops = {"sweep": (sweep_op, "contact_sweep"), "spd": (spd_op, "spd_inverse"),
           "sdf": (sdf_op, "sdf_sample"), "deff": (deff_op, "robot_deff")}
    seconds, rec = {}, {}
    for name in names:
        kind, _, task = name.partition(":")
        t0 = time.perf_counter()
        if kind in ("franka-cube-stack", "franka-cabinet"):
            with cs.phase(kind):
                rec[name] = cs.franka_phase(rollout, dev, ops, CLASSIC_PHASES[kind])
        elif kind in ("trifinger", "allegro-hand", "shadow-hand"):
            with cs.phase(kind):
                rec[name] = cs.hand_phase(rollout, dev, ops, CLASSIC_PHASES[kind])
        elif kind == "dextreme":
            with cs.phase(kind):
                rec[name] = cs.dextreme_phase(rollout, dev, ops)
        elif kind in ("allegro-kuka", "allegro-kuka-two-arms"):
            with cs.phase(kind):
                rec[name] = cs.allegro_kuka_phase(rollout, dev, ops, CLASSIC_PHASES[kind])
        elif kind == "factory":
            with cs.phase(kind):
                rec[name] = cs.factory_phase(rollout, dev, ops)
        elif kind == "industreal":
            with cs.phase(kind):
                rec[name] = cs.industreal_phase(rollout, dev, ops)
        elif kind in CLASSIC_PHASES:
            with cs.phase(kind):
                rec[name] = cs.classic_phase(rollout, dev, ops, CLASSIC_PHASES[kind])[0]
        elif kind == "entry":
            task, *extra = task.split(",")  # entry:AllegroKukaTwoArms,env.subtask=regrasping
            cfg, _ = resolve_task(task, [f"env.num_envs={cs.task_envs(task)}", *extra])
            with cs.phase("classic-entry"):
                rec[name] = cs.classic_entry(rollout, dev, task,
                                             type(build_env(cfg, "cpu")).state_type, extra)
        elif kind == "subprocess-entry":
            with cs.phase("classic-entry"):
                rec[name] = cs.run_module("handarm_tpu_torch.train", [
                    f"task={task}", f"env.num_envs={cs.task_envs(task)}",
                    f"max_iterations={cs.CLASSIC_ENTRY_ITERS}",
                    f"experiment=chip_phases_{task.lower()}"], name,
                    cs.PHASE_DEADLINE_S["classic-entry"] - 30)[0]
        else:
            raise SystemExit(f"chip_phases: unknown phase {name!r}")
        seconds[name] = time.perf_counter() - t0
    cs.log(json.dumps(seconds))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_phases.json"), "w") as f:
        json.dump({"card": smi, "seconds": seconds, "records": rec}, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
