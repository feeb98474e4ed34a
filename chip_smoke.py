#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port (handarm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each with a deadline and one flushed progress line:
  1. device    CUDA must be present; prints the card's name and power limit.
  2. build     compiles the kernels in handarm_tpu_torch/csrc (one nvcc per
               source, all started together, then one link) and prints each
               kernel's registers, spills and shared memory (-Xptxas -v).
  3. rollout   Ur5SihLift at 8192 envs on the in-repo stand-in robot, policy
               docs/evidence/lift_r3a/ckpt_5200.npz, reset + 31 deterministic
               policy-in-the-loop control steps; every state leaf must stay
               finite and the launch counters must show both of its kernels
               (spd_inverse once and contact_sweep 6 times per step).
  4. kernels   spd_inverse and contact_sweep against their plain PyTorch
               versions on inputs captured from that rollout, then timed.
               The sweep also runs a dense case (every slot made active, all
               link groups and object bins carrying impulses) and a robot
               case (only the robot's slots active, 2 sweeps: every link
               group carrying impulses at an ordinary scale); two launches
               of each kernel on the same inputs must be bit-identical.
  5. cpu-ref   16 envs of that rollout picked for robot-object impulses,
               at the step (the last timed one or one of 20 more, untimed)
               where the most envs push the box with the hand: 2 control
               steps on the card and on the CPU (plain versions) must
               agree, and the compared state must have active robot-object
               slots.
  6. multiobj  Ur5SihMultiObjectManipulation at 8192 envs as the entry
               points compose it from configs/ (3 YCB meshes, 372 slots, 16
               solver sweeps): genesis drop-init builds the pose pool, then a
               warm-up and 20 timed control steps of the
               docs/evidence/multiobj_r5a/ckpt_2700.npz policy. Counters are
               zeroed before genesis and read after the last step: each of
               the four kernels must show exactly its launches on this path
               (per genesis sim step: sdf_gather 1 (one per contact
               generation), prep_deff 1, spd_inverse 1, contact_sweep 2;
               per control step: 3, 1, 1, 6); every state leaf must stay
               finite.
  7. multiobj-kernels  all four kernels against their plain versions on
               inputs captured from that rollout (sdf_gather: the one call
               of a contact generation, every output channel; the sweep at
               K = 3 with both object sides, and its dense case),
               bit-identical over two launches, then timed beside their
               bounds, their plain versions and a one-call library
               equivalent. A kernel's "ms" is the replay of a CUDA graph of
               50 launches (device time; "eager_ms" launches them from
               Python one by one), as is grid_sample's; plain versions run
               eagerly. torch.linalg.inv is timed as a graph where capture
               works, else as the device time of its eager call
               (profiler), beside its eager time.
  8. multiobj-ref  2 control steps at 16 envs on the card and on the CPU
               (the deff path forced at this size) must agree, from the
               state of 16 envs of that rollout whose last solve pushed on
               robot-object and object-pair slots; the compared state must
               have active slots of both kinds.
  9. train     Ur5SihLift PPO at 8192 envs (horizon 16, minibatch 8192: 16
               minibatches x 4 mini-epochs, the 768-512-256 MLP), from
               ckpt_5200's params, Adam state, stats, lr and epoch read by
               the port's own loader, on a fresh reset: one warm-up
               train_iter, 3 iterations timed as rollout and update (each
               part between torch.cuda.synchronize calls), then one
               untimed iteration whose steps are kept. Counters are zeroed
               before each iteration and read after it: spd_inverse 16,
               contact_sweep 96, prep_deff 0, sdf_gather 0. Params and Adam
               moments must stay finite, Adam's count rise by 64 per
               iteration less the non-finite skips, the params move. The
               kept iteration against the CPU: each of its 64 minibatch
               steps rerun there from the card's inputs (loss terms and KL
               at every step, the first step's gradients, the optimizer
               step at every step: `compare_steps`); its prepared samples
               and stats, and its first minibatch's gather, against the
               CPU's from the same learner and trajectory
               (`compare_prepared`); and its first 4 minibatch steps,
               chained on each side, against the CPU's: params, Adam
               moments, counters and lr (`compare_prefix`). Then the user's
               entry point,
               `python -m handarm_tpu_torch.train` resumed from ckpt_5200
               for 2 iterations, must write its checkpoint (launches 32 and
               192).
 10. eval      handarm_tpu_torch.eval_policy for ckpt_5200 on Ur5SihLift at
               8192 envs: a zero-action step, a burn-in of 200 steps, 200
               counted steps (spd_inverse 401 launches, contact_sweep
               2,406); at least 3,000 episodes, every state leaf finite.
 11. reach     Ur5SihReach from a flax-default init at its preset size (64
               envs), 10 train iterations; reward_mean per iteration;
               every param and stat finite; spd_inverse 16 and
               contact_sweep 96 launches per iteration.
 12. family    Ur5SihReposition, OrientedReposition, Repose and Throw, each
               composed from configs/ at 8192 envs: one warm-up and 2 timed
               train iterations from a flax-default init (launches exactly
               spd_inverse 16 and contact_sweep 96 per iteration; prep_deff
               and sdf_gather 0, checked from the built scene: B * C < 2^21,
               no mesh object), params and stats finite; then 2 control
               steps of 16 of its envs on the card and on the CPU with
               actions from a numpy seed. Then the user's entry point in
               its own process at full width for one iteration:
               `python -m handarm_tpu_torch.train task=Ur5SihThrow
               env.num_envs=8192 max_iterations=1`.
 13. multiobj-train  Ur5SihMultiObjectManipulation as `train.py` composes
               it (16 sweeps; minibatch 32768 and every switch of its train
               yaml: 4 minibatches x 4 mini-epochs) at 8192 envs, on the
               multiobj phase's genesis pool, from ckpt_2700's learner:
               as phase 9 (1 warm-up, 3 timed, 1 kept iteration held
               against the CPU step by step), launches per iteration
               exactly spd_inverse 16, prep_deff 16, sdf_gather 48,
               contact_sweep 96. (Run before phase 9.)
 14. multiobj-eval  ckpt_2700's deterministic success rate in that composed
               environment on the same pool, as phase 10: at least 3,000
               episodes; launches per step 1, 1, 3, 6. (Run before phase 9.)
 15. multiobj-entry  the user's entry point in its own process, reading
               the multiobj phase's genesis pool (HANDARM_POOL_CACHE, set
               for the whole script): `python -m handarm_tpu_torch.train
               task=Ur5SihMultiObjectManipulation
               resume=docs/evidence/multiobj_r5a/ckpt_2700.npz
               max_iterations=2701` must write ckpt_2701.npz.
 16. clouds    every synthetic point-cloud observable (object, target,
               target interval and its position, robot, goal, scene) and
               the teacher observations of Ur5SihLift, 2 control steps of
               ckpt_5200 at 16 envs on the card and on the CPU from the
               cpu-ref state, with the same subsampling scores on both
               sides: every cloud by key (types and row order exact, xyz
               within 5e-4), the flat and teacher observations within 2e-3.
               (Run after phase 5.)
 17. distill-train  DAgger (`learn/distill.py`) distilling ckpt_5200 into a
               PointNet student on Ur5SihLift at 8192 envs, as
               `train_distill` builds it (horizon 16, 4 minibatches of
               32768 x 2 mini-epochs): one warm-up iteration, 3 timed as
               rollout and update, then one whose first minibatch step is
               rerun on the CPU from the card's inputs (loss terms,
               gradients, and the optimizer step: `distill_step_check`).
               Launches per iteration exactly spd_inverse 16,
               contact_sweep 96, prep_deff 0, sdf_gather 0.
 18. distill-eval  the student docs/evidence/distill_r5a/student.npz
               (`eval_policy --student`, teacher ckpt_5200) at 8192 envs,
               as phase 10: at least 8,192 episodes; launches per step 1
               spd_inverse and 6 contact_sweep.
 19. distill-entry  the user's entry points, each in its own process:
               `python -m handarm_tpu_torch.train_distill --teacher
               ckpt_5200 --envs 8192 --iters 2` must write student.npz (18
               finite leaves) and metrics; `python -m
               handarm_tpu_torch.eval_policy --student` of that file at
               8192 envs, 5-step episodes, must count 16,384 episodes.
 20. rnn-train  ShadowHandOpenAI_LSTM's learner on Ur5SihLift as `train.py`
               composes it from the `envs.tasks.LSTM_LIFT` overrides
               (an LSTM 1024 actor on 33 observations, an LSTM 1024
               central-value critic on the 121 teacher observations, MLP
               [512], seq_len 4, gamma 0.998; 4 minibatches of 8,192
               sequences x 4 mini-epochs) at 8192 envs from a flax-default
               init: one warm-up, 3 timed iterations (rollout and update
               seconds, train env-steps/s, peak device memory), launches
               exactly 16 / 96 / 0 / 0 per iteration; then a kept
               iteration's first minibatch step from the card's inputs
               (`rnn_step_check`): its first 1,024 sequences' loss terms
               and gradients on the card, on the CPU and in float64,
               within tolerances set from update_precision's float32
               error, and its optimizer step as `compare_steps` holds it.
 21. rnn-serve  30 deterministic `PPO.act` control steps of that learner
               at 8192 envs, the carry threaded (zeroed where an episode
               ends): serving env-steps/s, launches 1 / 6 per step; then
               16 of its envs (clocks zeroed) 2 control steps on the card
               and on the CPU, each side acting on its own observations
               and carry: actions, carries, q and observations held.
 22. rnn-entry  `python -m handarm_tpu_torch.train task=Ur5SihLift
               num_envs=8192` with the LSTM_LIFT overrides in its own
               process for 2 iterations, then `resume=auto` for a third:
               both checkpoints read back with the PPOConfig (teacher
               stats, last teacher observations, carry), epoch 3, Adam
               count 48 less skips, metrics rows 0-2.
 23. dr-train  Ur5SihMultiObjectManipulation as `train.py` composes it with
               IsaacGymEnvs' ShadowHand domain randomization
               (`envs.tasks.DR_SHADOWHAND`: observation and action noise,
               gravity, mass, friction and PD gain scales) at 8192 envs, on
               the multiobj phase's pool, from ckpt_2700's learner on a
               fresh reset: one warm-up and 1 timed iteration (rollout and
               update seconds, train env-steps/s, peak memory); launches
               exactly spd_inverse 16, prep_deff 16, sdf_gather 48,
               contact_sweep 96 per iteration; every param, stat and state
               leaf finite. The DRState in play, read back from the state:
               each leaf's min and max, the scales inside their ranges,
               gravity_z's spread over the envs within 10 % of 0.4. The
               TrainState round-trips through `save_checkpoint` and the
               port's reader: the 30 env leaves come back equal. (Run after
               phase 14, on its pool.)
 24. dr-kernels  spd_inverse, prep_deff and contact_sweep against their
               plain versions on inputs captured from that rollout's last
               control step, as in phase 7 (tolerances, bit-identical
               launches, times). DR reached them: the sweep's mu plane over
               the base friction spans more than half of [0.7, 1.3] for one
               slot across envs; its invm planes over the base inverse
               masses lie in [1/1.5, 1/0.5] and vary; the SPD inverse's
               input differs from the same state's unscaled matrix by the
               scaled PD terms on its diagonal alone.
 25. dr-ref    16 envs of that rollout whose last solve pushed robot-object
               and object-pair slots (at least two distinct mass scales per
               object among them): 2 control steps with DR on the card and
               on the CPU with the same noise draws, at phase 8's bounds.
 26. adr       the same with `rl.randomization_params.adr.enabled=true`
               (AdrConfig's defaults over DR's noise): one warm-up and one
               timed iteration, the same launches; then `adr_step` on the
               card against the CPU at 8192 envs (queue 256) from the same
               state and draws, every env done at objective 1 for 3 steps,
               then 0 for 4: the bounds move out by delta a step and back;
               lo, hi, queues and worker modes exact, values within 1e-6;
               adr_entropy before, at the widest and after.
 27. dr-entry  the user's entry point in its own process, reading the
               same genesis pool (genesis runs without DR and ADR):
               `python -m handarm_tpu_torch.train
               task=Ur5SihMultiObjectManipulation
               resume=docs/evidence/multiobj_r5a/ckpt_2700.npz
               max_iterations=2701 <DR_SHADOWHAND>
               rl.randomization_params.adr.enabled=true` (the file has no
               DR: its learner is kept, the env reset) must write
               ckpt_2701.npz with 36 env leaves (83 in all); the port's
               reader reads it with the run's config, and refuses it given
               the config without DR. (Run after phase 15.)
 28. engine-env  Ur5SihMultiObjectManipulation as `train.py` composes it
               (16 sweeps) at 8192 envs on the multiobj phase's pool, with
               ckpt_2700's policy, under each engine option alone:
               `heavy_prep_per_control=False` (dynamics and prep every sim
               step), `carry_fk=False` (exact FK and contacts every sim
               step) and `hand_only_collision=False` (the arm's spheres
               too: 456 slots). One warm-up and 5 timed control steps each
               (env-steps/s); every state leaf finite; launches per control
               step exactly spd_inverse / contact_sweep / prep_deff /
               sdf_gather 3 / 6 / 3 / 3, 1 / 6 / 1 / 4 and 1 / 6 / 1 / 3.
               (Run after phase 8.)
 29. engine-api  `engine.step` on that scene at 8192 envs from the exact-FK
               run's state, 3 sim steps with `SimParams(substep_contacts=
               True)` (launches 3 / 6 / 3 / 9: every solve through
               `solve_prepared`, the sweep with apply_warm=False), then 3
               with `shared_prep=False` (`engine.substep`: 6 / 6 / 6 / 6);
               every state leaf finite.
 30. engine-kernels  as phase 7 (tolerances, bit-identical launches,
               times): the sweep kernel with apply_warm=False on the
               substep_contacts run's last solve, and the sweep and
               prep_deff at the arm-sphere slot groups (17 dof masks, 456
               slots) on the second control step of the arm-sphere scene
               with the table's edge off the mount (phase 31's), at 8192
               envs: the composed scene's shoulder impulses (~4e9) would
               make 1e-4 of scale meaningless; the captured impulses must
               stay under 1e3.
 31. engine-ref  from multiobj-ref's 16 envs: 2 control steps under each
               option on the card and on the CPU at phase 8's bounds (the
               arm-sphere scene with the table's edge moved off the mount
               on both sides: at the mount its shoulder spheres have zero
               effective mass and impulses past 1e9); then one sim step of
               `substep`, of `substep_contacts`, of restitution 0.8 and of
               Gauss-Seidel (`mode="gs"`, a Python loop over the slots: at
               16 envs only), q and positions within 2e-4, velocities 2e-3.
 32. engine-entry  `python -m handarm_tpu_torch.train task=Ur5SihLift
               num_envs=8192 heavy_prep_per_control=false carry_fk=false
               hand_only_collision=false max_iterations=1` in its own
               process must write ckpt_1.npz (190 contact slots), and a
               second process with `max_iterations=2 resume=auto` must
               resume it, env state included, and write ckpt_2.npz. (Run
               after phase 27.)
 33. stretch   the Hello-Robot Stretch on its in-repo stand-in (9 dofs,
               six prismatic; 24 hand spheres), both tasks as `train.py`
               composes them at 8192 envs: StretchLift (100 slots) serving
               docs/evidence/stretch_r5d/ckpt_4000.npz's policy, reset + 1
               warm-up + 30 timed control steps, and
               StretchMultiObjectManipulation (116 slots) under a seeded
               random policy, 1 + 20 steps. Counters zeroed before each
               reset and read after its last step: exactly spd_inverse 1,
               contact_sweep 6, prep_deff 0, sdf_gather 0 per step (B * C
               < 2^21; analytic SDFs); env-steps/s; every state leaf
               finite, every object inside the workspace.
 34. stretch-kernels  as phase 7 (tolerances, bit-identical launches,
               times, bounds, library times): spd_inverse at n = 9 and
               contact_sweep at nv = 9 (with its dense and robot cases: the
               3 hand link groups) on inputs captured from both rollouts'
               last step, prep_deff at nv = 9 on one more StretchLift step
               with the deff kernel forced (`deff_at_any_size`).
 35. stretch-ref  16 envs of each rollout: 2 control steps on the card
               and on the CPU (float32 solver prep on both sides, as phase
               8), each side acting on the CPU's actions, at phase 8's
               bounds.
 36. stretch-train  `python -m handarm_tpu_torch.train task=StretchLift
               resume=docs/evidence/stretch_r5d/ckpt_4000.npz
               max_iterations=4002` in its own process at the yaml's 1,024
               envs (ckpt_4000's own): the whole TrainState resumed, 2
               iterations, ckpt_4002.npz read back (69 leaves, 100 slots);
               then StretchMultiObjectManipulation at 8192 envs from a
               fresh init: one warm-up and one timed iteration, launches
               16 / 96 / 0 / 0.
 37. stretch-eval  ckpt_4000's deterministic success rate on StretchLift
               at 8192 envs (`eval_policy`): a burn-in of one 400-step
               episode, then 100 counted steps (a quarter episode: at
               least 1,500 episodes); launches per step 1 / 6 / 0 / 0.
 38. camera    Ur5SihMultiObjectManipulation as `train.py` composes it at
               8192 envs on the multiobj phase's pool, serving ckpt_2700's
               policy, with the topview camera (`CameraConfig()`: 160 x 90,
               fovx 87, max_depth 3) and its five observables in
               `obs_dict`: reset, one warm-up and 30 timed control steps,
               after the same without the camera (env-steps/s of both, peak
               device memory of the camera run). Counters zeroed before
               each reset: exactly spd_inverse 1, prep_deff 1, sdf_gather
               3, contact_sweep 6 per step; 147 observations either way;
               every state leaf and float image finite; the robot (id 1)
               and some object (ids 3-5) in more than half of the envs'
               segmentations. (Run after phase 26, on its pool.)
 39. camera-ref  16 envs of that run, on the card and on the CPU, at
               tests/test_torch_camera.py's tolerances outside its pixel
               rule (a point within 1e-4 px of a pixel edge, the pixels it
               may land in and their points are left out; counts printed):
               `render_points` on the card's world points (depth 1e-6;
               segmentation, color and visibility exact), the five
               observables of the same state with the same scores (the
               clouds exact in types and within 1e-5 in xyz in the envs the
               rule leaves whole), and `CameraRecorder` frames of 4 envs
               (uint8; a depth gray level may round apart only where the
               float depths differ).
 40. camera-distill  a DAgger student of ckpt_5200 on Ur5SihLift at 8192
               envs whose cloud is the camera's
               (`topview_target_object_pointcloud` in place of the
               synthetic target cloud, `train_distill`'s other settings):
               one warm-up and one timed iteration (rollout and update
               seconds, peak memory), launches exactly 16 / 96 / 0 / 0 per
               iteration; params finite; the target seen in most envs'
               last cloud. (Run after phase 19.)
 41. bench     `python -m handarm_tpu_torch.bench --envs 8192 --policy
               docs/evidence/lift_r3a/ckpt_5200.npz` in its own process:
               its stdout must be the 1,024-env line, then the 8192-env
               headline, each with bench.py's keys; then
               `graft_entry.entry()` and one forward step on the card
               (launches 1 / 6 / 0 / 0). (Run last.)
Each phase prints its seconds ("[phase] ok in ..."). The line before the
last is a JSON object naming every kernel with its numbers (the
multi-object path's, at 16 sweeps; the lift path's under "lift"), with
the training phases' numbers under "train", "multiobj_train", "family"
and "distill", and the evaluations' under "eval", "multiobj_eval" and
"distill" -> "eval", the recurrent learner's under "rnn", domain
randomization's and ADR's under "dr" (and each kernel's dr-kernels numbers
under its "dr" key in "kernels"), the engine phases' under "engine" (and
each kernel's launches on those paths and engine-kernels numbers under its
"engine" key in "kernels"), the Stretch phases' under "stretch" (and
each kernel's Stretch launches and stretch-kernels numbers under its
"stretch" key in "kernels"), the camera phases' under "camera" (and
each kernel's launches on the camera paths under its "camera" key in
"kernels"), the benchmark entry's under "bench"; the last line
is {"ok": true, "device": {...}}. Any fault prints a traceback and exits
non-zero; without CUDA it exits 2 before any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback

TOTAL_DEADLINE_S = 1170
PHASE_DEADLINE_S = {"device": 60, "build": 420, "rollout": 300, "kernels": 180,
                    "cpu-ref": 240, "clouds": 180, "multiobj": 480, "multiobj-kernels": 240,
                    "multiobj-ref": 300, "multiobj-train": 420, "multiobj-eval": 300,
                    "train": 420, "eval": 300, "reach": 300, "family": 480,
                    "multiobj-entry": 480, "distill-train": 360, "distill-eval": 300,
                    "distill-entry": 360, "rnn-train": 360, "rnn-serve": 240, "rnn-entry": 330,
                    "dr-train": 300, "dr-kernels": 240, "dr-ref": 300, "adr": 240,
                    "dr-entry": 480, "engine-env": 300, "engine-api": 180,
                    "engine-kernels": 240, "engine-ref": 300, "engine-entry": 330,
                    "stretch": 240, "stretch-kernels": 180, "stretch-ref": 180,
                    "stretch-train": 300, "stretch-eval": 240, "camera": 240,
                    "camera-ref": 180, "camera-distill": 240, "bench": 240}
ENVS = 8192
STEPS = 30  # timed lift control steps, after one warm-up step
LIFT_EXTRA_STEPS = 20  # untimed lift steps searched for robot-object contact
MULTI_TASK = "Ur5SihMultiObjectManipulation"
MULTI_STEPS = 20  # multi-object control steps after genesis and reset
TRAIN_ITERS = 3  # timed lift train iterations, after one warm-up iteration
ENTRY_ITERS = 2  # iterations of the train entry point, resumed from ckpt_5200
EVAL_STEPS = 200  # counted eval steps, after a burn-in of one episode (200)
REACH_ITERS = 10
FAMILY = ("Ur5SihReposition", "Ur5SihOrientedReposition", "Ur5SihRepose", "Ur5SihThrow")
FAMILY_ITERS = 2  # timed family train iterations, after one warm-up iteration
PREFIX_STEPS = 4  # chained minibatch steps of the kept update rerun on the CPU
DISTILL_ITERS = 3  # timed DAgger iterations, after one warm-up iteration
DISTILL_ENTRY_ITERS = 2  # iterations of the train_distill entry point
STUDENT = os.path.join("docs", "evidence", "distill_r5a", "student.npz")
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, same source
FLOAT32_EPS = 2.0 ** -23  # one ulp of a float32 in [1, 2)
SDF_FLOPS_PER_POINT = 112  # 6 for u, 18 for the excess, 7 lerps x 4 channels x 3, 3 weights, 1


def log(msg: str) -> None:
    print(msg, flush=True)


def _watchdog() -> None:
    time.sleep(TOTAL_DEADLINE_S)
    sys.stderr.write(f"chip_smoke: overall deadline of {TOTAL_DEADLINE_S} s passed\n")
    sys.stderr.flush()
    os._exit(3)


@contextlib.contextmanager
def phase(name: str):
    def on_alarm(signum, frame):
        raise TimeoutError(f"phase {name} passed its {PHASE_DEADLINE_S[name]} s deadline")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(PHASE_DEADLINE_S[name])
    t0 = time.perf_counter()
    log(f"[{name}] start")
    try:
        yield
    finally:
        signal.alarm(0)
    log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel: its name and template arguments, then
    the compiler's registers and static shared memory, stack and spills."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:  # the kernel's name in the mangled one: digits precede it
            k = re.search(r"([a-z][a-z_]*_kernel)(I((?:Li-?\d+E)+)E)?", m.group(1))
            name = k.group(1) if k else m.group(1)
            if k and k.group(3):
                name += f"<{', '.join(re.findall(r'Li(-?[0-9]+)E', k.group(3)))}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"ptxas: {name}: {line.split('Used', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return out


def cuda_time_ms(fn, reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean ms per call between CUDA events. With `graph`, the `reps` calls
    are captured in one CUDA graph and the events bracket its replay: the
    device time without the host's launch gaps, which bound eager calls of
    a kernel that runs for tens of microseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_times(fn, reps: int) -> dict:
    """The kernel's device time (graph replay) and its time when launched
    eagerly from Python, one launch after another."""
    return dict(ms=cuda_time_ms(fn, reps, graph=True), eager_ms=cuda_time_ms(fn, reps))


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def spd_inverse_flops(n: int) -> int:
    """Flops of one n x n inverse as the kernel computes it (FMA = 2): the
    factorization, W = L^-1, and the upper half of the symmetric W^T W."""
    chol = sum(2 * j * (n - j) for j in range(n)) + n * (n - 1) // 2 + n
    inv = sum(2 * (i - r) + 1 for r in range(n) for i in range(r + 1, n))
    gram = sum(2 * (n - c) for a in range(n) for c in range(a, n))
    return chol + inv + gram


def contact_sweep_flops(anc, obj_idx, C: int, nv: int, K: int,
                        iterations: int) -> int:
    """Flops of one solve at this scene's couplings (FMA = 2): per slot the
    masked dof sums (one add per set bit per screw component), cross
    products, projection and impulse; per env the slot reductions, the
    generalized impulse and Minv gi. The same work whatever the kernel's
    summation order."""
    bits = int(anc.sum())
    sides = [int((row >= 0).sum()) for row in obj_idx]
    S = len(sides)
    vel = 6 * nv + 6 * bits + 12 * C + 12 * sum(sides) + 45 * C
    apply = 9 * C + 27 * sum(sides) + 6 * bits + 6 * S * C + 12 * nv + 2 * nv * nv + 12 * K * S
    return vel * iterations + apply * (iterations + 1)


def prep_deff_flops(anc) -> int:
    """Flops per env of the robot effective masses these slots need: for a
    slot with m set dofs, the arms (9 m), then per direction v (5 m), the
    quadratic form over the set dofs (2 m^2 + 2 m); 0 for a slot with none."""
    total = 0
    for m in anc.sum(1).tolist():
        m = int(m)
        if m:
            total += 9 * m + 3 * (7 * m + 2 * m * m)
    return total


def max_err(got, want):
    return float((got - want).abs().max()), float(want.abs().max())


def bitwise(fn, name: str) -> bool:
    """Two launches on the same inputs must give bit-identical outputs (no
    atomics, fixed summation order)."""
    import torch

    a, b = fn(), fn()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    return True


def library_graph_ms(fn, reps: int):
    """fn's time as a replayed CUDA graph, or None with the reason where
    capture is refused (a call that reads back to the host)."""
    import torch

    try:
        return cuda_time_ms(fn, reps, graph=True), None
    except RuntimeError as e:  # the capture is invalidated, not the context
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def device_ms(fn, reps: int) -> float:
    """Device time of one eager call: its kernels' summed time under the
    profiler, averaged over `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps


def check_spd(spd_op, M, dev, tag):
    import torch

    got = spd_op.spd_inverse_cuda(M)
    want = spd_op.spd_inverse_plain(M)
    torch.cuda.synchronize()
    err, scale = max_err(got, want)
    ident = float((torch.bmm(got, M) - torch.eye(M.shape[1], device=dev)).abs().max())
    log(f"spd_inverse ({tag}): B={M.shape[0]} n={M.shape[1]} max|kernel-plain| {err:.3e} "
        f"(scale {scale:.3e}), max|Minv M - I| {ident:.3e}")
    # float32 Cholesky of 17x17 matrices in two summation orders: 1e-4 of
    # the largest entry; the identity check is the JAX package's 5e-3
    if not err <= 1e-4 * scale or not ident <= 5e-3:
        raise AssertionError("spd_inverse kernel disagrees with its plain version")
    B, n = M.shape[0], M.shape[1]
    t_b, by = bound_ms(2 * B * n * n * 4, B * spd_inverse_flops(n))
    # yardstick like for like: torch.linalg.inv as a CUDA graph where capture
    # works, else the device time of its eager call (profiler), and its
    # eager time between events
    inv = lambda: torch.linalg.inv(M)
    lib_graph, refused = library_graph_ms(inv, 20)
    lib_device = device_ms(inv, 10)
    lib_eager = cuda_time_ms(inv, 20)
    log(f"spd_inverse ({tag}): torch.linalg.inv graph "
        f"{'refused: ' + refused if refused else f'{lib_graph:.4f} ms'}; device time per "
        f"eager call {lib_device:.4f} ms; eager {lib_eager:.4f} ms")
    return dict(
        max_abs_err=err, bitwise=bitwise(lambda: spd_op.spd_inverse_cuda(M), "spd_inverse"),
        **kernel_times(lambda: spd_op.spd_inverse_cuda(M), 50),
        plain_ms=cuda_time_ms(lambda: spd_op.spd_inverse_plain(M), 20),
        bound_ms=t_b, bound_by=by,
        library_ms=lib_graph if lib_graph is not None else lib_device,
        library_timing="graph" if lib_graph is not None else "device time of an eager call",
        library_graph_refused=refused, library_eager_ms=lib_eager,
    )


def sweep_groups_pushed(lam, groups) -> tuple[int, int, int, int]:
    """(link groups, of them; object bins, of the non-empty ones) with a slot
    that carries an impulse in some env."""
    pushed = (lam.abs().sum(0) > 0).any(0).cpu()  # [C]
    def count(ptr, slots):
        ptr, slots = ptr.tolist(), slots.long().cpu()
        lists = [slots[ptr[g]:ptr[g + 1]] for g in range(len(ptr) - 1) if ptr[g + 1] > ptr[g]]
        return sum(bool(pushed[x].any()) for x in lists), len(lists)
    return (*count(groups.link_ptr, groups.link_slots), *count(groups.obj_ptr, groups.obj_slots))


def check_sweep(sweep_op, captured, maps, tag, synthetic: bool = True):
    """The captured solve, then (with `synthetic`) every slot made active
    and only the robot's slots active, each against the plain version."""
    import torch

    from handarm_tpu_torch.physics.solver import mass_split

    args, kw = captured
    (planes, bias, screws, qd, minv2, obj, lam0, anc, groups, obj_idx,
     signs, iters, omega) = args
    warm = kw.get("apply_warm", True)

    def compare(P, bs, case, n=iters):
        cuda_args = (P, bs, screws, qd, minv2, obj, lam0, groups, obj_idx, signs, n, omega,
                     warm)
        plain_args = (P, bs, screws, qd, minv2, obj, lam0, anc, obj_idx, signs, n, omega,
                      warm)
        got = sweep_op.contact_sweep_cuda(*cuda_args)
        want = sweep_op.contact_sweep_plain(*plain_args)
        torch.cuda.synchronize()
        errs, scales = {}, {}
        for name, g, w in zip(("qd", "obj", "lam"), got, want):
            e, sc = max_err(g, w)
            errs[name], scales[name] = e, sc
            log(f"contact_sweep ({tag}, {case}): {name} max|kernel-plain| {e:.3e} (scale {sc:.3e})")
            # 8 (lift) or 16 (multi-object) Jacobi sweeps in float32 with
            # the slot sums taken in another order: 1e-4 of this output's
            # own largest value
            if not e <= 1e-4 * sc:
                raise AssertionError(f"contact_sweep kernel disagrees on {name} ({tag}, {case})")
        bitwise(lambda: sweep_op.contact_sweep_cuda(*cuda_args), f"contact_sweep ({tag}, {case})")
        return got, errs, scales, cuda_args, plain_args

    got, errs, scales, cuda_args, plain_args = compare(planes, bias, "captured")
    gate = sweep_op.BASE["gate"]
    active = int((planes[gate] > 0).sum())
    robot_active = int(((planes[gate] > 0) & (groups.slot_link[None] >= 0)).sum())
    log(f"contact_sweep ({tag}): B={planes.shape[1]} C={planes.shape[2]} K={obj.shape[2]} "
        f"sides={len(signs)} sweeps={iters} warm={warm}; slots with gate > 0: {active}, "
        f"of them on the robot: {robot_active}")
    # dense case: every slot active, with the gate (active x mass split) the
    # solver would give it, the median effective mass of the active slots
    # where it had none, and a penetrating contact's bias (+0.1 m/s)
    act = planes[gate] > 0
    meds = {k: planes[k][act].median() if bool(act.any()) else planes.new_tensor(1.0)
            for k in sweep_op.BASE["inv_d"]}
    ln = groups.link_bits.shape[0]
    dense_rec = robot_rec = None
    if synthetic:
        dense = planes.clone()
        dense[gate] = mass_split(torch.ones_like(planes[gate]), maps)
        for k, med in meds.items():
            dense[k] = torch.where(act, dense[k], med)
        dense_bias = torch.where(act, bias, torch.full_like(bias, 0.1))
        dgot, derrs, _, _, _ = compare(dense, dense_bias, "dense")
        pushed = int((dgot[2].abs().sum(0) > 0).sum())
        lg, ln, ob, on = sweep_groups_pushed(dgot[2], groups)
        log(f"contact_sweep ({tag}, dense): slots with gate > 0: "
            f"{int((dense[gate] > 0).sum())}, slots pushed {pushed} of {dense[gate].numel()}; "
            f"link groups with impulses {lg} of {ln}, object bins {ob} of {on}")
        if lg < ln or ob < on:
            raise AssertionError(f"contact_sweep dense case left a group without impulses "
                                 f"({tag})")
        dense_rec = dict(max_abs_err=max(derrs.values()), slots_pushed=pushed,
                         link_groups_pushed=lg, object_bins_pushed=ob)
    # robot case: only the robot's slots active, each with its mass split,
    # that median effective mass and that bias, over 2 sweeps (the dense
    # case's coupled slots overshoot over many, to scales where 1e-4 of
    # the largest value hides a slot): every link group at an ordinary scale
    if synthetic:
        on_robot = (groups.slot_link >= 0)[None].expand_as(act)
        robot = planes.clone()
        robot[gate] = mass_split(on_robot.to(planes.dtype), maps)
        for k, med in meds.items():
            robot[k] = torch.full_like(robot[k], float(med))
        rgot, rerrs, rscales, _, _ = compare(robot, torch.full_like(bias, 0.1), "robot", 2)
        rlg, _, _, _ = sweep_groups_pushed(rgot[2], groups)
        log(f"contact_sweep ({tag}, robot): {int(on_robot[0].sum())} robot slots active over "
            f"2 sweeps; link groups with impulses {rlg} of {ln}")
        if rlg < ln:
            raise AssertionError(f"contact_sweep robot case left a link group without "
                                 f"impulses ({tag})")
        robot_rec = dict(max_abs_err=max(rerrs.values()), scale=rscales, link_groups_pushed=rlg)
    B, C, nv, K = planes.shape[1], planes.shape[2], qd.shape[1], obj.shape[2]
    launch = sweep_op.launch_info(C, nv, K, len(signs), groups)
    log(f"contact_sweep ({tag}): blocks of {launch['threads']} threads, "
        f"{launch['shared_bytes']} bytes of shared memory, "
        f"{launch['blocks_per_sm']} resident per SM")
    flops = B * contact_sweep_flops(anc.cpu(), obj_idx.cpu().numpy(), C, nv, K, iters)
    t_b, by = bound_ms(nbytes(planes, bias, screws, qd, minv2, obj, lam0, obj_idx, *groups)
                       + nbytes(*got), flops)
    return dict(
        max_abs_err=max(errs.values()), scale=scales, bitwise=True, launch=launch,
        dense=dense_rec, robot=robot_rec,
        **kernel_times(lambda: sweep_op.contact_sweep_cuda(*cuda_args), 50),
        plain_ms=cuda_time_ms(lambda: sweep_op.contact_sweep_plain(*plain_args), 10),
        bound_ms=t_b, bound_by=by, library_ms=None,
    )


def check_sdf(sdf_op, call):
    """The one captured call of a contact generation (every mesh-SDF query
    of it) against the plain version, then timed beside its byte bound,
    the same call with its table in slot order, and grid_sample."""
    import torch

    field, lo, sp, p, table = call
    got = sdf_op.sdf_sample_cuda(*call)
    want = sdf_op.sdf_sample_plain(*call)
    torch.cuda.synchronize()
    errs = []
    for c, name in enumerate(("distance", "grad x", "grad y", "grad z")):
        e, s = max_err(got[..., c], want[..., c])
        errs.append(e)
        # the same f32 arithmetic in another order: 1e-4 of this channel's
        # largest value
        if not e <= 1e-4 * s:
            raise AssertionError(f"sdf_gather kernel disagrees with its plain version on "
                                 f"{name} ({e:.3e} at scale {s:.3e})")
    (B, L, _), (Lq, _), (K, R) = p.shape, table.shape, field.shape[:2]
    N = B * Lq
    pos = [table[table[:, 1] == k, 0].long() for k in range(K)]
    u = [(p[:, j] - lo[k]) / sp[k] for k, j in enumerate(pos)]
    off = sum(int(((x < 0) | (x > R - 1)).any(-1).sum()) for x in u)
    log(f"sdf_gather: one call of a contact generation, B={B} rows of L={L} queries, "
        f"{Lq} mesh queries per row (N = {N}), K={K} R={R}; {off} queries off the grid; "
        f"max|kernel-plain| per channel {[f'{e:.3e}' for e in errs]}")
    # yardstick: one grid_sample over the K fields computes the clamped
    # trilinear part of every query, each object's queries as one batch
    per = {int(j.numel()) for j in pos}
    if len(per) != 1:
        raise AssertionError(f"objects with unequal query counts {per}: no [K, ...] grid")
    inp = field.permute(0, 4, 3, 2, 1).contiguous()  # [K, 4, z, y, x]
    grid = torch.stack([x * (2.0 / (R - 1)) - 1.0 for x in u]).reshape(K, 1, 1, -1, 3)
    lib = lambda: torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="border", align_corners=True)
    lib_vs_plain = max(float((lib()[k, :, 0, 0].T.reshape(B, -1, 4)[..., 1:]
                              - want[:, j, 1:]).abs().max()) for k, j in enumerate(pos))
    log(f"sdf_gather: grid_sample [K, 4, R, R, R] with a [K, 1, 1, {per.pop()}, 3] grid vs "
        f"plain on the gradient channels {lib_vs_plain:.3e} (border clamp at R - 1, not "
        f"R - 1.001)")
    slot_order = table[torch.argsort(table[:, 0])].contiguous()
    slot_ms = cuda_time_ms(lambda: sdf_op.sdf_sample_cuda(field, lo, sp, p, slot_order), 50,
                           graph=True)
    t_b, by = bound_ms(nbytes(field, lo, sp, table) + N * (12 + 16), N * SDF_FLOPS_PER_POINT)
    return dict(
        max_abs_err=max(errs), queries=N, off_grid=off,
        bitwise=bitwise(lambda: sdf_op.sdf_sample_cuda(*call), "sdf_gather"),
        **kernel_times(lambda: sdf_op.sdf_sample_cuda(*call), 50),
        slot_order_ms=slot_ms,
        plain_ms=cuda_time_ms(lambda: sdf_op.sdf_sample_plain(*call), 10),
        bound_ms=t_b, bound_by=by,
        library_ms=cuda_time_ms(lib, 50, graph=True),
    )


def check_deff(deff_op, args):
    import torch

    screws, pos, basis, anc, groups, minv2 = args
    run = lambda: deff_op.robot_deff_cuda(screws, pos, basis, groups, minv2)
    got = run()
    want = deff_op.robot_deff_plain(screws, pos, basis, anc, minv2)
    torch.cuda.synchronize()
    err, scale = max_err(got, want)
    _, B, C = pos.shape
    nv, L = screws.shape[2], groups.link_bits.shape[0]
    robot_slots = int((groups.slot_link >= 0).sum())
    launch = deff_op.launch_info(nv, L)
    log(f"prep_deff: B={B} C={C} nv={nv} max|kernel-plain| {err:.3e} "
        f"(scale {scale:.3e}); robot slots {robot_slots} of {C} in {L} link groups; "
        f"blocks of {launch['threads']} threads, {launch['shared_bytes']} bytes of shared "
        f"memory, {launch['blocks_per_sm']} resident per SM")
    # float32 quadratic forms summed in another order: 1e-4 of the largest value
    if not err <= 1e-4 * scale:
        raise AssertionError("prep_deff kernel disagrees with its plain version")
    # a slot with no robot dof gives 0 whatever its point and basis hold:
    # only the robot slots' 12 pos and basis values per env are needed
    t_b, by = bound_ms(12 * 4 * B * robot_slots
                       + nbytes(screws, groups.link_bits, groups.slot_link, minv2, got),
                       B * prep_deff_flops(anc.cpu()))
    return dict(
        max_abs_err=err, bitwise=bitwise(run, "prep_deff"), launch=launch,
        **kernel_times(run, 50),
        plain_ms=cuda_time_ms(lambda: deff_op.robot_deff_plain(screws, pos, basis, anc, minv2), 5),
        # no single PyTorch call forms v from screws, points and bases and
        # contracts it with Minv
        bound_ms=t_b, bound_by=by, library_ms=None,
    )


class Capture:
    """Wraps the ops' entry points; while armed, keeps their arguments (with
    `last_only`, only each op's latest call's)."""

    def __init__(self, ops: dict, last_only: bool = False):
        self.ops, self.orig, self.calls, self.armed = ops, {}, {}, False
        self.last_only = last_only

    def __enter__(self):
        for key, (mod, attr) in self.ops.items():
            fn = getattr(mod, attr)
            self.orig[key] = fn

            def wrapped(*args, _fn=fn, _key=key, **kw):
                if self.armed:
                    if self.last_only:
                        self.calls[_key] = []
                    self.calls.setdefault(_key, []).append((args, kw))
                return _fn(*args, **kw)

            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for key, (mod, attr) in self.ops.items():
            setattr(mod, attr, self.orig[key])


def finite_state(tree_map, state, obs):
    import torch

    leaves = []
    tree_map(lambda x: leaves.append(x), state)
    for x in leaves + [obs]:
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite state after the rollout")


def slot_kinds(slots) -> dict:
    """[C] bool masks of the slot kinds that touch the robot or couple two
    objects (the rest hold an object against the table or walls)."""
    import torch

    rb, oa, ob = (torch.as_tensor(x) for x in (slots.robot_body, slots.obj_a, slots.obj_b))
    return {"robot-static": (rb >= 0) & (oa < 0) & (ob < 0),
            "robot-object": (rb >= 0) & (ob >= 0), "object-pair": (oa >= 0) & (ob >= 0)}


def card_vs_cpu(env_c, env_g, st_c, obs_c, policy_c, dev, tag: str, need=(), draws=None):
    """From one CPU state (clocks zeroed so no env times out), 2 control
    steps on the card and on the CPU (`draws`: each step's StepDraws, the
    same on both sides). Logs how many slots of each coupling kind are
    active (depth above -speculative_margin) in the compared state; each
    kind in `need` must have some."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.physics.contacts import generate_contacts
    from handarm_tpu_torch.physics.kinematics import forward_kinematics

    st_c = st_c._replace(task=st_c.task._replace(
        progress=torch.zeros_like(st_c.task.progress)))
    sc, ph = env_c.scene, st_c.physics
    fk = forward_kinematics(sc.model, ph.robot.q, sc.base_quat[None], sc.base_pos[None])
    con = generate_contacts(sc.slots, sc.shapes, sc.spheres, sc.geom, ph.objects.pos,
                            ph.objects.quat, fk.body_quat, fk.body_pos)
    active = con.depth > -sc.params.solver.speculative_margin
    counts = {k: int(active[:, m].sum()) for k, m in slot_kinds(sc.slots).items()}
    st_g = tree_map(lambda x: x.to(dev), st_c)
    for i in range(2):
        act = policy_c.act(obs_c)
        d = draws[i] if draws else None
        st_c, res_c = env_c.step(st_c, act, draws=d)
        st_g, res_g = env_g.step(st_g, act.to(dev),
                                 draws=tree_map(lambda x: x.to(dev), d) if d else None)
        obs_c = res_c.obs
    err = float((res_g.obs.cpu() - obs_c).abs().max())
    q_err = float((st_g.physics.robot.q.cpu() - st_c.physics.robot.q).abs().max())
    p_err = float((st_g.physics.objects.pos.cpu() - st_c.physics.objects.pos).abs().max())
    small = env_c.cfg.num_envs
    log(f"{tag}: {small} envs, active slots in the compared state {counts}; 2 control steps: "
        f"max|obs gpu-cpu| {err:.3e}, max|q gpu-cpu| {q_err:.3e}, "
        f"max|object pos gpu-cpu| {p_err:.3e}")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"no active {missing} slot in the compared state ({tag})")
    # the JAX package's position bound (2e-4) on q and object positions;
    # 2e-3 on observations, which include fingertip velocities
    if not (q_err <= 2e-4 and p_err <= 2e-4 and err <= 2e-3):
        raise AssertionError(f"the card's run disagrees with the CPU reference ({tag})")
    if not bool(torch.isfinite(res_g.obs).all()) or res_g.obs.shape != (small, env_g.num_obs):
        raise AssertionError(f"bad observations from the card ({tag})")
    return dict(active_slots=counts, obs_err=err, q_err=q_err, pos_err=p_err)


@contextlib.contextmanager
def deff_at_any_size():
    """The deff kernel at any B * C on the card while inside (the solver's
    threshold lowered to 0; on the CPU the chain runs, in the prep dtype)."""
    from handarm_tpu_torch.physics import solver

    threshold = solver.DEFF_KERNEL_MIN_BC
    solver.DEFF_KERNEL_MIN_BC = 0
    try:
        yield
    finally:
        solver.DEFF_KERNEL_MIN_BC = threshold


def small_multi_env(rollout, d, pool16, compose=(), **over):
    """The composed multi-object task at 16 envs on device `d` for a card
    vs CPU comparison: the genesis pool's first 16 envs (should an env
    reset), no disturbance draws, float32 solver prep (with
    `deff_at_any_size` the CPU's chain then computes the deff kernel's
    plain version), `over` replacing config fields."""
    from handarm_tpu_torch.envs import genesis

    return rollout.make_task_env(MULTI_TASK, 16, d, pool=genesis.InitialPool(
        pool16.pos.to(d), pool16.quat.to(d)), compose=compose, randomize=False,
        solver_prep_dtype="f32", **over)


def contact_scores(slots, state):
    """Per env: 2 if its last solve pushed a robot-object slot, plus 1 if it
    pushed an object-pair slot."""
    imp = state.physics.contact_impulse.norm(dim=-1) > 0  # [B, C]
    pushed = {k: imp[:, m.to(imp.device)].any(1).long() for k, m in slot_kinds(slots).items()}
    return 2 * pushed["robot-object"] + pushed["object-pair"]


def pick_contact_envs(slots, state, obs, n: int, tag: str):
    """The state and observations of n envs of a rollout, on the CPU: first
    those whose last solve pushed both robot-object and object-pair slots,
    then those with either."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map

    score = contact_scores(slots, state)
    B = score.shape[0]
    idx = torch.argsort(score, descending=True, stable=True)[:n]
    log(f"{tag}: envs of the rollout with robot-object impulses: {int((score >= 2).sum())}, "
        f"with object-pair impulses: {int((score % 2).sum())}, both: "
        f"{int((score == 3).sum())} of {B}; taking {idx.tolist()}")
    take = lambda x: (x[idx] if x.dim() and x.shape[0] == B else x).cpu()
    return tree_map(take, state), take(obs)


def learner_cpu(ts):
    """The learner part of a TrainState (params, optimizer state, stats, lr,
    epoch) on the CPU; no env state or observations."""
    return to_cpu(ts._replace(env_state=None, last_obs=None))


def learner_tensors(ts) -> dict:
    """name -> tensor of every float leaf of the learner."""
    out = {f"param {k}": v for k, v in ts.params.items()}
    out.update({f"adam mu {k}": v for k, v in ts.opt_state.mu.items()})
    out.update({f"adam nu {k}": v for k, v in ts.opt_state.nu.items()})
    for tag, st in (("obs", ts.obs_stats), ("value", ts.value_stats),
                    ("teacher", ts.teacher_obs_stats)):
        if st is not None:
            out.update({f"{tag} stats {f}": x for f, x in zip(st._fields, st)})
    if ts.hidden is not None:
        from handarm_tpu_torch.learn.ppo import carry_items

        out.update(carry_items(ts.hidden, "carry"))
    return out


class StepRecorder:
    """While active, keeps the inputs and outputs of `ppo`'s sample
    preparation (`PPO._prepare`) and of every minibatch step: its gradients
    (`PPO._grads`) and its optimizer step (`PPO._apply`)."""

    def __init__(self, ppo):
        self.ppo, self.prepares, self.grads, self.applies = ppo, [], [], []

    def __enter__(self):
        def recording(fn, calls):
            def wrapped(*args):
                out = fn(*args)
                calls.append((args, out))
                return out
            return wrapped

        self.ppo._prepare = recording(self.ppo._prepare, self.prepares)
        self.ppo._grads = recording(self.ppo._grads, self.grads)
        self.ppo._apply = recording(self.ppo._apply, self.applies)
        return self

    def __exit__(self, *exc):
        del self.ppo._prepare, self.ppo._grads, self.ppo._apply

    @property
    def kls(self) -> list:
        import torch

        return torch.stack([aux["kl"] for _, (_, aux) in self.grads]).tolist()


def to_cpu(x):
    """Tensors of nested tuples, NamedTuples and dicts, on the CPU."""
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [to_cpu(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x.cpu() if hasattr(x, "cpu") else x


def same_lr(a: float, b: float, kls, kl_threshold, tag: str) -> None:
    """Equal within 1e-6 relative, unless a KL (printed) lies within 1e-6
    relative of a branch threshold."""
    from handarm_tpu_torch.update_precision import kl_margin

    if abs(a - b) > 1e-6 * abs(b):
        log(f"{tag}: lr {a:.9e} vs {b:.9e}; KLs {kls}")
        if kl_margin(kls, kl_threshold) >= 1e-6:
            raise AssertionError(f"{tag}: the lr differs with no KL at a threshold")


def compare_steps(ppo, rec_card, kl_threshold, tag: str) -> dict:
    """Each of the card's minibatch steps rerun on the CPU from the card's
    inputs: the same functions of the same inputs.
    - The loss terms and the KL from the card's params, stats and minibatch,
      at every step: within 1e-4 relative plus 1e-6 absolute (float32 means
      of 8192 per-sample terms of order 1 in another order: the normalized
      advantages have unit spread, and the policy loss, a mean near 0,
      keeps the rounding of its O(1) terms).
    - The gradients of the first step, where every sample's ratio is 1 up
      to rounding, far from the clip edges: each tensor within 1e-4 of its
      largest value (each side is within 6.5e-6 of float64 on the CPU).
      Later steps' gradients are reported, not held: a sample whose ratio
      or value sits within rounding of a clip edge switches its term on one
      side and not the other (on an H100, up to 2-3e-2 of a tensor's
      largest gradient at later steps).
    - The optimizer step from the card's params, Adam state, lr and
      gradients, at every step (elementwise float32 arithmetic, the one
      global norm a sum in another order): params within 2 float32 ulps of
      each tensor's largest value, Adam's mu and nu within 1e-5 of theirs,
      the optax counters equal, the lr by `same_lr`."""
    # held checks: the largest fraction of its tolerance used; later
    # gradients: the largest difference relative to the tensor's scale
    worst = {k: 0.0 for k in ("loss terms", "first-step grad", "param", "adam mu",
                              "adam nu", "later grad")}
    grad_dev = [0.0] * len(rec_card.grads)  # per step: the largest gradient error over scale

    def check(kind, got, want, tol, k, name, atol=0.0):
        err, scale = max_err(got, want.cpu())
        if kind.endswith("grad"):
            grad_dev[k] = max(grad_dev[k], err / max(scale, 1e-30))
        if tol is None:
            worst[kind] = max(worst[kind], err / max(scale, 1e-30))
            return
        allowed = tol * scale + atol
        worst[kind] = max(worst[kind], err / allowed if allowed else float(err > 0))
        if not err <= allowed:
            raise AssertionError(f"step {k}: card and CPU differ on {kind} {name}: {err:.3e} "
                                 f"at scale {scale:.3e}")

    for k, (args, (grads, aux)) in enumerate(rec_card.grads):
        c_grads, c_aux = ppo._grads(*to_cpu(args))
        for name in aux:
            check("loss terms", c_aux[name], aux[name], 1e-4, k, name, atol=1e-6)
        for name, g in grads.items():
            if k == 0:
                check("first-step grad", c_grads[name], g, 1e-4, k, name)
            else:
                check("later grad", c_grads[name], g, None, k, name)
    for k, (args, (params, opt, lr)) in enumerate(rec_card.applies):
        c_params, c_opt, c_lr = ppo._apply(*to_cpu(args))
        for name, p in params.items():
            check("param", c_params[name], p, 2 * FLOAT32_EPS, k, name)
        for kind, card_m, cpu_m in (("adam mu", opt.mu, c_opt.mu), ("adam nu", opt.nu, c_opt.nu)):
            for name, m in card_m.items():
                check(kind, cpu_m[name], m, 1e-5, k, name)
        for a, b in zip(opt[:4], c_opt[:4]):
            if not bool((a.cpu() == b).all()):
                raise AssertionError(f"step {k}: card and CPU optax counters differ")
        same_lr(float(lr), float(c_lr), [float(args[4])], kl_threshold, f"step {k}")
    log(f"{tag} card-vs-cpu, step by step ({len(rec_card.applies)} minibatch steps, each rerun "
        f"on the CPU from the card's inputs): largest fraction of each tolerance used "
        f"{({k: round(v, 5) for k, v in worst.items() if k != 'later grad'})}; later steps' "
        f"gradients up to {worst['later grad']:.3e} of scale (not held); gradient error "
        f"over scale by step {[float(f'{d:.3g}') for d in grad_dev]}")
    return dict(worst, grad_dev=grad_dev)


def compare_prepared(card, cpu, old, card_mb, cpu_mb, tag: str) -> dict:
    """The card's samples of the update (GAE, the normalized advantages,
    returns and values, flattened env-major) and updated stats against the
    CPU's, from the same learner and trajectory; and the card's first
    minibatch (its `index_select` gather) against the CPU's gather of the
    same indices.
    - The rollout's own fields (obs, action, logp, mu, sigma) bit-identical:
      both sides flatten and gather the same numbers.
    - adv, return_n and value_n within 1e-5 of each tensor's largest value
      (float32 against float64 on the CPU: 1.2e-6).
    - The stats within 4 float32 ulps of each tensor's largest value plus
      1e-3 of its largest change in this update (float32 against float64:
      0.8 ulp; at a count of 6.8e8 a batch moves them by ~1e-5, so the
      ulps bound a batch term wrong by a few percent), the counts equal."""
    import torch

    card_data, card_obs, card_value = card[:3]
    cpu_data, cpu_obs, cpu_value = cpu[:3]
    worst = {"samples": 0.0, "first minibatch": 0.0, "stats": 0.0}

    def samples(kind, got, want):
        for name, w in want.items():
            g = got[name].cpu()
            if name in ("adv", "return_n", "value_n"):
                err, scale = max_err(g, w)
                worst[kind] = max(worst[kind], err / (1e-5 * scale))
                if not err <= 1e-5 * scale:
                    raise AssertionError(f"card and CPU differ on {name} of the {kind}: "
                                         f"{err:.3e} at scale {scale:.3e}")
            elif not torch.equal(g, w):
                raise AssertionError(f"the card's {kind} {name} is not the CPU's")

    samples("samples", card_data, cpu_data)
    samples("first minibatch", card_mb, cpu_mb)
    for kind, got, want, before in (("obs", card_obs, cpu_obs, old.obs_stats),
                                    ("value", card_value, cpu_value, old.value_stats)):
        for field, g, w, b in zip(want._fields, got, want, before):
            g, b = g.cpu(), b.cpu()
            if field == "count":
                if not torch.equal(g, w):
                    raise AssertionError(f"card and CPU {kind} stats counts differ")
                continue
            err, scale = max_err(g, w)
            allowed = 4 * FLOAT32_EPS * scale + 1e-3 * float((w - b).abs().max())
            worst["stats"] = max(worst["stats"], err / allowed)
            if not err <= allowed:
                raise AssertionError(f"card and CPU differ on {kind} stats {field}: "
                                     f"{err:.3e}, allowed {allowed:.3e}")
    log(f"{tag} card-vs-cpu, prepared samples ({cpu_data['adv'].shape[0]}) and stats from the "
        f"same learner and trajectory: largest fraction of each tolerance used "
        f"{({k: round(v, 5) for k, v in worst.items()})}")
    return worst


LIFT_PREFIX_TOLS = {"param": 1e-6, "adam mu": 1e-5, "adam nu": 1e-5}
# update_precision at minibatch 32768 (Ur5SihMultiObjectManipulation, ckpt_2700,
# 8192 envs, 4 steps, on the H100): float32 lies 1.26e-7, 6.65e-6 and 2.27e-7
# of scale from float64 (params, Adam mu, nu); card and CPU are two float32
# computations, so Adam mu may lie up to 1.33e-5 apart
MULTI_PREFIX_TOLS = {"param": 1e-6, "adam mu": 2e-5, "adam nu": 1e-5}


def compare_prefix(card, cpu, kls_card, kls_cpu, kl_threshold, tag: str, n: int,
                   tols: dict) -> dict:
    """The card's update after its first `n` minibatch steps against the
    CPU's, each chained on its own side from the same learner and its own
    prepared samples. Params, Adam's mu and nu each within `tols` of each
    tensor's largest value (`LIFT_PREFIX_TOLS`: float32 against float64 on
    the CPU, 4 steps of 8192 samples, lie 1.1e-7, 1.5e-6, 2.0e-7 apart;
    `MULTI_PREFIX_TOLS` from the same probe at minibatch 32768), the optax
    counters equal; the lr equal unless a KL of either side lies within
    1e-6 relative of a branch threshold (printed). Further on, the clip
    edges and the lr branches make two correct updates part (PERF.md §6);
    the steps there are held one by one (`compare_steps`)."""
    import torch

    from handarm_tpu_torch.update_precision import kl_margin

    (params, opt, lr), (c_params, c_opt, c_lr) = card, cpu
    worst, worst_at = {"param": 0.0, "adam mu": 0.0, "adam nu": 0.0}, {}
    for kind, got, want in (("param", params, c_params), ("adam mu", opt.mu, c_opt.mu),
                            ("adam nu", opt.nu, c_opt.nu)):
        tol = tols[kind]
        for name, w in want.items():
            err, scale = max_err(got[name].cpu(), w)
            if err / (tol * scale) >= worst[kind]:
                worst[kind], worst_at[kind] = err / (tol * scale), name
            if not err <= tol * scale:
                raise AssertionError(f"after {n} steps card and CPU differ on "
                                     f"{kind} {name}: {err:.3e} at scale {scale:.3e}")
    for a, b in zip(opt[:4], c_opt[:4]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"after {n} steps the optax counters differ")
    margin = kl_margin(kls_card + kls_cpu, kl_threshold)
    lrs = dict(card=float(lr), cpu=float(c_lr))
    log(f"{tag} card-vs-cpu, the first {n} minibatch steps chained on each side: "
        f"largest fraction of each tolerance used {({k: round(v, 5) for k, v in worst.items()})}"
        f" (at {worst_at}); lr {lrs}; KLs card {kls_card}, CPU {kls_cpu}; smallest relative "
        f"margin to a threshold {margin:.3e}")
    if lrs["card"] != lrs["cpu"] and margin >= 1e-6:
        raise AssertionError(f"after {n} steps the lr differs with no KL at a threshold")
    return dict(worst, steps=n, lr=lrs, kl_min_margin=margin)


def check_learner(ts, tag: str) -> None:
    import torch

    for name, x in learner_tensors(ts).items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag}: non-finite {name}")


def check_launches(counts: dict, per: dict, n: int, tag: str) -> None:
    want = {k: v * n for k, v in per.items()}
    if counts != want:
        raise AssertionError(f"{tag} launches {counts}, expected {want}")


def learner_run(rollout, ppo, ts, per_iter: dict, tag: str, prefix_tols=LIFT_PREFIX_TOLS,
                prefix_until_switch: bool = False, step_check=None) -> dict:
    """From TrainState `ts`: one warm-up train_iter, TRAIN_ITERS iterations
    timed as rollout and update, then one untimed iteration whose steps are
    kept and held against the CPU (`compare_steps`, `compare_prepared`,
    `compare_prefix` over PREFIX_STEPS chained steps; with
    `prefix_until_switch`, over fewer if an earlier step's gradients, from
    the card's own inputs, already lie more than the first step's 1e-4 of
    scale from the CPU's: a sample within rounding of a clip edge switched
    its term on one side only, and chained steps part from there). With
    `step_check`, `step_check(ppo, recorder)` replaces those three (the
    recurrent learner: `rnn_step_check`). Counters are zeroed before each
    iteration and read after it: exactly `per_iter`. Peak device memory
    from the first timed iteration on. Returns the record, with the final
    TrainState under "ts"."""
    import torch

    from handarm_tpu_torch import train

    cfg, dev, start = ppo.cfg, ppo.device, ts
    n = ppo.env.cfg.num_envs * cfg.horizon
    rows = n // cfg.seq_len if ppo.recurrent else n  # samples, or sequences
    rollout.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, _ = ppo.train_iter(ts)
    torch.cuda.synchronize()
    log(f"{tag}: warm-up iteration {time.perf_counter() - t0:.3f} s")
    check_launches(rollout.launch_counts(), per_iter, 1, f"{tag} warm-up")
    iters, skips = [], 0
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_ITERS + 1):
        last = i == TRAIN_ITERS  # untimed: its steps are kept for the CPU checks
        before = ts
        rollout.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ppo.rollout(ts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        perms = torch.stack([torch.randperm(rows, generator=ppo.gen, device=dev)
                             for _ in range(cfg.mini_epochs)]) if last else None
        with StepRecorder(ppo) if last else contextlib.nullcontext() as recorder:
            ts, stats = ppo._update_from_traj(ts, r.traj, r.env_state, r.last_obs, perms, r.info,
                                              r.last_teacher_obs, r.last_hidden)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = rollout.launch_counts()
        check_launches(counts, per_iter, 1, f"{tag} iteration {i}")
        skipped = int(ts.opt_state.total_notfinite - before.opt_state.total_notfinite)
        steps = int(ts.opt_state.count - before.opt_state.count)
        skips += skipped
        if steps != ppo.num_minibatches * cfg.mini_epochs - skipped:
            raise AssertionError(f"{tag}: Adam count rose by {steps} with {skipped} skips")
        rec = dict(rollout_s=t1 - t0, update_s=t2 - t1, env_steps_per_s=n / (t2 - t0),
                   adam_steps=steps, adam_skips=skipped, launches=counts,
                   **train.drain_stats({k: stats[k] for k in (
                       "reward_mean", "kl", "lr", "policy_loss", "value_loss",
                       "kl_guard_triggered", "success_rate_ewma")}))
        timing = "untimed (kept for the CPU checks)" if last else (
            f"rollout {rec['rollout_s']:.3f} s, update {rec['update_s']:.3f} s, "
            f"{rec['env_steps_per_s']:.0f} env-steps/s")
        log(f"{tag} iteration {i}: {timing}; reward_mean "
            f"{rec['reward_mean']:.5f} kl {rec['kl']:.5f} lr {rec['lr']:.4e} policy_loss "
            f"{rec['policy_loss']:.5f} value_loss {rec['value_loss']:.5f} kl_guard "
            f"{rec['kl_guard_triggered']:.0f} success_rate_ewma {rec['success_rate_ewma']:.4f}; "
            f"Adam steps {steps} (skipped {skipped}); launches {counts}")
        check_learner(ts, tag)
        if last:
            capture, rec_card = (before, r.traj, r.last_obs, perms), recorder
            captured_iter = rec
        else:
            iters.append(rec)
        del r
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = max(float((ts.params[k] - start.params[k]).abs().max()) for k in ts.params)
    if not moved > 0:
        raise AssertionError(f"{tag}: the params did not move in training")
    log(f"{tag}: max |params - start| after {2 + TRAIN_ITERS} iterations {moved:.4e}; Adam "
        f"skips {skips}; peak device memory {peak:.2f} GiB")
    mean = lambda k: sum(r[k] for r in iters) / len(iters)
    out = dict(envs=ppo.env.cfg.num_envs, horizon=cfg.horizon,
               minibatches=ppo.num_minibatches, minibatch_size=ppo.mb_size,
               mini_epochs=cfg.mini_epochs, solver_iterations=ppo.env.cfg.solver_iterations,
               iterations=iters, rollout_s=mean("rollout_s"), update_s=mean("update_s"),
               env_steps_per_s=n * len(iters) / sum(r["rollout_s"] + r["update_s"]
                                                    for r in iters),
               captured_iteration=captured_iter, adam_skips=skips, params_moved=moved,
               peak_memory_gib=peak, launches_per_iteration=per_iter, ts=ts)
    if step_check is not None:
        t0 = time.perf_counter()
        out["card_vs_cpu"] = step_check(ppo, rec_card)
        out["cpu_check_s"] = time.perf_counter() - t0
        return out

    before, traj, last_obs, perms = capture
    steps = compare_steps(ppo, rec_card, cfg.kl_threshold, tag)
    n_prefix = PREFIX_STEPS
    if prefix_until_switch:
        switch = [k for k, d in enumerate(steps["grad_dev"]) if k and d > 1e-4]
        n_prefix = min([PREFIX_STEPS] + switch)
        log(f"{tag}: first step whose gradients lie over 1e-4 of scale from the CPU's "
            f"{switch[0] if switch else None}: {n_prefix} chained steps held")
    learner_c = learner_cpu(before)
    minibatches = perms.cpu().reshape(-1, ppo.mb_size)
    t0 = time.perf_counter()
    with StepRecorder(ppo) as rec_cpu:
        prepared = ppo._prepare(learner_c, to_cpu(traj), last_obs.cpu())
        cpu_prefix = ppo._sgd(learner_c, prepared[0], minibatches[:n_prefix])
    cpu_s = time.perf_counter() - t0
    match = dict(prepared=compare_prepared(
        rec_card.prepares[0][1], prepared, before, rec_card.grads[0][0][2],
        {k: v.index_select(0, minibatches[0]) for k, v in prepared[0].items()}, tag))
    match["prefix"] = compare_prefix(rec_card.applies[n_prefix - 1][1], cpu_prefix[:3],
                                     rec_card.kls[:n_prefix], rec_cpu.kls, cfg.kl_threshold,
                                     tag, n_prefix, prefix_tols)
    match["step_by_step"] = steps
    log(f"{tag}: the CPU's preparation and {n_prefix} steps took {cpu_s:.1f} s")
    return dict(out, card_vs_cpu=match, cpu_check_s=cpu_s)


def train_phase(rollout, dev) -> dict:
    """Phase 9 (see the module docstring)."""
    from handarm_tpu_torch import train
    from handarm_tpu_torch.envs.tasks import make_env, ppo_overrides
    from handarm_tpu_torch.learn.ppo import PPO, PPOConfig
    from handarm_tpu_torch.utils.checkpoint import (load_train_state, read_leaves,
                                                    wait_for_pending_saves)

    ckpt = rollout.TASK_CKPTS["Ur5SihLift"]
    per_iter = {"spd_inverse": 16, "contact_sweep": 96, "prep_deff": 0, "sdf_gather": 0}
    env = make_env("Ur5SihLift", device=dev, num_envs=ENVS)
    cfg = PPOConfig(**ppo_overrides("Ur5SihLift"))
    ppo = PPO(env, cfg)
    fresh = ppo.init(0)
    start = load_train_state(ckpt, dev, fresh.env_state, fresh.last_obs)
    log(f"train: Ur5SihLift {ENVS} envs, horizon {cfg.horizon}, {ppo.num_minibatches} "
        f"minibatches of {ppo.mb_size} x {cfg.mini_epochs} mini-epochs, hidden {cfg.hidden}; "
        f"from {os.path.relpath(ckpt)} (epoch {int(start.epoch)}, Adam count "
        f"{int(start.opt_state.count)}, lr {float(start.lr):.4e})")
    rec = learner_run(rollout, ppo, start, per_iter, "train")
    del rec["ts"], ppo, env, fresh

    # the user's entry point, resumed from the checkpoint (runs/ is ignored by git)
    exp = "chip_smoke_train"
    rollout.reset_launch_counts()
    t0 = time.perf_counter()
    train.main(["task=Ur5SihLift", f"num_envs={ENVS}", f"resume={ckpt}", f"experiment={exp}",
                f"max_iterations={int(start.epoch) + ENTRY_ITERS}", "seed=1", f"device={dev}"])
    wait_for_pending_saves()
    entry_s = time.perf_counter() - t0
    check_launches(rollout.launch_counts(), per_iter, ENTRY_ITERS, "train entry point")
    out = os.path.join("runs", exp, "nn", f"ckpt_{int(start.epoch) + ENTRY_ITERS}.npz")
    leaves = read_leaves(out)
    if len(leaves) != 71 or int(leaves[70]) != int(start.epoch) + ENTRY_ITERS:
        raise AssertionError(f"bad checkpoint from the train entry point: {out}")
    log(f"train entry point: {ENTRY_ITERS} iterations resumed from ckpt_5200 in "
        f"{entry_s:.1f} s (env build and reset included), wrote {out}")
    return dict(task="Ur5SihLift", **rec, entry_point_s=entry_s)


LIFT_PER_STEP = {"spd_inverse": 1, "contact_sweep": 6, "prep_deff": 0, "sdf_gather": 0}
LIFT_PER_ITER = {k: 16 * v for k, v in LIFT_PER_STEP.items()}
MULTI_PER_STEP = {"spd_inverse": 1, "contact_sweep": 6, "prep_deff": 1, "sdf_gather": 3}


def eval_phase(rollout, dev, task="Ur5SihLift", per_step=LIFT_PER_STEP, pool=None,
               student=None, min_episodes=3000, steps=EVAL_STEPS, burn_in=200) -> dict:
    """Phases 10, 14, 18 and 37 (see the module docstring): a burn-in of
    `burn_in` steps (the task's episode length), then `steps` counted."""
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.eval_policy import evaluate

    rollout.reset_launch_counts()
    t0 = time.perf_counter()
    out, state = evaluate(task=task, envs=ENVS, steps=steps, device=dev, pool=pool,
                          student=student,
                          teacher=rollout.TASK_CKPTS["Ur5SihLift"] if student else None)
    seconds = time.perf_counter() - t0
    counts = rollout.launch_counts()
    check_launches(counts, per_step, 1 + burn_in + steps, f"eval {task}")
    finite_state(tree_map, state, state.physics.robot.q)
    n, p = out["episodes"], out["success_rate"]
    se = (p * (1 - p) / max(n, 1)) ** 0.5
    log(f"eval: {out['policy']} on {task}, {ENVS} envs, burn-in {burn_in} + {steps} steps "
        f"in {seconds:.1f} s: episodes {n}, successes {out['successes']}, "
        f"success rate {p:.6f} (standard error {se:.6f}), success_ewma "
        f"{out['success_ewma']:.6f}, per-object ewma {out['per_object_ewma']}; launches {counts}")
    if n < min_episodes:
        raise AssertionError(f"eval counted {n} episodes, fewer than {min_episodes}")
    return dict(out, policy=os.path.relpath(out["policy"]), envs=ENVS, steps=steps,
                seconds=seconds, launches=counts, standard_error=se)


def multiobj_train_phase(rollout, dev, pool) -> dict:
    """Phase 13 (see the module docstring)."""
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.utils.checkpoint import load_train_state

    ckpt = rollout.TASK_CKPTS[MULTI_TASK]
    env = rollout.make_task_env(MULTI_TASK, ENVS, dev, pool=pool)
    cfg = ppo_config(resolve_task(MULTI_TASK)[1])
    ppo = PPO(env, cfg)
    if (env.cfg.solver_iterations, cfg.minibatch_size) != (16, 32768):
        raise AssertionError(f"the composed {MULTI_TASK} is not the yamls' (16 sweeps, "
                             "minibatch 32768)")
    fresh = ppo.init(0)
    start = load_train_state(ckpt, dev, fresh.env_state, fresh.last_obs)
    del fresh
    log(f"multiobj-train: {MULTI_TASK} composed from configs/ ({env.cfg.solver_iterations} "
        f"sweeps, dt {env.cfg.dt}), {ENVS} envs, horizon {cfg.horizon}, "
        f"{ppo.num_minibatches} minibatches of {ppo.mb_size} x {cfg.mini_epochs} mini-epochs, "
        f"hidden {cfg.hidden}; from {os.path.relpath(ckpt)} (epoch {int(start.epoch)}, Adam "
        f"count {int(start.opt_state.count)}, lr {float(start.lr):.4e}); the multiobj "
        f"phase's genesis pool")
    per_iter = {k: 16 * v for k, v in MULTI_PER_STEP.items()}
    rec = learner_run(rollout, ppo, start, per_iter, "multiobj-train", MULTI_PREFIX_TOLS,
                      prefix_until_switch=True)
    del rec["ts"]
    return dict(task=MULTI_TASK, **rec)


class SeededActions:
    """Actions uniform in [-1, 1] from a numpy seed, whatever the obs."""

    def __init__(self, num_actions: int, seed: int):
        import numpy as np

        self.rng, self.num_actions = np.random.default_rng(seed), num_actions

    def act(self, obs):
        import torch

        a = self.rng.uniform(-1.0, 1.0, (obs.shape[0], self.num_actions))
        return torch.as_tensor(a, dtype=torch.float32)


def family_phase(rollout, dev) -> dict:
    """Phase 12 (see the module docstring)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import HandArmEnv, tree_map
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.physics.shapes import MESH_SDF

    out = {}
    for task in FAMILY:
        env_cfg, over = resolve_task(task, [f"env.num_envs={ENVS}"])
        env = HandArmEnv(env_cfg, dev)
        C = env.scene.slots.num_slots
        meshes = int((env.scene.shapes.kind == MESH_SDF).sum())
        # prep_deff runs at B * C >= 2^21 only, sdf_gather on mesh objects only
        per_iter = {"spd_inverse": 16, "contact_sweep": 96,
                    "prep_deff": 16 if ENVS * C >= 2 ** 21 else 0,
                    "sdf_gather": 48 if meshes else 0}
        if per_iter["prep_deff"] or per_iter["sdf_gather"]:
            raise AssertionError(f"{task}: B * C = {ENVS * C}, {meshes} mesh objects")
        cfg = ppo_config(over)
        ppo = PPO(env, cfg)
        ts = ppo.init(1)
        rollout.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = ppo.train_iter(ts)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        check_launches(rollout.launch_counts(), per_iter, 1, f"{task} warm-up")
        iters = []
        for i in range(FAMILY_ITERS):
            rollout.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, st = ppo.train_iter(ts)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = rollout.launch_counts()
            check_launches(counts, per_iter, 1, f"{task} iteration {i}")
            check_learner(ts, task)
            iters.append(dict(seconds=sec, env_steps_per_s=ENVS * cfg.horizon / sec,
                              launches=counts, **{k: float(st[k]) for k in (
                                  "reward_mean", "kl", "lr", "success_rate_ewma")}))
        log(f"family {task}: {ENVS} envs, C = {C}, obs {env.num_obs}, actions "
            f"{env.num_actions}, {env_cfg.solver_iterations} sweeps, minibatch "
            f"{ppo.mb_size}; warm-up {warm:.3f} s; iterations "
            f"{[(round(r['seconds'], 3), round(r['reward_mean'], 4)) for r in iters]}; "
            f"launches per iteration {per_iter}")
        ref_state, ref_obs = pick_contact_envs(env.scene.slots, ts.env_state, ts.last_obs, 16,
                                               f"family {task}")
        actions = SeededActions(env.num_actions, seed=0)
        del ts, ppo, env
        small = dataclasses.replace(env_cfg, num_envs=16)
        card_vs_cpu(HandArmEnv(small, "cpu"), HandArmEnv(small, dev), ref_state, ref_obs,
                    actions, dev, f"family {task} card-vs-cpu")
        out[task] = dict(envs=ENVS, slots=C, obs=int(ref_obs.shape[1]), warmup_s=warm,
                         iterations=iters, launches_per_iteration=per_iter)
    return out


def run_module(module: str, args: list[str], tag: str, timeout: int):
    """`python -m MODULE ARGS` as a user runs it, in its own process (the
    last lines of its output indented here); it must exit 0 within
    `timeout` s. Returns (seconds, its standard output)."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                         text=True, timeout=timeout, env=dict(os.environ, PYTHONPATH=path))
    seconds = time.perf_counter() - t0
    for line in (res.stdout + res.stderr).splitlines()[-12:]:
        log(f"  | {line}")
    if res.returncode != 0:
        raise AssertionError(f"{tag}: {module} exited {res.returncode}")
    log(f"{tag}: `python -m {module} {' '.join(args)}` in {seconds:.1f} s (process start, "
        "kernel load, env build and reset included)")
    return seconds, res.stdout


def entry_subprocess(args: list[str], out: str, tag: str, timeout: int,
                     n_leaves: int = 71) -> dict:
    """`python -m handarm_tpu_torch.train ARGS` in its own process
    (`run_module`); it must write the checkpoint `out`, `n_leaves` finite
    leaves (71 for the MLP learner without DR or ADR).
    Returns its seconds and its last iteration's kl, KL-guard flag and
    reward_mean."""
    import numpy as np

    from handarm_tpu_torch.utils.checkpoint import read_leaves

    seconds, _ = run_module("handarm_tpu_torch.train", args, tag, timeout)
    leaves = read_leaves(out)
    if len(leaves) != n_leaves or not all(np.isfinite(x).all() for x in leaves
                                    if np.issubdtype(x.dtype, np.floating)):
        raise AssertionError(f"{tag}: bad checkpoint {out}")
    metrics = os.path.join(os.path.dirname(os.path.dirname(out)), "metrics.jsonl")
    with open(metrics) as f:
        last = json.loads(f.read().splitlines()[-1])
    log(f"{tag}: wrote {out}; its last iteration: kl {last['kl']:.5f}, kl_guard "
        f"{last['kl_guard_triggered']:.0f}, reward_mean {last['reward_mean']:.5f}")
    return dict(seconds=seconds, kl=last["kl"], kl_guard=last["kl_guard_triggered"],
                reward_mean=last["reward_mean"])


def reach_phase(rollout, dev) -> dict:
    """Phase 11 (see the module docstring)."""
    import torch

    from handarm_tpu_torch import train
    from handarm_tpu_torch.envs.tasks import make_env, ppo_overrides
    from handarm_tpu_torch.learn.ppo import PPO, PPOConfig

    env = make_env("Ur5SihReach", device=dev)
    ppo = PPO(env, PPOConfig(**ppo_overrides("Ur5SihReach")))
    ts = ppo.init(0)
    rollout.reset_launch_counts()
    t0 = time.perf_counter()
    stats = []
    for _ in range(REACH_ITERS):
        ts, st = ppo.train_iter(ts)
        stats.append(st)
    rewards = [train.drain_stats(st)["reward_mean"] for st in stats]
    seconds = time.perf_counter() - t0
    check_launches(rollout.launch_counts(), {"spd_inverse": 16, "contact_sweep": 96,
                                             "prep_deff": 0, "sdf_gather": 0},
                   REACH_ITERS, "reach")
    check_learner(ts, "reach")
    first, last = sum(rewards[:5]) / 5, sum(rewards[-5:]) / 5
    log(f"reach: Ur5SihReach {env.cfg.num_envs} envs, {REACH_ITERS} iterations in "
        f"{seconds:.1f} s; reward_mean per iteration {[round(r, 5) for r in rewards]}; mean "
        f"of the first 5 {first:.5f}, of the last 5 {last:.5f}")
    return dict(task="Ur5SihReach", envs=env.cfg.num_envs, iterations=REACH_ITERS,
                seconds=seconds, reward_mean=rewards, first5=first, last5=last)


CLOUD_OBS = ("ur5_joint_pos", "ur5_flange_pose", "dof_position_targets",
             "target_object_interval_pos", "target_object_to_goal_pos",
             "object_synthetic_pointcloud", "target_object_synthetic_pointcloud",
             "target_object_synthetic_interval_pointcloud", "ur5sih_synthetic_pointcloud",
             "goal_synthetic_pointcloud", "scene_synthetic_pointcloud")


def clouds_phase(rollout, dev, ref_state) -> dict:
    """Phase 16 (see the module docstring)."""
    import torch

    from handarm_tpu_torch.envs import pointcloud as pc
    from handarm_tpu_torch.envs.hand_arm import HandArmEnv, tree_map
    from handarm_tpu_torch.envs.tasks import make_env

    lift = make_env("Ur5SihLift", device="cpu", num_envs=16).cfg
    cfg = dataclasses.replace(lift, observations=CLOUD_OBS,
                              teacher_observations=lift.observations)
    env_c, env_g = HandArmEnv(cfg, "cpu"), HandArmEnv(cfg, dev)
    st_c = ref_state._replace(task=ref_state.task._replace(
        progress=torch.arange(16, dtype=ref_state.task.progress.dtype)))
    st_g = tree_map(lambda x: x.to(dev), st_c)
    teacher = rollout.load_policy(rollout.TASK_CKPTS["Ur5SihLift"], "cpu")
    counts = sorted({pc.padded_points(len(env_c.robot_cloud[0]), cfg.pointcloud_max_points),
                     cfg.pointcloud_max_points})
    gen = torch.Generator().manual_seed(0)
    teacher_obs = env_c.observe(st_c)[1]
    for _ in range(2):
        act = teacher.act(teacher_obs)
        scores = {P: torch.rand((16, P), generator=gen) for P in counts}
        st_c, res_c = env_c.step(st_c, act, scores)
        st_g, res_g = env_g.step(st_g, act.to(dev), {P: x.to(dev) for P, x in scores.items()})
        teacher_obs = res_c.teacher_obs
    errs = {}
    for key, want in res_c.obs_dict.items():
        got = res_g.obs_dict[key].cpu()
        if got.shape != want.shape or not torch.equal(got[..., 3], want[..., 3]):
            raise AssertionError(f"clouds: {key} rows differ between the card and the CPU")
        errs[key] = float((got[..., :3] - want[..., :3]).abs().max())
    errs["teacher_obs"] = float((res_g.teacher_obs.cpu() - res_c.teacher_obs).abs().max())
    errs["obs"] = float((res_g.obs.cpu() - res_c.obs).abs().max())
    valid = {k: sorted(set((v[..., 3] > 0).sum(1).tolist())) for k, v in res_c.obs_dict.items()}
    shown = (st_c.task.progress % 4 == 0).tolist()
    log(f"clouds: 16 envs, 2 control steps of ckpt_5200 from the cpu-ref state, scores over "
        f"{counts} points; valid rows per cloud {valid}; interval shown {shown}; max|card-cpu| "
        f"{({k: float(f'{v:.3g}') for k, v in errs.items()})}")
    # the clouds are positions (2e-4 after 2 steps, as card_vs_cpu, plus the
    # rotation of points up to 0.1 m from their body's origin); the vectors
    # hold fingertip velocities: card_vs_cpu's observation bound
    if max(errs[k] for k in res_c.obs_dict) > 5e-4 or errs["teacher_obs"] > 2e-3 \
            or errs["obs"] > 2e-3:
        raise AssertionError("clouds: the card's observations disagree with the CPU's")
    if valid["target_object_synthetic_pointcloud"] != [14] or all(shown) or not any(shown):
        raise AssertionError("clouds: unexpected valid rows or interval clocks")
    return dict(envs=16, steps=2, max_abs_err=errs, valid_rows=valid)


class DistillRecorder:
    """While active, keeps the inputs and outputs of the DAgger's first
    gradient (`DAgger.grads`) and optimizer step (`DAgger.apply`)."""

    def __init__(self, dagger):
        self.dagger, self.grads, self.applies = dagger, [], []

    def __enter__(self):
        def recording(fn, calls):
            def wrapped(*args):
                out = fn(*args)
                if not calls:
                    calls.append((args, out))
                return out
            return wrapped

        self.dagger.grads = recording(self.dagger.grads, self.grads)
        self.dagger.apply = recording(self.dagger.apply, self.applies)
        return self

    def __exit__(self, *exc):
        del self.dagger.grads, self.dagger.apply


def distill_step_check(dagger, rec) -> dict:
    """The card's first minibatch step of a DAgger update, rerun on the CPU
    from the card's inputs, and in float64 there to size float32's own error
    (as update_precision sizes the PPO update's):
    - bc_loss and aux_loss within 1e-4 relative (float32 means of 32768 x 11
      and x 18 squared errors in another order);
    - the gradients of each tensor within 1e-4 of its largest value, as the
      PPO step's first gradients (compare_steps); the float64 errors of both
      sides are printed beside them;
    - the optimizer step from the card's params, Adam state and gradients:
      params within 2 float32 ulps of each tensor's largest value, Adam's
      moments within 1e-5 of theirs, the counters equal (compare_steps)."""
    import torch

    (params, mb), (grads, terms) = rec.grads[0]
    c_params, c_mb = to_cpu(params), to_cpu(mb)
    t0 = time.perf_counter()
    c_grads, c_terms = dagger.grads(c_params, c_mb)
    d = lambda x: {k: d(v) for k, v in x.items()} if isinstance(x, dict) else x.double()
    g64, t64 = dagger.grads(d(c_params), d(c_mb))
    cpu_s = time.perf_counter() - t0
    out = {"loss": {}, "grad": {}, "grad_card_f64": {}, "grad_cpu_f64": {}}
    for name, v in terms.items():
        err = abs(float(v) - float(c_terms[name]))
        out["loss"][name] = err / max(abs(float(c_terms[name])), 1e-30)
        if not err <= 1e-4 * abs(float(c_terms[name])):
            raise AssertionError(f"distill: card and CPU differ on {name}: {float(v)} vs "
                                 f"{float(c_terms[name])}")
    for name, g in grads.items():
        err, scale = max_err(g.cpu(), c_grads[name])
        out["grad"][name] = err / scale
        out["grad_card_f64"][name] = max_err(g.cpu().double(), g64[name])[0] / scale
        out["grad_cpu_f64"][name] = max_err(c_grads[name].double(), g64[name])[0] / scale
        if not err <= 1e-4 * scale:
            raise AssertionError(f"distill: card and CPU gradients of {name} differ: {err:.3e} "
                                 f"at scale {scale:.3e}")
    (a_params, a_opt, a_grads), (n_params, n_opt) = rec.applies[0]
    c_new, c_opt = dagger.apply(to_cpu(a_params), to_cpu(a_opt), to_cpu(a_grads))
    worst = {"param": 0.0, "adam mu": 0.0, "adam nu": 0.0}
    for kind, got, want, tol in (("param", n_params, c_new, 2 * FLOAT32_EPS),
                                 ("adam mu", n_opt.mu, c_opt.mu, 1e-5),
                                 ("adam nu", n_opt.nu, c_opt.nu, 1e-5)):
        for name, w in want.items():
            err, scale = max_err(got[name].cpu(), w)
            worst[kind] = max(worst[kind], err / (tol * scale))
            if not err <= tol * scale:
                raise AssertionError(f"distill: card and CPU {kind} {name} differ after the "
                                     f"step: {err:.3e} at scale {scale:.3e}")
    for a, b in zip(n_opt[:4], c_opt[:4]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("distill: card and CPU optax counters differ")
    moved = max(float((n_params[k] - a_params[k]).abs().max()) for k in n_params)
    rel = lambda m: float(f"{max(m.values()):.3g}")
    log(f"distill card-vs-cpu, the first minibatch step ({c_mb['obs'].shape[0]} samples) from "
        f"the card's inputs: loss terms {({k: float(f'{v:.3g}') for k, v in out['loss'].items()})}"
        f" relative; gradients up to {rel(out['grad'])} of scale (card vs float64 "
        f"{rel(out['grad_card_f64'])}, CPU vs float64 {rel(out['grad_cpu_f64'])}); optimizer "
        f"step: largest fraction of each tolerance used "
        f"{({k: round(v, 5) for k, v in worst.items()})}; params moved up to {moved:.3e}; "
        f"the CPU's float32 and float64 steps took {cpu_s:.1f} s")
    return dict(out, step=worst, params_moved=moved, cpu_s=cpu_s)


def distill_train_phase(rollout, dev) -> dict:
    """Phase 17 (see the module docstring)."""
    import torch

    from handarm_tpu_torch import train
    from handarm_tpu_torch.learn.distill import DAgger
    from handarm_tpu_torch.train_distill import (DEFAULT_STUDENT_OBS, distill_config,
                                                 student_setup)

    ckpt = rollout.TASK_CKPTS["Ur5SihLift"]
    env, teacher, cloud_keys, aux = student_setup("Ur5SihLift", ENVS, ckpt,
                                                  DEFAULT_STUDENT_OBS, dev)
    dagger = DAgger(env, teacher, distill_config(ENVS, 400, cloud_keys), aux_from_obs=aux)
    cfg = dagger.cfg
    ds = dagger.init(0)
    n = ENVS * cfg.horizon
    mb, n_mb = dagger.minibatches(n)
    log(f"distill-train: Ur5SihLift {ENVS} envs, student obs {env.num_obs} + clouds "
        f"{cloud_keys}, teacher obs {env.num_teacher_obs} ({os.path.relpath(ckpt)}), aux "
        f"{aux}; horizon {cfg.horizon}, {n_mb} minibatches of {mb} x {cfg.mini_epochs} "
        f"mini-epochs")
    per_iter = {"spd_inverse": 16, "contact_sweep": 96, "prep_deff": 0, "sdf_gather": 0}
    rollout.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds, _ = dagger.train_iter(ds)
    torch.cuda.synchronize()
    log(f"distill-train: warm-up iteration {time.perf_counter() - t0:.3f} s")
    check_launches(rollout.launch_counts(), per_iter, 1, "distill warm-up")
    start, iters = ds.params, []
    torch.cuda.reset_peak_memory_stats()
    for i in range(DISTILL_ITERS + 1):
        last = i == DISTILL_ITERS  # untimed: its first step is held against the CPU
        rollout.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta = dagger.beta(ds.iteration)
        collected = dagger.rollout(ds, beta)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with DistillRecorder(dagger) if last else contextlib.nullcontext() as recorder:
            ds, stats = dagger.update(ds, beta, *collected)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del collected
        counts = rollout.launch_counts()
        check_launches(counts, per_iter, 1, f"distill iteration {i}")
        rec = dict(rollout_s=t1 - t0, update_s=t2 - t1, env_steps_per_s=n / (t2 - t0),
                   launches=counts, **train.drain_stats(stats))
        for name, p in ds.params.items():
            if not bool(torch.isfinite(p).all()):
                raise AssertionError(f"distill: non-finite param {name}")
        timing = "untimed (its first step is held against the CPU)" if last else (
            f"rollout {rec['rollout_s']:.3f} s, update {rec['update_s']:.3f} s, "
            f"{rec['env_steps_per_s']:.0f} env-steps/s")
        log(f"distill iteration {i}: {timing}; bc_loss {rec['bc_loss']:.5f} aux_loss "
            f"{rec['aux_loss']:.5f} beta {rec['beta']:.5f} success_rate_ewma "
            f"{rec['success_rate_ewma']:.4f}; launches {counts}")
        if not last:
            iters.append(rec)
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = max(float((ds.params[k] - start[k]).abs().max()) for k in start)
    if not moved > 0:
        raise AssertionError("distill: the student did not move")
    log(f"distill-train: peak device memory {peak:.2f} GiB; max |params - start| after "
        f"{DISTILL_ITERS + 1} iterations {moved:.4e}")
    check = distill_step_check(dagger, recorder)
    mean = lambda k: sum(r[k] for r in iters) / len(iters)
    return dict(task="Ur5SihLift", envs=ENVS, horizon=cfg.horizon, minibatches=n_mb,
                minibatch_size=mb, mini_epochs=cfg.mini_epochs, iterations=iters,
                rollout_s=mean("rollout_s"), update_s=mean("update_s"),
                env_steps_per_s=n * len(iters) / sum(r["rollout_s"] + r["update_s"]
                                                     for r in iters),
                peak_memory_gib=peak, params_moved=moved, card_vs_cpu=check,
                launches_per_iteration=per_iter)


def distill_entry_phase(rollout) -> dict:
    """Phase 19 (see the module docstring)."""
    import numpy as np

    ckpt = os.path.relpath(rollout.TASK_CKPTS["Ur5SihLift"])
    out = os.path.join("runs", "chip_smoke_distill")
    train_s, _ = run_module("handarm_tpu_torch.train_distill", [
        "--teacher", ckpt, "--envs", str(ENVS), "--iters", str(DISTILL_ENTRY_ITERS),
        "--out", out, "--seed", "1"], "distill entry point", 150)
    with np.load(os.path.join(out, "student.npz")) as data:
        leaves = [data[k] for k in data.files]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        row = json.loads(f.read().splitlines()[-1])
    if len(leaves) != 18 or not all(np.isfinite(x).all() for x in leaves) \
            or row["step"] != DISTILL_ENTRY_ITERS:
        raise AssertionError(f"distill entry point: bad output in {out}")
    eval_s, stdout = run_module("handarm_tpu_torch.eval_policy", [
        "--student", os.path.join(out, "student.npz"), "--teacher", ckpt, "--envs", str(ENVS),
        "--steps", "10", "--episode-length", "5"], "student eval entry point", 150)
    res = json.loads(stdout.strip().splitlines()[-1])
    if res["episodes"] != 2 * ENVS:
        raise AssertionError(f"student eval entry point: {res['episodes']} episodes, "
                             f"expected {2 * ENVS}")
    log(f"distill entry points: train_distill's last row {row}; the student's eval {res}")
    return dict(train_distill_s=train_s, last_row=row, eval_policy_s=eval_s, eval=res)

# float32 against float64 for the recurrent learner's first minibatch step,
# `python -m handarm_tpu_torch.update_precision --recurrent --envs 256 --seqs
# 1024 --device cpu` (on the CPU): gradients 2.4e-6 of each tensor's largest
# value, loss terms 2.8e-7 relative (entropy; the rest under 1e-7). Each
# side is held to 8x that on the gradients, 35x on the loss terms (plus
# 1e-8 for terms near 0: the policy loss and KL of a first step)
RNN_CHECK_SEQS = 1024
RNN_GRAD_TOL = 2e-5
RNN_LOSS_TOL = (1e-5, 1e-8)  # relative to the float64 term, absolute


def rnn_step_check(ppo, rec) -> dict:
    """The recurrent learner's first minibatch step from the card's inputs:
    its first RNN_CHECK_SEQS sequences' loss terms and gradients on the
    card, on the CPU and in float64 on the CPU (`grad_errors`), each pair
    within RNN_LOSS_TOL and RNN_GRAD_TOL; then the optimizer step from the
    card's params, Adam state, lr and gradients, as `compare_steps` holds
    it (params 2 float32 ulps of scale, Adam moments 1e-5, counters equal,
    the lr)."""
    from types import SimpleNamespace

    from handarm_tpu_torch.update_precision import grad_errors

    (stats, params, mb), _ = rec.grads[0]
    sub = {k: v[:RNN_CHECK_SEQS] for k, v in mb.items()}
    t0 = time.perf_counter()
    errs = grad_errors(ppo, (stats, params, sub))
    worst = {}
    for pair in ("device vs f64", "cpu vs f64", "device vs cpu"):
        e = errs[pair]
        loss = max(v / (RNN_LOSS_TOL[0] * abs(errs["loss_f64"][k]) + RNN_LOSS_TOL[1])
                   for k, v in e["loss"].items())
        worst[pair] = dict(loss=loss, grad=e["grad"] / RNN_GRAD_TOL)
        if not (loss <= 1.0 and e["grad"] <= RNN_GRAD_TOL):
            raise AssertionError(f"rnn-train: {pair} differ on the first step: {e}")
    grad_s = time.perf_counter() - t0
    steps = compare_steps(ppo, SimpleNamespace(grads=[], applies=rec.applies[:1]),
                          ppo.cfg.kl_threshold, "rnn-train first optimizer step")
    log(f"rnn-train card-vs-cpu-vs-float64, the first minibatch step's first {RNN_CHECK_SEQS} "
        f"sequences from the card's inputs ({grad_s:.1f} s): gradients card "
        f"{errs['device vs f64']['grad']:.3e}, CPU {errs['cpu vs f64']['grad']:.3e} of scale "
        f"from float64, card vs CPU {errs['device vs cpu']['grad']:.3e}; loss terms (float64 "
        f"{errs['loss_f64']}) apart by {({p: errs[p]['loss'] for p in worst})}; largest "
        f"fraction of each tolerance used {worst}")
    return dict(errs, tolerance_used=worst, optimizer_step=steps, seconds=grad_s)


def rnn_train_phase(rollout, dev):
    """Phase 20 (see the module docstring). Returns (record, PPO, TrainState)."""
    from handarm_tpu_torch.envs.hand_arm import HandArmEnv
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.envs.tasks import LSTM_LIFT

    env_cfg, over = resolve_task("Ur5SihLift", [f"num_envs={ENVS}", *LSTM_LIFT])
    ppo = PPO(HandArmEnv(env_cfg, dev), ppo_config(over))
    cfg, env = ppo.cfg, ppo.env
    log(f"rnn-train: Ur5SihLift {ENVS} envs; actor obs {env.num_obs}, critic obs "
        f"{env.num_teacher_obs}; LSTM {cfg.rnn_units} / {cfg.critic_rnn_units}, hidden "
        f"{cfg.hidden}, seq_len {cfg.seq_len}, gamma {cfg.gamma}; horizon {cfg.horizon}, "
        f"{ppo.num_minibatches} minibatches of {ppo.mb_rows} sequences x {cfg.mini_epochs} "
        f"mini-epochs; {sum(p.numel() for p in ppo.net.parameters())} params, flax-default "
        f"init")
    rec = learner_run(rollout, ppo, ppo.init(0), LIFT_PER_ITER, "rnn-train",
                      step_check=rnn_step_check)
    ts = rec.pop("ts")
    return dict(task="Ur5SihLift", overrides=LSTM_LIFT, **rec), ppo, ts


def rnn_serve_phase(rollout, ppo, ts, dev) -> dict:
    """Phase 21 (see the module docstring)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import HandArmEnv, tree_map
    from handarm_tpu_torch.learn.ppo import carry_map, zero_where

    env = ppo.env

    def serve(env, ts, state, obs, hidden):
        a, hidden = ppo.act(ts, obs, True, hidden)
        state, res = env.step(state, a)
        if ppo.cfg.zero_rnn_on_done:
            hidden = zero_where(res.done, hidden)
        return state, res.obs, hidden, a

    state, obs = env.reset(1)
    state, obs, hidden, _ = serve(env, ts, state, obs, None)  # warm-up
    torch.cuda.synchronize()
    rollout.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, obs, hidden, _ = serve(env, ts, state, obs, hidden)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = rollout.launch_counts()
    check_launches(counts, LIFT_PER_STEP, STEPS, "rnn-serve")
    finite_state(tree_map, state, obs)
    if not all(bool(torch.isfinite(x).all()) for x in carry_leaves(hidden)):
        raise AssertionError("rnn-serve: non-finite carry")
    rate = ENVS * STEPS / seconds
    log(f"rnn-serve: {STEPS} deterministic PPO.act control steps at {ENVS} envs, the carry "
        f"threaded (zeroed where an episode ended) in {seconds:.3f} s = {rate:.0f} "
        f"env-steps/s; launches {counts}")

    # card against CPU: 16 envs of that state, clocks zeroed, 2 control steps
    take = lambda x: x[:16] if x.dim() and x.shape[0] == ENVS else x
    st_g = tree_map(take, state)
    st_g = st_g._replace(task=st_g.task._replace(progress=torch.zeros_like(st_g.task.progress)))
    small = dataclasses.replace(env.cfg, num_envs=16)
    env_g, env_c = HandArmEnv(small, dev), HandArmEnv(small, "cpu")
    st_c, ts_c = to_cpu(st_g), learner_cpu(ts)
    h_g = carry_map(take, hidden)
    h_c, obs_g = to_cpu(h_g), take(obs)
    obs_c = obs_g.cpu()
    errs = []
    for k in range(2):
        a_g, h_g = ppo.act(ts, obs_g, True, h_g)
        a_c, h_c = ppo.act(ts_c, obs_c, True, h_c)
        carry = max(float((x.cpu() - y).abs().max()) for x, y in
                    zip(carry_leaves(h_g), carry_leaves(h_c)))
        st_g, res_g = env_g.step(st_g, a_g)
        st_c, res_c = env_c.step(st_c, a_c)
        obs_g, obs_c = res_g.obs, res_c.obs
        errs.append(dict(action=float((a_g.cpu() - a_c).abs().max()), carry=carry,
                         q=float((st_g.physics.robot.q.cpu() - st_c.physics.robot.q).abs().max()),
                         obs=float((obs_g.cpu() - obs_c).abs().max())))
    log(f"rnn-serve card-vs-cpu, 16 envs, 2 control steps, each side acting on its own "
        f"observations and carry: {errs}")
    # step 1 from the same inputs: float32 nets, 1e-4; step 2 from each
    # side's observations (the env-step bound, 2e-3); q the JAX package's 2e-4
    first, second = errs
    if not (first["action"] <= 1e-4 and first["carry"] <= 1e-4 and second["action"] <= 2e-3
            and second["carry"] <= 2e-3 and max(e["q"] for e in errs) <= 2e-4
            and max(e["obs"] for e in errs) <= 2e-3):
        raise AssertionError("rnn-serve: the card's recurrent policy disagrees with the CPU's")
    return dict(envs=ENVS, control_steps=STEPS, seconds=seconds, env_steps_per_s=rate,
                launches=counts, card_vs_cpu=errs)


def carry_leaves(carry) -> list:
    """The tensors of a carry, (c, h) or {"actor": ..., "critic": ...}."""
    from handarm_tpu_torch.learn.ppo import carry_items

    return list(carry_items(carry).values())


def rnn_entry_phase(ppo) -> dict:
    """Phase 22 (see the module docstring)."""
    import numpy as np

    from handarm_tpu_torch.envs.tasks import LSTM_LIFT
    from handarm_tpu_torch.utils.checkpoint import load_train_state

    exp = "chip_smoke_rnn"
    args = ["task=Ur5SihLift", f"num_envs={ENVS}", *LSTM_LIFT, f"experiment={exp}", "seed=1"]
    nn_dir = os.path.join("runs", exp, "nn")
    first_s, _ = run_module("handarm_tpu_torch.train", args + ["max_iterations=2"],
                            "rnn entry point", 150)
    resume_s, _ = run_module("handarm_tpu_torch.train", args + ["max_iterations=3",
                                                                 "resume=auto"],
                             "rnn entry point resumed", 150)
    ts2, ts3 = (load_train_state(os.path.join(nn_dir, f"ckpt_{i}.npz"), cfg=ppo.cfg)
                for i in (2, 3))
    steps = ppo.num_minibatches * ppo.cfg.mini_epochs
    check_learner(ts3, "rnn entry point")
    with open(os.path.join("runs", exp, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f.read().splitlines()]
    ok = (int(ts2.epoch) == 2 and int(ts3.epoch) == 3
          and int(ts3.opt_state.count) == 3 * steps - int(ts3.opt_state.total_notfinite)
          and float(ts3.teacher_obs_stats.count) > float(ts2.teacher_obs_stats.count)
          and [r["step"] for r in rows] == [0, 1, 2]
          and all(np.isfinite(r["kl"]) for r in rows)
          and any(float(x.abs().max()) > 0 for x in carry_leaves(ts3.hidden)))
    if not ok:
        raise AssertionError(f"rnn entry point: bad checkpoints or metrics in runs/{exp}")
    log(f"rnn entry point: 2 iterations in {first_s:.1f} s, resumed for a third in "
        f"{resume_s:.1f} s; its rows {[(r['step'], round(r['kl'], 5)) for r in rows]}")
    return dict(first_s=first_s, resume_s=resume_s, rows=rows)


ADR_ON = "rl.randomization_params.adr.enabled=true"
DR_ITERS = 1  # timed dr-train iterations, after one warm-up iteration
ADR_ITERS = 1  # timed adr iterations, after one warm-up iteration
ADR_CHECK_STEPS = 3  # adr_step check: steps at objective 1, then as many at 0


def timed_iterations(rollout, ppo, ts, n: int, per_iter: dict, tag: str, capture=None):
    """One warm-up train_iter, then n iterations timed as rollout and update
    (each part between torch.cuda.synchronize calls); counters zeroed before
    each iteration and read after it: exactly `per_iter`; params, stats and
    every state leaf finite. `capture` (a Capture with last_only) is armed
    for the last timed rollout. Returns (record, TrainState)."""
    import torch

    from handarm_tpu_torch import train
    from handarm_tpu_torch.envs.hand_arm import tree_map

    samples = ppo.env.cfg.num_envs * ppo.cfg.horizon
    rollout.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, _ = ppo.train_iter(ts)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check_launches(rollout.launch_counts(), per_iter, 1, f"{tag} warm-up")
    torch.cuda.reset_peak_memory_stats()
    iters = []
    for i in range(n):
        rollout.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if capture is not None:
            capture.armed = i == n - 1
        r = ppo.rollout(ts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if capture is not None:
            capture.armed = False
        ts, stats = ppo._update_from_traj(ts, r.traj, r.env_state, r.last_obs, None, r.info,
                                          r.last_teacher_obs, r.last_hidden)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = rollout.launch_counts()
        check_launches(counts, per_iter, 1, f"{tag} iteration {i}")
        check_learner(ts, tag)
        finite_state(tree_map, ts.env_state, ts.last_obs)
        rec = dict(rollout_s=t1 - t0, update_s=t2 - t1, env_steps_per_s=samples / (t2 - t0),
                   launches=counts, **train.drain_stats({k: stats[k] for k in (
                       "reward_mean", "kl", "lr", "kl_guard_triggered", "success_rate_ewma")}))
        log(f"{tag} iteration {i}: rollout {rec['rollout_s']:.3f} s, update "
            f"{rec['update_s']:.3f} s, {rec['env_steps_per_s']:.0f} env-steps/s; reward_mean "
            f"{rec['reward_mean']:.5f} kl {rec['kl']:.5f} kl_guard "
            f"{rec['kl_guard_triggered']:.0f}; launches {counts}")
        iters.append(rec)
        del r
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag}: warm-up iteration {warm:.3f} s; peak device memory {peak:.2f} GiB; every "
        "param, stat and state leaf finite")
    mean = lambda k: sum(r[k] for r in iters) / len(iters)
    return dict(envs=ppo.env.cfg.num_envs, horizon=ppo.cfg.horizon,
                minibatches=ppo.num_minibatches, minibatch_size=ppo.mb_size,
                mini_epochs=ppo.cfg.mini_epochs, warmup_s=warm, iterations=iters,
                rollout_s=mean("rollout_s"), update_s=mean("update_s"),
                env_steps_per_s=samples * n / sum(r["rollout_s"] + r["update_s"] for r in iters),
                peak_memory_gib=peak, launches_per_iteration=per_iter), ts


def randomized_learner(rollout, dev, pool, compose, tag):
    """Ur5SihMultiObjectManipulation at ENVS envs as `train.py` composes it
    with the `compose` overrides, on the multiobj phase's pool, and
    ckpt_2700's learner on a fresh reset: (env, PPO, TrainState)."""
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.utils.checkpoint import load_train_state

    ckpt = rollout.TASK_CKPTS[MULTI_TASK]
    env = rollout.make_task_env(MULTI_TASK, ENVS, dev, pool=pool, compose=compose)
    ppo = PPO(env, ppo_config(resolve_task(MULTI_TASK, list(compose))[1]))
    fresh = ppo.init(0)
    start = load_train_state(ckpt, dev, fresh.env_state, fresh.last_obs)
    log(f"{tag}: {MULTI_TASK} composed with {len(compose)} overrides, {ENVS} envs, "
        f"{env.cfg.solver_iterations} sweeps, {ppo.num_minibatches} minibatches of "
        f"{ppo.mb_size}; DR {env.cfg.dr}; ADR {env.cfg.adr}; from {os.path.relpath(ckpt)}'s "
        f"learner (epoch {int(start.epoch)}) on a fresh reset")
    return env, ppo, start


def dr_train_phase(rollout, dev, pool, ops) -> tuple:
    """Phase 23 (see the module docstring). Returns (record, env, final
    TrainState, the kernels' captured calls)."""
    import numpy as np
    import torch

    from handarm_tpu_torch.convert import env_state_to_leaves
    from handarm_tpu_torch.envs.randomization import DRState
    from handarm_tpu_torch.envs.tasks import DR_SHADOWHAND
    from handarm_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint

    env, ppo, start = randomized_learner(rollout, dev, pool, DR_SHADOWHAND, "dr-train")
    dr = env.cfg.dr
    if not (dr.enabled and dr.mass_scale_range == (0.5, 1.5) and dr.gravity_noise == 0.4
            and not env.cfg.adr.enabled):
        raise AssertionError(f"dr-train: the composed DR is not ShadowHand's: {dr}")
    per_iter = {k: 16 * v for k, v in MULTI_PER_STEP.items()}
    with Capture(ops, last_only=True) as cap:
        rec, ts = timed_iterations(rollout, ppo, start, DR_ITERS, per_iter, "dr-train", cap)
    # the DRState in play, read back from the state
    ranges = {"mass_scale": dr.mass_scale_range, "friction_scale": dr.friction_scale_range,
              "gain_scale": dr.gain_scale_range}
    spans = {}
    for name, x in zip(DRState._fields, ts.env_state.task.dr):
        lo, hi = float(x.min()), float(x.max())
        spans[name] = (lo, hi)
        log(f"dr-train: DRState.{name} {tuple(x.shape)} min {lo:.6f} max {hi:.6f}")
        if name in ranges and not ranges[name][0] <= lo <= hi <= ranges[name][1]:
            raise AssertionError(f"dr-train: {name} outside {ranges[name]}")
    g_std = float(ts.env_state.task.dr.gravity_z.std())
    log(f"dr-train: std of gravity_z over {ENVS} envs {g_std:.5f} (gravity_noise 0.4)")
    if not abs(g_std - 0.4) <= 0.04:
        raise AssertionError("dr-train: gravity_z's spread is not gravity_noise's")
    path = save_checkpoint(os.path.join("runs", "chip_smoke_dr_roundtrip"), ts, 1, sync=True,
                           cfg=ppo.cfg, env_cfg=env.cfg)
    back = load_train_state(path, dev, cfg=ppo.cfg, env_cfg=env.cfg)
    a, b = env_state_to_leaves(ts.env_state), env_state_to_leaves(back.env_state)
    if len(a) != 30 or len(b) != 30 or not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("dr-train: the env state did not survive the checkpoint")
    log(f"dr-train: the TrainState round-trips through {path}: 30 env leaves equal")
    rec.update(drstate_ranges=spans, gravity_z_std=g_std, checkpoint_env_leaves=30)
    calls = cap.calls
    del ppo, start
    torch.cuda.empty_cache()
    return rec, env, ts, calls


def dr_reached(env, ts, calls, dev) -> dict:
    """Where DR's scales reach the kernels: the sweep's mu plane over the
    slots' base friction spans more than half of the friction range for one
    slot across envs; its invm planes over the base inverse masses lie in
    [1/1.5, 1/0.5] and vary; the SPD inverse's matrices of the final state
    differ from the same state's unscaled ones by exactly the scaled PD
    terms on the diagonal (h kd (g - 1) + h^2 kp (g - 1))."""
    import torch

    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op
    from handarm_tpu_torch.physics.engine import compute_heavy

    sc = env.scene
    planes = calls["sweep"][0][0][0]
    fric = torch.as_tensor(sc.slots.friction, device=dev)
    c = int(torch.nonzero(fric > 0)[0])
    mu = planes[sweep_op.BASE["mu"], :, c] / fric[c]
    lo, hi = env.cfg.dr.friction_scale_range
    mu_span = float(mu.max() - mu.min())
    log(f"dr-kernels: slot {c}'s mu over its base friction across {ENVS} envs: "
        f"{float(mu.min()):.5f}-{float(mu.max()):.5f} (span {mu_span:.5f})")
    if not (mu_span > 0.5 * (hi - lo) and float(mu.min()) >= lo - 1e-5
            and float(mu.max()) <= hi + 1e-5):
        raise AssertionError("dr-kernels: the friction scale did not reach the sweep's mu plane")
    invm = {}
    for s, (kidx, mask) in enumerate(zip(sc.maps.side_kidx, sc.maps.side_mask)):
        has = mask > 0
        r = planes[sweep_op.NBASE + s * sweep_op.NSIDE + 9][:, has] / \
            sc.shapes.inv_mass[kidx][has]
        invm[f"side {s}"] = (float(r.min()), float(r.max()), float(r.std()))
        if not (float(r.min()) >= 1 / 1.5 - 1e-5 and float(r.max()) <= 1 / 0.5 + 1e-5
                and float(r.std()) > 0):
            raise AssertionError("dr-kernels: the mass scale did not reach the sweep's invm planes")
    log(f"dr-kernels: invm over the base inverse mass (min, max, std) per side {invm}")
    st = ts.env_state
    ovr = env.overrides(st.task, ENVS)
    with Capture({"spd": (spd_op, "spd_inverse")}) as cap:
        cap.armed = True
        compute_heavy(sc, st.physics, ovr)
        compute_heavy(sc, st.physics)
    m_dr, m_plain = cap.calls["spd"][0][0][0], cap.calls["spd"][1][0][0]
    h = env.cfg.dt / env.cfg.substeps
    g = ovr.gain_scale
    want = h * sc.kd * (g - 1.0) + h * h * sc.kp * (g - 1.0)
    diff = m_dr - m_plain
    diag = torch.diagonal(diff, dim1=1, dim2=2)
    err = float((diag - want).abs().max())
    off = float((diff - torch.diag_embed(diag)).abs().max())
    scale = float(want.abs().max())
    log(f"dr-kernels: spd_inverse input minus the unscaled matrix of the same state: diagonal "
        f"{scale:.4e} at most, off its PD terms by {err:.3e}; off-diagonal {off:.3e}")
    top = float(m_plain.abs().max())
    if not (scale > 0 and err <= 1e-5 * top and off <= 1e-6 * top):
        raise AssertionError("dr-kernels: the gain scale did not reach the SPD inverse's input")
    return dict(mu_span=mu_span, invm_over_base=invm, spd_pd_diagonal_max=scale,
                spd_pd_diagonal_err=err)


def dr_kernels_phase(env, ts, calls, dev) -> dict:
    """Phase 24 (see the module docstring)."""
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import prep_deff as deff_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    out = {"reached": dr_reached(env, ts, calls, dev)}
    out["spd_inverse"] = check_spd(spd_op, calls["spd"][0][0][0], dev, "dr")
    out["prep_deff"] = check_deff(deff_op, calls["deff"][0][0])
    out["contact_sweep"] = check_sweep(sweep_op, calls["sweep"][0], env.scene.maps, "dr")
    return out


def dr_ref_phase(rollout, dev, env, ts, pool) -> dict:
    """Phase 25 (see the module docstring)."""
    import numpy as np
    import torch

    from handarm_tpu_torch.envs import genesis
    from handarm_tpu_torch.envs.hand_arm import StepDraws
    from handarm_tpu_torch.envs.tasks import DR_SHADOWHAND

    ref_state, ref_obs = pick_contact_envs(env.scene.slots, ts.env_state, ts.last_obs, 16,
                                           "dr-ref")
    ms = ref_state.task.dr.mass_scale
    distinct = [int(torch.unique(ms[:, k]).numel()) for k in range(ms.shape[1])]
    log(f"dr-ref: distinct mass scales per object among the 16 envs {distinct}")
    if min(distinct) < 2:
        raise AssertionError("dr-ref: an object has one mass scale in the compared envs")
    small = genesis.InitialPool(pool.pos[:, :16].cpu(), pool.quat[:, :16].cpu())
    # as multiobj-ref, with ShadowHand's DR
    env_c = small_multi_env(rollout, "cpu", small, DR_SHADOWHAND)
    rng = np.random.default_rng(5)
    f = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    draws = [StepDraws(act_noise=f(16, env_c.num_actions), obs_noise=f(16, env_c.num_obs))
             for _ in range(2)]
    with deff_at_any_size():
        card_vs_cpu(env_c, small_multi_env(rollout, dev, small, DR_SHADOWHAND), ref_state,
                    ref_obs, rollout.load_policy(rollout.TASK_CKPTS[MULTI_TASK], "cpu"), dev,
                    "dr-ref", need=("robot-object", "object-pair"), draws=draws)
    return dict(envs=16, control_steps=2, distinct_mass_scales=distinct)


def adr_step_check(cfg, dev) -> dict:
    """adr_step on the card against the CPU from the same state and draws at
    ENVS envs, every env done: ADR_CHECK_STEPS steps at objective 1, then
    one more at 0 (every queue fills each step at this size: the bounds move
    out by delta a step, then back in and clip at their initial values).
    lo, hi, the queues and the modes exact, values within 1e-6."""
    import torch

    from handarm_tpu_torch.envs.adr import adr_draws, adr_entropy, adr_step, init_adr_state
    from handarm_tpu_torch.envs.hand_arm import tree_map

    gen = torch.Generator().manual_seed(0)
    s_c = init_adr_state(cfg, ENVS, gen)
    s_g = tree_map(lambda x: x.to(dev), s_c)
    done = torch.ones(ENVS, dtype=torch.bool)
    entropy = [float(adr_entropy(s_g))]
    worst = 0.0
    for i, obj in enumerate([1.0] * ADR_CHECK_STEPS + [0.0] * (ADR_CHECK_STEPS + 1)):
        d = adr_draws(cfg, ENVS, gen, "cpu")
        objective = torch.full((ENVS,), obj)
        s_c = adr_step(cfg, s_c, done, objective, draws=d)
        s_g = adr_step(cfg, s_g, done.to(dev), objective.to(dev),
                       draws=tree_map(lambda x: x.to(dev), d))
        for name, g, c in zip(s_c._fields, s_g, s_c):
            g = g.cpu()
            if name == "values":
                worst = max(worst, float((g - c).abs().max()))
                if worst > 1e-6:
                    raise AssertionError(f"adr_step: values card vs CPU {worst:.3e}")
            elif not torch.equal(g, c):
                raise AssertionError(f"adr_step: {name} differs between card and CPU")
        entropy.append(float(adr_entropy(s_g)))
        log(f"adr_step {i} (objective {obj}): lo {[round(x, 6) for x in s_g.lo.tolist()]} hi "
            f"{[round(x, 6) for x in s_g.hi.tolist()]}; entropy {entropy[-1]:.4f} nats")
        if i == ADR_CHECK_STEPS - 1:
            widest = (s_c.lo.clone(), s_c.hi.clone())
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    n = ADR_CHECK_STEPS
    delta = t(cfg.delta)
    want_lo = torch.maximum(t(cfg.init_lo) - n * delta, t(cfg.limit_lo))
    want_hi = torch.minimum(t(cfg.init_hi) + n * delta, t(cfg.limit_hi))
    ok = (float((widest[0] - want_lo).abs().max()) <= 1e-6
          and float((widest[1] - want_hi).abs().max()) <= 1e-6
          and torch.equal(s_c.lo, t(cfg.init_lo)) and torch.equal(s_c.hi, t(cfg.init_hi)))
    if not ok:
        raise AssertionError("adr_step: the bounds did not move out by delta and back")
    log(f"adr_step: {2 * n + 1} steps at {ENVS} envs, card and CPU agree (lo, hi, queues, modes "
        f"exact; values within {worst:.1e}); adr_entropy {entropy[0]:.4f} -> "
        f"{max(entropy):.4f} -> {entropy[-1]:.4f} nats")
    return dict(steps=2 * n + 1, values_max_err=worst, entropy=entropy)


def adr_phase(rollout, dev, pool) -> dict:
    """Phase 26 (see the module docstring)."""
    from handarm_tpu_torch.envs.adr import AdrConfig
    from handarm_tpu_torch.envs.tasks import DR_SHADOWHAND

    env, ppo, start = randomized_learner(rollout, dev, pool, DR_SHADOWHAND + [ADR_ON], "adr")
    if env.cfg.adr != AdrConfig(enabled=True) or not env.cfg.dr.enabled:
        raise AssertionError(f"adr: the composed ADR is not the defaults over DR: {env.cfg.adr}")
    per_iter = {k: 16 * v for k, v in MULTI_PER_STEP.items()}
    rec, ts = timed_iterations(rollout, ppo, start, ADR_ITERS, per_iter, "adr")
    a = ts.env_state.task.adr
    log(f"adr: after {1 + ADR_ITERS} iterations: lo {a.lo.tolist()} hi {a.hi.tolist()} queue "
        f"counts {a.q_cnt.tolist()}; boundary workers {int((a.worker_mode >= 0).sum())} of "
        f"{ENVS}")
    rec["queue_counts"] = a.q_cnt.tolist()
    del ppo, start, ts, env
    rec["adr_step"] = adr_step_check(AdrConfig(enabled=True), dev)
    return rec


def dr_entry_phase(rollout) -> dict:
    """Phase 27 (see the module docstring)."""
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.envs.tasks import DR_SHADOWHAND
    from handarm_tpu_torch.utils.checkpoint import file_env_leaves, load_train_state, read_leaves

    ckpt = os.path.relpath(rollout.TASK_CKPTS[MULTI_TASK])
    step = int(os.path.basename(ckpt)[5:-4]) + 1
    out = os.path.join("runs", "chip_smoke_dr", "nn", f"ckpt_{step}.npz")
    rec = entry_subprocess(
        [f"task={MULTI_TASK}", f"resume={ckpt}", f"max_iterations={step}", *DR_SHADOWHAND,
         ADR_ON, "experiment=chip_smoke_dr", "seed=1"],
        out, "dr entry point", PHASE_DEADLINE_S["dr-entry"] - 30, n_leaves=83)
    env_cfg, _ = resolve_task(MULTI_TASK, DR_SHADOWHAND + [ADR_ON])
    ts = load_train_state(out, env_cfg=env_cfg)
    task = ts.env_state.task
    epoch = int(read_leaves(ckpt)[70]) + 1  # the resumed file's, one iteration on
    if not (file_env_leaves(out) == 36 and int(ts.epoch) == epoch and task.adr is not None
            and task.dr is not None):
        raise AssertionError(f"dr entry point: {out} is not a DR + ADR TrainState")
    try:
        load_train_state(out, env_cfg=resolve_task(MULTI_TASK)[0])
    except ValueError as e:
        log(f"dr entry point: a reader given the config without DR refuses the file: {e}")
    else:
        raise AssertionError("dr entry point: a reader without DR read a DR + ADR file")
    log(f"dr entry point: {out} holds 36 env leaves, epoch {int(ts.epoch)}; ADR lo "
        f"{task.adr.lo.tolist()} hi {task.adr.hi.tolist()}")
    return dict(rec, env_leaves=36)


# the engine's other cadences and collision set (phases 28-32)
ENGINE_OPTIONS = {
    "heavy every sim step": dict(heavy_prep_per_control=False),
    "exact FK": dict(carry_fk=False),
    "arm spheres": dict(hand_only_collision=False),
}
# launches per control step (3 sim steps x 2 substeps; sdf_gather once per
# contact generation): the mass structure every sim step; exact FK and
# contacts every sim step against compute_heavy's (whose own contact set
# feeds its prep: 1 + 3); the default cadence on the arm's 456 slots
ENGINE_PER_STEP = {
    "heavy every sim step": {"spd_inverse": 3, "contact_sweep": 6, "prep_deff": 3,
                             "sdf_gather": 3},
    "exact FK": {"spd_inverse": 1, "contact_sweep": 6, "prep_deff": 1, "sdf_gather": 4},
    "arm spheres": {"spd_inverse": 1, "contact_sweep": 6, "prep_deff": 1, "sdf_gather": 3},
}
ENGINE_STEPS = 5  # timed control steps per option, after one warm-up step
ENGINE_API_SIM_STEPS = 3
# launches over those 3 sim steps: substep_contacts (dynamics and prep at
# each step's start, contacts at its start and every substep), substep
# (everything every substep)
ENGINE_API_LAUNCHES = {
    "substep contacts": {"spd_inverse": 3, "contact_sweep": 6, "prep_deff": 3,
                         "sdf_gather": 9},
    "substep": {"spd_inverse": 6, "contact_sweep": 6, "prep_deff": 6, "sdf_gather": 6},
}
# the composed arm-sphere scene's shoulder spheres sit in the table at the
# mount with zero effective mass (tests/test_torch_engine_lift.py): its
# card-vs-CPU comparison moves the table's edge off the mount on both sides
ARM_TABLE_LO = (-0.5, 0.15)
ENGINE_ENTRY = ["task=Ur5SihLift", f"num_envs={ENVS}", "heavy_prep_per_control=false",
                "carry_fk=false", "hand_only_collision=false", "experiment=chip_smoke_engine",
                "seed=1"]


def engine_env_phase(rollout, dev, pool, policy) -> tuple:
    """Phase 28 (see the module docstring). Returns (record, the exact-FK
    run's env and final state)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map

    recs = {}
    for name, over in ENGINE_OPTIONS.items():
        env = rollout.make_task_env(MULTI_TASK, ENVS, dev, pool=pool, **over)
        C = env.scene.slots.num_slots
        state, obs = env.reset(0)
        state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
        torch.cuda.synchronize()
        rollout.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(ENGINE_STEPS):
            state, obs, reward, _ = rollout.forward_step(env, policy, state, obs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = rollout.launch_counts()
        finite_state(tree_map, state, obs)
        per = {k: v / ENGINE_STEPS for k, v in counts.items()}
        rate = ENVS * ENGINE_STEPS / seconds
        log(f"engine-env {name}: {MULTI_TASK} with {over}, {ENVS} envs, C = {C} slots, "
            f"{env.cfg.solver_iterations} sweeps: {ENGINE_STEPS} control steps in {seconds:.3f} s "
            f"= {rate:.0f} env-steps/s; launches per control step {per} (predicted "
            f"{ENGINE_PER_STEP[name]}); mean reward {float(reward.mean()):.4f}; every state "
            f"leaf finite")
        if counts != {k: ENGINE_STEPS * v for k, v in ENGINE_PER_STEP[name].items()}:
            raise AssertionError(f"engine-env {name}: launches {counts}, expected "
                                 f"{ENGINE_STEPS} x {ENGINE_PER_STEP[name]}")
        recs[name] = dict(overrides=over, slots=C, control_steps=ENGINE_STEPS, seconds=seconds,
                          env_steps_per_s=rate, launches=counts,
                          launches_per_control_step=ENGINE_PER_STEP[name])
        if name == "exact FK":
            exact = (env, state)
        del env, state, obs
        torch.cuda.empty_cache()
    return recs, exact


def engine_api_phase(rollout, dev, run, ops) -> tuple:
    """Phase 29 (see the module docstring). Returns (record, the kernels'
    calls of the last substep_contacts sim step)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.physics import engine as te

    env, state = run
    sc = env.scene
    recs, calls = {}, None
    for name, (sub, shared) in (("substep contacts", (True, True)), ("substep", (False, False))):
        s = dataclasses.replace(sc, params=sc.params._replace(substep_contacts=sub))
        ph = state.physics
        with Capture(ops, last_only=True) as cap:
            rollout.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(ENGINE_API_SIM_STEPS):
                cap.armed = i == ENGINE_API_SIM_STEPS - 1
                ph, info = te.step(s, ph, shared_prep=shared)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = rollout.launch_counts()
        finite_state(tree_map, ph, info.max_penetration)
        log(f"engine-api {name}: engine.step(scene, state{'' if shared else ', shared_prep=False'})"
            f" with substep_contacts={sub}, {ENVS} envs, {ENGINE_API_SIM_STEPS} sim steps in "
            f"{seconds:.3f} s; launches {counts} (predicted {ENGINE_API_LAUNCHES[name]}); max "
            f"penetration {float(info.max_penetration.max()):.4f} m; every state leaf finite")
        if counts != ENGINE_API_LAUNCHES[name]:
            raise AssertionError(f"engine-api {name}: launches {counts}, expected "
                                 f"{ENGINE_API_LAUNCHES[name]}")
        recs[name] = dict(sim_steps=ENGINE_API_SIM_STEPS, seconds=seconds, launches=counts)
        if sub:
            calls = cap.calls
            if calls["sweep"][0][1].get("apply_warm", True):
                raise AssertionError("engine-api: the substep solve did not pre-apply its warm "
                                     "start (apply_warm=False)")
    return recs, calls


def engine_kernels_phase(rollout, dev, pool, policy, ops, api_calls, api_maps) -> dict:
    """Phase 30 (see the module docstring)."""
    import torch

    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import prep_deff as deff_op

    # the arm's groups on inputs from the arm-sphere scene with the table's
    # edge off the mount: in the composed one the shoulder's table slots
    # carry impulses ~4e9, and 1e-4 of that scale would pass any error on
    # the other slots
    env = rollout.make_task_env(MULTI_TASK, ENVS, dev, pool=pool, hand_only_collision=False,
                                table_lo=ARM_TABLE_LO)
    state, obs = env.reset(0)
    state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
    with Capture(ops, last_only=True) as cap:
        cap.armed = True
        state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
    torch.cuda.synchronize()
    arm = env.scene.maps
    out = {"contact_sweep": {}, "prep_deff": {}}
    out["contact_sweep"]["apply_warm_false"] = check_sweep(
        sweep_op, api_calls["sweep"][0], api_maps, "engine, apply_warm=False")
    out["contact_sweep"]["arm"] = rec = check_sweep(sweep_op, cap.calls["sweep"][0], arm,
                                                    "engine, arm")
    # an ordinary contact's impulse per substep is well under 1 N s
    if not rec["scale"]["lam"] < 1e3:
        raise AssertionError(f"engine-kernels: the arm scene's impulses reach "
                             f"{rec['scale']['lam']:.3e}: a degenerate contact")
    out["prep_deff"]["arm"] = check_deff(deff_op, cap.calls["deff"][0][0])
    log(f"engine-kernels: arm-sphere slot groups: {arm.groups.link_bits.shape[0]} dof masks "
        f"(at most {sweep_op.MAX_LINKS}), C = {arm.anc_slot.shape[0]} (at most 1024)")
    return out


def engine_ref_phase(rollout, dev, ref_state, ref_obs, pool16) -> dict:
    """Phase 31 (see the module docstring)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.physics import engine as te

    policy_c = rollout.load_policy(rollout.TASK_CKPTS[MULTI_TASK], "cpu")
    out = {}
    with deff_at_any_size():
        for name, over in ENGINE_OPTIONS.items():
            over = dict(over, table_lo=ARM_TABLE_LO) if name == "arm spheres" else over
            env_c = small_multi_env(rollout, "cpu", pool16, **over)
            st = ref_state
            C = env_c.scene.slots.num_slots
            if C != st.physics.contact_impulse.shape[1]:
                st = st._replace(physics=st.physics._replace(
                    contact_impulse=torch.zeros(16, C, 3)))
            out[name] = card_vs_cpu(env_c, small_multi_env(rollout, dev, pool16, **over), st,
                                    ref_obs, policy_c, dev, f"engine-ref {name}",
                                    need=("robot-object",))
        env_c = small_multi_env(rollout, "cpu", pool16)
        env_g = small_multi_env(rollout, dev, pool16)
        sp = env_c.scene.params
        for name, params, shared in (
                ("substep", sp, False),
                ("substep contacts", sp._replace(substep_contacts=True), True),
                ("restitution 0.8", sp._replace(solver=sp.solver._replace(restitution=0.8)), True),
                ("gs", sp._replace(solver=sp.solver._replace(mode="gs")), True)):
            ph_c = ref_state.physics
            t0 = time.perf_counter()
            got, _ = te.step(dataclasses.replace(env_g.scene, params=params),
                             tree_map(lambda x: x.to(dev), ph_c), shared_prep=shared)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            want, _ = te.step(dataclasses.replace(env_c.scene, params=params), ph_c,
                              shared_prep=shared)
            errs = {k: float((g.cpu() - w).abs().max()) for k, g, w in (
                ("q", got.robot.q, want.robot.q), ("pos", got.objects.pos, want.objects.pos),
                ("qd", got.robot.qd, want.robot.qd),
                ("linvel", got.objects.linvel, want.objects.linvel))}
            log(f"engine-ref {name}: one sim step at 16 envs, card ({card_s:.2f} s) vs CPU: "
                f"max|gpu-cpu| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())}")
            # 2e-4 on q and positions (multiobj-ref's), 2e-3 on velocities
            if not (errs["q"] <= 2e-4 and errs["pos"] <= 2e-4 and errs["qd"] <= 2e-3
                    and errs["linvel"] <= 2e-3):
                raise AssertionError(f"engine-ref {name}: the card disagrees with the CPU")
            out[name] = dict(errs, card_seconds=card_s)
    return out


def engine_entry_phase() -> dict:
    """Phase 32 (see the module docstring)."""
    from handarm_tpu_torch.utils.checkpoint import file_contact_slots, load_train_state

    run = os.path.join("runs", "chip_smoke_engine")
    shutil.rmtree(run, ignore_errors=True)
    first = entry_subprocess(ENGINE_ENTRY + ["max_iterations=1"],
                             os.path.join(run, "nn", "ckpt_1.npz"), "engine entry point", 150)
    second_s, stdout = run_module("handarm_tpu_torch.train",
                                  ENGINE_ENTRY + ["max_iterations=2", "resume=auto"],
                                  "engine entry point resumed", 150)
    with open(os.path.join(run, "config.json")) as f:
        env_cfg = json.load(f)["env"]
    slots = [file_contact_slots(os.path.join(run, "nn", f"ckpt_{i}.npz")) for i in (1, 2)]
    ts = load_train_state(os.path.join(run, "nn", "ckpt_2.npz"))
    check_learner(ts, "engine entry point")
    ok = ("resumed from" in stdout and "reset fresh" not in stdout and slots == [190, 190]
          and int(ts.epoch) == 2 and ts.env_state.physics.contact_impulse.shape[0] == ENVS
          and not any(env_cfg[k] for k in ("heavy_prep_per_control", "carry_fk",
                                           "hand_only_collision")))
    if not ok:
        raise AssertionError(f"engine entry point: bad checkpoints or config in {run}")
    log(f"engine entry point: 1 iteration in {first['seconds']:.1f} s, resumed (its env state "
        f"too) for a second in {second_s:.1f} s; both checkpoints hold {slots[0]} contact slots")
    return dict(first, resume_seconds=second_s, slots=slots[0])


def add_engine_records(kernels: list, engine: dict) -> None:
    """Each kernel's record gains its launches on the engine's paths (and
    the engine-kernels checks) under "engine"."""
    for entry in kernels:
        name = entry["name"]
        launches = {k: r["launches"][name] for k, r in engine["env"].items()}
        launches.update({k: r["launches"][name] for k, r in engine["api"].items()})
        entry["engine"] = dict(launches=sum(launches.values()), launches_by_path=launches,
                               **engine["kernels"].get(name, {}))


STRETCH_TASK = "StretchLift"
STRETCH_MULTI = "StretchMultiObjectManipulation"
STRETCH_STEPS = 30  # timed StretchLift serving steps, after one warm-up step
STRETCH_MULTI_STEPS = 20  # random-policy multi-object steps, after one warm-up step
STRETCH_PER_STEP = {"spd_inverse": 1, "contact_sweep": 6, "prep_deff": 0, "sdf_gather": 0}
STRETCH_ENTRY_ITERS = 2  # iterations of the train entry point, resumed from ckpt_4000
STRETCH_EVAL_STEPS = 100  # counted eval steps, after a burn-in of one episode (400)


class RandomPolicy:
    """Uniform actions in [-1, 1] from a seeded CPU generator, one draw per
    call (moved to the observations' device): the same sequence on the
    card and on the CPU."""

    def __init__(self, num_actions: int, seed: int):
        import torch

        self.n, self.gen = num_actions, torch.Generator().manual_seed(seed)

    def act(self, obs):
        import torch

        a = torch.rand((obs.shape[0], self.n), generator=self.gen) * 2.0 - 1.0
        return a.to(obs.device)

    @staticmethod
    def observe(res):
        return res.obs


def stretch_policy(rollout, task: str, num_actions: int, dev):
    """ckpt_4000's policy for StretchLift; a seeded random policy for the
    multi-object task, which has no checkpoint."""
    if task == STRETCH_TASK:
        return rollout.load_policy(rollout.TASK_CKPTS[task], dev)
    return RandomPolicy(num_actions, seed=5)


def stretch_phase(rollout, dev, ops) -> tuple:
    """Phase 33 (see the module docstring). Returns (record, per task: the
    captured kernel calls, the scene's slot maps, the env, its last state
    and observations, and 16 of its envs on the CPU for stretch-ref)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map

    out, kept = {}, {}
    for task, steps in ((STRETCH_TASK, STRETCH_STEPS), (STRETCH_MULTI, STRETCH_MULTI_STEPS)):
        rollout.reset_launch_counts()
        env = rollout.make_task_env(task, ENVS, dev)
        policy = stretch_policy(rollout, task, env.num_actions, dev)
        with Capture(ops, last_only=True) as cap:
            state, obs = env.reset(0)
            state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                cap.armed = i == steps - 1
                state, obs, reward, _ = rollout.forward_step(env, policy, state, obs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = rollout.launch_counts()
        check_launches(counts, STRETCH_PER_STEP, steps + 1, f"stretch {task}")
        finite_state(tree_map, state, obs)
        z = state.physics.objects.pos[..., 2]
        if not bool(((z > -0.1) & (z < 2.0)).all()):
            raise AssertionError(f"stretch {task}: an object left the workspace")
        C, sps = env.scene.slots.num_slots, ENVS * steps / seconds
        B_C = ENVS * C
        log(f"stretch {task}: {ENVS} envs, nv {env.art.nv}, C = {C} contact slots (B*C = "
            f"{B_C}, the deff kernel from 2^21), K = {env.num_objects}, obs {env.num_obs}, "
            f"actions {env.num_actions}, policy "
            f"{os.path.relpath(rollout.TASK_CKPTS[task]) if task in rollout.TASK_CKPTS else 'random'}; "
            f"{steps} control steps in {seconds:.3f} s = {sps:.0f} env-steps/s; launches "
            f"{counts} over {steps + 1} steps; mean reward {float(reward.mean()):.4f}; "
            f"object z in [{float(z.min()):.3f}, {float(z.max()):.3f}]; every state leaf finite")
        out[task] = dict(envs=ENVS, control_steps=steps, seconds=seconds, env_steps_per_s=sps,
                         slots=C, launches=counts, launches_per_step=STRETCH_PER_STEP,
                         mean_reward=float(reward.mean()))
        kept[task] = dict(calls=cap.calls, maps=env.scene.maps, env=env, state=state, obs=obs,
                          ref=pick_contact_envs(env.scene.slots, state, obs, 16,
                                                f"stretch-ref {task}"))
    return out, kept


def stretch_kernels_phase(rollout, dev, ops, kept) -> dict:
    """Phase 34 (see the module docstring): {kernel: record}."""
    import torch

    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import prep_deff as deff_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    lift, multi = kept[STRETCH_TASK], kept[STRETCH_MULTI]
    # the deff kernel, off this path (B * C < 2^21), forced for one more
    # control step of the lift's rollout
    env, policy = lift["env"], stretch_policy(rollout, STRETCH_TASK, 5, dev)
    with deff_at_any_size(), Capture(ops, last_only=True) as cap:
        cap.armed = True
        rollout.forward_step(env, policy, lift["state"], lift["obs"])
    torch.cuda.synchronize()
    out = {
        "spd_inverse": check_spd(spd_op, lift["calls"]["spd"][0][0][0], dev, "stretch"),
        "contact_sweep": check_sweep(sweep_op, lift["calls"]["sweep"][0], lift["maps"],
                                     "stretch"),
        "prep_deff": check_deff(deff_op, cap.calls["deff"][0][0]),
    }
    # the multi-object scene's captured solve alone: its synthetic cases
    # give every slot the active slots' median effective mass, and slots
    # whose own is thousands of times larger (long lever arms on the 0.08
    # kg, 3 cm sphere and the 0.1 kg box) blow the object velocities up to
    # ~2e8 within 2 sweeps; the plain version's own float32 result then
    # lies 3.4e-3 (dense, 8 sweeps) and 3.7e-3 (robot, 2) of scale from its
    # float64 one (256 envs on the CPU): no 1e-4 bound holds. StretchLift's
    # robot case drives the same 3 hand link groups.
    out["contact_sweep"]["multiobj"] = dict(path=STRETCH_MULTI, **check_sweep(
        sweep_op, multi["calls"]["sweep"][0], multi["maps"], "stretch multiobj",
        synthetic=False))
    return out


def stretch_ref_phase(rollout, dev, kept) -> dict:
    """Phase 35 (see the module docstring)."""
    out = {}
    for task in (STRETCH_TASK, STRETCH_MULTI):
        state, obs = kept[task]["ref"]
        env_c = rollout.make_task_env(task, 16, "cpu", solver_prep_dtype="f32")
        env_g = rollout.make_task_env(task, 16, dev, solver_prep_dtype="f32")
        out[task] = card_vs_cpu(env_c, env_g, state, obs,
                                stretch_policy(rollout, task, env_c.num_actions, "cpu"), dev,
                                f"stretch-ref {task}")
    return out


def stretch_train_phase(rollout, dev) -> dict:
    """Phase 36 (see the module docstring)."""
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.utils.checkpoint import file_contact_slots, load_train_state

    ckpt = os.path.relpath(rollout.TASK_CKPTS[STRETCH_TASK])
    step = int(os.path.basename(ckpt)[5:-4]) + STRETCH_ENTRY_ITERS
    run = os.path.join("runs", "chip_smoke_stretch")
    shutil.rmtree(run, ignore_errors=True)
    out_path = os.path.join(run, "nn", f"ckpt_{step}.npz")
    seconds, stdout = run_module(
        "handarm_tpu_torch.train", [f"task={STRETCH_TASK}", f"resume={ckpt}",
                                    f"max_iterations={step}", "experiment=chip_smoke_stretch"],
        "stretch entry point", PHASE_DEADLINE_S["stretch-train"] // 2)
    cfg, _ = resolve_task(STRETCH_TASK)
    ts = load_train_state(out_path, env_cfg=cfg)
    check_learner(ts, "stretch entry point")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f.read().splitlines()]
    ok = ("resumed from" in stdout and "reset fresh" not in stdout
          and file_contact_slots(out_path) == 100 and int(ts.epoch) == step
          and ts.env_state.control.joint_target.shape == (cfg.num_envs, 9)
          and len(rows) == STRETCH_ENTRY_ITERS)
    if not ok:
        raise AssertionError(f"stretch entry point: bad checkpoint or metrics in {run}")
    log(f"stretch entry point: resumed {ckpt} whole at its {cfg.num_envs} envs, "
        f"{STRETCH_ENTRY_ITERS} iterations in {seconds:.1f} s; {out_path} read back (69 "
        f"leaves, 100 slots, epoch {step}); last kl {rows[-1]['kl']:.5f}, reward_mean "
        f"{rows[-1]['reward_mean']:.5f}")
    rec = dict(entry_point=dict(seconds=seconds, envs=cfg.num_envs, iterations=len(rows),
                                kl=rows[-1]["kl"], reward_mean=rows[-1]["reward_mean"]))
    env = rollout.make_task_env(STRETCH_MULTI, ENVS, dev)
    ppo = PPO(env, ppo_config(resolve_task(STRETCH_MULTI)[1]))
    log(f"stretch-train: {STRETCH_MULTI} at {ENVS} envs, {ppo.num_minibatches} minibatches "
        f"of {ppo.mb_size}, from a fresh init")
    rec["multiobj"], _ = timed_iterations(rollout, ppo, ppo.init(0), 1,
                                          {k: 16 * v for k, v in STRETCH_PER_STEP.items()},
                                          "stretch-train")
    return rec


def stretch_phases(rollout, dev, ops) -> tuple:
    """Phases 33-37: (their record, each kernel's Stretch record)."""
    rec = {}
    with phase("stretch"):
        rec["serve"], kept = stretch_phase(rollout, dev, ops)
    with phase("stretch-kernels"):
        kernels = stretch_kernels_phase(rollout, dev, ops, kept)
        for name, k in kernels.items():
            k.update(path=STRETCH_TASK, launches=rec["serve"][STRETCH_TASK]["launches"][name])
        kernels["contact_sweep"]["multiobj"]["launches"] = \
            rec["serve"][STRETCH_MULTI]["launches"]["contact_sweep"]
        kernels["sdf_gather"] = dict(path=STRETCH_TASK, launches=0)  # analytic SDFs only
        del kept[STRETCH_TASK]["calls"], kept[STRETCH_MULTI]["calls"]
    with phase("stretch-ref"):
        rec["ref"] = stretch_ref_phase(rollout, dev, kept)
        del kept
    with phase("stretch-train"):
        rec["train"] = stretch_train_phase(rollout, dev)
    with phase("stretch-eval"):
        rec["eval"] = eval_phase(rollout, dev, STRETCH_TASK, STRETCH_PER_STEP,
                                 min_episodes=1500, steps=STRETCH_EVAL_STEPS, burn_in=400)
    return rec, kernels


CAMERA_OBS = ("topview_depth", "topview_segmentation", "topview_color", "topview_pointcloud",
              "topview_target_object_pointcloud")
CAMERA_STEPS = 30  # timed camera serving steps, after one warm-up step (31 in all)
CAMERA_EDGE = 1e-4  # tests/test_torch_camera.py's pixel rule: px from a pixel edge
CAMERA_RECORDED = (0, 1, 2, 3)  # envs of the 16 whose frames camera-ref records
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "envs"]  # bench.py's emit


def with_camera() -> dict:
    """The config fields that give the composed multi-object task the
    topview camera (`CameraConfig()`) and its five observables after the
    task's own."""
    from handarm_tpu_torch.envs.camera import CameraConfig
    from handarm_tpu_torch.envs.registry import resolve_task

    return dict(cameras=(CameraConfig(),),
                observations=resolve_task(MULTI_TASK)[0].observations + CAMERA_OBS)


def serve_counted(rollout, env, policy, steps: int):
    """Reset, one warm-up and `steps` timed control steps of `policy`, the
    launch counters zeroed before the reset: (state, the last StepResult,
    seconds of the timed steps, launch counts)."""
    import torch

    rollout.reset_launch_counts()
    state, obs = env.reset(0)
    state, res = env.step(state, policy.act(obs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, res = env.step(state, policy.act(res.obs))
    torch.cuda.synchronize()
    return state, res, time.perf_counter() - t0, rollout.launch_counts()


def camera_phase(rollout, dev, pool, policy) -> tuple:
    """Phase 38 (see the module docstring). Returns (record, 16 envs of the
    camera run's last state on the CPU)."""
    import torch

    from handarm_tpu_torch.envs.camera import INT32_MIN
    from handarm_tpu_torch.envs.hand_arm import tree_map

    n = CAMERA_STEPS + 1
    plain = rollout.make_task_env(MULTI_TASK, ENVS, dev, pool=pool)
    state, res, plain_s, counts = serve_counted(rollout, plain, policy, CAMERA_STEPS)
    check_launches(counts, MULTI_PER_STEP, n, "camera (without the camera)")
    plain_obs = plain.num_obs
    del plain, state, res
    env = rollout.make_task_env(MULTI_TASK, ENVS, dev, pool=pool, **with_camera())
    cam = env.cfg.cameras[0]
    torch.cuda.reset_peak_memory_stats()
    state, res, cam_s, counts = serve_counted(rollout, env, policy, CAMERA_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches(counts, MULTI_PER_STEP, n, "camera")
    finite_state(tree_map, state, res.obs)
    od = res.obs_dict
    if sorted(od) != sorted(CAMERA_OBS) or env.num_obs != plain_obs or \
            res.obs.shape != (ENVS, plain_obs):
        raise AssertionError(f"camera: obs_dict {sorted(od)}, {env.num_obs} observations")
    for k, v in od.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"camera: non-finite {k}")
    seg = od["topview_segmentation"].flatten(1)
    seen = {i: float((seg == i).any(1).float().mean()) for i in (1, 3, 4, 5)}
    any_object = float(((seg >= 3) & (seg <= 5)).any(1).float().mean())
    hit = float((od["topview_depth"] < cam.max_depth).float().mean())
    empty = float((seg == INT32_MIN).float().mean())
    rows = {k: float((od[k][..., 3] > 0).sum(1).float().mean()) for k in CAMERA_OBS[3:]}
    rate, plain_rate = ENVS * CAMERA_STEPS / cam_s, ENVS * CAMERA_STEPS / plain_s
    log(f"camera: {MULTI_TASK} at {ENVS} envs with the topview camera ({cam.width} x "
        f"{cam.height}, fovx {cam.fovx_deg}, max_depth {cam.max_depth}), "
        f"{os.path.relpath(rollout.TASK_CKPTS[MULTI_TASK])}: {CAMERA_STEPS} timed steps "
        f"{rate:.0f} env-steps/s with the camera, {plain_rate:.0f} without (same call); "
        f"launches {counts} over {n} steps; peak device memory {peak:.2f} GiB; envs seeing "
        f"ids {seen} (any object {any_object:.4f}); pixels hit {hit:.4f}, empty (int32 min) "
        f"{empty:.4f}; mean valid cloud rows {rows}")
    if not (seen[1] > 0.5 and any_object > 0.5):
        raise AssertionError(f"camera: robot or objects unseen in most envs: {seen}")
    slots = env.scene.slots
    small = pick_contact_envs(slots, state, res.obs, 16, "camera-ref")[0]
    return dict(task=MULTI_TASK, envs=ENVS, steps=CAMERA_STEPS, camera=dataclasses.asdict(cam),
                env_steps_per_s=rate, env_steps_per_s_without=plain_rate,
                peak_memory_gib=peak, launches=counts, ids_seen=seen,
                any_object_seen=any_object, pixels_hit=hit, pixels_empty=empty,
                cloud_rows=rows), small


def pixel_rule(cam, uvz):
    """tests/test_torch_camera.py's pixel rule on the CPU's u, v of every
    point ([B, P, 3]): (points [B, P], pixels [B, H, W]) left out, the
    points within CAMERA_EDGE of a pixel edge, every pixel they may land
    in and every point in those pixels."""
    import torch

    u, v = uvz[..., 0].double(), uvz[..., 1].double()
    near = lambda x: (x - torch.round(x)).abs() <= CAMERA_EDGE
    edge = near(u) | near(v)
    W, H = cam.width, cam.height
    at = lambda uu, vv: (torch.clamp(torch.trunc(vv), 0, H - 1) * W
                         + torch.clamp(torch.trunc(uu), 0, W - 1)).long()
    hits = torch.zeros((u.shape[0], W * H), dtype=torch.long)
    for du in (-CAMERA_EDGE, CAMERA_EDGE):
        for dv in (-CAMERA_EDGE, CAMERA_EDGE):
            hits.scatter_add_(1, at(u + du, v + dv), edge.long())
    pix = hits > 0
    return edge | torch.gather(pix, 1, at(u, v)), pix.reshape(-1, H, W)


def compare_images(cam, uvz, got: dict, want: dict, tag: str) -> dict:
    """Card (`got`) against CPU (`want`) images and, where given, the
    visibility, at the test's tolerances outside the pixel rule: depth 1e-6,
    segmentation, color and visibility exact."""
    import torch

    drop_pts, drop_pix = pixel_rule(cam, uvz)
    keep = ~drop_pix
    g = {k: v.cpu() for k, v in got.items()}
    out = dict(points_left_out=int(drop_pts.sum()), points=drop_pts.numel(),
               pixels_left_out=int(drop_pix.sum()), pixels=drop_pix.numel())
    out["depth_err"] = float((g["depth"] - want["depth"])[keep].abs().max())
    exact = {k: bool(torch.equal(g[k][keep], want[k][keep]))
             for k in ("segmentation", "color") if k in want}
    if "visible" in want:
        exact["visible"] = bool(torch.equal(g["visible"][~drop_pts], want["visible"][~drop_pts]))
    out["exact"] = exact
    log(f"{tag}: {out['points_left_out']} of {out['points']} points and "
        f"{out['pixels_left_out']} of {out['pixels']} pixels left out by the pixel rule; "
        f"max|depth card-cpu| {out['depth_err']:.3e}; equal {exact}")
    if out["depth_err"] > 1e-6 or not all(exact.values()):
        raise AssertionError(f"{tag}: the card's render disagrees with the CPU's")
    return dict(out, _drop_pts=drop_pts, _drop_pix=drop_pix)


def camera_ref_phase(rollout, dev, st_c, pool16) -> dict:
    """Phase 39 (see the module docstring)."""
    import torch

    from handarm_tpu_torch.envs.camera import render_points
    from handarm_tpu_torch.envs.hand_arm import ObsContext, tree_map
    from handarm_tpu_torch.envs import pointcloud as pc
    from handarm_tpu_torch.utils.visualization import CameraRecorder

    import numpy as np

    env_c = small_multi_env(rollout, "cpu", pool16, **with_camera())
    env_g = small_multi_env(rollout, dev, pool16, **with_camera())
    cam = env_c.cfg.cameras[0]
    st_g = tree_map(lambda x: x.to(dev), st_c)
    out = {}
    # render_points on the card's world points, on both sides
    pts_g, segs_g, _ = ObsContext(env_g, st_g).camera_scene_points()
    pts, segs = pts_g.cpu(), segs_g.cpu()
    r_g = render_points(cam, pts_g, segs_g.to(torch.int32), valid=segs_g,
                        colors=env_g.scene_point_rgb)
    r_c = render_points(cam, pts, segs.to(torch.int32), valid=segs, colors=env_c.scene_point_rgb)
    part = lambda r: dict(depth=r.depth, segmentation=r.segmentation, color=r.color,
                          visible=r.visible)
    rec = compare_images(cam, r_c.points_uvz, part(r_g), part(r_c), "camera-ref render_points")
    uvz_err = float((r_g.points_uvz.cpu() - r_c.points_uvz)[..., 2].abs().max())
    out["render_points"] = {k: v for k, v in rec.items() if not k.startswith("_")}
    out["render_points"]["point_depth_err"] = uvz_err
    # the five observables of the same state with the same scores
    own_c = ObsContext(env_c, st_c).camera_scene_points()
    uvz = render_points(cam, own_c[0], own_c[1].to(torch.int32), valid=own_c[1]).points_uvz
    P = pc.padded_points(own_c[0].shape[1], env_c.cfg.pointcloud_max_points)
    scores = torch.rand((16, P), generator=torch.Generator().manual_seed(3))
    od_c = env_c.observe(st_c, {P: scores})[2]
    od_g = env_g.observe(st_g, {P: scores.to(dev)})[2]
    img = lambda od: dict(depth=od["topview_depth"], segmentation=od["topview_segmentation"],
                          color=od["topview_color"])
    rec = compare_images(cam, uvz, img(od_g), img(od_c), "camera-ref observables")
    whole = ~rec["_drop_pts"].any(1)
    cloud_err = {}
    for k in CAMERA_OBS[3:]:
        g, w = od_g[k].cpu()[whole], od_c[k][whole]
        if not torch.equal(g[..., 3], w[..., 3]):
            raise AssertionError(f"camera-ref: {k} rows differ between the card and the CPU")
        cloud_err[k] = float((g[..., :3] - w[..., :3]).abs().max())
    log(f"camera-ref clouds: compared in {int(whole.sum())} of 16 envs (the rest hold a point "
        f"the pixel rule leaves out); max|xyz card-cpu| {cloud_err}")
    if max(cloud_err.values()) > 1e-5 or int(whole.sum()) < 8:
        raise AssertionError("camera-ref: the card's clouds disagree with the CPU's")
    out["observables"] = {k: v for k, v in rec.items() if not k.startswith("_")}
    out["observables"].update(cloud_envs=int(whole.sum()), cloud_xyz_err=cloud_err)
    # CameraRecorder frames of 4 envs: equal outside the pixel rule, but a
    # depth gray level may round apart where the float depths differ
    frames = {}
    for d, env, st in (("cpu", env_c, st_c), ("card", env_g, st_g)):
        recorder = CameraRecorder(env, os.path.join("runs", "chip_smoke_camera", d),
                                  env_ids=CAMERA_RECORDED)
        recorder.add(st)
        frames[d] = {t: torch.as_tensor(np.stack([recorder.frames["topview"][t][i][0]
                                                  for i in CAMERA_RECORDED]))
                     for t in ("depth", "segmentation", "color")}
    idx = list(CAMERA_RECORDED)
    keep = ~rec["_drop_pix"][idx]
    depth_moved = (od_g["topview_depth"].cpu()[idx] != od_c["topview_depth"][idx])
    diff = {t: (frames["card"][t].int() - frames["cpu"][t].int()).abs().amax(-1)
            for t in frames["cpu"]}
    bad = {t: int((diff[t][keep] > 0).sum()) for t in ("segmentation", "color")}
    bad["depth"] = int(((diff["depth"] > 0) & keep & ~depth_moved).sum()
                       + ((diff["depth"] > 1) & keep).sum())
    rounded = int(((diff["depth"] == 1) & keep & depth_moved).sum())
    log(f"camera-ref CameraRecorder: {len(idx)} envs, frames {tuple(frames['cpu']['depth'].shape)}"
        f" uint8; pixels differing outside the rule {bad}; depth gray levels rounded apart "
        f"where the float depths differ: {rounded}")
    if any(bad.values()):
        raise AssertionError("camera-ref: the card's recorder frames disagree with the CPU's")
    out["recorder"] = dict(envs=len(idx), differing=bad, depth_gray_rounded=rounded)
    return out


def camera_distill_phase(rollout, dev) -> dict:
    """Phase 40 (see the module docstring)."""
    import torch

    from handarm_tpu_torch import train
    from handarm_tpu_torch.envs.camera import CameraConfig
    from handarm_tpu_torch.learn.distill import DAgger
    from handarm_tpu_torch.train_distill import (DEFAULT_STUDENT_OBS, distill_config,
                                                 student_setup)

    ckpt = rollout.TASK_CKPTS["Ur5SihLift"]
    obs = DEFAULT_STUDENT_OBS.replace("target_object_synthetic_pointcloud",
                                      "topview_target_object_pointcloud")
    env, teacher, cloud_keys, aux = student_setup("Ur5SihLift", ENVS, ckpt, obs, dev,
                                                  cameras=(CameraConfig(),))
    if cloud_keys != ("topview_target_object_pointcloud",):
        raise AssertionError(f"camera-distill: cloud keys {cloud_keys}")
    dagger = DAgger(env, teacher, distill_config(ENVS, 400, cloud_keys), aux_from_obs=aux)
    cfg = dagger.cfg
    ds = dagger.init(0)
    per_iter = {"spd_inverse": 16, "contact_sweep": 96, "prep_deff": 0, "sdf_gather": 0}
    recs = []
    for i in range(2):  # a warm-up, then the timed iteration
        if i:
            torch.cuda.reset_peak_memory_stats()
        rollout.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta = dagger.beta(ds.iteration)
        collected = dagger.rollout(ds, beta)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ds, stats = dagger.update(ds, beta, *collected)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del collected
        counts = rollout.launch_counts()
        check_launches(counts, per_iter, 1, f"camera-distill iteration {i}")
        recs.append(dict(rollout_s=t1 - t0, update_s=t2 - t1,
                         env_steps_per_s=ENVS * cfg.horizon / (t2 - t0), launches=counts,
                         **train.drain_stats(stats)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, p in ds.params.items():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"camera-distill: non-finite param {name}")
    cloud = ds.last_obs_dict["topview_target_object_pointcloud"]
    with_target = float((cloud[..., 3] == 2).any(1).float().mean())
    warm, timed = recs
    log(f"camera-distill: Ur5SihLift {ENVS} envs, student obs {env.num_obs} + the camera's "
        f"target cloud, teacher {os.path.relpath(ckpt)}; warm-up {warm['rollout_s']:.3f} + "
        f"{warm['update_s']:.3f} s; timed rollout {timed['rollout_s']:.3f} s, update "
        f"{timed['update_s']:.3f} s, {timed['env_steps_per_s']:.0f} env-steps/s; bc_loss "
        f"{timed['bc_loss']:.5f}; launches {timed['launches']}; peak device memory "
        f"{peak:.2f} GiB; envs whose last cloud holds target points {with_target:.4f}")
    if not with_target > 0.5:
        raise AssertionError("camera-distill: the target is unseen in most envs")
    return dict(task="Ur5SihLift", envs=ENVS, cloud=cloud_keys[0], horizon=cfg.horizon,
                warmup=warm, timed=timed, peak_memory_gib=peak, envs_seeing_target=with_target,
                launches_per_iteration=per_iter)


def bench_phase(rollout, dev) -> dict:
    """Phase 41 (see the module docstring)."""
    import torch

    from handarm_tpu_torch import graft_entry
    from handarm_tpu_torch.envs.hand_arm import tree_map

    ckpt = os.path.relpath(rollout.TASK_CKPTS["Ur5SihLift"])
    seconds, stdout = run_module("handarm_tpu_torch.bench",
                                 ["--envs", str(ENVS), "--policy", ckpt], "bench",
                                 PHASE_DEADLINE_S["bench"] - 60)
    lines = [json.loads(x) for x in stdout.strip().splitlines()]
    if [r["envs"] for r in lines] != [1024, ENVS] or any(list(r) != BENCH_KEYS for r in lines) \
            or not all(r["value"] > 0 for r in lines):
        raise AssertionError(f"bench: unexpected lines {lines}")
    rollout.reset_launch_counts()
    t0 = time.perf_counter()
    forward_step, (state, obs) = graft_entry.entry()
    state, obs, reward, done = forward_step(state, obs)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    counts = rollout.launch_counts()
    check_launches(counts, LIFT_PER_STEP, 1, "graft_entry")
    finite_state(tree_map, state, obs)
    if obs.shape != (64, 121) or reward.shape != (64,) or done.shape != (64,):
        raise AssertionError("graft_entry: bad forward step outputs")
    log(f"bench: {lines}; graft_entry.entry() and one forward step on the card in "
        f"{entry_s:.1f} s, launches {counts}")
    return dict(lines=lines, seconds=seconds, policy=ckpt,
                graft_entry=dict(seconds=entry_s, launches=counts, envs=64))


def main() -> int:
    threading.Thread(target=_watchdog, daemon=True).start()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False\n")
        return 2
    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        log(f"card: {smi}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
        import handarm_tpu_torch  # noqa: F401  (fails outside a checkout)

    with phase("build"):
        from handarm_tpu_torch.ops import build

        t0 = time.perf_counter()
        build.library()
        log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds}) "
            f"-> {build.BUILD_ROOT / build.source_digest()}")
        for line in ptxas_summary(build.ptxas_report()):
            log(line)

    from handarm_tpu_torch import rollout
    from handarm_tpu_torch.envs import genesis
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.tasks import make_env
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import prep_deff as deff_op
    from handarm_tpu_torch.ops import sdf_gather as sdf_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    ops = {"sweep": (sweep_op, "contact_sweep"), "spd": (spd_op, "spd_inverse"),
           "sdf": (sdf_op, "sdf_sample"), "deff": (deff_op, "robot_deff")}

    with phase("rollout"):
        env = make_env("Ur5SihLift", device=dev, num_envs=ENVS)
        C = env.scene.slots.num_slots
        log(f"scene: {ENVS} envs, nv {env.art.nv}, contact slots C = {C}, "
            f"objects K = {env.num_objects}, obs {env.num_obs}, actions {env.num_actions}")
        log(f"policy: {os.path.relpath(rollout.TASK_CKPTS['Ur5SihLift'])}")
        policy = rollout.load_policy(rollout.TASK_CKPTS["Ur5SihLift"], dev)
        with Capture(ops) as cap:
            rollout.reset_launch_counts()
            state, obs = env.reset(0)
            state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(STEPS):
                cap.armed = i == STEPS - 2  # late: the hand is in contact
                state, obs, reward, done = rollout.forward_step(env, policy, state, obs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = rollout.launch_counts()
        steps_run = STEPS + 1
        sim = env.cfg.control_freq_inv * env.cfg.substeps
        log(f"rollout: {STEPS} control steps in {seconds:.3f} s = "
            f"{ENVS * STEPS / seconds:.0f} env-steps/s; launches {counts} "
            f"over {steps_run} steps; mean reward {float(reward.mean()):.4f}")
        finite_state(tree_map, state, obs)
        want = {"spd_inverse": steps_run, "contact_sweep": sim * steps_run,
                "prep_deff": 0, "sdf_gather": 0}  # B * C < 2^21, box objects
        if counts != want:
            raise AssertionError(f"lift launches {counts}, expected {want}")
        env_steps_per_s = ENVS * STEPS / seconds
        lift_calls, lift_counts, lift_maps = cap.calls, counts, env.scene.maps
        # the card-vs-CPU state: of the last step and a few more (untimed),
        # the one where the most envs push the box with the hand
        pushing = [int((contact_scores(env.scene.slots, state) >= 2).sum())]
        ref = (state, obs)
        for _ in range(LIFT_EXTRA_STEPS):
            state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
            pushing.append(int((contact_scores(env.scene.slots, state) >= 2).sum()))
            if pushing[-1] > max(pushing[:-1]):
                ref = (state, obs)
        best = max(pushing)
        log(f"cpu-ref: envs of {ENVS} pushing a robot-object slot at control steps "
            f"{steps_run}-{steps_run + LIFT_EXTRA_STEPS}: {pushing}; taking step "
            f"{steps_run + pushing.index(best)}")
        lift_ref = pick_contact_envs(env.scene.slots, *ref, 16, "cpu-ref")
        del env, state, obs, ref

    lift = {}
    with phase("kernels"):
        lift["spd_inverse"] = check_spd(spd_op, lift_calls["spd"][0][0][0], dev, "lift")
        lift["contact_sweep"] = check_sweep(sweep_op, lift_calls["sweep"][0], lift_maps, "lift")
        for name, rec in lift.items():
            rec["launches"] = lift_counts[name]
        del lift_calls

    with phase("cpu-ref"):
        env_c = make_env("Ur5SihLift", device="cpu", num_envs=16)
        policy_c = rollout.load_policy(rollout.TASK_CKPTS["Ur5SihLift"], "cpu")
        card_vs_cpu(env_c, make_env("Ur5SihLift", device=dev, num_envs=16), *lift_ref,
                    policy_c, dev, "cpu-ref", need=("robot-object",))
        del env_c

    with phase("clouds"):
        clouds_rec = clouds_phase(rollout, dev, lift_ref[0])
        del lift_ref

    # the multiobj phase's genesis writes its pool here; the entry points of
    # the same composed task (multiobj-entry, dr-entry) read it
    pool_cache = os.path.join("runs", "chip_smoke_pool")
    shutil.rmtree(pool_cache, ignore_errors=True)
    os.environ["HANDARM_POOL_CACHE"] = pool_cache
    with phase("multiobj"):
        rollout.reset_launch_counts()
        menv = rollout.make_task_env(MULTI_TASK, ENVS, dev)
        pool = menv.initial_pool
        log(f"multiobj: genesis pool written to {menv.pool_cache_path()}")
        MC, K = menv.scene.slots.num_slots, menv.num_objects
        log(f"multiobj scene: {ENVS} envs, objects {menv.object_names}, contact slots "
            f"C = {MC}, obs {menv.num_obs}, {menv.cfg.solver_iterations} solver sweeps "
            f"(composed from configs/); genesis: {pool.sim_steps} sim steps in "
            f"{menv.genesis_seconds:.1f} s ({menv.genesis_seconds / pool.sim_steps * 1e3:.1f} "
            f"ms per sim step)")
        log(f"policy: {os.path.relpath(rollout.TASK_CKPTS[MULTI_TASK])}")
        mpolicy = rollout.load_policy(rollout.TASK_CKPTS[MULTI_TASK], dev)
        with Capture(ops) as cap:
            mstate, mobs = menv.reset(0)
            mstate, mobs, _, _ = rollout.forward_step(menv, mpolicy, mstate, mobs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(MULTI_STEPS):
                cap.armed = i == MULTI_STEPS - 2
                mstate, mobs, mreward, _ = rollout.forward_step(menv, mpolicy, mstate, mobs)
            torch.cuda.synchronize()
            mseconds = time.perf_counter() - t0
            mcounts = rollout.launch_counts()
        g, n = pool.sim_steps, MULTI_STEPS + 1
        gsec = menv.genesis_seconds
        want = {"spd_inverse": g + n, "prep_deff": g + n, "sdf_gather": g + 3 * n,
                "contact_sweep": 2 * g + 6 * n}
        multi_env_steps_per_s = ENVS * MULTI_STEPS / mseconds
        log(f"multiobj rollout: {MULTI_STEPS} control steps in {mseconds:.3f} s = "
            f"{multi_env_steps_per_s:.0f} env-steps/s; launches {mcounts} over genesis + "
            f"{n} steps; mean reward {float(mreward.mean()):.4f}")
        finite_state(tree_map, mstate, mobs)
        if mobs.shape != (ENVS, menv.num_obs) or not bool(torch.isfinite(pool.pos).all()):
            raise AssertionError("bad multiobj observations or pose pool")
        if mcounts != want:
            raise AssertionError(f"multiobj launches {mcounts}, expected {want}")
        log("multiobj: every state leaf finite")
        multi_calls = cap.calls
        multi_maps = menv.scene.maps
        ref_state, ref_obs = pick_contact_envs(menv.scene.slots, mstate, mobs, 16, "multiobj-ref")
        ref_pool = genesis.InitialPool(pool.pos[:, :16].cpu(), pool.quat[:, :16].cpu())
        del menv, mstate, mobs  # the pool is kept for multiobj-train and -eval

    kernels = []
    with phase("multiobj-kernels"):
        recs = {
            "sdf_gather": ("handarm_tpu_torch/csrc/sdf_gather.cu",
                           "handarm_tpu/ops/sdf_gather.py:98",
                           check_sdf(sdf_op, multi_calls["sdf"][0][0])),
            "prep_deff": ("handarm_tpu_torch/csrc/prep_deff.cu",
                          "handarm_tpu/ops/prep_deff.py:123",
                          check_deff(deff_op, multi_calls["deff"][0][0])),
            "contact_sweep": ("handarm_tpu_torch/csrc/contact_sweep.cu",
                              "handarm_tpu/ops/contact_sweep.py:284",
                              check_sweep(sweep_op, multi_calls["sweep"][0], multi_maps,
                                          "multiobj")),
            "spd_inverse": ("handarm_tpu_torch/csrc/spd_inverse.cu",
                            "handarm_tpu/ops/spd_inverse.py:63",
                            check_spd(spd_op, multi_calls["spd"][0][0][0], dev, "multiobj")),
        }
        for name, (src, replaces, rec) in recs.items():
            entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=mcounts[name], path=MULTI_TASK, **rec)
            if name in lift:
                entry["lift"] = dict(path="Ur5SihLift", **lift[name])
            kernels.append(entry)
        del multi_calls

    with phase("multiobj-ref"), deff_at_any_size():
        card_vs_cpu(small_multi_env(rollout, "cpu", ref_pool),
                    small_multi_env(rollout, dev, ref_pool), ref_state, ref_obs,
                    rollout.load_policy(rollout.TASK_CKPTS[MULTI_TASK], "cpu"), dev,
                    "multiobj-ref", need=("robot-object", "object-pair"))

    engine = {}
    with phase("engine-env"):
        engine["env"], exact_run = engine_env_phase(rollout, dev, pool, mpolicy)
    with phase("engine-api"):
        engine["api"], api_calls = engine_api_phase(rollout, dev, exact_run, ops)
    with phase("engine-kernels"):
        engine["kernels"] = engine_kernels_phase(rollout, dev, pool, mpolicy, ops, api_calls,
                                                 exact_run[0].scene.maps)
        del api_calls, exact_run
    with phase("engine-ref"):
        engine["ref"] = engine_ref_phase(rollout, dev, ref_state, ref_obs, ref_pool)
        add_engine_records(kernels, engine)

    with phase("multiobj-train"):
        multi_train_rec = multiobj_train_phase(rollout, dev, pool)
    with phase("multiobj-eval"):
        multi_eval_rec = eval_phase(rollout, dev, MULTI_TASK, MULTI_PER_STEP, pool)
    dr_rec = {}
    with phase("dr-train"):
        dr_rec["train"], dr_env, dr_ts, dr_calls = dr_train_phase(rollout, dev, pool, ops)
    with phase("dr-kernels"):
        dr_rec["kernels"] = dr_kernels_phase(dr_env, dr_ts, dr_calls, dev)
        del dr_calls
        for entry in kernels:
            if entry["name"] in dr_rec["kernels"]:
                entry["dr"] = dict(path=f"{MULTI_TASK} with envs.tasks.DR_SHADOWHAND",
                                   launches=dr_rec["train"]["launches_per_iteration"][
                                       entry["name"]] * (1 + DR_ITERS),
                                   **dr_rec["kernels"][entry["name"]])
    with phase("dr-ref"):
        dr_rec["ref"] = dr_ref_phase(rollout, dev, dr_env, dr_ts, pool)
        del dr_env, dr_ts
    with phase("adr"):
        dr_rec["adr"] = adr_phase(rollout, dev, pool)
    camera_rec = {}
    with phase("camera"):
        camera_rec["serve"], camera_small = camera_phase(rollout, dev, pool, mpolicy)
        del pool
    with phase("camera-ref"):
        camera_rec["ref"] = camera_ref_phase(rollout, dev, camera_small, ref_pool)
        del camera_small
    with phase("train"):
        train_rec = train_phase(rollout, dev)
    with phase("eval"):
        eval_rec = eval_phase(rollout, dev)
    with phase("reach"):
        train_rec["reach"] = reach_phase(rollout, dev)
    with phase("family"):
        family_rec = family_phase(rollout, dev)
        family_rec["entry_point"] = entry_subprocess(
            ["task=Ur5SihThrow", f"env.num_envs={ENVS}", "max_iterations=1",
             "experiment=chip_smoke_throw"],
            os.path.join("runs", "chip_smoke_throw", "nn", "ckpt_1.npz"), "family entry point",
            PHASE_DEADLINE_S["family"] // 2)
    with phase("multiobj-entry"):
        ckpt = os.path.relpath(rollout.TASK_CKPTS[MULTI_TASK])
        step = int(os.path.basename(ckpt)[5:-4]) + 1
        multi_train_rec["entry_point"] = entry_subprocess(
            [f"task={MULTI_TASK}", f"resume={ckpt}", f"max_iterations={step}",
             "experiment=chip_smoke_multiobj", "seed=1"],
            os.path.join("runs", "chip_smoke_multiobj", "nn", f"ckpt_{step}.npz"),
            "multiobj entry point", PHASE_DEADLINE_S["multiobj-entry"] - 30)
    with phase("dr-entry"):
        dr_rec["entry_point"] = dr_entry_phase(rollout)
    with phase("engine-entry"):
        engine["entry_point"] = engine_entry_phase()

    with phase("distill-train"):
        distill_rec = distill_train_phase(rollout, dev)
    with phase("distill-eval"):
        distill_rec["eval"] = eval_phase(rollout, dev, student=STUDENT, min_episodes=ENVS)
    with phase("distill-entry"):
        distill_rec["entry_points"] = distill_entry_phase(rollout)
    distill_rec["clouds"] = clouds_rec
    with phase("camera-distill"):
        camera_rec["distill"] = camera_distill_phase(rollout, dev)

    with phase("rnn-train"):
        rnn_rec, rnn_ppo, rnn_ts = rnn_train_phase(rollout, dev)
    with phase("rnn-serve"):
        rnn_rec["serve"] = rnn_serve_phase(rollout, rnn_ppo, rnn_ts, dev)
        del rnn_ts
    with phase("rnn-entry"):
        rnn_rec["entry_point"] = rnn_entry_phase(rnn_ppo)
        del rnn_ppo

    stretch_rec, stretch_kernels = stretch_phases(rollout, dev, ops)
    for entry in kernels:
        entry["stretch"] = stretch_kernels[entry["name"]]
    with phase("bench"):
        bench_rec = bench_phase(rollout, dev)
    for entry in kernels:
        name = entry["name"]
        entry["camera"] = dict(
            path=f"{MULTI_TASK} with the topview camera", launches=camera_rec["serve"][
                "launches"][name],
            distill_path="Ur5SihLift DAgger on the camera's cloud",
            distill_launches_per_iteration=camera_rec["distill"]["launches_per_iteration"][name],
            graft_entry_launches=bench_rec["graft_entry"]["launches"][name])

    log(json.dumps({"rollout": {"envs": ENVS, "control_steps": STEPS,
                                "env_steps_per_s": env_steps_per_s, "slots": C,
                                "card": smi},
                    "multiobj": {"envs": ENVS, "control_steps": MULTI_STEPS,
                                 "env_steps_per_s": multi_env_steps_per_s, "slots": MC,
                                 "objects": K, "genesis_sim_steps": g,
                                 "genesis_seconds": gsec, "card": smi}}))
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels, "train": train_rec, "eval": eval_rec,
                    "multiobj_train": multi_train_rec, "multiobj_eval": multi_eval_rec,
                    "family": family_rec, "distill": distill_rec, "rnn": rnn_rec,
                    "dr": dr_rec, "engine": engine, "stretch": stretch_rec,
                    "camera": camera_rec, "bench": bench_rec}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # report every fault, exit non-zero, print no result
        traceback.print_exc()
        sys.stdout.flush()
        code = 1
    sys.exit(code)
