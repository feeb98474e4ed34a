#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port (handarm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each with a deadline and one flushed progress line:
  1. device    CUDA must be present; prints the card's name and power limit.
  2. build     compiles the kernels in handarm_tpu_torch/csrc (one nvcc per
               source, all started together, then one link) and prints each
               kernel's registers, spills and shared memory (-Xptxas -v);
               spd_inverse_warp_kernel<27, 27> and <24, 25> (n and the
               shared row stride) and spd_inverse_kernel<12>, <16> and <18>
               must spill nothing.
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
               train_iter, 1 iteration timed as rollout and update (each
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
               for 1 iteration (`train.main` in this process), must write
               its checkpoint (launches 16 and 96).
 10. eval      handarm_tpu_torch.eval_policy for ckpt_5200 on Ur5SihLift at
               8192 envs: every env's clock zeroed at the reset (no burn-in:
               each env's first episode is whole and policy-driven), a
               zero-action step, 200 counted steps (spd_inverse 201
               launches, contact_sweep 1,206): every env ends one whole
               episode in the window; at least 3,000 episodes, every state
               leaf finite.
 11. reach     Ur5SihReach from a flax-default init at its preset size (64
               envs), 4 train iterations; reward_mean per iteration;
               every param and stat finite; spd_inverse 16 and
               contact_sweep 96 launches per iteration.
 12. family    Ur5SihReposition, OrientedReposition, Repose and Throw, each
               composed from configs/ at 8192 envs: 1 timed train
               iteration from a flax-default init, no warm-up (launches exactly
               spd_inverse 16 and contact_sweep 96 per iteration; prep_deff
               and sdf_gather 0, checked from the built scene: B * C < 2^21,
               no mesh object), params and stats finite; then 2 control
               steps of 16 of its envs on the card and on the CPU with
               actions from a numpy seed. Then the user's entry point at
               full width for one iteration, `train.main` in this process
               (`python -m handarm_tpu_torch.train task=Ur5SihThrow
               env.num_envs=8192 max_iterations=1` once started; only
               classic-entry, ddp, pbt and bench start a module in a
               process of its own): its checkpoint and launches 16 / 96.
 13. multiobj-train  Ur5SihMultiObjectManipulation as `train.py` composes
               it (16 sweeps; minibatch 32768 and every switch of its train
               yaml: 4 minibatches x 4 mini-epochs) at 8192 envs, on the
               multiobj phase's genesis pool, from ckpt_2700's learner:
               as phase 9 (1 warm-up, 1 timed, 1 kept iteration held
               against the CPU step by step), launches per iteration
               exactly spd_inverse 16, prep_deff 16, sdf_gather 48,
               contact_sweep 96. (Run before phase 9.)
 14. multiobj-eval  ckpt_2700's deterministic success rate in that composed
               environment on the same pool, as phase 10: at least 3,000
               episodes; launches per step 1, 1, 3, 6. (Run before phase 9.)
 15. multiobj-entry  the user's entry point, `train.main` in this
               process, reading the multiobj phase's genesis pool
               (HANDARM_POOL_CACHE, set for the whole script): `python -m
               handarm_tpu_torch.train task=Ur5SihMultiObjectManipulation
               resume=docs/evidence/multiobj_r5a/ckpt_2700.npz
               max_iterations=2701` must write ckpt_2701.npz, launches 16
               / 96 / 16 / 48 (no genesis: the pool is read).
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
               32768 x 2 mini-epochs): one warm-up iteration, 1 timed as
               rollout and update, then one whose first minibatch step is
               rerun on the CPU from the card's inputs (loss terms and
               gradients of its first 2,048 samples, recomputed on the
               card for them, and the whole optimizer step:
               `distill_step_check`).
               Launches per iteration exactly spd_inverse 16,
               contact_sweep 96, prep_deff 0, sdf_gather 0.
 18. distill-eval  the student docs/evidence/distill_r5a/student.npz
               (`eval_policy --student`, teacher ckpt_5200) at 8192 envs,
               as phase 10: at least 8,192 episodes; launches per step 1
               spd_inverse and 6 contact_sweep.
 19. distill-entry  the user's entry points, each as its main() in this
               process (the command once started): `python -m
               handarm_tpu_torch.train_distill --teacher
               ckpt_5200 --envs 8192 --iters 1` must write student.npz (18
               finite leaves) and metrics; `python -m
               handarm_tpu_torch.eval_policy --student` of that file at
               8192 envs, 5-step episodes, must count 16,384 episodes.
 20. rnn-train  ShadowHandOpenAI_LSTM's learner on Ur5SihLift as `train.py`
               composes it from the `envs.tasks.LSTM_LIFT` overrides
               (an LSTM 1024 actor on 33 observations, an LSTM 1024
               central-value critic on the 121 teacher observations, MLP
               [512], seq_len 4, gamma 0.998; 4 minibatches of 8,192
               sequences x 4 mini-epochs) at 8192 envs from a flax-default
               init: one warm-up, 1 timed iteration (rollout and update
               seconds, train env-steps/s, peak device memory), launches
               exactly 16 / 96 / 0 / 0 per iteration; then a kept
               iteration's first minibatch step from the card's inputs
               (`rnn_step_check`): its first 1,024 sequences' loss terms
               and gradients on the card, on the CPU and in float64,
               within tolerances set from update_precision's float32
               error, and its optimizer step as `compare_steps` holds it.
 21. rnn-serve  1 + 10 deterministic `PPO.act` control steps of that learner
               at 8192 envs, the carry threaded (zeroed where an episode
               ends): serving env-steps/s, launches 1 / 6 per step; then
               16 of its envs (clocks zeroed) 2 control steps on the card
               and on the CPU, each side acting on its own observations
               and carry: actions, carries, q and observations held.
 22. rnn-entry  `python -m handarm_tpu_torch.train task=Ur5SihLift
               num_envs=8192` with the LSTM_LIFT overrides (`train.main`
               in this process) for 1 iteration, launches 16 / 96, then
               `resume=auto` for a second:
               both checkpoints read back with the PPOConfig (teacher
               stats, last teacher observations, carry), epoch 2, Adam
               count 32 less skips, metrics rows 0-1.
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
 27. dr-entry  the user's entry point (`train.main` in this process,
               launches 16 / 96 / 16 / 48), reading the same genesis pool
               (genesis runs without DR and ADR):
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
               hand_only_collision=false max_iterations=1` (`train.main` in
               this process, launches 48 / 96 / 0 / 0: the mass structure
               every sim step) must write ckpt_1.npz (190 contact slots),
               and a second run with `max_iterations=2 resume=auto` must
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
               max_iterations=4002` as its main() in this process at the
               yaml's 1,024
               envs (ckpt_4000's own): the whole TrainState resumed, 2
               iterations, ckpt_4002.npz read back (69 leaves, 100 slots);
               then StretchMultiObjectManipulation at 8192 envs from a
               fresh init: one warm-up and one timed iteration, launches
               16 / 96 / 0 / 0.
 37. stretch-eval  ckpt_4000's deterministic success rate on StretchLift
               at 8192 envs (`eval_policy`), as phase 10: clocks zeroed at
               the reset, 400 counted steps (one 400-step episode: at least
               1,500 episodes); launches per step 1 / 6 / 0 / 0.
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
               (launches 1 / 6 / 0 / 0). (Run last, after phase 44.)
 42. ddp       the parallel layer (handarm_tpu_torch/parallel/) on the one
               card, ranks sharing it through gloo: one 8192-env Ur5SihLift
               rollout of ckpt_5200 captured in process, then 2 spawned
               ranks each run `_update_from_traj` on its 4,096 envs with
               the shared [4, 2, 65536] permutations (64 minibatch steps):
               every replicated leaf bit-identical across the ranks
               (`assert_sharded`), collectives per rank exactly 64 gradient
               all-reduces, 2 for the batch moments, 1 for the means and
               the checksums' gather; rank 0 held against the one-process
               data_shards=2 update of the whole trajectory (`ddp_check`:
               stats, advantages, loss terms, the first step's gradients
               and params within 1e-5 of scale, every optimizer step
               bit-identical to the one-process step of the averaged
               gradients). Then `python -m torch.distributed.run
               --standalone --nproc_per_node=2 -m handarm_tpu_torch.train
               task=Ur5SihLift env.num_envs=8192 max_iterations=1
               dist_backend=gloo experiment=chip_smoke_ddp`: rank 0's
               ckpt_1.npz holds all 8192 envs and one process resumes it
               whole (the file it writes back equals it leaf for leaf);
               global env-steps/s from its metrics. Then
               `graft_entry.dryrun_multichip(2, backend="gloo")` at its
               default shape (256 envs per rank): launches per rank per
               iteration exactly 16 / 96 / 0 / 0. (Run after phase 37.)
 43. pbt       two Ur5SihLift policies at 2,048 envs each on the card in one
               workspace (`pbt.objective=reward_mean`, an exchange every
               iteration's frames, both replace thresholds 0, mutation rate
               1): policy 1 resumes ckpt_5200 and runs first; policy 0
               starts fresh, finds itself worst, prints its restart and
               `os.execv`s itself; its new image resumes ckpt_1.npz (the
               donor's params, read back from both files) under the
               mutated hyperparameters of its config.json; both exit 0;
               `maybe_save_best_policy` archives its final state, and
               refuses a worse one.
 44. actor-learner  2 actor threads x 4,096 Ur5SihLift envs (each its own
               CUDA stream and generator) and the learner on the card, 2
               learner iterations from ckpt_5200's learner: staleness at
               most the queue depth (1), stats finite, launches exactly
               16 / 96 / 0 / 0 per actor rollout; one contact_sweep call of
               an actor env launched on a side stream bit-identical to the
               default stream's.
 45. quad      Quadcopter as `train.py` composes it (the classic task's
               registry defaults < configs/task/Quadcopter.yaml's env <
               configs/train/QuadcopterPPO.yaml: the 256-256-128 learner,
               horizon 16, minibatch 16384) at IsaacGymEnvs' 8192 envs
               (`env.num_envs=8192`): the floating-base craft, nv 14, 4
               contact slots (its rotor arms' spheres vs the ground), no
               objects. One timed train iteration from a fresh init, no
               warm-up (the classic phases all time their first
               iteration; launches exactly 16 / 32 / 0 / 0: one env step
               is one sim step of 2 substeps), 7 deterministic serving
               steps through `PPO.act`, the last 6 timed (1 / 2 / 0 / 0 per
               step); then the
               grounded kernel checks: B craft 4 mm over touching the
               ground, tilted 10-30 degrees, falling (`quadcopter.
               grounded_physics`; every env has an active slot, printed),
               one engine step: its spd_inverse call (n = 14) against the
               plain version, to n cond eps of each matrix
               (`check_spd_craft`: the craft's mass matrices reach cond
               ~2e4), and its last contact_sweep call (K = 0, no object
               side) captured, dense and robot cases against the plain
               version and against the plain version in float64
               (`check_sweep(f64=True)`); two launches bit-identical; both
               timed with their bounds and torch.linalg.inv.
 46. quad-ref  card vs CPU at 16 envs: 2 env steps from a fresh reset with
               the trained learner's actions and the same draws, and 2
               engine steps from a grounded state (impulses in every
               env); q and base position within 2e-4, observations within
               2e-3, each times max(1, the largest value).
 47. ingenuity  Ingenuity as phase 45 at its 4096 envs (nv 8, 8 slots on
               the chassis, Mars gravity): 1 timed iteration, 7 serving
               steps, spd_inverse at n = 8 and the
               sweep at C = 8, and its card-vs-CPU check as phase 46.
 48. classic-entry  `python -m handarm_tpu_torch.train task=Quadcopter
               env.num_envs=8192 max_iterations=1` as `train.main` in this
               process (launches 16 / 32 / 0 / 0 per iteration; the CLI
               path in its own process is pbt's); its ckpt_1.npz (61
               leaves: the QuadState's 14 with the floating base's pose)
               read whole with the task's config and written back leaf for
               leaf; then the Cartpole's entry point at 512 envs for 1
               iteration the same way (32 / 0 / 0 / 0 per iteration; the
               ClassicState's 4 leaves), AnymalTerrain's at 4096 envs (24
               / 48 / 0 / 0; the ATState's 18 leaves) and FrankaCabinet's
               at 4096 envs (16 / 32 / 0 / 16; the CabinetState's 12
               leaves: the drawer on its rail, the walls' scene and the
               persistent joint targets) and AllegroHand's at 16384 envs
               (16 / 32 / 16 / 0; the DexState's 15 leaves, the scalar
               consecutive-success average among them), AllegroHandManualDR's
               at 8192 envs (32 / 64 / 0 / 0; its recurrent learner's file
               read with its PPOConfig: the DextremeState's 25 leaves, the
               inner DexState's with the AdrState and the RNA masks) and
               `task=AllegroKuka env.subtask=throw`'s at 8192 envs (16 / 32
               / 16 / 0; the AKState's 25 leaves), `task=AllegroKukaTwoArms
               env.subtask=regrasping`'s at 8192 (16 / 32 / 16 / 0) and
               FactoryTaskNutBoltScrew's at 512 (64 / 64 / 0 / 32; the
               FactoryState's 16 leaves: the screw's unwrapped yaw and the
               fingertip forces among them).
 49. ant       the Ant as `train.py` composes it (configs/task/Ant.yaml,
               configs/train/AntPPO.yaml: 256-128-64, horizon 16,
               minibatch 32768) at IsaacGymEnvs' 4096 envs, on the in-repo
               stand-in (nv 14, 37 contact slots against the ground, K =
               0): 1 timed train iteration from a fresh init, launches per iteration exactly as the code predicts
               (`per_step_launches` x horizon: 16 / 32 / 0 / 0), 31
               deterministic serving steps through `PPO.act` (1 / 2 / 0 / 0
               per step) with every kernel call kept; on the step with the
               most envs standing on their feet (the feet's vertical force
               over half the weight; at least 1/32 of the envs),
               spd_inverse (n = 14) to n cond eps of
               each matrix (`check_spd_craft`) and the step's last sweep
               call (captured, dense and robot cases, and against float64)
               against their plain versions, timed beside their bounds and
               torch.linalg.inv; then card vs CPU at 16 of those standing
               envs (impulses in every one): 2 env steps with the learner's
               actions and the same draws, q and base position within
               2e-4, observations within 2e-3, each times max(1, scale).
 50. humanoid  the Humanoid as phase 49 (400-200-100, horizon 32: 32 / 64
               / 0 / 0 per iteration; nv 27, 51 slots): spd_inverse at n =
               27 through the warp-per-matrix kernel.
 51. cartpole  the Cartpole as phase 49 at its 512 envs (64-64,
               minibatch 2048; no contacts: 2 / 0 / 0 / 0 per step, the
               dynamics twice a step), spd_inverse at n = 2 on its last
               serving step, and card vs CPU from a fresh reset.
 52. ball-balance  BallBalance as `train.py` composes it (128-64-32,
               horizon 16, minibatch 8192, reward scale 0.1) at IsaacGymEnvs'
               4096 envs, on the in-repo stand-in balance bot (nv 12, 161
               slots: the ball's ground slot, 80 spheres against the
               ground and 80 against the ball, K = 1 with both object
               sides, rolling friction 0.002): 1 timed train iteration
               (16 / 32 / 0 / 0), 31 serving steps (1 / 2
               / 0 / 0 a step) keeping each step's last sweep call and its
               spd_inverse call for the step where the most balls push on
               their trays (robot-ball impulses in the solve; at least
               1/32 of the envs): spd_inverse (n = 12) to n cond eps and
               the sweep (captured, dense and robot cases, against float64)
               against their plain versions, timed beside their bounds and
               torch.linalg.inv; card vs CPU at 16 of those envs (q, the
               base's and the ball's positions within 2e-4, observations
               within 2e-3, each times max(1, scale)).
 53. anymal    Anymal as phase 52 (256-128-64, horizon 24, minibatch
               32768; the ANYmal stand-in, nv 18, 30 slots, K = 0): 24 / 48
               / 0 / 0 per iteration; the kernels on the step where the
               most envs have all four feet pushing on the ground.
 54. anymal-terrain  AnymalTerrain as phase 52 (512-256-128, horizon 24,
               minibatch 16384; the 6 x 10 curriculum field, a 640 x 960
               heightfield on the card): the serving window starts from
               levels spread over the six rows, and every step's levels
               are held to the curriculum rule for the envs that time out
               (the reset's random progress ends some episodes there);
               the kernels on the step where the most envs have a foot
               pushing along a normal that is not vertical. Its patches
               lie 12-52 m from the origin, where the mass matrices reach
               cond 1e7-1e10: spd_inverse is held to n cond eps, the sweep
               and card vs CPU per env to twice the larger of the two
               versions' own spreads under one-ulp input perturbations
               where that passes the fixed bound.
 55. franka-cube-stack  FrankaCubeStack as `train.py` composes it
               (256-128-64, horizon 32, minibatch 16384) at IsaacGymEnvs'
               8192 envs, on the in-repo stand-in Franka (nv 9, fixed base,
               30 fitted spheres; two box cubes, K = 2, 134 slots, rolling
               friction 0.002; the arm torque-driven by operational-space
               control): 1 timed train iteration from a fresh init (64 /
               64 / 0 / 0: spd_inverse twice a step, once for OSC and once
               in the engine's sim step), 7 serving steps
               (2 / 2 / 0 / 0 a step); then a built contact state: a
               scripted OSC approach of the grip site to cubeA's top with
               the gripper open, then closing on it (launches per step as
               predicted), its last step's calls kept, the envs whose hand
               pushes on cubeA counted (at least 1/32); there spd_inverse
               (n = 9, to n cond eps) and the sweep (captured, dense and
               robot cases, against float64) against their plain versions,
               two launches bit-identical, timed beside their bounds and
               torch.linalg.inv; card vs CPU at 16 of those envs, 2 env
               steps with the learner's actions and the same draws: q and
               the cubes' positions within 2e-4, observations within 2e-3,
               each times max(1, scale).
 56. franka-cabinet  FrankaCabinet as phase 55 (256-128-64, horizon 16,
               minibatch 8192) at 4096 envs: the drawer a 32^3 compound-box
               field (K = 1) on a +x rail, four cabinet walls, 190 slots;
               16 / 32 / 0 / 16 per iteration, 1 / 2 / 0 / 1 a step
               (sdf_gather once a sim step: its first classic path); the
               built contact state: the drawer slid out against the
               gripper, a few zero-action steps, the envs whose hand or
               fingers push on the drawer counted; sdf_gather (every
               channel, the queries inside the drawer's grid printed) with
               spd_inverse and the sweep against their plain versions (the
               sweep's dense case over 2 sweeps: over 8 the drawer's 130
               slots make an unstable Jacobi iteration that grows float32
               rounding 300-fold, past any fixed bound), timed beside
               their bounds and grid_sample; card vs CPU as
               phase 55 (the drawer's position).
 57. trifinger  Trifinger as `train.py` composes it (256-256-128-128,
               horizon 8, minibatch 16384) at IsaacGymEnvs' 16384 envs, on
               the in-repo stand-in TriFingerPro (nv 9, 21 fitted spheres;
               the box cube, K = 1, four arena walls, 91 slots; torque
               control through tau_ext): 1 timed train iteration from a
               fresh init (8 / 16 / 0 / 0), 7 serving
               steps, the last 6 timed (1 / 2 / 0 / 0 a step); then a
               built contact state: the scripted grasp
               (`TrifingerEnv.grasp_actions`, 10 steps toward the cube's
               faces, 10 closing on them; launches per step as predicted),
               its last step's calls kept, the envs whose fingers push on
               the cube counted (at least 1/32); there spd_inverse (n = 9,
               to n cond eps) and the sweep (captured, dense and robot
               cases, against float64) against their plain versions, two
               launches bit-identical, timed beside their bounds and
               torch.linalg.inv; card vs CPU at 16 of those envs, 2 env
               steps with the learner's actions and the same draws: q and
               the cube's position within 2e-4, observations within 2e-3,
               each times max(1, scale).
 58. allegro-hand  AllegroHand as phase 57 (512-256-128, horizon 8,
               minibatch 32768) at 16384 envs on the stand-in Allegro
               hand (nv 16, 68 spheres, 150 slots, 2 sim steps a control
               step: 16 / 32 / 16 / 0 an iteration, 2 / 4 / 2 / 0 a step;
               B x C = 2.46M >= 2^21, so prep_deff runs): the contact
               state is the cube resting on the fingers (a reset without
               joint, position or rotation noise, 15 steps holding the
               default joints; the envs whose cube stayed within 2 cm and
               whose episode went on counted, at least half), where
               spd_inverse (n = 16, `spd_inverse_kernel<16>`), the sweep
               and prep_deff are held against their plain versions.
 59. shadow-hand  ShadowHand as phase 58 (512-512-256-128) on the stand-in
               Shadow hand from MJCF (nv 24, 73 spheres from its geoms,
               160 slots; 8 / 16 / 8 / 0 an iteration): spd_inverse at n =
               24 (`spd_inverse_warp_kernel<24, 25>`, a warp per matrix,
               rows 25 words apart in shared memory), the sweep and
               prep_deff on the cube resting on the palm; then one train
               iteration from a fresh init each of ShadowHandOpenAI_FF
               (16384 envs, 400-400-200-100 with the asymmetric critic on
               the 211-dim state; 16 / 32 / 16 / 0) and
               ShadowHandOpenAI_LSTM (8192 envs, LSTM 1024 actor and
               critic, seq_len 4; 16 / 32 / 0 / 0: B x C = 1.31M).
 60. dextreme  AllegroHandDextremeADR as `train.py` composes it (LSTM 512
               before a 512-512 MLP, seq_len 16, its carry kept across
               episode ends; horizon 16, minibatch 16384) at IsaacGymEnvs'
               8192 envs: the AllegroHand stand-in under ADR (observation
               noise, action noise and the random network adversary's
               weight) and the adversary; 1 timed train iteration from a
               fresh init (32 / 64 / 0 / 0: B x C = 1.23M keeps prep_deff's
               gate shut), 7 serving steps with the carry threaded (2 / 4
               / 0 / 0 a step); ADR's ranges within their limits, every
               env's values within them, the weight in [0, 0.4], every
               state leaf finite; then card vs CPU at 16 envs from a fresh
               reset with the ranges opened to hi = (0.05, 0.05, 0.2), 2
               control steps with the learner's actions and the same draws
               (the hand's, ADR's, the masks' uniforms, both noises): the
               adversary's logits within 1e-4 of their scale and its bins
               equal away from near-ties (counted), q and the cube within
               2e-4, observations within 2e-3, each times max(1, scale),
               done flags, ADR's modes and the masks exactly. The n = 16
               kernels stay held by phase 58.
 61. allegro-kuka  AllegroKukaReorientation as `train.py` composes it
               (768-512-256, horizon 16, minibatch 32768) at IsaacGymEnvs'
               8192 envs on the in-repo KUKA iiwa 7 + Allegro stand-in (nv
               23, 52 spheres, three box slots, K = 3, 298 slots): 1 timed
               train iteration (16 / 32 / 16 / 0: B x C = 2.44M opens
               prep_deff's gate), 7 serving steps (1 / 2 / 1 / 0 a step);
               then a built contact state: each env's active object set
               resting on the back of the fingers at the reset's noisy
               pose, KUKA_SETTLE_STEPS steps holding the joints, the last
               step's calls kept, the envs whose robot pushes on its
               object counted (at least 1/32); there spd_inverse (n = 23,
               `spd_inverse_warp_kernel<23, 23>`: to n cond eps, or where
               that fails to twice the plain version's float64 distance,
               the record saying which), the sweep (captured, dense and
               robot cases, against float64) and prep_deff against their
               plain versions, timed beside their bounds and library
               calls; card vs CPU at 16 of those envs as phase 57; then
               one train iteration each of AllegroKukaRegrasping and
               AllegroKukaThrow at 8192 envs (16 / 32 / 16 / 0).
 62. allegro-kuka-two-arms  AllegroKukaTwoArmsReorientation as `train.py`
               composes it (768-512-256, horizon 16, minibatch 32768) at
               IsaacGymEnvs' 8192 envs on two KUKA iiwa 7 + Allegro
               stand-ins facing each other (nv 46, 104 spheres, three 0.5
               kg boxes, 506 slots, 46 dof masks, arm 1's at bits 23-45):
               1 timed train iteration (16 / 32 / 16 / 0: B x C = 4.15M),
               7 serving steps (1 / 2 / 1 / 0 a step); then a built contact
               state: each env's active box resting on one hand's fingers
               (even envs arm 0's, odd envs arm 1's), KUKA_SETTLE_STEPS
               steps holding the joints, the last step's calls kept, the
               envs whose robot pushes on its object counted for each arm
               (at least 1/32 each); there spd_inverse at n = 46
               (`spd_inverse_block_kernel<46, 47>`, a block of two warps per
               matrix: to n cond eps), and on a dense SPD batch at n = 46 (its
               off-block entries: to 1e-4), the sweep at nv 46 / L 46 / C
               506 (captured, dense and robot cases, against float64) and
               prep_deff at nv 46 against their plain versions, timed
               beside their bounds and library calls; card vs CPU at 16 of
               those envs as phase 57; then one train iteration of
               AllegroKukaTwoArmsRegrasping at 8192 envs (16 / 32 / 16 / 0).
 63. factory   FactoryTaskNutBoltPick as `train.py` composes it
               (256-128-64, horizon 32, minibatch 8192) at the task yaml's
               512 envs on the in-repo stand-in Franka with the reference's
               M16 nut and bolt (the tracked records at R = 40, 96 surface
               points; C = 298, K = 2, 16 sweeps): 1 timed train iteration
               (64 / 64 / 0 / 32: OSC's and the engine's spd_inverse, the
               sweep a substep, sdf_gather a contact generation; B x C =
               152,576 keeps prep_deff's gate shut), 7 serving steps (2 /
               2 / 0 / 1 a step); then FactoryTaskNutBoltPlace, the nut in
               the closed gripper, FACTORY_GRASP_STEPS steps with the arm
               still and the gripper closed, the last step's calls kept and
               the envs whose fingers push on the nut counted (at least
               1/32); there spd_inverse (n = 9, to n cond eps), the sweep
               (captured, dense over UNSTABLE_DENSE_SWEEPS sweeps and robot
               cases, against float64: lam per slot kind and obj per
               object too, each at its own scale), sdf_gather at R = 40 (every
               channel; the queries inside the grids printed) and
               prep_deff (forced for one more step) against their plain
               versions, bit-identical over two launches, timed beside
               their bounds and library calls; card vs CPU at 16 of those
               envs (2 steps, the same seeded actions and draws); then
               FactoryTaskNutBoltScrew, the nut started SCREW_START_TURNS
               down the thread and spun at SCREW_SPIN rad/s for SCREW_STEPS
               steps: its height the thread pitch's within 1e-3 m, on the
               bolt's axis, its nut-bolt slots active in at least 1/32 of
               the envs, the sweep held on that solve; then FactoryTaskGears
               (K = 3, C = 456, no warm start: the sweep with
               apply_warm=False at 16 sweeps, and sdf_gather over three
               fields) after GEARS_STEPS steps; then one train iteration
               each of FactoryTaskNutBoltPlace, FactoryTaskGears and
               FactoryTaskInsertion at 512 envs (64 / 64 / 0 / 32).
 64. industreal  IndustRealTaskPegsInsert as `train.py` composes it (the
               same MLP with an asymmetric critic on the 47-dim state) at
               512 envs: 1 timed train iteration (64 / 64 / 0 / 32), 7
               serving steps; then the welded plug in the squeezing
               gripper, IR_SQUEEZE_STEPS steps from a reset (the envs whose
               fingers push on the plug counted: at least 1/32), where
               spd_inverse, the 8-sweep sweep with the socket pinned by its
               zero-travel rail and sdf_gather are held as in phase 63;
               `sdf_reward`, `sapu_scale` and the interpenetration of every
               env's plug card vs CPU; card vs CPU at 16 envs; and one
               forced SBC update (every episode ending inserted, the EWMA at
               0.9, the counter at its interval: the bound 0.01 -> 0.005 m)
               card vs CPU.
               (Phases 45-47 and 49-64 run after phase 37, then 48, before
               phase 42.)
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
"kernels"), the benchmark entry's under "bench", the parallel layer's
under "parallel" (and each kernel's launches there under its "parallel"
key in "kernels"), the classic tasks' under "classic" (and each kernel's
launches and checks on the craft, the Ant, the Humanoid, the Cartpole,
BallBalance, Anymal, AnymalTerrain, FrankaCubeStack, FrankaCabinet,
Trifinger, AllegroHand, ShadowHand, DeXtreme, AllegroKuka, the two-arm
AllegroKuka, the Factory tasks and IndustReal under its "classic" key in
"kernels"; spd_inverse's compiled sizes, their layouts and the checks
that held each under its "instances" key);
the last line
is {"ok": true, "device": {...}}. Any fault prints a traceback and exits
non-zero; without CUDA it exits 2 before any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
                    "camera-ref": 180, "camera-distill": 240, "bench": 240, "ddp": 330,
                    "pbt": 240, "actor-learner": 180, "quad": 240, "quad-ref": 120,
                    "ingenuity": 240, "ant": 240, "humanoid": 300, "cartpole": 180,
                    "ball-balance": 240, "anymal": 240, "anymal-terrain": 300,
                    "franka-cube-stack": 240, "franka-cabinet": 240, "trifinger": 240,
                    "allegro-hand": 240, "shadow-hand": 300, "dextreme": 240,
                    "allegro-kuka": 300, "allegro-kuka-two-arms": 300, "factory": 240,
                    "industreal": 180, "classic-entry": 300}
ENVS = 8192
STEPS = 30  # timed lift control steps, after one warm-up step
LIFT_EXTRA_STEPS = 20  # untimed lift steps searched for robot-object contact
MULTI_TASK = "Ur5SihMultiObjectManipulation"
MULTI_STEPS = 20  # multi-object control steps after genesis and reset
TRAIN_ITERS = 1  # timed lift and multi-object train iterations, after one warm-up
ENTRY_ITERS = 1  # iterations of the train entry point, resumed from ckpt_5200
EVAL_STEPS = 200  # counted eval steps: one episode (200) from clocks zeroed at the reset
REACH_ITERS = 4
FAMILY = ("Ur5SihReposition", "Ur5SihOrientedReposition", "Ur5SihRepose", "Ur5SihThrow")
FAMILY_ITERS = 1  # timed family train iterations from a fresh init (no warm-up)
PREFIX_STEPS = 4  # chained minibatch steps of the kept update rerun on the CPU
DISTILL_ITERS = 1  # timed DAgger iterations, after one warm-up iteration
DISTILL_CHECK_SAMPLES = 2048  # of the first minibatch, its gradients rerun on the CPU
DISTILL_ENTRY_ITERS = 1  # iterations of the train_distill entry point
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


def check_spd(spd_op, M, dev, tag, compare: bool = True):
    """The kernel against its plain version (with `compare`; the craft's
    bound is `check_spd_craft`'s), then timed beside its bound and
    torch.linalg.inv."""
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
    if compare and (not err <= 1e-4 * scale or not ident <= 5e-3):
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
        n=n, batch=B,
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


def check_sweep(sweep_op, captured, maps, tag, synthetic: bool = True, f64: bool = False,
                spread: bool = False, dense_sweeps: int | None = None, slots=None):
    """The captured solve, then (with `synthetic`) every slot made active
    (over `dense_sweeps` sweeps, by default the captured solve's) and only
    the robot's slots active, each against the plain version.
    With `f64` (the craft's ill-conditioned Minv: entries ~1e5, whose
    products with small impulses cancel) the bound is relative to the
    plain version in float64 on the same inputs: the kernel's error from
    it at most the larger of 1e-4 of scale and twice the float32 plain
    version's own. With `spread` (AnymalTerrain: mass matrices of cond
    1e7-1e10 far from the origin, where float32 resolves neither version
    to 1e-4 of scale) the bound is per env instead: the kernel's distance
    from the plain version at most the larger of 1e-4 of the output's
    scale and twice the larger of the two versions' own spreads, the most
    each one's output moves when every float input is scaled by 1 +
    U(-1e-7, 1e-7) (6 draws: `own_spread`); the distances from float64 are
    printed. With `slots` (the scene's slot table; with `f64`) lam is
    held the same way per slot kind (`slot_kinds` and the object-static
    rest) and obj per object, each against its own float64 scale: one
    kind's impulses (IndustReal's first arm link on the table, inv_d at
    its 1e8 clamp: 4.6e8) then hide no other's."""
    import torch

    from handarm_tpu_torch.physics.solver import mass_split

    args, kw = captured
    (planes, bias, screws, qd, minv2, obj, lam0, anc, groups, obj_idx,
     signs, iters, omega) = args
    warm = kw.get("apply_warm", True)
    parts = []  # (name, the part of a (qd, obj, lam) output) held on its own
    if slots is not None:
        kinds = slot_kinds(slots)
        kinds["object-static"] = ~(kinds["robot-static"] | kinds["robot-object"]
                                   | kinds["object-pair"])
        parts = [(f"lam {k}", lambda o, m=m.to(planes.device): o[2][..., m])
                 for k, m in kinds.items() if bool(m.any())]
        parts += [(f"obj {k}", lambda o, k=k: o[1][:, :, k]) for k in range(obj.shape[2])]

    f64_errs = {}  # case -> output -> the kernel's and the plain version's error from f64

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
            if w.numel() == 0:  # no objects (K = 0): obj is [6, B, 0] on both sides
                if g.shape != w.shape:
                    raise AssertionError(f"contact_sweep kernel returned {name} of "
                                         f"{tuple(g.shape)} ({tag}, {case})")
                continue
            e, sc = max_err(g, w)
            errs[name], scales[name] = e, sc
            log(f"contact_sweep ({tag}, {case}): {name} max|kernel-plain| {e:.3e} (scale {sc:.3e})")
            # 8 (lift) or 16 (multi-object) Jacobi sweeps in float32 with
            # the slot sums taken in another order: 1e-4 of this output's
            # own largest value
            if not (f64 or spread) and not e <= 1e-4 * sc:
                raise AssertionError(f"contact_sweep kernel disagrees on {name} ({tag}, {case})")
        if spread:  # each version's own spread, from its own output
            sp = [torch.maximum(a, b) for a, b in zip(
                own_spread(sweep_op.contact_sweep_plain, plain_args, want),
                own_spread(sweep_op.contact_sweep_cuda, cuda_args, got))]
            for name, g, w, s_env in zip(("qd", "obj", "lam"), got, want, sp):
                if w.numel() == 0:
                    continue
                axis = 0 if name == "qd" else 1  # the env axis
                err = (g - w).abs().movedim(axis, 0).reshape(w.shape[axis], -1).amax(1)
                bound = torch.clamp(2.0 * s_env, min=1e-4 * scales[name])
                log(f"contact_sweep ({tag}, {case}): {name} per env: largest |kernel-plain| over "
                    f"the bound {float((err / bound).max()):.3e}; envs whose spread passes 1e-4 "
                    f"of scale {int((2.0 * s_env > 1e-4 * scales[name]).sum())} of "
                    f"{len(err)}, largest spread {float(s_env.max()):.3e}")
                if not bool((err <= bound).all()):
                    raise AssertionError(f"contact_sweep kernel disagrees on {name} ({tag}, "
                                         f"{case})")
        if f64:
            d = lambda t: t.double() if t.is_floating_point() else t
            want64 = sweep_op.contact_sweep_plain(*(d(a) if isinstance(a, torch.Tensor) else a
                                                    for a in plain_args))
            for name, g, w, w64 in zip(("qd", "obj", "lam"), got, want, want64):
                if w.numel() == 0:
                    continue
                ek, _ = max_err(g.double(), w64)
                ep, sc = max_err(w.double(), w64)
                f64_errs.setdefault(case, {})[name] = dict(kernel=ek, plain=ep, scale=sc)
                log(f"contact_sweep ({tag}, {case}): {name} max|kernel-f64| {ek:.3e}, "
                    f"max|plain-f64| {ep:.3e} (scale {sc:.3e})")
                if not spread and not ek <= max(1e-4 * sc, 2.0 * ep):
                    raise AssertionError(f"contact_sweep kernel disagrees on {name} ({tag}, "
                                         f"{case})")
            for name, part in parts:
                ek, _ = max_err(part(got).double(), part(want64))
                ep, sc = max_err(part(want).double(), part(want64))
                f64_errs[case][name] = dict(kernel=ek, plain=ep, scale=sc)
                log(f"contact_sweep ({tag}, {case}): {name} max|kernel-f64| {ek:.3e}, "
                    f"max|plain-f64| {ep:.3e} (scale {sc:.3e})")
                if not ek <= max(1e-4 * sc, 2.0 * ep):
                    raise AssertionError(f"contact_sweep kernel disagrees on {name} ({tag}, "
                                         f"{case})")
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
        dgot, derrs, _, _, _ = compare(dense, dense_bias, "dense",
                                       iters if dense_sweeps is None else dense_sweeps)
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
        f64=f64_errs or None,
        dense=dense_rec, robot=robot_rec,
        **kernel_times(lambda: sweep_op.contact_sweep_cuda(*cuda_args), 50),
        plain_ms=cuda_time_ms(lambda: sweep_op.contact_sweep_plain(*plain_args), 10),
        bound_ms=t_b, bound_by=by, library_ms=None,
    )


def own_spread(sweep, args, want, n: int = 6, rel: float = 1e-7) -> list:
    """Per output of a sweep version (`sweep`: the kernel's or the plain
    entry point, on its `args`; qd, obj, lam) and per env, the most it
    moves from `want` over `n` runs whose float inputs (planes, bias,
    screws, qd, Minv, objects, warm impulses) are each scaled by 1 +
    U(-rel, rel)."""
    import torch

    g = torch.Generator(device=want[0].device).manual_seed(0)

    def jitter(x):
        return x * (1 + (torch.rand(x.shape, generator=g, device=x.device) * 2 - 1) * rel)

    out = [torch.zeros(w.shape[0 if i == 0 else 1], device=w.device) for i, w in enumerate(want)]
    for _ in range(n):
        jargs = [jitter(a) if i < 7 else a for i, a in enumerate(args)]
        for i, (o, w) in enumerate(zip(sweep(*jargs), want)):
            if w.numel():
                d = (o - w).abs().movedim(0 if i == 0 else 1, 0)
                out[i] = torch.maximum(out[i], d.reshape(d.shape[0], -1).amax(1))
    return out


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
        f"{Lq} mesh queries per row (N = {N}), K={K} R={R}; {N - off} queries inside the "
        f"grid, {off} off it; "
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
        max_abs_err=max(errs), queries=N, off_grid=off, inside_grid=N - off,
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
MULTI_PER_ITER = {k: 16 * v for k, v in MULTI_PER_STEP.items()}


def eval_phase(rollout, dev, task="Ur5SihLift", per_step=LIFT_PER_STEP, pool=None,
               student=None, min_episodes=3000, steps=EVAL_STEPS, burn_in=0) -> dict:
    """Phases 10, 14, 18 and 37 (see the module docstring): a burn-in of
    `burn_in` steps (the task's episode length), then `steps` counted; with
    none, every env's clock zeroed at the reset and its first whole
    episode counted (`evaluate(..., burn_in=False)`)."""
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.eval_policy import evaluate

    rollout.reset_launch_counts()
    t0 = time.perf_counter()
    out, state = evaluate(task=task, envs=ENVS, steps=steps, device=dev, pool=pool,
                          student=student,
                          teacher=rollout.TASK_CKPTS["Ur5SihLift"] if student else None,
                          burn_in=burn_in > 0)
    seconds = time.perf_counter() - t0
    counts = rollout.launch_counts()
    check_launches(counts, per_step, 1 + burn_in + steps, f"eval {task}")
    finite_state(tree_map, state, state.physics.robot.q)
    n, p = out["episodes"], out["success_rate"]
    se = (p * (1 - p) / max(n, 1)) ** 0.5
    start = f"burn-in {burn_in} +" if burn_in else "clocks zeroed at the reset,"
    log(f"eval: {out['policy']} on {task}, {ENVS} envs, {start} {steps} steps "
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
        iters = []  # timed from the fresh init: no warm-up iteration
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
            f"{ppo.mb_size}; iterations from a fresh init "
            f"{[(round(r['seconds'], 3), round(r['reward_mean'], 4)) for r in iters]}; "
            f"launches per iteration {per_iter}")
        ref_state, ref_obs = pick_contact_envs(env.scene.slots, ts.env_state, ts.last_obs, 16,
                                               f"family {task}")
        actions = SeededActions(env.num_actions, seed=0)
        del ts, ppo, env
        small = dataclasses.replace(env_cfg, num_envs=16)
        card_vs_cpu(HandArmEnv(small, "cpu"), HandArmEnv(small, dev), ref_state, ref_obs,
                    actions, dev, f"family {task} card-vs-cpu")
        out[task] = dict(envs=ENVS, slots=C, obs=int(ref_obs.shape[1]), iterations=iters,
                         launches_per_iteration=per_iter)
    return out


def run_module(module: str, args: list[str], tag: str, timeout: int, tail: int = 12):
    """`python -m MODULE ARGS` as a user runs it, in its own process group
    (the last `tail` lines of its output indented here); it must exit 0
    within `timeout` s, else the whole group (a launcher's ranks too) is
    killed. Returns (seconds, its standard output)."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=path))
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    seconds = time.perf_counter() - t0
    for line in (out + err).splitlines()[-tail:]:
        log(f"  | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: {module} exited {proc.returncode}")
    log(f"{tag}: `python -m {module} {' '.join(args)}` in {seconds:.1f} s (process start, "
        "kernel load, env build and reset included)")
    return seconds, out


def run_main(module: str, args: list[str], tag: str, tail: int = 12):
    """`python -m MODULE ARGS` as its `main(ARGS)` in this process: the
    user's command once started (no process start, no second CUDA context,
    the kernel library already loaded), its standard output captured and
    its last `tail` lines indented here. Returns (seconds, its standard
    output), as `run_module`."""
    import importlib
    import io

    mod = importlib.import_module(module)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(list(args))
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines()[-tail:]:
        log(f"  | {line}")
    log(f"{tag}: `python -m {module} {' '.join(args)}` as its main() in this process in "
        f"{seconds:.1f} s (env build and reset included)")
    return seconds, out


def entry_in_process(rollout, args: list[str], out: str, tag: str, dev, per_iter: dict,
                     iters: int, n_leaves: int | None = 71) -> dict:
    """`handarm_tpu_torch.train.main(ARGS)` in this process, as a user's
    `python -m handarm_tpu_torch.train ARGS` runs it once started (the
    script starts a module in a process of its own in classic-entry, ddp,
    pbt and bench), its standard output captured and its last
    lines indented here. It must write the checkpoint `out` (with
    `n_leaves` finite leaves; None: any count) and launch exactly
    `per_iter` per iteration for its `iters` iterations. Returns its
    seconds, its last iteration's kl, KL-guard flag and reward_mean, and
    its standard output."""
    import io

    import numpy as np

    from handarm_tpu_torch import train
    from handarm_tpu_torch.utils.checkpoint import read_leaves, wait_for_pending_saves

    rollout.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(args + [f"device={dev}"])
    wait_for_pending_saves()
    seconds = time.perf_counter() - t0
    stdout = buf.getvalue()
    for line in stdout.splitlines()[-4:]:
        log(f"  | {line}")
    check_launches(rollout.launch_counts(), per_iter, iters, tag)
    leaves = read_leaves(out)
    if (n_leaves is not None and len(leaves) != n_leaves) or not all(
            np.isfinite(x).all() for x in leaves if np.issubdtype(x.dtype, np.floating)):
        raise AssertionError(f"{tag}: bad checkpoint {out}")
    with open(os.path.join(os.path.dirname(os.path.dirname(out)), "metrics.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    log(f"{tag}: train.main({' '.join(args)}) in {seconds:.1f} s (env build and reset "
        f"included); wrote {out}; launches {per_iter} per iteration; its last iteration: kl "
        f"{last['kl']:.5f}, kl_guard {last['kl_guard_triggered']:.0f}, reward_mean "
        f"{last['reward_mean']:.5f}")
    return dict(seconds=seconds, kl=last["kl"], kl_guard=last["kl_guard_triggered"],
                reward_mean=last["reward_mean"], in_process=True, stdout=stdout)


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
    half = REACH_ITERS // 2
    first, last = sum(rewards[:half]) / half, sum(rewards[-half:]) / half
    log(f"reach: Ur5SihReach {env.cfg.num_envs} envs, {REACH_ITERS} iterations in "
        f"{seconds:.1f} s; reward_mean per iteration {[round(r, 5) for r in rewards]}; mean "
        f"of the first {half} {first:.5f}, of the last {half} {last:.5f}")
    return dict(task="Ur5SihReach", envs=env.cfg.num_envs, iterations=REACH_ITERS,
                seconds=seconds, reward_mean=rewards, first_half=first, last_half=last)


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


def _head(x, n: int, rows: int):
    """The first `n` rows of every tensor of `rows` rows in nested dicts."""
    if isinstance(x, dict):
        return {k: _head(v, n, rows) for k, v in x.items()}
    return x[:n] if hasattr(x, "shape") and x.ndim and x.shape[0] == rows else x


def distill_step_check(dagger, rec) -> dict:
    """The card's first minibatch step of a DAgger update, rerun on the CPU
    from the card's inputs, and in float64 there to size float32's own error
    (as update_precision sizes the PPO update's). The loss terms and the
    gradients on the minibatch's first DISTILL_CHECK_SAMPLES samples
    (the card's recomputed for them; a float64 CPU pass over all 32768
    took most of the phase):
    - bc_loss and aux_loss within 1e-4 relative (float32 means of 2048 x 11
      and x 18 squared errors in another order);
    - the gradients of each tensor within 1e-4 of its largest value, as the
      PPO step's first gradients (compare_steps); the float64 errors of both
      sides are printed beside them;
    - the optimizer step from the card's params, Adam state and gradients:
      params within 2 float32 ulps of each tensor's largest value, Adam's
      moments within 1e-5 of theirs, the counters equal (compare_steps)."""
    import torch

    (params, mb), _ = rec.grads[0]
    mb = _head(mb, DISTILL_CHECK_SAMPLES, mb["obs"].shape[0])
    grads, terms = dagger.grads(params, mb)
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
    log(f"distill card-vs-cpu, the first minibatch step from the card's inputs (the loss "
        f"and gradients on its first {c_mb['obs'].shape[0]} samples): loss terms {({k: float(f'{v:.3g}') for k, v in out['loss'].items()})}"
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
    train_s, _ = run_main("handarm_tpu_torch.train_distill", [
        "--teacher", ckpt, "--envs", str(ENVS), "--iters", str(DISTILL_ENTRY_ITERS),
        "--out", out, "--seed", "1"], "distill entry point")
    with np.load(os.path.join(out, "student.npz")) as data:
        leaves = [data[k] for k in data.files]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        row = json.loads(f.read().splitlines()[-1])
    if len(leaves) != 18 or not all(np.isfinite(x).all() for x in leaves) \
            or row["step"] != DISTILL_ENTRY_ITERS:
        raise AssertionError(f"distill entry point: bad output in {out}")
    eval_s, stdout = run_main("handarm_tpu_torch.eval_policy", [
        "--student", os.path.join(out, "student.npz"), "--teacher", ckpt, "--envs", str(ENVS),
        "--steps", "10", "--episode-length", "5"], "student eval entry point")
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
RNN_SERVE_STEPS = 10  # timed rnn-serve steps, after one warm-up step
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
    for _ in range(RNN_SERVE_STEPS):
        state, obs, hidden, _ = serve(env, ts, state, obs, hidden)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = rollout.launch_counts()
    check_launches(counts, LIFT_PER_STEP, RNN_SERVE_STEPS, "rnn-serve")
    finite_state(tree_map, state, obs)
    if not all(bool(torch.isfinite(x).all()) for x in carry_leaves(hidden)):
        raise AssertionError("rnn-serve: non-finite carry")
    rate = ENVS * RNN_SERVE_STEPS / seconds
    log(f"rnn-serve: {RNN_SERVE_STEPS} deterministic PPO.act control steps at {ENVS} envs, "
        f"the carry "
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
    return dict(envs=ENVS, control_steps=RNN_SERVE_STEPS, seconds=seconds, env_steps_per_s=rate,
                launches=counts, card_vs_cpu=errs)


def carry_leaves(carry) -> list:
    """The tensors of a carry, (c, h) or {"actor": ..., "critic": ...}."""
    from handarm_tpu_torch.learn.ppo import carry_items

    return list(carry_items(carry).values())


def rnn_entry_phase(rollout, ppo, dev) -> dict:
    """Phase 22 (see the module docstring)."""
    import numpy as np

    from handarm_tpu_torch.envs.tasks import LSTM_LIFT
    from handarm_tpu_torch.utils.checkpoint import load_train_state

    exp = "chip_smoke_rnn"
    args = ["task=Ur5SihLift", f"num_envs={ENVS}", *LSTM_LIFT, f"experiment={exp}", "seed=1"]
    nn_dir = os.path.join("runs", exp, "nn")
    shutil.rmtree(os.path.join("runs", exp), ignore_errors=True)
    first_s, resume_s = (entry_in_process(
        rollout, args + more, os.path.join(nn_dir, f"ckpt_{i}.npz"), tag, dev, LIFT_PER_ITER, 1,
        n_leaves=None)["seconds"] for i, more, tag in (
            (1, ["max_iterations=1"], "rnn entry point"),
            (2, ["max_iterations=2", "resume=auto"], "rnn entry point resumed")))
    ts1, ts2 = (load_train_state(os.path.join(nn_dir, f"ckpt_{i}.npz"), cfg=ppo.cfg)
                for i in (1, 2))
    steps = ppo.num_minibatches * ppo.cfg.mini_epochs
    check_learner(ts2, "rnn entry point")
    with open(os.path.join("runs", exp, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f.read().splitlines()]
    ok = (int(ts1.epoch) == 1 and int(ts2.epoch) == 2
          and int(ts2.opt_state.count) == 2 * steps - int(ts2.opt_state.total_notfinite)
          and float(ts2.teacher_obs_stats.count) > float(ts1.teacher_obs_stats.count)
          and [r["step"] for r in rows] == [0, 1]
          and all(np.isfinite(r["kl"]) for r in rows)
          and any(float(x.abs().max()) > 0 for x in carry_leaves(ts2.hidden)))
    if not ok:
        raise AssertionError(f"rnn entry point: bad checkpoints or metrics in runs/{exp}")
    log(f"rnn entry point: 1 iteration in {first_s:.1f} s, resumed for a second in "
        f"{resume_s:.1f} s; its rows {[(r['step'], round(r['kl'], 5)) for r in rows]}")
    return dict(first_s=first_s, resume_s=resume_s, rows=rows)


ADR_ON = "rl.randomization_params.adr.enabled=true"
DR_ITERS = 1  # timed dr-train iterations, after one warm-up iteration
ADR_ITERS = 1  # timed adr iterations, after one warm-up iteration
ADR_CHECK_STEPS = 3  # adr_step check: steps at objective 1, then as many at 0


def timed_iterations(rollout, ppo, ts, n: int, per_iter: dict, tag: str, capture=None,
                     warmup: bool = True):
    """One warm-up train_iter (none without `warmup`: the first timed
    iteration then carries the first calls' costs), then n iterations timed
    as rollout and update (each part between torch.cuda.synchronize calls);
    counters zeroed before each iteration and read after it: exactly
    `per_iter`; params, stats and every state leaf finite. `capture` (a
    Capture with last_only) is armed for the last timed rollout. Returns
    (record, TrainState)."""
    import torch

    from handarm_tpu_torch import train
    from handarm_tpu_torch.envs.hand_arm import tree_map

    samples = ppo.env.cfg.num_envs * ppo.cfg.horizon
    warm = None
    if warmup:
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
    log(f"{tag}: warm-up iteration " + (f"{warm:.3f} s" if warmup else "none (the first "
                                         "iteration timed from a fresh init)")
        + f"; peak device memory {peak:.2f} GiB; every param, stat and state leaf finite")
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


def dr_entry_phase(rollout, dev) -> dict:
    """Phase 27 (see the module docstring)."""
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.envs.tasks import DR_SHADOWHAND
    from handarm_tpu_torch.utils.checkpoint import file_env_leaves, load_train_state, read_leaves

    ckpt = os.path.relpath(rollout.TASK_CKPTS[MULTI_TASK])
    step = int(os.path.basename(ckpt)[5:-4]) + 1
    out = os.path.join("runs", "chip_smoke_dr", "nn", f"ckpt_{step}.npz")
    rec = entry_in_process(
        rollout, [f"task={MULTI_TASK}", f"resume={ckpt}", f"max_iterations={step}",
                  *DR_SHADOWHAND, ADR_ON, "experiment=chip_smoke_dr", "seed=1"],
        out, "dr entry point", dev, MULTI_PER_ITER, 1, n_leaves=83)
    del rec["stdout"]
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


def engine_entry_phase(rollout, dev) -> dict:
    """Phase 32 (see the module docstring)."""
    from handarm_tpu_torch.utils.checkpoint import file_contact_slots, load_train_state

    run = os.path.join("runs", "chip_smoke_engine")
    shutil.rmtree(run, ignore_errors=True)
    # the lift's mass structure every sim step (3 spd_inverse a control
    # step), 6 sweeps; no deff (B * C = 8192 * 190 < 2^21), no mesh object
    per_iter = {"spd_inverse": 48, "contact_sweep": 96, "prep_deff": 0, "sdf_gather": 0}
    first = entry_in_process(rollout, ENGINE_ENTRY + ["max_iterations=1"],
                             os.path.join(run, "nn", "ckpt_1.npz"), "engine entry point", dev,
                             per_iter, 1)
    second = entry_in_process(rollout, ENGINE_ENTRY + ["max_iterations=2", "resume=auto"],
                              os.path.join(run, "nn", "ckpt_2.npz"),
                              "engine entry point resumed", dev, per_iter, 1)
    second_s, stdout = second["seconds"], second["stdout"]
    del first["stdout"]
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
STRETCH_EVAL_STEPS = 400  # counted eval steps: one episode (400) from zeroed clocks


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
    from handarm_tpu_torch.utils.checkpoint import (
        file_contact_slots,
        load_train_state,
        wait_for_pending_saves,
    )

    ckpt = os.path.relpath(rollout.TASK_CKPTS[STRETCH_TASK])
    step = int(os.path.basename(ckpt)[5:-4]) + STRETCH_ENTRY_ITERS
    run = os.path.join("runs", "chip_smoke_stretch")
    shutil.rmtree(run, ignore_errors=True)
    out_path = os.path.join(run, "nn", f"ckpt_{step}.npz")
    seconds, stdout = run_main(
        "handarm_tpu_torch.train", [f"task={STRETCH_TASK}", f"resume={ckpt}",
                                    f"max_iterations={step}", "experiment=chip_smoke_stretch"],
        "stretch entry point")
    wait_for_pending_saves()
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
                                 min_episodes=1500, steps=STRETCH_EVAL_STEPS)
    return rec, kernels


# the classic tasks (phases 45-56): task -> (envs, timed train iterations
# after the warm-up); 8192, 4096 and 512 are IsaacGymEnvs' cfg/task numEnvs
CLASSIC = {"Quadcopter": (8192, 1), "Ingenuity": (4096, 1), "Ant": (4096, 1),
           "Humanoid": (4096, 1), "Cartpole": (512, 1), "BallBalance": (4096, 1),
           "Anymal": (4096, 1), "AnymalTerrain": (4096, 1), "FrankaCubeStack": (8192, 1),
           "FrankaCabinet": (4096, 1), "Trifinger": (16384, 1), "AllegroHand": (16384, 1),
           "ShadowHand": (16384, 1), "AllegroHandDextremeADR": (8192, 1),
           "AllegroKukaReorientation": (8192, 1), "AllegroKukaTwoArmsReorientation": (8192, 1),
           "FactoryTaskNutBoltPick": (512, 1), "IndustRealTaskPegsInsert": (512, 1)}
LOCOMOTION = ("Ant", "Humanoid")
CONTACT_TASKS = ("BallBalance", "Anymal", "AnymalTerrain")  # phases 52-54
FRANKA_TASKS = ("FrankaCubeStack", "FrankaCabinet")  # phases 55-56
FRANKA_APPROACH_STEPS = 30  # scripted OSC steps to cubeA's top, the gripper open
FRANKA_GRASP_STEPS = 5  # then closing on it
CABINET_PAST_GRIP = 0.01  # m: the drawer's front this far past the grip site
CABINET_MAX_OPENING = 0.38  # m: short of the 0.39 m success line
CABINET_PRESS_STEPS = 3  # zero-action steps of the drawer sliding on against the gripper
HAND_TASKS = ("Trifinger", "AllegroHand", "ShadowHand")  # phases 57-59
HAND_SERVE_STEPS = 6  # the hands' timed serving steps at 16384 envs, after one warm-up
HAND_SETTLE_STEPS = 15  # steps of a hand holding its default joints, the cube resting
GRASP_STEPS = 10  # the Trifinger's scripted steps toward the cube's faces, then closing
# the asymmetric ShadowHand tasks (phase 59), one train iteration each at
# IsaacGymEnvs' numEnvs (cfg/task/ShadowHandOpenAI_FF.yaml, _LSTM.yaml)
OPENAI = {"ShadowHandOpenAI_FF": 16384, "ShadowHandOpenAI_LSTM": 8192}
# the entry points' tasks in neither table, at IsaacGymEnvs' numEnvs
ENTRY_ENVS = {"AllegroHandManualDR": 8192, "AllegroKuka": 8192, "AllegroKukaTwoArms": 8192,
              "FactoryTaskNutBoltScrew": 512}
# phases 60-61 at IsaacGymEnvs' numEnvs (cfg/task/AllegroHandDextremeADR.yaml,
# AllegroKuka.yaml); the KUKA's other variants one train iteration each
DEXTREME_TASK = "AllegroHandDextremeADR"
DEXTREME_REF_HI = (0.05, 0.05, 0.2)  # ADR's ranges opened for dextreme-ref
# phases 61-62 (the one-arm and the two-arm tasks): each task's other
# variants, one train iteration each
KUKA_TASKS = {"AllegroKukaReorientation": ("AllegroKukaRegrasping", "AllegroKukaThrow"),
              "AllegroKukaTwoArmsReorientation": ("AllegroKukaTwoArmsRegrasping",)}
KUKA_SETTLE_STEPS = 6  # steps of the objects resting on the back of the fingers
# phases 63-64 at the task yamls' 512 envs (configs/task/Factory*.yaml,
# IndustRealTaskPegsInsert.yaml)
FACTORY_TASK = "FactoryTaskNutBoltPick"
INDUSTREAL_TASK = "IndustRealTaskPegsInsert"
FACTORY_VARIANTS = ("FactoryTaskNutBoltPlace", "FactoryTaskGears", "FactoryTaskInsertion")
FACTORY_GRASP_STEPS = 3  # the place env's steps, the arm still and the gripper closed
SCREW_STEPS = 10  # the screw env's steps with the nut spun
SCREW_SPIN = -20.0  # rad/s about z before each of them (tests/test_factory.py:48-75)
SCREW_START_TURNS = 16  # the nut's start down the thread (3.2 cm): within 2 cm of the bolt
GEARS_STEPS = 3  # the gears env's zero-action steps
IR_SQUEEZE_STEPS = 2  # IndustReal's zero-action steps, the gripper squeezing the plug
# the dense case's sweeps where that case is an unstable Jacobi iteration
# (FrankaCabinet's drawer; the Factory and IndustReal parts, whose inverse
# inertias up to 5.4e5 take the object velocities to ~1e26 over 16 sweeps,
# the plain version at 256 envs on the CPU): 2, as the robot case's
UNSTABLE_DENSE_SWEEPS = 2
CLASSIC_SERVE_STEPS = 30  # timed deterministic steps through PPO.act, after one warm-up
CLASSIC_GROUND_HEIGHT = 0.004  # m over touching: every env's slots active at the first step
CLASSIC_ENTRY_ITERS = 1
UNIT_ROUNDOFF = 2.0 ** -24


def check_spd_craft(spd_op, M, dev, tag):
    """check_spd's comparison and timings at a craft's n, the bound per
    matrix: |kernel - plain| <= max(1e-4, n cond eps) of the plain
    inverse's largest entry and |Minv M - I| <= max(5e-3, n cond eps), cond
    the matrix's 2-norm condition number (float64), eps the unit roundoff:
    a float32 Cholesky inverse is good to about n cond eps, and the craft's
    PD-augmented mass matrices reach cond ~1e4-1e5 (grams of mass on
    origin-Plücker base coordinates metres from the origin), where no fixed
    1e-4 holds."""
    import torch

    got, want = spd_op.spd_inverse_cuda(M), spd_op.spd_inverse_plain(M)
    torch.cuda.synchronize()
    n = M.shape[1]
    cond = torch.linalg.cond(M.double())
    bound = n * cond * UNIT_ROUNDOFF
    rel = ((got - want).abs().amax((1, 2)) / want.abs().amax((1, 2))).double()
    ident = (torch.bmm(got, M) - torch.eye(n, device=dev)).abs().amax((1, 2)).double()
    c = dict(cond_max=float(cond.max()), cond_median=float(cond.median()),
             rel_err_max=float(rel.max()), ident_max=float(ident.max()),
             err_over_bound_max=float((rel / bound).max()),
             ident_over_bound_max=float((ident / bound).max()))
    log(f"spd_inverse ({tag}): B={M.shape[0]} n={n}; cond max {c['cond_max']:.3e} median "
        f"{c['cond_median']:.3e}; max relative |kernel-plain| {c['rel_err_max']:.3e}, max "
        f"|Minv M - I| {c['ident_max']:.3e}; worst over n cond eps "
        f"{c['err_over_bound_max']:.3e} and {c['ident_over_bound_max']:.3e}")
    if not (bool((rel <= torch.clamp(bound, min=1e-4)).all())
            and bool((ident <= torch.clamp(bound, min=5e-3)).all())):
        raise AssertionError(f"spd_inverse kernel disagrees with its plain version ({tag})")
    return dict(check_spd(spd_op, M, dev, tag, compare=False), conditioning=c)


def classic_kernels(env, ops, dev, task: str) -> dict:
    """The grounded kernel checks: the craft 4 mm over touching, tilted
    10-30 degrees, falling at 0.5 m/s (`quadcopter.grounded_physics`); one
    engine step with no thrust, its spd_inverse call and its last
    contact_sweep call (the second substep's) held against their plain
    versions. Prints how many envs have an active slot and impulses."""
    import torch

    from handarm_tpu_torch.envs.quadcopter import grounded_physics
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op
    from handarm_tpu_torch.physics import engine
    from handarm_tpu_torch.physics.contacts import generate_contacts
    from handarm_tpu_torch.physics.kinematics import forward_kinematics

    B = env.cfg.num_envs
    phys = grounded_physics(env, B, seed=0, height=CLASSIC_GROUND_HEIGHT)
    sc, r = env.scene, phys.robot
    fk = forward_kinematics(sc.model, r.q, r.base_quat, r.base_pos)
    con = generate_contacts(sc.slots, sc.shapes, sc.spheres, sc.geom, phys.objects.pos,
                            phys.objects.quat, fk.body_quat, fk.body_pos)
    active = con.depth > -sc.params.solver.speculative_margin
    with Capture(ops, last_only=True) as cap:
        cap.armed = True
        after, _ = engine.step(sc, phys)
    torch.cuda.synchronize()
    envs_active = int(active.any(-1).sum())
    pushed = int((after.contact_impulse.norm(dim=-1) > 0).any(-1).sum())
    log(f"{task} grounded: {B} envs, {envs_active} with an active slot ({int(active.sum())} "
        f"of {active.numel()} slots); {pushed} envs with impulses after the step")
    if envs_active < B or pushed == 0:
        raise AssertionError(f"{task} grounded: inactive slots, the kernels would compare "
                             "nothing")
    return {"spd_inverse": check_spd_craft(spd_op, cap.calls["spd"][0][0][0], dev,
                                           f"{task} grounded"),
            "contact_sweep": check_sweep(sweep_op, cap.calls["sweep"][0], sc.maps,
                                         f"{task} grounded", f64=True),
            "envs_active": envs_active, "envs_pushed": pushed}


def classic_ref(task: str, ppo, ts, dev) -> dict:
    """Card vs CPU at 16 envs, the same inputs on both sides: 2 env steps
    from a fresh reset with the trained learner's deterministic actions
    and the same draws (airborne), and 2 engine steps from a grounded
    state (`grounded_physics`, no thrust: the env would end those
    episodes at once, below its height floor). q and the base position
    within 2e-4, observations within 2e-3, each times max(1, the CPU
    value's largest) (PERF.md section 2)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.quadcopter import grounded_physics
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO
    from handarm_tpu_torch.physics import engine

    cfg, _ = resolve_task(task, ["env.num_envs=16"])
    env_c, env_g = build_env(cfg, "cpu"), build_env(cfg, dev)
    to = lambda x, d: tree_map(lambda t: t.to(d), x)
    learner = PPO(env_c, ppo.cfg, device="cpu")
    ts_c = ts._replace(params={k: v.cpu() for k, v in ts.params.items()},
                       obs_stats=to(ts.obs_stats, "cpu"))
    out = {}
    for case in ("airborne", "grounded"):
        state_c, obs_c = env_c.reset(3)
        if case == "grounded":
            state_c = state_c._replace(physics=grounded_physics(
                env_c, 16, seed=1, height=CLASSIC_GROUND_HEIGHT))
        state_g = to(state_c, dev)
        for _ in range(2):
            if case == "grounded":
                state_c = state_c._replace(physics=engine.step(env_c.scene, state_c.physics)[0])
                state_g = state_g._replace(physics=engine.step(env_g.scene, state_g.physics)[0])
                obs_c, obs_g = env_c._obs(state_c), env_g._obs(state_g)
            else:
                a, d = learner.act(ts_c, obs_c), env_c.draw(16)
                state_c, res_c = env_c.step(state_c, a, d)
                state_g, res_g = env_g.step(state_g, a.to(dev), to(d, dev))
                obs_c, obs_g = res_c.obs, res_g.obs
        rec = {}
        for name, g, c, tol in (("obs", obs_g, obs_c, 2e-3),
                                ("q", state_g.physics.robot.q, state_c.physics.robot.q, 2e-4),
                                ("base_pos", state_g.physics.robot.base_pos,
                                 state_c.physics.robot.base_pos, 2e-4)):
            scale = max(1.0, float(c.abs().max()))
            rec[name] = dict(err=float((g.cpu() - c).abs().max()), scale=scale,
                             tol=tol * scale)
        pushed = int((state_c.physics.contact_impulse.norm(dim=-1) > 0).any(-1).sum())
        log(f"{task}-ref {case}: 16 envs, 2 steps, {pushed} envs with impulses; " + ", ".join(
            f"max|{k} gpu-cpu| {v['err']:.3e} (scale {v['scale']:.3e})"
            for k, v in rec.items()))
        if not all(v["err"] <= v["tol"] for v in rec.values()):
            raise AssertionError(f"the card's run disagrees with the CPU reference "
                                 f"({task}-ref {case})")
        if not bool(torch.isfinite(obs_g).all()) or (case == "grounded" and pushed == 0):
            raise AssertionError(f"bad card run or no contact ({task}-ref {case})")
        out[case] = dict(envs_pushed=pushed, **rec)
    return out


def train_and_serve(rollout, env, ppo, task: str, steps: int = HAND_SERVE_STEPS) -> tuple:
    """A classic task's learner trained from a fresh init (`timed_iterations`
    for CLASSIC[task]'s iterations, no warm-up: launches per iteration
    exactly `per_step_launches` x horizon), then `serve_window`. Returns
    (record, TrainState, launches per step)."""
    envs, iters = CLASSIC[task]
    per_step = per_step_launches(env)
    per_iter = {k: v * ppo.cfg.horizon for k, v in per_step.items()}
    rec, ts = timed_iterations(rollout, ppo, ts=ppo.init(0), n=iters, per_iter=per_iter,
                               tag=f"{task} train", warmup=False)
    rec["serve"], _ = serve_window(rollout, env, ppo, ts, steps, per_step, task)
    return rec, ts, per_step


def serve_window(rollout, env, ppo, ts, steps: int, per_step: dict, task: str) -> tuple:
    """`steps` + 1 deterministic serving steps through `PPO.act` from a fresh
    reset (a recurrent policy's carry threaded, zeroed where an episode
    ended if its config says so), the last `steps` timed: launches per step
    as predicted, every state leaf finite. Returns (record, last state)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.learn.ppo import zero_where

    hidden = None

    def act(obs, done):
        nonlocal hidden
        if not ppo.recurrent:
            return ppo.act(ts, obs)
        if done is not None and ppo.cfg.zero_rnn_on_done:
            hidden = zero_where(done, hidden)
        a, hidden = ppo.act(ts, obs, True, hidden)
        return a

    envs = env.cfg.num_envs
    rollout.reset_launch_counts()
    state, obs = env.reset(1)
    state, res = env.step(state, act(obs, None))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, res = env.step(state, act(res.obs, res.done))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = rollout.launch_counts()
    check_launches(counts, per_step, steps + 1, f"{task} serve")
    finite_state(tree_map, state, res.obs)
    sps = envs * steps / seconds
    log(f"{task} serve: {steps} deterministic steps in {seconds:.3f} s = "
        f"{sps:.0f} env-steps/s; launches {counts} over {steps + 1} steps; "
        f"episodes done {int(res.done.sum())}, mean reward {float(res.reward.mean()):.4f}")
    return dict(envs=envs, steps=steps, seconds=seconds, env_steps_per_s=sps,
                launches=counts, launches_per_step=per_step), state


def classic_phase(rollout, dev, ops, task: str) -> tuple:
    """Phases 45 and 47: the task composed as train.py composes it at
    IsaacGymEnvs' env count, its learner at full width from a fresh init
    (`timed_iterations`, no warm-up: launches per iteration exactly 16 /
    32 / 0 / 0), 7 deterministic serving steps through `PPO.act` (1 / 2 /
    0 / 0 per step: `train_and_serve`), and the grounded kernel checks. Returns
    (record, the PPO, its TrainState)."""
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config

    envs = CLASSIC[task][0]
    cfg, over = resolve_task(task, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    ppo = PPO(env, ppo_config(over))
    log(f"{task}: {envs} envs, nv {env.art.nv}, C = {env.scene.slots.num_slots} contact "
        f"slots, K = 0, obs {env.num_obs}, actions {env.num_actions}, "
        f"{env.scene.params.solver.iterations} sweeps; learner hidden {ppo.cfg.hidden}, "
        f"horizon {ppo.cfg.horizon}, {ppo.num_minibatches} minibatches of {ppo.mb_size}")
    rec, ts, _ = train_and_serve(rollout, env, ppo, task)
    rec["kernels"] = classic_kernels(env, ops, dev, task)
    return rec, ppo, ts


def per_step_launches(env) -> dict:
    """Each kernel's launches per env step as the env's code predicts them:
    an engine-backed env (the craft, the locomotion robots, the balance bot
    and its ball, the ANYmal on the ground or the terrain, the Franka with
    its cubes or its drawer, the Trifinger, the hands) runs
    `control_freq_inv` sim steps (the Allegro hand's 2; every other's 1) of
    `substeps` anchored substeps each: spd_inverse once a sim step (and
    once more where the env computes the dynamics itself for
    operational-space control, FrankaCubeStack's `osc_tau`), the sweep once
    a substep, sdf_gather once a sim step (its one contact generation)
    where the scene holds a mesh-SDF object, and the deff kernel once a sim
    step (its solver prep) where B * C >= 2^21 (the hands' 150 and 160
    slots at 16384 envs, AllegroKuka's 298 and the two-arm AllegroKuka's
    506 at 8192); the Cartpole's contact-free step runs the
    dynamics `substeps * control_freq_inv` times and nothing else."""
    import numpy as np

    from handarm_tpu_torch.physics.shapes import MESH_SDF
    from handarm_tpu_torch.physics.solver import DEFF_KERNEL_MIN_BC

    if hasattr(env, "scene"):
        # the DeXtreme wrapper steps its inner AllegroHand env
        sims = getattr(getattr(env, "env", env).cfg, "control_freq_inv", 1)
        deff = env.cfg.num_envs * env.scene.slots.num_slots >= DEFF_KERNEL_MIN_BC
        mesh = MESH_SDF in np.asarray(env.scene.shapes.kind).tolist()
        return {"spd_inverse": sims * (1 + hasattr(env, "osc_tau")),
                "contact_sweep": sims * env.scene.params.substeps, "prep_deff": sims * deff,
                "sdf_gather": sims * mesh}
    return {"spd_inverse": env.cfg.substeps * env.cfg.control_freq_inv, "contact_sweep": 0,
            "prep_deff": 0, "sdf_gather": 0}


def weight_carried(env, state):
    """[B] bool: the feet carry half the robot's weight (the summed vertical
    contact force of the env's foot bodies over 0.5 m g)."""
    m = float(env.scene.model.mass.sum())
    return state.feet_force[..., 2].sum(-1) > 0.5 * m * 9.81


def locomotion_phase(rollout, dev, ops, task: str) -> tuple:
    """Phases 49-51 (Ant, Humanoid, Cartpole): the task composed as train.py
    composes it at IsaacGymEnvs' env count, on the in-repo stand-in, its
    learner at full width from a fresh init (`timed_iterations`: launches
    per iteration exactly `per_step_launches` x horizon), 31 deterministic
    serving steps through `PPO.act` with every kernel call kept, and the
    kernel checks on the serving step whose state has the most envs
    standing on their feet (`weight_carried`; at least 1/32 of the envs:
    the Humanoid stand-in's joints have no stiffness, and under a fresh
    policy its feet carry the weight only for the few steps after it
    lands): spd_inverse at
    n = 6 + joints and the sweep's last call of that step against their
    plain versions (`check_spd_craft`, `check_sweep(f64=True)`); the
    Cartpole's spd_inverse (n = 2) on its last step. Then card vs CPU at 16
    envs (`locomotion_ref`). Returns the record."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    envs, iters = CLASSIC[task]
    cfg, over = resolve_task(task, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    ppo = PPO(env, ppo_config(over))
    per_step = per_step_launches(env)
    legged = task in LOCOMOTION
    C = env.scene.slots.num_slots if legged else 0
    log(f"{task}: {envs} envs, nv {env.art.nv}, C = {C} contact slots, K = 0, obs "
        f"{env.num_obs}, actions {env.num_actions}; learner hidden {ppo.cfg.hidden}, horizon "
        f"{ppo.cfg.horizon}, {ppo.num_minibatches} minibatches of {ppo.mb_size}; launches "
        f"per step {per_step}")
    per_iter = {k: v * ppo.cfg.horizon for k, v in per_step.items()}
    rec, ts = timed_iterations(rollout, ppo, ts=ppo.init(0), n=iters, per_iter=per_iter,
                               tag=f"{task} train", warmup=False)
    rollout.reset_launch_counts()
    state, obs = env.reset(1)
    state, res = env.step(state, ppo.act(ts, obs))
    standing, states = [], []
    with Capture(ops) as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(CLASSIC_SERVE_STEPS):
            cap.armed = legged or i == CLASSIC_SERVE_STEPS - 1
            state, res = env.step(state, ppo.act(ts, res.obs))
            if cap.armed and legged:
                standing.append(weight_carried(env, state).sum())
                states.append(state)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = rollout.launch_counts()
    check_launches(counts, per_step, CLASSIC_SERVE_STEPS + 1, f"{task} serve")
    finite_state(tree_map, state, res.obs)
    sps = envs * CLASSIC_SERVE_STEPS / seconds
    log(f"{task} serve: {CLASSIC_SERVE_STEPS} deterministic steps in {seconds:.3f} s = "
        f"{sps:.0f} env-steps/s (every kernel call kept); launches {counts} "
        f"over {CLASSIC_SERVE_STEPS + 1} steps; episodes done {int(res.done.sum())}, mean "
        f"reward {float(res.reward.mean()):.4f}")
    rec["serve"] = dict(envs=envs, steps=CLASSIC_SERVE_STEPS, seconds=seconds,
                        env_steps_per_s=sps, launches=counts, launches_per_step=per_step)
    spd_calls = cap.calls["spd"]
    kern = {}
    if legged:
        stood = [int(x) for x in standing]
        best = stood.index(max(stood))
        log(f"{task}: envs whose feet carry half the weight at serving steps "
            f"1-{CLASSIC_SERVE_STEPS}: {stood}; the kernels' inputs from step {best + 1}")
        if max(stood) < envs // 32:
            raise AssertionError(f"{task}: the feet carry the weight in too few envs")
        kept = states[best]
        del states
        M = spd_calls[best][0][0]
        sweep_call = cap.calls["sweep"][per_step["contact_sweep"] * (best + 1) - 1]
        lam = sweep_call[0][6]
        pushed = int((lam.abs().sum(0).sum(-1) > 0).sum())
        log(f"{task}: {pushed} of {envs} envs with warm-start impulses in the checked solve")
        kern["spd_inverse"] = check_spd_craft(spd_op, M, dev, f"{task} standing")
        kern["contact_sweep"] = check_sweep(sweep_op, sweep_call, env.scene.maps,
                                            f"{task} standing", f64=True)
        kern["contact_sweep"].update(envs_standing=max(stood), envs_pushed=pushed)
        rec["ref"] = locomotion_ref(task, ppo, ts, dev, env, kept)
    else:
        kern["spd_inverse"] = check_spd_craft(spd_op, spd_calls[-1][0][0], dev, task)
        rec["ref"] = locomotion_ref(task, ppo, ts, dev, env, None)
    rec["kernels"] = kern
    del cap
    return rec


def locomotion_ref(task: str, ppo, ts, dev, env_g_full, kept) -> dict:
    """Card vs CPU at 16 envs, the same inputs on both sides: 2 env steps with
    the trained learner's deterministic actions (on the CPU) and the same
    reset draws; the locomotion robots from 16 of the serving envs whose
    feet carry the weight (`kept`, clocks zeroed: impulses in every env),
    the Cartpole from a fresh reset. q (and the base position) within
    2e-4, observations within 2e-3, each times max(1, the CPU value's
    largest) (PERF.md section 2)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO

    cfg, _ = resolve_task(task, ["env.num_envs=16"])
    env_c, env_g = build_env(cfg, "cpu"), build_env(cfg, dev)
    to = lambda x, d: tree_map(lambda t: t.to(d), x)
    learner = PPO(env_c, ppo.cfg, device="cpu")
    ts_c = ts._replace(params={k: v.cpu() for k, v in ts.params.items()},
                       obs_stats=to(ts.obs_stats, "cpu"))
    if kept is not None:
        idx = torch.nonzero(weight_carried(env_g_full, kept)).flatten()[:16]
        state_c = tree_map(lambda t: t[idx].cpu(), kept)
        state_c = state_c._replace(progress=torch.zeros_like(state_c.progress))
        obs_c = env_c._obs(state_c)
    else:
        state_c, obs_c = env_c.reset(3)
    state_g = to(state_c, dev)
    pushed = [int((state_c.physics.contact_impulse.abs().sum((1, 2)) > 0).sum())] \
        if kept is not None else []
    for _ in range(2):
        a, d = learner.act(ts_c, obs_c), env_c.draw(16)
        state_c, res_c = env_c.step(state_c, a, d)
        state_g, res_g = env_g.step(state_g, a.to(dev), to(d, dev))
        obs_c, obs_g = res_c.obs, res_g.obs
        if kept is not None:
            pushed.append(int((state_c.physics.contact_impulse.abs().sum((1, 2)) > 0).sum()))
    pairs = [("obs", obs_g, obs_c, 2e-3)]
    if kept is not None:
        r_g, r_c = state_g.physics.robot, state_c.physics.robot
        pairs += [("q", r_g.q, r_c.q, 2e-4), ("base_pos", r_g.base_pos, r_c.base_pos, 2e-4)]
    else:
        pairs += [("q", state_g.q, state_c.q, 2e-4)]
    rec = {}
    for name, g, c, tol in pairs:
        scale = max(1.0, float(c.abs().max()))
        rec[name] = dict(err=float((g.cpu() - c).abs().max()), scale=scale, tol=tol * scale)
    log(f"{task}-ref: 16 envs, 2 steps" + (f", envs with impulses {pushed}" if pushed else "")
        + "; " + ", ".join(f"max|{k} gpu-cpu| {v['err']:.3e} (scale {v['scale']:.3e})"
                           for k, v in rec.items()))
    if not all(v["err"] <= v["tol"] for v in rec.values()):
        raise AssertionError(f"the card's run disagrees with the CPU reference ({task}-ref)")
    if not bool(torch.isfinite(obs_g).all()) or (kept is not None and pushed[0] < 16):
        raise AssertionError(f"bad card run or an env off the ground ({task}-ref)")
    return dict(envs_with_impulses=pushed, **rec)


def task_envs(task: str) -> int:
    """A task's env count: CLASSIC's, OPENAI's or ENTRY_ENVS'."""
    if task in CLASSIC:
        return CLASSIC[task][0]
    if task in OPENAI:
        return OPENAI[task]
    if task in ENTRY_ENVS:
        return ENTRY_ENVS[task]
    raise KeyError(f"no env count for {task}: add it to ENTRY_ENVS")


def classic_entry(rollout, dev, task: str, state_type, extra=()) -> dict:
    """Phase 48's entry points, `train.main` in this process (`python -m
    handarm_tpu_torch.train task=TASK env.num_envs=N max_iterations=1` once
    started; the Quadcopter at 8192 envs, the Cartpole at 512,
    AnymalTerrain and FrankaCabinet at 4096, AllegroHand at 16384):
    launches per iteration as `per_step_launches` predicts from the
    composed env (the Quadcopter 16 / 32 / 0 / 0, the Cartpole 32 / 0 / 0
    / 0, AnymalTerrain 24 / 48 / 0 / 0, FrankaCabinet 16 / 32 / 0 / 16,
    AllegroHand 16 / 32 / 16 / 0), its ckpt_1.npz (the task state's leaves:
    the QuadState's 14, the ClassicState's 4, the ATState's 18, the
    CabinetState's 12, the DexState's 15) read whole with the task's config
    and written back leaf for leaf; at `task_envs`, with `extra` overrides:
    the DeXtreme ManualDR task at 8192 envs (2 / 4 / 0 / 0 a step, its
    recurrent learner's file read with its PPOConfig, the DextremeState's 25
    leaves), `AllegroKuka env.subtask=throw` at 8192 (1 / 2 / 1 / 0, the
    AKState's 25) and `AllegroKukaTwoArms env.subtask=regrasping` at 8192
    (1 / 2 / 1 / 0, the AKState's 25 at nv 46)."""
    import numpy as np

    from handarm_tpu_torch.convert import env_state_to_leaves, train_state_to_leaves
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import ppo_config
    from handarm_tpu_torch.utils.checkpoint import load_train_state, read_leaves

    envs = task_envs(task)
    exp = f"chip_smoke_{task.lower()}"
    run = os.path.join("runs", exp)
    shutil.rmtree(run, ignore_errors=True)
    out = os.path.join(run, "nn", f"ckpt_{CLASSIC_ENTRY_ITERS}.npz")
    cfg, over = resolve_task(task, [f"env.num_envs={envs}", *extra])
    pcfg = ppo_config(over)
    per_step = per_step_launches(build_env(cfg, "cpu"))
    per_iter = {k: v * pcfg.horizon for k, v in per_step.items()}
    rec = entry_in_process(rollout, [f"task={task}", f"env.num_envs={envs}", *extra,
                                     f"max_iterations={CLASSIC_ENTRY_ITERS}",
                                     f"experiment={exp}"], out,
                           f"{task} entry point", dev, per_iter, CLASSIC_ENTRY_ITERS, None)
    del rec["stdout"]
    leaves = read_leaves(out)
    ts = load_train_state(out, "cuda", cfg=pcfg, env_cfg=cfg)
    back = train_state_to_leaves(ts, seed=42, cfg=pcfg, env_cfg=cfg)
    same = len(back) == len(leaves) and all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        for a, b in zip(back, leaves))
    log(f"{task} entry point: {len(leaves)} leaves ({len(env_state_to_leaves(ts.env_state))} "
        f"of the env state) read whole as a "
        f"{type(ts.env_state).__name__} of {ts.last_obs.shape[0]} envs, epoch {int(ts.epoch)}, "
        f"written back {'leaf for leaf' if same else 'DIFFERENT'}")
    if not (same and isinstance(ts.env_state, state_type) and int(ts.epoch) == CLASSIC_ENTRY_ITERS
            and ts.last_obs.shape[0] == envs):
        raise AssertionError(f"{task} entry point: its checkpoint does not read back whole")
    return dict(rec, leaves=len(leaves), launches_per_iteration=per_iter)


def task_contact_scores(env, task: str, call):
    """[B] bool, from a captured sweep call (its warm-start impulses, the
    previous substep's, in the frozen basis, and its planes' normals): the
    envs whose solve has the contacts the task's kernel checks want.
    BallBalance: the ball pushes on the robot (a robot-ball slot with a
    normal impulse); Anymal: each of the four foot bodies pushes on the
    ground; AnymalTerrain: a foot pushes on the terrain along a normal that
    is not vertical (a slope or a step)."""
    import numpy as np
    import torch

    from handarm_tpu_torch.ops import contact_sweep as sweep_op

    planes, lam0 = call[0][0], call[0][6]
    pushed = lam0[0] > 0  # [B, C]
    slots = env.scene.slots
    dev = pushed.device
    body = torch.as_tensor(slots.robot_body, device=dev)
    if task == "BallBalance":
        rb = torch.as_tensor((slots.robot_body >= 0) & (slots.obj_b >= 0), device=dev)
        return (pushed & rb).any(-1)
    feet = [torch.as_tensor(np.asarray(slots.robot_body) == f, device=dev)
            for f in np.unique([env.art.sites[n].body for n in env.art.sites if "FOOT" in n])]
    if task == "Anymal":
        return torch.stack([(pushed & f).any(-1) for f in feet]).all(0)
    on_feet = torch.stack(feet).any(0) & (body >= 0)
    return (pushed & on_feet & (planes[sweep_op.BASE["n"][2]] < 0.9999)).any(-1)


def curriculum_check(env, before, after, mid_base_pos, counts: dict) -> None:
    """AnymalTerrain's curriculum over one step: every env's level after it
    as the rule gives it from the state before it and the step's base
    position (before any restart): on a timeout one row up after walking
    over half a patch, one down short of a quarter of the commanded
    distance, clipped to the rows; else unchanged. `counts` gathers the
    timeouts and the moves."""
    import torch

    cfg = env.cfg
    timeout = before.progress + 1 >= cfg.episode_length
    walked = torch.linalg.vector_norm(mid_base_pos[:, :2] - before.spawn_xy, dim=-1)
    cmd_dist = (torch.linalg.vector_norm(before.commands[:, :2], dim=-1)
                * cfg.episode_length * cfg.dt * 0.25)
    lvl = before.terrain_level
    want = torch.where(timeout & (walked > env.terrain.patch_length / 2), lvl + 1, lvl)
    want = torch.clamp(torch.where(timeout & (walked < cmd_dist), want - 1, want), 0,
                       cfg.num_levels - 1)
    if not torch.equal(after.terrain_level, want):
        raise AssertionError("AnymalTerrain: terrain levels off the curriculum rule")
    counts["timeouts"] += int(timeout.sum())
    counts["up"] += int((timeout & (after.terrain_level > lvl)).sum())
    counts["down"] += int((timeout & (after.terrain_level < lvl)).sum())
    counts["kept"] += int((timeout & (after.terrain_level == lvl)).sum())


def contact_task_phase(rollout, dev, ops, task: str) -> dict:
    """Phases 52-54 (BallBalance, Anymal, AnymalTerrain): the task composed
    as train.py composes it at IsaacGymEnvs' 4096 envs, on the in-repo
    stand-ins, its learner at full width from a fresh init
    (`timed_iterations`: launches per iteration exactly `per_step_launches`
    x horizon), 31 deterministic serving steps through `PPO.act` (launches
    per step as predicted), each step's last sweep call and its spd_inverse
    call kept for the step where the most envs have the contacts the task
    wants (`task_contact_scores`; at least 1/32 of the envs); there spd_inverse
    (n = 12 or 18, held to n cond eps: the floating base's mass matrices
    far from the origin) and the sweep (captured, dense and robot cases,
    against float64) against their plain versions, timed beside their
    bounds and torch.linalg.inv. AnymalTerrain's serving window starts
    from levels spread over the rows and holds every step's levels to the
    curriculum rule (`curriculum_check`; the reset's random progress ends
    some episodes in the window). Then card vs CPU at 16 of the kept
    step's envs (`contact_task_ref`). Returns the record."""
    import torch

    from handarm_tpu_torch.envs import anymal_terrain as at_mod
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    envs, iters = CLASSIC[task]
    cfg, over = resolve_task(task, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    ppo = PPO(env, ppo_config(over))
    per_step = per_step_launches(env)
    C, K = env.scene.slots.num_slots, env.scene.shapes.num_objects
    log(f"{task}: {envs} envs, nv {env.art.nv}, C = {C} contact slots, K = {K}, obs "
        f"{env.num_obs}, actions {env.num_actions}; learner hidden {ppo.cfg.hidden}, horizon "
        f"{ppo.cfg.horizon}, {ppo.num_minibatches} minibatches of {ppo.mb_size}; launches "
        f"per step {per_step}")
    per_iter = {k: v * ppo.cfg.horizon for k, v in per_step.items()}
    rec, ts = timed_iterations(rollout, ppo, ts=ppo.init(0), n=iters, per_iter=per_iter,
                               tag=f"{task} train", warmup=False)
    rollout.reset_launch_counts()
    state, obs = env.reset(1)
    terrain = task == "AnymalTerrain"
    if terrain:  # levels over the six rows, so that the curriculum's moves show
        g = torch.Generator(device=dev).manual_seed(5)
        state = state._replace(terrain_level=torch.randint(
            0, cfg.num_levels, (envs,), generator=g, device=dev))
        mid = {}
        engine_step = at_mod.engine_step

        def recording_step(scene, phys):  # the step's base position before restarts
            out = engine_step(scene, phys)
            mid["base_pos"] = out[0].robot.base_pos
            return out

        at_mod.engine_step = recording_step
    moves = dict(timeouts=0, up=0, down=0, kept=0)
    try:
        state, res = env.step(state, ppo.act(ts, obs))
        scores, best = [], None
        with Capture(ops, last_only=True) as cap:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(CLASSIC_SERVE_STEPS):
                cap.armed = True
                before = state
                state, res = env.step(state, ppo.act(ts, res.obs))
                if terrain:
                    curriculum_check(env, before, state, mid["base_pos"], moves)
                sc = task_contact_scores(env, task, cap.calls["sweep"][0])
                scores.append(int(sc.sum()))
                if best is None or scores[-1] > scores[best[0]]:
                    best = (i, state, sc, cap.calls["sweep"][0], cap.calls["spd"][0])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        if terrain:
            at_mod.engine_step = engine_step
    counts = rollout.launch_counts()
    check_launches(counts, per_step, CLASSIC_SERVE_STEPS + 1, f"{task} serve")
    finite_state(tree_map, state, res.obs)
    sps = envs * CLASSIC_SERVE_STEPS / seconds
    log(f"{task} serve: {CLASSIC_SERVE_STEPS} deterministic steps in {seconds:.3f} s = "
        f"{sps:.0f} env-steps/s (each step's last kernel calls kept); launches {counts} "
        f"over {CLASSIC_SERVE_STEPS + 1} steps; episodes done {int(res.done.sum())}, mean "
        f"reward {float(res.reward.mean()):.4f}")
    rec["serve"] = dict(envs=envs, steps=CLASSIC_SERVE_STEPS, seconds=seconds,
                        env_steps_per_s=sps, launches=counts, launches_per_step=per_step)
    if terrain:
        log(f"{task}: terrain levels held to the curriculum rule at every serving step; "
            f"{moves['timeouts']} timeouts: {moves['up']} a row up, {moves['down']} a row "
            f"down, {moves['kept']} kept")
        if moves["timeouts"] == 0 or moves["down"] == 0:
            raise AssertionError(f"{task}: no timeout moved a level in the window")
        rec["curriculum"] = moves
    want = {"BallBalance": "a robot-ball impulse", "Anymal": "all four feet pushing",
            "AnymalTerrain": "a foot pushing along a sloped normal"}[task]
    i, kept, sc, sweep_call, spd_call = best
    log(f"{task}: envs with {want} in the solves of serving steps 1-{CLASSIC_SERVE_STEPS}: "
        f"{scores}; the kernels' inputs from step {i + 1}")
    if scores[i] < envs // 32:
        raise AssertionError(f"{task}: too few envs with {want}")
    kern = {"spd_inverse": check_spd_craft(spd_op, spd_call[0][0], dev, f"{task} step {i + 1}"),
            "contact_sweep": check_sweep(sweep_op, sweep_call, env.scene.maps,
                                         f"{task} step {i + 1}", f64=True, spread=terrain)}
    kern["contact_sweep"].update(envs_with_contacts=scores[i], contacts=want)
    rec["kernels"] = kern
    del cap, best, sweep_call, spd_call
    rec["ref"] = contact_task_ref(task, ppo, ts, dev, kept, sc)
    return rec


def contact_task_ref(task: str, ppo, ts, dev, kept, scores) -> dict:
    """Card vs CPU at 16 envs, the same inputs on both sides: 16 envs of the
    kept serving step with the contacts `task_contact_scores` asks for
    (others in contact where fewer have them; clocks zeroed), 2 env steps
    with the trained learner's deterministic actions (on the CPU) and the
    same draws (AnymalTerrain's pushes too). q, the base position (and the
    ball's) within 2e-4, observations within 2e-3, each times max(1, the
    CPU value's largest); on the terrain, per env, within the larger of
    that and twice the larger of the two runs' own spreads, the most each
    one's outputs move when every float of the starting state is scaled by
    1 + U(-1e-7, 1e-7) (4 draws a side, the same actions and draws): the
    patches lie 12-52 m from the
    origin, about which the base's rotation dofs turn, and float32 resolves
    a step there only to that spread (tests/test_torch_anymal.py)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO

    cfg, _ = resolve_task(task, ["env.num_envs=16"])
    env_c, env_g = build_env(cfg, "cpu"), build_env(cfg, dev)
    to = lambda x, d: tree_map(lambda t: t.to(d), x)
    learner = PPO(env_c, ppo.cfg, device="cpu")
    ts_c = ts._replace(params={k: v.cpu() for k, v in ts.params.items()},
                       obs_stats=to(ts.obs_stats, "cpu"))
    # the scored envs first, then envs with any impulse
    touching = kept.physics.contact_impulse.abs().sum((1, 2)) > 0
    idx = torch.argsort(-(2 * scores.int() + touching.int()), stable=True)[:16]
    start = tree_map(lambda t: t[idx].cpu(), kept)
    start = start._replace(progress=torch.zeros_like(start.progress))
    obs_c = env_c._obs(start) if task != "BallBalance" else env_c._obs(start, None)
    state_c, state_g = start, to(start, dev)
    pushed = [int((state_c.physics.contact_impulse.abs().sum((1, 2)) > 0).sum())]
    inputs = []
    for _ in range(2):
        a, d = learner.act(ts_c, obs_c), env_c.draw(16)
        extra = (env_c.draw_push(16),) if task == "AnymalTerrain" else ()
        inputs.append((a, d, extra))
        state_c, res_c = env_c.step(state_c, a, d, *extra)
        state_g, res_g = env_g.step(state_g, a.to(dev), to(d, dev), *(x.to(dev) for x in extra))
        obs_c, obs_g = res_c.obs, res_g.obs
        pushed.append(int((state_c.physics.contact_impulse.abs().sum((1, 2)) > 0).sum()))

    def outputs(state, obs):
        rob = state.physics.robot
        out = {"obs": obs, "q": rob.q, "base_pos": rob.base_pos}
        if task == "BallBalance":
            out["ball_pos"] = state.physics.objects.pos[:, 0]
        return out

    got, want = outputs(state_g, obs_g), outputs(state_c, obs_c)
    spread = {k: torch.zeros(16) for k in want}
    if task == "AnymalTerrain":  # each side's own spread, from its own run
        g = torch.Generator().manual_seed(0)
        jitter = lambda t: (t * (1 + (torch.rand(t.shape, generator=g) * 2 - 1) * 1e-7)
                            if t.is_floating_point() else t)
        for env, ref, d_ in ((env_c, want, "cpu"), (env_g, got, dev)):
            for _ in range(4):
                st = to(tree_map(jitter, start), d_)
                for a, d, extra in inputs:
                    st, res = env.step(st, a.to(d_), to(d, d_), *(x.to(d_) for x in extra))
                for k, v in outputs(st, res.obs).items():
                    spread[k] = torch.maximum(spread[k], (v - ref[k]).abs().amax(1).cpu())
    rec = {}
    for name in want:
        tol = 2e-3 if name == "obs" else 2e-4
        scale = max(1.0, float(want[name].abs().max()))
        err = (got[name].cpu() - want[name]).abs().amax(1)
        bound = torch.clamp(2.0 * spread[name], min=tol * scale)
        rec[name] = dict(err=float(err.max()), scale=scale, tol=tol * scale,
                         over_bound=float((err / bound).max()),
                         spread_max=float(spread[name].max()))
        if not bool((err <= bound).all()):
            rec[name]["failed"] = True
    log(f"{task}-ref: 16 envs, 2 steps, envs with impulses {pushed}; " + ", ".join(
        f"max|{k} gpu-cpu| {v['err']:.3e} (scale {v['scale']:.3e}"
        + (f", spread up to {v['spread_max']:.3e}" if task == "AnymalTerrain" else "")
        + f"; {v['over_bound']:.3f} of the bound)" for k, v in rec.items()))
    if any(v.get("failed") for v in rec.values()):
        raise AssertionError(f"the card's run disagrees with the CPU reference ({task}-ref)")
    if not bool(torch.isfinite(obs_g).all()) or pushed[0] < 16:
        raise AssertionError(f"bad card run or an env without contact ({task}-ref)")
    return dict(envs_with_impulses=pushed, **rec)


def franka_contact_state(env, task: str, ops, dev):
    """A state of every env with the contacts phase 55 or 56 checks, built
    by the env's own steps (launches per step as `per_step_launches`
    predicts), the last step's kernel calls kept. FrankaCubeStack: the
    grip site driven by OSC to cubeA's top with the gripper open
    (FRANKA_APPROACH_STEPS), then closing on it (FRANKA_GRASP_STEPS);
    FrankaCabinet: the drawer slid out until its handle's front lies
    CABINET_PAST_GRIP past the env's grip site (short of the success line)
    and moving at 0.3 m/s against the gripper, then CABINET_PRESS_STEPS
    zero-action steps. Returns (state, [B] bool: the envs whose hand or
    fingers push on cubeA or the drawer at the last step's end (an impulse
    on a robot-object slot), the kept calls, steps)."""
    import torch

    state, obs = env.reset(2)
    B = env.cfg.num_envs
    if task == "FrankaCubeStack":
        lift = torch.tensor([0.0, 0.0, 0.01], device=dev)

        def action(obs, i):
            a = torch.zeros(B, 7, device=dev)
            a[:, :3] = torch.clamp(10.0 * (obs[:, 4:7] + lift - obs[:, 10:13]), -1.0, 1.0)
            a[:, 6] = 1.0 if i < FRANKA_APPROACH_STEPS else -1.0
            return a

        steps = FRANKA_APPROACH_STEPS + FRANKA_GRASP_STEPS
    else:  # the handle's front 1 cm past the grip site, within the rail short of success
        _, grip, _, _ = env._hand(state.physics)
        front = env.drawer_closed_pos[0] + float(env.scene.shapes.points[0, :, 0].max())
        s_open = torch.clamp(grip[:, 0] - front + CABINET_PAST_GRIP, 0.0, CABINET_MAX_OPENING)
        objects = state.physics.objects
        pos, linvel = objects.pos.clone(), objects.linvel.clone()
        pos[:, 0, 0] += s_open
        linvel[:, 0, 0] = 0.3
        state = state._replace(physics=state.physics._replace(
            objects=objects._replace(pos=pos, linvel=linvel)))
        action = lambda obs, i: torch.zeros(B, 9, device=dev)
        steps = CABINET_PRESS_STEPS
    with Capture(ops, last_only=True) as cap:
        for i in range(steps):
            cap.armed = i == steps - 1
            state, res = env.step(state, action(obs, i))
            obs = res.obs
    slots = env.scene.slots
    robot_obj = torch.as_tensor((slots.robot_body >= 0) & (slots.obj_b == 0), device=dev)
    pushed = state.physics.contact_impulse.norm(dim=-1) > 0
    return state, (pushed & robot_obj).any(-1), cap.calls, steps


def franka_phase(rollout, dev, ops, task: str) -> dict:
    """Phases 55-56 (FrankaCubeStack, FrankaCabinet): the task composed as
    train.py composes it at IsaacGymEnvs' env count, on the in-repo
    stand-in Franka, its learner at full width from a fresh init
    and 31 deterministic serving steps through `PPO.act`
    (`train_and_serve`); then the built contact state
    (`franka_contact_state`: at least 1/32 of the envs' hands pushing on
    cubeA or the drawer), where spd_inverse (n = 9, to n cond eps), the
    sweep (captured, dense and robot cases, against float64; the
    Cabinet's dense case over 2 sweeps) and, on the Cabinet, sdf_gather
    (every channel; the queries inside the drawer's grid printed) are held
    against their plain versions, timed beside their bounds and their
    library calls; then card vs CPU at 16 of those envs (`contact_state_ref`).
    Returns the record."""
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import sdf_gather as sdf_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    envs = CLASSIC[task][0]
    cfg, over = resolve_task(task, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    ppo = PPO(env, ppo_config(over))
    per_step = per_step_launches(env)
    sc = env.scene
    C, K = sc.slots.num_slots, sc.shapes.num_objects
    log(f"{task}: {envs} envs, nv {env.art.nv}, C = {C} contact slots, K = {K}, "
        f"{sc.spheres.body.shape[0]} robot spheres, {sc.geom.num_walls} walls, obs "
        f"{env.num_obs}, actions {env.num_actions}; object masses "
        f"{[round(float(m), 4) for m in sc.shapes.mass]} kg, the robot's "
        f"{float(sc.model.mass.sum()):.3f} kg; learner hidden {ppo.cfg.hidden}, horizon "
        f"{ppo.cfg.horizon}, {ppo.num_minibatches} minibatches of {ppo.mb_size}; launches "
        f"per step {per_step}")
    rec, ts, _ = train_and_serve(rollout, env, ppo, task)

    rollout.reset_launch_counts()
    kept, scores, calls, steps = franka_contact_state(env, task, ops, dev)
    check_launches(rollout.launch_counts(), per_step, steps, f"{task} contact state")
    finite_state(tree_map, kept, env._obs(kept))
    n_contact = int(scores.sum())
    want = "a hand or finger pushing on " + ("cubeA" if task == "FrankaCubeStack"
                                             else "the drawer")
    log(f"{task}: {n_contact} of {envs} envs with {want} at the contact state's last "
        f"step (built in {steps} steps)")
    if n_contact < envs // 32:
        raise AssertionError(f"{task}: too few envs with {want}")
    tag = f"{task} contact state"
    # the drawer's dense case (its 100 wall and ground slots and 30 sphere
    # slots made active on one body, the robot's 60 on the walls and the
    # ground) is an unstable Jacobi iteration: the plain version's float32
    # error from float64 grows 2.4e-7, 5.5e-7, 4.7e-6, 8.3e-5 over 1, 2, 4
    # and 8 sweeps at a scale of 0.7, so there two float32 orders differ
    # by their own rounding; it runs UNSTABLE_DENSE_SWEEPS
    dense = UNSTABLE_DENSE_SWEEPS if task == "FrankaCabinet" else None
    kern = {"spd_inverse": check_spd_craft(spd_op, calls["spd"][0][0][0], dev, tag),
            "contact_sweep": check_sweep(sweep_op, calls["sweep"][0], sc.maps, tag, f64=True,
                                         dense_sweeps=dense)}
    kern["contact_sweep"].update(envs_with_contacts=n_contact, contacts=want)
    if "sdf" in calls:
        kern["sdf_gather"] = check_sdf(sdf_op, calls["sdf"][0][0])
    if per_step["sdf_gather"] != ("sdf" in calls):
        raise AssertionError(f"{task}: sdf_gather calls do not match the scene")
    rec["kernels"] = kern
    rec["contact_state"] = dict(steps=steps, envs_with_contacts=n_contact)
    del calls
    rec["ref"] = contact_state_ref(task, ppo, ts, dev, kept, scores)
    return rec


def contact_state_ref(task: str, ppo, ts, dev, kept, scores) -> dict:
    """Card vs CPU at 16 envs of a built contact state (those whose robot
    pushes on the object first; clocks zeroed), 2 env steps with the
    trained learner's deterministic actions (on the CPU; an asymmetric
    learner's actor needs no teacher observations) and the same draws: q
    and the objects' positions within 2e-4, observations within 2e-3, each
    times max(1, the CPU value's largest)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO

    cfg, _ = resolve_task(task, ["env.num_envs=16"])
    env_c, env_g = build_env(cfg, "cpu"), build_env(cfg, dev)
    to = lambda x, d: tree_map(lambda t: t.to(d), x)
    learner = PPO(env_c, ppo.cfg, device="cpu")
    ts_c = ts._replace(params={k: v.cpu() for k, v in ts.params.items()},
                       obs_stats=to(ts.obs_stats, "cpu"))
    idx = torch.argsort(-scores.int(), stable=True)[:16]
    start = tree_map(lambda t: (t[idx] if t.ndim else t).cpu(), kept)  # a 0-d average kept
    start = start._replace(progress=torch.zeros_like(start.progress))
    state_c, state_g, obs_c = start, to(start, dev), env_c._obs(start)
    touching = lambda st: int((st.physics.contact_impulse.abs().sum((1, 2)) > 0).sum())
    pushed = [touching(state_c)]
    for _ in range(2):
        a, d = learner.act(ts_c, obs_c), env_c.draw(16)
        state_c, res_c = env_c.step(state_c, a, d)
        state_g, res_g = env_g.step(state_g, a.to(dev), to(d, dev))
        obs_c, obs_g = res_c.obs, res_g.obs
        pushed.append(touching(state_c))
    rec = {}
    for name, g, c, tol in (("obs", obs_g, obs_c, 2e-3),
                            ("q", state_g.physics.robot.q, state_c.physics.robot.q, 2e-4),
                            ("object_pos", state_g.physics.objects.pos,
                             state_c.physics.objects.pos, 2e-4)):
        scale = max(1.0, float(c.abs().max()))
        rec[name] = dict(err=float((g.cpu() - c).abs().max()), scale=scale, tol=tol * scale)
    log(f"{task}-ref: 16 envs, 2 steps, envs with impulses {pushed}; " + ", ".join(
        f"max|{k} gpu-cpu| {v['err']:.3e} (scale {v['scale']:.3e})" for k, v in rec.items()))
    if not all(v["err"] <= v["tol"] for v in rec.values()):
        raise AssertionError(f"the card's run disagrees with the CPU reference ({task}-ref)")
    if not bool(torch.isfinite(obs_g).all()) or pushed[0] < 16:
        raise AssertionError(f"bad card run or an env without contact ({task}-ref)")
    return dict(envs_with_impulses=pushed, **rec)


def part_env(task: str, envs: int, dev):
    """A Factory or IndustReal task's env as `train.py` composes it, at
    `envs` envs, with its per-step launch prediction."""
    from handarm_tpu_torch.envs.registry import build_env, resolve_task

    cfg, _ = resolve_task(task, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    return env, per_step_launches(env)


def pushing_envs(env, state, robot: bool):
    """[B] bool: the envs whose last solve left an impulse on a slot of the
    robot against part 0 (`robot`), or on a part-on-part slot."""
    import torch

    slots = env.scene.slots
    kind = ((slots.robot_body >= 0) & (slots.obj_b == 0) if robot
            else (slots.obj_a >= 0) & (slots.obj_b >= 0))
    pushed = state.physics.contact_impulse.norm(dim=-1) > 0
    return (pushed & torch.as_tensor(kind, device=pushed.device)).any(-1)


def run_steps(env, state, steps: int, action, ops, per_step: dict, rollout, tag: str,
              spin=None):
    """`steps` env steps from `state` with `action(i)` (and, with `spin`,
    part 0's spin about z forced to that rad/s before each step), the last
    step's kernel calls kept; launches as predicted. Returns (state, calls)."""
    from handarm_tpu_torch.envs.hand_arm import tree_map

    rollout.reset_launch_counts()
    with Capture(ops, last_only=True) as cap:
        for i in range(steps):
            cap.armed = i == steps - 1
            if spin is not None:
                o = state.physics.objects
                av = o.angvel.clone()
                av[:, 0, 2] = spin
                state = state._replace(physics=state.physics._replace(
                    objects=o._replace(angvel=av)))
            state, res = env.step(state, action(i))
    check_launches(rollout.launch_counts(), per_step, steps, tag)
    finite_state(tree_map, state, res.obs)
    return state, cap.calls


def parts_ref(env_g, kept, scores, dev, tag: str, closed: bool, extra=None) -> dict:
    """Card vs CPU at 16 envs of a built contact state (those with the
    contacts first; clocks zeroed), 2 env steps with the same seeded actions
    (uniform in [-0.3, 0.3], the gripper closed with `closed`) and the same
    draws: q and the parts' positions within 2e-4, observations within
    2e-3, each times max(1, the CPU value's largest). `extra(state)`
    replaces the start state's fields on both sides."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env

    cfg = dataclasses.replace(env_g.cfg, num_envs=16)
    env_c, env_g = build_env(cfg, "cpu"), build_env(cfg, dev)
    to = lambda x, d: tree_map(lambda t: t.to(d), x)
    idx = torch.argsort(-scores.int(), stable=True)[:16]
    start = tree_map(lambda t: (t[idx] if t.ndim else t).cpu(), kept)
    start = start._replace(progress=torch.zeros_like(start.progress))
    if extra is not None:
        start = extra(start)
    state_c, state_g = start, to(start, dev)
    gen = torch.Generator().manual_seed(4)
    rec = {"info": []}
    for _ in range(2):
        a = (torch.rand(16, env_c.num_actions, generator=gen) * 2.0 - 1.0) * 0.3
        if closed:
            a[:, 6] = -1.0
        d = env_c.draw(16)
        state_c, res_c = env_c.step(state_c, a, d)
        state_g, res_g = env_g.step(state_g, a.to(dev), to(d, dev))
        rec["info"].append({k: (float(res_g.info[k]), float(res_c.info[k]))
                            for k in res_c.info})
    pairs = [("obs", res_g.obs, res_c.obs, 2e-3),
             ("q", state_g.physics.robot.q, state_c.physics.robot.q, 2e-4),
             ("object_pos", state_g.physics.objects.pos, state_c.physics.objects.pos, 2e-4)]
    if env_c.num_teacher_obs:
        pairs.append(("teacher_obs", res_g.teacher_obs, res_c.teacher_obs, 2e-3))
    for name, g, c, tol in pairs:
        scale = max(1.0, float(c.abs().max()))
        rec[name] = dict(err=float((g.cpu() - c).abs().max()), scale=scale, tol=tol * scale)
    log(f"{tag}: 16 envs, 2 steps; " + ", ".join(
        f"max|{k} gpu-cpu| {v['err']:.3e} (scale {v['scale']:.3e})"
        for k, v in rec.items() if k != "info") + f"; info (card, cpu) {rec['info'][-1]}")
    if not all(v["err"] <= v["tol"] for k, v in rec.items() if k != "info"):
        raise AssertionError(f"the card's run disagrees with the CPU reference ({tag})")
    if not bool(torch.isfinite(res_g.obs).all()):
        raise AssertionError(f"non-finite card observations ({tag})")
    return rec, state_g, state_c


def factory_phase(rollout, dev, ops) -> dict:
    """Phase 63 (see the module docstring). Returns the record."""
    import torch

    from handarm_tpu_torch.envs.factory import (
        BOLT_HEAD_HEIGHT, BOLT_SHANK_LENGTH, TABLE_HEIGHT, THREAD_PITCH)
    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import prep_deff as deff_op
    from handarm_tpu_torch.ops import sdf_gather as sdf_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    envs = CLASSIC[FACTORY_TASK][0]
    env, per_step = part_env(FACTORY_TASK, envs, dev)
    _, over = resolve_task(FACTORY_TASK, [f"env.num_envs={envs}"])
    ppo = PPO(env, ppo_config(over))
    sc = env.scene
    log(f"{FACTORY_TASK}: {envs} envs, nv {env.art.nv}, C = {sc.slots.num_slots}, K = "
        f"{env.K}, R = {sc.shapes.sdf_field.shape[1]}, {sc.params.solver.iterations} sweeps, "
        f"warm start {sc.params.solver.warm_start}; part masses "
        f"{[round(float(m), 4) for m in sc.shapes.mass]} kg, inverse inertias up to "
        f"{float((1.0 / sc.shapes.inertia_diag).max()):.3e}; obs {env.num_obs}, actions "
        f"{env.num_actions}; learner hidden {ppo.cfg.hidden}, horizon {ppo.cfg.horizon}, "
        f"{ppo.num_minibatches} minibatches of {ppo.mb_size}; launches per step {per_step}")
    rec, _, _ = train_and_serve(rollout, env, ppo, FACTORY_TASK)
    del env, ppo

    def closed(n):  # the arm still, the gripper closed (action 6 < 0)
        a = torch.zeros(n, 12, device=dev)
        a[:, 6] = -1.0
        return lambda i: a

    # place: the nut in the closed gripper, the arm still
    place, per = part_env("FactoryTaskNutBoltPlace", envs, dev)
    state, _ = place.reset(2)
    state, calls = run_steps(place, state, FACTORY_GRASP_STEPS, closed(envs), ops, per,
                             rollout, "place contact state")
    scores = pushing_envs(place, state, robot=True)
    n_contact = int(scores.sum())
    nut_z = state.physics.objects.pos[:, 0, 2]
    log(f"FactoryTaskNutBoltPlace: {n_contact} of {envs} envs with the fingers pushing on the "
        f"nut after {FACTORY_GRASP_STEPS} steps; nut z {float(nut_z.min()):.4f}-"
        f"{float(nut_z.max()):.4f} m")
    if n_contact < envs // 32:
        raise AssertionError("FactoryTaskNutBoltPlace: too few envs with the fingers on the nut")
    tag = "FactoryTaskNutBoltPlace contact state"
    kern = {"spd_inverse": check_spd_craft(spd_op, calls["spd"][0][0][0], dev, tag),
            "contact_sweep": check_sweep(sweep_op, calls["sweep"][0], place.scene.maps, tag,
                                         f64=True, dense_sweeps=UNSTABLE_DENSE_SWEEPS,
                                         slots=place.scene.slots),
            "sdf_gather": check_sdf(sdf_op, calls["sdf"][0][0])}
    kern["contact_sweep"].update(envs_with_contacts=n_contact,
                                 contacts="the fingers pushing on the nut")
    kern["sdf_gather"].update(resolution=int(place.scene.shapes.sdf_field.shape[1]))
    # prep_deff, off this path (B x C < 2^21), forced for one more step
    with deff_at_any_size(), Capture(ops, last_only=True) as cap:
        cap.armed = True
        place.step(state, closed(envs)(0))
    torch.cuda.synchronize()
    kern["prep_deff"] = check_deff(deff_op, cap.calls["deff"][0][0])
    kern["prep_deff"].update(forced=True)
    rec["kernels"] = kern
    rec["contact_state"] = dict(task="FactoryTaskNutBoltPlace", steps=FACTORY_GRASP_STEPS,
                                envs_with_contacts=n_contact)
    rec["ref"], _, _ = parts_ref(place, state, scores, dev, "factory-ref (place)", True)
    del place, state, calls, cap

    # screw: the nut started SCREW_START_TURNS down the thread (within the
    # speculative margin of the bolt, which rests lower than the thread's top),
    # then spun on down it
    screw, per = part_env("FactoryTaskNutBoltScrew", envs, dev)
    state, _ = screw.reset(3)
    z_top = TABLE_HEIGHT + BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH
    theta0 = torch.full((envs,), -2.0 * math.pi * SCREW_START_TURNS, device=dev)
    o = state.physics.objects
    pos = o.pos.clone()
    pos[:, 0, 2] = z_top + THREAD_PITCH * theta0 / (2 * math.pi)
    state = state._replace(theta=theta0, physics=state.physics._replace(
        objects=o._replace(pos=pos)))
    z0 = pos[:, 0, 2]
    zeros = lambda i: torch.zeros(envs, 12, device=dev)
    state, calls = run_steps(screw, state, SCREW_STEPS, zeros, ops, per, rollout,
                             "screw", spin=SCREW_SPIN)
    z = state.physics.objects.pos[:, 0, 2]
    expect = torch.clamp(z_top + THREAD_PITCH * state.theta / (2 * math.pi),
                         TABLE_HEIGHT + BOLT_HEAD_HEIGHT, z_top)
    pitch_err = float((z - expect).abs().max())
    xy = float(state.physics.objects.pos[:, 0, :2].abs().max())
    descent = float((z0 - z).mean())
    pair = pushing_envs(screw, state, robot=False)
    # the nut-bolt slots the last solve held active (the gate: within the
    # speculative margin), whether or not they carried an impulse
    slots = screw.scene.slots
    pair_slots = torch.as_tensor((slots.obj_a >= 0) & (slots.obj_b >= 0), device=dev)
    gate = calls["sweep"][0][0][0][sweep_op.BASE["gate"]] > 0
    pair_active = int((gate & pair_slots[None]).any(-1).sum())
    log(f"FactoryTaskNutBoltScrew: {SCREW_STEPS} steps spun at {SCREW_SPIN} rad/s from "
        f"{SCREW_START_TURNS} turns down: theta {float(state.theta.mean()):.3f} rad, mean "
        f"descent {descent * 1e3:.4f} mm, max |z - pitch's| {pitch_err:.3e} m, max |xy| "
        f"{xy:.3e} m; {pair_active} envs with "
        f"active nut-bolt slots in the last solve, {int(pair.sum())} with nut-bolt impulses")
    if not (pitch_err <= 1e-3 and xy <= 1e-4 and float((state.theta - theta0).max()) < -1.0
            and pair_active >= envs // 32):
        raise AssertionError("FactoryTaskNutBoltScrew: the nut does not follow the thread, or "
                             "no nut-bolt slot in play")
    kern["contact_sweep"]["screw"] = dict(
        path="FactoryTaskNutBoltScrew, the nut spun on its cylindrical rail",
        envs_with_active_nut_bolt_slots=pair_active,
        envs_with_nut_bolt_impulses=int(pair.sum()), descent_m=descent, pitch_err_m=pitch_err,
        **check_sweep(sweep_op, calls["sweep"][0], screw.scene.maps,
                      "FactoryTaskNutBoltScrew spun", f64=True,
                      dense_sweeps=UNSTABLE_DENSE_SWEEPS, slots=screw.scene.slots))
    del screw, state, calls

    # gears: three parts on the table, no warm start
    gears, per = part_env("FactoryTaskGears", envs, dev)
    state, _ = gears.reset(4)
    state, calls = run_steps(gears, state, GEARS_STEPS, zeros, ops, per, rollout, "gears")
    on_table = pushing_envs(gears, state, robot=False) | (
        state.physics.contact_impulse.norm(dim=-1) > 0).any(-1)
    log(f"FactoryTaskGears: K = {gears.K}, C = {gears.scene.slots.num_slots}, warm start "
        f"{gears.scene.params.solver.warm_start}: {int(on_table.sum())} of {envs} envs with "
        f"impulses after {GEARS_STEPS} steps")
    if int(on_table.sum()) < envs // 32:
        raise AssertionError("FactoryTaskGears: no contacts to hold the sweep on")
    gsweep = check_sweep(sweep_op, calls["sweep"][0], gears.scene.maps, "FactoryTaskGears",
                         f64=True, dense_sweeps=UNSTABLE_DENSE_SWEEPS, slots=gears.scene.slots)
    if calls["sweep"][0][1].get("apply_warm", True):
        raise AssertionError("FactoryTaskGears: the sweep applied a warm start")
    kern["contact_sweep"]["gears"] = dict(path="FactoryTaskGears (K = 3, apply_warm=False)",
                                          **gsweep)
    kern["sdf_gather"]["gears"] = dict(path="FactoryTaskGears (K = 3)",
                                       **check_sdf(sdf_op, calls["sdf"][0][0]))
    del gears, state, calls
    rec["variants"] = {task: one_iteration(rollout, dev, task, envs)
                       for task in FACTORY_VARIANTS}
    return rec


def industreal_phase(rollout, dev, ops) -> dict:
    """Phase 64 (see the module docstring). Returns the record."""
    import torch

    from handarm_tpu_torch.envs.registry import resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import sdf_gather as sdf_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    task = INDUSTREAL_TASK
    envs = CLASSIC[task][0]
    env, per_step = part_env(task, envs, dev)
    _, over = resolve_task(task, [f"env.num_envs={envs}"])
    ppo = PPO(env, ppo_config(over))
    sc = env.scene
    log(f"{task}: {envs} envs, nv {env.art.nv}, C = {sc.slots.num_slots}, R = "
        f"{sc.shapes.sdf_field.shape[1]}, {sc.params.solver.iterations} sweeps; obs "
        f"{env.num_obs}, teacher obs {env.num_teacher_obs}, actions {env.num_actions}; learner "
        f"hidden {ppo.cfg.hidden}, asymmetric {ppo.cfg.asymmetric_critic}, horizon "
        f"{ppo.cfg.horizon}, {ppo.num_minibatches} minibatches of {ppo.mb_size}; launches per "
        f"step {per_step}")
    rec, _, _ = train_and_serve(rollout, env, ppo, task)
    del ppo

    # the welded plug in the squeezing gripper: a contact state from reset
    state, _ = env.reset(2)
    zeros = lambda i: torch.zeros(envs, 6, device=dev)
    state, calls = run_steps(env, state, IR_SQUEEZE_STEPS, zeros, ops, per_step, rollout,
                             "industreal contact state")
    scores = pushing_envs(env, state, robot=True)
    n_contact = int(scores.sum())
    log(f"{task}: {n_contact} of {envs} envs with the fingers pushing on the plug after "
        f"{IR_SQUEEZE_STEPS} steps")
    if n_contact < envs // 32:
        raise AssertionError(f"{task}: too few envs with the fingers on the plug")
    tag = f"{task} contact state"
    kern = {"spd_inverse": check_spd_craft(spd_op, calls["spd"][0][0][0], dev, tag),
            "contact_sweep": check_sweep(sweep_op, calls["sweep"][0], sc.maps, tag, f64=True,
                                         dense_sweeps=UNSTABLE_DENSE_SWEEPS, slots=sc.slots),
            "sdf_gather": check_sdf(sdf_op, calls["sdf"][0][0])}
    kern["contact_sweep"].update(envs_with_contacts=n_contact,
                                 contacts="the fingers pushing on the plug, the socket pinned")
    rec["kernels"] = kern
    rec["contact_state"] = dict(steps=IR_SQUEEZE_STEPS, envs_with_contacts=n_contact)
    del calls

    # sdf_reward and sapu_scale on the card's plug poses, card vs CPU
    from handarm_tpu_torch.envs.registry import build_env

    env_c = build_env(dataclasses.replace(env.cfg, num_envs=envs), "cpu")
    o = state.physics.objects
    got_r = env.sdf_reward(o.pos[:, 0], o.quat[:, 0])
    got_s, got_pen = env.sapu_scale(o.pos[:, 0], o.quat[:, 0], o.pos[:, 1], o.quat[:, 1])
    oc = tuple(x.cpu() for x in (o.pos, o.quat))
    want_r = env_c.sdf_reward(oc[0][:, 0], oc[1][:, 0])
    want_s, want_pen = env_c.sapu_scale(oc[0][:, 0], oc[1][:, 0], oc[0][:, 1], oc[1][:, 1])
    rewards = {}
    for name, g, w, tol in (("sdf_reward", got_r, want_r, 1e-4), ("sapu", got_s, want_s, 1e-4),
                            ("interpenetration", got_pen, want_pen, 1e-6)):
        e, scale = max_err(g.cpu(), w)
        rewards[name] = dict(err=e, scale=scale, mean=float(w.mean()))
        if not e <= tol * max(1.0, scale):
            raise AssertionError(f"{task}: {name} on the card disagrees with the CPU")
    log(f"{task} rewards at {envs} envs: " + ", ".join(
        f"{k} mean {v['mean']:.4e}, max|gpu-cpu| {v['err']:.3e}" for k, v in rewards.items()))
    rec["rewards"] = rewards
    rec["ref"], _, _ = parts_ref(env, state, scores, dev, "industreal-ref", False)

    # one forced SBC update: every ending episode inserted, the EWMA at 0.9,
    # the counter at its interval
    cfg = env.cfg

    def forced(s):
        n = s.progress.shape[0]
        return s._replace(inserted=torch.ones(n, dtype=torch.bool),
                          progress=torch.full((n,), cfg.episode_length - 1),
                          success_ewma=torch.tensor(0.9), max_disp=torch.tensor(0.01),
                          steps_since_sbc=torch.tensor(cfg.curriculum_interval - 1))

    sbc, sg, scpu = parts_ref(env, state, scores, dev, "industreal-sbc", False, forced)
    moved = (float(sg.max_disp), float(scpu.max_disp))
    log(f"{task} SBC: the bound 0.01 -> {moved[0]:.6f} on the card, {moved[1]:.6f} on the CPU")
    if not (abs(moved[0] - 0.005) <= 1e-6 and moved[0] == moved[1]):
        raise AssertionError(f"{task}: SBC's forced update does not move the bound alike")
    rec["sbc"] = dict(sbc, max_disp=moved)
    return rec


def hand_contact_state(env, task: str, ops):
    """A state of every env with the cube in contact, built by the env's own
    steps (launches per step as `per_step_launches` predicts), the last
    step's kernel calls kept. Trifinger: the scripted grasp
    (`TrifingerEnv.grasp_actions`), GRASP_STEPS toward the cube's faces and
    as many closing on them. AllegroHand, ShadowHand: a reset without
    joint, position or rotation noise, then HAND_SETTLE_STEPS steps holding
    the default joints, the cube coming to rest in the hand. Returns
    (state, [B] bool: the envs whose robot pushes on the cube at the last
    step's end, the kept calls, steps, [B] bool: the envs whose cube lies
    within 2 cm of its start and whose episode went on)."""
    import torch

    B = env.cfg.num_envs
    if task == "Trifinger":
        state, _ = env.reset(2)
        action = lambda st, i: env.grasp_actions(st, close=i >= GRASP_STEPS)
        steps = 2 * GRASP_STEPS
    else:
        d = env.draw(B)
        state, _ = env.reset(2, d._replace(dof=torch.zeros_like(d.dof),
                                           pos=torch.zeros_like(d.pos),
                                           rot=torch.zeros_like(d.rot)))
        hold = env._unscale(env.q_default)
        if hasattr(env, "actuated_idx"):
            hold = hold[env.actuated_idx]
        action = lambda st, i: hold[None].expand(B, -1)
        steps = HAND_SETTLE_STEPS
    start = state.physics.objects.pos[:, 0].clone()
    ended = torch.zeros(B, dtype=torch.bool, device=start.device)
    with Capture(ops, last_only=True) as cap:
        for i in range(steps):
            cap.armed = i == steps - 1
            state, res = env.step(state, action(state, i))
            ended |= res.done
    slots = env.scene.slots
    robot_obj = torch.as_tensor((slots.robot_body >= 0) & (slots.obj_b == 0),
                                device=start.device)
    pushed = state.physics.contact_impulse.norm(dim=-1) > 0
    rest = ~ended & ((state.physics.objects.pos[:, 0] - start).norm(dim=-1) < 0.02)
    return state, (pushed & robot_obj).any(-1), cap.calls, steps, rest


def hand_phase(rollout, dev, ops, task: str) -> dict:
    """Phases 57-59 (Trifinger, AllegroHand, ShadowHand): the task composed
    as train.py composes it at IsaacGymEnvs' 16384 envs, on the in-repo
    stand-ins, its learner at full width from a fresh init and
    HAND_SERVE_STEPS + 1 deterministic serving steps through `PPO.act`
    (`train_and_serve`); then the built contact state
    (`hand_contact_state`: at least 1/32 of the envs' robots pushing on the
    cube; the hands' cubes at rest counted), where spd_inverse (n = 9, 16,
    24, to n cond eps), the sweep (captured, dense and robot cases, against
    float64) and, where B * C >= 2^21 (the hands), prep_deff are held
    against their plain versions, timed beside their bounds and their
    library calls; then card vs CPU at 16 of those envs
    (`contact_state_ref`). ShadowHand adds one train iteration of
    each OPENAI task (`one_iteration`). Returns the record."""
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import prep_deff as deff_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    envs = CLASSIC[task][0]
    cfg, over = resolve_task(task, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    ppo = PPO(env, ppo_config(over))
    per_step = per_step_launches(env)
    sc = env.scene
    C = sc.slots.num_slots
    log(f"{task}: {envs} envs, nv {env.art.nv}, C = {C} contact slots (B x C = {envs * C}), "
        f"K = {sc.shapes.num_objects}, {sc.spheres.body.shape[0]} robot spheres, "
        f"{sc.geom.num_walls} walls, obs {env.num_obs}, actions {env.num_actions}; the "
        f"cube {float(sc.shapes.mass[0]):.4f} kg, the robot's moving bodies "
        f"{float(sc.model.mass.sum()):.3f} kg; learner hidden {ppo.cfg.hidden}, horizon "
        f"{ppo.cfg.horizon}, {ppo.num_minibatches} minibatches of {ppo.mb_size}; launches "
        f"per step {per_step}")
    rec, ts, _ = train_and_serve(rollout, env, ppo, task, HAND_SERVE_STEPS)

    rollout.reset_launch_counts()
    kept, scores, calls, steps, rest = hand_contact_state(env, task, ops)
    check_launches(rollout.launch_counts(), per_step, steps, f"{task} contact state")
    finite_state(tree_map, kept, env._obs(kept))
    n_contact, n_rest = int(scores.sum()), int(rest.sum())
    log(f"{task}: {n_contact} of {envs} envs with the robot pushing on the cube at the "
        f"contact state's last step (built in {steps} steps); {n_rest} with the cube within "
        f"2 cm of its start and no episode ended")
    if n_contact < envs // 32 or (task != "Trifinger" and n_rest < envs // 2):
        raise AssertionError(f"{task}: too few envs with the cube in contact or at rest")
    tag = f"{task} contact state"
    kern = {"spd_inverse": check_spd_craft(spd_op, calls["spd"][0][0][0], dev, tag),
            "contact_sweep": check_sweep(sweep_op, calls["sweep"][0], sc.maps, tag, f64=True)}
    kern["contact_sweep"].update(envs_with_contacts=n_contact, contacts="the robot on the cube")
    if bool(per_step["prep_deff"]) != ("deff" in calls):
        raise AssertionError(f"{task}: prep_deff calls do not match the gate")
    if "deff" in calls:
        kern["prep_deff"] = check_deff(deff_op, calls["deff"][0][0])
    rec["kernels"] = kern
    rec["contact_state"] = dict(steps=steps, envs_with_contacts=n_contact, envs_at_rest=n_rest)
    del calls
    rec["ref"] = contact_state_ref(task, ppo, ts, dev, kept, scores)
    if task == "ShadowHand":
        del env, ppo, ts, kept
        rec["openai"] = {t: one_iteration(rollout, dev, t, OPENAI[t]) for t in OPENAI}
    return rec


def one_iteration(rollout, dev, task: str, envs: int) -> dict:
    """One train iteration of a task as train.py composes it at `envs` envs
    from a fresh init, timed: launches exactly `per_step_launches` x
    horizon; params, stats and every state leaf finite (the asymmetric
    ShadowHand tasks: the 42-dim actor observation, the 211-dim state as
    the critic's; ShadowHandOpenAI_FF's 400-400-200-100 MLP, _LSTM's LSTM
    1024 actor and critic with seq_len 4; AllegroKukaRegrasping and
    AllegroKukaThrow: 99 observations, the 768-512-256 MLP)."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config

    cfg, over = resolve_task(task, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    ppo = PPO(env, ppo_config(over))
    c = ppo.cfg
    per_iter = {k: v * c.horizon for k, v in per_step_launches(env).items()}
    ts = ppo.init(0)
    rollout.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, stats = ppo.train_iter(ts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = rollout.launch_counts()
    check_launches(counts, per_iter, 1, f"{task} iteration")
    check_learner(ts, task)
    finite_state(tree_map, ts.env_state, ts.last_obs)
    sps = envs * c.horizon / seconds
    log(f"{task}: {envs} envs, obs {env.num_obs}, critic obs {env.num_teacher_obs}; hidden "
        f"{c.hidden}, LSTM {c.rnn_units} / {c.critic_rnn_units}, seq_len {c.seq_len}, "
        f"horizon {c.horizon}, {ppo.num_minibatches} minibatches; one train iteration from a "
        f"fresh init in {seconds:.3f} s ({sps:.0f} env-steps/s, first-call costs "
        f"included); reward_mean {float(stats['reward_mean']):.5f}; launches {counts}")
    return dict(envs=envs, horizon=c.horizon, hidden=list(c.hidden), rnn_units=c.rnn_units,
                critic_rnn_units=c.critic_rnn_units, seconds=seconds, env_steps_per_s=sps,
                launches=counts, launches_per_iteration=per_iter)


def dextreme_phase(rollout, dev, ops) -> dict:
    """Phase 60 (AllegroHandDextremeADR): the task composed as train.py
    composes it at IsaacGymEnvs' 8192 envs on the Allegro stand-in (ADR over
    the observation noise, action noise and RNA weight; the LSTM 512 before
    a 512-512 MLP, seq_len 16), one train iteration timed from a fresh
    init, then HAND_SERVE_STEPS + 1 deterministic serving steps through
    `PPO.act` with the carry threaded (`serve_window`); launches exactly 2 /
    4 / 0 / 0 a step (the inner hand's two sim steps; B x C = 8192 x 150
    keeps prep_deff's gate shut); ADR's ranges within their limits, every
    env's values within its ranges, the RNA weight in [0, 0.4]; one more
    serving step, its second spd_inverse call (n = 16, B = 8192) held
    against the plain version to n cond eps and timed (`check_spd_craft`;
    the sweep is held by allegro-hand); then card vs CPU (`dextreme_ref`).
    Returns the record."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    envs, iters = CLASSIC[DEXTREME_TASK]
    cfg, over = resolve_task(DEXTREME_TASK, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    ppo = PPO(env, ppo_config(over))
    per_step = per_step_launches(env)
    c = ppo.cfg
    log(f"{DEXTREME_TASK}: {envs} envs, nv {env.art.nv}, C = {env.scene.slots.num_slots} "
        f"contact slots (B x C = {envs * env.scene.slots.num_slots}), obs {env.num_obs}, "
        f"actions {env.num_actions}; ADR {cfg.adr.names}, limits {cfg.adr.limit_hi}; learner "
        f"hidden {c.hidden}, LSTM {c.rnn_units}, seq_len {c.seq_len}, zero_rnn_on_done "
        f"{c.zero_rnn_on_done}, horizon {c.horizon}, {ppo.num_minibatches} minibatches of "
        f"{ppo.mb_size}; launches per step {per_step}")
    if per_step != {"spd_inverse": 2, "contact_sweep": 4, "prep_deff": 0, "sdf_gather": 0}:
        raise AssertionError(f"{DEXTREME_TASK}: launches per step {per_step}")
    per_iter = {k: v * c.horizon for k, v in per_step.items()}
    rec, ts = timed_iterations(rollout, ppo, ts=ppo.init(0), n=iters, per_iter=per_iter,
                               tag=f"{DEXTREME_TASK} train", warmup=False)
    rec["serve"], state = serve_window(rollout, env, ppo, ts, HAND_SERVE_STEPS, per_step,
                                       DEXTREME_TASK)
    finite_state(tree_map, state, state.obs)
    adr, a = state.adr, cfg.adr
    lim = lambda x: torch.tensor(x, device=dev)
    ranges_ok = bool(((adr.lo >= lim(a.limit_lo)) & (adr.lo <= lim(a.init_lo))
                      & (adr.hi >= lim(a.init_hi)) & (adr.hi <= lim(a.limit_hi))).all())
    values_ok = bool(((adr.values >= adr.lo) & (adr.values <= adr.hi)).all())
    alpha = adr.values[:, 2]
    log(f"{DEXTREME_TASK}: ADR lo {adr.lo.tolist()}, hi {adr.hi.tolist()}, queues "
        f"{adr.q_cnt.tolist()}; boundary workers {int((adr.worker_mode >= 0).sum())} of "
        f"{envs}; RNA weight in [{float(alpha.min()):.4f}, {float(alpha.max()):.4f}]; every "
        "state leaf finite")
    if not (ranges_ok and values_ok and float(alpha.min()) >= 0.0
            and float(alpha.max()) <= a.limit_hi[2]):
        raise AssertionError(f"{DEXTREME_TASK}: ADR ranges or values out of their limits")
    rec["adr"] = dict(lo=adr.lo.tolist(), hi=adr.hi.tolist(),
                      boundary_workers=int((adr.worker_mode >= 0).sum()))
    rollout.reset_launch_counts()
    with Capture(ops, last_only=True) as cap:
        cap.armed = True
        env.step(state, torch.zeros(envs, env.num_actions, device=dev))
    check_launches(rollout.launch_counts(), per_step, 1, f"{DEXTREME_TASK} kernel step")
    rec["kernels"] = {"spd_inverse": check_spd_craft(
        spd_op, cap.calls["spd"][0][0][0], dev, f"{DEXTREME_TASK} serving state")}
    del cap
    rec["ref"] = dextreme_ref(ppo, ts, dev)
    return rec


def rna_agreement(env_g, env_c, state_g, state_c) -> dict:
    """The adversary's binned logits on the card against the CPU's on the same
    observations and masks (within 1e-4 of their largest magnitude), its
    decoded actions equal wherever a channel's two largest logits lie more
    than 1e-4 of that magnitude apart; near-ties and the channels decoded
    apart counted."""
    import torch

    from handarm_tpu_torch.learn import rna

    lg = rna.rna_logits(env_g.rna_params, state_g.rna, state_g.obs).cpu()
    lc = rna.rna_logits(env_c.rna_params, state_c.rna, state_c.obs)
    scale = float(lc.abs().max())
    top = torch.topk(lc, 2, dim=-1).values
    ties = (top[..., 0] - top[..., 1]) <= 1e-4 * scale
    apart = rna.rna_decode(lg) != rna.rna_decode(lc)
    err = float((lg - lc).abs().max())
    if err > 1e-4 * scale or bool((apart & ~ties).any()):
        raise AssertionError("dextreme-ref: the adversary's logits or actions disagree")
    return dict(logit_err=err, scale=scale, near_ties=int(ties.sum()),
                decoded_apart=int(apart.sum()), channels=ties.numel())


def dextreme_ref(ppo, ts, dev) -> dict:
    """Card vs CPU at 16 envs: 2 control steps from a fresh reset with ADR's
    ranges opened to hi = DEXTREME_REF_HI and values drawn in them (so the
    noise and the adversary act), the trained learner's deterministic
    actions (its carry threaded, on the CPU) and the same draws on both
    sides (the inner hand's, ADR's, the masks' uniforms, both noises): q
    and the cube within 2e-4, observations within 2e-3, each times max(1,
    the CPU value's largest); done flags, ADR's modes and the masks
    exactly, its values within 1e-6; the adversary held by
    `rna_agreement` before each step."""
    import torch

    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO

    cfg, _ = resolve_task(DEXTREME_TASK, ["env.num_envs=16"])
    env_c, env_g = build_env(cfg, "cpu"), build_env(cfg, dev)
    if not all(torch.equal(getattr(env_c.rna_params, k), getattr(env_g.rna_params, k).cpu())
               for k in ("w1", "w2", "w3")):
        raise AssertionError("dextreme-ref: the adversaries' weights differ")
    to = lambda x, d: tree_map(lambda t: t.to(d), x)
    learner = PPO(env_c, ppo.cfg, device="cpu")
    ts_c = ts._replace(params={k: v.cpu() for k, v in ts.params.items()},
                       obs_stats=to(ts.obs_stats, "cpu"))
    state_c, obs_c = env_c.reset(3)
    gen = torch.Generator().manual_seed(4)
    hi = torch.tensor(DEXTREME_REF_HI)
    state_c = state_c._replace(adr=state_c.adr._replace(
        hi=hi, values=torch.rand(16, 3, generator=gen) * hi))
    state_g = to(state_c, dev)
    hidden, rna_rec = None, []
    for _ in range(2):
        rna_rec.append(rna_agreement(env_g, env_c, state_g, state_c))
        a, hidden = learner.act(ts_c, obs_c, True, hidden)
        d = env_c.draw(16)
        state_c, res_c = env_c.step(state_c, a, d)
        state_g, res_g = env_g.step(state_g, a.to(dev), to(d, dev))
        obs_c, obs_g = res_c.obs, res_g.obs
        if not torch.equal(res_g.done.cpu(), res_c.done):
            raise AssertionError("dextreme-ref: done flags differ")
    rec = {}
    for name, g, c, tol in (("obs", obs_g, obs_c, 2e-3),
                            ("q", state_g.inner.physics.robot.q,
                             state_c.inner.physics.robot.q, 2e-4),
                            ("object_pos", state_g.inner.physics.objects.pos,
                             state_c.inner.physics.objects.pos, 2e-4)):
        scale = max(1.0, float(c.abs().max()))
        rec[name] = dict(err=float((g.cpu() - c).abs().max()), scale=scale, tol=tol * scale)
    same = (torch.equal(state_g.adr.worker_mode.cpu(), state_c.adr.worker_mode)
            and torch.equal(state_g.rna.mask1.cpu(), state_c.rna.mask1)
            and torch.equal(state_g.rna.mask2.cpu(), state_c.rna.mask2)
            and float((state_g.adr.values.cpu() - state_c.adr.values).abs().max()) <= 1e-6)
    log(f"dextreme-ref: 16 envs, 2 steps; " + ", ".join(
        f"max|{k} gpu-cpu| {v['err']:.3e} (scale {v['scale']:.3e})" for k, v in rec.items())
        + f"; ADR modes, values and masks {'alike' if same else 'DIFFERENT'}; adversary "
        f"near-ties {[r['near_ties'] for r in rna_rec]} of {rna_rec[0]['channels']} channels, "
        f"decoded apart {[r['decoded_apart'] for r in rna_rec]}")
    if not (same and all(v["err"] <= v["tol"] for v in rec.values())):
        raise AssertionError("the card's run disagrees with the CPU reference (dextreme-ref)")
    return dict(rec, rna=rna_rec)


def kuka_contact_state(env, ops):
    """A state of every env with its active object resting on the back of the
    Allegro's fingers: a reset with the task's joint noise (no velocity or
    object noise: the mass matrices differ env by env), each env's active
    object set level 1 mm over the robot's spheres under its footprint,
    centred over the index, middle and ring fingers' middle and distal
    links of one hand (on two arms, env b's arm b % 2); then
    KUKA_SETTLE_STEPS steps holding those joints (the arms' actions zero,
    the hands' their reset joints' targets), the last step's kernel calls
    kept. Returns (state, [B] bool: the envs whose robot pushes on their
    active object at the last step's end, the kept calls, steps, [B] bool:
    the envs whose object lies within 2 cm of where it was set and whose
    episode went on, [arms] the envs whose robot pushes on the object with
    each arm's slots)."""
    import torch

    from handarm_tpu_torch.math.quat import quat_rotate
    from handarm_tpu_torch.physics.kinematics import forward_kinematics

    B, dev, sc = env.cfg.num_envs, env.device, env.scene
    d = env.draw(B)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(B, 4)
    state, _ = env.reset(2, d._replace(dof_vel=torch.zeros_like(d.dof_vel),
                                       obj=d.obj._replace(pos=torch.zeros_like(d.obj.pos),
                                                          rot=ident)))
    q0 = state.physics.robot.q
    fk = forward_kinematics(sc.model, state.physics.robot.q, sc.base_quat[None],
                            sc.base_pos[None])
    body = torch.as_tensor(sc.spheres.body, device=dev)
    ctr = fk.body_pos[:, body] + quat_rotate(fk.body_quat[:, body], sc.spheres.offset[None])
    names, arms = env.art.body_names, env.arms
    arm_of = lambda b: max(k for k, p in enumerate(arms) if names[b].startswith(p))
    sph_arm = torch.as_tensor([arm_of(b) for b in sc.spheres.body], device=dev)
    finger = torch.as_tensor([names[b][len(arms[arm_of(b)]):].split("_link_")[0]
                              in ("index", "middle", "ring") and names[b][-1] in "23"
                              for b in sc.spheres.body], device=dev)
    env_arm = torch.arange(B, device=dev) % len(arms)
    under = (finger[None] & (sph_arm[None] == env_arm[:, None])).float()  # [B, S]
    xy = (ctr[..., :2] * under[..., None]).sum(1) / under.sum(1, keepdim=True)  # [B, 2]
    slot = env.active(B)
    half = env.obj_halves[slot]
    # the lowest level box over every sphere: a sphere at horizontal distance
    # d < r from the footprint reaches up to its centre's z + sqrt(r^2 - d^2)
    r = sc.spheres.radius[None]
    gap = torch.clamp((ctr[..., :2] - xy[:, None]).abs() - half[:, None, :2], min=0.0)
    d2 = (gap ** 2).sum(-1)
    top = torch.where(d2 < r ** 2, ctr[..., 2] + torch.sqrt(torch.clamp(r ** 2 - d2, min=0.0)),
                      -1.0).amax(-1)
    i = torch.arange(B, device=dev)
    o = state.physics.objects
    pos, quat = o.pos.clone(), o.quat.clone()
    pos[i, slot] = torch.cat([xy, (top + half[:, 2] + 0.001)[:, None]], -1)
    quat[i, slot] = ident
    start = pos[i, slot].clone()
    state = state._replace(physics=state.physics._replace(objects=o._replace(
        pos=pos, quat=quat, linvel=torch.zeros_like(o.linvel),
        angvel=torch.zeros_like(o.angvel))))
    # per arm block, the arm's 7 actions zero and the hand's 16 its joints'
    hand = 2.0 * (q0 - env.q_lo) / (env.q_hi - env.q_lo) - 1.0
    is_arm = (torch.arange(env.art.nv, device=dev) % 23) < 7
    hold = torch.where(is_arm, 0.0, hand)
    ended = torch.zeros(B, dtype=torch.bool, device=dev)
    with Capture(ops, last_only=True) as cap:
        for k in range(KUKA_SETTLE_STEPS):
            cap.armed = k == KUKA_SETTLE_STEPS - 1
            state, res = env.step(state, hold)
            ended |= res.done
    slots = sc.slots
    rb = torch.as_tensor(slots.robot_body >= 0, device=dev)
    ob = torch.as_tensor(slots.obj_b, device=dev)
    on_active = rb[None] & (ob[None] == slot[:, None])  # [B, C]
    pushed = (state.physics.contact_impulse.norm(dim=-1) > 0) & on_active
    rest = ~ended & ((state.physics.objects.pos[i, slot] - start).norm(dim=-1) < 0.02)
    slot_arm = torch.as_tensor([arm_of(b) if b >= 0 else -1 for b in slots.robot_body],
                               device=dev)
    per_arm = [int((pushed & (slot_arm == k)[None]).any(-1).sum()) for k in range(len(arms))]
    return state, pushed.any(-1), cap.calls, KUKA_SETTLE_STEPS, rest, per_arm


def dense_spd(n: int, B: int, dev):
    """[B, n, n] well-conditioned SPD matrices with every entry set (A A^T /
    n + I, A standard normal from a fixed seed): the off-block entries a
    block-diagonal scene never gives."""
    import torch

    g = torch.Generator(device=dev).manual_seed(46)
    A = torch.randn(B, n, n, generator=g, device=dev)
    return torch.bmm(A, A.transpose(1, 2)) / n + torch.eye(n, device=dev)


def allegro_kuka_phase(rollout, dev, ops, task: str) -> dict:
    """Phases 61 (AllegroKukaReorientation) and 62
    (AllegroKukaTwoArmsReorientation): the task composed as train.py
    composes it at IsaacGymEnvs' 8192 envs on the KUKA iiwa 7 + Allegro
    stand-in (nv 23, 298 contact slots) or two of them facing each other
    (nv 46, 506 slots), three box slots, its 768-512-256 learner, one
    train iteration timed from a fresh init and HAND_SERVE_STEPS + 1
    deterministic serving steps (`train_and_serve`: launches exactly 1 / 2
    / 1 / 0 a step, B x C opening prep_deff's gate); then the built
    contact state (`kuka_contact_state`: at least 1/32 of the envs pushing
    on their object with each arm; on two arms even envs rest it on arm 0's
    fingers, odd envs on arm 1's), where spd_inverse (`check_spd_craft`;
    on two arms also `check_spd` on a dense batch: the scene's matrices
    are block-diagonal, the arms sharing no link), the sweep (captured,
    dense and robot cases, against float64) and prep_deff are held
    against their plain versions, timed beside their bounds and their
    library calls; card vs CPU at 16 of those envs (`contact_state_ref`);
    then one train iteration of each of the task's other variants
    (`one_iteration`). Returns the record."""
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.registry import build_env, resolve_task
    from handarm_tpu_torch.learn.ppo import PPO, ppo_config
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import prep_deff as deff_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    envs = CLASSIC[task][0]
    cfg, over = resolve_task(task, [f"env.num_envs={envs}"])
    env = build_env(cfg, dev)
    ppo = PPO(env, ppo_config(over))
    per_step = per_step_launches(env)
    sc = env.scene
    C = sc.slots.num_slots
    log(f"{task}: {envs} envs, nv {env.art.nv}, C = {C} contact slots (B x C = "
        f"{envs * C}), {sc.maps.groups.link_bits.shape[0]} dof masks, K = "
        f"{sc.shapes.num_objects}, {sc.spheres.body.shape[0]} robot spheres, obs "
        f"{env.num_obs}, actions {env.num_actions}; the robot's moving bodies "
        f"{float(sc.model.mass.sum()):.3f} kg; learner hidden {ppo.cfg.hidden}, horizon "
        f"{ppo.cfg.horizon}, {ppo.num_minibatches} minibatches of {ppo.mb_size}; launches "
        f"per step {per_step}")
    if per_step != {"spd_inverse": 1, "contact_sweep": 2, "prep_deff": 1, "sdf_gather": 0}:
        raise AssertionError(f"{task}: launches per step {per_step}")
    rec, ts, _ = train_and_serve(rollout, env, ppo, task)

    rollout.reset_launch_counts()
    kept, scores, calls, steps, rest, per_arm = kuka_contact_state(env, ops)
    check_launches(rollout.launch_counts(), per_step, steps, f"{task} contact state")
    finite_state(tree_map, kept, env._obs(kept))
    n_contact, n_rest = int(scores.sum()), int(rest.sum())
    log(f"{task}: {n_contact} of {envs} envs with the robot pushing on its object at the "
        f"contact state's last step (built in {steps} steps), by arm {per_arm}; {n_rest} "
        "with the object within 2 cm of where it was set and no episode ended")
    if min(per_arm) < envs // 32:
        raise AssertionError(f"{task}: too few envs with the object in contact on an arm")
    tag = f"{task} contact state"
    kern = {"spd_inverse": check_spd_craft(spd_op, calls["spd"][0][0][0], dev, tag),
            "contact_sweep": check_sweep(sweep_op, calls["sweep"][0], sc.maps, tag, f64=True),
            "prep_deff": check_deff(deff_op, calls["deff"][0][0])}
    if len(env.arms) > 1:
        kern["spd_inverse"]["dense"] = check_spd(spd_op, dense_spd(env.art.nv, envs, dev), dev,
                                                 f"{task} dense SPD batch")
    kern["contact_sweep"].update(envs_with_contacts=n_contact, envs_by_arm=per_arm,
                                 contacts="the robot on the object resting on its fingers")
    rec["kernels"] = kern
    rec["contact_state"] = dict(steps=steps, envs_with_contacts=n_contact,
                                envs_by_arm=per_arm, envs_at_rest=n_rest)
    del calls
    rec["ref"] = contact_state_ref(task, ppo, ts, dev, kept, scores)
    del env, ppo, ts, kept
    rec["variants"] = {t: one_iteration(rollout, dev, t, envs) for t in KUKA_TASKS[task]}
    return rec


def spd_instances(entry: dict) -> list:
    """Each compiled n of the spd_inverse kernel (`KERNEL_N`), its layout
    (a thread, a warp or a block of two warps per matrix; the warp and
    block layouts' shared row stride) and the records of this run that
    held it against the plain version."""
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    held = {}

    def walk(rec, path):
        if isinstance(rec, dict):
            if "n" in rec and "max_abs_err" in rec:
                held.setdefault(rec["n"], []).append(path)
            for k, v in rec.items():
                walk(v, f"{path}/{k}")

    walk(entry, "spd_inverse")
    layout = lambda n: "block" if n > 32 else "warp" if n > 18 else "thread"
    out = [dict(n=n, layout=layout(n), row_stride=n | 1 if n > 18 else None,
                held_on=held.get(n, [])) for n in spd_op.KERNEL_N]
    missing = [x["n"] for x in out if not x["held_on"]]
    if missing:
        raise AssertionError(f"spd_inverse instances held by no check: {missing}")
    return out


def classic_phases(rollout, dev, ops) -> tuple:
    """Phases 45-64: (their record, each kernel's classic record)."""
    rec, kernels = {}, {}
    for task, ref in (("Quadcopter", "quad-ref"), ("Ingenuity", None)):
        name = "quad" if task == "Quadcopter" else "ingenuity"
        with phase(name):
            rec[task], ppo, ts = classic_phase(rollout, dev, ops, task)
            if ref is None:  # Ingenuity's card-vs-CPU ref inside its phase
                rec[task]["ref"] = classic_ref(task, ppo, ts, dev)
        if ref is not None:
            with phase(ref):
                rec[task]["ref"] = classic_ref(task, ppo, ts, dev)
        del ppo, ts
    for task in ("Ant", "Humanoid", "Cartpole"):
        with phase(task.lower()):
            rec[task] = locomotion_phase(rollout, dev, ops, task)
    for task, name in zip(CONTACT_TASKS, ("ball-balance", "anymal", "anymal-terrain")):
        with phase(name):
            rec[task] = contact_task_phase(rollout, dev, ops, task)
    for task, name in zip(FRANKA_TASKS, ("franka-cube-stack", "franka-cabinet")):
        with phase(name):
            rec[task] = franka_phase(rollout, dev, ops, task)
    for task, name in zip(HAND_TASKS, ("trifinger", "allegro-hand", "shadow-hand")):
        with phase(name):
            rec[task] = hand_phase(rollout, dev, ops, task)
    with phase("dextreme"):
        rec[DEXTREME_TASK] = dextreme_phase(rollout, dev, ops)
    for task, name in zip(KUKA_TASKS, ("allegro-kuka", "allegro-kuka-two-arms")):
        with phase(name):
            rec[task] = allegro_kuka_phase(rollout, dev, ops, task)
    with phase("factory"):
        rec[FACTORY_TASK] = factory_phase(rollout, dev, ops)
    with phase("industreal"):
        rec[INDUSTREAL_TASK] = industreal_phase(rollout, dev, ops)
    for task in CLASSIC:
        per_iter = rec[task]["launches_per_iteration"]
        for k in per_iter:
            entry = dict(path=f"{task} at {CLASSIC[task][0]} envs",
                         launches_per_iteration=per_iter[k],
                         launches_serve=rec[task]["serve"]["launches"][k])
            entry.update(rec[task]["kernels"].get(k, {}))
            kernels.setdefault(k, {})[task] = entry
    with phase("classic-entry"):
        from handarm_tpu_torch.envs.allegro_kuka import AKState
        from handarm_tpu_torch.envs.anymal_terrain import ATState
        from handarm_tpu_torch.envs.classic import ClassicState
        from handarm_tpu_torch.envs.dexhand import DexState
        from handarm_tpu_torch.envs.dextreme import DextremeState
        from handarm_tpu_torch.envs.franka_cabinet import CabinetState
        from handarm_tpu_torch.envs.quadcopter import QuadState

        rec["entry_point"] = {task: classic_entry(rollout, dev, task, state_type)
                              for task, state_type in (
                                  ("Quadcopter", QuadState), ("Cartpole", ClassicState),
                                  ("AnymalTerrain", ATState), ("FrankaCabinet", CabinetState),
                                  ("AllegroHand", DexState))}
        rec["entry_point"]["AllegroHandManualDR"] = classic_entry(
            rollout, dev, "AllegroHandManualDR", DextremeState)
        rec["entry_point"]["AllegroKuka env.subtask=throw"] = classic_entry(
            rollout, dev, "AllegroKuka", AKState, extra=["env.subtask=throw"])
        rec["entry_point"]["AllegroKukaTwoArms env.subtask=regrasping"] = classic_entry(
            rollout, dev, "AllegroKukaTwoArms", AKState, extra=["env.subtask=regrasping"])
        from handarm_tpu_torch.envs.factory import FactoryState

        rec["entry_point"]["FactoryTaskNutBoltScrew"] = classic_entry(
            rollout, dev, "FactoryTaskNutBoltScrew", FactoryState)
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


DDP_RANKS = 2  # gloo ranks sharing the card
DDP_ENTRY_ITERS = 1  # iterations of the train entry point under torchrun
DDP_TOLS = {"first-step param": 1e-5, "first-step grad": 1e-5, "loss terms": 1e-4,
            "stats": 1e-5}
PBT_ENVS = 2048
AL_ENVS, AL_ACTORS, AL_ITERS, AL_QUEUE = 4096, 2, 2, 1


def ddp_rank(group, path: str) -> dict:
    """One rank of the ddp phase (a spawned process): `_update_from_traj` of
    its 4,096 envs of the captured trajectory with the shared permutations,
    recording every minibatch step; `assert_sharded` on the result. Rank 0
    then holds its update against the one-process data_shards=2 update of
    the whole trajectory on the card, step by step from its own inputs
    (`ddp_check`)."""
    from types import SimpleNamespace

    import torch

    from handarm_tpu_torch.learn.ppo import PPO, Transition
    from handarm_tpu_torch.parallel.mesh import assert_sharded

    blob = torch.load(path, map_location=group.device, weights_only=False)
    cfg, ts, traj, last_obs, perms = (blob[k] for k in ("cfg", "ts", "traj", "last_obs",
                                                         "perms"))
    B = last_obs.shape[0]

    def stub(n):
        return SimpleNamespace(num_obs=last_obs.shape[1], num_actions=traj.action.shape[-1],
                               cfg=SimpleNamespace(num_envs=n), device=group.device)

    ppo = PPO(stub(B // group.world_size), cfg, group=group)
    rec = dict(prepared=[], averaged=[], steps=[])
    prepare, average, mb_step = ppo._prepare, ppo._average, ppo._mb_step

    def recorded(fn, key, keep_args=False):
        def wrapped(*args):
            out = fn(*args)
            rec[key].append((args, out) if keep_args else out)
            return out
        return wrapped

    ppo._prepare = recorded(prepare, "prepared")
    ppo._average = recorded(average, "averaged")
    ppo._mb_step = recorded(mb_step, "steps", keep_args=True)
    sl = group.env_slice(B)
    local = Transition(*(None if x is None else x[:, sl].contiguous() for x in traj))
    sync = torch.cuda.synchronize if group.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    new, stats = ppo._update_from_traj(ts, local, None, last_obs[sl].contiguous(), perms=perms)
    sync()
    out = dict(update_s=time.perf_counter() - t0, sharding=assert_sharded(group, new),
               collectives={f"{op} {tag}": n for (op, tag), n in group.counts.items()},
               stats={k: float(v) for k, v in stats.items()}, steps=len(rec["steps"]))
    if group.rank == 0:
        out["check"] = ddp_check(stub(B), cfg, ts, traj, last_obs, perms, rec, B // 2)
    return out


def ddp_check(stub, cfg, ts, traj, last_obs, perms, rec, half: int) -> dict:
    """Rank 0's update against the one-process data_shards=2 update of the
    whole trajectory, on the card:
    - the prepared stats (observation and value) within 1e-5 of scale, the
      normalized advantages of rank 0's samples within 1e-5 absolute (unit
      spread: the ranks' two-pass global moments against one mean and var);
    - every minibatch step from rank 0's inputs (params, Adam state, lr):
      the averaged loss terms and KL against the one-process minibatch's
      within 1e-4 relative plus 1e-6; the averaged gradients of the first
      step within 1e-5 of each tensor's scale (later steps' reported: a
      sample within rounding of a clip edge may switch its term on one
      side); the optimizer step from rank 0's averaged gradients
      bit-identical to the one-process `_apply` of the same inputs (lr,
      Adam and counters alike);
    - the first minibatch step's params, each tensor within 1e-5 of its
      scale of the one-process step's."""
    import torch

    from handarm_tpu_torch.learn.ppo import PPO

    one = PPO(stub, cfg)
    data, obs_stats, value_stats, _ = one._prepare(ts, traj, last_obs)
    r_data, r_obs, r_value, _ = rec["prepared"][0]
    worst = {k: 0.0 for k in DDP_TOLS}
    worst["later grad"] = 0.0

    def hold(kind, got, want, name, atol=0.0):
        err, scale = max_err(got, want)
        frac = err / max(scale, 1e-30)
        if kind == "later grad":
            worst[kind] = max(worst[kind], frac)
            return
        allowed = DDP_TOLS[kind] * scale + atol
        worst[kind] = max(worst[kind], err / allowed)
        if not err <= allowed:
            raise AssertionError(f"ddp: rank 0 and one process differ on {kind} {name}: "
                                 f"{err:.3e} at scale {scale:.3e}")

    for tag, a, b in (("obs", r_obs, obs_stats), ("value", r_value, value_stats)):
        for f, x, y in zip(a._fields, a, b):
            hold("stats", x, y, f"{tag} {f}")
    n_loc = half * cfg.horizon
    adv_err = float((r_data["adv"] - data["adv"][:n_loc]).abs().max())
    if not adv_err <= 1e-5:
        raise AssertionError(f"ddp: rank 0's normalized advantages {adv_err:.3e} apart")
    rows = one.minibatch_rows(perms)
    stats_in = (ts.obs_stats, ts.teacher_obs_stats)
    grad_dev = []
    for k, ((st, params, opt, lr, _), (p_out, o_out, l_out, _)) in enumerate(rec["steps"]):
        g_avg, aux_avg = rec["averaged"][k]
        mb = {key: v.index_select(0, rows[k]) for key, v in data.items()}
        g_one, aux_one = one._grads(stats_in, params, mb)
        for name in aux_one:
            hold("loss terms", aux_avg[name], aux_one[name], name, atol=1e-6)
        grad_dev.append(max(max_err(g_avg[n], g_one[n])[0]
                            / max(max_err(g_avg[n], g_one[n])[1], 1e-30) for n in g_one))
        for name in g_one:
            hold("first-step grad" if k == 0 else "later grad", g_avg[name], g_one[name], name)
        p_same, o_same, l_same = one._apply(params, opt, lr, g_avg, aux_avg["kl"])
        same = (all(torch.equal(p_same[n], p_out[n]) for n in p_out)
                and all(torch.equal(a, b) for a, b in zip(o_same[:4], o_out[:4]))
                and all(torch.equal(o_same.mu[n], o_out.mu[n])
                        and torch.equal(o_same.nu[n], o_out.nu[n]) for n in p_out)
                and torch.equal(l_same, l_out))
        if not same:
            raise AssertionError(f"ddp: step {k}: the rank's optimizer step is not the "
                                 "one-process step of its averaged gradients")
        if k == 0:
            p_one, _, _ = one._apply(params, opt, lr, g_one, aux_one["kl"])
            for name in p_one:
                hold("first-step param", p_out[name], p_one[name], name)
    return dict(worst=worst, grad_dev=grad_dev, adv_err=adv_err)


def ddp_phase(rollout, dev) -> dict:
    """Phase 42 (see the module docstring)."""
    import contextlib as cl
    import io

    import numpy as np
    import torch

    from handarm_tpu_torch import graft_entry, train
    from handarm_tpu_torch.envs.tasks import make_env, ppo_overrides
    from handarm_tpu_torch.learn.ppo import PPO, PPOConfig
    from handarm_tpu_torch.parallel.launch import spawn
    from handarm_tpu_torch.utils.checkpoint import (load_train_state, read_leaves,
                                                    wait_for_pending_saves)

    out_dir = os.path.join("runs", "chip_smoke_ddp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ckpt = rollout.TASK_CKPTS["Ur5SihLift"]
    env = make_env("Ur5SihLift", device=dev, num_envs=ENVS)
    cfg = PPOConfig(**ppo_overrides("Ur5SihLift"), data_shards=DDP_RANKS)
    ppo = PPO(env, cfg)
    fresh = ppo.init(0)
    start = load_train_state(ckpt, dev, fresh.env_state, fresh.last_obs)
    r = ppo.rollout(start)
    perms = ppo.draw_perms(dev)
    n_steps = ppo.num_minibatches * cfg.mini_epochs
    path = os.path.join(out_dir, "capture.pt")
    torch.save(dict(cfg=cfg, ts=start._replace(env_state=None, last_obs=None), traj=r.traj,
                    last_obs=r.last_obs, perms=perms), path)
    del env, ppo, fresh, r
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = spawn(ddp_rank, DDP_RANKS, (path,), backend="gloo",
                  timeout_s=PHASE_DEADLINE_S["ddp"] // 3)
    spawn_s = time.perf_counter() - t0
    os.remove(path)
    check = ranks[0].pop("check")
    if ranks[0]["sharding"] != ranks[1]["sharding"] or ranks[0]["stats"] != ranks[1]["stats"]:
        raise AssertionError(f"ddp: the ranks' results differ: {ranks}")
    steps = ranks[0]["steps"]
    want = {"all_reduce grads": n_steps, "all_reduce moments": 2, "all_reduce means": 1,
            "all_gather_object checksums": 1}
    if steps != n_steps or any(rk["collectives"] != want for rk in ranks):
        raise AssertionError(f"ddp: collectives {[rk['collectives'] for rk in ranks]}, "
                             f"expected {want}")
    log(f"ddp: {DDP_RANKS} gloo ranks on the card, each {ENVS // DDP_RANKS} envs of one "
        f"captured {ENVS}-env rollout of ckpt_5200 (Ur5SihLift, {steps} minibatch steps): "
        f"updates {[round(rk['update_s'], 3) for rk in ranks]} s, spawn to results "
        f"{spawn_s:.1f} s; replicated leaves bit-identical across ranks: "
        f"{ranks[0]['sharding']}; collectives per rank {ranks[0]['collectives']}; rank 0 "
        f"against one process (data_shards=2): largest fraction of each tolerance used "
        f"{({k: round(v, 5) for k, v in check['worst'].items() if k != 'later grad'})}, "
        f"later steps' gradients up to {check['worst']['later grad']:.3e} of scale (not "
        f"held); every optimizer step bit-identical to the one-process step of its "
        f"averaged gradients; kl {ranks[0]['stats']['kl']:.5f} lr "
        f"{ranks[0]['stats']['lr']:.4e}")

    # the user's entry point under torchrun: 2 ranks of 4096 envs on the card
    exp = "chip_smoke_ddp"
    shutil.rmtree(os.path.join("runs", exp), ignore_errors=True)
    entry_s, _ = run_module("torch.distributed.run", [
        "--standalone", f"--nproc_per_node={DDP_RANKS}", "-m", "handarm_tpu_torch.train",
        "task=Ur5SihLift", f"env.num_envs={ENVS}", f"max_iterations={DDP_ENTRY_ITERS}",
        "dist_backend=gloo", f"experiment={exp}"], "ddp entry point",
        PHASE_DEADLINE_S["ddp"] // 3)
    wait_for_pending_saves()
    ck2 = os.path.join("runs", exp, "nn", f"ckpt_{DDP_ENTRY_ITERS}.npz")
    leaves = read_leaves(ck2)
    if (len(leaves) != 71 or leaves[68].shape != (ENVS, 121)
            or int(leaves[70]) != DDP_ENTRY_ITERS):
        raise AssertionError(f"ddp entry point: bad checkpoint {ck2}")
    with open(os.path.join("runs", exp, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f.read().splitlines()]
    sps = [row["env_steps_per_s"] for row in rows]
    # one process resumes it (no further iteration) and writes it back: the
    # whole TrainState, leaf for leaf
    buf = io.StringIO()
    with cl.redirect_stdout(buf):
        train.main(["task=Ur5SihLift", f"num_envs={ENVS}", f"resume={ck2}",
                    f"max_iterations={DDP_ENTRY_ITERS}", f"experiment={exp}_resume",
                    f"device={dev}"])
    wait_for_pending_saves()
    resumed = buf.getvalue()
    back = read_leaves(os.path.join("runs", f"{exp}_resume", "nn",
                                    f"ckpt_{DDP_ENTRY_ITERS}.npz"))
    if (f"resumed from {ck2} at iter {DDP_ENTRY_ITERS}\n" not in resumed
            or "reset fresh" in resumed
            or not all(np.array_equal(a, b) for a, b in zip(leaves, back))):
        raise AssertionError(f"ddp: one process did not resume the ranks' file whole:\n"
                             f"{resumed}")
    log(f"ddp entry point: torchrun {DDP_RANKS} ranks x {ENVS // DDP_RANKS} envs, "
        f"{DDP_ENTRY_ITERS} iteration(s) in {entry_s:.1f} s (process starts included); global train env-steps/s "
        f"by iteration {[round(x) for x in sps]}; rank 0 wrote {ck2} ({ENVS} envs, 71 "
        f"leaves); one process resumed it whole (the file it wrote back is equal leaf for "
        f"leaf)")

    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(DDP_RANKS, backend="gloo",
                                       timeout_s=PHASE_DEADLINE_S["ddp"] // 3)
    dry_s = time.perf_counter() - t0
    for rk in dry["ranks"]:
        check_launches(rk["launches"], LIFT_PER_ITER, 1, "dryrun_multichip rank")
        if rk["sharding"] != dry["sharding"] or not math.isfinite(rk["stats"]["kl"]):
            raise AssertionError(f"dryrun_multichip: bad rank record {rk}")
    log(f"dryrun_multichip({DDP_RANKS}): {dry['envs_per_rank']} envs per rank, one whole "
        f"iteration in {dry_s:.1f} s (process starts included); per rank {dry['sharding']}, "
        f"launches per rank per iteration {dry['launches']}; collectives "
        f"{dry['collectives']}")
    return dict(ranks=DDP_RANKS, envs=ENVS, steps=steps, update_s=[rk["update_s"] for rk in
                                                                   ranks],
                spawn_s=spawn_s, sharding=ranks[0]["sharding"],
                collectives=ranks[0]["collectives"], check=check,
                entry_point=dict(seconds=entry_s, env_steps_per_s=sps, checkpoint=ck2),
                dryrun=dict(seconds=dry_s, envs_per_rank=dry["envs_per_rank"],
                            sharding=dry["sharding"], launches_per_rank=dry["launches"],
                            collectives=dry["collectives"], stats=dry["stats"]))


def pbt_phase(rollout) -> dict:
    """Phase 43 (see the module docstring)."""
    import numpy as np

    from handarm_tpu_torch.parallel.pbt import PbtConfig, maybe_save_best_policy
    from handarm_tpu_torch.utils.checkpoint import load_train_state, read_leaves

    root = os.path.join("runs", "chip_smoke_pbt")
    ws = os.path.join(root, "workspace")
    for d in (root, os.path.join("runs", "chip_smoke_pbt_p0"),
              os.path.join("runs", "chip_smoke_pbt_p1")):
        shutil.rmtree(d, ignore_errors=True)
    ckpt = os.path.relpath(rollout.TASK_CKPTS["Ur5SihLift"])
    frames = PBT_ENVS * 16  # one iteration's
    common = ["task=Ur5SihLift", f"num_envs={PBT_ENVS}", f"pbt.workspace={ws}",
              "pbt.num_policies=2", f"pbt.interval_steps={frames}", "pbt.objective=reward_mean",
              "pbt.replace_threshold_abs=0", "pbt.replace_threshold_rel=0",
              "pbt.mutation_rate=1"]
    budget = PHASE_DEADLINE_S["pbt"] // 3
    s1, out1 = run_module("handarm_tpu_torch.train", common + [
        "experiment=chip_smoke_pbt_p1", "pbt.policy_idx=1", f"resume={ckpt}",
        "max_iterations=5202", "seed=1"], "pbt policy 1", budget, tail=4)
    if "[pbt]" in out1:
        raise AssertionError("pbt: policy 1 restarted")
    s0, out0 = run_module("handarm_tpu_torch.train", common + [
        "experiment=chip_smoke_pbt_p0", "pbt.policy_idx=0", "max_iterations=2", "seed=2"],
        "pbt policy 0", 2 * budget, tail=6)
    line = [x for x in out0.splitlines() if x.startswith("[pbt] policy 0 restarts")]
    p0 = os.path.join("runs", "chip_smoke_pbt_p0")
    if (len(line) != 1 or not line[0].startswith("[pbt] policy 0 restarts from donor at iter 1")
            or f"resumed from {p0}/nn/ckpt_1.npz at iter 1\n" not in out0):
        raise AssertionError(f"pbt: policy 0 did not restart through os.execv:\n{out0}")
    with open(os.path.join(ws, "policy_01", "meta.json")) as f:
        donor_meta = json.load(f)
    with open(os.path.join(ws, "policy_00", "meta.json")) as f:
        own_meta = json.load(f)
    donor = read_leaves(os.path.join(ws, "policy_01", donor_meta["checkpoint"]))
    adopted = read_leaves(os.path.join(p0, "nn", "ckpt_1.npz"))
    if not all(np.array_equal(adopted[i], donor[i]) for i in range(11)):
        raise AssertionError("pbt: the restarted policy's params are not the donor's")
    with open(os.path.join(p0, "config.json")) as f:
        conf = json.load(f)
    mutated = {k: conf["ppo"][k] for k in PbtConfig().mutable}
    for k in mutated:
        if conf["ppo"][k] != float(conf["cli_overrides"][f"ppo.{k}"]) or (
                donor_meta["hparams"][k] and conf["ppo"][k] == donor_meta["hparams"][k]):
            raise AssertionError(f"pbt: {k} not mutated in the restart's config.json")
    final = os.path.join(p0, "nn", "ckpt_2.npz")
    with open(os.path.join(p0, "metrics.jsonl")) as f:
        last = json.loads(f.read().splitlines()[-1])
    cfg = PbtConfig(workspace=ws, policy_idx=0)
    ts = load_train_state(final, "cpu")
    archived = maybe_save_best_policy(cfg, ts, last["reward_mean"], int(last["total_env_steps"]))
    again = maybe_save_best_policy(cfg, ts, last["reward_mean"] - 1.0,
                                   int(last["total_env_steps"]) + 1)
    best = sorted(os.listdir(os.path.join(ws, "best")))
    if not archived or again or len(best) != 2:
        raise AssertionError(f"pbt: best-policy archive {best}")
    log(f"pbt: 2 policies x {PBT_ENVS} envs on the card in one workspace; policy 1 (from "
        f"ckpt_5200) {s1:.1f} s, objective {donor_meta['objective']:.5f}; policy 0 (fresh) "
        f"objective {own_meta['objective']:.5f}, found itself worst and restarted through "
        f"os.execv: {s0:.1f} s for both images, exit 0; its ckpt_1 holds the donor's "
        f"params; mutated hyperparameters {mutated} (donor's {donor_meta['hparams']}); "
        f"archived {best}")
    return dict(envs=PBT_ENVS, policy1_s=s1, policy0_s=s0, donor_objective=donor_meta[
        "objective"], restarted_objective=own_meta["objective"], mutated=mutated,
                donor_hparams=donor_meta["hparams"], archive=best)


def actor_learner_phase(rollout, dev, ops) -> dict:
    """Phase 44 (see the module docstring)."""
    from types import SimpleNamespace

    import torch

    from handarm_tpu_torch.convert import train_state_from_leaves
    from handarm_tpu_torch.envs.tasks import make_env, ppo_overrides
    from handarm_tpu_torch.learn.ppo import PPO, PPOConfig
    from handarm_tpu_torch.parallel.actor_learner import ActorLearner
    from handarm_tpu_torch.utils.checkpoint import read_leaves

    sweep_op = ops["sweep"][0]
    actor_env = lambda n: make_env("Ur5SihLift", device=dev, num_envs=n)
    env0 = actor_env(AL_ENVS)
    stub = SimpleNamespace(num_obs=env0.num_obs, num_actions=env0.num_actions,
                           cfg=SimpleNamespace(num_envs=AL_ENVS * AL_ACTORS),
                           device=torch.device(dev))
    cfg = PPOConfig(**ppo_overrides("Ur5SihLift"))
    ppo = PPO(stub, cfg)
    envs = iter([env0] + [actor_env(AL_ENVS) for _ in range(AL_ACTORS - 1)])
    al = ActorLearner(ppo, lambda n: next(envs), AL_ENVS, AL_ACTORS, AL_QUEUE)
    ts = train_state_from_leaves(read_leaves(rollout.TASK_CKPTS["Ur5SihLift"]), None, None,
                                 dev)
    rollout.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, stats = al.run(ts, AL_ITERS, seed=7, timeout_s=PHASE_DEADLINE_S["actor-learner"] // 2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = rollout.launch_counts()
    n_roll = sum(al.rollouts)
    check_launches(counts, LIFT_PER_ITER, n_roll, "actor-learner")
    drained = [{k: float(v) for k, v in s.items()} for s in stats]
    stale = [d["staleness"] for d in drained]
    if not all(0 <= x <= AL_QUEUE for x in stale) or not all(
            math.isfinite(v) for d in drained for v in d.values()):
        raise AssertionError(f"actor-learner: staleness {stale} or stats {drained}")
    check_learner(new, "actor-learner")
    moved = max(float((new.params[k] - ts.params[k]).abs().max()) for k in ts.params)
    if not moved > 0 or int(new.epoch) != int(ts.epoch) + AL_ITERS:
        raise AssertionError("actor-learner: the learner did not update")
    # one contact_sweep call of an actor env, launched on a side stream and on
    # the default stream: bit-identical
    with Capture({"sweep": ops["sweep"]}, last_only=True) as cap:
        state, obs = env0.reset(3)
        cap.armed = True
        state, _ = env0.step(state, torch.zeros(AL_ENVS, env0.num_actions, device=dev))
    (args, kw), = cap.calls["sweep"]
    want = sweep_op.contact_sweep(*args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = sweep_op.contact_sweep(*args, **kw)
    side.synchronize()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("actor-learner: the sweep on a side stream differs")
    sps = AL_ITERS * AL_ENVS * AL_ACTORS * cfg.horizon / seconds
    log(f"actor-learner: {AL_ACTORS} actors x {AL_ENVS} envs (each its own thread, CUDA stream "
        f"and generator) and the learner on the card, {AL_ITERS} learner iterations from "
        f"ckpt_5200's learner in {seconds:.2f} s = {sps:.0f} learner env-steps/s; actor "
        f"rollouts {al.rollouts}; launches {counts} = {LIFT_PER_ITER} per actor rollout; "
        f"staleness {stale} (queue depth {AL_QUEUE}); kl {[round(d['kl'], 5) for d in drained]}"
        f"; a sweep call on a side stream bit-identical to the default stream's")
    return dict(actors=AL_ACTORS, envs_per_actor=AL_ENVS, iterations=AL_ITERS, seconds=seconds,
                learner_env_steps_per_s=sps, rollouts=list(al.rollouts), launches=counts,
                launches_per_actor_iteration=LIFT_PER_ITER, staleness=stale,
                kl=[d["kl"] for d in drained])


def bench_phase(rollout, dev) -> dict:
    """Phase 41 (see the module docstring)."""
    import torch

    from handarm_tpu_torch import graft_entry
    from handarm_tpu_torch.envs.hand_arm import tree_map

    ckpt = os.path.relpath(rollout.TASK_CKPTS["Ur5SihLift"])
    # in a process of its own: its env-steps/s run 40 % lower as main() in
    # this process after the phases before it (PERF.md section 6)
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
        ptxas = ptxas_summary(build.ptxas_report())
        for line in ptxas:
            log(line)
        # the warp layout holds three rows a lane in registers (n = 27 and 23,
        # and n = 24 at a padded row stride of 25), the block layout two rows
        # a thread (n = 46, the matrix in shared memory at a row stride of
        # 47), and the thread-per-matrix n = 12, 16 and 18 their lower
        # triangles (78, 136 and 171 floats): no spill
        for kname in ("spd_inverse_warp_kernel<27, 27>", "spd_inverse_warp_kernel<24, 25>",
                      "spd_inverse_warp_kernel<23, 23>", "spd_inverse_block_kernel<46, 47>",
                      "spd_inverse_kernel<12>", "spd_inverse_kernel<16>",
                      "spd_inverse_kernel<18>"):
            lines = [x for x in ptxas if kname in x]
            if len(lines) != 1 or "0 bytes spill stores" not in lines[0]:
                raise AssertionError(f"{kname} spills or is missing: {lines}")
        # the classic tasks' solves: C = 4 (Quadcopter), 8 (Ingenuity), 30
        # (the ANYmal), 37 (Ant) and 51 (Humanoid) slots at K = 0, and C =
        # 161 at K = 1 (BallBalance)
        log("classic: contact_sweep at C = 4, 8, 30, 37 and 51 (K = 0, no object sides) "
            "launches contact_sweep_kernel<128, 6>, at C = 161, K = 1 (BallBalance), C = 134, "
            "K = 2 (FrankaCubeStack), C = 190, K = 1 (FrankaCabinet), C = 91 (Trifinger), 150 "
            "(AllegroHand) and 160 (ShadowHand), K = 1, C = 298, K = 3 (AllegroKuka), C = "
            "506, K = 3, nv 46 (the two-arm AllegroKuka), C = 298, K = 2 (the Factory nut and "
            "bolt, peg and hole, and IndustReal) and C = 456, K = 3 (FactoryTaskGears), the "
            "instance its launch line names; spd_inverse at n = 14, 8, 2, 12, 18, 9 and 16 its "
            "<14>, <8>, <2>, <12>, <18>, <9> and <16>, at n = 27, 24 and 23 "
            "spd_inverse_warp_kernel<27, 27>, <24, 25> and <23, 23> (a warp per matrix), at n = "
            "46 spd_inverse_block_kernel<46, 47> (a block of two warps per matrix); sdf_gather "
            "at FrankaCabinet's R = 32 drawer and the Factory and IndustReal parts' R = 40 "
            "fields the one sdf_gather_kernel; prep_deff on the hands' and both AllegroKuka "
            "scenes' B x C >= 2^21 (and forced on the Factory's) the one prep_deff_kernel")

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
        family_rec["entry_point"] = entry_in_process(
            rollout, ["task=Ur5SihThrow", f"env.num_envs={ENVS}", "max_iterations=1",
                      "experiment=chip_smoke_throw"],
            os.path.join("runs", "chip_smoke_throw", "nn", "ckpt_1.npz"), "family entry point",
            dev, LIFT_PER_ITER, 1)
        del family_rec["entry_point"]["stdout"]
    with phase("multiobj-entry"):
        ckpt = os.path.relpath(rollout.TASK_CKPTS[MULTI_TASK])
        step = int(os.path.basename(ckpt)[5:-4]) + 1
        multi_train_rec["entry_point"] = entry_in_process(
            rollout, [f"task={MULTI_TASK}", f"resume={ckpt}", f"max_iterations={step}",
                      "experiment=chip_smoke_multiobj", "seed=1"],
            os.path.join("runs", "chip_smoke_multiobj", "nn", f"ckpt_{step}.npz"),
            "multiobj entry point", dev, MULTI_PER_ITER, 1)
        del multi_train_rec["entry_point"]["stdout"]
    with phase("dr-entry"):
        dr_rec["entry_point"] = dr_entry_phase(rollout, dev)
    with phase("engine-entry"):
        engine["entry_point"] = engine_entry_phase(rollout, dev)

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
        rnn_rec["entry_point"] = rnn_entry_phase(rollout, rnn_ppo, dev)
        del rnn_ppo

    stretch_rec, stretch_kernels = stretch_phases(rollout, dev, ops)
    for entry in kernels:
        entry["stretch"] = stretch_kernels[entry["name"]]
    classic_rec, classic_kernels_rec = classic_phases(rollout, dev, ops)
    for entry in kernels:
        entry["classic"] = classic_kernels_rec[entry["name"]]
        if entry["name"] == "spd_inverse":
            entry["instances"] = spd_instances(entry)
    parallel_rec = {}
    with phase("ddp"):
        parallel_rec["ddp"] = ddp_phase(rollout, dev)
    with phase("pbt"):
        parallel_rec["pbt"] = pbt_phase(rollout)
    with phase("actor-learner"):
        parallel_rec["actor_learner"] = actor_learner_phase(rollout, dev, ops)
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
        entry["parallel"] = dict(
            path="Ur5SihLift under 2 gloo ranks on the card, and the actor/learner split",
            dryrun_launches_per_rank_per_iteration=parallel_rec["ddp"]["dryrun"][
                "launches_per_rank"][name],
            actor_learner_launches=parallel_rec["actor_learner"]["launches"][name],
            actor_rollouts=sum(parallel_rec["actor_learner"]["rollouts"]))

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
                    "camera": camera_rec, "bench": bench_rec, "parallel": parallel_rec,
                    "classic": classic_rec}))
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
