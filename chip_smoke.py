#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port (handarm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each with a deadline and one flushed progress line:
  1. device   CUDA must be present; prints the card's name and power limit.
  2. build    compiles the kernels in handarm_tpu_torch/csrc with one nvcc.
  3. rollout  the port's main path: Ur5SihLift at 8192 envs on the in-repo
              stand-in robot, policy weights from
              docs/evidence/lift_r3a/ckpt_5200.npz, reset + 31 deterministic
              policy-in-the-loop control steps; every state leaf must stay
              finite and the launch counters must show both kernels on the
              path (spd_inverse once and contact_sweep 6 times per step).
  4. kernels  each kernel against its plain PyTorch version on inputs
              captured from that rollout (B = 8192), with stated
              tolerances, then timed with CUDA events beside its bound and
              the one-call library equivalent where there is one.
  5. cpu-ref  from one state (25 CPU control steps after reset, the hand
              in contact), 2 control steps at 16 envs on the card and on
              the CPU (plain versions) must agree.
The line before the last is a JSON object naming every kernel with its
numbers; the last line is {"ok": true, "device": {...}}. Any fault prints a
traceback and exits non-zero; without CUDA it exits 2 before any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback

TOTAL_DEADLINE_S = 1100
PHASE_DEADLINE_S = {"device": 60, "build": 420, "rollout": 420, "kernels": 240,
                    "cpu-ref": 300}
ENVS = 8192
STEPS = 30  # timed control steps, after one warm-up step
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, same source


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


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spd_inverse_flops(n: int) -> int:
    """Flops of one n x n inverse as the kernel computes it (FMA = 2)."""
    chol = sum(2 * j * (n - j) for j in range(n)) + n * (n - 1) // 2 + n
    inv = sum(2 * (i - r) + 1 for r in range(n) for i in range(r + 1, n))
    gram = sum(2 * (n - max(a, c)) for a in range(n) for c in range(n))
    return chol + inv + gram


def contact_sweep_flops(anc_bits, obj_idx, C: int, nv: int, K: int,
                        iterations: int) -> int:
    """Flops of one solve at this scene's couplings (FMA = 2): per slot the
    masked dof sums (one add per set bit per screw component), cross
    products, projection and impulse; per env the slot reductions, the
    generalized impulse and Minv gi."""
    bits = sum(bin(int(b)).count("1") for b in anc_bits)
    sides = [int((row >= 0).sum()) for row in obj_idx]
    S = len(sides)
    vel = 6 * nv + 6 * bits + 12 * C + 12 * sum(sides) + 45 * C
    apply = 9 * C + 27 * sum(sides) + 6 * bits + 6 * S * C + 12 * nv + 2 * nv * nv + 12 * K * S
    return vel * iterations + apply * (iterations + 1)


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

    from handarm_tpu_torch import rollout
    from handarm_tpu_torch.envs.hand_arm import tree_map
    from handarm_tpu_torch.envs.tasks import make_env
    from handarm_tpu_torch.ops import contact_sweep as sweep_op
    from handarm_tpu_torch.ops import spd_inverse as spd_op

    captured = {}
    armed = {"on": False}
    orig_sweep, orig_spd = sweep_op.contact_sweep, spd_op.spd_inverse

    def capture_sweep(*args, **kw):
        if armed["on"] and "sweep" not in captured:
            captured["sweep"] = (args, kw)
        return orig_sweep(*args, **kw)

    def capture_spd(M):
        if armed["on"] and "spd" not in captured:
            captured["spd"] = M
        return orig_spd(M)

    with phase("rollout"):
        env = make_env("Ur5SihLift", device=dev, num_envs=ENVS)
        C = env.scene.slots.num_slots
        log(f"scene: {ENVS} envs, nv {env.art.nv}, contact slots C = {C}, "
            f"objects K = {env.num_objects}, obs {env.num_obs}, actions {env.num_actions}")
        log(f"policy: {os.path.relpath(rollout.DEFAULT_CKPT)}")
        policy = rollout.load_policy(rollout.DEFAULT_CKPT, dev)
        sweep_op.contact_sweep, spd_op.spd_inverse = capture_sweep, capture_spd
        try:
            rollout.reset_launch_counts()
            state, obs = env.reset(0)
            state, obs, _, _ = rollout.forward_step(env, policy, state, obs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(STEPS):
                armed["on"] = i == STEPS - 2  # late: the hand is in contact
                state, obs, reward, done = rollout.forward_step(env, policy, state, obs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = rollout.launch_counts()
        finally:
            sweep_op.contact_sweep, spd_op.spd_inverse = orig_sweep, orig_spd
        steps_run = STEPS + 1
        sim = env.cfg.control_freq_inv * env.cfg.substeps
        log(f"rollout: {STEPS} control steps in {seconds:.3f} s = "
            f"{ENVS * STEPS / seconds:.0f} env-steps/s; launches {counts} "
            f"over {steps_run} steps; mean reward {float(reward.mean()):.4f}")
        leaves = []
        tree_map(lambda x: leaves.append(x), state)
        for x in leaves + [obs]:
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                raise AssertionError("non-finite state after the rollout")
        if counts["spd_inverse"] != steps_run:
            raise AssertionError(f"spd_inverse ran {counts['spd_inverse']} times, "
                                 f"expected {steps_run}")
        if counts["contact_sweep"] != sim * steps_run:
            raise AssertionError(f"contact_sweep ran {counts['contact_sweep']} times, "
                                 f"expected {sim * steps_run}")
        env_steps_per_s = ENVS * STEPS / seconds

    kernels = []
    with phase("kernels"):
        # spd_inverse on the PD-augmented mass matrices of one control step
        M = captured["spd"]
        got = spd_op.spd_inverse_cuda(M)
        want = spd_op.spd_inverse_plain(M)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ident = float((torch.bmm(got, M) - torch.eye(M.shape[1], device=dev)).abs().max())
        log(f"spd_inverse: B={M.shape[0]} n={M.shape[1]} max|kernel-plain| {err:.3e} "
            f"(scale {scale:.3e}), max|Minv M - I| {ident:.3e}")
        # float32 Cholesky of 17x17 matrices in two summation orders: 1e-4 of
        # the largest entry; the identity check is the JAX package's 5e-3
        if not err <= 1e-4 * scale or not ident <= 5e-3:
            raise AssertionError("spd_inverse kernel disagrees with its plain version")
        B, n = M.shape[0], M.shape[1]
        t_b, by = bound_ms(2 * B * n * n * 4, B * spd_inverse_flops(n))
        kernels.append(dict(
            name="spd_inverse", route="cuda",
            source="handarm_tpu_torch/csrc/spd_inverse.cu",
            replaces="handarm_tpu/ops/spd_inverse.py:63",
            launches=counts["spd_inverse"], max_abs_err=err,
            ms=cuda_time_ms(lambda: spd_op.spd_inverse_cuda(M), 50),
            plain_ms=cuda_time_ms(lambda: spd_op.spd_inverse_plain(M), 20),
            bound_ms=t_b, bound_by=by,
            library_ms=cuda_time_ms(lambda: torch.linalg.inv(M), 20),
        ))

        # contact_sweep on one anchored solve of the rollout
        args, kw = captured["sweep"]
        (planes, bias, screws, qd, minv2, obj, lam0, anc, anc_bits, obj_idx,
         signs, iters, omega) = args
        warm = kw.get("apply_warm", True)
        cuda_args = (planes, bias, screws, qd, minv2, obj, lam0, anc_bits,
                     obj_idx, signs, iters, omega, warm)
        plain_args = (planes, bias, screws, qd, minv2, obj, lam0, anc, obj_idx,
                      signs, iters, omega, warm)
        got = sweep_op.contact_sweep_cuda(*cuda_args)
        want = sweep_op.contact_sweep_plain(*plain_args)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("qd", "obj", "lam"), got, want):
            e = float((g - w).abs().max())
            s = float(w.abs().max())
            errs[name] = e
            log(f"contact_sweep: {name} max|kernel-plain| {e:.3e} (scale {s:.3e})")
            # 8 Jacobi sweeps in float32 with the slot sums taken in another
            # order: 1e-4 of this output's own largest value
            if not e <= 1e-4 * s:
                raise AssertionError(f"contact_sweep kernel disagrees on {name}")
        active = int((planes[16] > 0).sum())
        log(f"contact_sweep: B={planes.shape[1]} C={planes.shape[2]} K={obj.shape[2]} "
            f"sweeps={iters} warm={warm}; slots with gate > 0: {active}")
        nbytes = sum(t.numel() * t.element_size() for t in
                     (planes, bias, screws, qd, minv2, obj, lam0, anc_bits, obj_idx))
        nbytes += sum(t.numel() * t.element_size() for t in got)
        flops = planes.shape[1] * contact_sweep_flops(
            anc_bits.cpu().numpy(), obj_idx.cpu().numpy(), planes.shape[2],
            qd.shape[1], obj.shape[2], iters)
        t_b, by = bound_ms(nbytes, flops)
        kernels.append(dict(
            name="contact_sweep", route="cuda",
            source="handarm_tpu_torch/csrc/contact_sweep.cu",
            replaces="handarm_tpu/ops/contact_sweep.py:284",
            launches=counts["contact_sweep"], max_abs_err=max(errs.values()),
            ms=cuda_time_ms(lambda: sweep_op.contact_sweep_cuda(*cuda_args), 50),
            plain_ms=cuda_time_ms(lambda: sweep_op.contact_sweep_plain(*plain_args), 10),
            bound_ms=t_b, bound_by=by, library_ms=None,
        ))

    with phase("cpu-ref"):
        small = 16
        env_c = make_env("Ur5SihLift", device="cpu", num_envs=small)
        env_g = make_env("Ur5SihLift", device=dev, num_envs=small)
        pol_c = rollout.load_policy(rollout.DEFAULT_CKPT, "cpu")
        st_c, obs_c = env_c.reset(1)
        for _ in range(25):  # on the CPU: the policy brings the hand into contact
            st_c, obs_c, _, _ = rollout.forward_step(env_c, pol_c, st_c, obs_c)
        # episode clocks at 0: no env times out (and redraws) in the 2 steps
        st_c = st_c._replace(task=st_c.task._replace(
            progress=torch.zeros_like(st_c.task.progress)))
        st_g = tree_map(lambda x: x.to(dev), st_c)
        for _ in range(2):
            act = pol_c.act(obs_c)
            st_c, res_c = env_c.step(st_c, act)
            st_g, res_g = env_g.step(st_g, act.to(dev))
            obs_c = res_c.obs
        err = float((res_g.obs.cpu() - obs_c).abs().max())
        q_err = float((st_g.physics.robot.q.cpu() - st_c.physics.robot.q).abs().max())
        log(f"cpu-ref: {small} envs, 2 control steps: max|obs gpu-cpu| {err:.3e}, "
            f"max|q gpu-cpu| {q_err:.3e}")
        # the JAX package's position bound (2e-4) on q; 2e-3 on observations,
        # which include fingertip velocities
        if not (q_err <= 2e-4 and err <= 2e-3):
            raise AssertionError("the card's run disagrees with the CPU reference")
        if not bool(torch.isfinite(res_g.obs).all()) or res_g.obs.shape != (small, env_g.num_obs):
            raise AssertionError("bad observations from the card")

    log(json.dumps({"rollout": {"envs": ENVS, "control_steps": STEPS,
                                "env_steps_per_s": env_steps_per_s, "slots": C,
                                "card": smi}}))
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels}))
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
