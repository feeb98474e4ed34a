"""Process-group launch helpers (counterpart of handarm_tpu/parallel/launch.py).

The JAX package runs one SPMD program over a device mesh; the port runs
what IsaacGymEnvs ran (torchrun + NCCL, its utils/rlgames_utils.py rank
wiring): one process per rank under `torch.distributed`.

- `init_distributed` reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
  MASTER_ADDR and MASTER_PORT (or takes them as arguments), joins the
  process group with the backend the caller names, and returns the JAX
  dict's keys.
- `rank_device`: the card of a rank. With `nccl` (the default) rank r runs
  on `cuda:LOCAL_RANK`, and a host with fewer cards than local ranks
  raises: NCCL cannot put two ranks on one card. With `gloo`, ranks share
  the host's cards (`cuda:LOCAL_RANK % cards`); gloo all-reduces and
  broadcasts CUDA tensors, and the port copies to the host explicitly for
  the collectives gloo has only there. A rank that finds no CUDA raises
  unless the caller passed `device="cpu"`. Nothing switches backend or
  device on its own.
- `spawn` runs a function on n local ranks (torch.multiprocessing, the
  spawn start method), each with a joined group, and returns what each
  rank returned; a rank that fails or outlives the timeout fails the call,
  and every child is stopped.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from handarm_tpu_torch import resolve_device

BACKENDS = ("nccl", "gloo")


def _env_int(name: str, default: int | None) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def rank_device(local_rank: int, backend: str = "nccl", device=None) -> torch.device:
    """The device of the local rank `local_rank` (see the module docstring).
    `device`: "cpu", or a card for every rank ("cuda:0"), or None / "cuda"
    for the rule by local rank."""
    if backend not in BACKENDS:
        raise ValueError(f"dist_backend {backend!r} is not one of {BACKENDS}")
    if device is not None and torch.device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; pass dist_backend=gloo "
                             "for ranks on the CPU")
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return resolve_device(device)
    resolve_device("cuda")  # raises where there is no CUDA
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= cards:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({cards} on this host): NCCL "
            "cannot put two ranks on one card; pass dist_backend=gloo to share a card")
    return torch.device("cuda", local_rank % cards)


def init_distributed(dist_backend: str = "nccl", device=None, rank: int | None = None,
                     world_size: int | None = None, local_rank: int | None = None,
                     init_method: str | None = None, timeout_s: float = 600.0) -> dict:
    """Join the process group of this rank, from the arguments or torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK; MASTER_ADDR and MASTER_PORT
    through `env://` unless `init_method` is given). A world of one
    process joins nothing. Returns the JAX dict's keys (process_index,
    process_count, local_devices, global_devices: one device per process)
    and this rank's `device` and `backend`."""
    rank = rank if rank is not None else _env_int("RANK", 0)
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK", rank)
    dev = rank_device(local_rank, dist_backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size > 1 and not dist.is_initialized():
        dist.init_process_group(dist_backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout_s))
    return dict(process_index=rank, process_count=world_size, local_devices=1,
                global_devices=world_size, device=dev, backend=dist_backend)


def is_main_process() -> bool:
    """Rank 0 (or a run without a process group): the rank that logs and
    writes checkpoints (reference train.py:183-188)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def per_host_envs(total_envs: int) -> int:
    """The envs of one rank: `total_envs` split evenly over the ranks."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if total_envs % n:
        raise ValueError(f"{total_envs} envs do not split over {n} ranks")
    return total_envs // n


def _rank_main(fn, rank: int, nprocs: int, backend: str, device, init_method: str,
               threads: int | None, args: tuple, out) -> None:
    from handarm_tpu_torch.parallel.mesh import DataParallel

    try:
        if threads is not None:
            torch.set_num_threads(threads)
        info = init_distributed(backend, device, rank=rank, world_size=nprocs,
                                local_rank=rank, init_method=init_method)
        group = (DataParallel.current(info["device"], backend) if nprocs > 1
                 else DataParallel(0, 1, info["device"], backend))
        # by value (plain pickle): a tensor shared by handle would die with the rank
        result = pickle.dumps(fn(group, *args))
        if dist.is_initialized():
            dist.barrier()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which fails the call
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), backend: str = "nccl", device=None,
          timeout_s: float = 900.0, threads: int | None = None) -> list:
    """`fn(group, *args)` on `nprocs` local ranks, each a spawned process with
    its DataParallel group (`device` as `rank_device`'s); returns the
    results in rank order. `fn` and its arguments and results must pickle.
    The ranks meet through a `file://` store in a fresh temporary
    directory. A rank that raises, dies or is still running after
    `timeout_s` fails the call (RuntimeError or TimeoutError) once every
    child is stopped."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="handarm_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, backend, device,
                                                  init_method, threads, args, out))
             for r in range(nprocs)]
    deadline = time.monotonic() + timeout_s
    results: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish within {timeout_s:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:  # the other ranks may wait on it in a collective: stop them all
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = pickle.loads(value)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            raise TimeoutError("ranks did not exit after returning their results")
        return [results[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(10.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
