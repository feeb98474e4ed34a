"""Checkpoints in the JAX package's format (`<name>_<step>.npz`, arrays
`leaf_0`, `leaf_1`, ... in the flattening order of its TrainState), read
and written by the port.

Leaves are read BY INDEX ONLY: the `.tree` file beside a JAX checkpoint is a
pickled JAX tree definition and is never opened here, and the port writes
none (the JAX loader reads the port's files given an `example_tree`). For a PPO TrainState
of the MLP ActorCritic (768-512-256, as in docs/evidence/lift_r3a) the
flattening order is

  0-10   params: dense_0.{bias,kernel}, dense_1.{bias,kernel},
         dense_2.{bias,kernel}, log_std, mu.{bias,kernel}, value.{bias,kernel}
  11-36  optimizer state (4 scalars, then Adam's mu and nu per parameter)
  37-39  observation running stats: mean, var, count
  40-42  value running stats; 43 learning rate
  44-67  env state (EnvState leaves: physics, control, task, metrics)
  68     last obs; 69 PRNG key; 70 epoch

(tests/test_torch_policy.py holds this map against the JAX package's own
loader.) Leaf dtypes: float32 but for the int32 optax counters, the bool
`last_finite`, the int32 episode clocks, target index, step count and
epoch, the bool goal flags and the two uint32 [2] PRNG keys (leaves 61 and
69).

A distilled student is written as the JAX package's `train_distill.py`
writes it: `student.npz` with one array per parameter, keys "0", "1", ...
in flax order (`read_student`, `save_student`).

`save_checkpoint` copies the state to the host at once and writes the file
on one background thread (atomically: `.tmp`, then `os.replace`), so the
training loop never waits on the disk; `wait_for_pending_saves` joins it.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from handarm_tpu_torch.convert import (
    env_state_from_leaves,
    student_params_from_leaves,
    student_params_to_leaves,
    train_state_from_leaves,
    train_state_to_leaves,
)
from handarm_tpu_torch.learn.networks import flax_names

PARAM_NAMES = tuple(f for f, _ in flax_names(3))  # dense_0.bias ... value.kernel
OBS_STATS_LEAVES = (37, 38, 39)  # mean, var, count
ENV_STATE_LEAVES = (44, 68)  # [start, stop)


def read_leaves(path: str) -> list[np.ndarray]:
    """All leaves of a checkpoint, in index order."""
    with np.load(path, allow_pickle=False) as data:
        n = len(data.files)
        return [np.asarray(data[f"leaf_{i}"]) for i in range(n)]


def read_policy(path: str):
    """(params {name: array}, (obs_mean, obs_var, obs_count)) of an MLP
    ActorCritic PPO checkpoint. Reads only those 14 leaves: an `.npz`
    member is decompressed when it is indexed."""
    with np.load(path, allow_pickle=False) as data:
        params = {name: np.asarray(data[f"leaf_{i}"]) for i, name in enumerate(PARAM_NAMES)}
        stats = tuple(np.asarray(data[f"leaf_{i}"]) for i in OBS_STATS_LEAVES)
    return params, stats


# one background writer: at most one write in flight, saves land in order
_writer_lock = threading.Lock()
_writer: threading.Thread | None = None


def wait_for_pending_saves() -> None:
    """Block until the in-flight checkpoint write, if any, is on disk."""
    with _writer_lock:
        w = _writer
    if w is not None:
        w.join()


def save_checkpoint(dirpath: str, ts, step: int, name: str = "ckpt", seed: int = 0,
                    sync: bool = False) -> str:
    """Write a PPO TrainState as `<dirpath>/<name>_<step>.npz` (71 leaves,
    uncompressed). The PRNG-key leaves hold `seed`'s key."""
    global _writer
    os.makedirs(dirpath, exist_ok=True)
    leaves = train_state_to_leaves(ts, seed)  # the host copy happens here
    path = os.path.join(dirpath, f"{name}_{step}.npz")

    def write():
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        os.replace(tmp, path)  # a reader never sees a torn file

    wait_for_pending_saves()
    if sync:
        write()
        return path
    t = threading.Thread(target=write, daemon=True)
    with _writer_lock:
        _writer = t
    t.start()
    return path


def load_train_state(path: str, device="cpu", env_state=None, last_obs=None):
    """A whole PPO checkpoint as the port's TrainState; the given env state
    and observations replace the checkpoint's own."""
    wait_for_pending_saves()
    leaves = read_leaves(path)
    if env_state is None:
        lo, hi = ENV_STATE_LEAVES
        env_state = env_state_from_leaves(leaves[lo:hi], device)
        last_obs = torch.tensor(leaves[hi], dtype=torch.float32, device=device)
    return train_state_from_leaves(leaves, env_state, last_obs, device)


def latest_checkpoint(dirpath: str) -> str | None:
    """The periodic checkpoint (`ckpt_<step>.npz`) in dirpath with the largest
    step, or None."""
    wait_for_pending_saves()
    if not os.path.isdir(dirpath):
        return None
    cands = [f for f in os.listdir(dirpath) if f.startswith("ckpt_") and f.endswith(".npz")]
    if not cands:
        return None
    return os.path.join(dirpath, max(cands, key=checkpoint_step))


def checkpoint_step(path: str) -> int:
    """The step in a `<name>_<step>.npz` file name."""
    return int(os.path.basename(path).rsplit("_", 1)[1].split(".")[0])


def read_student(path: str, net, device="cpu") -> dict:
    """The params of a `student.npz` for StudentPolicy `net`."""
    with np.load(path, allow_pickle=False) as data:
        leaves = [np.asarray(data[str(i)]) for i in range(len(data.files))]
    return student_params_from_leaves(net, leaves, device)


def save_student(path: str, net, params: dict) -> str:
    """Write a StudentPolicy's params as `student.npz` (atomically)."""
    leaves = student_params_to_leaves(net, params)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{str(i): x for i, x in enumerate(leaves)})
    os.replace(tmp, path)
    return path
