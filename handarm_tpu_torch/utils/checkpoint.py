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
loader.) The asymmetric and recurrent learners' TrainStates (`PPOConfig`
`asymmetric_critic`, `rnn_units`) flatten the same way: their params
(`{"actor", "critic"}` when asymmetric, `learn.ppo.param_names`), the
optax state over them, both stats, lr, the env state, last obs, key and
epoch; then the teacher-observation stats (mean, var, count) and the last
teacher observations when asymmetric; then the carry, (c, h) or actor
(c, h) and critic (c, h), when recurrent. The leaf count does not tell
these layouts apart, so their reader and writer take the PPOConfig.
Leaf dtypes: float32 but for the int32 optax counters, the bool
`last_finite`, the int32 episode clocks, target index, step count and
epoch, the bool goal flags and the two uint32 [2] PRNG keys (leaves 61 and
69).

A classic task's env state has 14 (Quadcopter, BallBalance, Anymal), 13
(Ingenuity), 16 (Ant, Humanoid), 18 (AnymalTerrain), 11
(FrankaCubeStack), 12 (FrankaCabinet), 15 (Trifinger, AllegroHand, the
ShadowHand tasks), 25 (the DeXtreme tasks: the inner DexState's 15, the
last observation, the AdrState's 6, the RNA masks, the key; the
AllegroKuka tasks) or 4 (Cartpole) leaves
(`convert.classic_state_to_leaves`): its physics with the floating base's
pose (and the locomotion robots' tau_ext; the fixed bases of the
Franka, the Trifinger and the hands have neither, the Cartpole no
physics), its own fields, its PRNG key; its
reader takes the task's config as `env_cfg`.

An env with domain randomization or ADR has 6 more env-state leaves for
each, after the step count (the DRState; the AdrState with its int32
`worker_mode`): 30 or 36 in all, and every later leaf moves up by as many.
The Stretch's control state is one leaf (`joint_target`), not the
UR5+SIH's three: its env state has 22 leaves (28, 34), its MLP TrainState
69 (docs/evidence/stretch_r5d/ckpt_4000.npz). The leaf count does not tell
DR from ADR, so the reader takes the env's HandArmConfig (`env_cfg`, whose
`robot` gives the control layout) and refuses a file of another layout.

A distilled student is written as the JAX package's `train_distill.py`
writes it: `student.npz` with one array per parameter, keys "0", "1", ...
in flax order (`read_student`, `save_student`).

`save_checkpoint` copies the state to the host at once and writes the file
on one background thread (atomically: `.tmp`, then `os.replace`), so the
training loop never waits on the disk; `wait_for_pending_saves` joins it.

Under ranks (`group`, a `parallel.mesh.DataParallel`), every rank calls
`save_checkpoint`: the per-env leaves are gathered in rank order and rank 0
writes the whole state, the file one process holding all B envs writes
(and the JAX package reads).
"""

from __future__ import annotations

import functools
import os
import threading

import numpy as np
import torch

from handarm_tpu_torch.convert import (
    env_leaf_count,
    env_leaf_counts,
    env_state_from_leaves,
    extra_leaf_count,
    learner_leaf_count,
    params_from_leaves,
    params_to_leaves,
    physics_leaf_count,
    train_state_from_leaves,
    train_state_to_leaves,
)
from handarm_tpu_torch.learn.networks import flax_names
from handarm_tpu_torch.learn.ppo import param_names
from handarm_tpu_torch.parallel.mesh import gather_train_state

PARAM_NAMES = tuple(f for f, _ in flax_names(3))  # dense_0.bias ... value.kernel
ENV_STATE_LEAVES = (44, 68)  # [start, stop) for the 768-512-256 MLP


def read_leaves(path: str) -> list[np.ndarray]:
    """All leaves of a checkpoint, in index order."""
    with np.load(path, allow_pickle=False) as data:
        n = len(data.files)
        return [np.asarray(data[f"leaf_{i}"]) for i in range(n)]


def read_policy(path: str):
    """(params {flax name: array}, (obs_mean, obs_var, obs_count)) of an MLP
    ActorCritic PPO checkpoint. Decompresses only its params and the
    observation stats (an `.npz` member is decompressed when it is indexed;
    the layout is checked from the members' headers). Raises
    NotImplementedError for another learner's checkpoint (asymmetric or
    recurrent): the JAX package's scripts/eval_policy.py evaluates the MLP
    ActorCritic alone, so the port's eval and serving paths do too
    (ROADMAP §1.8); a recurrent policy is served by `PPO.act`."""
    with np.load(path, allow_pickle=False) as data:
        header = functools.lru_cache(maxsize=None)(lambda i: _leaf_header(data, i))
        L = mlp_hidden_layers(header, len(data.files))
        names = [f for f, _ in flax_names(L)]
        params = {name: np.asarray(data[f"leaf_{i}"]) for i, name in enumerate(names)}
        k = 3 * len(names) + 4
        stats = tuple(np.asarray(data[f"leaf_{i}"]) for i in range(k, k + 3))
    return params, stats


def _leaf_header(data, i: int) -> tuple:
    """(shape, dtype) of member `leaf_i` of an open `.npz`, from its header."""
    with data.zip.open(f"leaf_{i}.npy") as f:
        major, _ = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        shape, _, dtype = read(f)
    return shape, dtype


def mlp_hidden_layers(header, n: int) -> int:
    """The hidden layers of the MLP ActorCritic whose checkpoint has `n`
    leaves, `header(i)` the (shape, dtype) of the i-th: its params must
    chain (dense_i bias and kernel, then log_std, mu, value) and be
    followed by optax's int32 and bool scalars. NotImplementedError
    otherwise."""
    shape = lambda i: header(i)[0] if i < n else None
    L, width = 0, None
    while (shape(2 * L + 1) is not None and len(shape(2 * L)) == 1
           and len(shape(2 * L + 1)) == 2 and shape(2 * L + 1)[1] == shape(2 * L)[0]
           and (width is None or shape(2 * L + 1)[0] == width)):
        width, L = shape(2 * L)[0], L + 1
    a = (shape(2 * L) or (None,))[0]
    ok = L > 0 and 2 * L + 7 <= n and [shape(2 * L + i) for i in range(5)] == [
        (a,), (a,), (width, a), (1,), (width, 1)]
    if ok:
        ok = [header(2 * L + 5), header(2 * L + 6)] == [((), np.int32), ((), np.bool_)]
    if not ok:
        raise NotImplementedError(
            "not an MLP ActorCritic checkpoint (an asymmetric or recurrent learner's?): the "
            "JAX package's scripts/eval_policy.py cannot evaluate one, and neither do the "
            "port's eval_policy and rollout (ROADMAP §1.8); serve a recurrent policy through "
            "PPO.act")
    return L


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
                    sync: bool = False, cfg=None, env_cfg=None, group=None) -> str:
    """Write a PPO TrainState as `<dirpath>/<name>_<step>.npz` (uncompressed;
    71 leaves for the 768-512-256 MLP). The PRNG-key leaves hold `seed`'s
    key. `cfg`: the PPOConfig of an asymmetric or recurrent learner;
    `env_cfg`: the env's HandArmConfig, whose DR and ADR states the env
    state must hold (without it, those it holds are written). `group`:
    under ranks, every rank calls this and rank 0 writes every rank's envs
    (the path is returned on every rank)."""
    global _writer
    path = os.path.join(dirpath, f"{name}_{step}.npz")
    if group is not None:
        ts = gather_train_state(group, ts)
        if group.rank != 0:
            return path
    os.makedirs(dirpath, exist_ok=True)
    leaves = train_state_to_leaves(ts, seed, cfg, env_cfg)  # the host copy happens here

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


def file_env_leaves(path: str, cfg=None) -> int:
    """The env-state leaves of a PPO checkpoint of the learner `cfg` (the
    PPOConfig; None: an MLP ActorCritic): 24, 30 or 36 (UR5+SIH), 22, 28
    or 34 (Stretch), 14 (Quadcopter, BallBalance, Anymal), 13 (Ingenuity), 16
    (Ant, Humanoid), 18 (AnymalTerrain), 11 (FrankaCubeStack), 12
    (FrankaCabinet), 15 (Trifinger, AllegroHand, the ShadowHand tasks), 4
    (Cartpole)."""
    with np.load(path, allow_pickle=False) as data:
        n = len(data.files)
        P = (2 * mlp_hidden_layers(lambda i: _leaf_header(data, i), n) + 5 if cfg is None
             else len(param_names(cfg)))
    n_env = n - learner_leaf_count(P) - 3 - extra_leaf_count(cfg)
    if n_env not in env_leaf_counts():
        raise ValueError(f"{path}: {n} leaves are not a PPO TrainState of this learner")
    return n_env


def file_contact_slots(path: str, cfg=None) -> int:
    """The contact-slot count of a PPO checkpoint's env state (the learner
    `cfg` as in `file_env_leaves`): the C of its [B, C, 3] impulses, 0 for
    a state without physics (the Cartpole's)."""
    n_env = file_env_leaves(path, cfg)
    if not physics_leaf_count(n_env):
        return 0
    with np.load(path, allow_pickle=False) as data:
        lo = len(data.files) - n_env - 3 - extra_leaf_count(cfg)  # where the env state starts
        # physics: q, qd, targets[, base pose], object x4, impulses
        shape, _ = _leaf_header(data, lo + physics_leaf_count(n_env) - 1)
    return int(shape[1])


def load_train_state(path: str, device="cpu", env_state=None, last_obs=None, cfg=None,
                     env_cfg=None):
    """A whole PPO checkpoint as the port's TrainState; the given env state
    and observations replace the checkpoint's own (then its env state may
    have any layout). `cfg`: the PPOConfig of an asymmetric or recurrent
    learner (without it, an MLP ActorCritic: another layout raises
    NotImplementedError). `env_cfg`: the HandArmConfig of the env the state
    is read for (None: without DR and ADR); a file whose env state has
    another layout raises ValueError. Under ranks, `parallel.mesh.
    scatter_train_state` cuts the whole file's env state to a rank's envs."""
    wait_for_pending_saves()
    n_env = file_env_leaves(path, cfg)
    leaves = read_leaves(path)
    if env_state is None:
        if n_env != env_leaf_count(env_cfg):
            raise ValueError(f"{path}: its env state has {n_env} leaves, this env's "
                             f"{env_leaf_count(env_cfg)} (domain randomization or ADR differ)")
        lo = len(leaves) - n_env - 3 - extra_leaf_count(cfg)  # where the env state starts
        env_state = env_state_from_leaves(leaves[lo:lo + n_env], device, env_cfg)
        last_obs = torch.tensor(leaves[lo + n_env], dtype=torch.float32, device=device)
    return train_state_from_leaves(leaves, env_state, last_obs, device, cfg, n_env)


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
    return params_from_leaves(net, leaves, device)


def save_student(path: str, net, params: dict) -> str:
    """Write a StudentPolicy's params as `student.npz` (atomically)."""
    leaves = params_to_leaves(net, params)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{str(i): x for i, x in enumerate(leaves)})
    os.replace(tmp, path)
    return path
