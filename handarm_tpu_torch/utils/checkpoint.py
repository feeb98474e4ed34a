"""Reader for the JAX package's checkpoints (`<name>_<step>.npz`, arrays
`leaf_0`, `leaf_1`, ... in the flattening order of its TrainState).

Leaves are read BY INDEX ONLY: the `.tree` file beside each checkpoint is a
pickled JAX tree definition and is never opened here. For a PPO TrainState
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
loader.)
"""

from __future__ import annotations

import numpy as np

PARAM_NAMES = (
    "dense_0.bias", "dense_0.kernel", "dense_1.bias", "dense_1.kernel",
    "dense_2.bias", "dense_2.kernel", "log_std", "mu.bias", "mu.kernel",
    "value.bias", "value.kernel",
)
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
