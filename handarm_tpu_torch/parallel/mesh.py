"""Data parallelism over ranks (counterpart of handarm_tpu/parallel/mesh.py).

The JAX package shards the env axis over a `data` mesh and lets XLA insert
the psums of the learner's reductions. The port runs one process per rank
under `torch.distributed` and issues those reductions itself:

- each rank owns a contiguous slice of the B envs, `[r B / W, (r + 1) B / W)`
  (`DataParallel.env_slice`), and steps only those;
- the learner's params, optimizer state, running stats, lr and epoch are
  replicated, and so are the env's global leaves: the success metrics,
  the episode counter and ADR's ranges and queues;
- where the one program reduces over the global batch, the port makes one
  explicit all-reduce (`DataParallel.all_reduce`, counted by tag).

Which leaves are the env's own is `shard_env_state`'s rule, by place in the
state rather than by shape: last observations, last teacher observations,
LSTM carries and the env state are per env, except its metrics, its
`task.total_steps` and ADR's `lo`, `hi`, `q_sum` and `q_cnt`.

`shard_train_state` broadcasts the replicated leaves from rank 0 and keeps
the per-env leaves; `gather_train_state` and `scatter_train_state` turn a
rank's state into the whole state (per-env leaves in rank order) and back;
`assert_sharded` checks that every replicated leaf is bit-identical across
ranks and every per-env leaf holds B / W rows.

Host-side collectives (the byte buffers of gathers and checksums) run on a
gloo group beside the main one, as gloo and NCCL take CUDA tensors for
all-reduce and broadcast only.
"""

from __future__ import annotations

import hashlib
from collections import Counter

import torch
import torch.distributed as dist

# env-state leaves that are global, not per env (paths under env_state)
REPLICATED_ENV_PATHS = ("metrics", "task.total_steps", "task.adr.lo", "task.adr.hi",
                        "task.adr.q_sum", "task.adr.q_cnt")
LOCAL_PATHS = ("env_state", "last_obs", "last_teacher_obs", "hidden")


class DataParallel:
    """One rank's view of the data-parallel group: rank, world size, device,
    backend, the process group (None: the default one) and a gloo group for
    host tensors. `counts` tallies the collectives issued, by (op, tag)."""

    def __init__(self, rank: int, world_size: int, device, backend: str, group=None,
                 host_group=None):
        self.rank, self.world_size = rank, world_size
        self.device, self.backend = torch.device(device), backend
        self.group, self.host_group = group, host_group
        self.counts: Counter = Counter()

    @classmethod
    def current(cls, device, backend: str) -> "DataParallel":
        """The group of the initialized default process group."""
        host = None if backend == "gloo" else dist.new_group(backend="gloo")
        return cls(dist.get_rank(), dist.get_world_size(), device, backend, None, host)

    def env_slice(self, num_envs: int) -> slice:
        """This rank's envs of `num_envs` in all."""
        if num_envs % self.world_size:
            raise ValueError(f"{num_envs} envs do not split over {self.world_size} ranks")
        n = num_envs // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        self.counts[("all_reduce", tag)] += 1
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, tag: str, src: int = 0) -> torch.Tensor:
        self.counts[("broadcast", tag)] += 1
        dist.broadcast(t, src, group=self.group)
        return t

    def all_gather_host(self, t: torch.Tensor, tag: str) -> list[torch.Tensor]:
        """Every rank's copy of a CPU tensor of the same shape, in rank order."""
        self.counts[("all_gather", tag)] += 1
        out = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(out, t, group=self.host_group)
        return out

    def all_gather_object(self, obj, tag: str) -> list:
        self.counts[("all_gather_object", tag)] += 1
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.host_group)
        return out


# --- leaves by path ----------------------------------------------------------

def _children(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every tensor in nested NamedTuples, dicts and
    tuples, in order; other leaves (None, ints) are left out."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    kids = _children(tree)
    if kids is None:
        return []
    return [x for k, v in kids
            for x in leaves_with_paths(v, f"{prefix}.{k}" if prefix else str(k))]


def map_with_paths(fn, tree, prefix: str = ""):
    """The tree with every tensor leaf x at path p replaced by fn(p, x)."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    kids = _children(tree)
    if kids is None:
        return tree
    vals = [map_with_paths(fn, v, f"{prefix}.{k}" if prefix else str(k)) for k, v in kids]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*vals)
    if isinstance(tree, dict):
        return dict(zip(tree, vals))
    return type(tree)(vals)


def is_env_local(path: str) -> bool:
    """Whether the TrainState leaf at `path` is per env (the module docstring's
    rule)."""
    top = path.split(".", 1)[0]
    if top not in LOCAL_PATHS:
        return False
    if top == "env_state":
        rest = path[len("env_state."):]
        return not any(rest == p or rest.startswith(p + ".") for p in REPLICATED_ENV_PATHS)
    return True


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A tensor shaped and typed as `like` from its bytes (copied: a view of
    another dtype needs an aligned offset)."""
    return buf.clone().view(like.dtype).reshape(like.shape)


def shard_train_state(group: DataParallel | None, ts):
    """The TrainState with every replicated leaf broadcast from rank 0 (one
    byte buffer, one collective); per-env leaves stay this rank's."""
    if group is None or group.world_size == 1:
        return ts
    leaves = [(p, x) for p, x in leaves_with_paths(ts) if not is_env_local(p)]
    buf = torch.cat([_bytes(x).to(group.device) for _, x in leaves])
    group.broadcast(buf, "replicated state")
    parts = iter(torch.split(buf, [x.numel() * x.element_size() for _, x in leaves]))
    new = {p: _from_bytes(next(parts), x).to(x.device) for p, x in leaves}
    return map_with_paths(lambda p, x: new.get(p, x), ts)


def gather_train_state(group: DataParallel | None, ts):
    """The whole TrainState of every rank's: per-env leaves gathered in rank
    order (CPU tensors of B rows), replicated ones as they are. Every rank
    calls it (one host all-gather)."""
    if group is None or group.world_size == 1:
        return ts
    local = [(p, x) for p, x in leaves_with_paths(ts) if is_env_local(p)]
    buf = torch.cat([_bytes(x).cpu() for _, x in local])
    parts = [torch.split(b, [x.numel() * x.element_size() for _, x in local])
             for b in group.all_gather_host(buf, "gather state")]
    whole = {p: torch.cat([_from_bytes(parts[r][i], x) for r in range(group.world_size)])
             for i, (p, x) in enumerate(local)}
    return map_with_paths(lambda p, x: whole.get(p, x), ts)


def scatter_train_state(group: DataParallel | None, ts):
    """This rank's TrainState of a whole one: rows `env_slice` of every
    per-env leaf, on the rank's device; nothing is communicated."""
    if group is None or group.world_size == 1:
        return ts

    def take(p, x):
        if not is_env_local(p):
            return x
        return x[group.env_slice(x.shape[0])].to(group.device).contiguous()

    return map_with_paths(take, ts)


def assert_sharded(group: DataParallel, ts) -> dict:
    """Check the placement of every TrainState leaf: a replicated leaf
    bit-identical on every rank (one all-gather of checksums), a per-env
    leaf of B / W rows, B / W the rank's observation rows. Returns
    {sharded: n, replicated: n}; raises AssertionError naming a leaf."""
    rows = ts.last_obs.shape[0]
    counts = {"sharded": 0, "replicated": 0}
    digests = {}
    for p, x in leaves_with_paths(ts):
        if is_env_local(p):
            if x.ndim == 0 or x.shape[0] != rows:
                raise AssertionError(f"{p}: per-env leaf of shape {tuple(x.shape)}, expected "
                                     f"{rows} rows")
            counts["sharded"] += 1
        else:
            digests[p] = hashlib.sha1(_bytes(x).cpu().numpy().tobytes()).hexdigest()
            counts["replicated"] += 1
    if group is not None and group.world_size > 1:
        for r, theirs in enumerate(group.all_gather_object(digests, "checksums")):
            bad = [p for p in digests if theirs.get(p) != digests[p]]
            if bad:
                raise AssertionError(f"replicated leaves differ between rank {group.rank} and "
                                     f"rank {r}: {bad}")
    return counts
