"""Actor/learner split (counterpart of handarm_tpu/parallel/actor_learner.py:
a sebulba-style pipeline).

The colocated PPO (`learn/ppo.py`) steps its envs and runs SGD in turn. Here
actors and the learner overlap:

- each **actor** owns an env of its own and rolls out `horizon` policy
  steps under a parameter snapshot that may be stale, on a thread of its
  own with its own CUDA stream and its own generator (on one card, actors
  and learner share it, as the JAX docstring allows; the kernels launch on
  the current stream, so they follow the actor's);
- the **learner** takes one trajectory from every actor, concatenates them
  on the env axis, runs the colocated update (`PPO._update_from_traj`) and
  publishes a fresh snapshot.

Snapshots and trajectories cross streams as copies ordered by CUDA events
(and `record_stream`, so the caching allocator reuses no block a stream may
still read). An actor starts its k-th rollout only under a snapshot of
version >= k - queue_depth, so the staleness a learner iteration reports,
`it - min(version)`, is at most `queue_depth`.

MLP policies only, as in the JAX package (recurrent rollouts carry per-env
state whose sequence layout is tied to the colocated path).
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
import traceback
from typing import Any, NamedTuple

import torch

from handarm_tpu_torch.learn.ppo import TrainState, Transition
from handarm_tpu_torch.parallel.mesh import leaves_with_paths, map_with_paths


class ActorSnapshot(NamedTuple):
    """What an actor needs of the TrainState; field names as TrainState's."""

    params: Any
    obs_stats: Any
    value_stats: Any
    teacher_obs_stats: Any
    version: int  # the learner iteration that produced it


def _tensors(tree) -> list:
    return [x for _, x in leaves_with_paths(tree)]


def _map(fn, tree):
    return map_with_paths(lambda _, x: fn(x), tree)


def snapshot_of(ts, version: int) -> ActorSnapshot:
    """A copy of the policy's part of `ts` (made on the current stream)."""
    clone = lambda t: _map(lambda x: x.detach().clone(), t)
    return ActorSnapshot(clone(ts.params), clone(ts.obs_stats), clone(ts.value_stats),
                         clone(ts.teacher_obs_stats), int(version))


class _Published:
    """The newest snapshot and the event after which it may be read."""

    def __init__(self):
        self.cond = threading.Condition()
        self.snap, self.event, self.closed = None, None, False

    def publish(self, snap: ActorSnapshot, event) -> None:
        with self.cond:
            self.snap, self.event = snap, event
            self.cond.notify_all()

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()

    def wait_for(self, version: int):
        """(snapshot, event) once one of at least `version` is out; None when
        closed."""
        with self.cond:
            self.cond.wait_for(lambda: self.closed or self.snap.version >= version)
            return None if self.closed else (self.snap, self.event)


class ActorLearner:
    """Pipelined actor/learner PPO.

    Args:
      ppo: a `PPO` whose config shapes the learner update; its env gives the
        observation and action sizes and the update's env count (actors x
        envs_per_actor), and is not stepped.
      make_env: `make_env(num_envs) -> env`, one actor's env (same task and
        config as ppo.env, fewer envs); its device is the actor's.
      envs_per_actor: env count per actor.
      num_actors: actor threads.
      queue_depth: bounds parameter staleness (see the module docstring).
    """

    def __init__(self, ppo, make_env, envs_per_actor: int, num_actors: int = 2,
                 queue_depth: int = 1):
        if ppo.recurrent:
            raise NotImplementedError("the actor/learner split supports MLP policies only")
        self.ppo, self.cfg = ppo, ppo.cfg
        self.envs_per_actor, self.queue_depth = envs_per_actor, queue_depth
        self.envs = [make_env(envs_per_actor) for _ in range(num_actors)]
        # each actor thread applies its own copy of the nets: functional_call
        # swaps a module's parameters while it runs
        self.actor_ppos = []
        for _ in range(num_actors):
            p = copy.copy(ppo)
            p.net = copy.deepcopy(ppo.net)
            p.actor = p.net.actor if ppo.asymmetric else p.net
            self.actor_ppos.append(p)
        self.rollouts = [0] * num_actors  # rollouts finished by each actor

    # --- actor side --------------------------------------------------------

    def _actor(self, idx: int, seed: int, rollouts: int, out: queue.Queue,
               stop: threading.Event, latest: _Published, errors: list) -> None:
        env, ppo = self.envs[idx], self.actor_ppos[idx]
        dev = env.device
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        try:
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                state, obs = env.reset(seed)
                teacher = None
                if ppo.asymmetric:  # zeros, as the JAX actors start
                    teacher = obs.new_zeros((obs.shape[0], env.num_teacher_obs))
                for k in range(rollouts):
                    got = latest.wait_for(k - self.queue_depth)
                    if got is None:
                        break
                    snap, ready = got
                    if stream is not None:
                        stream.wait_event(ready)
                        for t in _tensors(snap):
                            t.record_stream(stream)
                    ts = ppo_state(snap, state, obs, teacher)
                    r = ppo.rollout(ts, gen=gen, env=env)
                    done = None
                    if stream is not None:
                        done = torch.cuda.Event()
                        done.record(stream)
                    state, obs, teacher = r.env_state, r.last_obs, r.last_teacher_obs
                    self.rollouts[idx] += 1
                    item = (idx, r.traj, r.last_obs, r.last_teacher_obs, r.info,
                            snap.version, done)
                    while not stop.is_set():
                        try:
                            out.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        except BaseException:  # reported to the learner, which raises it
            errors.append(f"actor {idx}:\n{traceback.format_exc()}")

    # --- learner side ------------------------------------------------------

    @staticmethod
    def merge(parts: list):
        """(trajectory, last observations, last teacher observations, info) of
        the actors' parts, in actor order: trajectories concatenated on the
        env axis ([T, B, ...]), per-env planes of the last step's info
        concatenated on theirs, per-actor scalars averaged (the JAX rule:
        a [K] per-object plane concatenates too)."""
        parts = sorted(parts, key=lambda p: p[0])
        cat = lambda xs, d: None if xs[0] is None else torch.cat(xs, dim=d)
        traj = Transition(*(cat([p[1][i] for p in parts], 1)
                            for i in range(len(Transition._fields))))
        last_obs = cat([p[2] for p in parts], 0)
        last_teacher = cat([p[3] for p in parts], 0)
        info = {k: (torch.cat([p[4][k] for p in parts]) if v.ndim >= 1
                    else torch.stack([p[4][k] for p in parts]).mean(dim=0))
                for k, v in parts[0][4].items()}
        return traj, last_obs, last_teacher, info

    def learner_update(self, ts, traj, last_obs, last_teacher, info, perms=None):
        """The colocated update on the merged trajectory (the JAX
        `_learner_update`); the learner's env state passes through."""
        return self.ppo._update_from_traj(ts, traj, ts.env_state, last_obs, perms, info,
                                          last_teacher)

    def run(self, ts, iterations: int, seed: int = 0, timeout_s: float = 600.0):
        """Drive `iterations` learner updates; returns (ts, stats list). Each
        update takes one trajectory from every actor; its stats add
        `staleness` = it - the oldest snapshot version among them. Each
        actor thread (seeded seed * 1000 + actor) rolls out `iterations`
        times, none past what the learner takes, and is joined before the
        return; an actor's failure, or no trajectory within `timeout_s`,
        raises."""
        n = len(self.envs)
        outs = [queue.Queue(maxsize=self.queue_depth + 1) for _ in range(n)]
        stop, latest, errors = threading.Event(), _Published(), []
        learner_stream = torch.cuda.current_stream() if self.ppo.device.type == "cuda" else None

        def publish(state, version):
            snap = snapshot_of(state, version)
            ev = None
            if learner_stream is not None:
                ev = torch.cuda.Event()
                ev.record(learner_stream)
            latest.publish(snap, ev)

        publish(ts, 0)
        threads = [threading.Thread(target=self._actor, name=f"actor-{i}",
                                    args=(i, seed * 1000 + i, iterations, outs[i], stop,
                                          latest, errors))
                   for i in range(n)]
        for t in threads:
            t.start()
        stats_list = []
        try:
            for it in range(iterations):
                parts = [self._take(q, errors, timeout_s) for q in outs]
                dev = self.ppo.device
                if learner_stream is not None:
                    for p in parts:
                        learner_stream.wait_event(p[6])
                        for t in _tensors(p[1:5]):
                            t.record_stream(learner_stream)
                parts = [(p[0],) + _map(lambda x: x.to(dev), p[1:5]) + p[5:] for p in parts]
                traj, last_obs, last_teacher, info = self.merge(parts)
                ts, stats = self.learner_update(ts, traj, last_obs, last_teacher, info)
                stats["staleness"] = torch.tensor(float(it - min(p[5] for p in parts)),
                                                  device=dev)
                stats_list.append(stats)
                publish(ts, it + 1)
        finally:
            stop.set()
            latest.close()
            for t in threads:
                t.join(timeout_s)
        if any(t.is_alive() for t in threads):
            raise TimeoutError("an actor thread did not stop")
        if errors:
            raise RuntimeError("\n".join(errors))
        return ts, stats_list

    @staticmethod
    def _take(q: queue.Queue, errors: list, timeout_s: float):
        waited = 0.0
        while True:
            if errors:
                raise RuntimeError("\n".join(errors))
            try:
                return q.get(timeout=0.5)
            except queue.Empty:
                waited += 0.5
                if waited >= timeout_s:
                    raise TimeoutError(f"no trajectory from an actor within {timeout_s} s")


def ppo_state(snap: ActorSnapshot, env_state, obs, teacher):
    """A TrainState-shaped record of an actor's rollout: the snapshot's
    policy, the actor's env state and observations."""
    return TrainState(snap.params, None, snap.obs_stats, snap.value_stats, None, env_state,
                      obs, None, teacher_obs_stats=snap.teacher_obs_stats,
                      last_teacher_obs=teacher)

