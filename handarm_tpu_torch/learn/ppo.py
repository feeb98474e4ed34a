"""PPO with GAE (counterpart of handarm_tpu/learn/ppo.py).

One `train_iter` is a rollout of `horizon` stochastic policy steps through
the env, then `_update_from_traj`: the bootstrap value of the last
observation, GAE, the env-major flatten, the once-per-iteration updates of
the observation, teacher-observation and value statistics, and
`mini_epochs` passes of minibatched SGD with the clipped surrogate, the
(clipped) value loss, the bounds loss and a KL-adaptive (or fixed) learning
rate, then the KL guard that discards a catastrophic iteration. Every
switch of the JAX PPOConfig is ported with its branch.

`data_shards` = D lays the env-major samples out as D shards of B / D envs
each, and each mini-epoch draws one permutation per shard ([mini_epochs,
D, rows / D] `perms`): a minibatch takes minibatch_size / D rows of every
shard, shard-local indices, as the JAX package's `take_mb`. With one
process that is a layout alone. Under `torch.distributed` (a
`parallel.mesh.DataParallel` group of W ranks, D a multiple of W) each rank
holds B / W envs, D / W of the shards, and where the JAX program reduces
over the global batch the rank makes one all-reduce: the batch moments of
the running stats and of the advantage normalization (two, for all of
them: a global mean, then a global sum of squared deviations), the
returned reward and done means (one), and per minibatch step one flat
bucket of every gradient and loss term, averaged; the gradient clip, the
Adam step and the KL-driven lr then run alike on every rank. The learner's
generator (init, permutations) is seeded alike on every rank; the policy
noise and the env draw from generators seeded by rank.

Four layouts of the learner:
- the MLP `ActorCritic` (`rnn_units=0`);
- with `asymmetric_critic`, a `ValueNet` on the env's teacher observations
  is the critic, and the params are {"actor": ..., "critic": ...}
  (`AsymmetricActorCritic`; module names prefixed `actor.` and `critic.`);
- with `rnn_units > 0`, the LSTM-before-MLP `RecurrentActorCritic` (and,
  asymmetric, a `RecurrentValueNet` of `critic_rnn_units or rnn_units`).
  The rollout threads the carry (c, h) through the env steps, stores each
  step's pre-step carry, and zeroes the post-step carry of an env whose
  episode ended (with `zero_rnn_on_done`). The update cuts the env-major
  samples into sequences of `seq_len` steps, permutes sequences, and
  unrolls each from the carry stored at its first step, zeroing it again
  after a done inside the sequence (with `zero_rnn_on_done`): truncated
  BPTT from the stored chunk-start states, as the JAX package.

Parameters are a dict of tensors by module name, in flax order, applied
through `torch.func.functional_call`. The learning rate, the epoch, the
guard and every returned stat are 0-d tensors on the device, and every
choice between values is a `torch.where`: an iteration reads nothing back
to the host. Every random draw (policy noise, minibatch permutations,
init) comes from the learner's `gen`, or is passed in.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.func import functional_call

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.learn import optim
from handarm_tpu_torch.learn.networks import (
    ActorCritic,
    AsymmetricActorCritic,
    RecurrentActorCritic,
    RecurrentValueNet,
    ValueNet,
    asymmetric_names,
    flax_names,
    recurrent_names,
    value_net_names,
)
from handarm_tpu_torch.learn.running_stats import (
    RunningStats,
    clean_batch,
    denormalize,
    init_stats,
    merge_stats,
    normalize,
)


class PPOConfig(NamedTuple):
    horizon: int = 16
    num_minibatches: int = 0  # 0: num_envs * horizon // minibatch_size
    minibatch_size: int = 32768
    mini_epochs: int = 4
    gamma: float = 0.99
    tau: float = 0.95  # GAE lambda
    learning_rate: float = 3e-4
    kl_threshold: float = 0.016  # adaptive LR target
    lr_schedule: str = "adaptive"  # adaptive | fixed
    e_clip: float = 0.15
    clip_value: bool = True
    critic_coef: float = 4.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.0001
    grad_norm: float = 1.0
    reward_scale: float = 0.01
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    value_bootstrap: bool = True  # a timed-out episode earns its value
    max_lr: float = 1e-2
    min_lr: float = 1e-6
    # an iteration whose mean policy KL exceeds this is discarded whole
    # (params, optimizer state, both stats), from epoch 8 on
    kl_guard: float = 1.0
    hidden: tuple = (768, 512, 256)
    asymmetric_critic: bool = False  # the critic sees the teacher observations
    rnn_units: int = 0  # LSTM width; 0: the MLP policy
    seq_len: int = 4  # BPTT sequence length
    zero_rnn_on_done: bool = True
    critic_rnn_units: int = 0  # the recurrent critic's LSTM width; 0: rnn_units
    # shards of the env axis in the update's layout (the data mesh's size in
    # the JAX package); a multiple of the ranks' count
    data_shards: int = 1


RANK_SEED_STRIDE = 1_000_003  # rank r's env and noise draws: seed + r * stride


def param_names(cfg: PPOConfig) -> list[tuple[str, str]]:
    """(flax name, module name) of every parameter of the learner `cfg`
    builds, in flax order: the order of optax's state and of a checkpoint's
    param leaves."""
    n = len(cfg.hidden)
    if cfg.rnn_units > 0:
        actor = recurrent_names(n, actor=True)
        critic = recurrent_names(n, actor=False)
    else:
        actor, critic = flax_names(n), value_net_names(n)
    return asymmetric_names(actor, critic) if cfg.asymmetric_critic else actor


def ppo_config(overrides: dict) -> PPOConfig:
    """A PPOConfig from the overrides a task composes to (`hidden` as a
    list or tuple). An unknown field raises KeyError."""
    kw = {}
    for k, v in overrides.items():
        if k not in PPOConfig._fields:
            raise KeyError(f"unknown PPOConfig field {k!r}")
        kw[k] = tuple(v) if k == "hidden" else v
    if kw.get("lr_schedule", "adaptive") not in ("adaptive", "fixed"):
        raise ValueError(f"lr_schedule {kw['lr_schedule']!r} is not adaptive or fixed")
    return PPOConfig(**kw)


class TrainState(NamedTuple):
    params: dict  # module name -> tensor, flax order
    opt_state: optim.OptState
    obs_stats: RunningStats
    value_stats: RunningStats
    lr: torch.Tensor  # float32 scalar
    env_state: Any
    last_obs: torch.Tensor
    epoch: torch.Tensor  # int32 scalar
    teacher_obs_stats: RunningStats | None = None  # asymmetric only
    last_teacher_obs: torch.Tensor | None = None  # asymmetric only
    # the LSTM carry per env: (c, h), or {"actor": (c, h), "critic": (c, h)}
    # when asymmetric; None for the MLP
    hidden: Any = None


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    teacher_obs: torch.Tensor | None = None  # asymmetric only
    hidden: Any = None  # the pre-step carry (recurrent only)


class Rollout(NamedTuple):
    traj: Transition  # [horizon, B, ...]
    env_state: Any
    last_obs: torch.Tensor  # the observations after the last step
    info: dict | None  # the last step's
    last_teacher_obs: torch.Tensor | None  # asymmetric only
    last_hidden: Any  # the carry after the last step, zeroed where done


def gaussian_logp(mu, log_std, a):
    return torch.sum(-0.5 * ((a - mu) / torch.exp(log_std)) ** 2 - log_std
                     - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gae(reward, value, done, last_value, gamma: float, tau: float):
    """Advantages [T, B] of a trajectory, from its last state's value."""
    adv_next, v_next = torch.zeros_like(last_value), last_value
    out = []
    for t in reversed(range(reward.shape[0])):
        nonterminal = 1.0 - done[t].to(torch.float32)
        delta = reward[t] + gamma * v_next * nonterminal - value[t]
        adv_next = delta + gamma * tau * nonterminal * adv_next
        v_next = value[t]
        out.append(adv_next)
    return torch.stack(out[::-1])


def flatten_env_major(x: torch.Tensor) -> torch.Tensor:
    """[T, B, ...] -> [B * T, ...], each env's steps contiguous."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def where_stats(cond, a: RunningStats | None, b: RunningStats | None):
    if a is None:
        return None
    return RunningStats(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def carry_map(fn, *carries):
    """Map over the tensors of LSTM carries: (c, h) tuples, or dicts of them."""
    c0 = carries[0]
    if c0 is None:
        return None
    if isinstance(c0, dict):
        return {k: carry_map(fn, *(c[k] for c in carries)) for k in c0}
    if isinstance(c0, tuple):
        return tuple(carry_map(fn, *xs) for xs in zip(*carries))
    return fn(*carries)


def zero_where(done: torch.Tensor, carry):
    """The carry with the rows of envs where `done` set to 0."""
    return carry_map(lambda x: torch.where(done[:, None], torch.zeros_like(x), x), carry)


def carry_items(carry, prefix: str = "h0") -> dict:
    """The carry's tensors by flat name: `h0.c`, `h0.h`, or `h0.actor.c` ..."""
    if isinstance(carry, dict):
        return {k: v for name, c in carry.items()
                for k, v in carry_items(c, f"{prefix}.{name}").items()}
    return {f"{prefix}.c": carry[0], f"{prefix}.h": carry[1]}


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


class PPO:
    """Ties an env (`step`, `reset`, `num_obs`, `num_actions`,
    `cfg.num_envs`; with an asymmetric critic also `observe` and
    `num_teacher_obs`) to the train iteration. `device` defaults to the
    env's. `group`: the rank's `parallel.mesh.DataParallel` when the env
    holds this rank's B / W envs (None: one process holds all)."""

    def __init__(self, env, cfg: PPOConfig = PPOConfig(), device=None, group=None):
        if group is not None and group.world_size == 1:
            group = None  # one rank holds every env: nothing to reduce
        self.env, self.cfg, self.group = env, cfg, group
        W = group.world_size if group is not None else 1
        self.rank = group.rank if group is not None else 0
        self.device = resolve_device(device) if device is not None else env.device
        self.asymmetric, self.recurrent = cfg.asymmetric_critic, cfg.rnn_units > 0
        num_teacher = getattr(env, "num_teacher_obs", 0)
        if self.asymmetric and num_teacher <= 0:
            raise ValueError("asymmetric_critic requires env teacher_observations")
        if self.recurrent:
            if cfg.horizon % cfg.seq_len:
                raise ValueError(f"seq_len {cfg.seq_len} does not divide horizon {cfg.horizon}")
            actor = RecurrentActorCritic(env.num_obs, env.num_actions, cfg.rnn_units, cfg.hidden)
            critic = RecurrentValueNet(num_teacher, cfg.critic_rnn_units or cfg.rnn_units,
                                       cfg.hidden) if self.asymmetric else None
        else:
            actor = ActorCritic(env.num_obs, env.num_actions, cfg.hidden)
            critic = ValueNet(num_teacher, cfg.hidden) if self.asymmetric else None
        net = AsymmetricActorCritic(actor, critic) if self.asymmetric else actor
        self.net = net.to(self.device)
        self.actor = self.net.actor if self.asymmetric else self.net
        B = env.cfg.num_envs * W  # the global batch's envs
        batch = B * cfg.horizon
        self.num_minibatches = cfg.num_minibatches or max(1, batch // cfg.minibatch_size)
        if batch % self.num_minibatches:
            raise ValueError(f"{batch} samples do not split into {self.num_minibatches} "
                             "minibatches")
        self.mb_size = batch // self.num_minibatches
        if self.recurrent and self.mb_size % cfg.seq_len:
            raise ValueError(f"seq_len {cfg.seq_len} does not divide the minibatch "
                             f"{self.mb_size}")
        # rows of the prepared samples per minibatch: samples, or sequences
        self.mb_rows = self.mb_size // cfg.seq_len if self.recurrent else self.mb_size
        D = cfg.data_shards
        if D < 1 or D % W or B % D or self.mb_rows % D:
            raise ValueError(f"data_shards {D} must divide the {B} envs and the minibatch's "
                             f"{self.mb_rows} rows, and be a multiple of the {W} ranks")
        self.shard_rows = batch // (cfg.seq_len if self.recurrent else 1) // D
        self.gen = torch.Generator(device=self.device)
        # the policy noise: per env, so drawn by rank where there are ranks
        self.noise_gen = self.gen if W == 1 else torch.Generator(device=self.device)

    # --- init ---------------------------------------------------------------

    def init_carry(self, batch: int):
        """A zero LSTM carry of `batch` envs (None for the MLP)."""
        return self.net.init_carry(batch, self.device) if self.recurrent else None

    def init(self, seed: int) -> TrainState:
        """Env reset, flax-default params, a fresh optimizer and fresh
        stats, the configured learning rate, a zero carry; draws from
        `seed`. With an asymmetric critic, the teacher observations of the
        reset state (`env.observe`). Under ranks the params draw alike on
        every rank; rank r's env and policy noise draw from seed + r *
        RANK_SEED_STRIDE."""
        self.gen.manual_seed(seed)
        rank_seed = seed + self.rank * RANK_SEED_STRIDE
        if self.noise_gen is not self.gen:
            self.noise_gen.manual_seed(rank_seed)
        env_state, obs = self.env.reset(rank_seed)
        params = self.net.init_flax_default(self.gen).param_dict()
        dev = self.device
        teacher_stats = last_teacher = None
        if self.asymmetric:
            _, last_teacher, _ = self.env.observe(env_state)
            teacher_stats = init_stats((self.env.num_teacher_obs,), dev)
        return TrainState(
            params=params, opt_state=optim.init(params),
            obs_stats=init_stats((self.env.num_obs,), dev), value_stats=init_stats((), dev),
            lr=torch.tensor(self.cfg.learning_rate, dtype=torch.float32, device=dev),
            env_state=env_state, last_obs=obs,
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            teacher_obs_stats=teacher_stats, last_teacher_obs=last_teacher,
            hidden=self.init_carry(obs.shape[0]),
        )

    # --- net helpers --------------------------------------------------------

    def forward(self, params: dict, stats: tuple, obs: torch.Tensor, teacher_obs=None,
                carry=None):
        """(mu, log_std, value, new carry or None) of raw observations (and
        teacher observations); `stats` = (observation stats, teacher
        observation stats or None)."""
        obs_stats, teacher_stats = stats
        norm = self.cfg.normalize_input
        args = (normalize(obs_stats, obs) if norm else obs,)
        if self.asymmetric:
            args += (normalize(teacher_stats, teacher_obs) if norm else teacher_obs,)
        if self.recurrent:
            return functional_call(self.net, params, args + (carry,))
        return (*functional_call(self.net, params, args), None)

    def policy_value(self, params: dict, obs_stats: RunningStats, obs: torch.Tensor):
        """(mu, log_std, value) of raw observations (the MLP ActorCritic)."""
        return self.forward(params, (obs_stats, None), obs)[:3]

    def value_of(self, value_stats: RunningStats, value: torch.Tensor) -> torch.Tensor:
        """The critic's output in reward units; a non-finite value becomes 0."""
        if self.cfg.normalize_value:
            value = denormalize(value_stats, value)
        return torch.where(torch.isfinite(value), value, torch.zeros_like(value))

    # --- one train iteration ------------------------------------------------

    def train_iter(self, ts: TrainState, noise=None, perms=None):
        """(new TrainState, stats). `noise` [horizon, B, A] replaces the
        policy's normal draws, `perms` the minibatch permutations
        ([mini_epochs, data_shards, rows / data_shards], `minibatch_rows`):
        of the B * horizon samples, or on the recurrent path of the B *
        horizon / seq_len sequences."""
        r = self.rollout(ts, noise)
        return self._update_from_traj(ts, r.traj, r.env_state, r.last_obs, perms, r.info,
                                      r.last_teacher_obs, r.last_hidden)

    @torch.no_grad()
    def rollout(self, ts: TrainState, noise=None, gen=None, env=None) -> Rollout:
        """`horizon` stochastic policy steps (see `Rollout`) of `env`
        (default: the learner's); the noise from `noise`, else from `gen`
        (default: the learner's noise generator)."""
        gen = self.noise_gen if gen is None else gen
        env = self.env if env is None else env
        cfg = self.cfg
        stats = (ts.obs_stats, ts.teacher_obs_stats)
        env_state, obs, teacher, h = ts.env_state, ts.last_obs, ts.last_teacher_obs, ts.hidden
        steps, info = [], None
        for t in range(cfg.horizon):
            mu, log_std, value, h_next = self.forward(ts.params, stats, obs, teacher, h)
            eps = noise[t] if noise is not None else torch.randn(
                mu.shape, generator=gen, device=mu.device)
            sigma = torch.exp(log_std)
            a = mu + sigma * eps
            logp = gaussian_logp(mu, log_std, a)
            env_state, res = env.step(env_state, a)
            value = self.value_of(ts.value_stats, value)
            zero = torch.zeros_like(res.reward)
            reward = torch.where(torch.isfinite(res.reward), res.reward, zero) * cfg.reward_scale
            if cfg.value_bootstrap:
                # a timed-out episode earns the discounted value of where it
                # stopped; `where`, not a multiply by the done mask: a
                # non-finite value times 0 is still NaN
                reward = reward + cfg.gamma * torch.where(
                    res.done & torch.isfinite(value), value, zero)
            steps.append(Transition(obs, a, logp, value, reward, res.done, mu, sigma,
                                    teacher, h))
            if self.recurrent and cfg.zero_rnn_on_done:
                h_next = zero_where(res.done, h_next)
            h, info = h_next, res.info
            obs = _finite(res.obs)
            if self.asymmetric:
                teacher = _finite(res.teacher_obs)
        traj = Transition(*(carry_map(lambda *xs: torch.stack(xs), *field)
                            for field in zip(*steps)))
        return Rollout(traj, env_state, obs, info, teacher, h)

    @torch.no_grad()
    def _update_from_traj(self, ts: TrainState, traj: Transition, env_state, last_obs,
                          perms=None, info=None, last_teacher_obs=None, last_hidden=None):
        """GAE, the stats updates and the minibatched PPO epochs on a
        collected trajectory; (new TrainState, stats)."""
        cfg = self.cfg
        data, obs_stats, value_stats, teacher_stats = self._prepare(
            ts, traj, last_obs, last_teacher_obs, last_hidden)
        if perms is None:
            perms = self.draw_perms(data["adv"].device)
        params, opt_state, lr, aux = self._sgd(ts, data, self.minibatch_rows(perms))

        kl_mean = aux["kl"].mean()
        guard = (ts.epoch >= 8) & (~torch.isfinite(kl_mean) | (kl_mean > cfg.kl_guard))
        params = {k: torch.where(guard, ts.params[k], p) for k, p in params.items()}
        opt_state = optim.where(guard, ts.opt_state, opt_state)
        obs_stats = where_stats(guard, ts.obs_stats, obs_stats)
        value_stats = where_stats(guard, ts.value_stats, value_stats)
        teacher_stats = where_stats(guard, ts.teacher_obs_stats, teacher_stats)
        lr = torch.where(guard, torch.clamp(ts.lr / 2.0, min=cfg.min_lr), lr)

        done = traj.done.to(torch.float32)
        if self.group is None:
            reward_mean, done_frac = traj.reward.mean(), done.mean()
        else:
            sums = self.group.all_reduce(torch.stack([traj.reward.sum(), done.sum()]), "means")
            reward_mean, done_frac = sums / (done.numel() * self.group.world_size)
        stats = dict(
            reward_mean=reward_mean / cfg.reward_scale,
            episode_done_frac=done_frac,
            kl=kl_mean,
            kl_guard_triggered=guard.to(torch.float32),
            policy_loss=aux["policy_loss"].mean(),
            value_loss=aux["value_loss"].mean(),
            entropy=aux["entropy"].mean(),
            lr=lr,
            success_rate_ewma=(info["success_rate_ewma"] if info is not None
                               and "success_rate_ewma" in info
                               else torch.zeros((), device=lr.device)),
        )
        if info is not None and "per_object_success_ewma" in info:
            for k, v in enumerate(info["per_object_success_ewma"]):
                stats[f"success_ewma_obj{k}"] = v
        new_ts = TrainState(
            params, opt_state, obs_stats, value_stats, lr, env_state, last_obs, ts.epoch + 1,
            teacher_obs_stats=teacher_stats,
            last_teacher_obs=last_teacher_obs if self.asymmetric else ts.last_teacher_obs,
            hidden=last_hidden)
        return new_ts, stats

    def draw_perms(self, device) -> torch.Tensor:
        """[mini_epochs, data_shards, rows / data_shards]: per mini-epoch, one
        permutation per shard from the learner's generator."""
        cfg = self.cfg
        return torch.stack([torch.stack([
            torch.randperm(self.shard_rows, generator=self.gen, device=device)
            for _ in range(cfg.data_shards)]) for _ in range(cfg.mini_epochs)])

    def minibatch_rows(self, perms: torch.Tensor) -> torch.Tensor:
        """[mini_epochs * minibatches, rows per minibatch on this rank]: the
        rows of this rank's samples each minibatch step takes. `perms`
        [mini_epochs, data_shards, rows / data_shards] (or [mini_epochs,
        rows] with one shard) holds shard-local indices; step i of an epoch
        takes entries [i m, (i + 1) m) of each shard's permutation, m =
        minibatch rows / data_shards, shard after shard, as the JAX
        package's `take_mb`. This rank holds shards [r D / W, (r + 1) D / W)."""
        cfg = self.cfg
        E, D, n = cfg.mini_epochs, cfg.data_shards, self.shard_rows
        if perms.numel() != E * D * n:
            raise ValueError(f"perms {tuple(perms.shape)} are not [{E}, {D}, {n}]")
        W = self.group.world_size if self.group is not None else 1
        D_loc, m = D // W, self.mb_rows // D
        p = perms.reshape(E, D, n)[:, self.rank * D_loc:(self.rank + 1) * D_loc]
        p = p + (torch.arange(D_loc, device=p.device) * n)[None, :, None]
        p = p.reshape(E, D_loc, self.num_minibatches, m).transpose(1, 2)
        return p.reshape(E * self.num_minibatches, D_loc * m)

    def _moments(self, xs: list, n: int) -> list:
        """(mean, population variance) over the first axis of each batch in
        `xs`, of n samples in all: this batch's alone, or under ranks of the
        global batch (two all-reduces for all of them)."""
        if self.group is None:
            return [(x.mean(dim=0), x.var(dim=0, correction=0)) for x in xs]
        sizes = [x[0].numel() for x in xs]
        sums = self.group.all_reduce(torch.cat([x.sum(dim=0).reshape(-1) for x in xs]),
                                     "moments")
        means = [m.reshape(x.shape[1:]) / n for m, x in zip(torch.split(sums, sizes), xs)]
        ssd = self.group.all_reduce(torch.cat([((x - m) ** 2).sum(dim=0).reshape(-1)
                                               for x, m in zip(xs, means)]), "moments")
        return [(m, v.reshape(x.shape[1:]) / n)
                for m, v, x in zip(means, torch.split(ssd, sizes), xs)]

    def _prepare(self, ts: TrainState, traj: Transition, last_obs, last_teacher_obs=None,
                 last_hidden=None):
        """(the samples of the update, flattened env-major: the rollout's
        fields with the normalized advantages, returns and values, and the
        teacher observations when asymmetric; the updated observation,
        value and teacher-observation stats). On the recurrent path every
        field is [sequences, seq_len, ...], with `dprev` (the previous
        step's done within each sequence) and the carry stored at each
        sequence's first step (`carry_items`, [sequences, R])."""
        cfg = self.cfg
        _, _, last_value, _ = self.forward(ts.params, (ts.obs_stats, ts.teacher_obs_stats),
                                           last_obs, last_teacher_obs, last_hidden)
        last_value = self.value_of(ts.value_stats, last_value)
        advantages = gae(traj.reward, traj.value, traj.done, last_value, cfg.gamma, cfg.tau)
        returns = advantages + traj.value
        batch = Transition(*(flatten_env_major(x) for x in traj[:8]))
        adv = flatten_env_major(advantages)
        ret = flatten_env_major(returns)

        # the batch moments of the stats' updates and of the advantage
        # normalization: of the global batch (n samples) under ranks
        n = adv.shape[0] * (self.group.world_size if self.group is not None else 1)
        stats_in = {}  # name -> (stats, cleaned batch)
        if cfg.normalize_input:
            stats_in["obs"] = ts.obs_stats, clean_batch(ts.obs_stats, batch.obs, n)
        if cfg.normalize_value:
            stats_in["value"] = ts.value_stats, clean_batch(ts.value_stats, ret, n)
        teacher = flatten_env_major(traj.teacher_obs) if self.asymmetric else None
        if self.asymmetric and cfg.normalize_input:
            stats_in["teacher"] = (ts.teacher_obs_stats,
                                   clean_batch(ts.teacher_obs_stats, teacher, n))
        xs = [x for _, x in stats_in.values()] + ([adv] if cfg.normalize_advantage else [])
        moments = self._moments(xs, n)
        new = {k: merge_stats(s, *moments[i], n) for i, (k, (s, _)) in enumerate(stats_in.items())}
        obs_stats = new.get("obs", ts.obs_stats)
        value_stats = new.get("value", ts.value_stats)
        teacher_stats = new.get("teacher", ts.teacher_obs_stats)
        if cfg.normalize_advantage:
            a_mean, a_var = moments[-1]
            adv = (adv - a_mean) / (torch.sqrt(a_var) + 1e-8)  # jnp.std: ddof 0
        returns_n, values_n = ret, batch.value
        if cfg.normalize_value:
            returns_n = normalize(value_stats, ret, clip=math.inf)
            values_n = normalize(value_stats, batch.value, clip=math.inf)
        data = dict(obs=batch.obs, action=batch.action, logp=batch.logp, adv=adv,
                    return_n=returns_n, value_n=values_n, mu=batch.mu, sigma=batch.sigma)
        if self.asymmetric:
            data["teacher_obs"] = teacher
        if self.recurrent:
            # env-major samples b * T + t are sequence b * T / L + t // L,
            # step t % L
            L = cfg.seq_len
            data = {k: v.reshape((-1, L) + tuple(v.shape[1:])) for k, v in data.items()}
            done = batch.done.reshape(-1, L)
            data["dprev"] = torch.cat([torch.zeros_like(done[:, :1]), done[:, :-1]], dim=1)
            chunk_start = lambda h: flatten_env_major(h[::L])  # [T, B, R] -> [B * T / L, R]
            data.update(carry_items(carry_map(chunk_start, traj.hidden)))
        return data, obs_stats, value_stats, teacher_stats

    def _sgd(self, ts: TrainState, data: dict, minibatches: torch.Tensor):
        """(params, optimizer state, lr, aux stacked by step) after one
        minibatch step per row of sample (or sequence) indices
        `minibatches`, from the learner of `ts`."""
        params, opt_state, lr = ts.params, ts.opt_state, ts.lr
        # the loss normalizes with the ROLLOUT-time stats: mu and logp were
        # recorded under them; the new stats take effect on the next rollout
        stats = (ts.obs_stats, ts.teacher_obs_stats)
        auxs = []
        for idx in minibatches:
            mb = {k: v.index_select(0, idx) for k, v in data.items()}
            params, opt_state, lr, aux = self._mb_step(stats, params, opt_state, lr, mb)
            auxs.append(aux)
        aux = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
        return params, opt_state, lr, aux

    def _mb_step(self, stats, params, opt_state, lr, mb):
        grads, aux = self._grads(stats, params, mb)
        if self.group is not None:
            grads, aux = self._average(grads, aux)
        params, opt_state, lr = self._apply(params, opt_state, lr, grads, aux["kl"])
        return params, opt_state, lr, aux

    def _average(self, grads: dict, aux: dict) -> tuple[dict, dict]:
        """The gradients and loss terms of the global minibatch: every rank's,
        averaged, in one all-reduce of one flat bucket (each rank's loss is
        the mean over its equal share of the minibatch)."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()]
                         + [torch.stack(list(aux.values()))])
        flat = self.group.all_reduce(flat, "grads") / self.group.world_size
        parts = torch.split(flat, [g.numel() for g in grads.values()] + [len(aux)])
        grads = {k: p.reshape(g.shape) for (k, g), p in zip(grads.items(), parts)}
        return grads, dict(zip(aux, parts[-1].unbind()))

    def _grads(self, stats, params, mb):
        """(gradients of the loss by parameter, detached aux). A parameter
        the loss does not reach (the asymmetric actor's value head) gets a
        zero gradient, as under jax.grad."""
        with torch.enable_grad():
            leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
            total, aux = self._loss(leaves, stats, mb)
            grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        return {k: torch.zeros_like(p) if g is None else g
                for (k, p), g in zip(leaves.items(), grads)}, aux

    def _apply(self, params, opt_state, lr, grads, kl):
        """One optimizer step, then the adaptive lr from this minibatch's KL
        (measured before the step)."""
        cfg = self.cfg
        updates, opt_state = optim.update(grads, opt_state, cfg.grad_norm)
        params = {k: p + updates[k] * lr for k, p in params.items()}
        if cfg.lr_schedule == "adaptive":
            lr = torch.where(
                kl > 2.0 * cfg.kl_threshold, torch.clamp(lr / 1.5, min=cfg.min_lr),
                torch.where(kl < 0.5 * cfg.kl_threshold,
                            torch.clamp(lr * 1.5, max=cfg.max_lr), lr))
        return params, opt_state, lr

    def _unroll(self, params, stats, mb):
        """(mu, log_std, value), each [sequences, seq_len, ...], of the nets
        run over each sequence from its stored first carry."""
        if self.asymmetric:
            carry = {k: (mb[f"h0.{k}.c"], mb[f"h0.{k}.h"]) for k in ("actor", "critic")}
        else:
            carry = mb["h0.c"], mb["h0.h"]
        teacher = mb.get("teacher_obs")
        outs = []
        for t in range(self.cfg.seq_len):
            if self.cfg.zero_rnn_on_done:
                carry = zero_where(mb["dprev"][:, t], carry)
            *out, carry = self.forward(params, stats, mb["obs"][:, t],
                                       None if teacher is None else teacher[:, t], carry)
            outs.append(out)
        return tuple(torch.stack(x, dim=1) for x in zip(*outs))

    def _loss(self, params, stats, mb):
        """(total loss, detached aux) of one minibatch, as the JAX loss_fn."""
        cfg = self.cfg
        if self.recurrent:
            mu, log_std, value = self._unroll(params, stats, mb)
        else:
            mu, log_std, value, _ = self.forward(params, stats, mb["obs"], mb.get("teacher_obs"))
        logp = gaussian_logp(mu, log_std, mb["action"])
        ratio = torch.exp(logp - mb["logp"])
        surr1 = ratio * mb["adv"]
        surr2 = torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip) * mb["adv"]
        policy_loss = -torch.mean(torch.minimum(surr1, surr2))
        v_loss = (value - mb["return_n"]) ** 2
        if cfg.clip_value:
            v_clipped = mb["value_n"] + torch.clamp(value - mb["value_n"], -cfg.e_clip,
                                                    cfg.e_clip)
            v_loss = torch.maximum(v_loss, (v_clipped - mb["return_n"]) ** 2)
        value_loss = 0.5 * torch.mean(v_loss)
        entropy = torch.mean(torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e),
                                       dim=-1))
        # soft bound pushing mu into [-1.1, 1.1]
        mu_excess = torch.clamp(torch.abs(mu) - 1.1, min=0.0)
        bounds_loss = torch.mean(torch.sum(mu_excess ** 2, dim=-1))
        total = (policy_loss + cfg.critic_coef * 0.5 * value_loss
                 - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * bounds_loss)
        with torch.no_grad():
            # KL(old || new) for the adaptive LR (rl_games policy_kl form)
            old_sigma, sigma = mb["sigma"], torch.exp(log_std)
            kl = torch.sum(torch.log(sigma / old_sigma)
                           + (old_sigma ** 2 + (mb["mu"] - mu) ** 2) / (2.0 * sigma ** 2)
                           - 0.5, dim=-1).mean()
        aux = dict(policy_loss=policy_loss.detach(), value_loss=value_loss.detach(),
                   entropy=entropy.detach(), kl=kl, bounds_loss=bounds_loss.detach())
        return total, aux

    # --- inference ----------------------------------------------------------

    @torch.no_grad()
    def act(self, ts: TrainState, obs: torch.Tensor, deterministic: bool = True,
            hidden=None, noise=None):
        """The policy's action for raw observations: the mean, or with
        `deterministic` False the mean plus sigma times `noise` (default: a
        draw from `gen`). A recurrent policy threads the carry: it takes
        `hidden` (default: zeros) and returns (action, new hidden); with an
        asymmetric critic only the actor's carry is replaced."""
        nobs = normalize(ts.obs_stats, obs) if self.cfg.normalize_input else obs
        params = ts.params
        if self.asymmetric:
            params = {k[len("actor."):]: v for k, v in params.items() if k.startswith("actor.")}
        if self.recurrent:
            if hidden is None:
                hidden = self.init_carry(obs.shape[0])
            carry = hidden["actor"] if self.asymmetric else hidden
            mu, log_std, _, carry = functional_call(self.actor, params, (nobs, carry))
            hidden = {**hidden, "actor": carry} if self.asymmetric else carry
        else:
            mu, log_std, _ = functional_call(self.actor, params, (nobs,))
        a = mu
        if not deterministic:
            eps = noise if noise is not None else torch.randn(
                mu.shape, generator=self.noise_gen, device=mu.device)
            a = mu + torch.exp(log_std) * eps
        return (a, hidden) if self.recurrent else a
