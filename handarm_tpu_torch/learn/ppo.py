"""PPO with GAE, MLP policy (counterpart of handarm_tpu/learn/ppo.py
without its recurrent and asymmetric-critic paths; one data shard).

One `train_iter` is a rollout of `horizon` stochastic policy steps through
the env, then `_update_from_traj`: the bootstrap value of the last
observation, GAE, the env-major flatten, the once-per-iteration updates of
the observation and value statistics, and `mini_epochs` passes of
minibatched SGD with the clipped surrogate, the (clipped) value loss, the
bounds loss and a KL-adaptive (or fixed) learning rate, then the KL guard
that discards a catastrophic iteration. The switches of the JAX
PPOConfig are ported with their branches: input and value normalization,
advantage normalization, the timeout value bootstrap, the clipped value
loss, the lr schedule and a fixed minibatch count; the recurrent,
asymmetric and sharding fields are refused (`ppo_config`).

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
from handarm_tpu_torch.learn.networks import ActorCritic
from handarm_tpu_torch.learn.running_stats import (
    RunningStats,
    denormalize,
    init_stats,
    normalize,
    update_stats,
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


# the JAX PPOConfig's fields of paths not ported, with their defaults
NOT_PORTED = {
    "asymmetric_critic": (False, "§1.3"), "rnn_units": (0, "§1.3"), "seq_len": (4, "§1.3"),
    "zero_rnn_on_done": (True, "§1.3"), "critic_rnn_units": (0, "§1.3"),
    "data_shards": (1, "§1.6"),
}


def ppo_config(overrides: dict) -> PPOConfig:
    """A PPOConfig from the overrides a task composes to (`hidden` as a
    list or tuple). A field of a path not ported raises NotImplementedError
    unless it has its default; any other unknown field raises KeyError."""
    kw = {}
    for k, v in overrides.items():
        if k in NOT_PORTED:
            default, item = NOT_PORTED[k]
            if v != default:
                raise NotImplementedError(
                    f"PPOConfig.{k}={v!r} is not ported (only {default!r}; ROADMAP {item})")
        elif k not in PPOConfig._fields:
            raise KeyError(f"unknown PPOConfig field {k!r}")
        else:
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


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


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


def where_stats(cond, a: RunningStats, b: RunningStats) -> RunningStats:
    return RunningStats(*(torch.where(cond, x, y) for x, y in zip(a, b)))


class PPO:
    """Ties an env (`step`, `reset`, `num_obs`, `num_actions`,
    `cfg.num_envs`) to the train iteration. `device` defaults to the env's."""

    def __init__(self, env, cfg: PPOConfig = PPOConfig(), device=None):
        self.env, self.cfg = env, cfg
        self.device = resolve_device(device) if device is not None else env.device
        self.net = ActorCritic(env.num_obs, env.num_actions, cfg.hidden).to(self.device)
        batch = env.cfg.num_envs * cfg.horizon
        self.num_minibatches = cfg.num_minibatches or max(1, batch // cfg.minibatch_size)
        if batch % self.num_minibatches:
            raise ValueError(f"{batch} samples do not split into {self.num_minibatches} "
                             "minibatches")
        self.mb_size = batch // self.num_minibatches
        self.gen = torch.Generator(device=self.device)

    # --- init ---------------------------------------------------------------

    def init(self, seed: int) -> TrainState:
        """Env reset, flax-default params, a fresh optimizer and fresh
        stats, the configured learning rate; draws from `seed`."""
        self.gen.manual_seed(seed)
        env_state, obs = self.env.reset(seed)
        params = self.net.init_flax_default(self.gen).param_dict()
        dev = self.device
        return TrainState(
            params=params, opt_state=optim.init(params),
            obs_stats=init_stats((self.env.num_obs,), dev), value_stats=init_stats((), dev),
            lr=torch.tensor(self.cfg.learning_rate, dtype=torch.float32, device=dev),
            env_state=env_state, last_obs=obs,
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
        )

    # --- net helpers --------------------------------------------------------

    def policy_value(self, params: dict, obs_stats: RunningStats, obs: torch.Tensor):
        """(mu, log_std, value) of raw observations."""
        if self.cfg.normalize_input:
            obs = normalize(obs_stats, obs)
        return functional_call(self.net, params, (obs,))

    def value_of(self, value_stats: RunningStats, value: torch.Tensor) -> torch.Tensor:
        """The critic's output in reward units; a non-finite value becomes 0."""
        if self.cfg.normalize_value:
            value = denormalize(value_stats, value)
        return torch.where(torch.isfinite(value), value, torch.zeros_like(value))

    # --- one train iteration ------------------------------------------------

    def train_iter(self, ts: TrainState, noise=None, perms=None):
        """(new TrainState, stats). `noise` [horizon, B, A] replaces the
        policy's normal draws, `perms` [mini_epochs, B * horizon] the
        minibatch permutations."""
        traj, env_state, last_obs, info = self.rollout(ts, noise)
        return self._update_from_traj(ts, traj, env_state, last_obs, perms, info)

    @torch.no_grad()
    def rollout(self, ts: TrainState, noise=None):
        """(trajectory [horizon, B, ...], env state, next observations, the
        last step's info) of `horizon` stochastic policy steps."""
        cfg = self.cfg
        env_state, obs = ts.env_state, ts.last_obs
        steps, info = [], None
        for t in range(cfg.horizon):
            mu, log_std, value = self.policy_value(ts.params, ts.obs_stats, obs)
            eps = noise[t] if noise is not None else torch.randn(
                mu.shape, generator=self.gen, device=mu.device)
            sigma = torch.exp(log_std)
            a = mu + sigma * eps
            logp = gaussian_logp(mu, log_std, a)
            env_state, res = self.env.step(env_state, a)
            value = self.value_of(ts.value_stats, value)
            zero = torch.zeros_like(res.reward)
            reward = torch.where(torch.isfinite(res.reward), res.reward, zero) * cfg.reward_scale
            if cfg.value_bootstrap:
                # a timed-out episode earns the discounted value of where it
                # stopped; `where`, not a multiply by the done mask: a
                # non-finite value times 0 is still NaN
                reward = reward + cfg.gamma * torch.where(
                    res.done & torch.isfinite(value), value, zero)
            steps.append(Transition(obs, a, logp, value, reward, res.done, mu, sigma))
            info = res.info
            obs = torch.where(torch.isfinite(res.obs), res.obs, torch.zeros_like(res.obs))
        traj = Transition(*(torch.stack(x) for x in zip(*steps)))
        return traj, env_state, obs, info

    @torch.no_grad()
    def _update_from_traj(self, ts: TrainState, traj: Transition, env_state, last_obs,
                          perms=None, info=None):
        """GAE, the stats updates and the minibatched PPO epochs on a
        collected trajectory; (new TrainState, stats)."""
        cfg = self.cfg
        data, obs_stats, value_stats = self._prepare(ts, traj, last_obs)
        if perms is None:
            n = data["adv"].shape[0]
            perms = torch.stack([torch.randperm(n, generator=self.gen, device=data["adv"].device)
                                 for _ in range(cfg.mini_epochs)])
        # one permutation per mini-epoch, contiguous minibatches of it
        params, opt_state, lr, aux = self._sgd(ts, data, perms.reshape(-1, self.mb_size))

        kl_mean = aux["kl"].mean()
        guard = (ts.epoch >= 8) & (~torch.isfinite(kl_mean) | (kl_mean > cfg.kl_guard))
        params = {k: torch.where(guard, ts.params[k], p) for k, p in params.items()}
        opt_state = optim.where(guard, ts.opt_state, opt_state)
        obs_stats = where_stats(guard, ts.obs_stats, obs_stats)
        value_stats = where_stats(guard, ts.value_stats, value_stats)
        lr = torch.where(guard, torch.clamp(ts.lr / 2.0, min=cfg.min_lr), lr)

        stats = dict(
            reward_mean=traj.reward.mean() / cfg.reward_scale,
            episode_done_frac=traj.done.to(torch.float32).mean(),
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
        new_ts = TrainState(params, opt_state, obs_stats, value_stats, lr, env_state,
                            last_obs, ts.epoch + 1)
        return new_ts, stats

    def _prepare(self, ts: TrainState, traj: Transition, last_obs):
        """(the samples of the update, flattened env-major: the rollout's
        fields with the normalized advantages, returns and values; the
        updated observation and value stats)."""
        cfg = self.cfg
        _, _, last_value = self.policy_value(ts.params, ts.obs_stats, last_obs)
        last_value = self.value_of(ts.value_stats, last_value)
        advantages = gae(traj.reward, traj.value, traj.done, last_value, cfg.gamma, cfg.tau)
        returns = advantages + traj.value
        batch = Transition(*(flatten_env_major(x) for x in traj))
        adv = flatten_env_major(advantages)
        ret = flatten_env_major(returns)

        obs_stats = update_stats(ts.obs_stats, batch.obs) if cfg.normalize_input else ts.obs_stats
        value_stats = update_stats(ts.value_stats, ret) if cfg.normalize_value else ts.value_stats
        if cfg.normalize_advantage:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)  # jnp.std: ddof 0
        returns_n, values_n = ret, batch.value
        if cfg.normalize_value:
            returns_n = normalize(value_stats, ret, clip=math.inf)
            values_n = normalize(value_stats, batch.value, clip=math.inf)
        data = dict(obs=batch.obs, action=batch.action, logp=batch.logp, adv=adv,
                    return_n=returns_n, value_n=values_n, mu=batch.mu, sigma=batch.sigma)
        return data, obs_stats, value_stats

    def _sgd(self, ts: TrainState, data: dict, minibatches: torch.Tensor):
        """(params, optimizer state, lr, aux stacked by step) after one
        minibatch step per row of sample indices `minibatches`, from the
        learner of `ts`."""
        params, opt_state, lr = ts.params, ts.opt_state, ts.lr
        auxs = []
        for idx in minibatches:
            mb = {k: v.index_select(0, idx) for k, v in data.items()}
            # the loss normalizes with the ROLLOUT-time stats: mu and logp
            # were recorded under them; the new stats take effect on the
            # next rollout
            params, opt_state, lr, aux = self._mb_step(ts.obs_stats, params, opt_state, lr, mb)
            auxs.append(aux)
        aux = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
        return params, opt_state, lr, aux

    def _mb_step(self, obs_stats, params, opt_state, lr, mb):
        grads, aux = self._grads(obs_stats, params, mb)
        params, opt_state, lr = self._apply(params, opt_state, lr, grads, aux["kl"])
        return params, opt_state, lr, aux

    def _grads(self, obs_stats, params, mb):
        """(gradients of the loss by parameter, detached aux)."""
        with torch.enable_grad():
            leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
            total, aux = self._loss(leaves, obs_stats, mb)
            grads = torch.autograd.grad(total, list(leaves.values()))
        return dict(zip(leaves, grads)), aux

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

    def _loss(self, params, obs_stats, mb):
        """(total loss, detached aux) of one minibatch, as the JAX loss_fn."""
        cfg = self.cfg
        mu, log_std, value = self.policy_value(params, obs_stats, mb["obs"])
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
