"""Teacher-student DAgger distillation (counterpart of
handarm_tpu/learn/distill.py).

A trained PPO teacher, acting deterministically on the env's teacher
observations, supervises a student that sees only deployable observations:
a flat vector and synthetic point clouds. One `train_iter` is a rollout of
`horizon` steps that executes, per env and step, the teacher's action with
probability beta and else the student's, then `mini_epochs` passes of
minibatched regression of the student's mean action onto the teacher's
(plus optional auxiliary heads that predict slices of the teacher
observations), with global-norm clipping and Adam (`learn/optim.py`, the
bare chain: no step is skipped). Beta falls linearly from `beta_start` to
`beta_end` over `beta_decay_iters` iterations.

The student's parameters are a dict of tensors by module name, applied
through `torch.func.functional_call`; their flax names and order
(`flax_names`) are those of the JAX package's `student.npz`. Every stat of
an iteration stays a 0-d tensor on the device. Random draws (the mix, the
permutations, the init) come from the learner's `gen`, or are passed in.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch
from torch import nn
from torch.func import functional_call

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.learn import optim
from handarm_tpu_torch.learn.networks import init_dense_flax_default


class PointcloudEncoder(nn.Module):
    """PointNet over [..., N, 4] clouds (xyz and PointType): ReLU dense
    layers `pt_i` per point, `pt_out`, then a max over the valid points
    (type > 0). A cloud with no valid point encodes to -1e9 in every
    feature, as the JAX package's does."""

    def __init__(self, features: Sequence[int] = (64, 128), out_dim: int = 128,
                 in_dim: int = 4):
        super().__init__()
        dims = [in_dim, *features]
        self.num_hidden = len(features)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"pt_{i}", nn.Linear(a, b))
        self.pt_out = nn.Linear(dims[-1], out_dim)

    def forward(self, cloud: torch.Tensor) -> torch.Tensor:
        valid = cloud[..., 3:] > 0
        x = cloud
        for i in range(self.num_hidden):
            x = torch.relu(getattr(self, f"pt_{i}")(x))
        x = self.pt_out(x)
        x = torch.where(valid, x, torch.full_like(x, -1e9)).amax(dim=-2)
        return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


class StudentPolicy(nn.Module):
    """The flat observations and one encoding per cloud (in `cloud_keys`
    order) -> ELU dense layers `dense_i` -> the mean action `mu` and one
    linear head `aux_<name>` per auxiliary target.
    forward(obs, obs_dict) -> (mu, {name: prediction})."""

    def __init__(self, num_obs: int, num_actions: int, cloud_keys: Sequence[str] = (),
                 hidden: Sequence[int] = (512, 256, 128), encoder_dim: int = 128,
                 aux_heads: dict | None = None):
        super().__init__()
        self.cloud_keys, self.aux_names = tuple(cloud_keys), tuple(aux_heads or {})
        for key in self.cloud_keys:
            self.add_module(f"enc_{key}", PointcloudEncoder(out_dim=encoder_dim))
        dims = [num_obs + encoder_dim * len(self.cloud_keys), *hidden]
        self.num_hidden = len(hidden)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"dense_{i}", nn.Linear(a, b))
        self.mu = nn.Linear(dims[-1], num_actions)
        for name, dim in (aux_heads or {}).items():
            self.add_module(f"aux_{name}", nn.Linear(dims[-1], dim))

    def forward(self, obs: torch.Tensor, obs_dict: dict | None = None):
        feats = [obs] + [getattr(self, f"enc_{k}")(obs_dict[k]) for k in self.cloud_keys]
        x = torch.cat(feats, dim=-1)
        for i in range(self.num_hidden):
            x = nn.functional.elu(getattr(self, f"dense_{i}")(x))
        return self.mu(x), {n: getattr(self, f"aux_{n}")(x) for n in self.aux_names}

    def flax_names(self) -> list[tuple[str, str]]:
        """(flax name, module name) of every parameter, in the order flax
        flattens the params (module names sorted at each level, bias
        before kernel): the order of `student.npz`'s keys "0", "1", ...
        Flax names are `/`-joined module paths ending `.bias` or
        `.kernel`; kernels are [in, out] in flax, weights [out, in] here."""
        layers = sorted(
            (tuple(name.split(".")), name) for name, m in self.named_modules()
            if isinstance(m, nn.Linear))
        return [(f"{'/'.join(path)}.{leaf}", f"{name}.{attr}")
                for path, name in layers for leaf, attr in (("bias", "bias"),
                                                            ("kernel", "weight"))]

    def param_dict(self) -> dict[str, torch.Tensor]:
        """Detached copies of the parameters, by module name, in flax order."""
        own = dict(self.named_parameters())
        return {t: own[t].detach().clone() for _, t in self.flax_names()}

    @torch.no_grad()
    def init_flax_default(self, gen: torch.Generator) -> "StudentPolicy":
        """flax `Dense` defaults for every layer, drawn from `gen`."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_dense_flax_default(m, gen)
        return self


class DistillConfig(NamedTuple):
    horizon: int = 16
    learning_rate: float = 1e-3
    mini_epochs: int = 2
    minibatch_size: int = 4096
    beta_start: float = 1.0  # fraction of teacher actions executed
    beta_end: float = 0.0
    beta_decay_iters: int = 500
    aux_coef: float = 0.1
    grad_norm: float = 1.0
    cloud_keys: tuple = ()


class DistillState(NamedTuple):
    params: dict  # module name -> tensor, flax order
    opt_state: optim.OptState
    env_state: Any
    last_obs: torch.Tensor
    last_teacher_obs: torch.Tensor
    last_obs_dict: dict
    iteration: torch.Tensor  # int32 scalar


class DAgger:
    """Distills `teacher` (anything with `act(teacher_obs)`, for example
    `rollout.Policy`) into a StudentPolicy on `env`, whose config must list
    the teacher's observations as `teacher_observations`. `aux_from_obs`
    maps an auxiliary head's name to its (start, end) slice of the teacher
    observations. `device` defaults to the env's."""

    def __init__(self, env, teacher, cfg: DistillConfig = DistillConfig(),
                 aux_from_obs: dict | None = None, device=None):
        self.env, self.teacher, self.cfg = env, teacher, cfg
        self.device = resolve_device(device) if device is not None else env.device
        self.aux_from_obs = dict(aux_from_obs or {})
        self.net = StudentPolicy(
            env.num_obs, env.num_actions, cfg.cloud_keys,
            aux_heads={k: e - s for k, (s, e) in self.aux_from_obs.items()}).to(self.device)
        self.gen = torch.Generator(device=self.device)

    def init(self, seed: int) -> DistillState:
        """The genesis pool if the task drops its objects, an env reset, one
        zero-action step (the clouds and teacher observations come with a
        step), flax-default params, a fresh optimizer."""
        self.gen.manual_seed(seed)
        env_state, obs = self.env.reset(seed)
        env_state, res = self.env.step(
            env_state, torch.zeros(obs.shape[0], self.env.num_actions, device=obs.device))
        params = self.net.init_flax_default(self.gen).param_dict()
        return DistillState(
            params=params, opt_state=optim.init(params), env_state=env_state,
            last_obs=res.obs, last_teacher_obs=res.teacher_obs, last_obs_dict=res.obs_dict,
            iteration=torch.zeros((), dtype=torch.int32, device=self.device))

    def beta(self, iteration: torch.Tensor) -> torch.Tensor:
        """The fraction of teacher actions executed at `iteration`."""
        c = self.cfg
        frac = torch.clamp(iteration.to(torch.float32) / max(c.beta_decay_iters, 1), 0.0, 1.0)
        return c.beta_start + (c.beta_end - c.beta_start) * frac

    def student(self, params: dict, obs, obs_dict):
        """(mu, aux) of the student with `params`."""
        return functional_call(self.net, params, (obs, obs_dict))

    @torch.no_grad()
    def act(self, ds: DistillState, obs, obs_dict) -> torch.Tensor:
        return self.student(ds.params, obs, obs_dict)[0]

    def train_iter(self, ds: DistillState, mix=None, perms=None, scores=None):
        """(new DistillState, stats). `mix` [horizon, B, 1] (bool: the
        teacher acts) replaces the Bernoulli(beta) draws, `perms`
        [mini_epochs, n_mb * mb] the minibatch permutations of the
        time-major flattened samples, `scores` (a list of `horizon` dicts,
        as `env.step` takes) the clouds' subsampling draws."""
        beta = self.beta(ds.iteration)
        return self.update(ds, beta, *self.rollout(ds, beta, mix, scores), perms)

    def minibatches(self, num_samples: int) -> tuple[int, int]:
        """(minibatch size, minibatches per mini-epoch) of an update of
        `num_samples` samples: what is left over a whole minibatch is
        dropped."""
        mb = min(self.cfg.minibatch_size, num_samples)
        return mb, max(1, num_samples // mb)

    def update(self, ds: DistillState, beta, batch: dict, succ, env_state, carry, perms=None):
        """(new DistillState, stats) after the minibatch epochs on the
        samples of `rollout`."""
        N = batch["obs"].shape[0]
        mb, n_mb = self.minibatches(N)
        if perms is None:
            perms = torch.stack([torch.randperm(N, generator=self.gen, device=self.device)
                                 [:n_mb * mb] for _ in range(self.cfg.mini_epochs)])
        params, opt_state = ds.params, ds.opt_state
        bc, aux = [], []
        for idx in perms.reshape(-1, mb):
            mbatch = {k: (v.index_select(0, idx) if torch.is_tensor(v) else
                          {kk: vv.index_select(0, idx) for kk, vv in v.items()})
                      for k, v in batch.items()}
            params, opt_state, m = self.mb_step(params, opt_state, mbatch)
            bc.append(m["bc_loss"])
            aux.append(m["aux_loss"])
        stats = dict(bc_loss=torch.stack(bc).mean(), aux_loss=torch.stack(aux).mean(),
                     beta=beta, success_rate_ewma=succ)
        last_obs, last_teacher_obs, last_obs_dict = carry
        return DistillState(params, opt_state, env_state, last_obs, last_teacher_obs,
                            last_obs_dict, ds.iteration + 1), stats

    @torch.no_grad()
    def rollout(self, ds: DistillState, beta, mix=None, scores=None):
        """(samples flattened time-major: obs, obs_dict, the teacher's
        action `target` and teacher_obs; the last step's success EWMA; the
        env state; the last (obs, teacher_obs, obs_dict)) of `horizon`
        beta-mixed steps. The student acts with `ds.params`."""
        env_state = ds.env_state
        obs, teacher_obs, obs_dict = ds.last_obs, ds.last_teacher_obs, ds.last_obs_dict
        steps, succ = [], None
        for t in range(self.cfg.horizon):
            teacher_a = self.teacher.act(teacher_obs)
            student_mu = self.student(ds.params, obs, obs_dict)[0]
            m = mix[t] if mix is not None else (
                torch.rand((obs.shape[0], 1), generator=self.gen, device=obs.device) < beta)
            action = torch.where(m, teacher_a, student_mu)
            env_state, res = self.env.step(env_state, action,
                                           scores[t] if scores is not None else None)
            steps.append(dict(obs=obs, obs_dict=obs_dict, target=teacher_a,
                              teacher_obs=teacher_obs))
            succ = res.info.get("success_rate_ewma", torch.zeros((), device=obs.device))
            obs, teacher_obs, obs_dict = res.obs, res.teacher_obs, res.obs_dict
        flat = lambda xs: torch.stack(xs).reshape((-1,) + tuple(xs[0].shape[1:]))
        batch = {k: flat([s[k] for s in steps]) for k in ("obs", "target", "teacher_obs")}
        batch["obs_dict"] = {k: flat([s["obs_dict"][k] for s in steps]) for k in obs_dict}
        return batch, succ, env_state, (obs, teacher_obs, obs_dict)

    def loss(self, params: dict, mb: dict):
        """(total loss, {bc_loss, aux_loss}) of one minibatch."""
        mu, aux = self.student(params, mb["obs"], mb["obs_dict"])
        bc = torch.mean((mu - mb["target"]) ** 2)
        aux_loss = torch.zeros((), device=mu.device)
        for name, (s, e) in self.aux_from_obs.items():
            aux_loss = aux_loss + torch.mean((aux[name] - mb["teacher_obs"][:, s:e]) ** 2)
        return bc + self.cfg.aux_coef * aux_loss, dict(bc_loss=bc.detach(),
                                                       aux_loss=aux_loss.detach())

    def grads(self, params: dict, mb: dict):
        """(gradients of the loss by parameter, detached loss terms)."""
        with torch.enable_grad():
            leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
            total, terms = self.loss(leaves, mb)
            grads = torch.autograd.grad(total, list(leaves.values()))
        return dict(zip(leaves, grads)), terms

    def apply(self, params: dict, opt_state: optim.OptState, grads: dict):
        """(params, optimizer state) after one clipped Adam step."""
        updates, opt_state = optim.update(grads, opt_state, self.cfg.grad_norm,
                                          skip_nonfinite=False)
        lr = self.cfg.learning_rate
        return {k: p + updates[k] * lr for k, p in params.items()}, opt_state

    @torch.no_grad()
    def mb_step(self, params: dict, opt_state: optim.OptState, mb: dict):
        """(params, optimizer state, loss terms) after one minibatch step."""
        grads, terms = self.grads(params, mb)
        params, opt_state = self.apply(params, opt_state, grads)
        return params, opt_state, terms
