"""Policy and value networks (counterpart of handarm_tpu/learn/networks.py):
the shared-trunk MLP `ActorCritic`, the asymmetric critic `ValueNet`, and
the LSTM-before-MLP `RecurrentActorCritic` and `RecurrentValueNet`.

Each net names its parameters by module name here and lists them with their
flax names in flax's order (`flax_names`): dict keys sorted at each level,
the order of optax's state and of the checkpoints' leaves. Kernels are
[in, out] in flax and weights [out, in] here; every other leaf has the same
layout on both sides."""

from __future__ import annotations

import re
from typing import Sequence

import torch
from torch import nn

# flax's variance_scaling "truncated_normal": the standard deviation of a
# unit normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978
GATES = ("i", "f", "g", "o")  # flax's LSTM gate order
LAYER_NORM_EPS = 1e-6  # flax's LayerNorm default


def _flax_order(pairs) -> list[tuple[str, str]]:
    """(flax name, module name) pairs sorted as flax flattens them: by the
    flax name's path, `/` between modules and `.` before the leaf."""
    return sorted(pairs, key=lambda p: tuple(re.split(r"[/.]", p[0])))


def _dense(flax: str, module: str) -> list[tuple[str, str]]:
    return [(f"{flax}.bias", f"{module}.bias"), (f"{flax}.kernel", f"{module}.weight")]


def _head_names(num_hidden: int, heads) -> list[tuple[str, str]]:
    pairs = [p for i in range(num_hidden) for p in _dense(f"dense_{i}", f"trunk.{i}")]
    return pairs + [p for h in heads for p in _dense(h, h)]


def _lstm_names(layer_norm: bool) -> list[tuple[str, str]]:
    pairs = [(f"lstm/i{g}.kernel", f"lstm.i{g}.weight") for g in GATES]
    pairs += [p for g in GATES for p in _dense(f"lstm/h{g}", f"lstm.h{g}")]
    if layer_norm:
        pairs += [("rnn_ln.bias", "rnn_ln.bias"), ("rnn_ln.scale", "rnn_ln.scale")]
    return pairs


def flax_names(num_hidden: int) -> list[tuple[str, str]]:
    """(flax name, module name) of every ActorCritic parameter, flax order."""
    return _flax_order(_head_names(num_hidden, ("mu", "value")) + [("log_std", "log_std")])


def value_net_names(num_hidden: int) -> list[tuple[str, str]]:
    """(flax name, module name) of every ValueNet parameter, flax order."""
    return _flax_order(_head_names(num_hidden, ("value",)))


def recurrent_names(num_hidden: int, actor: bool, layer_norm: bool = True
                    ) -> list[tuple[str, str]]:
    """(flax name, module name) of every RecurrentActorCritic (`actor`) or
    RecurrentValueNet parameter, flax order."""
    heads = ("mu", "value") if actor else ("value",)
    pairs = _head_names(num_hidden, heads) + _lstm_names(layer_norm)
    return _flax_order(pairs + ([("log_std", "log_std")] if actor else []))


def asymmetric_names(actor: list, critic: list) -> list[tuple[str, str]]:
    """The names of `{"actor": ..., "critic": ...}` params, flax order."""
    return ([(f"actor/{f}", f"actor.{t}") for f, t in actor]
            + [(f"critic/{f}", f"critic.{t}") for f, t in critic])


class _FlaxParams:
    """`param_dict` and `init_flax_default` of a net with `flax_names()`."""

    def param_dict(self) -> dict[str, torch.Tensor]:
        """Detached copies of the parameters, by module name, in flax order
        (the learner's functional parameters)."""
        own = dict(self.named_parameters())
        return {t: own[t].detach().clone() for _, t in self.flax_names()}

    @torch.no_grad()
    def init_flax_default(self, gen: torch.Generator):
        """Re-initialize to flax's defaults, drawing from `gen` in module
        order: `Dense` and the LSTM's input kernels lecun normal (a unit
        normal truncated to +-2, times sqrt(1 / fan_in) / TRUNCATED_STD),
        the LSTM's four recurrent kernels each its own orthogonal matrix,
        biases 0, LayerNorm scale 1, log_std = sigma_init. Not nn.Linear's
        own default (kaiming uniform)."""
        in_lstm = {id(x) for m in self.modules() if isinstance(m, LSTMCell)
                   for x in m.children()}
        for m in self.modules():
            if isinstance(m, LSTMCell):
                m.init_flax_default(gen)
            elif isinstance(m, nn.Linear) and id(m) not in in_lstm:
                init_dense_flax_default(m, gen)
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, (ActorCritic, RecurrentActorCritic)):
                m.log_std.fill_(m.sigma_init)
        return self


def _trunk(dims: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))


def _elu_trunk(trunk: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in trunk:
        x = nn.functional.elu(layer(x))
    return x


class ActorCritic(_FlaxParams, nn.Module):
    """Shared ELU MLP trunk, a mean head, a value head and a state-independent
    log-std. forward(obs) -> (mu, log_std, value)."""

    def __init__(self, num_obs: int, num_actions: int,
                 hidden: Sequence[int] = (768, 512, 256), sigma_init: float = 0.0):
        super().__init__()
        dims = [num_obs, *hidden]
        self.trunk = _trunk(dims)
        self.mu = nn.Linear(dims[-1], num_actions)
        self.value = nn.Linear(dims[-1], 1)
        self.log_std = nn.Parameter(torch.full((num_actions,), sigma_init))
        self.sigma_init = sigma_init

    def forward(self, obs: torch.Tensor):
        x = _elu_trunk(self.trunk, obs)
        mu = self.mu(x)
        return mu, self.log_std.expand_as(mu), self.value(x)[..., 0]

    def flax_names(self) -> list[tuple[str, str]]:
        return flax_names(len(self.trunk))


class ValueNet(_FlaxParams, nn.Module):
    """The asymmetric critic: an ELU MLP on the teacher observations and a
    value head. forward(obs) -> value."""

    def __init__(self, num_obs: int, hidden: Sequence[int] = (768, 512, 256)):
        super().__init__()
        dims = [num_obs, *hidden]
        self.trunk = _trunk(dims)
        self.value = nn.Linear(dims[-1], 1)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.value(_elu_trunk(self.trunk, obs))[..., 0]

    def flax_names(self) -> list[tuple[str, str]]:
        return value_net_names(len(self.trunk))


class LSTMCell(nn.Module):
    """flax's `OptimizedLSTMCell`: input kernels `ii, if, ig, io` (no bias)
    and recurrent kernels `hi, hf, hg, ho` (each with a bias), each gate's
    its own layer as in flax's params; one matmul over the concatenated
    recurrent kernels plus their biases, one over the input kernels, then
    sigmoid gates i, f, o and tanh on g and on the new cell state. The carry
    is (c, h). forward(carry, x) -> (new carry, h')."""

    def __init__(self, num_in: int, units: int):
        super().__init__()
        self.units = units
        for g in GATES:
            self.add_module(f"i{g}", nn.Linear(num_in, units, bias=False))
            self.add_module(f"h{g}", nn.Linear(units, units))

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        layer = lambda n: getattr(self, n)
        w_h = torch.cat([layer(f"h{g}").weight for g in GATES])
        b_h = torch.cat([layer(f"h{g}").bias for g in GATES])
        w_i = torch.cat([layer(f"i{g}").weight for g in GATES])
        z = torch.addmm(b_h, h, w_h.T) + x @ w_i.T
        i, f, g, o = z.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h

    @torch.no_grad()
    def init_flax_default(self, gen: torch.Generator) -> None:
        for g in GATES:
            init_dense_flax_default(getattr(self, f"i{g}"), gen)
        for g in GATES:
            layer = getattr(self, f"h{g}")
            nn.init.orthogonal_(layer.weight, generator=gen)
            layer.bias.zero_()

    def init_carry(self, batch: int, device=None):
        z = torch.zeros(batch, self.units, device=device)
        return (z, z.clone())


class LayerNorm(nn.Module):
    """flax's `LayerNorm` over the last axis: epsilon 1e-6, the variance as
    E[x^2] - E[x]^2 clipped at 0 (`use_fast_variance`), parameters `scale`
    and `bias`: (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + LAYER_NORM_EPS) * self.scale) + self.bias


class _Recurrent(_FlaxParams, nn.Module):
    """The LSTM before the MLP: obs -> LSTMCell -> LayerNorm (unless
    `layer_norm` is False) -> ELU dense layers."""

    def __init__(self, num_obs: int, rnn_units: int, hidden: Sequence[int], layer_norm: bool):
        super().__init__()
        self.lstm = LSTMCell(num_obs, rnn_units)
        self.rnn_ln = LayerNorm(rnn_units) if layer_norm else None
        self.trunk = _trunk([rnn_units, *hidden])
        self.width = hidden[-1] if hidden else rnn_units

    def _features(self, obs, carry):
        carry, x = self.lstm(carry, obs)
        if self.rnn_ln is not None:
            x = self.rnn_ln(x)
        return _elu_trunk(self.trunk, x), carry

    def init_carry(self, batch: int, device=None):
        """A zero carry (c, h) of `batch` envs."""
        return self.lstm.init_carry(batch, device)


class RecurrentActorCritic(_Recurrent):
    """forward(obs, carry) -> (mu, log_std, value, new carry)."""

    def __init__(self, num_obs: int, num_actions: int, rnn_units: int = 1024,
                 hidden: Sequence[int] = (512, 512), layer_norm: bool = True,
                 sigma_init: float = 0.0):
        super().__init__(num_obs, rnn_units, hidden, layer_norm)
        self.mu = nn.Linear(self.width, num_actions)
        self.value = nn.Linear(self.width, 1)
        self.log_std = nn.Parameter(torch.full((num_actions,), sigma_init))
        self.sigma_init = sigma_init

    def forward(self, obs: torch.Tensor, carry):
        x, carry = self._features(obs, carry)
        mu = self.mu(x)
        return mu, self.log_std.expand_as(mu), self.value(x)[..., 0], carry

    def flax_names(self) -> list[tuple[str, str]]:
        return recurrent_names(len(self.trunk), True, self.rnn_ln is not None)


class RecurrentValueNet(_Recurrent):
    """The recurrent central-value critic. forward(obs, carry) -> (value,
    new carry)."""

    def __init__(self, num_obs: int, rnn_units: int = 1024,
                 hidden: Sequence[int] = (512, 512), layer_norm: bool = True):
        super().__init__(num_obs, rnn_units, hidden, layer_norm)
        self.value = nn.Linear(self.width, 1)

    def forward(self, obs: torch.Tensor, carry):
        x, carry = self._features(obs, carry)
        return self.value(x)[..., 0], carry

    def flax_names(self) -> list[tuple[str, str]]:
        return recurrent_names(len(self.trunk), False, self.rnn_ln is not None)


class AsymmetricActorCritic(_FlaxParams, nn.Module):
    """An actor (ActorCritic or RecurrentActorCritic) on the observations and
    a critic (ValueNet or RecurrentValueNet) on the teacher observations;
    the actor's own value head is computed and unused, as in the JAX
    package. forward(obs, teacher_obs[, carry]) -> (mu, log_std, value[,
    new carry]); a carry is {"actor": (c, h), "critic": (c, h)}."""

    def __init__(self, actor: nn.Module, critic: nn.Module):
        super().__init__()
        self.actor, self.critic = actor, critic

    def forward(self, obs: torch.Tensor, teacher_obs: torch.Tensor, carry=None):
        if carry is None:
            mu, log_std, _ = self.actor(obs)
            return mu, log_std, self.critic(teacher_obs)
        mu, log_std, _, a = self.actor(obs, carry["actor"])
        value, c = self.critic(teacher_obs, carry["critic"])
        return mu, log_std, value, {"actor": a, "critic": c}

    def flax_names(self) -> list[tuple[str, str]]:
        return asymmetric_names(self.actor.flax_names(), self.critic.flax_names())

    def init_carry(self, batch: int, device=None):
        return {"actor": self.actor.init_carry(batch, device),
                "critic": self.critic.init_carry(batch, device)}


@torch.no_grad()
def init_dense_flax_default(layer: nn.Linear, gen: torch.Generator) -> None:
    """flax `Dense`'s default init of an nn.Linear, drawn from `gen`: a
    lecun normal kernel, a zero bias."""
    w = layer.weight
    t = torch.empty(w.shape, device=w.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(t * ((1.0 / w.shape[1]) ** 0.5 / TRUNCATED_STD))
    if layer.bias is not None:
        layer.bias.zero_()
