"""Policy/value network (counterpart of handarm_tpu/learn/networks.py
`ActorCritic`, shared-trunk MLP path)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# flax's variance_scaling "truncated_normal": the standard deviation of a
# unit normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


def flax_names(num_hidden: int) -> list[tuple[str, str]]:
    """(flax name, module name) of every ActorCritic parameter, in the order
    flax flattens its params (dict keys sorted at each level): the order of
    optax's state and of the checkpoints' leaves. Kernels are [in, out] in
    flax and weights [out, in] here."""
    layers = {f"dense_{i}": f"trunk.{i}" for i in range(num_hidden)}
    layers.update(mu="mu", value="value", log_std=None)
    out = []
    for name in sorted(layers):
        if layers[name] is None:
            out.append((name, name))
        else:
            out += [(f"{name}.bias", f"{layers[name]}.bias"),
                    (f"{name}.kernel", f"{layers[name]}.weight")]
    return out


class ActorCritic(nn.Module):
    """Shared ELU MLP trunk, a mean head, a value head and a state-independent
    log-std. forward(obs) -> (mu, log_std, value)."""

    def __init__(self, num_obs: int, num_actions: int,
                 hidden: Sequence[int] = (768, 512, 256), sigma_init: float = 0.0):
        super().__init__()
        dims = [num_obs, *hidden]
        self.trunk = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.mu = nn.Linear(dims[-1], num_actions)
        self.value = nn.Linear(dims[-1], 1)
        self.log_std = nn.Parameter(torch.full((num_actions,), sigma_init))
        self.sigma_init = sigma_init

    def forward(self, obs: torch.Tensor):
        x = obs
        for layer in self.trunk:
            x = nn.functional.elu(layer(x))
        mu = self.mu(x)
        return mu, self.log_std.expand_as(mu), self.value(x)[..., 0]

    def param_dict(self) -> dict[str, torch.Tensor]:
        """Detached copies of the parameters, by module name, in flax order
        (the learner's functional parameters)."""
        own = dict(self.named_parameters())
        return {t: own[t].detach().clone() for _, t in flax_names(len(self.trunk))}

    @torch.no_grad()
    def init_flax_default(self, gen: torch.Generator) -> "ActorCritic":
        """Re-initialize to flax `Dense` defaults, drawing from `gen`: lecun
        normal kernels (a unit normal truncated to +-2, times
        sqrt(1 / fan_in) / TRUNCATED_STD), zero biases, log_std =
        sigma_init. Not nn.Linear's own default (kaiming uniform)."""
        for layer in (*self.trunk, self.mu, self.value):
            init_dense_flax_default(layer, gen)
        self.log_std.fill_(self.sigma_init)
        return self


@torch.no_grad()
def init_dense_flax_default(layer: nn.Linear, gen: torch.Generator) -> None:
    """flax `Dense`'s default init of an nn.Linear, drawn from `gen`: a
    lecun normal kernel, a zero bias."""
    w = layer.weight
    t = torch.empty(w.shape, device=w.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(t * ((1.0 / w.shape[1]) ** 0.5 / TRUNCATED_STD))
    layer.bias.zero_()
