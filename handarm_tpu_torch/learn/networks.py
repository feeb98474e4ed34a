"""Policy/value network (counterpart of handarm_tpu/learn/networks.py
`ActorCritic`, shared-trunk MLP path)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


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

    def forward(self, obs: torch.Tensor):
        x = obs
        for layer in self.trunk:
            x = nn.functional.elu(layer(x))
        mu = self.mu(x)
        return mu, self.log_std.expand_as(mu), self.value(x)[..., 0]
