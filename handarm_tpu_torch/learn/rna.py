"""Random Network Adversary (counterpart of handarm_tpu/learn/rna.py;
DeXtreme, reference utils/rna_util.py).

A fixed random MLP perturbs the policy's actions; per-env dropout masks
stand in for a different random network in every env. Its outputs are
binned per action channel and argmax-decoded to [-1, 1] (a continuous
tanh adversary collapses to about 0). The weights are fixed at init; the
masks are drawn anew for an env whose episode ends.

The random functions take a `torch.Generator` or the draws themselves, so
a test can hand over the JAX package's: `rna_masks` takes the masks'
uniforms in [0, 1) (JAX's `bernoulli` keeps a unit where its uniform is
below `keep`). The three products are plain matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RNAParams(NamedTuple):
    w1: torch.Tensor  # [in, H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, H]
    b2: torch.Tensor  # [H]
    w3: torch.Tensor  # [H, out * bins]
    num_actions: int
    bins: int


class RNAState(NamedTuple):
    mask1: torch.Tensor  # [B, H] per-env dropout masks
    mask2: torch.Tensor  # [B, H]


def rna_init(gen: torch.Generator, obs_dim: int, num_actions: int, hidden: int = 256,
             bins: int = 32, device="cpu") -> RNAParams:
    """Standard normal weights scaled by 1 / sqrt(fan in), zero biases."""
    normal = lambda *s: torch.randn(*s, generator=gen, device=device)
    return RNAParams(w1=normal(obs_dim, hidden) / obs_dim ** 0.5,
                     b1=torch.zeros(hidden, device=device),
                     w2=normal(hidden, hidden) / hidden ** 0.5,
                     b2=torch.zeros(hidden, device=device),
                     w3=normal(hidden, num_actions * bins) / hidden ** 0.5,
                     num_actions=num_actions, bins=bins)


class MaskDraws(NamedTuple):
    """The uniforms [B, H] in [0, 1) of two fresh masks."""

    u1: torch.Tensor
    u2: torch.Tensor


def mask_draws(B: int, params: RNAParams, gen: torch.Generator) -> MaskDraws:
    H, dev = params.b1.shape[0], params.b1.device
    return MaskDraws(torch.rand(B, H, generator=gen, device=dev),
                     torch.rand(B, H, generator=gen, device=dev))


def rna_masks(params: RNAParams, B: int, gen: torch.Generator | None = None,
              draws: MaskDraws | None = None, keep: float = 0.5) -> RNAState:
    """Fresh per-env dropout masks: a unit kept (scaled by 1 / keep) where its
    uniform is below `keep`."""
    u1, u2 = draws if draws is not None else mask_draws(B, params, gen)
    return RNAState(mask1=(u1 < keep).to(torch.float32) / keep,
                    mask2=(u2 < keep).to(torch.float32) / keep)


def rna_logits(params: RNAParams, state: RNAState, obs: torch.Tensor) -> torch.Tensor:
    """[B, obs] -> the binned logits [B, num_actions, bins]."""
    x = torch.relu((obs @ params.w1 + params.b1) * state.mask1)
    x = torch.relu((x @ params.w2 + params.b2) * state.mask2)
    return (x @ params.w3).reshape(obs.shape[0], params.num_actions, params.bins)


def rna_decode(logits: torch.Tensor) -> torch.Tensor:
    """Each channel's first largest bin, mapped to [-1, 1]."""
    bins = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1).to(torch.float32)
    return 2.0 * idx / (bins - 1) - 1.0


def rna_apply(params: RNAParams, state: RNAState, obs: torch.Tensor) -> torch.Tensor:
    """[B, obs] -> adversarial actions [B, num_actions] in [-1, 1]."""
    return rna_decode(rna_logits(params, state, obs))
