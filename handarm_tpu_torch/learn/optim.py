"""The learner's optimizer: the optax chain

    apply_if_finite(chain(clip_by_global_norm(grad_norm),
                          scale_by_adam(eps=1e-8),
                          scale_by_learning_rate(1.0, flip_sign=True)),
                    max_consecutive_errors=10_000)

that handarm_tpu/learn/ppo.py builds inline, written to optax 0.2.6's
formulas over a dict of parameters. The learning rate multiplies the
returned updates afterwards, as the JAX learner does.

- Clip: a gradient whose global norm is below `max_norm` passes unchanged,
  else it becomes g / norm * max_norm (not `clip_grad_norm_`, which adds
  1e-6 to the norm and always rescales).
- Adam: an int32 step count that saturates instead of overflowing, bias
  correction with the incremented count, mu_hat / (sqrt(nu_hat) + eps).
- A non-finite gradient gives zero updates and leaves Adam's state as it
  was; `notfinite_count` and `total_notfinite` go up, `last_finite` goes
  false. After more than `max_consecutive_errors` such steps in a row the
  update goes through anyway, as optax's does.

The state's leaves are optax's, in optax's order: notfinite_count,
last_finite, total_notfinite, Adam's count, then mu and nu per parameter
in the parameters' order. Everything stays on the parameters' device:
nothing reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT32_MAX = 2**31 - 1
MAX_CONSECUTIVE_ERRORS = 10_000


class OptState(NamedTuple):
    notfinite_count: torch.Tensor  # int32 scalar
    last_finite: torch.Tensor  # bool scalar
    total_notfinite: torch.Tensor  # int32 scalar
    count: torch.Tensor  # int32 scalar: Adam's step count
    mu: dict  # name -> first moment, shaped as the parameter
    nu: dict  # name -> second moment


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < INT32_MAX, count + 1, count)


def init(params: dict) -> OptState:
    dev = next(iter(params.values())).device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return OptState(
        notfinite_count=zero, last_finite=torch.ones((), dtype=torch.bool, device=dev),
        total_notfinite=zero.clone(), count=zero.clone(),
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
    )


def update(grads: dict, state: OptState, max_norm: float, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8,
           skip_nonfinite: bool = True) -> tuple[dict, OptState]:
    """(updates, new state) for one step; updates are already sign-flipped
    (add updates * lr to the parameters). With `skip_nonfinite` False the
    step is the bare chain(clip_by_global_norm, adam) (the distillation
    learner's): a non-finite gradient goes through; the counters still
    count it."""
    finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
    notfinite_count = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                  _safe_increment(state.notfinite_count))
    apply = finite | (notfinite_count > MAX_CONSECUTIVE_ERRORS)
    if not skip_nonfinite:
        apply = torch.ones_like(apply)

    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = g_norm < max_norm
    clipped = {k: torch.where(keep, g, (g / g_norm) * max_norm) for k, g in grads.items()}

    mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in clipped.items()}
    nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in clipped.items()}
    count = _safe_increment(state.count)
    c1 = 1 - torch.pow(b1, count.to(torch.float32))
    c2 = 1 - torch.pow(b2, count.to(torch.float32))
    updates = {k: -((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k in clipped}

    new = OptState(
        notfinite_count=notfinite_count,
        last_finite=finite,
        total_notfinite=torch.where(finite, state.total_notfinite,
                                    _safe_increment(state.total_notfinite)),
        count=torch.where(apply, count, state.count),
        mu={k: torch.where(apply, mu[k], state.mu[k]) for k in mu},
        nu={k: torch.where(apply, nu[k], state.nu[k]) for k in nu},
    )
    updates = {k: torch.where(apply, u, torch.zeros_like(u)) for k, u in updates.items()}
    return updates, new


def where(cond: torch.Tensor, a: OptState, b: OptState) -> OptState:
    """Leaf by leaf, a where `cond` else b."""
    pick = lambda x, y: torch.where(cond, x, y)
    return OptState(*(pick(x, y) for x, y in zip(a[:4], b[:4])),
                    {k: pick(a.mu[k], b.mu[k]) for k in a.mu},
                    {k: pick(a.nu[k], b.nu[k]) for k in a.nu})
