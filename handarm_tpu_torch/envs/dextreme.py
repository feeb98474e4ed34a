"""AllegroHandDextreme: in-hand reorientation under ADR and the random
network adversary (counterpart of handarm_tpu/envs/dextreme.py; reference
IsaacGymEnvs tasks/dextreme/allegro_hand_dextreme.py, AllegroHandDextremeADR,
AllegroHandADR and AllegroHandManualDR).

The AllegroHand env (`envs/dexhand.py`, on its in-repo stand-in) under
DeXtreme's two transfer mechanisms:

- ADR (`envs/adr.py`): every env draws its observation noise, action noise
  and RNA mixing weight from ranges that widen or narrow with the boundary
  workers' objective, the episode's goal count before the step.
- RNA (`learn/rna.py`): a fixed random binned MLP, fed the last (noisy)
  observation, whose actions are mixed into the policy's by the ADR weight
  alpha. Its dropout masks are drawn anew every step and kept only where
  the episode ended.

A step: the adversary's actions on the stored observation, the alpha mix,
the action noise, the inner step, the observation noise, `adr_step` on the
pre-step successes, the masks refreshed where done.
AllegroHandManualDR is the same env with fixed ranges
(`DEXTREME_MANUAL_DR`: zero deltas, so the bounds never move).

The env draws from its own torch.Generator (and the inner env from its
own), seeded by `reset(seed)`; `reset` and `step` take `DextremeDraws` in
place of those draws (a test hands over the JAX package's). The RNA
weights come from a generator seeded with `rna_seed`, drawn on the CPU;
`rna_params` may be replaced (a test carries the JAX package's across).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.adr import (
    AdrConfig,
    AdrDraws,
    AdrState,
    adr_draws,
    adr_step,
    init_adr_state,
)
from handarm_tpu_torch.envs.dexhand import DexDraws, DexState, make_allegro
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult
from handarm_tpu_torch.learn.rna import (
    MaskDraws,
    RNAState,
    mask_draws,
    rna_apply,
    rna_init,
    rna_masks,
)

# the adversary's parameters under ADR (allegro_hand_dextreme.py)
DEXTREME_ADR = AdrConfig(
    enabled=True,
    names=("obs_noise", "action_noise", "rna_alpha"),
    init_lo=(0.0, 0.0, 0.0),
    init_hi=(0.0, 0.0, 0.0),
    limit_lo=(0.0, 0.0, 0.0),
    limit_hi=(0.1, 0.1, 0.4),
    delta=(0.005, 0.005, 0.02),
    queue_len=64,
    objective_lo=1.0,
    objective_hi=3.0,
)

# AllegroHandDextremeManualDR: the same parameters in fixed hand-tuned ranges
DEXTREME_MANUAL_DR = AdrConfig(
    enabled=True,
    names=("obs_noise", "action_noise", "rna_alpha"),
    init_lo=(0.0, 0.0, 0.0),
    init_hi=(0.04, 0.04, 0.25),
    limit_lo=(0.0, 0.0, 0.0),
    limit_hi=(0.04, 0.04, 0.25),
    delta=(0.0, 0.0, 0.0),
    queue_len=64,
    objective_lo=1.0,
    objective_hi=3.0,
)


@dataclass(frozen=True)
class DextremeConfig:
    num_envs: int = 256
    episode_length: int = 600
    adr: AdrConfig = DEXTREME_ADR
    rna_seed: int = 0


class DextremeState(NamedTuple):
    """The JAX package's DextremeState without its PRNG keys."""

    inner: DexState
    obs: torch.Tensor  # [B, 88] the last observation, with its noise (RNA's input)
    adr: AdrState
    rna: RNAState


class DextremeDraws(NamedTuple):
    """The draws of a step: the inner env's, ADR's recycling, the fresh
    masks' uniforms, standard normal action [B, 16] and
    observation [B, 88] noise. A reset reads `inner`, `adr` and `rna` (its
    `act` and `obs` may be None)."""

    inner: DexDraws
    adr: AdrDraws
    rna: MaskDraws
    act: torch.Tensor | None
    obs: torch.Tensor | None


class AllegroHandDextremeEnv:
    """The PPO contract: reset, step, num_obs, num_actions, cfg.num_envs."""

    state_type = DextremeState

    def __init__(self, cfg: DextremeConfig = DextremeConfig(), device=None, group=None):
        """`group`: the rank's DataParallel under ranks; ADR's queues then
        take every rank's finished episodes (`adr_step`)."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.group = group
        self.env = make_allegro(num_envs=cfg.num_envs, device=dev,
                                episode_length=cfg.episode_length)
        self.scene, self.art = self.env.scene, self.env.art  # the inner env's
        self.adr_cfg = cfg.adr
        self.num_obs = self.env.num_obs
        self.num_actions = self.env.num_actions
        self.num_teacher_obs = self.env.num_teacher_obs
        self.obs_slices = self.env.obs_slices
        gen = torch.Generator()
        gen.manual_seed(cfg.rna_seed)
        p = rna_init(gen, self.num_obs, self.num_actions)
        self.rna_params = p._replace(**{k: getattr(p, k).to(dev)
                                        for k in ("w1", "b1", "w2", "b2", "w3")})
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    def draw(self, B: int) -> DextremeDraws:
        normal = lambda *s: torch.randn(*s, generator=self.gen, device=self.device)
        return DextremeDraws(inner=self.env.draw(B),
                             adr=adr_draws(self.adr_cfg, B, self.gen, self.device),
                             rna=mask_draws(B, self.rna_params, self.gen),
                             act=normal(B, self.num_actions), obs=normal(B, self.num_obs))

    def reset(self, seed: int = 0, draws: DextremeDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes at ADR's initial
        ranges, the generators seeded with `seed`."""
        B = self.cfg.num_envs
        self.gen.manual_seed(seed)
        self.env.gen.manual_seed(seed)
        d = draws if draws is not None else self.draw(B)
        inner = self.env._fresh(B, d.inner)
        obs = self.env._obs(inner)
        state = DextremeState(inner=inner, obs=obs,
                              adr=init_adr_state(self.adr_cfg, B, draws=d.adr),
                              rna=rna_masks(self.rna_params, B, draws=d.rna))
        return state, obs

    def observe(self, state: DextremeState):
        obs = state.obs
        return obs, obs.new_zeros(obs.shape[0], 0), {"obs": obs}

    def step(self, state: DextremeState, actions, draws: DextremeDraws | None = None):
        """(new state, ClassicStepResult)."""
        B = actions.shape[0]
        d = draws if draws is not None else self.draw(B)
        vals = state.adr.values  # [B, 3]
        obs_noise, act_noise, alpha = vals[:, 0:1], vals[:, 1:2], vals[:, 2:3]

        a_rna = rna_apply(self.rna_params, state.rna, state.obs)
        a = (1.0 - alpha) * actions + alpha * a_rna
        a = a + act_noise * d.act
        inner, res = self.env.step(state.inner, a, d.inner)
        obs = res.obs + obs_noise * d.obs

        # ADR's objective: the goals reached this episode before the step
        adr = adr_step(self.adr_cfg, state.adr, res.done, state.inner.successes.float(),
                       draws=d.adr, group=self.group)
        fresh = rna_masks(self.rna_params, B, draws=d.rna)
        done = res.done[:, None]
        rna = RNAState(mask1=torch.where(done, fresh.mask1, state.rna.mask1),
                       mask2=torch.where(done, fresh.mask2, state.rna.mask2))
        info = dict(res.info)
        info["adr_range_width"] = (adr.hi - adr.lo).mean()
        info["rna_alpha_mean"] = alpha.mean()
        return DextremeState(inner=inner, obs=obs, adr=adr, rna=rna), ClassicStepResult(
            obs=obs, reward=res.reward, done=res.done, info=info, teacher_obs=res.teacher_obs)


def dextreme_config(num_envs: int = 256, **kw) -> DextremeConfig:
    return DextremeConfig(num_envs=num_envs, **kw)


def dextreme_manual_config(num_envs: int = 256, **kw) -> DextremeConfig:
    return DextremeConfig(num_envs=num_envs, adr=DEXTREME_MANUAL_DR, **kw)


def make_allegro_dextreme(num_envs: int = 256, device=None, **kw) -> AllegroHandDextremeEnv:
    return AllegroHandDextremeEnv(dextreme_config(num_envs, **kw), device)


def make_allegro_dextreme_manual(num_envs: int = 256, device=None,
                                 **kw) -> AllegroHandDextremeEnv:
    return AllegroHandDextremeEnv(dextreme_manual_config(num_envs, **kw), device)
