"""Classic contact-free task suite (counterpart of handarm_tpu/envs/classic.py;
reference IsaacGymEnvs tasks/cartpole.py): a fixed-base articulation with
effort or PD actuation and task-specific observation and reward functions.
First member: Cartpole (effort on the slider; obs [cart_pos, cart_vel,
pole_angle, pole_vel]; balance reward; tilt / track-limit termination).

The step is FK, dynamics (the SPD-inverse kernel at the model's n, 2 for
the Cartpole) and integration, `substeps * control_freq_inv` times, with
no contact pipeline. The env holds its state on one device and draws from
its own torch.Generator, seeded by `reset(seed)`; `reset` and `step` take
`ClassicDraws` in place of those draws (a test hands over the JAX
package's).

The Cartpole's URDF defaults to the in-repo stand-in
`assets/classic_standin/cartpole.urdf` (the JAX package's default is the
reference asset tree's `urdf/cartpole.urdf`, which this repository does not
carry); `urdf=` overrides it.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.hand_arm import _where_done
from handarm_tpu_torch.envs.quadcopter import ClassicStepResult
from handarm_tpu_torch.physics.dynamics import compute_dyn, stable_pd_torque
from handarm_tpu_torch.physics.kinematics import forward_kinematics, model_arrays
from handarm_tpu_torch.physics.model import compile_urdf

STANDIN_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "classic_standin")
CARTPOLE_URDF = os.path.join(STANDIN_ROOT, "cartpole.urdf")


@dataclass(frozen=True)
class ClassicConfig:
    urdf: str = CARTPOLE_URDF
    num_envs: int = 512
    episode_length: int = 500
    dt: float = 1.0 / 60.0
    substeps: int = 2
    control_freq_inv: int = 1
    actuation: str = "effort"  # effort | position
    effort_scale: tuple | float = 400.0  # action -> torque scaling
    actuated_dofs: tuple = (0,)  # which dofs receive actions
    kp: float = 0.0
    kd: float = 0.0
    reset_noise: float = 0.1  # uniform initial q / qd noise half-range
    gravity: tuple = (0.0, 0.0, -9.81)


class ClassicState(NamedTuple):
    """The JAX package's ClassicState without its PRNG key (a checkpoint
    writes the key leaf as the JAX file has it)."""

    q: torch.Tensor  # [B, nv]
    qd: torch.Tensor  # [B, nv]
    progress: torch.Tensor  # [B] int64


class ClassicDraws(NamedTuple):
    """The draws of fresh episodes: `q` and `qd` [B, nv], each uniform in
    [-reset_noise, reset_noise)."""

    q: torch.Tensor
    qd: torch.Tensor


class ClassicEnv:
    """Contact-free articulation env parameterized by obs / reward fns:
    obs_fn(q, qd) -> [B, obs]; reward_fn(q, qd, progress, cfg) -> (reward
    [B], terminated [B])."""

    state_type = ClassicState

    def __init__(self, cfg: ClassicConfig, obs_fn: Callable, reward_fn: Callable,
                 num_obs: int, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.art = compile_urdf(cfg.urdf, default_armature=0.0)
        self.m = model_arrays(self.art, device=dev)
        self.obs_fn, self.reward_fn = obs_fn, reward_fn
        self.num_obs = num_obs
        self.num_actions = len(cfg.actuated_dofs)
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, num_obs)}
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        self.gravity = f32(cfg.gravity)
        nv = self.art.nv
        scale = np.zeros(nv)
        es = np.broadcast_to(np.asarray(cfg.effort_scale, dtype=np.float64),
                             (self.num_actions,))
        for i, d in enumerate(cfg.actuated_dofs):
            scale[d] = es[i]
        self.effort_map = f32(scale)
        self.kp = f32(np.full(nv, cfg.kp))
        self.kd = f32(np.full(nv, cfg.kd))
        self._base_quat = f32([[1.0, 0.0, 0.0, 0.0]])
        self._base_pos = f32([[0.0, 0.0, 0.0]])
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    def draw(self, B: int) -> ClassicDraws:
        n = self.cfg.reset_noise
        u = lambda: torch.rand(B, self.art.nv, generator=self.gen, device=self.device)
        return ClassicDraws(q=u() * (2.0 * n) - n, qd=u() * (2.0 * n) - n)

    def _fresh(self, B: int, draws: ClassicDraws | None = None) -> ClassicState:
        d = draws if draws is not None else self.draw(B)
        return ClassicState(q=d.q, qd=d.qd,
                            progress=torch.zeros(B, dtype=torch.int64, device=self.device))

    def reset(self, seed: int = 0, draws: ClassicDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        s = self._fresh(self.cfg.num_envs, draws)
        return s, self.obs_fn(s.q, s.qd)

    def step(self, state: ClassicState, actions, draws: ClassicDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg, m = self.cfg, self.m
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        h = cfg.dt / cfg.substeps
        tau_ext = actions.new_zeros(B, self.art.nv)
        for i, d in enumerate(cfg.actuated_dofs):
            tau_ext[:, d] = actions[:, i] * self.effort_map[d]
        q, qd = state.q, state.qd
        for _ in range(cfg.substeps * cfg.control_freq_inv):
            fk = forward_kinematics(m, q, self._base_quat, self._base_pos)
            dyn = compute_dyn(m, fk, qd, self.gravity, self.kp, self.kd, h)
            tau = tau_ext
            if cfg.actuation == "position":
                tau = tau + stable_pd_torque(
                    q, qd, tau_ext / torch.clamp(self.effort_map, min=1e-9), self.kp,
                    self.kd, h, m.effort_limit)
            qd = qd + h * dyn.solve(tau - dyn.bias)
            q = q + h * qd
            q = torch.minimum(torch.maximum(q, m.q_min), m.q_max)  # joint limits
        progress = state.progress + 1
        reward, terminated = self.reward_fn(q, qd, progress, cfg)
        done = terminated | (progress >= cfg.episode_length)
        fresh = self._fresh(B, draws)
        new_state = ClassicState(q=_where_done(done, fresh.q, q),
                                 qd=_where_done(done, fresh.qd, qd),
                                 progress=torch.where(done, 0, progress))
        obs = self.obs_fn(new_state.q, new_state.qd)
        return new_state, ClassicStepResult(obs=obs, reward=reward, done=done, info={},
                                            teacher_obs=obs.new_zeros(B, 0))


# --- Cartpole ---------------------------------------------------------------


def _cartpole_obs(q, qd):
    return torch.stack([q[:, 0], qd[:, 0], q[:, 1], qd[:, 1]], dim=-1)


def _cartpole_reward(q, qd, progress, cfg):
    cart_pos, pole_angle = q[:, 0], q[:, 1]
    cart_vel, pole_vel = qd[:, 0], qd[:, 1]
    reward = (1.0 - pole_angle * pole_angle - 0.01 * torch.abs(cart_vel)
              - 0.005 * torch.abs(pole_vel))
    bad = (torch.abs(cart_pos) > 3.0) | (torch.abs(pole_angle) > math.pi / 2)
    reward = torch.where(bad, torch.full_like(reward, -2.0), reward)
    return reward, bad


class CartpoleEnv(ClassicEnv):
    """The Cartpole as `make_cartpole` builds it, from its config alone (what
    the registry's `build_env` calls)."""

    def __init__(self, cfg: ClassicConfig, device=None, group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs."""
        super().__init__(cfg, _cartpole_obs, _cartpole_reward, num_obs=4, device=device)
        # slider (prismatic) then pole (revolute)
        assert self.art.nv == 2, self.art.joint_names


def cartpole_config(num_envs: int = 512, episode_length: int = 500, **kw) -> ClassicConfig:
    """Reference Cartpole (cfg/task/Cartpole.yaml: maxEffort 400, resetDist 3,
    reward / termination from tasks/cartpole.py compute_cartpole_reward)."""
    return ClassicConfig(num_envs=num_envs, episode_length=episode_length,
                         **{"actuated_dofs": (0,), "effort_scale": 400.0, "reset_noise": 0.1,
                            **kw})


def make_cartpole(num_envs: int = 512, episode_length: int = 500, device=None,
                  **kw) -> CartpoleEnv:
    return CartpoleEnv(cartpole_config(num_envs, episode_length, **kw), device)
