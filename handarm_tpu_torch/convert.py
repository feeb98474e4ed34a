"""Carry weights and state between the JAX package's numpy leaves and the
port, both ways: JAX -> port to read its checkpoints and states, port -> JAX
to write checkpoints its loader reads.

- flax `Dense` kernels are [in, out]; `nn.Linear` weights are [out, in]. The
  same holds for Adam's moments of each kernel.
- PhysicsState / EnvState leaves arrive in JAX's flattening order (NamedTuple
  fields in order, None fields absent): physics (q, qd, targets, object pos,
  quat, linvel, angvel, contact_impulse), control (the UR5+SIH's
  arm_target, servo_ticks, sih_smoothed; the Stretch's joint_target), task
  (progress, goal_pos, goal_quat, target_obj,
  goal_reached_before, initial_obj_pos, PRNG key, total_steps, then with
  domain randomization the DRState (mass_scale, friction_scale,
  gain_scale, gravity_z, obs_corr, act_corr) and with ADR the AdrState
  (lo, hi, worker_mode, values, q_sum, q_cnt)), metrics (success_ewma,
  per_object_ewma, total_resets, total_successes, end_success_ewma): 24
  leaves for the UR5+SIH, 22 for the Stretch, 6 more with DR and 6 more
  with ADR (`env_leaf_count`). The leaf count does not tell DR from ADR,
  so the readers take the HandArmConfig, whose `robot` also gives the
  control state's layout (without one: the UR5+SIH's). The PRNG key
  is dropped on the way in: the port draws from a torch.Generator. On the
  way out it is written as the JAX file has it, a [2] uint32 key from the
  seed (`jax.random.PRNGKey(seed)`'s value).
- A classic task's state flattens as the JAX package's: the physics with
  the floating base's pose (q, qd, targets, base_pos, base_quat, then the
  objects' leaves ([B, 0, ...] at K = 0) and the impulses; the craft's
  `tau_ext` is None between steps and drops out, the locomotion robots'
  stays, after base_quat), the task's own fields (the progress as int32),
  then its PRNG key last: 14 leaves for the Quadcopter (QuadState),
  BallBalance (BBotState, its ball among the object leaves) and Anymal
  (AnymalState), 13 for Ingenuity, 16 for the Ant and the Humanoid
  (LocoState), 18 for AnymalTerrain (ATState); the Franka's fixed base has
  no base pose and a None tau_ext between steps: 11 for FrankaCubeStack
  (FrankaState), 12 for FrankaCabinet (CabinetState, its persistent
  targets among them), 15 for Trifinger (TrifingerState) and the hands
  (DexState, its scalar consecutive-success average among them), 25 for
  AllegroKuka on one arm or two (AKState: its bool `lifted`, three scalars
  of the tolerance curriculum among them), 16 for the Factory tasks
  (FactoryState: its bool pick latch, the screw's unwrapped yaw, the
  fingertip forces, the bolt's position), 19 for IndustRealTaskPegsInsert
  (IRState: the weld, the bool insertion latch, the perception noise and
  SBC's three scalars among them); the DeXtreme wrapper's DextremeState nests the
  DexState (with its key), the last observation, the AdrState and the
  RNA masks before its own key: 25; the
  Cartpole's ClassicState has no physics: q, qd, progress, key. Its
  readers take the env's config (QuadcopterConfig, IngenuityConfig,
  ClassicConfig, LocomotionConfig, BallBalanceConfig, AnymalConfig,
  AnymalTerrainConfig, FrankaCubeStackConfig, FrankaCabinetConfig,
  TrifingerConfig, DexHandConfig, ShadowHandConfig, DextremeConfig,
  AllegroKukaConfig, AllegroKukaTwoArmsConfig, FactoryConfig,
  IndustRealConfig) in place of a HandArmConfig. Integer leaves are int32
  there and int64 here, bool leaves bool on both sides.
- `rna_params_from_arrays` carries the JAX package's RNAParams (the
  DeXtreme adversary's fixed weights) into the port.
- A PPO TrainState's leaves (`utils/checkpoint.py` documents them):
  params, optax state, both running stats, lr, env state, last obs, key,
  epoch (71 for the 768-512-256 MLP on the UR5+SIH, 69 on the Stretch),
  then with an asymmetric critic the
  teacher-observation stats and the last teacher observations, then on
  the recurrent path the carry: (c, h), or actor (c, h) and critic (c, h).
  Its params and their order follow from the PPOConfig
  (`learn.ppo.param_names`), not from the leaf count: readers and writers
  of the asymmetric and recurrent layouts take the config.
- A distilled student (`student.npz`) is its params alone, in flax order
  (`StudentPolicy.flax_names`; `params_from_leaves` reads any net that
  lists its flax names).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from handarm_tpu_torch.envs.adr import AdrState
from handarm_tpu_torch.envs.allegro_kuka import AKState
from handarm_tpu_torch.envs.classic import ClassicState
from handarm_tpu_torch.envs.dexhand import DexState
from handarm_tpu_torch.envs.dextreme import DextremeState
from handarm_tpu_torch.envs.factory import FactoryState
from handarm_tpu_torch.envs.franka import FrankaState
from handarm_tpu_torch.envs.franka_cabinet import CabinetState
from handarm_tpu_torch.envs.hand_arm import EnvState, HandArmConfig, Metrics, TaskState
from handarm_tpu_torch.envs.industreal import IRState
from handarm_tpu_torch.envs.locomotion import LocoState
from handarm_tpu_torch.envs.registry import CLASSIC_ENVS
from handarm_tpu_torch.envs.trifinger import TrifingerState
from handarm_tpu_torch.envs.randomization import DRState
from handarm_tpu_torch.learn import optim
from handarm_tpu_torch.learn.networks import ActorCritic, flax_names
from handarm_tpu_torch.learn.ppo import PPOConfig, TrainState, param_names
from handarm_tpu_torch.learn.rna import RNAParams, RNAState
from handarm_tpu_torch.learn.running_stats import RunningStats
from handarm_tpu_torch.physics.engine import ObjectState, PhysicsState, RobotState
from handarm_tpu_torch.robots import ROBOTS, control_type

N_PHYSICS_LEAVES = 8  # of a fixed base; a floating base adds its pose: 10
N_TASK_LEAVES = 8  # without DR and ADR
N_METRIC_LEAVES = 5
N_ENV_LEAVES = 24  # of the UR5+SIH, without DR and ADR
N_RAND_LEAVES = 6  # of a DRState, and of an AdrState
OPT_SCALARS = (np.int32, np.bool_, np.int32, np.int32)  # optax's, in its order
# the classic tasks' env states by their configs
CLASSIC_STATES = {cfg: env.state_type for cfg, env in CLASSIC_ENVS.items()}
# the physics leaves of a classic state: a floating base's pose, and the
# locomotion robots' tau_ext; the Cartpole's state holds no physics, the
# Franka's a fixed base's (the DeXtreme wrapper's inner DexState leads its
# leaves)
N_CLASSIC_PHYSICS = {ClassicState: 0, LocoState: N_PHYSICS_LEAVES + 3,
                     FrankaState: N_PHYSICS_LEAVES, CabinetState: N_PHYSICS_LEAVES,
                     TrifingerState: N_PHYSICS_LEAVES, DexState: N_PHYSICS_LEAVES,
                     AKState: N_PHYSICS_LEAVES, DextremeState: N_PHYSICS_LEAVES,
                     FactoryState: N_PHYSICS_LEAVES, IRState: N_PHYSICS_LEAVES}
N_RNA_LEAVES = 2  # an RNAState's masks


def actor_critic_from_params(params: dict, device="cpu") -> ActorCritic:
    """Build an ActorCritic from flax params named as in utils.checkpoint."""
    L = _num_hidden(len(params))
    net = ActorCritic(params["dense_0.kernel"].shape[0], params["mu.kernel"].shape[1],
                      hidden=[params[f"dense_{i}.kernel"].shape[1] for i in range(L)])
    net.load_state_dict({t: _to_torch_layout(f, params[f], "cpu") for f, t in flax_names(L)})
    return net.to(device)


def params_from_leaves(net, leaves: Sequence[np.ndarray], device="cpu") -> dict:
    """The params (module name -> tensor) of a net with `flax_names()` (a
    StudentPolicy, or a net of learn/networks.py) from its leaves in flax
    order; each leaf's shape must be the net's."""
    names = net.flax_names()
    if len(leaves) != len(names):
        raise ValueError(f"expected {len(names)} leaves, got {len(leaves)}")
    own = dict(net.named_parameters())
    params = {}
    for (f, t), x in zip(names, leaves):
        params[t] = _to_torch_layout(f, x, device)
        if params[t].shape != own[t].shape:
            raise ValueError(f"leaf {f}: shape {tuple(np.shape(x))} does not fit "
                             f"{tuple(own[t].shape)}")
    return params


def params_to_leaves(net, params: dict) -> list[np.ndarray]:
    """The params of a net with `flax_names()` as its leaves in flax order
    and layout."""
    return [_to_flax_layout(f, params[t]) for f, t in net.flax_names()]


def running_stats_from_leaves(mean, var, count, device="cpu") -> RunningStats:
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    return RunningStats(t(mean), t(var), t(count))


def physics_state_from_leaves(leaves: Sequence[np.ndarray], device="cpu") -> PhysicsState:
    """A PhysicsState of its 8 leaves, 10 with a floating base's pose, 11
    with its tau_ext as well."""
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    x = [t(v) for v in leaves]
    if len(x) >= N_PHYSICS_LEAVES + 2:
        q, qd, tg, bp, bq, *tau, pos, quat, lv, av, imp = x
        return PhysicsState(RobotState(q, qd, tg, bp, bq, *tau), ObjectState(pos, quat, lv, av),
                            imp)
    q, qd, tg, pos, quat, lv, av, imp = x
    return PhysicsState(RobotState(q, qd, tg), ObjectState(pos, quat, lv, av), imp)


def physics_state_to_leaves(p: PhysicsState) -> list[np.ndarray]:
    """The leaves of a PhysicsState in the JAX package's order (None fields,
    such as a fixed base's pose and a cleared tau_ext, drop out)."""
    f = lambda x: x.detach().cpu().numpy().astype(np.float32)
    return [f(x) for x in (*p.robot, *p.objects, p.contact_impulse) if x is not None]


def classic_physics_leaves(state_type) -> int:
    """Leaves of a classic task's physics: the craft's floating base (10),
    the locomotion robots' with tau_ext (11), the fixed bases of the Franka, the
    Trifinger and the hands (8), none (the Cartpole)."""
    return N_CLASSIC_PHYSICS.get(state_type, N_PHYSICS_LEAVES + 2)


def classic_leaf_count(state_type) -> int:
    """Leaves of a classic task's state: its physics, its own fields, the
    PRNG key; a DextremeState's: the inner DexState's, the last
    observation, the AdrState's, the RNA masks, the PRNG key."""
    if state_type is DextremeState:
        return classic_leaf_count(DexState) + 1 + N_RAND_LEAVES + N_RNA_LEAVES + 1
    k = classic_physics_leaves(state_type)
    return k + len(state_type._fields) - (k > 0) + 1


def _own_leaf(x, device) -> torch.Tensor:
    """A state leaf in the port's dtype: bool kept, integers int64, float32."""
    x = np.asarray(x)
    if x.dtype != np.bool_:
        x = x.astype(np.int64 if np.issubdtype(x.dtype, np.integer) else np.float32)
    return torch.tensor(x, device=device)


def _own_to_leaf(x: torch.Tensor) -> np.ndarray:
    """A state leaf in the JAX package's dtype: bool kept, integers int32,
    float32."""
    x = x.detach().cpu().numpy()
    if x.dtype == np.bool_:
        return x
    return x.astype(np.float32 if np.issubdtype(x.dtype, np.floating) else np.int32)


def classic_state_from_leaves(leaves: Sequence[np.ndarray], state_type, device="cpu"):
    """A classic task's state (`state_type`) of its leaves; the key is
    dropped."""
    n = classic_leaf_count(state_type)
    if len(leaves) != n:
        raise ValueError(f"expected {n} {state_type.__name__} leaves, got {len(leaves)}")
    if state_type is DextremeState:
        return dextreme_state_from_leaves(leaves, device)
    k = classic_physics_leaves(state_type)
    own = [_own_leaf(x, device) for x in leaves[k:-1]]
    if not k:
        return state_type(*own)
    return state_type(physics_state_from_leaves(leaves[:k], device), *own)


def classic_state_to_leaves(state, seed: int = 0) -> list[np.ndarray]:
    if isinstance(state, DextremeState):
        return dextreme_state_to_leaves(state, seed)
    physics = getattr(state, "physics", None)
    own = [_own_to_leaf(x) for x in (state[1:] if physics is not None else state)]
    return ((physics_state_to_leaves(physics) if physics is not None else []) + own
            + [prng_key(seed)])


def dextreme_state_from_leaves(leaves: Sequence[np.ndarray], device="cpu") -> DextremeState:
    """A DextremeState of its 25 leaves (the inner DexState's 15 with its
    key, the observation, the AdrState's 6 with the int32 `worker_mode`, the
    two RNA masks, the key); both keys are dropped."""
    k = classic_leaf_count(DexState)
    inner = classic_state_from_leaves(leaves[:k], DexState, device)
    obs, *rest = [_own_leaf(x, device) for x in leaves[k:-1]]
    adr = AdrState(*rest[:N_RAND_LEAVES])
    return DextremeState(inner=inner, obs=obs, adr=adr, rna=RNAState(*rest[N_RAND_LEAVES:]))


def dextreme_state_to_leaves(state: DextremeState, seed: int = 0) -> list[np.ndarray]:
    """The 25 leaves of a DextremeState in the JAX package's order and dtypes,
    both keys `prng_key(seed)`."""
    own = [state.obs, *state.adr, *state.rna]
    return (classic_state_to_leaves(state.inner, seed) + [_own_to_leaf(x) for x in own]
            + [prng_key(seed)])


def rna_params_from_arrays(p, device="cpu") -> RNAParams:
    """The port's RNAParams of any object with the JAX package's RNAParams
    fields (w1, b1, w2, b2, w3 as arrays, num_actions, bins)."""
    t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    return RNAParams(w1=t(p.w1), b1=t(p.b1), w2=t(p.w2), b2=t(p.b2), w3=t(p.w3),
                     num_actions=int(p.num_actions), bins=int(p.bins))


def control_leaf_count(robot: str) -> int:
    return len(control_type(robot)._fields)


def env_leaf_counts() -> set[int]:
    """Every env-state leaf count of a ported robot, with or without DR and
    ADR, and of the classic tasks."""
    base = N_PHYSICS_LEAVES + N_TASK_LEAVES + N_METRIC_LEAVES
    return ({base + control_leaf_count(r) + N_RAND_LEAVES * k for r in ROBOTS
             for k in range(3)} | {classic_leaf_count(s) for s in CLASSIC_STATES.values()})


def physics_leaf_count(n_env: int) -> int:
    """The physics leaves of an env state of `n_env` leaves (a classic
    task's: `classic_physics_leaves`)."""
    for s in CLASSIC_STATES.values():
        if classic_leaf_count(s) == n_env:
            return classic_physics_leaves(s)
    return N_PHYSICS_LEAVES


def env_leaf_count(env_cfg=None) -> int:
    """Env-state leaves of an env with `env_cfg` (None: the UR5+SIH without
    DR and ADR; a classic task's config: its state's)."""
    if type(env_cfg) in CLASSIC_STATES:
        return classic_leaf_count(CLASSIC_STATES[type(env_cfg)])
    robot = env_cfg.robot if env_cfg is not None else "ur5sih"
    rand = env_cfg.dr.enabled + env_cfg.adr.enabled if env_cfg is not None else 0
    return (N_PHYSICS_LEAVES + control_leaf_count(robot) + N_TASK_LEAVES + N_METRIC_LEAVES
            + N_RAND_LEAVES * rand)


def env_state_from_leaves(leaves: Sequence[np.ndarray], device="cpu", env_cfg=None):
    """The env state of an env with `env_cfg` (None: the UR5+SIH without DR
    and ADR; a classic task's config: its state) from its leaves;
    ValueError if their count is not that layout's."""
    if type(env_cfg) in CLASSIC_STATES:
        return classic_state_from_leaves(leaves, CLASSIC_STATES[type(env_cfg)], device)
    n = env_leaf_count(env_cfg)
    robot = env_cfg.robot if env_cfg is not None else "ur5sih"
    if len(leaves) != n:
        raise ValueError(f"expected {n} EnvState leaves for this config (robot {robot}, DR "
                         f"{bool(env_cfg and env_cfg.dr.enabled)}, ADR "
                         f"{bool(env_cfg and env_cfg.adr.enabled)}), got {len(leaves)}")
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    i = lambda x: torch.tensor(np.asarray(x).astype(np.int64), device=device)
    physics = physics_state_from_leaves(leaves[:N_PHYSICS_LEAVES], device)
    k = N_PHYSICS_LEAVES + control_leaf_count(robot)
    control = control_type(robot)(*(f(x) for x in leaves[N_PHYSICS_LEAVES:k]))
    (progress, goal_pos, goal_quat, target, reached, init_pos, _key,
     total) = leaves[k:k + N_TASK_LEAVES]
    k += N_TASK_LEAVES
    dr = adr = None
    if env_cfg is not None and env_cfg.dr.enabled:
        dr = DRState(*(f(x) for x in leaves[k:k + N_RAND_LEAVES]))
        k += N_RAND_LEAVES
    if env_cfg is not None and env_cfg.adr.enabled:
        lo, hi, mode, values, q_sum, q_cnt = leaves[k:k + N_RAND_LEAVES]
        adr = AdrState(f(lo), f(hi), i(mode), f(values), f(q_sum), f(q_cnt))
        k += N_RAND_LEAVES
    task = TaskState(
        progress=i(progress), goal_pos=f(goal_pos), goal_quat=f(goal_quat),
        target_obj=i(target),
        goal_reached_before=torch.tensor(np.asarray(reached), device=device),
        initial_obj_pos=f(init_pos), total_steps=i(total), dr=dr, adr=adr,
    )
    metrics = Metrics(*(f(x) for x in leaves[k:k + 5]))
    return EnvState(physics, control, task, metrics)


def _num_hidden(n_params: int) -> int:
    return (n_params - 5) // 2  # bias and kernel per layer, mu and value, log_std


def _to_torch_layout(name: str, x, device) -> torch.Tensor:
    t = torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    return t.T.contiguous() if name.endswith(".kernel") else t


def _to_flax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    x = t.detach().cpu()
    return np.ascontiguousarray((x.T if name.endswith(".kernel") else x).numpy())


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a seed below 2^32: [0, seed] uint32."""
    return np.asarray([0, seed], np.uint32)


def learner_leaf_count(n_params: int) -> int:
    """Leaves of params, optax state (4 scalars, Adam's mu and nu), both
    running stats and lr: where the env state starts."""
    return 3 * n_params + 4 + 7


def names_of(cfg: PPOConfig | None, n_params: int | None = None) -> list[tuple[str, str]]:
    """The learner's parameter names: `cfg`'s, or without one those of the
    MLP ActorCritic with `n_params` parameters."""
    return param_names(cfg) if cfg is not None else flax_names(_num_hidden(n_params))


def learner_from_leaves(leaves: Sequence[np.ndarray], names, device="cpu") -> tuple:
    """(params, optax state, obs stats, value stats, lr) of the first
    `learner_leaf_count` leaves."""
    P = len(names)
    params = {t: _to_torch_layout(f, leaves[i], device) for i, (f, t) in enumerate(names)}
    i32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.int32, device=device)
    moment = lambda off: {t: _to_torch_layout(f, leaves[off + i], device)
                          for i, (f, t) in enumerate(names)}
    opt = optim.OptState(
        notfinite_count=i32(leaves[P]),
        last_finite=torch.tensor(bool(leaves[P + 1]), device=device),
        total_notfinite=i32(leaves[P + 2]), count=i32(leaves[P + 3]),
        mu=moment(P + 4), nu=moment(P + 4 + P))
    k = P + 4 + 2 * P
    return (params, opt, running_stats_from_leaves(*leaves[k:k + 3], device=device),
            running_stats_from_leaves(*leaves[k + 3:k + 6], device=device),
            torch.tensor(np.asarray(leaves[k + 6]), dtype=torch.float32, device=device))


def extra_leaf_count(cfg: PPOConfig | None) -> int:
    """Leaves after the epoch: the teacher-observation stats and the last
    teacher observations (asymmetric), the carry (recurrent)."""
    if cfg is None:
        return 0
    carry = 2 * (1 + cfg.asymmetric_critic) if cfg.rnn_units > 0 else 0
    return 4 * cfg.asymmetric_critic + carry


def extra_from_leaves(leaves: Sequence[np.ndarray], cfg: PPOConfig, device="cpu") -> dict:
    """TrainState fields (teacher_obs_stats, last_teacher_obs, hidden) of
    the `extra_leaf_count` leaves after the epoch."""
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    out, i = {}, 0
    if cfg.asymmetric_critic:
        out["teacher_obs_stats"] = running_stats_from_leaves(*leaves[:3], device=device)
        out["last_teacher_obs"] = f(leaves[3])
        i = 4
    if cfg.rnn_units > 0:
        c = [f(x) for x in leaves[i:]]
        out["hidden"] = ({"actor": (c[0], c[1]), "critic": (c[2], c[3])}
                         if cfg.asymmetric_critic else (c[0], c[1]))
    return out


def train_state_from_leaves(leaves: Sequence[np.ndarray], env_state, last_obs,
                            device="cpu", cfg: PPOConfig | None = None,
                            n_env: int = N_ENV_LEAVES) -> TrainState:
    """The learner part of a PPO checkpoint's leaves (params, optax state,
    running stats, lr, epoch, and `cfg`'s teacher stats, last teacher
    observations and carry) with the given env state and observations; the
    file's env state has `n_env` leaves. Without `cfg`, an MLP ActorCritic
    checkpoint (its size from the leaf count)."""
    extra = extra_leaf_count(cfg)
    if cfg is None:
        # P params, 4 optax scalars, 2 P moments, 7 stats and lr, the env
        # state, last obs, key, epoch
        P, rest = divmod(len(leaves) - 4 - 7 - n_env - 3, 3)
        if rest or P < 7:
            raise ValueError(f"{len(leaves)} leaves are not a PPO TrainState")
    else:
        P = len(param_names(cfg))
        if len(leaves) != learner_leaf_count(P) + n_env + 3 + extra:
            raise ValueError(f"{len(leaves)} leaves are not a PPO TrainState of {cfg}")
    names = names_of(cfg, P)
    params, opt, obs_stats, value_stats, lr = learner_from_leaves(leaves, names, device)
    k = learner_leaf_count(P) + n_env + 2
    return TrainState(
        params=params, opt_state=opt, obs_stats=obs_stats, value_stats=value_stats, lr=lr,
        env_state=env_state, last_obs=last_obs,
        epoch=torch.tensor(np.asarray(leaves[k]), dtype=torch.int32, device=device),
        **(extra_from_leaves(leaves[k + 1:], cfg, device) if extra else {}),
    )


def env_state_to_leaves(state, seed: int = 0, env_cfg=None) -> list[np.ndarray]:
    """The env-state leaves (the UR5+SIH's 24, the Stretch's 22, 6 more for
    each of DR and ADR; a classic task's 4, 11-16 or 18) in the JAX package's
    order and dtypes. Given a HandArmConfig `env_cfg`, the state must hold
    its DR and ADR states, and only those."""
    if type(state) in CLASSIC_STATES.values():
        return classic_state_to_leaves(state, seed)
    np_ = lambda x: x.detach().cpu().numpy()
    f = lambda x: np_(x).astype(np.float32)
    i32 = lambda x: np_(x).astype(np.int32)
    p, c, t, m = state.physics, state.control, state.task, state.metrics
    if env_cfg is not None and ((t.dr is None) == env_cfg.dr.enabled
                                or (t.adr is None) == env_cfg.adr.enabled):
        raise ValueError("the env state's DR and ADR states are not its config's")
    rand = [f(x) for x in t.dr] if t.dr is not None else []
    if t.adr is not None:
        a = t.adr
        rand += [f(a.lo), f(a.hi), i32(a.worker_mode), f(a.values), f(a.q_sum), f(a.q_cnt)]
    return [
        *physics_state_to_leaves(p),
        *(f(x) for x in c),
        i32(t.progress), f(t.goal_pos), f(t.goal_quat), i32(t.target_obj),
        np_(t.goal_reached_before).astype(np.bool_), f(t.initial_obj_pos), prng_key(seed),
        i32(t.total_steps), *rand,
        *(f(x) for x in m),
    ]


def learner_to_leaves(ts: TrainState, cfg: PPOConfig | None = None) -> list[np.ndarray]:
    """The leading leaves of a PPO TrainState (params, optax state, both
    running stats, lr: 0-43 for the 768-512-256 MLP) in the JAX package's
    order, layouts and dtypes; the params are `cfg`'s, or without it the
    MLP ActorCritic's."""
    names = names_of(cfg, len(ts.params))
    o = ts.opt_state
    f = lambda x: x.detach().cpu().numpy().astype(np.float32)
    leaves = [_to_flax_layout(fn, ts.params[t]) for fn, t in names]
    leaves += [x.detach().cpu().numpy().astype(dt) for x, dt in zip(o[:4], OPT_SCALARS)]
    leaves += [_to_flax_layout(fn, o.mu[t]) for fn, t in names]
    leaves += [_to_flax_layout(fn, o.nu[t]) for fn, t in names]
    return leaves + [f(x) for x in (*ts.obs_stats, *ts.value_stats, ts.lr)]


def extra_to_leaves(ts: TrainState) -> list[np.ndarray]:
    """The leaves after the epoch: the teacher-observation stats and the
    last teacher observations, then the carry, those the state has."""
    f = lambda x: x.detach().cpu().numpy().astype(np.float32)
    out = []
    if ts.teacher_obs_stats is not None:
        out += [f(x) for x in ts.teacher_obs_stats]
    if ts.last_teacher_obs is not None:
        out.append(f(ts.last_teacher_obs))
    h = ts.hidden
    if h is not None:
        out += [f(x) for x in ((*h["actor"], *h["critic"]) if isinstance(h, dict) else h)]
    return out


def train_state_to_leaves(ts: TrainState, seed: int = 0, cfg: PPOConfig | None = None,
                          env_cfg: HandArmConfig | None = None) -> list[np.ndarray]:
    """The leaves of a PPO TrainState (71 for the 768-512-256 MLP on the
    UR5+SIH, 69 on the Stretch, 12 more with DR and ADR); both PRNG keys
    are `prng_key(seed)`."""
    return (learner_to_leaves(ts, cfg) + env_state_to_leaves(ts.env_state, seed, env_cfg)
            + [ts.last_obs.detach().cpu().numpy().astype(np.float32), prng_key(seed),
               ts.epoch.detach().cpu().numpy().astype(np.int32)] + extra_to_leaves(ts))
