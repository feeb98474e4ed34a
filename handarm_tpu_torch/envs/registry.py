"""Tasks by name through the yaml config groups, as the JAX package's entry
points build them (counterpart of `make_env`, `env_from_yaml`,
`_warn_unknown_yaml_keys`, `compose_task`, `register_classic` and
`all_task_names` of handarm_tpu/envs/registry.py: the UR5+SIH and Stretch
tasks, and of the classic tasks Quadcopter, Ingenuity, Cartpole, Ant,
Humanoid, BallBalance, Anymal, AnymalTerrain, FrankaCubeStack,
FrankaCabinet, Trifinger, AllegroHand, ShadowHand, ShadowHandOpenAI_FF,
ShadowHandOpenAI_LSTM, AllegroHandDextremeADR, AllegroHandADR,
AllegroHandManualDR, AllegroKukaReorientation, AllegroKukaRegrasping,
AllegroKukaThrow, AllegroKuka, AllegroKukaTwoArmsReorientation,
AllegroKukaTwoArmsRegrasping, AllegroKukaTwoArms, FactoryTaskNutBoltPick,
FactoryTaskNutBoltPlace, FactoryTaskNutBoltScrew, FactoryTaskGears,
FactoryTaskInsertion and IndustRealTaskPegsInsert).

`compose_task(name, overrides)` reads `configs/task/<name>.yaml` and
`configs/train/<name>PPO.yaml`, the same files the JAX package reads:

- A task yaml with full-config keys (`rl`, `sim`, `objects`, ...; for
  example Ur5SihMultiObjectManipulation, which inherits Ur5SihMultiObject
  and Ur5SihBase) is read whole by `env_from_yaml`: its own `ppo` block <
  the train yaml's < the overrides. Overrides are dotted yaml keys
  (`env.num_envs=8`, `rl.goal=throw`, `sim.solver_iterations=8`,
  `ppo.minibatch_size=64`); a bare `num_envs=8` is an unknown top-level key
  and raises.
- Otherwise the yaml's `env` block overrides the code preset of
  `envs/tasks.py` field by field (`make_env`): preset < task yaml < train
  yaml < overrides, each `<field>=value` or `env.<field>=value` for a
  HandArmConfig field, or `ppo.<field>=value`; an unknown field raises
  KeyError.

A classic task (`CLASSIC_TASKS`) composes as in the JAX package: its task
yaml's `env` block < the train yaml's `ppo` block < the overrides, over
the registry's PPO defaults. `env.`-prefixed or bare keys: `num_envs`
(512 by default), `episode_length` (500), `subtask` (passed on where the
factory takes one) and any other field of the env's config dataclass
(an unknown one raises TypeError); `ppo.<field>=` keys. Cartpole's
`urdf=` and the Ant's `mjcf=` take another asset; the Humanoid's factory
sets its own MJCF and refuses `mjcf=` (TypeError), as the JAX package's
does, so another Humanoid asset comes through `dataclasses.replace` of its
config. BallBalance, Anymal, AnymalTerrain and the two Franka tasks read
their module constants' stand-in assets and take no path, as the JAX
package's factories take none, and so do Trifinger and the hands; the
ANYmal tasks' registry default of 500 steps becomes their own 1000,
FrankaCubeStack's its own 300, Trifinger's 750 and the hands' 600 (the
DeXtreme and AllegroKuka tasks' too, on one arm and on two). The
ShadowHandOpenAI tasks are ShadowHand with `obs_type="openai"` and the
asymmetric critic (an MLP, or LSTMs for actor and critic). The DeXtreme tasks (AllegroHandDextremeADR
and its alias AllegroHandADR; AllegroHandManualDR with fixed ranges) wrap
AllegroHand with ADR and the random network adversary, under an LSTM 512
before a 512-512 MLP; the AllegroKuka tasks take their variant from the
name, or, as `AllegroKuka` and `AllegroKukaTwoArms`, from `env.subtask`
(reorientation by default; those resolvers take no other env field, as the
JAX package's). The Factory tasks (the variant from the name) and
IndustRealTaskPegsInsert (with its asymmetric critic) run on the stand-in
Franka with the tracked part records; as the JAX package's factories, they
keep `num_envs` and `episode_length` (the registry's 500 -> 100 and 128)
and drop every other env key. The JAX package's other classic tasks
(HumanoidAMP, IndustRealTaskGearsInsert) are not ported: naming one raises
NotImplementedError (ROADMAP §1.7).

Each function has a `*_config` form that stops at the env's config (a
HandArmConfig, or a classic task's config dataclass) and the PPO
overrides, without building the env; `build_env` builds the env of
either.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os

from handarm_tpu_torch.envs.adr import AdrConfig
from handarm_tpu_torch.envs.allegro_kuka import (
    AllegroKukaConfig,
    AllegroKukaEnv,
    AllegroKukaTwoArmsConfig,
    AllegroKukaTwoArmsEnv,
    allegro_kuka_config,
    allegro_kuka_two_arms_config,
)
from handarm_tpu_torch.envs.anymal import AnymalConfig, AnymalEnv, anymal_config
from handarm_tpu_torch.envs.anymal_terrain import (
    AnymalTerrainConfig,
    AnymalTerrainEnv,
    anymal_terrain_config,
)
from handarm_tpu_torch.envs.ball_balance import (
    BallBalanceConfig,
    BallBalanceEnv,
    ball_balance_config,
)
from handarm_tpu_torch.envs.camera import CameraConfig
from handarm_tpu_torch.envs.classic import CartpoleEnv, ClassicConfig, cartpole_config
from handarm_tpu_torch.envs.dexhand import (
    AllegroHandEnv,
    DexHandConfig,
    ShadowHandConfig,
    ShadowHandEnv,
    allegro_config,
    shadow_config,
)
from handarm_tpu_torch.envs.dextreme import (
    AllegroHandDextremeEnv,
    DextremeConfig,
    dextreme_config,
    dextreme_manual_config,
)
from handarm_tpu_torch.envs.factory import FactoryConfig, FactoryNutBoltEnv, factory_config
from handarm_tpu_torch.envs.franka import (
    FrankaCubeStackConfig,
    FrankaCubeStackEnv,
    franka_cube_stack_config,
)
from handarm_tpu_torch.envs.franka_cabinet import (
    FrankaCabinetConfig,
    FrankaCabinetEnv,
    franka_cabinet_config,
)
from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv
from handarm_tpu_torch.envs.industreal import IndustRealConfig, IndustRealEnv, industreal_config
from handarm_tpu_torch.envs.ingenuity import IngenuityConfig, IngenuityEnv
from handarm_tpu_torch.envs.locomotion import (
    LocomotionConfig,
    LocomotionEnv,
    ant_config,
    humanoid_config,
)
from handarm_tpu_torch.envs.quadcopter import QuadcopterConfig, QuadcopterEnv
from handarm_tpu_torch.envs.randomization import DRConfig, NoiseSpec
from handarm_tpu_torch.envs.tasks import TASKS
from handarm_tpu_torch.envs.trifinger import TrifingerConfig, TrifingerEnv, trifinger_config
from handarm_tpu_torch.utils.config import _parse_value, get, load_config

CONFIG_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")

# top-level keys that mark a full layered hand-arm config (read by env_from_yaml)
_FULL_CONFIG_KEYS = {"rl", "sim", "objects", "pointclouds", "cameras",
                     "domain_randomization", "adr", "workspace"}
_KNOWN_YAML_KEYS = {
    "robot", "env", "sim", "rl", "objects", "pointclouds", "ppo",
    "table_height", "name", "defaults", "debug", "logging", "ros", "asset",
    "task", "seed", "experiment", "workspace",
}


# classic tasks: name -> (factory(num_envs, episode_length, **fields) -> the
# env's config dataclass, default PPO overrides)
CLASSIC_TASKS: dict = {}
# the env class of each classic config
CLASSIC_ENVS = {QuadcopterConfig: QuadcopterEnv, IngenuityConfig: IngenuityEnv,
                ClassicConfig: CartpoleEnv, LocomotionConfig: LocomotionEnv,
                BallBalanceConfig: BallBalanceEnv, AnymalConfig: AnymalEnv,
                AnymalTerrainConfig: AnymalTerrainEnv,
                FrankaCubeStackConfig: FrankaCubeStackEnv, FrankaCabinetConfig: FrankaCabinetEnv,
                TrifingerConfig: TrifingerEnv, DexHandConfig: AllegroHandEnv,
                ShadowHandConfig: ShadowHandEnv, DextremeConfig: AllegroHandDextremeEnv,
                AllegroKukaConfig: AllegroKukaEnv,
                AllegroKukaTwoArmsConfig: AllegroKukaTwoArmsEnv,
                FactoryConfig: FactoryNutBoltEnv, IndustRealConfig: IndustRealEnv}
# the JAX package's classic tasks the port does not have yet
UNPORTED_CLASSIC = ("HumanoidAMP", "IndustRealTaskGearsInsert")


def register_classic(name: str, factory, ppo_overrides: dict | None = None):
    CLASSIC_TASKS[name] = (factory, ppo_overrides or {})


def _ingenuity_config(num_envs, episode_length, **kw) -> IngenuityConfig:
    # the registry's default 500 steps becomes Ingenuity's own 2000
    return IngenuityConfig(num_envs=num_envs,
                           episode_length=episode_length if episode_length != 500 else 2000,
                           **kw)


# reference cfg/train/QuadcopterPPO.yaml / IngenuityPPO.yaml: [256,256,128]
_CRAFT_PPO = dict(hidden=(256, 256, 128), horizon=16, minibatch_size=16384, gamma=0.99,
                  kl_threshold=0.016, reward_scale=0.1)
register_classic("Quadcopter", lambda num_envs, episode_length, **kw: QuadcopterConfig(
    num_envs=num_envs, episode_length=episode_length, **kw), dict(_CRAFT_PPO))
register_classic("Ingenuity", _ingenuity_config, dict(_CRAFT_PPO))
register_classic("Cartpole", cartpole_config,
                 dict(hidden=(64, 64), reward_scale=1.0, minibatch_size=2048))
# reference cfg/train/AntPPO.yaml: units [256,128,64], gamma 0.99, tau 0.95,
# lr 3e-4 adaptive kl 0.008, horizon 16, minibatch 32768; HumanoidPPO.yaml:
# units [400,200,100], horizon 32, minibatch 32768
register_classic("Ant", ant_config,
                 dict(hidden=(256, 128, 64), horizon=16, minibatch_size=32768, gamma=0.99,
                      kl_threshold=0.008, reward_scale=0.01))
register_classic("Humanoid", humanoid_config,
                 dict(hidden=(400, 200, 100), horizon=32, minibatch_size=32768, gamma=0.99,
                      kl_threshold=0.008, reward_scale=0.01))


# reference cfg/train/BallBalancePPO.yaml: units [128,64,32], horizon 16,
# minibatch 8192; AnymalPPO.yaml: [256,128,64], horizon 24, minibatch 32768;
# AnymalTerrainPPO.yaml: [512,256,128], horizon 24, minibatch 16384
register_classic("BallBalance", ball_balance_config,
                 dict(hidden=(128, 64, 32), horizon=16, minibatch_size=8192, gamma=0.99,
                      kl_threshold=0.008, reward_scale=0.1))


def _episode_rule(make, length: int):
    """A factory whose registry default of 500 steps becomes `length`."""
    return lambda num_envs, episode_length, **kw: make(
        num_envs, episode_length=episode_length if episode_length != 500 else length, **kw)


register_classic("Anymal", _episode_rule(anymal_config, 1000),
                 dict(hidden=(256, 128, 64), horizon=24, minibatch_size=32768, gamma=0.99,
                      kl_threshold=0.008, reward_scale=1.0))
register_classic("AnymalTerrain", _episode_rule(anymal_terrain_config, 1000),
                 dict(hidden=(512, 256, 128), horizon=24, minibatch_size=16384, gamma=0.99,
                      kl_threshold=0.008, reward_scale=1.0))


# reference cfg/train/FrankaCubeStackPPO.yaml: units [256,128,64], horizon 32,
# minibatch 16384; FrankaCabinetPPO.yaml: [256,128,64], horizon 16,
# minibatch 8192, reward shaper 0.01
register_classic("FrankaCubeStack", _episode_rule(franka_cube_stack_config, 300),
                 dict(hidden=(256, 128, 64), horizon=32, minibatch_size=16384, gamma=0.99,
                      kl_threshold=0.008, reward_scale=0.1))
register_classic("FrankaCabinet", franka_cabinet_config,
                 dict(hidden=(256, 128, 64), horizon=16, minibatch_size=8192, gamma=0.99,
                      kl_threshold=0.008, reward_scale=0.01))


# reference cfg/train/TrifingerPPO.yaml: units [256,256,128,128], horizon 8;
# AllegroHandPPO.yaml: [512,256,128], horizon 8, minibatch 32768, adaptive kl
# 0.016, reward shaper 0.01; ShadowHandPPO.yaml: [512,512,256,128];
# ShadowHandOpenAI_FFPPO.yaml [400,400,200,100] and ShadowHandOpenAI_LSTMPPO
# lstm 1024 + mlp [512], both on the 42-dim actor observation with the
# 211-dim state as the critic's
register_classic("Trifinger", _episode_rule(trifinger_config, 750),
                 dict(hidden=(256, 256, 128, 128), horizon=8, minibatch_size=16384, gamma=0.99,
                      kl_threshold=0.016, reward_scale=0.01))
register_classic("AllegroHand", _episode_rule(allegro_config, 600),
                 dict(hidden=(512, 256, 128), horizon=8, minibatch_size=32768, gamma=0.99,
                      kl_threshold=0.016, reward_scale=0.01))
register_classic("ShadowHand", _episode_rule(shadow_config, 600),
                 dict(hidden=(512, 512, 256, 128), horizon=8, minibatch_size=32768, gamma=0.99,
                      kl_threshold=0.016, reward_scale=0.01))


_shadow_openai_config = _episode_rule(
    lambda num_envs, **kw: shadow_config(num_envs, obs_type="openai", **kw), 600)
register_classic("ShadowHandOpenAI_FF", _shadow_openai_config,
                 dict(hidden=(400, 400, 200, 100), horizon=16, minibatch_size=32768,
                      gamma=0.998, kl_threshold=0.016, reward_scale=0.01,
                      asymmetric_critic=True))
register_classic("ShadowHandOpenAI_LSTM", _shadow_openai_config,
                 dict(hidden=(512,), horizon=16, minibatch_size=32768, gamma=0.998,
                      kl_threshold=0.016, reward_scale=0.01, asymmetric_critic=True,
                      rnn_units=1024, critic_rnn_units=1024, seq_len=4))


# reference cfg/train/AllegroHandDextremeADRPPO.yaml: an LSTM before the MLP
# ([512, 512], seq_len 16), its carry kept across episode ends; the JAX
# registry's 512 units (the reference's 1024: `ppo.rnn_units=1024`).
# AllegroHandADR and AllegroHandManualDR are the reference's task-map names
_DEXTREME_PPO = dict(hidden=(512, 512), horizon=16, minibatch_size=16384, gamma=0.998,
                     kl_threshold=0.016, reward_scale=0.01, rnn_units=512, seq_len=16,
                     zero_rnn_on_done=False)
register_classic("AllegroHandDextremeADR", _episode_rule(dextreme_config, 600),
                 dict(_DEXTREME_PPO))
register_classic("AllegroHandADR", _episode_rule(dextreme_config, 600), dict(_DEXTREME_PPO))
register_classic("AllegroHandManualDR", _episode_rule(dextreme_manual_config, 600),
                 dict(_DEXTREME_PPO))


# reference cfg/train/AllegroKukaPPO.yaml (DexPBT's MLP): [768, 512, 256],
# horizon 16, minibatch 32768
_KUKA_PPO = dict(hidden=(768, 512, 256), horizon=16, minibatch_size=32768, gamma=0.99,
                 kl_threshold=0.016, reward_scale=0.01)


def _allegro_kuka_factory(variant: str):
    return _episode_rule(lambda num_envs, **kw: allegro_kuka_config(num_envs, variant, **kw),
                         600)


for _variant, _name in (("reorientation", "AllegroKukaReorientation"),
                        ("regrasping", "AllegroKukaRegrasping"), ("throw", "AllegroKukaThrow")):
    register_classic(_name, _allegro_kuka_factory(_variant), dict(_KUKA_PPO))


def _allegro_kuka_resolver(num_envs, episode_length, subtask="reorientation"):
    """The reference's task-map name `AllegroKuka`: `env.subtask` picks the
    variant."""
    return _allegro_kuka_factory(subtask)(num_envs, episode_length)


register_classic("AllegroKuka", _allegro_kuka_resolver, dict(_KUKA_PPO))


# the two-arm tasks: the same PPO (the JAX registry's overrides, the train
# yamls' ppo blocks), reorientation and regrasping by name
def _allegro_kuka_two_arms_factory(variant: str):
    return _episode_rule(
        lambda num_envs, **kw: allegro_kuka_two_arms_config(num_envs, variant, **kw), 600)


for _variant, _name in (("reorientation", "AllegroKukaTwoArmsReorientation"),
                        ("regrasping", "AllegroKukaTwoArmsRegrasping")):
    register_classic(_name, _allegro_kuka_two_arms_factory(_variant), dict(_KUKA_PPO))


def _allegro_kuka_two_arms_resolver(num_envs, episode_length, subtask="reorientation"):
    """The reference's task-map name `AllegroKukaTwoArms`: `env.subtask`
    picks the variant (any of the env's, as the JAX package's resolver)."""
    return _allegro_kuka_two_arms_factory(subtask)(num_envs, episode_length)


register_classic("AllegroKukaTwoArms", _allegro_kuka_two_arms_resolver, dict(_KUKA_PPO))


def _keep_two_keys(make, task: str, length: int):
    """A factory that keeps `num_envs` and `episode_length` (the registry's
    500 -> `length`) and drops every other env key, as the JAX package's
    Factory and IndustReal factories do."""
    return lambda num_envs, episode_length, **kw: make(
        num_envs, episode_length if episode_length != 500 else length, task)


# reference cfg/train/FactoryTaskNutBolt*PPO.yaml: units [256,128,64],
# horizon 32; IndustRealTask*PPO.yaml: the same MLP with an asymmetric
# central-value critic on the 47-dim privileged state
# (IndustRealTaskPegsInsertPPO.yaml:81-100)
for _task, _name in (("pick", "FactoryTaskNutBoltPick"), ("place", "FactoryTaskNutBoltPlace"),
                     ("screw", "FactoryTaskNutBoltScrew"), ("gears", "FactoryTaskGears"),
                     ("insertion", "FactoryTaskInsertion")):
    register_classic(_name, _keep_two_keys(factory_config, _task, 100),
                     dict(hidden=(256, 128, 64), horizon=32, minibatch_size=8192, gamma=0.99,
                          kl_threshold=0.016, reward_scale=1.0))
register_classic("IndustRealTaskPegsInsert", _keep_two_keys(industreal_config, "pegs", 128),
                 dict(hidden=(256, 128, 64), horizon=32, minibatch_size=8192, gamma=0.998,
                      kl_threshold=0.016, reward_scale=0.01, asymmetric_critic=True))


def _refuse_unported(name: str) -> None:
    if name in UNPORTED_CLASSIC:
        raise NotImplementedError(f"the classic task {name!r} is not ported yet (ROADMAP "
                                  f"§1.7); ported: {sorted(CLASSIC_TASKS)}")


def classic_config(name: str, overrides: list[str] | None = None) -> tuple[object, dict]:
    """(the env's config dataclass, PPO overrides) of a classic task with
    `key=value` overrides (the JAX package's `make_env` classic branch)."""
    factory, ppo_overrides = CLASSIC_TASKS[name]
    ppo_updates = dict(ppo_overrides)
    kv = {}
    for ov in overrides or []:
        key, val = ov.split("=", 1)
        key = key.removeprefix("env.")
        if key.startswith("ppo."):
            ppo_updates[key[4:]] = _parse_value(val)
        else:
            kv[key] = val
    num_envs = int(_parse_value(kv.pop("num_envs", 512)))
    episode_length = int(_parse_value(kv.pop("episode_length", 500)))
    kwargs = {}
    subtask = kv.pop("subtask", None)
    if subtask is not None and "subtask" in inspect.signature(factory).parameters:
        kwargs["subtask"] = subtask
    for k, v in kv.items():  # the env config's other fields; unknown ones raise TypeError
        pv = _parse_value(v)
        if isinstance(pv, list):
            pv = tuple(tuple(x) if isinstance(x, list) else x for x in pv)
        kwargs[k] = pv
    return factory(num_envs, episode_length, **kwargs), ppo_updates


def build_env(cfg, device=None, group=None):
    """The env of a config: a HandArmEnv, or a classic task's env."""
    if isinstance(cfg, HandArmConfig):
        return HandArmEnv(cfg, device, group=group)
    return CLASSIC_ENVS[type(cfg)](cfg, device, group=group)


def all_task_names() -> list[str]:
    return sorted(TASKS) + sorted(CLASSIC_TASKS)


def make_config(name: str, overrides: list[str] | None = None) -> tuple[HandArmConfig, dict]:
    """(config, PPO overrides) of a preset, or of a classic task, with
    `key=value` overrides."""
    if name in CLASSIC_TASKS:
        return classic_config(name, overrides)
    _refuse_unported(name)
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}; known: {all_task_names()}")
    cfg, ppo_overrides = TASKS[name]
    fields = {f.name for f in dataclasses.fields(cfg)}
    updates = {}
    ppo_updates = dict(ppo_overrides)
    for ov in overrides or []:
        key, val = ov.split("=", 1)
        key = key.removeprefix("env.")
        if key.startswith("ppo."):
            ppo_updates[key[4:]] = _parse_value(val)
        elif key in fields:
            v = _parse_value(val)
            if isinstance(getattr(cfg, key), tuple) and isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            updates[key] = v
        else:
            raise KeyError(f"unknown config key {key!r}")
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    return cfg, ppo_updates


def make_env(name: str, overrides: list[str] | None = None, device=None):
    """(env, PPO overrides) of a preset or a classic task with `key=value`
    overrides."""
    cfg, ppo = make_config(name, overrides)
    return build_env(cfg, device), ppo


def config_from_yaml(path: str, overrides: list[str] | None = None
                     ) -> tuple[HandArmConfig, dict]:
    """(config, PPO overrides) of a layered task yaml. Observation and
    action spaces are the yaml's name lists; `asset.dof_properties` and
    `sim.gravity_mag` are read and not used, as in the JAX package."""
    cfg = load_config(path, overrides)
    env_block = cfg.get("env", {})
    obs = tuple(
        env_block.get("proprioceptive_observations", [])
        + env_block.get("object_observations", [])
        + env_block.get("task_observations", [])
        + env_block.get("observations", [])
    )
    dataset = tuple(
        (name, tuple(pats))
        for name, pats in get(cfg, "objects.dataset", {}).items()
        if pats
    )
    rand_params = get(cfg, "rl.randomization_params.object_disturbance", {})
    hc = HandArmConfig(
        robot=cfg.get("robot", "ur5sih"),
        # both spellings; the snake-case one (a CLI override) wins
        num_envs=int(env_block.get("num_envs", env_block.get("numEnvs", 1024))),
        episode_length=int(get(cfg, "rl.reset.max_episode_length", 200)),
        control_freq_inv=int(env_block.get("controlFrequencyInv", 3)),
        dt=float(get(cfg, "sim.dt", 1.0 / 60.0)),
        substeps=int(get(cfg, "sim.num_substeps", 2)),
        solver_iterations=int(get(cfg, "sim.solver_iterations", 16)),
        observations=obs or HandArmConfig.observations,
        actions=tuple(env_block.get("actions", HandArmConfig.actions)),
        teacher_observations=tuple(env_block.get("teacher_observations", [])),
        goal=get(cfg, "rl.goal", "lift"),
        goal_threshold=float(get(cfg, "rl.goal_threshold", 0.05)),
        lifting_threshold=float(get(cfg, "rl.lifting_threshold", 0.05)),
        reward=dict(get(cfg, "rl.reward", {"reaching": 1.0})),
        object_dataset=dataset,
        num_objects=int(get(cfg, "objects.num_objects", 0)),
        table_height=float(cfg.get("table_height", 0.5)),
        drop_pos=tuple(get(cfg, "objects.drop.pos", (0.28, 0.58, 1.5))),
        drop_noise=tuple(get(cfg, "objects.drop.noise", (0.1, 0.1, 0.0))),
        goal_pos=tuple(get(cfg, "objects.goal.pos", (0.28, 0.58, 0.8))),
        goal_noise=tuple(get(cfg, "objects.goal.noise", (0.15, 0.15, 0.1))),
        drop_num_steps=int(get(cfg, "objects.drop.num_steps", 100)),
        num_initial_poses=int(get(cfg, "objects.drop.num_initial_poses", 1)),
        use_drop_init=bool(dataset),
        randomize=bool(get(cfg, "rl.randomize", False)),
        balanced_target_sampling=bool(get(cfg, "rl.balanced_target_sampling", False)),
        disturbance_probability=float(rand_params.get("probability", 0.0)),
        disturbance_magnitude=float(rand_params.get("magnitude", 0.0)),
        dr=_dr_from_yaml(get(cfg, "rl.randomization_params.dr", {})),
        adr=_adr_from_yaml(get(cfg, "rl.randomization_params.adr", {})),
        pointcloud_average_points=int(get(cfg, "pointclouds.average_num_points", 100)),
        pointcloud_max_points=int(get(cfg, "pointclouds.max_num_points", 128)),
        use_bin=bool(get(cfg, "objects.bin.enabled", False)),
        bin_half_extent=float(get(cfg, "objects.bin.half_extent", 0.15)),
        bin_wall_height=float(get(cfg, "objects.bin.wall_height", 0.10)),
        # a top-level `workspace: [[lo], [hi]]` pair, or env.workspace.lo/hi
        workspace_lo=tuple(get(cfg, "env.workspace.lo",
                               cfg.get("workspace", [HandArmConfig.workspace_lo])[0])),
        workspace_hi=tuple(get(cfg, "env.workspace.hi",
                               cfg.get("workspace", [None, HandArmConfig.workspace_hi])[-1])),
        cameras=_cameras_from_yaml(env_block.get("cameras", {})),
    )
    _warn_unknown_yaml_keys(cfg)
    ppo_overrides = dict(cfg.get("ppo", {}))
    if "hidden" in ppo_overrides:
        ppo_overrides["hidden"] = tuple(ppo_overrides["hidden"])
    return hc, ppo_overrides


def env_from_yaml(path: str, overrides: list[str] | None = None, device=None):
    """(env, PPO overrides) of a layered task yaml (`config_from_yaml`)."""
    cfg, ppo = config_from_yaml(path, overrides)
    return HandArmEnv(cfg, device), ppo


def _cameras_from_yaml(block: dict) -> tuple:
    """`env.cameras`: {name: {pos: [...], quat: [...], width: .., height:
    ..}} -> CameraConfigs. A `fov_x` key is passed on as the JAX package
    passes it, so it raises TypeError (the field is `fovx_deg`)."""
    cams = []
    for name, c in (block or {}).items():
        kw = {"name": name}
        for k in ("pos", "quat"):
            if k in c:
                kw[k] = tuple(c[k])
        for k in ("width", "height", "fov_x"):
            if k in c:
                kw[k] = c[k]
        cams.append(CameraConfig(**kw))
    return tuple(cams)


def _dr_from_yaml(block: dict) -> DRConfig:
    """`rl.randomization_params.dr`: enabled unless it says otherwise when
    not empty. Every key of a noise block is read as a float, as in the JAX
    package, so `dist: uniform` there raises ValueError."""
    if not block:
        return DRConfig()

    def noise(b):
        return NoiseSpec(**{k: float(v) for k, v in (b or {}).items()})

    return DRConfig(
        enabled=bool(block.get("enabled", True)),
        observation_noise=noise(block.get("observation_noise")),
        action_noise=noise(block.get("action_noise")),
        mass_scale_range=tuple(block.get("mass_scale_range", (1.0, 1.0))),
        friction_scale_range=tuple(block.get("friction_scale_range", (1.0, 1.0))),
        gain_scale_range=tuple(block.get("gain_scale_range", (1.0, 1.0))),
        gravity_noise=float(block.get("gravity_noise", 0.0)),
        schedule_steps=int(block.get("schedule_steps", 0)),
    )


def _adr_from_yaml(block: dict) -> AdrConfig:
    """`rl.randomization_params.adr`: AdrConfig fields (lists become tuples),
    enabled unless it says otherwise when not empty."""
    if not block:
        return AdrConfig()
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in block.items()}
    kw.setdefault("enabled", True)
    return AdrConfig(**kw)


def _warn_unknown_yaml_keys(cfg: dict) -> None:
    """Unknown top-level keys are a config typo: they raise."""
    unknown = set(cfg) - _KNOWN_YAML_KEYS
    if unknown:
        raise ValueError(
            f"unknown task-yaml top-level keys {sorted(unknown)}; "
            f"known: {sorted(_KNOWN_YAML_KEYS)}"
        )


def resolve_task(name: str, overrides: list[str] | None = None
                 ) -> tuple[HandArmConfig, dict]:
    """(config, PPO overrides) of a task by its yaml config group, else its
    preset; `name` may also be a yaml path. See the module docstring."""
    overrides = list(overrides or [])
    if name.endswith(".yaml"):
        return config_from_yaml(name, overrides)
    _refuse_unported(name)
    tpath = os.path.join(CONFIG_ROOT, "task", f"{name}.yaml")
    trpath = os.path.join(CONFIG_ROOT, "train", f"{name}PPO.yaml")
    train_over: list[str] = []
    if os.path.exists(trpath):
        for k, v in (load_config(trpath).get("ppo") or {}).items():
            train_over.append(f"ppo.{k}={json.dumps(v)}")
    yaml_over: list[str] = []
    if os.path.exists(tpath):
        tcfg = load_config(tpath)
        if _FULL_CONFIG_KEYS & set(tcfg):
            return config_from_yaml(tpath, train_over + overrides)
        for k, v in (tcfg.get("env") or {}).items():
            yaml_over.append(f"{k}={json.dumps(v)}")
    return make_config(name, yaml_over + train_over + overrides)


def compose_task(name: str, overrides: list[str] | None = None, device=None):
    """(env, PPO overrides) of `resolve_task`."""
    cfg, ppo = resolve_task(name, overrides)
    return build_env(cfg, device), ppo
