"""Tasks by name through the yaml config groups, as the JAX package's entry
points build them (counterpart of `make_env`, `env_from_yaml`,
`_warn_unknown_yaml_keys` and `compose_task` of handarm_tpu/envs/registry.py,
the UR5+SIH and Stretch tasks).

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

Each function has a `*_config` form that stops at the HandArmConfig and the
PPO overrides, without building the env.
"""

from __future__ import annotations

import dataclasses
import json
import os

from handarm_tpu_torch.envs.adr import AdrConfig
from handarm_tpu_torch.envs.camera import CameraConfig
from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv
from handarm_tpu_torch.envs.randomization import DRConfig, NoiseSpec
from handarm_tpu_torch.envs.tasks import TASKS
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


def make_config(name: str, overrides: list[str] | None = None) -> tuple[HandArmConfig, dict]:
    """(config, PPO overrides) of a preset with `key=value` overrides."""
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}; known: {sorted(TASKS)}")
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
    """(env, PPO overrides) of a preset with `key=value` overrides."""
    cfg, ppo = make_config(name, overrides)
    return HandArmEnv(cfg, device), ppo


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
    return HandArmEnv(cfg, device), ppo
