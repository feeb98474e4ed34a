"""The port's yaml config surface against the JAX package's: `load_config`
on every UR5+SIH and Stretch task and train yaml, and `compose_task` on
every UR5+SIH and Stretch task with and without overrides, down to each HandArmConfig field and the
PPO overrides; the error cases fail on both sides; the features the port
has not ported are refused by name.

The JAX package's `utils/config.py` is loaded by file path (it imports no
JAX). Its `compose_task` builds a HandArmEnv; here the JAX registry's
HandArmEnv is replaced by the identity, so it returns the HandArmConfig it
would build from, and no asset is needed.
"""

import dataclasses
import glob
import importlib.util
import os
from types import SimpleNamespace

import pytest

from handarm_tpu_torch.envs import registry as treg
from handarm_tpu_torch.envs.adr import AdrConfig
from handarm_tpu_torch.envs.camera import CameraConfig
from handarm_tpu_torch.envs.hand_arm import HandArmConfig
from handarm_tpu_torch.envs.randomization import DRConfig, NoiseSpec
from handarm_tpu_torch.envs.tasks import DR_SHADOWHAND
from handarm_tpu_torch.learn.ppo import PPOConfig, ppo_config
from handarm_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "task", "Ur5Sih*.yaml"))
               + glob.glob(os.path.join(REPO, "configs", "train", "Ur5Sih*PPO.yaml"))
               + glob.glob(os.path.join(REPO, "configs", "task", "Stretch*.yaml"))
               + glob.glob(os.path.join(REPO, "configs", "train", "Stretch*PPO.yaml")))
FULL = "Ur5SihMultiObjectManipulation"
PRESET_TASKS = ("Ur5SihLift", "Ur5SihReposition", "Ur5SihOrientedReposition",
                "Ur5SihRepose", "Ur5SihThrow", "Ur5SihReach",
                "StretchLift", "StretchMultiObjectManipulation")
OVERRIDES = {
    # the documented CLI forms: a full-config yaml takes dotted yaml keys,
    # a preset-backed one HandArmConfig fields (with or without `env.`)
    "none": ([], []),
    "cli": (["env.num_envs=8", "rl.goal=throw", "ppo.minibatch_size=64"],
            ["env.num_envs=8", "goal=throw", "ppo.minibatch_size=64"]),
}
ERRORS = {
    # a bare field on a full-config yaml is an unknown top-level key
    "bare num_envs on the full config": (FULL, ["num_envs=8"], ValueError),
    "rl key on a preset yaml": ("Ur5SihLift", ["rl.goal=throw"], KeyError),
    "unknown field": ("Ur5SihReach", ["env.num_env=8"], KeyError),
    "unknown task": ("Ur5SihJuggle", [], KeyError),
    # every key of a DR noise block is read as a float
    "uniform noise dist": (FULL, ["rl.randomization_params.dr.observation_noise.dist=uniform"],
                           ValueError),
}


def _jax_config_module():
    spec = importlib.util.spec_from_file_location(
        "jax_package_config", os.path.join(REPO, "handarm_tpu", "utils", "config.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_compose(monkeypatch):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import handarm_tpu.envs.registry as jreg

    monkeypatch.setattr(jreg, "HandArmEnv", lambda cfg: cfg)
    return jreg.compose_task


def _fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for k in ("dr", "adr"):
        out[k] = dataclasses.asdict(out[k])
    out["cameras"] = tuple(dataclasses.asdict(c) for c in out["cameras"])  # either package's
    return out


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, REPO))
def test_load_config_matches(path):
    """The same dict, `inherits:` resolved, with and without overrides."""
    jcfg = _jax_config_module()
    over = ["env.num_envs=8", "ppo.hidden=[64, 32]", "rl.reward.goal=7.5"]
    for ov in (None, over):
        want = jcfg.load_config(path, ov)
        got = tconfig.load_config(path, ov)
        assert got == want
        assert tconfig.get(got, "env.num_envs") == jcfg.get(want, "env.num_envs")


@pytest.mark.parametrize("case", sorted(OVERRIDES))
@pytest.mark.parametrize("task", PRESET_TASKS + (FULL,))
def test_compose_task_matches(task, case, jax_compose):
    """Every HandArmConfig field the two packages share is equal, value and
    type (a list is not a tuple), and so are the PPO overrides."""
    over = OVERRIDES[case][0 if task == FULL else 1]
    jcfg, jppo = jax_compose(task, over)
    tcfg, tppo = treg.resolve_task(task, over)
    want, got = _fields(jcfg), _fields(tcfg)
    shared = sorted(want.keys() & got.keys())
    assert set(got) - set(want) == {"settle_num_steps"}  # the port's own
    assert set(want) - set(got) == set()
    for k in shared:
        assert type(got[k]) is type(want[k]) and got[k] == want[k], (k, got[k], want[k])
    assert tppo == jppo
    if case == "cli":
        assert tcfg.num_envs == 8 and tcfg.goal == "throw" and tppo["minibatch_size"] == 64


def test_multiobject_composes_to_the_train_yaml(jax_compose):
    """Ur5SihMultiObjectManipulation resolves to 16 solver sweeps (its base
    yaml), 8192 envs, the yaml's dt, and minibatch 32768 with every switch
    of its train yaml, in both packages; the code preset stays at 8 sweeps
    and minibatch 8192, as the JAX registry's."""
    from handarm_tpu_torch.envs.tasks import TASKS

    jcfg, jppo = jax_compose(FULL)
    tcfg, tppo = treg.resolve_task(FULL)
    for cfg, ppo in ((jcfg, jppo), (tcfg, tppo)):
        assert (cfg.solver_iterations, cfg.num_envs, cfg.dt) == (16, 8192, 0.016666667)
        assert ppo["minibatch_size"] == 32768 and ppo["hidden"] == (768, 512, 256)
    cfg = ppo_config(tppo)
    assert (cfg.minibatch_size, cfg.mini_epochs, cfg.horizon, cfg.lr_schedule) == \
        (32768, 4, 16, "adaptive")
    assert cfg.normalize_input and cfg.normalize_value and cfg.normalize_advantage
    assert cfg.value_bootstrap and cfg.clip_value and cfg.critic_coef == 4
    preset, preset_ppo = TASKS[FULL]
    assert preset.solver_iterations == 8 and preset_ppo == {"minibatch_size": 8192}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_compose_errors_match(case, jax_compose):
    """The error cases raise the same exception type on both sides."""
    task, over, exc = ERRORS[case]
    with pytest.raises(exc):
        jax_compose(task, over)
    with pytest.raises(exc):
        treg.resolve_task(task, over)


REFUSED = {
    # a PPOConfig field whose value the batch cannot take: refused when the
    # learner is built (8192 envs do not split into 3 shards)
    "data_shards": (FULL, ["ppo.data_shards=3"], "data_shards"),
}


# refused until the point clouds and teacher observations, the recurrent
# and asymmetric learner, domain randomization and ADR, the engine's
# cadences and the arm's collision spheres, the Stretch, the cameras and
# the data-parallel layout were ported; each now composes as the JAX
# package composes it
RETIRED = {
    "data_shards": (FULL, ["ppo.data_shards=2"], "data_shards", 2),
    "cameras": (FULL, ["env.cameras.top.width=64"], "cameras",
                (CameraConfig(name="top", width=64),)),
    "robot": (FULL, ["robot=stretch"], "robot", "stretch"),
    "engine option": ("Ur5SihLift", ["carry_fk=false"], "carry_fk", False),
    "collision set": ("Ur5SihLift", ["hand_only_collision=false"], "hand_only_collision",
                      False),
    "heavy prep cadence": ("Ur5SihLift", ["heavy_prep_per_control=false", "carry_fk=false",
                                          "hand_only_collision=false"],
                           "heavy_prep_per_control", False),
    "teacher observations": ("Ur5SihLift", ["teacher_observations=[dof_pos]"],
                             "teacher_observations", ("dof_pos",)),
    "point clouds": ("Ur5SihLift", ["observations=[object_synthetic_pointcloud]"],
                     "observations", ("object_synthetic_pointcloud",)),
    "point count": (FULL, ["pointclouds.max_num_points=64"], "pointcloud_max_points", 64),
    # PPOConfig fields, refused until the recurrent and asymmetric learner
    "recurrent policy": ("Ur5SihLift", ["ppo.rnn_units=256", "ppo.seq_len=8",
                                        "ppo.zero_rnn_on_done=false"], "rnn_units", 256),
    "asymmetric critic": ("Ur5SihLift", ["teacher_observations=[dof_pos]",
                                         "ppo.asymmetric_critic=true",
                                         "ppo.critic_rnn_units=512"], "asymmetric_critic", True),
    "domain randomization": (FULL, ["rl.randomization_params.dr.enabled=true"], "dr",
                             DRConfig(enabled=True)),
    "adaptive randomization": (FULL, ["rl.randomization_params.adr.enabled=true"], "adr",
                               AdrConfig(enabled=True)),
    # IsaacGymEnvs' ShadowHand randomization with ADR over it
    "ShadowHand DR with ADR": (FULL, DR_SHADOWHAND + ["rl.randomization_params.adr.enabled=true"],
                               "dr", DRConfig(
                                   enabled=True,
                                   observation_noise=NoiseSpec(amount=0.002, correlated=0.001),
                                   action_noise=NoiseSpec(amount=0.05, correlated=0.015),
                                   mass_scale_range=(0.5, 1.5), friction_scale_range=(0.7, 1.3),
                                   gain_scale_range=(0.75, 1.5), gravity_noise=0.4)),
}


@pytest.mark.parametrize("case", sorted(RETIRED))
def test_retired_refusals_compose_equal(case, jax_compose):
    """A feature once refused composes: every HandArmConfig field equal to
    the JAX package's, value and type, the PPO overrides equal, and the
    feature's field (of the HandArmConfig, or of the PPOConfig the
    overrides build) as asked."""
    task, over, name, value = RETIRED[case]
    jcfg, jppo = jax_compose(task, over)
    tcfg, tppo = treg.resolve_task(task, over)
    want, got = _fields(jcfg), _fields(tcfg)
    for k in want:
        assert type(got[k]) is type(want[k]) and got[k] == want[k], (k, got[k], want[k])
    owner = tcfg if name in got else ppo_config(tppo)
    assert getattr(owner, name) == value and tppo == jppo
    if name == "dr" and "adr" in case:  # ADR on, at its defaults (DeXtreme's)
        assert tcfg.adr == AdrConfig(enabled=True) and tcfg.adr.queue_len == 256


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_features_refused(case):
    """A value the port cannot take raises naming its field when the learner
    is built, never silently ignored: a data_shards that does not divide the
    composed task's envs (the JAX package asserts the same in its update)."""
    from handarm_tpu_torch.learn.ppo import PPO

    task, over, name = REFUSED[case]
    env_cfg, ppo_over = treg.resolve_task(task, over)
    env = SimpleNamespace(num_obs=8, num_actions=3, cfg=env_cfg)
    with pytest.raises(ValueError, match=name):
        PPO(env, ppo_config(ppo_over), device="cpu")


def test_ppo_config_refuses_unported_fields():
    """data_shards 2 and 4 build (the layout is ported); an unknown field
    raises KeyError; hidden becomes a tuple."""
    assert ppo_config({"data_shards": 2}) == PPOConfig(data_shards=2)
    assert ppo_config({"data_shards": 4}).data_shards == 4
    with pytest.raises(KeyError):
        ppo_config({"rnn_unit": 256})
    cfg = ppo_config({"data_shards": 1, "asymmetric_critic": False, "hidden": [64, 32]})
    assert cfg == PPOConfig(hidden=(64, 32))
    with pytest.raises(ValueError, match="goal"):
        HandArmConfig(goal="juggle")
