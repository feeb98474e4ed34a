"""Task presets over HandArmEnv, each with its PPO overrides (counterpart of
the UR5+SIH and Stretch entries of the TASKS table of
handarm_tpu/envs/registry.py).

These are the code presets. The entry points compose a task through its
yaml config group instead (`envs/registry.py` `compose_task`), as the JAX
package's do; for Ur5SihMultiObjectManipulation the two differ (the yaml
gives 16 solver sweeps and minibatch 32768). `make_env` here is the
keyword form over the presets.
"""

from __future__ import annotations

import dataclasses

from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv

STRETCH_OBS = (
    "stretch_joint_pos", "stretch_flange_pose", "stretch_fingertip_pos",
    "stretch_fingertip_linvel", "dof_position_targets",
    "object_pos", "object_bounding_box", "target_object_bounding_box",
    "target_object_to_goal_pos",
)

TASKS: dict[str, tuple[HandArmConfig, dict]] = {
    # one 6 cm box grasped out of a walled bin
    "Ur5SihLift": (
        HandArmConfig(objects=(("box", (0.03, 0.03, 0.03), 0.15),), use_bin=True),
        dict(minibatch_size=8192),
    ),
    "Ur5SihReposition": (HandArmConfig(goal="reposition"), dict(minibatch_size=8192)),
    # reposition plus 0.1 x the flange's rotation distance to a goal quaternion
    "Ur5SihOrientedReposition": (
        HandArmConfig(goal="oriented_reposition",
                      observations=HandArmConfig.observations + ("goal_quat",)),
        dict(minibatch_size=8192),
    ),
    # in-hand reorientation: fingertip and keypoint observations
    "Ur5SihRepose": (
        HandArmConfig(
            goal="repose",
            observations=(
                "ur5_joint_pos", "ur5_flange_pose", "sih_fingertip_pos",
                "sih_fingertip_quat", "sih_fingertip_linvel",
                "dof_position_targets", "target_object_pos",
                "target_object_quat", "target_object_keypoints",
                "goal_quat", "goal_keypoints",
            ),
            reward={"reaching": 1.0, "goal": 50.0, "success": 50.0},
        ),
        dict(minibatch_size=8192),
    ),
    # throw goals lie 0.5 m further along y
    "Ur5SihThrow": (HandArmConfig(goal="throw", goal_pos=(0.28, 1.08, 0.8)),
                    dict(minibatch_size=8192)),
    # three YCB meshes on the open table, reposition goal, drop-init pool,
    # object disturbances
    "Ur5SihMultiObjectManipulation": (
        HandArmConfig(
            goal="reposition",
            object_dataset=(
                ("ycb", ("015_peach", "005_tomato_soup_can", "006_mustard_bottle")),
            ),
            num_objects=3, use_drop_init=True, num_initial_poses=1, randomize=True,
        ),
        dict(minibatch_size=8192),
    ),
    # the Stretch's two tasks (handarm_tpu/envs/registry.py:90-138): its
    # grouped action, 400-step episodes; a box and a sphere on the open
    # table, reposition goal
    "StretchMultiObjectManipulation": (
        HandArmConfig(
            robot="stretch", goal="reposition", episode_length=400,
            observations=STRETCH_OBS, actions=("stretch_relative_joint_pos",),
            objects=(("box", (0.03, 0.03, 0.03), 0.1), ("sphere", (0.03,), 0.08)),
        ),
        dict(minibatch_size=8192),
    ),
    # one 6 cm box lifted out of a walled bin by the Stretch's gripper
    "StretchLift": (
        HandArmConfig(
            robot="stretch", goal="lift", episode_length=400,
            observations=STRETCH_OBS, actions=("stretch_relative_joint_pos",),
            objects=(("box", (0.03, 0.03, 0.03), 0.15),), use_bin=True,
        ),
        dict(minibatch_size=8192),
    ),
    # the training smoke: bring the fingertips to the box, arm actions only
    "Ur5SihReach": (
        HandArmConfig(
            reward={"reaching": 1.0},
            observations=("ur5_joint_pos", "ur5_flange_pose", "sih_fingertip_pos",
                          "dof_position_targets", "target_object_pos"),
            actions=("ur5_relative_joint_pos",),
            num_envs=64,
        ),
        dict(minibatch_size=256, hidden=(256, 128, 64)),
    ),
}


# ShadowHandOpenAI_LSTM's learner (handarm_tpu/envs/registry.py:755-762:
# asymmetric critic, LSTM 1024 actor and critic, MLP [512], seq_len 4,
# gamma 0.998) on Ur5SihLift, as overrides of its composition
# (`registry.resolve_task`, `python -m handarm_tpu_torch.train`): the actor
# sees the distilled student's four non-cloud observables (33 values), the
# critic the Lift's eleven default observables (121); the Lift's horizon 16
# and 4 mini-epochs, minibatches of 32768 samples (8,192 sequences)
LSTM_LIFT = [
    "observations=[ur5_joint_pos,ur5_flange_pose,dof_position_targets,"
    "target_object_to_goal_pos]",
    f"teacher_observations=[{','.join(HandArmConfig.observations)}]",
    "ppo.asymmetric_critic=true", "ppo.rnn_units=1024", "ppo.critic_rnn_units=1024",
    "ppo.hidden=[512]", "ppo.seq_len=4", "ppo.minibatch_size=32768", "ppo.gamma=0.998",
]


# The domain randomization of IsaacGymEnvs' cfg/task/ShadowHand.yaml
# (task.randomization_params), as `rl.randomization_params.dr` overrides of
# Ur5SihMultiObjectManipulation's composition (`registry._dr_from_yaml`):
# observations and actions gaussian additive (range 0.002 and 0.05,
# range_correlated 0.001 and 0.015), gravity additive gaussian 0.4 (on z),
# rigid-body mass scaled uniformly in [0.5, 1.5], rigid-shape friction in
# [0.7, 1.3], dof stiffness (here kp and kd) in [0.75, 1.5]. Its schedule
# lines are commented out there: no schedule. Add
# `rl.randomization_params.adr.enabled=true` for ADR (AdrConfig's defaults,
# DeXtreme's adr_vec_task.py) over these noise channels.
DR_SHADOWHAND = [
    "rl.randomization_params.dr.observation_noise.amount=0.002",
    "rl.randomization_params.dr.observation_noise.correlated=0.001",
    "rl.randomization_params.dr.action_noise.amount=0.05",
    "rl.randomization_params.dr.action_noise.correlated=0.015",
    "rl.randomization_params.dr.gravity_noise=0.4",
    "rl.randomization_params.dr.mass_scale_range=[0.5,1.5]",
    "rl.randomization_params.dr.friction_scale_range=[0.7,1.3]",
    "rl.randomization_params.dr.gain_scale_range=[0.75,1.5]",
]


def _preset(name: str) -> tuple[HandArmConfig, dict]:
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r} (ported: {sorted(TASKS)})")
    return TASKS[name]


def make_env(name: str, device=None, urdf_path: str | None = None,
             **overrides) -> HandArmEnv:
    """Build a registered task; keyword overrides replace config fields."""
    return HandArmEnv(dataclasses.replace(_preset(name)[0], **overrides), device, urdf_path)


def ppo_overrides(name: str) -> dict:
    """The task's PPOConfig fields that differ from the defaults."""
    return dict(_preset(name)[1])
