"""Task presets over HandArmEnv, each with its PPO overrides (counterpart of
the Ur5SihLift, Ur5SihMultiObjectManipulation and Ur5SihReach entries of
handarm_tpu/envs/registry.py)."""

from __future__ import annotations

import dataclasses

from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv

TASKS: dict[str, tuple[HandArmConfig, dict]] = {
    # one 6 cm box grasped out of a walled bin
    "Ur5SihLift": (
        HandArmConfig(objects=(("box", (0.03, 0.03, 0.03), 0.15),), use_bin=True),
        dict(minibatch_size=8192),
    ),
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
