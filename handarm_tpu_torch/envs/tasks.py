"""Task presets over HandArmEnv (counterpart of the Ur5SihLift and
Ur5SihMultiObjectManipulation entries of handarm_tpu/envs/registry.py)."""

from __future__ import annotations

import dataclasses

from handarm_tpu_torch.envs.hand_arm import HandArmConfig, HandArmEnv

TASKS: dict[str, HandArmConfig] = {
    # one 6 cm box grasped out of a walled bin
    "Ur5SihLift": HandArmConfig(
        objects=(("box", (0.03, 0.03, 0.03), 0.15),), use_bin=True,
    ),
    # three YCB meshes on the open table, reposition goal, drop-init pool,
    # object disturbances
    "Ur5SihMultiObjectManipulation": HandArmConfig(
        goal="reposition",
        object_dataset=(
            ("ycb", ("015_peach", "005_tomato_soup_can", "006_mustard_bottle")),
        ),
        num_objects=3, use_drop_init=True, num_initial_poses=1, randomize=True,
    ),
}


def make_env(name: str, device=None, urdf_path: str | None = None,
             **overrides) -> HandArmEnv:
    """Build a registered task; keyword overrides replace config fields."""
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r} (ported: {sorted(TASKS)})")
    return HandArmEnv(dataclasses.replace(TASKS[name], **overrides), device, urdf_path)
