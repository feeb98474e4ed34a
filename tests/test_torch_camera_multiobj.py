"""The topview camera on Ur5SihMultiObjectManipulation against the JAX
package at B = 4: the three YCB records' baked albedo in
`scene_point_rgb`, and the five observables of a reset and 2 control steps
(tests/test_torch_camera_env.py's procedure and tolerances, with
tests/test_torch_multiobj.py's object root and record cache; a one-pose
pool from the JAX package's spawn poses, genesis off).
"""

import sys

import numpy as np
import pytest
import torch

from test_torch_camera_env import (TAGS, check_camera_observables, jax_reference, port_env,
                                   run_reference)

TASK = "Ur5SihMultiObjectManipulation"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    from test_torch_multiobj import _record_copies

    tmp = tmp_path_factory.mktemp("camera_multiobj")
    root, cache = _record_copies(tmp)
    return run_reference(tmp, __file__, dict(HANDARM_OBJECT_ROOT=str(root),
                                             HANDARM_SDF_CACHE=str(cache)), timeout=1200)


@pytest.fixture(scope="module")
def env(ref):
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.genesis import InitialPool

    base, env = port_env(TASK, randomize=False)
    env.initial_pool = InitialPool(torch.as_tensor(ref["pool_pos"])[None],
                                   torch.as_tensor(ref["pool_quat"])[None])
    return base, env


def test_scene_albedo_and_obs_width(ref, env):
    """`scene_point_rgb` exact: the robot's gray, 015_peach's baked texture
    (varied, warm), the can's and the bottle's flat 0.5; 147 observations
    with the camera as without."""
    base, env = env
    rgb = env.scene_point_rgb.numpy()
    np.testing.assert_array_equal(rgb, ref["scene_point_rgb"])
    n_robot = len(env.robot_cloud[1])
    peach, can = rgb[n_robot:n_robot + 64], rgb[n_robot + 64:]
    assert peach.std(0).max() > 0.05 and peach.mean(0)[0] > peach.mean(0)[2]
    assert np.all(can == 0.5)
    assert [base.num_obs, env.num_obs] == ref["num_obs"].tolist() == [147, 147]


@pytest.mark.parametrize("tag", TAGS)
def test_multiobj_camera_observables_match(ref, env, tag):
    """Each state's five observables with the JAX package's scores; every
    id of the scene (robot 1, objects 3, 4, 5) and the empty-pixel value
    seen; the flat observations within 1e-4."""
    torch.set_num_threads(1)
    from handarm_tpu_torch.envs.camera import INT32_MIN

    got = check_camera_observables(ref, env[1], tag)
    assert {INT32_MIN, 1, 3, 4, 5} <= set(np.unique(got["seg"]))
    np.testing.assert_allclose(got["obs"].numpy(), ref[f"{tag}_obs"], atol=1e-4)


if __name__ == "__main__":
    jax_reference(sys.argv[1], TASK, ["randomize=False"], pool_seed=5)
