"""Run the JAX package's `scripts/eval_policy.py` on the in-repo stand-in
robot and the three tracked YCB records, as tests/test_torch_multiobj.py
sets the JAX package up: HANDARM_ASSET_ROOT at the stand-in,
HANDARM_OBJECT_ROOT at a directory of empty `ycb/<name>.urdf` files and
HANDARM_SDF_CACHE at copies of the records under the keys that root gives.
Genesis runs (it is the task's drop-init). Not a test: a tool, run as

    python tests/standin_jax_eval.py WORKDIR [eval_policy.py arguments ...]

for example `python tests/standin_jax_eval.py /tmp/ev --task
Ur5SihMultiObjectManipulation --ckpt docs/evidence/multiobj_r5a/ckpt_2700.npz
--envs 128 --steps 400`. WORKDIR holds the object root, the cache and the
JAX compilation cache; the eval's JSON line is printed as it prints it.
"""

import os
import pathlib
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(argv: list[str]) -> int:
    sys.path.insert(0, HERE)
    sys.path.insert(0, REPO)
    from test_torch_multiobj import STANDIN, _record_copies

    work = pathlib.Path(argv[0]).resolve()
    work.mkdir(parents=True, exist_ok=True)
    root, cache = work / "objects", work / "cache"
    if not cache.exists():
        root, cache = _record_copies(work)
    env = dict(os.environ, HANDARM_ASSET_ROOT=STANDIN, HANDARM_OBJECT_ROOT=str(root),
               HANDARM_SDF_CACHE=str(cache), JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(work / "jax_cache"))
    cmd = [sys.executable, os.path.join(REPO, "scripts", "eval_policy.py"),
           "--platform", "cpu", *argv[1:]]
    return subprocess.run(cmd, env=env, cwd=REPO).returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
