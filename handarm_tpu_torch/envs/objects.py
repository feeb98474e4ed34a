"""Mesh objects from the baked shape records in `<checkout>/.sdf_cache/`
(counterpart of handarm_tpu/envs/objects.py `load_object`, read-only).

The JAX package bakes each object's URDF mesh into a record (voxel SDF,
surface samples, OBB, mass, inertia) and caches it as
`<key>.npz`, key = sha1("<object root>/<set>/<name>.urdf:<R>:<P>:v4")[:16]
with its default object root, R = 32 and P = 64. The object directories
are not in the repository, so this loader never parses a URDF and never
writes: it maps the object names it knows to their record keys
(tests/test_torch_multiobj.py holds RECORD_KEYS against the JAX package's
key scheme) and reads the records as they are tracked.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parents[2] / ".sdf_cache"

# the JAX package's cache keys of the records this port reads (R = 32, P = 64)
RECORD_KEYS = {
    "ycb/015_peach": "bddf65758b6824fe",
    "ycb/005_tomato_soup_can": "095dc259e9b650fd",
    "ycb/006_mustard_bottle": "308c76b636d625d5",
}


def resolve_object_set(dataset: tuple) -> list[str]:
    """(("ycb", ("015_peach", ...)), ...) -> ["ycb/015_peach", ...], in the
    order listed. Patterns are not expanded: every name must be one whose
    record this port knows."""
    names = []
    for set_name, patterns in dataset:
        for pat in patterns:
            name = f"{set_name}/{pat}"
            if name not in RECORD_KEYS:
                raise KeyError(f"no baked record for object {name!r} "
                               f"(known: {sorted(RECORD_KEYS)})")
            if name not in names:
                names.append(name)
    return names


def load_object(name: str) -> dict:
    """The shape record of one object (numpy dict for stack_objects)."""
    if name not in RECORD_KEYS:
        raise KeyError(f"no baked record for object {name!r}")
    path = CACHE_DIR / f"{RECORD_KEYS[name]}.npz"
    if not path.exists():
        raise FileNotFoundError(f"record of {name!r} is missing: {path}")
    with np.load(path, allow_pickle=False) as d:
        return {k: (d[k] if d[k].shape else d[k].item()) for k in d.files}
