"""Mesh objects from the baked shape records in `<checkout>/.sdf_cache/`
(counterpart of handarm_tpu/envs/objects.py `load_object`, read-only).

The JAX package bakes each object's URDF mesh into a record (voxel SDF,
surface samples, OBB, mass, inertia) and caches it as
`<key>.npz`, key = sha1("<urdf directory>/<name>.urdf:<R>:<P>:v4")[:16]:
the YCB objects of the hand-arm tasks under its default object root at R =
32 and P = 64 (`RECORD_KEYS`), the Factory and IndustReal parts under
those tasks' URDF directories (factory.py `FACTORY_URDF_DIR`,
industreal.py `IR_URDF_DIR`) at R = 40 and P = 96 (`PART_RECORD_KEYS`).
The object directories are not in the repository, so this loader never
parses a URDF and never writes: it maps the object names it knows to
their record keys (tests/test_torch_multiobj.py and
tests/test_torch_factory.py hold both tables against the JAX package's key
scheme) and reads the records as they are tracked, friction included; the
Factory and IndustReal env modules rescale a part's mass and inertia.
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
# the Factory and IndustReal parts' keys (R = 40, P = 96); the two meshes of
# IndustRealTaskGearsInsert were never baked (ROADMAP §1)
PART_RECORD_KEYS = {
    "factory/factory_nut_m16_loose": "06ce3a259fae97f2",
    "factory/factory_bolt_m16_loose": "692fc8a9be8137ca",
    "factory/factory_gear_medium": "dadc8819c0381f98",
    "factory/factory_gear_base_loose": "871ac592ed0ecaef",
    "factory/factory_gear_small": "80f372f344b59479",
    "factory/factory_round_peg_8mm_loose": "872635b87f034a4d",
    "factory/factory_round_hole_8mm": "e69554de7051e679",
    "industreal/industreal_round_peg_8mm": "ff66a91689b79bc6",
    "industreal/industreal_round_hole_8mm": "dc5a3b787dd555d1",
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
    """The shape record of one object or part (numpy dict for
    stack_objects)."""
    key = RECORD_KEYS.get(name, PART_RECORD_KEYS.get(name))
    if key is None:
        raise KeyError(f"no baked record for object {name!r}")
    path = CACHE_DIR / f"{key}.npz"
    if not path.exists():
        raise FileNotFoundError(f"record of {name!r} is missing: {path}")
    with np.load(path, allow_pickle=False) as d:
        return {k: (d[k] if d[k].shape else d[k].item()) for k in d.files}
