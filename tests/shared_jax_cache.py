"""One JAX compilation cache for the JAX subprocesses of a pytest run's
parity tests."""

import re
from pathlib import Path


def shared_jax_env(tmp) -> dict:
    """The environment entries of a JAX subprocess started from a test whose
    temp directory is `tmp`: a persistent compilation cache beside the
    pytest run's temp directories (`pytest-N/`, which holds every xdist
    worker's), every compilation cached. The subprocesses of all the test
    files read and write it, so a program that several of them compile
    alike (the Ur5SihLift step at B = 8 that they drive into contact first;
    the single operations of eager code, such as an env's reset, a fraction
    of a second each) compiles once. JAX takes an entry it cannot read as a
    miss and compiles."""
    p = Path(tmp).resolve()
    root = next((d for d in (p, *p.parents) if re.fullmatch(r"pytest-\d+", d.name)), p)
    return {"JAX_COMPILATION_CACHE_DIR": str(root / "jax_cache"),
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}
