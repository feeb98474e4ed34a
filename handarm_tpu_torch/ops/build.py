"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and one more `nvcc` links the objects into one shared library
under `<checkout>/build/handarm_tpu_torch/<sha>/`, where `<sha>` is a hash
of the sources and the flags: an edited source builds into a fresh
directory, and a directory is only ever entered complete (objects and the
library are written to private temporary names and the library is renamed
into place), so a build that was cut off leaves nothing that a later run
would wait on or reuse. Nothing here runs at import: the first kernel
launch builds. `-Xptxas -v` makes each compile report its kernels'
registers, spills and shared memory; `ptxas_report` returns that text.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "handarm_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIB_NAME = "libhandarm_kernels.so"
REPORT_NAME = "ptxas.txt"

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()  # actor threads may ask for it at once
build_seconds: float | None = None  # wall time of the last build (None: cached)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _run(cmds: list[list[str]], timeout: float) -> list[str]:
    """Run the commands in parallel and return their outputs; raise with the
    output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs, fails = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=timeout)
            outs.append(out)
            if proc.returncode != 0:
                fails.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if fails:
        raise RuntimeError("\n".join(fails))
    return outs


def build(timeout: float = 600.0) -> Path:
    """Compile the kernels if this source hash has no library yet."""
    global build_seconds
    out_dir = BUILD_ROOT / source_digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f".{src.stem}.{tag}.o" for src in _sources()]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        outs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                     for src, o in zip(_sources(), objs)], timeout)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]], timeout)
        (out_dir / REPORT_NAME).write_text("".join(
            f"== {src.name}\n{out}" for src, out in zip(_sources(), outs)))
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def ptxas_report() -> str:
    """The compiler's register, spill and shared-memory lines of the built
    kernels, one block per source."""
    return (build().parent / REPORT_NAME).read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if _lib is None:
        with _lib_lock:
            _load()
    return _lib


def _load() -> None:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.spd_inverse_f32.argtypes = [vp, vp, ci, ci, vp]
        lib.spd_inverse_f32.restype = ci
        lib.contact_sweep_f32.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,  # float inputs
            vp, vp, vp, vp, vp, vp, vp,  # slot tables
            vp, vp, vp,  # outputs
            ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, cf, ci, vp,
        ]
        lib.contact_sweep_f32.restype = ci
        lib.sdf_gather_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.sdf_gather_f32.restype = ci
        lib.prep_deff_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.prep_deff_f32.restype = ci
        lib.contact_sweep_launch_info.argtypes = [ci, ci, ci, ci, ci, ci, ci, vp]
        lib.contact_sweep_launch_info.restype = ci
        lib.prep_deff_launch_info.argtypes = [ci, ci, vp]
        lib.prep_deff_launch_info.restype = ci
        _lib = lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
