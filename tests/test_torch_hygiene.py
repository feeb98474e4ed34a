"""The port stands alone: no module of handarm_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; the port's files are small
and text; every module imports on a machine without CUDA."""

import ast
import importlib
import os
import pkgutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "handarm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "handarm_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_port_files_small_and_text():
    """No binaries and no file over 200 KB in the port's package."""
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(root, f)
            assert os.path.getsize(p) < 200_000, p
            assert not f.endswith((".so", ".npz", ".npy", ".pt", ".o")), p
            open(p, encoding="utf-8").read()  # text


def test_modules_import_without_cuda():
    names = [m.name for m in pkgutil.walk_packages([PKG], "handarm_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    for mod in ("ops.contact_sweep", "ops.spd_inverse", "ops.sdf_gather", "ops.prep_deff",
                "physics.sdf", "envs.objects", "envs.genesis", "envs.registry", "envs.adr",
                "envs.randomization", "utils.config", "envs.pointcloud", "learn.distill",
                "train_distill"):
        assert f"handarm_tpu_torch.{mod}" in names


CU_SOURCES = {"contact_sweep.cu": "contact_sweep.py", "spd_inverse.cu": "spd_inverse.py",
              "sdf_gather.cu": "sdf_gather.py", "prep_deff.cu": "prep_deff.py"}


@pytest.mark.parametrize("name", sorted(CU_SOURCES))
def test_cuda_sources_small_text_and_noted(name):
    """Each kernel source is a small text file whose note names the TPU
    kernel it replaces, and the build compiles every one of them."""
    from handarm_tpu_torch.ops import build

    path = os.path.join(PKG, "csrc", name)
    assert os.path.getsize(path) < 50_000
    text = open(path, encoding="utf-8").read()
    assert f"Replaces: handarm_tpu/ops/{CU_SOURCES[name]}" in text
    assert "What bounds it on an H100" in text and 'extern "C"' in text
    assert path in map(str, build._sources())
