"""Host-side mesh loading + processing (numpy only).

A copy of the parts of handarm_tpu/utils/mesh.py that the robot model
build uses (loading, surface sampling, sphere fitting, hull inertia), kept
here so the port stands alone.

Nothing here runs in the hot path.
"""

from __future__ import annotations

import os
import struct

import numpy as np


class Mesh:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int64)

    # --- derived quantities -------------------------------------------------

    def face_areas(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)

    def area(self) -> float:
        return float(self.face_areas().sum())

    def sample_surface(self, n: int, rng: np.random.Generator | None = None) -> np.ndarray:
        """Area-weighted uniform surface samples (the reference's pointcloud
        sampling mode 'area', multi_object.py:774-806)."""
        return self.sample_surface_ex(n, rng)[0]

    def sample_surface_ex(
        self, n: int, rng: np.random.Generator | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Like sample_surface but also returns (face_idx [n], bary [n, 3])
        so per-face attributes (texture uv -> RGB) can be interpolated at the
        sample points. Consumes the rng identically to sample_surface."""
        rng = rng or np.random.default_rng(0)
        areas = self.face_areas()
        probs = areas / max(areas.sum(), 1e-12)
        idx = rng.choice(len(self.faces), size=n, p=probs)
        f = self.faces[idx]
        v = self.vertices
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        r1, r2 = rng.random((2, n, 1))
        s = np.sqrt(r1)
        wa, wb, wc = (1 - s), s * (1 - r2), s * r2
        pts = a * wa + b * wb + c * wc
        bary = np.concatenate([wa, wb, wc], axis=-1)
        return pts, idx, bary

    def scaled(self, s) -> "Mesh":
        return Mesh(self.vertices * np.asarray(s), self.faces)


def load_obj(path: str) -> Mesh:
    verts, faces = [], []
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = tok.split("/")[0]
                    idx.append(int(i) - 1 if int(i) > 0 else len(verts) + int(i))
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(np.array(verts), np.array(faces))


def load_stl(path: str) -> Mesh:
    with open(path, "rb") as fh:
        head = fh.read(80)
        rest = fh.read()
    if head[:5].lower() == b"solid" and b"facet" in rest[:500]:
        return _load_stl_ascii(path)
    (n_tri,) = struct.unpack("<I", rest[:4])
    data = np.frombuffer(rest[4 : 4 + n_tri * 50], dtype=np.uint8).reshape(n_tri, 50)
    tri = data[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3).astype(np.float64)
    verts = tri.reshape(-1, 3)
    # weld duplicates
    uniq, inv = np.unique(np.round(verts, 7), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    return Mesh(uniq, faces)


def _load_stl_ascii(path: str) -> Mesh:
    verts = []
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            t = line.split()
            if t and t[0] == "vertex":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    verts = np.array(verts)
    uniq, inv = np.unique(np.round(verts, 7), axis=0, return_inverse=True)
    return Mesh(uniq, inv.reshape(-1, 3))


def merge_meshes(meshes: list[Mesh]) -> Mesh:
    verts, faces, off = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        off += len(m.vertices)
    return Mesh(np.concatenate(verts), np.concatenate(faces))


def load_mesh(path: str, scale=None) -> Mesh:
    if not os.path.exists(path):
        # asset snapshots sometimes lack large visual meshes; fall back to the
        # sibling collision/ STL set with the same stem (e.g. palm -> palm_*.stl)
        import glob

        stem = os.path.splitext(os.path.basename(path))[0]
        coll_dir = os.path.join(os.path.dirname(path), "..", "collision")
        cands = sorted(glob.glob(os.path.join(coll_dir, stem + "*.stl")))
        if cands:
            m = merge_meshes([load_mesh(c) for c in cands])
            if scale is not None and not np.allclose(scale, 1.0):
                m = m.scaled(scale)
            return m
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        m = load_obj(path)
    elif ext == ".stl":
        m = load_stl(path)
    else:
        raise ValueError(f"unsupported mesh format {ext}")
    if scale is not None and not np.allclose(scale, 1.0):
        m = m.scaled(scale)
    return m


def hull_mass_properties(points: np.ndarray, density: float):
    """Mass, com and inertia (about com) of the uniform-density convex hull
    of a point set. Used to auto-derive missing URDF inertials the way PhysX
    does from collision shapes (links like the SIH fingers ship without
    <inertial> blocks)."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(np.asarray(points, dtype=np.float64))
    verts = hull.points
    # tetrahedra (origin, a, b, c) over hull triangles
    a = verts[hull.simplices[:, 0]]
    b = verts[hull.simplices[:, 1]]
    c = verts[hull.simplices[:, 2]]
    # ensure outward orientation w.r.t. hull centroid
    centroid0 = verts[np.unique(hull.simplices)].mean(0)
    n = np.cross(b - a, c - a)
    flip = np.einsum("ij,ij->i", n, a - centroid0) < 0
    b2 = np.where(flip[:, None], c, b)
    c2 = np.where(flip[:, None], b, c)
    b, c = b2, c2
    vol6 = np.einsum("ij,ij->i", a, np.cross(b, c))
    volume = vol6.sum() / 6.0
    com = ((a + b + c) / 4 * vol6[:, None]).sum(0) / max(vol6.sum(), 1e-12)
    # inertia via canonical tetra integrals (relative to origin), then shift
    I = np.zeros((3, 3))
    for av, bv, cv, v6 in zip(a, b, c, vol6):
        V = np.stack([av, bv, cv])
        Cq = (V.T @ V + V.sum(0)[:, None] * V.sum(0)[None, :]) / 20.0 * (v6 / 6.0)
        I += np.trace(Cq) * np.eye(3) - Cq
    mass = density * volume
    I = I * density
    # shift to com
    I -= mass * ((com @ com) * np.eye(3) - np.outer(com, com))
    return mass, com, I


def fit_spheres(
    points: np.ndarray, n_spheres: int, padding: float = 0.0, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Cover a point set with n spheres via k-means: returns (centers [n,3],
    radii [n]). The sphere proxies approximate link collision meshes for the
    TPU narrowphase (PhysX used the raw convex meshes)."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(points)
    n_spheres = min(n_spheres, len(pts))
    centers = pts[rng.choice(len(pts), n_spheres, replace=False)]
    for _ in range(20):
        d = np.linalg.norm(pts[:, None] - centers[None], axis=-1)
        assign = d.argmin(1)
        for k in range(n_spheres):
            sel = pts[assign == k]
            if len(sel):
                centers[k] = sel.mean(0)
    d = np.linalg.norm(pts[:, None] - centers[None], axis=-1)
    assign = d.argmin(1)
    radii = np.array(
        [
            d[assign == k, k].max() + padding if (assign == k).any() else padding
            for k in range(n_spheres)
        ]
    )
    return centers, radii
