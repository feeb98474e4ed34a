"""Host-side URDF parsing into plain Python/numpy structures.

A numpy-only copy of handarm_tpu/physics/urdf.py, kept here so the port
stands alone.

TPU-native replacement for the reference's urdfpy introspection + gymapi
asset loading (reference: isaacgymenvs/tasks/hand_arm/base/ur5sih.py:58-121,
gym.load_asset at ur5sih.py:94). Runs once at model-build time on the host;
nothing here is traced by jit.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np


def _floats(s: str | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF rpy (extrinsic XYZ, i.e. R = Rz(y) Ry(p) Rx(r))."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclass
class Geometry:
    kind: str  # 'box' | 'sphere' | 'cylinder' | 'mesh'
    size: np.ndarray | None = None  # box: full extents
    radius: float | None = None
    length: float | None = None
    mesh_path: str | None = None
    mesh_scale: np.ndarray | None = None


@dataclass
class CollisionSpec:
    origin_pos: np.ndarray
    origin_rot: np.ndarray  # 3x3
    geometry: Geometry


@dataclass
class LinkSpec:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    com_rot: np.ndarray = field(default_factory=lambda: np.eye(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    collisions: list[CollisionSpec] = field(default_factory=list)


@dataclass
class JointSpec:
    name: str
    joint_type: str  # 'revolute' | 'prismatic' | 'fixed' | 'continuous'
    parent: str
    child: str
    origin_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    origin_rot: np.ndarray = field(default_factory=lambda: np.eye(3))
    axis: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0]))
    lower: float = -np.inf
    upper: float = np.inf
    effort: float = np.inf
    velocity: float = np.inf
    damping: float = 0.0
    friction: float = 0.0


@dataclass
class UrdfModel:
    name: str
    links: dict[str, LinkSpec]
    joints: list[JointSpec]
    actuated_joint_names: list[str]  # from <transmission> blocks
    root_link: str
    path: str


def _parse_geometry(geom_el: ET.Element, urdf_dir: str) -> Geometry | None:
    for child in geom_el:
        if child.tag == "box":
            return Geometry("box", size=_floats(child.get("size"), (0, 0, 0)))
        if child.tag == "sphere":
            return Geometry("sphere", radius=float(child.get("radius")))
        if child.tag == "cylinder":
            return Geometry(
                "cylinder",
                radius=float(child.get("radius")),
                length=float(child.get("length")),
            )
        if child.tag == "mesh":
            fn = child.get("filename") or ""
            if fn.startswith("package://"):
                # ROS package URI: walk up from the urdf dir until a parent
                # contains the package directory (e.g. the trifinger assets
                # reference package://robot_properties_fingers/meshes/...)
                rel = fn[len("package://"):]
                pkg = rel.split("/", 1)[0]
                path = None
                d = urdf_dir
                for _ in range(8):
                    cand = os.path.join(d, rel)
                    if os.path.basename(d) == pkg and os.path.exists(
                        os.path.join(d, rel.split("/", 1)[1])
                    ):
                        path = os.path.join(d, rel.split("/", 1)[1])
                        break
                    if os.path.exists(cand):
                        path = cand
                        break
                    d = os.path.dirname(d)
                if path is None:
                    path = os.path.normpath(os.path.join(urdf_dir, rel))
            else:
                path = fn if os.path.isabs(fn) else os.path.normpath(
                    os.path.join(urdf_dir, fn)
                )
                if not os.path.isabs(fn) and not os.path.exists(path):
                    # some assets reference meshes relative to the asset
                    # ROOT, not the urdf dir (e.g. kuka_allegro_description
                    # urdfs use "kuka_allegro_description/meshes/...");
                    # walk up the tree until the relative path resolves
                    d = os.path.dirname(urdf_dir)
                    for _ in range(8):
                        cand = os.path.normpath(os.path.join(d, fn))
                        if os.path.exists(cand):
                            path = cand
                            break
                        d = os.path.dirname(d)
            scale = _floats(child.get("scale"), (1.0, 1.0, 1.0))
            return Geometry("mesh", mesh_path=path, mesh_scale=scale)
    return None


def parse_urdf(path: str) -> UrdfModel:
    tree = ET.parse(path)
    robot = tree.getroot()
    urdf_dir = os.path.dirname(os.path.abspath(path))

    links: dict[str, LinkSpec] = {}
    for link_el in robot.findall("link"):
        link = LinkSpec(name=link_el.get("name"))
        inertial = link_el.find("inertial")
        if inertial is not None:
            mass_el = inertial.find("mass")
            link.mass = float(mass_el.get("value")) if mass_el is not None else 0.0
            origin = inertial.find("origin")
            if origin is not None:
                link.com = _floats(origin.get("xyz"))
                link.com_rot = rpy_to_matrix(_floats(origin.get("rpy")))
            in_el = inertial.find("inertia")
            if in_el is not None:
                ixx = float(in_el.get("ixx", 0)); iyy = float(in_el.get("iyy", 0))
                izz = float(in_el.get("izz", 0)); ixy = float(in_el.get("ixy", 0))
                ixz = float(in_el.get("ixz", 0)); iyz = float(in_el.get("iyz", 0))
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                # Inertia given in the inertial frame; rotate into link frame.
                link.inertia = link.com_rot @ I @ link.com_rot.T
        for col_el in link_el.findall("collision"):
            origin = col_el.find("origin")
            pos = _floats(origin.get("xyz")) if origin is not None else np.zeros(3)
            rot = (
                rpy_to_matrix(_floats(origin.get("rpy")))
                if origin is not None
                else np.eye(3)
            )
            geom_el = col_el.find("geometry")
            if geom_el is not None:
                geom = _parse_geometry(geom_el, urdf_dir)
                if geom is not None:
                    link.collisions.append(CollisionSpec(pos, rot, geom))
        links[link.name] = link

    joints: list[JointSpec] = []
    children = set()
    for j_el in robot.findall("joint"):
        j = JointSpec(
            name=j_el.get("name"),
            joint_type=j_el.get("type"),
            parent=j_el.find("parent").get("link"),
            child=j_el.find("child").get("link"),
        )
        origin = j_el.find("origin")
        if origin is not None:
            j.origin_pos = _floats(origin.get("xyz"))
            j.origin_rot = rpy_to_matrix(_floats(origin.get("rpy")))
        axis = j_el.find("axis")
        if axis is not None:
            a = _floats(axis.get("xyz"))
            n = np.linalg.norm(a)
            j.axis = a / n if n > 0 else np.array([1.0, 0.0, 0.0])
        limit = j_el.find("limit")
        if limit is not None:
            j.lower = float(limit.get("lower", -np.inf))
            j.upper = float(limit.get("upper", np.inf))
            j.effort = float(limit.get("effort", np.inf))
            j.velocity = float(limit.get("velocity", np.inf))
        dyn = j_el.find("dynamics")
        if dyn is not None:
            j.damping = float(dyn.get("damping", 0.0))
            j.friction = float(dyn.get("friction", 0.0))
        joints.append(j)
        children.add(j.child)

    actuated = []
    for t_el in robot.findall("transmission"):
        tj = t_el.find("joint")
        if tj is not None:
            actuated.append(tj.get("name"))

    roots = [name for name in links if name not in children]
    if len(roots) != 1:
        raise ValueError(f"expected a single root link, got {roots}")

    return UrdfModel(
        name=robot.get("name", "robot"),
        links=links,
        joints=joints,
        actuated_joint_names=actuated,
        root_link=roots[0],
        path=path,
    )
