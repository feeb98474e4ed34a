"""Host-side MJCF (MuJoCo XML) parsing into the same UrdfModel structures
the URDF path uses, so one `compile_model` serves both formats.

A numpy-only copy of handarm_tpu/physics/mjcf.py, kept here so the port
stands alone; `parse_mjcf_string` parses a document held in memory (the
classic tasks generate theirs), so no two processes share a file.

TPU-native replacement for IsaacGym's built-in MJCF asset importer (the
reference loads mjcf assets via gym.load_asset for the classic locomotion
tasks, e.g. isaacgymenvs/tasks/ant.py asset "mjcf/nv_ant.xml"). Design:

- MJCF bodies may carry several joints; each joint rotates the body about
  its own anchor. We decompose a k-joint body into a chain of k-1 massless
  virtual links so the dof-per-body invariant of the compiler holds:
    joint i's URDF origin = (body offset for i=1) * translate(p_i - p_{i-1})
  and the real link's inertial/geoms shift by -p_k.
- <freejoint/> / <joint type="free"> marks the model floating-base.
- inertiafromgeom: link inertia computed from geoms at the geom density
  (sphere/capsule/box analytic mass properties), matching MuJoCo defaults.
- <default> classes (incl. nested childclass scoping) are resolved at parse
  time; only the attributes this engine consumes are tracked.
- <motor> actuators give actuated joint names + gear ratios.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from handarm_tpu_torch.physics.urdf import (
    CollisionSpec,
    Geometry,
    JointSpec,
    LinkSpec,
    UrdfModel,
    rpy_to_matrix,
)


@dataclass
class MjcfExtras:
    """Side information that has no URDF analog."""

    floating: bool = False
    root_body: str = ""
    root_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    motor_gears: dict = field(default_factory=dict)  # joint name -> gear
    motor_ctrl_range: dict = field(default_factory=dict)  # joint -> (lo, hi)
    init_qpos: np.ndarray | None = None  # custom numeric "init_qpos"
    joint_stiffness: dict = field(default_factory=dict)  # joint -> k
    joint_armature: dict = field(default_factory=dict)  # joint -> armature
    # per-link collision spheres derived from geoms: link -> [(pos, radius)]
    link_spheres: dict = field(default_factory=dict)
    geom_friction: dict = field(default_factory=dict)  # link -> mu (slide)


def _floats(s, default=None):
    if s is None:
        return None if default is None else np.asarray(default, np.float64)
    return np.asarray([float(x) for x in s.split()], np.float64)


def _quat_to_mat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _axisangle_mat(axis, angle):
    a = np.asarray(axis, np.float64)
    n = np.linalg.norm(a)
    if n < 1e-12:
        return np.eye(3)
    a = a / n
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _frame_rot(el: ET.Element, deg: bool) -> np.ndarray:
    """Orientation from quat / euler / axisangle / zaxis attributes."""
    s = np.pi / 180.0 if deg else 1.0
    if el.get("quat") is not None:
        return _quat_to_mat(_floats(el.get("quat")))
    if el.get("euler") is not None:
        e = _floats(el.get("euler")) * s
        # mujoco default eulerseq "xyz" (intrinsic) == extrinsic zyx reversed;
        # R = Rx Ry Rz applied right-to-left on body axes -> Rz@Ry@Rx order
        # matches URDF rpy for the common case
        return rpy_to_matrix(e)
    if el.get("axisangle") is not None:
        v = _floats(el.get("axisangle"))
        return _axisangle_mat(v[:3], v[3] * s)
    if el.get("zaxis") is not None:
        z = _floats(el.get("zaxis"))
        z = z / np.linalg.norm(z)
        ref = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0.0, 1, 0])
        x = np.cross(ref, z)
        x /= np.linalg.norm(x)
        return np.stack([x, np.cross(z, x), z], axis=1)
    return np.eye(3)


class _Defaults:
    """Resolved attribute defaults per element kind, with class inheritance."""

    def __init__(self):
        self.by_class: dict[str, dict[str, dict[str, str]]] = {"": {}}

    def parse(self, el: ET.Element, parent_class: str = ""):
        cls = el.get("class", parent_class)
        base = {k: dict(v) for k, v in self.by_class.get(parent_class, {}).items()}
        for child in el:
            if child.tag == "default":
                continue
            base.setdefault(child.tag, {}).update(child.attrib)
        self.by_class[cls] = base
        for child in el:
            if child.tag == "default":
                self.parse(child, cls)

    def resolve(self, el: ET.Element, kind: str, cls: str) -> dict[str, str]:
        cls = el.get("class", cls)
        out = dict(self.by_class.get(cls, self.by_class[""]).get(kind, {}))
        out.update(el.attrib)
        return out


def _geom_mass_props(g: dict, deg: bool):
    """(mass, com, inertia_about_com, pos, rot) for one geom at its density."""
    density = float(g.get("density", 1000.0))
    typ = g.get("type", "sphere")
    pos = _floats(g.get("pos"), (0, 0, 0))
    rot = np.eye(3)
    if g.get("fromto") is not None:
        ft = _floats(g.get("fromto"))
        a, b = ft[:3], ft[3:]
        pos = (a + b) / 2
        z = b - a
        L = np.linalg.norm(z)
        if L > 1e-9:
            z = z / L
            ref = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0.0, 1, 0])
            x = np.cross(ref, z)
            x /= np.linalg.norm(x)
            rot = np.stack([x, np.cross(z, x), z], axis=1)
    else:
        el_like = ET.Element("g", {k: v for k, v in g.items() if v is not None})
        rot = _frame_rot(el_like, deg)
        L = None

    size = _floats(g.get("size"), (0.0,))
    if typ == "sphere":
        r = size[0]
        m = density * 4 / 3 * np.pi * r**3
        i = 0.4 * m * r * r
        I = np.diag([i, i, i])
        geom = Geometry(kind="sphere", radius=float(r))
    elif typ == "capsule":
        r = size[0]
        hl = L / 2 if L is not None else (size[1] if len(size) > 1 else r)
        L_cyl = 2 * hl
        m_cyl = density * np.pi * r * r * L_cyl
        m_sph = density * 4 / 3 * np.pi * r**3
        m = m_cyl + m_sph
        # cylinder about its center + two hemispheres at the ends (z axis)
        iz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        ixy = (
            m_cyl * (L_cyl * L_cyl / 12 + r * r / 4)
            + m_sph * (0.4 * r * r + hl * hl + 0.75 * hl * r)
        )
        I = np.diag([ixy, ixy, iz])
        geom = Geometry(kind="cylinder", radius=float(r), length=float(L_cyl))
    elif typ == "box":
        h = size  # mjcf box size = half extents
        m = density * 8 * h[0] * h[1] * h[2]
        I = (
            m
            / 3.0
            * np.diag(
                [h[1] ** 2 + h[2] ** 2, h[0] ** 2 + h[2] ** 2, h[0] ** 2 + h[1] ** 2]
            )
        )
        geom = Geometry(kind="box", size=2 * np.asarray(h, np.float64))
    else:  # plane / unsupported: massless
        return 0.0, pos, np.zeros((3, 3)), pos, rot, None
    return float(m), pos, rot @ I @ rot.T, pos, rot, geom


def _geom_spheres(g: dict, rot: np.ndarray, pos: np.ndarray):
    """Collision-sphere proxies for a geom (locomotion-grade narrowphase)."""
    typ = g.get("type", "sphere")
    size = _floats(g.get("size"), (0.0,))
    if typ == "sphere":
        return [(pos, float(size[0]))]
    if typ == "capsule":
        r = float(size[0])
        if g.get("fromto") is not None:
            ft = _floats(g.get("fromto"))
            a, b = ft[:3], ft[3:]
        else:
            hl = size[1] if len(size) > 1 else r
            a = pos - rot[:, 2] * hl
            b = pos + rot[:, 2] * hl
        return [(a, r), ((a + b) / 2, r), (b, r)]
    if typ == "box":
        h = size
        r = float(min(h))
        c = []
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    off = np.array(
                        [sx * max(h[0] - r, 0), sy * max(h[1] - r, 0), sz * max(h[2] - r, 0)]
                    )
                    c.append((pos + rot @ off, r))
        return c
    return []


def _expand_includes(el: ET.Element, base_dir: str):
    """Inline <include file=.../> elements recursively (MuJoCo include
    semantics: the included file's root children are spliced in place —
    the OpenAI shadow-hand assets are structured this way)."""
    i = 0
    while i < len(el):
        child = el[i]
        if child.tag == "include":
            inc_path = os.path.join(base_dir, child.get("file"))
            inc_root = ET.parse(inc_path).getroot()
            _expand_includes(inc_root, os.path.dirname(inc_path))
            el.remove(child)
            for j, sub in enumerate(list(inc_root)):
                el.insert(i + j, sub)
        else:
            _expand_includes(child, base_dir)
            i += 1


def parse_mjcf(path: str) -> tuple[UrdfModel, MjcfExtras]:
    return _parse_root(ET.parse(path).getroot(), path)


def parse_mjcf_string(xml: str, path: str = "<string>") -> tuple[UrdfModel, MjcfExtras]:
    """`parse_mjcf` of a document in memory; `path` names it (its directory
    resolves <include> files)."""
    return _parse_root(ET.fromstring(xml), path)


def _parse_root(root: ET.Element, path: str) -> tuple[UrdfModel, MjcfExtras]:
    _expand_includes(root, os.path.dirname(os.path.abspath(path)))
    name = root.get("model", os.path.basename(path))

    compiler = root.find("compiler")
    deg = True  # mujoco default angle="degree"
    if compiler is not None and compiler.get("angle") == "radian":
        deg = False
    ang = np.pi / 180.0 if deg else 1.0

    defaults = _Defaults()
    for d in root.findall("default"):
        defaults.parse(d)

    extras = MjcfExtras()
    custom = root.find("custom")
    if custom is not None:
        for num in custom.findall("numeric"):
            if num.get("name") == "init_qpos":
                extras.init_qpos = _floats(num.get("data"))

    links: dict[str, LinkSpec] = {}
    joints: list[JointSpec] = []
    vcount = [0]

    def new_link(nm: str) -> LinkSpec:
        lk = LinkSpec(name=nm)
        links[nm] = lk
        return lk

    def visit_body(el: ET.Element, parent_link: str, cls: str):
        bname = el.get("name", f"body{len(links)}")
        body_pos = _floats(el.get("pos"), (0, 0, 0))
        body_rot = _frame_rot(el, deg)
        cls = el.get("childclass", cls)

        jels = [j for j in el.findall("joint")] + [
            j for j in el.findall("freejoint")
        ]
        free = any(
            j.tag == "freejoint" or j.get("type") == "free" for j in jels
        )
        if free:
            extras.floating = True
            extras.root_body = bname
            extras.root_pos = body_pos
            jels = []

        # chain decomposition: k joints -> k-1 virtual links
        prev_link = parent_link
        prev_anchor = np.zeros(3)
        last_anchor = np.zeros(3)
        hinge_jels = [j for j in jels if j.get("type", "hinge") in ("hinge", "slide")]
        for idx, j in enumerate(hinge_jels):
            a = defaults.resolve(j, "joint", cls)
            jname = a.get("name", f"{bname}_j{idx}")
            anchor = _floats(a.get("pos"), (0, 0, 0))
            axis = _floats(a.get("axis"), (0, 0, 1))
            rng = _floats(a.get("range"))
            limited = a.get("limited", "false") in ("true", "1") or rng is not None
            lo, hi = (-np.inf, np.inf)
            if rng is not None and limited:
                lo, hi = rng[0] * ang, rng[1] * ang
            is_last = idx == len(hinge_jels) - 1
            child = bname if is_last else f"{bname}__v{idx}"
            if not is_last:
                new_link(child)
            if idx == 0:
                opos = body_pos + body_rot @ anchor
                orot = body_rot
            else:  # translate from previous joint's anchor to this one
                opos = anchor - prev_anchor
                orot = np.eye(3)
            joints.append(
                JointSpec(
                    name=jname,
                    joint_type=(
                        "prismatic" if j.get("type") == "slide" else "revolute"
                    ),
                    parent=prev_link,
                    child=child,
                    origin_pos=opos,
                    origin_rot=orot,
                    axis=np.asarray(axis, np.float64),
                    lower=float(lo),
                    upper=float(hi),
                    effort=1e9,  # torque limits applied via motor gears
                    # MuJoCo has no joint velocity cap, but the engine's
                    # velocity_limit clamp (engine.py, PhysX maxVelocity
                    # analog) needs a finite value or airborne flailing
                    # diverges (gyroscopic blowup). 100 rad/s ~ PhysX's
                    # permissive default for mjcf imports; URDF robots get
                    # their declared limits instead
                    velocity=100.0,
                    damping=float(a.get("damping", 0.0)),
                    friction=float(a.get("frictionloss", 0.0)),
                )
            )
            extras.joint_stiffness[jname] = float(a.get("stiffness", 0.0))
            extras.joint_armature[jname] = float(a.get("armature", 0.0))
            prev_link = child
            prev_anchor = anchor
            last_anchor = anchor

        if not hinge_jels:
            # rigid attachment (fixed joint) or free root
            if parent_link is not None:
                joints.append(
                    JointSpec(
                        name=f"{bname}_fixed",
                        joint_type="fixed",
                        parent=parent_link,
                        child=bname,
                        origin_pos=body_pos,
                        origin_rot=body_rot,
                    )
                )
            last_anchor = np.zeros(3)
            shift = np.zeros(3)
        else:
            shift = -last_anchor
        lk = new_link(bname) if bname not in links else links[bname]

        # geoms -> inertia + collision proxies, shifted into the final frame
        mass_tot, fm, I_org = 0.0, np.zeros(3), np.zeros((3, 3))
        sph = []
        mu = None
        for gel in el.findall("geom"):
            g = defaults.resolve(gel, "geom", cls)
            m, com_g, I_com, gpos, grot, geom = _geom_mass_props(g, deg)
            if g.get("friction"):
                mu = float(g["friction"].split()[0])
            com_s = com_g + shift
            if m > 0:
                mass_tot += m
                fm += m * com_s
                c = com_s
                I_org += I_com + m * ((c @ c) * np.eye(3) - np.outer(c, c))
            if g.get("contype", "1") == "0":
                continue  # visual-only geom: no collision proxy
            for sp, sr in _geom_spheres(g, grot, gpos):
                sph.append((sp + shift, sr))
            if geom is not None:
                lk.collisions.append(
                    CollisionSpec(
                        origin_pos=gpos + shift, origin_rot=grot, geometry=geom
                    )
                )
        if mass_tot > 0:
            lk.mass = mass_tot
            lk.com = fm / mass_tot
            c = lk.com
            lk.inertia = I_org - mass_tot * (
                (c @ c) * np.eye(3) - np.outer(c, c)
            )
        inert = el.find("inertial")
        if inert is not None:
            # explicit <inertial> overrides geom-derived mass properties
            # (the shadow-hand assets specify these per body)
            lk.mass = float(inert.get("mass", 0.0))
            lk.com = _floats(inert.get("pos"), (0, 0, 0)) + shift
            Ri = _frame_rot(inert, deg)
            if inert.get("diaginertia") is not None:
                Id = np.diag(_floats(inert.get("diaginertia")))
            elif inert.get("fullinertia") is not None:
                fi = _floats(inert.get("fullinertia"))
                Id = np.array([
                    [fi[0], fi[3], fi[4]],
                    [fi[3], fi[1], fi[5]],
                    [fi[4], fi[5], fi[2]],
                ])
            else:
                Id = np.eye(3) * 1e-5
            lk.inertia = Ri @ Id @ Ri.T
        if sph:
            extras.link_spheres[bname] = sph
        if mu is not None:
            extras.geom_friction[bname] = mu

        for sub in el.findall("body"):
            visit_body(sub, bname, cls)

    world = root.find("worldbody")
    top_bodies = world.findall("body")
    # a synthetic world root ties multiple top-level bodies together
    new_link("world")
    for tb in top_bodies:
        visit_body(tb, None if _is_free_root(tb) else "world", "")

    # actuators
    for act in root.findall("actuator"):
        for mot in act.findall("motor"):
            a = defaults.resolve(mot, "motor", "")
            jn = a.get("joint")
            if jn is None:
                continue
            extras.motor_gears[jn] = float(a.get("gear", 1.0))
            cr = _floats(a.get("ctrlrange"))
            if cr is not None:
                extras.motor_ctrl_range[jn] = (cr[0], cr[1])

    root_link = extras.root_body if extras.floating else "world"
    actuated = list(extras.motor_gears)
    return (
        UrdfModel(
            name=name,
            links=links,
            joints=joints,
            actuated_joint_names=actuated,
            root_link=root_link,
            path=path,
        ),
        extras,
    )


def _is_free_root(body_el: ET.Element) -> bool:
    return any(
        j.tag == "freejoint" or j.get("type") == "free"
        for j in list(body_el.findall("joint")) + list(body_el.findall("freejoint"))
    )
