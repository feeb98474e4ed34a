"""Kinematic-tree compiler: URDF -> flat array articulation model.

A numpy-only copy of handarm_tpu/physics/model.py, kept here so the port
stands alone.

Replaces the reference's gymapi asset pipeline (gym.load_asset + urdfpy
introspection, reference: isaacgymenvs/tasks/hand_arm/base/ur5sih.py:58-121).
Fixed joints are collapsed at compile time: their child links merge into the
parent moving body (composite inertia) and their frames are kept as named
"sites" (used for flange/fingertip observables, reference ur5sih.py:159-231).

The result is a static pytree of unbatched arrays; per-env batching happens in
the dynamics functions, which broadcast the model against [B, ...] state.
Topology (parent indices, masks) stays as numpy so python-level loops unroll
under jit with static structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from handarm_tpu_torch.physics.urdf import JointSpec, UrdfModel, parse_urdf

REVOLUTE, PRISMATIC = 0, 1
# floating-base dof types: 3 world-axis translations + 3 world-axis rotations
# (MuJoCo-free-joint-style, but with world-frame angular velocity so the
# world-frame CRBA/RNEA screws stay trivial)
FREE_TRANS, FREE_ROT = 2, 3


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 -> wxyz quaternion (host-side, numpy)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
    elif i == 1:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.array(q)
    return q / np.linalg.norm(q)


@dataclass
class Site:
    """Named fixed frame on a moving body (flange, fingertips, palm, ...)."""

    body: int
    pos: np.ndarray  # in body frame
    quat: np.ndarray  # wxyz, body frame -> site frame


@dataclass
class CollisionSphere:
    body: int
    pos: np.ndarray  # center in body frame
    radius: float
    name: str = ""


@dataclass
class Articulation:
    """Compiled articulation (fixed- or floating-base). All arrays are
    numpy float64 at compile time; the physics engine casts to the compute
    dtype on use.

    Fixed base: one dof per moving body, nb == nv, dof/body indices
    coincide. Floating base (`floating=True`): dofs 0-5 are the base's
    world-frame translations/rotations (joint_type FREE_TRANS/FREE_ROT),
    body 0 is the base link, and joint dof 6+j drives body 1+j; per-dof
    arrays are [nv]-sized (first 6 rows describe the base dofs), per-body
    inertial arrays are [nb]-sized."""

    name: str
    nv: int
    # topology (static)
    parent: np.ndarray  # [nv] int, -1 = fixed base
    joint_type: np.ndarray  # [nv] int
    joint_names: list[str]
    body_names: list[str]  # moving-body canonical (child link) names
    ancestor_mask: np.ndarray  # [nv(body), nv(dof)] 1.0 if dof j moves body i
    # joint placement: transform from parent moving-body frame (or base frame)
    # to this joint's child body frame, at q = 0
    tree_pos: np.ndarray  # [nv, 3]
    tree_quat: np.ndarray  # [nv, 4]
    axis: np.ndarray  # [nv, 3], in child body frame
    # composite inertial properties per moving body, in body frame
    mass: np.ndarray  # [nv]
    com: np.ndarray  # [nv, 3]
    inertia: np.ndarray  # [nv, 3, 3] about com
    # limits / dynamics
    q_min: np.ndarray
    q_max: np.ndarray
    effort_limit: np.ndarray
    velocity_limit: np.ndarray
    joint_damping: np.ndarray
    joint_friction: np.ndarray
    armature: np.ndarray
    # named frames and collision proxies
    sites: dict[str, Site] = field(default_factory=dict)
    collision_spheres: list[CollisionSphere] = field(default_factory=list)
    actuated_joint_names: list[str] = field(default_factory=list)
    # floating-base topology (None = fixed base, derived trivially)
    floating: bool = False
    body_parent: np.ndarray | None = None  # [nb] int, -1 = world
    body_dof: np.ndarray | None = None  # [nb] int dof driving body (-1 base)
    dof_body: np.ndarray | None = None  # [nv] int body each dof moves first

    @property
    def nb(self) -> int:
        return len(self.body_names)

    @property
    def site_names(self) -> list[str]:
        return list(self.sites)

    def site_array(self, names: list[str]):
        """Stack sites into (body_idx [n], pos [n,3], quat [n,4]) numpy arrays."""
        bodies = np.array([self.sites[n].body for n in names], dtype=np.int32)
        pos = np.stack([self.sites[n].pos for n in names])
        quat = np.stack([self.sites[n].quat for n in names])
        return bodies, pos, quat


def _compose(Ra, ta, Rb, tb):
    return Ra @ Rb, Ra @ tb + ta


def compile_urdf(
    path: str,
    default_armature: float = 1e-3,
    floating_base: bool = False,
    default_density: float = 1000.0,
) -> Articulation:
    urdf = parse_urdf(path)
    return compile_model(
        urdf,
        default_armature=default_armature,
        default_density=default_density,
        floating_base=floating_base,
    )


def compile_mjcf(
    path: str, default_armature: float = 0.0, default_density: float = 0.0
):
    """MJCF asset -> (Articulation, MjcfExtras). Floating base follows the
    model's <freejoint>; joint armature comes from the mjcf defaults."""
    from handarm_tpu_torch.physics.mjcf import parse_mjcf

    urdf, extras = parse_mjcf(path)
    art = compile_model(
        urdf,
        default_armature=default_armature,
        default_density=default_density,
        floating_base=extras.floating,
    )
    # per-joint armature from mjcf joint defaults
    if extras.joint_armature:
        arm = art.armature.copy()
        for i, jn in enumerate(art.joint_names):
            if jn in extras.joint_armature:
                arm[i] = extras.joint_armature[jn]
        art.armature = arm
    return art, extras


def _estimate_missing_inertials(urdf: UrdfModel, density: float) -> None:
    """Links without <inertial> but with collision shapes get uniform-density
    convex-hull mass properties (matches PhysX's auto-computed inertials)."""
    from handarm_tpu_torch.utils.mesh import hull_mass_properties, load_mesh

    for link in urdf.links.values():
        if link.mass > 0.0 or not link.collisions:
            continue
        pts_all = []
        for col in link.collisions:
            g = col.geometry
            if g.kind == "mesh" and g.mesh_path:
                try:
                    mesh = load_mesh(g.mesh_path, g.mesh_scale)
                except FileNotFoundError:
                    continue
                pts = mesh.vertices
            elif g.kind == "box":
                h = np.asarray(g.size) / 2
                pts = np.array(
                    [[sx * h[0], sy * h[1], sz * h[2]]
                     for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
                )
            elif g.kind == "sphere":
                r = g.radius
                pts = r * np.array(
                    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                     [0, 0, -1], [0.577, 0.577, 0.577], [-0.577, -0.577, -0.577]]
                )
            elif g.kind == "cylinder":
                ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
                ring = np.stack([np.cos(ang) * g.radius, np.sin(ang) * g.radius], -1)
                pts = np.concatenate(
                    [np.concatenate([ring, np.full((12, 1), z)], -1)
                     for z in (-g.length / 2, g.length / 2)]
                )
            else:
                continue
            pts_all.append(pts @ col.origin_rot.T + col.origin_pos)
        if not pts_all:
            continue
        try:
            mass, com, I = hull_mass_properties(np.concatenate(pts_all), density)
        except Exception:
            continue
        if mass <= 0:
            continue
        link.mass = mass
        link.com = com
        link.com_rot = np.eye(3)
        link.inertia = I


def compile_model(
    urdf: UrdfModel,
    default_armature: float = 1e-3,
    default_density: float = 1000.0,
    floating_base: bool = False,
) -> Articulation:
    """Compile a parsed model into a flat articulation.

    Fixed base: one dof per moving body (dof index == body index).
    Floating base: dofs 0-5 are the base's 6 world-frame freedoms —
    3 translations (FREE_TRANS, constant screws (0, e_i)) then 3 rotations
    about axes through the WORLD ORIGIN (FREE_ROT, screws (e_i, 0)). Both
    families are constant in the parent (world) frame, so the world-frame
    CRBA/RNEA sweeps in dynamics.py apply unchanged. Body 0 is the root
    link; its pose lives in RobotState (not in q)."""
    if default_density > 0:
        _estimate_missing_inertials(urdf, default_density)
    # children adjacency
    by_parent: dict[str, list[JointSpec]] = {}
    for j in urdf.joints:
        by_parent.setdefault(j.parent, []).append(j)

    parent_list: list[int] = []  # per dof: parent dof index
    jtype: list[int] = []
    jnames: list[str] = []
    bnames: list[str] = []  # per body
    body_parent: list[int] = []  # per body: parent body index
    body_dof: list[int] = []  # per body: driving dof (-1 for floating base)
    dof_body: list[int] = []  # per dof: body it drives
    tree_pos: list[np.ndarray] = []
    tree_quat: list[np.ndarray] = []
    axis: list[np.ndarray] = []
    limits: list[tuple] = []
    dyn: list[tuple] = []
    # accumulated inertial state per moving body
    body_mass: list[float] = []
    body_first_moment: list[np.ndarray] = []  # mass * com
    body_inertia_origin: list[np.ndarray] = []  # inertia about body-frame origin
    sites: dict[str, Site] = {}

    BIG = 1e9
    if floating_base:
        eye = np.eye(3)
        for k in range(6):
            parent_list.append(k - 1)
            jtype.append(FREE_TRANS if k < 3 else FREE_ROT)
            jnames.append(f"free_{'tr'[k // 3]}{'xyz'[k % 3]}")
            dof_body.append(0)
            tree_pos.append(np.zeros(3))
            tree_quat.append(np.array([1.0, 0, 0, 0]))
            axis.append(eye[k % 3].copy())
            limits.append((-BIG, BIG, 0.0, BIG))
            dyn.append((0.0, 0.0))

    def new_body(name: str, parent_body: int, dof: int) -> int:
        bnames.append(name)
        body_parent.append(parent_body)
        body_dof.append(dof)
        body_mass.append(0.0)
        body_first_moment.append(np.zeros(3))
        body_inertia_origin.append(np.zeros((3, 3)))
        return len(bnames) - 1

    def add_link_inertia(body: int, R: np.ndarray, t: np.ndarray, link) -> None:
        """Fold link's inertia (link frame) into moving body `body`, where
        (R, t) maps link frame -> body frame."""
        if link.mass <= 0.0 and not np.any(link.inertia):
            return
        com_b = R @ link.com + t
        I_com_b = R @ link.inertia @ R.T
        # shift inertia about com to inertia about the body-frame origin
        c = com_b
        shift = link.mass * ((c @ c) * np.eye(3) - np.outer(c, c))
        body_mass[body] += link.mass
        body_first_moment[body] += link.mass * com_b
        body_inertia_origin[body] += I_com_b + shift

    def visit(link_name: str, body: int, R: np.ndarray, t: np.ndarray) -> None:
        """(R, t): transform from moving body `body` frame to `link_name`
        frame (body == -1 means the fixed base frame)."""
        link = urdf.links[link_name]
        if body >= 0:
            add_link_inertia(body, R, t, link)
        sites[link_name] = Site(body=body, pos=t.copy(), quat=_mat_to_quat(R))
        for j in by_parent.get(link_name, []):
            Rj, tj = _compose(R, t, j.origin_rot, j.origin_pos)
            if j.joint_type == "fixed":
                visit(j.child, body, Rj, tj)
            elif j.joint_type in ("revolute", "prismatic", "continuous"):
                dof = len(parent_list)
                parent_list.append(-1 if body < 0 else body_dof_last[body])
                jtype.append(PRISMATIC if j.joint_type == "prismatic" else REVOLUTE)
                jnames.append(j.name)
                tree_pos.append(tj)
                tree_quat.append(_mat_to_quat(Rj))
                # mjcf (and sloppy urdf) axes may be non-unit, e.g. the ant's
                # "-1 1 0" ankles; FK's axis-angle quats require unit axes
                axis.append(np.asarray(j.axis) / np.linalg.norm(j.axis))
                if j.joint_type == "continuous":
                    limits.append((-2 * np.pi, 2 * np.pi, j.effort, j.velocity))
                else:
                    limits.append((j.lower, j.upper, j.effort, j.velocity))
                dyn.append((j.damping, j.friction))
                b = new_body(j.child, body, dof)
                dof_body.append(b)
                body_dof_last.append(dof)
                visit(j.child, b, np.eye(3), np.zeros(3))
            else:
                raise NotImplementedError(f"joint type {j.joint_type}")

    # body_dof_last[b]: the last dof on the path to body b (its driving dof,
    # or dof 5 for the floating base body)
    body_dof_last: list[int] = []
    if floating_base:
        new_body(urdf.root_link, -1, -1)
        body_dof_last.append(5)
        visit(urdf.root_link, 0, np.eye(3), np.zeros(3))
    else:
        visit(urdf.root_link, -1, np.eye(3), np.zeros(3))

    nv = len(parent_list)
    nb = len(bnames)

    mass = np.array(body_mass)
    com = np.stack(
        [fm / m if m > 0 else np.zeros(3) for fm, m in zip(body_first_moment, mass)]
    ) if nb else np.zeros((0, 3))
    inertia = []
    for i in range(nb):
        c = com[i]
        shift = mass[i] * ((c @ c) * np.eye(3) - np.outer(c, c))
        inertia.append(body_inertia_origin[i] - shift)  # back to about-com
    inertia = np.stack(inertia) if nb else np.zeros((0, 3, 3))

    # ancestor_mask[b, u] = 1 iff dof u moves body b: walk the dof chain up
    # from each body's driving dof
    anc = np.zeros((nb, nv))
    for b in range(nb):
        j = body_dof_last[b]
        while j >= 0:
            anc[b, j] = 1.0
            j = parent_list[j]

    lim = np.array(limits) if limits else np.zeros((0, 4))
    dyn_arr = np.array(dyn) if dyn else np.zeros((0, 2))
    armature = np.full(nv, default_armature)
    if floating_base:
        armature[:6] = 0.0  # no phantom mass on the free base

    return Articulation(
        name=urdf.name,
        nv=nv,
        parent=np.array(parent_list, dtype=np.int32),
        joint_type=np.array(jtype, dtype=np.int32),
        joint_names=jnames,
        body_names=bnames,
        ancestor_mask=anc,
        tree_pos=np.stack(tree_pos) if nv else np.zeros((0, 3)),
        tree_quat=np.stack(tree_quat) if nv else np.zeros((0, 4)),
        axis=np.stack(axis) if nv else np.zeros((0, 3)),
        mass=mass,
        com=com,
        inertia=inertia,
        q_min=lim[:, 0],
        q_max=lim[:, 1],
        effort_limit=lim[:, 2],
        velocity_limit=lim[:, 3],
        joint_damping=dyn_arr[:, 0],
        joint_friction=dyn_arr[:, 1],
        armature=armature,
        sites=sites,
        actuated_joint_names=urdf.actuated_joint_names,
        floating=floating_base,
        body_parent=np.array(body_parent, dtype=np.int32),
        body_dof=np.array(body_dof, dtype=np.int32),
        dof_body=np.array(dof_body, dtype=np.int32),
    )
