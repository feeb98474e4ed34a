"""Quadcopter hover task (counterpart of handarm_tpu/envs/quadcopter.py;
reference IsaacGymEnvs tasks/quadcopter.py).

The craft is the reference's procedural MJCF (a free chassis and 4 rotor
arms, each with a pitch and a roll hinge: nv = 6 + 8), compiled with a
floating base and flown by per-rotor thrusts along each rotor's local +z.
The thrusts reach the engine as a generalized torque (`RobotState.tau_ext`,
set before the sim step and cleared after it):
tau_u = sum_b 1[u ancestor of b] s_u . (p_b x f_b, f_b).

The env holds its state on one device and draws from its own
torch.Generator, seeded by `reset(seed)`; `reset` and `step` take
`QuadDraws` in place of those draws (a test hands over the JAX package's).
The MJCF is parsed from memory, so concurrent processes share no file.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch import resolve_device
from handarm_tpu_torch.envs.hand_arm import _where_done, tree_map
from handarm_tpu_torch.math.quat import cross, quat_rotate, quat_to_matrix
from handarm_tpu_torch.physics.contacts import RobotSpheres, StaticGeom
from handarm_tpu_torch.physics.engine import (
    PhysicsState,
    SimParams,
    build_scene,
    initial_state,
    step as engine_step,
)
from handarm_tpu_torch.physics.kinematics import forward_kinematics
from handarm_tpu_torch.physics.mjcf import parse_mjcf_string
from handarm_tpu_torch.physics.model import compile_model
from handarm_tpu_torch.physics.shapes import stack_objects
from handarm_tpu_torch.physics.solver import SolverParams


def _quad_mjcf() -> str:
    """The reference's procedural quadcopter (quadcopter.py:121-202)."""
    cr, ct = 0.1, 0.03  # chassis radius/thickness
    rr, rt = 0.04, 0.01  # rotor radius/thickness
    rar = 0.01  # rotor arm radius
    arm_off = cr + 0.25 * rar
    rot_off = rr + 0.25 * rar
    bodies = []
    for i, ang in enumerate([0.25, 0.75, 1.25, 1.75]):
        a = ang * math.pi
        c, s = math.cos(a / 2), math.sin(a / 2)
        px, py = math.cos(a) * arm_off, math.sin(a) * arm_off
        bodies.append(f"""
        <body name="rotor_arm{i}" pos="{px:g} {py:g} 0" quat="{c:g} 0 0 {s:g}">
          <geom type="sphere" size="{rar:g}" density="200"/>
          <joint name="rotor_pitch{i}" type="hinge" pos="0 0 0" axis="0 1 0"
                 limited="true" range="-30 30"/>
          <body name="rotor{i}" pos="{rot_off:g} 0 0">
            <geom type="cylinder" size="{rr:g} {0.5 * rt:g}" density="1000"/>
            <joint name="rotor_roll{i}" type="hinge" pos="0 0 0" axis="1 0 0"
                   limited="true" range="-30 30"/>
          </body>
        </body>""")
    return f"""
    <mujoco model="Quadcopter">
      <compiler angle="degree" coordinate="local" inertiafromgeom="true"/>
      <worldbody>
        <body name="chassis" pos="0 0 0">
          <geom type="cylinder" size="{cr:g} {0.5 * ct:g}" density="50"/>
          <joint name="root_joint" type="free"/>
          {''.join(bodies)}
        </body>
      </worldbody>
    </mujoco>"""


@dataclass(frozen=True)
class QuadcopterConfig:
    num_envs: int = 256
    episode_length: int = 500
    dt: float = 1.0 / 60.0
    substeps: int = 2
    max_thrust: float = 2.0
    dof_speed_scale: float = 8.0 * np.pi
    thrust_speed_scale: float = 200.0


class QuadState(NamedTuple):
    """The JAX package's QuadState without its PRNG key (the env draws from
    its generator; a checkpoint writes the key leaf as the JAX file has it)."""

    physics: PhysicsState
    targets: torch.Tensor  # [B, nv]
    thrusts: torch.Tensor  # [B, 4]
    progress: torch.Tensor  # [B] int64


class QuadDraws(NamedTuple):
    """The draws of fresh episodes: `root` [B, 3] in [-1, 1) places the
    base, `dof` [B, nv] in [-0.2, 0.2) the joints (columns 0-5 unused)."""

    root: torch.Tensor
    dof: torch.Tensor


class ClassicStepResult(NamedTuple):
    obs: torch.Tensor  # [B, num_obs]
    reward: torch.Tensor  # [B]
    done: torch.Tensor  # [B] bool
    info: dict
    teacher_obs: torch.Tensor  # [B, 0]


def ground_geom(device) -> StaticGeom:
    """The ground plane: a table top at z = 0 over the whole field."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return StaticGeom(table_lo=f32([-1e4, -1e4]), table_hi=f32([1e4, 1e4]), table_height=0.0)


def mjcf_scene(urdf, extras, kp, kd, params: SimParams, device, objects=()):
    """(Articulation, Scene) of a parsed floating-base MJCF model over the
    ground plane: its collision spheres in their bodies' frames (friction
    1) and `objects` (make_*_object dicts)."""
    art = compile_model(urdf, floating_base=True, default_density=1000.0)
    bodies, offs, rads = [], [], []
    for bname, sph in extras.link_spheres.items():
        site = art.sites[bname]
        if site.body < 0:
            continue
        Rl = quat_to_matrix(torch.as_tensor(site.quat, dtype=torch.float32)).numpy()
        for pos, r in sph:
            bodies.append(site.body)
            offs.append(Rl @ np.asarray(pos) + site.pos)
            rads.append(r)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    spheres = RobotSpheres(body=np.asarray(bodies, np.int32), offset=f32(offs),
                           radius=f32(rads), friction=np.full(len(rads), 1.0, np.float32))
    scene = build_scene(art, stack_objects(list(objects), device=device), spheres,
                        ground_geom(device), kp=kp, kd=kd, params=params, device=device)
    return art, scene


def craft_scene(xml: str, kp, kd, params: SimParams, device):
    """(Articulation, Scene) of a floating-base craft over the ground plane:
    the MJCF's collision spheres in their bodies' frames, no objects."""
    return mjcf_scene(*parse_mjcf_string(xml), kp, kd, params, device)


def thrust_torque(scene, phys: PhysicsState, rotor_bodies: np.ndarray, f_local):
    """Generalized torque [B, nv] of forces f_local [B, R, 3], each in its
    rotor body's frame at the body's origin."""
    m = scene.model
    rob = phys.robot
    fk = forward_kinematics(m, rob.q, rob.base_quat, rob.base_pos)
    rb = torch.as_tensor(rotor_bodies.astype(np.int64), device=rob.q.device)
    f_w = quat_rotate(fk.body_quat[:, rb], f_local)
    p = fk.body_pos[:, rb]
    spat = torch.cat([cross(p, f_w), f_w], -1)  # [B, R, 6]
    anc = m.ancestor_mask[rb]  # [R, nv]
    return torch.einsum("bua,bka,ku->bu", fk.screw, spat, anc)


def base_velocity(rob):
    """(v, w): the base point's world velocity and the angular velocity."""
    w = rob.qd[:, 3:6]
    return rob.qd[:, 0:3] + cross(w, rob.base_pos), w


def where_done(done, fresh, cur):
    """Per env: the fresh state where done, else the current one."""
    return tree_map(lambda f, c: _where_done(done, f, c), fresh, cur)


def up_z(base_quat):
    """The world z of the base's up axis."""
    up = torch.zeros(base_quat.shape[0], 3, dtype=base_quat.dtype, device=base_quat.device)
    up[:, 2] = 1.0
    return quat_rotate(base_quat, up)[:, 2]


def grounded_physics(env, B: int, seed: int = 0, height: float = 0.0) -> PhysicsState:
    """A physics state of `B` craft about to land: the base `height` m above
    the height where its lowest collision sphere touches the ground, tilted
    10-30 degrees about a random horizontal axis (its xy in +-1.5 m), the
    joints at random angles in [-0.2, 0.2] rad clipped to their limits,
    falling at 0.5 m/s with no spin. The classic tasks' episodes end before
    the craft reach the ground, so their rollouts bring no contact slot
    into play; this state does within a sim step or two."""
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    sc, art = env.scene, env.art
    axis = torch.nn.functional.pad(torch.nn.functional.normalize(u(B, 2) - 0.5, dim=-1), (0, 1))
    half = torch.deg2rad(10.0 + 20.0 * u(B)) / 2.0
    quat = torch.cat([torch.cos(half)[:, None], torch.sin(half)[:, None] * axis], -1)
    lo = torch.as_tensor(np.maximum(art.q_min, -0.2), dtype=torch.float32, device=dev)
    hi = torch.as_tensor(np.minimum(art.q_max, 0.2), dtype=torch.float32, device=dev)
    q = lo + (hi - lo) * u(B, art.nv)
    q[:, :6] = 0.0
    # the lowest sphere's height below the base, at these angles
    probe = initial_state(sc, B, q0=q, base_quat0=quat)
    fk = forward_kinematics(sc.model, q, quat, probe.robot.base_pos)
    sb = torch.as_tensor(sc.spheres.body.astype(np.int64), device=dev)
    centers = fk.body_pos[:, sb] + quat_rotate(fk.body_quat[:, sb],
                                               sc.spheres.offset[None].expand(B, -1, 3))
    drop = (centers[..., 2] - sc.spheres.radius[None]).amin(-1)  # <= 0
    base = torch.stack([(u(B) - 0.5) * 3.0, (u(B) - 0.5) * 3.0, height - drop], -1)
    phys = initial_state(sc, B, q0=q, base_pos0=base, base_quat0=quat)
    qd = phys.robot.qd.clone()
    qd[:, 2] = -0.5  # no spin: the origin-Plücker velocity is the point velocity
    return phys._replace(robot=phys.robot._replace(qd=qd))


class QuadcopterEnv:
    state_type = QuadState

    def __init__(self, cfg: QuadcopterConfig = QuadcopterConfig(), device=None, group=None):
        """`group` is accepted for the train entry point's ranks: the env has
        no state shared across envs, so nothing of it is reduced."""
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        kp = np.zeros(14)
        kp[6:] = 1000.0  # reference dof props (quadcopter.py:246-248)
        self.art, self.scene = craft_scene(
            _quad_mjcf(), kp=kp, kd=np.zeros(14),
            params=SimParams(dt=cfg.dt, substeps=cfg.substeps,
                             solver=SolverParams(iterations=4),
                             max_base_angvel=4 * np.pi),  # asset max_angular_velocity
            device=dev)
        art = self.art
        self.q_lo = torch.as_tensor(art.q_min, dtype=torch.float32, device=dev)
        self.q_hi = torch.as_tensor(art.q_max, dtype=torch.float32, device=dev)
        self.rotor_bodies = np.array([art.sites[f"rotor{i}"].body for i in range(4)], np.int32)
        self.num_actions = 12  # 8 dof targets + 4 thrusts
        self.num_obs = 21
        self.num_teacher_obs = 0
        self.obs_slices = {"obs": (0, self.num_obs)}
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(0)

    def draw(self, B: int) -> QuadDraws:
        u = lambda *s: torch.rand(s, generator=self.gen, device=self.device)
        return QuadDraws(root=u(B, 3) * 2.0 - 1.0, dof=u(B, self.art.nv) * 0.4 - 0.2)

    def _fresh(self, B: int, draws: QuadDraws | None = None) -> QuadState:
        d = draws if draws is not None else self.draw(B)
        u = d.root
        base = torch.stack([u[:, 0] * 1.5, u[:, 1] * 1.5, 1.0 + u[:, 2] * 0.85 + 0.65], -1)
        q0 = torch.cat([torch.zeros_like(d.dof[:, :6]), d.dof[:, 6:]], -1)
        phys = initial_state(self.scene, B, q0=q0)
        phys = phys._replace(robot=phys.robot._replace(base_pos=base, targets=q0))
        return QuadState(physics=phys, targets=q0,
                         thrusts=torch.zeros(B, 4, device=self.device),
                         progress=torch.zeros(B, dtype=torch.int64, device=self.device))

    def reset(self, seed: int = 0, draws: QuadDraws | None = None):
        """(state, obs) of cfg.num_envs fresh episodes, the generator seeded
        with `seed`."""
        self.gen.manual_seed(seed)
        s = self._fresh(self.cfg.num_envs, draws)
        return s, self._obs(s)

    def _obs(self, s: QuadState):
        rob = s.physics.robot
        target = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        v, w = base_velocity(rob)
        dof_pos = 2.0 * (rob.q[:, 6:] - self.q_lo[6:]) / (self.q_hi[6:] - self.q_lo[6:]) - 1.0
        return torch.cat([(target[None] - rob.base_pos) / 3.0, rob.base_quat, v / 2.0,
                          w / np.pi, dof_pos], -1)

    def _thrust_tau(self, phys: PhysicsState, thrusts):
        f_local = torch.cat([thrusts.new_zeros(thrusts.shape + (2,)), thrusts[..., None]], -1)
        return thrust_torque(self.scene, phys, self.rotor_bodies, f_local)

    def step(self, state: QuadState, actions, draws: QuadDraws | None = None):
        """(new state, ClassicStepResult); `draws` replace the generator's
        draws of the episodes that restart."""
        cfg = self.cfg
        B = actions.shape[0]
        actions = torch.clamp(actions, -1.0, 1.0)
        targets = state.targets + torch.cat(
            [torch.zeros_like(actions[:, :6]), cfg.dt * cfg.dof_speed_scale * actions[:, :8]], -1)
        targets = torch.minimum(torch.maximum(targets, self.q_lo[None]), self.q_hi[None])
        thrusts = torch.clamp(state.thrusts + cfg.dt * cfg.thrust_speed_scale * actions[:, 8:],
                              0.0, cfg.max_thrust)
        tau = self._thrust_tau(state.physics, thrusts)
        phys = state.physics._replace(
            robot=state.physics.robot._replace(targets=targets, tau_ext=tau))
        phys, _ = engine_step(self.scene, phys)
        phys = phys._replace(robot=phys.robot._replace(tau_ext=None))

        progress = state.progress + 1
        p = phys.robot.base_pos
        target_dist = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2 + (1.0 - p[:, 2]) ** 2)
        pos_reward = 1.0 / (1.0 + target_dist ** 2)
        up_reward = 1.0 / (1.0 + (1.0 - up_z(phys.robot.base_quat)) ** 2)
        spin = torch.abs(phys.robot.qd[:, 5])
        spin_reward = 1.0 / (1.0 + spin ** 2)
        reward = pos_reward + pos_reward * (up_reward + spin_reward)

        finite = (torch.isfinite(phys.robot.q).all(-1) & torch.isfinite(p).all(-1))
        done = ((progress >= cfg.episode_length) | (target_dist > 3.0) | (p[:, 2] < 0.1)
                | ~finite)
        reward = torch.where(torch.isfinite(reward), reward, torch.zeros_like(reward))

        mid = QuadState(physics=phys, targets=targets, thrusts=thrusts, progress=progress)
        new_state = where_done(done, self._fresh(B, draws), mid)
        obs = self._obs(new_state)
        obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
        return new_state, ClassicStepResult(
            obs=obs, reward=reward, done=done, info={"target_dist": target_dist.mean()},
            teacher_obs=obs.new_zeros(B, 0))


def make_quadcopter(num_envs=256, episode_length=500, device=None, **kw) -> QuadcopterEnv:
    return QuadcopterEnv(QuadcopterConfig(num_envs=num_envs, episode_length=episode_length,
                                          **kw), device)
