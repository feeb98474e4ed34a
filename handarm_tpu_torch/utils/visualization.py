"""Offline debug visualization (counterpart of
handarm_tpu/utils/visualization.py).

Renders env states to matplotlib figures, PNG frames or MP4s on the host
from the scene the physics runs on (robot collision spheres, object
shapes, table, point clouds, goals), and records the cameras' depth,
segmentation and color images per env (`CameraRecorder`). `cv2` and
`matplotlib` are imported inside the functions that draw or write files,
so recording frames needs neither.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from handarm_tpu_torch.envs.camera import render_points
from handarm_tpu_torch.math.quat import quat_rotate
from handarm_tpu_torch.physics.shapes import BOX, MESH_SDF

_BOX_EDGES = [
    (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
    (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _draw_box(ax, pos, quat, half, color):
    """Wireframe of an oriented box (world pose pos, quat; half-extents)."""
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                     np.float32)
    corners = _np(quat_rotate(torch.as_tensor(np.asarray(quat, np.float32))[None],
                              torch.as_tensor(signs * np.asarray(half, np.float32)[None]))) \
        + np.asarray(pos)[None]
    for a, b in _BOX_EDGES:
        ax.plot(*zip(corners[a], corners[b]), c=color, lw=1.0)


def _scene_artists(ax, env, state, env_idx: int, scale: float = 1.0):
    from handarm_tpu_torch.physics.kinematics import forward_kinematics, site_poses

    scene = env.scene
    lo, hi = _np(scene.geom.table_lo), _np(scene.geom.table_hi)
    th = float(scene.geom.table_height)
    ax.plot([lo[0], hi[0], hi[0], lo[0], lo[0]], [lo[1], lo[1], hi[1], hi[1], lo[1]],
            [th] * 5, "k-", lw=0.5)
    fk = forward_kinematics(scene.model, state.physics.robot.q[env_idx:env_idx + 1],
                            scene.base_quat[None], scene.base_pos[None])
    body = torch.as_tensor(scene.spheres.body, device=fk.body_pos.device)
    centers = fk.body_pos[:, body] + quat_rotate(fk.body_quat[:, body],
                                                 scene.spheres.offset[None])
    c, r = _np(centers[0]), _np(scene.spheres.radius)
    ax.scatter(c[:, 0], c[:, 1], c[:, 2], s=(r * 300 * scale) ** 2, c="tab:blue", alpha=0.4,
               label="robot")
    sites = getattr(env, "fingertip_sites", None)
    if sites is not None:
        _, tp = site_poses(fk, *sites, base_quat=scene.base_quat[None],
                           base_pos=scene.base_pos[None])
        tp = _np(tp[0])
        ax.scatter(tp[:, 0], tp[:, 1], tp[:, 2], s=25 * scale ** 2, c="tab:red", marker="^",
                   label="tips")
    op = _np(state.physics.objects.pos[env_idx])
    oq = _np(state.physics.objects.quat[env_idx])
    size, kind = _np(scene.shapes.size), np.asarray(scene.shapes.kind)
    tgt = int(state.task.target_obj[env_idx])
    for k in range(op.shape[0]):
        col = "tab:green" if k == tgt else "tab:orange"
        ax.scatter(*op[k], s=40, c=col, marker="s")
        if kind[k] in (BOX, MESH_SDF):  # a box, or a mesh's OBB: a wireframe
            _draw_box(ax, op[k], oq[k], size[k], col)
    gp = _np(state.task.goal_pos[env_idx])
    ax.scatter(*gp, s=150, c="tab:red", marker="*", label="goal")


def render_state(env, state, env_idx: int = 0, path: str | None = None,
                 elev: float = 25, azim: float = -60, center=None,
                 extent: float | None = None):
    """One env's state as a matplotlib 3D figure (returned; saved as a PNG
    with `path`). `center` and `extent` zoom the view to center +- extent;
    `center="object"` tracks the target object."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    if isinstance(center, str) and center == "object":
        tgt = int(state.task.target_obj[env_idx])
        center = _np(state.physics.objects.pos[env_idx, tgt])
    scale = 1.0 if extent is None else min(3.0, 0.45 / extent)
    _scene_artists(ax, env, state, env_idx, scale=scale)
    if center is None:
        ax.set_xlim(-0.3, 0.9)
        ax.set_ylim(0.0, 1.2)
        ax.set_zlim(0.0, 1.2)
    else:
        e = extent or 0.25
        ax.set_xlim(center[0] - e, center[0] + e)
        ax.set_ylim(center[1] - e, center[1] + e)
        ax.set_zlim(center[2] - e, center[2] + e)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=110)
    return fig


def render_pointcloud(cloud, path: str | None = None):
    """Scatter an [N, 4] cloud, coloured by PointType."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cloud = _np(cloud)
    valid = cloud[:, 3] > 0
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    for t, col in {1.0: "tab:gray", 2.0: "tab:green", 3.0: "tab:red"}.items():
        sel = valid & (cloud[:, 3] == t)
        if sel.any():
            ax.scatter(cloud[sel, 0], cloud[sel, 1], cloud[sel, 2], s=4, c=col)
    if path:
        fig.savefig(path, dpi=110)
    return fig


class CameraRecorder:
    """Per-env MP4s of the cameras: buffers each recorded env's depth,
    segmentation and color frames (HxWx3 uint8) and, when that env's
    episode ends, writes `<out_dir>/{cam}_{type}_env_{i}_episode_{n}.mp4`
    (cv2; a PNG strip without it) and clears its buffers.

    Renders the whole batch through `render_points`, as the camera
    observables do, and keeps `env_ids`. Depth maps to gray over
    `depth_range`, segmentation ids through a fixed colour table."""

    # 0 background, 1 robot, 3 + k objects
    _SEG_COLORS = np.array([
        [0, 0, 0], [180, 180, 180], [80, 80, 80], [31, 119, 180],
        [255, 127, 14], [44, 160, 44], [214, 39, 40], [148, 103, 189],
        [140, 86, 75], [227, 119, 194], [127, 127, 127], [188, 189, 34],
    ], dtype=np.uint8)

    def __init__(self, env, out_dir: str, env_ids=(0,), depth_range: tuple = (0.0, 2.5)):
        cams = tuple(env.cfg.cameras)
        if not cams:
            raise ValueError("CameraRecorder needs an env built with cfg.cameras "
                             "(a yaml `cameras:` block)")
        self.env, self.cams, self.out_dir = env, cams, out_dir
        self.env_ids = tuple(int(i) for i in env_ids)
        self.depth_range = depth_range
        self.episode_count = {i: 0 for i in self.env_ids}
        # frames[cam][type][env_id] -> list of HxWx3 uint8
        self.frames = {c.name: {t: {i: [] for i in self.env_ids}
                                for t in ("depth", "segmentation", "color")}
                       for c in cams}

    def _render(self, state) -> dict:
        """{camera: (depth, segmentation, color)} of the recorded envs, on
        the host."""
        from handarm_tpu_torch.envs.hand_arm import ObsContext

        pts, segs, _ = ObsContext(self.env, state).camera_scene_points()
        idx = torch.as_tensor(self.env_ids, device=pts.device)
        out = {}
        for cam in self.cams:
            r = render_points(cam, pts, segs.to(torch.int32), valid=segs,
                              colors=self.env.scene_point_rgb)
            out[cam.name] = tuple(_np(x.index_select(0, idx))
                                  for x in (r.depth, r.segmentation, r.color))
        return out

    def _depth_to_rgb(self, d: np.ndarray) -> np.ndarray:
        lo, hi = self.depth_range
        g8 = (np.clip((d - lo) / (hi - lo), 0.0, 1.0) * 255).astype(np.uint8)
        return np.stack([g8] * 3, axis=-1)

    def _seg_to_rgb(self, s: np.ndarray) -> np.ndarray:
        return self._SEG_COLORS[np.clip(s, 0, len(self._SEG_COLORS) - 1)]

    def add(self, state, done=None) -> list[str]:
        """Append this step's frames of the recorded envs; with `done`
        ([B] bool), write and clear the buffers of those whose episode
        ended. Returns the paths written."""
        rendered = self._render(state)
        for cam in self.cams:
            depth, seg, color = rendered[cam.name]
            frames = self.frames[cam.name]
            for j, i in enumerate(self.env_ids):
                frames["depth"][i].append(self._depth_to_rgb(depth[j]))
                frames["segmentation"][i].append(self._seg_to_rgb(seg[j]))
                frames["color"][i].append((color[j] * 255).astype(np.uint8))
        written: list[str] = []
        if done is not None:
            done = _np(done)
            for i in self.env_ids:
                if done[i]:
                    written.extend(self.flush(i))
        return written

    def flush(self, env_id: int) -> list[str]:
        """Write and clear env_id's frames: one MP4 per camera and image
        type, named as the reference's recordings."""
        self.episode_count[env_id] += 1
        n = self.episode_count[env_id]
        fps = 1.0 / (self.env.cfg.dt * self.env.cfg.control_freq_inv)
        os.makedirs(self.out_dir, exist_ok=True)
        paths = []
        for cam in self.cams:
            for typ in ("depth", "segmentation", "color"):
                frames = self.frames[cam.name][typ][env_id]
                if not frames:
                    continue
                path = os.path.join(self.out_dir,
                                    f"{cam.name}_{typ}_env_{env_id}_episode_{n}.mp4")
                _write_video(frames, path, fps)
                paths.append(path)
                self.frames[cam.name][typ][env_id] = []
        return paths


def _write_video(frames: list[np.ndarray], path: str, fps: float) -> None:
    """An MP4 of HxWx3 uint8 RGB frames (cv2), or without cv2 a strip of
    PNGs `<path less .mp4>_0000.png`, ..."""
    try:
        import cv2
    except ImportError:
        import matplotlib.pyplot as plt

        base = os.path.splitext(path)[0]
        for i, f in enumerate(frames):
            plt.imsave(f"{base}_{i:04d}.png", f)
        return
    h, w, _ = frames[0].shape
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        vw.release()


class EpisodeRecorder:
    """Frames of one env's `render_state`, every `every`-th step, written
    as an MP4 (cv2) or a PNG strip."""

    def __init__(self, env, out_path: str, env_idx: int = 0, every: int = 1):
        self.env, self.out_path = env, out_path
        self.env_idx, self.every = env_idx, every
        self.frames: list[np.ndarray] = []
        self._i = 0

    def add(self, state) -> None:
        if self._i % self.every == 0:
            import matplotlib.pyplot as plt

            fig = render_state(self.env, state, self.env_idx)
            fig.canvas.draw()
            self.frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
            plt.close(fig)
        self._i += 1

    def save(self, fps: int = 20) -> str:
        os.makedirs(os.path.dirname(self.out_path) or ".", exist_ok=True)
        _write_video(self.frames, self.out_path, fps)
        return self.out_path
