"""The port's camera sensors (`envs/camera.py`) against the JAX package's,
on inputs from a numpy seed: `render_points` on random clouds that hold
points behind the camera, off the image, beyond max_depth, masked out,
exact duplicates (ties) and per-point colors; `depth_to_points` and
`visible_pointcloud` on the JAX package's render, the latter with its own
uniform scores; and the yaml `cameras` block (`_cameras_from_yaml` and a
composed task), a `fov_x` key raising TypeError in both.

Color is compared in its 8-bit values (`eight_bit`). Pixel rule: float32 projections in the two frameworks round apart, so a
point whose JAX u or v lies within 1e-4 of a pixel edge may land in the
neighbouring pixel. Such points are left out of the visibility check,
and every pixel they may land in (with every point in those pixels) out
of the image checks; each case prints how many points it leaves out.
"""

import dataclasses

import numpy as np
import pytest
import torch

from handarm_tpu_torch.envs import camera as tcam
from handarm_tpu_torch.envs import registry as treg

EDGE = 1e-4
B = 3


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from handarm_tpu.envs import camera as jcam

    return jax, jcam


def _straight(cam_module, **kw):
    return cam_module.CameraConfig(name="test", pos=(0.1, -0.2, 0.9),
                                   quat=(0.9238795, 0.0, 0.3826834, 0.0), fovx_deg=90.0,
                                   width=64, height=48, **kw)


def _quat_rotate(q, v):
    w, u = q[0], np.asarray(q[1:])
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def random_cloud(cfg, rng, P=600):
    """World points [B, P, 3] placed through the camera: most inside the
    image in front (many sharing a pixel at other depths), some off the
    image, behind the camera or past max_depth; the last 40 rows exact
    copies of earlier ones (with their own ids and colors)."""
    fx, fy, cx, cy = tcam._intrinsics(cfg)
    n_pix = 60  # a few pixels hit by many points: occlusion
    pu = rng.integers(0, cfg.width, (B, n_pix)) + rng.uniform(0.05, 0.95, (B, n_pix))
    pv = rng.integers(0, cfg.height, (B, n_pix)) + rng.uniform(0.05, 0.95, (B, n_pix))
    pick = rng.integers(0, n_pix, (B, P))
    shared = rng.uniform(size=(B, P)) < 0.5
    u = np.where(shared, np.take_along_axis(pu, pick, 1),
                 rng.uniform(-8, cfg.width + 8, (B, P)))
    v = np.where(shared, np.take_along_axis(pv, pick, 1),
                 rng.uniform(-8, cfg.height + 8, (B, P)))
    d = rng.uniform(0.3, 2.9, (B, P))
    kind = rng.uniform(size=(B, P))
    d = np.where(kind < 0.05, rng.uniform(-1.0, -0.1, (B, P)), d)  # behind
    d = np.where((kind >= 0.05) & (kind < 0.08), rng.uniform(3.05, 3.5, (B, P)), d)  # too far
    cam = np.stack([d, -(u - cx) / fx * np.abs(d), -(v - cy) / fy * np.abs(d)], -1)
    world = _quat_rotate(np.asarray(cfg.quat), cam) + np.asarray(cfg.pos)
    world[:, -40:] = world[:, rng.integers(0, P - 40, 40)]
    return world.astype(np.float32)


def excluded(cfg, uvz):
    """(points [B, P], pixels [B, H, W]) bool that the pixel rule leaves out,
    given the JAX package's u, v, depth [B, P, 3] of every point."""
    u, v = uvz[..., 0], uvz[..., 1]
    near = lambda x: np.abs(x - np.round(x)) <= EDGE
    edge = near(u) | near(v)
    pix = np.zeros((u.shape[0], cfg.height * cfg.width), bool)
    for b, p in zip(*np.nonzero(edge)):
        for du in (-EDGE, EDGE):
            for dv in (-EDGE, EDGE):
                ui = np.clip(np.trunc(u[b, p] + du), 0, cfg.width - 1)
                vi = np.clip(np.trunc(v[b, p] + dv), 0, cfg.height - 1)
                pix[b, int(vi * cfg.width + ui)] = True
    ui = np.clip(np.trunc(u).astype(np.int64), 0, cfg.width - 1)  # the JAX package's
    vi = np.clip(np.trunc(v).astype(np.int64), 0, cfg.height - 1)  # pixel of each point
    pts = edge | np.take_along_axis(pix, vi * cfg.width + ui, 1)
    return pts, pix.reshape(-1, cfg.height, cfg.width)


def eight_bit(color):
    """A color image's 8-bit channel values. The port scales them by the
    float32 reciprocal of 255, as XLA computes the JAX package's division
    under jit; the package's eager division rounds up to an ulp apart."""
    return np.rint(np.asarray(color, np.float64) * 255.0).astype(np.int64)


CASES = {
    "topview, ids [P], colors [P, 3]": ("topview", "shared", "shared", True),
    "topview, ids [B, P], colors [B, P, 3], no mask": ("topview", "batched", "batched", False),
    "straight, ids [P], no colors": ("straight", "shared", None, True),
    "straight, ids [B, P], colors [P, 3]": ("straight", "batched", "shared", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_points_matches(case):
    """Depth within 1e-6; segmentation (int32 min where no point lands),
    visibility and color equal outside the pixel rule's exclusions; the
    projected u, v of points in front within 1e-3 px and their depth within
    1e-6."""
    jax, jcam = _jax()
    import jax.numpy as jnp

    which, seg_form, rgb_form, masked = CASES[case]
    seed = sorted(CASES).index(case)
    rng = np.random.default_rng(seed)
    jcfg = jcam.CameraConfig() if which == "topview" else _straight(jcam)
    tcfg = tcam.CameraConfig() if which == "topview" else _straight(tcam)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    pts = random_cloud(tcfg, rng)
    P = pts.shape[1]
    seg = rng.choice([1, 3, 4, 5], size=(P,) if seg_form == "shared" else (B, P)).astype(np.int32)
    valid = (rng.uniform(size=(B, P)) < 0.85).astype(np.float32) if masked else None
    rgb = None if rgb_form is None else rng.uniform(
        -0.05, 1.05, (P, 3) if rgb_form == "shared" else (B, P, 3)).astype(np.float32)
    opt = lambda x: None if x is None else jnp.asarray(x)
    want = jcam.render_points(jcfg, jnp.asarray(pts), jnp.asarray(seg), valid=opt(valid),
                              colors=opt(rgb))
    topt = lambda x: None if x is None else torch.as_tensor(x)
    got = tcam.render_points(tcfg, torch.as_tensor(pts), torch.as_tensor(seg),
                             valid=topt(valid), colors=topt(rgb))
    uvz = np.asarray(want.points_uvz)
    u, v, z = uvz[..., 0], uvz[..., 1], uvz[..., 2]
    drop_pts, drop_pix = excluded(tcfg, uvz)
    keep_pix = ~drop_pix
    print(f"{case}: {int(drop_pts.sum())} of {B * P} points and {int(drop_pix.sum())} of "
          f"{drop_pix.size} pixels left out by the pixel rule")
    assert drop_pts.mean() < 0.05
    np.testing.assert_allclose(got.depth.numpy()[keep_pix], np.asarray(want.depth)[keep_pix],
                               atol=1e-6, rtol=0)
    assert got.segmentation.dtype == torch.int32
    gseg, wseg = got.segmentation.numpy(), np.asarray(want.segmentation)
    np.testing.assert_array_equal(gseg[keep_pix], wseg[keep_pix])
    assert (wseg == tcam.INT32_MIN).any() and (wseg == 0).any() and (wseg > 0).any()
    gvis, wvis = got.visible.numpy(), np.asarray(want.visible)
    np.testing.assert_array_equal(gvis[~drop_pts], wvis[~drop_pts])
    assert 0 < wvis.sum() < wvis.size
    front = z > 1e-3
    guvz = got.points_uvz.numpy()
    np.testing.assert_allclose(guvz[..., 2], z, atol=1e-6, rtol=0)
    np.testing.assert_allclose(guvz[front][:, :2], uvz[front][:, :2], atol=1e-3, rtol=0)
    if rgb is None:
        assert got.color is None and want.color is None
    else:
        gcol, wcol = got.color.numpy(), np.asarray(want.color)
        np.testing.assert_array_equal(eight_bit(gcol[keep_pix]), eight_bit(wcol[keep_pix]))
        np.testing.assert_allclose(gcol, wcol, atol=1.2e-7, rtol=0)
        assert (wcol[keep_pix] > 0).any()


def test_empty_pixels_and_ties():
    """A pixel no point reaches holds int32 min (segmentation), max_depth
    and black in both packages; one reached only by an occluded, masked
    or off-image point (clipped to the border) holds 0; two exactly tied
    points are both visible and the pixel takes the larger id and the
    larger packed color, never a blend."""
    jax, jcam = _jax()
    import jax.numpy as jnp

    pts = np.array([[[2.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.5, 0.3, 0.0],
                     [1.0, 5.0, 0.0]]], np.float32)  # far, two ties, masked, off-image
    seg = np.array([7, 3, 4, 9, 6], np.int32)
    valid = np.array([[1, 1, 1, 0, 1]], np.float32)
    rgb = np.array([[0, 1, 0], [1, 0, 0.2], [0, 1, 0.8], [1, 1, 1], [1, 1, 1]], np.float32)
    cfg_j = jcam.CameraConfig(name="t", pos=(0.0, 0.0, 0.0), quat=(1.0, 0.0, 0.0, 0.0),
                              fovx_deg=90.0, width=64, height=64)
    cfg_t = tcam.CameraConfig(**dataclasses.asdict(cfg_j))
    want = jcam.render_points(cfg_j, jnp.asarray(pts), jnp.asarray(seg),
                              valid=jnp.asarray(valid), colors=jnp.asarray(rgb))
    got = tcam.render_points(cfg_t, torch.as_tensor(pts), torch.as_tensor(seg),
                             valid=torch.as_tensor(valid), colors=torch.as_tensor(rgb))
    for g, w in ((got.depth, want.depth), (got.segmentation, want.segmentation),
                 (got.visible, want.visible)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(eight_bit(got.color.numpy()), eight_bit(want.color))
    seg_img = got.segmentation.numpy()[0]
    assert seg_img[32, 32] == 4  # the ties: the larger id
    assert seg_img[0, 0] == tcam.INT32_MIN and got.depth[0, 0, 0] == 3.0
    assert seg_img[32, 0] == 0  # the off-image point's clipped pixel
    assert seg_img[32, 25] == 0  # the masked point's pixel
    assert got.visible.numpy().tolist() == [[0.0, 1.0, 1.0, 0.0, 0.0]]
    q = np.floor(np.clip(rgb[1] * np.float32(255.0), 0, 255))
    assert np.array_equal(eight_bit(got.color.numpy()[0, 32, 32]), q)  # the larger packed color


@pytest.mark.parametrize("stride", (1, 3))
def test_depth_to_points_matches(stride):
    """The JAX package's depth image of a random cloud unprojected by both:
    world points within 1e-5, the mask equal."""
    jax, jcam = _jax()
    import jax.numpy as jnp

    cfg_t = tcam.CameraConfig()
    pts = random_cloud(cfg_t, np.random.default_rng(10 + stride))
    depth = jcam.render_points(jcam.CameraConfig(), jnp.asarray(pts),
                               jnp.ones(pts.shape[1], jnp.int32)).depth
    wpts, wmask = jcam.depth_to_points(jcam.CameraConfig(), depth, stride)
    gpts, gmask = tcam.depth_to_points(cfg_t, torch.as_tensor(np.asarray(depth)), stride)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert np.asarray(wmask).any() and not np.asarray(wmask).all()
    np.testing.assert_allclose(gpts.numpy(), np.asarray(wpts), atol=1e-5, rtol=0)


@pytest.mark.parametrize("P", (90, 128, 600))
def test_visible_pointcloud_matches(P):
    """The JAX package's render of a random cloud, with point types, through
    both `visible_pointcloud`s, the port given the JAX package's uniform
    draw of its key over the padded count: within 1e-6, types exact."""
    jax, jcam = _jax()
    import jax.numpy as jnp

    from handarm_tpu_torch.envs import pointcloud as pc

    rng = np.random.default_rng(P)
    cfg_t = tcam.CameraConfig()
    pts = random_cloud(cfg_t, rng, P)
    types = rng.integers(1, 3, (B, P)).astype(np.float32)
    render = jcam.render_points(jcam.CameraConfig(), jnp.asarray(pts),
                                jnp.ones(P, jnp.int32))
    key = jax.random.PRNGKey(P)
    want = np.asarray(jcam.visible_pointcloud(render, jnp.asarray(pts), jnp.asarray(types),
                                              key, 128))
    scores = torch.as_tensor(np.asarray(jax.random.uniform(key, (B, pc.padded_points(P, 128)))))
    trender = tcam.CameraRender(*(torch.as_tensor(np.asarray(x)) for x in render[:4]))
    got = tcam.visible_pointcloud(trender, torch.as_tensor(pts), torch.as_tensor(types),
                                  scores, 128).numpy()
    assert got.shape == (B, 128, 4)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (want[..., 3] > 0).any()


# the yaml `cameras` block: {name: {pos, quat, width, height, fov_x}}
BLOCKS = {
    "one camera": {"top": {"pos": [0.1, 0.5, 1.2], "quat": [0.0, 0.70710677, 0.0, 0.70710677],
                           "width": 64, "height": 48}},
    "two cameras, defaults": {"side": {"width": 32}, "front": {}},
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_cameras_from_yaml_matches(case):
    """The same CameraConfigs, field by field."""
    _jax()
    import handarm_tpu.envs.registry as jreg

    want = jreg._cameras_from_yaml(BLOCKS[case])
    got = treg._cameras_from_yaml(BLOCKS[case])
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
    assert all(type(c) is tcam.CameraConfig for c in got)


def test_fov_x_raises_in_both(monkeypatch):
    """A `fov_x` key is passed on to CameraConfig as the JAX package passes
    it, whose field is `fovx_deg`: TypeError in both, from the block and
    from a composed task."""
    _jax()
    import handarm_tpu.envs.registry as jreg

    block = {"top": {"fov_x": 60.0}}
    with pytest.raises(TypeError, match="fov_x"):
        jreg._cameras_from_yaml(block)
    with pytest.raises(TypeError, match="fov_x"):
        treg._cameras_from_yaml(block)
    monkeypatch.setattr(jreg, "HandArmEnv", lambda cfg: cfg)
    over = ["env.cameras.top.fov_x=60"]
    with pytest.raises(TypeError):
        jreg.compose_task("Ur5SihMultiObjectManipulation", over)
    with pytest.raises(TypeError):
        treg.resolve_task("Ur5SihMultiObjectManipulation", over)


def test_composed_camera_block_matches(monkeypatch):
    """Ur5SihMultiObjectManipulation with a cameras block from overrides
    composes to equal configs in both packages; the port's env builds with
    it and its five observables are registered, size 0, routed by name."""
    _jax()
    import handarm_tpu.envs.registry as jreg

    monkeypatch.setattr(jreg, "HandArmEnv", lambda cfg: cfg)
    over = ["env.cameras.top.width=64", "env.cameras.top.height=40",
            "env.cameras.top.pos=[0.3, 0.6, 1.4]"]
    jcfg = jreg.compose_task("Ur5SihMultiObjectManipulation", over)[0]
    tcfg = treg.resolve_task("Ur5SihMultiObjectManipulation", over)[0]
    assert [dataclasses.asdict(c) for c in tcfg.cameras] == \
        [dataclasses.asdict(c) for c in jcfg.cameras]
    assert tcfg.cameras[0] == tcam.CameraConfig(name="top", width=64, height=40,
                                                pos=(0.3, 0.6, 1.4))
