"""The XLA BVH path (bvh/traverse.py + the wavefront's BVH branch) against
brute force on whole scenes: closest and any-hit queries, renders under
every light-sampling and MIS mode and with textures, and path-replay
gradients against finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuspectral_tpu.bsdf import table as bt
from gpuspectral_tpu.bvh import build as bvh_build
from gpuspectral_tpu.bvh.traverse import intersect_any_bvh, intersect_closest_bvh
from gpuspectral_tpu.integrator.path_tracer import render_image_stats, render_sample
from gpuspectral_tpu.ops.intersect import intersect_any, intersect_closest
from gpuspectral_tpu.scene import load_mitsuba_scene
from gpuspectral_tpu.scene.data import TEX_RES, SceneBuilder
from gpuspectral_tpu.scene.obj import make_cube, make_rectangle
from gpuspectral_tpu.utils import RenderConfig

from conftest import CORNELL_XML


def _slot_mode(build):
    """Run a scene build with slot mode forced (the subtree-cut leaf layout
    with -1 padding slots that BVH-scale scenes get)."""
    old = bvh_build.SLOT_DENSE_THRESHOLD
    bvh_build.SLOT_DENSE_THRESHOLD = 8
    try:
        return build()
    finally:
        bvh_build.SLOT_DENSE_THRESHOLD = old


def _floor_and_light(b, mat, light_y=3.0, tiles=4):
    """A floor of tiles x tiles rectangles (each with the full uv square)
    and an area light above it."""
    pos, nrm, uv = make_rectangle()
    s = 2.0 / tiles
    for i in range(tiles):
        for j in range(tiles):
            x, z = -2.0 + s * (2 * i + 1), -2.0 + s * (2 * j + 1)
            floor = np.array([[s, 0, 0, x], [0, 0, s, -1], [0, -1, 0, z], [0, 0, 0, 1]],
                             np.float32)
            b.add_object(pos, nrm, uv, floor, mat, twofaced=True)
    light = b.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    lxf = np.array([[1, 0, 0, 0], [0, 0, -1, light_y], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, lxf, light, emission=(10.0, 10.0, 10.0))
    b.set_camera(np.array([[-1, 0, 0, 0], [0, 1, 0, 1.2], [0, 0, -1, 4], [0, 0, 0, 1]],
                          np.float32), np.deg2rad(60))
    return light


def _textured_scene():
    b = SceneBuilder()
    u = (np.arange(TEX_RES, dtype=np.float32) + 0.5) / TEX_RES
    grad_tex = np.broadcast_to(u[None, :, None], (TEX_RES, TEX_RES, 3)).copy()
    mat = b.add_bsdf(bt.diffuse((0.7, 0.5, 0.4)), texture=grad_tex)
    _floor_and_light(b, mat)
    return b.build()


def _mixed_scene():
    """Diffuse floor, a perfect-mirror cube and an area light."""
    b = SceneBuilder()
    kd = b.add_bsdf(bt.diffuse((0.6, 0.4, 0.3)))
    mirror = b.add_bsdf(bt.smooth_conductor(0.0))
    cpos, cnrm, cuv = make_cube()
    boxxf = np.array([[0.5, 0, 0, -0.5], [0, 0.5, 0, -0.49], [0, 0, 0.5, 0], [0, 0, 0, 1]],
                     np.float32)
    b.add_object(cpos, cnrm, cuv, boxxf, mirror)
    _floor_and_light(b, kd, light_y=2.5)
    return b.build()


def _uv_sphere(lat=12, lon=24):
    th = np.linspace(0.0, np.pi, lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, lon + 1)
    p = np.stack([np.sin(th)[:, None] * np.cos(ph)[None], np.cos(th)[:, None] + 0 * ph[None],
                  np.sin(th)[:, None] * np.sin(ph)[None]], -1)
    tris = []
    for i in range(lat):
        for j in range(lon):
            a, b_, c, d = p[i, j], p[i + 1, j], p[i + 1, j + 1], p[i, j + 1]
            tris += [[a, c, b_], [a, d, c]]
    pos = np.asarray(tris, np.float32)
    return pos, pos / np.linalg.norm(pos, axis=-1, keepdims=True)


def _sphere_scene():
    """Glass and rough-conductor spheres on a diffuse floor."""
    b = SceneBuilder()
    kd = b.add_bsdf(bt.diffuse((0.5, 0.5, 0.5)))
    glass = b.add_bsdf(bt.smooth_dielectric(1.5))
    metal = b.add_bsdf(bt.rough_conductor((1.66, 0.88, 0.52), (9.2, 6.3, 4.8), (1, 1, 1), 0.2))
    spos, snrm = _uv_sphere()
    for mat, x in ((glass, -0.6), (metal, 0.6)):
        xf = np.array([[0.45, 0, 0, x], [0, 0.45, 0, -0.5], [0, 0, 0.45, 0], [0, 0, 0, 1]],
                      np.float32)
        b.add_object(spos, snrm, None, xf, mat)
    _floor_and_light(b, kd)
    return b.build()


_SCENES = {
    "cornell": lambda: load_mitsuba_scene(str(CORNELL_XML))[0],
    "cornell_slot_mode": lambda: _slot_mode(lambda: load_mitsuba_scene(str(CORNELL_XML))[0]),
    "textured": lambda: _slot_mode(_textured_scene),
    "spheres": _sphere_scene,
}
_cache = {}


def _scene(name):
    if name not in _cache:
        _cache[name] = _SCENES[name]()
    return _cache[name]


def _rays(scene, n=384, seed=0):
    """Rays from random points inside the scene box in random directions."""
    rs = np.random.default_rng(seed)
    pos = np.asarray(scene.tri_pos)[: scene.num_tris].reshape(-1, 3)
    lo, hi = pos.min(0), pos.max(0)
    o = rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _bvh_args(scene):
    return (scene.tri_pos, scene.bvh_node_min, scene.bvh_node_max, scene.bvh_clusters,
            scene.bvh_leaf_size, scene.bvh_levels)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(_SCENES))
def test_traverse_closest_matches_brute(name, masked):
    scene = _scene(name)
    o, d = _rays(scene)
    active = (jnp.arange(o.shape[0]) % 3 != 0) if masked else None
    t_b, prim_b, u_b, _ = intersect_closest(o, d, scene.tri_pos, active=active, tri_chunk=128)
    t, prim, u, _ = intersect_closest_bvh(o, d, *_bvh_args(scene), active=active,
                                          packet_size=128)
    hit, hit_b = np.asarray(prim) >= 0, np.asarray(prim_b) >= 0
    np.testing.assert_array_equal(hit, hit_b)
    assert hit.mean() > 0.1  # the rays really meet geometry
    if masked:
        assert not hit[~np.asarray(active)].any()
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(t_b)[hit], rtol=1e-5)
    same = np.asarray(prim)[hit] == np.asarray(prim_b)[hit]
    assert same.mean() > 0.99  # shared-edge ties may pick either triangle
    np.testing.assert_allclose(np.asarray(u)[hit][same], np.asarray(u_b)[hit][same],
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(_SCENES))
def test_traverse_any_matches_brute(name, masked):
    scene = _scene(name)
    o, d = _rays(scene, seed=1)
    t_max = jnp.asarray(np.random.default_rng(2).uniform(0.2, 3.0, o.shape[0]), jnp.float32)
    active = (jnp.arange(o.shape[0]) % 4 != 1) if masked else None
    occ_b = intersect_any(o, d, scene.tri_pos, 1e-3, t_max, active=active, tri_chunk=128)
    occ = intersect_any_bvh(o, d, *_bvh_args(scene), t_min=1e-3, t_max=t_max,
                            active=active, packet_size=128)
    occ, occ_b = np.asarray(occ), np.asarray(occ_b)
    assert 0.05 < occ_b.mean() < 0.95
    np.testing.assert_array_equal(occ, occ_b)
    if masked:
        assert not occ[~np.asarray(active)].any()


@pytest.mark.parametrize("name,variant", [
    ("cornell", dict(light_sampling="power")),
    ("cornell_slot_mode", dict(mis_mode="exact")),
    ("spheres", dict(light_sampling="power", mis_mode="exact")),
    ("textured", {}),
])
def test_bvh_render_matches_brute(name, variant):
    """Same draws, same estimator: BVH and brute-force renders agree except
    where a shared-edge hit tie breaks differently (both are valid hits)."""
    scene = _scene(name)
    cfg = RenderConfig(width=24, height=24, spp=2, max_depth=4, ray_batch=576,
                       intersector="mt", tri_chunk=128, **variant)
    ref = np.asarray(render_image_stats(scene, cfg, jnp.uint32(0))[0])
    got = np.asarray(render_image_stats(scene, cfg.replace(use_bvh=True, packet_size=576),
                                        jnp.uint32(0))[0])
    assert np.isfinite(got).all() and got.max() > 0
    d = np.abs(got - ref).max(-1)
    assert (d > 1e-4).sum() <= 6, (d > 1e-4).sum()
    assert abs(got.mean() - ref.mean()) < 2e-3 * max(1.0, ref.mean())


def _fd_check(scene, cfg, row, channels, eps, rtol):
    """d loss / d bsdf_params[row, c] by path-replay AD vs central finite
    differences of the same (non-differentiable) forward."""
    n = cfg.width * cfg.height
    pix = jnp.arange(n, dtype=jnp.uint32)
    w = jnp.arange(3.0)

    def loss(bp, differentiable):
        sc = scene.replace(bsdf_params=bp)
        acc = sum(render_sample(sc, cfg, pix, jnp.uint32(s), differentiable=differentiable)[0]
                  for s in range(cfg.spp))
        return jnp.sum(acc * w) / cfg.spp

    bp0 = scene.bsdf_params
    g = np.asarray(jax.grad(lambda bp: loss(bp, True))(bp0))
    for c in channels:
        e = jnp.zeros_like(bp0).at[row, c].set(1.0)
        fd = (float(loss(bp0 + eps * e, False)) - float(loss(bp0 - eps * e, False))) / (2 * eps)
        assert abs(g[row, c] - fd) < rtol * max(abs(fd), 1e-3), (c, g[row, c], fd)


@pytest.mark.parametrize("name", ["mixed", "textured"])
def test_bvh_grads_match_finite_differences(name):
    """The diffuse albedo gradient through the BVH wavefront (traversal on
    constants, hit gradients from the re-test) matches finite differences;
    the loss is multilinear in kd, so a large eps keeps the central
    difference near-exact while beating f32 loss quantization."""
    if name == "mixed":
        scene = _slot_mode(_mixed_scene)
        row = int(np.argmax(np.asarray(scene.bsdf_kind) == bt.BSDF_DIFFUSE))
    else:
        scene = _scene("textured")
        row = 0
    assert scene.num_tris > 8  # slot mode: several leaves
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=4, ray_batch=256,
                       use_bvh=True, packet_size=256)
    _fd_check(scene, cfg, row, channels=(1, 2), eps=0.05, rtol=5e-2)
