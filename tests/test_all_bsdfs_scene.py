"""End-to-end scene exercising every BSDF kind at once (incl. the floor
variants no Mitsuba plugin maps to — reference parity: they exist in the
shader library, rayhit.rchit:428-458,583-617, but its loader never emits
them either; our SceneBuilder API does)."""

import numpy as np
import jax.numpy as jnp
import pytest

from gpuspectral_tpu.bsdf import table as bt
from gpuspectral_tpu.scene.data import SceneBuilder
from gpuspectral_tpu.scene.obj import make_cube, make_rectangle
from gpuspectral_tpu.integrator import render_image
from gpuspectral_tpu.utils import RenderConfig


@pytest.fixture(scope="module")
def zoo_scene():
    b = SceneBuilder()
    pos, nrm, uv = make_rectangle()

    # floor + back wall, diffuse
    diffuse = b.add_bsdf(bt.diffuse((0.7, 0.7, 0.7)))
    floor_xf = np.array([[4, 0, 0, 0], [0, 0, 4, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, floor_xf, diffuse, twofaced=True)
    back_xf = np.array([[4, 0, 0, 0], [0, 4, 0, 2], [0, 0, -1, -4], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, back_xf, diffuse, twofaced=True)

    # a small cube of each remaining bsdf kind, lined up on the floor
    kinds = [
        bt.smooth_dielectric(1.5),
        bt.smooth_conductor(0.0),
        bt.smooth_plastic((0.6, 0.2, 0.2), 1.5),
        bt.rough_conductor((1.66, 0.88, 0.52), (9.2, 6.3, 4.8), (1, 1, 1), 0.2),
        bt.smooth_floor((0.3, 0.5, 0.7), 0.04),
        bt.rough_floor((0.7, 0.5, 0.3), 0.04, 0.3),
        bt.rough_plastic((0.2, 0.6, 0.2), 1.5, alpha=0.2),
    ]
    cpos, cnrm, cuv = make_cube()
    for i, k in enumerate(kinds):
        idx = b.add_bsdf(k)
        x = -3.0 + i
        xf = np.array(
            [[0.35, 0, 0, x], [0, 0.35, 0, 0.35], [0, 0, 0.35, 0], [0, 0, 0, 1]],
            np.float32,
        )
        b.add_object(cpos, cnrm, cuv, xf, idx)

    # ceiling area light
    light = b.add_bsdf(bt.diffuse((0.0, 0.0, 0.0)))
    light_xf = np.array([[1.5, 0, 0, 0], [0, 0, -1, 4], [0, 1.5, 0, 0], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, light_xf, light, emission=(10.0, 10.0, 10.0))

    b.set_camera(
        np.array([[1, 0, 0, 0], [0, 1, 0, 1.2], [0, 0, -1, 7], [0, 0, 0, 1]], np.float32),
        fov_radians=np.deg2rad(45),
    )
    return b.build()


def test_all_kinds_present(zoo_scene):
    assert set(zoo_scene.kinds_present) == set(range(8))


def test_zoo_renders_finite(zoo_scene):
    cfg = RenderConfig(width=32, height=24, spp=8, max_depth=4, ray_batch=768, tri_chunk=128)
    img = np.asarray(render_image(zoo_scene, cfg))
    assert np.isfinite(img).all()
    assert img.max() > 0.5  # lit
    assert img.mean() > 0.005


def test_zoo_gradients_finite(zoo_scene):
    import jax

    from gpuspectral_tpu.integrator.path_tracer import render_sample

    cfg = RenderConfig(width=12, height=8, spp=2, max_depth=3, ray_batch=96)
    pix = jnp.arange(96, dtype=jnp.uint32)

    def loss(p):
        sc = zoo_scene.replace(bsdf_params=p)
        rad, _ = render_sample(sc, cfg, pix, jnp.uint32(0), differentiable=True)
        return jnp.sum(rad)

    g = np.asarray(jax.grad(loss)(zoo_scene.bsdf_params))
    assert np.isfinite(g).all(), np.argwhere(~np.isfinite(g))
    assert np.abs(g).max() > 0  # something is differentiable


def test_zoo_nee_consistency(zoo_scene):
    cfg_on = RenderConfig(width=16, height=12, spp=48, max_depth=3, ray_batch=192)
    cfg_off = cfg_on.replace(nee=False, spp=256)
    on = np.asarray(render_image(zoo_scene, cfg_on))
    off = np.asarray(render_image(zoo_scene, cfg_off, timestamp0=4000))
    m_on = on.reshape(4, 3, 4, 4, 3).mean((1, 3))
    m_off = off.reshape(4, 3, 4, 4, 3).mean((1, 3))
    err = np.abs(m_on - m_off).mean() / max(m_on.mean(), 1e-9)
    assert err < 0.35, err

def test_zoo_megakernel_matches_wavefront(zoo_scene):
    """All eight kinds in one scene: the kernel's per-lane kind dispatch
    (select chains over every present kind) against the wavefront."""
    from gpuspectral_tpu.integrator.mega import mega_eligible, render_mega
    from gpuspectral_tpu.integrator.path_tracer import render_image_stats

    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=4, ray_batch=192)
    assert mega_eligible(zoo_scene, cfg)
    ref, rays_ref = render_image_stats(zoo_scene, cfg, jnp.uint32(0))
    got, rays_got = render_mega(zoo_scene, cfg, 0, interpret=True)
    ref, got = np.asarray(ref), np.asarray(got)
    assert np.isfinite(got).all()
    # a seam tie can flip a whole path (one emitter hit moves a 2-sample
    # pixel by several units), so gate the share of such pixels and require
    # the rest to agree to float rounding
    off = np.abs(ref - got).max(-1) > 1e-3
    assert off.mean() < 0.03, off.mean()
    np.testing.assert_allclose(got[~off], ref[~off], atol=1e-5)
    assert abs(float(rays_ref) - float(rays_got)) / float(rays_ref) < 0.02
