"""Megakernel (integrator/mega.py) vs XLA wavefront equivalence, in the
Pallas interpreter.

The two integrators consume identical counter-based RNG draws and implement
identical semantics, so they agree everywhere except rays that land exactly
on geometric seams (wall/floor edges), where bit-level t-ties between the
intersector implementations flip the winning triangle — both choices are
valid closest hits.  Tests therefore assert exactness for emission-only
configs and tight statistical agreement once NEE samples seams.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gpuspectral_tpu.bsdf import table as bt
from gpuspectral_tpu.integrator import render_image_stats_auto, use_megakernel
from gpuspectral_tpu.integrator.mega import (
    BLOCK, mega_eligible, render_mega, render_mega_rows)
from gpuspectral_tpu.integrator.path_tracer import render_image_stats
from gpuspectral_tpu.scene.data import SceneBuilder
from gpuspectral_tpu.scene.obj import make_cube, make_rectangle
from gpuspectral_tpu.utils.config import RenderConfig


def _cfg(**kw):
    base = dict(width=32, height=32, ray_batch=1024)
    base.update(kw)
    return RenderConfig(**base)


def _assert_close(ref, got, frac=0.02, mean_tol=2e-3):
    """Seam-tie path flips only: few pixels differ, means agree."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.abs(ref - got)
    assert np.mean(np.max(d, -1) > 1e-3) < frac, np.mean(np.max(d, -1) > 1e-3)
    assert abs(ref.mean() - got.mean()) < mean_tol, (ref.mean(), got.mean())


def test_eligibility(cornell_scene):
    assert mega_eligible(cornell_scene, _cfg())
    assert not mega_eligible(cornell_scene, _cfg(use_bvh=True))
    assert not mega_eligible(cornell_scene, _cfg(light_sampling="power"))


def test_mega_matches_xla_emission_only(cornell_scene):
    # primary-hit emission involves no RNG and no seams along any ray: exact
    cfg = _cfg(max_depth=0, nee=False, spp=1)
    ref = np.asarray(render_image_stats(cornell_scene, cfg, jnp.uint32(0))[0])
    got = np.asarray(render_mega(cornell_scene, cfg, 0, interpret=True)[0])
    np.testing.assert_array_equal(ref, got)


def test_mega_matches_xla_one_bounce(cornell_scene):
    cfg = _cfg(max_depth=1, nee=False, spp=1)
    ref = np.asarray(render_image_stats(cornell_scene, cfg, jnp.uint32(0))[0])
    got = np.asarray(render_mega(cornell_scene, cfg, 0, interpret=True)[0])
    d = np.abs(ref - got)
    # seam-tie path flips only; everything else is bit-equal
    assert np.mean(np.max(d, -1) > 1e-4) < 0.01
    assert abs(ref.mean() - got.mean()) < 2e-3


def test_mega_matches_xla_full(cornell_scene):
    cfg = _cfg(max_depth=4, nee=True, spp=2)
    ref, rays_ref = render_image_stats(cornell_scene, cfg, jnp.uint32(0))
    got, rays_got = render_mega(cornell_scene, cfg, 0, interpret=True)
    _assert_close(ref, got)
    assert abs(float(rays_ref) - float(rays_got)) / float(rays_ref) < 0.01


@pytest.mark.parametrize("variant", [
    dict(mis_mode="exact"), dict(nee=False), dict(jitter=True),
    dict(max_depth=14, spp=1),  # past rr_start_depth: Russian roulette
])
def test_mega_matches_xla_config_variants(cornell_scene, variant):
    cfg = _cfg(width=16, height=16, max_depth=4, spp=2).replace(**variant)
    ref, rays_ref = render_image_stats(cornell_scene, cfg, jnp.uint32(3))
    got, rays_got = render_mega(cornell_scene, cfg, 3, interpret=True)
    _assert_close(ref, got, frac=0.03, mean_tol=3e-3)
    assert abs(float(rays_ref) - float(rays_got)) / float(rays_ref) < 0.01


@pytest.mark.parametrize("size", [(10, 7), (33, 5), (1, 1), (BLOCK + 3, 1)])
def test_mega_film_not_a_block_multiple(cornell_scene, size):
    """Pixel ids are padded up to whole blocks; pad lanes never reach the
    image or the ray count."""
    w, h = size
    cfg = _cfg(width=w, height=h, max_depth=2, spp=2, ray_batch=w * h)
    ref, rays_ref = render_image_stats(cornell_scene, cfg, jnp.uint32(0))
    got, rays_got = render_mega(cornell_scene, cfg, 0, interpret=True)
    assert np.asarray(got).shape == (h, w, 3)
    _assert_close(ref, got, frac=0.05, mean_tol=5e-3)
    assert abs(float(rays_ref) - float(rays_got)) <= 0.01 * float(rays_ref) + 2


def test_mega_ray_counts(cornell_scene):
    """Per-lane ray counts: one closest-hit ray per live bounce plus one
    shadow ray per NEE candidate, summed over the lane's samples."""
    cfg = _cfg(width=8, height=8, max_depth=0, nee=False, spp=3)
    pix = jnp.arange(BLOCK, dtype=jnp.uint32) % 64
    _, _, _, rays = render_mega_rows(cornell_scene, cfg, pix, 0, interpret=True)
    # depth 0 without NEE: exactly one camera ray per sample
    np.testing.assert_array_equal(np.asarray(rays), 3)
    cfg = cfg.replace(max_depth=1, nee=True)
    _, _, _, rays = render_mega_rows(cornell_scene, cfg, pix, 0, interpret=True)
    rays = np.asarray(rays)
    assert rays.min() >= 3 and rays.max() <= 3 * 4


def test_mega_rows_need_whole_blocks(cornell_scene):
    with pytest.raises(ValueError):
        render_mega_rows(cornell_scene, _cfg(), jnp.arange(BLOCK + 1, dtype=jnp.uint32))


def test_mega_timestamp_advances_samples(cornell_scene):
    cfg = _cfg(max_depth=2, nee=True, spp=1)
    a = np.asarray(render_mega(cornell_scene, cfg, 0, interpret=True)[0])
    b = np.asarray(render_mega(cornell_scene, cfg, 7, interpret=True)[0])
    assert not np.array_equal(a, b)  # different sample seeds
    assert abs(a.mean() - b.mean()) < 0.02  # same expectation


@pytest.mark.parametrize("platform,variant,expected", [
    ("gpu", {}, True),
    ("cpu", {}, False),
    ("gpu", dict(use_bvh=True), False),
    ("gpu", dict(light_sampling="power"), False),
])
def test_dispatch_decision(cornell_scene, platform, variant, expected):
    assert use_megakernel(cornell_scene, _cfg(**variant), platform) is expected


def test_auto_on_cpu_is_the_wavefront(cornell_scene):
    cfg = _cfg(max_depth=2, spp=1)
    got, rays = render_image_stats_auto(cornell_scene, cfg, 0)
    ref, rays_ref = render_image_stats(cornell_scene, cfg, jnp.uint32(0))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert float(rays) == float(rays_ref)


_KINDS = {
    "diffuse": bt.diffuse((0.7, 0.6, 0.5)),
    "smooth_dielectric": bt.smooth_dielectric(1.5),
    "smooth_conductor": bt.smooth_conductor(0.0),
    "smooth_plastic": bt.smooth_plastic((0.6, 0.2, 0.2), 1.5),
    "rough_conductor": bt.rough_conductor(
        (1.66, 0.88, 0.52), (9.2, 6.3, 4.8), (1, 1, 1), 0.2),
    "smooth_floor": bt.smooth_floor((0.3, 0.5, 0.7), 0.04),
    "rough_floor": bt.rough_floor((0.7, 0.5, 0.3), 0.04, 0.3),
    "rough_plastic": bt.rough_plastic((0.2, 0.6, 0.2), 1.5, alpha=0.2),
}


def _one_kind_scene(kind_row):
    """Floor, back wall, a cube and an area light, all of one BSDF kind
    (the kernel's single-kind specialization)."""
    b = SceneBuilder()
    pos, nrm, uv = make_rectangle()
    idx = b.add_bsdf(kind_row)
    floor_xf = np.array([[4, 0, 0, 0], [0, 0, 4, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, floor_xf, idx, twofaced=True)
    back_xf = np.array([[4, 0, 0, 0], [0, 4, 0, 2], [0, 0, -1, -4], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, back_xf, idx, twofaced=True)
    cpos, cnrm, cuv = make_cube()
    cube_xf = np.array([[0.6, 0, 0, 0.3], [0, 0.6, 0, 0.6], [0, 0, 0.6, 0], [0, 0, 0, 1]],
                       np.float32)
    b.add_object(cpos, cnrm, cuv, cube_xf, idx)
    light_xf = np.array([[1.5, 0, 0, 0], [0, 0, -1, 4], [0, 1.5, 0, 0], [0, 0, 0, 1]], np.float32)
    b.add_object(pos, nrm, uv, light_xf, idx, emission=(10.0, 10.0, 10.0))
    b.set_camera(
        np.array([[1, 0, 0, 0], [0, 1, 0, 1.2], [0, 0, -1, 7], [0, 0, 0, 1]], np.float32),
        fov_radians=np.deg2rad(45),
    )
    return b.build()


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_mega_matches_xla_per_bsdf_kind(kind):
    scene = _one_kind_scene(_KINDS[kind])
    assert len(scene.kinds_present) == 1
    cfg = _cfg(width=16, height=16, max_depth=4, spp=2)
    assert mega_eligible(scene, cfg)
    ref, rays_ref = render_image_stats(scene, cfg, jnp.uint32(0))
    got, rays_got = render_mega(scene, cfg, 0, interpret=True)
    _assert_close(ref, got, frac=0.03, mean_tol=5e-3 * max(1.0, float(np.mean(ref))))
    assert abs(float(rays_ref) - float(rays_got)) / float(rays_ref) < 0.02


@pytest.mark.gpu
def test_compiled_megakernel_matches_wavefront(gpu_device, cornell_scene):
    """The kernel as Triton compiles it for the card (no interpreter)."""
    cfg = _cfg(width=64, height=64, max_depth=6, spp=8)
    ref, rays_ref = render_image_stats(cornell_scene, cfg, jnp.uint32(0))
    got, rays_got = render_image_stats_auto(cornell_scene, cfg, 0)
    assert use_megakernel(cornell_scene, cfg)
    _assert_close(ref, got, frac=0.02, mean_tol=2e-3)
    assert abs(float(rays_ref) - float(rays_got)) / float(rays_ref) < 0.01
