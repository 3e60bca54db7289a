"""Pinned-seed regression images for the BVH-scale scenes (coffee and
living-room): like tests/test_regression_image.py but exercising the BVH
traversal path and PITCHED cameras (their to_world has a nonzero pitch,
which the round-3 camera-convention fix changed — see scene/camera.py).

Regenerate deliberately when estimator semantics change:

    python tests/test_regression_bvh_scenes.py   # rewrites tests/data/*.npz
"""

import os
import pathlib

import numpy as np
import pytest

DATA = pathlib.Path(__file__).parent / "data"
REF_SCENES = "/root/reference/src/GPUSpectral/assets/scenes"
needs_ref = pytest.mark.skipif(
    not os.path.isdir(REF_SCENES), reason="reference assets not mounted"
)

CASES = {
    "coffee": dict(fixture="coffee_16x20_spp8_d6_seed0.npz", width=16, height=20),
    "living-room": dict(fixture="living-room_24x14_spp8_d6_seed0.npz", width=24, height=14),
}


def _render(scene_name, width, height):
    from gpuspectral_tpu.integrator import render_image
    from gpuspectral_tpu.scene import load_mitsuba_scene
    from gpuspectral_tpu.utils import RenderConfig

    scene, _b = load_mitsuba_scene(f"{REF_SCENES}/{scene_name}/scene.xml")
    cfg = RenderConfig(
        width=width, height=height, spp=8, max_depth=6,
        ray_batch=width * height, use_bvh=True, intersector="woop",
        jitter=True, light_sampling="power", mis_mode="exact",
    )
    return np.asarray(render_image(scene, cfg, timestamp0=0))


def _check(scene_name):
    case = CASES[scene_name]
    ref = np.load(DATA / case["fixture"])["img"]
    img = _render(scene_name, case["width"], case["height"])
    assert img.shape == ref.shape
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=1e-3)
    rel = np.abs(img - ref) / np.maximum(ref, 1e-2)
    assert np.quantile(rel, 0.99) < 0.02, float(np.quantile(rel, 0.99))


@needs_ref
def test_pinned_coffee():
    _check("coffee")


@needs_ref
def test_pinned_living_room():
    _check("living-room")


if __name__ == "__main__":  # regeneration entry point
    import sys

    # the snapshots are CPU renders
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    for name, case in CASES.items():
        img = _render(name, case["width"], case["height"])
        np.savez_compressed(DATA / case["fixture"], img=img)
        print("wrote", case["fixture"], img.shape, "mean", img.mean())
