"""Multi-host (multi-process) distribution: real OS processes over gloo CPU
collectives must reproduce the single-process sharded render + gradients
(SURVEY.md §5.8; the GPUSPECTRAL_FAKE_HOSTS simulation promised by
parallel/launch.py)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_render_matches_single(tmp_path):
    n_hosts = 2
    port = _free_port()
    outs = [str(tmp_path / f"host{i}.npz") for i in range(n_hosts)]
    procs = []
    for i in range(n_hosts):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["GPUSPECTRAL_FAKE_HOSTS"] = str(n_hosts)
        env["GPUSPECTRAL_FAKE_HOST_ID"] = str(i)
        env["GPUSPECTRAL_COORDINATOR"] = f"127.0.0.1:{port}"
        procs.append(
            subprocess.Popen(
                [sys.executable, str(REPO / "tests/mh_worker.py"), outs[i]],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
        )
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=540)
        assert p.returncode == 0, f"host {i} failed:\n{err.decode()[-3000:]}"

    res = np.load(outs[0])
    assert res["processes"] == n_hosts
    assert res["devices"] == 4  # 2 hosts x 2 virtual chips

    # single-process reference on an equal 4-device mesh
    from gpuspectral_tpu.parallel.dist import grad_step_sharded, make_mesh, render_image_sharded
    from gpuspectral_tpu.scene import load_mitsuba_scene
    from gpuspectral_tpu.utils import RenderConfig

    scene, _ = load_mitsuba_scene(str(REPO / "scenes/cornell/scene.xml"))
    cfg = RenderConfig(width=16, height=8, spp=4, max_depth=2, ray_batch=128)
    mesh = make_mesh(4, spp_shards=2)
    img1 = np.asarray(render_image_sharded(scene, cfg, mesh))
    loss1, grads1 = grad_step_sharded(scene, cfg, mesh, np.zeros((8, 16, 3), np.float32))

    np.testing.assert_allclose(res["img"], img1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(res["loss"]), float(loss1), rtol=1e-5)
    np.testing.assert_allclose(res["grads"], np.asarray(grads1), rtol=1e-4, atol=1e-8)


def test_sharded_fast_bvh_config_uses_wavefront():
    """Configs the megakernel does not cover (here BVH traversal) shard
    through the XLA wavefront, identically to render_image_sharded."""
    from gpuspectral_tpu.parallel.dist import (
        make_mesh, render_image_sharded, render_image_sharded_fast)
    from gpuspectral_tpu.scene import load_mitsuba_scene
    from gpuspectral_tpu.utils import RenderConfig

    scene, _ = load_mitsuba_scene("scenes/cornell/scene.xml")
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=3,
                       ray_batch=256, use_bvh=True, jitter=False,
                       light_sampling="power", mis_mode="exact")
    mesh = make_mesh(8, spp_shards=2)
    img_f, nrays = render_image_sharded_fast(scene, cfg, mesh, interpret=True)
    img_s = render_image_sharded(scene, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(img_f), np.asarray(img_s))
    assert float(nrays) == 0.0


@pytest.mark.parametrize("spp_shards,size", [(2, (32, 32)), (1, (20, 9))])
def test_sharded_fast_brute_path(spp_shards, size):
    """Brute-force configs route through the megakernel per shard; the
    image and ray count match the unsharded kernel (same sample set)."""
    from gpuspectral_tpu.integrator.mega import mega_eligible, render_mega
    from gpuspectral_tpu.parallel.dist import (
        make_mesh, render_image_sharded_fast)
    from gpuspectral_tpu.scene import load_mitsuba_scene
    from gpuspectral_tpu.utils import RenderConfig

    scene, _ = load_mitsuba_scene("scenes/cornell/scene.xml")
    w, h = size
    cfg = RenderConfig(width=w, height=h, spp=2, max_depth=3,
                       ray_batch=1024, use_bvh=False, jitter=False)
    assert mega_eligible(scene, cfg)
    mesh = make_mesh(8, spp_shards=spp_shards)
    img_s, nrays_s = render_image_sharded_fast(
        scene, cfg, mesh, timestamp0=0, interpret=True)
    img_u, nrays_u = render_mega(scene, cfg, 0, interpret=True)
    img_s, img_u = np.asarray(img_s), np.asarray(img_u)
    assert img_s.shape == (h, w, 3)
    assert np.allclose(img_s, img_u, atol=1e-5), np.abs(img_s - img_u).max()
    assert float(nrays_s) == float(nrays_u)


@pytest.mark.parametrize("use_bvh", [False, True])
def test_grad_sharded_matches_single_device(use_bvh):
    """grad_step_sharded's loss and gradients equal a single-device
    value_and_grad of the same MSE over the same sample set."""
    import jax
    import jax.numpy as jnp

    from gpuspectral_tpu.integrator.path_tracer import render_sample
    from gpuspectral_tpu.parallel.dist import grad_step_sharded, make_mesh
    from gpuspectral_tpu.scene import load_mitsuba_scene
    from gpuspectral_tpu.utils import RenderConfig

    scene, _ = load_mitsuba_scene("scenes/cornell/scene.xml")
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=3,
                       ray_batch=256, use_bvh=use_bvh, jitter=False)
    target = np.random.default_rng(8).uniform(0.0, 1.0, (16, 16, 3)).astype(np.float32)
    mesh = make_mesh(8, spp_shards=2)
    loss_s, g_s = grad_step_sharded(scene, cfg, mesh, target, timestamp0=5)

    pix = jnp.arange(16 * 16, dtype=jnp.uint32)

    def loss_fn(bp):
        sc = scene.replace(bsdf_params=bp)
        acc = sum(render_sample(sc, cfg, pix, jnp.uint32(5 + s), differentiable=True)[0]
                  for s in range(cfg.spp))
        img = (acc / cfg.spp).reshape(16, 16, 3)
        return jnp.mean((img - target) ** 2)

    loss_u, g_u = jax.value_and_grad(loss_fn)(scene.bsdf_params)
    np.testing.assert_allclose(float(loss_s), float(loss_u), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_u), rtol=1e-4, atol=1e-7)
