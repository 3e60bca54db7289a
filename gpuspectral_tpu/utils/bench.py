"""Benchmark harness: measured Mrays/s on compiled, steady-state renders.

Mrays/s counts rays actually traced (closest-hit + shadow), instrumented in
the integrator — not a W*H*spp*depth upper bound.
"""

from __future__ import annotations

import time

import jax
import numpy as np


def run_benchmark(args) -> dict:
    from ..cli.main import _build
    from ..integrator import render_image_stats_auto as render_image_stats

    scene, cfg = _build(args)
    warmup = getattr(args, "warmup", 1)
    iters = getattr(args, "iters", 3)

    import jax.numpy as jnp

    # timestamp0 is passed as a device array so each iteration reuses one
    # executable; a device-side scalar reduce of the image ends each timed
    # frame
    t0 = time.time()
    img, nrays = render_image_stats(scene, cfg, jnp.uint32(0))
    np.asarray(img)
    compile_s = time.time() - t0
    for i in range(max(0, warmup - 1)):
        float(jnp.sum(render_image_stats(scene, cfg, jnp.uint32(i + 1))[0]))

    times = []
    for i in range(iters):
        t0 = time.time()
        img, nrays = render_image_stats(scene, cfg, jnp.uint32(100 + i))
        float(jnp.sum(img))
        times.append(time.time() - t0)
    nrays = float(np.asarray(nrays))

    seconds = float(np.median(times))
    total_rays = float(nrays)
    n_paths = cfg.width * cfg.height * cfg.spp
    return {
        "scene": args.scene,
        "width": cfg.width,
        "height": cfg.height,
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
        "compile_seconds": round(compile_s, 2),
        "seconds_per_frame": seconds,
        "rays_traced": total_rays,
        "mrays_per_s": total_rays / seconds / 1e6,
        "mpaths_per_s": n_paths / seconds / 1e6,
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
    }


def make_grad_step(scene, cfg, target):
    """Jitted (bsdf_params, timestamp0) -> (loss, grads): value_and_grad of
    the MSE between the cfg.spp-sample render and `target` (n_pixels, 3)
    through the path-replay-differentiable XLA wavefront, pixels in
    lax.map batches of cfg.ray_batch."""
    import jax
    import jax.numpy as jnp

    from ..integrator.path_tracer import render_sample

    n_pixels = cfg.width * cfg.height
    ray_batch = min(cfg.ray_batch, n_pixels)
    if n_pixels % ray_batch:
        raise ValueError(f"{n_pixels} pixels do not split into batches of {ray_batch}")

    @jax.jit
    def grad_step(params, ts):
        def loss(p):
            sc = scene.replace(bsdf_params=p)
            nb = n_pixels // ray_batch
            pix = jnp.arange(n_pixels, dtype=jnp.uint32).reshape(nb, ray_batch)

            def pix_batch(pb):
                # sample-level remat: replay across samples, store residuals
                # within one (see RenderConfig.grad_remat)
                @jax.checkpoint
                def body(acc, s):
                    rad, _ = render_sample(sc, cfg.replace(spp=1), pb, ts + s,
                                           differentiable=True)
                    return acc + rad, None

                acc, _ = jax.lax.scan(body, jnp.zeros((ray_batch, 3), jnp.float32),
                                      jnp.arange(cfg.spp, dtype=jnp.uint32))
                return acc / cfg.spp

            img = jax.lax.map(pix_batch, pix).reshape(n_pixels, 3)
            return jnp.mean((img - target) ** 2)

        return jax.value_and_grad(loss)(params)

    return grad_step


def run_grad_benchmark(scene_path: str, size: int = 512, spp: int = 64,
                       depth: int = 5, ray_batch: int = 65536,
                       steps: int = 2, use_bvh: bool = False) -> dict:
    """Gradient-step throughput at the headline config (grad-steps/s on
    Cornell 512^2@64spp): one Adam-less value_and_grad of the MSE against a
    fixed target through the path-replay-differentiable XLA wavefront."""
    import jax
    import jax.numpy as jnp

    from ..scene import load_mitsuba_scene
    from ..utils.config import RenderConfig

    scene, _ = load_mitsuba_scene(scene_path)
    cfg = RenderConfig(width=size, height=size, spp=spp, max_depth=depth,
                       ray_batch=ray_batch, grad_remat="sample",
                       use_bvh=use_bvh)
    n_pixels = size * size
    grad_step = make_grad_step(scene, cfg, jnp.zeros((n_pixels, 3), jnp.float32))

    t0 = time.time()
    _, g = grad_step(scene.bsdf_params, jnp.uint32(0))
    np.asarray(g)
    compile_s = time.time() - t0
    times = []
    for i in range(steps):
        t0 = time.time()
        _, g = grad_step(scene.bsdf_params, jnp.uint32(i + 1))
        np.asarray(g)
        times.append(time.time() - t0)
    dt = float(np.median(times))
    out = {
        "seconds_per_step": dt,
        "grad_steps_per_s": 1.0 / dt,
        "mpaths_per_s_fwd_bwd": n_pixels * spp / dt / 1e6,
        "compile_seconds": round(compile_s, 1),
        "size": size, "spp": spp, "max_depth": depth,
    }
    try:  # best effort: peak HBM (not all backends expose memory_stats)
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        if peak:
            out["peak_hbm_gb"] = round(peak / 2**30, 3)
    except Exception:  # noqa: BLE001
        pass
    return out
