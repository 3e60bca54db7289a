#!/usr/bin/env python
"""Smoke test of the renderer on an NVIDIA GPU, through its user entry points.

    python chip_smoke.py          # one GPU: phases 1-5
    python chip_smoke.py --four   # four GPUs of one host: phase 6 only

Phases (each checks its result; the first failure exits non-zero):

  1. device    a GPU is JAX's first device; prints the card's name and
               power limit, enables the compile cache
  2. golden    Cornell 64x64 @ 32 spp, depth 6, seed 0 through
               render_image_stats_auto vs the CPU snapshot in tests/data
  3. headline  Cornell 512x512 @ 64 spp, depth 50 through
               render_image_stats_auto (the GPU megakernel) and the XLA
               wavefront at the same seeds: images, quantiles, ray counts,
               compile time and steady seconds per frame
  4. bvh       Cornell through the XLA BVH packet traversal vs brute force
  5. grads     one value_and_grad step at 512x512 @ 64 spp, depth 5 (the
               grad benchmark's path); AD vs finite differences
               (diff/gradcheck); two diff/invert steps whose loss decreases
  6. --four    a 4-device (2 tiles x 2 spp) mesh: render_image_sharded,
               render_image_sharded_fast (the megakernel per shard) and
               grad_step_sharded, each vs its single-device result

Every time printed carries the card's name and power limit.  The last line
of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(HERE, "scenes", "cornell", "scene.xml")
GOLDEN = os.path.join(HERE, "tests", "data", "cornell_64x64_spp32_d6_seed0.npz")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def lum_quantiles(img):
    import numpy as np

    lum = np.asarray(img).mean(-1)
    return np.quantile(lum, [0.01, 0.5, 0.99])


def phase_device():
    sys.path.insert(0, HERE)
    import gpuspectral_tpu  # noqa: F401  (sets XLA_FLAGS before JAX starts)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform}", file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from gpuspectral_tpu.utils.jaxcache import enable

    enable()
    log(f"[device] {card} | jax {jax.__version__} | {dev.device_kind} x{len(jax.devices())}")
    return dev, card


def phase_golden(scene, card):
    import numpy as np

    from gpuspectral_tpu.integrator import render_image_stats_auto
    from gpuspectral_tpu.utils import RenderConfig

    cfg = RenderConfig(width=64, height=64, spp=32, max_depth=6, ray_batch=4096)
    (img, _), dt = timed(render_image_stats_auto, scene, cfg, 0)
    img = np.asarray(img)
    ref = np.load(GOLDEN)["img"]
    check(img.shape == ref.shape and np.isfinite(img).all(), "golden: bad image")
    r = np.abs(img - ref) / np.maximum(ref, 1e-2)
    m, q99, mx = rel(img.mean(), ref.mean()), float(np.quantile(r, 0.99)), float(r.max())
    n_off = int((r.max(-1) > 0.05).sum())
    log(f"[golden] mean rel {m:.3e}  rel q99 {q99:.3e}  rel max {mx:.3e}  "
        f"pixels off by >5%: {n_off} ({dt:.2f} s incl. compile) [{card}]")
    # The CPU gates (tests/test_regression_image.py) are mean 1e-4, q99 5e-3
    # and max 0.05.  The q99 gate holds as it is.  The card runs the
    # megakernel, whose Woop test and XLA's GPU transcendentals round
    # differently from the CPU wavefront, so a seam tie or a Russian-roulette
    # draw at its threshold can flip a whole path: that moves one pixel's
    # 32-sample mean by up to ~100% and the image mean by a few 1e-4 (an
    # H100 run flipped 12 of 4096 pixels; the interpreted kernel on the CPU
    # flips 1).  So the max gate becomes a share of such pixels (at most 1%)
    # and the mean gate 1e-3.
    check(m < 1e-3, f"golden: mean differs by {m:.3e}")
    check(q99 < 5e-3, f"golden: 99% of pixels within 5e-3, got {q99:.3e}")
    check(n_off <= r.shape[0] * r.shape[1] // 100,
          f"golden: {n_off} pixels differ by more than 5%")


def phase_headline(scene, card, dev):
    import numpy as np

    from gpuspectral_tpu.integrator import render_image_stats_auto, use_megakernel
    from gpuspectral_tpu.integrator.path_tracer import render_image_stats
    from gpuspectral_tpu.utils import RenderConfig

    cfg = RenderConfig(ray_batch=65536)  # 512x512 @ 64 spp, depth 50
    check(use_megakernel(scene, cfg), "headline: megakernel not chosen on the GPU")
    results = {}
    for name, fn in (("megakernel", render_image_stats_auto),
                     ("xla_wavefront", render_image_stats)):
        (img, rays), first = timed(fn, scene, cfg, 0)
        steady = sorted(timed(fn, scene, cfg, 1 + i)[1] for i in range(3))[1]
        img, rays = np.asarray(img), float(rays)
        check(img.shape == (512, 512, 3) and np.isfinite(img).all(),
              f"headline {name}: bad image")
        results[name] = (img, rays)
        log(f"[headline] {name}: compile+first {first:.2f} s, steady "
            f"{steady:.4f} s/frame, {rays / steady / 1e6:.1f} Mrays/s, "
            f"mean {img.mean():.6f}, rays {rays:.0f} [{card}]")
    (a, ra), (b, rb) = results["megakernel"], results["xla_wavefront"]
    qa, qb = lum_quantiles(a), lum_quantiles(b)
    frac = float(np.mean(np.abs(a - b).max(-1) > 1e-2))
    log(f"[headline] mean rel {rel(a.mean(), b.mean()):.3e}  quantiles(1/50/99%) "
        f"{qa} vs {qb}  rays rel {rel(ra, rb):.3e}  pixels off by >1e-2: {frac:.4f}")
    # same seeds, same estimator: only seam-tie / threshold flips differ
    check(rel(a.mean(), b.mean()) < 1e-3, "headline: mean radiance differs")
    check(all(rel(x, y) < 1e-2 for x, y in zip(qa, qb)), "headline: quantiles differ")
    check(rel(ra, rb) < 1e-3, "headline: ray counts differ")
    check(frac < 0.05, "headline: too many pixels differ")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    log(f"[headline] peak device memory {peak / 2**30:.3f} GiB [{card}]")


def phase_bvh(scene, card):
    import numpy as np

    from gpuspectral_tpu.integrator.path_tracer import render_image_stats
    from gpuspectral_tpu.utils import RenderConfig

    size, spp = 256, 4
    cfg = RenderConfig(width=size, height=size, spp=spp, ray_batch=65536,
                       intersector="mt")
    (ref, rays_ref), _ = timed(render_image_stats, scene, cfg, 0)
    _, brute = timed(render_image_stats, scene, cfg, 1)
    cfg_b = cfg.replace(use_bvh=True)
    (img, rays), first = timed(render_image_stats, scene, cfg_b, 0)
    _, steady = timed(render_image_stats, scene, cfg_b, 1)
    img, ref = np.asarray(img), np.asarray(ref)
    check(np.isfinite(img).all(), "bvh: non-finite image")
    frac = float(np.mean(np.abs(img - ref).max(-1) > 1e-2))
    log(f"[bvh] {size}x{size} @ {spp} spp depth {cfg.max_depth}: compile+first "
        f"{first:.2f} s, steady {steady:.3f} s/frame, "
        f"{float(rays) / steady / 1e6:.2f} Mrays/s (brute-force wavefront "
        f"{brute:.3f} s/frame); mean rel "
        f"{rel(img.mean(), ref.mean()):.3e}, rays rel "
        f"{rel(float(rays), float(rays_ref)):.3e}, pixels off {frac:.4f} [{card}]")
    # same arithmetic (Moller-Trumbore) and seeds; only hit ties may differ
    check(rel(img.mean(), ref.mean()) < 2e-3, "bvh: mean radiance differs")
    check(rel(float(rays), float(rays_ref)) < 2e-3, "bvh: ray counts differ")
    check(frac < 0.02, "bvh: too many pixels differ")


def phase_grads(scene, card, dev):
    import jax.numpy as jnp
    import numpy as np

    from gpuspectral_tpu.diff.gradcheck import check_gradients
    from gpuspectral_tpu.diff.invert import _render, invert, optimizable_mask
    from gpuspectral_tpu.utils import RenderConfig
    from gpuspectral_tpu.utils.bench import make_grad_step

    cfg = RenderConfig(spp=64, max_depth=5, ray_batch=65536, grad_remat="sample")
    step = make_grad_step(scene, cfg, jnp.zeros((512 * 512, 3), jnp.float32))
    (loss, g), first = timed(step, scene.bsdf_params, jnp.uint32(0))
    (loss, g), steady = timed(step, scene.bsdf_params, jnp.uint32(1))
    g = np.asarray(g)
    check(np.isfinite(float(loss)) and np.isfinite(g).all(), "grads: non-finite")
    check(np.abs(g).max() > 0, "grads: all zero")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    log(f"[grads] 512x512 @ 64 spp depth 5 value_and_grad: compile+first "
        f"{first:.2f} s, steady {steady:.3f} s/step, loss {float(loss):.6f}, "
        f"|g|max {np.abs(g).max():.3e}, peak {peak / 2**30:.3f} GiB [{card}]")

    small = RenderConfig(width=24, height=24, spp=32, max_depth=3, ray_batch=576)
    t0 = time.perf_counter()
    ok, report = check_gradients(scene, small)
    worst = max((e["rel_err"] for e in report["entries"]), default=float("nan"))
    log(f"[grads] gradcheck: {report['checked']} entries, worst rel err "
        f"{worst:.3e}, allclose {ok} ({time.perf_counter() - t0:.2f} s) [{card}]")
    check(ok and report["checked"] > 0, "grads: AD and finite differences disagree")

    inv = RenderConfig(width=64, height=64, spp=8, max_depth=4, ray_batch=4096)
    target = np.asarray(_render(scene, inv, inv.spp, jnp.uint32(0)))
    mask = optimizable_mask(np.asarray(scene.bsdf_kind))
    p0 = np.asarray(scene.bsdf_params).copy()
    p0[mask] = np.clip(p0[mask] + 0.2, 0.02, 1.0)
    t0 = time.perf_counter()
    _, history = invert(scene, target, inv, steps=2, lr=0.05, init_params=p0,
                        timestamp0=0, resample=False)
    log(f"[grads] invert 2 steps: loss {history[0]:.6e} -> {history[1]:.6e} "
        f"({time.perf_counter() - t0:.2f} s incl. compile) [{card}]")
    check(history[1] < history[0], "grads: invert loss did not decrease")


def phase_four(scene, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpuspectral_tpu.integrator.mega import render_mega
    from gpuspectral_tpu.integrator.path_tracer import render_image_stats, render_sample
    from gpuspectral_tpu.parallel import (
        grad_step_sharded, make_mesh, render_image_sharded, render_image_sharded_fast)
    from gpuspectral_tpu.utils import RenderConfig

    check(len(jax.devices()) >= 4, f"--four: {len(jax.devices())} devices")
    mesh = make_mesh(4, spp_shards=2)
    log(f"[four] mesh {dict(mesh.shape)} over {[d.id for d in mesh.devices.flat]}")

    cfg = RenderConfig(width=256, height=256, spp=16, max_depth=8, ray_batch=16384)
    img_s, dt = timed(render_image_sharded, scene, cfg, mesh)
    (ref, _), _ = timed(render_image_stats, scene, cfg, jnp.uint32(0))
    err = float(np.abs(np.asarray(img_s) - np.asarray(ref)).max())
    log(f"[four] render_image_sharded 256x256 @ 16 spp: max abs diff vs one "
        f"device {err:.3e} ({dt:.2f} s incl. compile) [{card}]")
    # same draws; sample sums are only reassociated across shards
    check(err < 1e-4, "four: sharded wavefront differs from one device")

    # render_image_sharded_fast traces a new shard_map program per call, so
    # both times below include tracing and compilation
    cfg_h = RenderConfig(spp=64)  # the headline 512x512 @ 64 spp, depth 50
    (img_f, rays_f), dt = timed(render_image_sharded_fast, scene, cfg_h, mesh)
    (img_1, rays_1), dt1 = timed(render_mega, scene, cfg_h, 0)
    err = float(np.abs(np.asarray(img_f) - np.asarray(img_1)).max())
    log(f"[four] render_image_sharded_fast 512x512 @ 64 spp: max abs diff vs one "
        f"device {err:.3e}; rays {float(rays_f):.0f} vs {float(rays_1):.0f} "
        f"({dt:.2f} s, one device {dt1:.2f} s, both incl. compile) [{card}]")
    check(err < 1e-4 and float(rays_f) == float(rays_1),
          "four: sharded megakernel differs from one device")

    cfg_g = RenderConfig(width=128, height=128, spp=8, max_depth=5, ray_batch=16384)
    target = np.random.default_rng(0).uniform(0, 1, (128, 128, 3)).astype(np.float32)
    (loss_s, g_s), dt = timed(grad_step_sharded, scene, cfg_g, mesh, target)
    pix = jnp.arange(128 * 128, dtype=jnp.uint32)

    @jax.jit
    def single_step(bp):
        def loss_fn(p):
            sc = scene.replace(bsdf_params=p)
            acc = sum(render_sample(sc, cfg_g, pix, jnp.uint32(s), differentiable=True)[0]
                      for s in range(cfg_g.spp))
            return jnp.mean(((acc / cfg_g.spp).reshape(128, 128, 3) - target) ** 2)

        return jax.value_and_grad(loss_fn)(bp)

    loss_u, g_u = single_step(scene.bsdf_params)
    g_s, g_u = np.asarray(g_s), np.asarray(g_u)
    gerr = float(np.abs(g_s - g_u).max() / max(np.abs(g_u).max(), 1e-12))
    log(f"[four] grad_step_sharded 128x128 @ 8 spp: loss {float(loss_s):.6e} vs "
        f"{float(loss_u):.6e}, grad rel max diff {gerr:.3e} ({dt:.2f} s incl. "
        f"compile) [{card}]")
    check(rel(float(loss_s), float(loss_u)) < 1e-4 and gerr < 1e-3,
          "four: sharded gradient differs from one device")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-GPU sharded phase")
    args = parser.parse_args()

    dev, card = phase_device()
    import jax

    from gpuspectral_tpu.scene import load_mitsuba_scene

    scene, _ = load_mitsuba_scene(CORNELL)
    if args.four:
        phase_four(scene, card)
    else:
        phase_golden(scene, card)
        phase_headline(scene, card, dev)
        phase_bvh(scene, card)
        phase_grads(scene, card, dev)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
