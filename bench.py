#!/usr/bin/env python
"""Benchmark: one JSON line with the headline metric.

Rows: Mrays/s at Cornell box 512x512 @ 64 spp depth 50 (rays actually
traced: closest-hit + shadow), grad-steps/s at Cornell 512^2@64spp
(depth 5), the config-5-scale 1024^2 @ 256 spp Cornell gradient step, and —
where the reference scene assets are present — test3 with its glossy
dielectric + rough-conductor spheres (512^2 @ 32 spp), staircase2 (31k
tris), coffee (168k tris) and living-room (300k tris, 3968 lights) at their
declared 64 spp, plus a BVH-scene gradient step (staircase2 albedo).

Each row runs in its own subprocess, one after another (never two at once:
a JAX process reserves most of the card's memory), so one failing row
cannot take the others with it.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

REF_SCENES = "/root/reference/src/GPUSpectral/assets/scenes"
ROW_TIMEOUT_S = 1500


def run_row(name: str):
    """One benchmark row, printed as a JSON line (subprocess entry)."""
    from gpuspectral_tpu.utils.jaxcache import enable as _enable_cache

    _enable_cache()
    import argparse

    from gpuspectral_tpu.utils.bench import run_benchmark, run_grad_benchmark

    cornell = os.path.join(HERE, "scenes/cornell/scene.xml")

    def render_args(scene, spp, bvh, size="512x512", iters=2):
        return argparse.Namespace(
            scene=scene, output="/dev/null", spp=spp, size=size,
            depth=None, no_nee=False, jitter=False, tonemap=False, seed=0,
            ray_batch=65536, metrics=None, warmup=1, iters=iters, bvh=bvh,
            intersector="auto", packet_size=1024,
        )

    if name == "cornell":
        out = run_benchmark(render_args(cornell, 64, False))
    elif name == "test3_glossy":
        # config 3 as declared (BASELINE.json configs[2]): 512^2 @ 32 spp
        out = run_benchmark(
            render_args(os.path.join(REF_SCENES, "test3/scene.xml"), 32,
                        True, size="512x512", iters=2))
    elif name == "staircase2":
        # declared sampler: 64 spp (scene.xml); medians over 3 iterations
        out = run_benchmark(
            render_args(os.path.join(REF_SCENES, "staircase2/scene.xml"),
                        64, True, iters=3))
    elif name == "coffee":
        out = run_benchmark(
            render_args(os.path.join(REF_SCENES, "coffee/scene.xml"), 64,
                        True, iters=2))
    elif name == "living_room":
        # declared film is 1280x720; benched at the same 16:9 aspect
        out = run_benchmark(
            render_args(os.path.join(REF_SCENES, "living-room/scene.xml"),
                        64, True, size="512x288", iters=2))
    elif name == "grad":
        out = run_grad_benchmark(cornell, steps=3)
    elif name == "grad_bvh":
        # BVH-scene inversion at the declared 64 spp
        out = run_grad_benchmark(
            os.path.join(REF_SCENES, "staircase2/scene.xml"), spp=64,
            steps=2, use_bvh=True)
    elif name == "grad_1024":
        # config-5 scale on one device: 1024^2 @ 256 spp
        out = run_grad_benchmark(cornell, size=1024, spp=256, steps=1)
    else:
        raise SystemExit(f"unknown row {name}")
    print("ROW_JSON:" + json.dumps(out))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--row":
        run_row(sys.argv[2])
        return 0

    detail = {}
    # headline + declared-scene rows first, the slow-compiling glossy/1024
    # rows last
    rows = ["cornell", "staircase2", "coffee", "living_room", "grad",
            "grad_bvh", "test3_glossy", "grad_1024"]
    for name in rows:
        needs_ref = name not in ("cornell", "grad", "grad_1024")
        if needs_ref and not os.path.isdir(REF_SCENES):
            continue
        try:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--row", name],
                capture_output=True, text=True, timeout=ROW_TIMEOUT_S,
            )
            line = next(
                (ln for ln in p.stdout.splitlines() if ln.startswith("ROW_JSON:")),
                None,
            )
            if line is None:
                detail[name] = {
                    "error": (p.stderr.strip().splitlines() or ["no output"])[-1][:300]
                }
            else:
                detail[name] = json.loads(line[len("ROW_JSON:"):])
        except subprocess.TimeoutExpired:
            detail[name] = {"error": f"row timed out after {ROW_TIMEOUT_S}s"}
        except Exception as e:  # noqa: BLE001 — keep the headline alive
            detail[name] = {"error": str(e)[:300]}

    mrays = detail.get("cornell", {}).get("mrays_per_s", 0.0)
    summary = {
        "metric": "cornell_512_64spp_mrays_per_s",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "staircase2_mrays_per_s": round(
            detail.get("staircase2", {}).get("mrays_per_s", 0.0), 3
        ),
        "coffee_mrays_per_s": round(
            detail.get("coffee", {}).get("mrays_per_s", 0.0), 3
        ),
        "living_room_mrays_per_s": round(
            detail.get("living_room", {}).get("mrays_per_s", 0.0), 3
        ),
        "test3_glossy_mrays_per_s": round(
            detail.get("test3_glossy", {}).get("mrays_per_s", 0.0), 3
        ),
        "grad_steps_per_s_512_64spp_d5": round(
            detail.get("grad", {}).get("grad_steps_per_s", 0.0), 4
        ),
        "grad_bvh_steps_per_s": round(
            detail.get("grad_bvh", {}).get("grad_steps_per_s", 0.0), 4
        ),
        "grad_1024_seconds_per_step": round(
            detail.get("grad_1024", {}).get("seconds_per_step", 0.0), 2
        ),
    }
    # detail first, compact summary LAST: the last line must always parse
    # alone
    print(json.dumps({"detail": detail}))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
