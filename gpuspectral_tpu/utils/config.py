"""Render configuration.

The reference hardcodes every knob (SURVEY.md §5.6): window 500x500 in
main.cpp:16, MAX_DEPTH 50 / RR start 10 / firefly clamp 20 in
raygen.rgen:27,60-71, NEE as a compile-time shader constant
(rayhit.rchit:656).  Here they are a hashable dataclass usable as a jit
static argument, defaulting to the reference's values.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    spp: int = 64
    max_depth: int = 50  # raygen.rgen:27
    rr_start_depth: int = 10  # raygen.rgen:66
    rr_clamp_min: float = 0.05  # raygen.rgen:67
    firefly_clamp: float = 20.0  # raygen.rgen:60
    nee: bool = True  # rayhit.rchit:656
    jitter: bool = False  # reference does not subpixel-jitter
    shadow_epsilon: float = 0.01  # rayhit.rchit:745-747
    origin_epsilon: float = 1e-4  # rayhit.rchit:793
    ray_batch: int = 8192  # rays processed per wavefront batch
    tri_chunk: int = 512  # triangles per intersection block
    use_bvh: bool = False  # hierarchical traversal (bvh/) vs brute force
    packet_size: int = 1024  # rays per BVH traversal packet
    # closest-hit/any-hit form of the XLA wavefront's brute-force test:
    # "woop" (precomputed unit-triangle transforms, ops/woop.py) or "mt"
    # (Moller-Trumbore); "auto" = "woop"
    intersector: str = "auto"
    # reverse-mode remat granularity for differentiable renders:
    # "bounce" re-runs each bounce during backward (path replay, minimal
    # memory); "sample" stores per-bounce residuals within one sample and
    # replays only across samples (~1.5x faster backward, needs
    # O(depth x rays) residual memory)
    grad_remat: str = "bounce"
    # periodic wavefront re-sorting by direction octant + origin Morton key:
    # restores packet coherence for BVH traversal on bounced rays (the EP/
    # queue-compaction analogue, SURVEY.md §2.3); irrelevant to brute force
    sort_rays: bool = False
    sort_interval: int = 4  # bounce iterations between sorts
    # share the NEE light PICK across aligned groups of this many lanes
    # (0 = per-lane, the reference's semantics).  Unbiased (each lane's pick
    # keeps its marginal distribution) but correlated across the block; turns
    # a block's shadow rays into a coherent beam toward one light, so a BVH
    # packet visits fewer nodes.  Enable for BVH-scale scenes.
    light_block: int = 0
    # "uniform" matches the reference (rayhit.rchit:148: randPcg % numLights);
    # "power" importance-samples lights by emitted power (lower variance on
    # many-light scenes, identical expectation)
    light_sampling: str = "uniform"
    # "reference" reproduces the reference's MIS complement weight, which
    # reuses the pdf of its *NEE light sample* (rayhit.rchit:786) — an
    # approximation that overcounts emitter hits.  "exact" computes the true
    # light pdf of the actual BSDF-ray hit point, converging to ground truth.
    mis_mode: str = "reference"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
