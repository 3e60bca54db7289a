"""Pinhole camera ray generation.

Behavior spec from the reference raygen shader (raygen.rgen:20-35), with one
deliberate correction.  The reference computes

    d_c = normalize(-xy.x, xy.y, z);  d_w = (to_world @ d_c).xyz;  d_w.y *= -1

i.e. it flips the *world* y of the finished direction.  For level cameras
(every scene its demo app ever renders: cornell-box, staircase2, test3 all
have to_world[1,2] == 0) that is identical to the Mitsuba convention; for a
PITCHED camera it negates the pitch — the camera looks up where the scene
author pointed it down.  coffee (pitch -0.039) and living-room (-0.029)
render ~4.5 deg vertically shifted against their Tungsten ground truths
under the reference's rule (measured rel error 1.04 -> 0.43 on the coffee
golden from this one sign).  We therefore use the Mitsuba convention the
ground truths were rendered with:

    d_c = normalize(-xy.x, -xy.y, z);  d_w = to_world[:3,:3] @ d_c

which is bit-identical to the reference for level, roll-free cameras.

fragCoord has (0,0) at the top-left pixel (Vulkan launch-ID convention) and
the reference samples at integer pixel coordinates (no subpixel jitter —
raygen.rgen:38 is commented out).  `jitter_u` lets callers pass a per-pixel
subpixel offset in [0,1)^2 for antialiased accumulation; pass None to
replicate the reference exactly.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import math3d as m3
from .data import CameraData


def generate_rays(cam: CameraData, width: int, height: int, pixel_index, jitter_u=None):
    """pixel_index: (...,) int32 flat index (y*width + x).
    Returns (origin (...,3), direction (...,3))."""
    px = (pixel_index % width).astype(jnp.float32)
    py = (pixel_index // width).astype(jnp.float32)
    if jitter_u is not None:
        px = px + jitter_u[0]
        py = py + jitter_u[1]
    xy_x = px - width / 2.0
    xy_y = py - height / 2.0
    z = (max(width, height) / 2.0) / jnp.tan(cam.fov / 2.0)
    d_cam = m3.normalize(
        jnp.stack([-xy_x, -xy_y, jnp.broadcast_to(z, xy_x.shape)], axis=-1)
    )
    # Explicit component products, NOT a (R,3)@(3,3) matmul: a GPU matmul at
    # default f32 precision may run in TF32, which quantizes ray directions
    # to 10 mantissa bits (a ~1e-3 geometric error on primary hits).
    r = cam.to_world[:3, :3]
    dx, dy, dz = d_cam[..., 0], d_cam[..., 1], d_cam[..., 2]
    d_world = jnp.stack(
        [
            r[0, 0] * dx + r[0, 1] * dy + r[0, 2] * dz,
            r[1, 0] * dx + r[1, 1] * dy + r[1, 2] * dz,
            r[2, 0] * dx + r[2, 1] * dy + r[2, 2] * dz,
        ],
        axis=-1,
    )
    origin = jnp.broadcast_to(cam.to_world[:3, 3], d_world.shape)
    return origin, d_world
