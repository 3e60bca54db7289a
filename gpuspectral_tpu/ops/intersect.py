"""Ray-triangle intersection kernels (brute force baseline).

This replaces what Vulkan gave the reference in hardware: `traceRayEXT`
against a driver-built BVH (backend/vulkan/VulkanRays.cpp).  The baseline
here tests every ray against every triangle in dense blocks — branch-free
elementwise work with perfect memory coherence.  `bvh/` supplies the
hierarchical path for big scenes; both share this Moller-Trumbore core.

Shapes: rays are SoA (origin (R,3), dir (R,3)); triangles (T,3,3).  The
triangle loop is a `lax.scan` over static chunks so peak memory is
R * TRI_CHUNK, independent of scene size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

TRI_CHUNK = 512
_EPS_PARALLEL = 1e-12


def _mt_chunk(origin, direction, tri_chunk, t_min, t_max):
    """Moller-Trumbore: (R,3) rays x (C,3,3) triangles -> (R,C) hit data."""
    v0 = tri_chunk[:, 0]  # (C,3)
    e1 = tri_chunk[:, 1] - v0
    e2 = tri_chunk[:, 2] - v0

    d = direction[:, None, :]  # (R,1,3)
    o = origin[:, None, :]
    h = jnp.cross(d, e2[None, :, :])  # (R,C,3)
    a = jnp.sum(e1[None, :, :] * h, axis=-1)  # (R,C)
    parallel = jnp.abs(a) < _EPS_PARALLEL
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = o - v0[None, :, :]
    u = f * jnp.sum(s * h, axis=-1)
    q = jnp.cross(s, e1[None, :, :])
    v = f * jnp.sum(d * q, axis=-1)
    t = f * jnp.sum(e2[None, :, :] * q, axis=-1)
    hit = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min[:, None])
        & (t < t_max[:, None])
    )
    return hit, t, u, v


@partial(jax.jit, static_argnames=("tri_chunk",))
def intersect_closest(
    origin,
    direction,
    tri_pos,
    t_min=None,
    t_max=None,
    active=None,
    tri_chunk: int = TRI_CHUNK,
    woop=None,
):
    """Closest-hit query.

    Returns (t (R,), prim (R,) int32 [-1 = miss], u (R,), v (R,)) where (u,v)
    are the barycentric weights of corners 1 and 2 (reference hitAttribute
    convention, rayhit.rchit:690).

    With `woop` (precomputed (T,12) transforms, ops/woop.py) the test is
    the Woop unit-triangle form; otherwise Moller-Trumbore.
    """
    r = origin.shape[0]
    big = jnp.float32(1e30)
    t_min = jnp.zeros((r,), jnp.float32) if t_min is None else jnp.broadcast_to(t_min, (r,))
    t_max = jnp.full((r,), big) if t_max is None else jnp.broadcast_to(t_max, (r,))
    if active is not None:
        t_max = jnp.where(active, t_max, -big)  # inactive rays hit nothing

    if woop is not None:
        from . import woop as woop_mod

        chunk = min(tri_chunk, woop.shape[0])
        return woop_mod.closest_scan(origin, direction, woop, t_min, t_max, chunk)

    tcount = tri_pos.shape[0]
    chunk = min(tri_chunk, tcount)
    n_chunks = -(-tcount // chunk)
    padded = n_chunks * chunk
    if padded != tcount:  # zero-area padding, never hits
        tri_pos = jnp.concatenate(
            [tri_pos, jnp.zeros((padded - tcount, 3, 3), tri_pos.dtype)], axis=0
        )
    tri_chunks = tri_pos.reshape(n_chunks, chunk, 3, 3)

    def body(carry, tri_block_and_base):
        tri_block, base = tri_block_and_base
        best_t, best_prim, best_u, best_v = carry
        hit, t, u, v = _mt_chunk(origin, direction, tri_block, t_min, t_max)
        t = jnp.where(hit, t, big)
        arg = jnp.argmin(t, axis=1)  # (R,)
        row = jnp.arange(t.shape[0])
        t_new = t[row, arg]
        closer = t_new < best_t
        best_prim = jnp.where(closer, base + arg.astype(jnp.int32), best_prim)
        best_u = jnp.where(closer, u[row, arg], best_u)
        best_v = jnp.where(closer, v[row, arg], best_v)
        best_t = jnp.where(closer, t_new, best_t)
        return (best_t, best_prim, best_u, best_v), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    init = (
        jnp.full((r,), big),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    (t, prim, u, v), _ = jax.lax.scan(body, init, (tri_chunks, bases))
    prim = jnp.where(t < big, prim, -1)
    return t, prim, u, v


@partial(jax.jit, static_argnames=("tri_chunk",))
def intersect_any(
    origin,
    direction,
    tri_pos,
    t_min,
    t_max,
    active=None,
    tri_chunk: int = TRI_CHUNK,
    woop=None,
):
    """Any-hit (shadow) query: True where something lies in (t_min, t_max).

    Mirrors the reference's terminate-on-first-hit shadow ray
    (rayhit.rchit:736-748).
    """
    r = origin.shape[0]
    t_min = jnp.broadcast_to(t_min, (r,))
    t_max = jnp.broadcast_to(t_max, (r,))
    if active is not None:
        t_max = jnp.where(active, t_max, -1.0)

    if woop is not None:
        from . import woop as woop_mod

        chunk = min(tri_chunk, woop.shape[0])
        return woop_mod.any_scan(origin, direction, woop, t_min, t_max, chunk)

    tcount = tri_pos.shape[0]
    chunk = min(tri_chunk, tcount)
    n_chunks = -(-tcount // chunk)
    padded = n_chunks * chunk
    if padded != tcount:
        tri_pos = jnp.concatenate(
            [tri_pos, jnp.zeros((padded - tcount, 3, 3), tri_pos.dtype)], axis=0
        )
    tri_chunks = tri_pos.reshape(n_chunks, chunk, 3, 3)

    def body(carry, tri_block):
        hit, _, _, _ = _mt_chunk(origin, direction, tri_block, t_min, t_max)
        return carry | jnp.any(hit, axis=1), None

    occluded, _ = jax.lax.scan(body, jnp.zeros((r,), bool), tri_chunks)
    return occluded
