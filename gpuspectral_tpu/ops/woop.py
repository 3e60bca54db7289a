"""Woop-transform ray-triangle intersection.

The classic Moller-Trumbore formulation has awkward (R, C, 3)
intermediates.  Woop's unit-triangle transform precomputes, per triangle,
the affine map M that sends the triangle to the unit triangle (v0->origin,
e1->x, e2->y, normal->z); then for a ray (o, d)

    o' = M o + b,   d' = M d
    t  = -o'_z / d'_z
    u  = o'_x + t d'_x,  v = o'_y + t d'_y
    hit = u >= 0 & v >= 0 & u+v <= 1 & t in (t_min, t_max)

Every ray meets every triangle of a chunk as ~10 elementwise ops on (R, C)
planes, which XLA fuses into one loop; the GPU megakernel
(integrator/mega.py) runs the same test per triangle and lane.

Precompute: `woop_transform(tri_pos)` -> (T, 12) rows [Ax, Ay, Az, b].
Degenerate (padding) triangles get A = 0, b = 0 => d'_z = 0 => rejected.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def woop_transform(tri_pos: np.ndarray) -> np.ndarray:
    """(T,3,3) triangles -> (T,12) float32 [M rows x,y,z | b = -M v0]."""
    t = tri_pos.shape[0]
    v0 = tri_pos[:, 0]
    e1 = tri_pos[:, 1] - v0
    e2 = tri_pos[:, 2] - v0
    n = np.cross(e1, e2)
    # columns [e1 e2 n]; M = inverse
    mat = np.stack([e1, e2, n], axis=-1)  # (T,3,3)
    det = np.linalg.det(mat)
    ok = np.abs(det) > 1e-18
    safe = mat.copy()
    safe[~ok] = np.eye(3)
    minv = np.linalg.inv(safe)  # (T,3,3), rows are the Woop map rows… M rows
    minv[~ok] = 0.0
    b = -np.einsum("tij,tj->ti", minv, v0)
    b[~ok] = 0.0
    out = np.concatenate([minv.reshape(t, 9), b], axis=1).astype(np.float32)
    return out


def _chunk_t(origin, direction, woop_chunk, t_min, t_max):
    """(R,3) rays x (C,12) woop rows -> (R,C) t with misses at +inf.

    Pure component-wise broadcasts: every intermediate is a well-tiled
    (R, C) plane (lanes = C); no (R, C, 3) tensors, no tiny-K matmuls.
    Only the z row is needed for t; u/v are recovered per winner later.
    """
    w = woop_chunk
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]  # (R,1)
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    az0, az1, az2, bz = w[None, :, 6], w[None, :, 7], w[None, :, 8], w[None, :, 11]
    opz = ox * az0 + oy * az1 + oz * az2 + bz
    dpz = dx * az0 + dy * az1 + dz * az2
    live = jnp.abs(dpz) > 1e-12
    t = -opz / jnp.where(live, dpz, 1.0)

    ax0, ax1, ax2, bx = w[None, :, 0], w[None, :, 1], w[None, :, 2], w[None, :, 9]
    u = (ox + t * dx) * ax0 + (oy + t * dy) * ax1 + (oz + t * dz) * ax2 + bx
    ay0, ay1, ay2, by = w[None, :, 3], w[None, :, 4], w[None, :, 5], w[None, :, 10]
    v = (ox + t * dx) * ay0 + (oy + t * dy) * ay1 + (oz + t * dz) * ay2 + by

    hit = (
        live
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min[:, None])
        & (t < t_max[:, None])
    )
    return jnp.where(hit, t, jnp.float32(1e30))


def _recover_uv(origin, direction, woop, prim, t):
    """Recompute (u, v) for each ray's winning triangle — (R,) work."""
    w = woop[jnp.maximum(prim, 0)]  # (R,12)
    p = origin + direction * t[:, None]
    u = p[:, 0] * w[:, 0] + p[:, 1] * w[:, 1] + p[:, 2] * w[:, 2] + w[:, 9]
    v = p[:, 0] * w[:, 3] + p[:, 1] * w[:, 4] + p[:, 2] * w[:, 5] + w[:, 10]
    return u, v


def closest_scan(origin, direction, woop, t_min, t_max, chunk: int):
    """Closest-hit over all triangles, scanning chunks of `chunk` rows.
    Returns (t, prim, u, v) with prim = -1 on miss."""
    r = origin.shape[0]
    tcount = woop.shape[0]
    n_chunks = -(-tcount // chunk)
    padded = n_chunks * chunk
    if padded != tcount:
        woop = jnp.concatenate([woop, jnp.zeros((padded - tcount, 12), woop.dtype)])
    woop_chunks = woop.reshape(n_chunks, chunk, 12)
    big = jnp.float32(1e30)

    def body(carry, args):
        woop_block, base = args
        best_t, best_prim = carry
        t = _chunk_t(origin, direction, woop_block, t_min, t_max)
        t_new = jnp.min(t, axis=1)
        arg = jnp.argmin(t, axis=1)
        closer = t_new < best_t
        best_prim = jnp.where(closer, base + arg.astype(jnp.int32), best_prim)
        best_t = jnp.where(closer, t_new, best_t)
        return (best_t, best_prim), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    init = (jnp.full((r,), big), jnp.full((r,), -1, jnp.int32))
    (t, prim), _ = jax.lax.scan(body, init, (woop_chunks, bases))
    prim = jnp.where(t < big, prim, -1)
    u, v = _recover_uv(origin, direction, woop, prim, jnp.where(prim >= 0, t, 0.0))
    u = jnp.where(prim >= 0, u, 0.0)
    v = jnp.where(prim >= 0, v, 0.0)
    return t, prim, u, v


def any_scan(origin, direction, woop, t_min, t_max, chunk: int):
    """Any-hit over all triangles."""
    r = origin.shape[0]
    tcount = woop.shape[0]
    n_chunks = -(-tcount // chunk)
    padded = n_chunks * chunk
    if padded != tcount:
        woop = jnp.concatenate([woop, jnp.zeros((padded - tcount, 12), woop.dtype)])
    woop_chunks = woop.reshape(n_chunks, chunk, 12)

    def body(carry, woop_block):
        t = _chunk_t(origin, direction, woop_block, t_min, t_max)
        return carry | jnp.any(t < 1e30, axis=1), None

    occ, _ = jax.lax.scan(body, jnp.zeros((r,), bool), woop_chunks)
    return occ
