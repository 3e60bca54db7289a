"""Environment emitter: evaluation, importance sampling, and pdf.

The reference declares an `Envmap` struct but never evaluates it — its miss
shader returns nothing (renderer/Scene.h:116-119, assets/shaders/miss.rmiss:15-18,
engine/Loader.cpp:338-346 parses then drops the scene-level emitter).  Here the
capability is completed: lat-long radiance maps (Mitsuba `envmap`) and uniform
`constant` emitters shade on ray miss.

Mapping follows Mitsuba's equirectangular convention (Y-up):

    d' = R_world_to_env @ d
    u  = (1 + atan2(d'.x, -d'.z) / pi) / 2
    v  = acos(clamp(d'.y)) / pi

Bilinear filtering with wrap addressing in u and clamp in v.  On the XLA
wavefront the lookup is a gather per miss lane; the GPU megakernel shades
constant emitters from scalars and small lat-long maps
(<= mega.MEGA_ENV_MAX_TEXELS texels) through per-lane gathers from a texel
table (mega._pack_env_table / make_env_tab_fns) — bigger maps run on the
wavefront.
"""

from __future__ import annotations

import jax.numpy as jnp


def acos_fast(x):
    """Polynomial arccos (Abramowitz & Stegun 4.4.45, |err| <= 6.8e-5 rad —
    far below a texel at any practical map size).

    The env mapping uses THIS implementation on BOTH the XLA wavefront and
    the megakernel, so texel decisions agree across paths and
    interpret-mode parity tests hold bitwise."""
    ax = jnp.abs(x)
    p = jnp.float32(-0.0187293)
    p = p * ax + jnp.float32(0.0742610)
    p = p * ax - jnp.float32(0.2121144)
    p = p * ax + jnp.float32(1.5707288)
    r = jnp.sqrt(jnp.maximum(1.0 - ax, 0.0)) * p
    return jnp.where(x < 0.0, jnp.float32(jnp.pi) - r, r)


def _dir_uv(ex, ey, ez):
    """(u, v) lat-long coordinates of an env-space direction.

    The azimuth uses sign(ex) * arccos(-ez / r) instead of
    atan2(ex, -ez): identical a.e. (ex == 0 resolves to the same 0 / pi
    branch), and the megakernel runs this exact op sequence, so
    interpret-mode parity tests hold bitwise."""
    r = jnp.sqrt(ex * ex + ez * ez)
    c = jnp.clip(-ez / jnp.maximum(r, 1e-20), -1.0, 1.0)
    phi = jnp.where(ex < 0.0, -1.0, 1.0) * acos_fast(c)
    u = (1.0 + phi / jnp.pi) * 0.5
    v = acos_fast(jnp.clip(ey, -1.0, 1.0)) / jnp.pi
    return u, v


def eval_envmap(envmap, rot, direction):
    """Radiance of the environment along world-space `direction`.

    envmap: (H, W, 3) float32 lat-long radiance map (gradients flow into it —
    it is a differentiable scene parameter like any BSDF table).
    rot: (3, 3) world->envmap rotation.
    direction: (R, 3) unit vectors.
    Returns (R, 3) radiance.
    """
    h, w = envmap.shape[0], envmap.shape[1]
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    # explicit products, not a matmul: a TF32 matmul would quantize the
    # direction, and that error shows up as seam wobble near the poles
    ex = rot[0, 0] * dx + rot[0, 1] * dy + rot[0, 2] * dz
    ey = rot[1, 0] * dx + rot[1, 1] * dy + rot[1, 2] * dz
    ez = rot[2, 0] * dx + rot[2, 1] * dy + rot[2, 2] * dz

    u, v = _dir_uv(ex, ey, ez)

    # continuous texel coordinates, texel centers at half-integers
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]

    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    # clamp the *unclamped* row pair so both rows collapse to the edge texel
    # beyond the pole centers (no bleed from the opposite row)
    y0u = y0.astype(jnp.int32)
    y0i = jnp.clip(y0u, 0, h - 1)
    y1i = jnp.clip(y0u + 1, 0, h - 1)

    flat = envmap.reshape(-1, 3)
    c00 = flat[y0i * w + x0i]
    c01 = flat[y0i * w + x1i]
    c10 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    top = c00 * (1.0 - tx) + c01 * tx
    bot = c10 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def sample_envmap(envmap, rot, cdf, pdf_map, u1, u2):
    """Importance-sample a direction from the luminance x sin(theta) texel
    distribution (tables built in scene/data.py:build_scene).

    u1 picks the texel by inverting the flattened CDF; the CDF residual
    (rescaled, independent uniform) and u2 jitter the direction uniformly in
    SOLID ANGLE within the texel (phi uniform; theta by inverting the sin
    density, i.e. cos(theta) uniform over the texel's cosine span) — the
    sampled density is exactly the piecewise-constant pdf_map value.

    Returns (direction (R,3) world-space unit vectors, pdf (R,) per
    steradian)."""
    h, w = pdf_map.shape[0], pdf_map.shape[1]
    n = h * w
    idx = jnp.clip(jnp.searchsorted(cdf, u1, side="left"), 0, n - 1).astype(jnp.int32)
    hi = cdf[idx]
    lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    jv = jnp.clip((u1 - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0)
    y = idx // w
    x = idx - y * w
    u = (x.astype(jnp.float32) + u2) / w
    # inverse of eval_envmap's mapping: u = (1 + atan2(ex,-ez)/pi)/2, v = acos(ey)/pi
    phi = (2.0 * u - 1.0) * jnp.pi
    c0 = jnp.cos(jnp.pi * y.astype(jnp.float32) / h)
    c1 = jnp.cos(jnp.pi * (y.astype(jnp.float32) + 1.0) / h)
    cos_t = c0 + jv * (c1 - c0)
    # cos/sin of theta via identities instead of arccos-then-sin/cos:
    # exact where it matters and the same ops as the megakernel
    ct = jnp.clip(cos_t, -1.0, 1.0)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    e0, e1, e2 = st * jnp.sin(phi), ct, -st * jnp.cos(phi)
    # env->world: rot is world->env, orthonormal, so inverse = transpose.
    # Explicit products in a fixed order (not a matmul) so the megakernel
    # reproduces the direction bitwise in interpret mode.
    d = jnp.stack([
        e0 * rot[0, 0] + e1 * rot[1, 0] + e2 * rot[2, 0],
        e0 * rot[0, 1] + e1 * rot[1, 1] + e2 * rot[2, 1],
        e0 * rot[0, 2] + e1 * rot[1, 2] + e2 * rot[2, 2],
    ], axis=-1)
    pdf = pdf_map.reshape(-1)[idx]
    return d, pdf


def envmap_pdf(pdf_map, rot, direction):
    """Solid-angle pdf that sample_envmap would assign to `direction`
    (nearest texel — the distribution is piecewise constant)."""
    h, w = pdf_map.shape[0], pdf_map.shape[1]
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    ex = rot[0, 0] * dx + rot[0, 1] * dy + rot[0, 2] * dz
    ey = rot[1, 0] * dx + rot[1, 1] * dy + rot[1, 2] * dz
    ez = rot[2, 0] * dx + rot[2, 1] * dy + rot[2, 2] * dz
    u, v = _dir_uv(ex, ey, ez)
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return pdf_map.reshape(-1)[y * w + x]
