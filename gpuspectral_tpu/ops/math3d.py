"""Vectorized 3D math helpers.

Vectors are arrays whose last axis has size 3; all ops broadcast over leading
batch axes.  Conventions follow the reference device code
(pt_common.glsl:122-151) so shading-space results agree.
"""

from __future__ import annotations

import jax.numpy as jnp

# Epsilon floors must satisfy eps**2 > float32 tiny (~1.2e-38): backward
# passes of x/max(y, eps) compute 1/eps^2, which must not overflow to inf.
EPS = 1e-12


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(v):
    # the positive floor keeps d(sqrt)/dx finite at degenerate (masked)
    # lanes — sqrt'(0) = inf would turn 0-cotangents into NaN in backward
    return jnp.sqrt(jnp.maximum(dot(v, v), 1e-24))


def normalize(v):
    return v / jnp.maximum(length(v), EPS)[..., None]


def safe_div(a, b, eps: float = EPS):
    """a/b with sign-preserving clamp of |b| away from zero."""
    mag = jnp.maximum(jnp.abs(b), eps)
    return a / jnp.where(b < 0, -mag, mag)


def faceforward(n, i, nref):
    """GLSL faceforward: n if dot(nref, i) < 0 else -n."""
    return jnp.where(dot(nref, i)[..., None] < 0.0, n, -n)


def reflect_local(wo):
    """Mirror reflection about the local z axis (shading frame)."""
    return jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)


def onb_create(n):
    """Orthonormal basis from a (normalized) normal.

    Matches onbCreate (pt_common.glsl:128-143): binormal is chosen from the
    larger of |n.x|, |n.z| so results are identical to the reference frame.
    Returns (tangent, binormal, normal).
    """
    n = normalize(n)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zeros = jnp.zeros_like(nx)
    b_a = jnp.stack([-ny, nx, zeros], axis=-1)  # |n.x| > |n.z| branch
    b_b = jnp.stack([zeros, -nz, ny], axis=-1)
    b = jnp.where((jnp.abs(nx) > jnp.abs(nz))[..., None], b_a, b_b)
    b = normalize(b)
    t = cross(b, n)
    return t, b, n


def onb_world_to_local(t, b, n, v):
    """World -> shading frame (onbTransform)."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def onb_local_to_world(t, b, n, v):
    """Shading frame -> world (onbUntransform)."""
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def _mat3_apply(m3x3, v):
    # explicit products: a GPU matmul at default precision may run f32
    # operands in TF32 (10 mantissa bits) — geometry cannot afford that
    return jnp.stack(
        [
            m3x3[0, 0] * v[..., 0] + m3x3[0, 1] * v[..., 1] + m3x3[0, 2] * v[..., 2],
            m3x3[1, 0] * v[..., 0] + m3x3[1, 1] * v[..., 1] + m3x3[1, 2] * v[..., 2],
            m3x3[2, 0] * v[..., 0] + m3x3[2, 1] * v[..., 1] + m3x3[2, 2] * v[..., 2],
        ],
        axis=-1,
    )


def transform_points(mat4, pts):
    """Apply a 4x4 homogeneous transform to (..., 3) points."""
    return _mat3_apply(mat4[:3, :3], pts) + mat4[:3, 3]


def transform_dirs(mat4, dirs):
    """Apply a 4x4 transform's linear part to (..., 3) directions."""
    return _mat3_apply(mat4[:3, :3], dirs)


def transform_normals(mat4, normals):
    """Transform normals by the inverse-transpose of the linear part."""
    inv_t = jnp.linalg.inv(mat4[:3, :3]).T
    return _mat3_apply(inv_t, normals)


def is_finite3(v):
    return jnp.all(jnp.isfinite(v), axis=-1)
