"""Brute-force path-tracing megakernel for NVIDIA GPUs (Pallas, Triton route).

The whole path tracer runs in one kernel: raygen (camera rays + progressive
seeding, raygen.rgen:29-41), the bounce loop with closest-hit shading
(rayhit.rchit:666-797), NEE shadow rays, Russian roulette and sample
regeneration.  Each program owns BLOCK rays, one per thread lane, and keeps
their path state in registers for all cfg.spp samples; nothing goes back to
device memory between bounces.  The XLA wavefront
(`path_tracer.trace_wavefront`) instead writes that state to HBM between the
many small fusions of every bounce.

Scene tables (Woop transforms, per-triangle attributes, lights, camera,
environment texels) are passed whole in global memory; they are at most
MEGA_MAX_TRIS rows, so they stay in L1/L2.  The triangle loops read one
triangle's Woop row with scalar loads shared by the block; hit attributes,
light rows and environment texels are per-lane gathers.

Scope: brute-force scenes up to MEGA_MAX_TRIS triangles, untextured, uniform
light selection, no or small environment maps (`mega_eligible`).  Everything
else runs on the XLA wavefront.  Semantics match
`path_tracer.trace_wavefront`: identical counter-based RNG draws (ops/rng.py
is pure elementwise uint32 math and runs unchanged in the kernel), identical
MIS/delta bookkeeping, clamps and epsilons; tests assert the two integrators
agree.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..bsdf.table import (
    BSDF_DIFFUSE,
    BSDF_SMOOTH_DIELECTRIC,
    BSDF_SMOOTH_CONDUCTOR,
    BSDF_SMOOTH_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_SMOOTH_FLOOR,
    BSDF_ROUGH_FLOOR,
    BSDF_ROUGH_PLASTIC,
)
from ..ops import microfacet as mf
from ..ops import rng
from ..scene.data import SceneData
from ..utils.config import RenderConfig

M_PI = jnp.pi
_BIG = 1e30

# Rays per program and warps per program: one ray per thread, so the ~40
# live state planes stay in registers.  Chosen by a sweep of 64/128/256 rays
# x 2/4/8 warps on an H100 at the Cornell headline size (PERF.md): 64 x 2 and
# 128 x 4 were within 3% of each other, and any layout with more threads
# than rays ran 2-4x slower.
BLOCK = 64
NUM_WARPS = 2

# Row strides of the flattened scene tables (see _pack_tables)
_NW = 12  # Woop row: M rows x, y, z | b
_NA = 31  # attribute row
_NL = 12  # light row: 3 vertices | emission
_NE = 5  # environment texel row: rgb | solid-angle pdf | cdf

# Megakernel eligibility: tables must stay cache-resident.  Must not exceed
# bvh/build.SLOT_DENSE_THRESHOLD: above it the SAH build scatters real
# triangles across padded slots with -1 gaps, and this kernel's
# fori(0, num_tris) loops would miss them.
from ..bvh.build import SLOT_DENSE_THRESHOLD as _SLOT_DENSE

MEGA_MAX_TRIS = 2048
assert MEGA_MAX_TRIS <= _SLOT_DENSE, (MEGA_MAX_TRIS, _SLOT_DENSE)

# Largest lat-long envmap the kernel shades itself (texels); bigger maps run
# on the XLA wavefront.
MEGA_ENV_MAX_TEXELS = 2048

# RNG channel layout — MUST match path_tracer.CH_*
_CH_BSDF_SELECT = 0
_CH_BSDF_U1 = 1
_CH_BSDF_U2 = 2
_CH_LIGHT_INDEX = 3
_CH_LIGHT_U1 = 4
_CH_LIGHT_U2 = 5
_CH_RR = 6
_CH_JITTER_X = 7
_CH_JITTER_Y = 8
_CH_ENV_U1 = 9
_CH_ENV_U2 = 10
_CH_ENV_SELECT = 11


# ---------------------------------------------------------------------------
# SoA vector helpers: a vector is a plain (x, y, z) tuple of (BLOCK,)
# arrays, one element per ray; reductions over the component axis are 2-add
# chains inside each thread.
# ---------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _length(a):
    # same guards as ops/math3d.py:length
    return jnp.sqrt(jnp.maximum(_dot(a, a), 1e-24))


def _normalize(a):
    inv = 1.0 / jnp.maximum(_length(a), 1e-12)
    return _scale(a, inv)


def _where3(c, a, b):
    return (
        jnp.where(c, a[0], b[0]),
        jnp.where(c, a[1], b[1]),
        jnp.where(c, a[2], b[2]),
    )


def _finite3(a):
    return jnp.isfinite(a[0]) & jnp.isfinite(a[1]) & jnp.isfinite(a[2])


def _safe_inv(x, eps=1e-12):
    return 1.0 / jnp.maximum(x, eps)


def _safe_div(a, b, eps=1e-12):
    mag = jnp.maximum(jnp.abs(b), eps)
    return a / jnp.where(b < 0, -mag, mag)


def _onb_create(n):
    """SoA port of ops/math3d.py:onb_create (pt_common.glsl:128-143)."""
    n = _normalize(n)
    nx, ny, nz = n
    zeros = jnp.zeros_like(nx)
    use_x = jnp.abs(nx) > jnp.abs(nz)
    b = (
        jnp.where(use_x, -ny, zeros),
        jnp.where(use_x, nx, -nz),
        jnp.where(use_x, zeros, ny),
    )
    b = _normalize(b)
    t = _cross(b, n)
    return t, b, n


def _to_local(t, b, n, v):
    return (_dot(v, t), _dot(v, b), _dot(v, n))


def _to_world(t, b, n, v):
    return (
        t[0] * v[0] + b[0] * v[1] + n[0] * v[2],
        t[1] * v[0] + b[1] * v[1] + n[1] * v[2],
        t[2] * v[0] + b[2] * v[1] + n[2] * v[2],
    )


# ---------------------------------------------------------------------------
# SoA sampling / microfacet (ports of ops/sampling.py + vector parts of
# ops/microfacet.py; scalar microfacet fns are reused from ops/ directly —
# they are pure elementwise jnp and run unchanged inside the kernel).
# ---------------------------------------------------------------------------


def _sample_concentric_disk(u1, u2):
    ux = 2.0 * u1 - 1.0
    uy = 2.0 * u2 - 1.0
    use_x = jnp.abs(ux) > jnp.abs(uy)
    r = jnp.where(use_x, ux, uy)
    th = jnp.where(
        use_x,
        (M_PI / 4.0) * _safe_div(uy, ux),
        M_PI / 2.0 - (M_PI / 4.0) * _safe_div(ux, uy),
    )
    at_origin = (ux == 0.0) & (uy == 0.0)
    x = jnp.where(at_origin, 0.0, r * jnp.cos(th))
    y = jnp.where(at_origin, 0.0, r * jnp.sin(th))
    return x, y


def _sample_cosine_hemisphere(u1, u2):
    x, y = _sample_concentric_disk(u1, u2)
    z = jnp.sqrt(jnp.maximum(1e-24, 1.0 - x * x - y * y))
    return (x, y, z)


def _cosine_pdf(w):
    return jnp.maximum(jnp.abs(w[2]) / M_PI, 1e-6)


def _sample_half_beckmann(u1, u2, alpha):
    phi = 2.0 * M_PI * u1
    log_sample = jnp.log(jnp.maximum(1.0 - u2, 1e-12))
    tan2 = -alpha * alpha * log_sample
    cost = 1.0 / jnp.sqrt(1.0 + tan2)
    sint = jnp.sqrt(jnp.maximum(1e-24, 1.0 - cost * cost))
    return (jnp.cos(phi) * sint, jnp.sin(phi) * sint, cost)


def _power_heuristic(f_pdf, g_pdf):
    f = f_pdf
    g = g_pdf
    denom = f * f + g * g
    return jnp.where(denom > 0.0, f * f / jnp.maximum(denom, 1e-12), 0.0)


def _reflect_local(wo):
    return (-wo[0], -wo[1], wo[2])


def _beckmann_d(wh, alpha):
    cos2 = jnp.maximum(wh[2] * wh[2], 1e-12)
    tan2 = (wh[0] ** 2 + wh[1] ** 2) / cos2
    a = jnp.exp(-tan2 / jnp.maximum(alpha * alpha, 1e-12))
    b = M_PI * alpha * alpha * cos2 * cos2
    return a / jnp.maximum(b, 1e-12)


def _ggx_d(wh, alpha):
    cos2 = wh[2] * wh[2]
    grazing = cos2 <= 1e-12
    cos2s = jnp.maximum(cos2, 1e-12)
    tan2 = (wh[0] ** 2 + wh[1] ** 2) / cos2s
    b = 1.0 + tan2 / jnp.maximum(alpha * alpha, 1e-12)
    a = M_PI * alpha * alpha * cos2s * cos2s * b * b
    return jnp.where(grazing, 0.0, 1.0 / jnp.maximum(a, 1e-12))


def _ggx_lambda(w, alpha):
    cos2 = w[2] * w[2]
    grazing = cos2 <= 1e-12
    cos2s = jnp.maximum(cos2, 1e-12)
    tan2 = (w[0] ** 2 + w[1] ** 2) / cos2s
    a = -1.0 + jnp.sqrt(jnp.maximum(1.0 + alpha * alpha * tan2, 1e-24))
    return jnp.where(grazing, 0.0, 0.5 * a)


def _ggx_masking(wo, wi, alpha):
    return 1.0 / (1.0 + _ggx_lambda(wo, alpha) + _ggx_lambda(wi, alpha))


def _fresnel_conductor_1(cos_th, eta, k):
    """Scalar-channel conductor Fresnel (ops/microfacet.py:fresnel_conductor
    without the RGB trailing axis — SoA kernels carry channels separately)."""
    cos_th = jnp.abs(cos_th)
    cos2 = cos_th * cos_th
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * k2, 1e-24))
    t1 = a2b2 + cos2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 1e-24))
    t2 = 2.0 * a * cos_th
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-12)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def _fresnel_conductor_rgb(cos_th, eta, k):
    """Per-channel conductor Fresnel; eta/k are 3-tuples."""
    return tuple(_fresnel_conductor_1(cos_th, eta[i], k[i]) for i in range(3))


def _refract_local_z(wo, nz, no, nt):
    """refract about (0,0,nz) in the shading frame (mf.refract_local
    specialized to the axis normal the dielectric sampler uses)."""
    sin_tho = jnp.sqrt(jnp.maximum(wo[0] ** 2 + wo[1] ** 2, 1e-24))
    sqrt_term = 1.0 - ((no * no) / (nt * nt)) * (sin_tho * sin_tho)
    ok = sqrt_term > 0.0
    cos_tht = jnp.sqrt(jnp.maximum(jnp.where(ok, sqrt_term, 1.0), 1e-24))
    eta = no / nt
    dot_won = wo[2] * nz
    coef = eta * dot_won - cos_tht
    wt = (-eta * wo[0], -eta * wo[1], -eta * wo[2] + coef * nz)
    return wt, ok


# ---------------------------------------------------------------------------
# SoA BSDF sample/eval — behavior identical to bsdf/dispatch.py (which itself
# cites rayhit.rchit:341-654).  `p` is the tuple of 12 gathered param planes.
# ---------------------------------------------------------------------------


def _s_diffuse(p, wo, u_sel, u1, u2):
    kd = (p[0], p[1], p[2])
    wi = _sample_cosine_hemisphere(u1, u2)
    f = _scale(kd, 1.0 / M_PI)
    pdf = _cosine_pdf(wi)
    return wi, f, pdf, jnp.zeros_like(pdf, bool)


def _s_smooth_dielectric(p, wo, u_sel, u1, u2):
    ior_in = jnp.maximum(p[0], 1e-2)
    ior_out = jnp.maximum(p[1], 1e-2)
    entering = wo[2] > 0.0
    no = jnp.where(entering, ior_out, ior_in)
    nt = jnp.where(entering, ior_in, ior_out)
    cos_tho = wo[2]
    nz = jnp.where(entering, 1.0, -1.0)
    wt, ok = _refract_local_z(wo, nz, no, nt)
    mirror = _reflect_local(wo)
    fr = mf.fresnel_dielectric_exact(no, jnp.abs(cos_tho), nt, jnp.abs(wt[2]))
    fr = jnp.where(ok, fr, 1.0)
    reflecting = (~ok) | (u_sel < fr)
    wi = _where3(reflecting, mirror, wt)
    inv_cos = _safe_inv(jnp.abs(cos_tho))
    f_reflect = jnp.where(ok, fr, 1.0) * inv_cos
    eta2 = (no * no) * _safe_inv(nt * nt)
    f_refract = eta2 * (1.0 - fr) * _safe_inv(jnp.abs(wt[2]))
    f_s = jnp.where(reflecting, f_reflect, f_refract)
    pdf = jnp.where(reflecting, jnp.where(ok, fr, 1.0), 1.0 - fr)
    return wi, (f_s, f_s, f_s), pdf, jnp.ones_like(pdf, bool)


def _s_smooth_conductor(p, wo, u_sel, u1, u2):
    ior_in, ior_out = p[0], p[1]
    aw = jnp.abs(wo[2])
    fr = jnp.where(
        ior_in == 0.0, 1.0, mf.fresnel_dielectric(aw, ior_out, jnp.maximum(ior_in, 1e-6))
    )
    wi = _reflect_local(wo)
    f_s = fr * _safe_inv(aw)
    pdf = jnp.ones_like(fr)
    return wi, (f_s, f_s, f_s), pdf, jnp.ones_like(pdf, bool)


def _s_smooth_floor(p, wo, u_sel, u1, u2):
    kd = (p[0], p[1], p[2])
    r0 = p[3]
    aw = jnp.abs(wo[2])
    fr = mf.schlick_fresnel(r0, aw)
    mirror = _reflect_local(wo)
    wi_d = _sample_cosine_hemisphere(u1, u2)
    spec = u_sel < fr
    wi = _where3(spec, mirror, wi_d)
    coupled = mf.coupled_diffuse_term(r0, aw, jnp.abs(wi[2]))
    f_diff = _scale(kd, coupled)
    f_spec_add = fr * _safe_inv(aw)
    f = _where3(spec, _add(f_diff, (f_spec_add, f_spec_add, f_spec_add)), f_diff)
    pdf = jnp.where(spec, fr, (1.0 - fr) * _cosine_pdf(wi))
    return wi, f, pdf, spec


def _s_smooth_plastic(p, wo, u_sel, u1, u2):
    kd = (p[0], p[1], p[2])
    ior_in, ior_out, r0 = p[3], p[4], p[5]
    no, nt = ior_out, jnp.maximum(ior_in, 1e-6)
    aw = jnp.abs(wo[2])
    fri = mf.fresnel_dielectric(aw, no, nt)
    spec = u_sel < fri
    mirror = _reflect_local(wo)
    wi_d = _sample_cosine_hemisphere(u1, u2)
    wi = _where3(spec, mirror, wi_d)
    fro = mf.fresnel_dielectric(jnp.abs(wi[2]), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    eta = no / nt
    s = (eta * eta * (1.0 - fri) * (1.0 - fro))
    d = tuple(kd[i] * s * _safe_inv(M_PI * (1.0 - kd[i] * ri)) for i in range(3))
    f_spec = fri * _safe_inv(aw)
    f = _where3(spec, (f_spec, f_spec, f_spec), d)
    pdf = jnp.where(spec, fri, (1.0 - fri) * _cosine_pdf(wi))
    return wi, f, pdf, spec


def _rough_common_wi(wo, u_sel, u1, u2, alpha):
    wh = _sample_half_beckmann(u1, u2, alpha)
    wh = _where3(wh[2] <= 0.0, _neg(wh), wh)
    wi_spec = _normalize(_add(_neg(wo), _scale(wh, 2.0 * _dot(wh, wo))))
    wi_d = _sample_cosine_hemisphere(u1, u2)
    use_spec = u_sel < 0.5
    return _where3(use_spec, wi_spec, wi_d)


def _s_rough_conductor(p, wo, u_sel, u1, u2):
    eta = (p[0], p[1], p[2])
    k = (p[3], p[4], p[5])
    refl = (p[6], p[7], p[8])
    alpha = p[9]
    aw = jnp.abs(wo[2])
    fr = _fresnel_conductor_rgb(aw, eta, k)
    wh = _sample_half_beckmann(u1, u2, alpha)
    wh = _where3(wh[2] <= 0.0, _neg(wh), wh)
    wi = _normalize(_add(_neg(wo), _scale(wh, 2.0 * _dot(wh, wo))))
    denom = 4.0 * jnp.abs(wi[2]) * aw
    s = _ggx_d(wh, alpha) * _ggx_masking(wo, wi, alpha) * _safe_inv(denom)
    f = tuple(refl[i] * fr[i] * s for i in range(3))
    pdf = _beckmann_d(wh, alpha) * jnp.abs(wh[2]) * _safe_inv(4.0 * jnp.abs(_dot(wo, wh)))
    return wi, f, pdf, jnp.zeros_like(pdf, bool)


def _rough_plastic_f_pdf(p, wo, wi, eval_clamp):
    kd = (p[0], p[1], p[2])
    ior_in, ior_out, r0, alpha = p[3], p[4], p[5], p[6]
    no, nt = ior_out, jnp.maximum(ior_in, 1e-6)
    eta = no / nt
    wh = _normalize(_add(wi, wo))
    fri = mf.fresnel_dielectric(jnp.abs(_dot(wh, wo)), no, nt)
    fro = mf.fresnel_dielectric(jnp.abs(_dot(wh, wi)), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    spec = (fri * _ggx_d(wh, alpha) * _ggx_masking(wo, wi, alpha)) * _safe_inv(
        4.0 * jnp.abs(wo[2]) * jnp.abs(wi[2])
    )
    s = (1.0 - fri) * (1.0 - fro) * eta * eta
    d = tuple(kd[i] * s * _safe_inv(M_PI * (1.0 - kd[i] * ri)) for i in range(3))
    bd = _beckmann_d(wh, alpha) * jnp.abs(wh[2])
    if eval_clamp:
        bd = jnp.maximum(bd, 0.01)
    pdf = 0.5 * bd * _safe_inv(4.0 * jnp.abs(_dot(wo, wh))) + 0.5 * _cosine_pdf(wi)
    f = tuple(d[i] + spec for i in range(3))
    return f, pdf


def _s_rough_plastic(p, wo, u_sel, u1, u2):
    alpha = p[6]
    wi = _rough_common_wi(wo, u_sel, u1, u2, alpha)
    f, pdf = _rough_plastic_f_pdf(p, wo, wi, eval_clamp=False)
    return wi, f, pdf, jnp.zeros_like(pdf, bool)


def _rough_floor_f_pdf(p, wo, wi):
    kd = (p[0], p[1], p[2])
    r0, alpha = p[3], p[4]
    wh = _normalize(_add(wi, wo))
    fr = mf.schlick_fresnel(r0, jnp.abs(_dot(wo, wh)))
    dterm = mf.fresnel_blend_diffuse_term(r0, jnp.abs(wo[2]), jnp.abs(wi[2]))
    spec = fr * _ggx_d(wh, alpha) * _safe_inv(
        4.0 * jnp.abs(_dot(wo, wh)) * jnp.maximum(jnp.abs(wo[2]), jnp.abs(wi[2]))
    )
    pdf = 0.5 * _beckmann_d(wh, alpha) * jnp.abs(wh[2]) * _safe_inv(
        4.0 * jnp.abs(_dot(wo, wh))
    ) + 0.5 * _cosine_pdf(wi)
    f = tuple(kd[i] * dterm + spec for i in range(3))
    return f, pdf


def _s_rough_floor(p, wo, u_sel, u1, u2):
    alpha = p[4]
    wi = _rough_common_wi(wo, u_sel, u1, u2, alpha)
    f, pdf = _rough_floor_f_pdf(p, wo, wi)
    return wi, f, pdf, jnp.zeros_like(pdf, bool)


_SAMPLERS = {
    BSDF_DIFFUSE: _s_diffuse,
    BSDF_SMOOTH_DIELECTRIC: _s_smooth_dielectric,
    BSDF_SMOOTH_CONDUCTOR: _s_smooth_conductor,
    BSDF_SMOOTH_PLASTIC: _s_smooth_plastic,
    BSDF_ROUGH_CONDUCTOR: _s_rough_conductor,
    BSDF_SMOOTH_FLOOR: _s_smooth_floor,
    BSDF_ROUGH_FLOOR: _s_rough_floor,
    BSDF_ROUGH_PLASTIC: _s_rough_plastic,
}


def _e_diffuse(p, wo, wi):
    pdf = _cosine_pdf(wi)
    return (p[0] / M_PI, p[1] / M_PI, p[2] / M_PI), pdf, jnp.zeros_like(pdf, bool)


def _e_delta(p, wo, wi):
    z = jnp.zeros_like(wo[2])
    return (z, z, z), jnp.ones_like(z), jnp.ones_like(z, bool)


def _e_smooth_floor(p, wo, wi):
    kd = (p[0], p[1], p[2])
    r0 = p[3]
    aw = jnp.abs(wo[2])
    fr = mf.schlick_fresnel(r0, aw)
    c = mf.coupled_diffuse_term(r0, aw, jnp.abs(wi[2]))
    f = _scale(kd, c)
    pdf = (1.0 - fr) * _cosine_pdf(wi)
    return f, pdf, jnp.zeros_like(pdf, bool)


def _e_smooth_plastic(p, wo, wi):
    kd = (p[0], p[1], p[2])
    ior_in, ior_out, r0 = p[3], p[4], p[5]
    no, nt = ior_out, jnp.maximum(ior_in, 1e-6)
    fri = mf.fresnel_dielectric(jnp.abs(wo[2]), no, nt)
    fro = mf.fresnel_dielectric(jnp.abs(wi[2]), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    eta = no / nt
    s = (1.0 - fri) * (1.0 - fro) * eta * eta
    f = tuple(kd[i] * s * _safe_inv(M_PI * (1.0 - kd[i] * ri)) for i in range(3))
    pdf = (1.0 - fri) * _cosine_pdf(wi)
    return f, pdf, jnp.zeros_like(pdf, bool)


def _e_rough_conductor(p, wo, wi):
    eta = (p[0], p[1], p[2])
    k = (p[3], p[4], p[5])
    refl = (p[6], p[7], p[8])
    alpha = p[9]
    aw = jnp.abs(wo[2])
    fr = _fresnel_conductor_rgb(aw, eta, k)
    wh = _normalize(_add(wo, wi))
    denom = 4.0 * jnp.abs(wi[2]) * aw
    s = _ggx_d(wh, alpha) * _ggx_masking(wo, wi, alpha) * _safe_inv(denom)
    f = tuple(fr[i] * refl[i] * s for i in range(3))
    pdf = _beckmann_d(wh, alpha) * jnp.abs(wh[2]) * _safe_inv(4.0 * jnp.abs(_dot(wo, wh)))
    return f, pdf, jnp.zeros_like(pdf, bool)


def _e_rough_plastic(p, wo, wi):
    f, pdf = _rough_plastic_f_pdf(p, wo, wi, eval_clamp=True)
    return f, pdf, jnp.zeros_like(pdf, bool)


def _e_rough_floor(p, wo, wi):
    f, pdf = _rough_floor_f_pdf(p, wo, wi)
    return f, pdf, jnp.zeros_like(pdf, bool)


_EVALS = {
    BSDF_DIFFUSE: _e_diffuse,
    BSDF_SMOOTH_DIELECTRIC: _e_delta,
    BSDF_SMOOTH_CONDUCTOR: _e_delta,
    BSDF_SMOOTH_PLASTIC: _e_smooth_plastic,
    BSDF_ROUGH_CONDUCTOR: _e_rough_conductor,
    BSDF_SMOOTH_FLOOR: _e_smooth_floor,
    BSDF_ROUGH_FLOOR: _e_rough_floor,
    BSDF_ROUGH_PLASTIC: _e_rough_plastic,
}


def _sample_bsdf_soa(present, p, kind, wo, u_sel, u1, u2):
    if len(present) == 1:
        return _SAMPLERS[present[0]](p, wo, u_sel, u1, u2)
    z = jnp.zeros_like(wo[2])
    wi = (z, z, z)
    f = (z, z, z)
    pdf = jnp.ones_like(z)
    delta = jnp.zeros_like(z, jnp.bool_)
    for t in present:
        wi_t, f_t, pdf_t, d_t = _SAMPLERS[t](p, wo, u_sel, u1, u2)
        sel = kind == t
        wi = _where3(sel, wi_t, wi)
        f = _where3(sel, f_t, f)
        pdf = jnp.where(sel, pdf_t, pdf)
        delta = delta | (sel & d_t)
    return wi, f, pdf, delta


def _eval_bsdf_soa(present, p, kind, wo, wi):
    if len(present) == 1:
        return _EVALS[present[0]](p, wo, wi)
    z = jnp.zeros_like(wo[2])
    f = (z, z, z)
    pdf = jnp.ones_like(z)
    delta = jnp.zeros_like(z, jnp.bool_)
    for t in present:
        f_t, pdf_t, d_t = _EVALS[t](p, wo, wi)
        sel = kind == t
        f = _where3(sel, f_t, f)
        pdf = jnp.where(sel, pdf_t, pdf)
        delta = delta | (sel & d_t)
    return f, pdf, delta



# ---------------------------------------------------------------------------
# Table packing (device-side, jit-traceable)
# ---------------------------------------------------------------------------


def _pack_env_table(scene: SceneData):
    """Flat (n * _NE,) f32 texel table: rows of rgb radiance, solid-angle
    pdf and the flattened importance-sampling CDF (envmap.sample_envmap)."""
    h, w = scene.envmap.shape[:2]
    n = h * w
    f32 = jnp.float32
    return jnp.concatenate([
        scene.envmap.reshape(n, 3).astype(f32),
        scene.envmap_pdf.reshape(n, 1).astype(f32),
        scene.envmap_cdf.reshape(n, 1).astype(f32),
    ], axis=1).reshape(-1)


def make_env_tab_fns(env_ref, h: int, w: int):
    """Kernel-side lookups into the _pack_env_table texel table, as per-lane
    gathers.  Returns dict(sample, rgb, pdf, h, w) consumed by
    make_bounce_body's image-env branches."""
    n = h * w

    def col(idx, c):
        return env_ref[idx * _NE + c]

    def sample(u1):
        """CDF inversion of the uniforms u1: the texel index is
        clip(searchsorted(cdf, u1, 'left'), 0, n - 1), found by a binary
        search over the table's cdf column, exactly as
        envmap.sample_envmap.  Returns the texel pdf, residual bounds and
        coordinates."""
        lo = jnp.zeros(u1.shape, jnp.int32)
        hi = jnp.full(u1.shape, n, jnp.int32)
        for _ in range(n.bit_length()):
            active = lo < hi
            mid = (lo + hi) >> 1
            below = col(jnp.minimum(mid, n - 1), 4) < u1
            lo = jnp.where(active & below, mid + 1, lo)
            hi = jnp.where(active & (~below), mid, hi)
        idx = jnp.minimum(lo, n - 1)
        y = idx // w
        x = idx - y * w
        return dict(
            pdf=col(idx, 3),
            hi=col(idx, 4),
            lo=jnp.where(idx > 0, col(jnp.maximum(idx - 1, 0), 4), 0.0),
            x=x.astype(jnp.float32),
            y=y.astype(jnp.float32),
        )

    def rgb(idx):
        """Radiance of per-lane flat texel indices (int32)."""
        return col(idx, 0), col(idx, 1), col(idx, 2)

    def pdf(idx):
        return col(idx, 3)

    return dict(sample=sample, rgb=rgb, pdf=pdf, h=h, w=w)


def _pack_tables(scene: SceneData):
    """Flatten the scene tables the kernel reads (row-major, one row per
    triangle / light).

    attr rows: 0-8 corner normals (n0 n1 n2), 9-11 emission, 12 twofaced,
    13 light idx, 14 bsdf kind, 15-26 bsdf params, 27-29 geometric normal,
    30 triangle area.
    """
    t = scene.tri_pos.shape[0]
    e1 = scene.tri_pos[:, 1] - scene.tri_pos[:, 0]
    e2 = scene.tri_pos[:, 2] - scene.tri_pos[:, 0]
    cr = jnp.cross(e1, e2)
    crl = jnp.sqrt(jnp.maximum(jnp.sum(cr * cr, -1), 1e-24))
    gn = cr / jnp.maximum(crl, 1e-12)[:, None]
    area = 0.5 * crl
    f32 = jnp.float32
    attr = jnp.concatenate(
        [
            scene.tri_nrm.reshape(t, 9),
            scene.tri_emission,
            scene.tri_twofaced[:, None].astype(f32),
            scene.tri_light_idx[:, None].astype(f32),
            scene.bsdf_kind[scene.tri_bsdf][:, None].astype(f32),
            scene.bsdf_params[scene.tri_bsdf],
            gn,
            area[:, None],
        ],
        axis=1,
    )  # (T, _NA)
    light = jnp.concatenate(
        [scene.light_pos.reshape(-1, 9), scene.light_emission], axis=1)
    cam = scene.camera
    # 0-8 camera rotation, 9-11 origin, 12 fov, 13-15 constant-env
    # radiance, 16-24 world->env rotation, 25 env texel solid-angle pdf
    # (zeros when no envmap; only read by kernels compiled for
    # constant-env scenes)
    camv = jnp.concatenate([
        cam.to_world[:3, :3].reshape(9), cam.to_world[:3, 3], cam.fov[None],
        scene.envmap.reshape(-1)[0:3], scene.envmap_rot.reshape(9),
        scene.envmap_pdf.reshape(-1)[0:1],
    ])
    return (scene.tri_woop.reshape(-1), attr.reshape(-1), light.reshape(-1),
            camv)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _env_eval_tab(tab, rot, d, want_pdf: bool):
    """Lat-long environment lookup on per-lane direction planes: bilinear
    radiance (+ nearest-texel pdf when want_pdf) through the env-table
    closures of make_env_tab_fns.  Reproduces envmap.eval_envmap /
    envmap_pdf op-for-op, with the same polynomial arccos (envmap._dir_uv)
    so texel decisions agree with the wavefront."""
    from .envmap import acos_fast

    h, w = tab["h"], tab["w"]
    dx, dy, dz = d
    ex = rot[0] * dx + rot[1] * dy + rot[2] * dz
    ey = rot[3] * dx + rot[4] * dy + rot[5] * dz
    ez = rot[6] * dx + rot[7] * dy + rot[8] * dz
    r = jnp.sqrt(ex * ex + ez * ez)
    c = jnp.clip(-ez / jnp.maximum(r, 1e-20), -1.0, 1.0)
    phi = jnp.where(ex < 0.0, -1.0, 1.0) * acos_fast(c)
    u = (1.0 + phi / M_PI) * 0.5
    v = acos_fast(jnp.clip(ey, -1.0, 1.0)) / M_PI

    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    # u in [0,1] puts x0 in [-1, w-1]: one-step wrap == jnp.mod here
    x0i = x0 + jnp.where(x0 < 0.0, float(w), 0.0)
    x1i = x0i + 1.0
    x1i = jnp.where(x1i >= w, x1i - w, x1i)
    y0c = jnp.clip(y0, 0.0, h - 1.0)
    y1c = jnp.clip(y0 + 1.0, 0.0, h - 1.0)
    toi = lambda a: a.astype(jnp.int32)  # noqa: E731
    c00 = tab["rgb"](toi(y0c * w + x0i))
    c01 = tab["rgb"](toi(y0c * w + x1i))
    c10 = tab["rgb"](toi(y1c * w + x0i))
    c11 = tab["rgb"](toi(y1c * w + x1i))
    out = tuple(
        (c00[k] * (1.0 - tx) + c01[k] * tx) * (1.0 - ty)
        + (c10[k] * (1.0 - tx) + c11[k] * tx) * ty
        for k in range(3))
    pdfv = None
    if want_pdf:
        xn = jnp.clip(jnp.floor(u * w), 0.0, w - 1.0)
        yn = jnp.clip(jnp.floor(v * h), 0.0, h - 1.0)
        pdfv = tab["pdf"](toi(yn * w + xn))
    return out, pdfv


def make_bounce_body(cfg: RenderConfig, present: tuple, *, closest, any_hit,
                     pick_light, fresh, spp, env=None):
    """The per-bounce shading + MIS/RR/regeneration state machine.

    The scene access is injected as closures:

      closest(o, d, alive) -> (t, hit, bu, bv, attrs)   attrs = _NA planes
      any_hit(o, d, t_min, t_max, active) -> occluded bool planes
      pick_light(seed, bounce) -> (lv0, lv1, lv2, lemit, select_pdf); the
          selection is uniform, so select_pdf is also the selection pdf
          of any emitter a BSDF ray hits
      fresh(sample) -> (o, d, seed)  per-pixel ray regeneration
      env: environment emitter: dict(const=(er,eg,eb) scalars, rot=(9
           scalars, world->env), pdf=<texel solid-angle pdf scalar>,
           p_env=<static float>, has_area=<static bool>, and — for image
           lat-long maps — tab=make_env_tab_fns(...) closures).  NEE
           mixes the env strategy with probability p_env (constant maps
           sample uniform-in-solid-angle; image maps invert the texel
           CDF) and misses shade the environment radiance, MIS-discounted
           exactly as path_tracer (same RNG channels, same op order).

    Semantics follow rayhit.rchit:666-797 + raygen.rgen:51-91 exactly, as
    path_tracer.trace_wavefront does (tests assert equivalence)."""
    uniform = rng.uniform

    def body(st):
        bounce = st["depth"]
        seed = st["seed"]
        alive = ~st["done"]
        o = (st["ox"], st["oy"], st["oz"])
        d = (st["dx"], st["dy"], st["dz"])

        t, hit, bu, bv, a = closest(o, d, alive)
        miss = (~hit) & alive

        n0 = (a[0], a[1], a[2])
        n1 = (a[3], a[4], a[5])
        n2 = (a[6], a[7], a[8])
        emission = (a[9], a[10], a[11])
        twofaced = a[12] > 0.5
        p = a[15:27]
        if len(present) == 1:  # kind row not gathered; constant
            kind = jnp.full(t.shape, present[0], jnp.int32)
        else:
            # kinds are small exact integers stored as f32
            kind = a[14].astype(jnp.int32)
        gn = (a[27], a[28], a[29])

        zb = jnp.zeros_like(t, jnp.bool_)

        t_safe = jnp.where(hit, t, 1.0)
        position = _add(o, _scale(d, t_safe))

        bw = 1.0 - bu - bv
        sn = _normalize(_add(_add(_scale(n0, bw), _scale(n1, bu)), _scale(n2, bv)))
        # orient interpolated normal into the geometric hemisphere
        # (path_tracer.py bounce step)
        sn = _where3(_dot(sn, gn) < 0.0, _neg(sn), sn)

        backface = _dot(gn, _neg(d)) < 0.0
        emissive = (emission[0] != 0.0) | (emission[1] != 0.0) | (emission[2] != 0.0)
        flip = backface & twofaced & (~emissive)
        gn = _where3(flip, _neg(gn), gn)
        sn = _where3(flip, _neg(sn), sn)

        tg, bn, nn = _onb_create(sn)
        wo = _normalize(_to_local(tg, bn, nn, _neg(d)))

        u_sel = uniform(seed, bounce, _CH_BSDF_SELECT)
        u1 = uniform(seed, bounce, _CH_BSDF_U1)
        u2 = uniform(seed, bounce, _CH_BSDF_U2)
        wi_local, f, pdf, delta = _sample_bsdf_soa(present, p, kind, wo, u_sel, u1, u2)
        now_ = jnp.abs(wi_local[2])
        wi_world = _to_world(tg, bn, nn, wi_local)
        transmission = kind == BSDF_SMOOTH_DIELECTRIC

        # --- light sampling ---
        lv0, lv1, lv2, lemit, select_pdf = pick_light(seed, bounce)
        lu1 = uniform(seed, bounce, _CH_LIGHT_U1)
        lu2 = uniform(seed, bounce, _CH_LIGHT_U2)
        # ops/sampling.py:sample_triangle_light
        su = jnp.sqrt(jnp.maximum(lu1, 0.0))
        lbu = 1.0 - su
        lbv = lu2 * su
        lbw = 1.0 - lbu - lbv
        lcr = _cross(_sub(lv2, lv0), _sub(lv1, lv0))
        larea = 0.5 * jnp.abs(_length(lcr))
        lnormal = _normalize(_cross(_sub(lv1, lv0), _sub(lv2, lv0)))
        light_pos = _add(_add(_scale(lv0, lbu), _scale(lv1, lbv)), _scale(lv2, lbw))
        ldelta = _sub(light_pos, position)
        ldist = _length(ldelta)
        ldir = _scale(ldelta, 1.0 / jnp.maximum(ldist, 1e-12))
        cos_light = _dot(_neg(ldir), lnormal)
        lfront = jnp.where(cos_light > 0.0, 1.0, 0.0)
        light_emitted = _scale(lemit, lfront)
        light_pdf = ldist * ldist / jnp.maximum(jnp.abs(cos_light) * larea, 1e-12)
        light_pdf = light_pdf * select_pdf

        p_env = env["p_env"] if (env and cfg.nee) else 0.0
        env_tab = env.get("tab") if env else None
        if env and cfg.nee:
            # env NEE strategy (path_tracer env mixture): constant (1x1)
            # emitters sample uniform-in-solid-angle; image maps invert the
            # texel CDF — both reproduce the ops/order of
            # integrator/envmap.py:sample_envmap exactly
            eu1 = uniform(seed, bounce, _CH_ENV_U1)
            eu2 = uniform(seed, bounce, _CH_ENV_U2)
            if env["has_area"]:
                env_pick = uniform(seed, bounce, _CH_ENV_SELECT) < p_env
            else:
                env_pick = jnp.ones_like(hit)
            if env_tab:
                s_env = env_tab["sample"](eu1)
                jv = jnp.clip(
                    (eu1 - s_env["lo"])
                    / jnp.maximum(s_env["hi"] - s_env["lo"], 1e-12),
                    0.0, 1.0)
                uu = (s_env["x"] + eu2) / env_tab["w"]
                phi = (2.0 * uu - 1.0) * M_PI
                c0_ = jnp.cos(M_PI * s_env["y"] / env_tab["h"])
                c1_ = jnp.cos(M_PI * (s_env["y"] + 1.0) / env_tab["h"])
                cos_t = c0_ + jv * (c1_ - c0_)
            else:
                jv = jnp.clip(eu1 / jnp.maximum(1.0, 1e-12), 0.0, 1.0)
                phi = (2.0 * eu2 - 1.0) * M_PI
                cos_t = 1.0 + jv * (-1.0 - 1.0)
            # identities instead of arccos-then-sin/cos, as
            # envmap.sample_envmap
            ct_ = jnp.clip(cos_t, -1.0, 1.0)
            st_ = jnp.sqrt(jnp.maximum(1.0 - ct_ * ct_, 0.0))
            ee = (st_ * jnp.sin(phi), ct_, -st_ * jnp.cos(phi))
            rot = env["rot"]  # 9 scalars, world->env; env->world = transpose
            env_dir = (
                ee[0] * rot[0] + ee[1] * rot[3] + ee[2] * rot[6],
                ee[0] * rot[1] + ee[1] * rot[4] + ee[2] * rot[7],
                ee[0] * rot[2] + ee[1] * rot[5] + ee[2] * rot[8],
            )
            if env_tab:
                env_l, _ = _env_eval_tab(env_tab, env["rot"], env_dir,
                                         want_pdf=False)
                env_pdf_v = s_env["pdf"]
            else:
                er, eg, eb = env["const"]
                env_l = (jnp.zeros_like(ldist) + er,
                         jnp.zeros_like(ldist) + eg,
                         jnp.zeros_like(ldist) + eb)
                env_pdf_v = env["pdf"]
            ldir = _where3(env_pick, env_dir, ldir)
            ldist = jnp.where(env_pick, jnp.float32(1e30), ldist)
            light_emitted = _where3(env_pick, env_l, light_emitted)
            light_pdf = jnp.where(env_pick, env_pdf_v * p_env,
                                  light_pdf * (1.0 - p_env))

        w_light_local = _to_local(tg, bn, nn, ldir)
        nol = jnp.abs(_dot(sn, ldir))
        f_light, _lpdf, _ld = _eval_bsdf_soa(present, p, kind, wo, w_light_local)

        front_ok = (_dot(gn, _neg(d)) > 0.0) & (_dot(gn, ldir) > 0.0)
        nee_candidate = hit & (~delta) & (front_ok | transmission) if cfg.nee else zb

        shadowed = any_hit(
            position, ldir,
            jnp.full(t.shape, cfg.shadow_epsilon, jnp.float32),
            ldist - cfg.shadow_epsilon,
            nee_candidate,
        )
        nee_done = nee_candidate & (~shadowed) & (light_pdf != 0.0)

        if env and cfg.nee:
            # env strategy uses the exact eval pdf at the NEE direction
            # (path_tracer note: the reference's sampled-pdf quirk is kept
            # for area lights only)
            mis_bsdf_pdf = jnp.where(env_pick, _lpdf, pdf)
        else:
            mis_bsdf_pdf = pdf
        w_mis = _power_heuristic(light_pdf, mis_bsdf_pdf)
        inv_lpdf = _safe_inv(light_pdf)
        nee_s = w_mis * nol * inv_lpdf
        weight = (st["wr"], st["wg"], st["wb"])
        e_r = jnp.where(nee_done, nee_s * f_light[0] * weight[0] * light_emitted[0], 0.0)
        e_g = jnp.where(nee_done, nee_s * f_light[1] * weight[1] * light_emitted[1], 0.0)
        e_b = jnp.where(nee_done, nee_s * f_light[2] * weight[2] * light_emitted[2], 0.0)

        # emitter accumulation w/ MIS bookkeeping (rayhit.rchit:760-768)
        light_flag = jnp.where(_dot(gn, _neg(d)) > 0.0, 1.0, 0.0)
        ce = st["count_emitted"]
        wd = st["was_delta"]
        se_r = emission[0] * light_flag * weight[0]
        se_g = emission[1] * light_flag * weight[1]
        se_b = emission[2] * light_flag * weight[2]
        if cfg.nee and cfg.mis_mode == "exact":
            area_hit = a[30]
            cos_hit = jnp.abs(_dot(gn, _neg(d)))
            sel_hit = select_pdf
            if env:
                sel_hit = sel_hit * (1.0 - p_env)  # env/area mixture
            pdf_hit = t_safe * t_safe / jnp.maximum(cos_hit * area_hit, 1e-12) * sel_hit
            w_emit = jnp.where(
                st["prev_nee"], _power_heuristic(st["prev_pdf"], pdf_hit), 1.0
            )
            emit_w = jnp.where((~ce) & (~wd), w_emit, 1.0)
        elif cfg.nee:
            emit_w = jnp.where((~ce) & (~wd), st["direct_weight"], 1.0)
        else:
            emit_w = 1.0
        e_r = e_r + emit_w * se_r
        e_g = e_g + emit_w * se_g
        e_b = e_b + emit_w * se_b
        e_r = jnp.where(hit, e_r, 0.0)
        e_g = jnp.where(hit, e_g, 0.0)
        e_b = jnp.where(hit, e_b, 0.0)
        if env:
            # environment radiance on miss, MIS-discounted against the env
            # NEE strategy (path_tracer env-miss block; miss.rmiss:15-18
            # stubs this in the reference).  Image maps evaluate bilinear
            # radiance + nearest-texel pdf at the miss direction
            # (envmap.eval_envmap/envmap_pdf ops).
            if env_tab:
                (er, eg, eb), m_pdf = _env_eval_tab(
                    env_tab, env["rot"], d, want_pdf=cfg.nee)
                pdf_e = (m_pdf * p_env) if cfg.nee else None
            else:
                er, eg, eb = env["const"]
                pdf_e = env["pdf"] * p_env if cfg.nee else None
            if cfg.nee:
                w_env = jnp.where(
                    st["prev_nee_any"] & (~wd),
                    _power_heuristic(st["prev_pdf"], pdf_e), 1.0)
                scale_env = jnp.where(ce, 1.0, w_env)
            else:
                scale_env = 1.0
            mf_ = jnp.where(miss, scale_env, 0.0)
            e_r = e_r + mf_ * weight[0] * er
            e_g = e_g + mf_ * weight[1] * eg
            e_b = e_b + mf_ * weight[2] * eb

        invalid_hemi = (_dot(wi_world, gn) <= 0.0) & (~transmission)
        self_isect = (_dot(gn, _neg(d)) <= 0.0) & (~transmission)
        bad_pdf = (~jnp.isfinite(pdf)) | (~_finite3(f)) | (pdf == 0.0)
        terminate = hit & (invalid_hemi | self_isect | bad_pdf)

        new_direct_weight = jnp.where(nee_done, _power_heuristic(pdf, light_pdf), 1.0)

        # faceforward(gn, -wi, gn): gn if dot(gn, -wi) < 0 else -gn
        off = _where3(_dot(gn, _neg(wi_world)) < 0.0, gn, _neg(gn))
        new_o = _add(position, _scale(off, cfg.origin_epsilon))
        w_s = now_ * _safe_inv(pdf)
        new_w = (weight[0] * f[0] * w_s, weight[1] * f[1] * w_s, weight[2] * f[2] * w_s)

        cont = hit & (~terminate)
        st = dict(st)
        st["rays"] = st["rays"] + jnp.where(alive, 1, 0) + jnp.where(nee_candidate, 1, 0)
        st["ox"] = jnp.where(cont, new_o[0], o[0])
        st["oy"] = jnp.where(cont, new_o[1], o[1])
        st["oz"] = jnp.where(cont, new_o[2], o[2])
        st["dx"] = jnp.where(cont, wi_world[0], d[0])
        st["dy"] = jnp.where(cont, wi_world[1], d[1])
        st["dz"] = jnp.where(cont, wi_world[2], d[2])
        st["wr"] = jnp.where(cont, new_w[0], weight[0])
        st["wg"] = jnp.where(cont, new_w[1], weight[1])
        st["wb"] = jnp.where(cont, new_w[2], weight[2])
        st["direct_weight"] = jnp.where(cont, new_direct_weight, st["direct_weight"])
        st["prev_pdf"] = jnp.where(cont, pdf, st["prev_pdf"])
        st["prev_nee"] = jnp.where(cont, nee_done, st["prev_nee"])
        if env:
            st["prev_nee_any"] = jnp.where(cont, nee_candidate, st["prev_nee_any"])
        st["was_delta"] = jnp.where(cont, delta, wd)
        st["count_emitted"] = jnp.where(cont, False, ce)
        st["done"] = st["done"] | miss | terminate

        keep = (e_r < cfg.firefly_clamp) & (e_g < cfg.firefly_clamp) & (e_b < cfg.firefly_clamp)
        acc = alive & keep
        st["rad_r"] = st["rad_r"] + jnp.where(acc, e_r, 0.0)
        st["rad_g"] = st["rad_g"] + jnp.where(acc, e_g, 0.0)
        st["rad_b"] = st["rad_b"] + jnp.where(acc, e_b, 0.0)

        if_rr = bounce > jnp.uint32(cfg.rr_start_depth)
        q = jnp.clip(jnp.maximum(jnp.maximum(st["wr"], st["wg"]), st["wb"]),
                     cfg.rr_clamp_min, 1.0)
        u_rr = uniform(seed, bounce, _CH_RR)
        rr_kill = if_rr & (u_rr > q)
        rr_keep = if_rr & (~rr_kill)
        inv_q = 1.0 / q
        st["wr"] = jnp.where(rr_keep, st["wr"] * inv_q, st["wr"])
        st["wg"] = jnp.where(rr_keep, st["wg"] * inv_q, st["wg"])
        st["wb"] = jnp.where(rr_keep, st["wb"] * inv_q, st["wb"])
        st["done"] = st["done"] | rr_kill

        # depth advance + per-path cutoff + regeneration
        # (path_tracer.trace_wavefront body)
        depth = bounce + 1
        done = st["done"] | (depth >= jnp.uint32(cfg.max_depth + 1))
        regen = done & (st["sample"] + 1 < spp)
        new_sample = jnp.where(regen, st["sample"] + 1, st["sample"])
        o_n, d_n, seed_n = fresh(new_sample)
        st["ox"] = jnp.where(regen, o_n[0], st["ox"])
        st["oy"] = jnp.where(regen, o_n[1], st["oy"])
        st["oz"] = jnp.where(regen, o_n[2], st["oz"])
        st["dx"] = jnp.where(regen, d_n[0], st["dx"])
        st["dy"] = jnp.where(regen, d_n[1], st["dy"])
        st["dz"] = jnp.where(regen, d_n[2], st["dz"])
        st["seed"] = jnp.where(regen, seed_n, st["seed"])
        st["wr"] = jnp.where(regen, 1.0, st["wr"])
        st["wg"] = jnp.where(regen, 1.0, st["wg"])
        st["wb"] = jnp.where(regen, 1.0, st["wb"])
        st["direct_weight"] = jnp.where(regen, 1.0, st["direct_weight"])
        st["prev_pdf"] = jnp.where(regen, 1.0, st["prev_pdf"])
        st["prev_nee"] = st["prev_nee"] & (~regen)
        if env:
            st["prev_nee_any"] = st["prev_nee_any"] & (~regen)
        st["was_delta"] = st["was_delta"] & (~regen)
        st["count_emitted"] = st["count_emitted"] | regen
        st["depth"] = jnp.where(regen, jnp.uint32(0), depth)
        st["sample"] = new_sample
        st["done"] = done & (~regen)
        st["it"] = st["it"] + 1
        return st

    return body


def _make_kernel(cfg: RenderConfig, n_tris: int, n_lights: int, present: tuple,
                 has_env: bool = False, has_area: bool = True,
                 env_hw=None):
    """Returns the kernel closure.  All shape/config values are static; the
    progressive timestamp arrives as a traced scalar so successive frames
    reuse one executable (raygen.rgen:37 semantics).  env_hw: (h, w) of an
    image envmap — the kernel then takes an extra texel-table input (see
    _pack_env_table); None = constant-env / no-env path."""
    width, height = cfg.width, cfg.height
    spp = cfg.spp
    max_iters = spp * (cfg.max_depth + 1)
    # attr rows actually consumed by this (scene, config): rows the present
    # BSDF set never reads are not gathered (e.g. diffuse-only Cornell
    # reads 19 of 31 rows)
    _params_used = {
        BSDF_DIFFUSE: 3, BSDF_SMOOTH_DIELECTRIC: 2, BSDF_SMOOTH_CONDUCTOR: 2,
        BSDF_SMOOTH_PLASTIC: 6, BSDF_ROUGH_CONDUCTOR: 10, BSDF_SMOOTH_FLOOR: 4,
        BSDF_ROUGH_FLOOR: 5, BSDF_ROUGH_PLASTIC: 7,
    }
    nparams = max(_params_used[k] for k in present)
    needed_rows = frozenset(
        list(range(0, 13))  # corner normals, emission, twofaced
        + ([14] if len(present) > 1 else [])  # kind (single-kind: constant)
        + list(range(15, 15 + nparams))  # bsdf params
        + list(range(27, 30))  # geometric normal
        + ([30] if (cfg.nee and cfg.mis_mode == "exact") else [])  # area
    )

    def kernel(pix_ref, woop_ref, attr_ref, light_ref, cam_ref, ts_ref,
               *rest):
        if env_hw:
            env_ref, rad_r_ref, rad_g_ref, rad_b_ref, rays_ref = rest
        else:
            rad_r_ref, rad_g_ref, rad_b_ref, rays_ref = rest
        t0 = ts_ref[0]  # uint32 scalar (progressive frame base)
        pix = pix_ref[...]  # uint32 pixel ids
        zf = jnp.zeros(pix.shape, jnp.float32)
        zb = jnp.zeros(pix.shape, jnp.bool_)

        # camera constants (scalar loads)
        r00, r01, r02 = cam_ref[0], cam_ref[1], cam_ref[2]
        r10, r11, r12 = cam_ref[3], cam_ref[4], cam_ref[5]
        r20, r21, r22 = cam_ref[6], cam_ref[7], cam_ref[8]
        cox, coy, coz = cam_ref[9], cam_ref[10], cam_ref[11]
        fov = cam_ref[12]
        zplane = (max(width, height) / 2.0) / jnp.tan(fov / 2.0)

        def fresh(sample):
            # scene/camera.py:generate_rays + per-sample seed (raygen.rgen:37)
            seed = rng.pixel_seed(pix, t0 + sample)
            px = (pix % width).astype(jnp.float32)
            py = (pix // width).astype(jnp.float32)
            if cfg.jitter:
                px = px + rng.uniform(seed, jnp.uint32(0xFFFF), _CH_JITTER_X)
                py = py + rng.uniform(seed, jnp.uint32(0xFFFF), _CH_JITTER_Y)
            xx = px - width / 2.0
            yy = py - height / 2.0
            inv = jax.lax.rsqrt(xx * xx + yy * yy + zplane * zplane)
            # Mitsuba convention (-xx, -yy, z), no world-y flip — see
            # scene/camera.py for why the reference's `d_w.y *= -1` rule is
            # wrong for pitched cameras (identical for level ones)
            dcx, dcy, dcz = -xx * inv, -yy * inv, zplane * inv
            dwx = r00 * dcx + r01 * dcy + r02 * dcz
            dwy = r10 * dcx + r11 * dcy + r12 * dcz
            dwz = r20 * dcx + r21 * dcy + r22 * dcz
            o = (zf + cox, zf + coy, zf + coz)
            return o, (dwx, dwy, dwz), seed

        o0, d0, seed0 = fresh(jnp.uint32(0))

        def _woop_test(ti, o, d, t_lo, t_hi):
            """One Woop unit-triangle test (ops/woop.py semantics) of
            triangle ti against every lane: returns (t, u, v, hit)."""
            base = ti * _NW
            ax0, ax1, ax2 = woop_ref[base], woop_ref[base + 1], woop_ref[base + 2]
            ay0, ay1, ay2 = woop_ref[base + 3], woop_ref[base + 4], woop_ref[base + 5]
            az0, az1, az2 = woop_ref[base + 6], woop_ref[base + 7], woop_ref[base + 8]
            bx, by, bz = woop_ref[base + 9], woop_ref[base + 10], woop_ref[base + 11]
            opz = o[0] * az0 + o[1] * az1 + o[2] * az2 + bz
            dpz = d[0] * az0 + d[1] * az1 + d[2] * az2
            live = jnp.abs(dpz) > 1e-12
            t = -opz / jnp.where(live, dpz, 1.0)
            px = o[0] + t * d[0]
            py = o[1] + t * d[1]
            pz = o[2] + t * d[2]
            u = px * ax0 + py * ax1 + pz * ax2 + bx
            v = px * ay0 + py * ay1 + pz * ay2 + by
            hit = live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_lo) & (t < t_hi)
            return t, u, v, hit

        def intersect_closest(o, d, alive):
            t_max0 = jnp.where(alive, _BIG, -_BIG)

            def tri(ti, carry):
                best_t, best_prim, best_u, best_v = carry
                t, u, v, hit = _woop_test(ti, o, d, 0.0, t_max0)
                closer = hit & (t < best_t)
                return (
                    jnp.where(closer, t, best_t),
                    jnp.where(closer, ti, best_prim),
                    jnp.where(closer, u, best_u),
                    jnp.where(closer, v, best_v),
                )

            init = (zf + _BIG, jnp.full(pix.shape, -1, jnp.int32), zf, zf)
            return jax.lax.fori_loop(0, n_tris, tri, init)

        def intersect_any(o, d, t_min, t_max, active):
            t_max = jnp.where(active, t_max, -1.0)

            def tri(ti, occ):
                _t, _u, _v, hit = _woop_test(ti, o, d, t_min, t_max)
                return occ | hit

            return jax.lax.fori_loop(0, n_tris, tri, zb)

        def gather_attrs(prim):
            """Per-lane gather of the hit triangle's attribute row; misses
            and rows outside `needed_rows` read zero."""
            found = prim >= 0
            base = jnp.maximum(prim, 0) * _NA
            return tuple(
                jnp.where(found, attr_ref[base + c], 0.0) if c in needed_rows
                else zf
                for c in range(_NA)
            )

        state = dict(
            ox=o0[0], oy=o0[1], oz=o0[2],
            dx=d0[0], dy=d0[1], dz=d0[2],
            wr=zf + 1.0, wg=zf + 1.0, wb=zf + 1.0,
            direct_weight=zf + 1.0,
            prev_pdf=zf + 1.0,
            prev_nee=zb,
            was_delta=zb,
            count_emitted=~zb,
            done=zb,
            rad_r=zf, rad_g=zf, rad_b=zf,
            rays=jnp.zeros(pix.shape, jnp.int32),
            seed=seed0,
            depth=jnp.zeros(pix.shape, jnp.uint32),
            sample=jnp.zeros(pix.shape, jnp.uint32),
            it=jnp.int32(0),
        )
        if has_env:
            state["prev_nee_any"] = zb

        def cond(st):
            exhausted = st["done"] & (st["sample"] + 1 >= spp)
            # "not all lanes exhausted", as a min-reduction (Triton lowers
            # no boolean any/all)
            return (st["it"] < max_iters) & (
                jnp.min(jnp.where(exhausted, 1, 0)) == 0)

        def closest(o, d, alive):
            t, prim, bu, bv = intersect_closest(o, d, alive)
            return t, (prim >= 0) & alive, bu, bv, gather_attrs(prim)

        def pick_light(seed, bounce):
            # uniform pick, as the reference (rayhit.rchit:720-729)
            lbits = rng.random_bits(seed, bounce, _CH_LIGHT_INDEX)
            base = (lbits % jnp.uint32(n_lights)).astype(jnp.int32) * _NL
            lr = [light_ref[base + c] for c in range(_NL)]
            return ((lr[0], lr[1], lr[2]), (lr[3], lr[4], lr[5]),
                    (lr[6], lr[7], lr[8]), (lr[9], lr[10], lr[11]),
                    1.0 / n_lights)

        env = None
        if has_env:
            env = dict(
                const=(cam_ref[13], cam_ref[14], cam_ref[15]),
                rot=tuple(cam_ref[16 + i] for i in range(9)),
                pdf=cam_ref[25],
                p_env=(0.5 if has_area else 1.0),
                has_area=has_area,
            )
            if env_hw:
                env["tab"] = make_env_tab_fns(env_ref, *env_hw)
        body = make_bounce_body(
            cfg, present,
            closest=closest,
            any_hit=intersect_any,
            pick_light=pick_light,
            fresh=fresh,
            spp=spp,
            env=env,
        )
        state = jax.lax.while_loop(cond, body, state)
        rad_r_ref[...] = state["rad_r"]
        rad_g_ref[...] = state["rad_g"]
        rad_b_ref[...] = state["rad_b"]
        rays_ref[...] = state["rays"]

    return kernel


def _env_image_hw(scene: SceneData):
    """(h, w) when the scene's envmap takes the fused image-table path
    (lat-long maps bigger than 1x1), else None (no env / constant)."""
    if not scene.has_envmap:
        return None
    h, w = (int(x) for x in scene.envmap.shape[:2])
    return None if (h, w) == (1, 1) else (h, w)


def _env_fused_ok(scene: SceneData) -> bool:
    """Envmap coverage of the kernel: none, a CONSTANT emitter (1x1 map —
    Mitsuba `constant`), or a lat-long map of at most MEGA_ENV_MAX_TEXELS
    texels.  Bigger maps stay on the XLA wavefront."""
    if not scene.has_envmap:
        return True
    h, w = scene.envmap.shape[:2]
    return (h, w) == (1, 1) or h * w <= MEGA_ENV_MAX_TEXELS


def mega_eligible(scene: SceneData, cfg: RenderConfig) -> bool:
    """Whether the fused megakernel covers this (scene, config)."""
    return (
        not cfg.use_bvh
        and not scene.has_textures
        and _env_fused_ok(scene)
        and cfg.light_sampling == "uniform"
        and scene.num_tris > 0
        and scene.num_tris <= MEGA_MAX_TRIS
        and scene.num_lights < (1 << 16)
    )


def render_mega_rows(scene: SceneData, cfg: RenderConfig, pix,
                     timestamp0=0, interpret: bool = False):
    """Run the megakernel over explicit pixel ids (possibly a shard —
    parallel/dist.py shards them over the device mesh).  pix: (n,) uint32
    with n a multiple of BLOCK.  Returns per-lane radiance sums over
    cfg.spp + ray counts, each (n,)."""
    woop, attr, light, camv = _pack_tables(scene)
    n = pix.shape[0]
    if n % BLOCK:
        raise ValueError(f"pixel count {n} is not a multiple of {BLOCK}")
    ts = jnp.asarray(timestamp0, jnp.uint32).reshape(1)
    env_hw = _env_image_hw(scene)
    kernel = _make_kernel(cfg, scene.num_tris, scene.num_lights,
                          scene.kinds_present,
                          has_env=scene.has_envmap,
                          has_area=scene.has_area_lights,
                          env_hw=env_hw)
    tables = [woop, attr, light, camv, ts]
    if env_hw:
        tables.append(_pack_env_table(scene))
    blk = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = [pl.BlockSpec(x.shape, lambda i: (0,)) for x in tables]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    return pl.pallas_call(
        kernel,
        grid=(n // BLOCK,),
        in_specs=[blk] + whole,
        out_specs=[blk, blk, blk, blk],
        out_shape=[f32, f32, f32, jax.ShapeDtypeStruct((n,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="mega_path_trace",
    )(pix.astype(jnp.uint32), *tables)


@partial(jax.jit, static_argnames=("cfg", "interpret"))
def render_mega(scene: SceneData, cfg: RenderConfig, timestamp0=0,
                interpret: bool = False):
    """Render (H, W, 3) radiance (mean over cfg.spp) + total rays traced.

    Equivalent to path_tracer.render_image_stats but executed as a single
    persistent kernel."""
    n_pixels = cfg.width * cfg.height
    padded = -(-n_pixels // BLOCK) * BLOCK
    pix = jnp.arange(padded, dtype=jnp.uint32)
    pix = jnp.where(pix < n_pixels, pix, 0)
    rad_r, rad_g, rad_b, rays = render_mega_rows(
        scene, cfg, pix, timestamp0, interpret=interpret)

    rad = jnp.stack([rad_r, rad_g, rad_b], axis=-1)[:n_pixels]
    nrays = jnp.sum(rays[:n_pixels].astype(jnp.float32))
    img = (rad / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return img, nrays
