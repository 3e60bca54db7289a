"""Vectorized BSDF sample/eval with type dispatch.

Behavior spec: the eight Sample/Eval pairs in rayhit.rchit:341-617 and the
X-macro dispatch in rayhit.rchit:630-654.  The reference dispatches with a
per-thread `switch`; SIMT threads diverge per type.  Here we evaluate every
type's (cheap, purely vector) math for the whole ray batch and select by type
mask — branch-free lockstep work that XLA fuses into elementwise loops.  When
ray queues are sorted by BSDF type (integrator/wavefront), XLA's fusion still
keeps this memory-bound-free; a per-type `lax.switch` specialization is a
later optimization.

Conventions: `wo`, `wi` in the local shading frame (+z = shading normal);
`params` rows per bsdf/table.py; uniforms are explicit counter-based draws.

Every sampler consumes the same uniform triple (u_sel, u1, u2).  This differs
from the reference's sequential stream (each type draws a different count) but
is statistically equivalent and is what makes dispatch order-free and replay
exact.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import math3d as m3
from ..ops import microfacet as mf
from ..ops import sampling as smp
from .table import (
    BSDF_DIFFUSE,
    BSDF_SMOOTH_DIELECTRIC,
    BSDF_SMOOTH_CONDUCTOR,
    BSDF_SMOOTH_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_SMOOTH_FLOOR,
    BSDF_ROUGH_FLOOR,
    BSDF_ROUGH_PLASTIC,
)

M_PI = jnp.pi


def is_transmission(kind):
    """Only the smooth dielectric transmits (rayhit.rchit:620-627)."""
    return kind == BSDF_SMOOTH_DIELECTRIC


def _abs_z(w):
    return jnp.abs(w[..., 2])


def _safe_inv(x, eps=1e-12):
    return 1.0 / jnp.maximum(x, eps)


# ---------------------------------------------------------------------------
# Per-type samplers.  Each returns (wi, f_rgb, pdf, is_delta).
# ---------------------------------------------------------------------------


def _sample_diffuse(p, wo, u_sel, u1, u2):
    # rayhit.rchit:341-349
    kd = p[..., 0:3]
    wi = smp.sample_cosine_hemisphere(u1, u2)
    f = kd / M_PI
    pdf = smp.cosine_hemisphere_pdf(wi)
    return wi, f, pdf, jnp.zeros(pdf.shape, bool)


def _sample_smooth_dielectric(p, wo, u_sel, u1, u2):
    # rayhit.rchit:362-398.  The ior clamp only affects *unselected* rows of
    # the all-types dispatch (real dielectrics have ior >= 1): ior 0 would
    # compute 0/0 in Snell's ratio and poison gradients of masked lanes.
    ior_in = jnp.maximum(p[..., 0], 1e-2)
    ior_out = jnp.maximum(p[..., 1], 1e-2)
    entering = wo[..., 2] > 0.0
    no = jnp.where(entering, ior_out, ior_in)
    nt = jnp.where(entering, ior_in, ior_out)
    cos_tho = wo[..., 2]
    # faceforward(+z, -wo, +z): +z if dot(+z, -wo) < 0 i.e. wo.z > 0, else -z
    nz = jnp.where(entering, 1.0, -1.0)
    n = jnp.stack([jnp.zeros_like(nz), jnp.zeros_like(nz), nz], axis=-1)
    wt, ok = mf.refract_local(wo, n, no, nt)
    mirror = m3.reflect_local(wo)

    fr = mf.fresnel_dielectric_exact(no, jnp.abs(cos_tho), nt, jnp.abs(wt[..., 2]))
    fr = jnp.where(ok, fr, 1.0)

    reflecting = jnp.logical_or(~ok, u_sel < fr)
    wi = jnp.where(reflecting[..., None], mirror, wt)
    inv_cos = _safe_inv(jnp.abs(cos_tho))
    f_reflect = jnp.where(ok, fr, 1.0) * inv_cos  # TIR: f = 1/|cos|
    eta2 = (no * no) * _safe_inv(nt * nt)
    f_refract = eta2 * (1.0 - fr) * _safe_inv(jnp.abs(wt[..., 2]))
    f_scalar = jnp.where(reflecting, f_reflect, f_refract)
    pdf = jnp.where(reflecting, jnp.where(ok, fr, 1.0), 1.0 - fr)
    f = jnp.broadcast_to(f_scalar[..., None], wi.shape)
    return wi, f, pdf, jnp.ones(pdf.shape, bool)


def _sample_smooth_conductor(p, wo, u_sel, u1, u2):
    # rayhit.rchit:406-418.  ior_in == 0 means perfect mirror.
    ior_in, ior_out = p[..., 0], p[..., 1]
    fr = jnp.where(
        ior_in == 0.0, 1.0, mf.fresnel_dielectric(_abs_z(wo), ior_out, jnp.maximum(ior_in, 1e-6))
    )
    wi = m3.reflect_local(wo)
    f = (fr * _safe_inv(_abs_z(wo)))[..., None] * jnp.ones_like(wi)
    pdf = jnp.ones_like(fr)
    return wi, f, pdf, jnp.ones(pdf.shape, bool)


def _sample_smooth_floor(p, wo, u_sel, u1, u2):
    # rayhit.rchit:428-449
    kd, r0 = p[..., 0:3], p[..., 3]
    fr = mf.schlick_fresnel(r0, _abs_z(wo))
    mirror = m3.reflect_local(wo)
    wi_d = smp.sample_cosine_hemisphere(u1, u2)
    spec = u_sel < fr
    wi = jnp.where(spec[..., None], mirror, wi_d)
    coupled = mf.coupled_diffuse_term(r0, _abs_z(wo), _abs_z(wi))
    f_diff = kd * coupled[..., None]
    f = jnp.where(spec[..., None], f_diff + (fr * _safe_inv(_abs_z(wo)))[..., None], f_diff)
    pdf = jnp.where(spec, fr, (1.0 - fr) * smp.cosine_hemisphere_pdf(wi))
    return wi, f, pdf, spec


def _sample_smooth_plastic(p, wo, u_sel, u1, u2):
    # rayhit.rchit:461-491
    kd = p[..., 0:3]
    ior_in, ior_out, r0 = p[..., 3], p[..., 4], p[..., 5]
    no, nt = ior_out, jnp.maximum(ior_in, 1e-6)
    fri = mf.fresnel_dielectric(_abs_z(wo), no, nt)
    spec = u_sel < fri
    mirror = m3.reflect_local(wo)
    wi_d = smp.sample_cosine_hemisphere(u1, u2)
    wi = jnp.where(spec[..., None], mirror, wi_d)
    fro = mf.fresnel_dielectric(_abs_z(wi), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    eta = no / nt
    d = (
        kd
        * (eta * eta * (1.0 - fri) * (1.0 - fro))[..., None]
        * _safe_inv(M_PI * (1.0 - kd * ri[..., None]))
    )
    f = jnp.where(spec[..., None], (fri * _safe_inv(_abs_z(wo)))[..., None] * jnp.ones_like(d), d)
    pdf = jnp.where(spec, fri, (1.0 - fri) * smp.cosine_hemisphere_pdf(wi))
    return wi, f, pdf, spec


def _rough_common_wi(wo, u_sel, u1, u2, alpha):
    """Shared 50/50 half-vector-reflect / cosine lobe selection used by
    rough plastic + rough floor (rayhit.rchit:532-547,583-594)."""
    wh = smp.sample_half_beckmann(u1, u2, alpha)
    wh = jnp.where(wh[..., 2:3] <= 0.0, -wh, wh)
    wi_spec = m3.normalize(-wo + 2.0 * m3.dot(wh, wo)[..., None] * wh)
    wi_d = smp.sample_cosine_hemisphere(u1, u2)
    use_spec = u_sel < 0.5
    return jnp.where(use_spec[..., None], wi_spec, wi_d)


def _sample_rough_conductor(p, wo, u_sel, u1, u2):
    # rayhit.rchit:508-520
    eta, k, refl, alpha = p[..., 0:3], p[..., 3:6], p[..., 6:9], p[..., 9]
    fr = mf.fresnel_conductor(_abs_z(wo), eta, k)
    wh = smp.sample_half_beckmann(u1, u2, alpha)
    wh = jnp.where(wh[..., 2:3] <= 0.0, -wh, wh)
    wi = m3.normalize(-wo + 2.0 * m3.dot(wh, wo)[..., None] * wh)
    denom = 4.0 * _abs_z(wi) * _abs_z(wo)
    f = refl * fr * (mf.ggx_d(wh, alpha) * mf.ggx_masking(wo, wi, alpha) * _safe_inv(denom))[..., None]
    pdf = mf.beckmann_d(wh, alpha) * _abs_z(wh) * _safe_inv(4.0 * jnp.abs(m3.dot(wo, wh)))
    return wi, f, pdf, jnp.zeros(pdf.shape, bool)


def _rough_plastic_f_pdf(p, wo, wi, eval_clamp: bool):
    """Shared shading for rough plastic sample & eval (rayhit.rchit:548-582).
    `eval_clamp` reproduces the eval-only max(beckD*|wh.z|, 0.01) clamp
    (rayhit.rchit:577)."""
    kd = p[..., 0:3]
    ior_in, ior_out, r0, alpha = p[..., 3], p[..., 4], p[..., 5], p[..., 6]
    no, nt = ior_out, jnp.maximum(ior_in, 1e-6)
    eta = no / nt
    wh = m3.normalize(wi + wo)
    fri = mf.fresnel_dielectric(jnp.abs(m3.dot(wh, wo)), no, nt)
    fro = mf.fresnel_dielectric(jnp.abs(m3.dot(wh, wi)), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    spec = (fri * mf.ggx_d(wh, alpha) * mf.ggx_masking(wo, wi, alpha)) * _safe_inv(
        4.0 * _abs_z(wo) * _abs_z(wi)
    )
    d = kd * ((1.0 - fri) * (1.0 - fro) * eta * eta)[..., None] * _safe_inv(
        M_PI * (1.0 - kd * ri[..., None])
    )
    bd = mf.beckmann_d(wh, alpha) * _abs_z(wh)
    if eval_clamp:
        bd = jnp.maximum(bd, 0.01)
    pdf = 0.5 * bd * _safe_inv(4.0 * jnp.abs(m3.dot(wo, wh))) + 0.5 * smp.cosine_hemisphere_pdf(wi)
    return d + spec[..., None], pdf


def _sample_rough_plastic(p, wo, u_sel, u1, u2):
    alpha = p[..., 6]
    wi = _rough_common_wi(wo, u_sel, u1, u2, alpha)
    f, pdf = _rough_plastic_f_pdf(p, wo, wi, eval_clamp=False)
    return wi, f, pdf, jnp.zeros(pdf.shape, bool)


def _rough_floor_f_pdf(p, wo, wi):
    """Shared shading for rough floor sample & eval (rayhit.rchit:595-617)."""
    kd, r0, alpha = p[..., 0:3], p[..., 3], p[..., 4]
    wh = m3.normalize(wi + wo)
    fr = mf.schlick_fresnel(r0, jnp.abs(m3.dot(wo, wh)))
    d = kd * mf.fresnel_blend_diffuse_term(r0, _abs_z(wo), _abs_z(wi))[..., None]
    spec = fr * mf.ggx_d(wh, alpha) * _safe_inv(
        4.0 * jnp.abs(m3.dot(wo, wh)) * jnp.maximum(_abs_z(wo), _abs_z(wi))
    )
    pdf = 0.5 * mf.beckmann_d(wh, alpha) * _abs_z(wh) * _safe_inv(
        4.0 * jnp.abs(m3.dot(wo, wh))
    ) + 0.5 * smp.cosine_hemisphere_pdf(wi)
    return d + spec[..., None], pdf


def _sample_rough_floor(p, wo, u_sel, u1, u2):
    alpha = p[..., 4]
    wi = _rough_common_wi(wo, u_sel, u1, u2, alpha)
    f, pdf = _rough_floor_f_pdf(p, wo, wi)
    return wi, f, pdf, jnp.zeros(pdf.shape, bool)


_SAMPLERS = {
    BSDF_DIFFUSE: _sample_diffuse,
    BSDF_SMOOTH_DIELECTRIC: _sample_smooth_dielectric,
    BSDF_SMOOTH_CONDUCTOR: _sample_smooth_conductor,
    BSDF_SMOOTH_PLASTIC: _sample_smooth_plastic,
    BSDF_ROUGH_CONDUCTOR: _sample_rough_conductor,
    BSDF_SMOOTH_FLOOR: _sample_smooth_floor,
    BSDF_ROUGH_FLOOR: _sample_rough_floor,
    BSDF_ROUGH_PLASTIC: _sample_rough_plastic,
}


# ---------------------------------------------------------------------------
# Per-type eval (for NEE light directions).  Each returns (f, pdf, is_delta).
# ---------------------------------------------------------------------------


def _eval_diffuse(p, wo, wi):
    kd = p[..., 0:3]
    pdf = smp.cosine_hemisphere_pdf(wi)
    return kd / M_PI, pdf, jnp.zeros(pdf.shape, bool)


def _eval_delta(p, wo, wi):
    # Smooth dielectric/conductor eval to 0 (rayhit.rchit:400-404,420-426).
    z = jnp.zeros(wo.shape[:-1])
    return jnp.zeros_like(wo), jnp.ones_like(z), jnp.ones(z.shape, bool)


def _eval_smooth_floor(p, wo, wi):
    kd, r0 = p[..., 0:3], p[..., 3]
    fr = mf.schlick_fresnel(r0, _abs_z(wo))
    f = kd * mf.coupled_diffuse_term(r0, _abs_z(wo), _abs_z(wi))[..., None]
    pdf = (1.0 - fr) * smp.cosine_hemisphere_pdf(wi)
    return f, pdf, jnp.zeros(pdf.shape, bool)


def _eval_smooth_plastic(p, wo, wi):
    kd = p[..., 0:3]
    ior_in, ior_out, r0 = p[..., 3], p[..., 4], p[..., 5]
    no, nt = ior_out, jnp.maximum(ior_in, 1e-6)
    fri = mf.fresnel_dielectric(_abs_z(wo), no, nt)
    fro = mf.fresnel_dielectric(_abs_z(wi), no, nt)
    ri = mf.internal_scatter_escape_fraction(r0, no, nt)
    eta = no / nt
    f = kd * ((1.0 - fri) * (1.0 - fro) * eta * eta)[..., None] * _safe_inv(
        M_PI * (1.0 - kd * ri[..., None])
    )
    pdf = (1.0 - fri) * smp.cosine_hemisphere_pdf(wi)
    return f, pdf, jnp.zeros(pdf.shape, bool)


def _eval_rough_conductor(p, wo, wi):
    eta, k, refl, alpha = p[..., 0:3], p[..., 3:6], p[..., 6:9], p[..., 9]
    fr = mf.fresnel_conductor(_abs_z(wo), eta, k)
    wh = m3.normalize(wo + wi)
    denom = 4.0 * _abs_z(wi) * _abs_z(wo)
    f = fr * refl * (mf.ggx_d(wh, alpha) * mf.ggx_masking(wo, wi, alpha) * _safe_inv(denom))[..., None]
    pdf = mf.beckmann_d(wh, alpha) * _abs_z(wh) * _safe_inv(4.0 * jnp.abs(m3.dot(wo, wh)))
    return f, pdf, jnp.zeros(pdf.shape, bool)


def _eval_rough_plastic(p, wo, wi):
    f, pdf = _rough_plastic_f_pdf(p, wo, wi, eval_clamp=True)
    return f, pdf, jnp.zeros(pdf.shape, bool)


def _eval_rough_floor(p, wo, wi):
    f, pdf = _rough_floor_f_pdf(p, wo, wi)
    return f, pdf, jnp.zeros(pdf.shape, bool)


_EVALS = {
    BSDF_DIFFUSE: _eval_diffuse,
    BSDF_SMOOTH_DIELECTRIC: _eval_delta,
    BSDF_SMOOTH_CONDUCTOR: _eval_delta,
    BSDF_SMOOTH_PLASTIC: _eval_smooth_plastic,
    BSDF_ROUGH_CONDUCTOR: _eval_rough_conductor,
    BSDF_SMOOTH_FLOOR: _eval_smooth_floor,
    BSDF_ROUGH_FLOOR: _eval_rough_floor,
    BSDF_ROUGH_PLASTIC: _eval_rough_plastic,
}


def sample_bsdf(params, kind, wo, u_sel, u1, u2, present=None):
    """Sample all BSDF types in lockstep and select by `kind`.

    params: (..., NUM_PARAMS) gathered rows; kind: (...,) int32;
    wo: (..., 3) shading-frame outgoing dir; u_*: (...,) uniforms.
    `present`: optional static tuple of kinds occurring in the scene — only
    those branches are computed (scene-specialized compile).
    Returns (wi, f, pdf, is_delta).
    """
    kinds = _SAMPLERS.keys() if present is None else present
    wi = jnp.zeros_like(wo)
    f = jnp.zeros_like(wo)
    pdf = jnp.ones(wo.shape[:-1], wo.dtype)
    delta = jnp.zeros(wo.shape[:-1], bool)
    for t in kinds:
        fn = _SAMPLERS[t]
        wi_t, f_t, pdf_t, d_t = fn(params, wo, u_sel, u1, u2)
        if len(list(kinds)) == 1:
            return wi_t, f_t, pdf_t, d_t
        sel = kind == t
        wi = jnp.where(sel[..., None], wi_t, wi)
        f = jnp.where(sel[..., None], f_t, f)
        pdf = jnp.where(sel, pdf_t, pdf)
        delta = jnp.where(sel, d_t, delta)
    return wi, f, pdf, delta


def eval_bsdf(params, kind, wo, wi, present=None):
    """Evaluate f/pdf for a given direction pair; select by `kind`."""
    kinds = _EVALS.keys() if present is None else present
    f = jnp.zeros_like(wo)
    pdf = jnp.ones(wo.shape[:-1], wo.dtype)
    delta = jnp.zeros(wo.shape[:-1], bool)
    for t in kinds:
        fn = _EVALS[t]
        f_t, pdf_t, d_t = fn(params, wo, wi)
        if len(list(kinds)) == 1:
            return f_t, pdf_t, d_t
        sel = kind == t
        f = jnp.where(sel[..., None], f_t, f)
        pdf = jnp.where(sel, pdf_t, pdf)
        delta = jnp.where(sel, d_t, delta)
    return f, pdf, delta
