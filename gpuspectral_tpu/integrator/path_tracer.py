"""Wavefront path tracer.

This module re-expresses the reference's RT pipeline: the raygen
bounce loop (raygen.rgen:29-108) and the closest-hit shading
(rayhit.rchit:666-797) re-expressed as one vectorized bounce step iterated
with `lax.scan` over a static depth bound.  Per-ray SIMT recursion becomes
per-wavefront dense math with masks; `traceRayEXT` becomes the intersection
kernels in ops/intersect.py (and bvh/ for large scenes).

Faithfully reproduced reference semantics (file:line cites):
  * firefly clamp: drop bounce contributions with any channel >= 20
    (raygen.rgen:60-63)
  * Russian roulette after depth 10, q = clamp(max weight, 0.05, 1)
    (raygen.rgen:66-71)
  * NEE with power-heuristic MIS and the countEmitted/wasDelta/directWeight
    emitter bookkeeping (rayhit.rchit:730-796)
  * two-faced normal flip only for non-emitting instances
    (rayhit.rchit:698-707)
  * invalid-hemisphere / self-intersection / non-finite terminations
    (rayhit.rchit:770-784)
  * shadow-ray epsilon 0.01, origin offset 1e-4 along the face-forward
    geometric normal (rayhit.rchit:745-747,793)
  * progressive accumulation as a running mean over timestamps with NaN
    guard (raygen.rgen:84-108)

Deliberate deviations (documented in ops/rng.py): uniforms are counter-based
draws rather than a sequential PCG stream, and light/BSDF sampling consume a
fixed channel layout per bounce:

  ch 0..2  bsdf (select, u1, u2)
  ch 3     light index bits
  ch 4..5  light triangle (u1, u2)
  ch 6     russian roulette
  ch 7..8  subpixel jitter (when enabled)
  ch 9..11 environment NEE (u1, u2, strategy select; envmap scenes only)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..bsdf.dispatch import eval_bsdf, is_transmission, sample_bsdf
from ..ops import intersect as isect
from ..ops import math3d as m3
from ..ops import rng
from ..ops import sampling as smp
from ..scene.camera import generate_rays
from ..scene.data import SceneData
from ..utils.config import RenderConfig

# RNG channel layout per bounce
CH_BSDF_SELECT = 0
CH_BSDF_U1 = 1
CH_BSDF_U2 = 2
CH_LIGHT_INDEX = 3
CH_LIGHT_U1 = 4
CH_LIGHT_U2 = 5
CH_RR = 6
CH_JITTER_X = 7
CH_JITTER_Y = 8
CH_ENV_U1 = 9
CH_ENV_U2 = 10
CH_ENV_SELECT = 11


def _take_rows(table, idx):
    """Row gather (gradients flow back into the table as a scatter-add)."""
    return table[idx]


def _tri_table(scene: SceneData):
    """(T, 36) packed per-triangle attributes, built from live scene arrays
    (differentiable w.r.t. bsdf params/emission); loop-invariant, so XLA
    hoists it out of the bounce loop."""
    t = scene.tri_pos.shape[0]
    f32 = jnp.float32
    cols = [
        scene.tri_pos.reshape(t, 9),  # 0:9
        scene.tri_nrm.reshape(t, 9),  # 9:18
        scene.tri_emission,  # 18:21
        scene.tri_twofaced[:, None].astype(f32),  # 21
        scene.tri_light_idx[:, None].astype(f32),  # 22
        scene.bsdf_kind[scene.tri_bsdf][:, None].astype(f32),  # 23
        scene.bsdf_params[scene.tri_bsdf],  # 24:36
    ]
    if scene.has_textures:
        cols.append(scene.tri_uv.reshape(t, 6))  # 36:42
        cols.append(scene.bsdf_tex[scene.tri_bsdf][:, None].astype(f32))  # 42
    return jnp.concatenate(cols, axis=1)


def _gather_tri(scene: SceneData, prim, tri_table=None):
    """Gather per-triangle shading data for (possibly miss=-1) prim ids."""
    safe = jnp.maximum(prim, 0)
    if tri_table is None:
        tri_table = _tri_table(scene)
    rows = _take_rows(tri_table, safe)
    r = rows.shape[0]
    return (
        rows[:, 0:9].reshape(r, 3, 3),  # pos
        rows[:, 9:18].reshape(r, 3, 3),  # nrm
        rows[:, 24:36],  # bsdf params
        jnp.round(rows[:, 23]).astype(jnp.int32),  # kind
        rows[:, 18:21],  # emission
        rows[:, 21] > 0.5,  # twofaced
        jnp.round(rows[:, 22]).astype(jnp.int32),  # light idx
        rows,  # full rows (uv/tex columns when textured)
    )


def _texture_modulation(scene: SceneData, rows, bu, bv):
    """Per-hit texture color for textured bsdf rows (1.0 elsewhere)."""
    r = rows.shape[0]
    uv_c = rows[:, 36:42].reshape(r, 3, 2)
    tex_id = jnp.round(rows[:, 42]).astype(jnp.int32)
    return _texture_lookup(scene, uv_c, tex_id, bu, bv)


def _texture_lookup(scene: SceneData, uv_c, tex_id, bu, bv):
    """Nearest-neighbor lookup in the fixed-resolution atlas; wrap
    addressing.  uv_c (R,3,2) per-corner uvs, tex_id (R,) (-1 = untextured)."""
    bw = 1.0 - bu - bv
    uv = bw[:, None] * uv_c[:, 0] + bu[:, None] * uv_c[:, 1] + bv[:, None] * uv_c[:, 2]
    res = scene.textures.shape[1]
    u = uv[:, 0] - jnp.floor(uv[:, 0])
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    px = jnp.clip((u * res).astype(jnp.int32), 0, res - 1)
    py = jnp.clip(((1.0 - v) * res).astype(jnp.int32), 0, res - 1)
    flat = scene.textures.reshape(-1, 3)
    idx = jnp.maximum(tex_id, 0) * res * res + py * res + px
    texel = flat[idx]
    return jnp.where((tex_id >= 0)[:, None], texel, 1.0)


def _rehit_grad(tri_pos, origin, direction, prim, t, u, v):
    """(t, u, v) with the values given and the gradients of a
    Moller-Trumbore re-test of each ray against its hit triangle `prim`
    (zero for misses, prim < 0)."""
    tri = tri_pos[jnp.maximum(prim, 0)]  # (R,3,3)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    h = jnp.cross(direction, e2)
    a = jnp.sum(e1 * h, axis=-1)
    f = 1.0 / jnp.where(jnp.abs(a) < 1e-12, 1.0, a)
    s = origin - v0
    q = jnp.cross(s, e1)
    u_re = f * jnp.sum(s * h, axis=-1)
    v_re = f * jnp.sum(direction * q, axis=-1)
    t_re = f * jnp.sum(e2 * q, axis=-1)
    hit = prim >= 0
    sg = jax.lax.stop_gradient

    def grad_of(x0, x):
        return x0 + jnp.where(hit, x - sg(x), 0.0)

    return grad_of(t, t_re), grad_of(u, u_re), grad_of(v, v_re)


def _resolve_intersector(cfg: RenderConfig) -> str:
    return "woop" if cfg.intersector == "auto" else cfg.intersector


def _bounce(scene: SceneData, cfg: RenderConfig, bounce, state):
    """One wavefront bounce. `state` is a dict of per-ray arrays."""
    origin, direction = state["origin"], state["direction"]
    seed = state["seed"]
    alive = ~state["done"]
    isector = _resolve_intersector(cfg)

    sg = jax.lax.stop_gradient
    if cfg.use_bvh:
        from ..bvh.traverse import intersect_closest_bvh

        # the traversal's while_loop cannot be reverse-differentiated: it
        # runs on constants, and the hit's (t, u, v) gradients come from a
        # re-test of the hit triangle (_rehit_grad)
        t, prim, bu, bv = intersect_closest_bvh(
            sg(origin),
            sg(direction),
            sg(scene.tri_pos),
            scene.bvh_node_min,
            scene.bvh_node_max,
            scene.bvh_clusters,
            scene.bvh_leaf_size,
            scene.bvh_levels,
            active=alive,
            packet_size=cfg.packet_size,
        )
        t, bu, bv = _rehit_grad(scene.tri_pos, origin, direction, prim, t, bu, bv)
    else:
        t, prim, bu, bv = isect.intersect_closest(
            origin,
            direction,
            scene.tri_pos,
            active=alive,
            tri_chunk=cfg.tri_chunk,
            woop=scene.tri_woop if isector == "woop" else None,
        )
    hit = (prim >= 0) & alive
    miss = (~(prim >= 0)) & alive

    pos_c, nrm_c, bparams, bkind, emission, twofaced, tri_lidx, _rows = _gather_tri(scene, prim)
    if scene.has_textures:
        # modulate the diffuse/reflectance color by the bound texture —
        # unlike the reference, whose texture plumbing is stubbed
        mod = _texture_modulation(scene, _rows, bu, bv)
        bparams = bparams.at[:, 0:3].multiply(mod)

    # hit position along the ray (rayhit.rchit:692).  Miss lanes carry
    # t = 1e30; clamp them to keep downstream math (and its *gradients*)
    # finite — their contributions are masked out anyway.
    t_safe = jnp.where(hit, t, 1.0)
    position = origin + direction * t_safe[..., None]

    # geometric + shading normals (rayhit.rchit:690-694)
    bw = 1.0 - bu - bv
    sn = m3.normalize(
        bw[..., None] * nrm_c[:, 0] + bu[..., None] * nrm_c[:, 1] + bv[..., None] * nrm_c[:, 2]
    )
    gn = m3.normalize(jnp.cross(pos_c[:, 1] - pos_c[:, 0], pos_c[:, 2] - pos_c[:, 0]))
    # orient the interpolated shading normal into the geometric hemisphere:
    # negative-determinant object transforms flip inverse-transpose normals
    # relative to the transformed winding, which would strand wi sampling on
    # the wrong side (the reference inherits the same inconsistency; this is
    # a no-op whenever source normals agree with winding)
    sn = jnp.where(m3.dot(sn, gn)[..., None] < 0.0, -sn, sn)

    # two-faced flip for non-emitters viewed from behind (rayhit.rchit:698-707)
    backface = m3.dot(gn, -direction) < 0.0
    emissive = jnp.any(emission != 0.0, axis=-1)
    flip = backface & twofaced & (~emissive)
    gn = jnp.where(flip[..., None], -gn, gn)
    sn = jnp.where(flip[..., None], -sn, sn)

    # shading frame (rayhit.rchit:712-713)
    tg, bn, nn = m3.onb_create(sn)
    wo = m3.normalize(m3.onb_world_to_local(tg, bn, nn, -direction))

    # BSDF sampling (rayhit.rchit:714-718)
    u_sel = rng.uniform(seed, bounce, CH_BSDF_SELECT)
    u1 = rng.uniform(seed, bounce, CH_BSDF_U1)
    u2 = rng.uniform(seed, bounce, CH_BSDF_U2)
    wi_local, f, pdf, delta = sample_bsdf(
        bparams, bkind, wo, u_sel, u1, u2, present=scene.kinds_present
    )
    now = jnp.abs(wi_local[..., 2])
    wi_world = m3.onb_local_to_world(tg, bn, nn, wi_local)

    transmission = is_transmission(bkind)

    # light sampling (rayhit.rchit:147-153,720-729)
    #
    # cfg.light_block > 0 makes every aligned group of light_block lanes use
    # lane 0's random draw for the light PICK (the light-point sample stays
    # per-lane).  Each lane's pick is still a uniform/power draw independent
    # of its other channels, so the estimator is unbiased; picks are merely
    # correlated ACROSS lanes of one block.  The payoff is shadow-ray
    # coherence: all lanes of a traversal block aim at one light, so the
    # block's BVH vote union collapses (the "shared light per warp" trick of
    # GPU wavefront tracers, here at vector-block granularity).
    pick_seed = seed
    if cfg.light_block > 0:
        r = seed.shape[0]
        nb = r // cfg.light_block
        if nb * cfg.light_block == r:
            pick_seed = jnp.broadcast_to(
                seed.reshape(nb, cfg.light_block)[:, 0:1], (nb, cfg.light_block)
            ).reshape(r)
    if cfg.light_sampling == "power":
        u_l = rng.uniform(pick_seed, bounce, CH_LIGHT_INDEX)
        lidx = jnp.clip(
            jnp.searchsorted(scene.light_cdf, u_l), 0, scene.num_lights - 1
        ).astype(jnp.int32)
        select_pdf = scene.light_prob[lidx]
    else:  # uniform, the reference's scheme
        lbits = rng.random_bits(pick_seed, bounce, CH_LIGHT_INDEX)
        lidx = (lbits % jnp.uint32(scene.num_lights)).astype(jnp.int32)
        select_pdf = 1.0 / scene.num_lights
    light_table = jnp.concatenate(
        [scene.light_pos.reshape(-1, 9), scene.light_emission], axis=1
    )
    lrows = _take_rows(light_table, lidx)
    lv = lrows[:, 0:9].reshape(-1, 3, 3)  # (R,3,3)
    lemit = lrows[:, 9:12]
    lu1 = rng.uniform(seed, bounce, CH_LIGHT_U1)
    lu2 = rng.uniform(seed, bounce, CH_LIGHT_U2)
    light_pos, light_emitted, light_pdf = smp.sample_triangle_light(
        lv[:, 0], lv[:, 1], lv[:, 2], lemit, position, lu1, lu2
    )
    light_pdf = light_pdf * select_pdf

    ldelta = light_pos - position
    ldist = m3.length(ldelta)
    ldir = ldelta / jnp.maximum(ldist, 1e-12)[..., None]

    # NEE over the environment emitter (capability beyond the reference,
    # which stubs envmaps entirely): with probability p_env the NEE strategy
    # importance-samples the luminance-weighted lat-long map instead of an
    # area light; pdfs carry the selection probability so the mixture MIS
    # stays exact.  A direction that misses all geometry has zero area-light
    # pdf, so BSDF-sampled env hits are discounted by p_env * envmap_pdf only.
    p_env = 0.0
    if scene.has_envmap and cfg.nee:
        from .envmap import sample_envmap

        p_env = 0.5 if scene.has_area_lights else 1.0
        eu1 = rng.uniform(seed, bounce, CH_ENV_U1)
        eu2 = rng.uniform(seed, bounce, CH_ENV_U2)
        if scene.has_area_lights:
            env_pick = rng.uniform(seed, bounce, CH_ENV_SELECT) < p_env
        else:
            env_pick = jnp.ones_like(hit)
        env_dir, env_pdf = sample_envmap(
            scene.envmap, scene.envmap_rot, scene.envmap_cdf, scene.envmap_pdf,
            eu1, eu2,
        )
        from .envmap import eval_envmap as _eval_env

        env_l = _eval_env(scene.envmap, scene.envmap_rot, env_dir)
        ldir = jnp.where(env_pick[..., None], env_dir, ldir)
        ldist = jnp.where(env_pick, jnp.float32(1e30), ldist)
        light_emitted = jnp.where(env_pick[..., None], env_l, light_emitted)
        light_pdf = jnp.where(
            env_pick, env_pdf * p_env, light_pdf * (1.0 - p_env)
        )
    w_light_local = m3.onb_world_to_local(tg, bn, nn, ldir)
    nol = jnp.abs(m3.dot(sn, ldir))
    f_light, _light_eval_pdf, _ = eval_bsdf(
        bparams, bkind, wo, w_light_local, present=scene.kinds_present
    )

    # NEE eligibility (rayhit.rchit:734-736)
    front_ok = (m3.dot(gn, -direction) > 0.0) & (m3.dot(gn, ldir) > 0.0)
    nee_candidate = cfg.nee & hit & (~delta) & (front_ok | transmission)

    if cfg.use_bvh:
        from ..bvh.traverse import intersect_any_bvh

        # visibility is a step function (zero gradient a.e.)
        shadowed = intersect_any_bvh(
            sg(position),
            sg(ldir),
            sg(scene.tri_pos),
            scene.bvh_node_min,
            scene.bvh_node_max,
            scene.bvh_clusters,
            scene.bvh_leaf_size,
            scene.bvh_levels,
            t_min=cfg.shadow_epsilon,
            t_max=sg(ldist - cfg.shadow_epsilon),
            active=nee_candidate,
            packet_size=cfg.packet_size,
        )
    else:
        shadowed = isect.intersect_any(
            position,
            ldir,
            scene.tri_pos,
            t_min=cfg.shadow_epsilon,
            t_max=ldist - cfg.shadow_epsilon,
            active=nee_candidate,
            tri_chunk=cfg.tri_chunk,
            woop=scene.tri_woop if isector == "woop" else None,
        )
    nee_done = nee_candidate & (~shadowed) & (light_pdf != 0.0)

    emitted = jnp.zeros_like(origin)
    # MIS complement pdf: the reference reuses the *sampled* BSDF pdf here
    # (rayhit.rchit:750-754 quirk, kept for area lights so goldens match);
    # the env strategy (no reference counterpart) uses the exact BSDF pdf at
    # the NEE direction — with the sampled pdf the weights don't sum to 1
    # over strategies and a constant-env furnace reads ~14% hot.
    if scene.has_envmap and cfg.nee:
        mis_bsdf_pdf = jnp.where(env_pick, _light_eval_pdf, pdf)
    else:
        mis_bsdf_pdf = pdf
    w_mis = smp.power_heuristic(light_pdf, mis_bsdf_pdf)
    nee_contrib = (
        w_mis[..., None]
        * nol[..., None]
        * f_light
        * state["weight"]
        * light_emitted
        / jnp.maximum(light_pdf, 1e-12)[..., None]
    )
    emitted = emitted + jnp.where(nee_done[..., None], nee_contrib, 0.0)

    # emitter accumulation with MIS bookkeeping (rayhit.rchit:760-768)
    light_flag = (m3.dot(gn, -direction) > 0.0).astype(jnp.float32)
    ce = state["count_emitted"]
    wd = state["was_delta"]
    self_emit = emission * light_flag[..., None] * state["weight"]
    if cfg.nee and cfg.mis_mode == "exact":
        # true MIS complement: light-sampling pdf of the point the BSDF ray
        # actually hit (solid-angle-converted area pdf x selection prob)
        e1h = pos_c[:, 1] - pos_c[:, 0]
        e2h = pos_c[:, 2] - pos_c[:, 0]
        area_hit = 0.5 * m3.length(jnp.cross(e1h, e2h))
        cos_hit = jnp.abs(m3.dot(gn, -direction))
        if cfg.light_sampling == "power":
            sel_hit = _take_rows(
                scene.light_prob[:, None], jnp.maximum(tri_lidx, 0)
            )[:, 0]
        else:
            sel_hit = 1.0 / scene.num_lights
        sel_hit = sel_hit * (1.0 - p_env)  # env/area mixture selection
        pdf_hit = t_safe * t_safe / jnp.maximum(cos_hit * area_hit, 1e-12) * sel_hit
        w_emit = jnp.where(
            state["prev_nee"], smp.power_heuristic(state["prev_pdf"], pdf_hit), 1.0
        )
        emitted = emitted + jnp.where(
            ((~ce) & (~wd))[..., None], w_emit[..., None] * self_emit, 0.0
        )
        emitted = emitted + jnp.where((ce | wd)[..., None], self_emit, 0.0)
    elif cfg.nee:
        emitted = emitted + jnp.where(
            ((~ce) & (~wd))[..., None], state["direct_weight"][..., None] * self_emit, 0.0
        )
        emitted = emitted + jnp.where((ce | wd)[..., None], self_emit, 0.0)
    else:
        emitted = emitted + self_emit
    emitted = jnp.where(hit[..., None], emitted, 0.0)

    if scene.has_envmap:
        # environment emitter on miss (capability the reference stubs:
        # miss.rmiss:15-18 returns nothing).  With NEE on, BSDF-sampled env
        # hits are MIS-discounted against the env NEE strategy: the mixture
        # pdf of a miss direction is p_env * envmap_pdf (area lights cannot
        # produce a direction that misses all geometry).
        from .envmap import eval_envmap, envmap_pdf

        env_l = eval_envmap(scene.envmap, scene.envmap_rot, direction)
        if cfg.nee:
            pdf_e = envmap_pdf(scene.envmap_pdf, scene.envmap_rot, direction) * p_env
            w_env = jnp.where(
                state["prev_nee_any"] & (~state["was_delta"]),
                smp.power_heuristic(state["prev_pdf"], pdf_e),
                1.0,
            )
            scale_env = jnp.where(state["count_emitted"], 1.0, w_env)
        else:
            scale_env = jnp.ones_like(state["prev_pdf"])
        emitted = emitted + jnp.where(
            miss[..., None], scale_env[..., None] * state["weight"] * env_l, 0.0
        )

    # path termination tests (rayhit.rchit:770-784)
    invalid_hemi = (m3.dot(wi_world, gn) <= 0.0) & (~transmission)
    self_isect = (m3.dot(gn, -direction) <= 0.0) & (~transmission)
    bad_pdf = (~jnp.isfinite(pdf)) | (~m3.is_finite3(f)) | (pdf == 0.0)
    terminate = hit & (invalid_hemi | self_isect | bad_pdf)

    # MIS weight carried to the next emitter hit (rayhit.rchit:785-790)
    new_direct_weight = jnp.where(nee_done, smp.power_heuristic(pdf, light_pdf), 1.0)

    # next ray state (rayhit.rchit:792-796)
    offset_n = m3.faceforward(gn, -wi_world, gn)
    new_origin = position + cfg.origin_epsilon * offset_n
    new_weight = state["weight"] * f * (now * _safe_inv(pdf))[..., None]

    cont = hit & (~terminate)
    state_out = dict(state)
    # instrumentation: closest-hit rays for every alive lane + shadow rays
    # (metrics the reference never reports, SURVEY.md §5.5)
    state_out["rays_traced"] = (
        state["rays_traced"] + alive.astype(jnp.int32) + nee_candidate.astype(jnp.int32)
    )
    state_out["origin"] = jnp.where(cont[..., None], new_origin, origin)
    state_out["direction"] = jnp.where(cont[..., None], wi_world, direction)
    state_out["weight"] = jnp.where(cont[..., None], new_weight, state["weight"])
    state_out["direct_weight"] = jnp.where(cont, new_direct_weight, state["direct_weight"])
    state_out["prev_pdf"] = jnp.where(cont, pdf, state["prev_pdf"])
    state_out["prev_nee"] = jnp.where(cont, nee_done, state["prev_nee"])
    state_out["prev_nee_any"] = jnp.where(cont, nee_candidate, state["prev_nee_any"])
    state_out["was_delta"] = jnp.where(cont, delta, wd)
    state_out["count_emitted"] = jnp.where(cont, False, ce)
    state_out["done"] = state["done"] | miss | terminate

    # raygen side: firefly clamp + accumulate (raygen.rgen:60-63)
    keep = jnp.all(emitted < cfg.firefly_clamp, axis=-1)
    state_out["radiance"] = state["radiance"] + jnp.where(
        (alive & keep)[..., None], emitted, 0.0
    )

    # Russian roulette (raygen.rgen:66-71)
    if_rr = bounce > cfg.rr_start_depth
    q = jnp.clip(jnp.max(state_out["weight"], axis=-1), cfg.rr_clamp_min, 1.0)
    u_rr = rng.uniform(seed, bounce, CH_RR)
    rr_kill = if_rr & (u_rr > q)
    state_out["weight"] = jnp.where(
        (if_rr & ~rr_kill)[..., None], state_out["weight"] / q[..., None], state_out["weight"]
    )
    state_out["done"] = state_out["done"] | rr_kill
    return state_out


def _safe_inv(x, eps=1e-12):
    return 1.0 / jnp.maximum(x, eps)


def trace_rays(
    scene: SceneData,
    cfg: RenderConfig,
    origin,
    direction,
    seed,
    differentiable: bool = False,
):
    """Trace a batch of rays to completion.

    Returns (radiance (R,3), rays_traced (R,) int32) — the latter counts
    closest-hit + shadow rays actually issued per lane.

    Two loop forms over the same bounce step:
      * `lax.while_loop` with an all-lanes-done early exit (default): the
        wavefront stops as soon as every path has terminated, which at
        depth 50 skips the vast majority of iterations (mean path length in
        closed scenes is a handful of bounces).
      * `lax.scan` over a static depth bound with per-bounce rematerialization
        (`differentiable=True`): reverse-mode path-replay backprop needs a
        reversible loop; `jax.checkpoint` makes the backward pass re-run each
        bounce instead of storing its intermediates — this *is* path replay,
        with the counter-based RNG regenerating identical paths.
    """
    r = origin.shape[0]
    state = dict(
        origin=origin,
        direction=direction,
        weight=jnp.ones((r, 3), jnp.float32),
        direct_weight=jnp.ones((r,), jnp.float32),
        prev_pdf=jnp.ones((r,), jnp.float32),
        prev_nee=jnp.zeros((r,), bool),
        prev_nee_any=jnp.zeros((r,), bool),
        was_delta=jnp.zeros((r,), bool),
        count_emitted=jnp.ones((r,), bool),  # raygen.rgen:43
        done=jnp.zeros((r,), bool),
        radiance=jnp.zeros((r, 3), jnp.float32),
        rays_traced=jnp.zeros((r,), jnp.int32),
        seed=seed,
    )

    # the reference's while loop runs depth = 0 .. MAX_DEPTH inclusive
    n_bounces = cfg.max_depth + 1

    if differentiable:
        bounce_step = lambda st, b: (_bounce(scene, cfg, b, st), None)
        if cfg.grad_remat == "bounce":
            bounce_step = jax.checkpoint(bounce_step, static_argnums=())
        state, _ = jax.lax.scan(
            bounce_step, state, jnp.arange(n_bounces, dtype=jnp.uint32)
        )
    else:

        def cond(carry):
            bounce, st = carry
            return (bounce < n_bounces) & (~jnp.all(st["done"]))

        def body(carry):
            bounce, st = carry
            return bounce + 1, _bounce(scene, cfg, bounce.astype(jnp.uint32), st)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return state["radiance"], state["rays_traced"]


def trace_wavefront(scene: SceneData, cfg: RenderConfig, pixel_index, timestamp0):
    """Persistent-lane wavefront: each lane owns one pixel and runs its
    cfg.spp samples back to back, regenerating a fresh camera path the
    moment the previous one terminates.

    The naive loop (scan over spp, while over bounces) leaves lanes idle
    from their path's death until the wavefront's slowest path finishes —
    measured ~2.5-3x wasted occupancy at depth 50 with Russian roulette.
    Regeneration keeps every lane busy until it exhausts its own sample
    budget; per-lane depth counters feed the RNG/RR (the bounce step is
    already elementwise in the depth).

    With cfg.sort_rays, lanes are periodically re-ordered by a direction-
    octant + origin-Morton key to restore packet coherence for BVH
    traversal; the pixel binding travels with the lane and results are
    scattered back at the end (the estimator is permutation-invariant).

    Returns (radiance_sum (R,3), rays_traced (R,), pixel (R,)) — lane order
    may differ from input when sorting; divide radiance by spp and scatter
    by pixel.
    """
    r = pixel_index.shape[0]
    t0 = jnp.uint32(timestamp0)

    def fresh_ray(pixel, sample_idx):
        seed = rng.pixel_seed(pixel, t0 + sample_idx)
        jitter = None
        if cfg.jitter:
            jitter = (
                rng.uniform(seed, jnp.uint32(0xFFFF), CH_JITTER_X),
                rng.uniform(seed, jnp.uint32(0xFFFF), CH_JITTER_Y),
            )
        o, d = generate_rays(scene.camera, cfg.width, cfg.height, pixel, jitter)
        return o, d, seed

    o0, d0, seed0 = fresh_ray(pixel_index, jnp.uint32(0))
    state = dict(
        origin=o0,
        direction=d0,
        weight=jnp.ones((r, 3), jnp.float32),
        direct_weight=jnp.ones((r,), jnp.float32),
        prev_pdf=jnp.ones((r,), jnp.float32),
        prev_nee=jnp.zeros((r,), bool),
        prev_nee_any=jnp.zeros((r,), bool),
        was_delta=jnp.zeros((r,), bool),
        count_emitted=jnp.ones((r,), bool),
        done=jnp.zeros((r,), bool),
        radiance=jnp.zeros((r, 3), jnp.float32),
        rays_traced=jnp.zeros((r,), jnp.int32),
        seed=seed0,
        depth=jnp.zeros((r,), jnp.uint32),
        sample=jnp.zeros((r,), jnp.uint32),
        pixel=pixel_index,
    )

    max_iters = cfg.spp * (cfg.max_depth + 1)

    def cond(carry):
        it, st = carry
        exhausted = st["done"] & (st["sample"] + 1 >= cfg.spp)
        return (it < max_iters) & (~jnp.all(exhausted))

    def body(carry):
        it, st = carry
        depth = st["depth"]
        st = _bounce(scene, cfg, depth, st)
        st["depth"] = depth + 1
        # per-path depth cutoff (the scan form bounded this by loop length)
        st["done"] = st["done"] | (st["depth"] >= cfg.max_depth + 1)

        # regenerate finished lanes that still have samples left
        regen = st["done"] & (st["sample"] + 1 < cfg.spp)
        new_sample = jnp.where(regen, st["sample"] + 1, st["sample"])
        o_n, d_n, seed_n = fresh_ray(st["pixel"], new_sample)
        rsel = regen[..., None]
        st["origin"] = jnp.where(rsel, o_n, st["origin"])
        st["direction"] = jnp.where(rsel, d_n, st["direction"])
        st["seed"] = jnp.where(regen, seed_n, st["seed"])
        st["weight"] = jnp.where(rsel, 1.0, st["weight"])
        st["direct_weight"] = jnp.where(regen, 1.0, st["direct_weight"])
        st["prev_pdf"] = jnp.where(regen, 1.0, st["prev_pdf"])
        st["prev_nee"] = jnp.where(regen, False, st["prev_nee"])
        st["prev_nee_any"] = jnp.where(regen, False, st["prev_nee_any"])
        st["was_delta"] = jnp.where(regen, False, st["was_delta"])
        st["count_emitted"] = jnp.where(regen, True, st["count_emitted"])
        st["depth"] = jnp.where(regen, 0, st["depth"])
        st["sample"] = new_sample
        st["done"] = st["done"] & (~regen)

        if cfg.sort_rays:
            def do_sort(s):
                key = _ray_sort_key(scene, s["origin"], s["direction"], s["done"])
                order = jnp.argsort(key)
                return {k: v[order] for k, v in s.items()}

            st = jax.lax.cond(
                (it + 1) % cfg.sort_interval == 0, do_sort, lambda s: s, st
            )
        return it + 1, st

    _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return state["radiance"], state["rays_traced"], state["pixel"]


def _ray_sort_key(scene: SceneData, origin, direction, done):
    """int32 coherence key: direction octant (3 bits) | origin Morton (27).
    Done lanes sort to the end."""
    bb_min = scene.bvh_node_min[0]
    bb_max = scene.bvh_node_max[0]
    extent = jnp.maximum(bb_max - bb_min, 1e-6)
    q = jnp.clip((origin - bb_min) / extent, 0.0, 1.0)
    q = (q * 511.0).astype(jnp.uint32)  # 9 bits per axis

    def expand9(v):
        v = (v | (v << 16)) & jnp.uint32(0x030000FF)
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    morton = (expand9(q[:, 0]) << 2) | (expand9(q[:, 1]) << 1) | expand9(q[:, 2])
    octant = (
        ((direction[:, 0] < 0).astype(jnp.uint32) << 2)
        | ((direction[:, 1] < 0).astype(jnp.uint32) << 1)
        | (direction[:, 2] < 0).astype(jnp.uint32)
    )
    key = ((octant << 27) | (morton & jnp.uint32((1 << 27) - 1))).astype(jnp.int32)
    return jnp.where(done, jnp.int32(2**30), key)


def render_sample(
    scene: SceneData, cfg: RenderConfig, pixel_index, timestamp, differentiable: bool = False
):
    """Radiance of one sample (one reference 'frame') per pixel index.
    Returns (radiance (R,3), rays_traced (R,))."""
    seed = rng.pixel_seed(pixel_index, timestamp)
    jitter = None
    if cfg.jitter:
        jitter = (
            rng.uniform(seed, jnp.uint32(0xFFFF), CH_JITTER_X),
            rng.uniform(seed, jnp.uint32(0xFFFF), CH_JITTER_Y),
        )
    origin, direction = generate_rays(scene.camera, cfg.width, cfg.height, pixel_index, jitter)
    return trace_rays(scene, cfg, origin, direction, seed, differentiable=differentiable)


@partial(jax.jit, static_argnames=("cfg",))
def render_image_stats(scene: SceneData, cfg: RenderConfig, timestamp0=0):
    """Render (H, W, 3) plus total rays traced (scalar int64-ish float).

    Mean of cfg.spp samples, batched over rays.  Each sample reuses the
    reference's per-frame seeding with an advancing timestamp (progressive
    accumulation semantics, raygen.rgen:37,84-91), so `spp` samples here ==
    `spp` reference frames.
    """
    n_pixels = cfg.width * cfg.height
    batch = min(cfg.ray_batch, n_pixels)
    n_batches = -(-n_pixels // batch)
    padded = n_batches * batch
    pixel_index = jnp.arange(padded, dtype=jnp.uint32).reshape(n_batches, batch)

    timestamp0 = jnp.uint32(timestamp0)

    def render_batch(pix):
        rad, rays, pixel = trace_wavefront(scene, cfg, pix, timestamp0)
        if cfg.sort_rays:  # lanes permuted: scatter back to pixel order
            local = (pixel - pix[0]).astype(jnp.int32)
            rad = jnp.zeros_like(rad).at[local].set(rad)
        return rad / cfg.spp, jnp.sum(rays.astype(jnp.float32))

    radiance, nrays = jax.lax.map(render_batch, pixel_index)
    radiance = radiance.reshape(padded, 3)
    return radiance[:n_pixels].reshape(cfg.height, cfg.width, 3), jnp.sum(nrays)


@partial(jax.jit, static_argnames=("cfg",))
def render_image(scene: SceneData, cfg: RenderConfig, timestamp0=0):
    """Render (H, W, 3); see render_image_stats."""
    return render_image_stats(scene, cfg, timestamp0)[0]


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("accum",))
def render_step(scene: SceneData, cfg: RenderConfig, accum, timestamp):
    """One progressive frame: 1 spp folded into the running mean.

    Reference semantics (raygen.rgen:84-108): accum' = mix(accum, cur,
    1/(t+1)), skipping NaN results; the accumulation buffer is donated just
    as the reference writes its storage image in place.
    """
    one_spp = cfg.replace(spp=1)
    frame = render_image(scene, one_spp, timestamp)
    t = timestamp.astype(jnp.float32)
    a = 1.0 / (t + 1.0)
    mixed = accum * (1.0 - a) + frame * a
    out = jnp.where(jnp.isnan(mixed), accum, mixed)
    return out
