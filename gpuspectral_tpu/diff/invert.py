"""Inverse rendering: recover BSDF/emitter parameters from target images.

Differentiate the renderer end-to-end and optimize scene parameters by gradient descent.
Path-replay backprop comes from the remat-ed bounce loop + counter-based RNG
(see diff/gradcheck.py); this module adds the optimization loop, parameter
constraints, checkpointing, and metrics.

Parameterization: optimizes in an unconstrained space u with
params = lo + (hi - lo) * sigmoid(u) per entry (albedo/reflectance colors in
[0, 1], roughness alphas in [1e-3, 1.5]; see `param_bounds`), so gradient
steps cannot leave the physical domain.  Emitter radiance (the north star's
"emitter parameters") optimizes as softplus(v) per light — positive,
unbounded above — and is scattered back onto the emitting triangles so NEE
light sampling and BSDF-path emitter hits stay consistent.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..integrator.path_tracer import render_sample
from ..scene.data import SceneData
from ..utils.config import RenderConfig
from ..utils.metrics import MetricsLogger
from ..bsdf.table import (
    BSDF_DIFFUSE,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_FLOOR,
    BSDF_ROUGH_PLASTIC,
    BSDF_SMOOTH_FLOOR,
    BSDF_SMOOTH_PLASTIC,
)


def optimizable_mask(kinds: np.ndarray) -> np.ndarray:
    """(B, NUM_PARAMS) bool: which table entries are continuously
    optimizable (albedo/reflectance colors and roughness alphas — the
    parameters path-replay gradients are valid for)."""
    b = kinds.shape[0]
    mask = np.zeros((b, 12), bool)
    for i, k in enumerate(kinds):
        if k in (BSDF_DIFFUSE, BSDF_SMOOTH_PLASTIC, BSDF_SMOOTH_FLOOR,
                 BSDF_ROUGH_FLOOR, BSDF_ROUGH_PLASTIC):
            mask[i, 0:3] = True  # diffuse color
        if k == BSDF_ROUGH_CONDUCTOR:
            mask[i, 6:9] = True  # reflectance
            mask[i, 9] = True  # alpha
        if k == BSDF_ROUGH_PLASTIC:
            mask[i, 6] = True  # alpha
        if k == BSDF_ROUGH_FLOOR:
            mask[i, 4] = True  # alpha
    return mask


_ALPHA_LO, _ALPHA_HI = 1e-3, 1.5


def param_bounds(kinds: np.ndarray):
    """(lo, hi) arrays (B, NUM_PARAMS) bounding each optimizable entry:
    colors in [0, 1], roughness alphas in [1e-3, 1.5].  Non-optimizable
    entries get [0, 1] placeholders (they never move — see
    `optimizable_mask`)."""
    b = kinds.shape[0]
    lo = np.zeros((b, 12), np.float32)
    hi = np.ones((b, 12), np.float32)
    for i, k in enumerate(kinds):
        if k == BSDF_ROUGH_CONDUCTOR:
            lo[i, 9], hi[i, 9] = _ALPHA_LO, _ALPHA_HI
        if k == BSDF_ROUGH_PLASTIC:
            lo[i, 6], hi[i, 6] = _ALPHA_LO, _ALPHA_HI
        if k == BSDF_ROUGH_FLOOR:
            lo[i, 4], hi[i, 4] = _ALPHA_LO, _ALPHA_HI
    return lo, hi


def params_to_unconstrained(params, lo, hi):
    """u = logit((p - lo) / (hi - lo)), clipped into the open interval."""
    t = (jnp.asarray(params) - lo) / (hi - lo)
    t = jnp.clip(t, 1e-4, 1.0 - 1e-4)
    return jnp.log(t) - jnp.log1p(-t)


def unconstrained_to_params(u, lo, hi):
    return lo + (hi - lo) * jax.nn.sigmoid(u)


def emission_to_unconstrained(e):
    """Inverse softplus (stable): v = e + log(-expm1(-e)) for e > 0."""
    e = jnp.maximum(jnp.asarray(e, jnp.float32), 1e-6)
    return e + jnp.log(-jnp.expm1(-e))


def unconstrained_to_emission(v):
    return jax.nn.softplus(v)


def scatter_light_emission(scene: SceneData, light_emission):
    """Scene with `light_emission` applied consistently to both the light
    table (NEE sampling) and the per-triangle emission (BSDF-path emitter
    hits, path_tracer.py self_emit)."""
    lidx = scene.tri_light_idx
    tri_emission = jnp.where(
        (lidx >= 0)[:, None],
        light_emission[jnp.maximum(lidx, 0)],
        scene.tri_emission,
    )
    return scene.replace(light_emission=light_emission, tri_emission=tri_emission)


@partial(jax.jit, static_argnames=("cfg", "spp"))
def _render(scene: SceneData, cfg: RenderConfig, spp: int, timestamp0):
    n_pixels = cfg.width * cfg.height
    pix = jnp.arange(n_pixels, dtype=jnp.uint32)

    def body(acc, s):
        rad, _ = render_sample(scene, cfg, pix, timestamp0 + s, differentiable=False)
        return acc + rad, None

    acc, _ = jax.lax.scan(
        body, jnp.zeros((n_pixels, 3), jnp.float32), jnp.arange(spp, dtype=jnp.uint32)
    )
    return (acc / spp).reshape(cfg.height, cfg.width, 3)


def _make_step(scene, cfg, mask, lo, hi, target, opt, optimize_emission):
    """Adam step in unconstrained space.  The opt variable is a pytree
    {"u": (B,12)} (+ {"v": (L,3)} when optimizing emitters); the physical
    parameters are reconstructed inside the loss so every step stays in
    domain by construction."""
    target_flat = target.reshape(-1, 3)
    n_pixels = cfg.width * cfg.height
    pix = jnp.arange(n_pixels, dtype=jnp.uint32)

    def to_physical(ov):
        sc = scene
        if "u" in ov:
            params = jnp.where(
                mask > 0, unconstrained_to_params(ov["u"], lo, hi), scene.bsdf_params
            )
            sc = sc.replace(bsdf_params=params)
        if optimize_emission:
            sc = scatter_light_emission(sc, unconstrained_to_emission(ov["v"]))
        return sc

    @partial(jax.jit, donate_argnames=("opt_vars", "opt_state"))
    def step(opt_vars, opt_state, timestamp0):
        def loss_fn(ov):
            sc = to_physical(ov)

            def body(acc, s):
                rad, _ = render_sample(sc, cfg, pix, timestamp0 + s, differentiable=True)
                return acc + rad, None

            acc, _ = jax.lax.scan(
                body,
                jnp.zeros((n_pixels, 3), jnp.float32),
                jnp.arange(cfg.spp, dtype=jnp.uint32),
            )
            img = acc / cfg.spp
            return jnp.mean((img - target_flat) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(opt_vars)
        if "u" in grads:
            grads["u"] = grads["u"] * mask  # only optimizable entries move
        updates, opt_state = opt.update(grads, opt_state, opt_vars)
        opt_vars = optax.apply_updates(opt_vars, updates)
        return opt_vars, opt_state, loss

    return step, to_physical


def invert(
    scene: SceneData,
    target,  # (H,W,3) target image
    cfg: RenderConfig,
    steps: int = 100,
    lr: float = 0.02,
    init_params=None,
    metrics: Optional[MetricsLogger] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 25,
    optimize_emission: bool = False,
    init_emission=None,
    optimize_bsdf: bool = True,
    timestamp0: int = 1000,
    resample: bool = True,
):
    """Optimize scene.bsdf_params (and, with optimize_emission, the emitter
    radiances) toward `target`, stepping in unconstrained (sigmoid/softplus)
    space so parameters stay in the physical domain.

    Returns (params, history), or ((params, light_emission), history) when
    optimize_emission is set."""
    kinds = np.asarray(scene.bsdf_kind)
    mask = jnp.asarray(optimizable_mask(kinds), jnp.float32)
    lo, hi = (jnp.asarray(x) for x in param_bounds(kinds))
    params = scene.bsdf_params if init_params is None else jnp.asarray(init_params)
    opt_vars = {}
    if optimize_bsdf:
        opt_vars["u"] = params_to_unconstrained(params, lo, hi)
    if optimize_emission:
        emission = (
            scene.light_emission if init_emission is None else jnp.asarray(init_emission)
        )
        opt_vars["v"] = emission_to_unconstrained(emission)
    opt = optax.adam(lr)
    opt_state = opt.init(opt_vars)
    target = jnp.asarray(target, jnp.float32)

    step, to_physical = _make_step(
        scene, cfg, mask, lo, hi, target, opt, optimize_emission
    )

    history = []
    for i in range(steps):
        t0 = time.time()
        # resample=True draws fresh paths per step (SGD, the production
        # setting); resample=False fixes the sample set — with timestamp0
        # matching the target's, the loss is a deterministic MSE whose
        # minimum is exactly the true parameters (common random numbers)
        ts = timestamp0 + (i * cfg.spp if resample else 0)
        opt_vars, opt_state, loss = step(opt_vars, opt_state, jnp.uint32(ts))
        loss = float(loss)
        dt = time.time() - t0
        history.append(loss)
        if metrics:
            metrics.log(event="invert_step", step=i, loss=loss, seconds=dt,
                        grad_steps_per_s=1.0 / max(dt, 1e-9))
        if checkpoint_dir and (i + 1) % checkpoint_every == 0:
            from ..io.checkpoint import save_checkpoint

            sc = to_physical(opt_vars)
            save_checkpoint(
                f"{checkpoint_dir}/ckpt_{i + 1:06d}.npz",
                dict(params=np.asarray(sc.bsdf_params),
                     light_emission=np.asarray(sc.light_emission),
                     step=np.int64(i + 1), loss=np.float64(loss)),
            )
    final = to_physical(opt_vars)
    if optimize_emission:
        return (final.bsdf_params, final.light_emission), history
    return final.bsdf_params, history
