"""Device-mesh distribution: tile x spp sharding with replicated scene.

The reference is strictly single-GPU (SURVEY.md §2.3: one graphics queue,
no NCCL/MPI anywhere).  The distribution plan:

  * a 2-D mesh (tiles, spp): pixels sharded on one axis, samples-per-pixel
    on the other — both embarrassingly parallel, so the forward pass needs
    ZERO communication; collectives appear only at the end:
      - `psum` over the spp axis to average samples,
      - gradients all-reduced with `psum` over both axes in the
        inverse-rendering step,
  * scene + BVH replicated to every device (they are small relative to
    device memory),
  * the cards of one host are joined all to all (NVLink), so the mesh
    follows the algorithm and has no topology of its own,
  * multi-process: the same `shard_map` program under
    `jax.distributed.initialize` (parallel/launch.py).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrator.path_tracer import render_sample
from ..scene.data import SceneData
from ..utils.config import RenderConfig


def make_mesh(n_devices: Optional[int] = None, spp_shards: int = 1) -> Mesh:
    """Build a (tiles, spp) mesh over the first n_devices devices."""
    devs = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    n = len(devs)
    assert n % spp_shards == 0, (n, spp_shards)
    arr = np.asarray(devs).reshape(n // spp_shards, spp_shards)
    return Mesh(arr, ("tiles", "spp"))


def _replicated_specs(tree):
    return jax.tree_util.tree_map(lambda _: P(), tree)


def _prep_inputs(mesh: Mesh, scene: SceneData, arrays):
    """Single-process: pass host arrays straight through (jit handles the
    placement).  Multi-process: shard_map needs *global* arrays — build them
    from the identical per-host values (parallel/launch.py helpers)."""
    if jax.process_count() <= 1:
        return scene, [jnp.asarray(a) for a, _ in arrays]
    from .launch import global_sharded, replicate_pytree

    scene = replicate_pytree(mesh, scene)
    return scene, [global_sharded(mesh, np.asarray(a), spec) for a, spec in arrays]


def render_image_sharded(
    scene: SceneData, cfg: RenderConfig, mesh: Mesh, timestamp0: int = 0
):
    """Distributed render: pixels sharded over 'tiles', spp over 'spp'.

    Forward pass communicates nothing; the final sample average is one psum
    over the spp axis.  Returns a replicated (H, W, 3) image.
    """
    n_pixels = cfg.width * cfg.height
    tiles = mesh.shape["tiles"]
    spp_shards = mesh.shape["spp"]
    assert n_pixels % tiles == 0, (n_pixels, tiles)
    assert cfg.spp % spp_shards == 0, (cfg.spp, spp_shards)
    local_spp = cfg.spp // spp_shards

    scene, [pixel_index] = _prep_inputs(
        mesh, scene, [(np.arange(n_pixels, dtype=np.uint32), P("tiles"))]
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("tiles"), _replicated_specs(scene)),
        out_specs=P("tiles"),
        check_vma=False,  # nested scans carry fresh constants; vma analysis
        # would demand pcasts with no behavioral effect
    )
    def _render(pix, scene_rep):
        s0 = jax.lax.axis_index("spp") * local_spp

        def body(acc, s):
            rad, _ = render_sample(scene_rep, cfg, pix, jnp.uint32(timestamp0) + s0 + s)
            return acc + rad, None

        acc, _ = jax.lax.scan(
            body,
            jnp.zeros((pix.shape[0], 3), jnp.float32),
            jnp.arange(local_spp, dtype=jnp.uint32),
        )
        # average over the spp mesh axis — the only collective in the forward
        return jax.lax.pmean(acc / local_spp, "spp")

    radiance = _render(pixel_index, scene)
    return radiance.reshape(cfg.height, cfg.width, 3)


def render_image_sharded_fast(
    scene: SceneData, cfg: RenderConfig, mesh: Mesh, timestamp0: int = 0,
    interpret: bool = False,
):
    """Distributed render through the GPU megakernel (integrator/mega.py)
    where `use_megakernel` picks it, else the XLA wavefront
    (render_image_sharded).  Pixel blocks are sharded over the 'tiles'
    axis; samples over 'spp' (each spp-shard renders progressive frames
    [t0 + i*local_spp, ...) whose union is exactly the unsharded sample
    set, so the summed estimator matches the single-device kernel).
    `interpret=True` runs the kernel in the Pallas interpreter (tests).

    Returns (image (H, W, 3) replicated, rays_traced scalar)."""
    from ..integrator import use_megakernel
    from ..integrator.mega import BLOCK, render_mega_rows

    platform = "gpu" if interpret else mesh.devices.flat[0].platform
    spp_shards = mesh.shape["spp"]
    if not use_megakernel(scene, cfg, platform) or cfg.spp % spp_shards:
        # the wavefront does not count rays; return 0.0 (a real float, so
        # callers doing float(nrays) keep working)
        img = render_image_sharded(scene, cfg, mesh, timestamp0)
        return img, jnp.float32(0.0)

    n_pixels = cfg.width * cfg.height
    tiles = mesh.shape["tiles"]
    local_spp = cfg.spp // spp_shards
    cfg_local = cfg.replace(spp=local_spp)

    # pixel blocks of BLOCK lanes; the block axis is padded to a tiles
    # multiple (pad lanes re-render pixel 0 and are masked out of the ray
    # counter)
    nb = -(-n_pixels // BLOCK)
    nb_pad = -(-nb // tiles) * tiles
    flat = np.arange(nb_pad * BLOCK, dtype=np.uint32)
    valid = flat < n_pixels
    pix_np = np.where(valid, flat, 0).reshape(nb_pad, BLOCK)

    scene_g, [pix] = _prep_inputs(mesh, scene, [(pix_np, P("tiles", None))])

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("tiles"), _replicated_specs(scene)),
        out_specs=(P("tiles"), P("tiles")),
        check_vma=False,
    )
    def _render(pix_l, scene_rep):
        ts = jnp.uint32(timestamp0) + jax.lax.axis_index("spp") * local_spp
        rr, rg, rb, rays = render_mega_rows(
            scene_rep, cfg_local, pix_l.reshape(-1), ts, interpret=interpret)
        rad = jnp.stack([rr, rg, rb], axis=-1).reshape(pix_l.shape + (3,))
        # sample sums add across spp shards (disjoint progressive frames)
        return (jax.lax.psum(rad, "spp"),
                jax.lax.psum(rays.reshape(pix_l.shape), "spp"))

    rad_blocks, ray_blocks = _render(pix, scene_g)
    rad = rad_blocks.reshape(-1, 3)[:n_pixels]
    nrays = jnp.sum(ray_blocks.reshape(-1)[:n_pixels].astype(jnp.float32))
    return (rad / cfg.spp).reshape(cfg.height, cfg.width, 3), nrays


def grad_step_sharded(
    scene: SceneData,
    cfg: RenderConfig,
    mesh: Mesh,
    target,
    timestamp0: int = 0,
):
    """One distributed inverse-rendering gradient step.

    Differentiates the MSE between the rendered image and `target` w.r.t.
    the BSDF parameter table, sharded like render_image_sharded.  The
    gradients all-reduce with one `psum` over both mesh axes, which XLA
    can overlap with the remat-ed backward bounce loop.

    Returns (loss, grads) with grads matching scene.bsdf_params.
    """
    n_pixels = cfg.width * cfg.height
    tiles = mesh.shape["tiles"]
    spp_shards = mesh.shape["spp"]
    assert n_pixels % tiles == 0
    assert cfg.spp % spp_shards == 0
    local_spp = cfg.spp // spp_shards

    scene, [pixel_index, target_flat] = _prep_inputs(
        mesh, scene,
        [(np.arange(n_pixels, dtype=np.uint32), P("tiles")),
         (np.asarray(target).reshape(n_pixels, 3), P("tiles", None))],
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("tiles"), P("tiles"), _replicated_specs(scene)),
        out_specs=(P(), _replicated_specs(scene.bsdf_params)),
        check_vma=False,
    )
    def _step(pix, tgt, scene_rep):
        s0 = jax.lax.axis_index("spp") * local_spp

        def local_accum(params):
            """Local-spp radiance sum for this shard's pixels."""
            sc = scene_rep.replace(bsdf_params=params)

            def body(acc, s):
                rad, _ = render_sample(
                    sc, cfg, pix, jnp.uint32(timestamp0) + s0 + s, differentiable=True
                )
                return acc + rad, None

            acc, _ = jax.lax.scan(
                body,
                jnp.zeros((pix.shape[0], 3), jnp.float32),
                jnp.arange(local_spp, dtype=jnp.uint32),
            )
            return acc / local_spp

        # Gradient strategy that does NOT differentiate through a collective
        # (collective transposes vary across jax versions): for the MSE loss
        # L = sum_p (img_p - t_p)^2 with img = (1/S) sum_shards x_i,
        # dL/dtheta = sum_p r_p * d img_p/dtheta with residual
        # r = 2 (img - t) held constant.  Each shard differentiates the
        # *linear* surrogate  sum(r * x_local) / S  through its own samples
        # only; the psum of those shard gradients is exactly dL/dtheta.
        x_local = local_accum(scene_rep.bsdf_params)
        img = jax.lax.pmean(jax.lax.stop_gradient(x_local), "spp")
        residual = jax.lax.stop_gradient(2.0 * (img - tgt))

        def surrogate(params):
            return jnp.sum(residual * local_accum(params)) / spp_shards

        grads = jax.grad(surrogate)(scene_rep.bsdf_params)
        denom = n_pixels * 3
        loss = jax.lax.psum(jnp.sum((img - tgt) ** 2), "tiles") / denom
        grads = jax.lax.psum(grads, ("tiles", "spp")) / denom
        return loss, grads

    return _step(pixel_index, target_flat, scene)
