from .path_tracer import render_image, trace_rays, render_sample  # noqa: F401


def use_megakernel(scene, cfg, platform=None) -> bool:
    """The one integrator dispatch decision: the brute-force megakernel
    (integrator/mega.py) on a GPU when it covers (scene, cfg), the XLA
    wavefront otherwise.  `platform` defaults to the platform of the first
    JAX device."""
    import jax

    from .mega import mega_eligible

    if platform is None:
        platform = jax.devices()[0].platform
    return platform == "gpu" and mega_eligible(scene, cfg)


def render_image_stats_auto(scene, cfg, timestamp0: int = 0):
    """Render (H, W, 3) + total rays traced through the integrator
    `use_megakernel` picks."""
    import jax.numpy as jnp

    from .mega import render_mega
    from .path_tracer import render_image_stats

    if use_megakernel(scene, cfg):
        return render_mega(scene, cfg, timestamp0)
    return render_image_stats(scene, cfg, jnp.uint32(timestamp0))


def render_image_auto(scene, cfg, timestamp0: int = 0):
    """Render (H, W, 3); see render_image_stats_auto."""
    return render_image_stats_auto(scene, cfg, timestamp0)[0]
