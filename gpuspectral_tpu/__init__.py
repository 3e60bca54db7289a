"""gpuspectral_tpu: a differentiable path tracer for NVIDIA GPUs in JAX.

A ground-up JAX/Pallas re-design of the capabilities of GPUSpectral
(reference: a Vulkan-RT C++ path tracer). Nothing here is a
port: the Vulkan HAL / framegraph / pipeline-cache machinery collapses into
XLA's compilation model, while the parts Vulkan supplied in hardware —
acceleration structures and the raygen/hit/miss execution model — are rebuilt
as XLA programs and one Pallas GPU kernel (see `bvh/` and `integrator/`).

Layout (mirrors SURVEY.md §7.1):
  scene/       Mitsuba-XML + OBJ loading -> SceneData pytree
  ops/         vectorized math kernels: RNG, sampling, Fresnel/GGX, intersection
  bsdf/        the 8-BSDF library (sample/eval) with vectorized dispatch
  bvh/         LBVH build + flattened nodes + traversal kernels
  integrator/  wavefront path tracer (render step, accumulation)
  diff/        path-replay differentiable rendering
  parallel/    device-mesh sharding (tile x spp) and multi-host helpers
  io/          PNG/EXR/PFM images, checkpoints, metrics
  utils/       config, logging
  cli/         render / benchmark / gradcheck entry points
"""

import os as _os

# In the scanned and reverse-mode bounce loops (diff/gradcheck, diff/invert)
# XLA (jax 0.9.0) gives two Triton softmax fusions with one computation but
# different block configs the same kernel, compiled for 32 threads, and
# launches it with 128: the H100 refuses (CUDA_ERROR_INVALID_VALUE).  Its
# Triton multi-output fusions failed the same way.  XLA reads XLA_FLAGS once,
# when JAX starts its first backend, so importing this package before any
# JAX computation turns both off; a flag the user already set is kept.
_GPU_XLA_FLAGS = (
    "--xla_gpu_unsupported_enable_triton_multi_output_fusion=false",
    "--xla_disable_hlo_passes=triton-softmax-rewriter",
)
_flags = _os.environ.get("XLA_FLAGS", "")
for _flag in _GPU_XLA_FLAGS:
    if _flag.split("=")[0] + "=" not in _flags:
        _flags = f"{_flags} {_flag}".strip()
_os.environ["XLA_FLAGS"] = _flags


__version__ = "0.1.0"
