"""Counter-based PCG random number generation.

The reference uses a *stateful* per-pixel PCG stream seeded with
``pcgHash(tea(pixelIndex, timestamp))`` and threads the mutable state through
the bounce loop (reference: assets/shaders/pt_common.glsl:86-120,
raygen.rgen:37).  A stateful stream is a poor fit for a wavefront integrator — it
serializes draws and makes backward replay depend on exact draw order.

We keep the same hash family (PCG-RXS-M-XS output permutation, TEA seed mix)
but make every draw *counter-based*: a uniform is a pure function of
``(pixel_seed, bounce, channel)``.  This gives

  * bit-exact path replay for free (the backward pass re-evaluates the same
    pure function — no recorded state),
  * order independence (all channels of a bounce can be drawn vectorized),
  * identical statistical quality (it is the same PCG output permutation).

All functions are shape-polymorphic: `seed` may be any uint32 array and
results broadcast elementwise.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32

# Constants from the reference PCG (pt_common.glsl:87-100).
_PCG_MULT = 747796405
_PCG_INC = 2891336453
_PCG_XSH_MULT = 277803737

_INV_U32_MAX = float(1.0 / 4294967295.0)  # reference: randPcg * (1/0xffffffff)


def pcg_hash(v):
    """PCG-RXS-M-XS hash of a uint32 (reference pt_common.glsl:95-100)."""
    v = v.astype(_U32) if hasattr(v, "astype") else jnp.asarray(v, _U32)
    state = v * _U32(_PCG_MULT) + _U32(_PCG_INC)
    word = ((state >> ((state >> 28) + _U32(4))) ^ state) * _U32(_PCG_XSH_MULT)
    return (word >> 22) ^ word


def tea(val0, val1, rounds: int = 4):
    """TEA seed scrambler (reference pt_common.glsl:106-120)."""
    v0 = jnp.asarray(val0, _U32)
    v1 = jnp.asarray(val1, _U32)
    v0, v1 = jnp.broadcast_arrays(v0, v1)
    s0 = _U32(0)
    for _ in range(rounds):
        s0 = s0 + _U32(0x9E3779B9)
        v0 = v0 + (((v1 << 4) + _U32(0xA341316C)) ^ (v1 + s0) ^ ((v1 >> 5) + _U32(0xC8013EA4)))
        v1 = v1 + (((v0 << 4) + _U32(0xAD90777D)) ^ (v0 + s0) ^ ((v0 >> 5) + _U32(0x7E95761E)))
    return v0


def pixel_seed(pixel_index, timestamp):
    """Per-pixel stream seed, matching raygen.rgen:37:
    ``pcgHash(tea(width*y + x, timestamp))``."""
    return pcg_hash(tea(pixel_index, timestamp))


def random_bits(seed, bounce, channel):
    """Counter-based uint32 draw: pure function of (seed, bounce, channel).

    Mixes the counter into the seed with one PCG round per component; the
    composition of PCG hashes keeps full avalanche behavior.
    """
    s = jnp.asarray(seed, _U32)
    b = _U32(bounce) if isinstance(bounce, int) else jnp.asarray(bounce, _U32)
    c = _U32(channel) if isinstance(channel, int) else jnp.asarray(channel, _U32)
    return pcg_hash(s ^ pcg_hash(b * _U32(0x9E3779B9) + c + _U32(1)))


def uniform(seed, bounce, channel):
    """U[0,1) float32 draw (reference randUniform: bits * 1/0xffffffff)."""
    return random_bits(seed, bounce, channel).astype(jnp.float32) * _INV_U32_MAX


def uniform2(seed, bounce, channel0):
    """Two consecutive-channel uniforms, stacked on the last axis."""
    u0 = uniform(seed, bounce, channel0)
    u1 = uniform(seed, bounce, channel0 + 1)
    return u0, u1
