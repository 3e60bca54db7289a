"""BSDF parameter table: struct-of-arrays storage for the 8 BSDF types.

The reference keeps one C array per BSDF type plus a 16-bit-type/16-bit-index
packed handle (renderer/Scene.h:84-97,166-181, assets/shaders/BSDF.inc).  We
instead pack every BSDF into one dense float row so a surface hit is a
single gather and dispatch is a vectorized select — no pointer chasing.

Row layout (NUM_PARAMS = 12 floats), by type:

  DIFFUSE            [0:3] reflectance
  SMOOTH_DIELECTRIC  [0] ior_in  [1] ior_out
  SMOOTH_CONDUCTOR   [0] ior_in  [1] ior_out
  SMOOTH_PLASTIC     [0:3] diffuse [3] ior_in [4] ior_out [5] r0
  ROUGH_CONDUCTOR    [0:3] eta [3:6] k [6:9] reflectance [9] alpha
  SMOOTH_FLOOR       [0:3] diffuse [3] r0
  ROUGH_FLOOR        [0:3] diffuse [3] r0 [4] alpha
  ROUGH_PLASTIC      [0:3] diffuse [3] ior_in [4] ior_out [5] r0 [6] alpha

Type ids match the reference enum (rayhit.rchit:332-339) so parity is easy to
audit.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

BSDF_DIFFUSE = 0
BSDF_SMOOTH_DIELECTRIC = 1
BSDF_SMOOTH_CONDUCTOR = 2
BSDF_SMOOTH_PLASTIC = 3
BSDF_ROUGH_CONDUCTOR = 4
BSDF_SMOOTH_FLOOR = 5
BSDF_ROUGH_FLOOR = 6
BSDF_ROUGH_PLASTIC = 7

NUM_BSDF_TYPES = 8
NUM_PARAMS = 12

BSDF_NAMES = [
    "diffuse",
    "smooth_dielectric",
    "smooth_conductor",
    "smooth_plastic",
    "rough_conductor",
    "smooth_floor",
    "rough_floor",
    "rough_plastic",
]


def _row(**kw) -> np.ndarray:
    r = np.zeros((NUM_PARAMS,), np.float32)
    for k, v in kw.items():
        sl, val = k, np.asarray(v, np.float32)
        r[sl] = val
    return r


def diffuse(reflectance) -> tuple[int, np.ndarray]:
    r = np.zeros((NUM_PARAMS,), np.float32)
    r[0:3] = np.asarray(reflectance, np.float32)
    return BSDF_DIFFUSE, r


def smooth_dielectric(ior_in, ior_out=1.0) -> tuple[int, np.ndarray]:
    r = np.zeros((NUM_PARAMS,), np.float32)
    r[0], r[1] = ior_in, ior_out
    return BSDF_SMOOTH_DIELECTRIC, r


def smooth_conductor(ior_in, ior_out=1.0) -> tuple[int, np.ndarray]:
    r = np.zeros((NUM_PARAMS,), np.float32)
    r[0], r[1] = ior_in, ior_out
    return BSDF_SMOOTH_CONDUCTOR, r


def smooth_plastic(diffuse_rgb, ior_in, ior_out=1.0, r0=None) -> tuple[int, np.ndarray]:
    if r0 is None:
        r0 = ((ior_in - ior_out) / (ior_in + ior_out)) ** 2
    r = np.zeros((NUM_PARAMS,), np.float32)
    r[0:3] = np.asarray(diffuse_rgb, np.float32)
    r[3], r[4], r[5] = ior_in, ior_out, r0
    return BSDF_SMOOTH_PLASTIC, r


def rough_conductor(eta, k, reflectance, alpha) -> tuple[int, np.ndarray]:
    r = np.zeros((NUM_PARAMS,), np.float32)
    r[0:3] = np.asarray(eta, np.float32)
    r[3:6] = np.asarray(k, np.float32)
    r[6:9] = np.asarray(reflectance, np.float32)
    r[9] = alpha
    return BSDF_ROUGH_CONDUCTOR, r


def smooth_floor(diffuse_rgb, r0) -> tuple[int, np.ndarray]:
    r = np.zeros((NUM_PARAMS,), np.float32)
    r[0:3] = np.asarray(diffuse_rgb, np.float32)
    r[3] = r0
    return BSDF_SMOOTH_FLOOR, r


def rough_floor(diffuse_rgb, r0, alpha) -> tuple[int, np.ndarray]:
    r = np.zeros((NUM_PARAMS,), np.float32)
    r[0:3] = np.asarray(diffuse_rgb, np.float32)
    r[3], r[4] = r0, alpha
    return BSDF_ROUGH_FLOOR, r


def rough_plastic(diffuse_rgb, ior_in, ior_out=1.0, r0=None, alpha=0.1) -> tuple[int, np.ndarray]:
    if r0 is None:
        r0 = ((ior_in - ior_out) / (ior_in + ior_out)) ** 2
    r = np.zeros((NUM_PARAMS,), np.float32)
    r[0:3] = np.asarray(diffuse_rgb, np.float32)
    r[3], r[4], r[5], r[6] = ior_in, ior_out, r0, alpha
    return BSDF_ROUGH_PLASTIC, r


@dataclasses.dataclass
class BSDFTable:
    """Mutable host-side builder for the dense BSDF table."""

    kinds: List[int] = dataclasses.field(default_factory=list)
    rows: List[np.ndarray] = dataclasses.field(default_factory=list)

    def add(self, kind_row: tuple[int, np.ndarray]) -> int:
        kind, row = kind_row
        self.kinds.append(kind)
        self.rows.append(row)
        return len(self.kinds) - 1

    def pack(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (kind (B,) int32, params (B, NUM_PARAMS) float32). Always at
        least one row so downstream shapes are never empty."""
        if not self.kinds:
            return (
                np.zeros((1,), np.int32),
                np.zeros((1, NUM_PARAMS), np.float32),
            )
        return (
            np.asarray(self.kinds, np.int32),
            np.stack(self.rows).astype(np.float32),
        )
