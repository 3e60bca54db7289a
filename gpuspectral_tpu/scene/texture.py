"""Texture loading (bitmap via PIL, procedural checkerboard).

The reference parses `<texture>` elements but the binding path is commented
out (Loader.cpp:122-143; the BSDF hasTexture fields stay zero).  Here
textures actually shade: every texture is resampled to a fixed-resolution
linear-light RGB tile so the whole scene's textures form one dense atlas
(SceneData.textures) — a single gather per shaded hit.
"""

from __future__ import annotations

import os

import numpy as np

from .data import TEX_RES


def load_bitmap(path: str, gamma: float = 2.2) -> np.ndarray:
    """-> (TEX_RES, TEX_RES, 3) float32 linear. LDR images are sRGB-decoded
    (Mitsuba semantics).  Row 0 = v=1 (top), consistent with sample_nearest.
    Needs Pillow, which only bitmap textures use."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"loading the bitmap texture {path} needs Pillow (PIL), which is "
            "not installed") from e

    img = Image.open(path).convert("RGB").resize((TEX_RES, TEX_RES), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr**gamma


def make_checkerboard(
    color0=(0.4, 0.4, 0.4), color1=(0.2, 0.2, 0.2), uscale: float = 1.0, vscale: float = 1.0
) -> np.ndarray:
    """Procedural checkerboard (the reference's createCheckerboard analogue,
    Loader.cpp:128-139)."""
    u = (np.arange(TEX_RES) + 0.5) / TEX_RES
    v = (np.arange(TEX_RES) + 0.5) / TEX_RES
    uu, vv = np.meshgrid(u, 1.0 - v)
    cell = (np.floor(uu * 2 * uscale) + np.floor(vv * 2 * vscale)) % 2
    c0 = np.asarray(color0, np.float32)
    c1 = np.asarray(color1, np.float32)
    return np.where(cell[..., None] > 0.5, c0, c1).astype(np.float32)


def missing_texture() -> np.ndarray:
    """Neutral white tile for unresolvable texture files: modulation 1.0
    reproduces the reference's effective shading (it never samples textures
    at all — rayhit.rchit has no sampler), so a scene with missing bitmaps
    renders as if untextured instead of screaming debug-magenta into every
    indirect bounce (a magenta/black checker here measured +0.12 golden rel
    error on living-room, whose WoodFloor.jpg is absent from the repo)."""
    return np.ones((TEX_RES, TEX_RES, 3), np.float32)


def load_texture_element(elem, parent_dir: str) -> np.ndarray | None:
    """Translate a Mitsuba <texture> element into an atlas tile."""
    ttype = elem.get("type", "")
    props = {}
    for child in elem:
        name = child.get("name", "")
        props[name] = child
    if ttype == "bitmap":
        fn = None
        for child in elem:
            if child.tag == "string" and child.get("name") == "filename":
                fn = child.get("value")
        if not fn:
            return None
        path = os.path.join(parent_dir, fn)
        if not os.path.exists(path):
            import sys

            print(f"WARN: missing texture {path}; using placeholder", file=sys.stderr)
            return missing_texture()
        try:
            return load_bitmap(path)
        except Exception:
            return missing_texture()
    if ttype == "checkerboard":
        def color(name, default):
            for child in elem:
                if child.get("name") == name and child.tag in ("rgb", "spectrum", "color"):
                    parts = [float(x) for x in child.get("value").replace(",", " ").split()]
                    if len(parts) == 1:
                        parts *= 3
                    return tuple(parts[:3])
            return default

        def number(name, default):
            for child in elem:
                if child.get("name") == name and child.tag in ("float", "integer"):
                    return float(child.get("value"))
            return default

        return make_checkerboard(
            color("color0", (0.4, 0.4, 0.4)),
            color("color1", (0.2, 0.2, 0.2)),
            number("uscale", 1.0),
            number("vscale", 1.0),
        )
    return None
