"""Image output/input.

The reference never writes images at all — its only output path is the
swapchain blit (renderer/PathTracer.cpp:41-55); screenshots were captured
externally (SURVEY.md §5.4).  A headless renderer needs real files:

  * PNG  (tonemapped LDR, written with zlib + struct),
  * PFM  (the reference parses PFM for envmaps, engine/Loader.cpp:236-251),
  * EXR  minimal OpenEXR writer (float32/half, uncompressed or ZIP) so
    outputs can be compared against the Tungsten ground-truth EXRs.

Tonemap: ACES filmic curve, spec from assets/shaders/common.glsl:64-82
(present in the reference but dormant — its toneMap flag is never set).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap_aces(x: np.ndarray) -> np.ndarray:
    """ACES filmic fit (common.glsl:64-71: a=2.51 b=0.03 c=2.43 d=0.59 e=0.14)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = np.asarray(x, np.float32)
    return np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def gamma_correct(x: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    return np.clip(np.asarray(x, np.float32), 0.0, 1.0) ** (1.0 / gamma)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path: str, img: np.ndarray, tonemap: bool = False, gamma: float = 2.2) -> None:
    """img: (H,W,3) float radiance. Applies ACES (optional) then gamma and
    writes an 8-bit RGB PNG (zlib-compressed scanlines, filter type 0)."""
    x = np.asarray(img, np.float32)
    x = tonemap_aces(x) if tonemap else np.clip(x, 0.0, 1.0)
    x = gamma_correct(x, gamma)
    rgb = (x * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    # IHDR: width, height, bit depth 8, colour type 2 (RGB), deflate,
    # adaptive filtering, no interlace
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_pfm(path: str, img: np.ndarray) -> None:
    """Binary PF (color) PFM, bottom-up scanlines, little-endian."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # negative scale = little endian
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Reads binary or (like the reference, Loader.cpp:236-251) ASCII PFM."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        count = w * h * (3 if header == b"PF" else 1)
        data = np.frombuffer(f.read(count * 4), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, -1)
    return np.flipud(img).copy()


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data


def write_exr(path: str, img: np.ndarray, compress: bool = True) -> None:
    """Minimal scanline OpenEXR 2.0 writer: float32 RGB, ZIP or none."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    channels = b""
    for name in (b"B", b"G", b"R"):
        # name, pixel type (2=float), pLinear+reserved, xSampling, ySampling
        channels += name + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    channels += b"\x00"

    comp = 3 if compress else 0  # 3 = ZIP (16-line blocks), 0 = none
    lines_per_block = 16 if compress else 1

    header = b""
    header += _exr_attr(b"channels", b"chlist", channels)
    header += _exr_attr(b"compression", b"compression", struct.pack("<B", comp))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0, 0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    n_blocks = -(-h // lines_per_block)
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        rows = img[y0 : y0 + lines_per_block]
        raw = b""
        for row in rows:
            # channel order B, G, R within each scanline
            raw += row[:, 2].astype("<f4").tobytes()
            raw += row[:, 1].astype("<f4").tobytes()
            raw += row[:, 0].astype("<f4").tobytes()
        if compress:
            # EXR ZIP predictor: delta-encode then interleave-split
            arr = np.frombuffer(raw, np.uint8).astype(np.int16)
            d = np.empty_like(arr)
            d[0] = arr[0]
            d[1:] = ((arr[1:] - arr[:-1]) + 128) & 0xFF
            d = d.astype(np.uint8)
            half = (len(d) + 1) // 2
            inter = np.empty_like(d)
            inter[:half] = d[0::2]
            inter[half:] = d[1::2]
            packed = zlib.compress(inter.tobytes())
            data = packed if len(packed) < len(raw) else raw
        else:
            data = raw
        blocks.append((y0, data))

    magic = struct.pack("<I", 20000630)
    version = struct.pack("<I", 2)
    offset_table_size = 8 * n_blocks
    data_start = len(magic) + len(version) + len(header) + offset_table_size
    offsets, pos = [], data_start
    for y0, data in blocks:
        offsets.append(pos)
        pos += 4 + 4 + len(data)  # y coord + size + payload

    with open(path, "wb") as f:
        f.write(magic + version + header)
        for off in offsets:
            f.write(struct.pack("<Q", off))
        for y0, data in blocks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)
