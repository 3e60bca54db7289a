"""IO tests: image formats roundtrip, checkpoint save/resume exactness."""

import numpy as np

from gpuspectral_tpu.io import (
    gamma_correct,
    read_pfm,
    tonemap_aces,
    write_exr,
    write_pfm,
    write_png,
)
from gpuspectral_tpu.io.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint


def test_pfm_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(0, 10, (7, 5, 3)).astype(np.float32)
    p = str(tmp_path / "x.pfm")
    write_pfm(p, img)
    np.testing.assert_allclose(read_pfm(p), img)


def test_png_roundtrip_stdlib(tmp_path):
    """write_png needs only zlib + struct; decode its chunks the same way
    and compare every pixel with the expected 8-bit values."""
    import struct
    import zlib

    img = np.random.default_rng(1).uniform(0, 1.5, (9, 13, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    write_png(str(p), img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 4:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(body), tag
        chunks[tag] = chunks.get(tag, b"") + body[4:]
        pos += 12 + n
    assert struct.unpack(">IIBBBBB", chunks[b"IHDR"]) == (13, 9, 8, 2, 0, 0, 0)
    assert chunks[b"IEND"] == b""
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(9, 1 + 13 * 3)
    assert (rows[:, 0] == 0).all()  # filter type 0 on every scanline
    expected = (gamma_correct(np.clip(img, 0.0, 1.0)) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(rows[:, 1:].reshape(9, 13, 3), expected)


def test_png_writes(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).uniform(0, 2, (16, 16, 3)).astype(np.float32)
    p = str(tmp_path / "x.png")
    write_png(p, img, tonemap=True)
    out = np.asarray(Image.open(p))
    assert out.shape == (16, 16, 3)


def test_exr_roundtrip_uncompressed_and_zip(tmp_path):
    img = np.random.default_rng(1).uniform(0, 30, (33, 17, 3)).astype(np.float32)
    for compress in (False, True):
        p = str(tmp_path / f"x{compress}.exr")
        write_exr(p, img, compress=compress)
        got = _read_exr_float_rgb(p)
        np.testing.assert_allclose(got, img, rtol=1e-6)


def _read_exr_float_rgb(path):
    """Independent minimal EXR reader used only to validate the writer."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    pos = 8
    attrs = {}
    while True:
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode()
        pos = end + 1
        if not name:
            break
        end = data.index(b"\x00", pos)
        pos = end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = data[pos : pos + size]
        pos += size
    comp = attrs["compression"][0]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    w, h = x1 + 1, y1 + 1
    lines_per_block = 16 if comp else 1
    n_blocks = -(-h // lines_per_block)
    offsets = struct.unpack_from("<%dQ" % n_blocks, data, pos)
    img = np.zeros((h, w, 3), np.float32)
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        payload = data[off + 8 : off + 8 + size]
        lines = min(lines_per_block, h - y)
        raw_len = lines * w * 3 * 4
        if size != raw_len:
            inter = np.frombuffer(zlib.decompress(payload), np.uint8)
            half = (len(inter) + 1) // 2
            d = np.empty_like(inter)
            d[0::2] = inter[:half]
            d[1::2] = inter[half:]
            dd = d.astype(np.int32)
            s = (np.cumsum(np.concatenate([[int(d[0])], dd[1:] - 128])) % 256).astype(np.uint8)
            raw = s.tobytes()
        else:
            raw = payload
        arr = np.frombuffer(raw, "<f4").reshape(lines, 3, w)
        img[y : y + lines, :, 0] = arr[:, 2]
        img[y : y + lines, :, 1] = arr[:, 1]
        img[y : y + lines, :, 2] = arr[:, 0]
    return img


def test_tonemap_monotone():
    x = np.linspace(0, 5, 100)
    y = tonemap_aces(x)
    assert (np.diff(y) >= -1e-6).all()
    assert y.max() <= 1.0 and y.min() >= 0.0
    g = gamma_correct(np.asarray([0.25]))
    np.testing.assert_allclose(g, 0.25 ** (1 / 2.2))


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "accum": np.random.default_rng(0).normal(size=(8, 8, 3)).astype(np.float32),
        "timestamp": np.uint32(42),
        "params": np.ones((3, 12), np.float32),
    }
    p = str(tmp_path / "ck" / "ckpt_000042.npz")
    save_checkpoint(p, state)
    got = load_checkpoint(p)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    assert latest_checkpoint(str(tmp_path / "ck")) == p


def test_progressive_resume_exact(cornell_scene):
    """Interrupt + resume the progressive accumulation: bitwise-identical to
    an uninterrupted run (running mean + counter-based RNG are stateless)."""
    import jax.numpy as jnp

    from gpuspectral_tpu.integrator.path_tracer import render_step
    from gpuspectral_tpu.utils import RenderConfig

    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2, ray_batch=64)
    accum = jnp.zeros((8, 8, 3))
    for t in range(4):
        accum = render_step(cornell_scene, cfg, accum, jnp.uint32(t))
    # interrupted at t=2, resumed from checkpoint
    accum2 = jnp.zeros((8, 8, 3))
    for t in range(2):
        accum2 = render_step(cornell_scene, cfg, accum2, jnp.uint32(t))
    state = {"accum": np.asarray(accum2), "timestamp": np.uint32(2)}
    restored = jnp.asarray(state["accum"])
    for t in range(int(state["timestamp"]), 4):
        restored = render_step(cornell_scene, cfg, restored, jnp.uint32(t))
    np.testing.assert_array_equal(np.asarray(restored), np.asarray(accum))
