"""Minimal dependency-free PNG writer (8-bit RGB, zlib-compressed) and
reader: a copy of ``tpu_pathtracer/io/png.py``; the writer is byte-equal to
the reference's."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def png_bytes(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3) array (values in [0, 1]) as 8-bit RGB PNG bytes."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    if image.shape[-1] > 3:
        image = image[..., :3]
    data = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    height, width = data.shape[:2]

    raw = b"".join(b"\0" + data[r].tobytes() for r in range(height))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload))
        )

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) array (values in [0, 1]) as an 8-bit RGB PNG."""
    with open(path, "wb") as fh:
        fh.write(png_bytes(image))


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG (gray/RGB/RGBA, all filter types)
    to an (H, W, 3) float32 array in [0, 1] (sRGB-decoded to linear).

    Texture loading for map_Kd (the reference has no texture sampling at all;
    this is the config-4 extension's asset path).  Dependency-free like the
    writer above.
    """
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    width = height = None
    bit_depth = color_type = interlace = None
    idat = []
    palette = None
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = (
                struct.unpack(">IIBBBBB", payload)
            )
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")
    if bit_depth != 8 or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced PNGs supported "
            f"(depth {bit_depth}, interlace {interlace})"
        )
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color_type)
    if channels is None:
        raise ValueError(f"{path}: unsupported color type {color_type}")
    raw = zlib.decompress(b"".join(idat))
    stride = width * channels
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    p = 0
    for r in range(height):
        ftype = raw[p]
        line = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8)
        p += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up: fully vectorized
            cur = line + prev  # uint8 wraps mod 256, as PNG specifies
        elif ftype == 1:  # Sub: per-channel prefix sum mod 256
            cur = np.empty(stride, np.uint8)
            for c in range(channels):
                cur[c::channels] = np.cumsum(
                    line[c::channels], dtype=np.uint64
                ).astype(np.uint8)
        elif ftype in (3, 4):
            # Average/Paeth have a left-neighbor recurrence: run it over a
            # bytearray (C-speed element access; ~20x the numpy-scalar loop)
            cur_b = bytearray(line.tobytes())
            prev_b = prev.tobytes()
            ch = channels
            if ftype == 3:
                for i in range(stride):
                    a = cur_b[i - ch] if i >= ch else 0
                    cur_b[i] = (cur_b[i] + ((a + prev_b[i]) >> 1)) & 0xFF
            else:
                for i in range(stride):
                    a = cur_b[i - ch] if i >= ch else 0
                    b = prev_b[i]
                    c = prev_b[i - ch] if i >= ch else 0
                    pa = abs(b - c)
                    pb = abs(a - c)
                    pc = abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else \
                        (b if pb <= pc else c)
                    cur_b[i] = (cur_b[i] + pred) & 0xFF
            cur = np.frombuffer(cur_b, np.uint8)  # cur_b is never reused
        else:
            raise ValueError(f"{path}: bad filter {ftype}")
        out[r] = cur
        prev = cur
    img = out.reshape(height, width, channels)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{path}: paletted PNG without PLTE")
        img = palette[img[..., 0]]
    elif channels == 1:
        img = np.repeat(img, 3, axis=-1)
    elif channels == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    elif channels == 4:
        img = img[..., :3]
    srgb = img.astype(np.float32) / 255.0
    # sRGB EOTF -> linear (textures are authored in sRGB)
    return np.where(
        srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
    ).astype(np.float32)
