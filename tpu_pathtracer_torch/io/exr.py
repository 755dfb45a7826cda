"""Dependency-free OpenEXR 2.x scanline reader/writer.

The reference loads golden EXRs through the vendored OpenEXR 2.2 C++ SDK
(reference: renderer/Renderer.mm:162-253, external/).  Here the subset of the
format those files use — scanline storage, NONE/ZIPS/ZIP compression, HALF/FLOAT
channels — is implemented directly on zlib + numpy, and the writer implements
the image *saving* the reference left as an empty stub
(reference: renderer/Renderer.mm:626-629, 659-662).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_RLE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _unpredict_deinterleave(raw: bytes) -> np.ndarray:
    """Undo EXR's zip preprocessing: byte delta predictor, then the
    two-half byte interleave."""
    t = np.frombuffer(raw, np.uint8).astype(np.int64)
    t[1:] -= 128  # d[i] stores t[i] - t[i-1] + 128 for i >= 1
    t = (np.cumsum(t, dtype=np.int64) % 256).astype(np.uint8)
    n = len(t)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out


def _predict_interleave(data: np.ndarray) -> bytes:
    n = len(data)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = data[0::2]
    t[half:] = data[1::2]
    d = t.astype(np.int32)
    d[1:] = d[1:] - d[:-1] + 128
    return (d % 256).astype(np.uint8).tobytes()


def read_exr(path: str) -> tuple[np.ndarray, list[str]]:
    """Read a scanline EXR.

    Returns (image, channel_names): image is (H, W, C) float32 with channels in
    R,G,B[,A] order when those names exist (alphabetical otherwise).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack("<I", data[4:8])[0]
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXRs not supported")
    if version & 0x800:
        raise ValueError(f"{path}: deep-data EXRs not supported")
    if version & 0x1000:
        # a multipart header would be silently misparsed (the second part's
        # header bytes would read as the offset table) — reject loudly
        raise ValueError(f"{path}: multipart EXRs not supported")

    off = 8
    channels: list[tuple[str, int]] = []
    compression = _COMP_NONE
    data_window = (0, 0, 0, 0)
    line_order = 0
    while True:
        end = data.index(b"\0", off)
        name = data[off:end].decode()
        off = end + 1
        if not name:
            break
        end = data.index(b"\0", off)
        attr_type = data[off:end].decode()
        off = end + 1
        size = struct.unpack("<i", data[off : off + 4])[0]
        off += 4
        val = data[off : off + size]
        off += size
        if attr_type == "chlist":
            p = 0
            while val[p] != 0:
                e = val.index(b"\0", p)
                cname = val[p:e].decode()
                p = e + 1
                ptype = struct.unpack("<i", val[p : p + 4])[0]
                xs, ys = struct.unpack("<2i", val[p + 8 : p + 16])
                if (xs, ys) != (1, 1):
                    # subsampled (luminance-chroma) layouts would decode to
                    # garbage under the full-width row math below
                    raise ValueError(
                        f"{path}: subsampled channel {cname!r} "
                        f"(sampling {xs}x{ys}) not supported")
                p += 16  # pixel type + pLinear/reserved + x/y sampling
                channels.append((cname, ptype))
        elif attr_type == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)
        elif attr_type == "lineOrder":
            line_order = val[0]

    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported compression {compression}")
    x_min, y_min, x_max, y_max = data_window
    width = x_max - x_min + 1
    height = y_max - y_min + 1
    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = -(-height // lines_per_block)

    # channels are stored per scanline in alphabetical order
    ch_sorted = sorted(channels)
    dtypes = {n: _PT_DTYPE[t] for n, t in channels}
    planes = {n: np.empty((height, width), dtypes[n]) for n, _ in channels}

    off += 8 * num_blocks  # skip the scanline offset table; chunks follow in order
    for _ in range(num_blocks):
        y, nbytes = struct.unpack("<ii", data[off : off + 8])
        off += 8
        chunk = data[off : off + nbytes]
        off += nbytes
        row0 = y - y_min
        nrows = min(lines_per_block, height - row0)
        raw_size = nrows * sum(
            width * np.dtype(dtypes[n]).itemsize for n, _ in channels
        )
        if compression in (_COMP_ZIP, _COMP_ZIPS) and nbytes < raw_size:
            raw = _unpredict_deinterleave(zlib.decompress(chunk)).tobytes()
        elif compression == _COMP_RLE and nbytes < raw_size:
            raw = _unpredict_deinterleave(_rle_decompress(chunk)).tobytes()
        else:
            raw = chunk
        p = 0
        for r in range(nrows):
            for cname, ptype in ch_sorted:
                nb = width * np.dtype(dtypes[cname]).itemsize
                planes[cname][row0 + r] = np.frombuffer(
                    raw[p : p + nb], dtypes[cname]
                )
                p += nb

    # note: no flip for DECREASING_Y files — each chunk header carries the
    # absolute y coordinate, so row0 = y - y_min already places rows correctly
    # for both line orders
    names = [n for n, _ in channels]
    preferred = [c for c in ("R", "G", "B", "A") if c in names]
    order = preferred + [n for n in sorted(names) if n not in preferred]
    img = np.stack([planes[n].astype(np.float32) for n in order], axis=-1)
    return img, order


def _rle_decompress(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        count = struct.unpack("<b", data[i : i + 1])[0]
        i += 1
        if count < 0:
            out += data[i : i - count]
            i += -count
        else:
            out += data[i : i + 1] * (count + 1)
            i += 1
    return bytes(out)


def write_exr(
    path: str,
    image: np.ndarray,
    channel_names: tuple = ("R", "G", "B"),
    half: bool = True,
    compress: bool = True,
) -> None:
    """Write an (H, W, C) array as a scanline EXR (ZIP or NONE compression)."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    height, width, nchan = image.shape
    if nchan != len(channel_names):
        raise ValueError("channel count mismatch")
    dtype = np.float16 if half else np.float32
    ptype = _PT_HALF if half else _PT_FLOAT
    compression = _COMP_ZIP if compress else _COMP_NONE
    lines_per_block = _LINES_PER_BLOCK[compression]

    def attr(name: str, attr_type: str, value: bytes) -> bytes:
        return (
            name.encode() + b"\0" + attr_type.encode() + b"\0"
            + struct.pack("<i", len(value)) + value
        )

    chlist = b""
    for cname, _ in sorted(zip(channel_names, range(nchan))):
        chlist += (
            cname.encode() + b"\0" + struct.pack("<i", ptype)
            + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
        )
    chlist += b"\0"
    box = struct.pack("<4i", 0, 0, width - 1, height - 1)

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([compression]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    order = sorted(range(nchan), key=lambda i: channel_names[i])
    pix = image.astype(dtype)
    chunks = []
    for row0 in range(0, height, lines_per_block):
        nrows = min(lines_per_block, height - row0)
        raw = b"".join(
            pix[row0 + r, :, c].tobytes() for r in range(nrows) for c in order
        )
        if compression == _COMP_ZIP:
            packed = zlib.compress(
                _predict_interleave(np.frombuffer(raw, np.uint8)), 6
            )
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        chunks.append((row0, packed))

    preamble = _MAGIC + struct.pack("<I", 2)
    table_offset = len(preamble) + len(header)
    data_offset = table_offset + 8 * len(chunks)
    offsets = []
    pos = data_offset
    for row0, packed in chunks:
        offsets.append(pos)
        pos += 8 + len(packed)

    with open(path, "wb") as fh:
        fh.write(preamble)
        fh.write(header)
        fh.write(struct.pack(f"<{len(offsets)}Q", *offsets))
        for (row0, packed), _ in zip(chunks, offsets):
            fh.write(struct.pack("<ii", row0, len(packed)))
            fh.write(packed)
