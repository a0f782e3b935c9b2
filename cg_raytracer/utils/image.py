"""Image output / input.

Reference capability: ``Screen`` (``screen.cpp:13-92``): clamp to [0,1], 8-bit
quantize, BMP write via stb (screen.cpp:38-49).  The y-flip the reference applies
in ``setPixel`` (screen.cpp:30-36) is already baked into our ray generation
(image-row order), so buffers here are written as-is.  PNG is the default
container; BMP is kept for byte-level parity workflows.  Reading supports loading
target images for the inverse-rendering loop (the reference's ``Image`` texture
loader, src/image.cpp, is a stub that never affects renders — SURVEY §0).

Both formats are written and read with numpy and ``zlib`` alone: 8-bit RGB/RGBA
non-interlaced PNG, and 24-bit uncompressed BMP.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_u8(img) -> np.ndarray:
    """Clamp to [0,1] and quantize to u8 — parity with screen.cpp:41-44
    (``u8vec4(vec4(clamp(color)) * 255.0f)``: truncation, not rounding)."""
    arr = np.asarray(img, np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """Write an [H, W, 3] float image as an 8-bit RGB PNG."""
    px = to_u8(img)
    h, w, _ = px.shape
    # Filter type 0 (none) on every scanline.
    raw = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, w * 3)],
                         axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def write_bmp(path: str, img) -> None:
    """Write an [H, W, 3] float image as a 24-bit uncompressed BMP."""
    px = to_u8(img)
    h, w, _ = px.shape
    row = w * 3
    pad = (-row) % 4
    # Bottom-up rows of BGR triples, each padded to a multiple of 4 bytes.
    body = np.zeros((h, row + pad), np.uint8)
    body[:, :row] = px[::-1, :, ::-1].reshape(h, row)
    size = 54 + body.size
    header = (b"BM" + struct.pack("<IHHI", size, 0, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, body.size,
                            2835, 2835, 0, 0))
    with open(path, "wb") as f:
        f.write(header + body.tobytes())


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-scanline filters (types 0-4)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = int(data[pos])
        line = data[pos + 1:pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:
            # Running sum along each channel, modulo 256.
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 3:
            cur = line.copy()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png_u8(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA non-interlaced PNG as u8 [H, W, 3]."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    idat = []
    header = None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit RGB/RGBA non-interlaced PNG is supported "
            f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)
    return px[..., :3]


def read_bmp_u8(path: str) -> np.ndarray:
    """Read a 24-bit uncompressed BMP (what ``write_bmp`` writes) as u8
    [H, W, 3]."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] != b"BM":
        raise ValueError(f"{path} is not a BMP file")
    (offset,) = struct.unpack("<I", blob[10:14])
    _, w, h, _, bpp, compression = struct.unpack("<IiiHHI", blob[14:34])
    if bpp != 24 or compression != 0:
        raise ValueError(f"{path}: only 24-bit uncompressed BMP is supported")
    rows = abs(h)
    stride = (w * 3 + 3) // 4 * 4
    body = np.frombuffer(blob, np.uint8, rows * stride, offset)
    px = body.reshape(rows, stride)[:, :w * 3].reshape(rows, w, 3)[..., ::-1]
    return px[::-1] if h > 0 else px  # positive height: bottom-up rows


def read_image(path: str) -> np.ndarray:
    """Load a PNG or BMP as float32 [H, W, 3] in [0, 1]."""
    with open(path, "rb") as f:
        magic = f.read(2)
    px = read_bmp_u8(path) if magic == b"BM" else read_png_u8(path)
    return px.astype(np.float32) / 255.0
