"""Image I/O with nothing but zlib and numpy (the port of
`aadff_tpu/utils/image.py`, which needs OpenCV): PNG read and write, PFM
read, the JET colour map and the bilinear resize of `cv2.resize`.

Colour images are in RGB order throughout (OpenCV's are BGR).  PNG:
  * `read_png` decodes non-interlaced 8- and 16-bit grey, grey+alpha, RGB
    and RGBA (16-bit samples are big-endian in the file), undoing all five
    row filters (OpenCV's writer picks them row by row); palette images,
    bit depths below 8 and interlaced files raise;
  * `write_png` writes 8- or 16-bit grey or RGB, every row with the Sub
    filter, as OpenCV's writer does by default.
PFM follows the format read by the reference `pfmreader.py:1-64`.
"""
from __future__ import annotations

import re
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples a pixel

# cv2.COLORMAP_JET as RGB triples for levels 0..255 (OpenCV's table, which is
# not matplotlib's jet), written out so that no OpenCV is needed.
_JET_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000")
JET = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3)


# ================================
# PNG
# ================================
def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + payload) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG has no IEND chunk")


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: rows [H, 1 + W * bpp] (each row's filter
    type, then its filtered bytes) -> the image's bytes [H, W, bpp].

    Each byte depends on its left neighbour, the one above and the one
    above-left (filters Sub, Up, Average, Paeth), so the bytes are decoded
    one anti-diagonal of pixels at a time, each diagonal in one vector
    operation: H + W - 1 steps in all.  In the skewed layout K[D, R] of
    pixel (r, x), with D = r + x + 2 and R = r + 1, diagonal D reads
    diagonals D - 1 and D - 2; row R = 0 and the pixels at x < 0 stay 0,
    which is what the filters read outside the image.
    """
    H = rows.shape[0]
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    W = (rows.shape[1] - 1) // bpp
    data = rows[:, 1:].reshape(H, W, bpp).astype(np.int16)
    if (ftype == 0).all():
        return data.astype(np.uint8)
    d_idx = np.arange(H)[:, None] + np.arange(W)[None, :] + 2
    r_idx = np.broadcast_to(np.arange(H)[:, None] + 1, (H, W))
    filtered = np.zeros((H + W + 1, H + 1, bpp), np.int16)
    filtered[d_idx, r_idx] = data
    out = np.zeros_like(filtered)
    t = ftype[:, None]
    sub, up, avg, paeth = t == 1, t == 2, t == 3, t == 4
    any_avg, any_paeth = avg.any(), paeth.any()
    for d in range(2, H + W + 1):
        a, b, c = out[d - 1, 1:], out[d - 1, :-1], out[d - 2, :-1]
        pred = np.where(sub, a, np.where(up, b, 0))
        if any_avg:
            pred = np.where(avg, (a + b) >> 1, pred)
        if any_paeth:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = np.where(paeth, pth, pred)
        out[d, 1:] = (filtered[d, 1:] + pred) & 0xFF
    return out[d_idx, r_idx].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file as it is stored: [H, W] for grey, [H, W, C] for
    grey+alpha, RGB and RGBA; uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        if data.startswith(b"\xff\xd8"):
            raise NotImplementedError(
                f"{path}: JPEG decoding is not available in the port (it "
                f"reads PNG with zlib and numpy only)")
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: unsupported PNG colour type {color} at "
                         f"bit depth {depth} (palette and < 8 bits are not "
                         f"read)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, "
                         f"expected {H * (1 + W * bpp)}")
    img = _unfilter(raw.reshape(H, 1 + W * bpp), bpp)
    if depth == 16:
        img = img.reshape(H, W * bpp).view(">u2").astype(np.uint16)
    img = img.reshape(H, W, channels)
    return img[..., 0] if channels == 1 else img


def write_png(path: str, img: np.ndarray):
    """Write an image [H, W] (grey) or [H, W, 3] (RGB), uint8 or uint16, as
    a PNG with the Sub filter on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        color, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, channels = 2, 3
    else:
        raise ValueError(f"PNG image must be [H, W] or [H, W, 3], got {img.shape}")
    H, W = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    samples = img.astype(">u2") if depth == 16 else img
    rows = samples.reshape(H, W * channels).view(np.uint8)
    bpp = channels * depth // 8
    sub = rows.copy()  # the Sub filter (1): each byte less its left neighbour's
    sub[:, bpp:] -= rows[:, :-bpp]
    raw = np.concatenate([np.ones((H, 1), np.uint8), sub], axis=1)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def imread_color(path: str) -> np.ndarray:
    """An image as 8-bit RGB [H, W, 3], as `cv2.imread(path)` reads it (in
    RGB order): grey is repeated, alpha dropped, 16-bit samples keep their
    high byte."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.shape[2] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imread_rgb(path, resize=None):
    """Read an RGB image as float32 [H, W, 3] in [0, 1]."""
    img = imread_color(path).astype(np.float32) / 255.0
    if resize is not None:
        img = resize_hw(img, resize)
    return img


def imread_depth_png(path, scale=1000.0, resize=None):
    """Read a 16-bit depth PNG, divide by `scale` (e.g. Middlebury /1000 -> m)."""
    depth = read_png(path).astype(np.float32) / scale
    if resize is not None:
        depth = resize_hw(depth, resize)
    return depth


def imwrite_colormap(path, depth, vmax=None):
    """Save a depth map as a JET colormap PNG (reference validate(),
    2_aber_aware_dff_aif.py:216-219)."""
    depth = np.asarray(depth, np.float64)
    vmax = depth.max() if vmax is None else vmax
    img = np.clip(depth / (vmax + 1e-12) * 255.0, 0, 255).astype(np.uint8)
    write_png(path, JET[img])


# ================================
# Resize
# ================================
def _linear_taps(src: int, dst: int):
    """Source indices and weights of cv2's INTER_LINEAR along one axis:
    half-pixel centres, the border replicated."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    f[(i0 < 0) | (i0 >= src - 1)] = 0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), 1 - f, f


def resize_hw(img: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)` for a
    float32 or float64 image [H, W] or [H, W, C], with size = (H, W) as the
    reference's transforms.Resize takes it.  No antialiasing: a downscale
    reads the two nearest source pixels along each axis.  The sums run in
    float64 and are rounded to the image's dtype."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise ValueError(f"resize_hw takes float32 or float64, got {img.dtype}")
    H, W = img.shape[:2]
    h, w = int(size[0]), int(size[1])
    if (h, w) == (H, W):
        return img.copy()
    cshape = (1,) * (img.ndim - 2)
    x0, x1, ax0, ax1 = _linear_taps(W, w)
    y0, y1, by0, by1 = _linear_taps(H, h)
    src = img.astype(np.float64)
    rows = (src[:, x0] * ax0.reshape(1, w, *cshape)
            + src[:, x1] * ax1.reshape(1, w, *cshape))
    out = (rows[y0] * by0.reshape(h, 1, *cshape)
           + rows[y1] * by1.reshape(h, 1, *cshape))
    return out.astype(img.dtype)


# ================================
# PFM
# ================================
def read_pfm(path):
    """Read a PFM file -> (data [H, W] or [H, W, 3] float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_line = f.readline()
        while dim_line.startswith(b"#"):
            dim_line = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dim_line)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.reshape(data, shape)
    return np.flipud(data).astype(np.float32), abs(scale)


def read_and_clean_pfm(path, clip_percentile=99.0):
    """PFM read + inf/outlier cleanup (reference pfmreader.py:66-88 intent)."""
    data, scale = read_pfm(path)
    finite = np.isfinite(data)
    if not finite.all():
        fill = np.percentile(data[finite], clip_percentile)
        data = np.where(finite, data, fill)
    return data, scale
