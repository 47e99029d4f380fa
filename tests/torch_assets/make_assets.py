"""The reader fixtures of tests/test_torch_jpeg.py, tests/test_torch_exr.py
and chip_smoke.py's `readers` phase, and the means to remake them:

    python tests/torch_assets/make_assets.py

writes, next to this file, with OpenCV and numpy only:
  frame_q95_420.jpg, frame_q90_444.jpg
      two 1280x1024 procedural frames (Matterport3D's colour size), written
      by cv2.imwrite at quality 95 with 4:2:0 sampling and at quality 90
      with 4:4:4
  restart_420.jpg    a 61x47 frame with a restart interval of 2 MCUs
  progressive.jpg    a 48x64 progressive frame, which the port refuses
  *.exr              small scanline OpenEXR files from `write_exr`, this
                     module's own writer of the OpenEXR layout (OpenCV here
                     has no EXR codec)
  manifest.json      for each JPEG the SHA-256 of cv2.imread's decode in RGB
                     order (the bytes of a [H, W, 3] uint8 array), for each
                     EXR the SHA-256, dtype and shape of the array that
                     cv2.imread(path, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)
                     returns for it (the values written; BGR order)
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEGS = {  # name: (seed, height, width, quality, sampling, restart interval, progressive)
    "frame_q95_420.jpg": (0, 1024, 1280, 95, "420", 0, False),
    "frame_q90_444.jpg": (1, 1024, 1280, 90, "444", 0, False),
    "restart_420.jpg": (2, 47, 61, 85, "420", 2, False),
    "progressive.jpg": (3, 48, 64, 85, "420", 0, True),
}
# name: (channels {name: pixel type}, compression, height, width, data
# window origin (x, y))
EXRS = {
    "disp_half_zip.exr": ({"Y": 1}, 3, 37, 21, (3, -2)),
    "rgb_float_zips.exr": ({"B": 2, "G": 2, "R": 2}, 2, 9, 13, (0, 0)),
    "y_uint_none.exr": ({"Y": 0}, 0, 5, 8, (0, 0)),
}
PIXEL = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
LINES = {0: 1, 2: 1, 3: 16}   # scanlines per chunk of each compression


def frame(seed: int, h: int, w: int) -> np.ndarray:
    """A procedural BGR uint8 frame: sine gratings, a square wave and
    smooth blobs, which compress about as much as a photograph."""
    import cv2

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        a, b, p = rng.uniform(8, 60, 3)
        img[..., c] = (128 + 70 * np.sin(xx / a + c) * np.cos(yy / b - p)
                       + 40 * np.sign(np.sin((xx + 2 * yy) / (a + b))))
    blobs = rng.normal(0, 1, (max(h // 8, 2), max(w // 8, 2), 3))
    img += 10 * cv2.resize(blobs, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_jpeg(path, seed, h, w, quality, sampling, restart, progressive):
    import cv2

    factor = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
              "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
              "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}[sampling]
    ok = cv2.imwrite(path, frame(seed, h, w), [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok, path


def with_exif(data: bytes, orientation: int, big_endian: bool = False) -> bytes:
    """JPEG bytes `data` with an APP1 Exif segment, whose IFD0 holds only
    the orientation tag, right after SOI."""
    e = ">" if big_endian else "<"
    tiff = ((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHI", 0x0112, 3, 1) + struct.pack(e + "H", orientation)
            + b"\0\0" + struct.pack(e + "I", 0))
    payload = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:]


def _zip_predict(raw: bytes) -> bytes:
    """The ZIP compressor's forward transform (OpenEXR's ImfZip.cpp):
    even bytes to the first half, odd to the second, then each byte
    replaced by its difference from the one before plus 128."""
    a = np.frombuffer(raw, np.uint8)
    t = np.concatenate([a[0::2], a[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def write_exr(path, channels: dict, compression: int, origin=(0, 0),
              version_flags=0):
    """A scanline OpenEXR file: `channels` {name: [H, W] array of uint32,
    float16 or float32}, compression 0 (NONE), 2 (ZIPS) or 3 (ZIP), the
    data window starting at `origin` (x, y).  A chunk is stored raw where
    compressing it would not make it smaller, as OpenEXR does.  Another
    compression id, or `version_flags` (tiled 0x200, deep 0x800, multi-part
    0x1000), only labels the file, for tests of what a reader refuses."""
    names = sorted(channels)
    ptype = {n: {np.dtype("uint32"): 0, np.dtype("float16"): 1,
                 np.dtype("float32"): 2}[np.asarray(channels[n]).dtype]
             for n in names}
    h, w = np.asarray(channels[names[0]]).shape
    x0, y0 = origin

    def attr(name, kind, value):
        return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(value)) + value

    chlist = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", ptype[n], 0, 1, 1)
                      for n in names) + b"\0"
    box = struct.pack("<4i", x0, y0, x0 + w - 1, y0 + h - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<i", 2 | version_flags)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([compression]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    lines = LINES.get(compression, 1)
    chunks = []
    for y in range(0, h, lines):
        rows = range(y, min(y + lines, h))
        raw = b"".join(np.ascontiguousarray(channels[n][r], PIXEL[ptype[n]]).tobytes()
                       for r in rows for n in names)
        if compression in (2, 3):
            packed = zlib.compress(_zip_predict(raw), 9)
            raw = packed if len(packed) < len(raw) else raw
        chunks.append(struct.pack("<ii", y0 + y, len(raw)) + raw)
    offset = len(header) + 8 * len(chunks)
    table = b""
    for c in chunks:
        table += struct.pack("<Q", offset)
        offset += len(c)
    with open(path, "wb") as f:
        f.write(header + table + b"".join(chunks))


def exr_channels(seed, kinds: dict, h, w) -> dict:
    """Channel arrays of the given pixel types from `seed`."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in kinds.items():
        if t == 0:
            out[name] = rng.integers(0, 2**32, (h, w), dtype=np.uint64).astype(np.uint32)
        else:
            v = rng.uniform(-40, 300, (h, w))
            out[name] = v.astype(np.float16 if t == 1 else np.float32)
    return out


def expected_exr(channels: dict) -> np.ndarray:
    """What OpenCV returns for a file of these channels: Y alone as [H, W],
    else B, G, R stacked; float32, or int32 when every channel is UINT."""
    read = [c for c in ("B", "G", "R") if c in channels] or ["Y"]
    arrays = [np.asarray(channels[c]) for c in read]
    if all(a.dtype == np.uint32 for a in arrays):
        arrays = [a.view(np.int32) for a in arrays]
    else:
        arrays = [a.astype(np.float32) for a in arrays]
    return arrays[0] if len(arrays) == 1 else np.stack(arrays, axis=-1)


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def make(out_dir: str = HERE) -> dict:
    """Write every fixture and manifest.json into out_dir; return the
    manifest."""
    import cv2

    manifest = {"jpeg": {}, "exr": {}}
    for name, spec in JPEGS.items():
        path = os.path.join(out_dir, name)
        write_jpeg(path, *spec)
        rgb = cv2.imread(path)[..., ::-1]
        manifest["jpeg"][name] = {"shape": list(rgb.shape), "sha256": sha256(rgb),
                                  "progressive": spec[-1]}
    for seed, (name, (kinds, compression, h, w, origin)) in enumerate(EXRS.items()):
        chans = exr_channels(seed, kinds, h, w)
        write_exr(os.path.join(out_dir, name), chans, compression, origin)
        want = expected_exr(chans)
        manifest["exr"][name] = {"shape": list(want.shape), "dtype": str(want.dtype),
                                 "sha256": sha256(want)}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    make()
