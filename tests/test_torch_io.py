"""The port's readers and writers against the JAX package and OpenCV: the
YAML-subset config reader (against `aadff_tpu.utils.config.load_config`,
types included), PNG read and write (against cv2, bit for bit), the JET
colour map (byte for byte), the bilinear resize (against cv2.resize), PFM
(as tests/test_dff.py:141) and the logging helpers.

Resize tolerance: within 1e-6 of cv2 in float64 (values to 20) and in
float32 on [0, 1] images (what the datasets resize: AiF images in float32,
Middlebury depth in float64).  Float32 maps with values to 20 are held at
2e-6, one float32 step below 32: OpenCV rounds its float32 sums in float32,
the port rounds float64 sums once.
"""
import glob
import logging
import os
import random

import cv2
import numpy as np
import pytest

from aadff_tpu.utils import image as jax_image
from aadff_tpu.utils.config import load_config as jax_load_config
from aadff_tpu_torch.utils import image
from aadff_tpu_torch.utils import logging as port_logging
from aadff_tpu_torch.utils.config import load_config, loads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))

EDGE_CASES = """\
# a comment line
top: plain string  # trailing comment
hash_inside: a#b
quoted_hash: 'x # not a comment'
dq: "tab\\tand \\"quote\\""
sq: 'it''s'
empty: ''
nothing:
tilde: ~
int: 20
neg: -3
hex: 0x1F
octal: 017
binary: 0b101
sexagesimal: 1:30
under: 1_000
float: 1.5e-3
float_plain: 2.
dot_float: .5
inf: -.inf
lr: 1e-4
big_e: 1E+5
bools: [True, false, yes, No, on, OFF]
nested:
  a: 1
  deeper:
    b: 'two'
    c: [1, 2.5, x]
  d: null
tuple: !!python/tuple [480, 640]
floats: !!python/tuple [25.968, 34.624]
empty_list: []
path: './lenses/rf50mm.json'
url_like: http://x/y
"""


def _same(a, b):
    """Equal values of the same types, recursively."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_matches_jax_loader(path):
    ours = load_config(path)
    _same(ours, jax_load_config(path))
    assert ours["lr"] == "1e-4" and ours["res"] == (480, 640)


def test_config_edge_cases_match_jax_loader(tmp_path):
    p = tmp_path / "edge.yml"
    p.write_text(EDGE_CASES)
    ours = load_config(str(p))
    _same(ours, jax_load_config(str(p)))
    assert ours["lr"] == "1e-4" and ours["float"] == 1.5e-3
    assert ours["nested"]["deeper"]["c"] == [1, 2.5, "x"]


@pytest.mark.parametrize("text,line", [
    ("a: 1\n- b\n", 2),
    ("a: 1\nb: {c: 1}\n", 2),
    ("a: &anchor 1\n", 1),
    ("a: !!str 1\n", 1),
    ("a: 2001-12-14\n", 1),
    ("a:\n  b: 1\n c: 2\n", 3),
    ("a: 'open\n", 1),
    ("a: b: c\n", 1),
    ("---\na: 1\n", 1),
])
def test_config_outside_the_subset_raises_with_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        loads(text)


def _scenes(rng, h, w):
    """A random image and a smooth one (which makes the encoder pick
    Sub/Up/Average/Paeth filters)."""
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([xx * 3, yy * 5, xx + yy], -1) % 256
    return {"random": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "smooth": smooth.astype(np.uint8)}


def _filters_used(path):
    """The set of PNG row filter types in a file (for the test's own check
    that cv2 wrote more than filter 0)."""
    import struct
    import zlib
    data = open(path, "rb").read()
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, t = struct.unpack(">I4s", data[pos:pos + 8])
        if t == b"IHDR":
            ihdr = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if t == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = ihdr
    bpp = {0: 1, 2: 3}[color] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * bpp)
    return set(raw[:, 0].tolist())


# cv2's default writer picks the Sub filter; these flags make it write each
# of the five filters, and all of them chosen row by row
PNG_FILTERS = {"default": [],
               **{f: [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{f}")]
                  for f in ("NONE", "SUB", "UP", "AVG", "PAETH")},
               "adaptive": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]}


@pytest.mark.parametrize("h,w", [(480, 640), (37, 53), (1, 1), (2, 7)])
def test_png_reads_cv2_files_bit_identically(tmp_path, h, w):
    rng = np.random.default_rng(h * 1000 + w)
    filters = set()
    path = str(tmp_path / "x.png")
    for params in PNG_FILTERS.values():
        for rgb in _scenes(rng, h, w).values():
            cv2.imwrite(path, rgb[..., ::-1], params)
            filters |= _filters_used(path)
            ours = image.read_png(path)
            assert ours.dtype == np.uint8
            np.testing.assert_array_equal(ours, rgb)
            np.testing.assert_array_equal(image.imread_color(path), rgb)
        for depth in (rng.integers(0, 65536, (h, w), dtype=np.uint16),
                      (np.arange(h * w).reshape(h, w) * 37 % 65536).astype(np.uint16)):
            cv2.imwrite(path, depth, params)
            filters |= _filters_used(path)
            ours = image.read_png(path)
            assert ours.dtype == np.uint16
            np.testing.assert_array_equal(ours, depth)
    if h > 1:  # on the first row libpng writes Up as None, Paeth as Sub
        assert filters == {0, 1, 2, 3, 4}, filters


def test_png_read_of_grey_alpha_and_16_bit_colour_matches_cv2(tmp_path):
    rng = np.random.default_rng(5)
    grey8 = rng.integers(0, 256, (21, 34), dtype=np.uint8)
    bgra = rng.integers(0, 256, (21, 34, 4), dtype=np.uint8)
    bgr16 = rng.integers(0, 65536, (21, 34, 3), dtype=np.uint16)
    for name, img in (("g8", grey8), ("rgba", bgra), ("c16", bgr16)):
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(image.imread_color(path),
                                      cv2.imread(path)[..., ::-1])
        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if raw.ndim == 3:
            raw = raw[..., [2, 1, 0, 3][:raw.shape[2]]]
        np.testing.assert_array_equal(image.read_png(path), raw)


def test_png_written_by_the_port_reads_back_in_cv2(tmp_path):
    rng = np.random.default_rng(6)
    for h, w in ((480, 640), (37, 53)):
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        depth = rng.integers(0, 65536, (h, w), dtype=np.uint16)
        image.write_png(str(tmp_path / "rgb.png"), rgb)
        image.write_png(str(tmp_path / "depth.png"), depth)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "rgb.png")),
                                      rgb[..., ::-1])
        back = cv2.imread(str(tmp_path / "depth.png"), -1)
        assert back.dtype == np.uint16
        np.testing.assert_array_equal(back, depth)
        np.testing.assert_array_equal(image.read_png(str(tmp_path / "rgb.png")), rgb)


def test_png_rejects_what_it_does_not_read(tmp_path):
    rgb = np.zeros((8, 8, 3), np.uint8)
    jpg = np.random.default_rng(7).integers(0, 256, (13, 21, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "x.jpg"), jpg)
    # a JPEG is not a PNG, and imread_color decodes it as OpenCV does
    with pytest.raises(ValueError, match="not a PNG file .a JPEG"):
        image.read_png(str(tmp_path / "x.jpg"))
    np.testing.assert_array_equal(image.imread_color(str(tmp_path / "x.jpg")),
                                  cv2.imread(str(tmp_path / "x.jpg"))[..., ::-1])
    path = str(tmp_path / "i.png")
    image.write_png(path, rgb)
    data = bytearray(open(path, "rb").read())
    data[28] = 1  # IHDR interlace byte; fix the CRC so that only it differs
    import struct
    import zlib
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        image.read_png(path)
    data[30] ^= 0xFF  # break the CRC
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        image.read_png(path)
    with pytest.raises(ValueError):
        image.write_png(path, rgb.astype(np.float32))


def test_png_read_of_a_480x640_frame_is_fast(tmp_path):
    import time
    rng = np.random.default_rng(7)
    path = str(tmp_path / "f.png")
    cv2.imwrite(path, _scenes(rng, 480, 640)["smooth"])
    t0 = time.perf_counter()
    image.read_png(path)
    assert time.perf_counter() - t0 < 1.0


def test_jet_matches_cv2_on_all_levels(tmp_path):
    levels = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(
        image.JET[levels], cv2.applyColorMap(levels, cv2.COLORMAP_JET)[..., ::-1])
    rng = np.random.default_rng(8)
    depth = rng.uniform(0.3, 9.0, (24, 32))
    image.imwrite_colormap(str(tmp_path / "ours.png"), depth, vmax=7.5)
    jax_image.imwrite_colormap(str(tmp_path / "jax.png"), depth, vmax=7.5)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours.png")),
                                  cv2.imread(str(tmp_path / "jax.png")))


@pytest.mark.parametrize("src,dst", [((480, 640), (240, 320)),
                                     ((48, 64), (32, 48)),
                                     ((32, 48), (48, 64)),
                                     ((37, 53), (100, 77)),
                                     ((480, 640), (37, 41))])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_matches_cv2(src, dst, channels):
    rng = np.random.default_rng(9)
    shape = src if channels is None else (*src, channels)
    for dtype, scale, atol in ((np.float32, 1.0, 1e-6), (np.float64, 20.0, 1e-6),
                               (np.float32, 20.0, 2e-6)):
        img = (scale * rng.uniform(0, 1, shape)).astype(dtype)
        ours = image.resize_hw(img, dst)
        ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


def test_imread_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(10)
    rgb = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    depth = rng.integers(300, 9000, (40, 56), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "im.png"), rgb[..., ::-1])
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    for resize in (None, (32, 48)):
        np.testing.assert_allclose(
            image.imread_rgb(str(tmp_path / "im.png"), resize),
            jax_image.imread_rgb(str(tmp_path / "im.png"), resize), atol=1e-6)
        np.testing.assert_allclose(
            image.imread_depth_png(str(tmp_path / "d.png"), resize=resize),
            jax_image.imread_depth_png(str(tmp_path / "d.png"), resize=resize),
            rtol=0, atol=2e-6)


def test_pfm_matches_jax(tmp_path):
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = tmp_path / "x.pfm"
    with open(path, "wb") as f:
        f.write(b"Pf\n4 3\n-1.0\n")
        np.flipud(data).astype("<f4").tofile(f)
    out, scale = image.read_pfm(str(path))
    np.testing.assert_allclose(out, data)
    assert scale == 1.0
    color = np.random.default_rng(11).uniform(0, 5, (5, 6, 3)).astype(np.float32)
    color[1, 2, 0] = np.inf
    cpath = tmp_path / "c.pfm"
    with open(cpath, "wb") as f:
        f.write(b"PF\n# a comment\n6 5\n2.0\n")
        np.flipud(color).astype(">f4").tofile(f)
    for fn in ("read_pfm", "read_and_clean_pfm"):
        ours, s1 = getattr(image, fn)(str(cpath))
        ref, s2 = getattr(jax_image, fn)(str(cpath))
        np.testing.assert_array_equal(ours, ref)
        assert s1 == s2 == 2.0


def test_logging_helpers(tmp_path):
    port_logging.set_seed(3)
    a = (random.random(), np.random.rand())
    port_logging.set_seed(3)
    assert (random.random(), np.random.rand()) == a
    root = logging.getLogger()
    saved = list(root.handlers), root.level
    try:
        port_logging.set_logger(str(tmp_path))
        logging.info("hello from the port")
        for h in root.handlers:
            h.flush()
        assert "hello from the port" in (tmp_path / "output.log").read_text()
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])
    t = port_logging.Timer()
    assert t.lap() >= 0.0
