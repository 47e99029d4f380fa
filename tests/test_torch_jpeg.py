"""The port's JPEG decoder (`utils/image.py:read_jpeg`, the C++ of
`csrc/jpeg_decode.cpp`) against OpenCV's `cv2.imread` (libjpeg-turbo), on
files that the tests write with cv2: bit for bit over quality 50, 75, 95
and 100, sampling 4:4:4, 4:2:2, 4:2:0 (and 4:1:1), grey, odd and
tiny sizes, restart intervals and EXIF orientations 1-8; the committed
fixtures of tests/torch_assets/ against their manifest; the kinds it
refuses raise with the file's name; and without a C++ compiler the build
raises, with no fallback decoder.
"""
import hashlib
import importlib.util
import json
import os
import struct

import cv2
import numpy as np
import pytest

from aadff_tpu_torch.utils import _host_build, image
from aadff_tpu_torch.utils.image import imread_color, read_jpeg

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_assets")
_spec = importlib.util.spec_from_file_location(
    "make_assets", os.path.join(ASSETS, "make_assets.py"))
assets = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(assets)

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = ((37, 53), (53, 37), (1, 1), (2, 7), (9, 17), (16, 16), (120, 160))


def _noisy(seed, h, w, channels=3):
    """A frame with gratings and noise (every coefficient busy)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([128 + 90 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0 - c)
                     for c in range(channels)], -1)
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _write(path, img, quality=90, sampling="420", restart=0, progressive=0):
    assert cv2.imwrite(str(path), img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
        cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
    return str(path)


def _assert_as_cv2(path):
    ref = cv2.imread(path)[..., ::-1]
    ours = read_jpeg(path)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref, err_msg=path)


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_decode_equals_cv2(tmp_path, quality, sampling):
    """Bit for bit at every size of SIZES, with and without restart
    intervals (1 and 5 MCUs)."""
    for k, (h, w) in enumerate(SIZES):
        for restart in (0, 1, 5):
            _assert_as_cv2(_write(tmp_path / f"{k}_{restart}.jpg", _noisy(k, h, w),
                                  quality, sampling, restart))


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_grey_decodes_to_three_equal_channels(tmp_path, quality):
    for k, (h, w) in enumerate(SIZES):
        path = _write(tmp_path / f"g{k}.jpg", _noisy(k, h, w, 1), quality,
                      restart=k % 2)
        _assert_as_cv2(path)
        ours = read_jpeg(path)
        assert (ours[..., 0] == ours[..., 1]).all() and (ours[..., 1] == ours[..., 2]).all()


def test_411_equals_cv2(tmp_path):
    """4:1:1, which libjpeg upsamples by replication, as it does a 4:2:x
    component at most 2 samples wide (SIZES' narrow frames)."""
    for k, (h, w) in enumerate(SIZES):
        _assert_as_cv2(_write(tmp_path / f"{k}.jpg", _noisy(k, h, w), 85, "411"))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applied_as_cv2(tmp_path, orientation):
    for k, (h, w) in enumerate(((37, 53), (16, 24))):
        src = _write(tmp_path / f"src{k}.jpg", _noisy(k, h, w), 90, "420")
        path = tmp_path / f"o{k}.jpg"
        path.write_bytes(assets.with_exif(open(src, "rb").read(), orientation, k == 1))
        _assert_as_cv2(str(path))
        if orientation >= 5:
            assert read_jpeg(str(path)).shape == (w, h, 3)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _manifest():
    with open(os.path.join(ASSETS, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(assets.JPEGS))
def test_committed_fixture_against_manifest(name):
    """The manifest holds cv2's decode of each committed JPEG; read_jpeg
    gives the same bytes, and refuses the progressive one."""
    rec = _manifest()["jpeg"][name]
    path = os.path.join(ASSETS, name)
    assert _sha(cv2.imread(path)[..., ::-1]) == rec["sha256"]
    if rec["progressive"]:
        with pytest.raises(NotImplementedError, match=f"{name}.*progressive"):
            read_jpeg(path)
        return
    ours = read_jpeg(path)
    assert list(ours.shape) == rec["shape"] and _sha(ours) == rec["sha256"]
    assert _sha(imread_color(path)) == rec["sha256"]


def test_fixtures_regenerate(tmp_path):
    """make_assets.py, run again, writes files whose cv2 decodes (and EXR
    values) the committed manifest records."""
    assert assets.make(str(tmp_path)) == _manifest()


def _baseline(tmp_path):
    return open(_write(tmp_path / "base.jpg", _noisy(0, 24, 32), 90, "420"), "rb").read()


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """`data` with the byte at `offset` into the first `marker` segment's
    payload (after its length) set to `value`."""
    i = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[i + 4 + offset] = value
    return bytes(out)


def _sof(data, new_marker):
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([new_marker]) + data[i + 2:]


def _adobe_rgb(data):
    """The JFIF APP0 segment replaced by an Adobe APP14 with transform 0."""
    i = data.index(b"\xff\xe0")
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + b"\x00\x64\x00\x00\x00\x00\x00"
    return data[:i] + adobe + data[i + 2 + n:]


REFUSED = {
    "progressive": (lambda d, p: open(_write(p / "x.jpg", _noisy(0, 24, 32), 90, "420",
                                              progressive=1), "rb").read(), "progressive"),
    "arithmetic": (lambda d, p: _sof(d, 0xC9), "arithmetic"),
    "lossless": (lambda d, p: _sof(d, 0xC3), "lossless"),
    "12-bit": (lambda d, p: _patched(d, 0xC0, 0, 12), "12-bit"),
    "cmyk": (lambda d, p: _patched(d, 0xC0, 5, 4), "CMYK"),
    "adobe-rgb": (lambda d, p: _adobe_rgb(d), "RGB-coded"),
    "multi-scan": (lambda d, p: _patched(d, 0xDA, 0, 1), "multi-scan"),
    "4:4:0": (lambda d, p: open(_write(p / "x.jpg", _noisy(0, 24, 32), 90, "440"),
                                "rb").read(), "4:4:0"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_kinds_raise_with_the_file_name(tmp_path, kind):
    make, message = REFUSED[kind]
    path = tmp_path / f"refused_{kind}.jpg"
    path.write_bytes(make(_baseline(tmp_path), tmp_path))
    with pytest.raises(NotImplementedError, match=f"refused_{kind}.jpg.*{message}"):
        read_jpeg(str(path))
    with pytest.raises(NotImplementedError, match=f"refused_{kind}.jpg"):
        imread_color(str(path))


def test_malformed_files_raise_with_the_file_name(tmp_path):
    data = _baseline(tmp_path)
    for name, bad in (("truncated.jpg", data[:200]), ("no_soi.jpg", data[2:]),
                      ("garbage.jpg", b"\xff\xd8\xff\x00" + data[4:])):
        (tmp_path / name).write_bytes(bad)
        with pytest.raises(ValueError, match=name):
            read_jpeg(str(tmp_path / name))


def test_without_a_compiler_the_build_raises(monkeypatch):
    """No compiler: the build names the compilers it looked for, and a
    decode raises instead of falling back to another decoder."""
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(_host_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_host_build, "_lib", None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler.*c\\+\\+, g\\+\\+"):
        _host_build.build()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        read_jpeg(os.path.join(ASSETS, "restart_420.jpg"))


def test_png_reader_names_a_jpeg(tmp_path):
    """A JPEG under a .png name: read_png refuses it, imread_color reads
    it by its content, as cv2.imread does."""
    path = tmp_path / "x.png"
    path.write_bytes(open(_write(tmp_path / "x.jpg", _noisy(0, 8, 8)), "rb").read())
    with pytest.raises(ValueError, match="x.png: not a PNG file .a JPEG"):
        image.read_png(str(path))
    np.testing.assert_array_equal(imread_color(str(path)),
                                  cv2.imread(str(path))[..., ::-1])
