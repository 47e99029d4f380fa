"""The port's OpenEXR reader (`utils/image.py:read_exr`) on files that the
tests write from the OpenEXR layout with their own writer
(tests/torch_assets/make_assets.py:write_exr): OpenCV here has no EXR
codec, so the oracle is the values written, arranged as OpenCV's
`ExrDecoder` returns them (Y alone as [H, W], R, G, B as [H, W, 3] in BGR
order; float32, int32 when every channel is UINT).  Every pixel type
(HALF, FLOAT, UINT) under every compression read (NONE, ZIPS, ZIP),
1 and 3 channels, data windows that do not start at 0, chunks stored raw,
the committed fixtures, and the files that must be refused.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from aadff_tpu_torch.utils.image import read_exr

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_assets")
_spec = importlib.util.spec_from_file_location(
    "make_assets", os.path.join(ASSETS, "make_assets.py"))
assets = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(assets)

TYPES = {"uint": 0, "half": 1, "float": 2}
COMPRESSIONS = {"none": 0, "zips": 2, "zip": 3}


def _assert_exact(ours, want):
    assert ours.dtype == want.dtype and ours.shape == want.shape
    np.testing.assert_array_equal(ours.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
@pytest.mark.parametrize("ptype", sorted(TYPES))
def test_values_and_shapes_exact(tmp_path, ptype, compression):
    """Y and R, G, B files of one pixel type, 37 rows (ZIP's 16-line chunks
    end ragged), data windows at (0, 0) and (-5, 7)."""
    t, c = TYPES[ptype], COMPRESSIONS[compression]
    for seed, (names, origin) in enumerate(((("Y",), (0, 0)),
                                            (("R", "G", "B"), (-5, 7)))):
        chans = assets.exr_channels(seed, {n: t for n in names}, 37, 23)
        path = tmp_path / f"{ptype}_{compression}_{len(names)}.exr"
        assets.write_exr(str(path), chans, c, origin)
        _assert_exact(read_exr(str(path)), assets.expected_exr(chans))


def test_bgr_order_and_ignored_channels(tmp_path):
    """R, G, B come back as B, G, R (OpenCV's order); an extra Z channel,
    which OpenCV does not read, is skipped."""
    h, w = 4, 6
    chans = {"R": np.full((h, w), 1, np.float32), "G": np.full((h, w), 2, np.float32),
             "B": np.full((h, w), 3, np.float32), "Z": np.full((h, w), 9, np.float32)}
    assets.write_exr(str(tmp_path / "bgr.exr"), chans, 3)
    out = read_exr(str(tmp_path / "bgr.exr"))
    assert out.shape == (h, w, 3)
    assert (out[..., 0] == 3).all() and (out[..., 1] == 2).all() and (out[..., 2] == 1).all()


def test_mixed_uint_and_float_read_as_float32(tmp_path):
    chans = assets.exr_channels(3, {"R": 0, "G": 2, "B": 1}, 5, 7)
    assets.write_exr(str(tmp_path / "mixed.exr"), chans, 2)
    out = read_exr(str(tmp_path / "mixed.exr"))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out[..., 2], chans["R"].astype(np.float32))


def test_constant_chunks_are_compressed_and_incompressible_ones_stored_raw(tmp_path):
    """A constant plane compresses; a 1x1 file does not (the writer then
    stores the chunk raw, as OpenEXR does): both read back exactly."""
    for name, plane in (("flat.exr", np.full((20, 30), 0.25, np.float16)),
                        ("tiny.exr", np.array([[7.5]], np.float32))):
        for c in (2, 3):
            assets.write_exr(str(tmp_path / name), {"Y": plane}, c)
            _assert_exact(read_exr(str(tmp_path / name)), plane.astype(np.float32))


@pytest.mark.parametrize("name", sorted(assets.EXRS))
def test_committed_fixture_against_manifest(name):
    import hashlib

    with open(os.path.join(ASSETS, "manifest.json")) as f:
        rec = json.load(f)["exr"][name]
    out = read_exr(os.path.join(ASSETS, name))
    assert list(out.shape) == rec["shape"] and str(out.dtype) == rec["dtype"]
    assert hashlib.sha256(out.tobytes()).hexdigest() == rec["sha256"]


def _file(tmp_path, name, chans=None, compression=3, flags=0):
    chans = chans or {"Y": np.zeros((3, 4), np.float32)}
    path = tmp_path / name
    assets.write_exr(str(path), chans, compression, version_flags=flags)
    return str(path)


def _plane(dtype=np.float32):
    return np.zeros((3, 4), dtype)


REFUSED = {  # name: (how the file differs, exception, message)
    "tiled": (dict(flags=0x200), NotImplementedError, "tiled"),
    "deep": (dict(flags=0x800), NotImplementedError, "deep"),
    "multipart": (dict(flags=0x1000), NotImplementedError, "multi-part"),
    "rle": (dict(compression=1), NotImplementedError, "RLE compression"),
    "piz": (dict(compression=4), NotImplementedError, "PIZ compression"),
    "pxr24": (dict(compression=5), NotImplementedError, "PXR24 compression"),
    "b44": (dict(compression=6), NotImplementedError, "B44 compression"),
    "dwaa": (dict(compression=8), NotImplementedError, "DWAA compression"),
    "alpha": (dict(chans={"R": _plane(), "G": _plane(), "B": _plane(), "A": _plane()}),
              NotImplementedError, "alpha"),
    "partial_rgb": (dict(chans={"R": _plane(), "G": _plane()}), NotImplementedError,
                    "only"),
    "chroma": (dict(chans={"Y": _plane(), "RY": _plane(), "BY": _plane()}),
               NotImplementedError, "luminance/chroma"),
    "no_known_channel": (dict(chans={"Z": _plane()}), ValueError, "none of the channels"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_files_raise_with_the_file_name(tmp_path, kind):
    how, exc, message = REFUSED[kind]
    path = _file(tmp_path, f"refused_{kind}.exr", **how)
    with pytest.raises(exc, match=f"refused_{kind}.exr.*{message}"):
        read_exr(path)


def test_malformed_files_raise_with_the_file_name(tmp_path):
    good = open(_file(tmp_path, "good.exr"), "rb").read()
    for name, bad in (("not_exr.exr", b"P5\n" + good), ("cut.exr", good[:-6])):
        (tmp_path / name).write_bytes(bad)
        with pytest.raises(ValueError, match=name):
            read_exr(str(tmp_path / name))
