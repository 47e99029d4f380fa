"""The port's stdlib-only Flax msgpack reader and its weight converters,
against `flax.serialization.msgpack_restore` and the msgpack package."""
import os

import msgpack
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore, to_bytes

from aadff_tpu import constants as jax_constants
from aadff_tpu.psfnet.convert import flax_mlp_to_torch_state as jax_mlp_export
from aadff_tpu_torch import constants
from aadff_tpu_torch.psfnet.arch import MLP
from aadff_tpu_torch.psfnet.convert import flax_mlp_to_torch_state
from aadff_tpu_torch.utils import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = {
    "psfnet": os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack"),
    "aifnet": os.path.join(REPO, "ckpt", "dff_synth", "aifnet",
                           "depth_net_best.msgpack"),
}


def _assert_same_tree(ours, ref, path="root"):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), path
        for k in ref:
            _assert_same_tree(ours[k], ref[k], f"{path}/{k}")
    else:
        ref = np.asarray(ref)
        ours = np.asarray(ours)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        assert ours.tobytes() == ref.tobytes(), path


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_reader_matches_flax(name):
    """Bit-identical arrays and the same tree as msgpack_restore."""
    with open(CHECKPOINTS[name], "rb") as f:
        data = f.read()
    ours = flax_msgpack.loads(data)
    _assert_same_tree(ours, msgpack_restore(data))
    expected = {"psfnet": {"params"}, "aifnet": {"params", "batch_stats", "step"}}
    assert set(ours) == expected[name]


def test_reader_decodes_every_msgpack_type():
    """Every type code the reader handles, packed by the msgpack package."""
    doc = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**63 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2**31, -2**31 - 1, -2**63],
        "floats": [0.5, -1e300, 3.25],
        "misc": [None, True, False],
        "str": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "π"],
        "bin": [b"", b"x" * 300, b"y" * 70000],
        "big_list": list(range(20)),
        "big_map": {str(i): i for i in range(20)},
        "nested": {"a": {"b": [1, [2, {"c": None}]]}},
    }
    data = msgpack.packb(doc, use_bin_type=True)
    assert flax_msgpack.loads(data) == msgpack.unpackb(data, raw=False,
                                                       strict_map_key=False)
    f32 = msgpack.packb(np.float32(1.5).item(), use_single_float=True)
    assert flax_msgpack.loads(f32) == 1.5


def test_reader_decodes_flax_arrays_and_scalars():
    tree = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
            "b": np.float32(2.5), "c": np.zeros((0, 3), np.float64),
            "d": {"e": np.array(7, np.int64)}}
    data = to_bytes(tree)
    _assert_same_tree(flax_msgpack.loads(data), msgpack_restore(data))


@pytest.mark.parametrize("data,message", [
    (msgpack.packb([1, 2, 3])[:-1], "truncated"),
    (msgpack.packb(1) + b"\x00", "trailing"),
    (msgpack.packb(msgpack.ExtType(5, b"x")), "extension type 5"),
    (b"\xc1", "type byte 0xc1"),
])
def test_reader_rejects_malformed_input(data, message):
    with pytest.raises(ValueError, match=message):
        flax_msgpack.loads(data)


def test_constants_match_jax():
    assert constants.DMIN == jax_constants.DMIN
    assert constants.DMAX == jax_constants.DMAX


def test_mlp_state_matches_jax_exporter():
    """The port's Flax -> torch MLP converter gives the tensors of the JAX
    package's own exporter (psfnet/convert.py:35-46), and loads strictly."""
    variables = flax_msgpack.load(CHECKPOINTS["psfnet"])
    ours = flax_mlp_to_torch_state(variables)
    ref = jax_mlp_export(variables)
    assert list(ours) == list(ref)
    for key in ref:
        assert torch.equal(ours[key], ref[key]), key
    MLP().load_state_dict(ours)
