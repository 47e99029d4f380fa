"""Flax AiFDepthNet variables -> the port's torch state dict.

Flax names its submodules by creation order (`aadff_tpu/models/aifnet.py`):
the outer module of a nested call is created first, so `Conv3dBN_1` is
conv2c and `Conv3dBN_2` conv2b.  The tables below record that order.
  * Conv kernels [kd, kh, kw, in, out] -> torch [out, in, kd, kh, kw].
  * `TorchConvTranspose` kernels [kd, kh, kw, in, out] -> torch
    [in, out, kd, kh, kw], with no flip: the Flax layer flips internally
    (`aadff_tpu/models/layers.py:50-90`), which is torch's definition.
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.
  * The DIRECT head's Dense kernels [S, out] -> Linear weights [out, S].
The variants (`models/aifnet.py:AiFDepthNet`) keep these names: `remat`
names its blocks as the plain model does, `n_classes` and `n_channels`
change only the shapes of the last and first convolutions, and
`stage2='direct'` adds `Dense_0` (depth) and `Dense_1` (AiF).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import flax_msgpack

_CONV_BN = {"conv1a": "Conv3dBN_0", "conv2c": "Conv3dBN_1",
            "conv2b": "Conv3dBN_2", "up_4f": "Conv3dBN_3",
            "up_3c": "Conv3dBN_4", "up_2c": "Conv3dBN_5",
            "up_1a": "Conv3dBN_6"}
_MIXED = ("3b", "3c", "4b", "4c", "4d", "4e", "4f", "5b", "5c")
_MIXED_BRANCH = {"b0": "Conv3dBN_0", "b1b": "Conv3dBN_1", "b1a": "Conv3dBN_2",
                 "b2b": "Conv3dBN_3", "b2a": "Conv3dBN_4", "b3": "Conv3dBN_5"}
_DENSE = {"direct_depth": "Dense_0", "direct_aif": "Dense_1"}
_TRANS = {"up_5c": "Trans3dBN_0", "up_5c4f": "Trans3dBN_1",
          "up_5c4f3c": "Trans3dBN_2", "up_5c4f3c2c": "Trans3dBN_3"}


def aifnet_state_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of the Flax AiFDepthNet -> a
    state dict for `aadff_tpu_torch.models.aifnet.AiFDepthNet`."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}

    def get(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    def tensor(a, perm=None):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.array(
            a if perm is None else a.transpose(perm), order="C"))

    def conv(name, path, perm=(4, 3, 0, 1, 2)):
        p = get(params, path)
        out[f"{name}.weight"] = tensor(p["kernel"], perm)
        out[f"{name}.bias"] = tensor(p["bias"])

    def bn(name, path):
        p, s = get(params, path), get(stats, path)
        out[f"{name}.weight"] = tensor(p["scale"])
        out[f"{name}.bias"] = tensor(p["bias"])
        out[f"{name}.running_mean"] = tensor(s["mean"])
        out[f"{name}.running_var"] = tensor(s["var"])

    def conv_bn(name, path):
        conv(f"{name}.conv", (*path, "TorchConv_0", "Conv_0"))
        bn(f"{name}.bn", (*path, "BatchNorm_0"))

    for name, flax_name in _CONV_BN.items():
        conv_bn(name, (flax_name,))
    for m in _MIXED:
        for branch, flax_name in _MIXED_BRANCH.items():
            conv_bn(f"mixed_{m}.{branch}", (f"Mixed_{m}", flax_name))
    for name, flax_name in _TRANS.items():
        conv(f"{name}.tconv", (flax_name, "TorchConvTranspose_0"),
             perm=(3, 4, 0, 1, 2))
        bn(f"{name}.bn", (flax_name, "BatchNorm_0"))
        conv_bn(f"{name}.conv", (flax_name, "Conv3dBN_0"))
    conv("up_final", ("TorchConvTranspose_0",), perm=(3, 4, 0, 1, 2))
    conv("out", ("TorchConv_0", "Conv_0"))
    for name, flax_name in _DENSE.items():
        if flax_name in params:
            conv(name, (flax_name,), perm=(1, 0))
    return out


def load_flax_aifnet(path: str) -> tuple[dict[str, torch.Tensor], int]:
    """Read a Flax AiFDepthNet checkpoint (full or stripped of its optimizer
    state) -> (torch state dict, the step it was saved at)."""
    variables = flax_msgpack.load(path)
    return aifnet_state_from_flax(variables), int(variables.get("step", 0))
