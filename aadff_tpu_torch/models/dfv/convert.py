"""Flax DFVNet variables -> the port's torch state dict.

Flax names submodules by type and creation order (`aadff_tpu/models/dfv/`):
  * FeatExactor: the stem is TorchConv_0 + BatchNorm_0, then BasicBlock_0..7
    (two per ResNet layer), PyramidPoolingSum_0 and ConvBNLeakyRelu_0..9 in
    the order upconv6, iconv5, upconv5, iconv4, upconv4, iconv3, proj6..3;
  * BasicBlock: TorchConv_0/BatchNorm_0 (conv1), _1 (conv2), _2 (the
    projection of the shortcut);
  * DecoderBlock: SepConv3dBlock_i, then SepConv3d_0 and _1 (classify, the
    cost computed before the upsample) and SepConv3d_2 (the upsample conv);
  * SepConv3dBlock: SepConv3d_0 (conv1), ProjFeat3d_0, SepConv3d_1 (conv2).
Conv kernels [kh, kw, in, out] -> torch [out, in, kh, kw] and
[kd, kh, kw, in, out] -> [out, in, kd, kh, kw]; BatchNorm scale/bias/mean/
var -> weight/bias/running_mean/running_var.

This is not the JAX package's `models/dfv/convert.py`, which loads a
torchvision ResNet-18 into the Flax feature extractor.
"""
from __future__ import annotations

import numpy as np
import torch

from ...utils import flax_msgpack

_PERM = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_FEAT_CONVS = ("upconv6", "iconv5", "upconv5", "iconv4", "upconv4", "iconv3",
               "proj6", "proj5", "proj4", "proj3")


def dfvnet_key_map() -> dict[str, tuple[str, tuple[str, ...]]]:
    """torch state-dict key -> (Flax collection, path of the Flax leaf) for
    DFVNet at level 2."""
    keys: dict[str, tuple[str, tuple[str, ...]]] = {}

    def conv(name, path, bias=False):
        keys[f"{name}.weight"] = ("params", (*path, "kernel"))
        if bias:
            keys[f"{name}.bias"] = ("params", (*path, "bias"))

    def bn(name, path):
        keys[f"{name}.weight"] = ("params", (*path, "scale"))
        keys[f"{name}.bias"] = ("params", (*path, "bias"))
        keys[f"{name}.running_mean"] = ("batch_stats", (*path, "mean"))
        keys[f"{name}.running_var"] = ("batch_stats", (*path, "var"))

    def conv_bn(name, path, conv_name="conv", bn_name="bn"):
        conv(f"{name}.{conv_name}", (*path, "TorchConv_0", "Conv_0"))
        bn(f"{name}.{bn_name}", (*path, "BatchNorm_0"))

    fe = ("feature_extraction",)
    conv("feature_extraction.conv1", (*fe, "TorchConv_0", "Conv_0"))
    bn("feature_extraction.bn1", (*fe, "BatchNorm_0"))
    for b in range(8):
        name = f"feature_extraction.layer{b // 2 + 1}.{b % 2}"
        path = (*fe, f"BasicBlock_{b}")
        conv(f"{name}.conv1", (*path, "TorchConv_0", "Conv_0"))
        bn(f"{name}.bn1", (*path, "BatchNorm_0"))
        conv(f"{name}.conv2", (*path, "TorchConv_1", "Conv_0"))
        bn(f"{name}.bn2", (*path, "BatchNorm_1"))
        if b in (2, 4, 6):  # first block of layers 2-4: strided shortcut
            conv(f"{name}.downsample.0", (*path, "TorchConv_2", "Conv_0"))
            bn(f"{name}.downsample.1", (*path, "BatchNorm_2"))
    for i in range(4):
        conv_bn(f"feature_extraction.pyramid_pooling.paths.{i}",
                (*fe, "PyramidPoolingSum_0", f"ConvBNLeakyRelu_{i}"))
    for i, name in enumerate(_FEAT_CONVS):
        conv_bn(f"feature_extraction.{name}", (*fe, f"ConvBNLeakyRelu_{i}"))

    def sep_conv(name, path, bias=False):
        conv(f"{name}.conv", (*path, "TorchConv_0", "Conv_0"), bias=bias)
        if not bias:
            bn(f"{name}.bn", (*path, "BatchNorm_0"))

    # At level 2 every decoder block keeps its width and stride, so none has
    # a ProjFeat3d shortcut.
    for name, up in (("decoder3", False), ("decoder4", True)):
        for i in range(2):
            block, path = f"{name}.convs.{i}", (name, f"SepConv3dBlock_{i}")
            sep_conv(f"{block}.conv1", (*path, "SepConv3d_0"))
            sep_conv(f"{block}.conv2", (*path, "SepConv3d_1"))
        sep_conv(f"{name}.classify.0", (name, "SepConv3d_0"))
        sep_conv(f"{name}.classify.2", (name, "SepConv3d_1"), bias=True)
        if up:
            sep_conv(f"{name}.up_conv", (name, "SepConv3d_2"))
    return keys


def dfvnet_state_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of the Flax DFVNet(level=2) -> a
    state dict for `aadff_tpu_torch.models.dfv.dffnet.DFVNet`."""
    out = {}
    for key, (collection, path) in dfvnet_key_map().items():
        leaf = variables[collection]
        for part in path:
            leaf = leaf[part]
        a = np.asarray(leaf, np.float32)
        if a.ndim in _PERM:
            a = a.transpose(_PERM[a.ndim])
        out[key] = torch.from_numpy(np.array(a, order="C"))
    return out


def load_flax_dfvnet(path: str) -> tuple[dict[str, torch.Tensor], int]:
    """Read a Flax DFVNet checkpoint -> (torch state dict, the step it was
    saved at)."""
    variables = flax_msgpack.load(path)
    return dfvnet_state_from_flax(variables), int(variables.get("step", 0))
