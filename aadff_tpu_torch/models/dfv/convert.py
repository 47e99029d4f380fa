"""Flax DFVNet variables -> the port's torch state dict.

Flax names submodules by type and creation order (`aadff_tpu/models/dfv/`):
  * FeatExactor: the stem is TorchConv_0 + BatchNorm_0, then BasicBlock_0..7
    (two per ResNet layer), PyramidPoolingSum_0 and ConvBNLeakyRelu_0..9 in
    the order upconv6, iconv5, upconv5, iconv4, upconv4, iconv3, proj6..3;
  * BasicBlock: TorchConv_0/BatchNorm_0 (conv1), _1 (conv2), _2 (the
    projection of the shortcut);
  * DecoderBlock: SepConv3dBlock_i, then with pool=True SepConv3d_0..3 (the
    pool convs), then two SepConv3d (classify, the cost computed before the
    upsample) and one more (the upsample conv): _0, _1, _2 without the
    pool and _4, _5, _6 with it;
  * SepConv3dBlock: SepConv3d_0 (conv1), ProjFeat3d_0 (Conv_0 and
    BatchNorm_0, where the block changes width: the first block of
    decoder4 at levels 3 and 4 and of decoder5 at level 4), SepConv3d_1
    (conv2).
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
from .dffnet import DECODERS

_PERM = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_FEAT_CONVS = ("upconv6", "iconv5", "upconv5", "iconv4", "upconv4", "iconv3",
               "proj6", "proj5", "proj4", "proj3")


def dfvnet_level(params: dict) -> int:
    """The level of a Flax DFVNet from its params: the coarsest decoder it
    has (decoder3 alone is level 1, decoder6 level 4)."""
    return max(n for n in (1, 2, 3, 4) if DECODERS[n][-1][0] in params)


def dfvnet_key_map(level: int = 2) -> dict[str, tuple[str, tuple[str, ...]]]:
    """torch state-dict key -> (Flax collection, path of the Flax leaf) for
    DFVNet at `level`."""
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

    # Every decoder block has stride 1, so a block has a ProjFeat3d shortcut
    # exactly where it changes width: the first block, fed cin channels.
    for name, cin, channels, up, pool in DECODERS[level]:
        for i in range(2):
            block, path = f"{name}.convs.{i}", (name, f"SepConv3dBlock_{i}")
            sep_conv(f"{block}.conv1", (*path, "SepConv3d_0"))
            if i == 0 and cin != channels:
                proj = (*path, "ProjFeat3d_0")
                conv(f"{block}.downsample.conv", (*proj, "Conv_0"))
                bn(f"{block}.downsample.bn", (*proj, "BatchNorm_0"))
            sep_conv(f"{block}.conv2", (*path, "SepConv3d_1"))
        k = 4 if pool else 0
        for j in range(k):
            sep_conv(f"{name}.pool_convs.{j}", (name, f"SepConv3d_{j}"))
        sep_conv(f"{name}.classify.0", (name, f"SepConv3d_{k}"))
        sep_conv(f"{name}.classify.2", (name, f"SepConv3d_{k + 1}"), bias=True)
        if up:
            sep_conv(f"{name}.up_conv", (name, f"SepConv3d_{k + 2}"))
    return keys


def dfvnet_state_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of a Flax DFVNet at any level
    (`dfvnet_level`) -> a state dict for
    `aadff_tpu_torch.models.dfv.dffnet.DFVNet` at that level."""
    out = {}
    level = dfvnet_level(variables["params"])
    for key, (collection, path) in dfvnet_key_map(level).items():
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
