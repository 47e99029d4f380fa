"""AiFDepthNet and its loss (the port of `aadff_tpu/models/aifnet.py:21-268`):
an I3D-style 3D-CNN U-Net over focal stacks with softmax attention over the
stack for depth and all-in-focus regression, or the DIRECT head, and the
4-channel input of `add_stack_index_channel`.

Inside it is NCDHW with D = the stack.  At its boundary it keeps the JAX
package's layout: the stack comes in as [B, S, H, W, C] and the outputs
`pred_depth` [B, 1, H, W] and `pred_AiF_img` [B, 3, H, W] go out as NCHW.
The trunk is cuDNN's: the JAX package has no Pallas kernel in it.

`dtype=torch.bfloat16` is the JAX model's `dtype=jnp.bfloat16`
(`aifnet.py:98-107`): the stack is cast to bf16 and every convolution and
transposed convolution computes in bf16 with its f32 parameters cast at use;
BatchNorm takes its statistics in f32 and returns bf16; the trunk's output
is cast to f32 before the attention head, which, like the loss, stays f32
and weights the f32 stack.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .layers import BatchNorm, checkpoint, conv

_UP_K, _UP_S, _UP_P = (3, 4, 4), (1, 2, 2), (1, 1, 1)


class Conv3dBN(nn.Module):
    """conv3d + BN + ReLU (`aifnet.py:21-39`)."""

    def __init__(self, cin: int, cout: int, k=(1, 1, 1), s=(1, 1, 1),
                 p=(0, 0, 0), dtype=None):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k, s, p)
        self.bn = BatchNorm(cout)
        self.dtype = dtype

    def forward(self, x):
        return F.relu(self.bn(conv(self.conv, x, self.dtype)))


class Trans3dBN(nn.Module):
    """transposed conv3d + BN + ReLU + Conv3dBN (`aifnet.py:42-61`)."""

    def __init__(self, cin: int, features: tuple[int, int], dtype=None):
        super().__init__()
        self.tconv = nn.ConvTranspose3d(cin, features[0], _UP_K, _UP_S, _UP_P)
        self.bn = BatchNorm(features[0])
        self.conv = Conv3dBN(features[0], features[1], (3, 3, 3), (1, 1, 1),
                             (1, 1, 1), dtype)
        self.dtype = dtype

    def forward(self, x):
        return self.conv(F.relu(self.bn(conv(self.tconv, x, self.dtype))))


class Mixed(nn.Module):
    """Inception block (`aifnet.py:64-83`); out_ch as in the JAX package."""

    def __init__(self, cin: int, out_ch: tuple[int, ...], dtype=None):
        super().__init__()
        oc = out_ch
        self.b0 = Conv3dBN(cin, oc[0], dtype=dtype)
        self.b1a = Conv3dBN(cin, oc[1], dtype=dtype)
        self.b1b = Conv3dBN(oc[1], oc[2], (3, 3, 3), p=(1, 1, 1), dtype=dtype)
        self.b2a = Conv3dBN(cin, oc[3], dtype=dtype)
        self.b2b = Conv3dBN(oc[3], oc[4], (3, 3, 3), p=(1, 1, 1), dtype=dtype)
        self.b3 = Conv3dBN(cin, oc[5], dtype=dtype)
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x):
        pooled = F.max_pool3d(x, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3(pooled)], dim=1)


class AiFDepthNet(nn.Module):
    """`aifnet.py:86-193`.  The main path's configuration is the default:
    stage2='attention', one output class, unnormalised attention.

    Variants, as the JAX model's fields name them: `n_channels=4` (the
    stack with `add_stack_index_channel`'s index); `n_classes=2` (the
    attention of depth and of the AiF image from two channels);
    `normalize_attention` (softplus over the stack, normalised, for the
    depth); `stage2='direct'` (two Linear layers over the stack, which
    need `n_stack`); `disp_depth` (the name of the depth output,
    "pred_<disp_depth>"); `remat` (each Mixed block recomputed in the
    backward pass, `layers.checkpoint`)."""

    def __init__(self, n_channels: int = 3, dtype=None, n_classes: int = 1,
                 n_stack: int = 10, disp_depth: str = "depth",
                 stage2: str = "attention", normalize_attention: bool = False,
                 remat: bool = False):
        super().__init__()
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None or torch.bfloat16, got "
                             f"{dtype}")
        if stage2.upper() not in ("ATTENTION", "DIRECT"):
            raise ValueError(f"stage2 must be 'attention' or 'direct', got "
                             f"{stage2!r}")
        if n_classes not in (1, 2):
            raise ValueError(f"n_classes must be 1 or 2, got {n_classes}")
        dt = self.dtype = dtype
        self.n_classes, self.n_stack = n_classes, n_stack
        self.disp_depth = disp_depth
        self.direct = stage2.upper() == "DIRECT"
        self.normalize_attention = normalize_attention
        self.remat = remat
        self.conv1a = Conv3dBN(n_channels, 64, (7, 7, 7), (1, 2, 2), (3, 3, 3),
                               dt)
        self.conv2b = Conv3dBN(64, 64, dtype=dt)
        self.conv2c = Conv3dBN(64, 192, (3, 3, 3), p=(1, 1, 1), dtype=dt)
        self.mixed_3b = Mixed(192, (64, 96, 128, 16, 32, 32), dt)
        self.mixed_3c = Mixed(256, (128, 128, 192, 32, 96, 64), dt)
        self.mixed_4b = Mixed(480, (192, 96, 208, 16, 48, 64), dt)
        self.mixed_4c = Mixed(512, (160, 112, 224, 24, 64, 64), dt)
        self.mixed_4d = Mixed(512, (128, 128, 256, 24, 64, 64), dt)
        self.mixed_4e = Mixed(512, (112, 144, 288, 32, 64, 64), dt)
        self.mixed_4f = Mixed(528, (256, 160, 320, 32, 128, 128), dt)
        self.mixed_5b = Mixed(832, (256, 160, 320, 32, 128, 128), dt)
        self.mixed_5c = Mixed(832, (384, 192, 384, 48, 128, 128), dt)
        self.up_5c = Trans3dBN(1024, (64, 64), dt)
        self.up_4f = Conv3dBN(832, 64, dtype=dt)
        self.up_5c4f = Trans3dBN(128, (64, 64), dt)
        self.up_3c = Conv3dBN(480, 64, dtype=dt)
        self.up_5c4f3c = Trans3dBN(128, (32, 32), dt)
        self.up_2c = Conv3dBN(192, 32, dtype=dt)
        self.up_5c4f3c2c = Trans3dBN(64, (32, 16), dt)
        self.up_1a = Conv3dBN(64, 16, dtype=dt)
        self.up_final = nn.ConvTranspose3d(32, 32, _UP_K, _UP_S, _UP_P)
        self.out = nn.Conv3d(32, n_classes, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        if self.direct:  # Flax's Dense_0 and Dense_1 (`aifnet.py:180-182`)
            self.direct_depth = nn.Linear(n_stack, 1)
            self.direct_aif = nn.Linear(n_stack, 3)

    def _mixed(self, block, x):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, x)
        return block(x)

    def forward(self, stack: torch.Tensor, focus_position: torch.Tensor):
        """stack [B, S, H, W, C]; focus_position [B, S] ->
        {'pred_<disp_depth>': [B, 1, H, W], 'pred_AiF_img': [B, 3, H, W]}."""
        B, S, H, W, C = stack.shape
        mixed = self._mixed
        x = stack.permute(0, 4, 1, 2, 3)  # [B, C, S, H, W]
        conv1a = self.conv1a(x if self.dtype is None else x.to(self.dtype))
        h = F.max_pool3d(conv1a, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        conv2c = self.conv2c(self.conv2b(h))
        h = F.max_pool3d(conv2c, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        mix3c = mixed(self.mixed_3c, mixed(self.mixed_3b, h))
        h = F.max_pool3d(mix3c, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for block in (self.mixed_4b, self.mixed_4c, self.mixed_4d,
                      self.mixed_4e, self.mixed_4f):
            h = mixed(block, h)
        mix4f = h
        h = F.max_pool3d(mix4f, (1, 2, 2), (1, 2, 2), (0, 0, 0))
        mix5c = mixed(self.mixed_5c, mixed(self.mixed_5b, h))

        up = self.up_5c(mix5c)
        up = self.up_5c4f(torch.cat([up, self.up_4f(mix4f)], dim=1))
        up = self.up_5c4f3c(torch.cat([up, self.up_3c(mix3c)], dim=1))
        up = self.up_5c4f3c2c(torch.cat([up, self.up_2c(conv2c)], dim=1))
        up = conv(self.up_final, torch.cat([up, self.up_1a(conv1a)], dim=1),
                  self.dtype)
        # transposed convs can overshoot by stride-1: crop to the input size;
        # the head runs in f32.  out [B, n_classes, S, H, W]
        out = conv(self.out, up, self.dtype)[..., :H, :W].float()

        if self.direct:  # `aifnet.py:178-182`: Linear layers over the stack
            o = out[:, 0].permute(0, 2, 3, 1)  # [B, H, W, S]
            depth = self.direct_depth(o).permute(0, 3, 1, 2)
            aif = torch.sigmoid(self.direct_aif(o)).permute(0, 3, 1, 2)
        else:
            a_att = torch.softmax(out[:, self.n_classes - 1], dim=1)  # over S
            if self.normalize_attention:
                d_att = F.softplus(out[:, 0])
                d_att = d_att / d_att.sum(1, keepdim=True)
            elif self.n_classes == 2:
                d_att = torch.softmax(out[:, 0], dim=1)
            else:  # one class: the same attention for both
                d_att = a_att
            depth = (d_att * focus_position.reshape(B, S, 1, 1)).sum(
                1, keepdim=True)
            aif = (a_att[:, None] * x[:, :3]).sum(2)
        return {f"pred_{self.disp_depth}": depth, "pred_AiF_img": aif}


def add_stack_index_channel(stack: torch.Tensor) -> torch.Tensor:
    """Append the normalised stack index as a 4th channel (`aifnet.py:195-
    204`, the n_channels=4 variant): [B, S, H, W, 3] -> [B, S, H, W, 4]."""
    B, S, H, W, C = stack.shape
    idx = (torch.arange(1, S + 1, dtype=stack.dtype, device=stack.device)
           / S).reshape(1, S, 1, 1, 1)
    return torch.cat([stack, idx.expand(B, S, H, W, 1)], dim=-1)


def _image_grads(x):
    return x[..., 1:, :] - x[..., :-1, :], x[..., 1:] - x[..., :-1]


def _robust_l1(x):
    return (x ** 2 + 0.001 ** 2) ** 0.5


def _smoothness_terms(gt_aif, d_out):
    """The edge weights and robust depth gradients of the edge-aware
    smoothness (`aifnet.py:220-226`): the mean of wx * rx and the mean of
    wy * ry, halved."""
    edge_constant = 150.0
    img_gx, img_gy = _image_grads(gt_aif)
    wx = torch.exp(-((edge_constant * img_gx) ** 2).mean(1, keepdim=True))
    wy = torch.exp(-((edge_constant * img_gy) ** 2).mean(1, keepdim=True))
    d_gx, d_gy = _image_grads(d_out)
    return wx, wy, _robust_l1(d_gx), _robust_l1(d_gy)


def compute_loss(outputs: dict, input_dict: dict, task: str,
                 disp_w: float = 1.0, aif_w: float = 0.0,
                 smooth_w: float = 0.0, disp_depth: str = "depth") -> dict:
    """Losses of tasks D_FS, A_FS and DA_FS (`aifnet.py:227-268`): masked L1
    depth (mask = gt > 0) under the key `disp_depth`, AiF L1 and edge-aware
    smoothness.

    Each mean is a sum over its count.  Under data parallelism every sum
    and count is summed over the ranks in one all-reduce before it is
    divided (`parallel.mesh.global_sums`), so each loss is that of the
    global batch, as JAX's is under a sharded `jit`: a masked mean is then
    sum(err * mask) / sum(mask) over all the ranks' pixels, not the mean of
    the ranks' masked means, which differs when their masks hold different
    counts."""
    if task not in ("D_FS", "A_FS", "DA_FS"):
        raise NotImplementedError(task)
    d_out = outputs[f"pred_{disp_depth}"]
    sums = {}
    if task in ("D_FS", "DA_FS"):
        gt_d = input_dict[disp_depth]
        mask = (gt_d > 0).to(d_out.dtype)
        err = d_out - gt_d
        sums["l1"] = (err.abs() * mask).sum()
        sums["mse"] = (err ** 2 * mask).sum()
        sums["mask"] = mask.sum()
    if task in ("A_FS", "DA_FS"):
        gt_aif = input_dict["AiF_img"]
        aif_err = (outputs["pred_AiF_img"] - gt_aif).abs()
        wx, wy, rx, ry = _smoothness_terms(gt_aif, d_out)
        for name, t in (("aif", aif_err), ("sx", wx * rx), ("sy", wy * ry)):
            sums[name], sums[f"{name}_n"] = t.sum(), t.new_tensor(float(t.numel()))
    g = dict(zip(sums, mesh.global_sums(*sums.values())))
    losses = {}
    if "l1" in g:
        losses[disp_depth] = g["l1"] / (g["mask"] + 1e-12)
        losses["disp_MSE"] = (g["mse"] / (g["mask"] + 1e-12)).detach()
    if "aif" in g:
        losses["AiF"] = g["aif"] / g["aif_n"]
        losses["smooth"] = (g["sx"] / g["sx_n"] + g["sy"] / g["sy_n"]) / 2.0
    if task == "D_FS":
        losses["total"] = disp_w * losses[disp_depth]
    elif task == "A_FS":
        losses["total"] = aif_w * losses["AiF"] + smooth_w * losses["smooth"]
    else:
        losses["total"] = (aif_w * losses["AiF"] + disp_w * losses[disp_depth]
                           + smooth_w * losses["smooth"])
    return losses
