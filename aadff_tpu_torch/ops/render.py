"""Per-pixel PSF convolution (the port of `aadff_tpu/ops/render.py:68-94`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def local_psf_render(img: torch.Tensor, psf: torch.Tensor,
                     kernel_size: int = 11) -> torch.Tensor:
    """img [B, C, H, W]; psf [B, H, W, ks, ks] (shared across channels).

    out[b,c,y,x] = sum_{i,j} img_pad[b,c,y+i,x+j] * psf[b,y,x,i,j] with the
    image edge-padded by (ks-1)//2: a loop over the ks^2 taps, so no unfold
    buffer of H*W*ks^2*C values ever exists.
    """
    if img.dim() == 3:
        img = img[None]
    B, C, H, W = img.shape
    taps = psf.reshape(B, H, W, kernel_size * kernel_size).permute(0, 3, 1, 2)
    return render_taps(img, taps, kernel_size)


def render_taps(img: torch.Tensor, taps: torch.Tensor,
                kernel_size: int = 11) -> torch.Tensor:
    """The tap loop of `local_psf_render` on PSFs given tap-major: img
    [B, C, H, W]; taps [B, ks*ks, H, W] (tap k = i * ks + j) -> [B, C, H, W].
    Each pixel sums its taps in the same order whatever the strides of
    `taps`; a contiguous tap plane is one coalesced read a step, where a
    [B, H, W, ks*ks] layout strides by ks*ks floats."""
    ks = kernel_size
    B, C, H, W = img.shape
    pad = (ks - 1) // 2
    img_pad = F.pad(img, (pad, pad, pad, pad), mode="replicate")
    out = torch.zeros_like(img)
    for k in range(ks * ks):
        i, j = divmod(k, ks)
        out = out + img_pad[:, :, i:i + H, j:j + W] * taps[:, k, None]
    return out
