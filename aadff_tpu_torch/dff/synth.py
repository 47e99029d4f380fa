"""Procedural scenes for the AiF main path: the port's stand-in for
SynthMiddlebury, which is not in the repository."""
from __future__ import annotations

import torch


def make_scenes(n: int, H: int, W: int, generator: torch.Generator,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """n textured RGB all-in-focus images [n, 3, H, W] in [0, 1] and depth maps
    [n, 1, H, W] in metres inside PSFNet's range (0.2-20 m): a tilted plane
    with nearer blobs, and about 3% of pixels at 0 (invalid, masked)."""
    y = torch.linspace(0, 1, H, device=device)[:, None]
    x = torch.linspace(0, 1, W, device=device)[None, :]

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    aif = torch.zeros(n, 3, H, W, device=device)
    for _ in range(8):
        freq = 2 + 80 * rand(n, 1, 1, 1)
        angle = torch.pi * rand(n, 1, 1, 1)
        phase = 2 * torch.pi * rand(n, 1, 1, 1)
        wave = torch.sin(2 * torch.pi * freq * (x * torch.cos(angle)
                                                + y * torch.sin(angle)) + phase)
        aif = aif + rand(n, 3, 1, 1) * wave
    aif = aif + 0.3 * rand(n, 3, H, W)
    lo = aif.amin(dim=(1, 2, 3), keepdim=True)
    hi = aif.amax(dim=(1, 2, 3), keepdim=True)
    aif = (aif - lo) / (hi - lo)

    depth = (0.5 + 6 * rand(n, 1, 1, 1) + 3 * rand(n, 1, 1, 1) * x
             + 3 * rand(n, 1, 1, 1) * y)
    for _ in range(4):
        cy, cx = rand(n, 1, 1, 1), rand(n, 1, 1, 1)
        r = 0.05 + 0.2 * rand(n, 1, 1, 1)
        blob = torch.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * r ** 2))
        depth = depth - 0.8 * depth * rand(n, 1, 1, 1) * blob
    depth = depth.clamp(0.3, 15.0)
    depth = torch.where(rand(n, 1, H, W) < 0.03, torch.zeros_like(depth), depth)
    return aif.contiguous(), depth.contiguous()
