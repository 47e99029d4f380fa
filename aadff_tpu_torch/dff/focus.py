"""Focus-distance selection for focal-stack synthesis (the port of
`aadff_tpu/dff/focus.py:11-45`)."""
from __future__ import annotations

import torch


def select_focus_dist(depth: torch.Tensor, num: int, mode: str = "linear",
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """depth [B, 1, H, W] (> 0 valid) -> sorted focus distances, on depth's
    device.

    'linear' spaces `num` distances evenly over [min, max] of the valid
    depths.  'importance' keeps max and min and adds rejection-sampled
    distances until it holds num - 2 of them, as the reference does (its
    `target = num - 2` quirk, PARITY.md:57-61); its draws come from
    `generator`, a CPU generator, on the host.
    """
    if num <= 3:
        raise ValueError("Focal stack size is too small")
    mask = depth > 0
    avg_depth = depth.sum(dim=(1, 2, 3)) / mask.sum(dim=(1, 2, 3))
    depth_max = depth.amax(dim=(1, 2, 3))
    depth_min = torch.where(mask, depth, torch.inf).amin(dim=(1, 2, 3))

    if mode == "linear":
        focus = [depth_min + i * (depth_max - depth_min) / (num - 1)
                 for i in range(num)]
    elif mode == "importance":
        dmax, dmin, avg = depth_max.cpu(), depth_min.cpu(), avg_depth.cpu()
        focus = [dmax, dmin]
        while len(focus) < num - 2:
            fd = torch.rand((), generator=generator) * (dmax - dmin) + dmin
            accept_rate = torch.where(fd > avg, (dmax - fd) / (dmax - avg),
                                      (fd - dmin) / (avg - dmin))
            if torch.rand((), generator=generator) < accept_rate.mean():
                focus.append(fd)
        focus = [f.to(depth.device) for f in focus]
    else:
        raise NotImplementedError(mode)
    return torch.sort(torch.stack(focus, dim=1), dim=-1).values
