"""Fused PSF render: the hand-written CUDA kernel
`csrc/fused_psf_render.cu`, its wrapper and its plain PyTorch version.

Replaces the Pallas kernel of `aadff_tpu/ops/pallas_render.py` (`_kernel`
:90-192 as launched by `fused_psf_render_stack` :292-366 and
`fused_psf_render` :197-248; host wrappers `fused_render_stack` :369-416 and
`fused_render_frame` :251-287).  For each image n, frame s and pixel it
builds the field (x, y, z, foc_z), runs the PSF MLP to 121 L1-normalised
taps and convolves the edge-padded image with them.

`fused_psf_render` launches the kernel for CUDA tensors and runs
`fused_psf_render_reference` for CPU tensors; there is no fallback from one
to the other.  The render has no gradient: the PSF surrogate is frozen and
the rendered stack is data.
"""
from __future__ import annotations

import ctypes

import torch

from ..psfnet.arch import MLP
from .render import local_psf_render

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that the main path went through the kernel).
launches = 0


def jax_linspace(start: float, stop: float, num: int,
                 device=None) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in f32 with its rounding:
    start * (1 - i/div) + stop * i/div, the last element exactly `stop`."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def psf_field(depth_mm: torch.Tensor, foc_mm: torch.Tensor, d_min: float,
              d_max: float) -> torch.Tensor:
    """depth_mm [N, H, W], foc_mm [N] -> field [N, H, W, 4] = (x, y, z, foc_z),
    z and foc_z normalised over [d_min, d_max] and clipped to [0, 1]."""
    N, H, W = depth_mm.shape
    dev = depth_mm.device
    x = jax_linspace(-1.0, 1.0, W, dev)[None, None, :].expand(N, H, W)
    y = jax_linspace(1.0, -1.0, H, dev)[None, :, None].expand(N, H, W)
    z = ((depth_mm - d_min) / (d_max - d_min)).clamp(0.0, 1.0)
    fz = ((foc_mm - d_min) / (d_max - d_min)).clamp(0.0, 1.0)
    return torch.stack([x, y, z, fz[:, None, None].expand(N, H, W)], dim=-1)


@torch.no_grad()
def fused_psf_render_reference(mlp: MLP, img: torch.Tensor,
                               depth_mm: torch.Tensor, focus_mm: torch.Tensor,
                               ks: int, d_min: float,
                               d_max: float) -> torch.Tensor:
    """Plain version: field -> MLP -> `local_psf_render`, one frame at a time
    to bound memory.  img [N,C,H,W], depth_mm [N,H,W], focus_mm [N,S] ->
    [N,S,C,H,W]."""
    N, C, H, W = img.shape
    S = focus_mm.shape[1]
    out = img.new_empty(N, S, C, H, W)
    for n in range(N):
        for s in range(S):
            field = psf_field(depth_mm[n:n + 1], focus_mm[n:n + 1, s],
                              d_min, d_max)
            psf = mlp(field.reshape(-1, 4)).reshape(1, H, W, ks, ks)
            out[n, s] = local_psf_render(img[n:n + 1], psf, ks)[0]
    return out


def pack_mlp_weights(mlp: MLP) -> tuple[torch.Tensor, list[int]]:
    """The kernel's weight layout: per layer W^T [k, fpad] then bias [fpad],
    outputs zero-padded to fpad = 128 or 256, all in one f32 buffer on the
    weights' device.  Returns (buffer, [k, f, fpad, w_off, b_off] * layers)."""
    chunks, layout, off = [], [], 0
    for lin in mlp.linears():
        f, k = lin.weight.shape
        fpad = 128 if f <= 128 else 256
        if f > 256 or k > 256:
            raise ValueError(f"layer {k}->{f} is wider than the kernel's 256")
        wt = lin.weight.new_zeros(k, fpad)
        wt[:, :f] = lin.weight.detach().t()
        b = lin.bias.new_zeros(fpad)
        b[:f] = lin.bias.detach()
        layout += [k, f, fpad, off, off + k * fpad]
        chunks += [wt.reshape(-1), b]
        off += k * fpad + fpad
    return torch.cat(chunks).float().contiguous(), layout


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device):
    """Raise unless t is a contiguous f32 tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@torch.no_grad()
def fused_psf_render(mlp: MLP, img: torch.Tensor, depth_mm: torch.Tensor,
                     focus_mm: torch.Tensor, ks: int, d_min: float,
                     d_max: float) -> torch.Tensor:
    """Render every frame of a focal stack.

    img [N, C, H, W]; depth_mm [N, H, W] and focus_mm [N, S] in the PSF
    surrogate's units (negative mm); the MLP's last layer has ks*ks outputs.
    Returns [N, S, C, H, W] f32.  A one-frame render is S = 1.
    """
    N, C, H, W = img.shape
    S = focus_mm.shape[-1]
    if img.device.type == "cpu":
        return fused_psf_render_reference(mlp, img, depth_mm, focus_mm, ks,
                                          d_min, d_max)
    if img.device.type != "cuda":
        raise ValueError(f"no fused render for device {img.device}")
    dev = img.device
    check_tensor("img", img, (N, C, H, W), dev)
    check_tensor("depth_mm", depth_mm, (N, H, W), dev)
    check_tensor("focus_mm", focus_mm, (N, S), dev)
    wpack, layout = pack_mlp_weights(mlp)
    check_tensor("weights", wpack, tuple(wpack.shape), dev)
    if layout[-4] != ks * ks:
        raise ValueError(f"MLP has {layout[-4]} outputs, expected {ks * ks}")

    from . import _build  # noqa: PLC0415  (builds with nvcc at first use)

    lib = _build.kernels()
    out = torch.empty((N, S, C, H, W), dtype=torch.float32, device=dev)
    n_layers = len(layout) // 5
    c_layout = (ctypes.c_int * len(layout))(*layout)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aadff_fused_psf_render(
            img.data_ptr(), depth_mm.data_ptr(), focus_mm.data_ptr(),
            wpack.data_ptr(), c_layout, n_layers, out.data_ptr(),
            N, S, C, H, W, ks, float(d_min), float(d_max), stream)
    if rc != 0:
        raise RuntimeError("fused_psf_render kernel launch failed: "
                           + lib.aadff_error_string(rc).decode())
    global launches
    launches += 1
    return out
