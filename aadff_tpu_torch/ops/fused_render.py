"""Fused PSF render: the hand-written CUDA kernels
`csrc/fused_psf_render.cu` and, for mode 'convonly', `csrc/psf_conv.cu`,
their wrapper and their plain PyTorch version.

Replaces the Pallas kernel of `aadff_tpu/ops/pallas_render.py` (`_kernel`
:90-192 as launched by `fused_psf_render_stack` :292-366 and
`fused_psf_render` :197-248; host wrappers `fused_render_stack` :369-416 and
`fused_render_frame` :251-287).  For each image n, frame s and pixel it
builds the field (x, y, z, foc_z), runs the PSF MLP to 121 L1-normalised
taps and convolves the edge-padded image with them.

Both compute dtypes of the Pallas kernel are here: f32 (the default) and
bf16, in which every layer's input and every weight is rounded to bf16 and
the products are summed in f32 (`mlp_reference` spells the arithmetic
out).  So are its diagnostic modes, for one frame only as in JAX: 'mlponly'
(the first C taps of the normalised PSF, no convolution), 'convonly' (a PSF
of 0.01 * z on every tap, no MLP) and `pipe` (the MLP as two half-tile
chains; the same result as 'full').

`fused_psf_render` launches the kernel for CUDA tensors and runs
`fused_psf_render_reference` for CPU tensors; there is no fallback from one
to the other, nor from one compute dtype to the other.  The render has no
gradient: the PSF surrogate is frozen and the rendered stack is data.
"""
from __future__ import annotations

import collections
import ctypes
import weakref

import torch

from ..psfnet.arch import MLP
from .render import local_psf_render

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that the main path went through the kernel), in all and by
# variant (`variant`).
launches = 0
variant_launches: collections.Counter = collections.Counter()

COMPUTE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MODES = ("full", "mlponly", "convonly")
CONVONLY_MAX_KS = 15  # csrc/psf_conv.cu's instantiations: odd ks to 15


def check_compute_dtype(compute_dtype) -> str:
    """The name of a compute dtype the kernels take ("f32" or "bf16")."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {compute_dtype}")
    return COMPUTE_DTYPES[compute_dtype]


def variant(compute_dtype, mode: str = "full", pipe: bool = False,
            frames: int = 1) -> str:
    """Name of a launch's variant, as `variant_launches` counts it: a whole
    stack ("stack", S > 1, the TPU's B1) or one frame ("frame", B2), the
    compute dtype, and the mode with "+pipe"; 'convonly' has no MLP, so its
    dtype is not part of its name."""
    dt = "-" if mode == "convonly" else check_compute_dtype(compute_dtype)
    return (f"{'stack' if frames > 1 else 'frame'}/{dt}/{mode}"
            f"{'+pipe' if pipe else ''}")


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


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x.to(compute_dtype).float()


@torch.no_grad()
def mlp_reference(mlp: MLP, x: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """The PSF MLP on rows x [..., 4] -> [..., ks*ks] L1-normalised rows.

    f32: the port's MLP forward.  bf16: the arithmetic of the Pallas
    kernel's bf16 chain (pallas_render.py:137-150, pallas_mlp.py:40-57, and
    of JAX's interpret mode): each layer's input and weight rounded to bf16
    (round to nearest even), products summed in f32 (`addmm` on the rounded
    values), the f32 bias and ReLU; the last layer's output stays f32 for
    the sigmoid and the L1 normalisation."""
    if check_compute_dtype(compute_dtype) == "f32":
        return mlp(x)
    linears = mlp.linears()
    h = x.reshape(-1, x.shape[-1])
    for i, lin in enumerate(linears):
        h = torch.addmm(lin.bias, _round(h, compute_dtype),
                        _round(lin.weight, compute_dtype).t())
        if i + 1 < len(linears):
            h = torch.relu(h)
    p = torch.sigmoid(h).reshape(*x.shape[:-1], -1)
    return p / (p.abs().sum(dim=-1, keepdim=True) + 1e-12)


@torch.no_grad()
def fused_psf_render_reference(mlp: MLP, img: torch.Tensor,
                               depth_mm: torch.Tensor, focus_mm: torch.Tensor,
                               ks: int, d_min: float, d_max: float,
                               compute_dtype=torch.float32, mode: str = "full",
                               pipe: bool = False) -> torch.Tensor:
    """Plain version: field -> MLP -> `local_psf_render`, one frame at a time
    to bound memory.  img [N,C,H,W], depth_mm [N,H,W], focus_mm [N,S] ->
    [N,S,C,H,W].  'mlponly' returns the first C taps of each pixel's PSF;
    'convonly' convolves with 0.01 * z on every tap; `pipe` changes nothing
    here (the kernel's two chains compute what one does)."""
    _check_mode(mode, pipe, focus_mm.shape[-1])
    check_compute_dtype(compute_dtype)
    N, C, H, W = img.shape
    S = focus_mm.shape[1]
    out = img.new_empty(N, S, C, H, W)
    for n in range(N):
        for s in range(S):
            field = psf_field(depth_mm[n:n + 1], focus_mm[n:n + 1, s],
                              d_min, d_max)
            if mode == "convonly":
                psf = (field[..., 2:3] * 0.01).expand(1, H, W, ks * ks)
            else:
                psf = mlp_reference(mlp, field.reshape(-1, 4), compute_dtype)
                psf = psf.reshape(1, H, W, ks * ks)
            if mode == "mlponly":
                out[n, s] = psf[0, :, :, :C].permute(2, 0, 1)
            else:
                out[n, s] = local_psf_render(
                    img[n:n + 1], psf.reshape(1, H, W, ks, ks), ks)[0]
    return out


# The bf16 stage's weight chunks (csrc/mlp_tile.cuh, wg::): 128 rows of 64
# k, K-major, rows of 128 bytes whose 16-byte groups are XOR-swizzled by the
# row index mod 8 (the 128-byte swizzle of the wgmma descriptor).
CHUNK_ROWS, CHUNK_K = 128, 64


def _swizzle_gather() -> torch.Tensor:
    """Position d of a swizzled chunk image holds element [gather[d]] of
    the plain [128, 64] chunk, flattened: the 16-byte group g of row r is
    stored at group g ^ (r % 8) of that row."""
    r = torch.arange(CHUNK_ROWS)[:, None, None]
    g = torch.arange(CHUNK_K // 8)[None, :, None]
    e = torch.arange(8)[None, None, :]
    return (r * CHUNK_K + ((g ^ (r % 8)) * 8) + e).reshape(-1)


def pack_mlp_weights(mlp: MLP, compute_dtype=torch.float32
                     ) -> tuple[torch.Tensor, list[int]]:
    """The kernels' weight layout, in one buffer on the weights' device, and
    [k, f, fpad, w_off, b_off] per layer (offsets in elements of the buffer's
    type, all multiples of 16 bytes); outputs are zero-padded to fpad = 128
    or 256.
      f32:  per layer W^T [k, fpad] then the bias [fpad], an f32 buffer;
      bf16: the weights rounded to bf16 as chunks of 128 output rows x 64 k
            (16 KB), every chunk the swizzled image the wgmma stage reads
            (`_swizzle_gather`): per layer the output halves of 128 rows
            in turn, each as ceil(k / 64) chunks along k; k is zero-padded
            (layer 0's K = 4 to its 64-wide row, of which the kernel reads
            the MMA depth of 16).  The chunks of all layers come first, in
            that order, each layer's at w_off; then each layer's f32 bias
            [fpad] stored bit for bit in 2 * fpad bf16 slots, at b_off."""
    bf16 = check_compute_dtype(compute_dtype) == "bf16"
    chunks, biases, layout, off = [], [], [], 0
    for lin in mlp.linears():
        f, k = lin.weight.shape
        fpad = 128 if f <= 128 else 256
        if f > 256 or k > 256:
            raise ValueError(f"layer {k}->{f} is wider than the kernel's 256")
        b = lin.bias.detach().float().new_zeros(fpad)
        b[:f] = lin.bias.detach()
        if bf16:
            nk = -(-k // CHUNK_K)
            w = lin.weight.new_zeros(fpad, nk * CHUNK_K, dtype=torch.bfloat16)
            w[:f, :k] = lin.weight.detach()
            w = (w.reshape(fpad // CHUNK_ROWS, CHUNK_ROWS, nk, CHUNK_K)
                 .permute(0, 2, 1, 3).reshape(-1, CHUNK_ROWS * CHUNK_K))
            w = w[:, _swizzle_gather().to(w.device)]
            layout += [k, f, fpad, off, None]
            chunks.append(w.reshape(-1))
            biases.append(b.view(torch.bfloat16))
            off += w.numel()
        else:
            w = lin.weight.new_zeros(k, fpad)
            w[:, :f] = lin.weight.detach().t()
            layout += [k, f, fpad, off, off + w.numel()]
            chunks += [w.reshape(-1), b]
            off += w.numel() + b.numel()
    if bf16:
        for i, b in enumerate(biases):
            layout[5 * i + 4] = off
            off += b.numel()
        chunks += biases
    return torch.cat(chunks).contiguous(), layout


# The packs of each MLP, by compute dtype, with the parameters' storage and
# version counters they were made from: a launch repacks only after the
# weights were replaced or changed in place.
_packs: "weakref.WeakKeyDictionary[MLP, dict]" = weakref.WeakKeyDictionary()


def packed_weights(mlp: MLP, compute_dtype) -> tuple[torch.Tensor, list[int]]:
    """`pack_mlp_weights(mlp, compute_dtype)`, made once per state of the
    weights."""
    stamp = tuple((p.data_ptr(), p.device, p._version)
                  for p in mlp.parameters())
    packs = _packs.setdefault(mlp, {})
    if compute_dtype not in packs or packs[compute_dtype][0] != stamp:
        packs[compute_dtype] = (stamp, *pack_mlp_weights(mlp, compute_dtype))
    return packs[compute_dtype][1:]


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device, dtype=torch.float32):
    """Raise unless t is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_mode(mode: str, pipe: bool, frames: int):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if (mode != "full" or pipe) and frames != 1:
        raise ValueError(f"mode={mode!r}, pipe={pipe} render one frame "
                         f"(S = 1), as the JAX kernel's frame launch; got "
                         f"S = {frames}")


@torch.no_grad()
def fused_psf_render(mlp: MLP, img: torch.Tensor, depth_mm: torch.Tensor,
                     focus_mm: torch.Tensor, ks: int, d_min: float,
                     d_max: float, compute_dtype=torch.float32,
                     mode: str = "full", pipe: bool = False) -> torch.Tensor:
    """Render every frame of a focal stack.

    img [N, C, H, W]; depth_mm [N, H, W] and focus_mm [N, S] in the PSF
    surrogate's units (negative mm); the MLP's last layer has ks*ks outputs.
    compute_dtype torch.float32 or torch.bfloat16 (the MLP's arithmetic);
    mode 'full', 'mlponly' or 'convonly' and pipe, the diagnostic knobs of
    the JAX kernel, take S = 1 only.  Returns [N, S, C, H, W] f32.  A
    one-frame render is S = 1.
    """
    N, C, H, W = img.shape
    S = focus_mm.shape[-1]
    _check_mode(mode, pipe, S)
    dt = check_compute_dtype(compute_dtype)
    if img.device.type == "cpu":
        return fused_psf_render_reference(mlp, img, depth_mm, focus_mm, ks,
                                          d_min, d_max, compute_dtype, mode,
                                          pipe)
    if img.device.type != "cuda":
        raise ValueError(f"no fused render for device {img.device}")
    dev = img.device
    check_tensor("img", img, (N, C, H, W), dev)
    check_tensor("depth_mm", depth_mm, (N, H, W), dev)
    check_tensor("focus_mm", focus_mm, (N, S), dev)
    if mode == "convonly":  # no MLP: the kernel reads no weights
        if ks > CONVONLY_MAX_KS:
            raise ValueError(f"mode='convonly' takes an odd ks up to "
                             f"{CONVONLY_MAX_KS}, got {ks}")
        wptr, c_layout, n_layers = None, None, 0
    else:
        wpack, layout = packed_weights(mlp, compute_dtype)
        check_tensor("weights", wpack, tuple(wpack.shape), dev, compute_dtype)
        if layout[-4] != ks * ks:
            raise ValueError(f"MLP has {layout[-4]} outputs, expected {ks * ks}")
        wptr, n_layers = wpack.data_ptr(), len(layout) // 5
        c_layout = (ctypes.c_int * len(layout))(*layout)

    from . import _build  # noqa: PLC0415  (builds with nvcc at first use)

    lib = _build.kernels()
    out = torch.empty((N, S, C, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aadff_fused_psf_render(
            img.data_ptr(), depth_mm.data_ptr(), focus_mm.data_ptr(),
            wptr, c_layout, n_layers, out.data_ptr(),
            N, S, C, H, W, ks, float(d_min), float(d_max), int(dt == "bf16"),
            MODES.index(mode), int(bool(pipe)), stream)
    if rc != 0:
        raise RuntimeError("fused_psf_render kernel launch failed: "
                           + lib.aadff_error_string(rc).decode())
    global launches
    launches += 1
    variant_launches[variant(compute_dtype, mode, pipe, S)] += 1
    return out
