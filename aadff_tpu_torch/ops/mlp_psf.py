"""Tiled PSF MLP: the hand-written CUDA kernel `csrc/mlp_psf.cu`, its
wrapper and its plain PyTorch version.

Replaces the Pallas kernel of `aadff_tpu/ops/pallas_mlp.py` (`_kernel`
:40-55 as launched by `mlp_psf_pallas` :62-116): a flat field [N, 4] =
(x, y, z, foc_z) -> [N, ks*ks] PSF rows, each the sigmoid of the MLP's last
layer divided by its L1 sum + 1e-12.  It is the first stage of the two-stage
render that `PSFNet` takes for frames whose size is not its sensor
resolution; `ops/render.py:local_psf_render` is the second.

`mlp_psf` launches the kernel for CUDA tensors and runs `mlp_psf_reference`
for CPU tensors; there is no fallback from one to the other, nor from one
compute dtype to the other.  Both compute dtypes of the Pallas kernel are
here: f32 (the default) and bf16 (weights and every layer's input rounded
to bf16, products summed in f32).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..psfnet.arch import MLP
from .fused_render import (check_compute_dtype, check_tensor, mlp_reference,
                           packed_weights)

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that the two-stage render went through the kernel), in all and by
# compute dtype ("f32", "bf16").
launches = 0
variant_launches: collections.Counter = collections.Counter()


@torch.no_grad()
def mlp_psf_reference(mlp: MLP, field: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version: the port's MLP forward (a chain of `addmm`), in bf16
    with the Pallas kernel's rounding (`fused_render.mlp_reference`)."""
    return mlp_reference(mlp, field, compute_dtype)


@torch.no_grad()
def mlp_psf(mlp: MLP, field: torch.Tensor,
            compute_dtype=torch.float32) -> torch.Tensor:
    """field [N, 4] f32 -> [N, f] PSF rows, f the MLP's outputs;
    compute_dtype torch.float32 or torch.bfloat16."""
    dt = check_compute_dtype(compute_dtype)
    if field.device.type == "cpu":
        return mlp_psf_reference(mlp, field, compute_dtype)
    if field.device.type != "cuda":
        raise ValueError(f"no PSF MLP kernel for device {field.device}")
    dev = field.device
    N = field.shape[0]
    check_tensor("field", field, (N, 4), dev)
    if not 0 < N < 2 ** 31 - 64:  # the kernel counts rows in int
        raise ValueError(f"field has {N} rows")
    wpack, layout = packed_weights(mlp, compute_dtype)
    check_tensor("weights", wpack, tuple(wpack.shape), dev, compute_dtype)

    from . import _build  # noqa: PLC0415  (builds with nvcc at first use)

    lib = _build.kernels()
    out = torch.empty((N, layout[-4]), dtype=torch.float32, device=dev)
    n_layers = len(layout) // 5
    c_layout = (ctypes.c_int * len(layout))(*layout)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aadff_mlp_psf(field.data_ptr(), wpack.data_ptr(), c_layout,
                               n_layers, out.data_ptr(), N, int(dt == "bf16"),
                               stream)
    if rc != 0:
        raise RuntimeError("mlp_psf kernel launch failed: "
                           + lib.aadff_error_string(rc).decode())
    global launches
    launches += 1
    variant_launches[dt] += 1
    return out
