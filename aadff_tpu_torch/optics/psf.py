"""PSF computation: pupil-sampled ray tracing and Monte-Carlo rasterisation
(the port of `aadff_tpu/optics/psf.py`).

The bilinear splat of ray hits is a dense contraction, as in the JAX
package: each ray's footprint along rows and columns is a hat function
`max(0, 1 - |p - i|)` on the kernel grid, and the PSF is
`einsum('snr,snc->nrc', W_row * ra, W_col)`, a batched matmul with no
scatter.  JAX contracts at precision 'highest'; here every contraction runs
under `full_f32()`, which turns TF32 off for its duration whatever the
process's flags say.  No Pallas kernel lies on this path, so there is no
CUDA kernel here either: the trace is elementwise PyTorch and the
rasteriser a cuBLAS batched matmul.

Random draws enter `psf_impl` as tensors (`PsfDraws`): JAX's random
streams cannot be reproduced in torch, so the tests draw the numbers with
`jax.random` under JAX's own key splits and hand them to both packages.
`draw_psf` makes them from a `torch.Generator`.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import DEFAULT_WAVE, DEPTH, EPSILON, GEO_SPP, WAVE_RGB
from .lens import trace_rays, uniform
from .rays import RayBundle, make_rays, propagate_to


@contextlib.contextmanager
def full_f32():
    """Full-f32 matmuls (no TF32) inside the block, the previous setting
    restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# --------------------------------------------------------------------------
# Rasterisation
# --------------------------------------------------------------------------
def hat_weights(pif, ks: int):
    """Bilinear footprint of float index `pif` [...] on grid 0..ks-1 -> [..., ks]."""
    grid = torch.arange(ks, dtype=pif.dtype, device=pif.device)
    return torch.clamp(1.0 - torch.abs(pif[..., None] - grid), min=0.0)


def assign_points_to_pixels(points, ks: int, x_range, y_range, ra,
                            coherent: bool = False, phase=None):
    """Splat points [spp, 2] into a [ks, ks] grid with bilinear weights."""
    x_min, x_max = x_range
    y_min, y_max = y_range
    row = (points[..., 1] - y_max) / (y_min - y_max) * (ks - 1)
    col = (points[..., 0] - x_min) / (x_max - x_min) * (ks - 1)
    wr = hat_weights(row, ks)  # [spp, ks]
    wc = hat_weights(col, ks)
    with full_f32():
        if coherent:
            amp = ra * torch.exp(1j * phase)
            return torch.einsum("sr,sc->rc", wr * amp[..., None], wc.to(amp.dtype))
        return torch.einsum("sr,sc->rc", wr * ra[..., None], wc)


def forward_integral(ray: RayBundle, ps: float, ks: int, pointc_ref=None):
    """Monte-Carlo PSF integral: ray.o [spp, N, 3] (or [spp, 3]) ->
    [N, ks, ks] (or [ks, ks]), all points in one batched contraction."""
    single_point = ray.o.dim() == 2
    points = -ray.o[..., :2]
    psf_range = ((-ks / 2 + 0.5) * ps, (ks / 2 - 0.5) * ps)

    if pointc_ref is None:
        pointc = torch.sum(points * ray.ra[..., None], dim=0) / (
            torch.sum(ray.ra[..., None], dim=0) + EPSILON
        )
        points_shift = points - pointc
    else:
        points_shift = points - pointc_ref

    ra = (
        ray.ra
        * (torch.abs(points_shift[..., 0]) < (psf_range[1] - 0.01 * ps))
        * (torch.abs(points_shift[..., 1]) < (psf_range[1] - 0.01 * ps))
    )
    points_shift = points_shift * ra[..., None]

    row = (points_shift[..., 1] - psf_range[1]) / (psf_range[0] - psf_range[1]) * (ks - 1)
    col = (points_shift[..., 0] - psf_range[0]) / (psf_range[1] - psf_range[0]) * (ks - 1)
    wr = hat_weights(row, ks)  # [spp, N, ks] or [spp, ks]
    wc = hat_weights(col, ks)
    with full_f32():
        if single_point:
            return torch.einsum("sr,sc->rc", wr * ra[..., None], wc)
        return torch.einsum("snr,snc->nrc", wr * ra[..., None], wc)


# --------------------------------------------------------------------------
# Point grids
# --------------------------------------------------------------------------
def point_source_grid(depth, grid=9, normalized=True, quater=False, center=False,
                      scale=1.0, sensor_size=None):
    if grid == 1:
        x = y = np.asarray([[0.0]], np.float32)
        if quater:
            raise ValueError("quater needs grid > 1")
    elif center:
        half_bin = 1 / 2 / (grid - 1)
        x, y = np.meshgrid(
            np.linspace(-1 + half_bin, 1 - half_bin, grid),
            np.linspace(1 - half_bin, -1 + half_bin, grid),
            indexing="xy",
        )
    else:
        x, y = np.meshgrid(
            np.linspace(-0.98, 0.98, grid),
            np.linspace(0.98, -0.98, grid),
            indexing="xy",
        )
    z = np.full((grid, grid), depth, np.float32)
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    if quater:
        bi = grid // 2 if grid % 2 == 0 else grid // 2 + 1
        pts = pts[0:bi, grid // 2 :, :]
    if not normalized:
        pts[..., 0] *= scale * sensor_size[0] / 2
        pts[..., 1] *= scale * sensor_size[1] / 2
    return pts


def point_source_radial(depth, grid=9, center=False):
    if grid == 1:
        x = np.asarray([0.0], np.float32)
    elif center:
        half_bin = 1 / 2 / (grid - 1)
        x = np.linspace(0, 1 - half_bin, grid, dtype=np.float32)
    else:
        x = np.linspace(0, 0.98, grid, dtype=np.float32)
    z = np.full_like(x, depth)
    return np.stack([x, x, z], axis=-1)


# --------------------------------------------------------------------------
# The PSF pipeline
# --------------------------------------------------------------------------
class PsfDraws(NamedTuple):
    """The uniforms of one `psf_impl` call: pupil angle and radius of the
    main bundle [spp] and of the chief bundle [GEO_SPP].  Each may also be
    [spp, N] (one column per point), which batches several calls."""

    theta: torch.Tensor
    r: torch.Tensor
    chief_theta: torch.Tensor
    chief_r: torch.Tensor


def draw_psf(spp: int, generator: torch.Generator, device, n_calls=None):
    """PsfDraws from `generator`: [spp] and [GEO_SPP], or with `n_calls`
    [spp, n_calls] and [GEO_SPP, n_calls] (one set per call)."""
    tail = () if n_calls is None else (n_calls,)
    return PsfDraws(*(uniform((n,) + tail, generator, device)
                      for n in (spp, spp, GEO_SPP, GEO_SPP)))


def trace_from_points(params, metas, point_obj, u_theta, u_r, pupil_r, pupilz,
                      d_sensor, wvln, lens_range) -> RayBundle:
    """Rays from object points [N, 3] (mm) through pupil samples (uniforms
    u_theta, u_r: [n] shared by the points, or [n, N]; the pupil's radius
    and z) through the lens to the sensor plane: [n, N] rays.

    Each ray's direction is normalised in float64 and the ray starts on
    the plane of the first vertex, moved there in float64: in f32, o + t d
    from an object metres away keeps only ~1e-4 mm of the hit point (1 ulp
    of |o_z|), and an f32 direction bends it by a few 1e-6 mm more.  JAX
    keeps more of it through XLA's fused multiply-add; this start keeps
    more still (tests/test_torch_psf.py compares both with a float64
    trace)."""
    n_rays = u_theta.shape[0]
    if u_theta.dim() == 1:
        u_theta, u_r = u_theta[:, None], u_r[:, None]
    theta = u_theta * 2 * np.pi
    r = torch.sqrt(u_r * pupil_r**2)
    o2 = torch.stack(torch.broadcast_tensors(
        r * torch.cos(theta), r * torch.sin(theta), pupilz), dim=-1)
    o = torch.broadcast_to(point_obj[None], (n_rays,) + tuple(point_obj.shape))
    o64 = o.double()
    d64 = o2.double() - o64
    d64 = d64 / torch.linalg.vector_norm(d64, dim=-1, keepdim=True)
    t = (params[lens_range[0]].d.double() - o64[..., 2]) / d64[..., 2]
    ray = make_rays(o64 + d64 * t[..., None], d64, normalize=False)
    ray, _ = trace_rays(ray, params, metas, wvln, True, False, lens_range, False)
    return propagate_to(ray, d_sensor)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def psf_rays(params, metas, points, draws: PsfDraws, wvln, center, lens_range,
             d_sensor, pupilz, pupilr, hfov, r_last, sensor_w, sensor_h):
    """The rays of `psf_impl` on the sensor: (pupil rays [spp, N], chief
    rays [GEO_SPP, N] through the half pupil, or None when `center` is
    False).  A ray's `ra` is 0 where the lens cut it."""
    device = points.device
    d_sensor, pupilz, pupilr, hfov, r_last, sensor_w, sensor_h = (
        _f32(x, device) for x in (d_sensor, pupilz, pupilr, hfov, r_last,
                                  sensor_w, sensor_h))
    depth = points[:, 2]
    scale = -depth * torch.tan(hfov) / r_last
    point_obj = torch.stack(
        [
            points[:, 0] * scale * sensor_w / 2,
            points[:, 1] * scale * sensor_h / 2,
            depth,
        ],
        dim=-1,
    )

    def sample_and_trace(u_theta, u_r, pupil_r):
        return trace_from_points(params, metas, point_obj, u_theta, u_r, pupil_r,
                                 pupilz, d_sensor, wvln, lens_range)

    ray = sample_and_trace(draws.theta, draws.r, pupilr)
    chief = (sample_and_trace(draws.chief_theta, draws.chief_r, pupilr * 0.5)
             if center else None)
    return ray, chief


def psf_centre(chief, points, sensor_w, sensor_h):
    """Each PSF's centre on the sensor [N, 2]: the centroid of the kept
    chief rays of `psf_rays`, or, with `chief` None, the point's
    perspective position."""
    if chief is not None:
        pc = torch.sum(chief.o * chief.ra[..., None], dim=0) / (
            torch.sum(chief.ra[..., None], dim=0) + EPSILON
        )
        return -pc[..., :2]
    sensor_w, sensor_h = (_f32(x, points.device) for x in (sensor_w, sensor_h))
    return torch.stack(
        [points[:, 0] * sensor_w / 2, points[:, 1] * sensor_h / 2], dim=-1
    )


def psf_from_rays(ray, centre, ks, pixel_size):
    """Rasterise the rays of `psf_rays` into PSFs [N, ks, ks] around
    `centre` [N, 2], each summing to 1 (or 0 where no ray lands)."""
    pixel_size = _f32(pixel_size, ray.o.device)
    psf = forward_integral(ray, ps=pixel_size, ks=ks, pointc_ref=centre)
    # Guarded normalisation: where every ray misses the window or the
    # aperture the sum is 0, and an all-zero kernel is the answer.
    return psf / torch.clamp(torch.sum(psf, dim=(-1, -2), keepdim=True),
                             min=EPSILON)


def psf_impl(params, metas, points, draws: PsfDraws, ks, wvln, center,
             lens_range, d_sensor, pupilz, pupilr, hfov, r_last, sensor_w,
             sensor_h, pixel_size):
    """points [N, 3] normalised (x, y in [-1, 1], z < 0 in mm) -> PSFs
    [N, ks, ks], each summing to 1 (or 0 where no ray lands): `psf_rays`,
    `psf_centre`, then `psf_from_rays`.

    The lens scalars are numbers or tensors that broadcast against [N]
    (per-point focus states batch several calls); they are taken in f32,
    as JAX takes them.  Pupil draws of shape [n] are shared by every
    point, as in JAX's call; of shape [n, N] each point has its own."""
    ray, chief = psf_rays(params, metas, points, draws, wvln, center,
                          lens_range, d_sensor, pupilz, pupilr, hfov, r_last,
                          sensor_w, sensor_h)
    return psf_from_rays(ray, psf_centre(chief, points, sensor_w, sensor_h), ks,
                         pixel_size)


def lens_scalars(lens):
    """(d_sensor, pupilz, pupilr, hfov, r_last, sensor_w, sensor_h,
    pixel_size) of the lens's current focus state, the trailing arguments
    of `psf_impl`."""
    pupilz, pupilr = lens.entrance_pupil()
    return (lens.d_sensor, pupilz, pupilr, lens.hfov, lens.r_last,
            lens.sensor_size[1], lens.sensor_size[0], lens.pixel_size)


def lens_psf(lens, points, ks=31, wvln=DEFAULT_WAVE, spp=GEO_SPP, center=True,
             generator=None, draws=None):
    """[N, 3] normalised points -> [N, ks, ks] PSFs ([3] -> [ks, ks]), at
    the lens's current focus.  `draws` defaults to `draw_psf` from
    `generator` (default: the lens's)."""
    points = torch.as_tensor(points, dtype=torch.float32, device=lens.device)
    single = points.dim() == 1
    if single:
        points = points[None]
    if draws is None:
        draws = draw_psf(spp, lens._gen(generator), lens.device)
    psf = psf_impl(lens.params, lens.metas, points, draws, int(ks), float(wvln),
                   bool(center), tuple(range(len(lens.metas))),
                   *lens_scalars(lens))
    return psf[0] if single else psf


def lens_psf_rgb(lens, points, ks=31, spp=GEO_SPP, center=True, generator=None):
    """[N, 3] -> [N, 3, ks, ks] RGB PSF, one set of draws per wavelength."""
    psfs = [
        lens_psf(lens, points, ks=ks, wvln=w, spp=spp, center=center,
                 generator=generator)
        for w in WAVE_RGB
    ]
    return torch.stack(psfs, dim=-3)


def make_grid_psf(psfs, nrow: int):
    """[N, C, ks, ks] -> [C, rows*ks, nrow*ks] tiling (torchvision.make_grid
    with padding=0)."""
    n, c, ks, _ = psfs.shape
    ncol = nrow
    nrows = int(math.ceil(n / ncol))
    pad = nrows * ncol - n
    if pad:
        psfs = torch.cat([psfs, psfs.new_zeros((pad, c, ks, ks))])
    psfs = psfs.reshape(nrows, ncol, c, ks, ks)
    psfs = psfs.permute(2, 0, 3, 1, 4)
    return psfs.reshape(c, nrows * ks, ncol * ks)


def lens_psf_map(lens, depth=None, grid=7, ks=51, spp=GEO_SPP, center=True,
                 generator=None):
    """RGB PSF map [3, grid*ks, grid*ks]."""
    depth = DEPTH if depth is None else depth
    pts = point_source_grid(depth=depth, grid=grid).reshape(-1, 3)
    psfs = lens_psf_rgb(lens, pts, ks=ks, spp=spp, center=center,
                        generator=generator)
    return make_grid_psf(psfs, nrow=grid)


def psf2mtf(psf, pixel_size: float):
    """PSF -> (freq, tangential MTF, sagittal MTF), in numpy."""
    psf = psf.detach().cpu().numpy() if torch.is_tensor(psf) else np.asarray(psf)
    cy, cx = psf.shape[0] // 2, psf.shape[1] // 2
    sagittal = psf[cy, :]
    tangential = psf[:, cx]
    mtf_s = np.abs(np.fft.fft(sagittal))
    mtf_t = np.abs(np.fft.fft(tangential))
    mtf_s /= mtf_s.max()
    mtf_t /= mtf_t.max()
    freq = np.fft.fftfreq(psf.shape[0], pixel_size)
    pos = freq > 0
    return freq[pos], mtf_t[pos], mtf_s[pos]
