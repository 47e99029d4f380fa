"""Optical surface math: sag, Newton intersection, Snell refraction (the
port of `aadff_tpu/optics/surfaces.py`).

One parameter tuple (`SurfaceParams`, tensors that may require grad) and a
static `SurfaceMeta` cover the three surface kinds (flat/stop, spheric,
aspheric).  Newton's method runs its fixed iterations under
`torch.no_grad()` and then one step that carries the gradient: the
detach/re-attach of the JAX package (`surfaces.py:155-178`).

All math is float32 and mask-based (invalid rays keep their old state).
Every expression keeps the JAX package's order of operations and its split
between host floats and tensors, so that both round alike.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..constants import EPSILON
from .materials import Material
from .rays import RayBundle

NEWTONS_MAXITER = 10
NEWTONS_TOLERANCE_TIGHT = 10e-6  # [mm]
NEWTONS_TOLERANCE_LOOSE = 50e-6  # [mm]
NEWTONS_STEP_BOUND = 5.0  # [mm]

MAX_AI_TERMS = 8  # even-asphere coefficients ai2 .. ai16


class SurfaceParams(NamedTuple):
    """Differentiable per-surface parameters: 0-d f32 tensors and ai [8]."""

    c: torch.Tensor  # curvature 1/roc
    d: torch.Tensor  # z position of the vertex [mm]
    k: torch.Tensor  # conic constant
    ai: torch.Tensor  # [MAX_AI_TERMS] even asphere coeffs (zero padded)


@dataclasses.dataclass(frozen=True)
class SurfaceMeta:
    """Static surface description."""

    kind: str  # 'stop' | 'spheric' | 'aspheric'
    r: float  # clear aperture radius [mm]
    mat1: Material
    mat2: Material
    ai_degree: int
    k_gt_neg1: bool  # static sign info for the validity boundary
    is_square: bool = False

    def eta(self, wvln: float, forward: bool) -> float:
        n1, n2 = self.mat1.ior(wvln), self.mat2.ior(wvln)
        return (n1 / n2) if forward else (n2 / n1)

    def index_before(self, wvln: float, forward: bool) -> float:
        return self.mat1.ior(wvln) if forward else self.mat2.ior(wvln)


def make_surface(kind: str, r: float, d: float, c: float = 0.0, k: float = 0.0,
                 ai: Optional[Sequence[float]] = None, mat1: str = "air",
                 mat2: str = "air", device=None):
    """Construct (params, meta) for one surface."""
    ai = list(ai) if ai is not None else []
    ai_pad = np.zeros(MAX_AI_TERMS, np.float32)
    ai_pad[: len(ai)] = ai

    def scalar(x):
        return torch.tensor(np.float32(x), dtype=torch.float32, device=device)

    params = SurfaceParams(c=scalar(c), d=scalar(d), k=scalar(k),
                           ai=torch.from_numpy(ai_pad).to(device))
    meta = SurfaceMeta(
        kind=kind,
        r=float(r),
        mat1=Material.create(mat1),
        mat2=Material.create(mat2),
        ai_degree=len(ai),
        k_gt_neg1=k > -1,
    )
    return params, meta


# --------------------------------------------------------------------------
# Sag and derivatives
# --------------------------------------------------------------------------
def sag_r2(r2, p: SurfaceParams, ai_degree: int):
    """z(r^2): conic base + even polynomial."""
    base = r2 * p.c / (1 + torch.sqrt(1 - (1 + p.k) * r2 * p.c**2))
    poly = torch.zeros_like(r2)
    for i in reversed(range(ai_degree)):
        poly = (poly + p.ai[i]) * r2
    return base + poly


def dsag_dr2(r2, p: SurfaceParams, ai_degree: int):
    """d z / d r^2."""
    sf = torch.sqrt(1 - (1 + p.k) * r2 * p.c**2)
    ds = (1 + sf + (1 + p.k) * r2 * p.c**2 / 2 / sf) * p.c / (1 + sf) ** 2
    poly = torch.zeros_like(r2)
    for i in reversed(range(ai_degree)):
        poly = poly * r2 + (i + 1) * p.ai[i]
    return ds + poly


def valid_tight(x, y, p: SurfaceParams, meta: SurfaceMeta):
    """The ray lands inside the defined, clear part of the surface."""
    r2 = x**2 + y**2
    inside = r2 < meta.r**2
    if meta.k_gt_neg1:
        inside = inside & (r2 < (1 - EPSILON) / p.c**2 / (1 + p.k))
    return inside


def valid_loose(x, y, p: SurfaceParams, meta: SurfaceMeta):
    """The surface's shape is mathematically defined there."""
    r2 = x**2 + y**2
    if meta.k_gt_neg1:
        return r2 < (1 - EPSILON) / p.c**2 / (1 + p.k)
    return r2 > 0


# --------------------------------------------------------------------------
# Newton intersection
# --------------------------------------------------------------------------
def newtons_method(ray: RayBundle, p: SurfaceParams, meta: SurfaceMeta):
    """Intersect rays with the surface; returns (valid, t).

    NEWTONS_MAXITER iterations without gradient, then one update that
    carries it (`surfaces.py:155-178`): the gradient reaches t only through
    t0 and that last step, and autograd keeps none of the iterations.
    """
    ox, oy, oz = ray.o[..., 0], ray.o[..., 1], ray.o[..., 2]
    dx, dy, dz = ray.d[..., 0], ray.d[..., 1], ray.d[..., 2]
    t0 = (p.d - oz) / dz

    def ft_dfdt(t, tight):
        new_o = ray.o + ray.d * t[..., None]
        nx, ny = new_o[..., 0], new_o[..., 1]
        if tight:
            valid = valid_tight(nx, ny, p, meta) & (ray.ra > 0)
        else:
            valid = valid_loose(nx, ny, p, meta) & (ray.ra > 0)
        vm = valid.to(nx.dtype)
        xm, ym = nx * vm, ny * vm
        r2 = xm**2 + ym**2
        ft = sag_r2(r2, p, meta.ai_degree) + p.d - new_o[..., 2]
        dr2dt = 2 * ((dx**2 + dy**2) * t + (dx * ox + dy * oy))
        dfdt = dsag_dr2(r2, p, meta.ai_degree) * dr2dt - dz
        return ft, dfdt

    with torch.no_grad():
        t = t0
        for _ in range(NEWTONS_MAXITER):
            ft, dfdt = ft_dfdt(t, tight=False)
            t = t - torch.clamp(ft / (dfdt + EPSILON), -NEWTONS_STEP_BOUND,
                                NEWTONS_STEP_BOUND)
        t1 = t - t0

    # one more iteration to regain the gradient
    t = t0 + t1
    ft, dfdt = ft_dfdt(t, tight=True)
    t = t - torch.clamp(ft / (dfdt + EPSILON), -NEWTONS_STEP_BOUND,
                        NEWTONS_STEP_BOUND)

    # validity: inside the clear aperture, converged, not travelling backwards
    with torch.no_grad():
        new_o = ray.o + ray.d * t[..., None]
        valid = (
            valid_tight(new_o[..., 0], new_o[..., 1], p, meta)
            & (torch.abs(ft) < NEWTONS_TOLERANCE_TIGHT)
            & (ray.ra > 0)
            & (t > 0)
        )
    return valid, t


# --------------------------------------------------------------------------
# Surface normal
# --------------------------------------------------------------------------
def surface_normal(ray: RayBundle, p: SurfaceParams, meta: SurfaceMeta):
    x, y, z = ray.o[..., 0], ray.o[..., 1], ray.o[..., 2]
    if meta.kind == "stop":
        return torch.stack(
            [torch.zeros_like(x), torch.zeros_like(y), -torch.ones_like(z)], dim=-1)
    if meta.kind == "spheric":
        R = 1 / p.c
        sgn = torch.sign(p.c)
        nx = sgn * 2 * x
        ny = sgn * 2 * y
        nz = sgn * (2 * z - 2 * (p.d + R))
        n = torch.stack([nx, ny, nz], dim=-1)
    else:  # aspheric
        vm = (ray.ra > 0).to(x.dtype)
        xm, ym = x * vm, y * vm
        r2 = xm**2 + ym**2
        ds = dsag_dr2(r2, p, meta.ai_degree)
        n = torch.stack([ds * 2 * xm, ds * 2 * ym, -torch.ones_like(x)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


# --------------------------------------------------------------------------
# Snell refraction
# --------------------------------------------------------------------------
def refract(ray: RayBundle, p: SurfaceParams, meta: SurfaceMeta, eta: float,
            forward: bool) -> RayBundle:
    n = surface_normal(ray, p, meta)
    if forward:
        n = -n

    cosi = torch.sum(ray.d * n, dim=-1)
    valid = (cosi**2 > 0.1) & (eta**2 * (1 - cosi**2) < 1) & (ray.ra > 0)
    vm = valid.to(cosi.dtype)

    sr = torch.sqrt(1 - eta**2 * (1 - cosi[..., None] ** 2) * vm[..., None])
    new_d = sr * n + eta * (ray.d - cosi[..., None] * n)
    new_d = torch.where(valid[..., None], new_d, ray.d)

    old_d = ray.d.detach()
    obliq = ray.obliq * torch.sum(new_d * old_d, dim=-1)
    return ray._replace(d=new_d, ra=ray.ra * vm, obliq=obliq)


# --------------------------------------------------------------------------
# Full surface interaction
# --------------------------------------------------------------------------
def ray_reaction(ray: RayBundle, p: SurfaceParams, meta: SurfaceMeta,
                 wvln: float, forward: bool, coherent: bool = False) -> RayBundle:
    """Intersect and refract one ray bundle at one surface."""
    eta = meta.eta(wvln, forward)
    n_before = meta.index_before(wvln, forward)
    k_wave = 2 * np.pi / (wvln * 1e-3)

    if meta.kind == "stop":
        t = (p.d - ray.o[..., 2]) / ray.d[..., 2]
        new_o = ray.o + t[..., None] * ray.d
        if meta.is_square:
            valid = (
                (torch.abs(new_o[..., 0]) <= meta.r)
                & (torch.abs(new_o[..., 1]) <= meta.r)
                & (ray.ra > 0)
            )
        else:
            valid = (
                torch.sqrt(new_o[..., 0] ** 2 + new_o[..., 1] ** 2) <= meta.r
            ) & (ray.ra > 0)
        o0 = ray.o
        o = torch.where(valid[..., None], new_o, ray.o)
        ray = ray._replace(o=o)
        if coherent:
            # standard OPD accumulation
            opl_std = torch.where(valid, ray.opl + n_before * t, ray.opl)
            phi_std = torch.where(
                valid,
                ray.phi + torch.remainder(
                    n_before * k_wave * (t - torch.amin(t, dim=0)), 2 * np.pi),
                ray.phi,
            )
            # Far-field branch (`surfaces.py:261-282`): when every ray
            # travels > 100 mm to the plane, the OPD is the new origin
            # projected on the incoming origin's direction, unmasked and
            # with no phase update.  Both branches are evaluated, and
            # torch.where back-propagates NaN from the branch it does not
            # select, so the norm is clamped: a ray from the coordinate
            # origin (|o0| = 0) would give 0/0.  Where the far-field branch
            # is selected, |o0| >> 1 and the clamp changes nothing.
            o0_norm = torch.sqrt(torch.sum(o0 * o0, dim=-1))
            opd = -torch.sum(o * o0, dim=-1) / torch.clamp(o0_norm, min=EPSILON)
            far_field = torch.amin(t) > 100.0
            opl = torch.where(far_field, ray.opl + opd, opl_std)
            phi = torch.where(far_field, ray.phi, phi_std)
            ray = ray._replace(opl=opl, phi=phi)
        ray = ray._replace(ra=ray.ra * valid.to(ray.ra.dtype))
        if eta != 1:
            ray = refract(ray, p, meta, eta, forward)
        return ray

    valid_n, t = newtons_method(ray, p, meta)
    new_o = ray.o + t[..., None] * ray.d

    if meta.kind == "spheric":
        # a spheric surface overrides the Newton validity
        valid = (
            (new_o[..., 0] ** 2 + new_o[..., 1] ** 2 <= meta.r**2)
            & (t >= 0)
            & (ray.ra > 0)
        )
    else:
        valid = valid_n

    o = torch.where(valid[..., None], new_o, ray.o)
    ray = ray._replace(o=o)
    if coherent:
        opl = torch.where(valid, ray.opl + n_before * t, ray.opl)
        phi = torch.where(
            valid,
            ray.phi + torch.remainder(
                n_before * k_wave * (t - torch.amin(t, dim=0)), 2 * np.pi),
            ray.phi,
        )
        ray = ray._replace(opl=opl, phi=phi)
    ray = ray._replace(ra=ray.ra * valid.to(ray.ra.dtype))
    return refract(ray, p, meta, eta, forward)
