"""Ray bundles and propagation (the port of `aadff_tpu/optics/rays.py`).

A `RayBundle` is an immutable NamedTuple of tensors; "mutation" is
`._replace(...)`.

Fields
    o      [..., 3]  positions [mm]
    d      [..., 3]  unit directions
    ra     [...]     validity mask (float 0/1, multiplied as in the reference)
    en     [...]     spherical-wave energy decay (kept for parity, unused)
    obliq  [...]     cumulative obliquity factor (cos of bend per refraction)
    opl    [...]     optical path length (coherent mode)
    phi    [...]     accumulated phase modulo 2*pi (coherent mode)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RayBundle(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    ra: torch.Tensor
    en: torch.Tensor
    obliq: torch.Tensor
    opl: torch.Tensor
    phi: torch.Tensor


def make_rays(o, d, normalize: bool = True, device=None) -> RayBundle:
    """Build a ray bundle in f32; directions are normalised unless told not."""
    o = torch.as_tensor(o, dtype=torch.float32, device=device)
    d = torch.as_tensor(d, dtype=torch.float32, device=o.device)
    if normalize:
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    ones = torch.ones(o.shape[:-1], dtype=torch.float32, device=o.device)
    zeros = torch.zeros_like(ones)
    return RayBundle(o=o, d=d, ra=ones, en=ones, obliq=ones, opl=zeros, phi=zeros)


def propagate_to(ray: RayBundle, z, n: float = 1.0, coherent: bool = False,
                 wvln: float = 0.589) -> RayBundle:
    """Propagate rays to the plane `z` (a number or a tensor that broadcasts
    against the rays' shape)."""
    t = (z - ray.o[..., 2]) / ray.d[..., 2]
    o = ray.o + ray.d * t[..., None]
    if not coherent:
        return ray._replace(o=o)
    opl = ray.opl + n * t
    k = 2 * np.pi / (wvln * 1e-3)
    phi = ray.phi + torch.remainder(n * k * (t - torch.amin(t, dim=0)), 2 * np.pi)
    return ray._replace(o=o, opl=opl, phi=phi)


def project_to(ray: RayBundle, z) -> torch.Tensor:
    """Intersection (x, y) of each ray with the plane `z`."""
    t = (z - ray.o[..., 2]) / ray.d[..., 2]
    return ray.o[..., 0:2] + ray.d[..., 0:2] * t[..., None]
