"""Lens system: JSON IO, ray sampling, tracing, pupils, focusing, geometry
(the port of `aadff_tpu/optics/lens.py`).

Surface parameters are a tuple of `SurfaceParams` (tensors on the lens's
device); everything else about a surface is a static `SurfaceMeta`.  The
trace is eager PyTorch: one launch per elementwise operation, about 8,000
for a 12-surface lens (10 Newton steps per surface).

Random draws come from `torch.Generator`s: each sampler takes a
`generator` (default: the lens's own, seeded from `seed`), and the ones the
tests hold to the JAX package also take their uniforms as tensors
(`draws=`).  `refocus` seeds its samples from the focus distance, as JAX
does (`lens.py:474`), but draws them on a CPU generator so that every
device finds the same sensor position.

Host-side statistics (focus, field of view, pupils) run in numpy as in the
JAX package: float32 where it reads traced rays, float64 in the pairwise
pupil solve with its 10% trimmed mean.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import DEFAULT_WAVE, DEPTH, EPSILON, GEO_SPP
from ..ops.fused_render import jax_linspace
from .rays import RayBundle, make_rays, project_to, propagate_to
from .surfaces import SurfaceMeta, SurfaceParams, make_surface, ray_reaction, sag_r2


def trace_rays(ray: RayBundle, params: Tuple[SurfaceParams, ...], metas, wvln,
               forward, coherent, lens_range, record):
    """Trace `ray` through the surfaces `lens_range` (reversed when not
    `forward`); with `record`, also the stacked origins [n+1, ..., 3] before
    the first surface and after each."""
    oss = [ray.o] if record else None
    order = lens_range if forward else tuple(reversed(lens_range))
    for i in order:
        ray = ray_reaction(ray, params[i], metas[i], wvln, forward, coherent)
        if record:
            oss.append(ray.o)
    if record:
        return ray, torch.stack(oss, dim=0)
    return ray, None


def _trim_mean(x: np.ndarray, proportion: float = 0.1) -> float:
    """scipy.stats.trim_mean semantics."""
    n = len(x)
    cut = int(n * proportion)
    xs = np.sort(x)
    return float(np.mean(xs[cut : n - cut]))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) draws of `shape` from `generator`, moved to `device`."""
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


class Lens:
    """A compound lens + sensor (functional core, thin stateful shell)."""

    def __init__(self, filename: Optional[str] = None, sensor_res=(1024, 1024),
                 seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.sensor_res = tuple(sensor_res)
        self.params: Tuple[SurfaceParams, ...] = ()
        self.metas: Tuple[SurfaceMeta, ...] = ()
        self.r_last = None
        self.d_sensor = None
        self.hfov = None
        self.lens_name = filename
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._focus_cache = {}

        if filename is not None:
            self.load_file(filename, sensor_res)

    # ------------------------------------------------------------------
    # IO
    # ------------------------------------------------------------------
    def load_file(self, filename: str, sensor_res):
        if not filename.endswith(".json"):
            raise ValueError("Only .json lens files are supported.")
        self.read_lens_json(filename)
        self.find_aperture()
        self.prepare_sensor(sensor_res)
        self.post_computation()

    def read_lens_json(self, filename: str):
        with open(filename) as f:
            data = json.load(f)
        params, metas = [], []
        for sd in data["surfaces"]:
            kind = {"Stop": "stop", "Spheric": "spheric", "Aspheric": "aspheric"}[
                sd["type"]
            ]
            p, m = make_surface(
                kind,
                r=sd["r"],
                d=sd["d"],
                c=sd.get("c", 0.0),
                k=sd.get("k", 0.0),
                ai=sd.get("ai"),
                mat1=sd["mat1"],
                mat2=sd["mat2"],
                device=self.device,
            )
            params.append(p)
            metas.append(m)
        self.params = tuple(params)
        self.metas = tuple(metas)
        self.r_last = float(data["r_last"])
        self.d_sensor = float(data["d_sensor"])

    def write_lens_json(self, filename: str):
        data = {
            "foclen": float(self.foclen),
            "fnum": float(self.fnum),
            "r_last": float(self.r_last),
            "d_sensor": float(self.d_sensor),
            "sensor_size": [float(s) for s in self.sensor_size],
            "surfaces": [],
        }
        for i, (p, m) in enumerate(zip(self.params, self.metas)):
            sd = {"r": m.r, "c": float(p.c), "d": float(p.d),
                  "mat1": m.mat1.name, "mat2": m.mat2.name}
            if m.kind == "stop":
                sd["type"] = "Stop"
            elif m.kind == "spheric":
                sd["type"] = "Spheric"
                sd["roc"] = 1 / float(p.c)
            else:
                sd["type"] = "Aspheric"
                sd["roc"] = 1 / float(p.c)
                sd["k"] = float(p.k)
                sd["ai"] = [float(a) for a in _np(p.ai)[: m.ai_degree]]
            if i < len(self.params) - 1:
                sd["d_next"] = float(self.params[i + 1].d) - float(p.d)
            else:
                sd["d_next"] = float(self.d_sensor) - float(p.d)
            data["surfaces"].append(sd)
        with open(filename, "w") as f:
            json.dump(data, f, indent=4)

    # ------------------------------------------------------------------
    # Sensor / aperture bookkeeping
    # ------------------------------------------------------------------
    def prepare_sensor(self, sensor_res=(512, 512), sensor_size=None):
        sensor_res = (
            (sensor_res, sensor_res) if isinstance(sensor_res, int) else tuple(sensor_res)
        )
        self.sensor_res = sensor_res
        H, W = sensor_res
        if sensor_size is None:
            self.sensor_size = [
                2 * self.r_last * H / math.sqrt(H**2 + W**2),
                2 * self.r_last * W / math.sqrt(H**2 + W**2),
            ]
        else:
            self.sensor_size = list(sensor_size)
            self.r_last = math.sqrt(sensor_size[0] ** 2 + sensor_size[1] ** 2) / 2
        if abs(self.sensor_size[0] / self.sensor_size[1] - H / W) >= 1e-9:
            raise ValueError("Pixel is not square.")
        self.pixel_size = self.sensor_size[0] / sensor_res[0]

    def post_computation(self):
        self.find_aperture()
        self.hfov = self.calc_fov()
        self.foclen = self.calc_efl()
        avg_pupilz, avg_pupilx = self.entrance_pupil()
        self.fnum = self.foclen / avg_pupilx / 2

    def find_aperture(self):
        self.aper_idx = None
        for i in range(len(self.metas) - 1):
            if self.metas[i].mat1.n < 1.0003 and self.metas[i].mat2.n < 1.0003:
                self.aper_idx = i
                return

    def find_diff_surf(self):
        if self.aper_idx is None:
            return list(range(len(self.metas)))
        return list(range(0, self.aper_idx)) + list(
            range(self.aper_idx + 1, len(self.metas))
        )

    def _clear_caches(self):
        self._pupil_cache = {}
        self._focus_cache = {}

    # ------------------------------------------------------------------
    # Ray sampling
    # ------------------------------------------------------------------
    def _gen(self, generator):
        return self.generator if generator is None else generator

    def surface_sample(self, surf_idx: int = 0, n: int = 1000, generator=None,
                       draws=None):
        """Uniform points [n, 3] on a surface's flat disc; `draws` = (u_theta,
        u_r), two [n] uniforms (default: drawn from `generator`)."""
        if draws is None:
            g = self._gen(generator)
            draws = (uniform((n,), g, self.device), uniform((n,), g, self.device))
        u_theta, u_r = (torch.as_tensor(u, dtype=torch.float32, device=self.device)
                        for u in draws)
        r_max = self.metas[surf_idx].r
        theta = u_theta * 2 * np.pi
        r = torch.sqrt(u_r * r_max**2)
        x = r * torch.cos(theta)
        y = r * torch.sin(theta)
        z = torch.full_like(x, float(self.params[surf_idx].d))
        return torch.stack([x, y, z], dim=1)

    def sample_parallel_2D(self, R=None, wvln=DEFAULT_WAVE, z=None, view=0.0,
                           M=15, forward=True, entrance_pupil=False):
        """2D parallel ray fan."""
        if entrance_pupil:
            pupilz, pupilx = self.entrance_pupil()
            x2 = np.linspace(-pupilx, pupilx, M, dtype=np.float32) * 0.99
            o2 = np.stack(
                [x2, np.zeros_like(x2), np.full_like(x2, pupilz)], axis=-1
            )
            d = np.stack(
                [
                    np.full_like(x2, np.sin(view / 57.3)),
                    np.zeros_like(x2),
                    np.full_like(x2, np.cos(view / 57.3)),
                ],
                axis=-1,
            )
            if pupilz > 0:
                o = o2 - d * ((o2[:, 2] + 0.1) / d[:, 2])[:, None]
            else:
                o = o2
            return make_rays(o, d, device=self.device)

        x = np.linspace(-R, R, M, dtype=np.float32)
        if z is None:
            z = 0.0 if forward else self.d_sensor
        o = np.stack([x, np.zeros_like(x), np.full_like(x, z)], axis=-1)
        dz = np.cos(view / 57.3) if forward else -np.cos(view / 57.3)
        d = np.stack(
            [np.full_like(x, np.sin(view / 57.3)), np.zeros_like(x), np.full_like(x, dz)],
            axis=-1,
        )
        return make_rays(o, d, device=self.device)

    def sample_parallel(self, fov=0.0, R=None, z=None, M=15, wvln=DEFAULT_WAVE,
                        sampling="grid", forward=True, entrance_pupil=False,
                        generator=None):
        """Parallel ray grid from a plane, shape [M, M] (one field angle)."""
        if z is None:
            z = float(self.params[0].d)
        fov_rad = float(np.radians(fov))

        if entrance_pupil:
            pupilz, pupilr = self.entrance_pupil()
        else:
            pupilz = 0.0
            sag = float(sag_r2(torch.tensor(np.float32(self.metas[0].r**2),
                                            device=self.device),
                               self.params[0], self.metas[0].ai_degree))
            pupilr = R if R is not None else (
                math.tan(fov_rad) * sag + self.metas[0].r
            )
        if sampling == "grid":
            x, y = torch.meshgrid(
                jax_linspace(-pupilr, pupilr, M, self.device),
                jax_linspace(pupilr, -pupilr, M, self.device),
                indexing="xy",
            )
        elif sampling == "radial":
            g = self._gen(generator)
            r2 = uniform((M, M), g, self.device) * pupilr**2
            theta = uniform((M, M), g, self.device) * 2 * np.pi
            x = torch.sqrt(r2) * torch.cos(theta)
            y = torch.sqrt(r2) * torch.sin(theta)
        else:
            raise ValueError("Sampling method not implemented!")

        o = torch.stack([x, y, torch.full_like(x, pupilz)], dim=2)
        sgn = 1.0 if forward else -1.0
        d = torch.stack(
            [
                torch.full_like(x, sgn * np.sin(fov_rad)),
                torch.zeros_like(x),
                torch.full_like(x, sgn * np.cos(fov_rad)),
            ],
            dim=2,
        )
        ray = make_rays(o, d)
        return propagate_to(ray, z)

    def sample_point_source_2D(self, depth=-1000.0, view=0.0, M=9,
                               entrance_pupil=False, wvln=DEFAULT_WAVE):
        """2D point-source fan."""
        if entrance_pupil:
            pupilz, pupilx = self.entrance_pupil()
        else:
            pupilz, pupilx = 0.0, self.metas[0].r
        x2 = np.linspace(-pupilx, pupilx, M, dtype=np.float32) * 0.99
        o2 = np.stack([x2, np.zeros_like(x2), np.full_like(x2, pupilz)], axis=1)
        o1 = np.zeros_like(o2)
        o1[:, 2] = depth
        o1[:, 0] = depth * np.tan(view / 57.3)
        ray = make_rays(o1, o2 - o1, device=self.device)
        return propagate_to(ray, float(self.params[0].d) - 0.1)

    def sample_point_source(self, R=None, depth=-10.0, M=11, spp=16,
                            wvln=DEFAULT_WAVE, importance_sampling=False,
                            generator=None):
        """Point-grid rays through the pupil, shape [spp, M, M]."""
        if R is None:
            R = self.metas[0].r
        Rw = R * self.sensor_res[1] / self.sensor_res[0]
        x, y = torch.meshgrid(
            jax_linspace(-1, 1, M, self.device), jax_linspace(1, -1, M, self.device),
            indexing="xy"
        )
        if importance_sampling:
            x = torch.sqrt(torch.abs(x)) * torch.sign(x)
            y = torch.sqrt(torch.abs(y)) * torch.sign(y)
        x = x * Rw
        y = y * R
        o = torch.stack([x, y, torch.full_like(x, depth)], dim=-1)
        o = torch.broadcast_to(o[None], (spp, M, M, 3))
        o2 = self.sample_pupil(res=(M, M), spp=spp, generator=generator)
        d = o2 - o
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return make_rays(o, d, normalize=False)

    def sample_from_points(self, o=((0.0, 0.0, -10000.0),), spp=256,
                           wvln=DEFAULT_WAVE, shrink_pupil=False, generator=None):
        """Rays from point sources through the entrance pupil, [spp, N]."""
        o = torch.as_tensor(o, dtype=torch.float32, device=self.device)
        o = torch.broadcast_to(o[None], (spp,) + tuple(o.shape))
        pupilz, pupilr = self.entrance_pupil(shrink_pupil=shrink_pupil)
        g = self._gen(generator)
        theta = uniform((spp,), g, self.device) * 2 * np.pi
        r = torch.sqrt(uniform((spp,), g, self.device) * pupilr**2)
        o2 = torch.stack(
            [r * torch.cos(theta), r * torch.sin(theta), torch.full_like(theta, pupilz)],
            dim=1,
        )
        d = o2[:, None, :] - o
        return make_rays(o, d)

    def sample_pupil(self, res=(512, 512), spp=16, num_angle=8, pupilr=None,
                     pupilz=None, generator=None):
        """Stratified ring samples on the pupil plane, [spp, H, W, 3]."""
        H, W = res
        if pupilr is None or pupilz is None:
            pupilz, pupilr = self.entrance_pupil()
        g = self._gen(generator)

        if spp % num_angle != 0 or spp >= 10000:
            theta = uniform((spp, H, W), g, self.device) * 2 * np.pi
            r = torch.sqrt(uniform((spp, H, W), g, self.device) * pupilr**2)
        else:
            num_r2 = spp // num_angle
            dtheta = (uniform((num_angle, num_r2, H, W), g, self.device)
                      * 2 * np.pi / num_angle)
            dr2 = (uniform((num_angle, num_r2, H, W), g, self.device)
                   * pupilr**2 / num_r2)
            i = torch.arange(num_angle, dtype=torch.float32,
                             device=self.device)[:, None, None, None]
            j = torch.arange(num_r2, dtype=torch.float32,
                             device=self.device)[None, :, None, None]
            theta = (dtheta + i * 2 * np.pi / num_angle).reshape(spp, H, W)
            r = torch.sqrt((dr2 + j * pupilr**2 / num_r2).reshape(spp, H, W))
        x = r * torch.cos(theta)
        y = r * torch.sin(theta)
        z = torch.full_like(x, pupilz)
        return torch.stack([x, y, z], dim=-1)

    def sample_sensor(self, spp=64, wvln=DEFAULT_WAVE, generator=None):
        """Rays from sensor pixels through the exit pupil."""
        H, W = self.sensor_res
        x1, y1 = torch.meshgrid(
            jax_linspace(-self.sensor_size[1] / 2, self.sensor_size[1] / 2, W + 1,
                         self.device)[1:],
            jax_linspace(self.sensor_size[0] / 2, -self.sensor_size[0] / 2, H + 1,
                         self.device)[1:],
            indexing="xy",
        )
        z1 = torch.full_like(x1, self.d_sensor)
        pupilz, pupilr = self.exit_pupil()
        o2 = self.sample_pupil((H, W), spp, pupilr=pupilr, pupilz=pupilz,
                               generator=generator)
        o = torch.stack([x1, y1, z1], dim=2)
        o = torch.broadcast_to(o[None], o2.shape)
        return make_rays(o, o2 - o)

    # ------------------------------------------------------------------
    # Ray tracing
    # ------------------------------------------------------------------
    def trace(self, ray: RayBundle, lens_range=None, record=False, forward=None,
              wvln=DEFAULT_WAVE, coherent=False):
        if lens_range is None:
            lens_range = tuple(range(len(self.metas)))
        else:
            lens_range = tuple(lens_range)
        if forward is None:
            forward = bool(ray.d.reshape(-1, 3)[0, 2] > 0)
        out, oss = trace_rays(ray, self.params, self.metas, float(wvln), forward,
                              coherent, lens_range, record)
        valid = out.ra > 0
        return out, valid, oss

    def trace2sensor(self, ray: RayBundle, record=False, wvln=DEFAULT_WAVE,
                     coherent=False):
        ray, valid, oss = self.trace(ray, record=record, wvln=wvln, coherent=coherent)
        ray = propagate_to(ray, self.d_sensor, coherent=coherent, wvln=wvln)
        if record:
            oss = torch.cat([oss, ray.o[None]], dim=0)
            return ray, oss
        return ray

    def trace2obj(self, ray: RayBundle, depth=DEPTH, wvln=DEFAULT_WAVE):
        ray, _, _ = self.trace(ray, wvln=wvln)
        return propagate_to(ray, depth)

    # ------------------------------------------------------------------
    # Focus
    # ------------------------------------------------------------------
    def calc_foclen(self):
        if self.r_last < 8:
            return self.calc_efl()
        return self.calc_bfl()

    def calc_bfl(self, wvln=DEFAULT_WAVE):
        return self.d_sensor - self.calc_principal(wvln=wvln)[1]

    def calc_efl(self):
        return self.r_last / math.tan(self.hfov)

    def calc_eqfl(self):
        return 21.63 / math.tan(self.hfov)

    def calc_foc_dist(self, wvln=DEFAULT_WAVE, generator=None):
        """Object-space focus distance, traced sensor -> object."""
        o1 = torch.tensor([0.0, 0.0, self.d_sensor], dtype=torch.float32,
                          device=self.device).tile((GEO_SPP, 1))
        o2 = self.surface_sample(0, GEO_SPP, generator=generator) * 0.2
        ray = make_rays(o1, o2 - o1)
        ray, _, _ = self.trace(ray, wvln=wvln)
        o, d, ra = _np(ray.o), _np(ray.d), _np(ray.ra)
        t = (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1]) / (
            d[..., 0] ** 2 + d[..., 1] ** 2
        )
        focus_p = (o[..., 2] - d[..., 2] * t)[ra > 0]
        focus_p = focus_p[~np.isnan(focus_p) & (focus_p < 0)]
        return float(np.mean(focus_p))

    def refocus_inf(self):
        ray = self.sample_parallel_2D(R=self.metas[0].r * 0.5, M=GEO_SPP)
        self._refocus_from_ray(ray)

    def refocus(self, depth=DEPTH):
        """Move the sensor to focus at `depth`, memoised per depth.

        The surface samples come from a CPU generator seeded with
        `hash(float(depth)) % 2**31`, the seed of JAX's `lens.py:474`: the
        same numbers on every device, other numbers than JAX's."""
        cached = self._focus_cache.get(float(depth))
        if cached is not None:
            (self.d_sensor, self.hfov, self.foclen, self.fnum,
             self._pupil_cache) = cached
            return

        gen = torch.Generator().manual_seed(hash(float(depth)) % (2**31))
        o = self.surface_sample(0, GEO_SPP, generator=gen)
        d = o - torch.tensor([0.0, 0.0, depth], dtype=torch.float32,
                             device=self.device)
        ray = make_rays(o, d)
        self._refocus_from_ray(ray)
        self._focus_cache[float(depth)] = (
            self.d_sensor, self.hfov, self.foclen, self.fnum, self._pupil_cache,
        )

    def _refocus_from_ray(self, ray):
        ray, _, _ = self.trace(ray)
        o, d, ra = _np(ray.o), _np(ray.d), _np(ray.ra)
        t = (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1]) / (
            d[..., 0] ** 2 + d[..., 1] ** 2
        )
        t = t * ra
        focus_d = o[..., 2] - d[..., 2] * t
        focus_d = focus_d[ra > 0]
        focus_d = focus_d[~np.isnan(focus_d) & (focus_d > 0)]
        d_sensor_new = float(np.mean(focus_d))
        if not d_sensor_new > 0:
            raise ValueError(f"sensor position is not positive: {d_sensor_new}")
        self.d_sensor = d_sensor_new
        self.post_computation()

    # ------------------------------------------------------------------
    # FoV / magnification
    # ------------------------------------------------------------------
    def calc_fov(self):
        M = 100
        pupilz, pupilx = self.exit_pupil(shrink_pupil=True)
        o1 = np.tile(
            np.asarray([self.r_last, 0.0, self.d_sensor], np.float32), (M, 1)
        )
        x2 = np.linspace(-pupilx, pupilx, M, dtype=np.float32)
        o2 = np.stack([x2, np.zeros_like(x2), np.full_like(x2, pupilz)], axis=-1)
        ray = make_rays(o1, o2 - o1, device=self.device)
        ray, _, _ = self.trace(ray, forward=False)
        d, ra = _np(ray.d), _np(ray.ra)
        tan_fov = d[..., 0] / d[..., 2]
        fov = np.arctan(np.sum(tan_fov * ra) / np.sum(ra))
        if np.isnan(fov):
            return 0.5
        return float(fov)

    def calc_magnification3(self, depth, generator=None):
        """Ray-traced magnification."""
        M, spp = 21, 512
        ray = self.sample_point_source(
            M=M, spp=spp, depth=depth,
            R=-depth * math.tan(self.hfov) * 0.5, generator=generator,
        )
        o1 = np.flip(_np(ray.o)[..., :2], (1, 2))
        ray, _, _ = self.trace(ray)
        o2 = _np(project_to(ray, self.d_sensor))
        ra = _np(ray.ra)
        x1 = o1[0, :, :, 0]
        x2 = np.sum(o2[..., 0] * ra, axis=0) / (np.sum(ra, axis=0) + EPSILON)
        mag_x = x1 / x2
        tmp = mag_x[: M // 2, : M // 2]
        mag = 1 / float(np.mean(tmp[~np.isnan(tmp)]))
        if mag == 0:
            return 1 / self.calc_scale_pinhole(depth)
        return mag

    def calc_principal(self, wvln=DEFAULT_WAVE):
        """Front/back principal planes."""
        M = 32
        out = []
        for forward in (False, True):
            ray = self.sample_parallel_2D(R=self.metas[0].r, M=M, forward=forward,
                                          wvln=wvln)
            inc_o = _np(ray.o)
            ray_out, _, _ = self.trace(ray, forward=forward, wvln=wvln)
            o, d, ra = _np(ray_out.o), _np(ray_out.d), _np(ray_out.ra)
            t = (o[..., 0] - inc_o[..., 0]) / d[..., 0]
            z = o[..., 2] - d[..., 2] * t
            out.append(float(np.nanmean(z[ra > 0])))
        front_principal, back_principal = out
        return front_principal, back_principal

    def calc_scale_pinhole(self, depth):
        return -np.asarray(depth) * math.tan(self.hfov) / self.r_last

    def calc_scale_ray(self, depth, generator=None):
        if np.ndim(depth) == 1:
            return np.asarray([1 / self.calc_magnification3(float(d), generator)
                               for d in depth])
        return 1 / self.calc_magnification3(float(depth), generator)

    # ------------------------------------------------------------------
    # Pupils
    # ------------------------------------------------------------------
    def exit_pupil(self, shrink_pupil=False):
        return self.entrance_pupil(entrance=False, shrink_pupil=shrink_pupil)

    def entrance_pupil(self, M=32, entrance=True, shrink_pupil=False):
        cache = getattr(self, "_pupil_cache", None)
        if cache is None:
            cache = self._pupil_cache = {}
        hit = cache.get((M, entrance))
        if hit is not None:
            z, x = hit
            return (z, x * 0.5) if shrink_pupil else (z, x)

        if self.aper_idx is None:
            if entrance:
                res = (float(self.params[0].d), self.metas[0].r)
            else:
                res = (float(self.params[-1].d), self.metas[-1].r)
        else:
            res = self._pupil_solve(M, entrance)
        cache[(M, entrance)] = res
        z, x = res
        return (z, x * 0.5) if shrink_pupil else (z, x)

    def _pupil_solve(self, M, entrance):
        """Trace edge-of-aperture rays and intersect them pairwise in float64;
        the pupil is the 10% trimmed mean of the intersections."""
        aper_idx = self.aper_idx
        aper_z = float(self.params[aper_idx].d)
        aper_r = self.metas[aper_idx].r
        ray_o = np.tile(np.asarray([aper_r, 0.0, aper_z], np.float32), (M, 1))
        phi = np.arange(-0.5, 0.5, 1.0 / M, dtype=np.float32)
        dz = -np.cos(phi) if entrance else np.cos(phi)
        d = np.stack([np.sin(phi), np.zeros_like(phi), dz], axis=-1)
        ray = make_rays(ray_o, d, device=self.device)

        if entrance:
            lens_range = tuple(range(0, aper_idx))
        else:
            lens_range = tuple(range(aper_idx + 1, len(self.metas)))
        if len(lens_range) > 0:
            ray, _, _ = self.trace(ray, lens_range=lens_range, forward=not entrance)

        o = _np(ray.o).astype(np.float64)
        dd = _np(ray.d).astype(np.float64)
        ra = _np(ray.ra)
        ii, jj = np.triu_indices(M, k=1)
        ok = (ra[ii] != 0) & (ra[jj] != 0)
        ii, jj = ii[ok], jj[ok]
        if len(ii) == 0:
            return 0.0, aper_r
        d1x, d1z = dd[ii, 0], dd[ii, 2]
        d2x, d2z = dd[jj, 0], dd[jj, 2]
        o1x, o1z = o[ii, 0], o[ii, 2]
        o2x, o2z = o[jj, 0], o[jj, 2]
        adet = -d1x * d2z + d2x * d1z
        b1 = -d1z * o1x + d1x * o1z
        b2 = -d2z * o2x + d2x * o2z
        oz = (-b1 * d2z + b2 * d1z) / adet
        ox = (b2 * d1x - b1 * d2x) / adet
        avg_x = _trim_mean(ox, 0.1)
        avg_z = _trim_mean(oz, 0.1)
        if abs(avg_z) < EPSILON:
            avg_z = 0.0
        return avg_z, avg_x

    # ------------------------------------------------------------------
    # Lens operations: each clears the focus and pupil caches
    # ------------------------------------------------------------------
    def set_aperture(self, fnum=None, foclen=None, aper_r=None):
        if aper_r is None:
            if foclen is None:
                foclen = self.calc_efl()
            aper_r = foclen / fnum / 2
        metas = list(self.metas)
        m = metas[self.aper_idx]
        metas[self.aper_idx] = dataclasses.replace(m, r=float(aper_r))
        self.metas = tuple(metas)
        self._clear_caches()
        self.fnum = self.foclen / aper_r / 2

    def perturb(self, ratio=0.001, thickness_precision=0.0005,
                diameter_precision=0.001, rng=None):
        """Manufacturing-error injection; draws from the numpy Generator
        `rng` in the JAX package's order."""
        rng = np.random.default_rng() if rng is None else rng
        params, metas = list(self.params), list(self.metas)
        for i, (p, m) in enumerate(zip(params, metas)):
            metas[i] = dataclasses.replace(
                m, r=m.r + float(rng.standard_normal()) * diameter_precision
            )
            c = p.c * (1 + rng.standard_normal() * ratio) if float(p.c) != 0 else p.c
            d = p.d + rng.standard_normal() * thickness_precision if float(p.d) != 0 else p.d
            k = p.k * (1 + rng.standard_normal() * ratio) if float(p.k) != 0 else p.k
            scale = 1 + rng.standard_normal(p.ai.shape).astype(np.float32) * ratio
            ai = p.ai * torch.from_numpy(scale).to(self.device)
            params[i] = SurfaceParams(
                c=c.to(torch.float32), d=d.to(torch.float32),
                k=k.to(torch.float32), ai=ai.to(torch.float32),
            )
        self.params, self.metas = tuple(params), tuple(metas)
        self._clear_caches()

    def max_height(self, idx):
        p, m = self.params[idx], self.metas[idx]
        if m.k_gt_neg1 and float(p.c) != 0:
            return float(np.sqrt(1 / (float(p.k) + 1) / float(p.c) ** 2)) - 0.01
        return 100.0

    def prune_surf(self, outer=None):
        """Prune surface apertures to the traced ray envelope (pruning_v2)."""
        outer = self.r_last * 0.05 if outer is None else outer
        self.pruning_v2(outer=outer)

    def pruning_v2(self, outer=None, surface_range=None):
        """Prune surfaces to the least height that passes all valid rays:
        reset apertures to the sensor radius, trace a max-FoV 2D fan, clamp
        each aperture to the traced ray envelope + `outer`, keep front <=
        back heights at cemented interfaces, and cap by the surface's own
        max height."""
        outer = self.r_last * 0.05 if outer is None else outer
        if surface_range is None:
            surface_range = self.find_diff_surf()

        metas = list(self.metas)
        for i in surface_range:
            metas[i] = dataclasses.replace(metas[i], r=self.r_last)
        self.metas = tuple(metas)
        self._pupil_cache = {}

        view = self.hfov if self.hfov is not None else math.atan(self.r_last / self.d_sensor)
        ray = self.sample_parallel_2D(view=np.rad2deg(view), M=21, entrance_pupil=True)
        _, oss = self.trace2sensor(ray=ray, record=True)
        oss = _np(oss)  # [n_surf+2, M, 3]

        metas = list(self.metas)
        for i in surface_range:
            height = np.abs(oss[i + 1, :, 0])
            metas[i] = dataclasses.replace(metas[i], r=float(height.max()) + outer)
        for i in surface_range[:-1]:
            if metas[i].mat1.n < metas[i + 1].mat1.n:
                metas[i] = dataclasses.replace(
                    metas[i], r=min(metas[i].r, metas[i + 1].r)
                )
        self.metas = tuple(metas)
        metas = list(self.metas)
        for i in surface_range:
            mh = min(self.max_height(i), self.r_last)
            metas[i] = dataclasses.replace(metas[i], r=min(metas[i].r, mh))
        self.metas = tuple(metas)
        self._clear_caches()

    def correct_shape(self):
        """Fix degenerate geometry during lens optimisation."""
        shape_changed = False
        params = list(self.params)
        move = float(params[0].d)
        for i, p in enumerate(params):
            params[i] = p._replace(d=p.d - move)
        self.d_sensor -= move

        if self.aper_idx == 0:
            d_aper = 0.1
            aper_r = self.metas[0].r
            p1 = params[1]
            sag1 = -float(sag_r2(torch.tensor(np.float32(aper_r**2),
                                              device=self.device),
                                 p1, self.metas[1].ai_degree))
            if sag1 > 0:
                d_aper += sag1
            delta = float(params[1].d) - d_aper
            for i in self.find_diff_surf():
                params[i] = params[i]._replace(d=params[i].d - delta)

        diff = self.find_diff_surf()
        for a, b in zip(diff[:-1], diff[1:]):
            if float(params[a].d) > float(params[b].d):
                params[b] = params[b]._replace(d=params[b].d + 0.2)
                shape_changed = True
        self.params = tuple(params)
        self._clear_caches()
        self.prune_surf()
        return shape_changed
