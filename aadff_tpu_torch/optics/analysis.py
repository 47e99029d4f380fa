"""Lens analysis (the port of `aadff_tpu/optics/analysis.py:26-80`): the RMS
spot radii, which return numbers.  The JAX module's figures need
matplotlib, which the port does not use."""
from __future__ import annotations

import torch

from ..constants import DEFAULT_WAVE, DEPTH, GEO_SPP, WAVE_RGB
from .rays import project_to


def analysis_rms(lens, depth=DEPTH, ref=True, seed=None):
    """(avg RMS radius, on-axis RMS, off-axis RMS) [mm] over the RGB
    wavelengths, for a 31 x 31 grid of point sources at `depth`.

    With `seed`, every bundle draws the same pupil samples from a generator
    seeded with it (JAX's `key=`); without, each draws fresh ones from the
    lens's generator (JAX's `key=None`)."""
    H = 31

    def gen():
        if seed is None:
            return None
        return torch.Generator(device=lens.device).manual_seed(seed)

    scale = lens.calc_scale_ray(depth, generator=gen())

    def spots(wvln):
        ray = lens.sample_point_source(
            M=H, spp=GEO_SPP, depth=depth, R=lens.sensor_size[0] / 2 * scale,
            wvln=wvln, generator=gen(),
        )
        ray, _, _ = lens.trace(ray, wvln=wvln)
        return project_to(ray, lens.d_sensor), ray.ra

    with torch.no_grad():
        p_center_ref = None
        if ref:
            p_green, ra = spots(DEFAULT_WAVE)
            p_center_ref = (p_green * ra[..., None]).sum(0) / (
                ra.sum(0)[..., None] + 1e-4
            )

        rms, rms_on, rms_off = [], [], []
        for wvln in WAVE_RGB:
            o2, ra = spots(wvln)
            center = (o2 * ra[..., None]).sum(0) / (ra.sum(0)[..., None] + 1e-4)
            o2n = (o2 - (p_center_ref if ref else center)) * ra[..., None]
            rms.append(float(torch.sqrt((o2n**2 * ra[..., None]).sum() / ra.sum())))
            c = H // 2 + 1
            rms_on.append(float(torch.sqrt(
                (o2n[:, c, c, :] ** 2 * ra[:, c, c, None]).sum()
                / ra[:, H // 2, H // 2].sum())))
            rms_off.append(float(torch.sqrt(
                (o2n[:, 0, 0, :] ** 2 * ra[:, 0, 0, None]).sum()
                / ra[:, 0, 0].sum())))
    n = len(rms)
    return sum(rms) / n, sum(rms_on) / n, sum(rms_off) / n
