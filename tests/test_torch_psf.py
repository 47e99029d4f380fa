"""The port's PSF pipeline (`optics/psf.py`) against the JAX package and
tests/goldens/optics_goldens.npz, on the CPU.

`psf_impl` takes its pupil draws as tensors: the tests draw them with
jax.random under the key splits of JAX's `_psf_impl` (`psf.py:162-167`)
and pass the same numbers, and JAX's lens scalars, to both packages.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadff_tpu.constants import GEO_SPP
from aadff_tpu.optics import Lens as JaxLens
from aadff_tpu.optics.psf import _psf_impl as jax_psf_impl
from aadff_tpu.optics.psf import assign_points_to_pixels as jax_assign
from aadff_tpu.optics.psf import forward_integral as jax_forward_integral
from aadff_tpu.optics.psf import make_grid_psf as jax_make_grid_psf
from aadff_tpu.optics.psf import psf2mtf as jax_psf2mtf
from aadff_tpu.optics.rays import RayBundle as JaxRayBundle
from aadff_tpu_torch.optics import Lens
from aadff_tpu_torch.optics.psf import (PsfDraws, assign_points_to_pixels,
                                        forward_integral, lens_psf, lens_psf_map,
                                        make_grid_psf, psf2mtf, psf_impl)
from aadff_tpu_torch.optics.rays import RayBundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
LENS_50F28 = os.path.join(REPO, "lenses", "50mm_f2.8.json")
GOLDENS = os.path.join(REPO, "tests", "goldens", "optics_goldens.npz")
RES = (480, 640)
# psf_impl from the same draws and lens scalars, the port against JAX
# (rf50mm, 6 points, spp 512, ks 11): max-abs measured 9.5e-5 (chief-ray
# centre) and 1.3e-4 (perspective centre), at the 20 m field corner.  Both
# trace in f32 with other roundings (XLA fuses multiply-adds); each ray's
# sensor position differs by up to 2.9e-4 mm (0.005 px) there, and JAX's
# is the farther from a float64 trace
# (test_psf_rays_are_closer_to_float64_than_jax).  A tap of a 512-ray PSF
# sums ~100 such rays.
PSF_IMPL_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.fixture(scope="module")
def lens():
    return Lens(LENS, sensor_res=RES, device="cpu")


@pytest.fixture(scope="module")
def jlens():
    return JaxLens(LENS, sensor_res=RES)


def _np(t):
    return t.detach().cpu().numpy()


def jax_psf_draws(key, spp):
    """The uniforms JAX's `_psf_impl` draws from `key`, as PsfDraws."""
    k_psf, k_chief = jax.random.split(key)
    out = []
    for k, n in ((k_psf, spp), (k_chief, GEO_SPP)):
        k1, k2 = jax.random.split(k)
        out += [np.array(jax.random.uniform(k1, (n,))),
                np.array(jax.random.uniform(k2, (n,)))]
    return PsfDraws(*(torch.from_numpy(u) for u in out))


def jax_scalars(jl):
    """JAX's lens scalars of `_psf_impl`, as f32 numpy values."""
    pupilz, pupilr = jl.entrance_pupil()
    return tuple(np.float32(v) for v in (
        jl.d_sensor, pupilz, pupilr, jl.hfov, jl.r_last, jl.sensor_size[1],
        jl.sensor_size[0], jl.pixel_size))


def _golden_rays(goldens, w, cls, asarray):
    o = asarray(goldens[f"rf50mm_w{w}_o"])
    d = asarray(goldens[f"rf50mm_w{w}_d"])
    ra = asarray(goldens[f"rf50mm_w{w}_ra"])
    return cls(o=o, d=d, ra=ra, en=ra * 0 + 1, obliq=ra * 0 + 1, opl=ra * 0,
               phi=ra * 0)


def test_forward_integral_golden(goldens, lens):
    """The golden traced rays -> the golden rasterised PSF (atol 1e-3,
    rtol 1e-4, tests/test_psf.py:30-39)."""
    ray = _golden_rays(goldens, "0589", RayBundle, torch.from_numpy)
    pointc = torch.from_numpy(goldens["rf50mm_fi_pointc"])
    psf = forward_integral(ray, ps=lens.pixel_size, ks=11, pointc_ref=pointc)
    np.testing.assert_allclose(_np(psf), goldens["rf50mm_fi_psf"], atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("pointc", [True, False], ids=["pointc_ref", "centroid"])
def test_forward_integral_matches_jax(goldens, lens, pointc):
    """The same rays through both rasterisers within 1e-6, with a given
    centre and with the rays' own centroid."""
    ray = _golden_rays(goldens, "0486", RayBundle, torch.from_numpy)
    jray = _golden_rays(goldens, "0486", JaxRayBundle, jnp.asarray)
    pc = goldens["rf50mm_fi_pointc"] if pointc else None
    ours = forward_integral(ray, ps=lens.pixel_size, ks=11,
                            pointc_ref=None if pc is None else torch.from_numpy(pc))
    ref = jax_forward_integral(jray, ps=lens.pixel_size, ks=11,
                               pointc_ref=None if pc is None else jnp.asarray(pc))
    # the unnormalised sums reach ~36 (f32 ulp 3.8e-6): within 1e-6 of the
    # largest tap, i.e. 1e-6 on the PSF normalised to its peak
    ref = np.asarray(ref)
    print(f"measured: forward_integral vs JAX / peak "
          f"{np.abs(_np(ours) - ref).max() / ref.max():.3g}")
    assert ref.max() > 1
    np.testing.assert_allclose(_np(ours), ref, rtol=0, atol=1e-6 * ref.max())


def test_assign_points_matches_jax():
    """The incoherent and the coherent splat against JAX's."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    ra = rng.uniform(0, 1, 64).astype(np.float32)
    phase = rng.uniform(0, 6, 64).astype(np.float32)
    ks, rngs = 7, (-3.0, 3.0)
    ours = assign_points_to_pixels(torch.from_numpy(pts), ks, rngs, rngs,
                                   torch.from_numpy(ra))
    ref = jax_assign(jnp.asarray(pts), ks, rngs, rngs, jnp.asarray(ra))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-6)
    ours = assign_points_to_pixels(torch.from_numpy(pts), ks, rngs, rngs,
                                   torch.from_numpy(ra), coherent=True,
                                   phase=torch.from_numpy(phase))
    ref = jax_assign(jnp.asarray(pts), ks, rngs, rngs, jnp.asarray(ra),
                     coherent=True, phase=jnp.asarray(phase))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("center", [True, False], ids=["chief", "perspective"])
def test_psf_impl_matches_jax(lens, jlens, center):
    """psf_impl from JAX's draws and lens scalars (focus 2,400 mm) against
    JAX's `_psf_impl` at spp 512, ks 11: max-abs within PSF_IMPL_TOL."""
    jlens.refocus(-2400.0)
    scalars = jax_scalars(jlens)
    pts = np.asarray([[0.0, 0.0, -2400.0], [0.5, -0.5, -5000.0],
                      [-0.9, 0.3, -800.0], [0.98, 0.98, -20000.0],
                      [-0.3, -0.7, -1200.0], [0.1, 0.9, -300.0]], np.float32)
    key = jax.random.PRNGKey(11)
    rng = tuple(range(len(jlens.metas)))
    ref = jax_psf_impl(jlens.params, jlens.metas, jnp.asarray(pts), key, 11, 512,
                       0.589, center, rng, *(jnp.float32(s) for s in scalars))
    ours = psf_impl(lens.params, lens.metas, torch.from_numpy(pts),
                    jax_psf_draws(key, 512), 11, 0.589, center, rng,
                    *(float(s) for s in scalars))
    err = np.abs(_np(ours) - np.asarray(ref)).max()
    print(f"measured: psf_impl vs JAX ({'chief' if center else 'perspective'}) {err:.3g}")
    assert np.asarray(ref).sum() > 5
    assert err <= PSF_IMPL_TOL, err


def test_psf_rays_are_closer_to_float64_than_jax(lens, jlens):
    """Sensor positions of PSF rays (focus 2,400 mm; on axis at 2.4 m and at
    the 20 m field corner) from the port's f32 trace and from JAX's, each
    against a float64 trace of the same rays: the port's error is the
    smaller, in median and in max."""
    from aadff_tpu.optics.lens import _trace_impl
    from aadff_tpu.optics.rays import make_rays as jax_make_rays
    from aadff_tpu.optics.rays import propagate_to as jax_propagate_to
    from aadff_tpu_torch.optics.lens import trace_rays
    from aadff_tpu_torch.optics.psf import trace_from_points
    from aadff_tpu_torch.optics.rays import propagate_to
    from aadff_tpu_torch.optics.surfaces import SurfaceParams

    jlens.refocus(-2400.0)
    d_sensor, pupilz, pupilr, hfov, r_last, sw, sh, _ = jax_scalars(jlens)
    rng = tuple(range(len(jlens.metas)))
    draws = jax_psf_draws(jax.random.PRNGKey(11), 512)
    pts = np.asarray([[0.0, 0.0, -2400.0], [0.98, 0.98, -20000.0]], np.float32)
    scale = -pts[:, 2] * np.tan(hfov) / r_last
    obj = np.stack([pts[:, 0] * scale * sw / 2, pts[:, 1] * scale * sh / 2,
                    pts[:, 2]], -1).astype(np.float32)

    @jax.jit
    def jax_rays(u_theta, u_r):
        theta = u_theta * 2 * np.pi
        r = jnp.sqrt(u_r * pupilr**2)
        o2 = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta),
                        jnp.full_like(theta, pupilz)], axis=1)
        o = jnp.broadcast_to(obj[None], (len(u_theta),) + obj.shape)
        ray, _ = _trace_impl(jax_make_rays(o, o2[:, None, :] - o), jlens.params,
                             jlens.metas, 0.589, True, False, rng, False)
        return jax_propagate_to(ray, d_sensor)

    ref = jax_rays(jnp.asarray(_np(draws.theta)), jnp.asarray(_np(draws.r)))
    ours = trace_from_points(lens.params, lens.metas, torch.from_numpy(obj),
                             draws.theta, draws.r, torch.tensor(pupilr),
                             torch.tensor(pupilz), torch.tensor(d_sensor), 0.589,
                             rng)
    # the same rays in float64: JAX's f32 start and direction, widened
    o = torch.from_numpy(np.broadcast_to(obj, (512, 2, 3)).copy()).double()
    theta = draws.theta.double()[:, None] * 2 * np.pi
    r = torch.sqrt(draws.r.double()[:, None] * float(pupilr) ** 2)
    o2 = torch.stack(torch.broadcast_tensors(
        r * torch.cos(theta), r * torch.sin(theta),
        torch.tensor(float(pupilz), dtype=torch.float64)), dim=-1)
    d = o2 - o
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    one = torch.ones(o.shape[:-1], dtype=torch.float64)
    params64 = tuple(SurfaceParams(*(t.double() for t in p)) for p in lens.params)
    exact, _ = trace_rays(RayBundle(o, d, one, one, one, 0 * one, 0 * one),
                          params64, lens.metas, 0.589, True, False, rng, False)
    exact = propagate_to(exact, float(d_sensor))
    valid = ((_np(ours.ra) > 0) & (np.asarray(ref.ra) > 0)
             & (_np(exact.ra) > 0))
    err_ours = np.abs(_np(ours.o) - _np(exact.o))[..., :2][valid]
    err_jax = np.abs(np.asarray(ref.o) - _np(exact.o))[..., :2][valid]
    assert valid.sum() > 500
    print(f"measured: psf rays vs float64: port median {np.median(err_ours):.3g} max "
          f"{err_ours.max():.3g}, JAX median {np.median(err_jax):.3g} max {err_jax.max():.3g}")
    assert np.median(err_ours) < np.median(err_jax)
    assert err_ours.max() < err_jax.max()


PSF_POINTS = np.asarray([[0.0, 0.0, -2400.0], [0.5, -0.5, -5000.0],
                         [-0.9, 0.3, -800.0], [0.98, 0.98, -20000.0],
                         [-0.3, -0.7, -1200.0], [0.1, 0.9, -300.0]], np.float32)


def _psf_float64(lens, draws, center, scalars, rng):
    """The PSFs of psf_impl's pipeline with every ray traced in float64: the
    f32 object points and draws widened, pupil rays (and the chief rays
    of the centre) traced through the lens in float64, then the same
    rasteriser, `forward_integral`, on the float64 rays."""
    from aadff_tpu_torch.constants import EPSILON
    from aadff_tpu_torch.optics.lens import trace_rays
    from aadff_tpu_torch.optics.rays import propagate_to
    from aadff_tpu_torch.optics.surfaces import SurfaceParams

    d_sensor, pupilz, pupilr, hfov, r_last, sw, sh, ps = scalars
    p = torch.from_numpy(PSF_POINTS)
    scale = -p[:, 2] * torch.tan(torch.tensor(hfov)) / torch.tensor(r_last)
    obj = torch.stack([p[:, 0] * scale * sw / 2, p[:, 1] * scale * sh / 2,
                       p[:, 2]], -1).double()
    params64 = tuple(SurfaceParams(*(t.double() for t in q)) for q in lens.params)

    def trace(u_theta, u_r, pupil_r):
        theta = u_theta.double()[:, None] * 2 * np.pi
        r = torch.sqrt(u_r.double()[:, None] * pupil_r ** 2)
        o2 = torch.stack(torch.broadcast_tensors(
            r * torch.cos(theta), r * torch.sin(theta),
            torch.tensor(float(pupilz), dtype=torch.float64)), -1)
        o = obj[None].expand(len(u_theta), *obj.shape)
        d = o2 - o
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        one = torch.ones(o.shape[:-1], dtype=torch.float64)
        ray, _ = trace_rays(RayBundle(o, d, one, one, one, 0 * one, 0 * one),
                            params64, lens.metas, 0.589, True, False, rng, False)
        return propagate_to(ray, float(d_sensor))

    ray = trace(draws.theta, draws.r, float(pupilr))
    if center:
        chief = trace(draws.chief_theta, draws.chief_r, float(pupilr) * 0.5)
        pointc = -((chief.o * chief.ra[..., None]).sum(0)
                   / (chief.ra[..., None].sum(0) + EPSILON))[..., :2]
    else:
        pointc = torch.stack([p[:, 0].double() * float(sw) / 2,
                              p[:, 1].double() * float(sh) / 2], -1)
    psf = forward_integral(ray, ps=float(ps), ks=11, pointc_ref=pointc)
    return _np(psf / torch.clamp(psf.sum((-1, -2), keepdim=True), min=EPSILON))


# psf_impl against the same pipeline traced in float64 (ROADMAP C): the
# port's f32 PSF is 1.04e-5 (chief-ray centre) and 8.3e-6 (perspective
# centre) from it, JAX's 9.5e-5 and 1.3e-4.  1e-5 is the goal; the port is
# held to be at least five times closer than JAX, and the perspective case,
# which needs no chief-ray centroid, to the goal itself.
PSF_FLOAT64_GOAL = 1e-5


@pytest.mark.parametrize("center", [True, False], ids=["chief", "perspective"])
def test_psf_impl_against_float64_trace(lens, jlens, center):
    """The port's f32 psf_impl from the draws and lens scalars of
    test_psf_impl_matches_jax against the same pipeline with every ray
    traced in float64 (the oracle), with JAX's distance to the oracle
    printed beside it."""
    jlens.refocus(-2400.0)
    scalars = jax_scalars(jlens)
    key = jax.random.PRNGKey(11)
    draws = jax_psf_draws(key, 512)
    rng = tuple(range(len(jlens.metas)))
    exact = _psf_float64(lens, draws, center, scalars, rng)
    ours = _np(psf_impl(lens.params, lens.metas, torch.from_numpy(PSF_POINTS),
                        draws, 11, 0.589, center, rng,
                        *(float(s) for s in scalars)))
    ref = np.asarray(jax_psf_impl(jlens.params, jlens.metas,
                                  jnp.asarray(PSF_POINTS), key, 11, 512, 0.589,
                                  center, rng, *(jnp.float32(s) for s in scalars)))
    err, err_jax = np.abs(ours - exact).max(), np.abs(ref - exact).max()
    print(f"measured: psf_impl vs float64 ({'chief' if center else 'perspective'}):"
          f" port {err:.3g}, JAX {err_jax:.3g}")
    assert exact.sum() > 5
    assert err <= err_jax / 5, (err, err_jax)
    if not center:
        assert err <= PSF_FLOAT64_GOAL, err


def test_psf_impl_batches_focus_states(lens, jlens):
    """Per-point lens scalars and per-point draws ([n, N]) give each point
    the PSF of its own call, to the summation order of the chief-ray
    centroid over a wider batch (measured 7.5e-6)."""
    rng = tuple(range(len(lens.metas)))
    calls = []
    for depth, key in ((-900.0, 3), (-6000.0, 4)):
        jlens.refocus(depth)
        calls.append((jax_scalars(jlens), jax_psf_draws(jax.random.PRNGKey(key), 128)))
    pts = torch.tensor([[0.2, -0.4, -1000.0], [-0.6, 0.1, -7000.0]])
    one_by_one = torch.cat([
        psf_impl(lens.params, lens.metas, pts[i:i + 1], dr, 11, 0.589, True, rng,
                 *(float(s) for s in sc)) for i, (sc, dr) in enumerate(calls)])
    scal = [torch.tensor([c[0][j] for c in calls]) for j in range(8)]
    draws = PsfDraws(*(torch.stack([c[1][j] for c in calls], dim=1)
                       for j in range(4)))
    batched = psf_impl(lens.params, lens.metas, pts, draws, 11, 0.589, True, rng,
                       *scal)
    np.testing.assert_allclose(_np(batched), _np(one_by_one), rtol=0, atol=2e-5)


def test_psf_sums_to_one(lens):
    pts = torch.tensor([[0.0, 0.0, -2400.0], [0.5, -0.5, -5000.0]])
    psf = lens_psf(lens, pts, ks=11, spp=512,
                   generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_np(psf.sum((-1, -2))), 1.0, atol=1e-5)
    assert (_np(psf) >= 0).all()
    other = Lens(LENS_50F28, sensor_res=RES, device="cpu")
    psf = lens_psf(other, [0.3, -0.4, -3000.0], ks=11, spp=512,
                   generator=torch.Generator().manual_seed(1))
    assert psf.shape == (11, 11)
    np.testing.assert_allclose(float(psf.sum()), 1.0, atol=1e-5)


def test_psf_diff_statistical_parity(goldens):
    """Refocus -> sample -> trace -> rasterise -> normalise against the
    reference PSFs within Monte-Carlo noise (tests/test_psf.py:69-84)."""
    lens = Lens(LENS, sensor_res=RES, device="cpu")
    lens.refocus(-2400.0)
    d_ref = goldens["rf50mm_psf_diff_state"][0]
    assert abs(lens.d_sensor - d_ref) < 2e-2
    pts = torch.tensor([[0.0, 0.0, -2400.0], [0.6, 0.6, -5000.0],
                        [-0.9, 0.3, -800.0]])
    psf = _np(lens_psf(lens, pts, ks=11, spp=32768,
                       generator=torch.Generator().manual_seed(3)))
    err = np.abs(psf - goldens["rf50mm_psf_diff"])
    assert err.max() < 2.5e-2 and err.mean() < 3e-3


def test_psf_center_false_shifts_the_centroid(lens):
    """center=False uses the perspective centre: normalised, centroid moved."""
    pts = torch.tensor([[0.6, 0.6, -2400.0]])
    a = lens_psf(lens, pts, ks=11, spp=512, center=True,
                 generator=torch.Generator().manual_seed(0))
    b = lens_psf(lens, pts, ks=11, spp=512, center=False,
                 generator=torch.Generator().manual_seed(0))

    def centroid(p):
        g = np.arange(11)
        p = _np(p[0])
        return (p.sum(0) @ g, p.sum(1) @ g)

    np.testing.assert_allclose([float(a.sum()), float(b.sum())], 1.0, atol=1e-4)
    assert not np.allclose(centroid(a), centroid(b), atol=0.05)


def test_make_grid_and_mtf_match_jax():
    """make_grid_psf and psf2mtf equal JAX's exactly."""
    rng = np.random.default_rng(2)
    psfs = rng.uniform(0, 1, (5, 3, 11, 11)).astype(np.float32)
    ours = make_grid_psf(torch.from_numpy(psfs), nrow=2)
    ref = jax_make_grid_psf(jnp.asarray(psfs), nrow=2)
    assert ours.shape == (3, 33, 22)
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))
    psf = rng.uniform(0, 1, (32, 32)).astype(np.float32)
    for a, b in zip(psf2mtf(torch.from_numpy(psf), 0.005), jax_psf2mtf(psf, 0.005)):
        np.testing.assert_array_equal(a, b)


def test_lens_psf_map_shape(lens):
    """The RGB PSF map: [3, grid*ks, grid*ks], each tile normalised."""
    psf_map = lens_psf_map(lens, depth=-3000.0, grid=2, ks=9, spp=64,
                           generator=torch.Generator().manual_seed(4))
    assert psf_map.shape == (3, 18, 18)
    np.testing.assert_allclose(_np(psf_map.reshape(3, 2, 9, 2, 9).sum((2, 4))),
                               1.0, atol=1e-5)
