"""The port's `Lens` (derived values, pupils, refocus, JSON, lens
operations, samplers, geometry) and `analysis_rms` against the JAX package
and tests/goldens/optics_goldens.npz, on the CPU.

Where each package draws its own random numbers (refocus, the random
samplers, the RMS spots), the tolerance is a Monte-Carlo one.
"""
import os

import jax
import numpy as np
import pytest
import torch

from aadff_tpu.optics import Lens as JaxLens
from aadff_tpu.optics import make_rays as jax_make_rays
from aadff_tpu_torch.optics import Lens, make_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENSES = {"rf50mm": os.path.join(REPO, "lenses", "rf50mm.json"),
          "50mm_f2_8": os.path.join(REPO, "lenses", "50mm_f2.8.json")}
GOLDENS = os.path.join(REPO, "tests", "goldens", "optics_goldens.npz")
RES = (480, 640)


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
def lenses():
    """{name: (port Lens, JAX Lens)} at 480x640, built once."""
    return {k: (Lens(p, sensor_res=RES, device="cpu"), JaxLens(p, sensor_res=RES))
            for k, p in LENSES.items()}


def _np(t):
    return t.detach().cpu().numpy()


def _near_rays(lens, n=48, seed=0):
    """Rays from points 20 mm before the first surface through the inner 60%
    of its aperture (as in tests/test_torch_optics.py)."""
    rng = np.random.default_rng(seed)
    z0 = float(lens.params[0].d)
    r0 = 0.6 * lens.metas[0].r
    tgt = np.stack([rng.uniform(-r0, r0, n), rng.uniform(-r0, r0, n),
                    np.full(n, z0)], -1).astype(np.float32)
    o = np.stack([0.8 * tgt[:, 0] + rng.uniform(-1, 1, n),
                  0.8 * tgt[:, 1] + rng.uniform(-1, 1, n),
                  np.full(n, z0 - 20.0)], -1).astype(np.float32)
    return o, tgt - o


# --------------------------------------------------------------------------
# Lens
# --------------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(LENSES))
def test_lens_derived_values_and_pupils(goldens, lenses, key):
    """foclen, fnum, hfov, d_sensor and the entrance pupil against the
    goldens within 1e-3 (tests/test_optics_core.py:100-108)."""
    lens = lenses[key][0]
    foclen, fnum, hfov, d_sensor = goldens[f"{key}_derived"]
    assert abs(lens.foclen - foclen) < 1e-3
    assert abs(lens.fnum - fnum) < 1e-3
    assert abs(lens.hfov - hfov) < 1e-4
    assert abs(lens.d_sensor - d_sensor) < 1e-9
    z, r = lens.entrance_pupil()
    pz, pr = goldens[f"{key}_pupil"]
    assert abs(z - pz) < 1e-3 and abs(r - pr) < 1e-3


@pytest.mark.parametrize("key", sorted(LENSES))
def test_refocus_matches_goldens(goldens, key):
    """The refocused sensor at 500 / 2,400 / 20,000 mm within the goldens'
    Monte-Carlo tolerance (tests/test_optics_core.py:136-148), and the
    memo returns the same state."""
    for depth in [-500.0, -2400.0, -20000.0]:
        lens = Lens(LENSES[key], sensor_res=RES, device="cpu")
        lens.refocus(depth)
        d_ref, hfov_ref, fnum_ref = goldens[f"{key}_refocus_{-int(depth)}"]
        assert abs(lens.d_sensor - d_ref) < 2e-2, (depth, lens.d_sensor, d_ref)
        assert abs(lens.hfov - hfov_ref) < 1e-3
        assert abs(lens.fnum - fnum_ref) < 2e-2
        d1 = lens.d_sensor
        lens.refocus(-1500.0)
        lens.refocus(depth)
        assert lens.d_sensor == d1


def test_lens_json_roundtrip(tmp_path, lenses):
    """The port's lens.json reads back equal in the port and in JAX."""
    lens = lenses["rf50mm"][0]
    path = str(tmp_path / "lens.json")
    lens.write_lens_json(path)
    again = Lens(path, sensor_res=RES, device="cpu")
    jax_again = JaxLens(path, sensor_res=RES)
    assert abs(again.foclen - lens.foclen) < 1e-3
    assert abs(again.d_sensor - lens.d_sensor) < 1e-6
    for p1, p2, p3 in zip(lens.params, again.params, jax_again.params):
        for a, b, c in zip(p1, p2, p3):
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-7)
            np.testing.assert_allclose(np.asarray(c), _np(a), atol=1e-7)
    assert [m.r for m in again.metas] == [m.r for m in lens.metas]


def _same_state(lens, jlens, atol=1e-6):
    for p, jp in zip(lens.params, jlens.params):
        for a, b in zip(p, jp):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=atol)
    np.testing.assert_allclose([m.r for m in lens.metas],
                               [m.r for m in jlens.metas], rtol=0, atol=atol)
    assert lens._focus_cache == {} and lens._pupil_cache == {}


def test_lens_operations_match_jax():
    """refocus_inf, then perturb (same numpy stream), pruning_v2,
    prune_surf, correct_shape and set_aperture, in turn on one lens of each
    package: the same sensor, parameters and apertures, and the caches
    cleared after each lens operation."""
    lens = Lens(LENSES["rf50mm"], sensor_res=RES, device="cpu")
    jlens = JaxLens(LENSES["rf50mm"], sensor_res=RES)
    lens.refocus_inf()
    jlens.refocus_inf()
    assert abs(lens.d_sensor - jlens.d_sensor) < 1e-4
    assert abs(lens.hfov - jlens.hfov) < 1e-6
    lens._focus_cache[-1.0] = "a state perturb must clear"
    lens.perturb(rng=np.random.default_rng(5))
    jlens.perturb(rng=np.random.default_rng(5))
    _same_state(lens, jlens, atol=0)
    lens.pruning_v2()
    jlens.pruning_v2()
    _same_state(lens, jlens, atol=1e-4)
    lens.prune_surf(outer=0.2)
    jlens.prune_surf(outer=0.2)
    _same_state(lens, jlens, atol=1e-4)
    assert lens.correct_shape() == jlens.correct_shape()
    _same_state(lens, jlens, atol=1e-4)
    lens.set_aperture(fnum=2.8)
    jlens.set_aperture(fnum=2.8)
    _same_state(lens, jlens, atol=1e-4)
    assert abs(lens.fnum - jlens.fnum) < 1e-6
    assert abs(lens.entrance_pupil()[1] - jlens.entrance_pupil()[1]) < 1e-4
    assert lens.max_height(1) == pytest.approx(jlens.max_height(1), abs=1e-5)


# --------------------------------------------------------------------------
# Samplers and geometry
# --------------------------------------------------------------------------
def test_deterministic_samplers_match_jax(lenses):
    """The samplers without random draws give JAX's rays: 2D fans (plain,
    entrance pupil, point source) and the parallel grid."""
    lens, jlens = lenses["rf50mm"]
    cases = [
        ("sample_parallel_2D", dict(R=5.0, M=7, view=3.0)),
        ("sample_parallel_2D", dict(R=5.0, M=7, forward=False)),
        ("sample_parallel_2D", dict(M=9, view=10.0, entrance_pupil=True)),
        ("sample_point_source_2D", dict(depth=-2000.0, view=5.0, M=9)),
        ("sample_parallel", dict(fov=4.0, M=5)),
        ("sample_parallel", dict(fov=2.0, M=4, entrance_pupil=True)),
    ]
    for name, kw in cases:
        ours = getattr(lens, name)(**kw)
        ref = getattr(jlens, name)(**kw)
        np.testing.assert_allclose(_np(ours.o), np.asarray(ref.o), rtol=0,
                                   atol=1e-5, err_msg=f"{name} {kw}")
        np.testing.assert_allclose(_np(ours.d), np.asarray(ref.d), rtol=0,
                                   atol=1e-7, err_msg=f"{name} {kw}")


def test_geometry_matches_jax(lenses):
    """Principal planes, back focal length, exit pupil, the pinhole scale and
    the trace back to the object against JAX."""
    lens, jlens = lenses["50mm_f2_8"]
    np.testing.assert_allclose(lens.calc_principal(), jlens.calc_principal(),
                               atol=1e-4)
    assert abs(lens.calc_foclen() - jlens.calc_foclen()) < 1e-4
    np.testing.assert_allclose(lens.exit_pupil(), jlens.exit_pupil(), atol=1e-4)
    np.testing.assert_allclose(lens.calc_scale_pinhole([-1000.0, -5000.0]),
                               jlens.calc_scale_pinhole([-1000.0, -5000.0]),
                               rtol=1e-6)
    o, d = _near_rays(lens, n=16, seed=3)
    out, _, _ = lens.trace(make_rays(o, d))
    ref, _, _ = jlens.trace(jax_make_rays(o, d))
    back = lens.trace2obj(make_rays(_np(out.o), -_np(out.d)), depth=-30.0)
    jback = jlens.trace2obj(jax_make_rays(np.asarray(ref.o), -np.asarray(ref.d)),
                            depth=-30.0)
    m = (_np(back.ra) > 0) & (np.asarray(jback.ra) > 0)
    assert m.sum() >= 4
    np.testing.assert_allclose(_np(back.o)[m], np.asarray(jback.o)[m], atol=1e-3)


def test_random_samplers_shapes_and_statistics(lenses):
    """The samplers that draw: shapes, rays on their planes, and the
    focus distance and magnification within Monte-Carlo noise of JAX's."""
    lens, jlens = lenses["rf50mm"]
    g = torch.Generator().manual_seed(0)
    pupil = lens.sample_pupil(res=(3, 4), spp=16, generator=g)
    assert pupil.shape == (16, 3, 4, 3)
    assert float(torch.linalg.vector_norm(pupil[..., :2], dim=-1).max()) <= \
        lens.entrance_pupil()[1] + 1e-5
    assert lens.sample_pupil(res=(2, 2), spp=12, generator=g).shape == (12, 2, 2, 3)
    ray = lens.sample_point_source(M=5, spp=8, depth=-1000.0, generator=g)
    assert ray.o.shape == (8, 5, 5, 3)
    small = Lens(LENSES["rf50mm"], sensor_res=(6, 8), device="cpu")
    ray = small.sample_sensor(spp=8, generator=g)
    assert ray.o.shape == (8, 6, 8, 3)
    np.testing.assert_allclose(_np(ray.o[..., 2]), small.d_sensor)
    ray = lens.sample_from_points(((0.0, 0.0, -5000.0), (10.0, 5.0, -5000.0)),
                                  spp=32, generator=g)
    assert ray.o.shape == (32, 2, 3)
    ray = lens.sample_parallel(fov=1.0, M=6, sampling="radial", generator=g)
    assert ray.o.shape == (6, 6, 3)
    # statistics against JAX: 2,048 rays (the sensor moved behind the
    # infinity focus in both), and 21 x 21 points x 512 rays
    near = Lens(LENSES["rf50mm"], sensor_res=RES, device="cpu")
    jnear = JaxLens(LENSES["rf50mm"], sensor_res=RES)
    near.d_sensor = jnear.d_sensor = 61.0
    foc = near.calc_foc_dist(generator=g)
    jfoc = jnear.calc_foc_dist(key=jax.random.PRNGKey(0))
    assert foc < 0 and abs(foc - jfoc) < 0.02 * abs(jfoc), (foc, jfoc)
    mag = lens.calc_magnification3(-3000.0, generator=g)
    jmag = jlens.calc_magnification3(-3000.0, key=jax.random.PRNGKey(1))
    assert abs(mag - jmag) < 0.01 * abs(jmag)


def test_analysis_rms_near_jax(lenses, monkeypatch):
    """RMS spot radii (256 rays a point): the mean and the on-axis within
    10% of JAX's, the off-axis corner within 25% (its field position
    follows each package's own ray-traced magnification, and vignetting
    there is steep); each package draws its own rays."""
    from aadff_tpu.optics import analysis as jax_analysis
    from aadff_tpu_torch.optics import analysis

    monkeypatch.setattr(analysis, "GEO_SPP", 256)
    monkeypatch.setattr(jax_analysis, "GEO_SPP", 256)
    lens, jlens = lenses["rf50mm"]
    ours = analysis.analysis_rms(lens, depth=-5000.0, seed=0)
    ref = jax_analysis.analysis_rms(jlens, depth=-5000.0, key=jax.random.PRNGKey(0))
    print(f"measured: analysis_rms {ours} vs JAX {ref}")
    np.testing.assert_allclose(ours[:2], ref[:2], rtol=0.1)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0.25)
