"""The port's optics core (materials, surfaces, the trace, its gradient,
coherent mode) against the JAX package and tests/goldens/optics_goldens.npz,
on the CPU.  Both packages read the in-repo lens files and trace the same
rays; tests/test_torch_lens.py holds the rest of the `Lens`.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadff_tpu.constants import WAVE_RGB
from aadff_tpu.optics import Lens as JaxLens
from aadff_tpu.optics import Material as JaxMaterial
from aadff_tpu.optics import make_rays as jax_make_rays
from aadff_tpu.optics import make_surface as jax_make_surface
from aadff_tpu.optics import ray_reaction as jax_ray_reaction
from aadff_tpu.optics.lens import _trace_impl as jax_trace_impl
from aadff_tpu.optics.rays import propagate_to as jax_propagate_to
from aadff_tpu_torch.optics import Lens, Material, make_rays, make_surface, ray_reaction
from aadff_tpu_torch.optics.rays import propagate_to
from aadff_tpu_torch.optics.surfaces import SurfaceParams

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


# --------------------------------------------------------------------------
# Materials
# --------------------------------------------------------------------------
def test_ior_of_every_glass_matches_jax():
    """Every glass of both lens files, and one of each dispersion model, at
    WAVE_RGB: the port's index equals JAX's to 1e-12."""
    names = {"n-bk7", "pmma", "1.83481/42.7"}
    for path in LENSES.values():
        with open(path) as f:
            for sd in json.load(f)["surfaces"]:
                names |= {sd["mat1"], sd["mat2"]}
    err = 0.0
    for name in sorted(names):
        ours, ref = Material.create(name), JaxMaterial.create(name)
        assert ours.dispersion == ref.dispersion
        for w in WAVE_RGB:
            err = max(err, abs(ours.ior(w) - ref.ior(w)))
            assert abs(ours.ior(w) - ref.ior(w)) <= 1e-12, (name, w)
    print(f"measured: ior max-abs {err:.3g}")


# --------------------------------------------------------------------------
# Single-surface analytic checks (tests/test_optics_core.py:41-66)
# --------------------------------------------------------------------------
def test_snell_flat_glass_interface():
    n2 = 1.5
    p, meta = make_surface("stop", r=10.0, d=5.0, c=0.0, mat1="air", mat2=f"{n2}/50")
    ang_i = 0.3
    d = [math.sin(ang_i), 0.0, math.cos(ang_i)]
    ray = make_rays([[0.0, 0.0, 0.0]], [d])
    out = ray_reaction(ray, p, meta, wvln=0.5893, forward=True)
    assert abs(float(out.d[0, 0]) - math.sin(ang_i) / n2) < 1e-5
    assert float(out.ra[0]) == 1.0


def test_sphere_intersection_analytic():
    c = 0.05  # roc 20 mm
    p, meta = make_surface("spheric", r=8.0, d=10.0, c=c, mat1="air", mat2="n-bk7")
    x0 = 3.0
    ray = make_rays([[x0, 0.0, 0.0]], [[0.0, 0.0, 1.0]])
    out = ray_reaction(ray, p, meta, wvln=0.5893, forward=True)
    R = 1 / c
    z_expected = 10.0 + R - math.sqrt(R**2 - x0**2)
    assert abs(float(out.o[0, 2]) - z_expected) < 1e-5
    assert abs(float(out.o[0, 0]) - x0) < 1e-6


def test_paraxial_focal_length_single_lens():
    """Thick plano-convex lens: the back focus of a paraxial ray."""
    n, R, thickness = 1.5, 50.0, 1.0
    p1, m1 = make_surface("spheric", r=10.0, d=0.0, c=1 / R, mat1="air", mat2=f"{n}/60")
    p2, m2 = make_surface("stop", r=10.0, d=thickness, c=0.0, mat1=f"{n}/60", mat2="air")
    lens = Lens(device="cpu")
    lens.params, lens.metas = (p1, p2), (m1, m2)
    out, _, _ = lens.trace(make_rays([[0.05, 0.0, -1.0]], [[0.0, 0.0, 1.0]]),
                           forward=True)
    t = -float(out.o[0, 0]) / float(out.d[0, 0])
    z_focus = float(out.o[0, 2]) + float(out.d[0, 2]) * t
    f = R / (n - 1)
    assert abs(z_focus - (thickness + f * (1 - thickness * (n - 1) / (n * R)))) < 0.02


# --------------------------------------------------------------------------
# Trace
# --------------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(LENSES))
@pytest.mark.parametrize("wvln", WAVE_RGB)
def test_trace_matches_goldens(goldens, lenses, key, wvln):
    """The golden input rays -> sensor endpoints, with the tolerances of
    tests/test_optics_core.py:111-132 (o 1e-3, d 2e-5, obliq 1e-4 on the
    rays valid in both; masks agree on > 99.9%)."""
    lens = lenses[key][0]
    ray = make_rays(goldens[f"{key}_ray_o_in"], goldens[f"{key}_ray_d_in"])
    out = lens.trace2sensor(ray, wvln=wvln)
    w = str(wvln).replace(".", "")
    ra_ref = goldens[f"{key}_w{w}_ra"]
    ra = _np(out.ra)
    assert (ra == ra_ref).mean() > 0.999
    m = (ra > 0) & (ra_ref > 0)
    print(f"measured: golden trace {key} w{w} o "
          f"{np.abs(_np(out.o)[m] - goldens[f'{key}_w{w}_o'][m]).max():.3g} d "
          f"{np.abs(_np(out.d)[m] - goldens[f'{key}_w{w}_d'][m]).max():.3g} obliq "
          f"{np.abs(_np(out.obliq)[m] - goldens[f'{key}_w{w}_obliq'][m]).max():.3g}")
    np.testing.assert_allclose(_np(out.o)[m], goldens[f"{key}_w{w}_o"][m], atol=1e-3)
    np.testing.assert_allclose(_np(out.d)[m], goldens[f"{key}_w{w}_d"][m], atol=2e-5)
    np.testing.assert_allclose(_np(out.obliq)[m], goldens[f"{key}_w{w}_obliq"][m],
                               atol=1e-4)


def _near_rays(lens, n=48, seed=0):
    """Rays from points 20 mm before the first surface through the inner 60%
    of its aperture, near the lens's axis of view.  (Rays from metres away
    lose the last digits of o + t d to the f32 rounding of |o| ~ 1e3, which
    XLA, fusing the multiply-add, rounds once and PyTorch twice: 1 ulp of
    3,000 is 2.4e-4.)"""
    rng = np.random.default_rng(seed)
    z0 = float(lens.params[0].d)
    r0 = 0.6 * lens.metas[0].r
    tgt = np.stack([rng.uniform(-r0, r0, n), rng.uniform(-r0, r0, n),
                    np.full(n, z0)], -1).astype(np.float32)
    o = np.stack([0.8 * tgt[:, 0] + rng.uniform(-1, 1, n),
                  0.8 * tgt[:, 1] + rng.uniform(-1, 1, n),
                  np.full(n, z0 - 20.0)], -1).astype(np.float32)
    return o, tgt - o


@pytest.mark.parametrize("key", sorted(LENSES))
def test_trace_matches_jax_trace(lenses, key):
    """The same rays through `trace_rays` and JAX's `_trace_impl` (record
    on): `ra` equal, every recorded o and the final d within 1e-5."""
    lens, jlens = lenses[key]
    o, d = _near_rays(lens)
    rng = tuple(range(len(lens.metas)))
    ours, oss = lens.trace(make_rays(o, d), record=True, forward=True)[0::2]
    ref, ref_oss = jax_trace_impl(jax_make_rays(o, d), jlens.params, jlens.metas,
                                  0.589, True, False, rng, True)
    np.testing.assert_array_equal(_np(ours.ra), np.asarray(ref.ra))
    assert _np(ours.ra).sum() >= 16
    print(f"measured: trace vs JAX {key} o {np.abs(_np(oss) - np.asarray(ref_oss)).max():.3g}"
          f" d {np.abs(_np(ours.d) - np.asarray(ref.d)).max():.3g}")
    np.testing.assert_allclose(_np(oss), np.asarray(ref_oss), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(ours.d), np.asarray(ref.d), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(ours.obliq), np.asarray(ref.obliq), rtol=0,
                               atol=1e-5)


def test_backward_trace_roundtrip(lenses):
    """Trace forward, reverse the exit ray: it comes back to the object."""
    lens = lenses["rf50mm"][0]
    o = torch.tensor([[1.0, 0.5, -3000.0]])
    tgt = torch.tensor([[0.0, 0.0, float(lens.params[0].d)]])
    out = lens.trace2sensor(make_rays(o, tgt - o))
    assert float(out.ra[0]) == 1.0
    back, _, _ = lens.trace(make_rays(out.o, -out.d), forward=False)
    back = propagate_to(back, -3000.0)
    assert float(back.ra[0]) == 1.0
    np.testing.assert_allclose(_np(back.o[0, :2]), [1.0, 0.5], atol=1e-3)


# --------------------------------------------------------------------------
# Gradient
# --------------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(LENSES))
def test_gradient_matches_jax_grad(lenses, key):
    """d(sum of sensor x)/d(c, d, k, ai) of every surface on the same rays,
    against jax.grad, within rtol 1e-3 (atol 1e-3 of the largest)."""
    lens, jlens = lenses[key]
    o, d = _near_rays(lens, n=64, seed=1)
    rng = tuple(range(len(lens.metas)))
    params = tuple(SurfaceParams(*(t.clone().requires_grad_(True) for t in p))
                   for p in lens.params)
    from aadff_tpu_torch.optics.lens import trace_rays

    out, _ = trace_rays(make_rays(o, d), params, lens.metas, 0.589, True, False,
                        rng, False)
    out = propagate_to(out, lens.d_sensor)
    loss = out.o[..., 0].sum()
    # a stop's or a sphere's unused ai gets a zero gradient, as in JAX
    grads = torch.autograd.grad(loss, [t for p in params for t in p],
                                allow_unused=True, materialize_grads=True)
    ours = np.concatenate([_np(g).ravel() for g in grads])

    def jloss(ps):
        r, _ = jax_trace_impl(jax_make_rays(o, d), ps, jlens.metas, 0.589, True,
                              False, rng, False)
        return jnp.sum(jax_propagate_to(r, jlens.d_sensor).o[..., 0])

    jg = jax.grad(jloss)(jlens.params)
    ref = np.concatenate([np.asarray(t).ravel() for p in jg for t in p])
    assert np.isfinite(ours).all() and np.abs(ref).max() > 0
    print(f"measured: gradient {key} max-abs diff / max |grad| "
          f"{np.abs(ours - ref).max() / np.abs(ref).max():.3g}")
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())


# --------------------------------------------------------------------------
# Coherent mode (after tests/test_misc_parity.py:14-100)
# --------------------------------------------------------------------------
def test_coherent_trace_matches_jax(lenses):
    """OPL through the whole rf50mm lens; the phase is finite.  (The phase
    of rays from 1 m, k (t - min t) mod 2 pi with k ~ 1e4 / mm, keeps no
    digit that f32 t ~ 1e3 can hold, in either package.)"""
    lens, jlens = lenses["rf50mm"]
    o = np.asarray([[0.5, 0.0, -1000.0], [1.5, 0.5, -1000.0], [-2.0, 1.0, -1000.0]],
                   np.float32)
    d = -o
    ours, valid, _ = lens.trace(make_rays(o, d), coherent=True)
    ref, _, _ = jlens.trace(jax_make_rays(o, d), coherent=True)
    assert bool(valid.all())
    opl = _np(ours.opl)
    assert (opl > 0).all()
    np.testing.assert_allclose(opl, np.asarray(ref.opl), rtol=1e-6, atol=2e-3)
    assert np.isfinite(_np(ours.phi)).all()


def _stop_case(z_src, n_rays=48, r_stop=4.0, seed=7):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, n_rays), rng.uniform(-3, 3, n_rays),
                  np.full(n_rays, z_src)], -1).astype(np.float32)
    tgt = np.stack([rng.uniform(-1.5 * r_stop, 1.5 * r_stop, n_rays),
                    rng.uniform(-1.5 * r_stop, 1.5 * r_stop, n_rays),
                    np.zeros(n_rays)], -1).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p, meta = make_surface("stop", r=r_stop, d=0.0)
    jp, jmeta = jax_make_surface("stop", r=r_stop, d=0.0)
    ours = ray_reaction(make_rays(o, d), p, meta, 0.589, True, coherent=True)
    ref = jax_ray_reaction(jax_make_rays(o, d), jp, jmeta, 0.589, True, coherent=True)
    return ours, ref


@pytest.mark.parametrize("z_src", [-1000.0, -50.0], ids=["far_field", "near_field"])
def test_coherent_stop_matches_jax(z_src):
    """A flat stop, far field (every ray > 100 mm: the projected OPD, no
    phase update) and near field (masked opl += n t and phase)."""
    ours, ref = _stop_case(z_src)
    ra = _np(ours.ra)
    np.testing.assert_array_equal(ra, np.asarray(ref.ra))
    assert 0 < ra.sum() < ra.size
    np.testing.assert_allclose(_np(ours.o), np.asarray(ref.o), atol=1e-5)
    np.testing.assert_allclose(_np(ours.opl), np.asarray(ref.opl), rtol=1e-6, atol=1e-4)
    dphi = _np(ours.phi) - np.asarray(ref.phi)
    np.testing.assert_allclose(np.abs(np.exp(1j * dphi) - 1.0), 0.0, atol=0.02)


def test_coherent_gradient_from_origin_ray_is_finite():
    """A ray whose origin is the coordinate origin (|o0| = 0) makes the
    far-field OPD 0/0 in the branch torch.where does not select; the
    clamped norm keeps the gradient of a near-field coherent trace finite,
    and equal to JAX's."""
    p, meta = make_surface("stop", r=4.0, d=5.0)
    jp, jmeta = jax_make_surface("stop", r=4.0, d=5.0)
    o = np.asarray([[0.0, 0.0, 0.0], [0.5, -0.2, 0.0]], np.float32)
    d = np.asarray([[0.1, 0.0, 1.0], [0.0, 0.1, 1.0]], np.float32)
    dz = torch.tensor(5.0, requires_grad=True)
    out = ray_reaction(make_rays(o, d), p._replace(d=dz), meta, 0.589, True,
                       coherent=True)
    (g,) = torch.autograd.grad(out.opl.sum() + out.o.sum(), dz)

    def jloss(dv):
        r = jax_ray_reaction(jax_make_rays(o, d), jp._replace(d=dv), jmeta, 0.589,
                             True, coherent=True)
        return r.opl.sum() + r.o.sum()

    ref = float(jax.grad(jloss)(jnp.float32(5.0)))
    assert np.isfinite(float(g))
    assert abs(float(g) - ref) <= 1e-5 * max(1.0, abs(ref))
