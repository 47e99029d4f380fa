"""The port's PSF surrogate and renderer against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
fused render is compared through its plain PyTorch version, which is what a
CPU tensor runs (the CUDA kernel is held to it on the card by chip_smoke.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.ops.pallas_render import fused_render_stack
from aadff_tpu.ops.render import local_psf_render as jax_local_psf_render
from aadff_tpu.psfnet import MLP as JaxMLP
from aadff_tpu.psfnet import PSFNet as JaxPSFNet
from aadff_tpu_torch.ops import fused_render, mlp_psf
from aadff_tpu_torch.ops.render import local_psf_render
from aadff_tpu_torch.psfnet import psfnet
from aadff_tpu_torch.psfnet.arch import MLP
from aadff_tpu_torch.psfnet.convert import flax_mlp_to_torch_state
from aadff_tpu_torch.psfnet.psfnet import PSFNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
RENDER_GOLDENS = os.path.join(REPO, "tests", "goldens", "render_goldens.npz")
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
D_MIN, D_MAX = -200.0, -20000.0  # PSFNet's normalisation endpoints


@pytest.fixture(scope="module")
def flax_variables():
    with open(PSFNET_CKPT, "rb") as f:
        return msgpack_restore(f.read())


@pytest.fixture(scope="module")
def torch_mlp(flax_variables):
    mlp = MLP()
    mlp.load_state_dict(flax_mlp_to_torch_state(flax_variables))
    return mlp.requires_grad_(False)


@pytest.fixture
def route_spy(monkeypatch):
    """Counts the calls PSFNet makes to the fused render and to the PSF MLP
    wrapper of the two-stage route."""
    calls = {"fused": 0, "mlp_psf": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(psfnet, "fused_psf_render",
                        spy("fused", fused_render.fused_psf_render))
    monkeypatch.setattr(psfnet, "mlp_psf", spy("mlp_psf", mlp_psf.mlp_psf))
    return calls


def _random_mlp(seed):
    """Random Flax MLP params and the same weights in the port's MLP."""
    model = JaxMLP(in_features=4, out_features=121, hidden_features=256,
                   hidden_layers=8)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4)))
    variables = jax.tree.map(np.asarray, variables)
    mlp = MLP()
    mlp.load_state_dict(flax_mlp_to_torch_state(variables))
    return model, variables, mlp.requires_grad_(False)


def test_mlp_matches_jax(flax_variables, torch_mlp):
    """4096 random field rows through both MLPs, within the 2e-6 of
    test_psfnet_render.py:61 (f32 matmul summation order)."""
    x = np.random.default_rng(0).uniform(-1, 1, (4096, 4)).astype(np.float32)
    model = JaxMLP(in_features=4, out_features=121, hidden_features=256,
                   hidden_layers=8)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(model.apply(flax_variables, jnp.asarray(x)))
    ours = torch_mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-6)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)


# XLA on the CPU turns jnp.linspace's division by (num - 1) into a multiply
# by its reciprocal and may fuse the products, so the field's coordinates
# can differ from the port's in the last bit: 2e-7 is under 2 ulp at 1.
FIELD_ATOL = 2e-7


@pytest.mark.parametrize("num", [1, 2, 7, 128, 640])
def test_linspace_matches_jnp_linspace(num):
    for start, stop in ((-1.0, 1.0), (1.0, -1.0)):
        ours = fused_render.jax_linspace(start, stop, num).numpy()
        ref = np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=FIELD_ATOL)
        assert ours[0] == start and ours[-1] == (stop if num > 1 else start)


def test_psf_field_matches_jax_field():
    """(x, y, z, foc_z) as fused_render_frame builds it
    (pallas_render.py:264-273)."""
    rng = np.random.default_rng(1)
    N, H, W = 2, 9, 13
    depth = -rng.uniform(50, 25000, (N, H, W)).astype(np.float32)
    foc = -rng.uniform(50, 25000, (N,)).astype(np.float32)
    z = jnp.clip((depth - D_MIN) / (D_MAX - D_MIN), 0.0, 1.0)
    x, y = jnp.meshgrid(jnp.linspace(-1, 1, W), jnp.linspace(1, -1, H),
                        indexing="xy")
    fz = jnp.clip((foc - D_MIN) / (D_MAX - D_MIN), 0.0, 1.0)
    ref = np.stack([np.broadcast_to(x, (N, H, W)),
                    np.broadcast_to(y, (N, H, W)), np.asarray(z),
                    np.broadcast_to(np.asarray(fz)[:, None, None], (N, H, W))],
                   axis=-1)
    ours = fused_render.psf_field(torch.from_numpy(depth),
                                  torch.from_numpy(foc), D_MIN, D_MAX)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=FIELD_ATOL)


@pytest.mark.parametrize("ks", [5, 11])
def test_local_psf_render_matches_jax(ks):
    """The tap loop with edge padding against ops/render.py:68-94, within
    1e-6 (f32 sums of ks^2 products in the same order)."""
    rng = np.random.default_rng(2)
    B, C, H, W = 2, 3, 16, 20
    img = rng.uniform(0, 1, (B, C, H, W)).astype(np.float32)
    psf = rng.uniform(0, 1, (B, H, W, ks, ks)).astype(np.float32)
    psf /= psf.sum(axis=(-1, -2), keepdims=True)
    ref = np.asarray(jax_local_psf_render(jnp.asarray(img), jnp.asarray(psf), ks))
    ours = local_psf_render(torch.from_numpy(img), torch.from_numpy(psf), ks)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)


def test_render_stack_matches_jax_fused_kernel():
    """The port's plain stack render against the Pallas whole-stack kernel in
    interpret mode, as tests/test_pallas.py:170-205 runs it (B=2, S=3,
    64x128), within the 5e-6 of test_pallas.py:98."""
    model, variables, mlp = _random_mlp(5)
    rng = np.random.default_rng(5)
    S, H, W = 3, 64, 128
    img = rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    depth = -rng.uniform(500, 15000, (2, 1, H, W)).astype(np.float32)
    focus = -np.sort(rng.uniform(500, 15000, (2, S)))[:, ::-1].astype(np.float32)
    ref = np.asarray(fused_render_stack(
        variables, jnp.asarray(img), jnp.asarray(depth), jnp.asarray(focus),
        11, D_MIN, D_MAX, interpret=True))
    net = PSFNet(device="cpu", sensor_res=(H, W))
    net.model = mlp
    ours = net.render_stack(img, depth, focus).numpy()
    assert ours.shape == (2, S, 3, H, W)
    np.testing.assert_allclose(ours, ref, atol=5e-6)


def test_psfnet_render_golden(route_spy):
    """PSFNet.render on render_goldens.npz with the converted checkpoint:
    `rendered` < 2e-4 and `psf_field_sample` within 1e-5, the tolerances of
    test_psfnet_render.py:143,156.  The 120x160 golden on the 480x640
    PSFNet is not a sensor-sized frame, so it takes the two-stage route
    field -> mlp_psf -> local_psf_render, as in the JAX package
    (psfnet.py:591-614)."""
    g = np.load(RENDER_GOLDENS)
    net = PSFNet(kernel_size=11, sensor_res=(480, 640), device="cpu")
    net.load_net(PSFNET_CKPT)
    out = net.render(g["img"], g["depth"], g["foc"]).numpy()
    assert route_spy == {"fused": 0, "mlp_psf": 1}
    assert np.abs(out - g["rendered"]).max() < 2e-4

    H, W = g["img"].shape[2:]
    z = np.clip((g["depth"][:, 0] - net.d_min) / (net.d_max - net.d_min), 0, 1)
    xg, yg = np.meshgrid(np.linspace(-1, 1, W), np.linspace(1, -1, H),
                         indexing="xy")
    fz = np.clip((g["foc"][0] - net.d_min) / (net.d_max - net.d_min), 0, 1)
    field = np.stack([xg, yg, z[0], np.full_like(xg, fz)], -1).astype(np.float32)
    psf = net.pred(field).numpy()
    np.testing.assert_allclose(psf[::37, ::41], g["psf_field_sample"], atol=1e-5)


def test_render_frame_is_stack_with_one_frame(torch_mlp):
    net = PSFNet(device="cpu", sensor_res=(12, 10))
    net.model = torch_mlp
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 3, 12, 10)).astype(np.float32)
    depth = -rng.uniform(500, 15000, (2, 1, 12, 10)).astype(np.float32)
    focus = np.asarray([[-900.0, -2400.0], [-5000.0, -700.0]], np.float32)
    stack = net.render_stack(img, depth, focus)
    for s in range(2):
        frame = net.render(img, depth[:, 0], focus[:, s])
        torch.testing.assert_close(frame, stack[:, s], rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version(torch_mlp):
    """A CPU tensor runs fused_psf_render_reference and launches nothing."""
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(0, 1, (1, 3, 7, 9)).astype(np.float32))
    depth = torch.from_numpy(-rng.uniform(500, 15000, (1, 7, 9)).astype(np.float32))
    focus = torch.tensor([[-900.0, -2000.0, -4000.0]])
    before = fused_render.launches
    out = fused_render.fused_psf_render(torch_mlp, img, depth, focus, 11,
                                        D_MIN, D_MAX)
    assert fused_render.launches == before
    ref = fused_render.fused_psf_render_reference(torch_mlp, img, depth, focus,
                                                  11, D_MIN, D_MAX)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert out.shape == (1, 3, 3, 7, 9)


def test_other_devices_are_refused(torch_mlp):
    img = torch.empty(1, 3, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no fused render"):
        fused_render.fused_psf_render(torch_mlp, img, img[:, 0], img[:, 0, 0],
                                      11, D_MIN, D_MAX)


def test_pack_mlp_weights_layout(torch_mlp):
    """The kernel's packed layout holds W^T and the bias of every layer,
    zero-padded to 128 or 256 outputs, at 16-byte-aligned offsets."""
    wpack, layout = fused_render.pack_mlp_weights(torch_mlp)
    rows = [layout[i:i + 5] for i in range(0, len(layout), 5)]
    assert [(k, f, fpad) for k, f, fpad, _, _ in rows] == (
        [(4, 64, 128), (64, 256, 256)] + [(256, 256, 256)] * 8
        + [(256, 121, 128)])
    for lin, (k, f, fpad, w_off, b_off) in zip(torch_mlp.linears(), rows):
        assert w_off % 4 == 0 and b_off % 4 == 0
        wt = wpack[w_off:w_off + k * fpad].reshape(k, fpad)
        torch.testing.assert_close(wt[:, :f], lin.weight.t(), rtol=0, atol=0)
        assert not wt[:, f:].any()
        b = wpack[b_off:b_off + fpad]
        torch.testing.assert_close(b[:f], lin.bias, rtol=0, atol=0)
        assert not b[f:].any()
    assert wpack.numel() == rows[-1][4] + rows[-1][2]


def test_render_path_label():
    """The label names the route a frame of the given size takes."""
    net = PSFNet(device="cpu")
    assert net.render_path() == "torch-mlp+taploop(f32)"
    assert net.render_path((120, 160)) == "torch-mlp+taploop(f32)"
    net.device = torch.device("cuda")  # the label only; nothing runs
    assert net.render_path() == "fused-mlp+conv(f32,cuda)"
    assert net.render_path((120, 160)) == "mlp-psf(f32,cuda)+taploop"


def test_sensor_sized_frames_take_the_fused_route(route_spy, torch_mlp):
    net = PSFNet(device="cpu", sensor_res=(12, 10))
    net.model = torch_mlp
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (2, 3, 12, 10)).astype(np.float32)
    depth = -rng.uniform(500, 15000, (2, 1, 12, 10)).astype(np.float32)
    net.render_stack(img, depth, np.full((2, 3), -900.0, np.float32))
    net.render(img, depth, np.full(2, -900.0, np.float32))
    assert route_spy == {"fused": 2, "mlp_psf": 0}


def _off_sensor_case(seed):
    rng = np.random.default_rng(seed)
    S, H, W = 3, 32, 48
    img = rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    depth = -rng.uniform(500, 15000, (2, 1, H, W)).astype(np.float32)
    focus = -np.sort(rng.uniform(500, 15000, (2, S)))[:, ::-1].astype(np.float32)
    return img, depth, focus


def test_off_sensor_stack_is_the_frame_loop(route_spy, torch_mlp):
    """render_stack at 32x48 on a 480x640 PSFNet renders frame by frame
    through the two-stage route (one mlp_psf call per frame, as lax.map
    does): it equals the per-frame render loop within 1e-6, and the fused
    route's plain version on the same inputs within 1e-6."""
    net = PSFNet(device="cpu", sensor_res=(480, 640))
    net.model = torch_mlp
    img, depth, focus = _off_sensor_case(8)
    stack = net.render_stack(img, depth, focus)
    assert route_spy == {"fused": 0, "mlp_psf": 3}
    for s in range(3):
        frame = net.render(img, depth, focus[:, s])
        np.testing.assert_allclose(frame.numpy(), stack[:, s].numpy(),
                                   atol=1e-6)
    fused = fused_render.fused_psf_render_reference(
        torch_mlp, torch.from_numpy(img), torch.from_numpy(depth[:, 0]),
        torch.from_numpy(focus), 11, net.d_min, net.d_max)
    np.testing.assert_allclose(stack.numpy(), fused.numpy(), atol=1e-6)


def test_off_sensor_stack_matches_jax_pallas_mlp_route(torch_mlp):
    """The JAX package's two-stage route with its Pallas MLP kernel in
    interpret mode (render_stack, use_pallas=True, at a resolution other
    than the sensor's) against the port's, within the 5e-6 of
    test_pallas.py:98 (f32 summation order)."""
    lens = JaxPSFNet(LENS, kernel_size=11, sensor_res=(480, 640))
    lens.load_net(PSFNET_CKPT)
    img, depth, focus = _off_sensor_case(9)
    ref = np.asarray(lens.render_stack(img, depth, focus, use_pallas=True))
    net = PSFNet(device="cpu", sensor_res=(480, 640))
    net.model = torch_mlp
    ours = net.render_stack(img, depth, focus).numpy()
    assert ours.shape == ref.shape == (2, 3, 3, 32, 48)
    np.testing.assert_allclose(ours, ref, atol=5e-6)
