"""The fused render's diagnostic modes against the JAX package's, on the
CPU: `mode='mlponly'`, `mode='convonly'` and `pipe=True` of
`fused_render_frame` (aadff_tpu/ops/pallas_render.py:93-101, 154-171),
in f32 and in bf16, with the Pallas kernel in interpret mode; and
'convonly' against an independent float64 formula.

The port runs the plain version of its kernel on CPU tensors (the CUDA
kernel is held to it on the card by chip_smoke.py).  Tolerances: f32 at the
5e-6 of tests/test_pallas.py:98 (f32 sums in another order); bf16 at
max-abs 3e-3 and mean-abs 2e-6, the bf16 tolerances of
tests/test_torch_bf16.py (a sum next to a bf16 rounding boundary may round
the other way and move later layers).  The wrapper's weight pack is also
checked here: it is made once per state of the weights.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.ops.pallas_render import fused_render_frame
from aadff_tpu_torch.ops import fused_render
from aadff_tpu_torch.psfnet.arch import MLP
from aadff_tpu_torch.psfnet.convert import flax_mlp_to_torch_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
D_MIN, D_MAX = -200.0, -20000.0  # PSFNet's normalisation endpoints
F32_TOL = 5e-6
BF16_MAX_ABS, BF16_MEAN_ABS = 3e-3, 2e-6
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
MODES = [("mlponly", False), ("convonly", False), ("full", True),
         ("mlponly", True)]


@pytest.fixture(scope="module")
def weights():
    with open(PSFNET_CKPT, "rb") as f:
        variables = msgpack_restore(f.read())
    mlp = MLP()
    mlp.load_state_dict(flax_mlp_to_torch_state(variables))
    return variables, mlp.requires_grad_(False)


def _case(seed=6, H=32, W=128):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    depth = -rng.uniform(500, 15000, (2, 1, H, W)).astype(np.float32)
    foc = np.asarray([-2400.0, -900.0], np.float32)
    return img, depth, foc


def _port(mlp, img, depth, foc, dtype, mode="full", pipe=False):
    return fused_render.fused_psf_render(
        mlp, torch.from_numpy(img), torch.from_numpy(depth[:, 0]),
        torch.from_numpy(foc[:, None]), 11, D_MIN, D_MAX, dtype, mode,
        pipe)[:, 0].numpy()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mode, pipe", MODES)
def test_mode_matches_pallas(weights, dt, mode, pipe):
    """One 32x128 frame per image (two 16-row TPU tiles) through both
    packages' kernel with the same mode and pipe."""
    variables, mlp = weights
    torch_dt, jax_dt = DTYPES[dt]
    img, depth, foc = _case()
    ref = np.asarray(fused_render_frame(
        variables, jnp.asarray(img), jnp.asarray(depth), jnp.asarray(foc),
        11, D_MIN, D_MAX, interpret=True, compute_dtype=jax_dt, th=16,
        mode=mode, pipe=pipe))
    ours = _port(mlp, img, depth, foc, torch_dt, mode, pipe)
    assert ours.shape == ref.shape == (2, 3, 32, 128)
    err = np.abs(ours - ref)
    if dt == "f32" or mode == "convonly":  # convonly has no MLP
        assert err.max() <= F32_TOL, err.max()
    else:
        assert err.max() <= BF16_MAX_ABS, err.max()
        assert err.mean() <= BF16_MEAN_ABS, err.mean()


# (N, H, W, ks): the frame chip_smoke.py measures, two images, a ragged
# frame whose rows are not 16-byte aligned, a frame smaller than the halo
# (edge replication reaches across it), and another ks
CONVONLY_CASES = [(1, 480, 640, 11), (2, 480, 640, 11), (1, 123, 161, 11),
                  (1, 7, 9, 11), (1, 123, 161, 7)]


@pytest.mark.parametrize("N, H, W, ks", CONVONLY_CASES,
                         ids=[f"{n}x{h}x{w}_ks{k}" for n, h, w, k in CONVONLY_CASES])
def test_convonly_is_a_scaled_box_sum(weights, N, H, W, ks):
    """'convonly' (csrc/psf_conv.cu on the card) is 0.01 * z times the
    ks x ks box sum of the edge-padded image: the plain version against that
    formula in float64 numpy, within 1e-6 (its 121 f32 sums of values up to
    ~1.2 round by ~1e-7 each; the kernel is held to the plain version on the
    card).  Depths reach past both normalisation ends, so z is clamped."""
    _, mlp = weights
    rng = np.random.default_rng(10 + N + H + ks)
    img = rng.uniform(0, 1, (N, 3, H, W)).astype(np.float32)
    depth = -rng.uniform(100, 25000, (N, H, W)).astype(np.float32)
    out = fused_render.fused_psf_render(
        mlp, torch.from_numpy(img), torch.from_numpy(depth),
        torch.full((N, 1), -900.0), ks, D_MIN, D_MAX, mode="convonly")
    pad = (ks - 1) // 2
    padded = np.pad(img.astype(np.float64),
                    ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="edge")
    box = sum(padded[:, :, a:a + H, b:b + W]
              for a in range(ks) for b in range(ks))
    z = np.clip((depth.astype(np.float64) - D_MIN) / (D_MAX - D_MIN), 0, 1)
    ref = 0.01 * z[:, None] * box
    assert out.shape == (N, 1, 3, H, W)
    err = np.abs(out[:, 0].numpy() - ref).max()
    assert err <= 1e-6, err


def test_convonly_declaration_matches_definition():
    """fused_psf_render.cu launches 'convonly' through its own extern "C"
    declaration of psf_conv.cu's entry point; C names carry no types, so
    the linker would not catch a mismatch: the two signatures are equal."""
    csrc = os.path.join(REPO, "aadff_tpu_torch", "csrc")

    def signature(name, end):
        with open(os.path.join(csrc, name)) as f:
            m = re.search(r"\nint aadff_psf_conv\(([^)]*)\)\s*" + end, f.read())
        assert m, name
        return " ".join(m.group(1).split())

    assert signature("fused_psf_render.cu", ";") == signature("psf_conv.cu", "{")


def test_mlponly_is_the_first_taps(weights):
    """'mlponly' writes the first C taps of each pixel's normalised PSF."""
    _, mlp = weights
    img, depth, foc = _case(7, H=8, W=12)
    out = _port(mlp, img, depth, foc, torch.float32, "mlponly")
    field = fused_render.psf_field(torch.from_numpy(depth[:, 0]),
                                   torch.from_numpy(foc), D_MIN, D_MAX)
    psf = mlp(field.reshape(-1, 4)).reshape(2, 8, 12, 121)
    np.testing.assert_array_equal(out, psf[..., :3].permute(0, 3, 1, 2).numpy())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pipe_equals_full(weights, dt):
    """The two half-tile chains compute what one chain does."""
    _, mlp = weights
    img, depth, foc = _case(8, H=8, W=12)
    full = _port(mlp, img, depth, foc, DTYPES[dt][0])
    pipe = _port(mlp, img, depth, foc, DTYPES[dt][0], pipe=True)
    np.testing.assert_array_equal(pipe, full)


@pytest.mark.parametrize("mode, pipe", MODES)
def test_modes_take_one_frame(weights, mode, pipe):
    """As in JAX, whose whole-stack launch is always 'full' without pipe,
    a mode or pipe renders one frame: S > 1 raises."""
    _, mlp = weights
    img = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError, match="one frame"):
        fused_render.fused_psf_render(mlp, img, img[:, 0],
                                      torch.full((1, 2), -900.0), 11, D_MIN,
                                      D_MAX, mode=mode, pipe=pipe)


def test_unknown_mode_and_dtype_raise(weights):
    _, mlp = weights
    img = torch.zeros(1, 3, 4, 4)
    args = (mlp, img, img[:, 0], torch.full((1, 1), -900.0), 11, D_MIN, D_MAX)
    with pytest.raises(ValueError, match="mode"):
        fused_render.fused_psf_render(*args, mode="mlp")
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_render.fused_psf_render(*args, compute_dtype=torch.float16)


def test_cpu_modes_launch_nothing(weights):
    _, mlp = weights
    img, depth, foc = _case(9, H=4, W=6)
    before = (fused_render.launches, dict(fused_render.variant_launches))
    for mode, pipe in MODES:
        _port(mlp, img, depth, foc, torch.bfloat16, mode, pipe)
    assert (fused_render.launches,
            dict(fused_render.variant_launches)) == before


def test_variant_names():
    v = fused_render.variant
    assert v(torch.float32, frames=8) == "stack/f32/full"
    assert v(torch.bfloat16, frames=8) == "stack/bf16/full"
    assert v(torch.bfloat16) == "frame/bf16/full"
    assert v(torch.float32, "mlponly", True) == "frame/f32/mlponly+pipe"
    assert v(torch.bfloat16, "convonly") == "frame/-/convonly"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_packed_weights_follow_the_weights(dt):
    """A launch packs the weights once per state of the MLP: the same buffer
    while they are unchanged, a fresh pack after an in-place change or a new
    state dict."""
    dtype = DTYPES[dt][0]
    mlp = MLP().requires_grad_(False)
    first, layout = fused_render.packed_weights(mlp, dtype)
    assert fused_render.packed_weights(mlp, dtype)[0] is first
    with torch.no_grad():
        mlp.linears()[3].weight.mul_(2)
    changed = fused_render.packed_weights(mlp, dtype)[0]
    mlp.load_state_dict(MLP().state_dict())
    reloaded, reloaded_layout = fused_render.packed_weights(mlp, dtype)
    assert changed is not first and reloaded is not changed
    fresh, fresh_layout = fused_render.pack_mlp_weights(mlp, dtype)
    assert reloaded_layout == fresh_layout == layout
    # bf16 packs hold f32 biases bit for bit: compare the bits
    bits = torch.int16 if dt == "bf16" else torch.int32
    assert torch.equal(reloaded.view(bits), fresh.view(bits))
