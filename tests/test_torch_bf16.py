"""The bf16 configuration of the port's AiF main path against the JAX
package, on the CPU: the PSF MLP and the fused render with
`compute_dtype=bf16`, `PSFNet.render_dtype` / `stack_kernel`, and the bf16
AiFDepthNet trunk.

The Pallas kernels run in interpret mode, as tests/test_pallas.py runs them;
the port runs the plain versions of its kernels, which is what a CPU tensor
takes (the CUDA kernels are held to them on the card by chip_smoke.py).
Inputs are made with numpy from a seed; weights come from the in-repo
checkpoints and from a seeded `MLP.init`.

Tolerances, each with its reason:
- bf16 port vs bf16 JAX, the same arithmetic summed in another order:
  max-abs BF16_MAX_ABS = 3e-3 and mean-abs BF16_MEAN_ABS = 2e-6.  A sum that
  lands next to a bf16 rounding boundary can round the other way, and the
  flip then moves every later layer: single elements move by up to ~2e-3
  while the mean moves by ~1e-7 (measured with f32 against f64 sums).
- bf16 against f32: rows sum to 1 within 1e-5 and L1/px < 5e-4
  (tests/test_pallas.py:25-42); with a random-init MLP the bf16 render is
  not equal to the f32 one and within 2e-3 max-abs of it
  (tests/test_pallas.py:120-123).  With the trained checkpoint single taps
  move by up to ~0.1 (JAX computes the same), so it is held by L1/px.
- bf16 trunk: outputs f32 and within 0.15 of the f32 trunk
  (tests/test_models.py:128-142); against the JAX bf16 trunk within
  TRUNK_BF16_TOL = 0.05 (measured 0.016; each bf16 trunk is 0.011-0.014
  from its f32 one: bf16 convolutions round once in cuDNN/oneDNN but twice
  in XLA, which adds the bias in bf16 after rounding the sum).
"""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.models.aifnet import AiFDepthNet as JaxAiFDepthNet
from aadff_tpu.ops.pallas_mlp import flax_mlp_weights, mlp_psf_pallas
from aadff_tpu.ops.pallas_render import fused_render_frame, fused_render_stack
from aadff_tpu.psfnet import MLP as JaxMLP
from aadff_tpu_torch.models.aifnet import AiFDepthNet
from aadff_tpu_torch.models.convert import (aifnet_state_from_flax,
                                            load_flax_aifnet)
from aadff_tpu_torch.ops import _build, fused_render, mlp_psf
from aadff_tpu_torch.psfnet import psfnet
from aadff_tpu_torch.psfnet.arch import MLP
from aadff_tpu_torch.psfnet.convert import flax_mlp_to_torch_state
from aadff_tpu_torch.psfnet.psfnet import PSFNet
from aadff_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
AIF_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "aifnet",
                        "depth_net_best.msgpack")
D_MIN, D_MAX = -200.0, -20000.0  # PSFNet's normalisation endpoints
BF16 = torch.bfloat16
BF16_MAX_ABS = 3e-3
BF16_MEAN_ABS = 2e-6
L1_PX = 5e-4
TRUNK_BF16_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this file runs.  The suite runs in several
    worker processes at once, and torch's default of a thread per core in
    each of them oversubscribes the machine: the 5 bf16 train steps below,
    1.6 s alone, took over 4 minutes so.  Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_bf16(ours, ref):
    err = np.abs(np.asarray(ours) - np.asarray(ref))
    assert err.max() <= BF16_MAX_ABS, err.max()
    assert err.mean() <= BF16_MEAN_ABS, err.mean()


def _port_mlp(variables):
    mlp = MLP()
    mlp.load_state_dict(flax_mlp_to_torch_state(variables))
    return mlp.requires_grad_(False)


@pytest.fixture(scope="module")
def weights():
    """{name: (flax variables, port MLP)} for the trained checkpoint and a
    random init from a seed."""
    with open(PSFNET_CKPT, "rb") as f:
        ckpt = msgpack_restore(f.read())
    model = JaxMLP(in_features=4, out_features=121, hidden_features=256,
                   hidden_layers=8)
    rand = jax.tree.map(np.asarray,
                        model.init(jax.random.PRNGKey(2), jnp.zeros((1, 4))))
    return {name: (v, _port_mlp(v)) for name, v in
            (("checkpoint", ckpt), ("random", rand))}


# ---- the PSF MLP (B3) -----------------------------------------------------

@pytest.mark.parametrize("name", ["checkpoint", "random"])
@pytest.mark.parametrize("n", [2048, 1500])
def test_mlp_bf16_matches_pallas_bf16(weights, name, n):
    """mlp_psf_reference in bf16 against mlp_psf_pallas(compute_dtype=bf16)
    in interpret mode, at N = 2048 and a ragged N = 1500."""
    variables, mlp = weights[name]
    field = np.random.default_rng(2).uniform(-1, 1, (n, 4)).astype(np.float32)
    ref = np.asarray(mlp_psf_pallas(jnp.asarray(field),
                                    flax_mlp_weights(variables), 121,
                                    interpret=True, tile=1024,
                                    compute_dtype=jnp.bfloat16))
    ours = mlp_psf.mlp_psf(mlp, torch.from_numpy(field), BF16).numpy()
    assert ours.shape == ref.shape == (n, 121)
    _close_bf16(ours, ref)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)
    f32 = mlp_psf.mlp_psf(mlp, torch.from_numpy(field)).numpy()
    assert 0 < np.abs(ours - f32).mean() < L1_PX


def test_mlp_compute_dtype_is_checked(weights):
    _, mlp = weights["random"]
    with pytest.raises(ValueError, match="compute_dtype"):
        mlp_psf.mlp_psf(mlp, torch.zeros(4, 4), torch.float16)


CHUNK_ELEMS = 8192  # one weight chunk of the bf16 stage: 128 rows x 64 k


def _unswizzle(img: np.ndarray) -> np.ndarray:
    """Decode one 16 KB chunk image (8192 uint16) into its [128, 64] rows.

    Written from the hardware's rule, not from the packer: element (r, k)
    of a K-major chunk with 128-byte rows sits at byte r * 128 + 2 * k, and
    the 128-byte swizzle XORs address bits 4-6 with bits 7-9 (the row mod
    8)."""
    r, k = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    plain = r * 128 + 2 * k
    swizzled = plain ^ (((plain >> 7) & 7) << 4)
    return img[swizzled // 2]


def _decode_bf16_pack(wpack: torch.Tensor, layout: list[int]):
    """[(W bits [fpad, ceil(k/64)*64] uint16, bias f32, row)] per layer from
    a bf16 pack, and check its offsets on the way: every chunk 16 KB and
    16 KB-aligned in the buffer (the bulk copy needs 16 bytes, the swizzle
    atom 1024), all chunks in reading order, then all biases."""
    bits = wpack.view(torch.int16).numpy().view(np.uint16)
    rows = [layout[i:i + 5] for i in range(0, len(layout), 5)]
    out, next_w, next_b = [], 0, rows[0][4]
    for k, f, fpad, w_off, b_off in rows:
        nh, nk = fpad // 128, -(-k // 64)
        assert w_off == next_w and w_off % CHUNK_ELEMS == 0
        assert b_off == next_b and (2 * b_off) % 16 == 0
        w = np.zeros((fpad, 64 * nk), np.uint16)
        for h in range(nh):
            for kc in range(nk):
                start = w_off + (h * nk + kc) * CHUNK_ELEMS
                w[128 * h:128 * (h + 1), 64 * kc:64 * (kc + 1)] = _unswizzle(
                    bits[start:start + CHUNK_ELEMS])
        bias = bits[b_off:b_off + 2 * fpad].view(np.float32)
        out.append((w, bias, (k, f, fpad)))
        next_w += nh * nk * CHUNK_ELEMS
        next_b += 2 * fpad
    assert rows[0][4] == next_w and next_b == wpack.numel()
    return out


def _check_bf16_pack(mlp):
    wpack, layout = fused_render.pack_mlp_weights(mlp, BF16)
    assert wpack.dtype == BF16
    decoded = _decode_bf16_pack(wpack, layout)
    assert len(decoded) == len(mlp.linears())
    for lin, (w, bias, (k, f, fpad)) in zip(mlp.linears(), decoded):
        assert fpad == (128 if f <= 128 else 256)
        want = lin.weight.detach().to(BF16).view(torch.int16).numpy()
        np.testing.assert_array_equal(w[:f, :k], want.view(np.uint16))
        assert not w[f:].any() and not w[:, k:].any()
        np.testing.assert_array_equal(
            bias[:f].view(np.uint32),
            lin.bias.detach().numpy().astype(np.float32).view(np.uint32))
        assert not bias[f:].any()
    return decoded


def test_pack_bf16_layout(weights):
    """The bf16 pack of the checkpoint, decoded by `_unswizzle`: every
    layer's W [f, k] in bf16 bit for bit, layer 0's K = 4 zero-padded to 16
    (and to its 64-wide chunk row) with its 64 outputs in a 128-row chunk,
    the last layer's 121 outputs zero-padded to 128, the biases f32 bit for
    bit, and 71 chunks of 16 KB at aligned offsets in reading order."""
    _, mlp = weights["checkpoint"]
    decoded = _check_bf16_pack(mlp)
    first, last = decoded[0], decoded[-1]
    assert first[2] == (4, 64, 128) and last[2] == (256, 121, 128)
    assert not first[0][:, 4:16].any() and not first[0][64:].any()
    assert not last[0][121:].any()
    nchunks = sum((fpad // 128) * -(-k // 64) for _, _, (k, _, fpad) in decoded)
    assert nchunks == 71


@pytest.mark.parametrize("seed, hidden_layers, out_features",
                         [(0, 8, 121), (1, 0, 121), (2, 3, 49), (3, 1, 128)])
def test_pack_bf16_decodes_random_mlps(seed, hidden_layers, out_features):
    """Random MLPs of other depths and tap counts (7x7 = 49, 128) decode to
    their weights and biases bit for bit, with the same padding rules."""
    torch.manual_seed(seed)
    mlp = MLP(out_features=out_features, hidden_layers=hidden_layers)
    decoded = _check_bf16_pack(mlp.requires_grad_(False))
    assert len(decoded) == hidden_layers + 3


def _c_params(name: str) -> list[str]:
    """The parameter types of the C entry point `name` in csrc/*.cu."""
    for src in _build.SOURCES:
        m = re.search(rf"\n(?:int|const char\*) {name}\(([^)]*)\)",
                      src.read_text())
        if m:
            return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    raise AssertionError(f"{name} not found in {_build.SOURCES}")


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_kernel_entry_point_argtypes(name):
    """The ctypes argtypes the wrappers bind match the C signature in the
    source, parameter by parameter: a pointer for a pointer, c_int for int,
    c_float for float (a mismatch would pass garbage to the launch)."""
    argtypes, _ = _build.ENTRY_POINTS[name]
    params = _c_params(name)
    assert len(params) == len(argtypes), (params, argtypes)
    for c_type, py_type in zip(params, argtypes):
        if c_type.endswith("*"):
            assert py_type is ctypes.c_void_p or issubclass(
                py_type, ctypes._Pointer), (name, c_type, py_type)
        else:
            assert {"int": ctypes.c_int, "float": ctypes.c_float}[c_type] \
                is py_type, (name, c_type, py_type)


# ---- the fused render (B1/B2) ---------------------------------------------

def _render_case(H, seed=3, W=128, S=2):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    depth = -rng.uniform(500, 15000, (2, 1, H, W)).astype(np.float32)
    focus = np.asarray([[-2400.0, -900.0]] * 2, np.float32)[:, :S]
    return img, depth, focus


def _port_render(mlp, img, depth, focus, dtype=torch.float32):
    return fused_render.fused_psf_render(
        mlp, torch.from_numpy(img), torch.from_numpy(depth[:, 0]),
        torch.from_numpy(focus), 11, D_MIN, D_MAX, dtype).numpy()


@pytest.mark.parametrize("name", ["checkpoint", "random"])
@pytest.mark.parametrize("H, th", [(16, 16), (64, 32)])
def test_fused_render_frame_bf16_matches_pallas(weights, name, H, th):
    """The plain bf16 render of one frame against fused_render_frame(
    compute_dtype=bf16) in interpret mode, at 16x128 and 64x128."""
    variables, mlp = weights[name]
    img, depth, focus = _render_case(H)
    ref = np.asarray(fused_render_frame(
        variables, jnp.asarray(img), jnp.asarray(depth),
        jnp.asarray(focus[:, 0]), 11, D_MIN, D_MAX, interpret=True,
        compute_dtype=jnp.bfloat16, th=th))
    ours = _port_render(mlp, img, depth, focus[:, :1], BF16)[:, 0]
    _close_bf16(ours, ref)


@pytest.mark.parametrize("name", ["checkpoint", "random"])
def test_fused_render_stack_bf16_matches_pallas(weights, name):
    """The plain bf16 stack render against fused_render_stack(
    compute_dtype=bf16) in interpret mode, at 64x128 with S = 2."""
    variables, mlp = weights[name]
    img, depth, focus = _render_case(64, seed=5)
    ref = np.asarray(fused_render_stack(
        variables, jnp.asarray(img), jnp.asarray(depth), jnp.asarray(focus),
        11, D_MIN, D_MAX, interpret=True, compute_dtype=jnp.bfloat16))
    ours = _port_render(mlp, img, depth, focus, BF16)
    assert ours.shape == ref.shape == (2, 2, 3, 64, 128)
    _close_bf16(ours, ref)


def test_fused_render_bf16_random_init_gate(weights):
    """Random-init MLP: the bf16 render is not the f32 one (it ran in bf16)
    and lies within 2e-3 of it (tests/test_pallas.py:120-123)."""
    _, mlp = weights["random"]
    img, depth, focus = _render_case(16, seed=4)
    err = np.abs(_port_render(mlp, img, depth, focus, BF16)
                 - _port_render(mlp, img, depth, focus)).max()
    assert 0 < err < 2e-3, err


def test_fused_render_bf16_checkpoint_l1(weights):
    """Trained checkpoint: the bf16 stack render against f32, L1/px < 5e-4
    (tests/test_pallas.py:42); single pixels move by up to ~0.04."""
    _, mlp = weights["checkpoint"]
    img, depth, focus = _render_case(64, seed=3)
    bf16 = _port_render(mlp, img, depth, focus, BF16)
    f32 = _port_render(mlp, img, depth, focus)
    assert 0 < np.abs(bf16 - f32).mean() < L1_PX


# ---- PSFNet: render_dtype and stack_kernel --------------------------------

@pytest.fixture
def dtype_spy(monkeypatch):
    """Records (route, compute dtype, frames) of every wrapper call PSFNet
    makes."""
    calls = []

    def fused(*args, **kwargs):
        calls.append(("fused", args[7], args[3].shape[1]))
        return fused_render.fused_psf_render(*args, **kwargs)

    def mlp(*args, **kwargs):
        calls.append(("mlp_psf", args[2], 1))
        return mlp_psf.mlp_psf(*args, **kwargs)

    monkeypatch.setattr(psfnet, "fused_psf_render", fused)
    monkeypatch.setattr(psfnet, "mlp_psf", mlp)
    return calls


def _net(weights, render_dtype="f32", sensor_res=(12, 10)):
    net = PSFNet(device="cpu", sensor_res=sensor_res,
                 render_dtype=render_dtype)
    net.model = weights["checkpoint"][1]
    return net


def _small_case(seed, H=12, W=10, S=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    depth = -rng.uniform(500, 15000, (2, 1, H, W)).astype(np.float32)
    focus = -np.sort(rng.uniform(500, 15000, (2, S)))[:, ::-1].astype(np.float32)
    return img, depth, focus


@pytest.mark.parametrize("render_dtype, dtype",
                         [("f32", torch.float32), ("bf16", BF16)])
def test_render_dtype_reaches_both_routes(weights, dtype_spy, render_dtype,
                                          dtype):
    """render_dtype is the compute dtype of the fused route (a sensor-sized
    stack, one launch) and of the two-stage route (one mlp_psf per frame)."""
    net = _net(weights, render_dtype)
    assert net.stack_kernel is True
    img, depth, focus = _small_case(1)
    net.render_stack(img, depth, focus)
    img2, depth2, focus2 = _small_case(2, H=8, W=6, S=2)
    net.render_stack(img2, depth2, focus2)
    assert dtype_spy == [("fused", dtype, 3), ("mlp_psf", dtype, 1),
                         ("mlp_psf", dtype, 1)]


def test_bf16_render_stack_is_the_bf16_kernel_plain_version(weights):
    """PSFNet(render_dtype='bf16').render_stack is the bf16 fused render,
    and not the f32 one."""
    net = _net(weights, "bf16")
    img, depth, focus = _small_case(3)
    out = net.render_stack(img, depth, focus).numpy()
    ref = _port_render(net.model, img, depth, focus, BF16)
    np.testing.assert_array_equal(out, ref)
    assert np.abs(out - _port_render(net.model, img, depth, focus)).max() > 0


@pytest.mark.parametrize("render_dtype", ["f32", "bf16"])
def test_stack_kernel_false_renders_frame_by_frame(weights, dtype_spy,
                                                   render_dtype):
    """stack_kernel=False: one one-frame fused launch per frame (B2), as
    lax.map over render_impl; equal to the whole-stack launch within 1e-6
    (tests/test_pallas.py:229-247)."""
    net = _net(weights, render_dtype)
    img, depth, focus = _small_case(4)
    stack = net.render_stack(img, depth, focus).numpy()
    net.stack_kernel = False
    loop = net.render_stack(img, depth, focus).numpy()
    dtype = psfnet.RENDER_DTYPES[render_dtype]
    assert dtype_spy == [("fused", dtype, 3)] + [("fused", dtype, 1)] * 3
    np.testing.assert_allclose(loop, stack, rtol=0, atol=1e-6)


def test_render_path_labels_carry_the_dtype():
    net = PSFNet(device="cpu", render_dtype="bf16")
    assert net.render_path() == "torch-mlp+taploop(bf16)"
    net.device = torch.device("cuda")  # the label only; nothing runs
    assert net.render_path() == "fused-mlp+conv(bf16,cuda)"
    assert net.render_path((120, 160)) == "mlp-psf(bf16,cuda)+taploop"
    net.render_dtype = "f32"
    assert net.render_path() == "fused-mlp+conv(f32,cuda)"
    assert net.render_path((120, 160)) == "mlp-psf(f32,cuda)+taploop"


def test_other_render_dtypes_raise(weights):
    with pytest.raises(ValueError, match="render_dtype"):
        PSFNet(device="cpu", render_dtype="fp16")
    net = _net(weights)
    net.render_dtype = "f16"
    img, depth, focus = _small_case(5)
    with pytest.raises(ValueError, match="render_dtype"):
        net.render_stack(img, depth, focus)


# ---- the bf16 AiFDepthNet trunk -------------------------------------------

@pytest.fixture(scope="module")
def trunk_case():
    """The AiF checkpoint, a [2, 4, 64, 64, 3] batch and the JAX bf16 and
    f32 eval outputs."""
    with open(AIF_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    rng = np.random.default_rng(0)
    stack = rng.uniform(0, 1, (2, 4, 64, 64, 3)).astype(np.float32)
    fp = np.tile(np.linspace(0.5, 3.0, 4, dtype=np.float32), (2, 1))
    jax16 = JaxAiFDepthNet(n_stack=4, dtype=jnp.bfloat16)
    out16 = jax.tree.map(np.asarray, jax.jit(
        lambda v, s, p: jax16.apply(v, s, p, train=False))(variables, stack, fp))
    state, _ = load_flax_aifnet(AIF_CKPT)
    return {"stack": stack, "fp": fp, "jax16": out16, "state": state}


def _trunk(state, dtype):
    net = AiFDepthNet(dtype=dtype)
    net.load_state_dict(state)
    return net


def test_bf16_trunk_matches_jax_bf16_trunk(trunk_case):
    net = _trunk(trunk_case["state"], BF16).eval()
    with torch.no_grad():
        out = net(torch.from_numpy(trunk_case["stack"]),
                  torch.from_numpy(trunk_case["fp"]))
        out32 = _trunk(trunk_case["state"], None).eval()(
            torch.from_numpy(trunk_case["stack"]),
            torch.from_numpy(trunk_case["fp"]))
    for key in ("pred_depth", "pred_AiF_img"):
        assert out[key].dtype == torch.float32
        assert out[key].shape == trunk_case["jax16"][key].shape
        np.testing.assert_allclose(out[key].numpy(), trunk_case["jax16"][key],
                                   atol=TRUNK_BF16_TOL)
        err = (out[key] - out32[key]).abs().max().item()
        assert 0 < err < 0.15, (key, err)
    # parameters and statistics stayed f32: no bf16 copy is stored
    assert all(t.dtype == torch.float32 for t in net.state_dict().values())


def test_bf16_trunk_train_steps_finite_and_learn(trunk_case):
    """5 guarded Adam steps with the bf16 trunk from the JAX test's own
    initialisation (Flax init, PRNGKey(1)) at lr 1e-3, as
    tests/test_models.py:145-162: finite, the loss falls, parameters and
    Adam's moments stay f32."""
    stack, fp = trunk_case["stack"], trunk_case["fp"]
    model = JaxAiFDepthNet(n_stack=4)
    variables = jax.jit(lambda key: model.init(key, stack, fp, train=True))(
        jax.random.PRNGKey(1))
    net = _trunk(aifnet_state_from_flax(jax.tree.map(np.asarray, variables)),
                 BF16)
    # decay_steps far beyond 5 steps: the cosine schedule stays at 1e-3, as
    # the JAX test's optax.adam(1e-3)
    state = trainer.create_train_state(net, 1e-3, 10 ** 9)
    step = trainer.make_aif_train_step("D_FS")
    stack, fp = torch.from_numpy(stack), torch.from_numpy(fp)
    depth = torch.full((2, 1, 64, 64), 1.7)
    aif = torch.zeros(2, 3, 64, 64)
    losses = [step(state, stack, fp, depth, aif) for _ in range(5)]
    totals = [float(x["total"]) for x in losses]
    assert all(np.isfinite(totals)) and totals[-1] < totals[0], totals
    assert all(float(x["skipped_nonfinite"]) == 0 for x in losses)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(m.dtype == torch.float32 for m in state.opt.mu + state.opt.nu)
    assert int(state.step) == 5


def test_trunk_dtype_from_args():
    assert trainer.trunk_dtype({"compute_dtype": "bf16"}) == BF16
    assert trainer.trunk_dtype({"compute_dtype": "f32"}) is None
    assert trainer.trunk_dtype({}) is None
    with pytest.raises(ValueError, match="dtype"):
        AiFDepthNet(dtype=torch.float16)
