"""The port's AiFDepthNet, its layers and its loss against the JAX package,
on the CPU, from the trained checkpoint converted for both packages.

Tolerances: 3D convolutions sum in another order in PyTorch than in XLA, in
f32, so outputs agree to 1e-4 and losses to rtol 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.models.aifnet import AiFDepthNet as JaxAiFDepthNet
from aadff_tpu.models.aifnet import compute_loss as jax_compute_loss
from aadff_tpu.models.layers import (TorchConv, TorchConvTranspose,
                                     torch_max_pool)
from aadff_tpu_torch.models.aifnet import AiFDepthNet, compute_loss
from aadff_tpu_torch.models.convert import (aifnet_state_from_flax,
                                            load_flax_aifnet)
from aadff_tpu_torch.models.layers import BatchNorm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIF_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "aifnet",
                        "depth_net_best.msgpack")
TASKS = ("D_FS", "DA_FS", "A_FS")
LOSS_W = {"aif_w": 1.0, "smooth_w": 0.5}


@pytest.fixture(scope="module")
def case():
    """The checkpoint in both packages, one [1, 8, 64, 64, 3] batch, and the
    JAX eval outputs, train-mode losses and updated batch_stats."""
    with open(AIF_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    rng = np.random.default_rng(0)
    stack = rng.uniform(0, 1, (1, 8, 64, 64, 3)).astype(np.float32)
    fp = np.linspace(0.5, 3.0, 8, dtype=np.float32)[None]
    depth = rng.uniform(0.5, 3.0, (1, 1, 64, 64)).astype(np.float32)
    depth[..., :5, :] = 0.0  # masked pixels
    aif = rng.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    batch = {"depth": depth, "AiF_img": aif}

    model = JaxAiFDepthNet(n_stack=8)

    @jax.jit
    def run(variables, stack, fp):
        ev = model.apply(variables, stack, fp, train=False)
        out, upd = model.apply(variables, stack, fp, train=True,
                               mutable=["batch_stats"])
        losses = {t: jax_compute_loss(out, batch, t, **LOSS_W) for t in TASKS}
        return ev, losses, upd["batch_stats"]

    ev, losses, bs = jax.tree.map(np.asarray, run(variables, stack, fp))
    state, _ = load_flax_aifnet(AIF_CKPT)
    net = AiFDepthNet()
    net.load_state_dict(state)
    return {"params": v["params"], "stack": stack, "fp": fp, "batch": batch,
            "eval": ev, "losses": losses, "batch_stats": bs, "net": net}


@pytest.fixture(scope="module")
def torch_train(case):
    """The port's train-mode forward on the case: outputs and the updated
    BatchNorm statistics."""
    net = AiFDepthNet()
    net.load_state_dict(case["net"].state_dict())
    net.train()
    out = net(torch.from_numpy(case["stack"]), torch.from_numpy(case["fp"]))
    return out, net.state_dict()


def test_eval_forward_matches_jax(case):
    net = case["net"].eval()
    with torch.no_grad():
        out = net(torch.from_numpy(case["stack"]), torch.from_numpy(case["fp"]))
    for key in ("pred_depth", "pred_AiF_img"):
        assert out[key].shape == case["eval"][key].shape
        np.testing.assert_allclose(out[key].numpy(), case["eval"][key],
                                   atol=1e-4)


@pytest.mark.parametrize("task", TASKS)
def test_compute_loss_matches_jax(case, torch_train, task):
    out, _ = torch_train
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    losses = compute_loss(out, batch, task, **LOSS_W)
    ref = case["losses"][task]
    assert set(losses) == set(ref)
    for key, value in losses.items():
        np.testing.assert_allclose(float(value.detach()), ref[key], rtol=1e-4)


def test_updated_batch_stats_match_jax(case, torch_train):
    """Flax's running-statistics rule (momentum 0.9 on the old value, biased
    batch variance).  Each tensor agrees within 1e-4 of its largest value:
    elementwise relative error means nothing for means near zero."""
    _, state = torch_train
    ref = aifnet_state_from_flax({"params": case["params"],
                                  "batch_stats": case["batch_stats"]})
    stats = [k for k in state if "running" in k]
    assert len(stats) == 2 * 69
    for key in stats:
        a, b = ref[key].numpy(), state[key].numpy()
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), key


def test_converter_covers_every_tensor(case):
    state = case["net"].state_dict()
    converted, step = load_flax_aifnet(AIF_CKPT)
    assert set(converted) == set(state) and step == 1064
    for key, value in converted.items():
        assert value.shape == state[key].shape, key


def test_conv_geometry_matches_torch_conv():
    """TorchConv (strided, padded) with its kernel converted to nn.Conv3d."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (1, 5, 9, 11, 3)).astype(np.float32)
    layer = TorchConv(4, (3, 7, 7), (1, 2, 2), (1, 3, 3))
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(layer.apply(variables, jnp.asarray(x)))
    p = variables["params"]["Conv_0"]
    conv = torch.nn.Conv3d(3, 4, (3, 7, 7), (1, 2, 2), (1, 3, 3))
    conv.weight.data = torch.from_numpy(np.array(p["kernel"]).transpose(4, 3, 0, 1, 2).copy())
    conv.bias.data = torch.from_numpy(np.array(p["bias"]))
    with torch.no_grad():
        out = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(), ref,
                               atol=1e-5)


@pytest.mark.parametrize("size", [(4, 3, 5), (2, 8, 8)])
def test_transposed_conv_geometry_matches_jax(size):
    """TorchConvTranspose's kernel [*k, in, out] loads into
    nn.ConvTranspose3d as [in, out, *k] with no flip; out = (i-1)s - 2p + k."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, *size, 6)).astype(np.float32)
    layer = TorchConvTranspose(5, (3, 4, 4), (1, 2, 2), (1, 1, 1))
    variables = layer.init(jax.random.PRNGKey(2), jnp.asarray(x))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32),
        variables)
    ref = np.asarray(layer.apply(variables, jnp.asarray(x)))
    p = variables["params"]
    tconv = torch.nn.ConvTranspose3d(6, 5, (3, 4, 4), (1, 2, 2), (1, 1, 1))
    tconv.weight.data = torch.from_numpy(np.array(p["kernel"]).transpose(3, 4, 0, 1, 2).copy())
    tconv.bias.data = torch.from_numpy(np.array(p["bias"]))
    with torch.no_grad():
        out = tconv(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    d, h, w = size
    assert ref.shape == (2, d, 2 * h, 2 * w, 5)
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(), ref,
                               atol=1e-5)


@pytest.mark.parametrize("window,strides,padding", [
    ((1, 3, 3), (1, 2, 2), (0, 1, 1)), ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((1, 2, 2), (1, 2, 2), (0, 0, 0))])
def test_max_pool_matches_jax(window, strides, padding):
    """The AiFDepthNet pools: padding is -inf in both."""
    x = np.random.default_rng(3).uniform(-3, -1, (1, 4, 7, 9, 2)).astype(np.float32)
    ref = np.asarray(torch_max_pool(jnp.asarray(x), window, strides, padding))
    out = torch.nn.functional.max_pool3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), window, strides, padding)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 4, 1).numpy(), ref)


def test_batchnorm_follows_flax():
    """Train mode normalises with the biased batch variance and keeps
    0.9 * old + 0.1 * batch; eval mode uses the running statistics."""
    import flax.linen as fnn

    rng = np.random.default_rng(4)
    x = rng.normal(2.0, 3.0, (2, 3, 4, 5, 6)).astype(np.float32)  # NCDHW
    xl = np.moveaxis(x, 1, -1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xl))
    ref, upd = bn.apply(variables, jnp.asarray(xl), mutable=["batch_stats"])

    ours = BatchNorm(3)
    out = ours(torch.from_numpy(x))
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1),
                               np.asarray(ref), atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(ours.running_mean.numpy(), stats["mean"],
                               rtol=1e-5)
    np.testing.assert_allclose(ours.running_var.numpy(), stats["var"],
                               rtol=1e-5)

    ours.eval()
    bn_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                            epsilon=1e-5)
    ref_eval = bn_eval.apply({"params": variables["params"],
                              "batch_stats": stats}, jnp.asarray(xl))
    with torch.no_grad():
        out_eval = ours(torch.from_numpy(x))
    np.testing.assert_allclose(np.moveaxis(out_eval.numpy(), 1, -1),
                               np.asarray(ref_eval), atol=1e-5)
