"""The port's DFVNet, its loss and its trainer against the JAX package, on
the CPU, from the trained checkpoint converted for both packages.

Tolerances: convolutions sum in another order in PyTorch than in XLA, in
f32, so outputs agree within 1e-4 of each output's largest value, the
BatchNorm statistics within 1e-4 of each tensor's largest value, and the
3-step loss trajectory within rtol 1e-3 (each Adam step moves every weight
by about the learning rate, so f32 noise grows from step to step), as for
AiFDepthNet in tests/test_torch_aifnet.py and tests/test_torch_trainer.py.
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.models.dfv import DFVNet as JaxDFVNet
from aadff_tpu.models.dfv import dfv_loss as jax_dfv_loss
from aadff_tpu.models.dfv.submodule import SepConv3dBlock as JaxSepConv3dBlock
from aadff_tpu.models.layers import resize_bilinear as jax_resize_bilinear
from aadff_tpu.models.layers import resize_trilinear as jax_resize_trilinear
from aadff_tpu.psfnet import PSFNet as JaxPSFNet
from aadff_tpu.train import dff_dfv as jax_dff_dfv
from aadff_tpu.train.trainer import TrainState as JaxTrainState
from aadff_tpu_torch.models.dfv.convert import (dfvnet_key_map,
                                                dfvnet_state_from_flax,
                                                load_flax_dfvnet)
from aadff_tpu_torch.models.dfv.dffnet import DFVNet, dfv_loss
from aadff_tpu_torch.models.dfv.submodule import SepConv3dBlock
from aadff_tpu_torch.models.layers import resize_bilinear, resize_trilinear
from aadff_tpu_torch.psfnet.psfnet import PSFNet
from aadff_tpu_torch.train import dff_dfv, trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DFV_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "dfvnet",
                        "depth_net_best.msgpack")
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
LR, DECAY_STEPS = 1e-4, 5
B, S, H, W = 1, 4, 64, 64   # the JAX tests' size (tests/test_models.py:169)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it, and a CPU train step then runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, rel=1e-4):
    """max-abs within `rel` of the reference's largest magnitude."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rel * np.abs(ref).max()


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        stack = rng.uniform(0, 1, (B, S, H, W, 3)).astype(np.float32)
        fds = np.sort(rng.uniform(0.5, 3.0, (B, S))).astype(np.float32)
        depth = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
        depth[..., :5, :] = 0.0  # masked pixels
        out.append((stack, fds, depth))
    return out


@pytest.fixture(scope="module")
def case():
    """The checkpoint in both packages, one batch, and the JAX eval outputs,
    train-mode outputs and updated batch_stats."""
    with open(DFV_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    stack, fds, depth = _batches(1, seed=0)[0]
    model = JaxDFVNet(clean=False, level=2, use_diff=1)

    @jax.jit
    def run(variables, stack, fds):
        ev = model.apply(variables, stack, fds, train=False)
        tr, upd = model.apply(variables, stack, fds, train=True,
                              mutable=["batch_stats"])
        return ev, tr, upd["batch_stats"]

    ev, tr, bs = jax.tree.map(np.asarray, run(variables, stack, fds))
    net = DFVNet()
    net.load_state_dict(load_flax_dfvnet(DFV_CKPT)[0])
    return {"variables": variables, "step": int(v["step"]), "stack": stack,
            "fds": fds, "depth": depth, "eval": ev, "train": tr,
            "batch_stats": bs, "net": net}


@pytest.fixture(scope="module")
def torch_train(case):
    """The port's train-mode forward on the case: outputs and the updated
    BatchNorm statistics."""
    net = DFVNet()
    net.load_state_dict(case["net"].state_dict())
    net.train()
    out = net(torch.from_numpy(case["stack"]), torch.from_numpy(case["fds"]))
    return out, net.state_dict()


def test_eval_forward_matches_jax(case):
    """pred [B,1,H,W], std [B,H,W] and the probability volume [B,S,H,W]."""
    net = case["net"].eval()
    with torch.no_grad():
        out = net(torch.from_numpy(case["stack"]), torch.from_numpy(case["fds"]))
    assert [tuple(o.shape) for o in out] == [(B, 1, H, W), (B, H, W),
                                             (B, S, H, W)]
    for ours, ref in zip(out, case["eval"]):
        _close(ours.numpy(), ref)
    np.testing.assert_allclose(out[2].sum(1).numpy(), 1.0, atol=1e-5)


def test_eval_forward_without_diff_matches_jax(case):
    """use_diff=0 (Ours-FV): the same weights, no differencing over the
    stack."""
    model = JaxDFVNet(clean=False, level=2, use_diff=0)
    ref = jax.jit(lambda v, s, f: model.apply(v, s, f, train=False))(
        case["variables"], case["stack"], case["fds"])
    net = DFVNet(use_diff=0)
    net.load_state_dict(case["net"].state_dict())
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(case["stack"]),
                         torch.from_numpy(case["fds"]))
    for ours, r in zip(out, ref):
        _close(ours.numpy(), np.asarray(r))


@pytest.mark.parametrize("stride", [(1, 1, 1), (2, 1, 1)])
def test_projected_block_matches_jax(stride):
    """A SepConv3dBlock that changes width or stride takes its shortcut
    through ProjFeat3d (unused at level 2); random weights and statistics,
    eval mode, within 1e-4 of the largest output."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 6, 6, 4)).astype(np.float32)  # [B,S,h,w,C]
    block = JaxSepConv3dBlock(features=8, stride=stride)
    variables = block.init(jax.random.PRNGKey(5), jnp.asarray(x))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        variables)
    ref = np.asarray(block.apply(variables, jnp.asarray(x)))
    p, bs = variables["params"], variables["batch_stats"]
    state = {}
    for name, flax in (("conv1", "SepConv3d_0"), ("conv2", "SepConv3d_1"),
                       ("downsample", "ProjFeat3d_0")):
        conv = p[flax]["Conv_0"] if name == "downsample" else \
            p[flax]["TorchConv_0"]["Conv_0"]
        k = conv["kernel"]
        state[f"{name}.conv.weight"] = torch.from_numpy(np.ascontiguousarray(
            k.transpose((3, 2, 0, 1) if k.ndim == 4 else (4, 3, 0, 1, 2))))
        for ours, theirs, coll in (("weight", "scale", p), ("bias", "bias", p),
                                   ("running_mean", "mean", bs),
                                   ("running_var", "var", bs)):
            state[f"{name}.bn.{ours}"] = torch.from_numpy(
                coll[flax]["BatchNorm_0"][theirs])
    net = SepConv3dBlock(4, 8, stride)
    net.load_state_dict(state)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    _close(out.permute(0, 2, 3, 4, 1).numpy(), ref)


def test_train_forward_matches_jax(case, torch_train):
    """(stacked, stds) of both levels, with batch statistics."""
    (stacked, stds), _ = torch_train
    ref_stacked, ref_stds = case["train"]
    assert len(stacked) == len(ref_stacked) == 2
    for ours, ref in zip(stacked + stds, list(ref_stacked) + list(ref_stds)):
        _close(ours.detach().numpy(), ref)


def test_updated_batch_stats_match_jax(case, torch_train):
    """Flax's running-statistics rule, each tensor within 1e-4 of its
    largest value (test_torch_aifnet.py's rule: elementwise relative error
    means nothing for means near zero)."""
    _, state = torch_train
    ref = dfvnet_state_from_flax({"params": case["variables"]["params"],
                                  "batch_stats": case["batch_stats"]})
    stats = [k for k in state if "running" in k]
    assert len(stats) == 90
    for key in stats:
        a, b = ref[key].numpy(), state[key].numpy()
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), key


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_dfv_loss_matches_jax(levels):
    """The level-weighted masked L1 on the same stacked/stds/mask."""
    rng = np.random.default_rng(levels)
    stacked = [rng.uniform(0.5, 3, (2, 1, 9, 11)).astype(np.float32)
               for _ in range(levels)]
    stds = [rng.uniform(0, 1, (2, 1, 9, 11)).astype(np.float32)
            for _ in range(levels)]
    gt = rng.uniform(0.5, 3, (2, 1, 9, 11)).astype(np.float32)
    mask = rng.uniform(size=gt.shape) > 0.3
    ref = float(jax_dfv_loss([jnp.asarray(s) for s in stacked], stds,
                             jnp.asarray(gt), jnp.asarray(mask)))
    ours = float(dfv_loss([torch.from_numpy(s) for s in stacked],
                          [torch.from_numpy(s) for s in stds],
                          torch.from_numpy(gt), torch.from_numpy(mask)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


# (steps, lr, cosine decay steps, the step whose batch is NaN, loss rtol):
# three steps as PR 5 held them, and the eight of
# tests/test_trajectory_equivalence.py:144 (lr 1e-3, the schedule over the
# 8 steps, the guard skipping step 3) on one device in both packages, held
# at three times the largest deviation measured (1.9e-3, at step 7).
TRAJECTORIES = {"3": (3, LR, DECAY_STEPS, None, 1e-3),
                "8": (8, 1e-3, 8, 3, 5.8e-3)}


@pytest.mark.parametrize("steps", sorted(TRAJECTORIES), ids=lambda c: f"{c}steps")
def test_train_trajectory_matches_jax(case, steps):
    """Steps from the checkpoint on identical batches, optax.adam with the
    cosine schedule on the JAX side: losses within the case's rtol, a NaN
    batch skipped by both guards, Adam's counts advanced by the trained
    steps only, and the parameter movements pointing the same way (cosine
    > 0.75, as tests/test_trajectory_equivalence.py holds 1 vs 8
    devices)."""
    n_steps, lr, decay, nan_at, rtol = TRAJECTORIES[steps]
    optimizer = optax.adam(optax.cosine_decay_schedule(lr, decay, 0.0))
    params = jax.tree.map(jnp.asarray, case["variables"]["params"])
    jstate = JaxTrainState(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, case["variables"]["batch_stats"]),
        opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))
    jax_step = jax_dff_dfv.make_dfv_train_step(
        JaxDFVNet(clean=False, level=2, use_diff=1), optimizer)

    net = DFVNet()
    net.load_state_dict(case["net"].state_dict())
    start = {k: v.clone() for k, v in net.state_dict().items()}
    state = trainer.create_train_state(net, lr, decay)
    step = dff_dfv.make_dfv_train_step()
    jl, tl, skipped = [], [], []
    for i, (stack, fds, depth) in enumerate(_batches(n_steps, seed=1)):
        if i == nan_at:
            stack = np.full_like(stack, np.nan)
        jstate, jloss = jax_step(jstate, stack, fds, depth)
        losses = step(state, *map(torch.from_numpy, (stack, fds, depth)))
        skipped.append((float(losses["skipped_nonfinite"]),
                        float(jloss["skipped_nonfinite"])))
        jl.append(float(jloss["total"]))
        tl.append(float(losses["total"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(tl, jl) if b]
    ref = dfvnet_state_from_flax({"params": jax.tree.map(np.asarray, jstate.params),
                                  "batch_stats": jax.tree.map(np.asarray,
                                                              jstate.batch_stats)})
    names = [n for n, _ in net.named_parameters()]
    ours = np.concatenate([(net.state_dict()[n] - start[n]).numpy().ravel() for n in names])
    theirs = np.concatenate([(ref[n] - start[n]).numpy().ravel() for n in names])
    cos = float(ours @ theirs / (np.linalg.norm(ours) * np.linalg.norm(theirs)))
    print(f"measured: DFV {n_steps}-step loss rel max {max(rel):.3g}",
          np.array2string(np.array(rel), precision=2, max_line_width=300),
          f"movement cosine {cos:.4f}")
    assert skipped == [(float(i == nan_at),) * 2 for i in range(n_steps)]
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    trained = n_steps - (nan_at is not None)
    assert int(state.step) == n_steps and int(state.opt.count) == trained
    assert int(state.opt.schedule_count) == int(jstate.opt_state[1].count) == trained
    assert cos > 0.75


def test_nan_batch_leaves_state_unchanged(case):
    """The analogue of tests/test_models.py:258: a NaN batch keeps params,
    Adam moments and count and BN statistics, reports total 0 and
    skipped_nonfinite 1; a sane batch afterwards updates again."""
    net = DFVNet()
    net.load_state_dict(case["net"].state_dict())
    state = trainer.create_train_state(net, LR, DECAY_STEPS)
    step = dff_dfv.make_dfv_train_step()
    stack, fds, depth = map(torch.from_numpy, _batches(1, seed=2)[0])
    step(state, stack, fds, depth)  # warm moments, count 1
    before = {k: v.clone() for k, v in net.state_dict().items()}
    moments = [m.clone() for m in state.opt.mu + state.opt.nu]
    losses = step(state, torch.full_like(stack, float("nan")), fds, depth)
    assert float(losses["skipped_nonfinite"]) == 1.0
    assert float(losses["total"]) == 0.0
    after = net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(a, b) for a, b in
               zip(moments, state.opt.mu + state.opt.nu))
    assert int(state.opt.count) == 1 and int(state.step) == 2
    losses = step(state, stack, fds, depth)
    assert float(losses["skipped_nonfinite"]) == 0.0
    assert not torch.equal(before["decoder3.classify.2.conv.bias"],
                           net.state_dict()["decoder3.classify.2.conv.bias"])


def test_converter_covers_every_flax_leaf(case):
    """Every Flax leaf of the checkpoint lands in exactly one state-dict
    entry of the port's DFVNet, and none is left over."""
    leaves = {
        (collection, tuple(k.key for k in path))
        for collection in ("params", "batch_stats")
        for path, _ in jax.tree_util.tree_flatten_with_path(
            case["variables"][collection])[0]}
    key_map = dfvnet_key_map()
    assert len(leaves) == 139 + 90
    assert sorted(key_map.values()) == sorted(leaves)  # each exactly once
    state = case["net"].state_dict()
    converted, step = load_flax_dfvnet(DFV_CKPT)
    assert set(converted) == set(key_map) == set(state) and step == 840
    for key, value in converted.items():
        assert value.shape == state[key].shape, key
    assert sum(v.numel() for k, v in converted.items()
               if "running" not in k) == 15_707_778


@pytest.mark.parametrize("src,dst", [((7, 10), (15, 20)), ((1, 1), (15, 20)),
                                     ((16, 16), (64, 64))])
def test_resize_bilinear_matches_jax_when_upsampling(src, dst):
    x = np.random.default_rng(0).normal(size=(2, 3, *src)).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                         dst)).transpose(0, 3, 1, 2)
    ours = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_resize_trilinear_matches_jax_when_upsampling():
    """The decoder's upsample: stack depth kept, h and w doubled."""
    x = np.random.default_rng(1).normal(size=(1, 5, 4, 8, 8)).astype(np.float32)
    ref = np.asarray(jax_resize_trilinear(
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)), (4, 16, 16)))
    ours = resize_trilinear(torch.from_numpy(x), (4, 16, 16)).numpy()
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 4, 1), ref, atol=1e-6)


def test_diff_volume_matches_jax():
    vol = np.random.default_rng(2).normal(size=(2, 5, 3, 4, 6)).astype(np.float32)
    ref = np.asarray(JaxDFVNet._diff_volume(jnp.asarray(vol)))  # [B,S,h,w,C]
    ours = DFVNet._diff_volume(torch.from_numpy(vol).permute(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 4, 1).numpy(), ref)


def test_validate_matches_jax(case):
    """validate_dfv on one batch: render through PSFNet at its sensor size
    (the port's plain render, JAX's XLA path), eval forward, the masked
    metrics.  abs_rel, mse, mae and rmse within rtol 1e-4 (the outputs'
    own tolerance); acc1 within one valid pixel's share, since a pixel
    whose ratio lies on the 1.25 threshold may fall either way."""
    rng = np.random.default_rng(4)
    aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    gt = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    gt[..., :6] = 0.0
    lens = JaxPSFNet(LENS, kernel_size=11, sensor_res=(H, W))
    lens.load_net(PSFNET_CKPT)
    model = JaxDFVNet(clean=False, level=2, use_diff=1)
    jstate = JaxTrainState(params=case["variables"]["params"],
                           batch_stats=case["variables"]["batch_stats"],
                           opt_state=None, step=0)
    logging.disable(logging.INFO)
    try:
        ref = jax_dff_dfv.validate_dfv(jax_dff_dfv.make_dfv_eval_step(model),
                                       jstate, lens, [(aif, gt)], S, 0, {})
    finally:
        logging.disable(logging.NOTSET)

    net = PSFNet(kernel_size=11, sensor_res=(H, W), device="cpu")
    net.load_net(PSFNET_CKPT)
    state = trainer.create_train_state(case["net"], LR, DECAY_STEPS)
    ours = dff_dfv.validate_dfv(dff_dfv.make_dfv_eval_step(), state, net,
                                [(torch.from_numpy(aif), torch.from_numpy(gt))],
                                S)
    assert set(ours) == set(ref) == set(dff_dfv.METRICS)
    for key in ("abs_rel", "mse", "mae", "rmse"):
        np.testing.assert_allclose(ours[key], float(ref[key]), rtol=1e-4)
    assert abs(ours["acc1"] - float(ref["acc1"])) <= 1.0 / (gt > 0).sum()
