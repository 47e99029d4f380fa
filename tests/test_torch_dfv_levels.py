"""The port's DFVNet at levels 1, 3 and 4, its pooled decoder and the
converter at every level, against the JAX package on the CPU, from a
seeded Flax init carried across by the converter (no checkpoint of these
levels exists).  Tolerances are tests/test_torch_dfv.py's: outputs within
1e-4 of each output's largest value, BatchNorm statistics within 1e-4 of
each tensor's largest value (f32 convolutions summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadff_tpu.models.dfv import DFVNet as JaxDFVNet
from aadff_tpu.models.dfv.submodule import DecoderBlock as JaxDecoderBlock
from aadff_tpu_torch.models.dfv.convert import (dfvnet_key_map, dfvnet_level,
                                                dfvnet_state_from_flax)
from aadff_tpu_torch.models.dfv.dffnet import DFVNet
from aadff_tpu_torch.models.dfv.submodule import DecoderBlock
from aadff_tpu_torch.models.layers import BatchNorm

B, S, H, W = 1, 4, 64, 64   # tests/test_torch_dfv.py's size (tests/test_models.py:169)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, rel=1e-4):
    """max-abs within `rel` of the reference's largest magnitude."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rel * np.abs(ref).max()


def _batch(seed):
    rng = np.random.default_rng(seed)
    stack = rng.uniform(0, 1, (B, S, H, W, 3)).astype(np.float32)
    fds = np.sort(rng.uniform(0.5, 3.0, (B, S))).astype(np.float32)
    return stack, fds


# --------------------------------------------------------------------------
# Levels 1, 3 and 4 and DecoderBlock(pool=True), from a seeded Flax init
# --------------------------------------------------------------------------
LEVEL_CASES = [(1, 0), (1, 1), (3, 0), (3, 1), (4, 0), (4, 1)]


@pytest.fixture(scope="module", params=LEVEL_CASES,
                ids=[f"level{lv}-diff{d}" for lv, d in LEVEL_CASES])
def level_case(request):
    """DFVNet(level, use_diff) initialised by Flax from PRNGKey(level) and
    carried across by the converter; one batch of the file's size (B 1: a
    batch of 2 through a level-3/4 pool decoder's global pool normalises
    two nearly equal values in train mode, which amplifies f32 rounding by
    up to 1/sqrt(eps)); the JAX eval outputs, train-mode outputs and
    updated batch statistics."""
    level, use_diff = request.param
    stack, fds = _batch(10 + level)
    model = JaxDFVNet(clean=False, level=level, use_diff=use_diff)
    variables = jax.jit(lambda k: model.init(k, stack, fds, train=False))(
        jax.random.PRNGKey(level))

    @jax.jit
    def run(variables):
        ev = model.apply(variables, stack, fds, train=False)
        tr, upd = model.apply(variables, stack, fds, train=True,
                              mutable=["batch_stats"])
        return ev, tr, upd["batch_stats"]

    ev, tr, bs = jax.tree.map(np.asarray, run(variables))
    variables = jax.tree.map(np.asarray, variables)
    net = DFVNet(level=level, use_diff=use_diff)
    net.load_state_dict(dfvnet_state_from_flax(variables))
    return {"level": level, "variables": variables, "stack": stack, "fds": fds,
            "eval": ev, "train": tr, "batch_stats": bs, "net": net}


def test_level_eval_forward_matches_jax(level_case):
    """pred, std and prob of levels 1, 3 and 4 (use_diff 0 and 1) within
    1e-4 of each output's largest value (measured ~5e-7)."""
    net = level_case["net"].eval()
    with torch.no_grad():
        out = net(torch.from_numpy(level_case["stack"]),
                  torch.from_numpy(level_case["fds"]))
    assert [tuple(o.shape) for o in out] == [(B, 1, H, W), (B, H, W),
                                             (B, S, H, W)]
    for ours, ref in zip(out, level_case["eval"]):
        _close(ours.numpy(), ref)


def test_level_train_forward_matches_jax(level_case):
    """(stacked, stds) of every level of the net in train mode (levels 3
    and 4 take their coarse costs through the trilinear resize to
    (S, H, W)) within 1e-4 of the largest value (measured 1.4e-5 to
    2.6e-5), and the updated BatchNorm statistics within 1e-4 of each
    tensor's largest value."""
    net = DFVNet(level=level_case["level"], use_diff=level_case["net"].use_diff)
    net.load_state_dict(level_case["net"].state_dict())
    stacked, stds = net.train()(torch.from_numpy(level_case["stack"]),
                                torch.from_numpy(level_case["fds"]))
    ref_stacked, ref_stds = level_case["train"]
    assert len(stacked) == len(ref_stacked) == level_case["level"]
    for ours, ref in zip(stacked + stds, list(ref_stacked) + list(ref_stds)):
        _close(ours.detach().numpy(), ref)
    ref = dfvnet_state_from_flax({"params": level_case["variables"]["params"],
                                  "batch_stats": level_case["batch_stats"]})
    state = net.state_dict()
    for key in (k for k in state if "running" in k):
        a, b = ref[key].numpy(), state[key].numpy()
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), key


@pytest.mark.parametrize("level,n_params,n_stats,n_weights", [
    (1, 119, 78, 15_450_225), (3, 174, 112, 16_365_123),
    (4, 209, 134, 18_988_484)])
def test_converter_covers_every_flax_leaf_at_each_level(level, n_params,
                                                        n_stats, n_weights):
    """Every Flax leaf of a seeded DFVNet(level) lands in exactly one
    state-dict entry of the port's DFVNet(level): with pool=True the pool
    convs take SepConv3d_0..3, classify _4/_5 and the upsample conv _6,
    and a width-changing first block its ProjFeat3d_0."""
    model = JaxDFVNet(clean=False, level=level, use_diff=1)
    variables = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 2, 64, 64, 3)), jnp.zeros((1, 2)), train=False),
        jax.random.PRNGKey(0))
    leaves = {
        (collection, tuple(k.key for k in path))
        for collection in ("params", "batch_stats")
        for path, _ in jax.tree_util.tree_flatten_with_path(
            variables[collection])[0]}
    assert dfvnet_level(variables["params"]) == level
    key_map = dfvnet_key_map(level)
    assert len(leaves) == n_params + n_stats
    assert sorted(key_map.values()) == sorted(leaves)  # each exactly once
    state = DFVNet(level=level).state_dict()
    assert set(key_map) == set(state)
    for key, (collection, path) in key_map.items():
        leaf = variables[collection]
        for part in path:
            leaf = leaf[part]
        assert int(np.prod(leaf.shape)) == state[key].numel(), key
    assert sum(v.numel() for k, v in state.items()
               if "running" not in k) == n_weights


def test_bad_level_raises():
    with pytest.raises(ValueError, match="level"):
        DFVNet(level=5)


def _decoder_torch_state(params, stats):
    """The port's DecoderBlock state dict from a Flax DecoderBlock(pool=True,
    up=True) whose first block has a ProjFeat3d shortcut."""
    def sep(name, path, bias=False):
        out = {}
        leaf = params
        for part in path:
            leaf = leaf[part]
        k = leaf["TorchConv_0"]["Conv_0"]["kernel"]
        out[f"{name}.conv.weight"] = k.transpose(4, 3, 0, 1, 2)
        if bias:
            out[f"{name}.conv.bias"] = leaf["TorchConv_0"]["Conv_0"]["bias"]
        else:
            st = stats
            for part in path:
                st = st[part]
            out.update({f"{name}.bn.weight": leaf["BatchNorm_0"]["scale"],
                        f"{name}.bn.bias": leaf["BatchNorm_0"]["bias"],
                        f"{name}.bn.running_mean": st["BatchNorm_0"]["mean"],
                        f"{name}.bn.running_var": st["BatchNorm_0"]["var"]})
        return out

    state = {}
    for i in range(2):
        blk = (f"SepConv3dBlock_{i}",)
        state.update(sep(f"convs.{i}.conv1", (*blk, "SepConv3d_0")))
        state.update(sep(f"convs.{i}.conv2", (*blk, "SepConv3d_1")))
    proj, proj_stats = (params["SepConv3dBlock_0"]["ProjFeat3d_0"],
                        stats["SepConv3dBlock_0"]["ProjFeat3d_0"])
    state.update({
        "convs.0.downsample.conv.weight":
            proj["Conv_0"]["kernel"].transpose(3, 2, 0, 1),
        "convs.0.downsample.bn.weight": proj["BatchNorm_0"]["scale"],
        "convs.0.downsample.bn.bias": proj["BatchNorm_0"]["bias"],
        "convs.0.downsample.bn.running_mean": proj_stats["BatchNorm_0"]["mean"],
        "convs.0.downsample.bn.running_var": proj_stats["BatchNorm_0"]["var"]})
    for j in range(4):
        state.update(sep(f"pool_convs.{j}", (f"SepConv3d_{j}",)))
    state.update(sep("classify.0", ("SepConv3d_4",)))
    state.update(sep("classify.2", ("SepConv3d_5",), bias=True))
    state.update(sep("up_conv", ("SepConv3d_6",)))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pool_decoder_block_matches_jax(train):
    """DecoderBlock(pool=True, up=True) alone at the ragged size decoder5
    sees at 480x640: vol3 [B, 8, 30, 40], pool sizes [1, 2, 3, 4] and the
    window (2, 10, 13) among them; 24 -> 16 channels, so the first block
    projects its shortcut.  Random weights and statistics; features and
    cost within 1e-4 of their largest values, eval and train mode (batch
    statistics)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 8, 30, 40, 24)).astype(np.float32)  # [B,D,h,w,C]
    block = JaxDecoderBlock(2, 16, up=True, pool=True)
    variables = block.init(jax.random.PRNGKey(21), jnp.asarray(x))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        variables)
    (feat, cost), _ = block.apply(variables, jnp.asarray(x), train,
                                  mutable=["batch_stats"])
    net = DecoderBlock(24, 2, 16, up=True, pool=True)
    net.load_state_dict(_decoder_torch_state(variables["params"],
                                             variables["batch_stats"]))
    net.train(train)
    with torch.no_grad():
        ours_feat, ours_cost = net(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert tuple(ours_feat.shape) == (2, 8, 8, 60, 80)
    _close(ours_feat.permute(0, 2, 3, 4, 1).numpy(), np.asarray(feat))
    _close(ours_cost.numpy(), np.asarray(cost))


def test_batchnorm_of_one_value_per_channel_matches_flax():
    """Train mode on one value per channel (a batch of 1 through a pool
    decoder's global pool): Flax normalises it to 0, so the output is the
    bias, the input and scale get no gradient, and the running statistics
    move toward it."""
    import flax.linen as fnn
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 5, 1, 1, 1)).astype(np.float32)
    scale = rng.uniform(0.5, 2, 5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(5, np.float32),
                                 "var": np.ones(5, np.float32)}}
    xt = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    ref, upd = mod.apply(variables, xt, mutable=["batch_stats"])
    g_ref = jax.grad(lambda v, x: mod.apply(v, x, mutable=["batch_stats"])[0].sum(),
                     argnums=(0, 1))(variables, xt)
    bn = BatchNorm(5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xin = torch.from_numpy(x).requires_grad_()
    out = bn(xin)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 4, 1),
                               np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), atol=1e-7)
    np.testing.assert_allclose(xin.grad.numpy().transpose(0, 2, 3, 4, 1),
                               np.asarray(g_ref[1]), atol=1e-6)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(g_ref[0]["params"]["scale"]), atol=1e-6)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(g_ref[0]["params"]["bias"]), atol=1e-6)
