"""AiFDepthNet's variants in the port (`models/aifnet.py`, the JAX model's
fields `stage2`, `normalize_attention`, `n_classes`, `disp_depth`,
`n_channels` with `add_stack_index_channel`, and `remat`) against the JAX
package on the CPU, from the same Flax init converted by
`models/convert.py:aifnet_state_from_flax`, at 2 x 4 x 64x64; the oracles
of tests/test_model_variants.py:22,38,69 (shapes, the stack index channel,
remat equal to the plain model) held on the port.

Tolerances: eval outputs within 1e-4 of each output's largest value, as
ROADMAP C holds the models' forwards against JAX (two convolution
libraries in f32); the losses within rtol 1e-4.  `remat` against the plain
model: the same operations recomputed, so outputs, gradients and running
statistics within 1e-6, and the statistics prove a single update (a
second would move them by another momentum step).
"""

import numpy as np
import pytest
import torch

from aadff_tpu_torch.models.aifnet import (AiFDepthNet, add_stack_index_channel,
                                           compute_loss)
from aadff_tpu_torch.models.convert import aifnet_state_from_flax
from aadff_tpu_torch.parallel import mesh

B, S, H, W = 2, 4, 64, 64
# name -> the fields of both models
VARIANTS = {
    "direct": {"stage2": "direct"},
    "normalize_attention": {"normalize_attention": True},
    "two_classes_disp": {"n_classes": 2, "disp_depth": "disp"},
    "four_channels": {"n_channels": 4},
    "remat": {"remat": True},
}
# the variants whose parameters differ from the plain model's
OWN_INIT = {"direct", "two_classes_disp", "four_channels"}
LOSS_W = {"disp_w": 1.0, "aif_w": 1.0, "smooth_w": 0.1}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    stack = rng.uniform(0, 1, (B, S, H, W, 3)).astype(np.float32)
    fds = np.sort(rng.uniform(0.5, 3.0, (B, S))).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    depth[0, :, :9] = 0.0
    aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    return stack, fds, depth, aif


@pytest.fixture(scope="module")
def flax_variables():
    """{variant or "plain": Flax variables of JaxAiFDepthNet(n_stack=S,
    **fields) from PRNGKey(0)}, host arrays."""
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415

    from aadff_tpu.models.aifnet import AiFDepthNet as JaxAiF  # noqa: PLC0415

    out = {}
    for name in ("plain", *sorted(OWN_INIT)):
        fields = VARIANTS.get(name, {})
        c = fields.get("n_channels", 3)
        v = jax.jit(JaxAiF(n_stack=S, **fields).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, S, H, W, c)), jnp.zeros((1, S)))
        out[name] = jax.tree.map(np.array, v)
    return out


def _variables(flax_variables, name):
    return flax_variables[name if name in OWN_INIT else "plain"]


def _port(fields, variables):
    model = AiFDepthNet(n_stack=S, **fields)
    model.load_state_dict(aifnet_state_from_flax(variables))
    return model


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_eval_and_loss_match_jax(flax_variables, name):
    """Eval outputs within 1e-4 of the largest value, under the variant's
    keys, and the DA_FS loss with its `disp_depth` within rtol 1e-4."""
    import jax.numpy as jnp  # noqa: PLC0415

    from aadff_tpu.models.aifnet import AiFDepthNet as JaxAiF  # noqa: PLC0415
    from aadff_tpu.models.aifnet import add_stack_index_channel as jax_index  # noqa: PLC0415
    from aadff_tpu.models.aifnet import compute_loss as jax_loss  # noqa: PLC0415

    fields = VARIANTS[name]
    variables = _variables(flax_variables, name)
    stack, fds, depth, aif = _inputs()
    jstack = jnp.asarray(stack)
    tstack = torch.from_numpy(stack)
    if fields.get("n_channels") == 4:
        jstack, tstack = jax_index(jstack), add_stack_index_channel(tstack)
    ref = JaxAiF(n_stack=S, **fields).apply(variables, jstack, jnp.asarray(fds))
    model = _port(fields, variables).eval()
    with torch.no_grad():
        out = model(tstack, torch.from_numpy(fds))
    key = f"pred_{fields.get('disp_depth', 'depth')}"
    assert set(out) == set(ref) == {key, "pred_AiF_img"}
    for k in out:
        r = np.asarray(ref[k])
        assert out[k].shape == r.shape
        err = np.abs(out[k].numpy() - r).max() / np.abs(r).max()
        print(f"measured: {name} {k} {err:.3g} of the largest value")
        assert err <= 1e-4, (k, err)
    dd = fields.get("disp_depth", "depth")
    ours = compute_loss(out, {dd: torch.from_numpy(depth),
                              "AiF_img": torch.from_numpy(aif)}, "DA_FS",
                        disp_depth=dd, **LOSS_W)
    theirs = jax_loss(ref, {dd: jnp.asarray(depth), "AiF_img": jnp.asarray(aif)},
                      "DA_FS", disp_depth=dd, **LOSS_W)
    assert set(ours) == set(theirs) == {dd, "disp_MSE", "AiF", "smooth", "total"}
    for k in ours:
        np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(OWN_INIT))
def test_converter_covers_every_variant_leaf(flax_variables, name):
    """Every Flax parameter and statistic of the variant lands in the
    port's state dict, shape for shape."""
    import jax  # noqa: PLC0415

    variables = flax_variables[name]
    sd = aifnet_state_from_flax(variables)
    n_leaves = len(jax.tree.leaves(variables["params"])) + len(
        jax.tree.leaves(variables["batch_stats"]))
    model_sd = AiFDepthNet(n_stack=S, **VARIANTS[name]).state_dict()
    assert len(sd) == n_leaves == len(model_sd)
    assert all(sd[k].shape == v.shape for k, v in model_sd.items())


def test_add_stack_index_channel_matches_jax():
    """tests/test_model_variants.py:38: the index k / S in channel 4."""
    import jax.numpy as jnp  # noqa: PLC0415

    from aadff_tpu.models.aifnet import add_stack_index_channel as jax_index  # noqa: PLC0415

    stack = _inputs()[0]
    ours = add_stack_index_channel(torch.from_numpy(stack)).numpy()
    assert ours.shape == (B, S, H, W, 4)
    np.testing.assert_array_equal(ours, np.asarray(jax_index(jnp.asarray(stack))))
    assert ours[0, 0, 0, 0, 3] == 0.25 and ours[0, 3, 0, 0, 3] == 1.0


def _train_pass(model, stack, fds, depth, aif):
    """One train-mode forward and backward of the DA_FS loss: outputs,
    gradients by parameter name, running statistics."""
    model.train()
    out = model(stack, fds)
    losses = compute_loss(out, {"depth": depth, "AiF_img": aif}, "DA_FS", **LOSS_W)
    losses["total"].backward()
    return ({k: v.detach() for k, v in out.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items() if "running" in k})


def _assert_same_pass(a, b, tol=1e-6):
    """Outputs, gradients and statistics of two train passes within `tol`
    of each tensor's largest magnitude (at least 1)."""
    for da, db in zip(a, b):
        assert set(da) == set(db)
        for k in da:
            scale = max(float(db[k].abs().max()), 1.0)
            assert float((da[k] - db[k]).abs().max()) <= tol * scale, k


def test_remat_matches_plain_and_updates_statistics_once(flax_variables):
    """`remat` recomputes each Mixed block in the backward pass: outputs and
    gradients equal the plain model's, and so do the running statistics
    after one train forward and backward, which the recomputation would
    have moved a second time."""
    variables = flax_variables["plain"]
    inputs = [torch.from_numpy(a) for a in _inputs()]
    plain = _train_pass(_port({}, variables), *inputs)
    remat = _train_pass(_port({"remat": True}, variables), *inputs)
    _assert_same_pass(remat, plain)
    start = aifnet_state_from_flax(variables)
    moved = [k for k, v in remat[2].items() if not torch.equal(v, start[k])]
    assert len(moved) == len(remat[2])  # each statistic took its one update


def _remat_worker(state_dict, inputs):
    """On this rank: the all-reduces of the plain model's and the remat
    model's train pass on the rank's rows, and whether the two passes
    agree (`_assert_same_pass`)."""
    import torch.distributed as dist  # noqa: PLC0415

    calls = []
    all_reduce = dist.all_reduce

    def counting(t, *a, **k):
        calls.append(t.numel())
        return all_reduce(t, *a, **k)

    dist.all_reduce = counting
    rows = [torch.from_numpy(a) for a in mesh.shard_batch(*inputs)]
    out = {}
    for remat in (False, True):
        calls.clear()
        model = AiFDepthNet(n_stack=S, remat=remat)
        model.load_state_dict(state_dict)
        out[remat] = (_train_pass(model, *rows), list(calls))
    _assert_same_pass(out[True][0], out[False][0])
    return {"plain_calls": out[False][1], "remat_calls": out[True][1]}


def test_remat_on_two_ranks_reduces_once(tmp_path, flax_variables):
    """On 2 ranks the recomputation reuses the global sums of the first
    pass: remat makes exactly the all-reduces of the plain model (one per
    BatchNorm forward and backward and one for the loss), and its outputs,
    gradients and statistics equal the plain model's within 1e-6."""
    from test_torch_parallel import run_ranks  # noqa: PLC0415

    inputs = _inputs()
    inputs = (inputs[0][:, :, :32], inputs[1], inputs[2][..., :32, :],
              inputs[3][..., :32, :])
    ranks = run_ranks(tmp_path, _remat_worker,
                      aifnet_state_from_flax(flax_variables["plain"]),
                      tuple(np.ascontiguousarray(a) for a in inputs))
    for out in ranks:
        assert out["remat_calls"] == out["plain_calls"]
        assert len(out["plain_calls"]) > 100
