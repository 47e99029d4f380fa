"""Data parallelism of the port (`aadff_tpu_torch/parallel/mesh.py`) on the
CPU: ranks are processes joined by gloo through a `file://` rendezvous in
the test's tmp_path, and are held to one process and to the JAX package on
a 2-device mesh (the conftest gives JAX 8 CPU devices):
  (a) BatchNorm, 2 ranks x 1 row against 1 process x 2 rows, and the
      pooled case of one value per channel on each rank;
  (b) compute_loss / dfv_loss with unequal mask counts on the two ranks;
  (c) AiF and DFV train steps from the trained checkpoints against JAX's
      steps on `make_mesh(2)`;
  (d) a NaN depth in rank 1's rows: both ranks skip, in the guard and in
      the loop;
  (e) `train/dff_aif.py:train` on 2 ranks against 1 process, on PNG scenes
      of `dff/synth.make_scenes`;
  (f) the dry-run twin (`scripts/dryrun_multichip.py`) against JAX's two
      steps from the same Flax init;
and the inter-process build lock (`ops/_build.py:build_lock`).

Each group of ranks has its own init timeout and join deadline, so a hung
collective fails its test; each rank pins torch to 2 threads.

Tolerances: BatchNorm and the losses against one process and against
Flax / JAX within 1e-6 of the largest magnitude (the same sums in another
order), but BatchNorm on two values per channel at 3e-5 (`BN_CASES`: the
input's gradient there is a cancellation of far larger terms, and Flax's
variance formula is not the port's).  The steps against JAX as tests/test_torch_trainer.py
holds one device: step-1 losses within rtol 1e-5 (a forward in f32 through
two convolution libraries), 3 steps within rtol 1e-3 (Adam moves every
weight by about lr, so f32 noise grows), BatchNorm statistics after step 1
within 1e-4 of each tensor's largest value.  The ranks' parameters after
the steps are bit-identical: every rank applies the same all-reduced
gradient.
"""
import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import pytest
import torch

from aadff_tpu_torch.models.dfv.dffnet import dfv_loss
from aadff_tpu_torch.models.layers import BatchNorm
from aadff_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT_TIMEOUT_S = 120     # a collective that waits longer fails its rank
JOIN_DEADLINE_S = 420    # a group still running then is killed and fails
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


# ---- the harness: n gloo ranks of one worker function ---------------------
def _rank_main(worker, rank, n, init, out_dir, args):
    """One rank: join the group, run worker(*args), save what it returns
    to rank<r>.pt (or the traceback to rank<r>.err)."""
    torch.set_num_threads(THREADS)
    try:
        mesh.setup("gloo", "cpu", rank=rank, world_size=n, init_method=init,
                   timeout_s=INIT_TIMEOUT_S)
        result = worker(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        mesh.teardown()


def run_ranks(tmp_path, worker, *args, n=2):
    """worker(*args) on n gloo ranks (spawned processes) -> the n results."""
    out = tmp_path / f"ranks_{worker.__name__}"
    out.mkdir()
    init = f"file://{out}/rendezvous"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(worker, r, n, init, str(out), args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_DEADLINE_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (out / f"rank{r}.err").read_text() for r in range(n)
              if (out / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} still running after {JOIN_DEADLINE_S} s"
    assert not errors and all(p.exitcode == 0 for p in procs), errors
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def _rows(a, rank, n=2):
    k = a.shape[0] // n
    return a[rank * k:(rank + 1) * k]


def _close(ours, ref, rel=1e-6):
    """max |ours - ref| within `rel` of ref's largest magnitude (at least
    1): sums of the same terms in another order."""
    scale = max(float(ref.abs().max()), 1.0)
    err = float((ours - ref).abs().max())
    assert err <= rel * scale, f"{err:.3g} > {rel:g} x {scale:.3g}"


# ---- (a) BatchNorm over the global batch ---------------------------------
def _bn_run(x, coef, w, b, rank=None):
    """BatchNorm in train mode on x (this rank's rows when `rank` is given),
    the objective sum(y * coef) backpropagated: y, the running statistics
    and the gradients of weight, bias and x."""
    if rank is not None:
        x, coef = _rows(x, rank), _rows(coef, rank)
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    bn.train()
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * coef).sum().backward()
    return {"y": y.detach(), "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(), "dw": bn.weight.grad.clone(),
            "db": bn.bias.grad.clone(), "dx": x.grad.clone()}


def _bn_worker(x, coef, w, b):
    return _bn_run(x, coef, w, b, rank=mesh.rank())


def _flax_bn(x, coef, w, b):
    """Flax's nn.BatchNorm (momentum 0.9, epsilon 1e-5, channels on axis 1)
    in train mode on the whole batch: the same quantities as `_bn_run`."""
    import flax.linen as fnn  # noqa: PLC0415
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       axis=1)
    stats = {"mean": jnp.zeros(x.shape[1]), "var": jnp.ones(x.shape[1])}

    def objective(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(coef.numpy())), (y, upd["batch_stats"])

    params = {"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(b.numpy())}
    (_, (y, new)), (dp, dx) = jax.value_and_grad(objective, (0, 1), has_aux=True)(
        params, jnp.asarray(x.numpy()))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {"y": t(y), "mean": t(new["mean"]), "var": t(new["var"]),
            "dw": t(dp["scale"]), "db": t(dp["bias"]), "dx": t(dx)}


# (shape, tolerance): 'pooled' has one value per channel on each rank, as
# DecoderBlock's global pool leaves at bs 2 over 2 ranks.  Two values per
# channel normalise to about -1 and +1 whatever they are, so the input's
# gradient (|dx| <= 2.5e-3 here) is the small difference of terms of order
# w / var^1.5 (~100) that cancel, and another order of the sums moves it by
# their ulps: measured 1.5e-6 against one process and 1.05e-5 against
# Flax, whose E[x^2] - E[x]^2 also moves y by 5.5e-6 on two values (the
# ranks and one process take the two-pass variance).  Held at 3e-5 there.
BN_CASES = {"5d": ((2, 6, 3, 4, 5), 1e-6), "pooled": ((2, 6, 1, 1, 1), 3e-5)}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_two_ranks_equal_one_process_and_flax(tmp_path, case):
    """2 ranks x 1 row against Flax's BatchNorm on the 2 rows and against
    the port's one process x 2 rows, within the case's tolerance of each
    tensor's largest magnitude (at least 1): outputs,
    running statistics (the same on both ranks), the gradients of weight
    and bias (summed over the ranks: each rank's objective is its rows'
    share) and of each rank's rows.  In 'pooled' the global batch holds
    two values per channel, and they are normalised."""
    rng = np.random.default_rng(0)
    shape, tol = BN_CASES[case]
    x = torch.from_numpy(rng.normal(0.3, 1.5, shape).astype(np.float32))
    coef = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, shape[1]).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=shape[1]).astype(np.float32))
    ranks = run_ranks(tmp_path, _bn_worker, x, coef, w, b)
    for ref in (_flax_bn(x, coef, w, b), _bn_run(x, coef, w, b)):
        for r, out in enumerate(ranks):
            for k in ("y", "dx"):
                _close(out[k], _rows(ref[k], r), tol)
            for k in ("mean", "var"):
                _close(out[k], ref[k], tol)
                assert torch.equal(out[k], ranks[0][k])
        for k in ("dw", "db"):
            _close(ranks[0][k] + ranks[1][k], ref[k], tol)
        assert float(ref["y"].abs().max()) > 0.5  # normalised, not the bias


# ---- (b) the masked means of the losses over the global batch -----------
def _loss_batch():
    """Outputs and targets of 2 rows whose masks hold different counts
    (rank 0's row has a third of its depths invalid, rank 1's none)."""
    rng = np.random.default_rng(1)
    B, H, W = 2, 16, 24
    pred = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    depth[0, :, : H // 3] = 0.0
    gt_aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    levels = [rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
              for _ in range(3)]
    return pred, aif, depth, gt_aif, levels


LOSS_W = {"disp_w": 1.0, "aif_w": 1.0, "smooth_w": 0.1}
TASKS = ("D_FS", "A_FS", "DA_FS")


def _port_losses(rank=None):
    """compute_loss of each task and dfv_loss on the batch (this rank's rows
    when `rank` is given), with the gradients of the predictions."""
    from aadff_tpu_torch.models.aifnet import compute_loss  # noqa: PLC0415

    pred, aif, depth, gt_aif, levels = (
        _loss_batch() if rank is None else
        [(_rows(a, rank) if not isinstance(a, list) else [_rows(x, rank) for x in a])
         for a in _loss_batch()])
    out = {}
    for task in TASKS:
        p = torch.from_numpy(pred).requires_grad_(True)
        a = torch.from_numpy(aif).requires_grad_(True)
        losses = compute_loss({"pred_depth": p, "pred_AiF_img": a},
                              {"depth": torch.from_numpy(depth),
                               "AiF_img": torch.from_numpy(gt_aif)}, task, **LOSS_W)
        losses["total"].backward()
        out[task] = ({k: float(v) for k, v in losses.items()},
                     *(torch.zeros_like(t) if t.grad is None else t.grad.clone()
                       for t in (p, a)))
    ps = [torch.from_numpy(x).requires_grad_(True) for x in levels]
    d = torch.from_numpy(depth)
    total = dfv_loss(ps, None, d, d > 0)
    total.backward()
    out["dfv"] = ({"total": float(total)}, [p.grad.clone() for p in ps])
    return out


def _loss_worker():
    return _port_losses(mesh.rank())


def test_masked_losses_two_ranks_equal_one_process_and_jax(tmp_path):
    """The masks of the two ranks hold different counts, so the mean of the
    ranks' masked means would differ from the global one.  Each rank's loss
    equals one process's and JAX's on the whole batch within 1e-6, and each
    rank's gradient, averaged over the ranks as `guarded_step` averages the
    parameters' gradients, equals one process's on its rows."""
    import jax.numpy as jnp  # noqa: PLC0415

    from aadff_tpu.models.aifnet import compute_loss as jax_loss  # noqa: PLC0415
    from aadff_tpu.models.dfv.dffnet import dfv_loss as jax_dfv_loss  # noqa: PLC0415

    pred, aif, depth, gt_aif, levels = _loss_batch()
    counts = (depth > 0).reshape(2, -1).sum(1)
    assert counts[0] != counts[1]
    ref = _port_losses()
    ranks = run_ranks(tmp_path, _loss_worker)
    for task in TASKS:
        jl = jax_loss({"pred_depth": jnp.asarray(pred), "pred_AiF_img": jnp.asarray(aif)},
                      {"depth": jnp.asarray(depth), "AiF_img": jnp.asarray(gt_aif)},
                      task, **LOSS_W)
        for r, out in enumerate(ranks):
            losses, dp, da = out[task]
            assert set(losses) == set(ref[task][0])
            for k, v in losses.items():
                assert v == pytest.approx(ref[task][0][k], rel=0, abs=1e-6), (task, k)
                assert v == pytest.approx(float(jl[k]), rel=0, abs=1e-6), (task, k)
            _close(dp / 2, _rows(ref[task][1], r))
            _close(da / 2, _rows(ref[task][2], r))
    jd = float(jax_dfv_loss([jnp.asarray(x) for x in levels], None,
                            jnp.asarray(depth), jnp.asarray(depth > 0)))
    for r, out in enumerate(ranks):
        assert out["dfv"][0]["total"] == pytest.approx(ref["dfv"][0]["total"],
                                                       rel=0, abs=1e-6)
        assert out["dfv"][0]["total"] == pytest.approx(jd, rel=0, abs=1e-6)
        for g, g_ref in zip(out["dfv"][1], ref["dfv"][1]):
            _close(g / 2, _rows(g_ref, r))


def test_one_process_functions_are_the_identity():
    """With no active mesh every function leaves its input as it is and the
    world is one process."""
    assert mesh.active() is None and mesh.size() == 1 and not mesh.distributed()
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.sum_over_ranks(x) is x
    assert mesh.mean_over_ranks([x])[0] is x
    assert torch.equal(mesh.shard_batch(x)[0], x)
    assert mesh.any_over_ranks(True) and not mesh.any_over_ranks(False)
    assert mesh.broadcast_object("a") == "a"
    mesh.check_batch(1)
    mesh.barrier()


def test_nccl_without_cuda_and_unknown_backends_are_refused():
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        mesh.setup("nccl", "cpu", rank=0, world_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.setup("nccl", "cuda", rank=0, world_size=1)
    with pytest.raises(ValueError, match="backend must be one of"):
        mesh.setup("mpi", "cpu", rank=0, world_size=1)
    assert mesh.active() is None


# ---- (c) train steps against JAX's 2-device mesh -------------------------
AIF_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "aifnet", "depth_net_best.msgpack")
DFV_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "dfvnet", "depth_net_best.msgpack")
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
B, S, H, W = 2, 4, 64, 64
LR, DECAY, STEPS = 1e-4, 10, 3
# the dry run's AiF objective (__graft_entry__.py:116): every loss term
AIF_TASK = ("DA_FS", {"aif_w": 1.0, "smooth_w": 0.1})


def _batches(n, seed=2):
    """n global batches (stack, focus, depth, aif) of B rows whose masks
    hold different counts (row 0 has a quarter of its depths at 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        stack = rng.uniform(0, 1, (B, S, H, W, 3)).astype(np.float32)
        fds = np.sort(rng.uniform(0.5, 3.0, (B, S))).astype(np.float32)
        depth = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
        depth[0, :, : H // 4] = 0.0
        depth[1, :, :, :3] = 0.0
        aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
        out.append((stack, fds, depth, aif))
    return out


@pytest.fixture(scope="module")
def jax_mesh_steps():
    """JAX's AiF (DA_FS) and DFV train steps, jitted, and a runner that
    takes Flax variables through a list of global batches sharded over
    `make_mesh(2)`: (losses of each step, batch_stats after step 1, the
    final state)."""
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415
    import optax  # noqa: PLC0415

    from aadff_tpu.models.aifnet import AiFDepthNet as JaxAiF  # noqa: PLC0415
    from aadff_tpu.models.dfv import DFVNet as JaxDFV  # noqa: PLC0415
    from aadff_tpu.parallel.mesh import make_mesh, replicate  # noqa: PLC0415
    from aadff_tpu.parallel.mesh import shard_batch as jax_shard  # noqa: PLC0415
    from aadff_tpu.train import trainer as jt  # noqa: PLC0415
    from aadff_tpu.train.dff_dfv import make_dfv_train_step  # noqa: PLC0415

    jmesh = make_mesh(2)
    opt = optax.adam(optax.cosine_decay_schedule(LR, DECAY, alpha=0.0))
    models = {"aif": JaxAiF(n_stack=S),
              "dfv": JaxDFV(clean=False, level=2, use_diff=1)}
    steps = {"aif": jt.make_aif_train_step(models["aif"], opt, AIF_TASK[0],
                                           **AIF_TASK[1]),
             "dfv": make_dfv_train_step(models["dfv"], opt)}

    def run(family, variables, batches):
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = replicate(jmesh, jt.TrainState(
            params=params, batch_stats=jax.tree.map(jnp.asarray,
                                                    variables["batch_stats"]),
            opt_state=opt.init(params), step=jnp.zeros((), jnp.int32)))
        losses, stats1 = [], None
        for i, (stack, fds, depth, aif) in enumerate(batches):
            b = jax_shard(jmesh, dict(stack=stack, fp=fds, depth=depth, aif=aif))
            if family == "aif":
                state, out = steps["aif"](state, b["stack"], b["fp"], b["depth"],
                                          b["aif"])
            else:
                state, out = steps["dfv"](state, b["stack"], b["fp"], b["depth"])
            losses.append({k: float(v) for k, v in out.items()})
            if i == 0:
                stats1 = jax.tree.map(np.asarray, state.batch_stats)
        return losses, stats1, state

    def init(family, seed):
        """Flax's initial variables of the family, as the dry run makes them."""
        state = jt.create_train_state(models[family], opt,
                                      jnp.zeros((1, S, H, W, 3)),
                                      jnp.zeros((1, S)), jax.random.PRNGKey(seed))
        # host copies: the jitted steps donate the device arrays they take
        return {"params": jax.tree.map(np.array, state.params),
                "batch_stats": jax.tree.map(np.array, state.batch_stats)}

    return run, init


def _port_model(family, state_dict=None):
    """The family's port model from `state_dict` (the trained checkpoint's
    where None)."""
    from aadff_tpu_torch.models.aifnet import AiFDepthNet  # noqa: PLC0415
    from aadff_tpu_torch.models.convert import load_flax_aifnet  # noqa: PLC0415
    from aadff_tpu_torch.models.dfv.convert import load_flax_dfvnet  # noqa: PLC0415
    from aadff_tpu_torch.models.dfv.dffnet import DFVNet  # noqa: PLC0415

    if family == "aif":
        model, load = AiFDepthNet(), load_flax_aifnet
    else:
        model, load = DFVNet(clean=False, level=2, use_diff=1), load_flax_dfvnet
    model.load_state_dict(load({"aif": AIF_CKPT, "dfv": DFV_CKPT}[family])[0]
                          if state_dict is None else state_dict)
    return model


def _port_step(family):
    from aadff_tpu_torch.train.dff_dfv import make_dfv_train_step  # noqa: PLC0415
    from aadff_tpu_torch.train.trainer import make_aif_train_step  # noqa: PLC0415

    if family == "aif":
        step = make_aif_train_step(AIF_TASK[0], **AIF_TASK[1])
        return lambda st, stack, fds, depth, aif: step(st, stack, fds, depth, aif)
    step = make_dfv_train_step()
    return lambda st, stack, fds, depth, aif: step(st, stack, fds, depth)


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def _digest(model):
    """A hash of the model's parameters, bit for bit (the ranks' parameters
    are compared by it rather than sent whole between processes)."""
    import hashlib  # noqa: PLC0415

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def _steps_worker(family, batches):
    """The family's steps on this rank's rows of each batch, from the
    trained checkpoint: losses, statistics after step 1, parameters."""
    from aadff_tpu_torch.train.trainer import create_train_state  # noqa: PLC0415

    model = mesh.replicate(_port_model(family))
    state = create_train_state(model, LR, DECAY)
    step = _port_step(family)
    losses, stats1 = [], None
    for i, batch in enumerate(batches):
        out = step(state, *(torch.from_numpy(a) for a in mesh.shard_batch(*batch)))
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            stats1 = _stats(model)
    return {"losses": losses, "stats1": stats1, "params": _digest(model),
            "step": int(state.step), "count": int(state.opt.count)}


def _stats_deviation(stats, flax_stats, convert, params):
    """The largest deviation of a BatchNorm statistic from JAX's, over that
    tensor's largest value."""
    ref = convert({"params": params, "batch_stats": flax_stats})
    return max(float((v - ref[k]).abs().max() / max(float(ref[k].abs().max()), 1e-6))
               for k, v in stats.items())


@pytest.mark.parametrize("family", ["aif", "dfv"])
def test_steps_on_two_ranks_match_jax_mesh(tmp_path, jax_mesh_steps, family):
    """3 train steps (AiF: DA_FS with aif_w 1, smooth_w 0.1, every loss
    term; DFV level 2) from the trained checkpoint on 2 ranks against JAX's
    step on a 2-device mesh: step-1 losses within rtol 1e-5, 3 steps within
    1e-3, BatchNorm statistics after step 1 within 1e-4 of each tensor's
    largest value, and the two ranks' parameters bit-identical."""
    from flax.serialization import msgpack_restore  # noqa: PLC0415

    from aadff_tpu_torch.models.convert import aifnet_state_from_flax  # noqa: PLC0415
    from aadff_tpu_torch.models.dfv.convert import dfvnet_state_from_flax  # noqa: PLC0415

    run, _ = jax_mesh_steps
    with open({"aif": AIF_CKPT, "dfv": DFV_CKPT}[family], "rb") as f:
        variables = msgpack_restore(f.read())
    batches = _batches(STEPS)
    jl, jstats1, _ = run(family, variables, batches)
    ranks = run_ranks(tmp_path, _steps_worker, family, batches)
    convert = {"aif": aifnet_state_from_flax, "dfv": dfvnet_state_from_flax}[family]
    params = variables["params"]
    for out in ranks:
        ours = [x["total"] for x in out["losses"]]
        theirs = [x["total"] for x in jl]
        print(f"measured: {family} 2-rank losses {ours}, JAX {theirs}")
        np.testing.assert_allclose(ours[0], theirs[0], rtol=1e-5)
        np.testing.assert_allclose(ours, theirs, rtol=1e-3)
        for k in out["losses"][0]:
            np.testing.assert_allclose(out["losses"][0][k], jl[0][k], rtol=1e-5,
                                       atol=1e-7)
        assert _stats_deviation(out["stats1"], jstats1, convert, params) <= 1e-4
        assert out["step"] == out["count"] == STEPS
    assert ranks[0]["params"] == ranks[1]["params"]


# ---- (d) a NaN in one rank's rows -----------------------------------------
def _nan_guard_worker(batch):
    """The AiF step on a batch whose NaN depth lies in rank 1's rows only:
    the losses and whether the state moved."""
    from aadff_tpu_torch.train.trainer import create_train_state  # noqa: PLC0415

    model = mesh.replicate(_port_model("aif"))
    state = create_train_state(model, LR, DECAY)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = _port_step("aif")(state, *(torch.from_numpy(a)
                                     for a in mesh.shard_batch(*batch)))
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])]
    return {"losses": {k: float(v) for k, v in out.items()}, "moved": moved,
            "count": int(state.opt.count), "mu_zero": all(
                bool((m == 0).all()) for m in state.opt.mu)}


def test_nan_in_one_ranks_rows_skips_the_step_on_both(tmp_path):
    """The guard: a NaN depth in rank 1's rows only makes rank 1's masked
    sums NaN, the global loss NaN, and both ranks skip the update: no
    parameter, statistic, moment or count moves on either, and neither
    hangs.  (The loop's skip: `test_train_on_two_ranks_matches_one_process`.)"""
    stack, fds, depth, aif = _batches(1)[0]
    depth[1, 0, 5, 7] = np.nan
    ranks = run_ranks(tmp_path, _nan_guard_worker, (stack, fds, depth, aif))
    for out in ranks:
        assert out["losses"]["skipped_nonfinite"] == 1.0
        assert out["losses"]["total"] == 0.0
        assert out["moved"] == [] and out["count"] == 0 and out["mu_zero"]


# ---- (e) train/dff_aif.py:train on 2 ranks ---------------------------------
TRAIN_RES, TRAIN_SCENES, VAL_SCENES = (32, 64), 4, 2


def _write_scenes(root, n, seed):
    """n SynthMiddlebury-layout scenes of dff/synth.make_scenes at
    TRAIN_RES: <scene>/im0.png (8-bit RGB) and depth.png (uint16 mm)."""
    from aadff_tpu_torch.dff.synth import make_scenes  # noqa: PLC0415
    from aadff_tpu_torch.utils.image import write_png  # noqa: PLC0415

    aif, depth = make_scenes(n, *TRAIN_RES, torch.Generator().manual_seed(seed), "cpu")
    rgb = (aif * 255).round().byte().permute(0, 2, 3, 1).numpy()
    mm = (depth[:, 0] * 1000).round().numpy().astype(np.uint16)
    for i in range(n):
        d = os.path.join(root, f"scene{i}")
        os.makedirs(d)
        write_png(os.path.join(d, "im0.png"), rgb[i])
        write_png(os.path.join(d, "depth.png"), mm[i])
    return root


@pytest.fixture
def train_args(tmp_path):
    """configs/aber_aware_dff_synth.yml at 32x64 with 4 frames, 1 epoch,
    its sets 4 + 2 scenes, and as dffnet_pretrained the trained AiFDepthNet
    stripped at step 0 (the checkpoint's own step would put the cosine
    schedule at its end, lr 0).  From a random init the first Adam steps
    move noise-level weights by lr in either sign (ROADMAP C)."""
    from aadff_tpu_torch.utils import flax_msgpack  # noqa: PLC0415
    from aadff_tpu_torch.utils.config import load_config  # noqa: PLC0415

    args = load_config(os.path.join(REPO, "configs", "aber_aware_dff_synth.yml"))
    for section in ("train", "test"):
        args[section]["lens"] = LENS
        args[section]["psfnet_path"] = PSFNET_CKPT
    pretrained = str(tmp_path / "depth_net_init.msgpack")
    flax_msgpack.save(pretrained, dict(flax_msgpack.load(AIF_CKPT),
                                       step=np.asarray(0, np.int32)))
    args["train"]["dffnet_pretrained"] = pretrained
    args.update(res=list(TRAIN_RES), n_stack=4, epochs=1,
                SynthMiddlebury_train=_write_scenes(str(tmp_path / "train"),
                                                    TRAIN_SCENES, 0),
                SynthMiddlebury_val=_write_scenes(str(tmp_path / "val"),
                                                  VAL_SCENES, 1))
    return args


class _Recorder:
    """Patches train/dff_aif.py with `patch(module, name, value)` for a run:
    datasets without augmentation (one item's depth NaN where `nan_item` is
    given), and records the losses of each step, the validation scores and
    the checkpoints saved (each an empty file: a train state is ~200 MB,
    and `save_checkpoint` is tested in tests/test_torch_train_loop.py)."""

    def __init__(self, patch=setattr, nan_item=None):
        from aadff_tpu_torch.dff.dataset import Middlebury  # noqa: PLC0415
        from aadff_tpu_torch.train import dff_aif  # noqa: PLC0415

        self.losses, self.scores, self.saved = [], [], []
        step, validate = dff_aif.make_aif_train_step, dff_aif.validate

        class Items(Middlebury):
            def __getitem__(self, i):
                aif, depth = super().__getitem__(i)
                if i == nan_item:
                    depth[0, 3, 4] = np.nan
                return aif, depth

        def datasets(args):
            return (Items(args["SynthMiddlebury_train"], resize=args["res"]),
                    Middlebury(args["SynthMiddlebury_val"], resize=args["res"]))

        def recording_step(*a, **k):
            inner = step(*a, **k)

            def run(*b):
                out = inner(*b)
                self.losses.append({k: float(v) for k, v in out.items()})
                return out
            return run

        def recording_validate(*a, **k):
            scores = validate(*a, **k)
            self.scores.append(scores)
            return scores

        patch(dff_aif, "get_dataset", datasets)
        patch(dff_aif, "make_aif_train_step", recording_step)
        patch(dff_aif, "validate", recording_validate)
        def save(directory, state, name):
            self.saved.append(name)
            open(os.path.join(directory, f"depth_net_{name}.pt"), "w").close()

        patch(dff_aif, "save_checkpoint", save)


def _train_worker(args, nan_item=None):
    """train/dff_aif.py:train on this rank: the recorder's records, the
    parameters, and the refusal of a batch smaller than the world."""
    from aadff_tpu_torch.train import dff_aif  # noqa: PLC0415

    rec = _Recorder(nan_item=nan_item)
    state = dff_aif.train(dict(args), device="cpu")
    try:
        dff_aif.train(dict(args, bs=1), device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"losses": rec.losses, "scores": rec.scores, "saved": rec.saved,
            "step": int(state.step), "refused": refused,
            "params": _digest(state.model)}


def test_train_on_two_ranks_matches_one_process(tmp_path, train_args, monkeypatch):
    """`train/dff_aif.py:train` for one epoch (two passes of 2 steps around
    one validation) on 2 ranks against one process on the same PNG scenes
    (datasets without augmentation), from the trained weights: the step-1
    loss within rtol 1e-5, the losses of every step within 1e-3, the
    continuous validation metrics within 1e-3 and acc1-3 within 2e-3 (as
    tests/test_torch_entry.py holds the entry twins: a pixel of a scene's
    ~2,000 crossing a 1.25^k threshold moves acc by 5e-4; measured 7.8e-4
    on acc1, 1.5e-4 on the others); the ranks end bit-identical; only rank
    0 validates and saves, each checkpoint once; a batch of 1 over 2 ranks
    is refused."""
    from aadff_tpu_torch.train import dff_aif  # noqa: PLC0415

    rec = _Recorder(monkeypatch.setattr)
    state = dff_aif.train(dict(train_args, results_dir=str(tmp_path / "one")),
                          device="cpu")
    run_args = dict(train_args, results_dir=str(tmp_path / "ranks"))
    ranks = run_ranks(tmp_path, _train_worker, run_args)
    ref = [x["total"] for x in rec.losses]
    assert len(ref) == 4 and int(state.step) == 4
    for r, out in enumerate(ranks):
        ours = [x["total"] for x in out["losses"]]
        print(f"measured: rank {r} losses {ours}, one process {ref}")
        np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(ours, ref, rtol=1e-3)
        assert out["step"] == 4
        assert out["refused"] is not None and "cannot split" in out["refused"]
    assert ranks[1]["scores"] == [] and ranks[1]["saved"] == []
    assert sorted(ranks[0]["saved"]) == sorted(rec.saved)
    assert sorted(os.listdir(tmp_path / "ranks")) == sorted(os.listdir(tmp_path / "one"))
    rel = {k: abs(ranks[0]["scores"][0][k] - v) / abs(v)
           for k, v in rec.scores[0].items() if k != "avg_time"}
    print("measured: metrics' relative deviation", rel)
    for k, r in rel.items():
        assert r <= (2e-3 if k.startswith("acc") else 1e-3), (k, r)
    assert ranks[0]["params"] == ranks[1]["params"]


def test_nan_depth_in_one_ranks_rows_skips_the_batch_in_the_loop(tmp_path, train_args):
    """The loop's NaN-depth skip is decided on the global batch: an item
    with a NaN depth skips its batch on both ranks in each pass, whichever
    rank holds it, so both take the same 2 of 4 steps and end
    bit-identical, with no hang."""
    order = np.arange(TRAIN_SCENES)
    np.random.default_rng(0).shuffle(order)  # NumpyLoader's first pass
    nan_item = int(order[1])  # rank 1's row of the first global batch
    args = dict(train_args, results_dir=str(tmp_path / "ranks"))
    ranks = run_ranks(tmp_path, _train_worker, args, nan_item)
    for out in ranks:
        assert out["step"] == 2 and len(out["losses"]) == 2
        assert all(x["skipped_nonfinite"] == 0.0 for x in out["losses"])
    assert ranks[0]["params"] == ranks[1]["params"]


# ---- (f) the dry-run twin ---------------------------------------------------
def _dryrun_worker(psfnet, aif_init, dfv_init):
    from aadff_tpu_torch.scripts.dryrun_multichip import dryrun_multichip  # noqa: PLC0415

    out = dryrun_multichip("cpu", psfnet, torch.load(aif_init), torch.load(dfv_init))
    return {"loss": out["loss"], "dfv_loss": out["dfv_loss"],
            "stack": out["stack"]}


def test_dryrun_twin_on_two_ranks_matches_jax(tmp_path, jax_mesh_steps):
    """`scripts/dryrun_multichip.py` at N = 2 against JAX's same two steps
    (`__graft_entry__.py:dryrun_multichip`) on a 2-device mesh, from the
    same Flax inits (PSFNet seed 0, AiFDepthNet PRNGKey(0), DFVNet
    PRNGKey(1)) on the same inputs: each rank renders its own row, and the
    printed losses agree within rtol 1e-4."""
    from aadff_tpu.psfnet import PSFNet as JaxPSFNet  # noqa: PLC0415
    from aadff_tpu.train.trainer import render_focal_stack  # noqa: PLC0415
    from aadff_tpu_torch.models.convert import aifnet_state_from_flax  # noqa: PLC0415
    from aadff_tpu_torch.models.dfv.convert import dfvnet_state_from_flax  # noqa: PLC0415
    from aadff_tpu_torch.scripts.dryrun_multichip import inputs  # noqa: PLC0415

    run, init = jax_mesh_steps
    lens = JaxPSFNet(filename=LENS, sensor_res=(H, W), kernel_size=11)
    psfnet = str(tmp_path / "psfnet.msgpack")
    lens.save_net(psfnet)
    aif, depth, fds = inputs(2)
    stack = np.asarray(render_focal_stack(lens, aif, depth, fds))
    variables = {f: init(f, seed) for f, seed in (("aif", 0), ("dfv", 1))}
    jl = {f: run(f, variables[f], [(stack, fds, depth, aif)])[0][0]["total"]
          for f in variables}
    paths = {}
    for f, convert in (("aif", aifnet_state_from_flax),
                       ("dfv", dfvnet_state_from_flax)):
        paths[f] = str(tmp_path / f"{f}_init.pt")
        torch.save(convert(variables[f]), paths[f])
    ranks = run_ranks(tmp_path, _dryrun_worker, psfnet, paths["aif"], paths["dfv"])
    for r, out in enumerate(ranks):
        print(f"measured: dryrun_multichip(2) rank {r}: loss={out['loss']} "
              f"dfv_loss={out['dfv_loss']}; JAX {jl}")
        np.testing.assert_allclose(out["stack"].numpy(), stack[r:r + 1], atol=2e-4)
        np.testing.assert_allclose(out["loss"], jl["aif"], rtol=1e-4)
        np.testing.assert_allclose(out["dfv_loss"], jl["dfv"], rtol=1e-4)


def test_dryrun_twin_under_the_launcher(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    aadff_tpu_torch.scripts.dryrun_multichip --device cpu` (gloo) prints
    its line; NCCL without CUDA is refused."""
    import subprocess  # noqa: PLC0415
    import sys  # noqa: PLC0415

    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "aadff_tpu_torch.scripts.dryrun_multichip",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=JOIN_DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip(2): ok, loss=" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m",
             "aadff_tpu_torch.scripts.dryrun_multichip", "--backend", "nccl"],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=JOIN_DEADLINE_S)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


# ---- the build lock -----------------------------------------------------------
def _build_worker(library, go):
    """Build the host library into `library`'s directory once `go` exists."""
    from pathlib import Path  # noqa: PLC0415

    from aadff_tpu_torch.utils import _host_build  # noqa: PLC0415

    _host_build.LIBRARY = Path(library)
    while not os.path.exists(go):
        time.sleep(0.01)
    return _host_build.build()["built"]


def test_concurrent_builds_run_the_compiler_once(tmp_path):
    """Two processes build the host library into an empty directory at
    once: the compiler (a wrapper that logs each run and waits a second)
    runs once, one process reports it built, the other waited for the lock
    and found the stamp current."""
    import shutil  # noqa: PLC0415
    import stat  # noqa: PLC0415

    from aadff_tpu_torch.utils import _host_build  # noqa: PLC0415

    real = _host_build.compiler()
    log = tmp_path / "compiler_runs.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\necho run >> {log}\nsleep 1\nexec {real} \"$@\"\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    library = tmp_path / "build" / "libaadff_host.so"
    go = tmp_path / "go"
    ctx = mp.get_context("spawn")
    env_cxx = os.environ.get("CXX")
    os.environ["CXX"] = str(cxx)
    try:
        with ctx.Pool(2) as pool:
            pending = pool.starmap_async(_build_worker, [(str(library), str(go))] * 2)
            time.sleep(1.0)
            go.touch()
            built = pending.get(timeout=JOIN_DEADLINE_S)
    finally:
        if env_cxx is None:
            del os.environ["CXX"]
        else:
            os.environ["CXX"] = env_cxx
    assert sorted(built) == [False, True]
    assert log.read_text().splitlines() == ["run"]
    assert library.exists() and library.with_suffix(".so.stamp").exists()
    assert shutil.which(real)
