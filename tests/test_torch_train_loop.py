"""The port's training loop pieces against the JAX package: Adam's two
counts, resume from the JAX package's full and stripped train states (held
tensor for tensor against JAX's `load_checkpoint`), the first updates after
a stripped resume, `.pt` checkpoints from before the counts were split, K
train steps per call, the step-indexed `CheckpointManager`
(tests/test_checkpointing.py:22,135), and `train/dff_aif.py:train` with
its `dffnet_pretrained` loader (on tests/test_torch_entry.py's scenes).

Tolerances: checkpoint loads are exact (the same float32 values, only
transposed).  The first three updates after a stripped resume agree with
optax within rtol 1e-6 (Adam's arithmetic in another order; atol 1e-9 for
parameters within a few float32 steps of 0).  K steps per call are the
same operations as K single calls in the same order, so they agree bit for
bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.train import trainer as jax_trainer
from aadff_tpu_torch.models.aifnet import AiFDepthNet
from aadff_tpu_torch.models.convert import aifnet_state_from_flax
from aadff_tpu_torch.models.dfv.convert import dfvnet_state_from_flax
from aadff_tpu_torch.models.dfv.dffnet import DFVNet
from aadff_tpu_torch.psfnet.psfnet import PSFNet
from aadff_tpu_torch.train import trainer
from test_torch_entry import _jax_state_msgpack, config  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "ckpt", "dff_synth")
AIF_DIR = os.path.join(CKPT, "aifnet")            # depth_net_best, stripped
DFV_DIR = os.path.join(CKPT, "dfvnet")            # depth_net_best, stripped
DFV_PARTIAL = os.path.join(CKPT, "dfv_thin_partial")  # depth_net_state, step 448
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
LR, DECAY = 1e-4, 2000


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it, and a CPU train step then runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

FAMILIES = {
    "aif": (lambda: AiFDepthNet(), aifnet_state_from_flax, AIF_DIR),
    "dfv": (lambda: DFVNet(clean=False, level=2, use_diff=1),
            dfvnet_state_from_flax, DFV_DIR),
}


def _optimizer():
    return optax.adam(optax.cosine_decay_schedule(LR, DECAY, alpha=0.0))


def _flax_variables(path):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _jax_fresh_state(variables):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jax_trainer.TrainState(
        params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=_optimizer().init(params), step=jnp.zeros((), jnp.int32))


def _port_state(family):
    make, _, _ = FAMILIES[family]
    return trainer.create_train_state(make(), LR, DECAY)


def _port_tree(state, convert, tree, batch_stats):
    """A JAX params-shaped tree in the order of the port's parameters."""
    sd = convert({"params": jax.tree.map(np.asarray, tree),
                  "batch_stats": jax.tree.map(np.asarray, batch_stats)})
    return [sd[n] for n, _ in state.model.named_parameters()]


def _assert_state_equals_jax(state, jstate, convert):
    """Parameters, statistics, moments, both counts and the step, tensor for
    tensor."""
    sd = convert({"params": jax.tree.map(np.asarray, jstate.params),
                  "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    ours = state.model.state_dict()
    assert set(ours) == set(sd)
    for k in sd:
        assert torch.equal(ours[k], sd[k]), k
    adam, sched = jstate.opt_state
    for mine, theirs in ((state.opt.mu, adam.mu), (state.opt.nu, adam.nu)):
        ref = _port_tree(state, convert, theirs, jstate.batch_stats)
        assert all(torch.equal(a, b) for a, b in zip(mine, ref))
    assert int(state.opt.count) == int(adam.count)
    assert int(state.opt.schedule_count) == int(sched.count)
    assert int(state.step) == int(jstate.step)


def test_adam_keeps_two_counts():
    p = [torch.zeros(3)]
    opt = trainer.Adam(p, LR, 10)
    assert set(opt.tensors()) == {"mu", "nu", "count", "schedule_count"}
    for ok in (True, False, True):
        opt.step([torch.ones(3)], torch.tensor(ok))
    assert int(opt.count) == int(opt.schedule_count) == 2
    opt.count.fill_(0)  # as after a stripped resume: Adam cold, schedule at 2
    opt.step([torch.ones(3)], torch.tensor(True))
    assert int(opt.count) == 1 and int(opt.schedule_count) == 3


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_full_jax_state_loads_tensor_for_tensor(tmp_path, family):
    """A full train state written by JAX's save_checkpoint, with moments and
    counts that differ, against JAX's load_checkpoint."""
    _, convert, src = FAMILIES[family]
    variables = _flax_variables(os.path.join(src, "depth_net_best.msgpack"))
    jstate = _jax_fresh_state(variables)
    rng = np.random.default_rng(0)

    def noise(tree, scale):
        return jax.tree.map(lambda a: jnp.asarray(
            rng.normal(0, scale, a.shape).astype(np.float32)), tree)

    adam, sched = jstate.opt_state
    saved = jstate.replace(
        opt_state=(adam._replace(count=jnp.asarray(7), mu=noise(adam.mu, 1e-3),
                                 nu=noise(adam.nu, 1e-6)),
                   sched._replace(count=jnp.asarray(9))),
        step=jnp.asarray(9, jnp.int32))
    jax_trainer.save_checkpoint(str(tmp_path), saved, "state")
    jrestored = jax_trainer.load_checkpoint(str(tmp_path), jstate, "state")
    state = trainer.load_checkpoint(str(tmp_path), _port_state(family), "state")
    _assert_state_equals_jax(state, jrestored, convert)
    assert int(state.opt.count) == 7 and int(state.opt.schedule_count) == 9


def test_stripped_dfv_state_loads_as_jax_does():
    """The committed DFV level-2 train state (stripped, step 448): schedule
    count re-seeded to the step, Adam cold (tests/test_checkpointing.py:89)."""
    variables = _flax_variables(os.path.join(DFV_PARTIAL, "depth_net_state.msgpack"))
    assert "opt_state" not in variables
    jrestored = jax_trainer.load_checkpoint(DFV_PARTIAL, _jax_fresh_state(variables),
                                            "state")
    state = trainer.load_checkpoint(DFV_PARTIAL, _port_state("dfv"), "state")
    _assert_state_equals_jax(state, jrestored, dfvnet_state_from_flax)
    assert int(state.step) == 448 and int(state.opt.schedule_count) == 448
    assert int(state.opt.count) == 0
    assert all(float(m.abs().max()) == 0.0 for m in state.opt.mu + state.opt.nu)


def test_stripped_resume_first_updates_match_jax():
    """The committed AiF checkpoint (stripped, step 1064) resumed in both
    packages, then three Adam updates with the same gradients: the schedule
    continues at 1064 while Adam's bias correction starts cold."""
    variables = _flax_variables(os.path.join(AIF_DIR, "depth_net_best.msgpack"))
    optimizer = _optimizer()
    jstate = jax_trainer.load_checkpoint(AIF_DIR, _jax_fresh_state(variables), "best")
    state = trainer.load_checkpoint(AIF_DIR, _port_state("aif"), "best")
    assert int(state.opt.schedule_count) == int(jstate.opt_state[1].count) == 1064
    assert int(state.opt.count) == int(jstate.opt_state[0].count) == 0
    rng = np.random.default_rng(1)
    params, opt_state = jstate.params, jstate.opt_state

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for i in range(3):
        grads = jax.tree.map(lambda a: jnp.asarray(
            rng.normal(0, 1e-2, a.shape).astype(np.float32)), params)
        params, opt_state = update(grads, opt_state, params)
        state.opt.step(_port_tree(state, aifnet_state_from_flax, grads,
                                  jstate.batch_stats), torch.tensor(True))
        ref = _port_tree(state, aifnet_state_from_flax, params, jstate.batch_stats)
        for p, r in zip(state.opt.params, ref):
            np.testing.assert_allclose(p.detach().numpy(), r.numpy(),
                                       rtol=1e-6, atol=1e-9)
    assert int(state.opt.count) == 3 and int(state.opt.schedule_count) == 1067


def test_pt_checkpoint_with_one_count_sets_both(tmp_path):
    """A .pt written before the counts were split holds one `count`."""
    net = AiFDepthNet()
    state = trainer.create_train_state(net, LR, 10)
    state.opt.count.fill_(5)
    state.opt.schedule_count.fill_(5)
    trainer.save_checkpoint(str(tmp_path), state, "state")
    path = tmp_path / "depth_net_state.pt"
    sd = torch.load(path, weights_only=True)
    del sd["schedule_count"]
    torch.save(sd, path)
    fresh = trainer.create_train_state(AiFDepthNet(), LR, 10)
    restored = trainer.load_checkpoint(str(tmp_path), fresh, "state")
    assert int(restored.opt.count) == int(restored.opt.schedule_count) == 5


def test_k_steps_per_call_equal_k_single_steps():
    """7 batches, K = 3 (two calls and a tail of one single step), a NaN
    batch inside a call: the same per-step losses, skips and final state
    as 7 single steps, bit for bit (as tests/test_trainer_multistep.py:89
    holds JAX)."""
    B, S, H, W = 2, 4, 32, 64
    lens = PSFNet(kernel_size=11, sensor_res=(H, W), device="cpu")
    lens.load_net(PSFNET_CKPT)
    rng = np.random.default_rng(41)
    batches = []
    for i in range(7):
        aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
        depth = rng.uniform(0.6, 2.9, (B, 1, H, W)).astype(np.float32)
        if i == 4:
            aif[:] = np.nan  # the guard skips it inside a call too
        fds = np.broadcast_to(np.linspace(0.5, 3.0, S, dtype=np.float32), (B, S))
        batches.append([torch.from_numpy(np.ascontiguousarray(a))
                        for a in (aif, depth, fds)])

    def fresh():
        torch.manual_seed(3)
        return trainer.create_train_state(AiFDepthNet(), 1e-3, 12)

    single = trainer.make_aif_train_step("D_FS")
    s1, recs1 = fresh(), []
    for aif, depth, fds in batches:
        stack = trainer.render_focal_stack(lens, aif, depth, fds)
        losses = single(s1, stack, fds, depth, aif)
        recs1.append((float(losses["total"]), float(losses["skipped_nonfinite"])))

    multi = trainer.make_aif_train_multi_step("D_FS", lens)
    sk, recsk = fresh(), []
    for g in range(2):
        group = batches[3 * g:3 * g + 3]
        losses = multi(sk, *(torch.stack(x) for x in zip(*group)))
        assert losses["total"].shape == (3,)
        recsk += list(zip(losses["total"].tolist(),
                          losses["skipped_nonfinite"].tolist()))
    aif, depth, fds = batches[6]
    losses = single(sk, trainer.render_focal_stack(lens, aif, depth, fds), fds,
                    depth, aif)
    recsk.append((float(losses["total"]), float(losses["skipped_nonfinite"])))

    assert recs1 == recsk
    assert recs1[4] == (0.0, 1.0) and sum(s for _, s in recsk) == 1.0
    assert int(s1.step) == int(sk.step) == 7
    assert int(sk.opt.count) == int(sk.opt.schedule_count) == 6
    a, b = s1.model.state_dict(), sk.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in
               zip(s1.opt.mu + s1.opt.nu, sk.opt.mu + sk.opt.nu))


def _tiny_state():
    torch.manual_seed(0)
    return trainer.create_train_state(AiFDepthNet(), LR, 10)


def test_checkpoint_manager_save_restore(tmp_path):
    """tests/test_checkpointing.py:22: the latest step by default, or the
    step asked for."""
    state = _tiny_state()
    mgr = trainer.CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    assert mgr.latest_step() is None
    mgr.save(1, state)
    first = next(state.model.parameters()).detach().clone()
    state.step += 5
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    mgr.save(2, state)
    restored = mgr.restore(_tiny_state())
    assert int(restored.step) == 5
    assert torch.equal(next(state.model.parameters()),
                       next(restored.model.parameters()))
    r1 = mgr.restore(_tiny_state(), step=1)
    assert int(r1.step) == 0
    assert torch.equal(first, next(r1.model.parameters()))


def test_checkpoint_manager_retention(tmp_path):
    """tests/test_checkpointing.py:135: max_to_keep newest steps stay."""
    state = _tiny_state()
    mgr = trainer.CheckpointManager(str(tmp_path / "ck2"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "ck2")) == ["2", "3"]


def test_dff_aif_train_runs_its_epochs_and_loads_pretrained(tmp_path, config):
    """`train/dff_aif.py:train` on the CPU with epochs: 1 (two training
    passes around one validation, as the JAX loop runs), then
    `dffnet_pretrained` as a JAX msgpack and as a port .pt."""
    from aadff_tpu_torch.train import dff_aif
    from aadff_tpu_torch.utils.config import load_config

    args = load_config(config)
    args["epochs"] = 1
    args["results_dir"] = str(tmp_path / "run")
    state = dff_aif.train(args, device="cpu")
    assert int(state.step) == 4
    for name in ("last", "best", "best_acc1"):
        assert (tmp_path / "run" / f"depth_net_{name}.pt").exists()
    _jax_state_msgpack(tmp_path / "jax")
    for path in (str(tmp_path / "jax" / "depth_net_state.msgpack"),
                 str(tmp_path / "run" / "depth_net_last.pt")):
        fresh = trainer.create_train_state(type(state.model)(), 1e-4, 4)
        loaded = dff_aif.load_pretrained(path, fresh)
        ref = trainer.create_train_state(type(state.model)(), 1e-4, 4)
        if path.endswith(".msgpack"):
            ref = trainer.load_flax_checkpoint(path, ref)
        else:
            ref = trainer.load_checkpoint(str(tmp_path / "run"), ref, "last")
        a, b = loaded.model.state_dict(), ref.model.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert int(loaded.step) == int(ref.step) > 0
