"""The port's AiF trainer against the JAX trainer, on the CPU: the optimizer,
the train step, the non-finite guard, the eval step, checkpoints, and the
slice as a whole (render -> train steps).

Loss trajectories agree within rtol 1e-3: each Adam step moves every weight
by about the learning rate whatever the size of its gradient, so the f32
noise of two convolution libraries grows a little from step to step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.models.aifnet import AiFDepthNet as JaxAiFDepthNet
from aadff_tpu.psfnet import PSFNet as JaxPSFNet
from aadff_tpu.train import trainer as jax_trainer
from aadff_tpu_torch.models.aifnet import AiFDepthNet
from aadff_tpu_torch.models.convert import aifnet_state_from_flax, load_flax_aifnet
from aadff_tpu_torch.psfnet.psfnet import PSFNet
from aadff_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIF_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "aifnet",
                        "depth_net_best.msgpack")
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
LR, DECAY_STEPS = 1e-4, 5
B, S, H, W = 1, 4, 64, 128


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it, and a CPU train step then runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    """The checkpoint as a JAX TrainState factory and one jitted train step
    (D_FS), shared by the trajectory and whole-slice tests; with
    (lr, decay steps), a factory and step of that schedule."""
    with open(AIF_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    model = JaxAiFDepthNet(n_stack=S)

    def side(lr=LR, decay_steps=DECAY_STEPS):
        optimizer = optax.adam(optax.cosine_decay_schedule(lr, decay_steps,
                                                           alpha=0.0))

        def fresh_state():
            params = jax.tree.map(jnp.asarray, v["params"])
            return jax_trainer.TrainState(
                params=params,
                batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))

        return fresh_state, jax_trainer.make_aif_train_step(model, optimizer, "D_FS")

    return side


def _torch_state(lr=LR, decay_steps=DECAY_STEPS):
    net = AiFDepthNet()
    net.load_state_dict(load_flax_aifnet(AIF_CKPT)[0])
    return trainer.create_train_state(net, lr, decay_steps)


def _torch_stats_of(jstate):
    """The BatchNorm statistics of a JAX train state as the port names them."""
    sd = aifnet_state_from_flax({"params": jax.tree.map(np.asarray, jstate.params),
                                 "batch_stats": jax.tree.map(np.asarray,
                                                             jstate.batch_stats)})
    return {k: v for k, v in sd.items() if "running" in k}


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        stack = rng.uniform(0, 1, (B, S, H, W, 3)).astype(np.float32)
        fds = np.sort(rng.uniform(0.5, 3.0, (B, S))).astype(np.float32)
        depth = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
        depth[..., :4] = 0.0
        aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
        out.append((stack, fds, depth, aif))
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(LR, DECAY_STEPS, alpha=0.0)
    opt = trainer.Adam([torch.zeros(1)], LR, DECAY_STEPS)
    for count in range(DECAY_STEPS + 3):
        ours = opt.learning_rate(torch.tensor(count, dtype=torch.int32))
        np.testing.assert_allclose(float(ours), float(sched(count)), rtol=1e-6)


def test_adam_matches_optax():
    """Four updates of random tensors, one of them skipped by the guard."""
    rng = np.random.default_rng(0)
    params = [rng.normal(size=(3, 4)).astype(np.float32),
              rng.normal(size=(5,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(4)]
    optimizer = optax.adam(optax.cosine_decay_schedule(LR, DECAY_STEPS, 0.0))
    jp = [jnp.asarray(p) for p in params]
    state = optimizer.init(jp)
    ours = [torch.from_numpy(p.copy()) for p in params]
    opt = trainer.Adam(ours, LR, DECAY_STEPS)
    for i, g in enumerate(grads):
        ok = i != 2
        if ok:
            updates, state = optimizer.update([jnp.asarray(x) for x in g], state, jp)
            jp = optax.apply_updates(jp, updates)
        opt.step(_t(*g), torch.tensor(ok))
    for a, b in zip(ours, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    assert int(opt.count) == 3


# (steps, lr, cosine decay steps, the step whose batch is NaN, loss rtol):
# three steps as PR 4 held them, and the ten of
# tests/test_trajectory_equivalence.py:33 (lr 1e-3, the schedule over the
# 10 steps, the guard skipping step 4) on one device in both packages,
# held at three times the largest deviation measured (2.1e-4 at step 10).
TRAJECTORIES = {"3": (3, LR, DECAY_STEPS, None, 1e-3),
                "10": (10, 1e-3, 10, 4, 3.5e-3)}


def _stats_deviation(state, jstate):
    """The largest deviation of a BatchNorm statistic between the port's and
    JAX's states, over its tensor's largest value."""
    ref = _torch_stats_of(jstate)
    return max(float(np.abs(v.numpy() - ref[k].numpy()).max()
                     / max(np.abs(ref[k].numpy()).max(), 1e-6))
               for k, v in state.model.state_dict().items() if "running" in k)


def _movement(state, jstate, start):
    """(cosine, divergence / movement) of the two packages' parameter
    movements from `start`, the statistic of
    tests/test_trajectory_equivalence.py:125-140."""
    ref = aifnet_state_from_flax({"params": jax.tree.map(np.asarray, jstate.params),
                                  "batch_stats": jax.tree.map(np.asarray,
                                                              jstate.batch_stats)})
    names = [n for n, _ in state.model.named_parameters()]
    ours = np.concatenate([(state.model.state_dict()[n] - start[n]).numpy().ravel()
                           for n in names])
    theirs = np.concatenate([(ref[n] - start[n]).numpy().ravel() for n in names])
    cos = ours @ theirs / (np.linalg.norm(ours) * np.linalg.norm(theirs))
    return float(cos), float(np.linalg.norm(ours - theirs) / np.linalg.norm(theirs))


@pytest.mark.parametrize("case", sorted(TRAJECTORIES), ids=lambda c: f"{c}steps")
def test_train_trajectory_matches_jax(jax_side, case):
    """Steps from the same converted init on identical pre-rendered
    batches: the loss trajectory agrees within the case's rtol, a NaN
    batch is skipped by both guards, Adam's counts advance with the trained
    steps only, the BatchNorm statistics after the first step agree within
    1e-4 of each tensor's largest value (later, the weights' f32 noise
    moves them apart), and the parameter movements point the same way."""
    n_steps, lr, decay, nan_at, rtol = TRAJECTORIES[case]
    fresh_state, jax_step = jax_side(lr, decay)
    jstate = fresh_state()
    state = _torch_state(lr, decay)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = trainer.make_aif_train_step("D_FS")
    jl, tl, skipped = [], [], []
    for i, (stack, fds, depth, aif) in enumerate(_batches(n_steps, seed=1)):
        if i == nan_at:
            stack = np.full_like(stack, np.nan)
        jstate, jloss = jax_step(jstate, stack, fds, depth, aif)
        losses = step(state, *_t(stack, fds, depth, aif))
        jl.append(float(jloss["total"]))
        tl.append(float(losses["total"]))
        skipped.append((float(losses["skipped_nonfinite"]),
                        float(jloss["skipped_nonfinite"])))
        if i == 0:
            assert _stats_deviation(state, jstate) <= 1e-4
    rel = [abs(a - b) / abs(b) for a, b in zip(tl, jl) if b]
    cos, divergence = _movement(state, jstate, start)
    print(f"measured: AiF {n_steps}-step loss rel max {max(rel):.3g}",
          np.array2string(np.array(rel), precision=2, max_line_width=300),
          f"movement cosine {cos:.4f}, divergence / movement {divergence:.3g}")
    assert skipped == [(float(i == nan_at),) * 2 for i in range(n_steps)]
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    trained = n_steps - (nan_at is not None)
    assert int(state.step) == n_steps and int(state.opt.count) == trained
    assert int(state.opt.schedule_count) == int(jstate.opt_state[1].count) == trained
    assert cos > 0.75 and divergence < 0.6


def test_nan_batch_leaves_state_unchanged():
    """A NaN batch keeps params, Adam moments and count and BN statistics,
    zeroes the losses and reports skipped_nonfinite == 1."""
    state = _torch_state()
    step = trainer.make_aif_train_step("DA_FS", aif_w=1.0)
    stack, fds, depth, aif = _batches(1, seed=2)[0]
    step(state, *_t(stack, fds, depth, aif))  # warm moments, count 1
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = [m.clone() for m in state.opt.mu + state.opt.nu]
    aif_bad = np.full_like(aif, np.nan)
    losses = step(state, *_t(stack, fds, depth, aif_bad))
    assert float(losses["skipped_nonfinite"]) == 1.0
    assert all(float(v) == 0.0 for k, v in losses.items()
               if k != "skipped_nonfinite")
    after = state.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(a, b) for a, b in
               zip(moments, state.opt.mu + state.opt.nu))
    assert int(state.opt.count) == 1 and int(state.step) == 2


def test_eval_step_uses_running_statistics():
    state = _torch_state()
    stack, fds, _, _ = _batches(1, seed=3)[0]
    before = [b.clone() for b in state.model.buffers()]
    out = trainer.make_aif_eval_step()(state, *_t(stack, fds))
    assert out["pred_depth"].shape == (B, 1, H, W)
    assert out["pred_AiF_img"].shape == (B, 3, H, W)
    assert all(torch.equal(a, b) for a, b in zip(before, state.model.buffers()))
    # softmax attention over the stack: depth lies inside the focus range
    assert float(out["pred_depth"].min()) >= fds.min() - 1e-6
    assert float(out["pred_depth"].max()) <= fds.max() + 1e-6


def test_checkpoint_round_trip(tmp_path):
    state = _torch_state()
    step = trainer.make_aif_train_step("D_FS")
    stack, fds, depth, aif = _batches(1, seed=4)[0]
    step(state, *_t(stack, fds, depth, aif))
    trainer.save_checkpoint(str(tmp_path), state, "state")
    assert sorted(os.listdir(tmp_path)) == ["depth_net_state.pt"]
    restored = trainer.load_checkpoint(str(tmp_path), _torch_state(), "state")
    a, b = state.model.state_dict(), restored.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in
               zip(state.opt.mu + state.opt.nu, restored.opt.mu + restored.opt.nu))
    assert int(restored.opt.count) == 1 and int(restored.step) == 1


def test_slice_render_then_train_matches_jax(jax_side):
    """The slice as a whole: render_focal_stack through PSFNet (the port's
    plain render here, JAX's XLA path) then 2 train steps, B=1, S=4,
    64x128.  Stacks agree within 5e-6, losses within rtol 1e-3."""
    fresh_state, jax_step = jax_side()
    lens = JaxPSFNet(LENS, kernel_size=11, sensor_res=(H, W))
    lens.load_net(PSFNET_CKPT)
    net = PSFNet(kernel_size=11, sensor_res=(H, W), device="cpu")
    net.load_net(PSFNET_CKPT)

    jstate, state = fresh_state(), _torch_state()
    step = trainer.make_aif_train_step("D_FS")
    rng = np.random.default_rng(6)
    for _ in range(2):
        aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
        depth = rng.uniform(0.5, 10.0, (B, 1, H, W)).astype(np.float32)
        fds = np.sort(rng.uniform(0.5, 10.0, (B, S))).astype(np.float32)
        jstack = np.asarray(jax_trainer.render_focal_stack(lens, aif, depth, fds))
        stack = trainer.render_focal_stack(net, *_t(aif, depth, fds))
        assert stack.shape == (B, S, H, W, 3)
        np.testing.assert_allclose(stack.numpy(), jstack, atol=5e-6)
        jstate, jloss = jax_step(jstate, jstack, fds, depth, aif)
        losses = step(state, stack, *_t(fds, depth, aif))
        np.testing.assert_allclose(float(losses["total"]),
                                   float(jloss["total"]), rtol=1e-3)
