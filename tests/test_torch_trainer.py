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
from aadff_tpu_torch.models.convert import load_flax_aifnet
from aadff_tpu_torch.psfnet.psfnet import PSFNet
from aadff_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIF_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "aifnet",
                        "depth_net_best.msgpack")
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
LR, DECAY_STEPS = 1e-4, 5
B, S, H, W = 1, 4, 64, 128


@pytest.fixture(scope="module")
def jax_side():
    """The checkpoint as a JAX TrainState factory and one jitted train step
    (D_FS), shared by the trajectory and whole-slice tests."""
    with open(AIF_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    model = JaxAiFDepthNet(n_stack=S)
    optimizer = optax.adam(optax.cosine_decay_schedule(LR, DECAY_STEPS,
                                                       alpha=0.0))

    def fresh_state():
        params = jax.tree.map(jnp.asarray, v["params"])
        return jax_trainer.TrainState(
            params=params, batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
            opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))

    step = jax_trainer.make_aif_train_step(model, optimizer, "D_FS")
    return fresh_state, step


def _torch_state():
    net = AiFDepthNet()
    net.load_state_dict(load_flax_aifnet(AIF_CKPT)[0])
    return trainer.create_train_state(net, LR, DECAY_STEPS)


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


def test_train_trajectory_matches_jax(jax_side):
    """Three steps from the same converted init on identical pre-rendered
    batches: the loss trajectory agrees within rtol 1e-3."""
    fresh_state, jax_step = jax_side
    jstate = fresh_state()
    state = _torch_state()
    step = trainer.make_aif_train_step("D_FS")
    jl, tl = [], []
    for stack, fds, depth, aif in _batches(3, seed=1):
        jstate, jloss = jax_step(jstate, stack, fds, depth, aif)
        losses = step(state, *_t(stack, fds, depth, aif))
        jl.append(float(jloss["total"]))
        tl.append(float(losses["total"]))
        assert float(losses["skipped_nonfinite"]) == 0.0
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert int(state.step) == 3 and int(state.opt.count) == 3


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
    fresh_state, jax_step = jax_side
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
