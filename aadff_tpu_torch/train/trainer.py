"""DFF training engine (the port of `aadff_tpu/train/trainer.py`):
`render_focal_stack` :170-189, the AiF train step `_aif_step_body` :68-112
with its non-finite guard `guard_nonfinite` :57-65 (`guarded_step`, which
the DFV step of `train/dff_dfv.py` shares), K steps per call
`make_aif_train_multi_step` :123-156 (`make_multi_step`, shared with the
DFV step), `make_aif_eval_step` :159-167,
`validate` :195-268, the checkpoints :274-330 (which also read the JAX
package's msgpack train states) and `OrbaxManager` :333 as
`CheckpointManager`.

JAX's train state is immutable; here `TrainState` holds the model and the
optimizer state, and a train step updates them in place.  The optimizer is
optax's `adam(cosine_decay_schedule(lr, decay_steps, alpha=0))` written out
over tensors, so that the guard is a `torch.where` on every tensor of the
state and never waits for the host.
"""
from __future__ import annotations

import logging
import math
import os
import shutil
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..dff import metrics as M
from ..dff.focus import select_focus_dist
from ..models.aifnet import AiFDepthNet, compute_loss
from ..models.convert import aifnet_state_from_flax
from ..models.dfv.convert import dfvnet_state_from_flax
from ..models.dfv.dffnet import DFVNet
from ..parallel import mesh
from ..utils import flax_msgpack
from ..utils.image import imwrite_colormap, write_png


class StepTimer:
    """Times each train call (render included) without waiting for the
    device: CUDA events on a GPU, the host clock on the CPU (where every op
    has finished when it returns).  `timed(loader)` also records the host
    ms the loop waits for each batch (`waits`)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.calls = []
        self.waits = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, start, steps: int):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.calls.append((start, end, steps))
        else:
            self.calls.append(((time.perf_counter() - start) * 1e3, steps))

    def step_ms(self) -> list[float]:
        """ms of each step since the last call, a K-step call's time split
        evenly over its K steps."""
        if self.cuda:
            torch.cuda.synchronize()
            calls = [(s.elapsed_time(e), k) for s, e, k in self.calls]
        else:
            calls = self.calls
        self.calls = []
        return [ms / k for ms, k in calls for _ in range(k)]

    def timed(self, batches):
        """Yield the batches of `batches`, appending to `waits` the host ms
        spent waiting for each."""
        it = iter(batches)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(1e3 * (time.perf_counter() - t))
            yield batch


class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8) scaled by
    optax.cosine_decay_schedule(lr, decay_steps, alpha=0); moments and counts
    are device tensors.  With `weight_decay` it is optax.adamw: the update
    is -lr * (adam + weight_decay * p) (`add_decayed_weights`); the default
    0 is plain Adam, which the DFF steps use.

    Two counts, as optax keeps them: `count` (ScaleByAdamState.count) for the
    bias correction and `schedule_count` (ScaleByScheduleState.count), at
    which the schedule is evaluated before the update.  They are equal in
    plain training and differ after a resume from a checkpoint stripped of
    its optimizer state (`load_checkpoint`)."""

    def __init__(self, params, lr: float, decay_steps: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        if decay_steps <= 0:
            raise ValueError(f"decay_steps must be positive, got {decay_steps}")
        self.params = list(params)
        self.lr, self.decay_steps = lr, float(decay_steps)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device)
        self.schedule_count = torch.zeros_like(self.count)

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.float(), max=self.decay_steps)
        return self.lr * (0.5 * (1 + torch.cos(math.pi * c / self.decay_steps)))

    @torch.no_grad()
    def step(self, grads, ok: torch.Tensor):
        """One update where `ok` (a 0-d bool tensor); where it is False the
        parameters, moments and counts keep their values."""
        count_inc = self.count + 1
        neg_lr = -self.learning_rate(self.schedule_count)
        bc1 = 1 - self.b1 ** count_inc
        bc2 = 1 - self.b2 ** count_inc
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m_new = (1 - self.b1) * g + self.b1 * m
            v_new = (1 - self.b2) * g ** 2 + self.b2 * v
            update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.copy_(torch.where(ok, p + update * neg_lr, p))
            m.copy_(torch.where(ok, m_new, m))
            v.copy_(torch.where(ok, v_new, v))
        self.count.copy_(torch.where(ok, count_inc, self.count))
        self.schedule_count.copy_(torch.where(ok, self.schedule_count + 1,
                                              self.schedule_count))

    def tensors(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "schedule_count": self.schedule_count}


@dataclass
class TrainState:
    model: nn.Module
    opt: Adam
    step: torch.Tensor


def create_train_state(model: nn.Module, lr: float,
                       decay_steps: int) -> TrainState:
    """The train state of any DFF model (AiFDepthNet, DFVNet): Adam over
    its parameters with the cosine schedule, and a step count of 0."""
    device = next(model.parameters()).device
    return TrainState(model=model, opt=Adam(model.parameters(), lr, decay_steps),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def guarded_step(state: TrainState, loss_fn) -> dict:
    """One train step with the non-finite guard (`guard_nonfinite`, shared
    by the AiF and DFV steps of the JAX package).

    `loss_fn(model)` runs the train-mode forward and returns a dict of 0-d
    losses with the objective under "total".  A batch whose loss or gradient
    norm is not finite leaves the parameters, the Adam moments and count and
    the BatchNorm statistics as they were; its losses read 0 and
    `skipped_nonfinite` 1.

    Under data parallelism (`parallel/mesh.py`) each rank holds its rows of
    the global batch.  The gradients and the losses are averaged over the
    ranks in one all-reduce after `torch.autograd.grad` (which no
    DistributedDataParallel hook would see), so every rank applies the same
    update and reports the global losses; the guard reads the global loss
    and the global gradient norm, so the ranks skip a batch together.
    """
    model = state.model
    model.train()
    stats = list(model.buffers())
    stats_before = [b.clone() for b in stats]
    losses = loss_fn(model)
    # a parameter the loss does not reach (DFVNet's coarsest projections,
    # whose BatchNorm statistics still update) gets a zero gradient, as in JAX
    grads = torch.autograd.grad(losses["total"], state.opt.params,
                                allow_unused=True, materialize_grads=True)
    names = list(losses)
    *grads, values = mesh.mean_over_ranks(
        [*grads, torch.stack([losses[k].detach() for k in names])])
    losses = dict(zip(names, values.unbind()))
    gnorm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    ok = torch.isfinite(losses["total"]) & torch.isfinite(gnorm)
    state.opt.step(grads, ok)
    with torch.no_grad():
        for b, before in zip(stats, stats_before):
            b.copy_(torch.where(ok, b, before))
        state.step += 1
    losses = {k: torch.where(ok, v, 0.0) for k, v in losses.items()}
    losses["skipped_nonfinite"] = (~ok).float()
    return losses


def trunk_dtype(args: dict):
    """The AiFDepthNet trunk dtype that a run's args select:
    `compute_dtype: "bf16"` gives torch.bfloat16, anything else None (f32),
    as `aadff_tpu/train/dff_aif.py:53-57` chooses."""
    return torch.bfloat16 if args.get("compute_dtype") == "bf16" else None


def make_aif_train_step(task: str, disp_w: float = 1.0, aif_w: float = 0.0,
                        smooth_w: float = 0.0, disp_depth: str = "depth"):
    """Returns train_step(state, stack, focus_dists, depth, aif) -> losses,
    guarded as `guarded_step` says.

    stack [B, S, H, W, C]; depth and aif NCHW like the reference; `depth` is
    the target of the model's `pred_<disp_depth>`.  The model may have a
    bf16 trunk (`AiFDepthNet(dtype=torch.bfloat16)`): its parameters,
    Adam's moments, the guard and the loss stay f32.
    """

    def train_step(state: TrainState, stack, focus_dists, depth, aif):
        return guarded_step(state, lambda model: compute_loss(
            model(stack, focus_dists), {disp_depth: depth, "AiF_img": aif},
            task, disp_w=disp_w, aif_w=aif_w, smooth_w=smooth_w,
            disp_depth=disp_depth))

    return train_step


def make_aif_train_multi_step(task: str, lens, disp_w: float = 1.0,
                              aif_w: float = 0.0, smooth_w: float = 0.0):
    """Returns multi_step(state, aif_k, depth_k, focus_k) -> losses: K AiF
    train steps in one call (`make_multi_step`)."""
    return make_multi_step(lens, make_aif_train_step(task, disp_w, aif_w,
                                                     smooth_w))


def make_multi_step(lens, step):
    """Returns multi_step(state, aif_k, depth_k, focus_k) -> losses: K train
    steps in one call, each rendering its focal stack through `lens` and
    then calling step(state, stack, focus, depth, aif) -> losses.

    Takes K batches stacked on a leading axis: aif [K, B, C, H, W], depth
    [K, B, 1, H, W], focus_k [K, B, S].  The guard stays per step (a
    non-finite batch skips only its own update) and every loss comes back
    stacked to [K] on the device: nothing inside the call waits for the
    host, so the caller may queue the next group before reading them.
    """

    def multi_step(state: TrainState, aif_k, depth_k, focus_k):
        per_step = []
        for aif, depth, focus in zip(aif_k, depth_k, focus_k):
            stack = render_focal_stack(lens, aif, depth, focus)
            per_step.append(step(state, stack, focus, depth, aif))
        return {k: torch.stack([losses[k] for losses in per_step])
                for k in per_step[0]}

    return multi_step


def make_aif_eval_step():
    """Returns eval_step(state, stack, focus_dists) -> model outputs, with
    BatchNorm on its running statistics."""

    @torch.no_grad()
    def eval_step(state: TrainState, stack, focus_dists):
        state.model.eval()
        return state.model(stack, focus_dists)

    return eval_step


def render_focal_stack(lens, aif, depth, focus_dists) -> torch.Tensor:
    """Render an aberrated focal stack (reference
    2_aber_aware_dff_aif.py:107-116).

    aif [B, C, H, W]; depth [B, 1, H, W] in m (> 0); focus_dists [B, S] in m.
    Returns [B, S, H, W, C] (channels last, the models' input layout).
    """
    stack = lens.render_stack(aif, depth * -1e3, focus_dists * -1e3)
    return stack.permute(0, 1, 3, 4, 2)


VAL_METRICS = ("abs_rel", "sq_rel", "mse", "mae", "rmse", "rmse_log",
               "acc1", "acc2", "acc3", "psnr", "ssim")


def _save_aif_png(path, img):
    """An AiF image [3, H, W] normalised to [0, 1] by its own range, as an
    8-bit RGB PNG (reference 2_aber_aware_dff_aif.py:222-224)."""
    a = np.transpose(np.asarray(img), (1, 2, 0))
    lo, hi = a.min(), a.max()
    a = (a - lo) / max(hi - lo, 1e-12)
    write_png(path, (a * 255).astype(np.uint8))


def validate(eval_step, state: TrainState, test_lens, val_loader, n_stack: int,
             epoch: int, args: dict, save_images: bool = True) -> dict:
    """Mean over `val_loader`'s batches (aif [1, 3, H, W], gt depth
    [1, 1, H, W] in m, host arrays) of the 11 metrics of VAL_METRICS, and
    `avg_time`, the eval forward's seconds a batch.  A batch whose mean
    valid depth is NaN is skipped.  Each batch's focal stack is rendered
    through `test_lens` at linearly spaced focus distances.

    With `save_images`, writes results/img{idx}_pred.png and _gt.png (JET
    colour maps) and _pred_aif.png and _gt_aif.png under
    args["results_dir"].  LPIPS is not computed: the port has no LPIPS
    network (JAX computes it only when `ckpt/lpips_vgg.msgpack` exists).
    """
    result_img_dir = os.path.join(args["results_dir"], "results")
    os.makedirs(result_img_dir, exist_ok=True)
    logging.info("LPIPS skipped: the port has no LPIPS network")
    device = state.step.device
    sums = {k: 0.0 for k in VAL_METRICS}
    n_val, val_time = 0, 0.0
    for idx, (aif, gt_depth) in enumerate(val_loader):
        if np.isnan(gt_depth.sum() / max((gt_depth > 0).sum(), 1)):
            continue
        aif_t = torch.as_tensor(aif, device=device)
        gt_t = torch.as_tensor(gt_depth, device=device)
        focus_dists = select_focus_dist(gt_t, n_stack, mode="linear")
        stack = render_focal_stack(test_lens, aif_t, gt_t, focus_dists)

        t0 = time.time()
        out = eval_step(state, stack, focus_dists)
        pred_aif = out["pred_AiF_img"].cpu().numpy()
        val_time += time.time() - t0

        gt, pd = gt_t.squeeze(), out["pred_depth"].squeeze()
        tm = gt > 0
        sums["abs_rel"] += float(M.mask_abs_rel(pd, gt, tm))
        sums["sq_rel"] += float(M.mask_sq_rel(pd, gt, tm))
        sums["mse"] += float(M.mask_mse(pd, gt, tm))
        sums["mae"] += float(M.mask_mae(pd, gt, tm))
        sums["rmse"] += float(M.mask_rmse(pd, gt, tm))
        sums["rmse_log"] += float(M.mask_rmse_log(pd, gt, tm))
        for k in (1, 2, 3):
            sums[f"acc{k}"] += float(M.mask_accuracy_k(pd, gt, k, tm))
        sums["psnr"] += M.mask_psnr(pred_aif, aif)
        sums["ssim"] += M.mask_ssim(pred_aif, aif)
        n_val += 1

        if save_images:
            gt_np = np.squeeze(gt_depth)
            imwrite_colormap(f"{result_img_dir}/img{idx}_pred.png",
                             pd.cpu().numpy(), vmax=gt_np.max())
            imwrite_colormap(f"{result_img_dir}/img{idx}_gt.png", gt_np)
            _save_aif_png(f"{result_img_dir}/img{idx}_pred_aif.png", pred_aif[0])
            _save_aif_png(f"{result_img_dir}/img{idx}_gt_aif.png", aif[0])

    n_val = max(n_val, 1)
    scores = {k: v / n_val for k, v in sums.items()}
    scores["avg_time"] = val_time / n_val
    for k, v in scores.items():
        logging.info(f"Avg_{k}({epoch}): {v}")
    return scores


def save_checkpoint(ckpt_dir: str, state: TrainState, name: str = "last"):
    """Write the whole train state to depth_net_<name>.pt, atomically (a kill
    mid-write leaves the previous file intact)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"depth_net_{name}.pt")
    tmp = path + ".tmp"
    torch.save({"model": state.model.state_dict(), **state.opt.tensors(),
                "step": state.step}, tmp)
    os.replace(tmp, path)


def load_checkpoint(ckpt_dir: str, state: TrainState,
                    name: str = "last") -> TrainState:
    """Restore `state` from depth_net_<name>.pt (written by `save_checkpoint`)
    or, where there is none, from the JAX package's depth_net_<name>.msgpack
    (`load_flax_checkpoint`)."""
    path = os.path.join(ckpt_dir, f"depth_net_{name}.pt")
    if not os.path.exists(path):
        return load_flax_checkpoint(
            os.path.join(ckpt_dir, f"depth_net_{name}.msgpack"), state)
    sd = torch.load(path, map_location=state.step.device, weights_only=True)
    state.model.load_state_dict(sd["model"])
    with torch.no_grad():
        for dst, src in zip(state.opt.mu + state.opt.nu, sd["mu"] + sd["nu"]):
            dst.copy_(src)
        state.opt.count.copy_(sd["count"])
        # a checkpoint written before the counts were split has one count
        state.opt.schedule_count.copy_(sd.get("schedule_count", sd["count"]))
        state.step.copy_(sd["step"])
    return state


def _flax_converter(model: nn.Module):
    """The function that turns {'params', 'batch_stats'} of the Flax
    counterpart of `model` into its torch state dict."""
    if isinstance(model, AiFDepthNet):
        return aifnet_state_from_flax
    if isinstance(model, DFVNet):
        return dfvnet_state_from_flax
    raise TypeError(f"no Flax converter for {type(model).__name__}")


def _optax_adam_state(opt_state) -> tuple[dict, dict]:
    """(ScaleByAdamState, ScaleByScheduleState) of a serialised
    `optax.adam(schedule)` state, {'0': {count, mu, nu}, '1': {count}}."""
    try:
        adam, sched = opt_state["0"], opt_state["1"]
        if set(adam) == {"count", "mu", "nu"} and set(sched) == {"count"}:
            return adam, sched
    except (KeyError, TypeError):
        pass
    raise ValueError("opt_state is not the state of optax.adam with a "
                     "learning-rate schedule")


def load_flax_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore `state` (AiFDepthNet or DFVNet) from a train state that the
    JAX package's `save_checkpoint` wrote (`trainer.py:287-330`).

    A full state sets the parameters, BatchNorm statistics, Adam's moments
    and both counts and the step.  A state stripped of `opt_state`
    (`scripts/strip_ckpt.py`) sets the parameters, statistics and step,
    re-seeds the schedule's count to the step and keeps `state`'s Adam
    moments and count, as JAX does: from a fresh state Adam restarts cold.
    """
    sd = flax_msgpack.load(path)
    convert = _flax_converter(state.model)
    stats = sd["batch_stats"]
    state.model.load_state_dict(convert({"params": sd["params"],
                                         "batch_stats": stats}))
    names = [n for n, _ in state.model.named_parameters()]
    device = state.step.device
    with torch.no_grad():
        if "opt_state" in sd:
            adam, sched = _optax_adam_state(sd["opt_state"])
            for key, dst in (("mu", state.opt.mu), ("nu", state.opt.nu)):
                tree = convert({"params": adam[key], "batch_stats": stats})
                for d, n in zip(dst, names):
                    d.copy_(tree[n])
            state.opt.count.fill_(int(adam["count"]))
            state.opt.schedule_count.fill_(int(sched["count"]))
        elif "step" in sd:
            state.opt.schedule_count.fill_(int(sd["step"]))
            logging.warning(
                "checkpoint %s is stripped of opt_state: LR-schedule count "
                "re-seeded to step %d; Adam restarts cold", path, int(sd["step"]))
        if "step" in sd:
            state.step.copy_(torch.as_tensor(int(sd["step"]), device=device))
    return state


class CheckpointManager:
    """Step-indexed train-state checkpoints with retention (the counterpart
    of the JAX package's `OrbaxManager`): step s lives in
    <directory>/<s>/depth_net_state.pt, and a save keeps the newest
    `max_to_keep` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory) if d.isdigit()
                      and os.path.exists(os.path.join(
                          self.directory, d, "depth_net_state.pt")))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState):
        save_checkpoint(os.path.join(self.directory, str(step)), state, "state")
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_checkpoint(os.path.join(self.directory, str(step)), state,
                               "state")
