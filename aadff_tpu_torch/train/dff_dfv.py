"""Aberration-aware DFF training with DFVNet on one device (the port of
`aadff_tpu/train/dff_dfv.py`): the train step `_dfv_step_body` :43-73, K
steps per call `make_dfv_train_multi_step` :80-98, the eval step
`make_dfv_eval_step` :101-109, `validate_dfv` :112-131 with its metrics,
and the run `config` :32-41, `train` :134-186 and `main` :188-190.  The
engine (Adam with the cosine schedule, the non-finite guard,
`render_focal_stack`) is `train/trainer.py`'s.  Data parallelism is not
ported yet (ROADMAP A8).

    python -m aadff_tpu_torch.train.dff_dfv

is the twin of `scripts/2_aber_aware_dff_dfv.py`: configs/aber_aware_dff_dfv.yml,
results under ./results/<date>-AberAware_DFF_DFVNet.
"""
from __future__ import annotations

import logging
import os
from datetime import datetime

import numpy as np
import torch

from ..dff import metrics
from ..dff.dataset import NumpyLoader
from ..dff.factory import get_dataset, get_lens
from ..dff.focus import select_focus_dist
from ..models.dfv.dffnet import DFVNet, dfv_loss
from ..utils.config import load_config
from ..utils.image import imwrite_colormap
from ..utils.logging import set_logger, set_seed
from .dff_aif import resolve_device, to_device
from .trainer import (TrainState, create_train_state, guarded_step,
                      make_aif_eval_step, make_multi_step, render_focal_stack,
                      save_checkpoint)

METRICS = ("abs_rel", "mse", "mae", "rmse", "acc1")


def config(path="configs/aber_aware_dff_dfv.yml"):
    args = load_config(path)
    args["num_devices"] = 1
    result_dir = ("./results/" + datetime.now().strftime("%m%d-%H%M%S")
                  + "-AberAware_DFF_DFVNet")
    args["results_dir"] = result_dir
    os.makedirs(result_dir, exist_ok=True)
    set_logger(result_dir)
    set_seed(126)
    return args


def make_dfv_train_step():
    """Returns train_step(state, stack, focus_dists, depth) -> losses
    {"total", "skipped_nonfinite"}: a train-mode forward, `dfv_loss` over the
    mask depth > 0, then Adam, guarded as `trainer.guarded_step` says.

    stack [B, S, H, W, C]; focus_dists [B, S]; depth [B, 1, H, W].
    """

    def train_step(state: TrainState, stack, focus_dists, depth):
        def loss_fn(model):
            stacked, stds = model(stack, focus_dists)
            return {"total": dfv_loss(stacked, stds, depth, depth > 0)}

        return guarded_step(state, loss_fn)

    return train_step


def make_dfv_train_multi_step(lens):
    """Returns multi_step(state, aif_k, depth_k, focus_k) -> losses stacked
    to [K]: K DFV train steps in one call, each rendering its focal stack
    through `lens` first, the guard per step (`trainer.make_multi_step`)."""
    step = make_dfv_train_step()
    return make_multi_step(lens, lambda state, stack, focus, depth, aif:
                           step(state, stack, focus, depth))


def make_dfv_eval_step():
    """Returns eval_step(state, stack, focus_dists) -> (pred [B, 1, H, W],
    std [B, H, W], prob [B, S, H, W]), BatchNorm on its running statistics:
    the AiF eval step, which runs any model in eval mode."""
    return make_aif_eval_step()


def validate_dfv(eval_step, state: TrainState, lens, batches, n_stack: int,
                 epoch=None, args=None, img_dir=None) -> dict[str, float]:
    """Mean over `batches` of (aif [B, 3, H, W], gt_depth [B, 1, H, W] in m;
    host arrays or tensors) of the masked METRICS (mask gt > 0): each
    batch's focal stack is rendered through `lens` at linearly spaced focus
    distances, then evaluated on the train state's device.  With `epoch`,
    logs each metric as Avg_<name>(<epoch>), as the JAX package does (its
    `args` is unused there and here).  With `img_dir`, writes the JET
    colour maps img<i>_pred.png and img<i>_gt.png of each batch there, as
    the JAX package's DFV script does in its --eval-only."""
    device = state.step.device
    sums = {k: 0.0 for k in METRICS}
    n_val = 0
    for idx, (aif, gt_depth) in enumerate(batches):
        aif, gt_depth = to_device(device, aif, gt_depth)
        focus_dists = select_focus_dist(gt_depth, n_stack, mode="linear")
        stack = render_focal_stack(lens, aif, gt_depth, focus_dists)
        pred, _, _ = eval_step(state, stack, focus_dists)
        mask = gt_depth > 0
        sums["abs_rel"] += float(metrics.mask_abs_rel(pred, gt_depth, mask))
        sums["mse"] += float(metrics.mask_mse(pred, gt_depth, mask))
        sums["mae"] += float(metrics.mask_mae(pred, gt_depth, mask))
        sums["rmse"] += float(metrics.mask_rmse(pred, gt_depth, mask))
        sums["acc1"] += float(metrics.mask_accuracy_k(pred, gt_depth, 1, mask))
        n_val += 1
        if img_dir is not None:
            gt = np.squeeze(gt_depth.cpu().numpy())
            imwrite_colormap(f"{img_dir}/img{idx}_pred.png",
                             np.squeeze(pred.cpu().numpy()), vmax=gt.max())
            imwrite_colormap(f"{img_dir}/img{idx}_gt.png", gt)
    scores = {k: v / max(n_val, 1) for k, v in sums.items()}
    if epoch is not None:
        for k, v in scores.items():
            logging.info(f"Avg_{k}({epoch}): {v}")
    return scores


def train(args, device="cuda"):
    """Train DFVNet(level 2, use_diff 1) for args["epochs"] epochs and
    return the train state.  As in the JAX package: the cosine runs over
    epochs x len(loader) steps, the loop runs epochs + 1 training passes
    with validation before each pass but the first, then depth_net_last
    and, at a lower validation MSE, depth_net_best.  No `dffnet_pretrained`
    is loaded, as the JAX package loads none."""
    device = resolve_device(device)
    train_lens, test_lens = get_lens(args, device)
    n_stack = args["n_stack"]
    torch.manual_seed(126)  # the model's initial weights
    model = DFVNet(clean=False, level=2, use_diff=1).to(device)

    train_set, val_set = get_dataset(args)
    train_loader = NumpyLoader(train_set, batch_size=args["bs"], shuffle=True)
    val_loader = NumpyLoader(val_set, batch_size=1)

    steps = max(args["epochs"] * len(train_loader), 1)
    state = create_train_state(model, float(args["lr"]), steps)
    train_step = make_dfv_train_step()
    eval_step = make_dfv_eval_step()

    args["mse_min"] = 100.0
    for epoch in range(args["epochs"] + 1):
        if epoch > 0:
            scores = validate_dfv(eval_step, state, test_lens, val_loader,
                                  n_stack, epoch, args)
            save_checkpoint(args["results_dir"], state, "last")
            if scores["mse"] < args["mse_min"]:
                args["mse_min"] = scores["mse"]
                save_checkpoint(args["results_dir"], state, "best")
        epoch_loss, n_batches = 0.0, 0
        for aif, depth in train_loader:
            if np.isnan(depth).any():
                continue
            aif, depth = to_device(device, aif, depth)
            focus_dists = select_focus_dist(depth, n_stack, mode="linear")
            stack = render_focal_stack(train_lens, aif, depth, focus_dists)
            losses = train_step(state, stack, focus_dists, depth)
            epoch_loss += float(losses["total"])
            n_batches += 1
        if n_batches:
            logging.info(f"epoch {epoch}: loss {epoch_loss / n_batches:.4f}")
    return state


def main():
    args = config()
    train(args)


if __name__ == "__main__":
    main()
