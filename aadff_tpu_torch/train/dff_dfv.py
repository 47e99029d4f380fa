"""Aberration-aware DFF training with DFVNet (the port of
`aadff_tpu/train/dff_dfv.py`): the train step `_dfv_step_body` :43-73, the
eval step `make_dfv_eval_step` :101-109 and `validate_dfv` :112-131 with its
metrics.  The engine (Adam with the cosine schedule, the non-finite guard,
`render_focal_stack`) is `train/trainer.py`'s.
"""
from __future__ import annotations

from ..dff import metrics
from ..dff.focus import select_focus_dist
from ..models.dfv.dffnet import dfv_loss
from .trainer import (TrainState, guarded_step, make_aif_eval_step,
                      render_focal_stack)

METRICS = ("abs_rel", "mse", "mae", "rmse", "acc1")


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


def make_dfv_eval_step():
    """Returns eval_step(state, stack, focus_dists) -> (pred [B, 1, H, W],
    std [B, H, W], prob [B, S, H, W]), BatchNorm on its running statistics:
    the AiF eval step, which runs any model in eval mode."""
    return make_aif_eval_step()


def validate_dfv(eval_step, state: TrainState, lens, batches,
                 n_stack: int) -> dict[str, float]:
    """Mean over `batches` of (aif [B, 3, H, W], gt_depth [B, 1, H, W] in m)
    of the masked METRICS (mask gt > 0): each batch's focal stack is
    rendered through `lens` at linearly spaced focus distances, then
    evaluated."""
    sums = {k: 0.0 for k in METRICS}
    n_val = 0
    for aif, gt_depth in batches:
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
    return {k: v / max(n_val, 1) for k, v in sums.items()}
