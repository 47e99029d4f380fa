"""Aberration-aware DFF training with DFVNet on SynthMiddlebury, in chunks:
the twin of `scripts/4_aber_aware_dff_dfv_synth.py` for the PyTorch/CUDA
port.

    python -m aadff_tpu_torch.scripts.aber_aware_dff_dfv_synth \\
        [--config configs/aber_aware_dff_synth.yml] [--workdir DIR] \\
        [--epochs-per-chunk N] [--total-epochs N] [--k-per-dispatch K] \\
        [--time-budget S] [--eval-only CKPT_NAME] [--lr LR] [--val-dir DIR] \\
        [--device cuda|cpu]

Each invocation trains `--epochs-per-chunk` epochs of DFVNet(level 2,
use_diff 1) from where the workdir stands and exits: focal stacks rendered
through the config's train lens in the loop (the PSF surrogate, or the
ideal thin lens under configs/aber_aware_dff_synth_thinlens.yml), the
multi-scale masked L1, validation through the test lens with the masked
depth metrics after every epoch, the best checkpoint by MSE.  The chunk
loop is `scripts/aber_aware_dff_synth.py`'s.  It runs on the GPU unless
`--device cpu` is given; with no GPU and no `--device cpu` it stops with an
error.

Files under --workdir, as the JAX script writes them (with .pt for
.msgpack):
  depth_net_state.pt / _best.pt   full train state after the last epoch /
                                  at the lowest validation MSE
  progress.json                   epoch reached and mse_min, written after
                                  each epoch's saved state
  train_log.jsonl                 per epoch: mean loss, steps, skipped,
                                  sec, and step_ms, the time of each step
                                  (render included; a K-step call's time
                                  over K)
  metrics.jsonl                   per epoch: abs_rel, mse, mae, rmse, acc1
  eval_final.json                 --eval-only's abs_rel, mse, rmse, acc1,
                                  with results/img{i}_{pred,gt}.png
A workdir that holds the JAX script's depth_net_state.msgpack and no .pt
resumes from the msgpack.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..dff.dataset import NumpyLoader
from ..dff.factory import get_dataset, get_lens
from ..models.dfv.dffnet import DFVNet
from ..train.dff_aif import resolve_device
from ..train.dff_dfv import (make_dfv_eval_step, make_dfv_train_multi_step,
                             make_dfv_train_step, validate_dfv)
from ..train.trainer import (create_train_state, load_checkpoint,
                             render_focal_stack, save_checkpoint)
from ..utils.config import load_config
from ..utils.logging import set_seed
from .aber_aware_dff_synth import REPO, StepTimer, train_epoch

EVAL_KEYS = ("abs_rel", "mse", "rmse", "acc1")  # the JAX script's eval_final.json


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(REPO, "configs/aber_aware_dff_synth.yml"))
    ap.add_argument("--workdir", default=os.path.join(REPO, "results/dfv_synth_torch"))
    ap.add_argument("--epochs-per-chunk", type=int, default=6)
    ap.add_argument("--total-epochs", type=int, default=20)
    ap.add_argument("--k-per-dispatch", type=int, default=0,
                    help="group K train steps (render included) into one "
                         "call whose losses are read at the epoch's end "
                         "(0 = one call per step, the reference-shaped loop)")
    ap.add_argument("--time-budget", type=float, default=600.0,
                    help="stop cleanly after the first epoch that ends past "
                         "this many seconds")
    ap.add_argument("--eval-only", default=None, metavar="CKPT_NAME",
                    help="skip training; validate checkpoint "
                         "depth_net_<CKPT_NAME>.pt (or .msgpack), save depth "
                         "maps, exit")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the config peak learning rate (the cosine "
                         "still decays over total-epochs)")
    ap.add_argument("--val-dir", default=None,
                    help="override the validation scene dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run one chunk (or one evaluation) and return the train state."""
    args_cli = parse_args(argv)
    t_start = time.time()
    device = resolve_device(args_cli.device)
    os.makedirs(args_cli.workdir, exist_ok=True)
    args = load_config(args_cli.config)
    args["results_dir"] = args_cli.workdir
    if args_cli.val_dir:
        args["SynthMiddlebury_val"] = args_cli.val_dir
    if args_cli.lr is not None:
        args["lr"] = args_cli.lr
    set_seed(126)

    progress_path = os.path.join(args_cli.workdir, "progress.json")
    progress = {"epoch": 0, "mse_min": 1e9}
    if os.path.exists(progress_path):
        with open(progress_path) as f:
            progress = json.load(f)
    start_epoch = progress["epoch"]
    if args_cli.eval_only is None and start_epoch >= args_cli.total_epochs:
        print(f"training complete at epoch {start_epoch}")
        return None

    train_lens, test_lens = get_lens(args, device)
    n_stack = args["n_stack"]
    torch.manual_seed(126)  # the model's initial weights
    model = DFVNet(clean=False, level=2, use_diff=1).to(device)

    train_set, val_set = get_dataset(args)
    train_loader = NumpyLoader(train_set, batch_size=args["bs"], shuffle=True,
                               seed=126 + start_epoch)
    val_loader = NumpyLoader(val_set, batch_size=1)

    total_steps = max(args_cli.total_epochs * len(train_loader), 1)
    state = create_train_state(model, float(args["lr"]), total_steps)
    if start_epoch > 0:
        state = load_checkpoint(args_cli.workdir, state, name="state")
        print(f"resumed from epoch {start_epoch} (step {int(state.step)})")

    train_step = make_dfv_train_step()
    multi_step = make_dfv_train_multi_step(train_lens)
    eval_step = make_dfv_eval_step()

    if args_cli.eval_only is not None:
        state = load_checkpoint(args_cli.workdir, state, name=args_cli.eval_only)
        img_dir = os.path.join(args_cli.workdir, "results")
        os.makedirs(img_dir, exist_ok=True)
        scores = validate_dfv(eval_step, state, test_lens, val_loader, n_stack,
                              img_dir=img_dir)
        scores = {k: float(scores[k]) for k in EVAL_KEYS}
        scores["ckpt"] = args_cli.eval_only
        with open(os.path.join(args_cli.workdir, "eval_final.json"), "w") as f:
            json.dump(scores, f, indent=2)
        print("eval:", json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                   for k, v in scores.items()}))
        return state

    def single_step(aif, depth, focus_dists):
        stack = render_focal_stack(train_lens, aif, depth, focus_dists)
        return train_step(state, stack, focus_dists, depth)

    end_epoch = min(start_epoch + args_cli.epochs_per_chunk,
                    args_cli.total_epochs)
    timer = StepTimer(device)
    for epoch in range(start_epoch, end_epoch):
        t0 = time.time()
        epoch_loss, n_batches, n_skipped = train_epoch(
            train_loader, device, n_stack, single_step,
            lambda *group: multi_step(state, *group), args_cli.k_per_dispatch,
            timer, lambda depth: bool(np.isnan(depth).any()))
        rec = {"epoch": epoch + 1,
               "loss": round(epoch_loss / max(n_batches, 1), 5),
               "steps": n_batches, "skipped": n_skipped,
               "sec": round(time.time() - t0, 1), "step_ms": timer.step_ms()}
        print("train:", json.dumps(rec))
        with open(os.path.join(args_cli.workdir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

        save_checkpoint(args_cli.workdir, state, "state")
        progress["epoch"] = epoch + 1
        # persist progress at once: a kill during validation must not
        # retrain the finished epoch
        with open(progress_path, "w") as f:
            json.dump(progress, f)

        scores = validate_dfv(eval_step, state, test_lens, val_loader, n_stack,
                              epoch + 1, args)
        scores = {k: float(v) for k, v in scores.items()}
        scores["epoch"] = epoch + 1
        with open(os.path.join(args_cli.workdir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(scores) + "\n")
        print("val:", json.dumps({k: round(v, 4) for k, v in scores.items()}))
        if scores["mse"] < progress["mse_min"]:
            progress["mse_min"] = scores["mse"]
            save_checkpoint(args_cli.workdir, state, "best")

        with open(progress_path, "w") as f:
            json.dump(progress, f)

        if time.time() - t_start > args_cli.time_budget:
            print(f"time budget reached after epoch {epoch + 1}; exiting cleanly")
            break

    print(f"chunk done: epochs {start_epoch + 1}..{end_epoch} / {args_cli.total_epochs}")
    return state


if __name__ == "__main__":
    main()
