"""Aberration-aware DFF training on SynthMiddlebury, in chunks: the twin of
`scripts/3_aber_aware_dff_synth.py` for the PyTorch/CUDA port.

    python -m aadff_tpu_torch.scripts.aber_aware_dff_synth \\
        [--config configs/aber_aware_dff_synth.yml] [--workdir DIR] \\
        [--epochs-per-chunk N] [--total-epochs N] [--k-per-dispatch K] \\
        [--eval-only CKPT_NAME] [--device cuda|cpu] ...

Each invocation trains `--epochs-per-chunk` epochs from where the workdir
stands and exits: focal stacks rendered through the PSF surrogate in the
loop, AiFDepthNet forward/backward, validation with the full metric suite,
best checkpoints.  It runs on the GPU unless `--device cpu` is given; with
no GPU and no `--device cpu` it stops with an error.

Files under --workdir, as the JAX script writes them (with .pt for
.msgpack):
  depth_net_state.pt            full train state, the resume point
  depth_net_best.pt / _best_acc1.pt   best validation MSE / acc1
  progress.json                 epoch reached (advances only together with
                                a saved state), mse_min, acc1_max
  train_log.jsonl               per epoch: mean loss, steps, skipped, sec,
                                and step_ms, the time of each step (render
                                included; a K-step call's time over K)
  metrics.jsonl                 per validated epoch: the metric suite
  eval_final.json               --eval-only's metrics
A workdir that holds the JAX script's depth_net_state.msgpack and no .pt
resumes from the msgpack.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..dff.dataset import NumpyLoader
from ..dff.factory import get_dataset, get_lens
from ..dff.focus import select_focus_dist
from ..models.aifnet import AiFDepthNet
from ..train.dff_aif import TASKS, nan_depth, resolve_device, to_device
from ..train.trainer import (StepTimer, create_train_state, load_checkpoint,
                             make_aif_eval_step, make_aif_train_multi_step,
                             make_aif_train_step, render_focal_stack,
                             save_checkpoint, validate)
from ..utils.config import load_config
from ..utils.logging import set_seed

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def train_epoch(train_loader, device, n_stack, single_step, multi_step, k,
                timer, skip):
    """One pass over `train_loader`, the chunk loop's body that both twins
    share.  A batch (aif, depth) for which skip(depth) holds is left out;
    the others go to the device with linearly spaced focus distances and
    train through single_step(aif, depth, focus) -> losses or, with k > 1,
    in groups of k through multi_step(aif_k, depth_k, focus_k) -> losses
    stacked to [k], whose losses are read only at the epoch's end (the
    epoch's tail of < k batches goes one call a step, so that every loaded
    batch trains and the step count follows the loader).  Each call is
    timed by `timer`.  Returns (sum of the losses, steps, skipped)."""
    epoch_loss, n_batches, n_skipped = 0.0, 0, 0
    pending = []  # staged (aif, depth, focus) device batches of a K-step call
    deferred_losses = []  # K-step losses, read at the epoch's end

    def one(aif, depth, focus_dists):
        t = timer.start()
        losses = single_step(aif, depth, focus_dists)
        timer.stop(t, 1)
        return float(losses["total"]), int(losses["skipped_nonfinite"])

    for aif, depth in train_loader:
        if skip(depth):
            continue
        aif, depth = to_device(device, aif, depth)
        focus_dists = select_focus_dist(depth, n_stack, mode="linear")
        if k > 1:
            pending.append((aif, depth, focus_dists))
            if len(pending) < k:
                continue
            t = timer.start()
            losses = multi_step(*(torch.stack(group) for group in zip(*pending)))
            timer.stop(t, k)
            pending = []
            deferred_losses.append(losses)
            n_batches += k
        else:
            loss, skipped = one(aif, depth, focus_dists)
            epoch_loss += loss
            n_skipped += skipped
            n_batches += 1
    for aif, depth, focus_dists in pending:
        loss, skipped = one(aif, depth, focus_dists)
        epoch_loss += loss
        n_skipped += skipped
        n_batches += 1
    for losses in deferred_losses:
        epoch_loss += float(losses["total"].sum())
        n_skipped += int(losses["skipped_nonfinite"].sum())
    return epoch_loss, n_batches, n_skipped


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(REPO, "configs/aber_aware_dff_synth.yml"))
    ap.add_argument("--workdir", default=os.path.join(REPO, "results/dff_synth_torch"))
    ap.add_argument("--epochs-per-chunk", type=int, default=3)
    ap.add_argument("--total-epochs", type=int, default=20)
    ap.add_argument("--validate-every", type=int, default=1)
    ap.add_argument("--save-images", action="store_true")
    ap.add_argument("--eval-only", default=None, metavar="CKPT_NAME",
                    help="skip training; validate checkpoint "
                         "depth_net_<CKPT_NAME>.pt (or .msgpack) and exit")
    ap.add_argument("--val-dir", default=None,
                    help="override the validation scene dir")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the config peak learning rate (the cosine "
                         "still decays over total-epochs)")
    ap.add_argument("--bf16", action="store_true",
                    help="run the conv trunk in bfloat16 (params, optimizer "
                         "and losses stay f32; the render stays f32)")
    ap.add_argument("--save-every", type=int, default=1,
                    help="save the full train state every N epochs; "
                         "progress.json advances only with a save, so a kill "
                         "retrains at most N-1 epochs")
    ap.add_argument("--k-per-dispatch", type=int, default=0,
                    help="group K train steps (render included) into one "
                         "call whose losses are read at the epoch's end "
                         "(0 = one call per step, the reference-shaped loop)")
    ap.add_argument("--time-budget", type=float, default=600.0,
                    help="stop cleanly after the first epoch that ends past "
                         "this many seconds")
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
    progress = {"epoch": 0, "mse_min": 1e9, "acc1_max": 0.0}
    if os.path.exists(progress_path):
        with open(progress_path) as f:
            progress = json.load(f)
    start_epoch = progress["epoch"]
    if args_cli.eval_only is None and start_epoch >= args_cli.total_epochs:
        print(f"training complete at epoch {start_epoch}")
        return None

    train_lens, test_lens = get_lens(args, device)
    task = TASKS[args["pred_name"]]
    n_stack = args["n_stack"]
    torch.manual_seed(126)  # the model's initial weights
    model = AiFDepthNet(dtype=torch.bfloat16 if args_cli.bf16 else None).to(device)

    train_set, val_set = get_dataset(args)
    train_loader = NumpyLoader(train_set, batch_size=args["bs"], shuffle=True,
                               seed=126 + start_epoch)
    val_loader = NumpyLoader(val_set, batch_size=1)

    steps_per_epoch = len(train_loader)
    total_steps = max(args_cli.total_epochs * steps_per_epoch, 1)
    state = create_train_state(model, float(args["lr"]), total_steps)
    if start_epoch > 0:
        state = load_checkpoint(args_cli.workdir, state, name="state")
        print(f"resumed from epoch {start_epoch} (step {int(state.step)})")

    train_step = make_aif_train_step(task)
    multi_step = make_aif_train_multi_step(task, train_lens)
    eval_step = make_aif_eval_step()

    if args_cli.eval_only is not None:
        state = load_checkpoint(args_cli.workdir, state, name=args_cli.eval_only)
        scores = validate(eval_step, state, test_lens, val_loader, n_stack,
                          start_epoch, args, save_images=True)
        scores = {k: float(v) for k, v in scores.items()}
        scores["ckpt"] = args_cli.eval_only
        with open(os.path.join(args_cli.workdir, "eval_final.json"), "w") as f:
            json.dump(scores, f, indent=2)
        print("eval:", json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                   for k, v in scores.items()}))
        return state

    def single_step(aif, depth, focus_dists):
        stack = render_focal_stack(train_lens, aif, depth, focus_dists)
        return train_step(state, stack, focus_dists, depth, aif)

    end_epoch = min(start_epoch + args_cli.epochs_per_chunk,
                    args_cli.total_epochs)
    timer = StepTimer(device)
    for epoch in range(start_epoch, end_epoch):
        t0 = time.time()
        epoch_loss, n_batches, n_skipped = train_epoch(
            train_loader, device, n_stack, single_step,
            lambda *group: multi_step(state, *group), args_cli.k_per_dispatch,
            timer, nan_depth)
        mean_loss = epoch_loss / max(n_batches, 1)
        rec = {"epoch": epoch + 1, "loss": round(mean_loss, 5),
               "steps": n_batches, "skipped": n_skipped,
               "sec": round(time.time() - t0, 1), "step_ms": timer.step_ms()}
        print("train:", json.dumps(rec))
        with open(os.path.join(args_cli.workdir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

        # progress.json advances only together with a saved state, so a kill
        # between saves retrains at most save_every - 1 epochs instead of
        # resuming from a state file that does not exist
        def _persist():
            save_checkpoint(args_cli.workdir, state, "state")
            progress["epoch"] = epoch + 1
            with open(progress_path, "w") as f:
                json.dump(progress, f)

        saved = False
        if (epoch + 1) % args_cli.save_every == 0 or epoch + 1 == end_epoch:
            _persist()
            saved = True

        if (epoch + 1) % args_cli.validate_every == 0 or epoch + 1 == args_cli.total_epochs:
            scores = validate(eval_step, state, test_lens, val_loader, n_stack,
                              epoch + 1, args, save_images=args_cli.save_images)
            scores = {k: float(v) for k, v in scores.items()}
            scores["epoch"] = epoch + 1
            with open(os.path.join(args_cli.workdir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(scores) + "\n")
            print("val:", json.dumps({k: round(v, 4) for k, v in scores.items()}))
            if scores["mse"] < progress["mse_min"]:
                progress["mse_min"] = scores["mse"]
                save_checkpoint(args_cli.workdir, state, "best")
            if scores["acc1"] > progress["acc1_max"]:
                progress["acc1_max"] = scores["acc1"]
                save_checkpoint(args_cli.workdir, state, "best_acc1")

        with open(progress_path, "w") as f:
            json.dump(progress, f)

        if time.time() - t_start > args_cli.time_budget:
            if not saved:
                _persist()
            print(f"time budget reached after epoch {epoch + 1}; exiting cleanly")
            break

    print(f"chunk done: epochs {start_epoch + 1}..{end_epoch} / {args_cli.total_epochs}")
    return state


if __name__ == "__main__":
    main()
