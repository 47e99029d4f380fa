"""Aberration-aware DFF training with AiFDepthNet on one device (the port of
`aadff_tpu/train/dff_aif.py`): the YAML config, the lens and dataset
factories, focal stacks rendered in the loop, per-epoch validation with the
full metric suite, and last/best/best_acc1 checkpoints.  Data parallelism
is not ported yet (ROADMAP A8).

Also the pieces that `scripts/aber_aware_dff_synth.py` shares with `train`:
`resolve_device`, `TASKS`, `nan_depth` and `to_device`.
"""
from __future__ import annotations

import logging
import os
from datetime import datetime

import numpy as np
import torch

from ..dff.dataset import NumpyLoader
from ..dff.factory import get_dataset, get_lens
from ..dff.focus import select_focus_dist
from ..models.aifnet import AiFDepthNet
from ..utils.config import load_config
from ..utils.logging import set_logger, set_seed
from .trainer import (create_train_state, load_checkpoint, load_flax_checkpoint,
                      make_aif_eval_step, make_aif_train_step,
                      render_focal_stack, save_checkpoint, trunk_dtype,
                      validate)

TASKS = {"depth": "D_FS", "aif": "A_FS", "depth_aif": "DA_FS"}


def resolve_device(name: str) -> torch.device:
    """The torch device `name`; a CUDA device must exist, and there is no
    falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} was asked for but CUDA is not "
                           f"available; pass --device cpu (or device='cpu') "
                           f"to run on the CPU")
    return device


def nan_depth(depth: np.ndarray) -> bool:
    """Whether any depth map of a batch [B, 1, H, W] has a NaN mean over its
    valid pixels (such batches are skipped, reference
    2_aber_aware_dff_aif.py:103-105)."""
    mask = depth > 0
    avg = depth.sum(axis=(1, 2, 3)) / np.maximum(mask.sum(axis=(1, 2, 3)), 1)
    return bool(np.isnan(avg).any())


def to_device(device, *arrays):
    return [torch.as_tensor(a, device=device) for a in arrays]


def load_pretrained(path: str, state):
    """Load `dffnet_pretrained`: a JAX train-state msgpack or the port's
    depth_net_<name>.pt."""
    if path.endswith(".msgpack"):
        return load_flax_checkpoint(path, state)
    name = os.path.basename(path).replace("depth_net_", "").replace(".pt", "")
    return load_checkpoint(os.path.dirname(path), state, name)


def config(path="configs/aber_aware_dff_aif.yml"):
    args = load_config(path)
    args["num_devices"] = 1
    result_dir = ("./results/" + datetime.now().strftime("%m%d-%H%M%S")
                  + "-AberAware_DFF_AiFNet")
    args["results_dir"] = result_dir
    os.makedirs(result_dir, exist_ok=True)
    set_logger(result_dir)
    logging.info(f"Using {args['num_devices']} devices")
    logging.info(f"Result folder: {result_dir}")
    set_seed(126)
    return args


def train(args, device="cuda"):
    """Train for args["epochs"] epochs, validating and checkpointing after
    each one, and return the train state.  As in the JAX package, the loop
    runs epochs + 1 training passes: validation comes before each pass but
    the first."""
    device = resolve_device(device)
    train_lens, test_lens = get_lens(args, device)
    task = TASKS[args["pred_name"]]
    n_stack = args["n_stack"]
    torch.manual_seed(126)  # the model's initial weights
    model = AiFDepthNet(dtype=trunk_dtype(args)).to(device)

    train_set, val_set = get_dataset(args)
    train_loader = NumpyLoader(train_set, batch_size=args["bs"], shuffle=True)
    val_loader = NumpyLoader(val_set, batch_size=1)
    logging.info(
        f"Totally {len(train_set)} images for training, {len(val_set)} for test."
    )

    # decay over optimizer steps (batches), as the reference's cosine runs
    # over len(train_loader) steps per epoch (2_aber_aware_dff_aif.py:79-80)
    steps = max(args["epochs"] * len(train_loader), 1)
    state = create_train_state(model, float(args["lr"]), steps)
    path = args["train"].get("dffnet_pretrained")
    if path and os.path.exists(path):
        state = load_pretrained(path, state)
        logging.info(f"Loaded pretrained DFF net from {path}")

    train_step = make_aif_train_step(task)
    eval_step = make_aif_eval_step()
    args["mse_min"] = 100.0
    args["acc1_max"] = 0.0

    for epoch in range(args["epochs"] + 1):
        if epoch > 0:
            scores = validate(eval_step, state, test_lens, val_loader, n_stack,
                              epoch, args)
            save_checkpoint(args["results_dir"], state, "last")
            if scores["mse"] < args["mse_min"]:
                args["mse_min"] = scores["mse"]
                save_checkpoint(args["results_dir"], state, "best")
            if scores["acc1"] > args["acc1_max"]:
                args["acc1_max"] = scores["acc1"]
                save_checkpoint(args["results_dir"], state, "best_acc1")

        epoch_loss, n_batches = 0.0, 0
        for aif, depth in train_loader:
            if nan_depth(depth):
                continue
            aif, depth = to_device(device, aif, depth)
            focus_dists = select_focus_dist(depth, n_stack, mode="linear")
            stack = render_focal_stack(train_lens, aif, depth, focus_dists)
            losses = train_step(state, stack, focus_dists, depth, aif)
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
