"""Aberration-aware DFF training with AiFDepthNet (the port of
`aadff_tpu/train/dff_aif.py`): the YAML config, the lens and dataset
factories, focal stacks rendered in the loop, per-epoch validation with the
full metric suite, and last/best/best_acc1 checkpoints.

    python -m aadff_tpu_torch.train.dff_aif [--config C] [--device D]

trains on one device.  Under a launcher,

    python -m torch.distributed.run --nproc_per_node N \
        -m aadff_tpu_torch.train.dff_aif [--backend nccl|gloo]

it trains data-parallel over N ranks (`parallel/mesh.py`; NCCL on the
cards by default, each rank on cuda:LOCAL_RANK), as the JAX loop shards
each batch over its mesh: every rank shuffles with the same seed, reads
and renders only its bs / N rows of each global batch, and the step
averages the gradients and takes BatchNorm's statistics and the losses
over the global batch.  N must divide bs.  Validation and checkpoints run
on rank 0 while the others wait; every rank ends with the same state.
The augmentation draws from numpy's global stream, seeded 126 + rank on
each rank (ROADMAP C).

Also the pieces that `scripts/aber_aware_dff_synth.py` shares with `train`:
`resolve_device`, `TASKS`, `nan_depth` and `to_device`.
"""
from __future__ import annotations

import argparse
import logging
import os
from datetime import datetime

import numpy as np
import torch

from ..dff.dataset import NumpyLoader
from ..dff.factory import get_dataset, get_lens
from ..dff.focus import select_focus_dist
from ..models.aifnet import AiFDepthNet
from ..parallel import mesh
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
    args["num_devices"] = mesh.size()
    result_dir = mesh.broadcast_object(
        "./results/" + datetime.now().strftime("%m%d-%H%M%S")
        + "-AberAware_DFF_AiFNet")
    args["results_dir"] = result_dir
    os.makedirs(result_dir, exist_ok=True)
    if mesh.rank() == 0:
        set_logger(result_dir)
    logging.info(f"Using {args['num_devices']} devices")
    logging.info(f"Result folder: {result_dir}")
    set_seed(126)
    return args


def shard_loader(train_set, bs: int) -> NumpyLoader:
    """The shuffled train loader of this rank: its rows of each global batch
    of `bs` (all of them on one device).  Refuses a world that does not
    split bs (`parallel.mesh.check_batch`), and seeds the augmentation's
    stream 126 + rank on each rank of several."""
    mesh.check_batch(bs)
    if mesh.distributed():
        np.random.seed(126 + mesh.rank())
    return NumpyLoader(train_set, batch_size=bs, shuffle=True,
                       shard=(mesh.rank(), mesh.size()))


def train(args, device="cuda", timer=None):
    """Train for args["epochs"] epochs, validating and checkpointing after
    each one, and return the train state.  As in the JAX package, the loop
    runs epochs + 1 training passes: validation comes before each pass but
    the first.  With a `trainer.StepTimer`, each train step (render
    included) is timed and the loop's wait for each batch recorded.  Under
    an active mesh (`parallel/mesh.py`) this is one rank of a data-parallel
    run, as the module's docstring says."""
    device = resolve_device(device)
    train_lens, test_lens = get_lens(args, device)
    task = TASKS[args["pred_name"]]
    n_stack = args["n_stack"]
    torch.manual_seed(126)  # the model's initial weights
    model = AiFDepthNet(dtype=trunk_dtype(args)).to(device)

    train_set, val_set = get_dataset(args)
    train_loader = shard_loader(train_set, args["bs"])
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
    mesh.replicate(model)

    train_step = make_aif_train_step(task)
    eval_step = make_aif_eval_step()
    args["mse_min"] = 100.0
    args["acc1_max"] = 0.0

    for epoch in range(args["epochs"] + 1):
        if epoch > 0:
            if mesh.rank() == 0:
                scores = validate(eval_step, state, test_lens, val_loader,
                                  n_stack, epoch, args)
                save_checkpoint(args["results_dir"], state, "last")
                if scores["mse"] < args["mse_min"]:
                    args["mse_min"] = scores["mse"]
                    save_checkpoint(args["results_dir"], state, "best")
                if scores["acc1"] > args["acc1_max"]:
                    args["acc1_max"] = scores["acc1"]
                    save_checkpoint(args["results_dir"], state, "best_acc1")
            mesh.barrier()

        epoch_loss, n_batches = 0.0, 0
        for aif, depth in (train_loader if timer is None
                           else timer.timed(train_loader)):
            # a NaN in any rank's rows skips the global batch on every rank
            if mesh.any_over_ranks(nan_depth(depth)):
                continue
            aif, depth = to_device(device, aif, depth)
            t = None if timer is None else timer.start()
            focus_dists = select_focus_dist(depth, n_stack, mode="linear")
            stack = render_focal_stack(train_lens, aif, depth, focus_dists)
            losses = train_step(state, stack, focus_dists, depth, aif)
            if timer is not None:
                timer.stop(t, 1)
            epoch_loss += float(losses["total"])
            n_batches += 1
        if n_batches:
            logging.info(f"epoch {epoch}: loss {epoch_loss / n_batches:.4f}")

    return state


def parse_args(argv, default_config: str):
    """--config, --device and --backend of the train entry points."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=default_config)
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK under a launcher), cuda:<i> "
                         "(every rank on that card) or cpu")
    ap.add_argument("--backend", choices=mesh.BACKENDS, default=None,
                    help="under a launcher: nccl (the default on CUDA) or "
                         "gloo (the default on the CPU)")
    a = ap.parse_args(argv)
    if a.backend is not None and not mesh.launched():
        ap.error("--backend needs a launcher: python -m torch.distributed.run "
                 "--nproc_per_node N -m ...")
    return a


def run(module_config, module_train, argv, default_config):
    """main() of a train entry point: join the launcher's mesh if there is
    one, then config() and train() on this rank's device."""
    a = parse_args(argv, default_config)
    m = mesh.setup_from_launcher(a.device, a.backend)
    try:
        args = module_config(a.config)
        return module_train(args, device=str(m.device) if m else a.device)
    finally:
        mesh.teardown()


def main(argv=None):
    return run(config, train, argv, "configs/aber_aware_dff_aif.yml")


if __name__ == "__main__":
    main()
