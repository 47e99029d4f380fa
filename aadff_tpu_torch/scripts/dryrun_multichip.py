"""The multi-device dry run (the twin of `__graft_entry__.py:55-144`,
`dryrun_multichip`): one AiF and one DFVNet train step, focal stacks
rendered through PSFNet (B1, the fused kernel) included, data-parallel over
the launcher's ranks.

    python -m torch.distributed.run --nproc_per_node N \\
        -m aadff_tpu_torch.scripts.dryrun_multichip [--backend nccl|gloo] \\
        [--device cuda|cuda:<i>|cpu] [--report DIR]

As in the JAX package: B = N rows, S = 4 frames of 64x64, the inputs drawn
from `np.random.default_rng(0)` (AiF images uniform in [0, 1], depths and
focus distances uniform in [0.5, 15] m), each rank rendering and training
on its own row; AiFDepthNet on task DA_FS (aif_w 1, smooth_w 0.1) and
DFVNet(level 2, use_diff 1), Adam at lr 1e-4.  Rank 0 prints

    dryrun_multichip(N): ok, loss=... dfv_loss=... (...)

Without a launcher it runs one process (N = 1).  With `--report DIR` each
rank also writes DIR/rank<r>.json: its losses, its backend and device, and
the kernel wrappers' launch counts.  The JAX run draws its
PSFNet and model weights from Flax's initialisers; the port has none of
those, so by default PSFNet holds the committed checkpoint and the models
a seeded torch init (the tests pass the JAX run's own weights in).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from ..models.aifnet import AiFDepthNet
from ..models.dfv.dffnet import DFVNet
from ..ops import fused_render, mlp_psf
from ..parallel import mesh
from ..psfnet.psfnet import PSFNet
from ..train.dff_aif import resolve_device
from ..train.dff_dfv import make_dfv_train_step
from ..train.trainer import (create_train_state, make_aif_train_step,
                             render_focal_stack)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PSFNET_CKPT = os.path.join(ROOT, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
S, H, W, KS, LR = 4, 64, 64, 11, 1e-4


def inputs(n: int):
    """The JAX run's global batch of n rows: aif [n, 3, H, W], depth
    [n, 1, H, W] (m), focus distances [n, S] (m), as float32 numpy."""
    rng = np.random.default_rng(0)
    aif = rng.uniform(0, 1, (n, 3, H, W)).astype(np.float32)
    depth = rng.uniform(0.5, 15.0, (n, 1, H, W)).astype(np.float32)
    focus = np.sort(rng.uniform(0.5, 15.0, (n, S)), axis=-1).astype(np.float32)
    return aif, depth, focus


def dryrun_multichip(device, psfnet: str = PSFNET_CKPT, aif_init=None,
                     dfv_init=None) -> dict:
    """One AiF and one DFV train step over the active mesh's ranks (or one
    process) from `aif_init`/`dfv_init` (state dicts; a seeded torch init
    where None).  Returns the global losses, both states and this rank's
    stack."""
    n = mesh.size()
    device = torch.device(device)
    aif, depth, focus = (torch.from_numpy(a).to(device)
                         for a in mesh.shard_batch(*inputs(n)))
    lens = PSFNet(kernel_size=KS, sensor_res=(H, W), device=device)
    lens.load_net(psfnet)
    stack = render_focal_stack(lens, aif, depth, focus)
    if tuple(stack.shape) != (1, S, H, W, 3):
        raise RuntimeError(f"this rank's stack is {tuple(stack.shape)}, "
                           f"not one row of the {n}-row batch")

    def state_of(model, init, seed):
        torch.manual_seed(seed)
        model = model().to(device)
        if init is not None:
            model.load_state_dict(init)
        mesh.replicate(model)
        return create_train_state(model, LR, 1)

    state = state_of(AiFDepthNet, aif_init, 0)
    losses = make_aif_train_step("DA_FS", aif_w=1.0, smooth_w=0.1)(
        state, stack, focus, depth, aif)
    dfv_state = state_of(lambda: DFVNet(clean=False, level=2, use_diff=1),
                         dfv_init, 1)
    dfv_losses = make_dfv_train_step()(dfv_state, stack, focus, depth)
    out = {"loss": float(losses["total"]), "dfv_loss": float(dfv_losses["total"]),
           "skipped": float(losses["skipped_nonfinite"])
           + float(dfv_losses["skipped_nonfinite"]),
           "state": state, "dfv_state": dfv_state, "stack": stack}
    if not (math.isfinite(out["loss"]) and math.isfinite(out["dfv_loss"])):
        raise RuntimeError(f"non-finite losses {out['loss']}, {out['dfv_loss']}")
    if out["skipped"]:
        raise RuntimeError("a train step was skipped")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=mesh.BACKENDS, default=None,
                    help="nccl (the default on CUDA) or gloo (the default on "
                         "the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK under a launcher), cuda:<i> "
                         "(every rank on that card) or cpu")
    ap.add_argument("--report", default=None,
                    help="a directory for each rank's rank<r>.json")
    a = ap.parse_args(argv)
    if a.backend is not None and not mesh.launched():
        ap.error("--backend needs a launcher: python -m torch.distributed.run "
                 "--nproc_per_node N -m aadff_tpu_torch.scripts.dryrun_multichip")
    device = resolve_device(a.device)
    m = mesh.setup_from_launcher(str(device), a.backend)
    try:
        out = dryrun_multichip(m.device if m else device)
        n = mesh.size()
        if mesh.rank() == 0:
            print(f"dryrun_multichip({n}): ok, loss={out['loss']:.4f} "
                  f"dfv_loss={out['dfv_loss']:.4f} (render + AiF + DFV train "
                  f"steps sharded over {n} ranks)", flush=True)
        if a.report is not None:
            with open(os.path.join(a.report, f"rank{mesh.rank()}.json"), "w") as f:
                json.dump({"world": n, "loss": out["loss"],
                           "dfv_loss": out["dfv_loss"],
                           "backend": m.backend if m else None,
                           "device": str(out["stack"].device),
                           "launches": dict(fused_render.variant_launches),
                           "mlp_psf_launches": mlp_psf.launches}, f)
    finally:
        mesh.teardown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
