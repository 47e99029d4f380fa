"""Fit the PSF surrogate to the ray-traced lens: the twin of
`scripts/1_fit_psfnet.py` for the PyTorch/CUDA port.

    python -m aadff_tpu_torch.scripts.fit_psfnet [--iters N]
        [--evaluate-every N] [--result-dir DIR] [--device cuda|cpu]

The JAX script's settings: `lenses/rf50mm.json` at 480x640 with ks 11, a
warm start from `ckpt/rf50mm/psfnet_480x640_ks11.msgpack`, bs 128, lr 1e-4
(AdamW, cosine schedule), spp 4096, 100,000 iterations, the weights saved
every 1,000.  It writes lens.json, logs the lens's RMS spot radii (the JAX
script also draws figures, which need matplotlib), fits, writes the PSF
panels of `evaluate_psf` and prints the quality gate of the fitted net.
Files under --result-dir: lens.json, output.log, PSFNet_mlp.msgpack (a
Flax msgpack file, which the JAX package's `PSFNet.load_net` also reads)
and foc*_depth*.png.  It runs on the GPU unless `--device cpu` is given;
with no GPU and no `--device cpu` it stops with an error.
"""
from __future__ import annotations

import argparse
import logging
import os
from datetime import datetime

from ..optics.analysis import analysis_rms
from ..psfnet.psfnet import PSFNet
from ..train.dff_aif import resolve_device
from ..utils.logging import set_logger, set_seed

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
SENSOR_RES, KS = (480, 640), 11
BS, LR, SPP = 128, 1e-4, 4096


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100000)
    ap.add_argument("--evaluate-every", type=int, default=1000)
    ap.add_argument("--result-dir", default=None,
                    help="default: ./results/<date>-psfnet")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the script; returns (net, fit losses, (gate l1, gate l2))."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    result_dir = args.result_dir or (
        "./results/" + datetime.now().strftime("%m%d-%H%M%S") + "-psfnet")
    os.makedirs(result_dir, exist_ok=True)
    set_logger(result_dir)
    set_seed(0)

    psfnet = PSFNet(kernel_size=KS, sensor_res=SENSOR_RES, device=device,
                    filename=LENS)
    rms, rms_on, rms_off = analysis_rms(psfnet.lens)
    logging.info(f"RMS spot radius [mm]: {rms:.4g} (on-axis {rms_on:.4g}, "
                 f"off-axis {rms_off:.4g})")
    psfnet.lens.write_lens_json(os.path.join(result_dir, "lens.json"))

    if os.path.exists(CKPT):
        psfnet.load_net(CKPT)  # warm start from the reference checkpoint
    losses = psfnet.train_psfnet(iters=args.iters, bs=BS, lr=LR, spp=SPP,
                                 evaluate_every=args.evaluate_every,
                                 result_dir=result_dir)
    psfnet.evaluate_psf(result_dir=result_dir)
    l1, l2 = psfnet.evaluate_psf_score()
    print(f"avg l1 error: {l1}, avg l2 error: {l2}.")
    print("Finish PSF net fitting.")
    return psfnet, losses, (l1, l2)


if __name__ == "__main__":
    main()
