"""Run the PSFNet quality gate on a checkpoint: the twin of
`scripts/psf_gate.py` for the PyTorch/CUDA port.

    python -m aadff_tpu_torch.scripts.psf_gate [ckpt] [--full]
        [--out PATH] [--device cuda|cpu]

The gate is `evaluate_psf_score`: the mean L1/L2 PSF error over the (foc,
z, field-grid) lattice against freshly ray-traced PSFs of
`lenses/rf50mm.json` at 480x640, ks 11, spp 4096.  The default ckpt is
`ckpt/rf50mm/psfnet_480x640_ks11.msgpack`; the default lattice 20 foc x 10
z, and `--full` the reference's 20 foc x 40 z.  It prints the JAX script's
JSON record; with `--out` it also adds the record to that file's
{"records": [...]}, replacing one of the same ckpt and lattice (the JAX
script keeps them in the repo's PSF_GATE.json, which this one never
writes).  It runs on the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..psfnet.psfnet import PSFNet
from ..train.dff_aif import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
SPP = 4096


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", nargs="?", default=CKPT)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the gate; returns its record."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    net = PSFNet(kernel_size=11, sensor_res=(480, 640), device=device,
                 filename=LENS)
    net.load_net(args.ckpt)
    n_z = 40 if args.full else 10
    t0 = time.time()
    l1, l2 = net.evaluate_psf_score(spp=SPP, n_z=n_z)
    dt = time.time() - t0
    rec = {
        "ckpt": os.path.relpath(os.path.abspath(args.ckpt), REPO),
        "avg_l1": l1, "avg_l2": l2,
        "lattice": f"{len(net.foc_z_arr)} foc x {n_z} z x "
                   f"{net.psf_grid[0]}x{net.psf_grid[1]} field points",
        "spp": SPP,
        "seconds": round(dt, 1),
        "date": time.strftime("%Y-%m-%d"),
    }
    print(json.dumps(rec, indent=2))
    if args.out is not None:
        try:
            with open(args.out) as f:
                records = json.load(f)["records"]
        except FileNotFoundError:
            records = []
        records = [r for r in records
                   if (r.get("ckpt"), r.get("lattice")) != (rec["ckpt"], rec["lattice"])]
        records.append(rec)
        with open(args.out, "w") as f:
            json.dump({"records": records}, f, indent=2)
            f.write("\n")
    return rec


if __name__ == "__main__":
    main()
