#!/usr/bin/env python3
"""Where the time of the port's AiF train step goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_train_step.py [--steps 3] [--seed 0]

Builds the main path of chip_smoke.py (bs 2, 8 frames, 480x640, render
through the fused CUDA kernel, AiFDepthNet D_FS step with Adam and the
guard), runs two warm-up steps, then traces `--steps` steps with
torch.profiler.  Prints one JSON line: the step's wall time, the device time
of the traced kernels by category (the fused render kernel, convolutions,
BatchNorm, pooling, elementwise, reductions, other) and the device's idle
share over the traced window, then the top kernels by device time.  Exits
non-zero without a CUDA device or when the trace holds no device time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PSFNET_CKPT = os.path.join(ROOT, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
AIF_CKPT = os.path.join(ROOT, "ckpt", "dff_synth", "aifnet", "depth_net_best.msgpack")
BS, N_STACK, H, W, KS = 2, 8, 480, 640, 11

CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("render", ("fused_psf_render",)),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_")),
    ("conv", ("conv", "xmma", "gemm", "cudnn", "implicit", "wgrad", "dgrad")),
    ("pool", ("pool",)),
    ("elementwise", ("elementwise", "unrolled", "vectorized")),
    ("reduce", ("reduce",)),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from aadff_tpu_torch.dff.focus import select_focus_dist
    from aadff_tpu_torch.dff.synth import make_scenes
    from aadff_tpu_torch.models.aifnet import AiFDepthNet
    from aadff_tpu_torch.models.convert import load_flax_aifnet
    from aadff_tpu_torch.psfnet.psfnet import PSFNet
    from aadff_tpu_torch.train import trainer

    device = torch.device("cuda", 0)
    net = PSFNet(kernel_size=KS, sensor_res=(H, W), device=device)
    net.load_net(PSFNET_CKPT)
    model = AiFDepthNet().to(device)
    model.load_state_dict(load_flax_aifnet(AIF_CKPT)[0])
    n_steps = 2 + args.steps
    state = trainer.create_train_state(model, 1e-4, 20 * n_steps)
    train_step = trainer.make_aif_train_step("D_FS")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    scenes = [make_scenes(BS, H, W, gen, device) for _ in range(n_steps)]

    def step(aif, depth):
        focus = select_focus_dist(depth, N_STACK, mode="linear")
        stack = trainer.render_focal_stack(net, aif, depth, focus)
        return train_step(state, stack, focus, depth, aif)

    for aif, depth in scenes[:2]:
        step(aif, depth)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for aif, depth in scenes[2:]:
            losses = step(aif, depth)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    if device_us <= 0:
        print("the trace holds no device time", file=sys.stderr)
        return 1
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    window = max(e.time_range.end for e in kernels) - min(
        e.time_range.start for e in kernels)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    per_step = 1e3 / args.steps
    print(json.dumps({
        "gpu": smi, "steps": args.steps,
        "wall_ms_per_step": wall_s * per_step,
        "device_ms_per_step": device_us * per_step / 1e6,
        "kernels_per_step": len(kernels) / args.steps,
        "idle_share": 1.0 - busy / max(wall_s * 1e6, window),
        "by_category_ms_per_step": {k: v * per_step / 1e6 for k, v in
                                    sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "last_loss": float(losses["total"]),
    }), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({"top_kernels_ms_per_step": [
        [name[:120], us * per_step / 1e6] for name, us in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
