"""Split the 'convonly' kernel's device time into its loads and the rest.

    python -m aadff_tpu_torch.scripts.psf_conv_phases [--reps 50] [--seed 0]

Builds `csrc/psf_conv.cu` twice with nvcc, as is and with
-DPSF_CONV_NO_LOADS (no halo and no depth load: the same FMAs, PSF values
and stores on whatever shared memory holds), and times each on one 480x640
RGB frame, ks 11, by torch.profiler's device time over `--reps` launches,
back to back (warm) and with 64 MB written between launches (L2-cold).
The difference is what the loads cost where they are not hidden.  Prints
one JSON line with the card's name and power limit; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import _build

H, W, C, KS = 480, 640, 3, 11
D_MIN, D_MAX = -200.0, -20000.0   # PSFNet's normalisation endpoints
FLUSH_BYTES = 64 << 20
VARIANTS = {"full": (), "no_loads": ("-DPSF_CONV_NO_LOADS",)}


def build(out_dir: Path) -> dict:
    """{variant: loaded library}, each built from csrc/psf_conv.cu."""
    exe = _build.nvcc()
    src = _build._CSRC / "psf_conv.cu"
    procs = {name: (out_dir / f"psf_conv_{name}.so", subprocess.Popen(
        [exe, *_build.NVCC_FLAGS, *flags, "-shared", "-o",
         str(out_dir / f"psf_conv_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.aadff_psf_conv.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.aadff_psf_conv.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_us(fn, reps: int, flush=None) -> float:
    """Mean device microseconds of the psf_conv kernels of `reps` calls."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "psf_conv" in e.name]
    if len(spans) != reps:
        raise RuntimeError(f"{len(spans)} kernels under the profiler, expected {reps}")
    return sum(spans) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("psf_conv_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    img = torch.rand(1, C, H, W, generator=gen, device=dev)
    depth = -(500 + 14500 * torch.rand(1, H, W, generator=gen, device=dev))
    out = torch.empty(1, 1, C, H, W, device=dev)
    flush_src = torch.empty(FLUSH_BYTES // 4, device=dev)
    flush_dst = torch.empty_like(flush_src)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        result = {}
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.aadff_psf_conv(img.data_ptr(), depth.data_ptr(),
                                        out.data_ptr(), 1, C, H, W, KS, D_MIN,
                                        D_MAX, stream)
                if rc != 0:
                    raise RuntimeError(f"psf_conv launch failed: {rc}")
            for _ in range(5):
                call()
            result[name] = {
                "warm_us": device_us(call, args.reps),
                "cold_us": device_us(call, args.reps,
                                     lambda: flush_dst.copy_(flush_src))}
    result["loads_us"] = {k: result["full"][k] - result["no_loads"][k]
                          for k in ("warm_us", "cold_us")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"frame": f"1x{C}x{H}x{W}", "ks": KS, "reps": args.reps,
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
