#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`aadff_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Runs, from the root of a checkout, the main path of
`scripts/3_aber_aware_dff_synth.py` at the full configuration of
`configs/aber_aware_dff_synth.yml` (task D_FS, bs 2, n_stack 8, 480x640,
ks 11, PSFNet `ckpt/rf50mm/psfnet_480x640_ks11.msgpack`, AiFDepthNet from
`ckpt/dff_synth/aifnet/depth_net_best.msgpack`), the two-stage render route,
and DFVNet training at the full configuration of
`configs/aber_aware_dff_dfv.yml` (bs 2, n_stack 8, 480x640, ks 11, lr 1e-4,
DFVNet level 2 from `ckpt/dff_synth/dfvnet/depth_net_best.msgpack`), DFVNet
levels 1, 3 and 4, the twin of `scripts/4_aber_aware_dff_dfv_synth.py`,
the thin-lens baseline (`configs/aber_aware_dff_synth_thinlens.yml`), and
the paper's own runs (`configs/aber_aware_dff_{aif,dfv}.yml`: Matterport3D
JPEG frames -> Middlebury2014), on scenes made from the seed and the
committed fixtures of tests/torch_assets/:

  device      the card, its power limit, torch and CUDA versions
  build       nvcc builds the kernels into build/aadff_tpu_torch/; ptxas'
              registers, spills and wgmma warnings of every kernel; the
              three bf16 (wgmma) kernels have no spills and no C7512
              ("wgmma serialized"), and no instantiation of the 'convonly'
              kernel (csrc/psf_conv.cu) spills
  kernels     the fused PSF-render kernel against its plain PyTorch version
              on the card (TF32 off for both): the main-path stack
              [2,8,3,480,640] and a ragged 123x161 frame
  mlp_kernel  the PSF-MLP kernel against its plain version (TF32 off): the
              field of the first batch at one focus distance (N = 614,400
              rows) and a ragged 123x161 field
  bf16_kernels
              both kernels with compute_dtype=bf16 (the wgmma MLP stage)
              against their plain bf16 versions and against the f32
              kernels: the fused render on the main-path stack and the
              ragged frame, the PSF MLP at N = 614,400 and N = 19,803; two
              launches of the stack are bit-identical
  two_stage   PSFNet.render of tests/goldens/render_goldens.npz (120x160 on
              the 480x640 PSFNet) and render_stack of a [2,8] stack at
              240x320, in f32 and in bf16, take field -> PSF-MLP kernel ->
              tap loop; each stack agrees with the fused kernel of its
              dtype on the same inputs
  frame_route PSFNet.render at 480x640 in f32 and bf16 (the fused kernel's
              one-frame launch), and render_stack with stack_kernel=False
              (one such launch per frame), held to the whole-stack launch
  kernel_split
              the fused kernel's diagnostic modes on a 480x640 frame, f32
              and bf16: 'mlponly', 'convonly' and pipe, each against its
              plain version, pipe against 'full'; their times split the
              kernel into MLP and convolution.  'mlponly' beside the
              cuBLAS chains of B3 on the frame's 307,200 rows (library_ms).
              'convonly' is its own kernel (csrc/psf_conv.cu): also held to
              its plain version at N = 2, on a ragged 123x161 frame, a 7x9
              frame (smaller than the halo) and at ks 7, one launch each;
              its device time by torch.profiler over 50 launches, warm and
              L2-cold (64 MB written between launches), with its share of
              the bound, beside PyTorch's depthwise 11x11 F.conv2d of the
              replicate-padded image (library_ms, TF32 off; the kernels it
              ran are named in library_names)
  train       3 train steps: render the focal stack through the fused
              kernel -> AiFDepthNet forward/backward -> Adam with a cosine
              schedule and the non-finite guard
  eval        one eval forward, with masked AbsRel and RMSE
  bf16_train / bf16_eval
              the same with PSFNet(render_dtype="bf16") (the bf16 fused
              kernel) and the bf16 AiFDepthNet trunk (compute_dtype: bf16)
  dfv_train   3 DFVNet train steps: render through the fused kernel ->
              DFVNet forward/backward with the multi-scale loss -> Adam and
              the guard
  dfv_eval    one DFVNet validation batch: masked AbsRel, MSE, MAE, RMSE,
              acc1
  entry       the entry point as users run it: configs/aber_aware_dff_synth.yml
              with its SynthMiddlebury paths pointing at 4 train and 2 val
              scenes from dff/synth.make_scenes, written as PNGs; the twin
              of scripts/3_aber_aware_dff_synth.py, in this process, runs
              one chunk, a resumed chunk with --k-per-dispatch 2,
              --eval-only best and a --bf16 chunk in a second workdir.
              Checks: progress.json at epoch 2 after 4 steps, the saved
              state loads bit for bit equal to the trained one, finite
              losses with none skipped, finite metrics, eval_final.json,
              and one B1 f32 launch per render (train steps and validation
              scenes).  Reports step_ms per step, validation forward ms,
              PNG read ms per scene and seconds per epoch
  dfv_levels  DFVNet levels 1, 3 and 4 (use_diff 1; levels 3 and 4 with the
              pooled decoders) from a seeded init: one train step and one
              eval forward each at bs 2 x 8 x 480x640 through B1 (losses,
              outputs and peak memory finite); each level's eval outputs
              on the card and on the CPU from the same weights at
              2 x 4 x 64x64, TF32 off, within 1e-4 of the largest value
  dfv_entry   the twin of scripts/4_aber_aware_dff_dfv_synth.py in this
              process on configs/aber_aware_dff_synth.yml and PNG scenes
              (as entry): a chunk of 2 epochs x 2 steps, a resumed chunk
              with --k-per-dispatch 2, --eval-only best.  Checks: the saved
              state reloads bit for bit, finite losses with none skipped,
              the 5 metrics finite, one B1 f32 launch per render and no
              PSF-MLP launch.  Reports step_ms per step beside dfv_train's,
              seconds per epoch and the validation forward ms
  thinlens    ThinLens.render of the render golden (within 2e-4) and
              render_stack against its frame loop (1e-6) on the card; the
              ms and memory of one [2,8,3,480,640] thin-lens stack (the tap
              loop); one chunk of each twin (AiF, DFV) under
              configs/aber_aware_dff_synth_thinlens.yml: no B1 launch in
              training, one per validation scene
  readers     the committed fixtures of tests/torch_assets/ against
              their manifest (cv2's decodes): each JPEG decodes to the same
              bytes, the progressive one is refused, each EXR gives the
              exact values; the host library's build (g++) and the decode
              ms of a 1280x1024 frame (median of 5)
  paper_config
              the paper's own configs, configs/aber_aware_dff_aif.yml and
              configs/aber_aware_dff_dfv.yml (Matterport3D -> Middlebury2014,
              bs 2, n_stack 8, 480x640, ks 11, lr 1e-4) through
              train/dff_aif.py:train and train/dff_dfv.py:train on the card:
              4 Matterport3D frames (the 1280x1024 JPEG fixtures, 16-bit
              depth PNGs) and 2 Middlebury2014 scenes, epochs cut to 1 (2
              passes of 2 steps, one validation).  Checks: finite losses and
              metrics, the checkpoints, one B1 f32 launch per render.
              Reports step_ms (CUDA events, render included), the loader's
              wait per step and a sample's host ms (JPEG, PNG, augmentation,
              resize)
  data_parallel
              data parallelism (aadff_tpu_torch/parallel/mesh.py) on the one
              card, TF32 off: the main configuration's AiF (D_FS) and DFV
              steps, 3 each from the trained checkpoints, first in this
              process at bs 2, then on 2 gloo ranks of 1 row each
              (torch.distributed.run of this script with --dp-worker
              steps); the ranks held to the one process (step 1 rtol 1e-4,
              3 steps 1e-3, BatchNorm statistics after step 1 within 1e-4
              of each tensor's largest value), their parameters
              bit-identical, one B1 launch per rank per step; per rank the
              step ms, peak memory and the gradient all-reduce's ms and
              bytes (gloo goes through the host: no forecast of NCCL across
              cards).  Then the dry-run twin, scripts/dryrun_multichip.py,
              under the launcher with 2 gloo ranks and with 1 NCCL rank,
              and the AiF paper config (epochs cut to 1, paper_config's
              fixtures) through train/dff_aif.py's config() and train() on
              2 gloo ranks: equal epoch losses on both, validation and
              checkpoints on rank 0 only, one B1 launch per render
  variants    AiFDepthNet's variants (stage2='direct', normalize_attention,
              n_classes=2 with disp_depth='disp', n_channels=4 with the
              stack index, remat) and the plain model from a seeded init:
              one train step (DA_FS) and one eval forward each at the main
              configuration through B1, all finite; remat's peak memory
              below the plain model's
  optics      the ray tracer on the card, both lens files
              (lenses/rf50mm.json, lenses/50mm_f2.8.json at 480x640):
              derived values, pupils, the trace of every wavelength and the
              refocus at 500 / 2,400 / 20,000 mm held to
              tests/goldens/optics_goldens.npz; psf_impl from the same
              draws and lens scalars on the card and on the CPU, held on
              the rays both keep (the kept-ray masks agree on > 99.9%;
              the whole-PSF difference reported beside it); PSF sums
  psf_fit     the twin of scripts/1_fit_psfnet.py in this process at its
              configuration (rf50mm, 480x640, ks 11, bs 128, spp 4096, lr
              1e-4 AdamW with the cosine schedule, warm start from the
              converted checkpoint), cut to 100 iterations: finite losses,
              the last 10 within 1.5x of the first 10, the saved weights
              reload equal; ms and kernels per iteration (CUDA events,
              torch.profiler), the device's idle share and peak memory;
              then one [2,8,3,480,640] stack through B1 f32 with the
              fitted weights, held to its plain version
  psf_gate    the twin of scripts/psf_gate.py on the converted checkpoint,
              20 foci x 10 z at spp 4096: L1 within 5% and L2 within 10%
              of PSF_GATE.json's record; its seconds
Each phase prints one JSON line with its elapsed seconds; then one
{"kernels": [...]} line, the card's name and power limit as nvidia-smi gives
them, and as the last line {"ok": true, "device": {...}}.  Any failed check
or exception exits non-zero; without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PSFNET_CKPT = os.path.join(ROOT, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
AIF_CKPT = os.path.join(ROOT, "ckpt", "dff_synth", "aifnet", "depth_net_best.msgpack")
DFV_CKPT = os.path.join(ROOT, "ckpt", "dff_synth", "dfvnet", "depth_net_best.msgpack")
RENDER_GOLDENS = os.path.join(ROOT, "tests", "goldens", "render_goldens.npz")
OPTICS_GOLDENS = os.path.join(ROOT, "tests", "goldens", "optics_goldens.npz")
LENS_FILES = {"rf50mm": os.path.join(ROOT, "lenses", "rf50mm.json"),
              "50mm_f2_8": os.path.join(ROOT, "lenses", "50mm_f2.8.json")}
PSF_GATE = os.path.join(ROOT, "PSF_GATE.json")
ASSETS = os.path.join(ROOT, "tests", "torch_assets")
MATTERPORT_FRAMES = ("frame_q95_420.jpg", "frame_q90_444.jpg")

BS, N_STACK, H, W, KS = 2, 8, 480, 640, 11   # configs/aber_aware_dff_{synth,dfv}.yml
LR, EPOCHS = 1e-4, 20
H2, W2 = 240, 320           # a stack off the sensor's size: the two-stage route
TRAIN_STEPS = 3
ENTRY_TRAIN, ENTRY_VAL = 4, 2   # scenes of the entry phase: 2 steps an epoch
# Kernel against plain version: both sum in f32 but in another order (the
# kernel's 11-layer GEMMs k by k, cuBLAS in blocks), which moves outputs in
# [0, 1] by a few 1e-7.  The same holds between the two render routes.
KERNEL_TOL = 1e-5
# bf16 kernel against its plain bf16 version: the same roundings, the f32
# sums in another order (and the tensor cores' own accumulation).  A sum
# next to a bf16 rounding boundary may round the other way and move every
# later layer: single values by up to ~2e-3, the mean by ~1e-7 on PSF rows
# and on smooth scenes, and by ~2e-6 on a frame of uniform noise, whose
# pixels do not cancel the PSF's errors.  So both a max-abs and a mean-abs
# bound.
BF16_MAX_ABS = 3e-3
BF16_MEAN_ABS = 5e-6
# bf16 against f32, on PSF rows (tests/test_pallas.py:42) and on the
# main-path stack.  A render of uniform noise amplifies the PSF's bf16
# deviation (the JAX package's own bf16 render of noise deviates by up to
# 6.8e-4 per pixel), so there it is reported and held only to differ.
L1_PX = 5e-4
LOOP_TOL = 1e-6             # frame loop vs stack: tests/test_pallas.py:247
ROWSUM_TOL = 1e-5           # PSF rows sum to 1: tests/test_pallas.py:22
GOLDEN_TOL = 2e-4           # tests/test_psfnet_render.py:143
BUDGET_S = 1000.0           # stop before the 1200 s the run may take
# data_parallel: gloo ranks on the one card, and each launch's time limit.
# The ranks against one process of this script on the same scenes from the
# same checkpoints (TF32 off): step 1 is one forward in f32 (the ranks'
# convolutions see one row, and BatchNorm takes Flax's E[x^2] - E[x]^2
# where one process takes torch's two-pass variance), later steps carry
# Adam's amplification of f32 noise (tests/test_torch_trainer.py), the
# statistics after step 1 as ROADMAP C holds them against JAX.
DP_RANKS, DP_TIMEOUT_S = 2, 300
DP_STEP1_RTOL, DP_RTOL, DP_STATS_TOL = 1e-4, 1e-3, 1e-4
# The tracer against optics_goldens.npz (tests/test_optics_core.py:100-148):
# derived values and pupils, ray endpoints on the rays valid in both (the
# masks agree on > 99.9%), and the refocus within its Monte-Carlo noise.
DERIVED_TOL = {"foclen": 1e-3, "fnum": 1e-3, "hfov": 1e-4, "d_sensor": 1e-9,
               "pupil": 1e-3}
TRACE_TOL = {"o": 1e-3, "d": 2e-5, "obliq": 1e-4}
REFOCUS_TOL = {"d_sensor": 2e-2, "hfov": 1e-3, "fnum": 2e-2}
PSF_CARD_VS_CPU = 1e-4      # psf_impl, same draws: the card against the CPU
# DFVNet eval outputs, the card against the CPU from the same weights (TF32
# off): 1e-4 of the largest value, the bound ROADMAP C holds them to
# against JAX (cuDNN and oneDNN sum the convolutions in other orders).
DFV_CARD_VS_CPU = 1e-4
FIT_ITERS, FIT_EVERY = 100, 50
GATE_TOL = {"avg_l1": 0.05, "avg_l2": 0.10}   # relative to PSF_GATE.json
F32_FLOPS = 67e12           # H100 SXM, f32 on the CUDA cores, 700 W
BF16_FLOPS = 989e12         # H100 SXM, bf16 on the tensor cores, dense
HBM_BYTES_S = 3.35e12
PEAK = {"f32": F32_FLOPS, "bf16": BF16_FLOPS}
WEIGHT_BYTES = {"f32": 4, "bf16": 2}
# The bf16 kernels' design, and their instantiations as ptxas names them.
BF16_DESIGN = ("wgmma stage: 2 consumer warpgroups (A in registers, turns on "
               "the tensor cores) + 1 producer, bulk-copy ring of 16 KB "
               "swizzled chunks")
BF16_KERNELS = ("fused_psf_render_wg<0>", "fused_psf_render_wg<1>", "mlp_psf_wg")
# The 'convonly' kernel (csrc/psf_conv.cu), as ptxas names it for ks = 11,
# and its design; its device time by torch.profiler over PROFILE_REPS
# launches, back to back (warm) and with FLUSH_BYTES written between
# launches (L2-cold: the H100's L2 holds 50 MB).
CONV_KERNEL = f"psf_conv_kernel<{KS}>"
CONV_DESIGN = ("128 threads on a 16x64 tile of one channel, 2x4 outputs a "
               "thread from 16-byte shared loads of ks+3 halo values a row; "
               "halo by 4-byte cp.async, edge-clamped; float4 depth and "
               "stores")
PROFILE_REPS = 50
FLUSH_BYTES = 64 << 20


class SmokeError(RuntimeError):
    pass


def check(cond, message):
    if not cond:
        raise SmokeError(message)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps):
    """Mean ms of `reps` calls after one warm-up, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(t_ops, t_bytes):
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _mlp_work(mlp, dt):
    """(multiply-adds per row, bytes of the weights and biases) in dt."""
    linears = mlp.linears()
    macs = sum(lin.in_features * lin.out_features for lin in linears)
    nbytes = sum(WEIGHT_BYTES[dt] * lin.weight.numel() + 4 * lin.bias.numel()
                 for lin in linears)
    return macs, nbytes


def render_bound_ms(mlp, N, S, C, H_, W_, ks, dt="f32", mode="full"):
    """Least time the card could take for one fused render: the larger of
    the operations over the peak of their type (the MLP in `dt`, the
    convolution in f32 on the CUDA cores) and the bytes over memory
    bandwidth (each input read once, the output written once).  'mlponly'
    has no convolution and reads no image; 'convonly' has no MLP."""
    macs, w_bytes = _mlp_work(mlp, dt)
    px = N * S * H_ * W_
    mlp_ops = 0 if mode == "convonly" else px * 2 * macs
    conv_ops = 0 if mode == "mlponly" else px * 2 * ks * ks * C
    nbytes = (4 * (N * H_ * W_ + N * S + N * S * C * H_ * W_)
              + (0 if mode == "mlponly" else 4 * N * C * H_ * W_)
              + (0 if mode == "convonly" else w_bytes))
    return _bound(mlp_ops / PEAK[dt] + conv_ops / F32_FLOPS,
                  nbytes / HBM_BYTES_S)


def mlp_bound_ms(mlp, N, dt="f32"):
    """Least time the card could take for the PSF MLP on N field rows: the
    larger of operations over the peak of `dt` and bytes over memory
    bandwidth (the field and the weights read once, the rows written once)."""
    macs, w_bytes = _mlp_work(mlp, dt)
    taps = mlp.linears()[-1].out_features
    return _bound(N * 2 * macs / PEAK[dt],
                  (4 * N * (4 + taps) + w_bytes) / HBM_BYTES_S)


def library_mlp_bf16(mlp):
    """One cuBLAS bf16 chain computing the PSF rows (bf16 in and out of each
    layer, the last layer cast to f32 for the sigmoid and the L1 norm): the
    yardstick `library_ms` of the bf16 PSF-MLP kernel, never used by the
    port."""
    import torch  # noqa: PLC0415

    params = [(lin.weight.to(torch.bfloat16), lin.bias.to(torch.bfloat16))
              for lin in mlp.linears()]

    def run(field):
        h = field.to(torch.bfloat16)
        for i, (w, b) in enumerate(params):
            h = torch.nn.functional.linear(h, w, b)
            if i + 1 < len(params):
                h = torch.relu(h)
        p = torch.sigmoid(h.float())
        return p / (p.abs().sum(-1, keepdim=True) + 1e-12)

    return run


def ptxas_report(log):
    """{kernel: {registers, spill_stores, spill_loads, warnings}} from
    nvcc's -Xptxas -v output; a kernel is named by its template and its
    integer template arguments (the f32 stage's geometry, the mode)."""
    def short(mangled):
        m = re.search(r"\d(fused_psf_render_wg|fused_psf_render_kernel|"
                      r"mlp_psf_wg|mlp_psf_kernel|psf_conv_kernel)(I.*?EEvP|EP)",
                      mangled)
        if not m:
            return mangled
        if m.group(2) == "EP":
            return m.group(1)
        return f"{m.group(1)}<{','.join(re.findall(r'Li(-?\d+)E', m.group(2)))}>"
    report, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            current = short(m.group(1))
            report.setdefault(current, {"warnings": {}})
            continue
        m = re.search(r"\((C\d+)\).*function '([^']+)'", ln)
        if m:
            warn = report.setdefault(short(m.group(2)), {"warnings": {}})["warnings"]
            warn[m.group(1)] = warn.get(m.group(1), 0) + 1
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and current:
            report[current].update(spill_stores=int(m.group(1)),
                                   spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and current:
            report[current]["registers"] = int(m.group(1))
    return report


def reset_counts(*modules):
    """Set every launch count of the kernel wrappers to 0."""
    for mod in modules:
        mod.launches = 0
        mod.variant_launches.clear()


def errors(out, ref):
    """max-abs and mean-abs of out - ref."""
    err = (out - ref).abs()
    return err.max().item(), err.mean().item()


def split_errors(vs_plain, vs_f32):
    """{case: (max, mean)} against the plain version and against the f32
    kernel -> the JSON fields of a bf16 phase."""
    return {"max_abs_err": {k: v[0] for k, v in vs_plain.items()},
            "mean_abs_err": {k: v[1] for k, v in vs_plain.items()},
            "vs_f32_max_abs": {k: v[0] for k, v in vs_f32.items()},
            "vs_f32_l1_px": {k: v[1] for k, v in vs_f32.items()}}


def write_scene_dirs(root, aif, depth):
    """Scenes in the SynthMiddlebury layout: <root>/scene<i>/im0.png (8-bit
    RGB) and depth.png (uint16, mm), from aif [n, 3, H, W] in [0, 1] and
    depth [n, 1, H, W] in m."""
    from aadff_tpu_torch.utils.image import write_png  # noqa: PLC0415

    rgb = (aif * 255).round().clamp(0, 255).byte().permute(0, 2, 3, 1).cpu().numpy()
    mm = (depth[:, 0] * 1000).round().clamp(0, 65535).cpu().numpy().astype("uint16")
    for i in range(rgb.shape[0]):
        d = os.path.join(root, f"scene{i}")
        os.makedirs(d)
        write_png(os.path.join(d, "im0.png"), rgb[i])
        write_png(os.path.join(d, "depth.png"), mm[i])
    return root


def write_run_config(tmp, name, make_scenes, gen, device):
    """configs/<name> with its two SynthMiddlebury paths pointing at
    ENTRY_TRAIN + ENTRY_VAL scenes of make_scenes written as PNGs under
    `tmp`, and its lens and checkpoint paths made absolute: (the config's
    path, the val scene dir)."""
    train_dir = write_scene_dirs(os.path.join(tmp, "train"),
                                 *make_scenes(ENTRY_TRAIN, H, W, gen, device))
    val_dir = write_scene_dirs(os.path.join(tmp, "val"),
                               *make_scenes(ENTRY_VAL, H, W, gen, device))
    with open(os.path.join(ROOT, "configs", name)) as f:
        text = f.read()
    for old, new in (("'./datasets/SynthMiddlebury/train'", repr(train_dir)),
                     ("'./datasets/SynthMiddlebury/val'", repr(val_dir)),
                     ("'./lenses/", repr(ROOT + "/lenses/")[:-1]),
                     ("'./ckpt/", repr(ROOT + "/ckpt/")[:-1])):
        check(old in text, f"{name} has no {old}")
        text = text.replace(old, new)
    config = os.path.join(tmp, name)
    with open(config, "w") as f:
        f.write(text)
    return config, val_dir


def state_equal(torch, a, b):
    """Whether two train states hold the same weights, statistics, Adam
    moments, counts and step, bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for x, y in zip(a.opt.mu + a.opt.nu,
                                                      b.opt.mu + b.opt.nu))
            and int(a.opt.count) == int(b.opt.count)
            and int(a.step) == int(b.step))


def read_json(path):
    with open(path) as f:
        return json.load(f)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_entry(torch, np, gen, device, make_scenes, trainer, fused_render,
              mlp_psf):
    """The entry phase: `configs/aber_aware_dff_synth.yml` with its two
    SynthMiddlebury paths pointing at ENTRY_TRAIN + ENTRY_VAL scenes written
    as PNGs, then the twin of scripts/3_aber_aware_dff_synth.py in this
    process: one chunk, a resumed chunk with 2 steps per call, --eval-only
    best, and a --bf16 chunk in a second workdir.  Returns the phase's
    fields; raises SmokeError on a failed check."""
    import shutil  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    from aadff_tpu_torch.dff.dataset import Middlebury  # noqa: PLC0415
    from aadff_tpu_torch.scripts import aber_aware_dff_synth as twin  # noqa: PLC0415
    from aadff_tpu_torch.utils.image import read_png  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="aadff_entry_")
    try:
        config, val_dir = write_run_config(tmp, "aber_aware_dff_synth.yml",
                                           make_scenes, gen, device)
        png_ms, scene_ms = [], []
        val_set = Middlebury(val_dir, resize=(H, W))
        for i, scene in enumerate(val_set.scenes):
            t = time.perf_counter()
            read_png(os.path.join(val_dir, scene, "im0.png"))
            read_png(os.path.join(val_dir, scene, "depth.png"))
            png_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            val_set[i]
            scene_ms.append(1e3 * (time.perf_counter() - t))

        wd, wd16 = os.path.join(tmp, "run"), os.path.join(tmp, "run_bf16")
        common = ["--config", config, "--total-epochs", "2",
                  "--epochs-per-chunk", "1"]
        torch.cuda.synchronize()
        reset_counts(fused_render, mlp_psf)
        secs = {}
        t = time.perf_counter()
        state1 = twin.main([*common, "--workdir", wd])
        secs["chunk"] = time.perf_counter() - t
        fresh = trainer.create_train_state(type(state1.model)().to(device), LR, 1)
        saved = trainer.load_checkpoint(wd, fresh, "state")
        resumed_equal = state_equal(torch, state1, saved)
        del state1, fresh, saved
        t = time.perf_counter()
        state2 = twin.main([*common, "--workdir", wd, "--k-per-dispatch", "2"])
        secs["resumed_chunk_k2"] = time.perf_counter() - t
        steps = int(state2.step)
        del state2
        t = time.perf_counter()
        twin.main(["--config", config, "--workdir", wd, "--eval-only", "best"])
        secs["eval_only"] = time.perf_counter() - t
        t = time.perf_counter()
        twin.main([*common, "--workdir", wd16, "--total-epochs", "1", "--bf16"])
        secs["bf16_chunk"] = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = dict(fused_render.variant_launches)
        mlp_launches = mlp_psf.launches

        with open(os.path.join(wd, "progress.json")) as f:
            progress = json.load(f)
        logs = read_jsonl(os.path.join(wd, "train_log.jsonl"))
        logs16 = read_jsonl(os.path.join(wd16, "train_log.jsonl"))
        val = read_jsonl(os.path.join(wd, "metrics.jsonl"))
        val16 = read_jsonl(os.path.join(wd16, "metrics.jsonl"))
        final_path = os.path.join(wd, "eval_final.json")
        check(os.path.exists(final_path), "no eval_final.json")
        with open(final_path) as f:
            final = json.load(f)
        # a render per train step and per validation scene of each validation
        renders = (sum(r["steps"] for r in logs + logs16)
                   + ENTRY_VAL * (len(val) + len(val16) + 1))
        metric_keys = ("abs_rel", "sq_rel", "mse", "mae", "rmse", "rmse_log",
                       "acc1", "acc2", "acc3", "psnr", "ssim")
        fields = {
            "config": "configs/aber_aware_dff_synth.yml", "scenes": {
                "train": ENTRY_TRAIN, "val": ENTRY_VAL, "res": [H, W]},
            "progress": progress, "steps": steps,
            "train_log": [{k: r[k] for k in ("epoch", "loss", "steps", "skipped",
                                             "sec")} for r in logs],
            "step_ms": [r["step_ms"] for r in logs],
            "bf16_train_log": [{k: r[k] for k in ("epoch", "loss", "steps",
                                                  "skipped", "sec")}
                               for r in logs16],
            "bf16_step_ms": [r["step_ms"] for r in logs16],
            "val": val, "eval_final": final,
            "val_forward_ms": [1e3 * m["avg_time"] for m in val + [final]],
            "png_read_ms_per_scene": png_ms,
            "dataset_item_ms_per_scene": scene_ms,
            "run_s": secs, "resumed_equal": resumed_equal,
            "launches": launches, "mlp_psf_launches": mlp_launches,
            "expected_renders": renders,
        }
        check(progress["epoch"] == 2 and steps == 4,
              f"progress {progress}, {steps} steps")
        check(resumed_equal, "the resumed state differs from the saved one")
        for r in logs + logs16:
            check(np.isfinite(r["loss"]) and r["skipped"] == 0,
                  f"train epoch {r['epoch']}: loss {r['loss']}, "
                  f"{r['skipped']} skipped")
        for m in val + val16 + [final]:
            check(all(np.isfinite(m[k]) for k in metric_keys),
                  f"non-finite validation metrics {m}")
        check(launches == {"stack/f32/full": renders} and mlp_launches == 0,
              f"entry launches {launches}, expected {renders} stack/f32/full")
        return fields
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_dfv_entry(torch, gen, device, make_scenes, trainer, fused_render,
                  mlp_psf, procedural_step_ms):
    """The dfv_entry phase: `configs/aber_aware_dff_synth.yml` on PNG
    scenes, then the twin of scripts/4_aber_aware_dff_dfv_synth.py in this
    process: one chunk of 2 epochs, a resumed chunk with 2 steps per call,
    --eval-only best.  Returns the phase's fields; raises SmokeError on a
    failed check."""
    import math  # noqa: PLC0415
    import shutil  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    from aadff_tpu_torch.dff.focus import select_focus_dist  # noqa: PLC0415
    from aadff_tpu_torch.models.dfv.dffnet import DFVNet  # noqa: PLC0415
    from aadff_tpu_torch.scripts import aber_aware_dff_dfv_synth as twin  # noqa: PLC0415
    from aadff_tpu_torch.train import dff_dfv  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="aadff_dfv_entry_")
    try:
        config, _ = write_run_config(tmp, "aber_aware_dff_synth.yml",
                                     make_scenes, gen, device)
        wd = os.path.join(tmp, "run")
        common = ["--config", config, "--workdir", wd, "--total-epochs", "3"]
        torch.cuda.synchronize()
        reset_counts(fused_render, mlp_psf)
        secs = {}
        t = time.perf_counter()
        state1 = twin.main([*common, "--epochs-per-chunk", "2"])
        secs["chunk_2_epochs"] = time.perf_counter() - t
        fresh = trainer.create_train_state(DFVNet().to(device), LR, 1)
        resumed_equal = state_equal(torch, state1,
                                    trainer.load_checkpoint(wd, fresh, "state"))
        del state1, fresh
        t = time.perf_counter()
        state = twin.main([*common, "--epochs-per-chunk", "1",
                           "--k-per-dispatch", "2"])
        secs["resumed_chunk_k2"] = time.perf_counter() - t
        t = time.perf_counter()
        twin.main(["--config", config, "--workdir", wd, "--eval-only", "best"])
        secs["eval_only"] = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = dict(fused_render.variant_launches)
        mlp_launches = mlp_psf.launches
        steps = int(state.step)

        # the validation forward alone: one [1, 8, H, W] stack, eval mode
        _, depth = make_scenes(1, H, W, gen, device)
        focus = select_focus_dist(depth, N_STACK, mode="linear")
        stack = torch.rand(1, N_STACK, H, W, 3, generator=gen, device=device)
        eval_step = dff_dfv.make_dfv_eval_step()
        val_forward_ms = time_ms(torch, lambda: eval_step(state, stack, focus), 3)
        del state, stack

        with open(os.path.join(wd, "progress.json")) as f:
            progress = json.load(f)
        logs = read_jsonl(os.path.join(wd, "train_log.jsonl"))
        val = read_jsonl(os.path.join(wd, "metrics.jsonl"))
        with open(os.path.join(wd, "eval_final.json")) as f:
            final = json.load(f)
        # a render per train step and per validation scene of each validation
        renders = sum(r["steps"] for r in logs) + ENTRY_VAL * (len(val) + 1)
        fields = {
            "config": "configs/aber_aware_dff_synth.yml", "model": "DFVNet(level=2, use_diff=1)",
            "scenes": {"train": ENTRY_TRAIN, "val": ENTRY_VAL, "res": [H, W]},
            "progress": progress, "steps": steps,
            "train_log": [{k: r[k] for k in ("epoch", "loss", "steps", "skipped",
                                             "sec")} for r in logs],
            "step_ms": [r["step_ms"] for r in logs],
            "procedural_dfv_step_ms": procedural_step_ms,
            "sec_per_epoch": [r["sec"] for r in logs],
            "val": val, "eval_final": final, "val_forward_ms": val_forward_ms,
            "run_s": secs, "resumed_equal": resumed_equal,
            "launches": launches, "mlp_psf_launches": mlp_launches,
            "expected_renders": renders,
        }
        check(progress["epoch"] == 3 and steps == 6,
              f"progress {progress}, {steps} steps")
        check(resumed_equal, "the resumed DFV state differs from the saved one")
        for r in logs:
            check(math.isfinite(r["loss"]) and r["skipped"] == 0
                  and len(r["step_ms"]) == r["steps"],
                  f"DFV train epoch {r['epoch']}: loss {r['loss']}, "
                  f"{r['skipped']} skipped")
        for m in val:
            check(all(math.isfinite(m[k]) for k in dff_dfv.METRICS),
                  f"non-finite DFV metrics {m}")
        check(all(math.isfinite(final[k]) for k in ("abs_rel", "mse", "rmse", "acc1")),
              f"non-finite eval_final {final}")
        check(launches == {"stack/f32/full": renders} and mlp_launches == 0,
              f"dfv_entry launches {launches}, expected {renders} stack/f32/full")
        return fields
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_readers(np):
    """The readers phase: the committed fixtures of tests/torch_assets/
    against their manifest (cv2's decodes, recorded on a machine with
    OpenCV): each JPEG decodes to the same bytes, the progressive one is
    refused, each EXR gives the exact values; the host library's build, and
    the decode ms of each 1280x1024 frame (median of 5)."""
    import hashlib  # noqa: PLC0415
    import statistics  # noqa: PLC0415

    from aadff_tpu_torch.utils import _host_build  # noqa: PLC0415
    from aadff_tpu_torch.utils.image import read_exr, read_jpeg  # noqa: PLC0415

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    t = time.perf_counter()
    built = _host_build.build()
    fields = {"compiler": _host_build.compiler(), "built": built["built"],
              "build_s": time.perf_counter() - t, "jpeg": {}, "exr": {}}
    with open(os.path.join(ASSETS, "manifest.json")) as f:
        manifest = json.load(f)
    for name, rec in manifest["jpeg"].items():
        path = os.path.join(ASSETS, name)
        if rec["progressive"]:
            try:
                read_jpeg(path)
                refused = None
            except NotImplementedError as e:
                refused = str(e)
            fields["jpeg"][name] = {"refused": refused}
            check(refused is not None and name in refused,
                  f"{name}: the progressive file was not refused ({refused})")
            continue
        img = read_jpeg(path)
        ms = []
        for _ in range(5):
            t = time.perf_counter()
            read_jpeg(path)
            ms.append(1e3 * (time.perf_counter() - t))
        fields["jpeg"][name] = {"shape": list(img.shape), "equal": sha(img) == rec["sha256"],
                                "decode_ms_median": statistics.median(ms),
                                "decode_ms": ms}
        check(fields["jpeg"][name]["equal"] and list(img.shape) == rec["shape"],
              f"{name}: the decode differs from cv2's")
    for name, rec in manifest["exr"].items():
        out = read_exr(os.path.join(ASSETS, name))
        ok = (sha(out) == rec["sha256"] and list(out.shape) == rec["shape"]
              and str(out.dtype) == rec["dtype"])
        fields["exr"][name] = {"shape": list(out.shape), "dtype": str(out.dtype),
                               "exact": ok}
        check(ok, f"{name}: values differ from the manifest's")
    return fields


def write_matterport(root, gen, device, make_scenes):
    """Matterport3D's layout: ENTRY_TRAIN frames over 2 scenes,
    <root>/aif/<scene>/undistorted_color_images/*.jpg (the two 1280x1024
    fixtures, copied) and <root>/depth/<scene>/render_depth/*.png (uint16,
    make_scenes depth x 4000)."""
    import shutil  # noqa: PLC0415

    from aadff_tpu_torch.utils.image import write_png  # noqa: PLC0415

    _, depth = make_scenes(ENTRY_TRAIN, 1024, 1280, gen, device)
    units = (depth[:, 0] * 4000).round().clamp(0, 65535).cpu().numpy().astype("uint16")
    for i in range(ENTRY_TRAIN):
        scene = f"scene{i // 2}"
        rgb = os.path.join(root, "aif", scene, "undistorted_color_images")
        dep = os.path.join(root, "depth", scene, "render_depth")
        os.makedirs(rgb, exist_ok=True)
        os.makedirs(dep, exist_ok=True)
        shutil.copy(os.path.join(ASSETS, MATTERPORT_FRAMES[i % 2]),
                    os.path.join(rgb, f"frame{i % 2}.jpg"))
        write_png(os.path.join(dep, f"frame{i % 2}.png"), units[i])
    return os.path.join(root, "aif"), os.path.join(root, "depth")


def sample_host_ms(np, aif_path, depth_path):
    """A Matterport3D training sample's host ms, step by step as
    `Matterport3D.__getitem__` takes them: JPEG decode, PNG decode,
    augmentation (a draw that rotates and one that does not) and the two
    resizes to 480x640; each the median of 3."""
    import statistics  # noqa: PLC0415

    from aadff_tpu_torch.dff.dataset import auto_augment  # noqa: PLC0415
    from aadff_tpu_torch.utils.image import imread_color, read_png, resize_hw  # noqa: PLC0415

    def ms(fn):
        out = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t))
        return statistics.median(out)

    aif = imread_color(aif_path) / 255.0
    depth = read_png(depth_path) / 4000

    def rotates(seed):
        """Whether auto_augment's draws from RandomState(seed) rotate: a
        contrast draw (two more on success), two flips, then the rotation."""
        r = np.random.RandomState(seed)
        if r.rand() > 0.5:
            r.rand(), r.rand()
        r.rand(), r.rand()
        return r.rand() > 0.5

    seeds = {}
    for seed in range(50):
        seeds.setdefault(rotates(seed), seed)
    return {
        "jpeg_decode_ms": ms(lambda: imread_color(aif_path)),
        "png_decode_ms": ms(lambda: read_png(depth_path)),
        "augment_rotating_ms": ms(lambda: auto_augment(
            aif, depth, np.random.RandomState(seeds[True]))),
        "augment_not_rotating_ms": ms(lambda: auto_augment(
            aif, depth, np.random.RandomState(seeds[False]))),
        "resize_ms": ms(lambda: (resize_hw(aif.astype(np.float32), (H, W)),
                                 resize_hw(depth.astype(np.float32), (H, W)))),
    }


class LogRecords:
    """A logging handler that keeps the messages of the root logger's
    INFO records while it is attached."""

    def __init__(self):
        import logging  # noqa: PLC0415

        self.messages = []
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = lambda r: self.messages.append(r.getMessage())
        self.root = logging.getLogger()

    def __enter__(self):
        import logging  # noqa: PLC0415

        self.level = self.root.level
        self.root.setLevel(logging.INFO)
        self.root.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.root.removeHandler(self.handler)
        self.root.setLevel(self.level)


def write_paper_config(tmp, family, gen, device, make_scenes):
    """configs/aber_aware_dff_<family>.yml with its data paths pointed at a
    Matterport3D layout of ENTRY_TRAIN frames and a Middlebury2014 layout of
    ENTRY_VAL scenes under `tmp`, and its lens and checkpoint paths made
    absolute: (the config's path, the aif dir, the depth dir)."""
    aif_dir, depth_dir = write_matterport(os.path.join(tmp, "mp"), gen, device,
                                          make_scenes)
    val_dir = write_scene_dirs(os.path.join(tmp, "Middlebury2014"),
                               *make_scenes(ENTRY_VAL, H, W, gen, device))
    name = f"aber_aware_dff_{family}.yml"
    with open(os.path.join(ROOT, "configs", name)) as f:
        text = f.read()
    for old, new in (("'./dataset/Matterport3D/train/aif'", repr(aif_dir)),
                     ("'./dataset/Matterport3D/train/depth'", repr(depth_dir)),
                     ("'./dataset/Middlebury2014'", repr(val_dir)),
                     ("'./lenses/", repr(ROOT + "/lenses/")[:-1]),
                     ("'./ckpt/", repr(ROOT + "/ckpt/")[:-1])):
        check(old in text, f"{name} has no {old}")
        text = text.replace(old, new)
    config = os.path.join(tmp, name)
    with open(config, "w") as f:
        f.write(text)
    return config, aif_dir, depth_dir


def parse_train_log(messages):
    """(the epoch losses, {metric: value}) that train/dff_*.py logged."""
    losses = [float(m.group(1)) for m in map(
        re.compile(r"epoch \d+: loss (\S+)").fullmatch, messages) if m]
    metrics = {}
    for m in map(re.compile(r"Avg_(\w+)\(\d+\): (\S+)").fullmatch, messages):
        if m:
            metrics[m.group(1)] = float(m.group(2))
    return losses, metrics


def run_paper_config(torch, np, gen, device, make_scenes, fused_render, mlp_psf,
                     family):
    """The paper_config phase for one family ("aif" or "dfv"):
    configs/aber_aware_dff_<family>.yml as the paper runs it (Matterport3D
    -> Middlebury2014, bs 2, n_stack 8, 480x640, ks 11, lr 1e-4), its data
    paths pointed at a Matterport3D layout of ENTRY_TRAIN frames (the
    1280x1024 JPEG fixtures, 16-bit depth) and a Middlebury2014 layout of
    ENTRY_VAL scenes, and its epochs cut to 1 (two passes of 2 steps around
    one validation); `train/dff_<family>.py:train` on the card in this
    process.  Checks: finite losses and metrics, the checkpoints, and one B1
    f32 launch per render (train steps and validation scenes).  Reports the
    steps' ms (CUDA events, render included), the loader's wait per step
    and a sample's host ms split.  Returns the phase's fields."""
    import math  # noqa: PLC0415
    import shutil  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    from aadff_tpu_torch.train import dff_aif, dff_dfv  # noqa: PLC0415
    from aadff_tpu_torch.train.trainer import VAL_METRICS, StepTimer  # noqa: PLC0415
    from aadff_tpu_torch.utils.config import load_config  # noqa: PLC0415

    module = {"aif": dff_aif, "dfv": dff_dfv}[family]
    name = f"aber_aware_dff_{family}.yml"
    tmp = tempfile.mkdtemp(prefix=f"aadff_paper_{family}_")
    try:
        config, aif_dir, depth_dir = write_paper_config(tmp, family, gen, device,
                                                        make_scenes)
        args = load_config(config)
        check((args["train"]["dataset"], args["test"]["dataset"], args["bs"],
               args["n_stack"], tuple(args["res"]), args["ks"], float(args["lr"]))
              == ("Matterport3D", "Middlebury2014", BS, N_STACK, (H, W), KS, LR),
              f"{name}: {args}")
        args["epochs"] = 1
        args["results_dir"] = os.path.join(tmp, "run")
        host = sample_host_ms(np, os.path.join(aif_dir, "scene0", "undistorted_color_images",
                                               "frame0.jpg"),
                              os.path.join(depth_dir, "scene0", "render_depth", "frame0.png"))
        timer = StepTimer(device)
        np.random.seed(126)  # as the entry's config() seeds the augmentation
        torch.cuda.synchronize()
        reset_counts(fused_render, mlp_psf)
        t = time.perf_counter()
        with LogRecords() as log:
            state = module.train(args, device=str(device), timer=timer)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        launches = dict(fused_render.variant_launches)
        mlp_launches = mlp_psf.launches
        step_ms = timer.step_ms()
        steps = int(state.step)
        del state

        losses, metrics = parse_train_log(log.messages)
        keys = VAL_METRICS if family == "aif" else dff_dfv.METRICS
        renders = steps + ENTRY_VAL
        fields = {
            "config": f"configs/{name}", "data": {
                "train": f"Matterport3D, {ENTRY_TRAIN} JPEG frames 1024x1280 "
                         f"({', '.join(MATTERPORT_FRAMES)})",
                "val": f"Middlebury2014 layout, {ENTRY_VAL} scenes {H}x{W}",
                "res": [H, W]},
            "epochs": 1, "steps": steps, "epoch_losses": losses, "val": metrics,
            "step_ms": step_ms, "step_ms_after_first": step_ms[1:],
            "loader_wait_ms": timer.waits, "run_s": run_s,
            "sample_host_ms": host, "launches": launches,
            "mlp_psf_launches": mlp_launches, "expected_renders": renders,
            "checkpoints": sorted(f for f in os.listdir(args["results_dir"])
                                  if f.endswith(".pt")),
        }
        check(steps == 2 * (ENTRY_TRAIN // BS) and len(step_ms) == steps,
              f"{name}: {steps} steps, {len(step_ms)} timed")
        check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
              f"{name}: epoch losses {losses}")
        check(set(keys) <= set(metrics) and all(math.isfinite(metrics[k]) for k in keys),
              f"{name}: metrics {metrics}")
        check("depth_net_last.pt" in fields["checkpoints"], f"{name}: no checkpoint")
        check(launches == {"stack/f32/full": renders} and mlp_launches == 0,
              f"{name}: launches {launches}, expected {renders} stack/f32/full")
        return fields
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_launcher(nproc, target, timeout=DP_TIMEOUT_S, errors_dir=None):
    """`python -m torch.distributed.run --standalone --nproc_per_node nproc
    *target` from the repository root, in a process group of its own that
    is killed, with every process the launcher started, if it outlasts
    `timeout`.  A failure reports the ranks' rank<r>.err files in
    `errors_dir`.  Returns (its stdout, its seconds)."""
    import signal  # noqa: PLC0415

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *target]
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err = f"ran over {timeout} s\n{err}"
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    if proc.returncode != 0:
        ranks = "".join(
            f"--- {name}\n{open(os.path.join(errors_dir, name)).read()}"
            for name in sorted(os.listdir(errors_dir or "."))
            if errors_dir and name.endswith(".err"))
        raise SmokeError(f"{' '.join(cmd[2:])} exited {proc.returncode}:\n"
                         f"{ranks or err[-6000:]}")
    return out, time.perf_counter() - t


def dp_family(torch, family, device, trainer):
    """The main configuration's model of `family` ("aif": AiFDepthNet on
    task D_FS; "dfv": DFVNet level 2) from its trained checkpoint, and its
    train step step(state, stack, focus, depth, aif) -> losses."""
    from aadff_tpu_torch.models.aifnet import AiFDepthNet  # noqa: PLC0415
    from aadff_tpu_torch.models.convert import load_flax_aifnet  # noqa: PLC0415
    from aadff_tpu_torch.models.dfv.convert import load_flax_dfvnet  # noqa: PLC0415
    from aadff_tpu_torch.models.dfv.dffnet import DFVNet  # noqa: PLC0415
    from aadff_tpu_torch.train import dff_dfv  # noqa: PLC0415

    if family == "aif":
        model = AiFDepthNet()
        model.load_state_dict(load_flax_aifnet(AIF_CKPT)[0])
        return model.to(device), trainer.make_aif_train_step("D_FS")
    model = DFVNet(clean=False, level=2, use_diff=1)
    model.load_state_dict(load_flax_dfvnet(DFV_CKPT)[0])
    step = dff_dfv.make_dfv_train_step()
    return model.to(device), (lambda state, stack, focus, depth, aif:
                              step(state, stack, focus, depth))


def dp_steps(torch, scenes, lens, device):
    """TRAIN_STEPS steps of each family from its checkpoint on `scenes`
    ([(aif, depth)] global batches on the CPU), each step rendering its
    stack through `lens` (B1): this rank's rows under an active mesh, all
    of them in one process.  Returns ({family: losses, step ms, BatchNorm
    statistics after step 1, parameter digest, peak GiB, and on several
    ranks the gradient all-reduce's ms and bytes}, statistics)."""
    import hashlib  # noqa: PLC0415

    from aadff_tpu_torch.dff.focus import select_focus_dist  # noqa: PLC0415
    from aadff_tpu_torch.parallel import mesh  # noqa: PLC0415
    from aadff_tpu_torch.train import trainer  # noqa: PLC0415

    out, stats = {}, {}
    for family in ("aif", "dfv"):
        model, step = dp_family(torch, family, device, trainer)
        mesh.replicate(model)
        state = trainer.create_train_state(model, LR, EPOCHS * TRAIN_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"losses": [], "step_ms": []}
        for i, scene in enumerate(scenes):
            aif, depth = (t.to(device) for t in mesh.shard_batch(*scene))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            focus = select_focus_dist(depth, N_STACK, mode="linear")
            stack = trainer.render_focal_stack(lens, aif, depth, focus)
            losses = step(state, stack, focus, depth, aif)
            ev[1].record()
            torch.cuda.synchronize()
            rec["losses"].append({k: float(v) for k, v in losses.items()})
            rec["step_ms"].append(ev[0].elapsed_time(ev[1]))
            if i == 0:
                stats[family] = {k: v.to("cpu", copy=True)
                                 for k, v in model.state_dict().items()
                                 if "running" in k}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        rec["params_sha256"] = digest.hexdigest()
        if mesh.distributed():
            # the step's one all-reduce: the gradients and the losses
            flat = [torch.zeros_like(p) for p in state.opt.params]
            flat.append(torch.zeros(len(rec["losses"][0]) - 1, device=device))
            ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                mesh.barrier()
                t = time.perf_counter()
                mesh.mean_over_ranks(flat)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
            rec["grad_allreduce_ms"] = ms
            rec["grad_allreduce_bytes"] = sum(4 * f.numel() for f in flat)
        out[family] = rec
        del model, state
    return out, stats


def dp_paper(torch, device, workdir, config):
    """The AiF paper config through train/dff_aif.py's config() and train()
    on this rank, epochs cut to 1, from `workdir` (config() writes
    ./results/<date>-AberAware_DFF_AiFNet there): the rank's fields."""
    from aadff_tpu_torch.ops import fused_render, mlp_psf  # noqa: PLC0415
    from aadff_tpu_torch.train import dff_aif  # noqa: PLC0415
    from aadff_tpu_torch.train.trainer import StepTimer  # noqa: PLC0415

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        args = dff_aif.config(config)
        args["epochs"] = 1
        timer = StepTimer(device)
        reset_counts(fused_render, mlp_psf)
        t = time.perf_counter()
        with LogRecords() as log:
            state = dff_aif.train(args, device=str(device), timer=timer)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        results = os.path.join(workdir, args["results_dir"])
    finally:
        os.chdir(cwd)
    losses, metrics = parse_train_log(log.messages)
    return {"num_devices": args["num_devices"], "steps": int(state.step),
            "epoch_losses": losses, "val": metrics, "step_ms": timer.step_ms(),
            "loader_wait_ms": timer.waits, "run_s": run_s,
            "launches": dict(fused_render.variant_launches),
            "mlp_psf_launches": mlp_psf.launches,
            "checkpoints": sorted(f for f in os.listdir(results)
                                  if f.endswith(".pt")),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def dp_worker(args):
    """One rank of a data_parallel launch (`--dp-worker steps|paper`,
    started by torch.distributed.run on the one card through gloo): writes
    <dp-dir>/rank<r>.json, and for `steps` rank<r>_stats.pt."""
    import torch

    from aadff_tpu_torch.ops import fused_render, mlp_psf
    from aadff_tpu_torch.parallel import mesh
    from aadff_tpu_torch.psfnet.psfnet import PSFNet

    rank = int(os.environ["RANK"])
    try:
        m = mesh.setup("gloo", "cuda:0")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if args.dp_worker == "steps":
            lens = PSFNet(kernel_size=KS, sensor_res=(H, W), device=m.device)
            lens.load_net(PSFNET_CKPT)
            scenes = torch.load(os.path.join(args.dp_dir, "scenes.pt"))
            reset_counts(fused_render, mlp_psf)
            out, stats = dp_steps(torch, scenes, lens, m.device)
            out["launches"] = dict(fused_render.variant_launches)
            out["mlp_psf_launches"] = mlp_psf.launches
            torch.save(stats, os.path.join(args.dp_dir, f"rank{m.rank}_stats.pt"))
        else:
            out = dp_paper(torch, m.device, args.dp_dir, args.config)
        out.update(rank=m.rank, world=m.size, backend=m.backend,
                   device=str(m.device))
        with open(os.path.join(args.dp_dir, f"rank{m.rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        import traceback  # noqa: PLC0415

        with open(os.path.join(args.dp_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        mesh.teardown()
    return 0


def run_data_parallel(torch, gen, device, make_scenes, lens, fused_render,
                      mlp_psf):
    """The data_parallel phase on the one card, TF32 off.  Returns (the
    phase's fields, B1 launches by run)."""
    import shutil  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    from aadff_tpu_torch.train.trainer import VAL_METRICS  # noqa: PLC0415

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="aadff_dp_")
    me = os.path.join(ROOT, "chip_smoke.py")
    fields, launches = {"ranks": DP_RANKS, "backend": "gloo", "tf32": False}, {}
    try:
        # the main configuration's steps: one process, then 2 ranks
        scenes = [tuple(t.cpu() for t in make_scenes(BS, H, W, gen, device))
                  for _ in range(TRAIN_STEPS)]
        steps_dir = os.path.join(tmp, "steps")
        os.makedirs(steps_dir)
        torch.save(scenes, os.path.join(steps_dir, "scenes.pt"))
        ref, ref_stats = dp_steps(torch, scenes, lens, device)
        torch.cuda.empty_cache()
        _, seconds = run_launcher(DP_RANKS, [me, "--dp-worker", "steps",
                                             "--dp-dir", steps_dir],
                                  errors_dir=steps_dir)
        ranks = [read_json(os.path.join(steps_dir, f"rank{r}.json"))
                 for r in range(DP_RANKS)]
        stats = [torch.load(os.path.join(steps_dir, f"rank{r}_stats.pt"))
                 for r in range(DP_RANKS)]
        steps = {"launcher_s": seconds, "one_process": ref, "tol": {
            "step1_rtol": DP_STEP1_RTOL, "rtol": DP_RTOL, "stats": DP_STATS_TOL}}
        for family in ("aif", "dfv"):
            theirs = [x["total"] for x in ref[family]["losses"]]
            dev = {}
            for r, rank in enumerate(ranks):
                ours = [x["total"] for x in rank[family]["losses"]]
                rel = [abs(a - b) / abs(b) for a, b in zip(ours, theirs)]
                st = max(float((v - ref_stats[family][k]).abs().max()
                               / ref_stats[family][k].abs().max().clamp(min=1e-6))
                         for k, v in stats[r][family].items())
                dev[f"rank{r}"] = {"loss_rel": rel, "stats_rel": st}
                check(rel[0] <= DP_STEP1_RTOL and max(rel) <= DP_RTOL,
                      f"data_parallel {family} rank {r}: losses {ours} against "
                      f"one process {theirs}")
                check(st <= DP_STATS_TOL, f"data_parallel {family} rank {r}: "
                                          f"BatchNorm statistics {st:.3g} apart")
                check(all(x["skipped_nonfinite"] == 0.0
                          for x in rank[family]["losses"]),
                      f"data_parallel {family} rank {r} skipped a step")
            check(len({rank[family]["params_sha256"] for rank in ranks}) == 1,
                  f"data_parallel {family}: the ranks' parameters differ")
            steps[family] = {"vs_one_process": dev, "ranks": [
                {k: rank[family][k] for k in ("losses", "step_ms", "peak_gib",
                                              "grad_allreduce_ms",
                                              "grad_allreduce_bytes")}
                for rank in ranks]}
        for r, rank in enumerate(ranks):
            check(rank["launches"] == {"stack/f32/full": 2 * TRAIN_STEPS}
                  and rank["mlp_psf_launches"] == 0,
                  f"data_parallel rank {r} launches {rank['launches']}")
        launches["steps"] = [rank["launches"]["stack/f32/full"] for rank in ranks]
        fields["steps"] = steps

        # the dry-run twin through the launcher: 2 gloo ranks, 1 NCCL rank
        for name, nproc, flags in (("gloo", DP_RANKS, ["--backend", "gloo",
                                                       "--device", "cuda:0"]),
                                   ("nccl", 1, [])):
            report = os.path.join(tmp, f"dryrun_{name}")
            os.makedirs(report)
            out, seconds = run_launcher(nproc, [
                "-m", "aadff_tpu_torch.scripts.dryrun_multichip", *flags,
                "--report", report])
            line = [x for x in out.splitlines() if x.startswith("dryrun_multichip(")]
            reps = [read_json(os.path.join(report, f"rank{r}.json"))
                    for r in range(nproc)]
            check(len(line) == 1 and line[0].startswith(
                f"dryrun_multichip({nproc}): ok, loss="), f"dryrun {name}: {out}")
            for r, rep in enumerate(reps):
                check(rep["world"] == nproc and rep["backend"] == name
                      and rep["launches"] == {"stack/f32/full": 1}
                      and rep["loss"] == reps[0]["loss"],
                      f"dryrun {name} rank {r}: {rep}")
            fields[f"dryrun_{name}"] = {"line": line[0], "launcher_s": seconds,
                                        "ranks": reps}
            launches[f"dryrun_{name}"] = [1] * nproc

        # the AiF paper config on 2 ranks
        paper_dir = os.path.join(tmp, "paper")
        os.makedirs(paper_dir)
        config, _, _ = write_paper_config(paper_dir, "aif", gen, device,
                                          make_scenes)
        _, seconds = run_launcher(DP_RANKS, [me, "--dp-worker", "paper",
                                             "--dp-dir", paper_dir,
                                             "--config", config],
                                  errors_dir=paper_dir)
        ranks = [read_json(os.path.join(paper_dir, f"rank{r}.json"))
                 for r in range(DP_RANKS)]
        steps = 2 * (ENTRY_TRAIN // BS)
        for r, rank in enumerate(ranks):
            renders = steps + (ENTRY_VAL if r == 0 else 0)
            check(rank["num_devices"] == DP_RANKS and rank["steps"] == steps
                  and len(rank["step_ms"]) == steps,
                  f"paper config rank {r}: {rank['steps']} steps")
            check(len(rank["epoch_losses"]) == 2
                  and rank["epoch_losses"] == ranks[0]["epoch_losses"]
                  and all(math.isfinite(x) for x in rank["epoch_losses"]),
                  f"paper config rank {r}: epoch losses {rank['epoch_losses']}")
            check(rank["launches"] == {"stack/f32/full": renders}
                  and rank["mlp_psf_launches"] == 0,
                  f"paper config rank {r}: launches {rank['launches']}, "
                  f"expected {renders}")
        check(set(VAL_METRICS) <= set(ranks[0]["val"]) and all(
            math.isfinite(ranks[0]["val"][k]) for k in VAL_METRICS)
            and ranks[1]["val"] == {}, "paper config: validation on rank 0 only")
        check("depth_net_last.pt" in ranks[0]["checkpoints"]
              and ranks[0]["checkpoints"] == ranks[1]["checkpoints"],
              f"paper config checkpoints {[x['checkpoints'] for x in ranks]}")
        fields["paper_config_aif"] = {"config": "configs/aber_aware_dff_aif.yml",
                                      "epochs": 1, "launcher_s": seconds,
                                      "ranks": ranks}
        launches["paper_config_aif"] = [rank["launches"]["stack/f32/full"]
                                        for rank in ranks]
        fields["note"] = ("gloo carries every collective through the host: "
                          "these times say nothing of NCCL across cards")
        fields["launches"] = launches
        return fields, launches
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)


VARIANTS = {"plain": {}, "direct": {"stage2": "direct"},
            "normalize_attention": {"normalize_attention": True},
            "two_classes_disp": {"n_classes": 2, "disp_depth": "disp"},
            "four_channels": {"n_channels": 4}, "remat": {"remat": True}}


def run_variants(torch, gen, device, make_scenes, lens, trainer, fused_render,
                 mlp_psf):
    """The variants phase: AiFDepthNet's variants (and the plain model) from
    a seeded init, one train step (DA_FS: every loss term) and one eval
    forward each at the main configuration through B1.  Returns (the
    phase's fields, B1 launches)."""
    from aadff_tpu_torch.dff.focus import select_focus_dist  # noqa: PLC0415
    from aadff_tpu_torch.models.aifnet import (AiFDepthNet,  # noqa: PLC0415
                                               add_stack_index_channel)

    (aif, depth), (aif2, depth2) = (make_scenes(BS, H, W, gen, device)
                                    for _ in range(2))
    eval_step = trainer.make_aif_eval_step()
    fields = {"task": "DA_FS", "aif_w": 1.0, "smooth_w": 0.1}
    torch.cuda.synchronize()
    reset_counts(fused_render, mlp_psf)
    for name, kw in VARIANTS.items():
        torch.manual_seed(0)
        model = AiFDepthNet(n_stack=N_STACK, **kw).to(device)
        state = trainer.create_train_state(model, LR, EPOCHS * TRAIN_STEPS)
        dd = kw.get("disp_depth", "depth")
        step = trainer.make_aif_train_step("DA_FS", aif_w=1.0, smooth_w=0.1,
                                           disp_depth=dd)
        index = (add_stack_index_channel if kw.get("n_channels") == 4
                 else lambda stack: stack)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        focus = select_focus_dist(depth, N_STACK, mode="linear")
        stack = trainer.render_focal_stack(lens, aif, depth, focus)
        losses = step(state, index(stack), focus, depth, aif)
        ev[1].record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        focus2 = select_focus_dist(depth2, N_STACK, mode="linear")
        out = eval_step(state, index(trainer.render_focal_stack(
            lens, aif2, depth2, focus2)), focus2)
        torch.cuda.synchronize()
        rec = {"fields": kw, "loss": float(losses["total"]),
               "skipped_nonfinite": float(losses["skipped_nonfinite"]),
               "step_ms": ev[0].elapsed_time(ev[1]), "peak_gib": peak,
               "outputs": {k: list(v.shape) for k, v in out.items()},
               "outputs_finite": all(bool(torch.isfinite(v).all())
                                     for v in out.values())}
        fields[name] = rec
        check(math.isfinite(rec["loss"]) and rec["skipped_nonfinite"] == 0.0
              and rec["outputs_finite"], f"variant {name}: {rec}")
        check(set(out) == {f"pred_{dd}", "pred_AiF_img"}
              and rec["outputs"][f"pred_{dd}"] == [BS, 1, H, W],
              f"variant {name}: outputs {rec['outputs']}")
        del model, state, stack, out
    check(fields["remat"]["peak_gib"] < fields["plain"]["peak_gib"],
          f"remat's peak {fields['remat']['peak_gib']:.3f} GiB is not below "
          f"the plain model's {fields['plain']['peak_gib']:.3f}")
    torch.cuda.synchronize()
    launches = dict(fused_render.variant_launches)
    fields["launches"] = launches
    check(launches == {"stack/f32/full": 2 * len(VARIANTS)}
          and mlp_psf.launches == 0, f"variants launches {launches}")
    return fields, launches["stack/f32/full"]


def run_dfv_levels(torch, gen, device, make_scenes, lens, trainer,
                   fused_render, mlp_psf):
    """The dfv_levels phase: DFVNet levels 1, 3 and 4 (use_diff 1) from a
    seeded init, one train step and one eval forward each at the main
    configuration through B1; then each level's eval outputs on the card
    and on the CPU from the same initial weights at 2 x 4 x 64x64, TF32 off.
    Returns (the phase's fields, B1 launches)."""
    import math  # noqa: PLC0415

    from aadff_tpu_torch.dff.focus import select_focus_dist  # noqa: PLC0415
    from aadff_tpu_torch.models.dfv.dffnet import DFVNet  # noqa: PLC0415
    from aadff_tpu_torch.train import dff_dfv  # noqa: PLC0415

    step, eval_step = dff_dfv.make_dfv_train_step(), dff_dfv.make_dfv_eval_step()
    cpu_gen = torch.Generator().manual_seed(7)
    small = torch.rand(2, 4, 64, 64, 3, generator=cpu_gen)
    small_fd = torch.sort(0.5 + 2.5 * torch.rand(2, 4, generator=cpu_gen))[0]
    fields = {"tol": DFV_CARD_VS_CPU}
    torch.cuda.synchronize()
    reset_counts(fused_render, mlp_psf)
    for level in (1, 3, 4):
        torch.manual_seed(level)
        init = DFVNet(level=level, use_diff=1)
        model = DFVNet(level=level, use_diff=1).to(device)
        model.load_state_dict(init.state_dict())
        state = trainer.create_train_state(model, LR, EPOCHS * TRAIN_STEPS)
        (aif, depth), (aif2, depth2) = (make_scenes(BS, H, W, gen, device)
                                        for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        focus = select_focus_dist(depth, N_STACK, mode="linear")
        stack = trainer.render_focal_stack(lens, aif, depth, focus)
        ev[1].record()
        losses = step(state, stack, focus, depth)
        ev[2].record()
        torch.cuda.synchronize()
        focus2 = select_focus_dist(depth2, N_STACK, mode="linear")
        pred, std, prob = eval_step(state, trainer.render_focal_stack(
            lens, aif2, depth2, focus2), focus2)
        torch.cuda.synchronize()
        rec = {"loss": float(losses["total"]),
               "skipped_nonfinite": float(losses["skipped_nonfinite"]),
               "render_ms": ev[0].elapsed_time(ev[1]),
               "step_ms": ev[0].elapsed_time(ev[2]),
               "outputs": [list(pred.shape), list(std.shape), list(prob.shape)],
               "outputs_finite": all(bool(torch.isfinite(t).all())
                                     for t in (pred, std, prob)),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "params": sum(p.numel() for p in model.parameters())}
        del state, model, stack, pred, std, prob

        # card against CPU, the initial weights in eval mode, TF32 off
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = DFVNet(level=level, use_diff=1).to(device).eval()
        card.load_state_dict(init.state_dict())
        with torch.no_grad():
            ref = init.eval()(small, small_fd)
            out = card(small.to(device), small_fd.to(device))
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        rec["card_vs_cpu_rel"] = [((o.cpu() - r).abs().max() / r.abs().max()).item()
                                  for o, r in zip(out, ref)]
        fields[f"level{level}"] = rec
        check(math.isfinite(rec["loss"]) and rec["skipped_nonfinite"] == 0.0,
              f"DFV level {level}: loss {rec['loss']}, skipped "
              f"{rec['skipped_nonfinite']}")
        check(rec["outputs_finite"] and math.isfinite(rec["peak_gib"]),
              f"DFV level {level}: non-finite outputs")
        check(max(rec["card_vs_cpu_rel"]) <= DFV_CARD_VS_CPU,
              f"DFV level {level}: card vs CPU {rec['card_vs_cpu_rel']}")
    torch.cuda.synchronize()
    launches = dict(fused_render.variant_launches)
    fields["launches"] = launches
    check(launches == {"stack/f32/full": 6} and mlp_psf.launches == 0,
          f"dfv_levels launches {launches}")
    return fields, launches.get("stack/f32/full", 0)


def run_thinlens(torch, np, gen, device, make_scenes, fused_render, mlp_psf):
    """The thinlens phase: ThinLens.render against the render golden and
    render_stack against its frame loop on the card; then one chunk of the
    AiF twin and one of the DFV twin under
    configs/aber_aware_dff_synth_thinlens.yml (the thin lens trains, PSFNet
    validates).  Returns (the phase's fields, B1 launches)."""
    import math  # noqa: PLC0415
    import shutil  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    from aadff_tpu_torch.dff.focus import select_focus_dist  # noqa: PLC0415
    from aadff_tpu_torch.psfnet.psfnet import ThinLens  # noqa: PLC0415
    from aadff_tpu_torch.scripts import aber_aware_dff_dfv_synth  # noqa: PLC0415
    from aadff_tpu_torch.scripts import aber_aware_dff_synth  # noqa: PLC0415
    from aadff_tpu_torch.utils.config import load_config  # noqa: PLC0415

    g = np.load(RENDER_GOLDENS)
    # the golden's own lens (tests/test_psfnet_render.py:162)
    golden = ThinLens(50.0, 1.8, KS, [25.968, 34.624], (480, 640), device=device)
    err_golden = float(np.abs(golden.render(g["img"], g["depth"], g["foc"])
                              .cpu().numpy() - g["thinlens_rendered"]).max())
    sec = load_config(os.path.join(ROOT, "configs",
                                   "aber_aware_dff_synth_thinlens.yml"))["train"]
    thin = ThinLens(float(sec["foc_len"]), float(sec["fnum"]), KS,
                    [float(v) for v in sec["sensor_size"]], (H, W), device=device)
    aif, depth = make_scenes(BS, H, W, gen, device)
    focus = select_focus_dist(depth, N_STACK, mode="linear")
    args = (aif, depth * -1e3, focus * -1e3)
    torch.cuda.synchronize()
    reset_counts(fused_render, mlp_psf)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stack = thin.render_stack(*args)
    torch.cuda.synchronize()
    render_peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    loop = torch.stack([thin.render(aif, args[1], args[2][:, s])
                        for s in range(N_STACK)], dim=1)
    loop_err = (stack - loop).abs().max().item()
    finite = bool(torch.isfinite(stack).all())
    del stack, loop
    render_ms = time_ms(torch, lambda: thin.render_stack(*args), 3)
    render_launches = fused_render.launches + mlp_psf.launches

    tmp = tempfile.mkdtemp(prefix="aadff_thinlens_")
    try:
        config, _ = write_run_config(tmp, "aber_aware_dff_synth_thinlens.yml",
                                     make_scenes, gen, device)
        chunks = {}
        for name, twin in (("aif", aber_aware_dff_synth),
                           ("dfv", aber_aware_dff_dfv_synth)):
            wd = os.path.join(tmp, name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = fused_render.launches
            t = time.perf_counter()
            state = twin.main(["--config", config, "--workdir", wd,
                               "--total-epochs", "1", "--epochs-per-chunk", "1"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t
            log = read_jsonl(os.path.join(wd, "train_log.jsonl"))[0]
            val = read_jsonl(os.path.join(wd, "metrics.jsonl"))[0]
            chunks[name] = {
                "steps": int(state.step), "loss": log["loss"],
                "skipped": log["skipped"], "step_ms": log["step_ms"],
                "sec": log["sec"], "run_s": run_s, "val": val,
                "b1_launches": fused_render.launches - before,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del state
        torch.cuda.synchronize()
        launches = dict(fused_render.variant_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fields = {"config": "configs/aber_aware_dff_synth_thinlens.yml",
              "golden_tol": GOLDEN_TOL, "loop_tol": LOOP_TOL,
              "golden_max_abs_err": err_golden, "loop_vs_stack_max_abs": loop_err,
              "render": {"shape": [BS, N_STACK, 3, H, W], "ms": render_ms,
                         "peak_gib_above_inputs": render_peak_gib,
                         "kernel_launches": render_launches,
                         "route": "tap loop (plain PyTorch; JAX renders it in "
                                  "plain XLA, no pallas_call)"},
              "chunks": chunks, "launches": launches,
              "mlp_psf_launches": mlp_psf.launches}
    check(err_golden < GOLDEN_TOL, f"thin-lens golden {err_golden:.3g}")
    check(finite and loop_err <= LOOP_TOL,
          f"thin-lens stack vs frame loop {loop_err:.3g}, finite {finite}")
    check(render_launches == 0, f"the thin-lens render launched {render_launches}")
    for name, rec in chunks.items():
        check(rec["steps"] == 2 and rec["skipped"] == 0 and math.isfinite(rec["loss"]),
              f"thin-lens {name} chunk: {rec['steps']} steps, loss {rec['loss']}")
        check(all(math.isfinite(v) for v in rec["val"].values()),
              f"thin-lens {name} metrics {rec['val']}")
        # B1 renders validation only: none of the 2 training stacks
        check(rec["b1_launches"] == ENTRY_VAL,
              f"thin-lens {name} chunk: {rec['b1_launches']} B1 launches, "
              f"expected {ENTRY_VAL} (validation only)")
    check(launches == {"stack/f32/full": 2 * ENTRY_VAL} and mlp_psf.launches == 0,
          f"thinlens launches {launches}")
    return fields, launches.get("stack/f32/full", 0)


def run_optics(torch, np, device):
    """The optics phase: both lens files on the card against the goldens,
    and psf_impl on the card against the CPU.  Returns the phase's fields;
    raises SmokeError on a failed check."""
    from aadff_tpu_torch.constants import WAVE_RGB  # noqa: PLC0415
    from aadff_tpu_torch.optics import Lens, make_rays  # noqa: PLC0415
    from aadff_tpu_torch.optics.psf import (draw_psf, lens_scalars,  # noqa: PLC0415
                                            psf_centre, psf_from_rays,
                                            psf_impl, psf_rays)

    g = np.load(OPTICS_GOLDENS)
    fields = {"tol": {"derived": DERIVED_TOL, "trace": TRACE_TOL,
                      "refocus": REFOCUS_TOL, "psf_card_vs_cpu": PSF_CARD_VS_CPU,
                      "psf_sum": ROWSUM_TOL}}
    for key, path in LENS_FILES.items():
        lens = Lens(path, sensor_res=(H, W), device=device)
        foclen, fnum, hfov, d_sensor = g[f"{key}_derived"]
        errs = {"foclen": abs(lens.foclen - foclen), "fnum": abs(lens.fnum - fnum),
                "hfov": abs(lens.hfov - hfov),
                "d_sensor": abs(lens.d_sensor - d_sensor),
                "pupil": max(abs(a - b) for a, b in zip(lens.entrance_pupil(),
                                                        g[f"{key}_pupil"]))}
        trace = {}
        for wvln in WAVE_RGB:
            ray = make_rays(g[f"{key}_ray_o_in"], g[f"{key}_ray_d_in"], device=device)
            out = lens.trace2sensor(ray, wvln=wvln)
            w = str(wvln).replace(".", "")
            ra, ra_ref = out.ra.cpu().numpy(), g[f"{key}_w{w}_ra"]
            m = (ra > 0) & (ra_ref > 0)
            trace[w] = {"mask_agree": float((ra == ra_ref).mean()),
                        "o": float(np.abs(out.o.cpu().numpy()[m] - g[f"{key}_w{w}_o"][m]).max()),
                        "d": float(np.abs(out.d.cpu().numpy()[m] - g[f"{key}_w{w}_d"][m]).max()),
                        "obliq": float(np.abs(out.obliq.cpu().numpy()[m]
                                              - g[f"{key}_w{w}_obliq"][m]).max())}
        refocus = {}
        for depth in (500, 2400, 20000):
            lens = Lens(path, sensor_res=(H, W), device=device)
            lens.refocus(-float(depth))
            d_ref, hfov_ref, fnum_ref = g[f"{key}_refocus_{depth}"]
            refocus[depth] = {"d_sensor": abs(lens.d_sensor - d_ref),
                              "hfov": abs(lens.hfov - hfov_ref),
                              "fnum": abs(lens.fnum - fnum_ref)}
        fields[key] = {"derived_err": errs, "trace_err": trace,
                       "refocus_err": refocus}
        for name, err in errs.items():
            check(err < DERIVED_TOL[name], f"{key} {name}: {err:.3g}")
        for w, rec in trace.items():
            check(rec["mask_agree"] > 0.999, f"{key} w{w}: masks {rec['mask_agree']}")
            for name, tol in TRACE_TOL.items():
                check(rec[name] <= tol, f"{key} w{w} {name}: {rec[name]:.3g}")
        for depth, rec in refocus.items():
            for name, tol in REFOCUS_TOL.items():
                check(rec[name] < tol, f"{key} refocus {depth} {name}: {rec[name]:.3g}")

    # psf_impl from the same draws and lens scalars, on the card and the
    # CPU.  A ray that lands at the PSF window's edge (or grazes a stop)
    # may be kept on one device and cut on the other, whose f32 roundings
    # differ, and one such ray of 4,096 moves a tap by ~2.5e-4.  So, as in
    # the trace check, the kept-ray masks must agree on > 99.9%, and the
    # PSFs are held to PSF_CARD_VS_CPU on the rays that both keep; the
    # whole-PSF difference is reported beside it.
    on_card = Lens(LENS_FILES["rf50mm"], sensor_res=(H, W), device=device)
    on_cpu = Lens(LENS_FILES["rf50mm"], sensor_res=(H, W), device="cpu")
    on_cpu.refocus(-2400.0)
    scalars = lens_scalars(on_cpu)
    draws = draw_psf(4096, torch.Generator().manual_seed(0), "cpu")
    pts = torch.tensor([[0.0, 0.0, -2400.0], [0.5, -0.5, -5000.0],
                        [-0.9, 0.3, -800.0], [0.98, 0.98, -20000.0],
                        [-0.3, -0.7, -1200.0], [0.1, 0.9, -300.0]])
    rng = tuple(range(len(on_card.metas)))
    card_args = (on_card.params, on_card.metas, pts.to(device),
                 type(draws)(*(t.to(device) for t in draws)))
    cpu_args = (on_cpu.params, on_cpu.metas, pts, draws)
    card = psf_impl(*card_args, KS, 0.589, True, rng, *scalars)
    cpu = psf_impl(*cpu_args, KS, 0.589, True, rng, *scalars)
    fields["psf_card_vs_cpu_whole_max_abs"] = (card.cpu() - cpu).abs().max().item()
    fields["psf_sum_err"] = (card.sum((-1, -2)) - 1).abs().max().item()

    sensor_w, sensor_h, ps = scalars[5:]
    ps32 = torch.tensor(ps, dtype=torch.float32)
    window = (KS / 2 - 0.5) * ps32 - 0.01 * ps32   # as forward_integral
    (ray_d, chief_d), (ray_h, chief_h) = (
        psf_rays(*args, 0.589, True, rng, *scalars[:7]) for args in (card_args, cpu_args))
    chief_keep = (chief_d.ra.cpu() > 0) & (chief_h.ra > 0)
    centre_d = psf_centre(chief_d._replace(ra=chief_keep.float().to(device)),
                          pts, sensor_w, sensor_h)
    centre_h = psf_centre(chief_h._replace(ra=chief_keep.float()), pts, sensor_w,
                          sensor_h)

    def kept(ray, centre):
        shift = -ray.o[..., :2] - centre
        return ((ray.ra > 0) & (shift.abs() < window.to(ray.o.device)).all(-1)).cpu()

    keep_d, keep_h = kept(ray_d, centre_d), kept(ray_h, centre_h)
    both = (keep_d & keep_h).float()
    joint_d = psf_from_rays(ray_d._replace(ra=both.to(device)), centre_d, KS, ps)
    joint_h = psf_from_rays(ray_h._replace(ra=both), centre_h, KS, ps)
    fields["psf_mask_agree"] = {
        "rays": float((keep_d == keep_h).float().mean()),
        "chief_rays": float(((chief_d.ra.cpu() > 0) == (chief_h.ra > 0)).float().mean())}
    fields["psf_rays_kept"] = {"card": int(keep_d.sum()), "cpu": int(keep_h.sum()),
                               "both": int(both.sum())}
    fields["psf_card_vs_cpu_max_abs"] = (joint_d.cpu() - joint_h).abs().max().item()
    for name, agree in fields["psf_mask_agree"].items():
        check(agree > 0.999, f"psf_impl {name}: masks agree on {agree}")
    check(fields["psf_card_vs_cpu_max_abs"] <= PSF_CARD_VS_CPU,
          f"psf_impl card vs CPU on the rays both keep "
          f"{fields['psf_card_vs_cpu_max_abs']:.3g}")
    check(fields["psf_sum_err"] <= ROWSUM_TOL, f"PSF sums {fields['psf_sum_err']:.3g}")
    return fields


def profile_fit_step(torch, net, opt, foc_z, state):
    """One fit iteration under torch.profiler: (device events, kernels
    among them (the rest are copies and memsets), device ms busy, wall
    ms)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        net.fit_step(opt, foc_z, state, 128, 4096)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for a, b in spans:  # the union of the kernels' intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    n_kernels = sum(not e.name.startswith(("Memcpy", "Memset")) for e in kernels)
    return len(kernels), n_kernels, busy / 1e3, wall_ms


def kernel_device_us(torch, fn, reps, name_part=None, flush=None):
    """`reps` calls of fn under torch.profiler, each after flush() if one is
    given: (device microseconds a call, summed over the kernels whose name
    holds `name_part`, or over all of fn's kernels if it is None; the count
    of those kernels; their names).  Copies and memsets are never counted,
    so a flush that copies into a buffer stays out.  The kernels alone,
    where CUDA events around the call also time the launch."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    kept = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))
            and (name_part is None or name_part in e.name)]
    us = sum(e.time_range.end - e.time_range.start for e in kept) / reps
    # a kernel's name without its arguments and namespaces
    names = sorted({re.split(r"[<(]", e.name.replace("(anonymous namespace)::", "")
                             .removeprefix("void "))[0].split("::")[-1]
                    for e in kept})
    return (us if kept else None), len(kept), names


def run_convonly(torch, device, net, fused_render, mlp_psf, cases):
    """'convonly' (csrc/psf_conv.cu) beyond kernel_split's 480x640 frame:
    each case {name: (img, depth_mm, focus_mm, ks)} against the plain
    version, its launches counted; then the 480x640 frame (the first case)
    by torch.profiler, warm and L2-cold, and PyTorch's depthwise ks x ks
    convolution of the edge-padded image (TF32 off), the same ks^2
    multiply-adds an output without the per-pixel scale: a yardstick that
    the port never calls.  Returns the fields of the kernel's record."""
    import torch.nn.functional as F  # noqa: PLC0415

    def render(img, depth, focus, ks, plain=False):
        fn = (fused_render.fused_psf_render_reference if plain
              else fused_render.fused_psf_render)
        return fn(net.model, img, depth, focus, ks, net.d_min, net.d_max,
                  mode="convonly")

    torch.cuda.synchronize()
    reset_counts(fused_render, mlp_psf)
    outs = {name: render(*case) for name, case in cases.items()}
    torch.cuda.synchronize()
    launches = dict(fused_render.variant_launches)
    errs, shapes_ok = {}, True
    for name, (img, depth, focus, ks) in cases.items():
        out = outs[name]
        shapes_ok &= (out.shape == (img.shape[0], 1, *img.shape[1:])
                      and bool(torch.isfinite(out).all()))
        errs[name] = (out - render(img, depth, focus, ks, True)).abs().max().item()
    del outs

    img, depth, focus, ks = next(iter(cases.values()))
    flush_src = torch.empty(FLUSH_BYTES // 4, device=device)
    flush_dst = torch.empty_like(flush_src)

    def flush():
        flush_dst.copy_(flush_src)  # a device copy: the profiler skips it

    def kernel():
        render(img, depth, focus, ks)

    pad = (ks - 1) // 2
    box = torch.ones(img.shape[1], 1, ks, ks, device=device)

    def library():
        return F.conv2d(F.pad(img, (pad,) * 4, mode="replicate"), box,
                        groups=img.shape[1])

    z = ((depth - net.d_min) / (net.d_max - net.d_min)).clamp(0.0, 1.0) * 0.01
    lib_err = (library() * z[:, None]
               - render(img, depth, focus, ks, True)[:, 0]).abs().max().item()
    rec = {"launches_by_case": launches, "cases": list(cases),
           "max_abs_err_by_case": errs, "shapes_ok": shapes_ok,
           "profile_reps": PROFILE_REPS, "flush_bytes": FLUSH_BYTES}
    for tag, fl in (("", None), ("_cold", flush)):
        us, n, names = kernel_device_us(torch, kernel, PROFILE_REPS,
                                        "psf_conv", fl)
        lib_us, lib_n, lib_names = kernel_device_us(torch, library,
                                                    PROFILE_REPS, None, fl)
        rec.update({f"profiler_us{tag}": us, f"profiler_kernels{tag}": n,
                    f"kernel_names{tag}": names,
                    f"library_us{tag}": lib_us, f"library_kernels{tag}": lib_n,
                    f"library_names{tag}": lib_names})
    rec["library_ms"] = rec["library_us"] / 1e3
    rec["library_times_scaled_z_vs_plain_max_abs"] = lib_err
    del flush_src, flush_dst
    return rec


def run_psf_fit(torch, np, gen, device, make_scenes, fused_render, mlp_psf):
    """The psf_fit phase: the twin of scripts/1_fit_psfnet.py in this
    process, cut to FIT_ITERS iterations, then one B1 f32 stack with the
    fitted weights.  Returns the phase's fields and the B1 launches."""
    import shutil  # noqa: PLC0415
    import tempfile  # noqa: PLC0415

    from aadff_tpu_torch.dff.focus import select_focus_dist  # noqa: PLC0415
    from aadff_tpu_torch.psfnet.psfnet import PSFNet  # noqa: PLC0415
    from aadff_tpu_torch.scripts import fit_psfnet  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="aadff_fit_")
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        net, losses, (l1, l2) = fit_psfnet.main([
            "--iters", str(FIT_ITERS), "--evaluate-every", str(FIT_EVERY),
            "--result-dir", tmp, "--device", str(device)])
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t
        files = sorted(os.listdir(tmp))
        saved = PSFNet(kernel_size=KS, sensor_res=(H, W), device=device)
        saved.load_net(os.path.join(tmp, "PSFNet_mlp.msgpack"))
        reload_equal = all(torch.equal(a, b) for a, b in zip(
            saved.model.parameters(), net.model.parameters()))

        # one focal stack through B1 f32 with the fitted weights
        aif, depth = make_scenes(BS, H, W, gen, device)
        focus = select_focus_dist(depth, N_STACK, mode="linear")
        depth_mm, focus_mm = depth * -1e3, focus * -1e3
        torch.cuda.synchronize()
        reset_counts(fused_render, mlp_psf)
        stack = net.render_stack(aif, depth_mm, focus_mm)
        torch.cuda.synchronize()
        launches = dict(fused_render.variant_launches)
        ref = fused_render.fused_psf_render_reference(
            net.model, aif, depth_mm[:, 0].contiguous(), focus_mm.contiguous(),
            KS, net.d_min, net.d_max)
        render_err = (stack - ref).abs().max().item()
        del stack, ref

        # the fit iteration on its own: CUDA events, then one under the profiler
        opt = net.fit_optimizer(1e-4, FIT_ITERS)
        states = net.focus_states()
        foc_z = torch.tensor(net.foc_z_arr.astype(np.float32), device=device)
        net.fit_step(opt, foc_z[0], states[0], 128, 4096)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iter_ms = time_ms(torch, lambda: net.fit_step(opt, foc_z[5], states[5],
                                                      128, 4096), 10)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        n_events, n_kernels, busy_ms, wall_ms = profile_fit_step(
            torch, net, opt, foc_z[9], states[9])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    fields = {"config": {"lens": "lenses/rf50mm.json", "res": [H, W], "ks": KS,
                         "bs": fit_psfnet.BS, "spp": fit_psfnet.SPP,
                         "lr": fit_psfnet.LR, "iters": FIT_ITERS,
                         "warm_start": os.path.relpath(fit_psfnet.CKPT, ROOT)},
              "twin_s": twin_s, "files": files, "n_losses": len(losses),
              "loss_first10_mean": first, "loss_last10_mean": last,
              "gate_n_z40": {"avg_l1": l1, "avg_l2": l2},
              "reload_equal": reload_equal,
              "ms_per_iter": iter_ms, "kernels_per_iter": n_kernels,
              "device_events_per_iter": n_events,
              "idle_share": 1.0 - busy_ms / iter_ms,
              "profiled_iter": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                "idle_share": 1.0 - busy_ms / wall_ms},
              "peak_gib": peak_gib,
              "render": {"launches": launches, "max_abs_err": render_err,
                         "tol": KERNEL_TOL}}
    check(len(losses) == FIT_ITERS + 1 and bool(np.isfinite(losses).all()),
          f"fit losses: {len(losses)}, finite {np.isfinite(losses).all()}")
    check(last <= 1.5 * first, f"fit: last 10 {last:.3g} vs first 10 {first:.3g}")
    check(reload_equal, "the saved weights do not reload equal")
    check("lens.json" in files and "PSFNet_mlp.msgpack" in files,
          f"fit files {files}")
    check(np.isfinite(l1) and np.isfinite(l2), f"fit gate {l1}, {l2}")
    check(launches == {"stack/f32/full": 1} and mlp_psf.launches == 0,
          f"fitted render launches {launches}")
    check(render_err <= KERNEL_TOL, f"fitted render vs plain {render_err:.3g}")
    check(n_kernels > 0 and busy_ms > 0, "the profile holds no device time")
    return fields, launches.get("stack/f32/full", 0)


def run_psf_gate(torch, device):
    """The psf_gate phase: the twin of scripts/psf_gate.py on the converted
    checkpoint, held to PSF_GATE.json."""
    import tempfile  # noqa: PLC0415

    from aadff_tpu_torch.scripts import psf_gate  # noqa: PLC0415

    with open(PSF_GATE) as f:
        committed = json.load(f)["records"]
    ref = next(r for r in committed
               if r["ckpt"] == "ckpt/rf50mm/psfnet_480x640_ks11.msgpack"
               and r["lattice"] == "20 foc x 10 z x 7x10 field points")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gate.json")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = psf_gate.main([PSFNET_CKPT, "--out", out, "--device", str(device)])
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with open(out) as f:
            written = json.load(f)["records"]
    rel = {k: abs(rec[k] - ref[k]) / ref[k] for k in GATE_TOL}
    fields = {"record": rec, "reference": {k: ref[k] for k in GATE_TOL},
              "rel_err": rel, "tol": GATE_TOL, "peak_gib": peak_gib}
    check(written == [rec], f"gate file {written}")
    for k, tol in GATE_TOL.items():
        check(rel[k] <= tol, f"gate {k} {rec[k]:.4g} vs {ref[k]:.4g} ({rel[k]:.3g})")
    return fields


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of the data_parallel phase's launches (torch.distributed.run)
    ap.add_argument("--dp-worker", choices=("steps", "paper"), help=argparse.SUPPRESS)
    ap.add_argument("--dp-dir", help=argparse.SUPPRESS)
    ap.add_argument("--config", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1

    from aadff_tpu_torch.dff import metrics
    from aadff_tpu_torch.dff.focus import select_focus_dist
    from aadff_tpu_torch.dff.synth import make_scenes
    from aadff_tpu_torch.models.aifnet import AiFDepthNet
    from aadff_tpu_torch.models.convert import load_flax_aifnet
    from aadff_tpu_torch.models.dfv.convert import load_flax_dfvnet
    from aadff_tpu_torch.models.dfv.dffnet import DFVNet
    from aadff_tpu_torch.ops import _build, fused_render, mlp_psf
    from aadff_tpu_torch.psfnet.psfnet import PSFNet
    from aadff_tpu_torch.train import dff_dfv, trainer

    if args.dp_worker:
        return dp_worker(args)

    def phase(name, t0, **fields):
        elapsed = time.perf_counter() - t_start
        emit({"phase": name, "elapsed_s": round(time.perf_counter() - t0, 3),
              "total_s": round(elapsed, 3), **fields})
        check(elapsed < BUDGET_S, f"over the {BUDGET_S:.0f} s budget after {name}")

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    phase("device", t0, nvidia_smi=smi, gpu=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = _build.build()
    _build.kernels()
    ptxas = ptxas_report(built["log"])
    phase("build", t0, nvcc_s=round(built["seconds"], 3), built=built["built"],
          library=os.path.relpath(built["path"], ROOT), ptxas=ptxas)
    # (a library built by an earlier run leaves no log to read)
    if built["built"]:
        check(sorted(k for k in ptxas if "_wg" in k) == sorted(BF16_KERNELS),
              f"ptxas report of the bf16 kernels: {sorted(ptxas)}")
        for name in BF16_KERNELS:
            rec = ptxas[name]
            check("registers" in rec and rec.get("spill_stores") == 0
                  and rec.get("spill_loads") == 0, f"{name}: ptxas {rec}")
            check("C7512" not in rec["warnings"],
                  f"{name}: ptxas serialized its wgmma (C7512): {rec}")
        conv = {k: v for k, v in ptxas.items() if k.startswith("psf_conv_kernel")}
        check(CONV_KERNEL in conv and all(
            rec.get("spill_stores") == 0 and rec.get("spill_loads") == 0
            for rec in conv.values()), f"psf_conv_kernel: ptxas {conv}")

    # ---- the image readers: JPEG (host C++), EXR -------------------------
    t0 = time.perf_counter()
    phase("readers", t0, **run_readers(np))

    # ---- kernel against its plain version, TF32 off for both -------------
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = PSFNet(kernel_size=KS, sensor_res=(H, W), device=device)
    net.load_net(PSFNET_CKPT)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    aif, depth = make_scenes(BS, H, W, gen, device)
    focus = select_focus_dist(depth, N_STACK, mode="linear")
    render_args = (net.model, aif, (depth * -1e3)[:, 0].contiguous(),
                   (focus * -1e3).contiguous(), KS, net.d_min, net.d_max)
    out = fused_render.fused_psf_render(*render_args)
    ref = fused_render.fused_psf_render_reference(*render_args)
    torch.cuda.synchronize()
    check(out.shape == (BS, N_STACK, 3, H, W), f"stack shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite kernel output")
    err_stack = (out - ref).abs().max().item()
    kernel_ms = time_ms(torch, lambda: fused_render.fused_psf_render(*render_args), 3)
    plain_ms = time_ms(torch, lambda: fused_render.fused_psf_render_reference(*render_args), 2)
    bound_ms, bound_by = render_bound_ms(net.model, BS, N_STACK, 3, H, W, KS)
    # one frame at sensor resolution, as PSFNet.render launches it (S = 1)
    frame_args = (net.model, aif[:1], render_args[2][:1],
                  render_args[3][:1, :1].contiguous(), KS, net.d_min, net.d_max)
    frame_ms = time_ms(torch, lambda: fused_render.fused_psf_render(*frame_args), 5)
    frame_plain_ms = time_ms(
        torch, lambda: fused_render.fused_psf_render_reference(*frame_args), 3)
    frame_bound_ms, _ = render_bound_ms(net.model, 1, 1, 3, H, W, KS)
    del out, ref

    rg = torch.Generator(device=device).manual_seed(args.seed + 1)
    rimg = torch.rand(1, 3, 123, 161, generator=rg, device=device)
    rdepth = -(500 + 14500 * torch.rand(1, 123, 161, generator=rg, device=device))
    rfocus = torch.tensor([[-2400.0]], device=device)
    ragged = fused_render.fused_psf_render(net.model, rimg, rdepth, rfocus, KS,
                                           net.d_min, net.d_max)
    err_ragged = (ragged - fused_render.fused_psf_render_reference(
        net.model, rimg, rdepth, rfocus, KS, net.d_min, net.d_max)).abs().max().item()
    torch.cuda.synchronize()
    phase("kernels", t0, tf32=False, tol=KERNEL_TOL,
          max_abs_err={"stack_2x8x3x480x640": err_stack,
                       "ragged_1x1x3x123x161": err_ragged},
          ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
          frame_ms=frame_ms, frame_plain_ms=frame_plain_ms,
          frame_bound_ms=frame_bound_ms)
    check(err_stack <= KERNEL_TOL, f"stack: kernel vs plain {err_stack:.3g}")
    check(err_ragged <= KERNEL_TOL, f"ragged: kernel vs plain {err_ragged:.3g}")

    # ---- PSF-MLP kernel against its plain version, TF32 off -------------
    t0 = time.perf_counter()
    fields = {
        "field_614400x4": fused_render.psf_field(
            render_args[2], render_args[3][:, 0], net.d_min, net.d_max),
        "ragged_19803x4": fused_render.psf_field(
            rdepth, rfocus[:, 0], net.d_min, net.d_max)}
    mlp_err, mlp_rowsum = {}, {}
    for name, field in fields.items():
        field = field.reshape(-1, 4).contiguous()
        rows = mlp_psf.mlp_psf(net.model, field)
        rows_ref = mlp_psf.mlp_psf_reference(net.model, field)
        torch.cuda.synchronize()
        check(rows.shape == (field.shape[0], KS * KS), f"{name}: {tuple(rows.shape)}")
        check(bool(torch.isfinite(rows).all()), f"{name}: non-finite rows")
        mlp_err[name] = (rows - rows_ref).abs().max().item()
        mlp_rowsum[name] = (rows.sum(-1) - 1).abs().max().item()
    field = fields["field_614400x4"].reshape(-1, 4).contiguous()
    mlp_ms = time_ms(torch, lambda: mlp_psf.mlp_psf(net.model, field), 5)
    # the plain version is the port's MLP forward, a chain of cuBLAS addmm:
    # also the one library call that computes the same function
    mlp_plain_ms = time_ms(
        torch, lambda: mlp_psf.mlp_psf_reference(net.model, field), 5)
    mlp_bound, mlp_bound_by = mlp_bound_ms(net.model, field.shape[0])
    del rows, rows_ref
    phase("mlp_kernel", t0, tf32=False, tol=KERNEL_TOL, rowsum_tol=ROWSUM_TOL,
          max_abs_err=mlp_err, max_rowsum_err=mlp_rowsum, n_rows=field.shape[0],
          ms=mlp_ms, plain_ms=mlp_plain_ms, library_ms=mlp_plain_ms,
          bound_ms=mlp_bound, bound_by=mlp_bound_by)
    for name in fields:
        check(mlp_err[name] <= KERNEL_TOL, f"{name}: kernel vs plain {mlp_err[name]:.3g}")
        check(mlp_rowsum[name] <= ROWSUM_TOL, f"{name}: row sums {mlp_rowsum[name]:.3g}")

    # ---- both kernels in bf16: against their plain bf16 versions and f32 --
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    net16 = PSFNet(kernel_size=KS, sensor_res=(H, W), device=device,
                   render_dtype="bf16")
    net16.model = net.model
    out32 = fused_render.fused_psf_render(*render_args)
    out16 = fused_render.fused_psf_render(*render_args, bf16)
    repeat16 = fused_render.fused_psf_render(*render_args, bf16)
    ref16 = fused_render.fused_psf_render_reference(*render_args, bf16)
    torch.cuda.synchronize()
    check(out16.shape == out32.shape, f"bf16 stack shape {tuple(out16.shape)}")
    check(bool(torch.isfinite(out16).all()), "non-finite bf16 kernel output")
    repeat_equal = bool(torch.equal(out16, repeat16))
    del repeat16
    b1_16 = {"stack_2x8x3x480x640": errors(out16, ref16)}
    b1_16_f32 = {"stack_2x8x3x480x640": errors(out16, out32)}
    del out16, out32, ref16
    ragged16 = fused_render.fused_psf_render(net.model, rimg, rdepth, rfocus, KS,
                                             net.d_min, net.d_max, bf16)
    b1_16["ragged_1x1x3x123x161"] = errors(ragged16, (
        fused_render.fused_psf_render_reference(
            net.model, rimg, rdepth, rfocus, KS, net.d_min, net.d_max, bf16)))
    b1_16_f32["ragged_1x1x3x123x161"] = errors(ragged16, ragged)
    b1_16_ms = time_ms(torch, lambda: fused_render.fused_psf_render(
        *render_args, bf16), 5)
    b1_16_plain_ms = time_ms(torch, lambda: (
        fused_render.fused_psf_render_reference(*render_args, bf16)), 2)
    b1_16_bound, b1_16_bound_by = render_bound_ms(net.model, BS, N_STACK, 3, H,
                                                  W, KS, "bf16")
    frame16_ms = time_ms(torch, lambda: fused_render.fused_psf_render(
        *frame_args, bf16), 5)
    frame16_plain_ms = time_ms(torch, lambda: (
        fused_render.fused_psf_render_reference(*frame_args, bf16)), 3)
    frame16_bound = render_bound_ms(net.model, 1, 1, 3, H, W, KS, "bf16")

    b3_16, b3_16_f32, b3_16_rowsum = {}, {}, {}
    for name, field in fields.items():
        field = field.reshape(-1, 4).contiguous()
        rows16 = mlp_psf.mlp_psf(net.model, field, bf16)
        rows_ref16 = mlp_psf.mlp_psf_reference(net.model, field, bf16)
        rows32 = mlp_psf.mlp_psf(net.model, field)
        torch.cuda.synchronize()
        check(rows16.shape == (field.shape[0], KS * KS),
              f"{name}: {tuple(rows16.shape)}")
        check(bool(torch.isfinite(rows16).all()), f"{name}: non-finite bf16 rows")
        b3_16[name] = errors(rows16, rows_ref16)
        b3_16_f32[name] = errors(rows16, rows32)
        b3_16_rowsum[name] = (rows16.sum(-1) - 1).abs().max().item()
    field = fields["field_614400x4"].reshape(-1, 4).contiguous()
    library = library_mlp_bf16(net.model)
    b3_16_library_err = errors(
        library(field), mlp_psf.mlp_psf_reference(net.model, field, bf16))
    b3_16_ms = time_ms(torch, lambda: mlp_psf.mlp_psf(net.model, field, bf16), 10)
    b3_16_plain_ms = time_ms(
        torch, lambda: mlp_psf.mlp_psf_reference(net.model, field, bf16), 5)
    b3_16_library_ms = time_ms(torch, lambda: library(field), 10)
    b3_16_bound, b3_16_bound_by = mlp_bound_ms(net.model, field.shape[0], "bf16")
    del rows16, rows_ref16, rows32
    phase("bf16_kernels", t0, tol={"max_abs": BF16_MAX_ABS,
                                   "mean_abs": BF16_MEAN_ABS},
          l1_px_tol=L1_PX, rowsum_tol=ROWSUM_TOL, design=BF16_DESIGN,
          repeat_bit_equal=repeat_equal,
          render={**split_errors(b1_16, b1_16_f32),
                  "ms": b1_16_ms, "plain_ms": b1_16_plain_ms,
                  "bound_ms": b1_16_bound, "bound_by": b1_16_bound_by,
                  "frame_ms": frame16_ms, "frame_plain_ms": frame16_plain_ms,
                  "frame_bound_ms": frame16_bound[0]},
          mlp={**split_errors(b3_16, b3_16_f32),
               "max_rowsum_err": b3_16_rowsum, "ms": b3_16_ms,
               "plain_ms": b3_16_plain_ms, "library_ms": b3_16_library_ms,
               "library_vs_plain_max_abs": b3_16_library_err[0],
               "bound_ms": b3_16_bound, "bound_by": b3_16_bound_by})
    for name, (mx, mean) in [*b1_16.items(), *b3_16.items()]:
        check(mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS,
              f"{name}: bf16 kernel vs plain max {mx:.3g}, mean {mean:.3g}")
    for name, (mx, l1) in [*b1_16_f32.items(), *b3_16_f32.items()]:
        check(mx > 0 and (l1 < L1_PX or name == "ragged_1x1x3x123x161"),
              f"{name}: bf16 vs f32 kernel max {mx:.3g}, L1/px {l1:.3g}")
    for name, err in b3_16_rowsum.items():
        check(err <= ROWSUM_TOL, f"{name}: bf16 row sums {err:.3g}")
    check(repeat_equal, "two launches of the bf16 stack differ")

    # ---- the two-stage route: frames off the sensor's size ---------------
    t0 = time.perf_counter()
    g = np.load(RENDER_GOLDENS)
    img2, depth2 = make_scenes(BS, H2, W2, gen, device)
    focus2 = select_focus_dist(depth2, N_STACK, mode="linear")
    stack_args = (img2, depth2 * -1e3, focus2 * -1e3)
    torch.cuda.synchronize()
    reset_counts(fused_render, mlp_psf)
    golden = net.render(g["img"], g["depth"], g["foc"]).cpu().numpy()
    golden_launches = (mlp_psf.launches, fused_render.launches)
    two_stage = net.render_stack(*stack_args)
    two_stage16 = net16.render_stack(*stack_args)  # render_dtype="bf16"
    torch.cuda.synchronize()
    route_launches = dict(mlp_psf.variant_launches)
    route_fused_launches = fused_render.launches
    err_golden = float(np.abs(golden - g["rendered"]).max())
    fused_args = (net.model, img2, stack_args[1][:, 0].contiguous(),
                  stack_args[2].contiguous(), KS, net.d_min, net.d_max)
    err_routes = (two_stage - fused_render.fused_psf_render(
        *fused_args)).abs().max().item()
    err_routes16 = errors(two_stage16,
                          fused_render.fused_psf_render(*fused_args, bf16))
    route_ms = time_ms(torch, lambda: net.render_stack(*stack_args), 2)
    route16_ms = time_ms(torch, lambda: net16.render_stack(*stack_args), 2)
    del two_stage, two_stage16
    phase("two_stage", t0, golden_tol=GOLDEN_TOL, tol=KERNEL_TOL,
          render_path={"f32": net.render_path((H2, W2)),
                       "bf16": net16.render_path((H2, W2))},
          max_abs_err={"golden_vs_rendered_120x160": err_golden,
                       f"stack_2x8x3x{H2}x{W2}_vs_fused": err_routes,
                       f"bf16_stack_2x8x3x{H2}x{W2}_vs_fused": err_routes16[0]},
          mean_abs_err={
              f"bf16_stack_2x8x3x{H2}x{W2}_vs_fused": err_routes16[1]},
          golden_launches={"mlp_psf": golden_launches[0],
                           "fused_psf_render": golden_launches[1]},
          launches={"mlp_psf": route_launches,
                    "fused_psf_render": route_fused_launches},
          stack_ms=route_ms, bf16_stack_ms=route16_ms)
    check(err_golden < GOLDEN_TOL, f"golden: {err_golden:.3g}")
    check(golden_launches == (1, 0), f"golden launches {golden_launches}")
    check(route_launches == {"f32": 1 + N_STACK, "bf16": N_STACK}
          and route_fused_launches == 0,
          f"two-stage stacks: PSF-MLP launches {route_launches}, "
          f"{route_fused_launches} fused")
    check(err_routes <= KERNEL_TOL, f"two-stage vs fused {err_routes:.3g}")
    check(err_routes16[0] <= BF16_MAX_ABS and err_routes16[1] <= BF16_MEAN_ABS,
          f"bf16 two-stage vs fused {err_routes16}")

    # ---- the one-frame launch on its routes: PSFNet.render at the sensor's
    # size and render_stack with stack_kernel=False -------------------------
    t0 = time.perf_counter()
    depth_mm, focus_mm = depth * -1e3, focus * -1e3
    lenses = {"f32": net, "bf16": net16}
    torch.cuda.synchronize()
    reset_counts(fused_render, mlp_psf)
    frames, loops = {}, {}
    for dt, lens in lenses.items():
        frames[dt] = lens.render(aif, depth_mm, focus_mm[:, 2])
        lens.stack_kernel = False
        loops[dt] = lens.render_stack(aif, depth_mm, focus_mm)
        lens.stack_kernel = True
    torch.cuda.synchronize()
    frame_counts = dict(fused_render.variant_launches)
    frame_mlp_launches = mlp_psf.launches
    loop_err, frame_err, loop_ms, stack_ms = {}, {}, {}, {}
    for dt, lens in lenses.items():
        whole = lens.render_stack(aif, depth_mm, focus_mm)  # one launch
        loop_err[dt] = (loops[dt] - whole).abs().max().item()
        frame_err[dt] = (frames[dt] - whole[:, 2]).abs().max().item()
        stack_ms[dt] = time_ms(torch, lambda: lens.render_stack(
            aif, depth_mm, focus_mm), 2)
        lens.stack_kernel = False
        loop_ms[dt] = time_ms(torch, lambda: lens.render_stack(
            aif, depth_mm, focus_mm), 2)
        lens.stack_kernel = True
    del frames, loops, whole
    phase("frame_route", t0, tol=LOOP_TOL,
          launches={"fused_psf_render": frame_counts,
                    "mlp_psf": frame_mlp_launches},
          loop_vs_stack_max_abs=loop_err, frame_vs_stack_max_abs=frame_err,
          loop_ms=loop_ms, stack_ms=stack_ms)
    check(frame_counts == {"frame/f32/full": 1 + N_STACK,
                           "frame/bf16/full": 1 + N_STACK}
          and frame_mlp_launches == 0, f"frame-route launches {frame_counts}")
    for dt in lenses:
        check(loop_err[dt] <= LOOP_TOL and frame_err[dt] <= LOOP_TOL,
              f"{dt}: frame loop vs stack {loop_err[dt]:.3g}, render vs "
              f"stack {frame_err[dt]:.3g}")

    # ---- the kernel's diagnostic modes on one 480x640 frame --------------
    t0 = time.perf_counter()
    modes = [(dt, mode, pipe) for dt in ("f32", "bf16")
             for mode, pipe in (("mlponly", False), ("full", True))]
    modes.append(("f32", "convonly", False))  # no MLP: no dtype
    dtypes = {"f32": torch.float32, "bf16": bf16}
    torch.cuda.synchronize()
    reset_counts(fused_render, mlp_psf)
    outs = {m: fused_render.fused_psf_render(*frame_args, dtypes[m[0]], *m[1:])
            for m in modes}
    torch.cuda.synchronize()
    split_counts = dict(fused_render.variant_launches)
    split = {}
    for (dt, mode, pipe), out in outs.items():
        mode_args = (*frame_args, dtypes[dt], mode, pipe)
        name = fused_render.variant(dtypes[dt], mode, pipe)
        ref = fused_render.fused_psf_render_reference(*mode_args)
        rec = dict(zip(("max_abs_err", "mean_abs_err"), errors(out, ref)))
        if pipe:
            full = fused_render.fused_psf_render(*frame_args, dtypes[dt])
            rec["vs_full_max_abs"] = (out - full).abs().max().item()
        rec["ms"] = time_ms(torch, lambda: fused_render.fused_psf_render(
            *mode_args), 5)
        rec["plain_ms"] = time_ms(torch, lambda: (
            fused_render.fused_psf_render_reference(*mode_args)), 3)
        rec["bound_ms"], rec["bound_by"] = render_bound_ms(
            net.model, 1, 1, 3, H, W, KS, dt, mode)
        rec["launches"] = split_counts.get(name, 0)
        split[name] = rec
    del outs
    # 'mlponly' computes the PSF rows of the frame's 307,200 pixels: the
    # cuBLAS chains that B3's rows time are its yardsticks
    frame_field = fused_render.psf_field(
        frame_args[2], frame_args[3][:, 0], net.d_min, net.d_max
    ).reshape(-1, 4).contiguous()
    mlp16_library = library_mlp_bf16(net.model)
    split["frame/f32/mlponly"]["library_ms"] = time_ms(
        torch, lambda: mlp_psf.mlp_psf_reference(net.model, frame_field), 5)
    split["frame/bf16/mlponly"]["library_ms"] = time_ms(
        torch, lambda: mlp16_library(frame_field), 10)
    del frame_field
    # 'convonly' (csrc/psf_conv.cu) on every shape it may meet; ~3 us of
    # work, so its time is the profiler's device time, not the events'
    # (which also time the launch)
    rg7 = torch.Generator(device=device).manual_seed(args.seed + 2)
    conv_cases = {
        "frame_1x3x480x640": (*frame_args[1:4], KS),
        "n2_2x3x480x640": (aif, render_args[2],
                           render_args[3][:, :1].contiguous(), KS),
        "ragged_1x3x123x161": (rimg, rdepth, rfocus, KS),
        "tiny_1x3x7x9": (torch.rand(1, 3, 7, 9, generator=rg7, device=device),
                         -(500 + 14500 * torch.rand(1, 7, 9, generator=rg7,
                                                    device=device)),
                         rfocus, KS),
        "ks7_1x3x123x161": (rimg, rdepth, rfocus, 7)}
    conv = split["frame/-/convonly"]
    conv.update(run_convonly(torch, device, net, fused_render, mlp_psf,
                             conv_cases))
    conv["share_of_bound"] = 1e3 * conv["bound_ms"] / conv["profiler_us"]
    conv["share_of_bound_cold"] = (1e3 * conv["bound_ms"]
                                   / conv["profiler_us_cold"])
    full_ms = {"f32": frame_ms, "bf16": frame16_ms}
    shares = {dt: {"mlponly_over_full": split[f"frame/{dt}/mlponly"]["ms"]
                   / full_ms[dt],
                   "convonly_over_full": conv["profiler_us"] / 1e3
                   / full_ms[dt]} for dt in full_ms}
    phase("kernel_split", t0, tol={"f32": KERNEL_TOL,
                                   "bf16_max_abs": BF16_MAX_ABS,
                                   "bf16_mean_abs": BF16_MEAN_ABS},
          modes=split, full_ms=full_ms, shares=shares)
    for tag in ("", "_cold"):
        check(conv[f"profiler_kernels{tag}"] == PROFILE_REPS,
              f"convonly{tag} under the profiler: "
              f"{conv[f'profiler_kernels{tag}']} kernels of {PROFILE_REPS} launches")
    check(conv["launches_by_case"] == {"frame/-/convonly": len(conv_cases)},
          f"convonly cases: launches {conv['launches_by_case']}")
    check(conv["shapes_ok"], "convonly cases: a shape or a non-finite value")
    for case, err in conv["max_abs_err_by_case"].items():
        check(err <= KERNEL_TOL, f"convonly {case}: vs plain {err:.3g}")
    for name, rec in split.items():
        check(rec["launches"] == 1, f"{name}: {rec['launches']} launches")
        if "/bf16/" in name:
            check(rec["max_abs_err"] <= BF16_MAX_ABS
                  and rec["mean_abs_err"] <= BF16_MEAN_ABS,
                  f"{name}: vs plain {rec['max_abs_err']:.3g}, "
                  f"mean {rec['mean_abs_err']:.3g}")
        else:
            check(rec["max_abs_err"] <= KERNEL_TOL,
                  f"{name}: vs plain {rec['max_abs_err']:.3g}")
        check(rec.get("vs_full_max_abs", 0.0) == 0.0,
              f"{name}: pipe differs from full by {rec.get('vs_full_max_abs')}")

    # ---- main path: train steps, then one eval forward -------------------
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    t0 = time.perf_counter()
    state_dict, ckpt_step = load_flax_aifnet(AIF_CKPT)
    model = AiFDepthNet().to(device)
    model.load_state_dict(state_dict)
    state = trainer.create_train_state(model, LR, EPOCHS * TRAIN_STEPS)
    train_step = trainer.make_aif_train_step("D_FS")
    eval_step = trainer.make_aif_eval_step()
    scenes = [make_scenes(BS, H, W, gen, device) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    phase("setup", t0, aifnet_checkpoint_step=ckpt_step,
          params=sum(p.numel() for p in model.parameters()))

    def train_steps(lens, scenes, step_fn, kind="stack/f32/full"):
        """Render each scene's focal stack through `lens` (the fused kernel,
        variant `kind`), then step_fn(stack, focus, depth, aif) -> losses;
        one JSON line a step."""
        reset_counts(fused_render, mlp_psf)
        steps = []
        for i, (aif, depth) in enumerate(scenes):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            focus = select_focus_dist(depth, N_STACK, mode="linear")
            stack = trainer.render_focal_stack(lens, aif, depth, focus)
            ev[1].record()
            losses = step_fn(stack, focus, depth, aif)
            ev[2].record()
            torch.cuda.synchronize()
            rec = {"step": i + 1, "loss": float(losses["total"]),
                   "skipped_nonfinite": float(losses["skipped_nonfinite"]),
                   "render_ms": ev[0].elapsed_time(ev[1]),
                   "step_ms": ev[0].elapsed_time(ev[2]),
                   "launches": dict(fused_render.variant_launches)}
            steps.append(rec)
            emit(rec)
            check(np.isfinite(rec["loss"]), f"step {i + 1}: loss {rec['loss']}")
            check(rec["skipped_nonfinite"] == 0.0, f"step {i + 1} was skipped")
            check(rec["launches"] == {kind: i + 1} and mlp_psf.launches == 0,
                  f"step {i + 1}: kernel launches {rec['launches']}")
        return steps

    def eval_once(lens, state, scene):
        """One eval forward on a scene rendered through `lens`: masked AbsRel
        and RMSE, checked finite."""
        aif, depth = scene
        focus = select_focus_dist(depth, N_STACK, mode="linear")
        stack = trainer.render_focal_stack(lens, aif, depth, focus)
        out = eval_step(state, stack, focus)
        pred = out["pred_depth"]
        mask = depth > 0
        abs_rel = float(metrics.mask_abs_rel(pred, depth, mask))
        rmse = float(metrics.mask_rmse(pred, depth, mask))
        check(np.isfinite(abs_rel) and np.isfinite(rmse),
              "non-finite eval metrics")
        check(bool(torch.isfinite(out["pred_AiF_img"]).all()), "non-finite AiF")
        return {"abs_rel": abs_rel, "rmse": rmse,
                "pred_depth": list(pred.shape),
                "pred_aif": list(out["pred_AiF_img"].shape),
                "pred_dtype": str(pred.dtype)}

    t0 = time.perf_counter()
    steps = train_steps(net, scenes[:TRAIN_STEPS], lambda stack, focus, depth, aif:
                        train_step(state, stack, focus, depth, aif))
    phase("train", t0, steps=len(steps), peak_gib=round(
        torch.cuda.max_memory_allocated() / 2 ** 30, 3),
        tf32_conv=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    scores = eval_once(net, state, scenes[TRAIN_STEPS])
    main_launches = fused_render.launches
    phase("eval", t0, **scores)
    check(dict(fused_render.variant_launches) == {
        "stack/f32/full": TRAIN_STEPS + 1} and mlp_psf.launches == 0,
        f"AiF path launches {dict(fused_render.variant_launches)}")

    # ---- the bf16 main path: PSFNet(render_dtype="bf16") and the bf16
    # AiFDepthNet trunk (compute_dtype: bf16), from the same checkpoint ----
    t0 = time.perf_counter()
    del model, state
    model16 = AiFDepthNet(dtype=trainer.trunk_dtype({"compute_dtype": "bf16"}))
    model16 = model16.to(device)
    model16.load_state_dict(state_dict)
    state16 = trainer.create_train_state(model16, LR, EPOCHS * TRAIN_STEPS)
    scenes16 = [make_scenes(BS, H, W, gen, device)
                for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps16 = train_steps(net16, scenes16[:TRAIN_STEPS],
                          lambda stack, focus, depth, aif:
                          train_step(state16, stack, focus, depth, aif),
                          kind="stack/bf16/full")
    phase("bf16_train", t0, steps=len(steps16), render_dtype=net16.render_dtype,
          trunk_dtype=str(model16.dtype),
          param_dtypes=sorted({str(p.dtype) for p in model16.parameters()}),
          peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3))
    check(all(p.dtype == torch.float32 for p in model16.parameters()),
          "the bf16 trunk's parameters left f32")

    t0 = time.perf_counter()
    scores16 = eval_once(net16, state16, scenes16[TRAIN_STEPS])
    bf16_launches = dict(fused_render.variant_launches)
    phase("bf16_eval", t0, **scores16, launches=bf16_launches)
    check(bf16_launches == {"stack/bf16/full": TRAIN_STEPS + 1}
          and mlp_psf.launches == 0, f"bf16 AiF path launches {bf16_launches}")

    # ---- DFVNet: train steps, then one validation batch ----------------
    t0 = time.perf_counter()
    del model16, state16
    state_dict, dfv_step = load_flax_dfvnet(DFV_CKPT)
    dfv = DFVNet(clean=False, level=2, use_diff=1).to(device)
    dfv.load_state_dict(state_dict)
    dfv_state = trainer.create_train_state(dfv, LR, EPOCHS * TRAIN_STEPS)
    dfv_train_step = dff_dfv.make_dfv_train_step()
    dfv_scenes = [make_scenes(BS, H, W, gen, device)
                  for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dfv_steps = train_steps(net, dfv_scenes[:TRAIN_STEPS],
                            lambda stack, focus, depth, aif:
                            dfv_train_step(dfv_state, stack, focus, depth))
    phase("dfv_train", t0, steps=len(dfv_steps), dfvnet_checkpoint_step=dfv_step,
          params=sum(p.numel() for p in dfv.parameters()),
          peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
          tf32_conv=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    scores = dff_dfv.validate_dfv(dff_dfv.make_dfv_eval_step(), dfv_state, net,
                                  dfv_scenes[TRAIN_STEPS:], N_STACK)
    dfv_launches = fused_render.launches
    phase("dfv_eval", t0, **scores)
    check(all(np.isfinite(v) for v in scores.values()),
          f"non-finite DFV metrics {scores}")
    check(dfv_launches == TRAIN_STEPS + 1, f"{dfv_launches} DFV-path launches")
    check(mlp_psf.launches == 0, "the DFV path left the fused route")

    # ---- DFVNet levels 1, 3 and 4 from a seeded init --------------------
    t0 = time.perf_counter()
    del dfv, dfv_state
    levels, levels_launches = run_dfv_levels(torch, gen, device, make_scenes,
                                             net, trainer, fused_render, mlp_psf)
    phase("dfv_levels", t0, **levels)

    # ---- the entry point as users run it: YAML config and PNG scene
    # directories -> chunked training, resume, evaluation -> checkpoints ----
    t0 = time.perf_counter()
    entry = run_entry(torch, np, gen, device, make_scenes, trainer,
                      fused_render, mlp_psf)
    entry_launches = entry["launches"]["stack/f32/full"]
    phase("entry", t0, **entry)

    # ---- DFVNet's entry point: the twin of scripts/4_* on PNG scenes -----
    t0 = time.perf_counter()
    dfv_entry = run_dfv_entry(torch, gen, device, make_scenes, trainer,
                              fused_render, mlp_psf,
                              [r["step_ms"] for r in dfv_steps])
    dfv_entry_launches = dfv_entry["launches"]["stack/f32/full"]
    phase("dfv_entry", t0, **dfv_entry)

    # ---- the thin-lens baseline: its render, and both twins under
    # configs/aber_aware_dff_synth_thinlens.yml ----------------------------
    t0 = time.perf_counter()
    thinlens, thinlens_launches = run_thinlens(torch, np, gen, device,
                                               make_scenes, fused_render, mlp_psf)
    phase("thinlens", t0, **thinlens)

    # ---- the paper's own configs: Matterport3D JPEGs -> Middlebury2014,
    # through train/dff_aif.py and train/dff_dfv.py ------------------------
    paper_launches = {}
    for family in ("aif", "dfv"):
        t0 = time.perf_counter()
        paper = run_paper_config(torch, np, gen, device, make_scenes, fused_render,
                                 mlp_psf, family)
        paper_launches[family] = paper["launches"]["stack/f32/full"]
        phase("paper_config", t0, family=family, **paper)

    # ---- data parallelism: 2 gloo ranks on the card against one process,
    # the dry-run twin under the launcher (gloo x 2, NCCL x 1), the AiF
    # paper config on 2 ranks ----------------------------------------------
    t0 = time.perf_counter()
    dp, dp_launches = run_data_parallel(torch, gen, device, make_scenes, net,
                                        fused_render, mlp_psf)
    phase("data_parallel", t0, **dp)

    # ---- AiFDepthNet's variants at full width ----------------------------
    t0 = time.perf_counter()
    variants, variants_launches = run_variants(torch, gen, device, make_scenes,
                                               net, trainer, fused_render, mlp_psf)
    phase("variants", t0, **variants)

    # ---- the lens ray tracer and PSFNet fitting --------------------------
    t0 = time.perf_counter()
    phase("optics", t0, **run_optics(torch, np, device))
    t0 = time.perf_counter()
    fit, fit_launches = run_psf_fit(torch, np, gen, device, make_scenes,
                                    fused_render, mlp_psf)
    phase("psf_fit", t0, **fit)
    t0 = time.perf_counter()
    phase("psf_gate", t0, **run_psf_gate(torch, device))

    render_src = "aadff_tpu_torch/csrc/fused_psf_render.cu"
    conv_src = "aadff_tpu_torch/csrc/psf_conv.cu"
    mlp_src = "aadff_tpu_torch/csrc/mlp_psf.cu"
    b1 = "aadff_tpu/ops/pallas_render.py:336"
    b2 = "aadff_tpu/ops/pallas_render.py:222"
    bf16_tol = {"max_abs": BF16_MAX_ABS, "mean_abs": BF16_MEAN_ABS}

    def entry(name, source, replaces, launches, err, tol, ms, plain, bound,
              library_ms=None, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err[0], **({"mean_abs_err": err[1]}
                                          if len(err) > 1 else {}),
                "tol": tol, "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms, **extra}

    def bf16_extra(kernel):
        """The bf16 stage's design, and ptxas' registers and spills of the
        kernel that ran (from this run's build; None when an earlier run
        built the library)."""
        return {"design": BF16_DESIGN, "ptxas": {kernel: ptxas.get(kernel)}}

    kernels = [
        entry("fused_psf_render", render_src, b1, main_launches, (err_stack,),
              KERNEL_TOL, kernel_ms, plain_ms, (bound_ms, bound_by),
              variant="stack/f32/full", dfv_launches=dfv_launches,
              dfv_levels_launches=levels_launches,
              entry_launches=entry_launches,
              dfv_entry_launches=dfv_entry_launches,
              thinlens_launches=thinlens_launches,
              paper_config_launches=paper_launches,
              data_parallel_launches=dp_launches,
              variants_launches=variants_launches,
              psf_fit_launches=fit_launches),
        entry("fused_psf_render_bf16", render_src, b1,
              bf16_launches["stack/bf16/full"], b1_16["stack_2x8x3x480x640"],
              bf16_tol, b1_16_ms, b1_16_plain_ms, (b1_16_bound, b1_16_bound_by),
              variant="stack/bf16/full",
              l1_px_vs_f32=b1_16_f32["stack_2x8x3x480x640"][1],
              **bf16_extra("fused_psf_render_wg<0>")),
        entry("fused_psf_render_frame", render_src, b2,
              frame_counts["frame/f32/full"], (err_ragged,), KERNEL_TOL,
              frame_ms, frame_plain_ms, (frame_bound_ms, bound_by),
              variant="frame/f32/full"),
        entry("fused_psf_render_frame_bf16", render_src, b2,
              frame_counts["frame/bf16/full"], b1_16["ragged_1x1x3x123x161"],
              bf16_tol, frame16_ms, frame16_plain_ms, frame16_bound,
              variant="frame/bf16/full", **bf16_extra("fused_psf_render_wg<0>")),
        entry("mlp_psf", mlp_src, "aadff_tpu/ops/pallas_mlp.py:100",
              route_launches["f32"], (max(mlp_err.values()),), KERNEL_TOL,
              mlp_ms, mlp_plain_ms, (mlp_bound, mlp_bound_by),
              library_ms=mlp_plain_ms, variant="f32"),
        entry("mlp_psf_bf16", mlp_src, "aadff_tpu/ops/pallas_mlp.py:100",
              route_launches["bf16"], b3_16["field_614400x4"], bf16_tol,
              b3_16_ms, b3_16_plain_ms, (b3_16_bound, b3_16_bound_by),
              library_ms=b3_16_library_ms, variant="bf16",
              l1_px_vs_f32=b3_16_f32["field_614400x4"][1],
              **bf16_extra("mlp_psf_wg")),
    ]
    conv_keys = ("profiler_us", "profiler_us_cold", "share_of_bound",
                 "share_of_bound_cold", "library_us_cold",
                 "max_abs_err_by_case")
    for name, rec in split.items():
        convonly = name == "frame/-/convonly"
        kernels.append(entry(
            f"fused_psf_render[{name.split('/', 1)[1]}]",
            conv_src if convonly else render_src,
            "aadff_tpu/ops/pallas_render.py:222 (modes :93-101)",
            rec["launches"], (rec["max_abs_err"], rec["mean_abs_err"]),
            bf16_tol if "/bf16/" in name else KERNEL_TOL, rec["ms"],
            rec["plain_ms"], (rec["bound_ms"], rec["bound_by"]),
            library_ms=rec.get("library_ms"),
            variant=name, **({"vs_full_max_abs": rec["vs_full_max_abs"]}
                             if "vs_full_max_abs" in rec else {}),
            **({"design": CONV_DESIGN,
                "library": "F.conv2d(F.pad(img, replicate), ones[C,1,ks,ks], "
                           "groups=C), TF32 off, torch.profiler device time",
                "library_names": rec["library_names"],
                "ptxas": {CONV_KERNEL: ptxas.get(CONV_KERNEL)},
                **{k: rec[k] for k in conv_keys}} if convonly else {}),
            **(bf16_extra("fused_psf_render_wg<1>" if "mlponly" in name
                          else "fused_psf_render_wg<0>") if "/bf16/" in name else {})))
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
