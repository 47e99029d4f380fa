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
DFVNet level 2 from `ckpt/dff_synth/dfvnet/depth_net_best.msgpack`), on
scenes made from the seed:

  device      the card, its power limit, torch and CUDA versions
  build       nvcc builds the kernels into build/aadff_tpu_torch/
  kernels     the fused PSF-render kernel against its plain PyTorch version
              on the card (TF32 off for both): the main-path stack
              [2,8,3,480,640] and a ragged 123x161 frame
  mlp_kernel  the PSF-MLP kernel against its plain version (TF32 off): the
              field of the first batch at one focus distance (N = 614,400
              rows) and a ragged 123x161 field
  two_stage   PSFNet.render of tests/goldens/render_goldens.npz (120x160 on
              the 480x640 PSFNet) and render_stack of a [2,8] stack at
              240x320 take field -> PSF-MLP kernel -> tap loop; the stack
              agrees with the fused kernel on the same inputs
  train       3 train steps: render the focal stack through the fused
              kernel -> AiFDepthNet forward/backward -> Adam with a cosine
              schedule and the non-finite guard
  eval        one eval forward, with masked AbsRel and RMSE
  dfv_train   3 DFVNet train steps: render through the fused kernel ->
              DFVNet forward/backward with the multi-scale loss -> Adam and
              the guard
  dfv_eval    one DFVNet validation batch: masked AbsRel, MSE, MAE, RMSE,
              acc1
Each phase prints one JSON line with its elapsed seconds; then one
{"kernels": [...]} line, the card's name and power limit as nvidia-smi gives
them, and as the last line {"ok": true, "device": {...}}.  Any failed check
or exception exits non-zero; without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PSFNET_CKPT = os.path.join(ROOT, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
AIF_CKPT = os.path.join(ROOT, "ckpt", "dff_synth", "aifnet", "depth_net_best.msgpack")
DFV_CKPT = os.path.join(ROOT, "ckpt", "dff_synth", "dfvnet", "depth_net_best.msgpack")
RENDER_GOLDENS = os.path.join(ROOT, "tests", "goldens", "render_goldens.npz")

BS, N_STACK, H, W, KS = 2, 8, 480, 640, 11   # configs/aber_aware_dff_{synth,dfv}.yml
LR, EPOCHS = 1e-4, 20
H2, W2 = 240, 320           # a stack off the sensor's size: the two-stage route
TRAIN_STEPS = 3
# Kernel against plain version: both sum in f32 but in another order (the
# kernel's 11-layer GEMMs k by k, cuBLAS in blocks), which moves outputs in
# [0, 1] by a few 1e-7.  The same holds between the two render routes.
KERNEL_TOL = 1e-5
ROWSUM_TOL = 1e-5           # PSF rows sum to 1: tests/test_pallas.py:22
GOLDEN_TOL = 2e-4           # tests/test_psfnet_render.py:143
BUDGET_S = 1000.0           # stop before the 1200 s the run may take
F32_FLOPS = 67e12           # H100 SXM, f32 on the CUDA cores, 700 W
HBM_BYTES_S = 3.35e12


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


def render_bound_ms(mlp, N, S, C, H_, W_, ks):
    """Least time the card could take for one fused render: the larger of
    operations over the f32 CUDA-core peak and bytes over memory bandwidth
    (each input read once, the output written once)."""
    linears = mlp.linears()
    macs = sum(lin.in_features * lin.out_features for lin in linears)
    ops = N * S * H_ * W_ * (2 * macs + 2 * ks * ks * C)
    n_weights = sum(lin.weight.numel() + lin.bias.numel() for lin in linears)
    nbytes = 4 * (N * C * H_ * W_ + N * H_ * W_ + N * S + n_weights
                  + N * S * C * H_ * W_)
    t_ops, t_bytes = ops / F32_FLOPS, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mlp_bound_ms(mlp, N):
    """Least time the card could take for the PSF MLP on N field rows: the
    larger of operations over the f32 CUDA-core peak and bytes over memory
    bandwidth (the field and the weights read once, the rows written once)."""
    linears = mlp.linears()
    ops = N * 2 * sum(lin.in_features * lin.out_features for lin in linears)
    n_weights = sum(lin.weight.numel() + lin.bias.numel() for lin in linears)
    nbytes = 4 * (N * 4 + n_weights + N * linears[-1].out_features)
    t_ops, t_bytes = ops / F32_FLOPS, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", t0, nvcc_s=round(built["seconds"], 3), built=built["built"],
          library=os.path.relpath(built["path"], ROOT), ptxas=ptxas)

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

    # ---- the two-stage route: frames off the sensor's size ---------------
    t0 = time.perf_counter()
    g = np.load(RENDER_GOLDENS)
    img2, depth2 = make_scenes(BS, H2, W2, gen, device)
    focus2 = select_focus_dist(depth2, N_STACK, mode="linear")
    stack_args = (img2, depth2 * -1e3, focus2 * -1e3)
    torch.cuda.synchronize()
    mlp_psf.launches = fused_render.launches = 0
    golden = net.render(g["img"], g["depth"], g["foc"]).cpu().numpy()
    golden_launches = (mlp_psf.launches, fused_render.launches)
    two_stage = net.render_stack(*stack_args)
    torch.cuda.synchronize()
    route_launches = mlp_psf.launches
    route_fused_launches = fused_render.launches
    err_golden = float(np.abs(golden - g["rendered"]).max())
    fused = fused_render.fused_psf_render(
        net.model, img2, stack_args[1][:, 0].contiguous(),
        stack_args[2].contiguous(), KS, net.d_min, net.d_max)
    err_routes = (two_stage - fused).abs().max().item()
    route_ms = time_ms(torch, lambda: net.render_stack(*stack_args), 2)
    del two_stage, fused
    phase("two_stage", t0, golden_tol=GOLDEN_TOL, tol=KERNEL_TOL,
          render_path=net.render_path((H2, W2)),
          max_abs_err={"golden_vs_rendered_120x160": err_golden,
                       f"stack_2x8x3x{H2}x{W2}_vs_fused": err_routes},
          golden_launches={"mlp_psf": golden_launches[0],
                           "fused_psf_render": golden_launches[1]},
          launches={"mlp_psf": route_launches,
                    "fused_psf_render": route_fused_launches},
          stack_ms=route_ms)
    check(err_golden < GOLDEN_TOL, f"golden: {err_golden:.3g}")
    check(golden_launches == (1, 0), f"golden launches {golden_launches}")
    check(route_launches == 1 + N_STACK and route_fused_launches == 0,
          f"two-stage stack: {route_launches} PSF-MLP launches, "
          f"{route_fused_launches} fused")
    check(err_routes <= KERNEL_TOL, f"two-stage vs fused {err_routes:.3g}")

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

    def train_steps(scenes, step_fn):
        """Render each scene's focal stack through the fused kernel, then
        step_fn(stack, focus, depth, aif) -> losses; one JSON line a step."""
        fused_render.launches = mlp_psf.launches = 0
        steps = []
        for i, (aif, depth) in enumerate(scenes):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            focus = select_focus_dist(depth, N_STACK, mode="linear")
            stack = trainer.render_focal_stack(net, aif, depth, focus)
            ev[1].record()
            losses = step_fn(stack, focus, depth, aif)
            ev[2].record()
            torch.cuda.synchronize()
            rec = {"step": i + 1, "loss": float(losses["total"]),
                   "skipped_nonfinite": float(losses["skipped_nonfinite"]),
                   "render_ms": ev[0].elapsed_time(ev[1]),
                   "step_ms": ev[0].elapsed_time(ev[2]),
                   "launches": fused_render.launches}
            steps.append(rec)
            emit(rec)
            check(np.isfinite(rec["loss"]), f"step {i + 1}: loss {rec['loss']}")
            check(rec["skipped_nonfinite"] == 0.0, f"step {i + 1} was skipped")
            check(fused_render.launches == i + 1,
                  f"step {i + 1}: {fused_render.launches} kernel launches")
        return steps

    t0 = time.perf_counter()
    steps = train_steps(scenes[:TRAIN_STEPS], lambda stack, focus, depth, aif:
                        train_step(state, stack, focus, depth, aif))
    phase("train", t0, steps=len(steps), peak_gib=round(
        torch.cuda.max_memory_allocated() / 2 ** 30, 3),
        tf32_conv=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    aif, depth = scenes[TRAIN_STEPS]
    focus = select_focus_dist(depth, N_STACK, mode="linear")
    stack = trainer.render_focal_stack(net, aif, depth, focus)
    out = eval_step(state, stack, focus)
    pred = out["pred_depth"]
    mask = depth > 0
    abs_rel = float(metrics.mask_abs_rel(pred, depth, mask))
    rmse = float(metrics.mask_rmse(pred, depth, mask))
    main_launches = fused_render.launches
    phase("eval", t0, abs_rel=abs_rel, rmse=rmse,
          pred_depth=list(pred.shape), pred_aif=list(out["pred_AiF_img"].shape))
    check(np.isfinite(abs_rel) and np.isfinite(rmse), "non-finite eval metrics")
    check(bool(torch.isfinite(out["pred_AiF_img"]).all()), "non-finite AiF")
    check(main_launches == TRAIN_STEPS + 1, f"{main_launches} launches")
    check(mlp_psf.launches == 0, "the AiF path left the fused route")

    # ---- DFVNet: train steps, then one validation batch ----------------
    t0 = time.perf_counter()
    del model, state, out, stack
    state_dict, dfv_step = load_flax_dfvnet(DFV_CKPT)
    dfv = DFVNet(clean=False, level=2, use_diff=1).to(device)
    dfv.load_state_dict(state_dict)
    dfv_state = trainer.create_train_state(dfv, LR, EPOCHS * TRAIN_STEPS)
    dfv_train_step = dff_dfv.make_dfv_train_step()
    dfv_scenes = [make_scenes(BS, H, W, gen, device)
                  for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dfv_steps = train_steps(dfv_scenes[:TRAIN_STEPS],
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

    emit({"kernels": [{
        "name": "fused_psf_render",
        "route": "cuda",
        "source": "aadff_tpu_torch/csrc/fused_psf_render.cu",
        "replaces": "aadff_tpu/ops/pallas_render.py:336",
        "also_replaces": "aadff_tpu/ops/pallas_render.py:222",
        "launches": main_launches,
        "dfv_launches": dfv_launches,
        "max_abs_err": err_stack,
        "tol": KERNEL_TOL,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "mlp_psf",
        "route": "cuda",
        "source": "aadff_tpu_torch/csrc/mlp_psf.cu",
        "replaces": "aadff_tpu/ops/pallas_mlp.py:100",
        "launches": route_launches,
        "max_abs_err": max(mlp_err.values()),
        "tol": KERNEL_TOL,
        "ms": mlp_ms,
        "plain_ms": mlp_plain_ms,
        "bound_ms": mlp_bound,
        "bound_by": mlp_bound_by,
        "library_ms": mlp_plain_ms,
    }]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
