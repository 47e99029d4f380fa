"""The paper's own run configurations, configs/aber_aware_dff_aif.yml and
configs/aber_aware_dff_dfv.yml (Matterport3D -> Middlebury2014), through
the port's `train/dff_aif.py:train` and `train/dff_dfv.py:train` against
the JAX package's `train`, on the CPU, for one epoch (two training passes
around one validation, as both loops run `epochs + 1` passes).

The data is Matterport3D's layout written by the test with cv2: 4 colour
frames as real JPEGs (4:2:0, q95) and 16-bit depth PNGs in units of 1/4000
m, and Middlebury2014's layout of 2 scenes for validation.  Only `res` is
cut (AiF 32x64, DFV 64x64: DFVNet's pyramid pools need 64 pixels a side),
and the lens and checkpoint paths are made absolute; bs 2, n_stack 8, ks
11 and lr 1e-4 stay the configs'.  Both packages start from the same
weights, with Adam at count 0: AiF from a JAX train state of the trained
AiFDepthNet given as `dffnet_pretrained`; DFV, whose `train` loads no
pretrained net, from the trained DFVNet put in place of each package's
initial state in the test.  (From a random init the first Adam step moves
every weight by lr, also those whose gradients are f32 noise and differ
in sign between the packages: the DFV losses then part by 2.7e-3 by the
fourth step.)  JAX's native rotation is switched off in the test, so both
augment with scipy from the same numpy draws.

The losses of the 4 steps (spied on the step functions) agree within rtol
1e-3, and the validation metrics within rtol 1e-3 (continuous) and 2e-3
(acc1-3), PSNR/SSIM within 0.01 dB / 5e-4, as tests/test_torch_entry.py
holds the AiF twin (the weights are two Adam steps from the start, and
carry the trajectory's f32 noise).
"""
import logging
import os
import random
import re
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore

import aadff_tpu.dff.native_ops as jax_native_ops
from aadff_tpu.train import dff_aif as jax_dff_aif
from aadff_tpu.train import dff_dfv as jax_dff_dfv
from aadff_tpu.train import trainer as jax_trainer
from aadff_tpu_torch.models.dfv.convert import load_flax_dfvnet
from aadff_tpu_torch.train import dff_aif, dff_dfv, trainer
from aadff_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIF_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "aifnet", "depth_net_best.msgpack")
DFV_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "dfvnet", "depth_net_best.msgpack")
RES = {"aif": (32, 64), "dfv": (64, 64)}
DEPTH_KEYS = ("abs_rel", "sq_rel", "mse", "mae", "rmse", "rmse_log")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it, and a CPU train step then runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each run writes ~2 GB of train states (both packages, last/best):
    removed after the test, pass or fail, so that kept test directories do
    not fill the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _frame(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w] / np.array([h, w])[:, None, None]
    img = np.stack([128 + 90 * np.sin(20 * xx + 7 * yy + c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def _depth_mm(seed, h, w, scale):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w] / np.array([h, w])[:, None, None]
    depth = 0.7 + 2.0 * xx + 0.4 * yy * (seed % 3)
    depth[rng.uniform(size=(h, w)) < 0.05] = 0
    return (depth * scale).astype(np.uint16)


def _layout(root, h, w):
    """Matterport3D (2 scenes x 2 JPEG frames) and Middlebury2014 (2
    scenes) a little larger than `res`, so that both sets resize."""
    for s in range(2):
        rgb = root / "mp" / "aif" / f"scene{s}" / "undistorted_color_images"
        dep = root / "mp" / "depth" / f"scene{s}" / "render_depth"
        rgb.mkdir(parents=True)
        dep.mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(rgb / f"f{i}.jpg"), _frame(2 * s + i, h, w),
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
            cv2.imwrite(str(dep / f"f{i}.png"), _depth_mm(2 * s + i, h, w, 4000))
    for s in range(2):
        d = root / "mb" / f"scene{s}"
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "im0.png"), _frame(10 + s, h, w))
        cv2.imwrite(str(d / "depth.png"), _depth_mm(10 + s, h, w, 1000))


def _args(tmp_path, family, workdir):
    args = load_config(os.path.join(REPO, "configs", f"aber_aware_dff_{family}.yml"))
    assert args["train"]["dataset"] == "Matterport3D"
    assert args["test"]["dataset"] == "Middlebury2014"
    assert (args["bs"], args["n_stack"], args["ks"]) == (2, 8, 11)
    for section in ("train", "test"):
        for key in ("lens", "psfnet_path"):
            args[section][key] = os.path.join(REPO, args[section][key])
    args.update(res=RES[family], epochs=1, results_dir=str(tmp_path / workdir),
                train_aif_dir=str(tmp_path / "mp" / "aif"),
                train_depth_dir=str(tmp_path / "mp" / "depth"),
                Middlebury2014_val=str(tmp_path / "mb"))
    return args


def _spy(module, name, losses):
    """Wrap module.name (a train-step factory) so that each step's total
    loss is appended to `losses`."""
    make = getattr(module, name)

    def spied(*a, **k):
        step = make(*a, **k)

        def run(*args):
            out = step(*args)
            result = out[1] if isinstance(out, tuple) else out
            losses.append(float(result["total"]))
            return out
        return run
    return spied


def _metrics(records):
    """{name: value} of the `Avg_<name>(<epoch>): <value>` log lines."""
    out = {}
    for r in records:
        m = re.fullmatch(r"Avg_(\w+)\(\d+\): (\S+)", r.getMessage())
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def _seed():
    random.seed(126)
    np.random.seed(126)


def _run(caplog, fn):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        _seed()
        fn()
    return _metrics(caplog.records)


def _assert_close(ours, ref, losses, ref_losses, keys):
    assert len(losses) == len(ref_losses) == 4
    rel = np.abs(np.subtract(losses, ref_losses)) / np.abs(ref_losses)
    print("measured: loss rel", np.array2string(rel, precision=2),
          {k: abs(ours[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in keys})
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    for k in keys:
        if k.startswith("acc"):
            assert abs(ours[k] - ref[k]) <= 2e-3, (k, ours[k], ref[k])
        elif k == "psnr":
            assert abs(ours[k] - ref[k]) <= 0.01
        elif k == "ssim":
            assert abs(ours[k] - ref[k]) <= 5e-4
        else:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, err_msg=k)


def test_aif_paper_config_epoch_matches_jax(tmp_path, caplog, monkeypatch):
    monkeypatch.setattr(jax_native_ops, "available", lambda: False)
    _layout(tmp_path, 40, 72)
    with open(AIF_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    params = jax.tree.map(jnp.asarray, v["params"])
    opt = optax.adam(optax.cosine_decay_schedule(1e-4, 2, alpha=0.0))
    init = jax_trainer.TrainState(
        params=params, batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=opt.init(params), step=jnp.zeros((), jnp.int32))
    jax_trainer.save_checkpoint(str(tmp_path / "init"), init, "init")
    pretrained = str(tmp_path / "init" / "depth_net_init.msgpack")

    ref_losses, losses = [], []
    monkeypatch.setattr(jax_dff_aif, "make_aif_train_step",
                        _spy(jax_dff_aif, "make_aif_train_step", ref_losses))
    monkeypatch.setattr(dff_aif, "make_aif_train_step",
                        _spy(dff_aif, "make_aif_train_step", losses))
    ref_args, args = (_args(tmp_path, "aif", d) for d in ("jax", "port"))
    for a in (ref_args, args):
        a["train"]["dffnet_pretrained"] = pretrained
    ref = _run(caplog, lambda: jax_dff_aif.train(ref_args))
    ours = _run(caplog, lambda: dff_aif.train(args, device="cpu"))
    assert set(ours) == set(ref) - {"lpips"}
    _assert_close(ours, ref, losses, ref_losses,
                  DEPTH_KEYS + ("acc1", "acc2", "acc3", "psnr", "ssim"))
    for name in ("last", "best", "best_acc1"):
        assert (tmp_path / "port" / f"depth_net_{name}.pt").exists()


def test_dfv_paper_config_epoch_matches_jax(tmp_path, caplog, monkeypatch):
    monkeypatch.setattr(jax_native_ops, "available", lambda: False)
    _layout(tmp_path, 72, 80)
    # both start from the trained DFVNet, with Adam at count 0
    with open(DFV_CKPT, "rb") as f:
        v = msgpack_restore(f.read())

    def jax_state(model, optimizer, *_):
        params = jax.tree.map(jnp.asarray, v["params"])
        return jax_trainer.TrainState(
            params=params, batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
            opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))

    def port_state(model, lr, steps):
        model.load_state_dict(load_flax_dfvnet(DFV_CKPT)[0])
        return trainer.create_train_state(model, lr, steps)

    monkeypatch.setattr(jax_dff_dfv, "create_train_state", jax_state)
    monkeypatch.setattr(dff_dfv, "create_train_state", port_state)

    ref_losses, losses = [], []
    monkeypatch.setattr(jax_dff_dfv, "make_dfv_train_step",
                        _spy(jax_dff_dfv, "make_dfv_train_step", ref_losses))
    monkeypatch.setattr(dff_dfv, "make_dfv_train_step",
                        _spy(dff_dfv, "make_dfv_train_step", losses))
    ref_args, args = (_args(tmp_path, "dfv", d) for d in ("jax", "port"))
    ref = _run(caplog, lambda: jax_dff_dfv.train(ref_args))
    ours = _run(caplog, lambda: dff_dfv.train(args, device="cpu"))
    assert set(ours) == set(ref) == set(dff_dfv.METRICS)
    _assert_close(ours, ref, losses, ref_losses, dff_dfv.METRICS)
    for name in ("last", "best"):
        assert (tmp_path / "port" / f"depth_net_{name}.pt").exists()
