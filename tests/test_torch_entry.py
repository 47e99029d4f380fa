"""The port's entry script, `python -m aadff_tpu_torch.scripts.aber_aware_dff_synth`,
on the CPU (`--device cpu`) at 32x64 with 4 frames, on SynthMiddlebury-
layout scenes that the test writes with cv2 (4 train, 2 val):
  * a chunk, its resume with K = 2 steps per call and `--eval-only` keep
    the JAX script's file contract (progress.json, train_log.jsonl,
    metrics.jsonl, eval_final.json, depth_net_{state,best,best_acc1});
  * without a GPU and without `--device cpu` it stops with an error;
  * one epoch of the twin against one epoch of
    `scripts/3_aber_aware_dff_synth.py` (run in-process with runpy), both
    resuming from the same JAX train state that the test writes, on the
    same scenes and the same augmentation draws (JAX's native rotation
    switched off in the test, so that both rotate with scipy).  The epoch
    loss agrees within rtol 1e-3 (tests/test_torch_trainer.py) and
    PSNR/SSIM within 0.01 dB and 5e-4 (tests/test_torch_validate.py).  The
    depth metrics are those of weights two Adam steps apart in the two
    packages, which carry the trajectory's relative noise (ROADMAP C): the
    continuous ones agree within rtol 1e-3, and acc1-3 within 2e-3, four
    of a scene's ~1,950 valid pixels crossing a 1.25^k threshold (measured:
    sq_rel 1.2e-4 apart, acc1 5e-4, one pixel).
"""
import json
import os
import runpy
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore

import aadff_tpu.dff.native_ops as jax_native_ops
from aadff_tpu.train import trainer as jax_trainer
from aadff_tpu_torch.scripts import aber_aware_dff_synth as twin
from aadff_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "aber_aware_dff_synth.yml")
JAX_SCRIPT = os.path.join(REPO, "scripts", "3_aber_aware_dff_synth.py")
AIF_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "aifnet", "depth_net_best.msgpack")
DEPTH_KEYS = ("abs_rel", "sq_rel", "mse", "mae", "rmse", "rmse_log",
              "acc1", "acc2", "acc3")
METRIC_KEYS = set(DEPTH_KEYS) | {"psnr", "ssim", "avg_time", "epoch"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it, and a CPU train step then runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_scenes(root, seed=0, h=40, w=72):
    """SynthMiddlebury layout, a little larger than the 32x64 the config
    asks for, so that the datasets resize."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w] / np.array([h, w])[:, None, None]
    for split, n in (("train", 4), ("val", 2)):
        for i in range(n):
            d = root / split / f"scene{i}"
            d.mkdir(parents=True)
            img = 0.6 * rng.integers(0, 256, (h, w, 3)) + 100 * (
                np.sin(25 * xx + 3 * i)[..., None] > 0)
            cv2.imwrite(str(d / "im0.png"), img.astype(np.uint8))
            depth = 700 + 2000 * xx + 900 * yy * (i + 1) / n
            depth[rng.uniform(size=(h, w)) < 0.05] = 0
            cv2.imwrite(str(d / "depth.png"), depth.astype(np.uint16))


@pytest.fixture
def config(tmp_path):
    """A copy of configs/aber_aware_dff_synth.yml at 32x64, 4 frames, with
    absolute paths and its SynthMiddlebury sets in tmp_path."""
    _write_scenes(tmp_path / "data")
    text = open(CONFIG).read()
    for old, new in (("n_stack: 8", "n_stack: 4"), ("[480, 640]", "[32, 64]"),
                     ("'./lenses/", f"'{REPO}/lenses/"),
                     ("'./ckpt/", f"'{REPO}/ckpt/"),
                     ("'./datasets/SynthMiddlebury/", f"'{tmp_path}/data/")):
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / "config.yml"
    path.write_text(text)
    return str(path)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _twin(config, workdir, *flags):
    return twin.main(["--config", config, "--workdir", str(workdir),
                      "--device", "cpu", *flags])


def test_twin_chunks_resume_and_eval_keep_the_file_contract(tmp_path, config):
    wd = tmp_path / "wd"
    state1 = _twin(config, wd, "--epochs-per-chunk", "1", "--total-epochs", "2")
    assert json.load(open(wd / "progress.json"))["epoch"] == 1
    saved = trainer.load_checkpoint(
        str(wd), trainer.create_train_state(type(state1.model)(), 1e-4, 4), "state")
    a, b = state1.model.state_dict(), saved.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(state1.opt.mu + state1.opt.nu,
                                                  saved.opt.mu + saved.opt.nu))
    assert int(saved.step) == 2 and int(saved.opt.schedule_count) == 2

    state2 = _twin(config, wd, "--epochs-per-chunk", "1", "--total-epochs", "2",
                   "--k-per-dispatch", "2")
    progress = json.load(open(wd / "progress.json"))
    assert progress["epoch"] == 2 and int(state2.step) == 4
    log = _jsonl(wd / "train_log.jsonl")
    assert [r["epoch"] for r in log] == [1, 2]
    for r in log:
        assert r["steps"] == 2 and r["skipped"] == 0 and np.isfinite(r["loss"])
        assert len(r["step_ms"]) == 2
    metrics = _jsonl(wd / "metrics.jsonl")
    assert [m["epoch"] for m in metrics] == [1, 2]
    for m in metrics:
        assert set(m) == METRIC_KEYS and all(np.isfinite(v) for v in m.values())
    assert progress["mse_min"] == min(m["mse"] for m in metrics)
    # the chunk is done: a further call trains nothing
    assert _twin(config, wd, "--total-epochs", "2") is None

    _twin(config, wd, "--eval-only", "best")
    final = json.load(open(wd / "eval_final.json"))
    assert final["ckpt"] == "best" and set(final) == METRIC_KEYS - {"epoch"} | {"ckpt"}
    names = sorted(os.listdir(wd))
    for f in ("depth_net_state.pt", "depth_net_best.pt", "depth_net_best_acc1.pt",
              "progress.json", "train_log.jsonl", "metrics.jsonl",
              "eval_final.json"):
        assert f in names
    assert sorted(os.listdir(wd / "results")) == sorted(
        f"img{i}_{t}.png" for i in range(2) for t in ("pred", "gt", "pred_aif", "gt_aif"))


def test_twin_without_cuda_stops(tmp_path, config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        twin.main(["--config", config, "--workdir", str(tmp_path / "wd")])
    assert not (tmp_path / "wd").exists()


def _jax_state_msgpack(workdir):
    """A JAX train state at the end of epoch 1 (2 steps of 4 in all): the
    trained AiFDepthNet weights, Adam moments that are not zero, both counts
    2; with progress.json at epoch 1."""
    with open(AIF_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    params = jax.tree.map(jnp.asarray, v["params"])
    opt = optax.adam(optax.cosine_decay_schedule(1e-4, 4, alpha=0.0))
    adam, sched = opt.init(params)
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(0, 1e-4, a.shape).astype(np.float32)), params)
    nu = jax.tree.map(lambda a: jnp.asarray(
        np.abs(rng.normal(0, 1e-8, a.shape)).astype(np.float32)), params)
    state = jax_trainer.TrainState(
        params=params, batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=(adam._replace(count=jnp.asarray(2), mu=mu, nu=nu),
                   sched._replace(count=jnp.asarray(2))),
        step=jnp.asarray(2, jnp.int32))
    os.makedirs(workdir)
    jax_trainer.save_checkpoint(str(workdir), state, "state")
    with open(os.path.join(workdir, "progress.json"), "w") as f:
        json.dump({"epoch": 1, "mse_min": 1e9, "acc1_max": 0.0}, f)


def test_twin_epoch_matches_jax_script(tmp_path, config, monkeypatch):
    monkeypatch.setattr(jax_native_ops, "available", lambda: False)
    _jax_state_msgpack(tmp_path / "jax")
    _jax_state_msgpack(tmp_path / "port")
    flags = ["--config", config, "--epochs-per-chunk", "1", "--total-epochs", "2"]
    monkeypatch.setattr(sys, "argv", [JAX_SCRIPT, *flags,
                                      "--workdir", str(tmp_path / "jax")])
    runpy.run_path(JAX_SCRIPT, run_name="__main__")
    state = twin.main([*flags, "--workdir", str(tmp_path / "port"),
                       "--device", "cpu"])
    assert int(state.step) == 4
    ref_log, log = (_jsonl(tmp_path / d / "train_log.jsonl") for d in ("jax", "port"))
    assert [r["steps"] for r in log] == [r["steps"] for r in ref_log] == [2]
    assert log[0]["skipped"] == ref_log[0]["skipped"] == 0
    np.testing.assert_allclose(log[0]["loss"], ref_log[0]["loss"], rtol=1e-3)
    ref, ours = (_jsonl(tmp_path / d / "metrics.jsonl")[0] for d in ("jax", "port"))
    assert set(ours) == set(ref) == METRIC_KEYS
    for k in DEPTH_KEYS[:6]:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, err_msg=k)
    for k in DEPTH_KEYS[6:]:
        assert abs(ours[k] - ref[k]) <= 2e-3, (k, ours[k], ref[k])
    assert abs(ours["psnr"] - ref["psnr"]) <= 0.01
    assert abs(ours["ssim"] - ref["ssim"]) <= 5e-4
    assert json.load(open(tmp_path / "port" / "progress.json"))["epoch"] == 2
