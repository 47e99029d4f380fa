"""The port's DFV training entry points on the CPU against the JAX package:
K DFV steps per call, `train/dff_dfv.py:train`, and the twin of
`scripts/4_aber_aware_dff_dfv_synth.py`,
`python -m aadff_tpu_torch.scripts.aber_aware_dff_dfv_synth`, at 64x64
with 4 frames (DFVNet's pyramid pooling needs 64 pixels a side) on
SynthMiddlebury-layout scenes that the test writes with cv2 (4 train, 2
val):
  * a chunk, its resume with K = 2 steps per call and `--eval-only` keep
    the JAX script's file contract (progress.json, train_log.jsonl,
    metrics.jsonl, eval_final.json, depth_net_{state,best},
    results/img{i}_{pred,gt}.png);
  * one epoch of the twin against one epoch of the JAX script (run
    in-process with runpy), both resuming from the same JAX DFV train state
    that the test writes, on the same scenes and augmentation draws (JAX's
    native rotation switched off in the test).  The loss agrees within rtol
    1e-3 and the metrics within rtol 1e-3, acc1 within 2e-3, as
    tests/test_torch_entry.py holds the AiF twin (weights two Adam steps
    apart carry the trajectory's relative noise, ROADMAP C).
"""
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore

import aadff_tpu.dff.native_ops as jax_native_ops
from aadff_tpu.train import trainer as jax_trainer
from aadff_tpu_torch.dff.dataset import Middlebury, NumpyLoader
from aadff_tpu_torch.models.dfv.dffnet import DFVNet
from aadff_tpu_torch.psfnet.psfnet import ThinLens
from aadff_tpu_torch.scripts import aber_aware_dff_dfv_synth as twin
from aadff_tpu_torch.train import dff_dfv, trainer
from test_torch_entry import _jsonl, _write_scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "aber_aware_dff_synth.yml")
JAX_SCRIPT = os.path.join(REPO, "scripts", "4_aber_aware_dff_dfv_synth.py")
DFV_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "dfvnet", "depth_net_best.msgpack")
METRIC_KEYS = set(dff_dfv.METRICS) | {"epoch"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it, and a CPU train step then runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_config(tmp_path, source=CONFIG):
    """A copy of a SynthMiddlebury run config at 64x64, 4 frames, with
    absolute paths and its SynthMiddlebury sets (4 train, 2 val scenes of
    72x80, so that the datasets resize) in tmp_path."""
    _write_scenes(tmp_path / "data", h=72, w=80)
    text = open(source).read()
    for old, new in (("n_stack: 8", "n_stack: 4"), ("[480, 640]", "[64, 64]"),
                     ("'./lenses/", f"'{REPO}/lenses/"),
                     ("'./ckpt/", f"'{REPO}/ckpt/"),
                     ("'./datasets/SynthMiddlebury/", f"'{tmp_path}/data/")):
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / "config.yml"
    path.write_text(text)
    return str(path)


@pytest.fixture
def config(tmp_path):
    return write_config(tmp_path)


def _twin(config, workdir, *flags):
    return twin.main(["--config", config, "--workdir", str(workdir),
                      "--device", "cpu", *flags])


def test_dfv_k_steps_per_call_equal_k_single_steps():
    """5 batches, K = 2 (two calls and a tail of one single step), a NaN
    batch inside a call, through the thin lens as
    tests/test_trainer_multistep.py:139 holds JAX: the same per-step
    losses, skips and final state as 5 single steps, bit for bit (the port's
    K-step call is a loop of the same step)."""
    H, W, S, B = 64, 64, 3, 2
    lens = ThinLens(50.0, 1.8, 11, [25.968, 25.968], (H, W), device="cpu")
    rng = np.random.default_rng(19)
    batches = []
    for i in range(5):
        aif = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
        depth = rng.uniform(0.6, 2.9, (B, 1, H, W)).astype(np.float32)
        if i == 2:
            aif[:] = np.nan  # the guard skips it inside a call too
        fds = np.broadcast_to(np.linspace(0.5, 3.0, S, dtype=np.float32), (B, S))
        batches.append([torch.from_numpy(np.ascontiguousarray(a))
                        for a in (aif, depth, fds)])

    def fresh():
        torch.manual_seed(9)
        return trainer.create_train_state(DFVNet(), 1e-3, 8)

    single = dff_dfv.make_dfv_train_step()
    s1, recs1 = fresh(), []
    for aif, depth, fds in batches:
        stack = trainer.render_focal_stack(lens, aif, depth, fds)
        losses = single(s1, stack, fds, depth)
        recs1.append((float(losses["total"]), float(losses["skipped_nonfinite"])))

    multi = dff_dfv.make_dfv_train_multi_step(lens)
    sk, recsk = fresh(), []
    for g in range(2):
        losses = multi(sk, *(torch.stack(x) for x in zip(*batches[2 * g:2 * g + 2])))
        assert losses["total"].shape == (2,)
        recsk += list(zip(losses["total"].tolist(),
                          losses["skipped_nonfinite"].tolist()))
    aif, depth, fds = batches[4]
    losses = single(sk, trainer.render_focal_stack(lens, aif, depth, fds), fds,
                    depth)
    recsk.append((float(losses["total"]), float(losses["skipped_nonfinite"])))

    assert recs1 == recsk
    assert recs1[2] == (0.0, 1.0) and sum(s for _, s in recsk) == 1.0
    assert int(s1.step) == int(sk.step) == 5
    assert int(sk.opt.count) == int(sk.opt.schedule_count) == 4
    a, b = s1.model.state_dict(), sk.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in
               zip(s1.opt.mu + s1.opt.nu, sk.opt.mu + sk.opt.nu))


def test_dff_dfv_train_runs_the_skeleton(tmp_path, monkeypatch):
    """`train/dff_dfv.py:train` on the CPU with the skeleton of
    tests/test_dfv_integration.py (two 64x64 scenes, bs 2, 4 frames, the
    thin lens): epochs 1 runs two training passes around one validation,
    as the JAX loop does; finite losses, none skipped; depth_net_last and
    _best; the validation metrics finite and the RMSE in (0, 10)."""
    _write_scenes(tmp_path / "data", h=64, w=64)
    thin = {"lens": "thinlens", "foc_len": 50.0, "fnum": 1.8,
            "sensor_size": ["25.968", "25.968"], "dataset": "SynthMiddlebury"}
    args = {"bs": 2, "n_stack": 4, "res": (64, 64), "ks": 11, "lr": "1e-4",
            "epochs": 1, "train": dict(thin), "test": dict(thin),
            "SynthMiddlebury_train": str(tmp_path / "data" / "val"),
            "SynthMiddlebury_val": str(tmp_path / "data" / "val"),
            "results_dir": str(tmp_path / "run")}
    os.makedirs(args["results_dir"])
    seen = []
    step = dff_dfv.make_dfv_train_step

    def spy():
        inner = step()

        def train_step(state, stack, fds, depth):
            losses = inner(state, stack, fds, depth)
            seen.append((float(losses["total"]), float(losses["skipped_nonfinite"])))
            return losses

        return train_step

    monkeypatch.setattr(dff_dfv, "make_dfv_train_step", spy)
    state = dff_dfv.train(args, device="cpu")
    assert int(state.step) == 2 and state.model.level == 2
    assert all(np.isfinite(t) and s == 0.0 for t, s in seen) and len(seen) == 2
    for name in ("last", "best"):
        assert (tmp_path / "run" / f"depth_net_{name}.pt").exists()
    scores = dff_dfv.validate_dfv(
        dff_dfv.make_dfv_eval_step(), state,
        ThinLens(50.0, 1.8, 11, [25.968, 25.968], (64, 64), device="cpu"),
        _val_batches(tmp_path), 4, 1, args)
    assert all(np.isfinite(scores[k]) for k in ("abs_rel", "mse", "acc1"))
    assert 0 < scores["rmse"] < 10


def _val_batches(tmp_path):
    return NumpyLoader(Middlebury(str(tmp_path / "data" / "val"), resize=(64, 64)),
                       batch_size=1)


def test_dfv_twin_chunks_resume_and_eval_keep_the_file_contract(tmp_path, config):
    wd = tmp_path / "wd"
    state1 = _twin(config, wd, "--epochs-per-chunk", "1", "--total-epochs", "2")
    assert json.load(open(wd / "progress.json"))["epoch"] == 1
    saved = trainer.load_checkpoint(
        str(wd), trainer.create_train_state(DFVNet(), 1e-4, 4), "state")
    a, b = state1.model.state_dict(), saved.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(state1.opt.mu + state1.opt.nu,
                                                  saved.opt.mu + saved.opt.nu))
    assert int(saved.step) == 2 and int(saved.opt.schedule_count) == 2

    state2 = _twin(config, wd, "--epochs-per-chunk", "1", "--total-epochs", "2",
                   "--k-per-dispatch", "2")
    progress = json.load(open(wd / "progress.json"))
    assert progress["epoch"] == 2 and int(state2.step) == 4
    assert set(progress) == {"epoch", "mse_min"}
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
    assert _twin(config, wd, "--total-epochs", "2") is None

    _twin(config, wd, "--eval-only", "best")
    final = json.load(open(wd / "eval_final.json"))
    assert final["ckpt"] == "best"
    assert set(final) == {"abs_rel", "mse", "rmse", "acc1", "ckpt"}
    assert all(np.isfinite(final[k]) for k in ("abs_rel", "mse", "rmse", "acc1"))
    names = sorted(os.listdir(wd))
    for f in ("depth_net_state.pt", "depth_net_best.pt", "progress.json",
              "train_log.jsonl", "metrics.jsonl", "eval_final.json"):
        assert f in names
    assert sorted(os.listdir(wd / "results")) == sorted(
        f"img{i}_{t}.png" for i in range(2) for t in ("pred", "gt"))


def test_dfv_twin_without_cuda_stops(tmp_path, config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        twin.main(["--config", config, "--workdir", str(tmp_path / "wd")])
    assert not (tmp_path / "wd").exists()


def _jax_dfv_state_msgpack(workdir):
    """A JAX DFV train state at the end of epoch 1 (2 steps of 4 in all):
    the trained DFVNet weights, Adam moments that are not zero, both counts
    2; with progress.json at epoch 1."""
    with open(DFV_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    params = jax.tree.map(jnp.asarray, v["params"])
    opt = optax.adam(optax.cosine_decay_schedule(1e-4, 4, alpha=0.0))
    adam, sched = opt.init(params)
    rng = np.random.default_rng(6)
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
        json.dump({"epoch": 1, "mse_min": 1e9}, f)


def test_dfv_twin_epoch_matches_jax_script(tmp_path, config, monkeypatch):
    """One epoch from the same JAX train state (the twin resumes from the
    msgpack, having no .pt): losses within rtol 1e-3, metrics within rtol
    1e-3 and acc1 within 2e-3."""
    monkeypatch.setattr(jax_native_ops, "available", lambda: False)
    _jax_dfv_state_msgpack(tmp_path / "jax")
    _jax_dfv_state_msgpack(tmp_path / "port")
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
    print(f"measured: DFV epoch loss port {log[0]['loss']} JAX {ref_log[0]['loss']}")
    np.testing.assert_allclose(log[0]["loss"], ref_log[0]["loss"], rtol=1e-3)
    ref, ours = (_jsonl(tmp_path / d / "metrics.jsonl")[0] for d in ("jax", "port"))
    assert set(ours) == set(ref) == METRIC_KEYS
    print("measured: DFV metrics " + ", ".join(
        f"{k} {abs(ours[k] - ref[k]) / abs(ref[k]):.3g}" for k in dff_dfv.METRICS))
    for k in ("abs_rel", "mse", "mae", "rmse"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, err_msg=k)
    assert abs(ours["acc1"] - ref["acc1"]) <= 2e-3, (ours["acc1"], ref["acc1"])
    assert json.load(open(tmp_path / "port" / "progress.json"))["epoch"] == 2
