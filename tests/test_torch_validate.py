"""The port's `validate` against the JAX package's, on the same AiFDepthNet
weights (`ckpt/dff_synth/aifnet/depth_net_best.msgpack`, converted), the
same PSFNet and the same scene files, on the CPU at 32x64 with 4 frames.

Tolerances:
  * depth metrics: rtol 1e-4 (f32 convolutions sum in another order in
    PyTorch than in XLA; tests/test_torch_aifnet.py);
  * PSNR and SSIM of the same `pred_AiF_img` arrays: within 1e-10;
  * PSNR and SSIM end to end: the two packages' AiF predictions differ by
    ~1e-6, which flips the uint8 rounding of a few of the 6,144 samples a
    scene.  One flip moves the squared error by up to (2|e| + 1) / 6144, so
    PSNR by up to ~0.005 dB at these errors and SSIM by ~1e-4; both are
    also rounded to 4 decimals (batch_PSNR, batch_SSIM).  Held at 0.01 dB
    and 5e-4.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.dff import dataset as jax_dataset
from aadff_tpu.dff import metrics as jax_metrics
from aadff_tpu.models.aifnet import AiFDepthNet as JaxAiFDepthNet
from aadff_tpu.psfnet import PSFNet as JaxPSFNet
from aadff_tpu.train import trainer as jax_trainer
from aadff_tpu_torch.dff import dataset, metrics
from aadff_tpu_torch.dff.focus import select_focus_dist
from aadff_tpu_torch.models.aifnet import AiFDepthNet
from aadff_tpu_torch.models.convert import load_flax_aifnet
from aadff_tpu_torch.psfnet.psfnet import PSFNet
from aadff_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIF_CKPT = os.path.join(REPO, "ckpt", "dff_synth", "aifnet",
                        "depth_net_best.msgpack")
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")
LENS = os.path.join(REPO, "lenses", "rf50mm.json")
S, H, W = 4, 32, 64
DEPTH_KEYS = ("abs_rel", "sq_rel", "mse", "mae", "rmse", "rmse_log",
              "acc1", "acc2", "acc3")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it, and a CPU train step then runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scenes(root, n=3, seed=0):
    """Middlebury-layout scenes: textured RGB and a depth plane with blobs,
    in mm, some pixels invalid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W] / np.array([H, W])[:, None, None]
    for i in range(n):
        d = root / f"scene{i}"
        d.mkdir(parents=True)
        img = rng.integers(0, 256, (H, W, 3)).astype(np.float64)
        img = 0.5 * img + 0.5 * 255 * (np.sin(20 * xx + i)[..., None] > 0)
        cv2.imwrite(str(d / "im0.png"), img.astype(np.uint8))
        depth = 800 + 1500 * xx + 600 * yy + rng.uniform(0, 50, (H, W))
        depth[rng.uniform(size=(H, W)) < 0.05] = 0
        cv2.imwrite(str(d / "depth.png"), depth.astype(np.uint16))
    return str(root)


@pytest.fixture(scope="module")
def both():
    """(JAX eval step, JAX state, JAX lens, port eval step, port state,
    port lens) from the same weights."""
    with open(AIF_CKPT, "rb") as f:
        v = msgpack_restore(f.read())
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = jax_trainer.TrainState(
        params=params, batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=optax.adam(1e-4).init(params), step=jnp.zeros((), jnp.int32))
    jlens = JaxPSFNet(LENS, kernel_size=11, sensor_res=(H, W))
    jlens.load_net(PSFNET_CKPT)
    net = AiFDepthNet()
    net.load_state_dict(load_flax_aifnet(AIF_CKPT)[0])
    state = trainer.create_train_state(net, 1e-4, 10)
    lens = PSFNet(kernel_size=11, sensor_res=(H, W), device="cpu")
    lens.load_net(PSFNET_CKPT)
    return (jax_trainer.make_aif_eval_step(JaxAiFDepthNet(n_stack=S)), jstate,
            jlens, trainer.make_aif_eval_step(), state, lens)


def test_validate_matches_jax(tmp_path, both):
    jeval, jstate, jlens, peval, state, lens = both
    root = _scenes(tmp_path / "val")
    out = {}
    for name, ds_mod, ev, st, ln, fn in (
            ("jax", jax_dataset, jeval, jstate, jlens, jax_trainer.validate),
            ("port", dataset, peval, state, lens, trainer.validate)):
        args = {"results_dir": str(tmp_path / name)}
        loader = ds_mod.NumpyLoader(ds_mod.Middlebury(root, resize=(H, W)),
                                    batch_size=1)
        out[name] = fn(ev, st, ln, loader, S, 1, args, save_images=True)
    ref, ours = out["jax"], out["port"]
    assert set(ours) == set(ref) == set(DEPTH_KEYS) | {"psnr", "ssim", "avg_time"}
    for k in DEPTH_KEYS:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    assert abs(ours["psnr"] - ref["psnr"]) <= 0.01
    assert abs(ours["ssim"] - ref["ssim"]) <= 5e-4
    assert all(np.isfinite(v) for v in ours.values())
    names = sorted(os.listdir(tmp_path / "port" / "results"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "results"))
    assert names == sorted(f"img{i}_{tag}.png" for i in range(3)
                           for tag in ("pred", "gt", "pred_aif", "gt_aif"))
    for i in range(3):  # the same ground truth gives the same files
        for tag in ("gt", "gt_aif"):
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "port" / "results" / f"img{i}_{tag}.png")),
                cv2.imread(str(tmp_path / "jax" / "results" / f"img{i}_{tag}.png")))


def test_psnr_ssim_of_the_same_prediction_match_jax(tmp_path, both):
    """The port's eval outputs, scored by both packages' metrics."""
    _, _, _, peval, state, lens = both
    root = _scenes(tmp_path / "val", n=2, seed=1)
    for aif, depth in dataset.NumpyLoader(dataset.Middlebury(root, resize=(H, W)),
                                          batch_size=1):
        focus = select_focus_dist(torch.from_numpy(depth), S)
        stack = trainer.render_focal_stack(lens, torch.from_numpy(aif),
                                           torch.from_numpy(depth), focus)
        pred_aif = peval(state, stack, focus)["pred_AiF_img"].numpy()
        for fn in ("mask_psnr", "mask_ssim"):
            assert abs(getattr(metrics, fn)(pred_aif, aif)
                       - getattr(jax_metrics, fn)(pred_aif, aif)) <= 1e-10


def test_validate_skips_nan_depth_and_writes_no_images(tmp_path, both):
    """A batch whose mean valid depth is NaN is skipped in both packages;
    save_images=False writes nothing."""
    jeval, jstate, jlens, peval, state, lens = both
    rng = np.random.default_rng(2)
    aif = rng.uniform(0, 1, (1, 3, H, W)).astype(np.float32)
    depth = rng.uniform(0.8, 3.0, (1, 1, H, W)).astype(np.float32)
    bad = depth.copy()
    bad[0, 0, 3, 3] = np.nan
    batches = [(aif, bad), (aif, depth)]
    ref = jax_trainer.validate(jeval, jstate, jlens, batches, S, 2,
                               {"results_dir": str(tmp_path / "jax")},
                               save_images=False)
    ours = trainer.validate(peval, state, lens, batches, S, 2,
                            {"results_dir": str(tmp_path / "port")},
                            save_images=False)
    for k in DEPTH_KEYS:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    assert os.listdir(tmp_path / "port" / "results") == []
