"""The port's data path against the JAX package on the same files and the
same random streams: the metric remainder (confidence-weighted errors,
bumpiness, uint8-quantised PSNR/SSIM) within 1e-10, importance-mode focus
selection on the same uniform draws within 1e-6, the datasets, the
augmentation, the loader's batch order, and the factories.

Datasets are built by the tests with cv2 in the reference layouts
(tests/test_dff.py:105, tests/test_datasets_full.py).  Arrays equal JAX's
exactly where nothing is resized and within 1e-6 where something is (the
port's resize against cv2's, tests/test_torch_io.py).  JAX rotates with its
native bilinear op when native/libaadff_io.so loads; these tests hold the
port to JAX's scipy path by switching the native op off, in the test only.
"""
import os

import cv2
import numpy as np
import pytest
import torch

import aadff_tpu.dff.native_ops as jax_native_ops
from aadff_tpu.dff import dataset as jax_dataset
from aadff_tpu.dff import factory as jax_factory
from aadff_tpu.dff import focus as jax_focus
from aadff_tpu.dff import metrics as jax_metrics
from aadff_tpu_torch.dff import dataset, factory, metrics
from aadff_tpu_torch.dff.focus import select_focus_dist
from aadff_tpu_torch.utils import flax_msgpack
from aadff_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")


@pytest.fixture
def scipy_rotate(monkeypatch):
    """JAX's augmentation on its scipy rotation, as the port's."""
    monkeypatch.setattr(jax_native_ops, "available", lambda: False)


# ================================
# metrics
# ================================
def _depth_pair(seed, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 3.0, shape)
    est = gt + rng.normal(0, 0.1, shape)
    mask = rng.uniform(size=shape) > 0.2
    conf = rng.uniform(0.1, 1.0, shape)
    return gt, est, mask, conf


@pytest.mark.parametrize("name", ["mask_mse_w_conf", "mask_mae_w_conf"])
def test_confidence_weighted_errors_match_jax(name):
    gt, est, mask, conf = _depth_pair(0)
    ref = getattr(jax_metrics, name)(est, gt, conf, mask)
    ours = getattr(metrics, name)(*(torch.from_numpy(a) for a in (est, gt, conf, mask)))
    assert abs(float(ours) - ref) <= 1e-10


def test_bumpiness_matches_jax():
    gt, est, mask, _ = _depth_pair(1)
    for args in ((gt, est, mask), (gt[None, None], est[None, None], mask[None, None])):
        assert abs(metrics.get_bumpiness(*args)
                   - jax_metrics.get_bumpiness(*args)) <= 1e-10
    assert abs(metrics.get_bumpiness_non_mask(gt, est, clip=0.02)
               - jax_metrics.get_bumpiness_non_mask(gt, est, clip=0.02)) <= 1e-10


def test_psnr_ssim_match_jax():
    """The cases of tests/test_dff.py:35-53 and a noisy batch."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, 3, 32, 40)).astype(np.float32)
    noisy = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(np.float32)
    a = rng.uniform(0, 255, (32, 32))
    for fn, args in (("batch_PSNR", (noisy, img)), ("batch_SSIM", (noisy, img)),
                     ("batch_SSIM", (img, img)), ("mask_psnr", (noisy, img)),
                     ("mask_ssim", (noisy, img)), ("psnr", (a, 255 - a)),
                     ("ssim", (a, a)), ("ssim", (a, 255 - a)),
                     ("ssim", (img[0], noisy[0]))):
        kwargs = {"channel_axis": 0} if fn == "ssim" and args[0].ndim == 3 else {}
        ours = getattr(metrics, fn)(*args, **kwargs)
        ref = getattr(jax_metrics, fn)(*args, **kwargs)
        assert abs(ours - ref) <= 1e-10, (fn, ours, ref)
    assert metrics.batch_SSIM(img, img) == 1.0


# ================================
# focus selection, importance mode
# ================================
class _Draws:
    """A stand-in for numpy's Generator whose .random() returns a given
    sequence."""

    def __init__(self, values):
        self.values = iter(values)

    def random(self):
        return next(self.values)


@pytest.mark.parametrize("B,num,seed", [(1, 6, 0), (3, 8, 1), (2, 10, 2)])
def test_importance_focus_matches_jax_on_the_same_draws(B, num, seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.4, 9.0, (B, 1, 16, 24)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    g = torch.Generator().manual_seed(seed)
    twin = torch.Generator()
    twin.set_state(g.get_state())
    draws = [float(torch.rand((), generator=twin)) for _ in range(20000)]
    ours = select_focus_dist(torch.from_numpy(depth), num, mode="importance",
                             generator=g)
    ref = jax_focus.select_focus_dist(depth, num, mode="importance",
                                      rng=_Draws(draws))
    assert ours.shape == ref.shape == (B, num - 2)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


# ================================
# datasets
# ================================
def _middlebury(root, n, h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = root / f"scene{i}"
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "im0.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        depth = rng.uniform(500, 3000, (h, w))
        depth[:, :2] = 0
        cv2.imwrite(str(d / "depth.png"), depth.astype(np.uint16))
    return str(root)


def _assert_items(ours, ref, atol):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        if atol == 0:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("resize,atol", [((40, 56), 0), ((32, 48), 1e-6)])
def test_middlebury_matches_jax(tmp_path, scipy_rotate, train, resize, atol):
    root = _middlebury(tmp_path / "mb", 2)
    ours = dataset.Middlebury(root, resize=resize, train=train)
    ref = jax_dataset.Middlebury(root, resize=resize, train=train)
    assert ours.scenes == ref.scenes
    # seeds chosen so that the draws take every branch of auto_augment
    for seed in range(6):
        for i in range(len(ref)):
            np.random.seed(seed)
            a = ours[i]
            np.random.seed(seed)
            _assert_items(a, ref[i], atol)


def test_auto_augment_matches_jax(scipy_rotate):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (24, 32, 3))
    stack = rng.uniform(0, 1, (24, 32, 3, 4))
    depth = rng.uniform(0.5, 3.0, (24, 32))
    for seed in range(8):
        for x in (img, stack):
            ours = dataset.auto_augment(x.copy(), depth.copy(),
                                        np.random.RandomState(seed))
            ref = jax_dataset.auto_augment(x.copy(), depth.copy(),
                                           np.random.RandomState(seed))
            _assert_items(ours, ref, 0)


def test_matterport3d_matches_jax(tmp_path, scipy_rotate):
    """The layout of tests/test_datasets_full.py:9.  The colour files hold
    PNG data under their .jpg names (OpenCV and the port both go by the
    file's signature): the port decodes no JPEG."""
    rgb = tmp_path / "rgb" / "scene1" / "undistorted_color_images"
    dep = tmp_path / "dep" / "scene1" / "render_depth"
    rgb.mkdir(parents=True)
    dep.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        ok, png = cv2.imencode(".png", rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
        (rgb / f"img{i}.jpg").write_bytes(png.tobytes())
        cv2.imwrite(str(dep / f"img{i}.png"),
                    rng.uniform(1000, 12000, (40, 48)).astype(np.uint16))
    for train in (False, True):
        args = (str(tmp_path / "rgb"), str(tmp_path / "dep"))
        ours = dataset.Matterport3D(*args, resize=(32, 32), train=train)
        ref = jax_dataset.Matterport3D(*args, resize=(32, 32), train=train)
        assert len(ours) == len(ref) == 2
        for seed in range(4):
            np.random.seed(seed)
            a = ours[0]
            np.random.seed(seed)
            # float32 depth maps (to 3 m) resized: within 2e-6 (test_torch_io)
            _assert_items(a, ref[0], 2e-6)
    cv2.imwrite(str(rgb / "img0.jpg"), np.zeros((40, 48, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="JPEG"):
        dataset.Matterport3D(*args, resize=(32, 32))[0]


def test_flyingthings3d_matches_jax(tmp_path, scipy_rotate):
    """AiF and focal-stack modes, disparity from PFM and from .npy."""
    rng = np.random.default_rng(1)
    for k, fmt in enumerate(("pfm", "npy")):
        scene = tmp_path / f"scene{k}"
        scene.mkdir()
        disp = rng.uniform(10, 40, (32, 40)).astype(np.float32)
        if fmt == "npy":
            np.save(str(scene / "disp.npy"), disp)
        else:
            with open(scene / "disp.pfm", "wb") as f:
                f.write(b"Pf\n40 32\n-1.0\n")
                np.flipud(disp).astype("<f4").tofile(f)
        cv2.imwrite(str(scene / "AiF.png"),
                    rng.integers(0, 256, (32, 40, 3), dtype=np.uint8))
        for fd in ("10.0", "20.0", "30.0"):
            cv2.imwrite(str(scene / f"{fd}.png"),
                        rng.integers(0, 256, (32, 40, 3), dtype=np.uint8))
    for fs_num in (0, 2):
        for train in (False, True):
            ours = dataset.FlyingThings3D(str(tmp_path), resize=(24, 32),
                                          train=train, fs_num=fs_num)
            ref = jax_dataset.FlyingThings3D(str(tmp_path), resize=(24, 32),
                                             train=train, fs_num=fs_num)
            assert sorted(ours.scenes) == sorted(ref.scenes)
            for i in range(len(ref)):
                for seed in range(3):
                    import random
                    random.seed(seed)
                    np.random.seed(seed)
                    a = ours[i]
                    random.seed(seed)
                    np.random.seed(seed)
                    _assert_items(a, ref[i], 2e-6)


def test_realworld_matches_jax(tmp_path):
    scene = tmp_path / "capture1" / "align"
    scene.mkdir(parents=True)
    (tmp_path / "capture1" / "depth").mkdir()
    rng = np.random.default_rng(2)
    for fd in (600, 1200, 2400):
        cv2.imwrite(str(scene / f"img_dist{fd}_x.png"),
                    rng.integers(0, 256, (32, 40, 3), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "capture1" / "depth" / "depth.png"),
                rng.integers(0, 65536, (32, 40), dtype=np.uint16))
    for resize, atol in (((32, 40), 0), ((24, 32), 1e-6)):
        ours = dataset.RealWorld(str(tmp_path), resize=resize)
        ref = jax_dataset.RealWorld(str(tmp_path), resize=resize)
        _assert_items(ours[0], ref[0], atol)
    # depth: OpenCV resizes the uint16 map and rounds; one unit (3000/65535
    # mm) apart where a sum lands on a tie
    ours = dataset.RealWorld(str(tmp_path), resize=(24, 32), depth=True)[0][1]
    ref = jax_dataset.RealWorld(str(tmp_path), resize=(24, 32), depth=True)[0][1]
    np.testing.assert_allclose(ours, ref, rtol=0, atol=3.0 / 65535 + 1e-6)


# ================================
# loader
# ================================
@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_keeps_jax_batch_order(tmp_path, scipy_rotate, prefetch):
    root = _middlebury(tmp_path / "mb", 5, seed=4)
    for seed in (0, 127):
        batches = []
        for ds_mod in (dataset, jax_dataset):
            ds = ds_mod.Middlebury(root, resize=(32, 48), train=True)
            np.random.seed(9)
            loader = ds_mod.NumpyLoader(ds, batch_size=2, shuffle=True,
                                        prefetch=prefetch, seed=seed)
            batches.append(list(loader))
        ours, ref = batches
        assert len(ours) == len(ref) == 2
        for a, b in zip(ours, ref):
            _assert_items(a, b, 1e-6)


def test_loader_reraises_a_worker_failure():
    class Broken(dataset.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise FileNotFoundError("scene 2")
            return [np.zeros(3, np.float32)]

    for prefetch in (0, 2):
        loader = dataset.NumpyLoader(Broken(), batch_size=1, prefetch=prefetch)
        with pytest.raises(FileNotFoundError, match="scene 2"):
            list(loader)


# ================================
# factories
# ================================
def _args(tmp_path, **overrides):
    args = load_config(os.path.join(REPO, "configs", "aber_aware_dff_synth.yml"))
    args["res"] = (32, 64)
    for section in ("train", "test"):
        args[section]["lens"] = os.path.join(REPO, "lenses", "rf50mm.json")
        args[section]["psfnet_path"] = PSFNET_CKPT
    args.update(overrides)
    return args


def test_get_lens_builds_psfnet(tmp_path):
    train_lens, test_lens = factory.get_lens(_args(tmp_path), device="cpu")
    ref = flax_msgpack.load(PSFNET_CKPT)["params"]
    for lens in (train_lens, test_lens):
        assert lens.sensor_res == (32, 64) and lens.kernel_size == 11
        assert lens.device.type == "cpu"
        assert lens.lens_path.endswith("rf50mm.json")
        w = lens.model.linears()[0].weight.detach().numpy()
        np.testing.assert_array_equal(w, np.asarray(ref["Dense_0"]["kernel"]).T)


def test_get_lens_refuses_missing_lens(tmp_path):
    args = _args(tmp_path)
    args["test"]["lens"] = str(tmp_path / "absent.json")
    with pytest.raises(FileNotFoundError):
        factory.get_lens(args, device="cpu")


def test_get_dataset_matches_jax(tmp_path):
    root = _middlebury(tmp_path / "mb", 2)
    args = _args(tmp_path, SynthMiddlebury_train=root, SynthMiddlebury_val=root,
                 Middlebury2014_val=root, Middlebury2021_val=root)
    for train_name, test_name in (("SynthMiddlebury", "SynthMiddlebury"),
                                  ("SynthMiddlebury", "Middlebury2014"),
                                  ("SynthMiddlebury", "Middlebury2021")):
        args["train"]["dataset"], args["test"]["dataset"] = train_name, test_name
        ours = factory.get_dataset(args)
        ref = jax_factory.get_dataset(args)
        for a, b in zip(ours, ref):
            assert type(a).__name__ == type(b).__name__
            assert a.scenes == b.scenes and a.train == b.train
    for section, name in (("train", "Kitti"), ("test", "NYU")):
        args = _args(tmp_path, SynthMiddlebury_train=root, SynthMiddlebury_val=root)
        args[section]["dataset"] = name
        for fn in (factory.get_dataset, jax_factory.get_dataset):
            with pytest.raises(NotImplementedError, match=name):
                fn(args)
