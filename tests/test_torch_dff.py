"""The port's focus selection and depth metrics against the JAX package's
numpy functions on the same inputs."""
import numpy as np
import pytest
import torch

from aadff_tpu.dff import metrics as jax_metrics
from aadff_tpu.dff.focus import select_focus_dist as jax_select_focus_dist
from aadff_tpu_torch.dff import metrics
from aadff_tpu_torch.dff.focus import select_focus_dist


def _depth(seed, B=3, H=24, W=32):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.3, 9.0, (B, 1, H, W)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0  # invalid pixels
    return depth


@pytest.mark.parametrize("num", [4, 8, 10])
def test_linear_focus_matches_jax(num):
    """Exact: the same f32 arithmetic in the same order."""
    depth = _depth(num)
    ref = jax_select_focus_dist(depth, num, mode="linear")
    ours = select_focus_dist(torch.from_numpy(depth), num, mode="linear")
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_importance_focus_keeps_the_reference_quirk():
    """num - 2 sorted distances from min to max of the valid depth (the
    reference's `target = num - 2`), as the JAX function returns."""
    depth = _depth(1)
    g = torch.Generator().manual_seed(0)
    ours = select_focus_dist(torch.from_numpy(depth), 8, mode="importance",
                             generator=g).numpy()
    ref = jax_select_focus_dist(depth, 8, mode="importance",
                                rng=np.random.default_rng(0))
    assert ours.shape == ref.shape == (3, 6)
    valid = np.where(depth > 0, depth, np.inf)
    np.testing.assert_array_equal(ours[:, 0], valid.min(axis=(1, 2, 3)))
    np.testing.assert_array_equal(ours[:, -1], depth.max(axis=(1, 2, 3)))
    assert (np.diff(ours, axis=1) >= 0).all()


def test_focus_rejects_small_stacks():
    with pytest.raises(ValueError):
        select_focus_dist(torch.ones(1, 1, 2, 2), 3)


MASKED = ["mask_abs_rel", "mask_sq_rel", "mask_mse", "mask_mae", "mask_rmse",
          "mask_rmse_log", "mask_accuracy_k"]
UNMASKED = ["abs_rel", "sq_rel", "mae", "mse", "rmse", "rmse_log",
            "accuracy_k"]


def _pred_gt(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 5.0, (48, 64))
    est = gt * rng.uniform(0.6, 1.5, gt.shape)
    gt[rng.uniform(size=gt.shape) < 0.1] = 0.0
    return est, gt


@pytest.mark.parametrize("name", MASKED)
def test_masked_metrics_match_jax(name):
    """Within 1e-6 (f64 inputs: the formulas are what is compared)."""
    est, gt = _pred_gt(0)
    mask = gt > 0
    args = (1,) if name.endswith("_k") else ()
    ref = getattr(jax_metrics, name)(est, gt, *args, mask)
    ours = getattr(metrics, name)(torch.from_numpy(est), torch.from_numpy(gt),
                                  *args, torch.from_numpy(mask))
    np.testing.assert_allclose(float(ours), ref, rtol=1e-6)


@pytest.mark.parametrize("name", UNMASKED)
def test_unmasked_metrics_match_jax(name):
    """Within 1e-6, with invalid (zero) ground truth left in: the infinite
    terms are skipped as the reference skips them."""
    est, gt = _pred_gt(1)
    args = (2,) if name.endswith("_k") else ()
    with np.errstate(divide="ignore", invalid="ignore"):
        ref = getattr(jax_metrics, name)(est, gt, *args)
    ours = getattr(metrics, name)(torch.from_numpy(est), torch.from_numpy(gt),
                                  *args)
    np.testing.assert_allclose(float(ours), ref, rtol=1e-6)
