"""The port's thin-lens baseline (`psfnet/psfnet.py:ThinLens`) and the
factory's `thinlens` branch against the JAX package on the CPU, and both
entry twins under configs/aber_aware_dff_synth_thinlens.yml: the train lens
is the ideal thin lens, validation and --eval-only render through the PSF
surrogate.

Tolerances are the JAX tests' own: the render golden within 2e-4
(tests/test_psfnet_render.py:166), render_stack against its frame loop
within 1e-6 (:185); the port against JAX's render and render_stack on the
same inputs within the golden's 2e-4.
"""
import json
import os

import numpy as np
import pytest
import torch

from aadff_tpu.dff.factory import get_lens as jax_get_lens
from aadff_tpu.psfnet import ThinLens as JaxThinLens
from aadff_tpu_torch.dff import factory
from aadff_tpu_torch.psfnet.psfnet import PSFNet, ThinLens
from aadff_tpu_torch.scripts import aber_aware_dff_dfv_synth as dfv_twin
from aadff_tpu_torch.scripts import aber_aware_dff_synth as aif_twin
from aadff_tpu_torch.utils.config import load_config
from test_torch_entry import _jsonl, _write_scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIN_CONFIG = os.path.join(REPO, "configs", "aber_aware_dff_synth_thinlens.yml")
GOLDEN_TOL = 2e-4   # tests/test_psfnet_render.py:166
LOOP_TOL = 1e-6     # tests/test_psfnet_render.py:185


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Test workers share the CPU: torch's full thread pool in each of them
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def render_goldens():
    return np.load(os.path.join(REPO, "tests", "goldens", "render_goldens.npz"))


def _seeded(seed=11, n=2, h=48, w=64, s=4):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, 3, h, w)).astype(np.float32)
    depth = -rng.uniform(500, 15000, (n, 1, h, w)).astype(np.float32)
    fds = -np.sort(rng.uniform(500, 15000, (n, s))).astype(np.float32)
    return img, depth, fds


def test_thinlens_render_golden(render_goldens):
    """tests/test_psfnet_render.py:160: the Gaussian-CoC render of the
    golden scene on the 480x640 sensor."""
    tl = ThinLens(50.0, 1.8, 11, [25.968, 34.624], (480, 640), device="cpu")
    out = tl.render(render_goldens["img"], render_goldens["depth"],
                    render_goldens["foc"]).numpy()
    err = np.abs(out - render_goldens["thinlens_rendered"]).max()
    print(f"measured: thin-lens golden {err:.3g}")
    assert out.shape == render_goldens["thinlens_rendered"].shape
    assert err < GOLDEN_TOL


@pytest.mark.parametrize("res", [(48, 64), (37, 53)], ids=["48x64", "ragged"])
def test_thinlens_matches_jax(res):
    """render and render_stack on seeded inputs against JAX's, and the CoC
    in pixels."""
    args = (49.82, 1.87, 11, [25.968, 34.624], res)
    jtl, tl = JaxThinLens(*args), ThinLens(*args, device="cpu")
    img, depth, fds = _seeded(h=res[0], w=res[1])
    frame = tl.render(img, depth, fds[:, 1]).numpy()
    stack = tl.render_stack(img, depth, fds).numpy()
    ref_frame = np.asarray(jtl.render(img, depth, fds[:, 1]))
    ref_stack = np.asarray(jtl.render_stack(img, depth, fds))
    assert stack.shape == ref_stack.shape == (2, 4, 3, *res)
    err = max(np.abs(frame - ref_frame).max(), np.abs(stack - ref_stack).max())
    print(f"measured: thin-lens render vs JAX {err:.3g}")
    assert err < GOLDEN_TOL
    np.testing.assert_allclose(
        tl.coc(torch.from_numpy(depth), torch.from_numpy(fds[:, :1, None, None])).numpy(),
        np.asarray(jtl.coc(depth, fds[:, :1, None, None])), rtol=1e-6)


def test_thinlens_render_stack_matches_frame_loop():
    """tests/test_psfnet_render.py:169: render_stack is the per-frame loop."""
    tl = ThinLens(49.82, 1.87, 11, [25.968, 34.624], (48, 64), device="cpu")
    img, depth, fds = _seeded()
    stack = tl.render_stack(img, depth, fds).numpy()
    loop = np.stack([tl.render(img, depth, fds[:, i]).numpy() for i in range(4)], 1)
    np.testing.assert_allclose(stack, loop, rtol=0, atol=LOOP_TOL)


def test_thinlens_psf_rows_sum_to_one():
    tl = ThinLens(49.82, 1.87, 11, [25.968, 34.624], (48, 64), device="cpu")
    _, depth, fds = _seeded()
    taps = tl.psf_taps(torch.from_numpy(depth), torch.from_numpy(fds[:, 0]))
    assert taps.shape == (2, 121, 48, 64)
    np.testing.assert_allclose(taps.sum(1).numpy(), 1.0, atol=1e-5)
    assert bool((taps >= 0).all())


def test_factory_thinlens_branch():
    """tests/test_model_variants.py:50: both sections `thinlens`, the sensor
    size as strings; the lenses render what JAX's render."""
    args = {
        "ks": 11, "res": (64, 64),
        "train": {"lens": "thinlens", "foc_len": 50.0, "fnum": 1.8,
                  "sensor_size": ["25.968", "25.968"]},
        "test": {"lens": "thinlens", "foc_len": 50.0, "fnum": 1.8,
                 "sensor_size": ["25.968", "25.968"]},
    }
    train_lens, test_lens = factory.get_lens(args, device="cpu")
    assert isinstance(train_lens, ThinLens) and isinstance(test_lens, ThinLens)
    assert train_lens.device.type == "cpu" and train_lens.sensor_size == [25.968] * 2
    img = np.zeros((1, 3, 64, 64), np.float32) + 0.5
    depth = -np.full((1, 1, 64, 64), 2400.0, np.float32)
    out = train_lens.render(img, depth, np.asarray([-2400.0])).numpy()
    assert out.shape == img.shape and np.isfinite(out).all()
    ref = np.asarray(jax_get_lens(args)[0].render(img, depth, np.asarray([-2400.0])))
    np.testing.assert_allclose(out, ref, rtol=0, atol=GOLDEN_TOL)


def test_factory_builds_the_thinlens_config():
    """configs/aber_aware_dff_synth_thinlens.yml: a ThinLens to train
    through (the rf50mm's paraxial focal length and f-number), the PSF
    surrogate to test through."""
    args = load_config(THIN_CONFIG)
    args["res"] = (32, 64)
    args["test"]["lens"] = os.path.join(REPO, args["test"]["lens"])
    args["test"]["psfnet_path"] = os.path.join(REPO, args["test"]["psfnet_path"])
    train_lens, test_lens = factory.get_lens(args, device="cpu")
    assert isinstance(train_lens, ThinLens) and isinstance(test_lens, PSFNet)
    assert (train_lens.foc_len, train_lens.fnum) == (49.81833767821963,
                                                     1.8656503525485066)
    assert train_lens.sensor_size == [25.968, 34.624]
    assert train_lens.ps == 25.968 / 32


def _thin_config(tmp_path, res):
    """configs/aber_aware_dff_synth_thinlens.yml at `res` with 4 frames,
    absolute paths and SynthMiddlebury sets (4 train, 2 val scenes) that
    the test writes."""
    _write_scenes(tmp_path / "data", h=res[0] + 8, w=res[1] + 16)
    text = open(THIN_CONFIG).read()
    for old, new in (("n_stack: 8", "n_stack: 4"),
                     ("[480, 640]", f"[{res[0]}, {res[1]}]"),
                     ("'./lenses/", f"'{REPO}/lenses/"),
                     ("'./ckpt/", f"'{REPO}/ckpt/"),
                     ("'./datasets/SynthMiddlebury/", f"'{tmp_path}/data/")):
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / "config.yml"
    path.write_text(text)
    return str(path)


@pytest.fixture
def render_calls(monkeypatch):
    """Counts render_stack calls by lens type: the thin lens trains, the
    PSF surrogate validates."""
    calls = {"ThinLens": 0, "PSFNet": 0}
    for cls in (ThinLens, PSFNet):
        inner = cls.render_stack

        def counted(self, *a, _inner=inner, _name=cls.__name__, **k):
            calls[_name] += 1
            return _inner(self, *a, **k)

        monkeypatch.setattr(cls, "render_stack", counted)
    return calls


@pytest.mark.parametrize("twin,res,metric_keys", [
    (aif_twin, (32, 64), 12), (dfv_twin, (64, 64), 5)], ids=["aif", "dfv"])
def test_twins_train_through_the_thin_lens(tmp_path, render_calls, twin, res,
                                           metric_keys):
    """One chunk (2 steps, one validation of 2 scenes), --eval-only best:
    every training render goes through ThinLens and every validation and
    evaluation render through PSFNet; finite losses and metrics."""
    config = _thin_config(tmp_path, res)
    wd = tmp_path / "wd"
    common = ["--config", config, "--workdir", str(wd), "--device", "cpu"]
    state = twin.main([*common, "--epochs-per-chunk", "1", "--total-epochs", "1"])
    assert int(state.step) == 2
    assert render_calls == {"ThinLens": 2, "PSFNet": 2}
    log = _jsonl(wd / "train_log.jsonl")
    assert log[0]["steps"] == 2 and log[0]["skipped"] == 0
    assert np.isfinite(log[0]["loss"])
    metrics = _jsonl(wd / "metrics.jsonl")[0]
    assert len(metrics) == metric_keys + 1  # the epoch besides
    assert all(np.isfinite(v) for v in metrics.values())
    twin.main([*common, "--eval-only", "best"])
    assert render_calls == {"ThinLens": 2, "PSFNet": 4}
    final = json.load(open(wd / "eval_final.json"))
    assert all(np.isfinite(v) for k, v in final.items() if k != "ckpt")


def test_thinlens_render_on_a_cuda_tensor_needs_cuda(monkeypatch):
    """A thin lens on the card is asked for with device='cuda'; without a
    card, building its tensors raises rather than falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tl = ThinLens(50.0, 1.8, 11, [25.968, 34.624], (16, 16))
    assert tl.device.type == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        tl.render(np.zeros((1, 3, 16, 16), np.float32),
                  -np.full((1, 1, 16, 16), 2400.0, np.float32), [-2400.0])
