"""The port stands alone: it imports nothing of JAX, Flax, msgpack, YAML,
OpenCV or PIL, and nothing of the JAX package, so that it runs where those
are not installed."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "msgpack", "yaml", "cv2", "PIL", "aadff_tpu")
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "aadff_tpu_torch"))
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    code = ("import aadff_tpu_torch, aadff_tpu_torch.train.trainer, "
            "aadff_tpu_torch.train.dff_dfv, aadff_tpu_torch.psfnet.psfnet, "
            "aadff_tpu_torch.ops.mlp_psf, aadff_tpu_torch.models.dfv.convert, "
            "sys; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'flax', 'msgpack', 'aadff_tpu.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _top_level_imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_sources_import_nothing_forbidden(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _top_level_imports(tree) if m in FORBIDDEN]
    assert not bad, (path, bad)
