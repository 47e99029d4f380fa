"""The port stands alone: it imports nothing of JAX, Flax, msgpack, YAML,
OpenCV, PIL or matplotlib, and nothing of the JAX package, so that it runs
where those are not installed."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "msgpack", "yaml", "cv2", "PIL", "matplotlib",
             "aadff_tpu")
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "aadff_tpu_torch"))
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    """Every module of the port, the entry script included."""
    modules = [p[:-3].replace(os.sep, ".").removesuffix(".__init__")
               for p in PORT_FILES if p.startswith("aadff_tpu_torch")]
    for twin in ("aber_aware_dff_synth", "aber_aware_dff_dfv_synth",
                 "fit_psfnet", "psf_gate", "dryrun_multichip"):
        assert f"aadff_tpu_torch.scripts.{twin}" in modules
    # the readers and the host library's builder (JPEG, EXR); data parallelism
    for mod in ("aadff_tpu_torch.utils.image", "aadff_tpu_torch.utils._host_build",
                "aadff_tpu_torch.parallel", "aadff_tpu_torch.parallel.mesh"):
        assert mod in modules
    code = (f"import importlib, sys; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'flax', 'msgpack', 'yaml', 'cv2', 'PIL', 'matplotlib', "
            "'aadff_tpu.'))]; "
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
