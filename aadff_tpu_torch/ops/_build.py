"""Build the port's CUDA kernels with nvcc into a plain shared library and
load it with ctypes.

The library has a C interface and includes no PyTorch header; nvcc takes
about a minute, most of it for the bf16 wgmma kernels.  It is built at first
use into `build/aadff_tpu_torch/` under the repository root and rebuilt when
a source, a header or a flag changes (a stamp file holds their hash).
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (_CSRC / "fused_psf_render.cu", _CSRC / "mlp_psf.cu",
           _CSRC / "psf_conv.cu")
HEADERS = (_CSRC / "mlp_tile.cuh",)  # included by the sources
BUILD_DIR = _ROOT / "build" / "aadff_tpu_torch"
LIBRARY = BUILD_DIR / "libaadff_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes and restype of the library's C entry points (csrc/*.cu, extern "C")
ENTRY_POINTS = {
    "aadff_fused_psf_render": (
        [_P, _P, _P, _P, ctypes.POINTER(_I), _I, _P, _I, _I, _I, _I, _I, _I,
         _F, _F, _I, _I, _I, _P], _I),
    "aadff_mlp_psf": ([_P, _P, ctypes.POINTER(_I), _I, _P, _I, _I, _P], _I),
    "aadff_error_string": ([_I], ctypes.c_char_p),
}

_lib = None


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME, else the default toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> dict:
    """Compile the kernels if the library is missing or stale.

    Returns {"path", "built", "seconds", "log"}; `log` holds nvcc's output,
    including ptxas' registers, shared memory and spills per kernel.
    """
    stamp_file = LIBRARY.with_suffix(".so.stamp")
    stamp = _stamp()
    if LIBRARY.exists() and stamp_file.exists() and stamp_file.read_text() == stamp:
        return {"path": str(LIBRARY), "built": False, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    tmp = LIBRARY.with_suffix(f".so.{tag}")
    exe = nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all at once; then one link
    procs = [subprocess.Popen([exe, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(SOURCES, objects)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        link = subprocess.run(
            [exe, *ARCH, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = [link.returncode] if link.returncode != 0 else []
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    os.replace(tmp, LIBRARY)
    stamp_file.write_text(stamp)
    return {"path": str(LIBRARY), "built": True, "seconds": seconds, "log": log}


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        for name, (argtypes, restype) in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
