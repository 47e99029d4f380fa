"""Build the port's CUDA kernels with nvcc into a plain shared library and
load it with ctypes.

The library has a C interface and includes no PyTorch header; nvcc takes
about a minute, most of it for the bf16 wgmma kernels.  It is built at first
use into `build/aadff_tpu_torch/` under the repository root and rebuilt when
a source, a header or a flag changes (a stamp file holds their hash).
Processes that start at once (the ranks of a data-parallel run) build it
once: the builder holds a file lock beside the library (`build_lock`),
and a process that waited for it checks the stamp again before it builds.
Nothing here runs at import time.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
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


def is_current(library: Path, stamp: str) -> bool:
    """Whether `library` exists and was built from the inputs of `stamp`."""
    stamp_file = library.with_suffix(".so.stamp")
    return (library.exists() and stamp_file.exists()
            and stamp_file.read_text() == stamp)


def write_stamp(library: Path, stamp: str, tag: str):
    """Write `library`'s stamp atomically (a temporary name, then
    os.replace), after the library itself is in place."""
    stamp_file = library.with_suffix(".so.stamp")
    tmp = stamp_file.with_suffix(f".stamp.{tag}")
    tmp.write_text(stamp)
    os.replace(tmp, stamp_file)


@contextlib.contextmanager
def build_lock(library: Path):
    """An exclusive inter-process lock (flock) on `<library>.lock`, held
    while one process builds `library`; the others wait for it."""
    library.parent.mkdir(parents=True, exist_ok=True)
    with open(library.with_suffix(".so.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> dict:
    """Compile the kernels if the library is missing or stale.

    Returns {"path", "built", "seconds", "log"}; `log` holds nvcc's output,
    including ptxas' registers, shared memory and spills per kernel.
    """
    stamp = _stamp()
    if is_current(LIBRARY, stamp):
        return {"path": str(LIBRARY), "built": False, "seconds": 0.0, "log": ""}
    with build_lock(LIBRARY):
        if is_current(LIBRARY, stamp):  # another process built it meanwhile
            return {"path": str(LIBRARY), "built": False, "seconds": 0.0,
                    "log": ""}
        return _build(stamp)


def _build(stamp: str) -> dict:
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
    write_stamp(LIBRARY, stamp, tag)
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
