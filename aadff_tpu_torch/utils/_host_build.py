"""Build the port's host C++ (`csrc/jpeg_decode.cpp`) with the system's C++
compiler into a plain shared library and load it with ctypes.

The library is built at first use into `build/aadff_tpu_torch/
libaadff_host.so` under the repository root and rebuilt when the source or
the flags change (a stamp file holds their hash).  The builder holds the
kernels' file lock (`ops/_build.py:build_lock`) and checks the stamp again
once it has it, so processes that start at once (test workers, the ranks
of a data-parallel run) compile it once; it writes to temporary names and
moves the library, then the stamp, into place with `os.replace`.  There is no Python
fallback: without a compiler the build raises and names the compilers it
looked for.  Calls through ctypes release the GIL, so a loader thread
decodes while the training step runs.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..ops._build import BUILD_DIR, build_lock, is_current, write_stamp

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (_CSRC / "jpeg_decode.cpp",)
LIBRARY = BUILD_DIR / "libaadff_host.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
COMPILERS = ("c++", "g++")

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# argtypes and restype of the library's C entry points (extern "C")
ENTRY_POINTS = {
    "aadff_jpeg_info": ([ctypes.c_char_p, _I64, ctypes.POINTER(ctypes.c_int32),
                         ctypes.c_char_p, _I64], ctypes.c_int),
    "aadff_jpeg_decode": ([ctypes.c_char_p, _I64, _P, _I64, ctypes.c_char_p, _I64],
                          ctypes.c_int),
}

_lib = None
_lock = threading.Lock()


def compiler() -> str:
    """The C++ compiler: $CXX, else c++ or g++ on PATH."""
    for name in ((os.environ["CXX"],) if os.environ.get("CXX") else ()) + COMPILERS:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        f"no C++ compiler found (looked for $CXX, {', '.join(COMPILERS)}): the "
        f"port's JPEG decoder ({SOURCES[0].name}) cannot be built")


def _stamp(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> dict:
    """Compile the library if it is missing or stale.  Returns {"path",
    "built", "log"}."""
    cxx = compiler()
    stamp = _stamp(cxx)
    if is_current(LIBRARY, stamp):
        return {"path": str(LIBRARY), "built": False, "log": ""}
    with build_lock(LIBRARY):
        if is_current(LIBRARY, stamp):  # another process built it meanwhile
            return {"path": str(LIBRARY), "built": False, "log": ""}
        tag = f"tmp{os.getpid()}.{threading.get_ident()}"
        tmp = LIBRARY.with_suffix(f".so.{tag}")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                               *map(str, SOURCES)], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{log}")
        os.replace(tmp, LIBRARY)
        write_stamp(LIBRARY, stamp, tag)
    return {"path": str(LIBRARY), "built": True, "log": log}


def host_library() -> ctypes.CDLL:
    """The loaded host library (built on first use), with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            for name, (argtypes, restype) in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib
