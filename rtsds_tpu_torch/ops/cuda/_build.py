"""Builds the CUDA kernels in ``csrc/`` at first use and binds them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
library lands in ``_build/`` beside this file, named by a hash of the
sources and flags, so a changed source builds anew.  A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (with ptxas's register and smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError("nvcc not found (on PATH, or under CUDA_HOME); "
                           "it is needed to build the port's CUDA kernels")
    return str(candidate)


def library_path() -> Path:
    """Where the library for the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librtsds_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    global build_log
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    sources = sorted(CSRC.glob("*.cu"))
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    try:
        compiles = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)]
        build_log = "".join(proc.communicate()[0] for proc in compiles)
        codes = [proc.returncode for proc in compiles]
        if any(codes):
            raise RuntimeError(f"nvcc failed {codes}:\n{build_log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, target)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return target


def load() -> ctypes.CDLL:
    """The bound kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rtsds_hist_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.rtsds_hist_launch.restype = ctypes.c_int
            lib.rtsds_remap_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                ctypes.c_int, ctypes.c_int32, ctypes.c_void_p]
            lib.rtsds_remap_launch.restype = ctypes.c_int
            lib.rtsds_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rtsds_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.rtsds_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
