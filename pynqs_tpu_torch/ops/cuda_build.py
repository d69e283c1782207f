"""Build and load the port's CUDA sources.

Each source under ``pynqs_tpu_torch/csrc/`` is compiled on its own with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(``build/lib<name>_<sha1>.so``, once per source version) and loaded with
``ctypes``, so a change to one source rebuilds that library only.
Nothing here runs when a module is imported: the first CUDA tensor that
reaches a kernel's wrapper builds its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

__all__ = ["Counter", "nvcc", "build_library", "load_library", "check_launch", "BUILD_INFO"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "build")
BUILD_INFO: dict = {}  # source name -> the compiler's ``-Xptxas -v`` report
_LOCK = threading.Lock()
_LIBS: dict = {}


class Counter:
    """A running count the program keeps beside its work: the launches of
    one CUDA kernel (one per launch, nowhere else), or rows a function
    was handed.  ``n`` is a Python int, or a 0-d tensor where the count is
    summed on the device; ``int(counter.n)`` reads either (the tensor
    waits for the device)."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_library(name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``csrc/<name>.cu`` for sm_90a into ``build_dir`` (once per
    source version) and return the library path; the compiler's
    ``-Xptxas -v`` report goes to ``BUILD_INFO[name]``.  Safe to call
    from several threads at once for different sources."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    lib = os.path.join(build_dir, f"lib{name}_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src,
    ]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO[name] = r.stderr
    return lib


def load_library(name: str, bind) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once; ``bind(so)``
    sets its entry points' argument and result types."""
    with _LOCK:
        if name not in _LIBS:
            so = ctypes.CDLL(build_library(name))
            bind(so)
            _LIBS[name] = so
    return _LIBS[name]


def check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
