"""Native (C++) host helpers, loaded with ctypes.

Counterpart of ``pynqs_tpu/native`` with its own copy of
``onv_tools.cpp``: the determinant-space enumeration and the ONV bit
packing for large sectors.  The library is compiled with ``g++`` into
``build/`` (gitignored, one file per source version) at the first call,
never next to the source.  Where no compiler is found (``available()``
False) ``fci_space_bits`` returns the Python enumeration of
``utils/fci`` and ``pack_bits_u32`` packs in numpy; ``CALLS`` counts the
calls that went through the library, so a run can show that it did.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from pynqs_tpu_torch.ops.cuda_build import BUILD_DIR, Counter

__all__ = ["available", "build", "fci_space_bits", "pack_bits_u32", "CALLS"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "onv_tools.cpp")
CALLS = Counter()  # calls of the library's functions
_LOCK = threading.Lock()
_lib = None
_tried = False


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile onv_tools.cpp with g++ into ``build_dir`` (once per source
    version) and return the library path; raises without a compiler."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    lib = os.path.join(build_dir, f"libonvtools_{digest}.so")
    if os.path.exists(lib):
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native helpers cannot be built")
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    r = subprocess.run([cxx, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                       capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on onv_tools.cpp ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _tried
    with _LOCK:
        if _lib is None and not _tried:
            _tried = True
            if shutil.which("g++") is not None:
                lib = ctypes.CDLL(build())
                lib.n_choose_k.restype = ctypes.c_longlong
                lib.n_choose_k.argtypes = [ctypes.c_int, ctypes.c_int]
                lib.fci_space_bits.restype = ctypes.c_longlong
                lib.fci_space_bits.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_char_p]
                lib.pack_bits_u32.restype = None
                lib.pack_bits_u32.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_void_p]
                _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def fci_space_bits(sorb: int, noa: int, nob: int) -> np.ndarray:
    """All (noa, nob) determinants as bits [n, sorb] int8 in ``fci_bits``'
    order, through the library (the Python enumeration without one, or
    above 64 spatial orbitals)."""
    norb = sorb // 2
    lib = _load()
    if lib is None or norb > 64:
        from pynqs_tpu_torch.utils.fci import python_fci_bits

        return python_fci_bits(sorb, noa, nob)
    n = lib.n_choose_k(norb, noa) * lib.n_choose_k(norb, nob)
    out = np.empty((n, sorb), dtype=np.int8)
    got = lib.fci_space_bits(norb, noa, nob, out.ctypes.data_as(ctypes.c_char_p))
    CALLS.n += 1
    if got != n:
        raise RuntimeError(f"native fci_space_bits failed ({got} != {n})")
    return out


def pack_bits_u32(bits: np.ndarray) -> np.ndarray:
    """Bits [n, sorb] -> little-endian uint32 words [n, ceil(sorb / 32)]."""
    bits = np.ascontiguousarray(bits, dtype=np.int8)
    n, sorb = bits.shape
    nw = (sorb + 31) // 32
    lib = _load()
    if lib is None:
        out = np.zeros((n, nw), dtype=np.uint32)
        for w in range(nw):
            for j in range(min(32, sorb - 32 * w)):
                out[:, w] |= bits[:, 32 * w + j].astype(np.uint32) << j
        return out
    out = np.empty((n, nw), dtype=np.uint32)
    lib.pack_bits_u32(bits.ctypes.data_as(ctypes.c_char_p), n, sorb,
                      out.ctypes.data_as(ctypes.c_void_p))
    CALLS.n += 1
    return out
