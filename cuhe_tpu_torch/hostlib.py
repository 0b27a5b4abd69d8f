"""The port's native host library: keygen's batched polynomial inverse.

``csrc/host/xgcd.cpp`` (plain C++ with OpenMP, no CUDA) is compiled by
``g++ -O3 -fPIC -shared -fopenmp`` at first use into ``_build/``, named by a
hash of its source and flags, and loaded with ``ctypes``.  The build writes
a temporary file and renames it into place, so processes that build at the
same time (test workers) all load one complete library.  Nothing is built
at import.  A failed build or load raises: keygen has no other route.

`poly_inv_batch` is what `dhs.CuDHS._find_inverse` calls on every device;
its plain version is ``hostmath.poly_xgcd_mod_p`` (numpy, one prime at a
time), which the tests hold it against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "xgcd.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17"]


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler (g++) found: the host library "
                           f"{SOURCE.name} cannot be built")
    return path


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcuhe_xgcd_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        out = subprocess.run([_cxx(), *CXX_FLAGS, str(SOURCE), "-o", tmp],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    dll = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    dll.poly_inv_batch.argtypes = [i64p, i64p, i64p, ctypes.c_int,
                                   ctypes.c_int, i64p,
                                   ctypes.POINTER(ctypes.c_int32)]
    dll.poly_inv_batch.restype = None
    return dll


def poly_inv_batch(fs: np.ndarray, ms: np.ndarray, ps: np.ndarray):
    """f_i^-1 mod (m_i(x), p_i) for each prime, OpenMP over the primes.

    fs: int64 [np, n] (f mod p_i, degree < n); ms: int64 [np, n + 1] (m(x)
    mod p_i); ps: int64 [np], primes < 2^31.  Returns (out int64 [np, n],
    ok int32 [np]), ok[i] == 0 where f is invertible mod p_i.
    """
    fs = np.ascontiguousarray(fs, dtype=np.int64)
    ms = np.ascontiguousarray(ms, dtype=np.int64)
    ps = np.ascontiguousarray(ps, dtype=np.int64)
    if fs.ndim != 2 or ms.shape != (fs.shape[0], fs.shape[1] + 1) \
            or ps.shape != (fs.shape[0],):
        raise ValueError(f"shapes fs {fs.shape}, ms {ms.shape}, ps {ps.shape}:"
                         " expected [np, n], [np, n + 1], [np]")
    if ps.size and (ps.min() < 2 or ps.max() >= 1 << 31):
        raise ValueError("primes must lie in [2, 2^31)")
    npn, n = fs.shape
    out = np.zeros((npn, n), dtype=np.int64)
    ok = np.zeros(npn, dtype=np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib().poly_inv_batch(fs.ctypes.data_as(i64p), ms.ctypes.data_as(i64p),
                         ps.ctypes.data_as(i64p), npn, n,
                         out.ctypes.data_as(i64p),
                         ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, ok
