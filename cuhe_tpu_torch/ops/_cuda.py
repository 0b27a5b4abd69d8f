"""Build, load and launch the hand-written Hopper kernels of ``csrc/``.

On first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library is named by a hash of the sources and flags, so an unchanged tree
reuses it.  Nothing here runs at import: the CPU tests import every module
on a machine with no ``nvcc`` and no card.

Every C entry point takes device pointers, sizes and a stream, launches on
that stream, allocates nothing and returns ``cudaGetLastError()``; `launch`
raises on a non-zero code and counts the launch in `LAUNCHES`.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# C signatures: 'p' a pointer (or None), 'i' a 32-bit int; every entry point
# also takes the stream as its last argument.
_SIGNATURES = {
    "cuhe_ntt_fwd": "pppp" + "iii",
    "cuhe_ntt_fwd_digits": "pppp" + "iiiiiii",
    "cuhe_ntt_inv_modcrt": "pppppp" + "iiii",
    # the forward column pass on a column block of a transform split across
    # devices
    "cuhe_ntt_fwd_cols_block": "pppp" + "iiiii",
    "cuhe_icrt": "pppppp" + "iiii",
    "cuhe_relin_mulacc": "pppppppp" + "iiiiiiii",
    # the elementwise Z_P / CRT layer (csrc/pointwise.cu)
    "cuhe_zp_mul": "pppppp" + "ii",
    "cuhe_barrett_combine": "pppppp" + "iiii",
    "cuhe_mod_switch": "ppppp" + "iiiiii",
    "cuhe_crt_add": "pppp" + "iii",
    "cuhe_zp_add": "pppppp" + "ii",
    # the CRT-domain elementwise ops (csrc/crt_ops.cu)
    "cuhe_crt_from_raw": "ppp" + "iiii",
    "cuhe_crt_scalar": "ppppp" + "iiiii",
    "cuhe_icrt_split16": "pp" + "i",
    "cuhe_icrt_combine16": "pppp" + "iiii",
    "cuhe_calib": "p" + "iii",
    # the NTT passes one at a time (probes/ablate.py)
    "cuhe_ntt_cols_io": "pppp" + "iii",
    "cuhe_ntt_cols_notw": "pppp" + "iii",
    "cuhe_ntt_cols": "pppp" + "iii",
    "cuhe_ntt_rows": "ppppp" + "iii",
    "cuhe_ntt_rows_io": "pppp" + "iii",
    "cuhe_ntt_inv_rows": "pppp" + "iii",
    "cuhe_ntt_inv_nomod": "pppp" + "iii",
    "cuhe_ntt_inv_cols": "pppp" + "iii",
    # resident blocks per SM of a pass's kernel (no launch)
    "cuhe_ntt_blocks_per_sm": "iii",
    "cuhe_relin_blocks_per_sm": "ii",
    "cuhe_icrt_blocks_per_sm": "ii",
    # rate probes (probes/calib.py)
    "cuhe_probe_alu": "pp" + "iii",
    "cuhe_probe_dot_s8": "pppp" + "iiiiii",
    "cuhe_probe_dot_bf16": "pppp" + "iiiiii",
    "cuhe_probe_dot_loads_only": "pppp" + "iiiiiii",
    "cuhe_probe_dot_mma_only": "pppp" + "iiiiiii",
}

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel, and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()
# Calls of the elementwise kernels' plain versions (ops/pointwise.py,
# ops/barrett.py, ops/crt.py) on CUDA tensors, by the kernel's launch
# counter: a path that runs on the kernels makes none.
PLAIN_CALLS: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Set the launch counts and the plain versions' call counts to 0."""
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def count_plain(counter: str, t: torch.Tensor) -> None:
    """Count a plain version's call under its kernel's launch counter
    where its operand `t` lies on a CUDA device."""
    if t.device.type == "cuda":
        PLAIN_CALLS[counter] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(SRC_DIR.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run(procs: list[subprocess.Popen]) -> None:
    outs = [p.communicate()[0] for p in procs]
    failed = [f"{' '.join(p.args)}\n{out}"
              for p, out in zip(procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> tuple[Path, float]:
    """Compile csrc/ into the shared library if it is not built yet.

    Returns (library path, seconds spent building).
    """
    so = BUILD_DIR / f"libcuhe_kernels_{_digest()}.so"
    if so.exists():
        return so, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()

    def nvcc_proc(*args: str) -> subprocess.Popen:
        return subprocess.Popen([nvcc, *NVCC_FLAGS, *args], text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(SRC_DIR.glob("*.cu"))
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in srcs]
        _run([nvcc_proc("-c", str(s), "-o", o) for s, o in zip(srcs, objs)])
        tmp_so = os.path.join(tmp, so.name)
        _run([nvcc_proc("-shared", "-o", tmp_so, *objs)])
        os.replace(tmp_so, so)
    return so, time.perf_counter() - t0


def sass() -> str:
    """The machine code of every kernel in the library, as `cuobjdump -sass`
    (beside nvcc in the toolkit) prints it."""
    so, _ = build()
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    so, _ = build()
    dll = ctypes.CDLL(str(so))
    for name, sig in _SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dll.cuhe_error_string.argtypes = [ctypes.c_int]
    dll.cuhe_error_string.restype = ctypes.c_char_p
    return dll


def _cargs(args) -> list:
    """Tensors as their data pointers, ints as ints (None: a null pointer);
    ctypes converts each by the entry point's argtypes."""
    return [a.data_ptr() if isinstance(a, torch.Tensor)
            else None if a is None else int(a) for a in args]


def launch(counter: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry point `fn` on `device`'s current stream; raise on error.

    Every call of a kernel front end pays this host time, and a timed call
    of a short kernel sees it: the stream comes from PyTorch's raw-stream
    query, and the device is switched only when it is not the current one.
    """
    dll = lib()
    call, cargs = getattr(dll, fn), _cargs(args)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        rc = call(*cargs, stream)
    else:
        with torch.cuda.device(index):
            rc = call(*cargs, stream)
    if rc != 0:
        raise RuntimeError(
            f"{fn}: CUDA error {rc}: {dll.cuhe_error_string(rc).decode()}")
    LAUNCHES[counter] += 1


def query(fn: str, device: torch.device, *args) -> int:
    """Call C entry point `fn`, which launches nothing, on `device` and
    return its non-negative result; raise on a negative one (a CUDA error)."""
    dll = lib()
    with torch.cuda.device(device):
        rc = getattr(dll, fn)(*_cargs(args), None)
    if rc < 0:
        raise RuntimeError(
            f"{fn}: CUDA error {-rc}: {dll.cuhe_error_string(-rc).decode()}")
    return rc


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device: torch.device | None = None, align: int = 1) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and `shape`,
    `device` where given) whose data starts at a multiple of `align` bytes:
    what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must start at a multiple of {align} "
                         f"bytes")
