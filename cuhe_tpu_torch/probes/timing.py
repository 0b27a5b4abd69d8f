"""Timing, the card's identity and the bound model of the probes (and of
``chip_smoke.py``).

Every time here is a median of CUDA-event timings on the card; nothing in
this module measures on the CPU.  A bound is the least time the card could
take for a function's work: the larger of the bytes it must move (each input
read once, each output written once) over the memory rate and the
operations it needs over the card's peak rate for their kind.
"""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

# H100 SXM memory rate and dense tensor-core peaks (NVIDIA data sheet, at
# the full 700 W power limit).  The data sheet gives no integer rates; the
# multiply rates come from csrc/calib.cu (`calib.mul_rates`) and the
# add / xor / shift rate from the pipes of P2's machine code and the SM
# clock (`calib.alu_peak_per_clock`).
HBM_BYTES_PER_S = 3.35e12
TENSOR_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}

# timed calls per measurement: a kernel, and its (far slower) plain version
REPS = 10
PLAIN_REPS = 3


def require_card(device="cuda") -> torch.device:
    """The CUDA device to measure on; raises without a card (the probes
    have no CPU path: a CPU timing is not a device number)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes measure the card, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no card: the probes run on a CUDA device only")
    return dev


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms_out(fn, reps: int, warm: int = 1):
    """(median time of fn() in ms over `reps` CUDA-event-timed calls, the
    last call's output)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Median time of fn() in ms over `reps` CUDA-event-timed calls."""
    return cuda_ms_out(fn, reps, warm)[0]


def cuda_ms_burst(fn, calls: int = 50) -> float:
    """ms per call of `calls` back-to-back calls of fn() between two CUDA
    events: with the launch queue ahead of the card, the host's time per
    call hides behind the kernels', so this is the device's time of a call
    (where the host is faster than the card)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound(nbytes: float, ops: dict, rates: dict) -> tuple[float, str]:
    """Least time in ms: the larger of the bytes over the memory rate and
    the operations of each kind over that kind's peak rate (per second)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max((count / rates[kind] * 1e3 for kind, count in ops.items()),
             default=0.0)
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_bound(tag: str, ms: float, bound_ms: float) -> None:
    """Raise if a measured time beats its bound: then the bound is not a
    least time, and the model behind it is wrong."""
    if ms < bound_ms:
        raise AssertionError(f"{tag}: {ms:.4f} ms is under its bound "
                             f"{bound_ms:.4f} ms; the bound model is wrong")


def ntt_products(n: int) -> int:
    """64x64->128-bit products of a length-n NTT over Z_P by radix-64
    passes: the inner length-64 DFTs need only shifts, since every 64th root
    of unity mod P is a power of two (8 has order 64), and so does each
    twiddle w^(k1 j2) between passes whose order divides 64.  The other
    twiddles are counted; additions, shifts and reductions are not."""
    if n <= 64:
        return 0
    m = n // 64
    k1, j2 = np.arange(64)[:, None], np.arange(m)[None, :]
    return int(np.count_nonzero(k1 * j2 % m)) + 64 * ntt_products(m)


def twiddle_products(n: int, n1: int, n2: int) -> int:
    """Products of the four-step twiddle w^(k1 j2), k1 < n1, j2 < n2, of a
    length-n NTT: those whose exponent is not a multiple of n/64 (a 64th
    root of unity, a power of two, costs a shift)."""
    k1, j2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    return int(np.count_nonzero(k1 * j2 % (n // 64)))


def radix16_products(length: int) -> int:
    """Generic products of one length-L DFT as csrc/ntt.cu's passes split it,
    16 x L/16: the inner twiddles w_L^(a kb), a < L/16, kb < 16, whose
    exponent is not a multiple of L/64 (those are shifts); the length-16 and
    length-L/16 DFTs themselves run on shifts only."""
    a, kb = np.arange(length // 16)[:, None], np.arange(16)[None, :]
    return int(np.count_nonzero(a * kb % (length // 64)))
