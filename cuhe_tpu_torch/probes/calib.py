"""Rate probes of the card: tensor-core dots, 32-bit add / xor / shift, the
integer multiply rates behind the kernels' bounds, and the SM clock.

Counterpart of ``scripts/tpu_probe_calib.py``:
  * `dot` (kernel ``csrc/probe_dot.cu``) is ``bench_dot``'s ``dot_kernel``:
    ``x @ w`` for int8 -> int32 and bf16 -> f32, recomputed ``grid`` times,
    by a persistent TMA + wgmma kernel whose tile width and block count
    `dot_launch_config` picks; `dot_stop` runs its two stop points (the TMA
    ring alone, the wgmma loop alone);
  * `alu` (kernel ``csrc/probe_alu.cu``) is ``bench_vpu``'s ``vpu_kernel``:
    ``y = x``, then ``reps`` times ``y = (y + x) ^ (y >> 3)`` over uint32;
  * `mul_rates` (kernel ``csrc/calib.cu``) measures the 64x64->128 and
    32x32->64 multiply rates, the multiply half of ``bench_vpu``.
Each front end launches its kernel for a CUDA tensor and runs its plain
PyTorch version (`dot_plain`, `dot_stop_plain`, `alu_plain`) for a CPU
tensor; the rate functions (`dot_rate`, `dot_stop_rate`, `alu_rate`,
`mul_rates`, `sample_sm_clock`) run on
the card only, raise without one, and raise if the kernel's output at the
timed shape differs from the plain version's.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math
import re
import subprocess
import time

import numpy as np
import torch

from ..ops import _cuda, modp
from ..ops.ntt_kernels import _is_cpu
from .timing import (PLAIN_REPS, REPS, TENSOR_OPS_PER_S, bound, cuda_ms,
                     cuda_ms_burst, cuda_ms_out, require_card)

# bench_dot's shapes (m, k, n) and grid, bench_vpu's shapes, reps and grid
DOT_SHAPES = ((1024, 128, 1024), (1024, 1024, 1024), (128, 128, 128))
DOT_GRID = 64
ALU_SHAPES = ((512, 1024), (1024, 1024))
ALU_REPS = 64
ALU_GRID = 8

# Per SM and clock on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table): 64 results of the ALU pipe
# (32-bit integer add, shift and logical operations: IADD3, SHF, LOP3) and 64
# of the FMA pipe's integer multiply-add, which also carries adds and moves
# (IMAD.IADD, IMAD.MOV); and one warp instruction per clock in each of the
# four sub-partitions, 128 results, for every instruction.
ALU_PIPE_PER_CLOCK = 64
FMA_PIPE_PER_CLOCK = 64
ISSUE_PER_CLOCK = 128
_ALU_OPCODES = ("IADD3", "SHF", "LOP3")
# length of the multiply loop under which the SM clock is read
_CLOCK_LOOP_S = 1.0

# the kernel line's fields of each probe kernel: (source, TPU kernel replaced)
SOURCES = {
    "probe_dot_s8": ("cuhe_tpu_torch/csrc/probe_dot.cu",
                     "scripts/tpu_probe_calib.py:52"),
    "probe_dot_bf16": ("cuhe_tpu_torch/csrc/probe_dot.cu",
                       "scripts/tpu_probe_calib.py:52"),
    "probe_dot_loads_only": ("cuhe_tpu_torch/csrc/probe_dot.cu",
                             "scripts/tpu_probe_calib.py:52"),
    "probe_dot_mma_only": ("cuhe_tpu_torch/csrc/probe_dot.cu",
                           "scripts/tpu_probe_calib.py:52"),
    "probe_alu": ("cuhe_tpu_torch/csrc/probe_alu.cu",
                  "scripts/tpu_probe_calib.py:87"),
}

_DOT_KERNELS = {  # input dtype -> (counter, C entry point, output dtype)
    torch.int8: ("probe_dot_s8", "cuhe_probe_dot_s8", torch.int32),
    torch.bfloat16: ("probe_dot_bf16", "cuhe_probe_dot_bf16", torch.float32),
}
DOT_COUNTERS = {"int8": "probe_dot_s8", "bf16": "probe_dot_bf16"}
# P1's stop points (csrc/probe_dot.cu): the TMA ring without wgmma, and the
# wgmma loop on one resident stage without loads; stop -> counter
DOT_STOPS = {"loads_only": "probe_dot_loads_only",
             "mma_only": "probe_dot_mma_only"}

# the dot kernel's tile: 128 rows of out by DOT_BN columns (256 where n
# allows, else 128)
DOT_BM = 128
DOT_BN = (256, 128)


# ---------------------------------------------------------------------------
# P1: tensor-core dot (replaces scripts/tpu_probe_calib.py::bench_dot)
# ---------------------------------------------------------------------------

def dot_launch_config(m: int, n: int, grid: int, sms: int) -> dict:
    """The dot kernel's launch for out [m, n] computed `grid` times on a card
    of `sms` SMs: the tile width bn (256 where n % 256 == 0, else 128), the
    units (one per copy and 128 x bn tile), and the persistent blocks,
    min(sms, units), each walking units block, block + blocks, ..."""
    bn = next(b for b in DOT_BN if n % b == 0)
    tiles = (m // DOT_BM) * (n // bn)
    units = grid * tiles
    return {"bn": bn, "tiles": tiles, "units": units,
            "blocks": min(sms, units)}


def dot_unit(u: int, cfg: dict, n: int) -> tuple[int, int, int]:
    """Unit u of a launch as the kernel reads it: (copy, first row, first
    column) of its tile of out."""
    tile = u % cfg["tiles"]
    tiles_n = n // cfg["bn"]
    return (u // cfg["tiles"], tile // tiles_n * DOT_BM,
            tile % tiles_n * cfg["bn"])


@contextlib.contextmanager
def _full_fp32():
    """float32 matmuls in full float32 (no TF32), restored on exit."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of `dot`: int8 through a float64 matmul (exact: every
    partial sum is an integer below 2^53 for k <= 2^38), bf16 through a
    float32 matmul with TF32 off."""
    if x.dtype == torch.int8:
        return (x.double() @ w.double()).to(torch.int32)
    if x.dtype == torch.bfloat16:
        with _full_fp32():
            return x.float() @ w.float()
    raise TypeError(f"dot takes int8 or bfloat16, got {x.dtype}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _dot_args(x, w, grid):
    """Check a kernel call's operands; returns (m, k, n, out dtype, launch
    config, w^T scratch)."""
    if x.dtype not in _DOT_KERNELS:
        raise TypeError(f"dot takes int8 or bfloat16, got {x.dtype}")
    # TMA reads x and w^T from 16-byte aligned rows
    _cuda.check(x, "x", x.dtype, align=16)
    _cuda.check(w, "w", x.dtype, device=x.device)
    (m, k), (k2, n) = x.shape, w.shape
    if k2 != k:
        raise ValueError(f"x [{m}, {k}] @ w [{k2}, {n}]: inner dims differ")
    if m % 128 or n % 128 or (k * x.element_size()) % 64 or not m * n * k:
        raise ValueError(f"dot kernel needs m, n multiples of 128 and "
                         f"k * itemsize of 64, got ({m}, {k}, {n})")
    if not 1 <= grid <= 65535:
        raise ValueError(f"grid {grid} out of range")
    wt = torch.empty((n, k), dtype=x.dtype, device=x.device)
    return (m, k, n, _DOT_KERNELS[x.dtype][2],
            dot_launch_config(m, n, grid, _sms(x.device.index)), wt)


def dot(x: torch.Tensor, w: torch.Tensor, *, grid: int = 1) -> torch.Tensor:
    """x @ w for x [m, k], w [k, n]: int8 -> int32 or bf16 -> float32.

    On the card the kernel computes the product `grid` times (the probe's
    repeated block) and needs m, n multiples of 128 and k * itemsize a
    multiple of 64."""
    if _is_cpu(x):
        return dot_plain(x, w)
    m, k, n, out_dtype, cfg, wt = _dot_args(x, w, grid)
    counter, fn, _ = _DOT_KERNELS[x.dtype]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _cuda.launch(counter, fn, x.device, x, w, wt, out, m, k, n, grid,
                 cfg["bn"], cfg["blocks"])
    return out


def dot_stop_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of `dot_stop`: the stop points compute no product and
    write zeros of the output's type."""
    if x.dtype not in _DOT_KERNELS:
        raise TypeError(f"dot takes int8 or bfloat16, got {x.dtype}")
    return torch.zeros((x.shape[0], w.shape[1]),
                       dtype=_DOT_KERNELS[x.dtype][2], device=x.device)


def dot_stop(x: torch.Tensor, w: torch.Tensor, stop: str, *,
             grid: int = 1) -> torch.Tensor:
    """`dot`'s kernel stopped at `stop` ("loads_only": the TMA ring and its
    barriers, no wgmma; "mma_only": the wgmma loop on one resident zeroed
    stage, no loads), with `dot`'s contract; returns its output, zeros."""
    if stop not in DOT_STOPS:
        raise ValueError(f"unknown stop point {stop}")
    if _is_cpu(x):
        return dot_stop_plain(x, w)
    m, k, n, out_dtype, cfg, wt = _dot_args(x, w, grid)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _cuda.launch(DOT_STOPS[stop], f"cuhe_probe_dot_{stop}", x.device, x, w,
                 wt, out, m, k, n, grid, cfg["bn"], cfg["blocks"],
                 int(x.dtype == torch.bfloat16))
    return out


def dot_tolerance(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-entry bound on |kernel - plain| for bf16 inputs: k * 2^-24 *
    (|x| @ |w|).  The products of bf16 values are exact in float32; each
    float32 sum of k of them is within (k - 1) * 2^-24 * sum |x_i w_i| of
    the exact sum, and two such sums in different orders stay within that
    bound in practice by a wide margin."""
    with _full_fp32():
        return x.shape[1] * 2.0 ** -24 * (x.float().abs() @ w.float().abs())


def dot_inputs(m: int, k: int, n: int, kind: str, device="cuda"):
    """bench_dot's inputs: rng 0; int8 in [-100, 100), or standard normal
    float32 rounded to bf16."""
    rng = np.random.default_rng(0)
    if kind == "int8":
        x = rng.integers(-100, 100, size=(m, k)).astype(np.int8)
        w = rng.integers(-100, 100, size=(k, n)).astype(np.int8)
        return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device))
    if kind != "bf16":
        raise ValueError(f"unknown dot kind {kind}")
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return x.to(torch.bfloat16).to(device), w.to(torch.bfloat16).to(device)


# P1 on the card at shapes `run` does not time (suite.check), held to
# dot_plain: (tag, kind, m, k, n, grid, fill).  n = 128 and 384 take the
# 128-wide tile; k * itemsize = 64 and 192 end in a half slice (TMA's zero
# fill); m = 128 with 1 and 3 copies; int8 operands at the extremes, whose
# sums of 1024 products (16,777,216, 16,516,096, -16,646,144) are exact in
# int32; bf16 operands whose exponents run from 2^-30 to 2^30.
DOT_CHECKS = tuple(
    [(f"n=128 {kd}", kd, 256, 512, 128, 64, "rand") for kd in ("int8", "bf16")]
    + [(f"n=384 {kd}", kd, 128, 512, 384, 64, "rand")
       for kd in ("int8", "bf16")]
    + [("k tail int8", "int8", 256, 64, 256, 64, "rand"),
       ("k tail bf16", "bf16", 256, 32, 256, 64, "rand"),
       ("slice + tail int8", "int8", 256, 192, 512, 8, "rand"),
       ("slice + tail bf16", "bf16", 256, 96, 512, 8, "rand")]
    + [(f"m=128 grid {g} {kd}", kd, 128, 256, 256, g, "rand")
       for g in (1, 3) for kd in ("int8", "bf16")]
    + [(f"int8 {f}", "int8", 128, 1024, 256, 2, f)
       for f in ("min", "max", "minmax")]
    + [("bf16 mixed exponents", "bf16", 256, 1024, 256, 4, "exp")])


def dot_check_inputs(kind: str, m: int, k: int, n: int, fill: str,
                     device="cuda"):
    """Inputs of a DOT_CHECKS case: "rand" draws int8 over its whole range
    or standard normal bf16 (rng 7); "min" is x = w = -128, "max" x = w =
    127, "minmax" x = -128 and w = 127; "exp" draws bf16 sign * [1, 2) *
    2^e, e uniform in [-30, 30]."""
    rng = np.random.default_rng(7)
    if kind == "int8":
        if fill == "rand":
            x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
            w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
        else:
            vx, vw = {"min": (-128, -128), "max": (127, 127),
                      "minmax": (-128, 127)}[fill]
            x = np.full((m, k), vx, np.int8)
            w = np.full((k, n), vw, np.int8)
        return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)

    def draw(shape):
        if fill == "rand":
            return rng.standard_normal(shape)
        sign = rng.choice([-1.0, 1.0], size=shape)
        return sign * rng.uniform(1, 2, shape) * np.exp2(
            rng.integers(-30, 31, size=shape))
    return tuple(torch.from_numpy(draw(s).astype(np.float32))
                 .to(torch.bfloat16).to(device) for s in ((m, k), (k, n)))


def _library_dot(xs, w):
    """One PyTorch call for the work of one kernel launch: x stacked `grid`
    times, [grid * m, k] @ [k, n], through cuBLAS's int8 GEMM (int32 out) or
    its bf16 GEMM with float32 out, as the kernel writes.  Timed only."""
    if xs.dtype == torch.int8:
        return torch._int_mm(xs, w)
    return torch.mm(xs, w, out_dtype=torch.float32)


def dot_error(got, want, x, w) -> float:
    """max |got - want|; raises unless got equals want (int8) or every entry
    is within `dot_tolerance` (bf16)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"dot: {got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    if x.dtype == torch.int8:
        if not torch.equal(got, want):
            raise AssertionError("dot int8: kernel != plain")
        return 0.0
    err = (got - want).abs()
    if not bool((err <= dot_tolerance(x, w)).all()):
        raise AssertionError("dot bf16: |kernel - plain| above "
                             "k 2^-24 (|x| @ |w|)")
    return float(err.max())


def dot_rate(m: int, k: int, n: int, kind: str, device="cuda") -> dict:
    """P1 at one shape on the card: the kernel's time and tensor-core rate,
    the plain version's and cuBLAS's times for the same work (DOT_GRID
    products, as one call on x stacked DOT_GRID times), and the bound at the
    data-sheet peak.  The kernel's last timed output is held against the
    plain version's first product (`dot_error`)."""
    dev = require_card(device)
    grid = DOT_GRID
    x, w = dot_inputs(m, k, n, kind, dev)
    xs = x.repeat(grid, 1)
    ms, got = cuda_ms_out(lambda: dot(x, w, grid=grid), REPS)
    plain_ms, want = cuda_ms_out(lambda: dot_plain(xs, w), PLAIN_REPS)
    err = dot_error(got, want[:m], x, w)
    del want
    library_ms = cuda_ms(lambda: _library_dot(xs, w), REPS)
    burst_ms = cuda_ms_burst(lambda: dot(x, w, grid=grid))
    library_burst_ms = cuda_ms_burst(lambda: _library_dot(xs, w))
    ops = 2.0 * m * k * n * grid
    nbytes = (m * k + k * n) * x.element_size() + m * n * 4
    b_ms, b_by = bound(nbytes, {kind: ops}, TENSOR_OPS_PER_S)
    counter = DOT_COUNTERS[kind]
    cfg = dot_launch_config(m, n, grid,
                            torch.cuda.get_device_properties(dev)
                            .multi_processor_count)
    return dict(probe="P1", kernel=counter, shape=f"{m}x{k}x{n} x{grid}",
                bn=cfg["bn"], blocks=cfg["blocks"], burst_ms=burst_ms,
                library_burst_ms=library_burst_ms,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                rate=ops / (ms * 1e-3), peak=TENSOR_OPS_PER_S[kind])


def dot_stop_rate(stop: str, kind: str, device="cuda") -> dict:
    """P1's kernel stopped at `stop` at 1024^3 x DOT_GRID on the card: its
    time beside the plain version's (zeros; the output is held to it) and
    its bound: for loads_only the bytes of the product (each input read
    once, the output written once), for mma_only the operations of the
    product at the data-sheet peak (and the output's bytes).  `tma_bytes`
    is what the TMA ring copies into shared memory in one call."""
    dev = require_card(device)
    m = k = n = 1024
    grid = DOT_GRID
    x, w = dot_inputs(m, k, n, kind, dev)
    ms, got = cuda_ms_out(lambda: dot_stop(x, w, stop, grid=grid), REPS)
    plain_ms, want = cuda_ms_out(lambda: dot_stop_plain(x, w), PLAIN_REPS)
    if not torch.equal(got, want):
        raise AssertionError(f"P1 {stop} {kind}: kernel != plain (zeros)")
    burst_ms = cuda_ms_burst(lambda: dot_stop(x, w, stop, grid=grid))
    ops = 2.0 * m * k * n * grid
    if stop == "loads_only":
        nbytes, opc = (m * k + k * n) * x.element_size() + m * n * 4, {}
    else:
        nbytes, opc = m * n * 4, {kind: ops}
    b_ms, b_by = bound(nbytes, opc, TENSOR_OPS_PER_S)
    cfg = dot_launch_config(m, n, grid,
                            torch.cuda.get_device_properties(dev)
                            .multi_processor_count)
    slices = -(-k * x.element_size() // 128)
    tma_bytes = cfg["units"] * slices * 128 * (DOT_BM + cfg["bn"])
    return dict(probe=f"P1 {stop}", kernel=DOT_STOPS[stop], kind=kind,
                shape=f"{m}x{k}x{n} x{grid}", ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=0.0, rate=ops / (ms * 1e-3),
                peak=TENSOR_OPS_PER_S[kind], tma_bytes=tma_bytes,
                burst_ms=burst_ms)


# ---------------------------------------------------------------------------
# P2: 32-bit add / xor / shift (replaces scripts/tpu_probe_calib.py::bench_vpu)
# ---------------------------------------------------------------------------

def alu_plain(x: torch.Tensor, *, reps: int = ALU_REPS) -> torch.Tensor:
    """Plain version of `alu`, on int64 words masked to 32 bits."""
    xi = modp.to_i64(x)
    y = xi
    for _ in range(reps):
        y = ((y + xi) & modp.M32) ^ (y >> 3)
    return modp.to_u32(y)


def alu(x: torch.Tensor, *, reps: int = ALU_REPS,
        grid: int = 1) -> torch.Tensor:
    """y = x, then `reps` times y = (y + x) ^ (y >> 3) over uint32 (wrap-
    around add, logical shift).  On the card the kernel recomputes it
    `grid` times (the probe's repeated block)."""
    if _is_cpu(x):
        return alu_plain(x, reps=reps)
    _cuda.check(x, "x", torch.uint32)
    if not 1 <= grid <= 65535 or reps < 0 or x.numel() >= 1 << 31:
        raise ValueError(f"alu: bad grid {grid}, reps {reps} or size")
    out = torch.empty_like(x)
    if x.numel():
        _cuda.launch("probe_alu", "cuhe_probe_alu", x.device, x, out,
                     x.numel(), reps, grid)
    return out


def alu_inputs(rows: int, cols: int, device="cuda") -> torch.Tensor:
    """bench_vpu's input: rng 0, uint32 [rows, cols]."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, size=(rows, cols), dtype=np.uint64)
    return torch.from_numpy(x.astype(np.uint32)).to(device)


_SASS_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def sass_loop(sass: str, kernel: str, most: str = "") -> collections.Counter:
    """Opcodes of the longest loop (a backward branch and the instructions
    back to its target) of the kernel whose name holds `kernel`, in the text
    `cuobjdump -sass` prints; with `most`, of the loop with the most
    instructions whose opcode starts with it."""
    for function in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, code = function.partition("\n")
        if kernel not in name:
            continue
        ins = [(int(a, 16), op, rest)
               for a, op, rest in _SASS_INSTRUCTION.findall(code)]
        where = {a: i for i, (a, _, _) in enumerate(ins)}
        loops = [ins[where[t]: i + 1] for i, (a, op, rest) in enumerate(ins)
                 if op == "BRA" and rest.startswith("0x")
                 and (t := int(rest.split()[0], 16)) < a and t in where]
        if not loops:
            raise ValueError(f"{name}: no loop in its SASS")
        return collections.Counter(op for _, op, _ in max(
            loops, key=lambda l: sum(op.startswith(most) for _, op, _ in l)))
    raise ValueError(f"no kernel named *{kernel}* in the SASS")


def dot_sass_counts(sass: str) -> dict:
    """Per variant of P1's kernel ("int8 bn=256", ...): the tensor-core
    instructions (HGMMA for bf16, IGMMA for int8) of its loop with the most
    of them and the TMA loads (UTMALDG) of its loop with the most of those,
    from `cuobjdump -sass` text.  Raises if either is zero: then the kernel
    is not the wgmma / TMA design."""
    counts = {}
    for kind, flag, op in (("int8", 0, "IGMMA"), ("bf16", 1, "HGMMA")):
        for bn in DOT_BN:
            name = f"dot_kernelILb{flag}ELi{bn}ELi0E"
            mma, tma = (sum(c for o, c in sass_loop(sass, name, want).items()
                            if o.startswith(want))
                        for want in (op, "UTMALDG"))
            if not mma or not tma:
                raise AssertionError(f"P1 {kind} bn={bn}: {mma} {op} and "
                                     f"{tma} UTMALDG in its loops")
            counts[f"{kind} bn={bn}"] = {op: mma, "UTMALDG": tma}
    return counts


def alu_loop_mix() -> collections.Counter:
    """The opcodes of P2's kernel loop, from the built library's SASS."""
    return sass_loop(_cuda.sass(), "alu_kernel")


def alu_peak_per_clock(mix: collections.Counter) -> float:
    """Add / xor / shift results per clock per SM that P2's loop can give
    at most: each pass of one thread through the loop does one step per
    logical right shift (SHF.R.U32.HI) in it, three results each, and holds
    each pipe for its share of the loop's instructions at that pipe's rate;
    the slowest pipe sets the time."""
    steps = mix["SHF.R.U32.HI"]
    alu = sum(c for op, c in mix.items() if op.split(".")[0] in _ALU_OPCODES)
    fma = sum(c for op, c in mix.items() if op.startswith("IMAD"))
    if not steps:
        raise ValueError(f"P2's loop has no shift: {dict(mix)}")
    clocks = max(alu / ALU_PIPE_PER_CLOCK, fma / FMA_PIPE_PER_CLOCK,
                 sum(mix.values()) / ISSUE_PER_CLOCK)
    return 3 * steps / clocks


def alu_rate(rows: int, cols: int, clock: dict, mix: collections.Counter,
             device="cuda") -> dict:
    """P2 at one shape on the card: time and rate, counted as bench_vpu
    counts them (3 operations per element and step), the plain version's
    time for the same work, and the bound at `alu_peak_per_clock(mix)` on
    every SM at the card's highest SM clock (`clock["max_mhz"]`).  The
    kernel's last timed output is held against the plain version's."""
    dev = require_card(device)
    reps, grid = ALU_REPS, ALU_GRID
    x = alu_inputs(rows, cols, dev)
    ms, got = cuda_ms_out(lambda: alu(x, reps=reps, grid=grid), REPS)
    plain_ms, want = cuda_ms_out(
        lambda: [alu_plain(x, reps=reps) for _ in range(grid)], PLAIN_REPS)
    if not torch.equal(got.view(torch.int32), want[0].view(torch.int32)):
        raise AssertionError(f"P2 alu {rows}x{cols}: kernel != plain")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    peak = alu_peak_per_clock(mix) * sms * clock["max_mhz"] * 1e6
    ops = 3.0 * rows * cols * reps * grid
    b_ms, b_by = bound(rows * cols * 8, {"alu": ops}, {"alu": peak})
    return dict(probe="P2", kernel="probe_alu",
                shape=f"{rows}x{cols} x{reps}x{grid}", ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, rate=ops / (ms * 1e-3),
                peak=peak)


# ---------------------------------------------------------------------------
# multiply rates (csrc/calib.cu) and the SM clock
# ---------------------------------------------------------------------------

_CALIB_ITERS = 4096
_CALIB_CHAINS = 8
_CALIB_THREADS = 256


def _calib_launcher(dev):
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    out = torch.empty(blocks * _CALIB_THREADS, dtype=torch.int64, device=dev)

    def launch(mode: int) -> None:
        _cuda.launch("calib", "cuhe_calib", dev, out, mode, _CALIB_ITERS,
                     blocks)
    return launch, blocks * _CALIB_THREADS * _CALIB_CHAINS * _CALIB_ITERS


def mul_rates(device="cuda") -> dict:
    """Peak multiply rates of the card, per second, from csrc/calib.cu.

    mul64_native, mad32_wide, mad32_pair: the three modes' rates.
    mad32: 32x32->64 products, the faster of one wide instruction and a
    low/high pair.  mul64: 64x64->128 products, the faster of the
    compiler's own and four 32x32->64 products (schoolbook)."""
    launch, ops = _calib_launcher(require_card(device))
    per_s = [ops / (cuda_ms(lambda: launch(mode), REPS, warm=2) * 1e-3)
             for mode in range(3)]
    mad32 = max(per_s[1], per_s[2])
    return {"mul64_native": per_s[0], "mad32_wide": per_s[1],
            "mad32_pair": per_s[2], "mad32": mad32,
            "mul64": max(per_s[0], mad32 / 4)}


def rates_line(rates: dict, clock: dict) -> str:
    """The multiply rates and the SM clock, as one log line's text."""
    return (f"per second: {rates['mul64_native'] / 1e12:.4f} T 64x64->128 "
            f"products, {rates['mad32_wide'] / 1e12:.4f} T wide and "
            f"{rates['mad32_pair'] / 1e12:.4f} T low/high-pair 32x32->64 "
            f"products; SM clock {clock['sm_mhz']:.0f} MHz of "
            f"{clock['max_mhz']:.0f} under load (loop still running at the "
            f"reading: {clock['busy']})")


def sample_sm_clock(device="cuda") -> dict:
    """The SM clock in MHz, read by nvidia-smi while about a second of the
    64-bit multiply calibration loop runs on the card.

    Returns sm_mhz and max_mhz as read, and busy: whether the loop was still
    running when the reading returned (if not, it may be an idle clock)."""
    dev = require_card(device)
    launch, _ = _calib_launcher(dev)
    one_ms = cuda_ms(lambda: launch(0), 3)
    count = max(1, math.ceil(_CLOCK_LOOP_S * 1e3 / one_ms))
    for _ in range(count):
        launch(0)
    done = torch.cuda.Event()
    done.record()
    time.sleep(_CLOCK_LOOP_S / 4)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    busy = not done.query()
    done.synchronize()
    sm, sm_max = (float(v) for v in out.strip().splitlines()[0].split(","))
    return {"sm_mhz": sm, "max_mhz": sm_max, "busy": busy}
