"""The NTT kernels pass by pass: the counterpart of the TPU stage ablations
``scripts/tpu_probe_inv_ablate.py::make_ablate`` (P3, the inverse, B2) and
``scripts/tpu_probe_fwd32_ablate.py::make_ablate`` (P4, the forward, B1).

A length-n NTT runs as two passes of ``csrc/ntt.cu`` over the four-step
split n = n1 * n2 (``ops/ntt.py``).  Each pass kernel takes a compile-time
stop point, and the front ends here launch the same kernels the transforms
launch, stopped there:

  forward  (input u32 [.., n/2] -> uint32 pair [.., n] at [k1, j2])
    cols_io      the column pass's load and store only: out[k1, j2] =
                 x[bitrev(k1), j2] (zero for rows >= n1/2), hi words 0
    cols_notw    the column DFTs, without the twiddle
    cols         the whole column pass: DFTs times w^(k1 j2)
    rows         the row pass (pair in, pair out), the second launch
  inverse  (input uint32 pair [.., n] mat-linear)
    rows_io      the row pass's load and store only, into u64 words:
                 out[k1, t2] = x[k1, bitrev(t2)]
    inv_rows     the row DFTs times w^-(k1 t2), into u64 words
    inv_nomod    the column DFTs times n^-1, without the mod p: a uint32
                 pair [.., n] in natural order (u64 words in)
    inv_cols     the whole column pass, mod p: uint32 [.., n]

A u64 word is kept in an int64 tensor as its bit pattern.  Each front end
launches its kernel for a CUDA tensor and runs its plain version (``*_plain``,
built from ``ops/ntt.py``'s `dft64` and power tables) for a CPU tensor.

The probes' variants map onto the same points of the pipeline:

  P3 (inverse, 16k)   digits  -> rows_io
                      stage1  -> inv_rows            (its lo words)
                      nomod   -> inv_rows, inv_nomod (its lo words)
                      full    -> inv_linear, p = 0xFFF1
  P4 (forward, 16k    io      -> cols_io
      and 32k)        stage1  -> cols_notw
                      twiddle -> cols                (its lo words)
                      digits8 -> cols
                      full    -> fwd_linear

The TPU's digit stages (P3 ``digits``, P4 ``io`` and ``digits8``) cut its
operands into int8 digit planes for the MXU; the port computes on whole
64-bit words and has no digit planes (ROADMAP A1), so those variants have
no point of their own here: ``digits`` and ``io`` are the load and store,
and ``digits8`` is the same point as ``twiddle``.  P4 ``stage1`` is a lazy,
non-canonical value on the TPU; here it is canonical.
"""

from __future__ import annotations

from math import prod

import numpy as np
import torch

from ..ops import _cuda, modp, ntt
from ..ops import ntt_kernels as nk
from .timing import ntt_products, radix16_products, twiddle_products

# the probes' shapes: (n, transforms), tpu_probe_inv_ablate.py:168-170 and
# tpu_probe_fwd32_ablate.py:398; and PRINCE level 0's, 32 ciphertexts x 25
# primes of n = 32768 (cuhe_tpu/models/prince.py:108)
INV_PROBE_SHAPES = ((16384, 512),)
FWD_PROBE_SHAPES = ((16384, 512), (32768, 512))
PRINCE_SHAPE = (32768, 32 * 25)
# P3's `full` reduces every transform mod one prime, 0xFFF1 (:256)
INV_PROBE_PRIME = 0xFFF1

INV_VARIANTS = {"digits": ("rows_io",), "stage1": ("inv_rows",),
                "nomod": ("inv_rows", "inv_nomod"), "full": ("inv_linear",)}
FWD_VARIANTS = {"io": ("cols_io",), "stage1": ("cols_notw",),
                "twiddle": ("cols",), "digits8": ("cols",),
                "full": ("fwd_linear",)}
PASSES = ("cols_io", "cols_notw", "cols", "rows", "rows_io", "inv_rows",
          "inv_nomod", "inv_cols")
# launch counter of each pass's front end
COUNTERS = {name: f"ntt_{name}" for name in PASSES}
# the kernel line's fields of each pass: (source, TPU kernel replaced), the
# forward passes P4's ablation, the inverse ones P3's
SOURCES = {COUNTERS[name]: (
    "cuhe_tpu_torch/csrc/ntt.cu",
    "scripts/tpu_probe_fwd32_ablate.py:51"
    if name in ("cols_io", "cols_notw", "cols", "rows")
    else "scripts/tpu_probe_inv_ablate.py:57") for name in PASSES}


def _log2(v: int) -> int:
    return v.bit_length() - 1


# ---------------------------------------------------------------------------
# word helpers of the plain versions
# ---------------------------------------------------------------------------

def u64_bits(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int64 tensor of the u64 bit pattern."""
    return (modp.to_u32(hi).view(torch.int32).to(torch.int64) << 32) | lo


def u64_words(a: torch.Tensor):
    """int64 tensor of u64 bit patterns -> (lo, hi) int64 words."""
    return a & modp.M32, (a >> 32) & modp.M32


def lo_plane(out) -> torch.Tensor:
    """The low 32-bit words of a pass's output, as uint32: the plane the
    TPU probes write."""
    if isinstance(out, tuple):
        return out[0]
    if out.dtype == torch.int64:
        return modp.to_u32(out & modp.M32)
    return out


def _twiddle_grid(n: int, inverse: bool, device: str):
    """w^(k1 j2) (or w^-(k1 j2)) as int64 words [n1, n2]."""
    n1, n2 = ntt.factors(n)
    tw_lo, tw_hi = ntt.power_words(n, inverse, device)
    e = (torch.arange(n1, device=device)[:, None]
         * torch.arange(n2, device=device)[None, :]) % n
    return tw_lo[e], tw_hi[e]


def _col_dft(lo, hi, n: int, inverse: bool):
    """Length-n1 DFTs down the columns of int64 words [count, n1, n2]."""
    count, n1, n2 = lo.shape

    def t(v):
        return v.transpose(1, 2).reshape(-1, n1)
    lo, hi = ntt.dft64(t(lo), t(hi), n, inverse, length=n1)
    return (lo.reshape(count, n2, n1).transpose(1, 2),
            hi.reshape(count, n2, n1).transpose(1, 2))


def _row_dft(lo, hi, n: int, inverse: bool):
    """Length-n2 DFTs along the rows of int64 words [count, n1, n2]."""
    count, n1, n2 = lo.shape
    lo, hi = ntt.dft64(lo.reshape(-1, n2), hi.reshape(-1, n2), n, inverse,
                       length=n2)
    return lo.reshape(count, n1, n2), hi.reshape(count, n1, n2)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _fwd_cols_plain(x: torch.Tensor, n: int, stop: str):
    n1, n2 = ntt.factors(n)
    lead = x.shape[:-1]
    xi = modp.to_i64(x).reshape(-1, n1 // 2, n2)
    lo = torch.zeros((xi.shape[0], n1, n2), dtype=torch.int64,
                     device=x.device)
    lo[:, : n1 // 2] = xi
    hi = torch.zeros_like(lo)
    if stop == "io":
        lo = lo[:, ntt.bitrev_index(n1, str(x.device))]
    else:
        lo, hi = _col_dft(lo, hi, n, False)
        if stop == "full":
            lo, hi = modp.mul_modp64((lo, hi), _twiddle_grid(n, False,
                                                             str(x.device)))
    return (modp.to_u32(lo).reshape(lead + (n,)),
            modp.to_u32(hi).reshape(lead + (n,)))


def cols_io_plain(x, n):
    return _fwd_cols_plain(x, n, "io")


def cols_notw_plain(x, n):
    return _fwd_cols_plain(x, n, "notw")


def cols_plain(x, n):
    return _fwd_cols_plain(x, n, "full")


def _pair_grid(pair, n: int):
    n1, n2 = ntt.factors(n)
    return (modp.to_i64(pair[0]).reshape(-1, n1, n2),
            modp.to_i64(pair[1]).reshape(-1, n1, n2))


def rows_plain(pair, n):
    lead = pair[0].shape[:-1]
    lo, hi = _row_dft(*_pair_grid(pair, n), n, False)
    return (modp.to_u32(lo).reshape(lead + (n,)),
            modp.to_u32(hi).reshape(lead + (n,)))


def rows_io_plain(pair, n):
    lead = pair[0].shape[:-1]
    lo, hi = _pair_grid(pair, n)
    rev = ntt.bitrev_index(lo.shape[-1], str(lo.device))
    return u64_bits(lo[..., rev], hi[..., rev]).reshape(lead + (n,))


def inv_rows_plain(pair, n):
    lead = pair[0].shape[:-1]
    lo, hi = _row_dft(*_pair_grid(pair, n), n, True)
    lo, hi = modp.mul_modp64((lo, hi), _twiddle_grid(n, True, str(lo.device)))
    return u64_bits(lo, hi).reshape(lead + (n,))


def _inv_cols64(a, n: int):
    n1, n2 = ntt.factors(n)
    lo, hi = u64_words(a.reshape(-1, n1, n2))
    lo, hi = _col_dft(lo, hi, n, True)
    ninv = ntt.n_inverse(n)
    return modp.mul_modp64((lo, hi), (ninv & modp.M32, ninv >> 32))


def inv_nomod_plain(a, n):
    lead = a.shape[:-1]
    lo, hi = _inv_cols64(a, n)
    return (modp.to_u32(lo).reshape(lead + (n,)),
            modp.to_u32(hi).reshape(lead + (n,)))


def inv_cols_plain(a, n, p):
    lead = a.shape[:-1]
    lo, hi = _inv_cols64(a, n)
    p_b = torch.broadcast_to(modp.to_i64(p), lead).reshape(-1, 1, 1)
    return modp.to_u32(modp.mod_p64((lo, hi), p_b)).reshape(lead + (n,))


# ---------------------------------------------------------------------------
# front ends
# ---------------------------------------------------------------------------

def _cols(name: str, x: torch.Tensor, n: int):
    nk.check_root_shift(n, False)
    n1, n2 = ntt.factors(n)
    _cuda.check(x, "x", torch.uint32)
    if x.shape[-1] != n // 2:
        raise ValueError(f"x: last dim {x.shape[-1]} != n/2 = {n // 2}")
    lead = tuple(x.shape[:-1])
    lo = torch.empty(lead + (n,), dtype=torch.uint32, device=x.device)
    hi = torch.empty_like(lo)
    if prod(lead):
        _cuda.launch(COUNTERS[name], f"cuhe_ntt_{name}", x.device, x, lo, hi,
                     nk._device_powers(n, False, str(x.device)), prod(lead),
                     _log2(n1), _log2(n2))
    return lo, hi


def _check_pair(pair, n: int):
    lo, hi = pair
    # the row pass loads 16 bytes at a time
    _cuda.check(lo, "x_lo", torch.uint32, align=16)
    if lo.shape[-1] != n:
        raise ValueError(f"x_lo: last dim {lo.shape[-1]} != n = {n}")
    _cuda.check(hi, "x_hi", torch.uint32, lo.shape, lo.device, align=16)
    return tuple(lo.shape[:-1])


def _check_u64(a: torch.Tensor, n: int):
    _cuda.check(a, "a", torch.int64)
    if a.shape[-1] != n:
        raise ValueError(f"a: last dim {a.shape[-1]} != n = {n}")
    return tuple(a.shape[:-1])


def cols_io(x: torch.Tensor, n: int):
    """Forward column pass, load and store only (u32 [.., n/2] -> pair)."""
    return cols_io_plain(x, n) if nk._is_cpu(x) else _cols("cols_io", x, n)


def cols_notw(x: torch.Tensor, n: int):
    """Forward column DFTs without the twiddle (u32 [.., n/2] -> pair)."""
    return cols_notw_plain(x, n) if nk._is_cpu(x) else _cols("cols_notw", x, n)


def cols(x: torch.Tensor, n: int):
    """The whole forward column pass (u32 [.., n/2] -> pair)."""
    return cols_plain(x, n) if nk._is_cpu(x) else _cols("cols", x, n)


def rows(pair, n: int):
    """The forward row pass, out of place (pair [.., n] -> pair [.., n])."""
    if nk._is_cpu(pair[0]):
        return rows_plain(pair, n)
    nk.check_root_shift(n, False)
    n1, n2 = ntt.factors(n)
    lead = _check_pair(pair, n)
    lo = torch.empty(lead + (n,), dtype=torch.uint32, device=pair[0].device)
    hi = torch.empty_like(lo)
    if prod(lead):
        _cuda.launch(COUNTERS["rows"], "cuhe_ntt_rows", lo.device, pair[0],
                     pair[1], lo, hi,
                     nk._device_powers(n, False, str(lo.device)),
                     prod(lead) << _log2(n1), _log2(n1), _log2(n2))
    return lo, hi


def _inv_rows(name: str, pair, n: int):
    nk.check_root_shift(n, True)
    n1, n2 = ntt.factors(n)
    lead = _check_pair(pair, n)
    out = torch.empty(lead + (n,), dtype=torch.int64, device=pair[0].device)
    if prod(lead):
        _cuda.launch(COUNTERS[name], f"cuhe_ntt_{name}", out.device, pair[0],
                     pair[1], out, nk._device_powers(n, True, str(out.device)),
                     prod(lead), _log2(n1), _log2(n2))
    return out


def rows_io(pair, n: int):
    """Inverse row pass, load and store only (pair -> u64 words [.., n])."""
    return (rows_io_plain(pair, n) if nk._is_cpu(pair[0])
            else _inv_rows("rows_io", pair, n))


def inv_rows(pair, n: int):
    """The whole inverse row pass (pair -> u64 words [.., n])."""
    return (inv_rows_plain(pair, n) if nk._is_cpu(pair[0])
            else _inv_rows("inv_rows", pair, n))


def inv_nomod(a: torch.Tensor, n: int):
    """Inverse column DFTs times n^-1, without the mod p (u64 words
    [.., n] -> pair [.., n] in natural order)."""
    if nk._is_cpu(a):
        return inv_nomod_plain(a, n)
    nk.check_root_shift(n, True)
    n1, n2 = ntt.factors(n)
    lead = _check_u64(a, n)
    lo = torch.empty(lead + (n,), dtype=torch.uint32, device=a.device)
    hi = torch.empty_like(lo)
    if prod(lead):
        _cuda.launch(COUNTERS["inv_nomod"], "cuhe_ntt_inv_nomod", a.device, a,
                     lo, hi, nk._device_powers(n, True, str(a.device)),
                     prod(lead), _log2(n1), _log2(n2))
    return lo, hi


def inv_cols(a: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """The whole inverse column pass, each transform mod its prime (u64
    words [.., n], uint32 p broadcastable to the leading dims -> uint32
    [.., n] in natural order)."""
    if nk._is_cpu(a):
        return inv_cols_plain(a, n, p)
    nk.check_root_shift(n, True)
    n1, n2 = ntt.factors(n)
    lead = _check_u64(a, n)
    _cuda.check(p, "p", torch.uint32, device=a.device)
    p_b = nk._u32_contiguous(torch.broadcast_to(p, lead))
    out = torch.empty(lead + (n,), dtype=torch.uint32, device=a.device)
    if prod(lead):
        _cuda.launch(COUNTERS["inv_cols"], "cuhe_ntt_inv_cols", a.device, a,
                     out, p_b, nk._device_powers(n, True, str(a.device)),
                     prod(lead), _log2(n1), _log2(n2))
    return out


# ---------------------------------------------------------------------------
# the probes' variants
# ---------------------------------------------------------------------------

def inv_probe_input(batch: int, n: int = 16384, device="cpu"):
    """P3's input as tpu_probe_inv_ablate.py builds it: c uint32 [batch, n]
    below 2^31 from default_rng(1), taken as the pair (c, c)."""
    n1, n2 = ntt.factors(n)
    rng = np.random.default_rng(1)
    c = rng.integers(0, 1 << 31, size=(batch, n1, n2), dtype=np.uint32)
    t = torch.from_numpy(c.reshape(batch, n)).to(device)
    return t, t


def fwd_probe_input(batch: int, n: int, device="cpu", seed: int = 1):
    """P4's input as tpu_probe_fwd32_ablate.py builds it: uint32
    [batch, n/2] below 2^31 from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 31, size=(batch, n // 2), dtype=np.uint32)
    return torch.from_numpy(x).to(device)


def inv_ablate(variant: str, x_pair, n: int = 16384):
    """P3's `variant` of the inverse on x_pair: the output of the last pass
    the port runs for it (INV_VARIANTS); `full` reduces every transform mod
    INV_PROBE_PRIME."""
    passes = INV_VARIANTS[variant]
    if passes == ("inv_linear",):
        p = modp.to_u32(torch.tensor([INV_PROBE_PRIME]))
        return nk.inv_linear(x_pair, n, p.to(x_pair[0].device))
    out = (rows_io if passes[0] == "rows_io" else inv_rows)(x_pair, n)
    return inv_nomod(out, n) if passes[-1] == "inv_nomod" else out


def fwd_ablate(variant: str, x: torch.Tensor, n: int):
    """P4's `variant` of the forward on x: the output of the pass the port
    runs for it (FWD_VARIANTS)."""
    fn = {"cols_io": cols_io, "cols_notw": cols_notw, "cols": cols,
          "fwd_linear": nk.fwd_linear}[FWD_VARIANTS[variant][0]]
    return fn(x, n)


# bytes read and written per coefficient by each pass; inv_cols also reads
# one 4-byte prime per transform
_PASS_BYTES = {"cols_io": (2, 8), "cols_notw": (2, 8), "cols": (2, 8),
               "rows": (8, 8), "rows_io": (8, 8), "inv_rows": (8, 8),
               "inv_nomod": (8, 8), "inv_cols": (8, 4)}
# the whole transforms as their passes
TRANSFORM_PASSES = {"fwd_linear": ("cols", "rows"),
                    "inv_linear": ("inv_rows", "inv_cols")}


def pass_model(passes, n: int, count: int):
    """(bytes, {"mul64": products}) of `passes`, run one after the other
    over `count` transforms, for their bound.  Bytes: the first pass's input
    read once and the last pass's output written once (what passes between
    them is not the function's traffic).  Products: the radix-64 DFTs
    (`ntt_products`) of each pass's length and the twiddles that are not
    powers of two."""
    passes = [q for name in passes
              for q in TRANSFORM_PASSES.get(name, (name,))]
    n1, n2 = ntt.factors(n)
    col = n2 * ntt_products(n1)
    row = n1 * ntt_products(n2)
    tw = twiddle_products(n, n1, n2)
    products = {"cols_io": 0, "cols_notw": col, "cols": col + tw, "rows": row,
                "rows_io": 0, "inv_rows": row + tw, "inv_nomod": col,
                "inv_cols": col}
    nbytes = (_PASS_BYTES[passes[0]][0] + _PASS_BYTES[passes[-1]][1]) * n
    nbytes += 4 * (passes[-1] == "inv_cols")
    total = sum(products[q] for q in passes)
    return count * nbytes, ({"mul64": count * total} if total else {})


def kernel_products(passes, n: int) -> int:
    """Generic 64x64->128 products per transform that the kernels of
    `passes` do (shifts by powers of two not counted): the inner twiddles of
    the radix-16 split that are not shifts (`radix16_products`), and the
    four-step twiddle of `cols` and `inv_rows`: one product per coefficient,
    and M - 1 more per M coefficients for its recurrence (M = n1/16 in
    `cols`, n2/16 in `inv_rows`).  The inverse column pass's n^-1 is a
    shift."""
    passes = [q for name in passes
              for q in TRANSFORM_PASSES.get(name, (name,))]
    n1, n2 = ntt.factors(n)
    col, row = n2 * radix16_products(n1), n1 * radix16_products(n2)
    col_tw = n + n // (n1 // 16) * (n1 // 16 - 1)
    row_tw = n + n // (n2 // 16) * (n2 // 16 - 1)
    products = {"cols_io": 0, "cols_notw": col, "cols": col + col_tw,
                "rows": row, "rows_io": 0, "inv_rows": row + row_tw,
                "inv_nomod": col, "inv_cols": col}
    return sum(products[q] for q in passes)


# id of each pass's kernel for `blocks_per_sm` (csrc/ntt.cu,
# cuhe_ntt_blocks_per_sm); "digits" is the digit NTT's column pass (B6)
_KERNEL_IDS = {**{name: i for i, name in enumerate(PASSES)}, "digits": 8}


def blocks_per_sm(name: str, n: int, device) -> int:
    """Resident blocks per SM of the kernel that pass `name` launches at
    length n on `device` (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n1, n2 = ntt.factors(n)
    return _cuda.query("cuhe_ntt_blocks_per_sm", torch.device(device),
                       _KERNEL_IDS[name], _log2(n1), _log2(n2))
