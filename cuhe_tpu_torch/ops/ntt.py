"""NTT tables, layouts and the plain PyTorch transforms.

Counterpart of the tables and layouts of ``cuhe_tpu/ops/ntt_kernels.py`` and
of ``cuhe_tpu/ops/ntt.py``.  The transform is the DFT over Z_P

    X[k] = sum_j x[j] w^(j k),   w = NTT_GEN^(65536 / n)

with the reference generator (Base.cu:64-67).  NTT-domain data is kept flat
``[.., n]`` in *mat-linear* order: with n = n1 * n2 from ``FACTORS``, the
element at ``k1 * n2 + k2`` is NTT index ``k1 + n1 * k2`` (the four-step
``[k1, k2]`` output layout the fused kernels write without a transpose).

The plain transforms here are iterative radix-2 over int64 word pairs, then
permuted to mat order; they are the reference the CUDA kernels of
``csrc/ntt.cu`` are held against.  Beside them: the shifts of the roots of
unity that are powers of two (`root_shift`), the shift multiply
(`mul_pow2`), and `dft64_radix16`, the kernels' 16 x L/16 split of each
pass's DFT written out in plain PyTorch with the kernels' index maps.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import hostmath as hm
from . import modp

P = hm.P

# The factorization of cuhe_tpu/ops/ntt_kernels.py::_FACTORS.  It fixes the
# mat layout, so it must stay the same as the JAX package's, (256, 128) at
# 32k included.
FACTORS = {16384: (128, 128), 32768: (256, 128), 65536: (256, 256)}


def factors(n: int) -> tuple[int, int]:
    if n not in FACTORS:
        raise ValueError(f"unsupported NTT length {n}")
    return FACTORS[n]


@lru_cache(maxsize=None)
def powers(n: int, inverse: bool = False) -> np.ndarray:
    """uint64 [n]: w^i (or w^-i) for the length-n root w."""
    factors(n)
    om = pow(hm.NTT_GEN, 65536 // n, P)
    if inverse:
        om = hm.modinv(om, P)
    pw = np.empty(n, dtype=np.uint64)
    cur = 1
    for i in range(n):
        pw[i] = cur
        cur = cur * om % P
    return pw


def n_inverse(n: int) -> int:
    return hm.modinv(n, P)


@lru_cache(maxsize=None)
def bitrev_index(length: int, device: str) -> torch.Tensor:
    """The bit-reversal permutation of range(length), length a power of 2."""
    bits = length.bit_length() - 1
    idx = np.arange(length, dtype=np.int64)
    rev = np.zeros(length, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return torch.from_numpy(rev).to(device)


@lru_cache(maxsize=None)
def power_words(n: int, inverse: bool, device: str):
    """w^e (or w^-e), e < n, as an int64 word pair on `device`."""
    t = torch.from_numpy(powers(n, inverse).view(np.int64).copy()).to(device)
    return t & modp.M32, (t >> 32) & modp.M32


# Rows per block of `dft64` on the CPU: the transforms are independent, and
# a block whose temporaries (2 MB each at 16k) stay in the CPU's caches
# runs faster there than one pass over hundreds of rows.
CPU_ROWS = 16


def dft64(lo, hi, n: int, inverse: bool = False, length: int | None = None):
    """Length-L DFTs of int64 word pairs [B, L] in natural order (radix-2
    DIT), L = `length` (default n), with the root w^(n/L) of the length-n
    root w (w^-(n/L) for `inverse`): the sub-transforms of a four-step
    split of n take L = n1 or n2.

    Returns the pair in natural (std) NTT index order.  Never forms more than
    a few [B, L] temporaries (on the CPU, [CPU_ROWS, L]).  The butterflies
    work on each value's bit pattern in one int64 (`modp.pack64`).
    """
    L = n if length is None else length
    if L & (L - 1) or not 1 <= L <= n:
        raise ValueError(f"bad DFT length {L} for n = {n}")
    if lo.device.type == "cpu" and lo.shape[0] > CPU_ROWS:
        parts = [dft64(lo[i: i + CPU_ROWS], hi[i: i + CPU_ROWS], n, inverse, L)
                 for i in range(0, lo.shape[0], CPU_ROWS)]
        return (torch.cat([v[0] for v in parts]),
                torch.cat([v[1] for v in parts]))
    rev = bitrev_index(L, str(lo.device))
    tw_lo, tw_hi = power_words(n, inverse, str(lo.device))
    x = modp.pack64(lo, hi)[:, rev]
    b = x.shape[0]
    h = 1
    while h < L:
        idx = torch.arange(h, device=x.device) * (n // (2 * h))
        xv = x.view(b, L // (2 * h), 2, h)
        u = xv[:, :, 0]
        v = (xv[:, :, 1] if h == 1  # the twiddle w^0 = 1
             else modp.mul_bits64(xv[:, :, 1], (tw_lo[idx], tw_hi[idx])))
        x = torch.stack((modp.add_bits64(u, v), modp.sub_bits64(u, v)),
                        dim=2).reshape(b, L)
        h *= 2
    return modp.unpack64(x)


def std_to_mat(x: torch.Tensor, n: int) -> torch.Tensor:
    """Std NTT order [.., n] -> mat-linear order [.., n]."""
    n1, n2 = factors(n)
    lead = x.shape[:-1]
    return x.reshape(lead + (n2, n1)).transpose(-1, -2).reshape(lead + (n,))


def mat_to_std(x: torch.Tensor, n: int) -> torch.Tensor:
    """Mat-linear order [.., n] -> std NTT order [.., n]."""
    n1, n2 = factors(n)
    lead = x.shape[:-1]
    return x.reshape(lead + (n1, n2)).transpose(-1, -2).reshape(lead + (n,))


def extract_digit(raw: torch.Tensor, w: int, wid: int) -> torch.Tensor:
    """w-bit window `wid` of RAW words [.., w32, L] -> int64 [.., L].

    ntt_1_*_ext_block semantics (Base.cu:360-371), bit for bit with
    cuhe_tpu/ops/ntt.py::extract_digit: planes past the top word read zero.
    """
    w32 = raw.shape[-2]
    bit = w * wid
    k, sh = bit >> 5, bit & 31
    lo = modp.to_i64(raw[..., k, :]) if k < w32 else torch.zeros_like(
        modp.to_i64(raw[..., 0, :]))
    val = lo >> sh
    if sh and k + 1 < w32:
        val = val | ((modp.to_i64(raw[..., k + 1, :]) << (32 - sh)) & modp.M32)
    mask = (1 << w) - 1 if w < 32 else modp.M32
    return val & mask


# ---------------------------------------------------------------------------
# the radix-16 split of csrc/ntt.cu's passes
# ---------------------------------------------------------------------------

# 2^96 = -1 mod P, so 2 has order 192 and every root of unity of an order
# dividing 64 is a power of two
ORDER_OF_2 = 192


@lru_cache(maxsize=None)
def root_shift(n: int, length: int, inverse: bool = False) -> int:
    """The s in [0, 192) with 2^s = w^(n/length) mod P (w^-(n/length) for
    `inverse`), w the length-n root: the root of a length-`length` DFT.
    Raises where no power of two is that root (length 128 or more)."""
    factors(n)
    if length & (length - 1) or not 1 <= length <= n:
        raise ValueError(f"bad DFT length {length} for n = {n}")
    root = pow(hm.NTT_GEN, 65536 // length, P)
    if inverse:
        root = hm.modinv(root, P)
    for s in range(ORDER_OF_2):
        if pow(2, s, P) == root:
            return s
    raise ValueError(f"no power of two is the length-{length} root of unity "
                     f"(n = {n}, inverse = {inverse})")


def _times_2r(x, r: int):
    """x * 2^r for a canonical word pair x and 0 <= r < 32."""
    t0 = x[0] << r
    t1 = (x[1] << r) + (t0 >> 32)
    # V = w0 + w1 2^32 + w2 2^64, 2^64 = 2^32 - 1
    return modp._fold((t0 & modp.M32) - (t1 >> 32),
                      (t1 & modp.M32) + (t1 >> 32))


def mul_pow2(x, s: int):
    """x * 2^s mod P for a canonical int64 word pair x, with shifts and the
    folds 2^64 = 2^32 - 1, 2^96 = -1 only (no multiply)."""
    s %= ORDER_OF_2
    if s >= 96:
        x = modp.sub_modp64((torch.zeros_like(x[0]), torch.zeros_like(x[1])), x)
        s -= 96
    q, r = divmod(s, 32)
    if r:
        x = _times_2r(x, r)
    for _ in range(q):  # times 2^32: words (0, lo, hi)
        x = modp._fold(-x[1], x[0] + x[1])
    return x


def _dif(v: list, shift: int, half_zero: bool = False) -> list:
    """Radix-2 DIF DFT of the R = len(v) word pairs v with the root 2^shift
    (an R-th root of unity), as csrc/ntt.cu's `dft_regs`: returns the R
    outputs in natural order (the kernel's registers hold them
    bit-reversed).  half_zero: v[R/2:] are zero, and the first level is
    v[i + R/2] = v[i] 2^(shift i)."""
    v = list(v)
    R = len(v)
    m = R
    while m > 1:
        h = m // 2
        for b in range(0, R, m):
            for j in range(h):
                s = shift * (R // m) * j % ORDER_OF_2
                u, t = v[b + j], v[b + j + h]
                if half_zero and m == R:
                    v[b + j + h] = mul_pow2(u, s)
                else:
                    v[b + j] = modp.add_modp64(u, t)
                    v[b + j + h] = mul_pow2(modp.sub_modp64(u, t), s)
        m = h
    bits = R.bit_length() - 1
    return [v[int(f"{k:0{bits}b}"[::-1], 2)] for k in range(R)]


def dft64_radix16(lo, hi, n: int, inverse: bool = False,
                  length: int | None = None, half_zero: bool = False):
    """The length-L DFTs of int64 word pairs [B, L] as csrc/ntt.cu's passes
    compute them, L = 16 M (M = 8 or 16): sub-DFT a < M takes x[a + M jb],
    jb < 16, through the length-16 DFT on the root 2^root_shift(n, 16);
    element kb is multiplied by w_L^(a kb), a shift where L/64 divides a kb,
    else a product with the power table; sub-DFT kb < 16 takes those
    elements over a through the length-M DFT, and its element ka is X[kb +
    16 ka].  half_zero: x[L/2:] are zero (the forward column pass), so the
    first level of each length-16 DFT is a shift.  Same result as
    `dft64(lo, hi, n, inverse, length)`."""
    L = n if length is None else length
    if L not in (128, 256):
        raise ValueError(f"the passes split lengths 128 and 256, not {L}")
    m = L // 16
    s16, sm, s64 = (root_shift(n, r, inverse) for r in (16, m, 64))
    tw_lo, tw_hi = power_words(n, inverse, str(lo.device))
    y = {}
    for a in range(m):
        v = _dif([(lo[:, a + m * jb], hi[:, a + m * jb]) for jb in range(16)],
                 s16, half_zero)
        for kb in range(16):
            e = a * kb % L
            if e % (L // 64):
                i = n // L * e
                y[a, kb] = modp.mul_modp64(v[kb], (tw_lo[i], tw_hi[i]))
            else:
                y[a, kb] = mul_pow2(v[kb], s64 * (e // (L // 64)))
    out = [None] * L
    for kb in range(16):
        f = _dif([y[a, kb] for a in range(m)], sm)
        for ka in range(m):
            out[kb + 16 * ka] = f[ka]
    return (torch.stack([o[0] for o in out], 1),
            torch.stack([o[1] for o in out], 1))
