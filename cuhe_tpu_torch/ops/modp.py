"""Z_P arithmetic, P = 2^64 - 2^32 + 1, in plain PyTorch.

Counterpart of ``cuhe_tpu/ops/modp.py``.  A Z_P value is a ``(lo, hi)`` pair
of 32-bit words.  PyTorch has no unsigned 32/64-bit arithmetic, so the words
are widened to ``int64`` tensors holding values in [0, 2^32): a 32x32-bit
product is one int64 multiply, which wraps modulo 2^64 into the product's
64 bits (two's complement; PyTorch's CPU and CUDA integer multiplies do so,
and tests/test_torch_modp.py on the CPU and chip_smoke.py's phase 2 on the
card hold every wrapping operation here at the extremes against Python
ints), and a 128-bit product is folded back with 2^64 = 2^32 - 1 and
2^96 = -1 (mod P), as ModP.h does.  The plain NTT's loop works on each
value's u64 bit pattern in one int64 (`pack64`, `*_bits64`).

Two forms of every operation:
  * ``*64`` functions work on int64 word pairs (the form the other plain
    versions compute in);
  * the public names take and return ``torch.uint32`` pairs, the JAX
    package's layout, converting at the boundary.
All outputs are canonical, in [0, P).
"""

from __future__ import annotations

import numpy as np
import torch

P = 0xFFFFFFFF00000001
P_HI = 0xFFFFFFFF
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# uint32 <-> int64 word conversion (through int32 views, which every backend
# supports for uint32 tensors)
# ---------------------------------------------------------------------------

def to_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 tensor of the same values."""
    if x.dtype == torch.int64:
        return x
    if x.dtype != torch.uint32:
        raise TypeError(f"expected uint32 or int64, got {x.dtype}")
    return x.view(torch.int32).to(torch.int64) & M32


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor with values in [0, 2^32) -> uint32 tensor."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).view(torch.uint32)


def pair_from_u64(x: np.ndarray, device="cpu"):
    """numpy uint64 values -> uint32 pair on `device`."""
    x = np.asarray(x, dtype=np.uint64)
    lo = (x & np.uint64(M32)).astype(np.uint32)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


def u64_from_pair(lo: torch.Tensor, hi: torch.Tensor) -> np.ndarray:
    """uint32 pair -> numpy uint64 values."""
    lo = lo.cpu().numpy().astype(np.uint64)
    hi = hi.cpu().numpy().astype(np.uint64)
    return lo | (hi << np.uint64(32))


# ---------------------------------------------------------------------------
# int64 word-pair arithmetic
# ---------------------------------------------------------------------------

def mul32(a, b):
    """Full 32x32 -> 64-bit product of int64 words < 2^32, as a word pair.

    The product, up to (2^32 - 1)^2 > 2^63, wraps modulo 2^64 into the same
    64 bits; its words are the low 32 bits and the arithmetic shift's low
    32 bits."""
    p = a * b
    return p & M32, (p >> 32) & M32


def mul64(a, b):
    """Full 64x64 -> 128-bit product of word pairs: four words, LE."""
    l00, h00 = mul32(a[0], b[0])
    l01, h01 = mul32(a[0], b[1])
    l10, h10 = mul32(a[1], b[0])
    l11, h11 = mul32(a[1], b[1])
    s1 = h00 + l01 + l10
    s2 = h01 + h10 + l11 + (s1 >> 32)
    return l00, s1 & M32, s2 & M32, h11 + (s2 >> 32)


def _fold(lo, hi):
    """Canonical pair of V = lo + hi * 2^32 mod P.

    Valid for -P < V < 2^65 - 2^34 with |lo| < 2^34 (what add, sub and the
    128-bit fold below produce): the words are normalised, a 2^64 carry (or
    borrow) q is folded as q * (2^32 - 1), then one conditional subtract of P.
    """
    hi = hi + (lo >> 32)
    lo = lo & M32
    q = hi >> 32
    hi = (hi & M32) + q
    lo = lo - q
    hi = hi + (lo >> 32)
    lo = lo & M32
    ge = (hi == P_HI) & (lo >= 1)
    return torch.where(ge, lo - 1, lo), torch.where(ge, 0, hi)


def add_modp64(a, b):
    """(a + b) mod P for canonical int64 word pairs."""
    return _fold(a[0] + b[0], a[1] + b[1])


def sub_modp64(a, b):
    """(a - b) mod P for canonical int64 word pairs."""
    return _fold(a[0] - b[0], a[1] - b[1])


def mul_modp64(a, b):
    """(a * b) mod P for int64 word pairs a, b < 2^64."""
    w0, w1, w2, w3 = mul64(a, b)
    # V = w0 + w1 2^32 + w2 2^64 + w3 2^96 = (w0 - w2 - w3) + (w1 + w2) 2^32
    return _fold(w0 - w2 - w3, w1 + w2)


# ---------------------------------------------------------------------------
# u64 values as their bit patterns in one int64 (x - 2^64 for x >= 2^63):
# half the tensors and passes of a word pair, for the plain NTT's loop
# ---------------------------------------------------------------------------

_SIGN = -(1 << 63)
_EPS = (1 << 32) - 1                # 2^64 mod P
_P_KEY = (P - (1 << 64)) ^ _SIGN    # P's bit pattern, ordered as signed


def pack64(lo, hi) -> torch.Tensor:
    """int64 words -> the bit pattern of lo + hi * 2^32, reduced below P
    (a word pair < 2^64 may be at most 2^32 - 2 above it)."""
    x = lo | (hi << 32)
    return torch.where((x ^ _SIGN) >= _P_KEY, x + _EPS, x)


def unpack64(x):
    """Bit pattern -> its int64 words."""
    return x & M32, (x >> 32) & M32


def add_bits64(a, b):
    """(a + b) mod P for bit patterns of canonical values: where the sum
    wraps past 2^64 or reaches P, adding 2^64 - P (2^32 - 1, wrapping)
    gives it."""
    s = a + b
    fix = ((s ^ _SIGN) < (a ^ _SIGN)) | ((s ^ _SIGN) >= _P_KEY)
    return torch.where(fix, s + _EPS, s)


def sub_bits64(a, b):
    """(a - b) mod P for bit patterns of canonical values."""
    d = a - b
    return torch.where((a ^ _SIGN) < (b ^ _SIGN), d - _EPS, d)


def mul_bits64(a, w):
    """(a * w) mod P for the bit pattern a and w's int64 words (w0, w1):
    the four 32 x 32-bit products, their words summed as in `mul64`, then
    `_fold`; returns a bit pattern."""
    a0, a1 = a & M32, (a >> 32) & M32
    p00, p01, p10, p11 = a0 * w[0], a0 * w[1], a1 * w[0], a1 * w[1]
    s1 = ((p00 >> 32) & M32) + (p01 & M32) + (p10 & M32)
    s2 = (((p01 >> 32) & M32) + ((p10 >> 32) & M32) + (p11 & M32)
          + (s1 >> 32))
    w2 = s2 & M32
    lo, hi = _fold((p00 & M32) - w2 - ((p11 >> 32) & M32) - (s2 >> 32),
                   (s1 & M32) + w2)
    return lo | (hi << 32)


def canonicalize64(a):
    """Reduce a value < 2^64 to [0, P) (one conditional subtract)."""
    return _fold(a[0], a[1])


def mod_p64(a, p):
    """(lo + hi * 2^32) mod p for p < 2^32, by 16-bit Horner steps."""
    r = torch.remainder(a[1], p)
    r = torch.remainder((r << 16) | (a[0] >> 16), p)
    return torch.remainder((r << 16) | (a[0] & 0xFFFF), p)


def mulmod32(a, b, p):
    """(a * b) mod p for int64 words a, b < p < 2^32."""
    r = torch.remainder(a * (b >> 16), p)
    return torch.remainder((r << 16) + a * (b & 0xFFFF), p)


# ---------------------------------------------------------------------------
# public uint32-pair API (the JAX package's layout)
# ---------------------------------------------------------------------------

def _w(pair):
    return to_i64(pair[0]), to_i64(pair[1])


def _u(pair):
    return to_u32(pair[0]), to_u32(pair[1])


def add_modp(a, b):
    """(a + b) mod P for canonical uint32 pairs."""
    return _u(add_modp64(_w(a), _w(b)))


def sub_modp(a, b):
    """(a - b) mod P for canonical uint32 pairs."""
    return _u(sub_modp64(_w(a), _w(b)))


def mul_modp(a, b):
    """(a * b) mod P for uint32 pairs a, b < 2^64; canonical output."""
    return _u(mul_modp64(_w(a), _w(b)))


def canonicalize(a):
    """uint32 pair < 2^64 -> canonical uint32 pair."""
    return _u(canonicalize64(_w(a)))


def barrett_mu(p: int) -> tuple[int, int]:
    """Host precompute: mu = floor(2^64 / p) as (lo, hi) ints (the JAX
    package's Barrett constant; the port reduces with exact ``%``)."""
    mu = (1 << 64) // int(p)
    return mu & M32, mu >> 32


def barrett_mod_u64(x: int, p: int) -> int:
    """x mod p for x < 2^64 and 1 < p < 2^32, as the inverse NTT's column
    pass reduces (csrc/goldilocks.cuh::mod_p32), in Python ints: mu =
    floor((2^64 - 1) / p), q = umulhi(x, mu) (floor(x / p) or one less), r =
    x - q p, one conditional subtract."""
    mu = ((1 << 64) - 1) // p
    r = x - ((x * mu) >> 64) * p
    return r - p if r >= p else r


def mod_u32(x, p):
    """x mod p for a uint32 pair x < 2^64 and uint32 p (broadcastable)."""
    return to_u32(mod_p64(_w(x), to_i64(p)))


def mulmod_u32(a, b, p):
    """(a * b) mod p for uint32 a, b < p."""
    return to_u32(mulmod32(to_i64(a), to_i64(b), to_i64(p)))
