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
``csrc/ntt.cu`` are held against.
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


def dft64(lo, hi, n: int, inverse: bool = False, length: int | None = None):
    """Length-L DFTs of int64 word pairs [B, L] in natural order (radix-2
    DIT), L = `length` (default n), with the root w^(n/L) of the length-n
    root w (w^-(n/L) for `inverse`): the sub-transforms of a four-step
    split of n take L = n1 or n2.

    Returns the pair in natural (std) NTT index order.  Never forms more than
    a few [B, L] temporaries.
    """
    L = n if length is None else length
    if L & (L - 1) or not 1 <= L <= n:
        raise ValueError(f"bad DFT length {L} for n = {n}")
    rev = bitrev_index(L, str(lo.device))
    tw_lo, tw_hi = power_words(n, inverse, str(lo.device))
    lo, hi = lo[:, rev], hi[:, rev]
    b = lo.shape[0]
    h = 1
    while h < L:
        idx = torch.arange(h, device=lo.device) * (n // (2 * h))
        w = (tw_lo[idx], tw_hi[idx])
        x_lo = lo.view(b, L // (2 * h), 2, h)
        x_hi = hi.view(b, L // (2 * h), 2, h)
        u = (x_lo[:, :, 0], x_hi[:, :, 0])
        v = modp.mul_modp64((x_lo[:, :, 1], x_hi[:, :, 1]), w)
        s = modp.add_modp64(u, v)
        d = modp.sub_modp64(u, v)
        lo = torch.stack((s[0], d[0]), dim=2).reshape(b, L)
        hi = torch.stack((s[1], d[1]), dim=2).reshape(b, L)
        h *= 2
    return lo, hi


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
