"""The length-n DFT over Z_P, written out as a radix-2 transform.

    X[k] = sum_j x[j] w^(j k),    w = NTT_GEN^(65536 / n)  (mod P)

NTT-domain data is stored flat in mat-linear order, as cuHE's TPU and GPU
ports store it: with n = n1 n2 (``FACTORS``), position k1 n2 + k2 holds
X[k1 + n1 k2].  The inverse returns x[j] = n^-1 sum_k X[k] w^(-j k).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import zp
from .ring import NTT_GEN
from .zp import P

FACTORS = {16384: (128, 128), 32768: (256, 128), 65536: (256, 256)}


@lru_cache(maxsize=None)
def _powers(n: int, inverse: bool) -> np.ndarray:
    w = pow(NTT_GEN, 65536 // n, P)
    if inverse:
        w = pow(w, -1, P)
    out = np.empty(n // 2, dtype=np.uint64)
    cur = 1
    for i in range(n // 2):
        out[i] = cur
        cur = cur * w % P
    return out


@lru_cache(maxsize=None)
def _tables(n: int, inverse: bool, device: str):
    """Bit-reversal of range(n) and w^i (i < n/2) as an int64 pair."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    pw = _powers(n, inverse)
    lo = torch.from_numpy((pw & np.uint64(0xFFFFFFFF)).astype(np.int64))
    hi = torch.from_numpy((pw >> np.uint64(32)).astype(np.int64))
    return (torch.from_numpy(rev).to(device), lo.to(device), hi.to(device))


def dft(a, n: int, inverse: bool = False):
    """Natural-order DFTs of pairs [rows, n] (iterative radix-2 DIT)."""
    rev, tw_lo, tw_hi = _tables(n, inverse, str(a[0].device))
    x = (a[0][:, rev], a[1][:, rev])
    rows = x[0].shape[0]
    h = 1
    while h < n:
        step = n // (2 * h)
        tw = (tw_lo[::step][:h], tw_hi[::step][:h])
        u = tuple(v.view(rows, n // (2 * h), 2, h)[:, :, 0] for v in x)
        v = tuple(v.view(rows, n // (2 * h), 2, h)[:, :, 1] for v in x)
        v = zp.mul(v, tw)
        s, d = zp.add(u, v), zp.sub(u, v)
        x = tuple(torch.stack((s[i], d[i]), dim=2).reshape(rows, n)
                  for i in range(2))
        h *= 2
    return x


def to_mat(x: torch.Tensor, n: int) -> torch.Tensor:
    n1, n2 = FACTORS[n]
    lead = x.shape[:-1]
    return x.reshape(lead + (n2, n1)).transpose(-1, -2).reshape(lead + (n,))


def from_mat(x: torch.Tensor, n: int) -> torch.Tensor:
    n1, n2 = FACTORS[n]
    lead = x.shape[:-1]
    return x.reshape(lead + (n1, n2)).transpose(-1, -2).reshape(lead + (n,))


def forward(coeffs: torch.Tensor, n: int):
    """int64 coefficients [.., L] (L <= n, values below 2^32), zero-padded
    to n -> the mat-linear NTT-domain pair [.., n]."""
    lead = coeffs.shape[:-1]
    x = torch.zeros(lead + (n,), dtype=torch.int64, device=coeffs.device)
    x[..., : coeffs.shape[-1]] = coeffs
    x = x.reshape(-1, n)
    lo, hi = dft((x, torch.zeros_like(x)), n)
    return (to_mat(lo, n).reshape(lead + (n,)),
            to_mat(hi, n).reshape(lead + (n,)))


def inverse_mod(a, n: int, p: torch.Tensor) -> torch.Tensor:
    """Mat-linear pair [.., n] -> int64 [.., n]: the inverse DFT times n^-1,
    each transform reduced mod its prime (p int64, broadcast against the
    leading dims)."""
    lead = a[0].shape[:-1]
    x = tuple(from_mat(v, n).reshape(-1, n) for v in a)
    y = dft(x, n, inverse=True)
    y = zp.mul(y, zp.from_int(pow(n, -1, P), y[0]))
    pb = torch.broadcast_to(p, lead).reshape(-1, 1)
    return zp.mod_small(y, pb).reshape(lead + (n,))
