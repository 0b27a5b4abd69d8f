"""Arithmetic mod the Goldilocks prime P = 2^64 - 2^32 + 1 in plain PyTorch.

A value is a pair (lo, hi) of int64 tensors holding its two 32-bit words,
each in [0, 2^32); every function returns canonical values, below P.  A
product is taken in 16-bit limbs, so that no partial product or sum leaves
the int64 range, and folded with 2^64 = 2^32 - 1 and 2^96 = -1 (mod P).
The same code runs on any PyTorch device.
"""

from __future__ import annotations

import torch

P = (1 << 64) - (1 << 32) + 1
M32 = (1 << 32) - 1
M16 = (1 << 16) - 1


def canon(x: torch.Tensor, y: torch.Tensor):
    """The canonical pair of (x + y 2^32) mod P, for int64 x, y of absolute
    value below 2^60."""
    for _ in range(3):
        y = y + (x >> 32)
        x = x & M32
        t = y >> 32  # y = (y mod 2^32) + t 2^32, and t 2^64 = t (2^32 - 1)
        y = (y & M32) + t
        x = x - t
    y = y + (x >> 32)
    x = x & M32
    # now 0 <= x < 2^32 and -2 <= y <= 2^32 + 1: one add or one subtract of P
    neg = y < 0
    x, y = torch.where(neg, x + 1, x), torch.where(neg, y + M32, y)
    y = y + (x >> 32)
    x = x & M32
    big = (y > M32) | ((y == M32) & (x >= 1))
    x, y = torch.where(big, x - 1, x), torch.where(big, y - M32, y)
    y = y + (x >> 32)
    return x & M32, y


def add(a, b):
    return canon(a[0] + b[0], a[1] + b[1])


def sub(a, b):
    return canon(a[0] - b[0], a[1] - b[1])


def _limbs(a):
    return (a[0] & M16, a[0] >> 16, a[1] & M16, a[1] >> 16)


def mul(a, b):
    """(a b) mod P."""
    x, y = _limbs(a), _limbs(b)
    c = [None] * 7
    for i in range(4):
        for j in range(4):
            t = x[i] * y[j]
            c[i + j] = t if c[i + j] is None else c[i + j] + t
    # sum_k c_k 2^(16k) with 2^64 = 2^32 - 1, 2^80 = 2^48 - 2^16, 2^96 = -1
    e0, e1 = c[0] - c[4] - c[6], c[1] - c[5]
    e2, e3 = c[2] + c[4], c[3] + c[5]
    return canon(e0 + (e1 << 16), e2 + (e3 << 16))


def from_int(v: int, like: torch.Tensor):
    """The constant v mod P as a pair of scalars on like's device."""
    v %= P
    dev = like.device
    return (torch.tensor(v & M32, dtype=torch.int64, device=dev),
            torch.tensor(v >> 32, dtype=torch.int64, device=dev))


def mod_small(a, p: torch.Tensor) -> torch.Tensor:
    """a mod p for a canonical pair a and int64 p < 2^31 (broadcast)."""
    r = torch.remainder(a[1], p)
    r = torch.remainder((r << 16) | (a[0] >> 16), p)
    return torch.remainder((r << 16) | (a[0] & M16), p)


def from_u32(lo: torch.Tensor, hi: torch.Tensor):
    """uint32 word tensors -> an int64 pair."""
    return u32_to_i64(lo), u32_to_i64(hi)


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int64:
        return x
    return x.view(torch.int32).to(torch.int64) & M32


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 (through int32, which every
    device converts to)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(
        torch.int32).view(torch.uint32)
