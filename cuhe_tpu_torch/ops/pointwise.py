"""CRT-domain pointwise arithmetic and modulus switching, in plain PyTorch.

Counterpart of ``cuhe_tpu/ops/pointwise.py`` (Base.cu:1112-1138) and of the
CRT subtract of ``cuhe_tpu/ops/barrett.py``.  CRT
values are uint32 residues ``[.., pnum, L]`` mod the plane's prime; the
arithmetic runs in int64 and returns uint32.  These are elementwise passes,
not kernels: on the card PyTorch's own elementwise kernels run them.
"""

from __future__ import annotations

import torch

from . import modp


def crt_sub(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for int64 residues a, b < p (planewise)."""
    return torch.where(a < b, a + p - b, a - b)


def mod_switch(crt: torch.Tensor, primes: torch.Tensor,
               invp_last: torch.Tensor, mod_msg: int) -> torch.Tensor:
    """BGV-style modulus switch dropping the last prime plane.

    crt: uint32 [.., pnum, L] at level lvl; primes: uint32 [pnum] (p_t =
    primes[pnum-1] is dropped); invp_last: uint32 [pnum-1], inv(p_t, p_i).
    Returns uint32 [.., pnum-1, L].

    The dropped residue ("dirty") is moved by +/- ep*p_t so that it becomes
    divisible by the message modulus, with the centered branch on
    dirty > (p_t-1)/2; then (x_i - dirty) * p_t^-1 mod p_i per plane.  The
    difference can be negative: `torch.remainder` takes the divisor's sign,
    as jnp's % does in the JAX package.
    """
    x = modp.to_i64(crt)
    p = modp.to_i64(primes)
    pnum = x.shape[-2]
    dirty = x[..., pnum - 1, :]
    pt = p[pnum - 1]
    ep = torch.remainder(dirty, mod_msg)
    adj = torch.where(dirty > (pt - 1) // 2, dirty - ep * pt, dirty + ep * pt)
    dirty = torch.where(ep != 0, adj, dirty)
    pp = p[: pnum - 1, None]
    diff = torch.remainder(x[..., : pnum - 1, :] - dirty[..., None, :], pp)
    return modp.to_u32(modp.mulmod32(diff, modp.to_i64(invp_last)[:, None], pp))
