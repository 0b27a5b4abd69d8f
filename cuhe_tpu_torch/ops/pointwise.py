"""Pointwise gate arithmetic and modulus switching, in plain PyTorch.

Counterpart of ``cuhe_tpu/ops/pointwise.py`` (Base.cu:1036-1138) and of the
CRT subtract of ``cuhe_tpu/ops/barrett.py``.  NTT-domain values are uint32
pairs mod P ``[.., pnum, n]``; CRT values are uint32 residues
``[.., pnum, L]`` mod the plane's prime, whose arithmetic runs in int64 and
returns uint32.  These are elementwise passes, not kernels: on the card
PyTorch's own elementwise kernels run them.
"""

from __future__ import annotations

import torch

from . import modp


# ---- NTT domain (mod P), Base.cu:1036-1075 ----

def ntt_mul(x, y):
    return modp.mul_modp(x, y)


def ntt_add(x, y):
    return modp.add_modp(x, y)


def ntt_mul_nx1(x, scalar):
    """x: pair [.., pnum, n]; scalar: pair [n] broadcast across planes."""
    return modp.mul_modp(x, scalar)


def ntt_add_nx1(x, scalar):
    """x: pair [.., pnum, n]; scalar: pair [n] broadcast across planes."""
    return modp.add_modp(x, scalar)


# ---- CRT domain (per-plane mod p_i), Base.cu:1078-1109 ----

def crt_add(x, y, primes):
    """(x + y) mod p_i per plane; x, y uint32 [.., pnum, L], primes [pnum]."""
    p = modp.to_i64(primes)[:, None]
    s = modp.to_i64(x) + modp.to_i64(y)
    return modp.to_u32(torch.where(s >= p, s - p, s))


def crt_sub(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for int64 residues a, b < p (planewise)."""
    return torch.where(a < b, a + p - b, a - b)


def _set_coeff0(x, v):
    out = x.clone()
    out[..., 0] = modp.to_u32(v)
    return out


def crt_add_int(x, a: int, primes):
    """Add integer a to coefficient 0 of every plane (crt_add_int kernel)."""
    p = modp.to_i64(primes)
    return _set_coeff0(x, (modp.to_i64(x[..., 0]) + int(a) % p) % p)


def crt_add_nx1(x, scalar, primes):
    """Ciphertext + plaintext: add a uint32 polynomial [L], not reduced mod
    any p_i, to every plane mod p_i (Base.cu:1101-1109): the exact 33-bit
    sum, reduced."""
    p = modp.to_i64(primes)[:, None]
    return modp.to_u32(torch.remainder(modp.to_i64(x) + modp.to_i64(scalar), p))


def crt_mul_int(x, a: int, primes):
    """Multiply coefficient 0 of every plane by integer a mod p_i."""
    return _set_coeff0(x, modp.mulmod32(modp.to_i64(x[..., 0]), int(a),
                                        modp.to_i64(primes)))


# ---- modulus switching (Base.cu:1112-1138) ----

def mod_switch_dirty(dirty: torch.Tensor, pt, mod_msg: int) -> torch.Tensor:
    """The dropped plane's residues (int64, < p_t) moved by +/- ep*p_t so
    that they become divisible by the message modulus, with the centered
    branch on dirty > (p_t-1)/2 (int64 out)."""
    ep = torch.remainder(dirty, mod_msg)
    adj = torch.where(dirty > (pt - 1) // 2, dirty - ep * pt, dirty + ep * pt)
    return torch.where(ep != 0, adj, dirty)


def mod_switch_planes(crt: torch.Tensor, dirty: torch.Tensor,
                      primes: torch.Tensor,
                      invp_last: torch.Tensor) -> torch.Tensor:
    """(x_i - dirty) * p_t^-1 mod p_i for the kept planes crt uint32
    [.., k, L], dirty int64 [.., L] from `mod_switch_dirty`, primes and
    invp_last uint32 [k].  The difference can be negative:
    `torch.remainder` takes the divisor's sign, as jnp's % does in the JAX
    package.  Returns uint32 [.., k, L]."""
    pp = modp.to_i64(primes)[:, None]
    diff = torch.remainder(modp.to_i64(crt) - dirty[..., None, :], pp)
    return modp.to_u32(modp.mulmod32(diff, modp.to_i64(invp_last)[:, None],
                                     pp))


def mod_switch(crt: torch.Tensor, primes: torch.Tensor,
               invp_last: torch.Tensor, mod_msg: int) -> torch.Tensor:
    """BGV-style modulus switch dropping the last prime plane.

    crt: uint32 [.., pnum, L] at level lvl; primes: uint32 [pnum] (p_t =
    primes[pnum-1] is dropped); invp_last: uint32 [pnum-1], inv(p_t, p_i).
    Returns uint32 [.., pnum-1, L]: `mod_switch_dirty` of the dropped plane,
    then `mod_switch_planes` of the others (a crt-sharded step runs the two
    parts on different devices, parallel/mesh.py).
    """
    pnum = crt.shape[-2]
    dirty = mod_switch_dirty(modp.to_i64(crt[..., pnum - 1, :]),
                             modp.to_i64(primes)[pnum - 1], mod_msg)
    return mod_switch_planes(crt[..., : pnum - 1, :], dirty,
                             primes[: pnum - 1], invp_last)
