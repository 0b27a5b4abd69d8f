"""Polynomial Barrett reduction mod m(x) in the CRT/NTT domains.

Counterpart of ``cuhe_tpu/ops/barrett.py`` (reference pipeline
Operations.cu:460-504, Base.cu:927-1001).  Given f of degree <= 2n-2 per CRT
plane and the precomputed

    u = x^(2n-1) div m       (NTT domain, per prime)
    m - x^n                  (NTT domain and CRT domain, per prime)

it computes f mod m(x).  The two forward and two inverse NTTs go through
`fwd` and `inv` (the kernel front ends by default); the rest is elementwise.
"""

from __future__ import annotations

import torch

from . import modp
from . import ntt_kernels as nk
from .pointwise import crt_sub


def barrett_reduce(f, *, mod_len: int, n: int, u_ntt, m_ntt, m_crt, primes,
                   fwd=nk.fwd_linear, inv=nk.inv_linear) -> torch.Tensor:
    """f: uint32 [.., pnum, n] residues of a degree <= 2*mod_len-2 polynomial.

    Returns uint32 [.., pnum, n/2] residues of f mod m(x).  u_ntt, m_ntt:
    uint32 pairs [pnum, n], mat-linear; m_crt: uint32 [pnum, n/2]; primes:
    uint32 [pnum].
    """
    half = n // 2
    pc = modp.to_i64(primes)[:, None]
    idx = torch.arange(n, device=f.device)

    # c1 = intt(u * ntt(f >> (mod_len - 1))), low mod_len coefficients zeroed
    t1 = fwd(f[..., mod_len - 1: mod_len - 1 + half].contiguous(), n)
    c1 = modp.to_i64(inv(modp.mul_modp(t1, u_ntt), n, primes))
    c1 = torch.where(idx >= mod_len, c1, 0)

    # c2 = intt((m - x^n) * ntt(c1 >> mod_len))
    h = modp.to_u32(c1[..., mod_len: mod_len + half].contiguous())
    c2 = modp.to_i64(inv(modp.mul_modp(fwd(h, n), m_ntt), n, primes))

    # subtract c1 from the high half, then c2 everywhere (barrett_sub_1/2)
    ff = modp.to_i64(f)
    high = (idx >= mod_len) & (idx < 2 * mod_len)
    src = crt_sub(torch.where(high, crt_sub(ff, c1, pc), ff), c2, pc)

    # where coefficient x^mod_len of a plane is nonzero, subtract (m - x^n)
    # in that plane (barrett_sub_mc, Base.cu:978-1001)
    t = src[..., mod_len][..., None]
    mc = modp.to_i64(m_crt)
    mc_full = torch.cat([mc, torch.zeros_like(mc)[..., : n - half]], dim=-1)
    take = (t > 0) & (idx < mod_len - 1)
    src = torch.where(take, crt_sub(src, mc_full, pc), src)
    return modp.to_u32(src[..., :half].contiguous())
