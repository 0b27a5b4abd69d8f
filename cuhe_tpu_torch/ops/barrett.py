"""Polynomial Barrett reduction mod m(x) in the CRT/NTT domains.

Counterpart of ``cuhe_tpu/ops/barrett.py`` (reference pipeline
Operations.cu:460-504, Base.cu:927-1001).  Given f of degree <= 2n-2 per CRT
plane and the precomputed

    u = x^(2n-1) div m       (NTT domain, per prime)
    m - x^n                  (NTT domain and CRT domain, per prime)

it computes f mod m(x).  The two forward and two inverse NTTs go through
`fwd` and `inv`, the two products through `mul`, and the three subtracts
that end it (steps 4-6) through `combine`: by default the kernel front ends
(``ops/ntt_kernels.py``, `pointwise.ntt_mul`, `barrett_combine`), which run
their plain versions for a CPU tensor; `GateStep(plain=True)` passes the
plain versions themselves.
"""

from __future__ import annotations

import torch

from . import _cuda, modp
from . import ntt_kernels as nk
from . import pointwise as pw


def barrett_combine_plain(f, c1, c2, m_crt, primes, *, mod_len: int,
                          n: int) -> torch.Tensor:
    """Plain version of `barrett_combine`, in int64, following the JAX
    package's steps 2 and 4-6 (c1's low mod_len coefficients zeroed first,
    which no later step reads)."""
    _cuda.count_plain("barrett_combine", f)
    half = n // 2
    pc = modp.to_i64(primes)[:, None]
    idx = torch.arange(n, device=f.device)
    c1 = torch.where(idx >= mod_len, modp.to_i64(c1), 0)

    # subtract c1 from the high half, then c2 everywhere (barrett_sub_1/2)
    ff = modp.to_i64(f)
    high = (idx >= mod_len) & (idx < 2 * mod_len)
    src = pw.crt_sub(torch.where(high, pw.crt_sub(ff, c1, pc), ff),
                     modp.to_i64(c2), pc)

    # where coefficient x^mod_len of a plane is nonzero, subtract (m - x^n)
    # in that plane (barrett_sub_mc, Base.cu:978-1001)
    t = src[..., mod_len][..., None]
    mc = modp.to_i64(m_crt)
    mc_full = torch.cat([mc, torch.zeros_like(mc)[..., : n - half]], dim=-1)
    take = (t > 0) & (idx < mod_len - 1)
    src = torch.where(take, pw.crt_sub(src, mc_full, pc), src)
    return modp.to_u32(src[..., :half].contiguous())


def barrett_combine(f, c1, c2, m_crt, primes, *, mod_len: int,
                    n: int) -> torch.Tensor:
    """Barrett's steps 4-6: f - c1 on the high range [mod_len, 2 mod_len),
    then - c2, then - m_crt on [0, mod_len - 1) in each plane whose
    coefficient x^mod_len is nonzero, all mod p_i.

    f, c1, c2: uint32 residues [.., pnum, n] (c1 as the inverse NTT gives
    it: its low coefficients are not read); m_crt: uint32 [pnum, n/2];
    primes: uint32 [pnum].  Returns uint32 [.., pnum, n/2].  On the card:
    K2 (csrc/pointwise.cu), one launch."""
    if nk._is_cpu(f):
        return barrett_combine_plain(f, c1, c2, m_crt, primes,
                                     mod_len=mod_len, n=n)
    if f.dim() < 2 or f.shape[-1] != n:
        raise ValueError(f"barrett_combine: f {tuple(f.shape)}, expected "
                         f"[.., pnum, {n}]")
    pnum, half = f.shape[-2], n // 2
    if c1.shape != f.shape or c2.shape != f.shape:
        raise ValueError(f"barrett_combine: c1 {tuple(c1.shape)}, c2 "
                         f"{tuple(c2.shape)}, expected f's {tuple(f.shape)}")
    if m_crt.shape != (pnum, half) or primes.shape != (pnum,):
        raise ValueError(f"barrett_combine: m_crt {tuple(m_crt.shape)}, "
                         f"primes {tuple(primes.shape)}, expected "
                         f"({pnum}, {half}) and ({pnum},)")
    if n % 8 or not 1 <= mod_len <= half:
        raise ValueError(f"barrett_combine: n = {n}, mod_len = {mod_len}: "
                         f"expected n % 8 == 0 and 1 <= mod_len <= n/2")
    dev = f.device
    f, c1, c2, m_crt = (pw._dense(v, name, dev) for v, name in
                        ((f, "f"), (c1, "c1"), (c2, "c2"), (m_crt, "m_crt")))
    primes = pw._dense(primes, "primes", dev, align=4)
    pw._quads(f, "f")
    out = torch.empty(f.shape[:-1] + (half,), dtype=torch.uint32, device=dev)
    rows = out.numel() // half
    if rows:
        _cuda.launch("barrett_combine", "cuhe_barrett_combine", dev, f, c1,
                     c2, m_crt, primes, out, rows, pnum, n, mod_len)
    return out


def barrett_reduce(f, *, mod_len: int, n: int, u_ntt, m_ntt, m_crt, primes,
                   fwd=nk.fwd_linear, inv=nk.inv_linear, mul=pw.ntt_mul,
                   combine=barrett_combine) -> torch.Tensor:
    """f: uint32 [.., pnum, n] residues of a degree <= 2*mod_len-2 polynomial.

    Returns uint32 [.., pnum, n/2] residues of f mod m(x).  u_ntt, m_ntt:
    uint32 pairs [pnum, n], mat-linear; m_crt: uint32 [pnum, n/2]; primes:
    uint32 [pnum].
    """
    half = n // 2
    # c1 = intt(u * ntt(f >> (mod_len - 1))); only its coefficients from
    # mod_len on are read below (the JAX package zeroes the others)
    t1 = fwd(f[..., mod_len - 1: mod_len - 1 + half].contiguous(), n)
    c1 = inv(mul(t1, u_ntt), n, primes)

    # c2 = intt((m - x^n) * ntt(c1 >> mod_len))
    h = c1[..., mod_len: mod_len + half].contiguous()
    c2 = inv(mul(fwd(h, n), m_ntt), n, primes)
    return combine(f, c1, c2, m_crt, primes, mod_len=mod_len, n=n)
