"""CRT decomposition of RAW multiword coefficients, and its inverse.

`crt_from_raw`, the counterpart of ``cuhe_tpu/ops/crt.py:25-41``, reduces
each coefficient mod each prime by Horner over its words; it is elementwise
work in plain PyTorch (the JAX package leaves it to XLA), with no kernel.

The inverse is the counterpart of ``cuhe_tpu/ops/crt.py:43-162``: for each
coefficient

    x = sum_i ((x_i * b_i mod p_i) * M/p_i)  mod M

as a multiword sum whose result is the unique value in [0, M).
`icrt_to_raw_plain` subtracts M after each prime where the sum reaches it
(leq_M, Base.cu:845-856); the kernel, ``csrc/icrt.cu``, launched by
`icrt_to_raw` for CUDA tensors, reduces once, after the last prime.

Layouts: CRT ``[.., pnum, L]`` and RAW ``[.., words, L]`` uint32 planes;
bi ``[pnum]``, mi_words ``[pnum, words]``, m_words ``[words]`` uint32.
"""

from __future__ import annotations

from math import prod

import torch

from . import _cuda, modp
from .ntt_kernels import _is_cpu

MAX_WORDS = 32  # the kernel's widest instantiation (csrc/icrt.cu kMaxWords)


def crt_from_raw(raw: torch.Tensor, primes: torch.Tensor) -> torch.Tensor:
    """RAW uint32 [.., words, L] -> CRT residues uint32 [.., pnum, L] for
    primes uint32 [pnum]: Horner from the top word, r = (r 2^32 + w) mod p."""
    x = modp.to_i64(raw)
    p = modp.to_i64(primes)[:, None]
    r = torch.remainder(x[..., -1, None, :], p)
    for w in range(x.shape[-2] - 2, -1, -1):
        r = modp.mod_p64((x[..., w, None, :], r), p)
    return modp.to_u32(r)


def icrt_to_raw_plain(crt, primes, bi, mi_words, m_words) -> torch.Tensor:
    """Plain version of `icrt_to_raw`: a loop over primes and words."""
    x = modp.to_i64(crt)
    pnum = x.shape[-2]
    ps = modp.to_i64(primes).tolist()
    bs = modp.to_i64(bi).tolist()
    mi = modp.to_i64(mi_words).tolist()
    m = modp.to_i64(m_words).tolist()
    words = len(m)
    zero = torch.zeros_like(x[..., 0, :])
    s = [zero] * (words + 1)
    for i in range(pnum):
        y = modp.mulmod32(x[..., i, :], bs[i], ps[i])
        carry = zero
        for w in range(words):
            lo, hi = modp.mul32(y, mi[i][w])
            t = s[w] + lo + carry
            s[w] = t & modp.M32
            carry = (t >> 32) + hi
        s[words] = s[words] + carry
        ge = s[words] > 0
        eq = torch.ones_like(ge)
        for w in range(words - 1, -1, -1):
            ge = ge | (eq & (s[w] > m[w]))
            eq = eq & (s[w] == m[w])
        ge = ge | eq
        borrow = zero
        for w in range(words):
            d = s[w] - m[w] - borrow
            borrow = (d < 0).to(torch.int64)
            s[w] = torch.where(ge, d & modp.M32, s[w])
        s[words] = torch.where(ge, s[words] - borrow, s[words])
    return modp.to_u32(torch.stack(s[:words], dim=-2))


def icrt_to_raw(crt, primes, bi, mi_words, m_words) -> torch.Tensor:
    """CRT residues uint32 [.., pnum, L] -> RAW uint32 [.., words, L] in
    [0, M), with pnum = crt.shape[-2] and words = len(m_words)."""
    if _is_cpu(crt):
        return icrt_to_raw_plain(crt, primes, bi, mi_words, m_words)
    dev = crt.device
    _cuda.check(crt, "crt", torch.uint32)
    pnum, length = crt.shape[-2], crt.shape[-1]
    words = m_words.shape[0]
    if not 1 <= words <= MAX_WORDS:
        raise ValueError(f"{words} words: the kernel takes 1..{MAX_WORDS}")
    _cuda.check(primes, "primes", torch.uint32, (pnum,), dev)
    _cuda.check(bi, "bi", torch.uint32, (pnum,), dev)
    _cuda.check(mi_words, "mi_words", torch.uint32, (pnum, words), dev)
    _cuda.check(m_words, "m_words", torch.uint32, (words,), dev)
    lead = tuple(crt.shape[:-2])
    out = torch.empty(lead + (words, length), dtype=torch.uint32, device=dev)
    batch = prod(lead)
    if batch:
        _cuda.launch("icrt", "cuhe_icrt", dev, crt, out, primes, bi, mi_words,
                     m_words, batch, pnum, words, length)
    return out


def icrt_blocks_per_sm(pnum: int, words: int, device) -> int:
    """Resident blocks per SM of icrt_to_raw's kernel at this shape
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return _cuda.query("cuhe_icrt_blocks_per_sm", torch.device(device), pnum,
                       words)
