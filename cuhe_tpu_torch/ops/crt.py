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

With the primes split across devices (a crt-sharded step,
``parallel/mesh.py``), each device runs the ICRT of its own primes against
the global M, and `icrt_psum_combine`, the counterpart of
``cuhe_tpu/ops/crt.py:165-215``, sums the partials with one all-reduce.

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


def _cond_sub_m(s: list, top: torch.Tensor, m: list, zero: torch.Tensor):
    """Where the multiword value (top, s[words-1], .., s[0]) >= M: subtract
    M.  int64 words in place; returns the new top word."""
    ge = top > 0
    eq = torch.ones_like(ge)
    for w in range(len(m) - 1, -1, -1):
        ge = ge | (eq & (s[w] > m[w]))
        eq = eq & (s[w] == m[w])
    ge = ge | eq
    borrow = zero
    for w in range(len(m)):
        d = s[w] - m[w] - borrow
        borrow = (d < 0).to(torch.int64)
        s[w] = torch.where(ge, d & modp.M32, s[w])
    return torch.where(ge, top - borrow, top)


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
        s[words] = _cond_sub_m(s, s[words] + carry, m, zero)
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


# The shard sums of 16-bit halves are taken in int32: exact below 2^15 shards.
MAX_SHARDS = (1 << 15) - 1


def icrt_combine_halves(lo16: torch.Tensor, hi16: torch.Tensor,
                        m_words: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The arithmetic of `icrt_psum_combine` after its all-reduce.

    lo16, hi16: int [.., words, L], the sums over n_shards partials (each
    in [0, M)) of their words' low and high 16-bit halves.  The halves are
    rippled into words (value = sum_w (lo16_w + 2^16 hi16_w) 2^(32 w)),
    and the total, below n_shards * M, is brought into [0, M) by
    n_shards - 1 conditional subtracts of M.  Returns uint32 [.., words, L].
    """
    lo, hi = lo16.to(torch.int64), hi16.to(torch.int64)
    m = modp.to_i64(m_words).tolist()
    words = lo.shape[-2]
    zero = torch.zeros_like(lo[..., 0, :])
    s, carry = [], zero
    for w in range(words):
        t = lo[..., w, :] + (hi[..., w, :] << 16) + carry
        s.append(t & modp.M32)
        carry = t >> 32
    top = carry
    for _ in range(max(1, n_shards - 1)):
        top = _cond_sub_m(s, top, m, zero)
    return modp.to_u32(torch.stack(s, dim=-2))


def icrt_psum_combine(partial: torch.Tensor, m_words: torch.Tensor, group,
                      n_shards: int) -> torch.Tensor:
    """Sum the per-shard ICRT partials of a crt-sharded prime axis mod M.

    partial: uint32 [.., words, L], this shard's `icrt_to_raw` of its own
    primes against the global M (a value in [0, M)); group: the crt axis
    of a ``parallel.mesh.Mesh`` (its `all_reduce_sum` sums over the
    n_shards ranks).  The words' 16-bit halves go through one all-reduce
    in int32 (no collective takes uint32), then `icrt_combine_halves`.
    Returns uint32 [.., words, L], the same on every shard.
    """
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"{n_shards} shards: the int32 sum of 16-bit halves "
                         f"is exact for 1..{MAX_SHARDS}")
    x = modp.to_i64(partial)
    halves = torch.stack((x & 0xFFFF, x >> 16)).to(torch.int32)
    halves = group.all_reduce_sum(halves)
    return icrt_combine_halves(halves[0], halves[1], m_words, n_shards)
