"""CRT decomposition of RAW multiword coefficients, and its inverse.

`crt_from_raw`, the counterpart of ``cuhe_tpu/ops/crt.py:25-41``, reduces
each coefficient mod each prime: the front end of a hand-written kernel
(K5, ``csrc/crt_ops.cu``: a dot product of the coefficient's bit chunks with
per-prime constants, one reduction per residue) for a CUDA tensor, and of
its plain version `crt_from_raw_plain` (Horner over the words) for a CPU
tensor (the JAX package leaves this work to XLA).

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
``cuhe_tpu/ops/crt.py:165-215``, sums the partials with one all-reduce,
between two front ends of K8 (``csrc/crt_ops.cu``): `icrt_split_halves`
before it and `icrt_combine_halves` after it.

Every front end here launches its kernel for a CUDA tensor and runs its
``*_plain`` version for a CPU tensor; any other device raises.  A plain
version of K5 or K8 called with a CUDA tensor counts the call in
``_cuda.PLAIN_CALLS``.

Layouts: CRT ``[.., pnum, L]`` and RAW ``[.., words, L]`` uint32 planes;
bi ``[pnum]``, mi_words ``[pnum, words]``, m_words ``[words]`` uint32.
"""

from __future__ import annotations

from math import prod

import torch

from . import _cuda, modp
from .ntt_kernels import _is_cpu, _u32_contiguous

MAX_WORDS = 40  # the kernels' widest instantiation (csrc/icrt.cu kMaxWords)


def _words_arg(name: str, t) -> int:
    """Raise unless t is a uint32 tensor [.., words, L] with 1 <= words <=
    MAX_WORDS (both devices); return words."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.uint32:
        raise TypeError(f"{name}: expected {torch.uint32}, got {t.dtype}")
    if t.dim() < 2 or not 1 <= t.shape[-2] <= MAX_WORDS:
        raise ValueError(f"{name}: {tuple(t.shape)}, expected [.., words, "
                         f"L] with 1..{MAX_WORDS} words")
    return t.shape[-2]


def crt_from_raw_plain(raw: torch.Tensor, primes: torch.Tensor) -> torch.Tensor:
    """Plain version of `crt_from_raw`."""
    _cuda.count_plain("crt_from_raw", raw)
    x = modp.to_i64(raw)
    p = modp.to_i64(primes)[:, None]
    r = torch.remainder(x[..., -1, None, :], p)
    for w in range(x.shape[-2] - 2, -1, -1):
        r = modp.mod_p64((x[..., w, None, :], r), p)
    return modp.to_u32(r)


def crt_from_raw(raw: torch.Tensor, primes: torch.Tensor) -> torch.Tensor:
    """RAW uint32 [.., words, L] -> CRT residues uint32 [.., pnum, L] for
    primes uint32 [pnum]: Horner from the top word, r = (r 2^32 + w) mod p,
    1 <= words <= MAX_WORDS.  On the card: K5, one launch."""
    words = _words_arg("crt_from_raw", raw)
    if not isinstance(primes, torch.Tensor) or primes.dtype != torch.uint32:
        raise TypeError(f"crt_from_raw: primes must be a {torch.uint32} "
                        "tensor")
    if primes.dim() != 1 or primes.shape[0] < 1:
        raise ValueError(f"crt_from_raw: primes {tuple(primes.shape)}, "
                         "expected [pnum]")
    if _is_cpu(raw):
        return crt_from_raw_plain(raw, primes)
    dev = raw.device
    if not raw.is_contiguous():
        raw = _u32_contiguous(raw)
    _cuda.check(raw, "raw", torch.uint32, device=dev, align=4)
    _cuda.check(primes, "primes", torch.uint32, device=dev, align=4)
    pnum, length = primes.shape[0], raw.shape[-1]
    lead = tuple(raw.shape[:-2])
    out = torch.empty(lead + (pnum, length), dtype=torch.uint32, device=dev)
    rows = prod(lead)
    if rows and length:
        _cuda.launch("crt_from_raw", "cuhe_crt_from_raw", dev, raw, primes,
                     out, rows, words, pnum, length)
    return out


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


def icrt_split_halves_plain(partial: torch.Tensor) -> torch.Tensor:
    """Plain version of `icrt_split_halves`."""
    _cuda.count_plain("icrt_split16", partial)
    x = modp.to_i64(partial)
    return torch.stack((x & 0xFFFF, x >> 16)).to(torch.int32)


def icrt_split_halves(partial: torch.Tensor) -> torch.Tensor:
    """uint32 words [.., words, L] -> int32 [2, .., words, L], their low
    and high 16-bit halves (what `icrt_psum_combine` sums across shards).
    On the card: K8's split, one launch."""
    _words_arg("icrt_split_halves", partial)
    if _is_cpu(partial):
        return icrt_split_halves_plain(partial)
    dev = partial.device
    if not partial.is_contiguous():
        partial = _u32_contiguous(partial)
    _cuda.check(partial, "partial", torch.uint32, device=dev, align=4)
    out = torch.empty((2,) + tuple(partial.shape), dtype=torch.int32,
                      device=dev)
    count = partial.numel()
    if count >= 1 << 31:
        raise ValueError(f"icrt_split_halves: {count} words, the kernel "
                         "takes fewer than 2^31")
    if count:
        _cuda.launch("icrt_split16", "cuhe_icrt_split16", dev, partial, out,
                     count)
    return out


def icrt_combine_halves_plain(lo16: torch.Tensor, hi16: torch.Tensor,
                              m_words: torch.Tensor,
                              n_shards: int) -> torch.Tensor:
    """Plain version of `icrt_combine_halves`."""
    _cuda.count_plain("icrt_combine16", lo16)
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


def icrt_combine_halves(lo16: torch.Tensor, hi16: torch.Tensor,
                        m_words: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The arithmetic of `icrt_psum_combine` after its all-reduce.

    lo16, hi16: int32 [.., words, L], the sums over n_shards partials (each
    in [0, M)) of their words' low and high 16-bit halves; m_words: M's
    words [words], uint32 (or int64 values, which a CUDA call converts).
    The halves are rippled into words (value = sum_w (lo16_w + 2^16 hi16_w)
    2^(32 w)), and the total, below n_shards * M, is brought into [0, M) by
    n_shards - 1 conditional subtracts of M (the kernel computes their
    count from one quotient estimate).  Returns uint32 [.., words, L].
    On the card: K8's combine, one launch.
    """
    for name, t in (("lo16", lo16), ("hi16", hi16)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"icrt_combine_halves: {name} must be a "
                            f"tensor of {torch.int32}")
    if (not isinstance(m_words, torch.Tensor)
            or m_words.dtype not in (torch.uint32, torch.int64)):
        raise TypeError("icrt_combine_halves: m_words must be a uint32 or "
                        "int64 tensor")
    words = m_words.shape[0] if m_words.dim() == 1 else -1
    if (hi16.shape != lo16.shape or lo16.dim() < 2
            or lo16.shape[-2] != words or not 1 <= words <= MAX_WORDS):
        raise ValueError(f"icrt_combine_halves: lo16 {tuple(lo16.shape)}, "
                         f"hi16 {tuple(hi16.shape)}, m_words "
                         f"{tuple(m_words.shape)}: expected two [.., words, "
                         f"L] and [words], 1 <= words <= {MAX_WORDS}")
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"{n_shards} shards: the int32 sum of 16-bit halves "
                         f"is exact for 1..{MAX_SHARDS}")
    if _is_cpu(lo16):
        return icrt_combine_halves_plain(lo16, hi16, m_words, n_shards)
    dev = lo16.device
    if m_words.dtype == torch.int64:
        m_words = modp.to_u32(m_words)
    lo16, hi16 = lo16.contiguous(), hi16.contiguous()
    _cuda.check(lo16, "lo16", torch.int32, device=dev, align=4)
    _cuda.check(hi16, "hi16", torch.int32, device=dev, align=4)
    _cuda.check(m_words, "m_words", torch.uint32, device=dev, align=4)
    out = torch.empty(lo16.shape, dtype=torch.uint32, device=dev)
    length = lo16.shape[-1]
    rows = prod(lo16.shape[:-2])
    if rows and length:
        _cuda.launch("icrt_combine16", "cuhe_icrt_combine16", dev, lo16,
                     hi16, m_words, out, rows, words, length, n_shards)
    return out


def icrt_psum_combine(partial: torch.Tensor, m_words: torch.Tensor, group,
                      n_shards: int) -> torch.Tensor:
    """Sum the per-shard ICRT partials of a crt-sharded prime axis mod M.

    partial: uint32 [.., words, L], this shard's `icrt_to_raw` of its own
    primes against the global M (a value in [0, M)); group: the crt axis
    of a ``parallel.mesh.Mesh`` (its `all_reduce_sum` sums over the
    n_shards ranks).  The words' 16-bit halves (`icrt_split_halves`) go
    through one all-reduce in int32 (no collective takes uint32), then
    `icrt_combine_halves`.  Returns uint32 [.., words, L], the same on
    every shard.
    """
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"{n_shards} shards: the int32 sum of 16-bit halves "
                         f"is exact for 1..{MAX_SHARDS}")
    halves = group.all_reduce_sum(icrt_split_halves(partial))
    return icrt_combine_halves(halves[0], halves[1], m_words, n_shards)
