"""Front ends of the NTT and relinearization kernels.

Counterpart of ``cuhe_tpu/ops/ntt_kernels.py:1120-1186`` (``fwd_linear``,
``inv_linear``) and of the relinearization kernels' front ends
(``ntt_fwd_digits``, ``relin_digits_mulacc``).  Each front end launches its
CUDA kernel (``csrc/ntt.cu``, ``csrc/relin.cu``) for a CUDA tensor and runs
its plain PyTorch version, the ``*_plain`` function beside it, for a CPU
tensor; anything else raises.  There is no fallback from one to the other.

Layouts are the JAX package's: u32 coefficients ``[.., n/2]``, NTT-domain
pairs of uint32 ``[.., n]`` in mat-linear order (see ``ops/ntt.py``), eval
keys ``[knum, pnum, n]`` in the same order.
"""

from __future__ import annotations

from functools import lru_cache
from math import prod

import torch

from . import _cuda, modp, ntt


def _log2(v: int) -> int:
    return v.bit_length() - 1


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


@lru_cache(maxsize=None)
def _device_powers(n: int, inverse: bool, device: str) -> torch.Tensor:
    """w^e (or w^-e), e < n, as u64 bit patterns in an int64 tensor."""
    return torch.from_numpy(ntt.powers(n, inverse).view("int64").copy()).to(device)


def _u32_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).contiguous().view(torch.uint32)


# The shift s with 2^s = w^(n/64) (w^-(n/64) for the inverse) that the
# passes of csrc/ntt.cu are compiled for (kShift64): the root of their
# radix-16 DFTs.
KERNEL_SHIFT64 = {False: 3, True: 189}


def check_root_shift(n: int, inverse: bool) -> None:
    """Raise unless the shift of w^(n/64) (or its inverse) derived on the
    host (`ntt.root_shift`) is the one the kernels are compiled for."""
    s = ntt.root_shift(n, 64, inverse)
    if s != KERNEL_SHIFT64[inverse]:
        raise ValueError(f"n = {n}: the root w^(n/64) is 2^{s}, the kernels "
                         f"are compiled for 2^{KERNEL_SHIFT64[inverse]}")


# Each transform runs in one launch, a thread-block cluster of K blocks of
# 256 threads per transform holding the whole transform in shared memory
# (csrc/ntt.cu, cluster::inv_cols and cluster::fwd_cols).  Their time is
# the integer units', so the blocks an SM holds at once set it:
# INV_BLOCKS_PER_SM at 64 registers a thread fill the register file.  K is
# the smallest power of two up to MAX_CLUSTER whose blocks hold whole warps
# of rows and fit that many to an SM's SM_SHARED_BYTES, each with
# BLOCK_RESERVED_BYTES for the runtime; where none does, MAX_CLUSTER.  The
# forward's blocks hold the inverse's rows without its Barrett constant, and
# it takes the inverse's K and blocks an SM (`inv_cluster`).
SM_SHARED_BYTES = 228 << 10
BLOCK_RESERVED_BYTES = 1 << 10
MAX_CLUSTER = 8
INV_BLOCKS_PER_SM = 4


def inv_cluster_bytes(n: int, k: int) -> int:
    """Shared memory of one block of the one-pass inverse at length n in
    clusters of k: its n1/k rows of n2 u64 words, each padded by a word,
    and its Barrett constant."""
    n1, n2 = ntt.factors(n)
    return n1 // k * (n2 + 1) * 8 + 8


def inv_cluster_blocks(n: int, k: int) -> int:
    """Blocks of the one-pass inverse an SM holds at length n in clusters
    of k: as many as its shared memory takes, at most INV_BLOCKS_PER_SM."""
    per_block = inv_cluster_bytes(n, k) + BLOCK_RESERVED_BYTES
    return min(INV_BLOCKS_PER_SM, SM_SHARED_BYTES // per_block)


def inv_cluster(n: int) -> int:
    """Blocks per cluster of the one-pass inverse, and of the one-pass
    forward, at length n."""
    n1, _ = ntt.factors(n)
    for k in (1, 2, 4, MAX_CLUSTER):
        if (n1 // k >= 32
                and inv_cluster_blocks(n, k) == INV_BLOCKS_PER_SM):
            return k
    if inv_cluster_blocks(n, MAX_CLUSTER) < 2:
        raise ValueError(f"n = {n}: no cluster of up to {MAX_CLUSTER} "
                         f"blocks holds the transform")
    return MAX_CLUSTER


def _fwd64(x, n: int):
    """Plain forward NTT of int64 coefficients [B, n/2] -> mat int64 pair."""
    lo = torch.cat([x, torch.zeros_like(x)], dim=-1)
    lo, hi = ntt.dft64(lo, torch.zeros_like(lo), n)
    return ntt.std_to_mat(lo, n), ntt.std_to_mat(hi, n)


# ---------------------------------------------------------------------------
# forward NTT (replaces cuhe_tpu/ops/ntt_kernels.py::_fwd_call)
# ---------------------------------------------------------------------------

def fwd_linear_plain(x: torch.Tensor, n: int):
    """Plain version of `fwd_linear`."""
    lead = x.shape[:-1]
    lo, hi = _fwd64(modp.to_i64(x).reshape(-1, n // 2), n)
    return (modp.to_u32(lo).reshape(lead + (n,)),
            modp.to_u32(hi).reshape(lead + (n,)))


def fwd_linear(x: torch.Tensor, n: int):
    """Forward NTT of uint32 coefficients [.., n/2] (upper half zero) ->
    uint32 pair [.., n] in mat-linear order.  On the card: one launch of
    the one-pass forward, a cluster per transform."""
    if _is_cpu(x):
        return fwd_linear_plain(x, n)
    check_root_shift(n, False)
    n1, n2 = ntt.factors(n)
    _cuda.check(x, "x", torch.uint32)
    if x.shape[-1] != n // 2:
        raise ValueError(f"x: last dim {x.shape[-1]} != n/2 = {n // 2}")
    lead = tuple(x.shape[:-1])
    lo = torch.empty(lead + (n,), dtype=torch.uint32, device=x.device)
    hi = torch.empty_like(lo)
    count = prod(lead)
    if count:
        _cuda.launch("ntt_fwd", "cuhe_ntt_fwd", x.device, x, lo, hi,
                     _device_powers(n, False, str(x.device)), count,
                     _log2(n1), _log2(n2), _log2(inv_cluster(n)))
    return lo, hi


# ---------------------------------------------------------------------------
# B1's two passes on the blocks of a transform split across devices
# (parallel/mesh.py::ntt_fwd_sharded): a column block j2_0 .. j2_0 + C - 1
# of the [n1/2, n2] coefficient matrix, then a block of rows k1 of the
# [n1, n2] intermediate
# ---------------------------------------------------------------------------


def fwd_cols_block_plain(x: torch.Tensor, n: int, j2_0: int):
    """Plain version of `fwd_cols_block`."""
    n1, _ = ntt.factors(n)
    lead, cols = x.shape[:-2], x.shape[-1]
    xt = modp.to_i64(x).reshape(-1, n1 // 2, cols).transpose(1, 2)
    xt = xt.reshape(-1, n1 // 2)
    lo = torch.cat([xt, torch.zeros_like(xt)], dim=-1)
    lo, hi = ntt.dft64(lo, torch.zeros_like(lo), n, length=n1)  # [.., k1]
    tw_lo, tw_hi = ntt.power_words(n, False, str(x.device))
    k1 = torch.arange(n1, device=x.device)
    j2 = torch.arange(j2_0, j2_0 + cols, device=x.device)
    e = (j2[:, None] * k1[None, :]) % n                          # [C, n1]
    lo, hi = modp.mul_modp64((lo.reshape(-1, cols, n1),
                              hi.reshape(-1, cols, n1)), (tw_lo[e], tw_hi[e]))
    shape = tuple(lead) + (n1, cols)
    return (modp.to_u32(lo.transpose(1, 2)).reshape(shape),
            modp.to_u32(hi.transpose(1, 2)).reshape(shape))


def fwd_cols_block(x: torch.Tensor, n: int, j2_0: int):
    """Column pass of B1 over a column block: x uint32 [.., n1/2, C] holds
    columns j2_0 .. j2_0 + C - 1 of each transform's coefficient matrix
    (coefficient j1 * n2 + j2).  Returns the uint32 pair [.., n1, C] of
    B[k1, j2] w^(k1 j2), B the length-n1 DFT over j1, with the global j2."""
    if _is_cpu(x):
        return fwd_cols_block_plain(x, n, j2_0)
    check_root_shift(n, False)
    n1, n2 = ntt.factors(n)
    _cuda.check(x, "x", torch.uint32)
    cols = x.shape[-1]
    if x.dim() < 2 or x.shape[-2] != n1 // 2:
        raise ValueError(f"x: expected [.., {n1 // 2}, C], got {tuple(x.shape)}")
    if (cols & (cols - 1) or not 1 <= cols <= n2 or j2_0 < 0
            or j2_0 + cols > n2):
        raise ValueError(f"column block {j2_0}..{j2_0 + cols - 1}: the pass "
                         f"takes a power of two of 1..{n2} columns inside "
                         f"0..{n2 - 1}")
    lead = tuple(x.shape[:-2])
    lo = torch.empty(lead + (n1, cols), dtype=torch.uint32, device=x.device)
    hi = torch.empty_like(lo)
    count = prod(lead)
    if count:
        _cuda.launch("ntt_fwd_cols_block", "cuhe_ntt_fwd_cols_block",
                     x.device, x, lo, hi,
                     _device_powers(n, False, str(x.device)), count,
                     _log2(n1), _log2(n2), _log2(cols), j2_0)
    return lo, hi


def fwd_rows_block_plain(pair, n: int):
    """Plain version of `fwd_rows_block`."""
    _, n2 = ntt.factors(n)
    lo, hi = pair
    shape = lo.shape
    lo, hi = ntt.dft64(modp.to_i64(lo).reshape(-1, n2),
                       modp.to_i64(hi).reshape(-1, n2), n, length=n2)
    return modp.to_u32(lo).reshape(shape), modp.to_u32(hi).reshape(shape)


def fwd_rows_block(pair, n: int):
    """Row pass of B1 over rows of the column pass's output: the uint32
    pair [.., R, n2] of rows C[k1, j2] -> the pair [.., R, n2] of
    D[k1, k2] = sum_j2 C[k1, j2] w^(n1 j2 k2).  Each row is its own
    length-n2 DFT, so any block of rows k1 takes the pass (on the card,
    B1's row kernel over these rows)."""
    lo, hi = pair
    if _is_cpu(lo):
        return fwd_rows_block_plain(pair, n)
    check_root_shift(n, False)
    n1, n2 = ntt.factors(n)
    _cuda.check(lo, "lo", torch.uint32, align=16)
    _cuda.check(hi, "hi", torch.uint32, lo.shape, lo.device, align=16)
    rows = prod(lo.shape[:-1])
    if lo.shape[-1] != n2:
        raise ValueError(f"rows: expected [.., R, {n2}], got "
                         f"{tuple(lo.shape)}")
    out_lo, out_hi = torch.empty_like(lo), torch.empty_like(hi)
    if rows:
        _cuda.launch("ntt_fwd_rows_block", "cuhe_ntt_rows",
                     lo.device, lo, hi, out_lo, out_hi,
                     _device_powers(n, False, str(lo.device)), rows,
                     _log2(n1), _log2(n2))
    return out_lo, out_hi


# ---------------------------------------------------------------------------
# inverse NTT + n^-1 + mod p (replaces ntt_kernels.py::_inv_call)
# ---------------------------------------------------------------------------

def inv_linear_plain(x_pair, n: int, p: torch.Tensor) -> torch.Tensor:
    """Plain version of `inv_linear`."""
    lo, hi = x_pair
    lead = lo.shape[:-1]
    lo = ntt.mat_to_std(modp.to_i64(lo), n).reshape(-1, n)
    hi = ntt.mat_to_std(modp.to_i64(hi), n).reshape(-1, n)
    lo, hi = ntt.dft64(lo, hi, n, inverse=True)
    ninv = ntt.n_inverse(n)
    y = modp.mul_modp64((lo, hi), (ninv & modp.M32, ninv >> 32))
    p_b = torch.broadcast_to(modp.to_i64(p), lead).reshape(-1, 1)
    return modp.to_u32(modp.mod_p64(y, p_b)).reshape(lead + (n,))


def _inv_args(x_pair, n: int, p: torch.Tensor):
    """The checks of the one-pass inverse's front ends on x and p, and the
    arguments they share: (out, p broadcast to x's leading dims, count)."""
    check_root_shift(n, True)
    lo, hi = x_pair
    lead = tuple(lo.shape[:-1])
    # the kernel loads 16 bytes at a time
    _cuda.check(lo, "x_lo", torch.uint32, lead + (n,), align=16)
    _cuda.check(hi, "x_hi", torch.uint32, lead + (n,), lo.device, align=16)
    _cuda.check(p, "p", torch.uint32, device=lo.device)
    p_b = _u32_contiguous(torch.broadcast_to(p, lead))
    out = torch.empty(lead + (n,), dtype=torch.uint32, device=lo.device)
    return out, p_b, prod(lead)


def inv_linear(x_pair, n: int, p: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of a mat-linear uint32 pair [.., n], times n^-1, each
    transform reduced mod its prime: p is uint32 broadcastable against the
    leading dims (e.g. [pnum] for [batch, pnum, n]).  Returns uint32 [.., n]
    in natural coefficient order."""
    if _is_cpu(x_pair[0]):
        return inv_linear_plain(x_pair, n, p)
    lo, hi = x_pair
    n1, n2 = ntt.factors(n)
    out, p_b, count = _inv_args(x_pair, n, p)
    if count:
        _cuda.launch("ntt_inv_cluster", "cuhe_ntt_inv_cluster", lo.device, lo,
                     hi, out, p_b, _device_powers(n, True, str(lo.device)),
                     count, _log2(n1), _log2(n2), _log2(inv_cluster(n)))
    return out


def check_suffix_pair(name: str, x, y) -> None:
    """Raise unless the uint32 pair y has x's shape or a suffix of it (y
    broadcast over x's leading dimensions: a [pnum, n] table, a
    plaintext's [n]) and each pair's two words match."""
    xs, ys = x[0].shape, y[0].shape
    if (x[1].shape != xs or y[1].shape != ys or len(ys) > len(xs)
            or xs[len(xs) - len(ys):] != ys):
        raise ValueError(f"{name}: x {tuple(xs)}, y {tuple(ys)}: y must "
                         "end x's shape, and a pair's words match")


def inv_linear_mul_plain(x_pair, y_pair, n: int,
                         p: torch.Tensor) -> torch.Tensor:
    """Plain version of `inv_linear_mul`: the Z_P product (ops/modp.py's
    int64 word pairs), then `inv_linear_plain`."""
    return inv_linear_plain(modp.mul_modp(x_pair, y_pair), n, p)


def inv_linear_mul(x_pair, y_pair, n: int, p: torch.Tensor) -> torch.Tensor:
    """`inv_linear` of x * y mod P, for uint32 pairs of values < 2^64: y
    has x's shape [.., n], or a suffix of it (a [pnum, n] table broadcast
    over x's leading dimensions).  On the card: one launch of the one-pass
    inverse, which takes the product at its load (the step's AND and
    Barrett's two table products, with no product written between them);
    a strided view of an operand is copied here, explicitly, as
    `pointwise.ntt_mul` copies it."""
    check_suffix_pair("inv_linear_mul", x_pair, y_pair)
    if x_pair[0].shape[-1:] != (n,) or y_pair[0].shape[-1:] != (n,):
        raise ValueError(f"inv_linear_mul: x {tuple(x_pair[0].shape)}, y "
                         f"{tuple(y_pair[0].shape)}: both end in n = {n}")
    if _is_cpu(x_pair[0]):
        return inv_linear_mul_plain(x_pair, y_pair, n, p)
    lo, hi, y_lo, y_hi = (v if v.is_contiguous() or v.dtype != torch.uint32
                          else _u32_contiguous(v) for v in (*x_pair, *y_pair))
    n1, n2 = ntt.factors(n)
    out, p_b, count = _inv_args((lo, hi), n, p)
    _cuda.check(y_lo, "y_lo", torch.uint32, device=lo.device, align=16)
    _cuda.check(y_hi, "y_hi", torch.uint32, y_lo.shape, lo.device, align=16)
    if count:
        _cuda.launch("ntt_inv_cluster_mul", "cuhe_ntt_inv_cluster_mul",
                     lo.device, lo, hi, y_lo, y_hi, out, p_b,
                     _device_powers(n, True, str(lo.device)), count,
                     y_lo.numel() // n, _log2(n1), _log2(n2),
                     _log2(inv_cluster(n)))
    return out


# ---------------------------------------------------------------------------
# windowed-digit forward NTTs (replaces ntt_kernels.py::_fwd_digits_call)
# ---------------------------------------------------------------------------

def ntt_fwd_digits_plain(raw: torch.Tensor, n: int, *, w: int, j0: int,
                         c: int):
    """Plain version of `ntt_fwd_digits`."""
    lead = raw.shape[:-2]
    digits = torch.stack([ntt.extract_digit(raw, w, j)
                          for j in range(j0, j0 + c)])
    lo, hi = _fwd64(digits.reshape(-1, n // 2), n)
    shape = (c,) + tuple(lead) + (n,)
    return modp.to_u32(lo).reshape(shape), modp.to_u32(hi).reshape(shape)


def ntt_fwd_digits(raw: torch.Tensor, n: int, *, w: int, j0: int, c: int):
    """Forward NTTs of the w-bit relinearization digits j0 .. j0+c-1 of RAW
    words [.., w32, n/2] (window at bit w*j, ntt_1_*_ext_block semantics).
    Returns a uint32 pair [c, .., n] in mat-linear order.  On the card: one
    launch of the one-pass forward, which takes the windows at its load."""
    if _is_cpu(raw):
        return ntt_fwd_digits_plain(raw, n, w=w, j0=j0, c=c)
    check_root_shift(n, False)
    n1, n2 = ntt.factors(n)
    _cuda.check(raw, "raw", torch.uint32)
    if raw.dim() < 2 or raw.shape[-1] != n // 2:
        raise ValueError(f"raw: expected [.., w32, {n // 2}], got {tuple(raw.shape)}")
    if not 0 < w <= 32 or c < 1 or j0 < 0:
        raise ValueError(f"bad digit window w={w}, j0={j0}, c={c}")
    lead = tuple(raw.shape[:-2])
    w32 = raw.shape[-2]
    batch = prod(lead)
    lo = torch.empty((c,) + lead + (n,), dtype=torch.uint32, device=raw.device)
    hi = torch.empty_like(lo)
    if batch:
        _cuda.launch("ntt_fwd_digits", "cuhe_ntt_fwd_digits", raw.device, raw,
                     lo, hi, _device_powers(n, False, str(raw.device)), batch,
                     w32, w, j0, c, _log2(n1), _log2(n2),
                     _log2(inv_cluster(n)))
    return lo, hi


# ---------------------------------------------------------------------------
# eval-key multiply-accumulate (replaces the contraction of
# ntt_kernels.py::_relin_call and ::_relin_p_call)
# ---------------------------------------------------------------------------

def relin_mulacc_plain(d_pair, ek_pair, *, j0: int, pnum: int, acc=None):
    """Plain version of `relin_mulacc`: one digit at a time, so the
    [c, .., pnum, n] product is never formed."""
    d_lo, d_hi = d_pair
    out = None if acc is None else (modp.to_i64(acc[0]), modp.to_i64(acc[1]))
    for jj in range(d_lo.shape[0]):
        d = (modp.to_i64(d_lo[jj])[..., None, :],
             modp.to_i64(d_hi[jj])[..., None, :])
        e = (modp.to_i64(ek_pair[0][j0 + jj, :pnum]),
             modp.to_i64(ek_pair[1][j0 + jj, :pnum]))
        prod_ = modp.mul_modp64(d, e)
        out = prod_ if out is None else modp.add_modp64(out, prod_)
    return modp.to_u32(out[0]), modp.to_u32(out[1])


# The multiply-accumulate kernel's accumulator is exact for fewer than 2^31
# digits (csrc/goldilocks.cuh, gl_acc_mac).
LAZY_MAX_DIGITS = (1 << 31) - 1

# Its block tile (csrc/relin.cu): 32 positions by thread groups of
# RELIN_RB ciphertexts x RELIN_RP planes, at most RELIN_MAX_GROUPS groups
# (640 threads) and RELIN_MAX_PLANE_GROUPS plane groups (the shared memory
# of its staged rows under 48 KB).
RELIN_RB, RELIN_RP = 2, 5
RELIN_POSITIONS = 32
RELIN_MAX_GROUPS, RELIN_MAX_PLANE_GROUPS = 20, 8
# ciphertext groups per block where the planes leave room for them
RELIN_B_GROUPS = 4


def relin_tile(batch: int, pnum: int) -> tuple[int, int]:
    """(ciphertext groups, plane groups) of relin_mulacc's block: enough
    plane groups for every plane (at most RELIN_MAX_PLANE_GROUPS), then up
    to RELIN_B_GROUPS ciphertext groups, no more than the batch needs."""
    pg = min(-(-pnum // RELIN_RP), RELIN_MAX_PLANE_GROUPS)
    bg = max(1, min(RELIN_B_GROUPS, RELIN_MAX_GROUPS // pg,
                    -(-batch // RELIN_RB)))
    return bg, pg


def relin_mulacc(d_pair, ek_pair, *, j0: int, pnum: int, acc=None):
    """acc + sum_jj d[jj] * ek[j0 + jj, :pnum] mod P.

    d_pair: uint32 pair [c, .., n] (digit NTTs j0 .. j0+c-1, mat-linear);
    ek_pair: uint32 pair [knum, pnum_ek, n]; acc: None or a pair
    [.., pnum, n].  Returns a new uint32 pair [.., pnum, n]."""
    d_lo, d_hi = d_pair
    if _is_cpu(d_lo):
        return relin_mulacc_plain(d_pair, ek_pair, j0=j0, pnum=pnum, acc=acc)
    dev = d_lo.device
    c, n = d_lo.shape[0], d_lo.shape[-1]
    lead = tuple(d_lo.shape[1:-1])
    # the kernel stages its operands with 16-byte copies of 32 positions
    _cuda.check(d_lo, "d_lo", torch.uint32, align=16)
    _cuda.check(d_hi, "d_hi", torch.uint32, d_lo.shape, dev, align=16)
    ek_lo, ek_hi = ek_pair
    _cuda.check(ek_lo, "ek_lo", torch.uint32, device=dev, align=16)
    _cuda.check(ek_hi, "ek_hi", torch.uint32, ek_lo.shape, dev, align=16)
    knum, pnum_ek, n_ek = ek_lo.shape
    if n_ek != n or j0 < 0 or j0 + c > knum or not 0 < pnum <= pnum_ek:
        raise ValueError(f"eval keys {tuple(ek_lo.shape)} do not cover "
                         f"digits {j0}..{j0 + c - 1}, {pnum} planes, n={n}")
    if n % RELIN_POSITIONS:
        raise ValueError(f"n = {n}: the kernel takes a multiple of "
                         f"{RELIN_POSITIONS}")
    if not 0 < c <= LAZY_MAX_DIGITS:
        raise ValueError(f"{c} digits: the kernel's accumulator is exact for "
                         f"1..{LAZY_MAX_DIGITS}")
    shape = lead + (pnum, n)
    if acc is not None:
        _cuda.check(acc[0], "acc_lo", torch.uint32, shape, dev)
        _cuda.check(acc[1], "acc_hi", torch.uint32, shape, dev)
    out_lo = torch.empty(shape, dtype=torch.uint32, device=dev)
    out_hi = torch.empty_like(out_lo)
    batch = prod(lead)
    if batch:
        _cuda.launch("relin_mulacc", "cuhe_relin_mulacc", dev, d_lo, d_hi,
                     ek_lo, ek_hi, None if acc is None else acc[0],
                     None if acc is None else acc[1], out_lo, out_hi, batch,
                     pnum, pnum_ek, n, c, j0, *relin_tile(batch, pnum))
    return out_lo, out_hi


def relin_blocks_per_sm(batch: int, pnum: int, device) -> int:
    """Resident blocks per SM of relin_mulacc's kernel at the tile it takes
    for this batch and pnum (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return _cuda.query("cuhe_relin_blocks_per_sm", torch.device(device),
                       *relin_tile(batch, pnum))


def relin_digits_mulacc(raw, ek_pair, n: int, *, w: int, j0: int, c: int,
                        pnum: int, acc=None):
    """acc + sum_j ntt(digit_j(raw)) * ek[j, :pnum] over j0 <= j < j0+c:
    the function of cuhe_tpu's fused relinearization kernels, as the digit
    NTT kernel followed by the multiply-accumulate kernel."""
    return relin_mulacc(ntt_fwd_digits(raw, n, w=w, j0=j0, c=c), ek_pair,
                        j0=j0, pnum=pnum, acc=acc)


def relin_digits_mulacc_plain(raw, ek_pair, n: int, *, w: int, j0: int,
                              c: int, pnum: int, acc=None):
    """Plain version of `relin_digits_mulacc`."""
    return relin_mulacc_plain(ntt_fwd_digits_plain(raw, n, w=w, j0=j0, c=c),
                              ek_pair, j0=j0, pnum=pnum, acc=acc)
