"""Pointwise gate arithmetic and modulus switching.

Counterpart of ``cuhe_tpu/ops/pointwise.py`` (Base.cu:1036-1138) and of
``cuhe_tpu/ops/modp.py::mul_modp`` / ``add_modp``.  NTT-domain values are
uint32 pairs mod P ``[.., pnum, n]``; CRT values are uint32 residues
``[.., pnum, L]`` mod the plane's prime.

Every operation here but `crt_sub` (a helper of the plain versions) is the
front end of a hand-written kernel (``csrc/pointwise.cu``, ``csrc/
crt_ops.cu``), as in ``ops/ntt_kernels.py``: for a CUDA tensor it launches
the kernel, for a CPU tensor it runs its plain version, the ``*_plain``
function beside it, whose int64 arithmetic follows the JAX package's; any
other device raises, and nothing gives way from one to the other.  Shapes
and dtypes are checked on both devices.  They are

  * `ntt_mul` / `ntt_mul_nx1` (K1, ``cuhe_zp_mul``): the Z_P pair product;
  * `mod_switch` / `mod_switch_dropped` (K3, ``cuhe_mod_switch``);
  * `crt_add`      (K4, ``cuhe_crt_add``);
  * `ntt_add` / `ntt_add_nx1` (K6, ``cuhe_zp_add``): the Z_P pair sum;
  * `crt_add_nx1`, `crt_add_int`, `crt_add_int_rows`, `crt_mul_int` (K7,
    ``cuhe_crt_scalar``): a plaintext added to every plane, and a constant
    added to or multiplied into coefficient 0;

and `ops/barrett.py::barrett_combine` (K2).  A plain version called with a
CUDA tensor counts the call in ``_cuda.PLAIN_CALLS`` (under its kernel's
launch counter), so that a check of the card can tell that a path ran on
the kernels alone.
"""

from __future__ import annotations

from math import prod

import torch

from . import _cuda, modp
from . import ntt_kernels as nk


def _dense(t: torch.Tensor, name: str, device: torch.device,
           align: int = 16) -> torch.Tensor:
    """`t` as the kernels take it: contiguous (a strided view is copied
    here, explicitly), uint32, on `device`, and starting at a multiple of
    `align` bytes (16 for the planes the kernels move four words at a
    time)."""
    if t.dtype == torch.uint32 and not t.is_contiguous():
        t = nk._u32_contiguous(t)
    _cuda.check(t, name, torch.uint32, device=device, align=align)
    return t


def _quads(t: torch.Tensor, name: str) -> None:
    """The kernels move four coefficients a thread: the last dimension must
    be a multiple of 4, and the count below 2^31."""
    if t.dim() == 0 or t.shape[-1] % 4 or t.numel() >= 1 << 31:
        raise ValueError(f"{name}: the kernels take a last dimension that is "
                         f"a multiple of 4 and under 2^31 elements, got "
                         f"{tuple(t.shape)}")


def _u32_args(name: str, *ts) -> None:
    """Raise TypeError unless every tensor of `ts` is uint32 (both
    devices: the kernels and the plain versions take uint32 words)."""
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.uint32:
            raise TypeError(f"{name}: expected {torch.uint32}, got {t.dtype}")


# ---- NTT domain (mod P), Base.cu:1036-1075 ----

def _zp_pair_op(name: str, counter: str, fn: str, plain, x, y):
    """The front end of K1 and K6: y has x's shape, or a suffix of it
    (broadcast over x's leading dimensions: a [pnum, n] table, a
    plaintext's [n]); both devices hold y to that shape."""
    xs, ys = x[0].shape, y[0].shape
    if (x[1].shape != xs or y[1].shape != ys or len(ys) > len(xs)
            or xs[len(xs) - len(ys):] != ys):
        raise ValueError(f"{name}: x {tuple(xs)}, y {tuple(ys)}: y must "
                         "end x's shape, and a pair's words match")
    if nk._is_cpu(x[0]):
        return plain(x, y)
    dev = x[0].device
    xl, xh = (_dense(v, "x", dev) for v in x)
    yl, yh = (_dense(v, "y", dev) for v in y)
    _quads(xl, "x")
    _quads(yl, "y")
    lo, hi = torch.empty_like(xl), torch.empty_like(xh)
    if xl.numel():
        _cuda.launch(counter, fn, dev, xl, xh, yl, yh, lo, hi, xl.numel(),
                     yl.numel())
    return lo, hi


def ntt_mul_plain(x, y):
    """Plain version of `ntt_mul` (ops/modp.py's int64 word pairs)."""
    _cuda.count_plain("zp_mul", x[0])
    return modp.mul_modp(x, y)


def ntt_mul(x, y):
    """(x * y) mod P for uint32 pairs of values < 2^64; canonical output.

    y has x's shape, or a suffix of it (broadcast over x's leading
    dimensions: a [pnum, n] table, a plaintext's [n]).  On the card: K1,
    one launch.  Both devices hold y to that shape."""
    return _zp_pair_op("ntt_mul", "zp_mul", "cuhe_zp_mul", ntt_mul_plain,
                       x, y)


def ntt_add_plain(x, y):
    """Plain version of `ntt_add` (ops/modp.py's int64 word pairs)."""
    _cuda.count_plain("zp_add", x[0])
    return modp.add_modp(x, y)


def ntt_add(x, y):
    """(x + y) mod P for canonical uint32 pairs; canonical output.  y has
    x's shape or a suffix of it, as in `ntt_mul`.  On the card: K6, one
    launch."""
    return _zp_pair_op("ntt_add", "zp_add", "cuhe_zp_add", ntt_add_plain,
                       x, y)


def ntt_mul_nx1(x, scalar):
    """x: pair [.., pnum, n]; scalar: pair [n] broadcast across planes."""
    return ntt_mul(x, scalar)


def ntt_add_nx1(x, scalar):
    """x: pair [.., pnum, n]; scalar: pair [n] broadcast across planes."""
    return ntt_add(x, scalar)


# ---- CRT domain (per-plane mod p_i), Base.cu:1078-1109 ----

def crt_add_plain(x, y, primes):
    """Plain version of `crt_add`."""
    _cuda.count_plain("crt_add", x)
    p = modp.to_i64(primes)[:, None]
    s = modp.to_i64(x) + modp.to_i64(y)
    return modp.to_u32(torch.where(s >= p, s - p, s))


def crt_add(x, y, primes):
    """(x + y) mod p_i per plane; x, y uint32 residues [.., pnum, L],
    primes [pnum].  On the card: K4, one launch."""
    if nk._is_cpu(x):
        return crt_add_plain(x, y, primes)
    if x.dim() < 2 or y.shape != x.shape:
        raise ValueError(f"crt_add: x {tuple(x.shape)}, y {tuple(y.shape)}: "
                         "expected two [.., pnum, L] of one shape")
    pnum, length = x.shape[-2:]
    if primes.shape != (pnum,):
        raise ValueError(f"crt_add: primes {tuple(primes.shape)}, expected "
                         f"({pnum},)")
    dev = x.device
    x, y = _dense(x, "x", dev), _dense(y, "y", dev)
    primes = _dense(primes, "primes", dev, align=4)
    _quads(x, "x")
    out = torch.empty_like(x)
    rows = x.numel() // length if length else 0
    if rows:
        _cuda.launch("crt_add", "cuhe_crt_add", dev, x, y, primes, out, rows,
                     pnum, length)
    return out


def crt_sub(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for int64 residues a, b < p (planewise)."""
    return torch.where(a < b, a + p - b, a - b)


# K7's modes (csrc/crt_ops.cu ScalarMode)
_ADD_POLY, _ADD_COEFF0, _MUL_COEFF0 = 0, 1, 2


def _crt_scalar_checks(name: str, x, primes, a=None) -> None:
    """The shape and dtype rules of K7's front ends, on both devices: x
    uint32 [.., pnum, L], primes uint32 [pnum], a an int in [0, 2^32) (the
    JAX package takes it as a jnp.uint32)."""
    _u32_args(name, x, primes)
    if x.dim() < 2 or primes.shape != (x.shape[-2],):
        raise ValueError(f"{name}: x {tuple(x.shape)}, primes "
                         f"{tuple(primes.shape)}: expected [.., pnum, L] and "
                         "[pnum]")
    if a is not None and not 0 <= int(a) < 1 << 32:
        raise ValueError(f"{name}: a = {a} is not a uint32")


def _crt_scalar(x, primes, mode: int, *, s=None, c_rows=None, a: int = 0):
    """Launch K7 on CUDA residues x [.., pnum, L]: one pass that writes the
    whole output."""
    dev = x.device
    pnum, length = x.shape[-2:]
    x = _dense(x, "x", dev)
    _quads(x, "x")
    primes = _dense(primes, "primes", dev, align=4)
    if s is not None:
        s = _dense(s, "scalar", dev)
    if c_rows is not None:
        c_rows = _dense(c_rows, "c", dev, align=4)
    out = torch.empty_like(x)
    rows = x.numel() // length if length else 0
    if rows:
        # a as the bit pattern of a C int
        _cuda.launch("crt_scalar", "cuhe_crt_scalar", dev, x, s, c_rows,
                     primes, out, rows, pnum, length, mode,
                     a - (1 << 32) if a >= 1 << 31 else a)
    return out


def _set_coeff0(x, v):
    out = x.clone()
    out[..., 0] = modp.to_u32(v)
    return out


def crt_add_int_plain(x, a: int, primes):
    """Plain version of `crt_add_int`."""
    _cuda.count_plain("crt_scalar", x)
    p = modp.to_i64(primes)
    return _set_coeff0(x, (modp.to_i64(x[..., 0]) + int(a) % p) % p)


def crt_add_int(x, a: int, primes):
    """Add integer a (0 <= a < 2^32) to coefficient 0 of every plane mod
    p_i (crt_add_int kernel).  On the card: K7, one launch."""
    _crt_scalar_checks("crt_add_int", x, primes, a)
    if nk._is_cpu(x):
        return crt_add_int_plain(x, a, primes)
    return _crt_scalar(x, primes, _ADD_COEFF0, a=int(a))


def crt_add_int_rows_plain(x, c, primes):
    """Plain version of `crt_add_int_rows`."""
    _cuda.count_plain("crt_scalar", x)
    p = modp.to_i64(primes)
    return _set_coeff0(x, (modp.to_i64(x[..., 0]) + modp.to_i64(c)[..., None])
                       % p)


def crt_add_int_rows(x, c, primes):
    """Add c[b], uint32 of x's leading shape (one value per ciphertext, not
    reduced mod any p_i: PRINCE's round-constant bits), to coefficient 0 of
    every plane of ciphertext b mod p_i.  On the card: K7, one launch."""
    _crt_scalar_checks("crt_add_int_rows", x, primes)
    _u32_args("crt_add_int_rows", c)
    if c.shape != x.shape[:-2]:
        raise ValueError(f"crt_add_int_rows: c {tuple(c.shape)}, expected "
                         f"x's leading shape {tuple(x.shape[:-2])}")
    if nk._is_cpu(x):
        return crt_add_int_rows_plain(x, c, primes)
    return _crt_scalar(x, primes, _ADD_COEFF0, c_rows=c)


def crt_add_nx1_plain(x, scalar, primes):
    """Plain version of `crt_add_nx1`."""
    _cuda.count_plain("crt_scalar", x)
    p = modp.to_i64(primes)[:, None]
    return modp.to_u32(torch.remainder(modp.to_i64(x) + modp.to_i64(scalar), p))


def crt_add_nx1(x, scalar, primes):
    """Ciphertext + plaintext: add a uint32 polynomial [L], not reduced mod
    any p_i, to every plane mod p_i (Base.cu:1101-1109): the exact 33-bit
    sum, reduced.  On the card: K7, one launch."""
    _crt_scalar_checks("crt_add_nx1", x, primes)
    _u32_args("crt_add_nx1", scalar)
    if scalar.shape != x.shape[-1:]:
        raise ValueError(f"crt_add_nx1: scalar {tuple(scalar.shape)}, "
                         f"expected ({x.shape[-1]},)")
    if nk._is_cpu(x):
        return crt_add_nx1_plain(x, scalar, primes)
    return _crt_scalar(x, primes, _ADD_POLY, s=scalar)


def crt_mul_int_plain(x, a: int, primes):
    """Plain version of `crt_mul_int`."""
    _cuda.count_plain("crt_scalar", x)
    return _set_coeff0(x, modp.mulmod32(modp.to_i64(x[..., 0]), int(a),
                                        modp.to_i64(primes)))


def crt_mul_int(x, a: int, primes):
    """Multiply coefficient 0 of every plane by integer a (0 <= a < 2^32)
    mod p_i.  On the card: K7, one launch."""
    _crt_scalar_checks("crt_mul_int", x, primes, a)
    if nk._is_cpu(x):
        return crt_mul_int_plain(x, a, primes)
    return _crt_scalar(x, primes, _MUL_COEFF0, a=int(a))


# ---- modulus switching (Base.cu:1112-1138) ----

def mod_switch_dropped_plain(crt, dropped, primes, invp_last,
                             mod_msg: int) -> torch.Tensor:
    """Plain version of `mod_switch_dropped`, in int64.  The dropped
    residues d (< p_t) are moved by +/- ep*p_t, ep = d mod mod_msg, so that
    they become divisible by the message modulus, with the centered branch
    on d > (p_t-1)/2; then (x_i - d) * p_t^-1 mod p_i for the kept planes.
    The difference can be negative: `torch.remainder` takes the divisor's
    sign, as jnp's % does in the JAX package."""
    _cuda.count_plain("mod_switch", crt)
    k = invp_last.shape[0]
    p = modp.to_i64(primes)
    pt, pp = p[k], p[:k, None]
    d = modp.to_i64(dropped)
    ep = torch.remainder(d, mod_msg)
    adj = torch.where(d > (pt - 1) // 2, d - ep * pt, d + ep * pt)
    d = torch.where(ep != 0, adj, d)
    diff = torch.remainder(modp.to_i64(crt[..., :k, :]) - d[..., None, :], pp)
    return modp.to_u32(modp.mulmod32(diff, modp.to_i64(invp_last)[:, None],
                                     pp))


def mod_switch_dropped(crt, dropped, primes, invp_last,
                       mod_msg: int) -> torch.Tensor:
    """The modulus switch with the dropped prime's plane given on its own.

    crt: uint32 [.., P, L] whose first k = len(invp_last) planes are kept
    (P >= k; the rest are not read); dropped: uint32 [.., L], the residues
    mod p_t; primes: uint32 [k + 1], the kept planes' primes, then p_t;
    invp_last: uint32 [k], inv(p_t, p_i).  Returns uint32 [.., k, L].
    `mod_switch` passes its own last plane; a crt-sharded step
    (parallel/mesh.py) the plane broadcast by the rank that holds it.  On
    the card: K3, one launch, reading the kept planes and the dropped one
    where they lie (a row stride each)."""
    if nk._is_cpu(crt):
        return mod_switch_dropped_plain(crt, dropped, primes, invp_last,
                                        mod_msg)
    k = invp_last.shape[0] if invp_last.dim() == 1 else -1
    if crt.dim() < 2 or k < 0 or crt.shape[-2] < k:
        raise ValueError(f"mod_switch: crt {tuple(crt.shape)} and invp_last "
                         f"{tuple(invp_last.shape)}: expected [.., P, L] with "
                         f"P >= k and [k]")
    dev = crt.device
    # dropped may be a strided view, so it is checked here and not by
    # _dense; its words are reinterpreted below only once they are uint32
    if not isinstance(dropped, torch.Tensor) or dropped.dtype != torch.uint32:
        raise TypeError(f"dropped: expected {torch.uint32}, got "
                        f"{getattr(dropped, 'dtype', type(dropped).__name__)}")
    if dropped.device != dev:
        raise ValueError(f"dropped: on {dropped.device}, expected {dev}")
    lead, planes_in, length = crt.shape[:-2], crt.shape[-2], crt.shape[-1]
    if dropped.shape != lead + (length,):
        raise ValueError(f"mod_switch: dropped {tuple(dropped.shape)}, "
                         f"expected {tuple(lead + (length,))}")
    if primes.shape != (k + 1,):
        raise ValueError(f"mod_switch: primes {tuple(primes.shape)}, "
                         f"expected ({k + 1},): the kept planes', then p_t")
    if mod_msg < 1:
        raise ValueError(f"mod_switch: mod_msg {mod_msg} < 1")
    crt = _dense(crt, "crt", dev)
    _quads(crt, "crt")
    out = torch.empty(lead + (k, length), dtype=torch.uint32, device=dev)
    if out.numel() == 0:
        return out
    rows = prod(lead)
    # the dropped rows where they lie (one row stride), unless their words
    # are strided or misaligned: then a copy, explicitly
    drop = dropped.view(torch.int32).reshape(rows, length)
    stride = drop.stride(0) if rows > 1 else length
    if drop.stride(-1) != 1 or stride % 4 or drop.data_ptr() % 16:
        drop = drop.contiguous()
        stride = length
    drop = drop.view(torch.uint32)
    primes = _dense(primes, "primes", dev, align=4)
    invp_last = _dense(invp_last, "invp_last", dev, align=4)
    _cuda.launch("mod_switch", "cuhe_mod_switch", dev, crt, drop, primes,
                 invp_last, out, rows, planes_in, k, length, stride, mod_msg)
    return out


def mod_switch_plain(crt: torch.Tensor, primes: torch.Tensor,
                     invp_last: torch.Tensor, mod_msg: int) -> torch.Tensor:
    """Plain version of `mod_switch`."""
    pnum = crt.shape[-2]
    return mod_switch_dropped_plain(crt, crt[..., pnum - 1, :],
                                    primes[:pnum], invp_last, mod_msg)


def mod_switch(crt: torch.Tensor, primes: torch.Tensor,
               invp_last: torch.Tensor, mod_msg: int) -> torch.Tensor:
    """BGV-style modulus switch dropping the last prime plane.

    crt: uint32 [.., pnum, L] at level lvl; primes: uint32 [pnum] (p_t =
    primes[pnum-1] is dropped); invp_last: uint32 [pnum-1], inv(p_t, p_i).
    Returns uint32 [.., pnum-1, L]: `mod_switch_dropped` with crt's last
    plane (on the card K3, one launch)."""
    pnum = crt.shape[-2]
    return mod_switch_dropped(crt, crt[..., pnum - 1, :], primes[:pnum],
                              invp_last, mod_msg)
