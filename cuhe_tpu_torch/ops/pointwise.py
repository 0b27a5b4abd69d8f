"""Pointwise gate arithmetic and modulus switching.

Counterpart of ``cuhe_tpu/ops/pointwise.py`` (Base.cu:1036-1138) and of
``cuhe_tpu/ops/modp.py::mul_modp``.  NTT-domain values are uint32 pairs mod
P ``[.., pnum, n]``; CRT values are uint32 residues ``[.., pnum, L]`` mod
the plane's prime.

Three functions of the gate step, and the CRT add of XOR and of PRINCE's
linear layers, are front ends of hand-written kernels (``csrc/
pointwise.cu``), as in ``ops/ntt_kernels.py``: for a CUDA tensor they
launch the kernel, for a CPU tensor they run their plain version, the
``*_plain`` function beside each, whose int64 arithmetic follows the JAX
package's; any other device raises, and nothing gives way from one to the
other.  They are

  * `ntt_mul`      (K1, ``cuhe_zp_mul``): the Z_P pair product;
  * `mod_switch` / `mod_switch_dropped` (K3, ``cuhe_mod_switch``);
  * `crt_add`      (K4, ``cuhe_crt_add``);

and `ops/barrett.py::barrett_combine` (K2).  The other operations here are
plain PyTorch on both devices.
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


# ---- NTT domain (mod P), Base.cu:1036-1075 ----

def ntt_mul_plain(x, y):
    """Plain version of `ntt_mul` (ops/modp.py's int64 word pairs)."""
    return modp.mul_modp(x, y)


def ntt_mul(x, y):
    """(x * y) mod P for uint32 pairs of values < 2^64; canonical output.

    y has x's shape, or a suffix of it (broadcast over x's leading
    dimensions: a [pnum, n] table, a plaintext's [n]).  On the card: K1,
    one launch.  Both devices hold y to that shape."""
    xs, ys = x[0].shape, y[0].shape
    if (x[1].shape != xs or y[1].shape != ys or len(ys) > len(xs)
            or xs[len(xs) - len(ys):] != ys):
        raise ValueError(f"ntt_mul: x {tuple(xs)}, y {tuple(ys)}: y must "
                         "end x's shape, and a pair's words match")
    if nk._is_cpu(x[0]):
        return ntt_mul_plain(x, y)
    dev = x[0].device
    xl, xh = (_dense(v, "x", dev) for v in x)
    yl, yh = (_dense(v, "y", dev) for v in y)
    _quads(xl, "x")
    _quads(yl, "y")
    lo, hi = torch.empty_like(xl), torch.empty_like(xh)
    if xl.numel():
        _cuda.launch("zp_mul", "cuhe_zp_mul", dev, xl, xh, yl, yh, lo, hi,
                     xl.numel(), yl.numel())
    return lo, hi


def ntt_add(x, y):
    return modp.add_modp(x, y)


def ntt_mul_nx1(x, scalar):
    """x: pair [.., pnum, n]; scalar: pair [n] broadcast across planes."""
    return ntt_mul(x, scalar)


def ntt_add_nx1(x, scalar):
    """x: pair [.., pnum, n]; scalar: pair [n] broadcast across planes."""
    return modp.add_modp(x, scalar)


# ---- CRT domain (per-plane mod p_i), Base.cu:1078-1109 ----

def crt_add_plain(x, y, primes):
    """Plain version of `crt_add`."""
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

def mod_switch_dropped_plain(crt, dropped, primes, invp_last,
                             mod_msg: int) -> torch.Tensor:
    """Plain version of `mod_switch_dropped`, in int64.  The dropped
    residues d (< p_t) are moved by +/- ep*p_t, ep = d mod mod_msg, so that
    they become divisible by the message modulus, with the centered branch
    on d > (p_t-1)/2; then (x_i - d) * p_t^-1 mod p_i for the kept planes.
    The difference can be negative: `torch.remainder` takes the divisor's
    sign, as jnp's % does in the JAX package."""
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
