"""Ciphertext / plaintext polynomial objects and gate-level operations.

Counterpart of ``cuhe_tpu/poly.py`` (the reference's CuPolynomial / CuCtxt /
CuPtxt state machine and gate API, cuhe/CuHE.h:46-209, cuhe/CuHE.cu:80-606).
A polynomial carries its circuit level, its domain and the "is product"
flag, and is immutable: every conversion or gate returns a new object.

  ZZX : host Python ints (list), coefficients in [0, q)
  RAW : uint32 tensor [words, raw_len]    (planar little-endian words)
  CRT : uint32 tensor [pnum, crt_len]
  NTT : pair of uint32 tensors [pnum, ntt_len], mat-linear

RAW, CRT and NTT data live on the context's device; the conversions are the
Context's per-level methods (kernels for CUDA tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import hostmath as hm
from .context import Context
from .ops import pointwise as pw

ZZX, RAW, CRT, NTT = "zzx", "raw", "crt", "ntt"

# Polynomials per batch of `poly_mul_one_to_many`: bounds the int64
# temporaries of its Barrett reduction (about 20 of [chunk, pnum, n]).
MUL_MANY_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class Ctxt:
    """Ciphertext polynomial (CuCtxt, CuHE.h:115-138)."""

    level: int
    domain: str
    data: Any
    is_prod: bool = False

    def logq(self, ctx: Context) -> int:
        return ctx.params.log_coeff(self.level)


@dataclasses.dataclass(frozen=True)
class Ptxt:
    """Plaintext polynomial: single residue plane (CuPtxt, CuHE.h:141-147)."""

    domain: str
    data: Any


# ---------------------------------------------------------------------------
# constructors / host bridges
# ---------------------------------------------------------------------------

def ctxt_from_ints(coeffs: list[int], level: int) -> Ctxt:
    return Ctxt(level=level, domain=ZZX, data=[int(c) for c in coeffs])


def ptxt_from_ints(coeffs: list[int]) -> Ptxt:
    return Ptxt(domain=ZZX, data=[int(c) for c in coeffs])


def to_ints(ctx: Context, ct: Ctxt) -> list[int]:
    """x2z (CuHE.cu:411-425): convert to host coefficients."""
    ct = to_raw(ctx, ct)
    if ct.domain == ZZX:
        return list(ct.data)
    return hm.words_to_ints(ct.data.cpu().numpy())[: ctx.params.mod_len]


def _words(ctx: Context, coeffs: list[int], words: int) -> torch.Tensor:
    """Host ints -> uint32 words [words, raw_len] on the context's device."""
    arr = hm.ints_to_words(coeffs, words, ctx.params.raw_len)
    return torch.from_numpy(arr).to(ctx.device)


# ---------------------------------------------------------------------------
# domain conversions (CuPolynomial::x2r / x2c / x2n / x2z)
# ---------------------------------------------------------------------------

def _z2r(ctx: Context, ct: Ctxt) -> Ctxt:
    raw = _words(ctx, ct.data, ctx.params.words_coeff(ct.level))
    return dataclasses.replace(ct, domain=RAW, data=raw)


def _multi_prime(ctx: Context, lvl: int) -> bool:
    """Whether q_lvl spans more than one CRT prime; a single-prime level
    passes data between RAW and CRT unchanged (CuHE.cu:366-382)."""
    return ctx.params.log_coeff(lvl) > ctx.params.log_crt_prime


def to_raw(ctx: Context, ct: Ctxt) -> Ctxt:
    if ct.domain == RAW:
        return ct
    if ct.domain == ZZX:
        return _z2r(ctx, ct)
    if ct.domain == NTT:
        return to_raw(ctx, to_crt(ctx, ct))
    raw = ctx.c2r(ct.level, ct.data) if _multi_prime(ctx, ct.level) else ct.data
    return dataclasses.replace(ct, domain=RAW, data=raw)


def to_crt(ctx: Context, ct: Ctxt) -> Ctxt:
    if ct.domain == CRT:
        return ct
    if ct.domain == ZZX:
        return to_crt(ctx, _z2r(ctx, ct))
    if ct.domain == RAW:
        c = ctx.r2c(ct.level, ct.data) if _multi_prime(ctx, ct.level) else ct.data
        return dataclasses.replace(ct, domain=CRT, data=c)
    # NTT -> CRT (n2c): inverse NTT, with Barrett reduction if a product
    c = ctx.n2c(ct.level, ct.is_prod, ct.data)
    return dataclasses.replace(ct, domain=CRT, data=c, is_prod=False)


def to_ntt(ctx: Context, ct: Ctxt) -> Ctxt:
    if ct.domain == NTT:
        return ct
    ct = to_crt(ctx, ct)
    return dataclasses.replace(ct, domain=NTT, data=ctx.c2n(ct.data))


def ptxt_to_ntt(ctx: Context, pt: Ptxt) -> Ptxt:
    """The plaintext's one word plane, not reduced mod any prime, through
    the forward NTT."""
    if pt.domain == NTT:
        return pt
    if pt.domain == ZZX:
        pt = Ptxt(domain=CRT, data=_words(ctx, pt.data, 1))
    return Ptxt(domain=NTT, data=ctx.c2n(pt.data))


def ptxt_to_crt(ctx: Context, pt: Ptxt) -> Ptxt:
    if pt.domain == CRT:
        return pt
    if pt.domain == ZZX:
        return Ptxt(domain=CRT, data=_words(ctx, pt.data, 1))
    raise ValueError("cannot convert plaintext NTT -> CRT")


# ---------------------------------------------------------------------------
# gates (CuHE.cu:101-216)
# ---------------------------------------------------------------------------

def _check(a: Ctxt, b: Ctxt, dom: str | None):
    if a.level != b.level:
        raise ValueError("operands at different levels")
    if dom is not None and (a.domain != dom or b.domain != dom):
        raise ValueError(f"operands must be in {dom} domain")


def _plane0(pt: Ptxt):
    return (pt.data[0][0], pt.data[1][0])


def c_and(ctx: Context, a: Ctxt, b: Ctxt) -> Ctxt:
    """Homomorphic AND = NTT-domain pointwise multiply (cAnd, CuHE.cu:101)."""
    _check(a, b, NTT)
    out = pw.ntt_mul(a.data, b.data)
    return Ctxt(level=a.level, domain=NTT, data=out, is_prod=True)


def c_and_ptxt(ctx: Context, a: Ctxt, pt: Ptxt) -> Ctxt:
    if a.domain != NTT or pt.domain != NTT:
        raise ValueError("cAnd(ct, pt) requires NTT domain")
    out = pw.ntt_mul_nx1(a.data, _plane0(pt))
    return Ctxt(level=a.level, domain=NTT, data=out, is_prod=True)


def c_xor(ctx: Context, a: Ctxt, b: Ctxt) -> Ctxt:
    """Homomorphic XOR = addition (cXor, CuHE.cu:141)."""
    _check(a, b, None)
    if a.domain == CRT and b.domain == CRT:
        out = pw.crt_add(a.data, b.data, ctx.level(a.level).primes)
        return Ctxt(level=a.level, domain=CRT, data=out)
    if a.domain == NTT and b.domain == NTT:
        out = pw.ntt_add(a.data, b.data)
        return Ctxt(level=a.level, domain=NTT, data=out,
                    is_prod=a.is_prod or b.is_prod)
    raise ValueError("cXor requires both operands in CRT or NTT domain")


def c_xor_ptxt(ctx: Context, a: Ctxt, pt: Ptxt) -> Ctxt:
    if a.domain == CRT and pt.domain == CRT:
        out = pw.crt_add_nx1(a.data, pt.data[0], ctx.level(a.level).primes)
        return Ctxt(level=a.level, domain=CRT, data=out)
    if a.domain == NTT and pt.domain == NTT:
        out = pw.ntt_add_nx1(a.data, _plane0(pt))
        return Ctxt(level=a.level, domain=NTT, data=out, is_prod=a.is_prod)
    raise ValueError("cXor(ct, pt) domain mismatch")


def c_not(ctx: Context, a: Ctxt) -> Ctxt:
    """Homomorphic NOT: add (mod_msg - 1) to constant coeff (cNot, CuHE.cu:203)."""
    if a.domain != CRT:
        raise ValueError("cNot requires CRT domain")
    out = pw.crt_add_int(a.data, ctx.params.mod_msg - 1,
                         ctx.level(a.level).primes)
    return Ctxt(level=a.level, domain=CRT, data=out)


# ---------------------------------------------------------------------------
# noise control (CuCtxt::modSwitch / relin, CuHE.cu:543-581)
# ---------------------------------------------------------------------------

def mod_switch(ctx: Context, ct: Ctxt) -> Ctxt:
    pr = ctx.params
    if pr.log_coeff(ct.level) < pr.log_coeff_min + pr.log_coeff_cut:
        raise ValueError("cannot modSwitch on the last level")
    ct = to_crt(ctx, ct)
    return Ctxt(level=ct.level + 1, domain=CRT,
                data=ctx.mod_switch(ct.level, ct.data))


def mod_switch_to(ctx: Context, ct: Ctxt, lvl: int) -> Ctxt:
    if lvl < ct.level or lvl >= ctx.params.depth:
        raise ValueError("modSwitch to unavailable level")
    while ct.level < lvl:
        ct = mod_switch(ctx, ct)
    return ct


def relin(ctx: Context, ct: Ctxt) -> Ctxt:
    """Key switch back to a linear ciphertext (CuCtxt::relin, CuHE.cu:570)."""
    ct = to_raw(ctx, ct)
    out = Ctxt(level=ct.level, domain=NTT, data=ctx.relin(ct.level, ct.data),
               is_prod=True)
    return to_crt(ctx, out)


# ---------------------------------------------------------------------------
# NTL-interface equivalent (mulZZX, CuHE.cu:259-268)
# ---------------------------------------------------------------------------

def poly_mul_ints(ctx: Context, a: list[int], b: list[int], lvl: int) -> list[int]:
    """(a * b) mod m(x), coefficients mod q_lvl; both inputs already in [0, q)."""
    return poly_mul_one_to_many(ctx, a, [b], lvl)[0]


def poly_mul_one_to_many(ctx: Context, a: list[int], bs: list[list[int]],
                         lvl: int) -> list[list[int]]:
    """(a * b_i) mod m(x) mod q_lvl for a fixed left operand, the b_i in
    batches of MUL_MANY_CHUNK through `Context.mul_one_many` (decryption's
    products by the secret key share one NTT of `a`)."""
    pr = ctx.params
    words = pr.words_coeff(lvl)
    a_ntt = to_ntt(ctx, ctxt_from_ints(a, lvl)).data
    out = []
    for i in range(0, len(bs), MUL_MANY_CHUNK):
        raw = torch.from_numpy(np.stack([
            hm.ints_to_words(b, words, pr.raw_len)
            for b in bs[i: i + MUL_MANY_CHUNK]])).to(ctx.device)
        res = ctx.mul_one_many(lvl, raw, a_ntt).cpu().numpy()
        out += [hm.words_to_ints(r)[: pr.mod_len] for r in res]
    return out
