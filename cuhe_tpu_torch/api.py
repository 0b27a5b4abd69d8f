"""Reference-flavoured convenience API over a process-global context.

The reference exposes a global parameter singleton plus free functions and
polynomial objects with in-place domain conversions (cuhe/CuHE.h:46-209,
cuhe/Parameters.h:64-76): ``setParameters -> initCuHE -> CuCtxt::x2n ->
cAnd(...) -> relin/modSwitch``.  The core of this framework is functional
(explicit `Context`, immutable `Ctxt`); this module, the counterpart of
``cuhe_tpu/api.py``, layers the familiar imperative surface on top so a cuHE
user can port call sites one-to-one:

    from cuhe_tpu_torch import api as cuhe
    cuhe.setParameters(5, 2, 1, 61, 20, 8191)
    cuhe.initCuHE()                    # CuHE.cu:36 (tables precompute)
    x = cuhe.CuCtxt(coeffs, level=0)
    x.x2n()
    y = cuhe.cAnd(x, x)
    y.relin(); y.modSwitch()
    out = y.x2z()

The global context lives on the card unless `initCuHE` is asked for the
CPU.  `multiGPUs(n)` records the requested card count and `numGPUs()`
reports the visible cards; one context runs on one device.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import poly
from .context import Context
from .params import Params, make_params

_ctx: Optional[Context] = None
_params: Optional[Params] = None
_num_chips: int = 1


# ---------------------------------------------------------------------------
# globals (Parameters.h:64-76, CuHE.cu:60-78)
# ---------------------------------------------------------------------------

def setParameters(d: int, p: int, w: int, min_: int, cut: int, m: int):
    """Global parameter singleton setter (CuHE.h:164-171 / Parameters.cu:53)."""
    global _params, _ctx
    _params = make_params(d, p, w, min_, cut, m)
    _ctx = None
    return _params


def resetParameters():
    global _params, _ctx
    _params = None
    _ctx = None


def initCuHE(device="cuda"):
    """Precompute NTT/CRT/Barrett tables for the global params (CuHE.cu:36)
    on `device`."""
    global _ctx
    if _params is None:
        raise RuntimeError("setParameters first")
    _ctx = Context(_params, device)
    return _ctx


def setContext(ctx: Context):
    """Adopt an existing Context (e.g. CuDHS.ctx) as the global one."""
    global _ctx, _params
    _ctx = ctx
    _params = ctx.params


def context() -> Context:
    if _ctx is None:
        initCuHE()
    return _ctx


def initRelinearization(ek_lo, ek_hi):
    """Upload eval keys in NTT domain (Relinearization.cu:43-73)."""
    context().set_eval_keys(ek_lo, ek_hi)


def multiGPUs(n: int):
    """Record the target card count (CuHE.cu:60)."""
    global _num_chips
    _num_chips = int(n)


def numGPUs() -> int:
    visible = torch.cuda.device_count()
    return min(_num_chips, visible) if _num_chips > 1 else visible


# ---------------------------------------------------------------------------
# polynomial objects (CuHE.h:46-147)
# ---------------------------------------------------------------------------

class CuCtxt:
    """Imperative wrapper over the immutable poly.Ctxt (CuHE.h:115-138)."""

    def __init__(self, coeffs=None, level: int = 0, _inner: poly.Ctxt = None):
        # `coeffs if ... is not None` (not `coeffs or []`): numpy arrays have
        # no truth value, and falsy-but-valid inputs must not be dropped
        self._c = _inner if _inner is not None else poly.ctxt_from_ints(
            coeffs if coeffs is not None else [], level)

    # -- state accessors ---------------------------------------------------
    @property
    def level(self) -> int:
        return self._c.level

    @property
    def domain(self) -> str:
        return self._c.domain

    def logq(self) -> int:
        return self._c.logq(context())

    # -- domain conversions (CuHE.cu:317-464) ------------------------------
    def x2z(self):
        out = poly.to_ints(context(), self._c)
        self._c = poly.ctxt_from_ints(out, self._c.level)
        return out

    def x2r(self):
        self._c = poly.to_raw(context(), self._c)
        return self

    def x2c(self):
        self._c = poly.to_crt(context(), self._c)
        return self

    def x2n(self):
        self._c = poly.to_ntt(context(), self._c)
        return self

    # -- noise management (CuHE.cu:543-581) --------------------------------
    def relin(self):
        self._c = poly.relin(context(), self._c)
        return self

    def modSwitch(self, lvl: int | None = None):
        ctx = context()
        self._c = (poly.mod_switch(ctx, self._c) if lvl is None
                   else poly.mod_switch_to(ctx, self._c, lvl))
        return self

    def copy(self) -> "CuCtxt":
        return CuCtxt(_inner=self._c)


class CuPtxt:
    """Plaintext wrapper (CuHE.h:141-147)."""

    def __init__(self, coeffs=None, _inner: poly.Ptxt = None):
        self._p = _inner if _inner is not None else poly.ptxt_from_ints(
            coeffs if coeffs is not None else [])

    @property
    def domain(self) -> str:
        return self._p.domain

    def x2c(self):
        self._p = poly.ptxt_to_crt(context(), self._p)
        return self

    def x2n(self):
        self._p = poly.ptxt_to_ntt(context(), self._p)
        return self


# ---------------------------------------------------------------------------
# gates (CuHE.cu:80-216)
# ---------------------------------------------------------------------------

def cAnd(a: CuCtxt, b) -> CuCtxt:
    ctx = context()
    if isinstance(b, CuPtxt):
        return CuCtxt(_inner=poly.c_and_ptxt(ctx, a._c, b._p))
    return CuCtxt(_inner=poly.c_and(ctx, a._c, b._c))


def cXor(a: CuCtxt, b) -> CuCtxt:
    ctx = context()
    if isinstance(b, CuPtxt):
        return CuCtxt(_inner=poly.c_xor_ptxt(ctx, a._c, b._p))
    return CuCtxt(_inner=poly.c_xor(ctx, a._c, b._c))


def cNot(a: CuCtxt) -> CuCtxt:
    return CuCtxt(_inner=poly.c_not(context(), a._c))


# snake_case aliases
set_parameters = setParameters
init_cuhe = initCuHE
init_relinearization = initRelinearization
c_and, c_xor, c_not = cAnd, cXor, cNot
