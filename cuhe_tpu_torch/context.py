"""Precomputed tables for one parameter set, on one device, and the
per-level domain conversions.

Counterpart of ``cuhe_tpu/context.py``: the CRT primes, the inverse-prime
matrix, the per-level ICRT words, the polynomial Barrett tables
(``m - x^mod_len`` in the CRT and NTT domains, ``u = x^(2 mod_len - 1) div m``
in the NTT domain, built with the port's forward NTT) and the eval keys.
Host tables are numpy; the NTT-domain tables and eval keys are uint32 pairs
on the context's device, in mat-linear order.

The conversions of the reference's CuPolynomial state machine
(CuHE.cu:317-464; ``cuhe_tpu/context.py:150-291``) are methods taking the
level and the data: `r2c`, `c2r` (the ICRT kernel), `c2n` (the forward
NTT), `n2c` (the inverse NTT, then Barrett for a product), `mod_switch`,
`relin` and `mul_one_many`.  They take a leading batch axis or none.  A
level's conversions are written once, as methods of its `LevelTables`
(put on the device at the level's first use), which ``step.py`` calls too.

`Context.from_numpy_state` builds a context from another context's tables
(for example the JAX package's, converted to numpy) without recomputing them;
`numpy_state` is its inverse.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from . import hostmath as hm
from .ops import crt, modp
from .ops import ntt_kernels as nk
from .ops import pointwise as pw
from .ops.barrett import barrett_combine, barrett_combine_plain, barrett_reduce
from .ops.relin import relinearize
from .params import Params, make_params

_STATE_KEYS = ("params", "primes_np", "mus_np", "invp_np", "icrt", "m_crt_np",
               "m_ntt", "u_ntt", "ek")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; asking for CUDA on a machine without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but no card is available; "
                           "pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _poly_long_div_mod_p(num_deg: int, m: list[int], p: int) -> np.ndarray:
    """(x^num_deg) div m(x) mod p, m monic; quotient coefficients, int64."""
    n = len(m) - 1
    mm = np.array(m, dtype=np.int64) % p
    r = np.zeros(num_deg + 1, dtype=np.int64)
    r[num_deg] = 1
    q = np.zeros(num_deg - n + 1, dtype=np.int64)
    for i in range(num_deg, n - 1, -1):
        c = int(r[i])
        if c:
            q[i - n] = c
            r[i - n: i + 1] = (r[i - n: i + 1] - c * mm) % p
    return q


def _host_tables(pr: Params) -> dict:
    """Everything of the context that is computed on the host, as numpy."""
    ps = list(pr.crt_primes)
    pnum = pr.num_crt_prime
    invp = np.zeros((pnum, pnum), dtype=np.uint32)
    for (i, j), v in pr.crt_inv_primes.items():
        invp[i, j] = v
    icrt = {}
    for lvl in range(pr.depth):
        q, mi, bi = pr.icrt_consts(lvl)
        w = pr.words_coeff(lvl)
        icrt[lvl] = (hm.ints_to_words([q], w)[:, 0],
                     np.stack([hm.ints_to_words([v], w)[:, 0] for v in mi]),
                     np.array(bi, dtype=np.uint32))
    mus = [modp.barrett_mu(p) for p in ps]
    half = pr.ntt_len // 2
    mcoeffs = list(pr.poly_mod)

    def residue_planes(per_p):
        out = np.zeros((pnum, half), dtype=np.uint32)
        for i, v in enumerate(per_p):
            k = min(len(v), half)
            if np.any(v[k:]):
                raise ValueError("non-zero Barrett coefficients clipped")
            out[i, :k] = v[:k].astype(np.uint32)
        return out

    m_per_p, u_per_p = [], []
    for p in ps:
        u_per_p.append(_poly_long_div_mod_p(2 * pr.mod_len - 1, mcoeffs, p))
        mp = np.array(mcoeffs, dtype=np.int64) % p
        mp[pr.mod_len] = 0  # drop the x^mod_len term (m - x^n)
        m_per_p.append(mp)
    return {
        "primes_np": np.array(ps, dtype=np.uint32),
        "mus_np": (np.array([m[0] for m in mus], dtype=np.uint32),
                   np.array([m[1] for m in mus], dtype=np.uint32)),
        "invp_np": invp,
        "icrt": icrt,
        "m_crt_np": residue_planes(m_per_p),
        "u_crt_np": residue_planes(u_per_p),
    }


def _pair_to(pair, device):
    return tuple(v.to(device) if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for v in pair)


@dataclasses.dataclass(frozen=True)
class FrontEnds:
    """The functions a level's conversions call: the kernels' front ends
    (`KERNELS`; each runs its plain version for a CPU tensor) or the plain
    versions themselves (`PLAIN`, the kernels' reference on a card)."""

    fwd: Callable            # forward NTT
    inv: Callable            # inverse NTT mod each prime
    inv_mul: Callable        # inverse NTT of a Z_P product
    combine: Callable        # Barrett's three subtracts (K2)
    icrt: Callable           # CRT -> RAW (B3)
    digits_mulacc: Callable  # relinearization's digit NTTs and mul-acc
    switch: Callable         # modulus switch (K3)


KERNELS = FrontEnds(nk.fwd_linear, nk.inv_linear, nk.inv_linear_mul,
                    barrett_combine, crt.icrt_to_raw, nk.relin_digits_mulacc,
                    pw.mod_switch)
PLAIN = FrontEnds(nk.fwd_linear_plain, nk.inv_linear_plain,
                  nk.inv_linear_mul_plain, barrett_combine_plain,
                  crt.icrt_to_raw_plain, nk.relin_digits_mulacc_plain,
                  pw.mod_switch_plain)


@dataclasses.dataclass(frozen=True)
class LevelTables:
    """A level's constants on the context's device (uint32), and the
    conversions at the level, through the front ends `ops`.  The eval keys
    are not among them: `relin` takes the ones it reads."""

    n: int
    mod_len: int
    mod_msg: int
    w: int                  # bits of a relinearization digit
    knum: int               # eval-key digits at the level
    pn: int                 # CRT primes at the level
    primes: torch.Tensor    # [pn]
    invp_last: torch.Tensor  # [pn - 1]: inv(p_last, p_i)
    bi: torch.Tensor        # [pn]: ICRT inv(M/p_i mod p_i, p_i)
    mi_words: torch.Tensor  # [pn, words]: M/p_i
    m_words: torch.Tensor   # [words]: M
    u_ntt: tuple            # Barrett u, pair [pn, n]
    m_ntt: tuple            # Barrett m - x^n, pair [pn, n]
    m_crt: torch.Tensor     # [pn, n/2]

    def planes(self, c0: int, c1: int) -> "LevelTables":
        """The tables of planes c0..c1-1 (a crt rank's), contiguous copies;
        M and `invp_last` stay whole (the sharded switch cuts its own)."""
        def cut(v):
            return nk._u32_contiguous(v[c0:c1])

        return dataclasses.replace(
            self, pn=c1 - c0, primes=cut(self.primes), bi=cut(self.bi),
            mi_words=cut(self.mi_words), u_ntt=tuple(map(cut, self.u_ntt)),
            m_ntt=tuple(map(cut, self.m_ntt)), m_crt=cut(self.m_crt))

    def n2c(self, is_prod: bool, pair, other=None,
            ops: FrontEnds = KERNELS) -> torch.Tensor:
        """NTT-domain pair [.., pn, n] -> CRT residues [.., pn, n/2]: the
        inverse NTT mod each prime, of pair * other mod P where `other` is
        given (the product taken inside the inverse), then for a product
        (degree up to 2 mod_len - 2) the polynomial Barrett reduction."""
        if other is None:
            full = ops.inv(pair, self.n, self.primes)
        else:
            full = ops.inv_mul(pair, other, self.n, self.primes)
        if not is_prod:
            return full[..., : self.n // 2].contiguous()
        return barrett_reduce(full, mod_len=self.mod_len, n=self.n,
                              u_ntt=self.u_ntt, m_ntt=self.m_ntt,
                              m_crt=self.m_crt, primes=self.primes, ops=ops)

    def c2r(self, c, ops: FrontEnds = KERNELS) -> torch.Tensor:
        """CRT residues -> RAW words in [0, M) (the ICRT)."""
        return ops.icrt(c, self.primes, self.bi, self.mi_words, self.m_words)

    def mod_switch(self, c, ops: FrontEnds = KERNELS) -> torch.Tensor:
        """CRT residues -> the next level's (the last prime dropped)."""
        return ops.switch(c, self.primes, self.invp_last, self.mod_msg)

    def relin(self, raw, ek, ops: FrontEnds = KERNELS):
        """RAW words of a product -> NTT-domain pair [.., pn, n] of the
        relinearized ciphertext, over the eval-key pair `ek` [num_eval_key,
        >= pn, n]."""
        return relinearize(raw, *ek, w=self.w, knum=self.knum, pnum=self.pn,
                           n=self.n, ops=ops)


class Context:
    """Precomputed state for one parameter set (one ring / prime chain)."""

    def __init__(self, params: Params, device="cuda"):
        dev = resolve_device(device)
        host = _host_tables(params)
        n = params.ntt_len
        m_ntt = nk.fwd_linear(torch.from_numpy(host["m_crt_np"]).to(dev), n)
        u_ntt = nk.fwd_linear(torch.from_numpy(host.pop("u_crt_np")).to(dev), n)
        self._install(params, dev, m_ntt=m_ntt, u_ntt=u_ntt, **host)

    def _install(self, params, device, *, primes_np, mus_np, invp_np, icrt,
                 m_crt_np, m_ntt, u_ntt):
        self.params = params
        self.device = device
        self.n = params.ntt_len
        self.mod_len = params.mod_len
        self.primes_np = primes_np
        self.mus_np = mus_np
        self.invp_np = invp_np
        self._icrt = icrt
        self.m_crt_np = m_crt_np
        self.m_crt = torch.from_numpy(m_crt_np).to(device)
        self.m_ntt = m_ntt
        self.u_ntt = u_ntt
        self.ek_ntt: tuple | None = None
        self._levels: dict[int, LevelTables] = {}

    def set_eval_keys(self, ek_lo, ek_hi) -> None:
        """Install mat-linear NTT-domain eval keys [num_eval_key, pnum, n]
        (numpy or torch uint32) on the context's device."""
        shape = (self.params.num_eval_key, self.params.num_crt_prime, self.n)
        lo, hi = _pair_to((ek_lo, ek_hi), self.device)
        for name, v in (("ek_lo", lo), ("ek_hi", hi)):
            if v.dtype != torch.uint32 or tuple(v.shape) != shape:
                raise ValueError(f"{name}: expected uint32 {shape}, got "
                                 f"{v.dtype} {tuple(v.shape)}")
        self.ek_ntt = (lo.contiguous(), hi.contiguous())

    # ---- per-level conversions (CuPolynomial state machine) ----
    def level(self, lvl: int) -> LevelTables:
        """The constants of level `lvl`, on the device (made once)."""
        if lvl not in self._levels:
            pr = self.params
            pn = pr.num_crt_prime_lvl(lvl)
            m_words, mi_words, bi = self._icrt[lvl]

            def dev(a):
                return torch.from_numpy(np.array(a, dtype=np.uint32)).to(
                    self.device)

            self._levels[lvl] = LevelTables(
                n=self.n, mod_len=self.mod_len, mod_msg=pr.mod_msg,
                w=pr.log_relin, knum=pr.num_eval_key_lvl(lvl),
                pn=pn, primes=dev(self.primes_np[:pn]),
                invp_last=dev(self.invp_np[pn - 1, : pn - 1]), bi=dev(bi),
                mi_words=dev(mi_words), m_words=dev(m_words),
                u_ntt=tuple(v[:pn] for v in self.u_ntt),
                m_ntt=tuple(v[:pn] for v in self.m_ntt),
                m_crt=self.m_crt[:pn])
        return self._levels[lvl]

    def r2c(self, lvl: int, raw: torch.Tensor) -> torch.Tensor:
        """RAW words [.., words, n/2] -> CRT residues [.., pn, n/2]."""
        return crt.crt_from_raw(raw, self.level(lvl).primes)

    def c2r(self, lvl: int, c: torch.Tensor) -> torch.Tensor:
        """CRT residues -> RAW words in [0, q_lvl) (the ICRT kernel)."""
        return self.level(lvl).c2r(c)

    def c2n(self, c: torch.Tensor):
        """Coefficients [.., n/2] -> NTT-domain pair [.., n] (the forward
        NTT); the same at every level, and for a plaintext's word plane."""
        return nk.fwd_linear(c, self.n)

    def n2c(self, lvl: int, is_prod: bool, pair, other=None) -> torch.Tensor:
        """NTT-domain pair [.., pn, n], or its product with `other` -> CRT
        residues [.., pn, n/2] (`LevelTables.n2c`)."""
        return self.level(lvl).n2c(is_prod, pair, other)

    def mod_switch(self, lvl: int, c: torch.Tensor) -> torch.Tensor:
        """CRT residues at level lvl -> level lvl + 1 (one prime fewer)."""
        return self.level(lvl).mod_switch(c)

    def relin(self, lvl: int, raw: torch.Tensor):
        """RAW words of a product -> NTT-domain pair [.., pn, n] of the
        relinearized ciphertext (the digit NTT and multiply-accumulate
        kernels, over the level's eval keys)."""
        if self.ek_ntt is None:
            raise RuntimeError("relinearization keys not initialised")
        return self.level(lvl).relin(raw, self.ek_ntt)

    def mul_one_many(self, lvl: int, raw_batch: torch.Tensor, a_pair):
        """RAW words [B, words, n/2] of B polynomials times one NTT-domain
        operand [pn, n], mod m(x) and q_lvl: RAW words [B, words, n/2]."""
        b = self.c2n(self.r2c(lvl, raw_batch))
        return self.c2r(lvl, self.n2c(lvl, True, pw.ntt_mul(b, a_pair)))

    # ---- state interchange ----
    def numpy_state(self) -> dict:
        """All tables as numpy arrays (keys as `from_numpy_state` reads)."""
        pr = self.params
        np_pair = lambda t: tuple(v.cpu().numpy() for v in t)  # noqa: E731
        return {
            "params": (pr.depth, pr.mod_msg, pr.log_relin, pr.log_coeff_min,
                       pr.log_coeff_cut, pr.m_size),
            "primes_np": self.primes_np, "mus_np": self.mus_np,
            "invp_np": self.invp_np, "icrt": self._icrt,
            "m_crt_np": self.m_crt_np,
            "m_ntt": np_pair(self.m_ntt), "u_ntt": np_pair(self.u_ntt),
            "ek": None if self.ek_ntt is None else np_pair(self.ek_ntt),
        }

    @classmethod
    def from_numpy_state(cls, state: dict, device="cuda") -> "Context":
        """Build a context from numpy tables without recomputing them.

        `state` holds: "params" (the six make_params arguments), "primes_np",
        "mus_np" (pair), "invp_np", "icrt" ({lvl: (m_words, mi_words, bi)}),
        "m_crt_np", "m_ntt" and "u_ntt" (mat-linear pairs [pnum, n]) and
        "ek" (pair [num_eval_key, pnum, n] or None).  The JAX Context's
        attributes of the same names (``_icrt`` for "icrt", ``ek_ntt`` for
        "ek"), converted with np.asarray, are such a state.
        """
        missing = [k for k in _STATE_KEYS if k not in state]
        if missing:
            raise KeyError(f"state lacks {missing}")
        dev = resolve_device(device)
        pr = make_params(*state["params"])
        primes = np.asarray(state["primes_np"], dtype=np.uint32)
        if primes.tolist() != list(pr.crt_primes):
            raise ValueError("state primes do not match its parameters")
        shape = (pr.num_crt_prime, pr.ntt_len)
        m_ntt = _pair_to(state["m_ntt"], dev)
        u_ntt = _pair_to(state["u_ntt"], dev)
        for v in m_ntt + u_ntt:
            if v.dtype != torch.uint32 or tuple(v.shape) != shape:
                raise ValueError(f"Barrett NTT tables must be uint32 {shape}")
        ctx = cls.__new__(cls)
        ctx._install(
            pr, dev, primes_np=primes,
            mus_np=tuple(np.asarray(v, dtype=np.uint32)
                         for v in state["mus_np"]),
            invp_np=np.asarray(state["invp_np"], dtype=np.uint32),
            icrt={int(k): tuple(np.asarray(a, dtype=np.uint32) for a in v)
                  for k, v in state["icrt"].items()},
            m_crt_np=np.asarray(state["m_crt_np"], dtype=np.uint32),
            m_ntt=m_ntt, u_ntt=u_ntt)
        if state["ek"] is not None:
            ctx.set_eval_keys(*state["ek"])
        return ctx
