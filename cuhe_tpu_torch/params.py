"""Global parameter derivations and the CRT prime chain.

Faithful re-derivation of the reference's parameter logic:
  - setParam            (cuhe/Parameters.cu:53-85)
  - per-level accessors (cuhe/Parameters.cu:107-145)
  - genCrtPrimes        (cuhe/Operations.cu:37-80)
  - genCoeffModuli      (cuhe/Operations.cu:81-90)
  - genCrtInvPrimes     (cuhe/Operations.cu:91-100)
  - genIcrtByLevel      (cuhe/Operations.cu:107-134)

Everything here is host-side Python-int math, computed once per scheme
instance; arrays destined for the device live in context.py.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

from . import hostmath as hm

P = hm.P

NTT_LENGTHS = (16384, 32768, 65536)


@dataclasses.dataclass(frozen=True)
class Params:
    """Equivalent of GlobalParameters (cuhe/Parameters.h:34-62)."""

    depth: int          # d: multiplicative levels + 1
    mod_msg: int        # p: message modulus
    log_relin: int      # w: relinearization window bits (0 = no relin)
    log_coeff_min: int  # min: bits of the smallest coeff modulus
    log_coeff_cut: int  # cut: bits removed per level
    m_size: int         # m: ring index (modulus = m-th "cyclotomic" poly)

    # ---- derived quantities (Parameters.cu:61-84) ----
    @cached_property
    def log_coeff_max(self) -> int:
        return self.log_coeff_min + self.log_coeff_cut * (self.depth - 1)

    @cached_property
    def mod_len(self) -> int:
        return hm.euler_totient(self.m_size)

    @cached_property
    def mod_len2(self) -> int:
        v = 1 << (self.mod_len - 1).bit_length()
        return max(v, 8192)

    @property
    def raw_len(self) -> int:
        return self.mod_len2

    @property
    def crt_len(self) -> int:
        return self.mod_len2

    @property
    def ntt_len(self) -> int:
        return 2 * self.mod_len2

    @cached_property
    def log_msg(self) -> int:
        return (self.mod_msg - 1).bit_length()

    @property
    def words_msg(self) -> int:
        return (self.log_msg + 31) // 32

    @cached_property
    def num_eval_key(self) -> int:
        if self.log_relin != 0:
            return (self.log_coeff_max + self.log_relin - 1) // self.log_relin
        return 0

    @cached_property
    def _crt_plan(self) -> tuple[int, int]:
        # "use as large and as few # of crt primes as possible"
        # (Parameters.cu:78-84)
        log_crt = _isqrt(P // self.mod_len).bit_length()
        num = (self.log_coeff_min + log_crt - 1) // log_crt
        log_crt = 0
        while log_crt * num < self.log_coeff_min:
            log_crt += 1
        num += self.depth - 1
        return log_crt, num

    @property
    def log_crt_prime(self) -> int:
        return self._crt_plan[0]

    @property
    def num_crt_prime(self) -> int:
        return self._crt_plan[1]

    # ---- per-level accessors (Parameters.cu:107-145) ----
    def num_crt_prime_lvl(self, lvl: int) -> int:
        if lvl == -1:
            return 1
        if lvl >= self.depth:
            raise ValueError(f"num_crt_prime_lvl: bad level {lvl}")
        return self.num_crt_prime - lvl

    def log_coeff(self, lvl: int) -> int:
        if lvl == -1:
            return self.log_msg
        if lvl < self.depth:
            return self.log_coeff_max - lvl * self.log_coeff_cut
        if lvl == self.depth:
            return self.log_coeff_min - self.log_crt_prime
        raise ValueError("log_coeff: lvl cannot exceed depth")

    def words_coeff(self, lvl: int) -> int:
        return max((self.log_coeff(lvl) + 31) // 32, 1)

    def num_eval_key_lvl(self, lvl: int) -> int:
        return (self.log_coeff(lvl) + self.log_relin - 1) // self.log_relin

    def get_level(self, logq: int) -> int:
        if logq >= self.log_coeff_min:
            return (self.log_coeff_max - logq) // self.log_coeff_cut
        return -1  # plaintext

    # ---- CRT prime chain (Operations.cu:37-80) ----
    @cached_property
    def crt_primes(self) -> tuple[int, ...]:
        pnum, depth = self.num_crt_prime, self.depth
        log_crt, log_cut = self.log_crt_prime, self.log_coeff_cut
        primes: list[int] = []
        logmid = self.log_coeff_min - (pnum - depth) * log_crt
        # large primes, descending from 2^log_crt - 1
        temp = (1 << log_crt) - 1
        for _ in range(pnum - depth):
            temp = hm.prev_prime(temp)
            primes.append(temp)
            temp -= 1
        # mid prime
        tmid = (1 << logmid) - 1 if logmid != log_crt else temp
        tmid = hm.prev_prime(tmid)
        primes.append(tmid)
        # cutting primes: prime and == 1 mod mod_msg
        if log_cut == logmid:
            temp = tmid - 1
        elif log_cut == log_crt:
            temp -= 1
        else:
            temp = (1 << log_cut) - 1
        for _ in range(pnum - depth + 1, pnum):
            while (not hm.is_prime(temp)) or temp % self.mod_msg != 1:
                temp -= 1
            primes.append(temp)
            temp -= 1
        assert len(primes) == pnum
        return tuple(primes)

    @cached_property
    def coeff_moduli(self) -> tuple[int, ...]:
        """coeffModulus[lvl] = prod of the first (pnum - lvl) primes."""
        out = []
        for lvl in range(self.depth):
            q = 1
            for p in self.crt_primes[: self.num_crt_prime - lvl]:
                q *= p
            out.append(q)
        return tuple(out)

    def coeff_modulus(self, lvl: int) -> int:
        if lvl == -1:
            return self.mod_msg
        return self.coeff_moduli[lvl]

    @cached_property
    def crt_inv_primes(self) -> dict[tuple[int, int], int]:
        """inv(p_i mod p_j, p_j) for j < i (Operations.cu:91-100)."""
        out = {}
        ps = self.crt_primes
        for i in range(1, len(ps)):
            for j in range(i):
                out[(i, j)] = hm.modinv(ps[i] % ps[j], ps[j])
        return out

    def icrt_consts(self, lvl: int):
        """Per-level ICRT constants (Operations.cu:107-134).

        Returns (q, [M/p_i], [inv(M/p_i mod p_i)]) for the level's modulus.
        """
        pnum = self.num_crt_prime_lvl(lvl)
        q = self.coeff_moduli[lvl]
        mi = [q // p for p in self.crt_primes[:pnum]]
        bi = [hm.modinv(mi[i] % self.crt_primes[i], self.crt_primes[i])
              for i in range(pnum)]
        return q, mi, bi

    @cached_property
    def poly_mod(self) -> tuple[int, ...]:
        """m(x) coefficients (examples/DHS/DHS.cu:280-305)."""
        return tuple(hm.gen_poly_mod(self.m_size))

    def validate(self) -> None:
        if self.ntt_len not in NTT_LENGTHS:
            raise ValueError(f"unsupported NTT length {self.ntt_len}")
        if self.num_crt_prime > 103:
            raise ValueError("more than 103 CRT primes (reference cap, Base.cu:139)")
        # NTT-exactness bound: n * p^2 < P (Parameters.cu:78, survey section 0)
        pmax = max(self.crt_primes)
        if self.ntt_len // 2 * pmax * pmax >= P:
            raise ValueError("CRT primes too large for exact NTT convolution")


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


def make_params(d: int, p: int, w: int, min_: int, cut: int, m: int) -> Params:
    """setParameters equivalent (cuhe/CuHE.cu:68, Parameters.cu:53)."""
    pr = Params(depth=d, mod_msg=p, log_relin=w, log_coeff_min=min_,
                log_coeff_cut=cut, m_size=m)
    pr.validate()
    return pr
