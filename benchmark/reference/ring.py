"""The ring, the CRT prime chain and every per-level table of a cuHE
parameter set, worked out from the six published parameters alone.

``Ring(d, p, w, min, cut, m)`` follows cuHE's setParameters
(cuhe/Parameters.cu:53-85), genCrtPrimes (cuhe/Operations.cu:37-80) and
genIcrtByLevel (Operations.cu:107-134): the ring modulus is the m-th
cyclotomic polynomial, the NTT length twice the next power of two of its
degree (at least 8192), and the CRT primes the largest that keep a length-n
convolution of residues below the Goldilocks prime.  Host-side Python ints
and numpy only.
"""

from __future__ import annotations

import math
from functools import cached_property

import numpy as np

from .zp import P

# generator of the 2^16-th roots of unity mod P (cuhe/Base.cu:64-67)
NTT_GEN = 15893793146607301539


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for q in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % q == 0:
            return n == q
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _prev_prime(n: int) -> int:
    while not is_prime(n):
        n -= 1
    return n


def _mobius(n: int) -> int:
    out, k = 1, 2
    while k * k <= n:
        if n % k == 0:
            n //= k
            if n % k == 0:
                return 0
            out = -out
        k += 1
    return -out if n > 1 else out


def cyclotomic(m: int) -> list[int]:
    """Coefficients of the m-th cyclotomic polynomial, lowest first:
    prod over d | m of (x^(m/d) - 1)^mu(d)."""
    poly = [1]
    divs = [d for d in range(1, m + 1) if m % d == 0]
    for d in divs:
        if _mobius(d) == 1:  # times (x^k - 1)
            k = m // d
            out = [0] * (len(poly) + k)
            for i, c in enumerate(poly):
                out[i + k] += c
                out[i] -= c
            poly = out
    for d in divs:
        if _mobius(d) == -1:  # exact division by (x^k - 1)
            k = m // d
            rem = list(poly)
            q = [0] * (len(poly) - k)
            for i in range(len(poly) - 1, k - 1, -1):
                c = rem[i]
                if c:
                    q[i - k] = c
                    rem[i] = 0
                    rem[i - k] += c
            if any(rem):
                raise ArithmeticError("division by x^k - 1 not exact")
            poly = q
    while len(poly) > 1 and poly[-1] == 0:
        poly.pop()
    return poly


def int_words(v: int, words: int) -> list[int]:
    """v as `words` little-endian 32-bit words."""
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(words)]


class Ring:
    """One parameter set: CuDHS(d, p, w, min, cut, m)."""

    def __init__(self, depth, mod_msg, log_relin, log_min, log_cut, m):
        self.depth, self.mod_msg, self.w = depth, mod_msg, log_relin
        self.log_min, self.log_cut, self.m = log_min, log_cut, m
        self.poly_mod = cyclotomic(m)
        self.mod_len = len(self.poly_mod) - 1
        self.half = max(1 << (self.mod_len - 1).bit_length(), 8192)
        self.n = 2 * self.half
        self.log_max = log_min + log_cut * (depth - 1)
        self.num_eval_key = -(-self.log_max // log_relin)
        log_crt = math.isqrt(P // self.mod_len).bit_length()
        num = -(-log_min // log_crt)
        log_crt = 0
        while log_crt * num < log_min:
            log_crt += 1
        self.log_crt, self.pnum = log_crt, num + depth - 1
        self.primes = self._prime_chain()
        if self.half * max(self.primes) ** 2 >= P:
            raise ValueError("the primes are too large for an exact NTT")

    def _prime_chain(self) -> list[int]:
        pnum, depth, log_crt = self.pnum, self.depth, self.log_crt
        out = []
        logmid = self.log_min - (pnum - depth) * log_crt
        t = (1 << log_crt) - 1
        for _ in range(pnum - depth):
            t = _prev_prime(t)
            out.append(t)
            t -= 1
        tmid = _prev_prime((1 << logmid) - 1 if logmid != log_crt else t)
        out.append(tmid)
        if self.log_cut == logmid:
            t = tmid - 1
        elif self.log_cut == log_crt:
            t -= 1
        else:
            t = (1 << self.log_cut) - 1
        for _ in range(pnum - depth + 1, pnum):
            while not is_prime(t) or t % self.mod_msg != 1:
                t -= 1
            out.append(t)
            t -= 1
        return out

    # ---- per level ----
    def pn(self, lvl: int) -> int:
        return self.pnum - lvl

    def log_coeff(self, lvl: int) -> int:
        return self.log_max - lvl * self.log_cut

    def words(self, lvl: int) -> int:
        return max(-(-self.log_coeff(lvl) // 32), 1)

    def knum(self, lvl: int) -> int:
        return -(-self.log_coeff(lvl) // self.w)

    def q(self, lvl: int) -> int:
        return math.prod(self.primes[: self.pn(lvl)])

    def icrt(self, lvl: int):
        """(M, [M / p_i], [(M / p_i)^-1 mod p_i]) of the level."""
        q = self.q(lvl)
        ps = self.primes[: self.pn(lvl)]
        mi = [q // p for p in ps]
        return q, mi, [pow(v % p, -1, p) for v, p in zip(mi, ps)]

    def invp_last(self, lvl: int) -> list[int]:
        """p_t^-1 mod p_i for the kept primes, p_t the level's last."""
        ps = self.primes[: self.pn(lvl)]
        return [pow(ps[-1] % p, -1, p) for p in ps[:-1]]

    # ---- Barrett's polynomials, per prime ----
    @cached_property
    def _quotient(self) -> np.ndarray:
        """x^(2 mod_len - 1) div m(x) over the integers (m is monic)."""
        n = self.mod_len
        m = np.array(self.poly_mod, dtype=np.int64)
        r = np.zeros(2 * n, dtype=np.int64)
        r[2 * n - 1] = 1
        q = np.zeros(n, dtype=np.int64)
        for i in range(2 * n - 1, n - 1, -1):
            c = r[i]
            if c:
                if abs(int(c)) >= 1 << 40:
                    raise OverflowError("Barrett quotient out of int64 range")
                q[i - n] = c
                r[i - n: i + 1] -= c * m
        return q

    def barrett_polys(self) -> tuple[np.ndarray, np.ndarray]:
        """(u, m - x^mod_len) mod each prime, int64 [pnum, half]."""
        ps = np.array(self.primes, dtype=np.int64)[:, None]
        u = np.zeros((self.pnum, self.half), dtype=np.int64)
        u[:, : self.mod_len] = np.remainder(self._quotient[None, :], ps)
        mm = np.array(self.poly_mod[: self.mod_len], dtype=np.int64)
        mc = np.zeros((self.pnum, self.half), dtype=np.int64)
        mc[:, : self.mod_len] = np.remainder(mm[None, :], ps)
        return u, mc
