"""Host-side exact integer / polynomial math for the PyTorch port.

The port's own copy of ``cuhe_tpu/hostmath.py`` without its optional native
library: the Goldilocks prime and NTT generator, primality and the prime
search, Euler totient / Moebius, the cyclotomic ring modulus m(x), the
polynomial inverse mod (m(x), p) by extended Euclid (keygen), CRT
combination, the big-int <-> little-endian u32 word packing of the RAW
domain, and the GF(2) / GF(2^d) tools of the DHS Batcher.  Everything is
Python big-int + numpy; nothing here touches a device.
"""

from __future__ import annotations

from functools import lru_cache as _lru_cache

import numpy as np

# The NTT-friendly "Goldilocks" prime P = 2^64 - 2^32 + 1 (reference ModP.h:34).
P = 0xFFFFFFFF00000001
# Generator of the 2^16-th roots of unity used by all NTT tables (Base.cu:65).
NTT_GEN = 15893793146607301539

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53)

# Deterministic Miller-Rabin witness set, valid for all n < 3.3e24 (> 2^64).
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic primality test for n < 2^81."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def prev_prime(n: int) -> int:
    """Largest prime <= n (the descending search of Operations.cu:44)."""
    while not is_prime(n):
        n -= 1
    return n


def factorize(n: int) -> dict[int, int]:
    """Trial-division factorisation (fine for the small ring indices used)."""
    fac: dict[int, int] = {}
    d = 2
    while d * d <= n:
        while n % d == 0:
            fac[d] = fac.get(d, 0) + 1
            n //= d
        d += 1
    if n > 1:
        fac[n] = fac.get(n, 0) + 1
    return fac


def euler_totient(n: int) -> int:
    """phi(n) (reference Parameters.cu:34-51)."""
    if n < 3:
        return n
    res = n
    for p in factorize(n):
        res = res // p * (p - 1)
    return res


def mobius(n: int) -> int:
    """Moebius function (reference DHS.cu:394-416)."""
    if n == 1:
        return 1
    fac = factorize(n)
    if any(e > 1 for e in fac.values()):
        return 0
    return -1 if len(fac) % 2 else 1


def modinv(a: int, m: int) -> int:
    return pow(a, -1, m)


def poly_mul_sparse_cyclo(coeffs: np.ndarray, k: int) -> np.ndarray:
    """Multiply poly by (x^k - 1)."""
    out = np.zeros(len(coeffs) + k, dtype=object)
    out[k:] += coeffs
    out[: len(coeffs)] -= coeffs
    return out


def poly_div_sparse_cyclo(coeffs: np.ndarray, k: int) -> np.ndarray:
    """Exact division of poly by (x^k - 1)."""
    n = len(coeffs) - 1
    while n >= 0 and coeffs[n] == 0:
        n -= 1
    if n < k - 1:
        if n < 0:
            return np.zeros(1, dtype=object)
        raise ValueError("division by (x^k - 1) not exact")
    r = coeffs.astype(object).copy()
    q = np.zeros(n - k + 1, dtype=object)
    for i in range(n, k - 1, -1):
        c = r[i]
        if c != 0:
            q[i - k] = c
            r[i] = 0
            r[i - k] += c
    if any(x != 0 for x in r):
        raise ValueError("division by (x^k - 1) not exact")
    return q


def gen_poly_mod(m: int) -> list[int]:
    """The ring modulus m(x) = prod_{d|m} (x^{m/d} - 1)^{mu(d)}.

    Mirrors genPolyMod_ (examples/DHS/DHS.cu:280-305): all mu=+1 factors are
    multiplied first, then all mu=-1 factors divided out.
    """
    poly = np.ones(1, dtype=object)
    divs = [d for d in range(1, m + 1) if m % d == 0]
    for d in divs:
        if mobius(d) == 1:
            poly = poly_mul_sparse_cyclo(poly, m // d)
    for d in divs:
        if mobius(d) == -1:
            poly = poly_div_sparse_cyclo(poly, m // d)
    out = [int(c) for c in poly]
    while len(out) > 1 and out[-1] == 0:
        out.pop()
    return out


# ---------------------------------------------------------------------------
# Polynomial arithmetic over Z_p[x] with numpy int64 (p < 2^26 so products of
# residues fit comfortably in int64).
# ---------------------------------------------------------------------------

def _np_poly_trim(a: np.ndarray) -> np.ndarray:
    n = len(a)
    while n > 1 and a[n - 1] == 0:
        n -= 1
    return a[:n]


def poly_xgcd_mod_p(f: np.ndarray, m: np.ndarray, p: int):
    """Inverse of f modulo (m(x), p) via extended Euclid over Z_p[x].

    Returns int64 numpy array inv with f*inv = 1 mod (m, p), or None if f is
    not invertible.  Replaces NTL ZZ_pE inv (examples/DHS/DHS.cu:377-393); the
    per-step elimination is vectorised in numpy (int64 is safe: p < 2^31 and
    each step multiplies residues < p).
    """
    f = _np_poly_trim(np.asarray(f, dtype=np.int64) % p)
    m = _np_poly_trim(np.asarray(m, dtype=np.int64) % p)
    # Euclid on (r0, r1) while tracking only the f-cofactor (s0, s1):
    # r = s * f (mod m), starting from r0 = m (s0 = 0), r1 = f (s1 = 1).
    n = len(m)
    r0, r1 = m.copy(), f.copy()
    s0 = np.zeros(n, dtype=np.int64)
    s1 = np.zeros(n, dtype=np.int64)
    s1[0] = 1
    d0, d1 = len(r0) - 1, len(r1) - 1
    r0 = np.concatenate([r0, np.zeros(n + 1 - len(r0), dtype=np.int64)])
    r1 = np.concatenate([r1, np.zeros(n + 1 - len(r1), dtype=np.int64)])
    while d1 > 0 or (d1 == 0 and r1[0] == 0):
        if d1 < 0 or (d1 == 0 and r1[0] == 0):
            return None  # gcd != const
        lc1 = int(r1[d1])
        if lc1 == 0:
            while d1 >= 0 and r1[d1] == 0:
                d1 -= 1
            continue
        try:
            inv_lc1 = modinv(lc1, p)
        except ValueError:
            return None  # p not prime or degenerate; caller resamples
        while d0 >= d1:
            lc0 = int(r0[d0])
            if lc0 != 0:
                c = (lc0 * inv_lc1) % p
                k = d0 - d1
                # r0 -= c * x^k * r1 ; s0 -= c * x^k * s1  (mod p)
                r0[k : d1 + k + 1] = (r0[k : d1 + k + 1] - c * r1[: d1 + 1]) % p
                sh = n - k
                s0[k:] = (s0[k:] - c * s1[:sh]) % p
            d0 -= 1
        # swap
        r0, r1 = r1, r0
        s0, s1 = s1, s0
        d0, d1 = d1, d0
        while d1 >= 0 and r1[d1] == 0:
            d1 -= 1
    if d1 < 0:
        return None
    c = int(r1[0])
    if c == 0:
        return None
    try:
        cinv = modinv(c, p)
    except ValueError:
        return None
    return (s1 * cinv) % p


# ---------------------------------------------------------------------------
# CRT combination and the RAW word packing (replaces NTL BytesFromZZ /
# ZZFromBytes, CuHE.cu:317-348)
# ---------------------------------------------------------------------------

def crt_combine(residues: list[int], primes: list[int]) -> int:
    """x = sum_i ((x_i * b_i mod p_i) * M/p_i) mod M."""
    M = 1
    for p in primes:
        M *= p
    x = 0
    for xi, p in zip(residues, primes):
        mi = M // p
        bi = modinv(mi % p, p)
        x += (xi * bi % p) * mi
    return x % M


def ints_to_words(coeffs: list[int], words: int, length: int | None = None) -> np.ndarray:
    """Pack non-negative ints into a planar uint32 array [words, len]."""
    n = len(coeffs) if length is None else length
    nbytes = words * 4
    buf = bytearray(n * nbytes)
    for i, c in enumerate(coeffs):
        if i >= n:
            break
        buf[i * nbytes : (i + 1) * nbytes] = int(c).to_bytes(nbytes, "little")
    # over the bytearray itself, so the result is writable (torch.from_numpy)
    arr = np.frombuffer(buf, dtype="<u4").reshape(n, words)
    return np.ascontiguousarray(arr.T)


def words_to_ints(arr: np.ndarray) -> list[int]:
    """Inverse of ints_to_words: planar uint32 [words, n] -> list of ints."""
    w, n = arr.shape
    flat = np.ascontiguousarray(arr.T.astype("<u4")).tobytes()
    nbytes = w * 4
    return [int.from_bytes(flat[i * nbytes : (i + 1) * nbytes], "little")
            for i in range(n)]


# ---------------------------------------------------------------------------
# GF(2) polynomial helpers (ints as bit-vectors).  Used by the Batcher
# (examples/DHS/DHS.cu:418-530) replacement in dhs.py.
# ---------------------------------------------------------------------------

def gf2_mul(a: int, b: int) -> int:
    """Carry-less multiply of GF(2) polys encoded as ints."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        b >>= 1
    return r


def gf2_deg(a: int) -> int:
    return a.bit_length() - 1


def gf2_mod(a: int, m: int) -> int:
    dm = gf2_deg(m)
    while True:
        da = gf2_deg(a)
        if da < dm:
            return a
        a ^= m << (da - dm)


def gf2_divmod(a: int, m: int) -> tuple[int, int]:
    dm = gf2_deg(m)
    q = 0
    while True:
        da = gf2_deg(a)
        if da < dm:
            return q, a
        q ^= 1 << (da - dm)
        a ^= m << (da - dm)


def gf2_xgcd(a: int, b: int):
    """Extended GCD over GF(2)[x]: returns (g, u, v) with u*a ^ v*b = g."""
    r0, r1 = a, b
    s0, s1 = 1, 0
    t0, t1 = 0, 1
    while r1:
        q, r = gf2_divmod(r0, r1)
        r0, r1 = r1, r
        s0, s1 = s1, s0 ^ gf2_mul(q, s1)
        t0, t1 = t1, t0 ^ gf2_mul(q, t1)
    return r0, s0, t0


def gf2_inv_mod(a: int, m: int) -> int:
    g, u, _ = gf2_xgcd(gf2_mod(a, m), m)
    if g != 1:
        raise ValueError("not invertible")
    return gf2_mod(u, m)


def gf2_powmod(base: int, e: int, f: int) -> int:
    """base^e mod f over GF(2)[x] by square-and-multiply."""
    r = 1
    base = gf2_mod(base, f)
    while e:
        if e & 1:
            r = gf2_mod(gf2_mul(r, base), f)
        base = gf2_mod(gf2_mul(base, base), f)
        e >>= 1
    return r


def gf2_irreducible(f: int, d: int) -> bool:
    """Rabin test: f (degree d) irreducible over GF(2)?"""
    # x^(2^d) == x mod f
    if gf2_powmod(2, 1 << d, f) != 2:
        return False
    # gcd(x^(2^(d/q)) - x, f) == 1 for every prime q | d
    for q in factorize(d):
        h = gf2_powmod(2, 1 << (d // q), f) ^ 2
        if gf2_xgcd(h, f)[0] != 1:
            return False
    return True


@_lru_cache(maxsize=None)
def primitive_poly(d: int) -> int:
    """Smallest primitive polynomial of degree d over GF(2).

    The reference finds the Batcher's factors by trial division over all
    degree-d binary polynomials (examples/DHS/DHS.cu:439-459); here GF(2^d)
    is built once from a primitive polynomial, for any d.  Primitivity = irreducible + ord(x) == 2^d - 1 (checked against every
    prime factor of the group order).
    """
    group = (1 << d) - 1
    qs = list(factorize(group))
    for f in range((1 << d) | 1, 1 << (d + 1), 2):
        if not gf2_irreducible(f, d):
            continue
        if all(gf2_powmod(2, group // q, f) != 1 for q in qs):
            return f
    raise ValueError(f"no primitive polynomial of degree {d}")  # unreachable


class GF2e:
    """GF(2^d) via log/antilog tables over a primitive polynomial."""

    # known primitive polynomials (fast path); any other degree is generated
    # at runtime by primitive_poly()
    PRIM = {13: (1 << 13) | 0b11011, 16: (1 << 16) | (1 << 12) | 0b1011}

    def __init__(self, d: int):
        self.d = d
        self.poly = self.PRIM.get(d) or primitive_poly(d)
        size = 1 << d
        exp = np.zeros(2 * size, dtype=np.int64)
        log = np.zeros(size, dtype=np.int64)
        x = 1
        for i in range(size - 1):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & size:
                x ^= self.poly
        if x != 1:
            raise ValueError("polynomial not primitive")
        exp[size - 1 : 2 * (size - 1)] = exp[: size - 1]
        self.exp, self.log = exp, log
        self.order = size - 1

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def pow_gen(self, e: int) -> int:
        """Generator ** e."""
        return int(self.exp[e % self.order])

    def minpoly_of_coset(self, coset_exps: list[int], gen_exp: int) -> int:
        """prod_{j in coset} (x - g^{gen_exp * j}) over GF(2^d) -> GF(2) poly int.

        All coefficients of the product land in GF(2) when the coset is closed
        under Frobenius (multiplication by 2 mod group order).
        """
        # poly coeffs in GF(2^d), ascending; start with 1
        coeffs = [1]
        for j in coset_exps:
            root = self.pow_gen(gen_exp * j)
            # multiply by (x + root)  (char 2: minus == plus)
            nxt = [0] * (len(coeffs) + 1)
            for i, c in enumerate(coeffs):
                nxt[i + 1] ^= c
                nxt[i] ^= self.mul(c, root)
            coeffs = nxt
        out = 0
        for i, c in enumerate(coeffs):
            if c not in (0, 1):
                raise ValueError("coset product not in GF(2)")
            out |= c << i
        return out
