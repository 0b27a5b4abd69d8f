"""Host-side exact integer / polynomial math for the PyTorch port.

The port's own copy of the parts of ``cuhe_tpu/hostmath.py`` that the gate
step needs: the Goldilocks prime and NTT generator, primality and the prime
search, Euler totient / Moebius, the cyclotomic ring modulus m(x), CRT
combination and the big-int <-> little-endian u32 word packing of the RAW
domain.  Everything is Python big-int + numpy; nothing here touches a device.
"""

from __future__ import annotations

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
    arr = np.frombuffer(bytes(buf), dtype="<u4").reshape(n, words)
    return np.ascontiguousarray(arr.T)


def words_to_ints(arr: np.ndarray) -> list[int]:
    """Inverse of ints_to_words: planar uint32 [words, n] -> list of ints."""
    w, n = arr.shape
    flat = np.ascontiguousarray(arr.T.astype("<u4")).tobytes()
    nbytes = w * 4
    return [int.from_bytes(flat[i * nbytes : (i + 1) * nbytes], "little")
            for i in range(n)]
