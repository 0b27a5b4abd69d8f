"""Plaintext slots of a cyclotomic ring mod 2, in plain numpy and PyTorch:
the decoding that turns a decrypted plaintext polynomial into its slots.

Phi_m(x) splits mod 2 into the minimal polynomials f_i of the primitive
m-th roots of unity in GF(2^d), d the order of 2 mod m, each of degree d;
slot i of a plaintext c(x) holds c mod f_i, a bit where the encoding put
one (DHS.cu:418-530), read as the constant coefficient.  The slots are in
the ascending order of the f_i as bit vectors (coefficient k at bit k).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def order_of_two(m: int) -> int:
    d, v = 1, 2 % m
    while v != 1:
        v = v * 2 % m
        d += 1
    return d


def _prime_factors(n: int) -> list[int]:
    out, k = [], 2
    while k * k <= n:
        if n % k == 0:
            out.append(k)
            while n % k == 0:
                n //= k
        k += 1
    return out + ([n] if n > 1 else [])


def _mulmod(a: int, b: int, f: int, d: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> d:
            a ^= f
    return r


def _powmod(a: int, e: int, f: int, d: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _mulmod(r, a, f, d)
        a = _mulmod(a, a, f, d)
        e >>= 1
    return r


def _field(d: int):
    """GF(2^d) as (modulus, exp table, log table) over a primitive
    element: the first (modulus, element) found with the group's order."""
    group = (1 << d) - 1
    qs = _prime_factors(group)
    for f in range((1 << d) + 1, 1 << (d + 1), 2):
        for g in (2, 3, 5, 6, 7):
            if _powmod(g, group, f, d) != 1:
                continue  # f is not irreducible, or g not in its group
            if all(_powmod(g, group // q, f, d) != 1 for q in qs):
                exp = np.zeros(2 * group, dtype=np.int64)
                x = 1
                for i in range(group):
                    exp[i] = x
                    x = _mulmod(x, g, f, d)
                if len(set(exp[:group].tolist())) != group:
                    continue  # not a field
                exp[group:] = exp[:group]
                log = np.zeros(1 << d, dtype=np.int64)
                log[exp[:group]] = np.arange(group)
                return exp, log
    raise ValueError(f"no field of degree {d} found")


def factors(m: int) -> list[int]:
    """The irreducible factors of Phi_m mod 2, ascending, as ints."""
    d = order_of_two(m)
    exp, log = _field(d)
    group = (1 << d) - 1
    step = group // m  # generator ** step has order m
    reps, seen = [], set()
    for s in range(1, m):
        if math.gcd(s, m) == 1 and s not in seen:
            reps.append(s)
            t = s
            while t not in seen:
                seen.add(t)
                t = t * 2 % m
    # the product of (x + root) over each coset, every coset at once
    coef = np.zeros((len(reps), d + 1), dtype=np.int64)  # GF(2^d) elements
    coef[:, 0] = 1
    for i in range(d):
        roots = exp[(np.array(reps) * pow(2, i, m) % m) * step % group]
        nxt = np.zeros_like(coef)
        nxt[:, 1:] = coef[:, :-1]
        nz = coef != 0
        prod = np.where(nz, exp[(log[coef] + log[roots][:, None]) % group], 0)
        coef = nxt ^ prod
    if ((coef != 0) & (coef != 1)).any():
        raise ArithmeticError("a coset's product is not over GF(2)")
    out = (coef << np.arange(d + 1)).sum(axis=1)
    return sorted(int(v) for v in out)


def decode_matrix(m: int, mod_len: int) -> np.ndarray:
    """T [slots, mod_len] (uint8): T[i, k] = constant coefficient of x^k
    mod f_i."""
    fs = np.array(factors(m), dtype=np.int64)
    d = order_of_two(m)
    t = np.zeros((mod_len, len(fs)), dtype=np.uint8)
    state = np.ones(len(fs), dtype=np.int64)
    for k in range(mod_len):
        t[k] = state & 1
        state = state << 1
        state ^= fs * ((state >> d) & 1)
    return np.ascontiguousarray(t.T)


def decode(bits: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """Plaintext coefficients mod 2, int64 [B, mod_len] -> slot bits
    [B, slots] (float32 products: the sums stay below 2^24)."""
    tt = torch.from_numpy(t).to(bits.device, torch.float32)
    s = bits.to(torch.float32) @ tt.T
    return torch.remainder(s.to(torch.int64), 2)
