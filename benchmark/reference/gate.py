"""cuHE's homomorphic gate, AND -> relinearize -> modulus switch, in plain
PyTorch: the reference that the port's gate step is held against.

The steps (cuhe/CuHE.cu:101, 543-581; Relinearization.cu:43-88;
Operations.cu:460-504, Base.cu:927-1001):

  1. AND: the product of the NTT-domain operands, mod P.
  2. Inverse NTT, each plane reduced mod its prime: the residues of the
     product polynomial, degree up to 2 mod_len - 2.
  3. Polynomial Barrett reduction mod m(x), with u = x^(2 mod_len - 1) div m
     and m - x^mod_len in the NTT domain, and cuHE's closing subtracts.
  4. ICRT: the residues -> each coefficient in [0, q) as 32-bit words.
  5. Relinearization: the w-bit digits of the coefficients, their forward
     NTTs, and the sum over digits of digit times eval key, plane by plane.
  6. Inverse NTT mod each prime and Barrett again.
  7. Modulus switch: the level's last prime dropped, cuHE's rounding of the
     dropped residue to a multiple of the message modulus.

Every table comes from `ring.Ring`; nothing is taken from the program under
test.  Arrays are int64 word values; pairs are (lo, hi).
"""

from __future__ import annotations

import torch

from . import ntt, zp
from .ring import Ring, int_words


class Tables:
    """A ring's per-level constants on one device."""

    def __init__(self, ring: Ring, device):
        self.ring, self.device = ring, torch.device(device)
        n = ring.n
        u, mc = ring.barrett_polys()
        self.primes = torch.tensor(ring.primes, dtype=torch.int64,
                                   device=self.device)
        self.m_crt = torch.from_numpy(mc).to(self.device)
        self.u_ntt = ntt.forward(torch.from_numpy(u).to(self.device), n)
        self.m_ntt = ntt.forward(self.m_crt, n)

    def pn(self, lvl):
        return self.ring.pn(lvl)


def _sub_mod(a, b, p):
    return torch.remainder(a - b, p)


def barrett(f: torch.Tensor, t: Tables, lvl: int) -> torch.Tensor:
    """Residues [.., pn, n] of a product -> residues [.., pn, n/2] mod
    m(x)."""
    ring, n, half = t.ring, t.ring.n, t.ring.half
    N, pn = ring.mod_len, t.pn(lvl)
    p = t.primes[:pn, None]
    u = tuple(v[:pn] for v in t.u_ntt)
    mn = tuple(v[:pn] for v in t.m_ntt)
    # quotient estimate: ((f >> (N - 1)) u) >> N, and its product with
    # m - x^N
    c1 = ntt.inverse_mod(zp.mul(ntt.forward(f[..., N - 1: N - 1 + half], n),
                                u), n, t.primes[:pn])
    c2 = ntt.inverse_mod(zp.mul(ntt.forward(c1[..., N: N + half], n), mn),
                         n, t.primes[:pn])
    idx = torch.arange(n, device=f.device)
    high = (idx >= N) & (idx < 2 * N)
    r = torch.where(high, _sub_mod(f, torch.where(idx >= N, c1, 0), p), f)
    r = _sub_mod(r, c2, p)
    # cuHE's last step: where coefficient x^N is left nonzero, subtract
    # m - x^N once more below x^(N - 1)
    mc = torch.zeros((pn, n), dtype=torch.int64, device=f.device)
    mc[:, :half] = t.m_crt[:pn]
    take = (r[..., N: N + 1] > 0) & (idx < N - 1)
    r = torch.where(take, _sub_mod(r, mc, p), r)
    return r[..., :half]


def icrt(x: torch.Tensor, t: Tables, lvl: int) -> torch.Tensor:
    """Residues [.., pn, L] -> coefficients in [0, q) as int64 32-bit words
    [.., words, L]."""
    q, mi, bi = t.ring.icrt(lvl)
    words = t.ring.words(lvl)
    qw = int_words(q, words)
    s = [torch.zeros_like(x[..., 0, :]) for _ in range(words)]
    for i, p in enumerate(t.ring.primes[: t.pn(lvl)]):
        # y_i = x_i b_i mod p_i (b_i < 2^32 split in halves: no overflow)
        y = torch.remainder(x[..., i, :] * (bi[i] >> 16), p)
        y = torch.remainder((y << 16) + x[..., i, :] * (bi[i] & 0xFFFF), p)
        carry = torch.zeros_like(y)
        for k, mw in enumerate(int_words(mi[i], words)):
            v = s[k] + y * mw + carry
            s[k], carry = v & zp.M32, v >> 32
        # s < 2 q: subtract q where s >= q
        borrow = torch.zeros_like(y)
        d = []
        for k in range(words):
            v = s[k] - qw[k] - borrow
            d.append(v & zp.M32)
            borrow = (v < 0).to(torch.int64)
        ge = (borrow == 0) | (carry > 0)
        s = [torch.where(ge, dk, sk) for dk, sk in zip(d, s)]
    return torch.stack(s, dim=-2)


def digit(raw: torch.Tensor, w: int, j: int) -> torch.Tensor:
    """floor(c / 2^(w j)) mod 2^w of each coefficient c of RAW words
    [.., words, L]."""
    words = raw.shape[-2]
    k, sh = divmod(w * j, 32)
    if k >= words:
        return torch.zeros_like(raw[..., 0, :])
    v = raw[..., k, :] >> sh
    if sh + w > 32 and k + 1 < words:
        v = v | (raw[..., k + 1, :] << (32 - sh))
    return v & ((1 << w) - 1)


def relinearize(raw: torch.Tensor, ek, t: Tables, lvl: int):
    """RAW words [B, words, n/2] -> NTT-domain pair [B, pn, n]: the sum over
    the level's digits of NTT(digit) times the eval key, mod P.  ek: int64
    pair [num_eval_key, pnum, n], mat-linear."""
    ring, pn = t.ring, t.pn(lvl)
    knum = ring.knum(lvl)
    d = ntt.forward(torch.stack([digit(raw, ring.w, j)
                                 for j in range(knum)]), ring.n)
    acc = None
    for j in range(knum):  # [B, 1, n] times [1, pn, n]
        term = zp.mul(tuple(v[j][:, None, :] for v in d),
                      tuple(v[j, :pn][None] for v in ek))
        acc = term if acc is None else zp.add(acc, term)
    return acc


def mod_switch(x: torch.Tensor, t: Tables, lvl: int, mod_msg: int):
    """Residues [.., pn, L] at lvl -> [.., pn - 1, L] at lvl + 1."""
    pn = t.pn(lvl)
    pt = t.ring.primes[pn - 1]
    p = t.primes[: pn - 1, None]
    inv = torch.tensor(t.ring.invp_last(lvl), dtype=torch.int64,
                       device=x.device)[:, None]
    d = x[..., pn - 1, :]
    ep = torch.remainder(d, mod_msg)
    moved = torch.where(d > (pt - 1) // 2, d - ep * pt, d + ep * pt)
    d = torch.where(ep != 0, moved, d)
    diff = torch.remainder(x[..., : pn - 1, :] - d[..., None, :], p)
    # diff * inv mod p with inv split in halves
    r = torch.remainder(diff * (inv >> 16), p)
    return torch.remainder((r << 16) + diff * (inv & 0xFFFF), p)


def product_to_crt(prod, t: Tables, lvl: int) -> torch.Tensor:
    """NTT-domain product pair [.., pn, n] -> residues [.., pn, n/2] of the
    product mod m(x)."""
    return barrett(ntt.inverse_mod(prod, t.ring.n, t.primes[: t.pn(lvl)]),
                   t, lvl)


def gate(a, b, ek, t: Tables, lvl: int, mod_msg: int) -> torch.Tensor:
    """mod_switch(relin(a AND b)) of NTT-domain pairs [B, pn, n] at lvl:
    int64 residues [B, pn - 1, n/2] at lvl + 1."""
    raw = icrt(product_to_crt(zp.mul(a, b), t, lvl), t, lvl)
    r = relinearize(raw, ek, t, lvl)
    return mod_switch(product_to_crt(r, t, lvl), t, lvl, mod_msg)


def residues(raw: torch.Tensor, t: Tables, lvl: int) -> torch.Tensor:
    """RAW words [.., words, L] -> residues [.., pn, L] mod each prime of
    the level (Horner over the words, most significant first)."""
    p = t.primes[: t.pn(lvl), None]
    r = torch.zeros(raw.shape[:-2] + (t.pn(lvl), raw.shape[-1]),
                    dtype=torch.int64, device=raw.device)
    for k in range(raw.shape[-2] - 1, -1, -1):
        w = raw[..., k, :].unsqueeze(-2)
        r = torch.remainder((r << 16) | (w >> 16), p)
        r = torch.remainder((r << 16) | (w & 0xFFFF), p)
    return r
