"""DHS decryption, the eval keys' relation to the secret key, and plaintext
arithmetic in plain code, to judge what a homomorphic circuit's ciphertexts
and keys say.

Decryption (examples/DHS/DHS.cu:254-270): t = c sk mod (m(x), q_lvl), each
coefficient centred about q_lvl, then reduced mod the message modulus.  A
plaintext product is the product of 0/1 polynomials mod (m(x), 2), on
Python ints used as bit vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gate, ntt, zp
from .gate import Tables
from .ring import int_words


def int_words_tensor(coeffs, words: int, length: int, device):
    """Non-negative ints -> int64 32-bit words [words, length]."""
    buf = b"".join(int(c).to_bytes(4 * words, "little") for c in coeffs)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(coeffs), words)
    full = np.zeros((words, length), dtype=np.int64)
    full[:, : len(coeffs)] = arr.T
    return torch.from_numpy(full).to(device)


def ints_to_ntt(polys, t: Tables, lvl: int, device):
    """Polynomials as ints in [0, q_lvl), lowest coefficient first ->
    NTT-domain pairs [B, pn, n]: the RAW -> CRT -> NTT conversion."""
    ring = t.ring
    raw = torch.stack([int_words_tensor(c, ring.words(lvl), ring.half,
                                        device) for c in polys])
    return ntt.forward(gate.residues(raw, t, lvl), ring.n)


def centred_mod(words: torch.Tensor, q: int, mod: int) -> torch.Tensor:
    """Coefficients c in [0, q) as int64 32-bit words [.., W, L] -> the
    centred c (c - q above (q - 1) / 2) mod `mod`, int64 [.., L]."""
    nw = words.shape[-2]
    r = torch.zeros_like(words[..., 0, :])
    for k in range(nw):  # c mod `mod`, word by word
        r = torch.remainder(r + torch.remainder(words[..., k, :], mod)
                            * pow(2, 32 * k, mod), mod)
    half = int_words((q - 1) // 2, nw)
    above = torch.zeros_like(r, dtype=torch.bool)
    equal = torch.ones_like(above)
    for k in range(nw - 1, -1, -1):  # c > (q - 1) / 2, most significant first
        above |= equal & (words[..., k, :] > half[k])
        equal &= words[..., k, :] == half[k]
    return torch.where(above, torch.remainder(r - q % mod, mod), r)


def eval_key_errors(ek, sk, t: Tables, w: int, mod_msg: int,
                    block: int = 8) -> int:
    """Coefficients at which the eval keys break their relation to the
    secret key.  genEk (DHS.cu:340-362) makes ek_i = pk s_i + p e_i +
    2^(w i) sk with pk = p g sk^-1, so sk ek_i - 2^(w i) sk^2 = p (g s_i +
    sk e_i) mod (m(x), q_0): every coefficient, centred, a multiple of the
    message modulus p.  ek: NTT-domain pair [num_eval_key, pnum, n] at
    level 0; sk: the secret key's ints mod q_0."""
    ring = t.ring
    pn, nk = t.pn(0), ek[0].shape[0]
    dev = ek[0].device
    s = ntt.forward(residues_of_ints(sk, t, 0, dev), ring.n)
    sk2 = gate.product_to_crt(zp.mul(s, s), t, 0)
    p = t.primes[:pn, None]
    bad = 0
    for b in range(0, nk, block):
        keys = range(b, min(b + block, nk))
        prod = gate.product_to_crt(
            zp.mul(tuple(v[keys.start: keys.stop] for v in ek), s), t, 0)
        tw = torch.tensor([[pow(2, w * i, pr) for pr in ring.primes[:pn]]
                           for i in keys], dtype=torch.int64, device=dev)
        diff = torch.remainder(prod - torch.remainder(sk2 * tw[..., None], p),
                               p)
        words = gate.icrt(diff, t, 0)
        bad += int((centred_mod(words, ring.q(0), mod_msg) != 0).sum())
    return bad


def residues_of_ints(coeffs, t: Tables, lvl: int, device) -> torch.Tensor:
    """Ints (coefficients, lowest first) -> residues int64 [pn, n/2]."""
    out = torch.zeros((t.pn(lvl), t.ring.half), dtype=torch.int64)
    for i, p in enumerate(t.ring.primes[: t.pn(lvl)]):
        out[i, : len(coeffs)] = torch.tensor([int(c) % p for c in coeffs],
                                             dtype=torch.int64)
    return out.to(device)


def decrypt(ct: torch.Tensor, sk, t: Tables, lvl: int, mod_msg: int,
            count: int | None = None) -> list[list[int]]:
    """Residues int64 [B, pn, n/2] of B ciphertexts at lvl, and the secret
    key's coefficients -> the first `count` (all mod_len by default)
    plaintext coefficients of each."""
    ring, n = t.ring, t.ring.n
    count = ring.mod_len if count is None else count
    skr = residues_of_ints(sk, t, lvl, ct.device)
    prod = zp.mul(ntt.forward(ct, n), ntt.forward(skr, n))
    words = gate.icrt(gate.product_to_crt(prod, t, lvl), t, lvl)
    words = words[..., :count].cpu().tolist()  # [B][words][count]
    q = ring.q(lvl)
    out = []
    for w in words:
        row = []
        for j in range(count):
            v = sum(int(w[k][j]) << (32 * k) for k in range(len(w)))
            row.append((v - q if v > (q - 1) // 2 else v) % mod_msg)
        out.append(row)
    return out


def poly_bits(coeffs) -> int:
    """A 0/1 polynomial as an int, coefficient i at bit i."""
    v = 0
    for i, c in enumerate(coeffs):
        if int(c) & 1:
            v |= 1 << i
    return v


def gf2_mulmod(a: int, b: int, m_bits: int) -> int:
    """a b mod m(x) over GF(2), polynomials as bit vectors."""
    prod, i = 0, 0
    while b >> i:
        if (b >> i) & 1:
            prod ^= a << i
        i += 1
    deg = m_bits.bit_length() - 1
    for k in range(prod.bit_length() - 1, deg - 1, -1):
        if (prod >> k) & 1:
            prod ^= m_bits << (k - deg)
    return prod
