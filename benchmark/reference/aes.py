"""AES-128 (FIPS-197) in plain numpy, on many blocks at once: the cipher
that the homomorphic circuit is held to, slot by slot.

The S-box is built from its definition (the inverse in GF(2^8) mod x^8 +
x^4 + x^3 + x + 1, then the affine map with 0x63), the key schedule from
section 5.2; a state is uint8 [B, 16] in the standard's byte order
(column-major: byte 4 c + r is row r of column c).
"""

from __future__ import annotations

import numpy as np


def gf_mul(a: int, b: int) -> int:
    """a b in GF(2^8) mod x^8 + x^4 + x^3 + x + 1."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


def _sbox() -> np.ndarray:
    inv = [0] * 256
    for a in range(1, 256):
        inv[a] = next(b for b in range(1, 256) if gf_mul(a, b) == 1)
    out = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        x, y = inv[a], 0
        for i in range(8):
            bit = (x >> i) ^ (x >> ((i + 4) % 8)) ^ (x >> ((i + 5) % 8)) ^ \
                (x >> ((i + 6) % 8)) ^ (x >> ((i + 7) % 8)) ^ (0x63 >> i)
            y |= (bit & 1) << i
        out[a] = y
    return out


SBOX = _sbox()
XTIME = np.array([gf_mul(a, 2) for a in range(256)], dtype=np.uint8)


def expand_key(key: bytes) -> np.ndarray:
    """The 11 round keys of a 16-byte key, uint8 [11, 16]."""
    w = [list(key[4 * i: 4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [int(SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = gf_mul(rcon, 2)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.array(w, dtype=np.uint8).reshape(11, 16)


def sub_bytes(s: np.ndarray) -> np.ndarray:
    return SBOX[s]


def shift_rows(s: np.ndarray) -> np.ndarray:
    """Row r of the state rotated left by r columns."""
    idx = [4 * ((c + r) % 4) + r for c in range(4) for r in range(4)]
    return s[:, idx]


def mix_columns(s: np.ndarray) -> np.ndarray:
    out = np.empty_like(s)
    for c in range(4):
        a = [s[:, 4 * c + r] for r in range(4)]
        for r in range(4):
            a0, a1, a2, a3 = (a[(r + k) % 4] for k in range(4))
            out[:, 4 * c + r] = XTIME[a0] ^ XTIME[a1] ^ a1 ^ a2 ^ a3
    return out


def encrypt(blocks: np.ndarray, key: bytes, rounds: int = 10) -> np.ndarray:
    """AES-128 of uint8 blocks [B, 16], cut to `rounds` rounds (the last
    without MixColumns, the standard's form for 10)."""
    keys = expand_key(key)
    s = np.asarray(blocks, dtype=np.uint8) ^ keys[0]
    for r in range(1, rounds + 1):
        s = shift_rows(sub_bytes(s))
        if r < rounds:
            s = mix_columns(s)
        s = s ^ keys[r]
    return s
