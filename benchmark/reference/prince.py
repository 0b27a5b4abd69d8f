"""The PRINCE block cipher (Borghoff et al., "PRINCE - A Low-latency Block
Cipher for Pervasive Computing Applications", ASIACRYPT 2012) on plain
64-bit integers.

A state is an int; nibble 0 is its most significant.  `encrypt(m, k0, k1)`
is the published cipher.  `layers` stops it right after that many S-box
layers (12 in all), for comparison with a homomorphic circuit cut short.
"""

from __future__ import annotations

SBOX = [0xB, 0xF, 0x3, 0x2, 0xA, 0xC, 0x9, 0x1,
        0x6, 0x7, 0x8, 0x0, 0xE, 0x5, 0xD, 0x4]
SBOX_INV = [SBOX.index(i) for i in range(16)]
RC = [0x0000000000000000, 0x13198A2E03707344, 0xA4093822299F31D0,
      0x082EFA98EC4E6C89, 0x452821E638D01377, 0xBE5466CF34E90C6C,
      0x7EF84F78FD955CB1, 0x85840851F1AC43AA, 0xC882D32F25323C54,
      0x64A51195E0E3610D, 0xD3B5A399CA0C2399, 0xC0AC29B7C97C50DD]
MASK = (1 << 64) - 1
# ShiftRows on nibbles: output nibble i is input nibble SR[i]
SR = [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11]
SR_INV = [SR.index(i) for i in range(16)]


def _sub(s: int, box) -> int:
    out = 0
    for i in range(16):
        out |= box[(s >> (60 - 4 * i)) & 0xF] << (60 - 4 * i)
    return out


def _perm(s: int, perm) -> int:
    out = 0
    for i in range(16):
        out |= ((s >> (60 - 4 * perm[i])) & 0xF) << (60 - 4 * i)
    return out


def _m_hat(first: int) -> list[list[int]]:
    """The 16 x 16 bit matrix M^(first): 4 x 4 blocks M_((first + r + c)
    mod 4), where M_k is the 4 x 4 identity with row k cleared."""
    rows = []
    for br in range(4):
        for r in range(4):
            row = []
            for bc in range(4):
                k = (first + br + bc) % 4
                row += [1 if (c == r and r != k) else 0 for c in range(4)]
            rows.append(row)
    return rows


_M_PRIME = [_m_hat(0), _m_hat(1), _m_hat(1), _m_hat(0)]


def _m_prime(s: int) -> int:
    """M' = diag(M^(0), M^(1), M^(1), M^(0)) on the 64 bits, bit 0 the most
    significant."""
    bits = [(s >> (63 - i)) & 1 for i in range(64)]
    out = 0
    for blk, mat in enumerate(_M_PRIME):
        x = bits[16 * blk: 16 * blk + 16]
        for r in range(16):
            v = 0
            for c in range(16):
                v ^= mat[r][c] & x[c]
            out |= v << (63 - (16 * blk + r))
    return out


def encrypt(m: int, k0: int, k1: int, layers: int = 12) -> int:
    """PRINCE_k0||k1(m), or, for layers < 12, the state right after S-box
    layer `layers`."""
    stop = layers if layers < 12 else None
    done = 0
    s = m ^ k0 ^ k1 ^ RC[0]
    for i in range(1, 6):
        s = _sub(s, SBOX)
        done += 1
        if done == stop:
            return s
        s = _perm(_m_prime(s), SR) ^ RC[i] ^ k1
    s = _sub(s, SBOX)
    done += 1
    if done == stop:
        return s
    s = _sub(_m_prime(s), SBOX_INV)
    done += 1
    if done == stop:
        return s
    for i in range(6, 11):
        s ^= k1 ^ RC[i]
        s = _sub(_m_prime(_perm(s, SR_INV)), SBOX_INV)
        done += 1
        if done == stop:
            return s
    k0p = ((k0 >> 1) | ((k0 & 1) << 63)) ^ (k0 >> 63)
    return s ^ RC[11] ^ k1 ^ k0p


def to_bits(v: int) -> list[int]:
    """64 bits, the most significant first."""
    return [(v >> (63 - i)) & 1 for i in range(64)]


def from_bits(bits) -> int:
    out = 0
    for b in bits:
        out = (out << 1) | (int(b) & 1)
    return out
