"""Homomorphic AES-128's circuit (cuhe_tpu_torch/models/aes.py) on plain
bits, and its linear layers on ciphertext words, on the CPU:

  * Boyar and Peralta's S-box circuit is the AES S-box for all 256 inputs,
    with 34 ANDs at AND-depth 4, batched 9 / 3 / 4 / 18 by AND-depth;
  * the whole cipher, run on plain bits through the same schedule, is the
    plain reference (benchmark/reference/aes.py) on FIPS-197's vectors and
    on seeded random blocks and keys, at 10 rounds and cut shorter;
  * the reference holds to FIPS-197 (appendices B and C.1);
  * ShiftRows, MixColumns and AddRoundKey on CRT ciphertexts are the same
    sums mod each prime, row for row, as the plain layers' GF(2) sums.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import aes as ref
from benchmark.reference import aes_sbox as ref_sbox
from cuhe_tpu_torch.context import Context
from cuhe_tpu_torch.models import aes
from cuhe_tpu_torch.params import make_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIPS = [  # (key, plaintext, ciphertext): FIPS-197 appendices B and C.1
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
]


def _gf_sbox():
    """The S-box from its definition: GF(2^8) inverse, then the affine
    map."""
    def mul(a, b):
        r = 0
        while b:
            r ^= a if b & 1 else 0
            a = (a << 1) ^ (0x11B if a & 0x80 else 0)
            b >>= 1
        return r
    inv = [0] + [next(b for b in range(1, 256) if mul(a, b) == 1)
                 for a in range(1, 256)]
    rot = [lambda x, k=k: ((x << k) | (x >> (8 - k))) & 0xFF
           for k in range(1, 5)]
    return [inv[a] ^ rot[0](inv[a]) ^ rot[1](inv[a]) ^ rot[2](inv[a])
            ^ rot[3](inv[a]) ^ 0x63 for a in range(256)]


def test_sbox_circuit_is_the_table_at_and_depth_4():
    table = _gf_sbox()
    assert aes.sbox_table().tolist() == table
    assert ref.SBOX.tolist() == table
    assert [ref_sbox.on_bits(x) for x in range(256)] == table
    depth = aes.and_depths()
    assert max(depth[s] for s in aes.SBOX_OUTPUTS) == 4
    assert sum(g[1] == "&" for g in aes.SBOX_CIRCUIT) == 34
    assert [len(g) for g, is_and, _ in aes.SCHEDULE if is_and] == \
        [9, 3, 4, 18]
    # the port's circuit and the reference's copy are the same gates
    assert [(o, a, g, b) for o, g, a, b in aes.SBOX_CIRCUIT] == \
        list(ref_sbox.GATES)


@pytest.mark.parametrize("key,pt,ct", FIPS)
def test_fips197_vectors(key, pt, ct):
    k, p = bytes.fromhex(key), np.frombuffer(bytes.fromhex(pt), np.uint8)
    assert bytes(ref.encrypt(p[None], k)[0]).hex() == ct
    assert bytes(aes.encrypt_plain(p[None], k)[0]).hex() == ct
    assert (aes.expand_key(k) == ref.expand_key(k)).all()


@pytest.mark.parametrize("rounds", [1, 2, 10])
def test_circuit_on_plain_bits_is_the_reference(rounds):
    rng = np.random.default_rng(rounds)
    blocks = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    key = bytes(rng.integers(0, 256, 16, dtype=np.uint8).tolist())
    assert (aes.encrypt_plain(blocks, key, rounds)
            == ref.encrypt(blocks, key, rounds)).all()


def test_linear_layers_on_ciphertext_words():
    """The layers on random residues [128, pn, L]: row o of the output is
    the sum mod p_i of the input rows the plain layer XORs into bit o."""
    ctx = Context(make_params(3, 2, 16, 50, 25, 8191), "cpu")
    gates = aes.Ciphertexts(type("D", (), {"ctx": ctx, "params":
                                           ctx.params})())
    lvl, pn = 1, ctx.params.num_crt_prime_lvl(1)
    p = torch.tensor(ctx.params.crt_primes[:pn], dtype=torch.int64)
    g = torch.Generator().manual_seed(3)

    def rand():
        x = torch.randint(0, 1 << 24, (128, pn, 64), generator=g)
        return torch.remainder(x, p[:, None])

    x, k = rand(), rand()

    def wire(v):
        return aes.Wire(v.to(torch.int32).view(torch.uint32), lvl)

    def words(w):
        return w.data.view(torch.int32).to(torch.int64)

    layer = aes.AES(gates)
    assert torch.equal(words(layer.shift_rows(wire(x))),
                       x[torch.from_numpy(aes.SHIFT_ROWS)])
    m = torch.from_numpy(aes.mix_columns_matrix().astype(np.int64))
    want = torch.remainder(torch.einsum("oi,ipl->opl", m, x), p[:, None])
    assert torch.equal(words(layer.mix_columns(wire(x))), want)
    assert torch.equal(words(layer.add_round_key(wire(x), wire(k))),
                       torch.remainder(x + k, p[:, None]))
    # the plain layers are the reference's, byte for byte
    s = np.random.default_rng(4).integers(0, 256, (8, 16), dtype=np.uint8)
    bits = aes.byte_bits(s).T
    plain = aes.AES(aes.PlainBits())
    assert (aes.bits_bytes(plain.shift_rows(bits).T)
            == ref.shift_rows(s)).all()
    assert (aes.bits_bytes(plain.mix_columns(bits).T)
            == ref.mix_columns(s)).all()
