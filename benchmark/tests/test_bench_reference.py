"""The plain reference: its arithmetic against Python ints, its tables
against the published parameters' derivation, its gate against the port's
CPU path at the small make_params(3, 2, 16, 50, 25, 8191) ring, its
decryption, and the plain PRINCE cipher against the paper's vectors."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from benchmark.reference import dhs as rdhs
from benchmark.reference import gate as rg
from benchmark.reference import ntt, prince, sbox, zp
from benchmark.reference.ring import Ring, cyclotomic

P = zp.P
CONFIGS = [(3, 2, 16, 50, 25, 8191), (5, 2, 1, 61, 20, 8191),
           (25, 2, 16, 25, 25, 21845)]


def _pair(vals):
    return (torch.tensor([v & zp.M32 for v in vals]),
            torch.tensor([v >> 32 for v in vals]))


def _ints(pair):
    return [int(lo) + (int(hi) << 32) for lo, hi in zip(*pair)]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_zp_against_python_ints(op):
    r = random.Random(11)
    edge = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1,
            1 << 63, P - (1 << 32)]
    a = edge * len(edge) + [r.randrange(P) for _ in range(3000)]
    b = [y for y in edge for _ in edge] + [r.randrange(P) for _ in range(3000)]
    fn = {"mul": (zp.mul, lambda x, y: x * y % P),
          "add": (zp.add, lambda x, y: (x + y) % P),
          "sub": (zp.sub, lambda x, y: (x - y) % P)}[op]
    assert _ints(fn[0](_pair(a), _pair(b))) == [fn[1](x, y)
                                                for x, y in zip(a, b)]


def test_mod_small():
    r = random.Random(3)
    vals = [0, P - 1] + [r.randrange(P) for _ in range(500)]
    p = torch.tensor([33550337], dtype=torch.int64)
    assert zp.mod_small(_pair(vals), p).tolist() == [v % 33550337
                                                     for v in vals]


@pytest.mark.parametrize("args", CONFIGS)
def test_ring_against_the_ports_derivation(args):
    from cuhe_tpu_torch.params import make_params

    r, pr = Ring(*args), make_params(*args)
    assert r.primes == list(pr.crt_primes)
    assert r.poly_mod == list(pr.poly_mod)
    assert (r.n, r.mod_len, r.num_eval_key) == (pr.ntt_len, pr.mod_len,
                                                pr.num_eval_key)
    for lvl in range(pr.depth):
        assert r.words(lvl) == pr.words_coeff(lvl)
        assert r.knum(lvl) == pr.num_eval_key_lvl(lvl)
        q, mi, bi = pr.icrt_consts(lvl)
        assert r.icrt(lvl) == (q, mi, bi)


def test_cyclotomic_small():
    assert cyclotomic(1) == [-1, 1]
    assert cyclotomic(6) == [1, -1, 1]
    assert cyclotomic(15) == [1, -1, 0, 1, -1, 1, 0, -1, 1]


@pytest.mark.parametrize("args", CONFIGS[:2])
def test_barrett_polys_against_the_ports_tables(args):
    from cuhe_tpu_torch.context import _host_tables
    from cuhe_tpu_torch.params import make_params

    u, mc = Ring(*args).barrett_polys()
    host = _host_tables(make_params(*args))
    assert (u == host["u_crt_np"].astype(np.int64)).all()
    assert (mc == host["m_crt_np"].astype(np.int64)).all()


def test_ntt_is_the_dft():
    n = 16384
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 1 << 30, (2, n // 2), generator=g)
    lo, hi = ntt.forward(x, n)
    std_lo, std_hi = ntt.from_mat(lo, n), ntt.from_mat(hi, n)
    w = pow(ntt.NTT_GEN, 65536 // n, P)
    xs = x[1].tolist()
    for k in (0, 1, 777, n - 1):
        want = sum(v * pow(w, j * k, P) for j, v in enumerate(xs)) % P
        assert int(std_lo[1, k]) + (int(std_hi[1, k]) << 32) == want
    p = torch.tensor([(1 << 31) - 1], dtype=torch.int64)
    back = ntt.inverse_mod((lo, hi), n, p)
    assert (back[..., : n // 2] == x % p).all()
    assert (back[..., n // 2:] == 0).all()


def test_gate_matches_the_ports_cpu_path():
    """GateStep on the CPU (the port's plain versions) at the entry ring."""
    from cuhe_tpu_torch import entry

    step, inp = entry.entry(device="cpu")
    out = zp.u32_to_i64(step(*inp))
    t = rg.Tables(Ring(*entry.ENTRY_PARAMS), "cpu")
    ek = zp.from_u32(*step.ctx.ek_ntt)
    ref = rg.gate(zp.from_u32(inp[0], inp[1]), zp.from_u32(inp[2], inp[3]),
                  ek, t, 0, 2)
    assert ref.shape == out.shape
    assert int((ref != out).sum()) == 0


def test_dhs_gate_and_decryption_against_the_port():
    """The port's keygen, encryption and AND gate at the light ring: the
    reference gate from the integer ciphertexts and eval keys gives the
    port's words, and its decryption the plaintexts' product; the eval keys
    keep their relation to the secret key, and one altered key does not."""
    from cuhe_tpu_torch import poly
    from cuhe_tpu_torch.dhs import CuDHS

    args = CONFIGS[0]
    dhs = CuDHS(*args, seed=7, device="cpu")
    ctx, ring = dhs.ctx, Ring(*args)
    t = rg.Tables(ring, "cpu")
    rng = np.random.default_rng(5)
    pa, pb = (rng.integers(0, 2, ring.mod_len).tolist() for _ in range(2))
    ca, cb = dhs.encrypt(pa, 0), dhs.encrypt(pb, 0)
    x, y = (poly.to_ntt(ctx, poly.ctxt_from_ints(c, 0)) for c in (ca, cb))
    out = poly.mod_switch(ctx, poly.relin(ctx, poly.c_and(ctx, x, y)))

    def ref_ntt(cs, lvl):
        return rdhs.ints_to_ntt(cs, t, lvl, "cpu")

    ek = ref_ntt(dhs.ek, 0)
    assert (ek[0] == zp.u32_to_i64(ctx.ek_ntt[0])).all()
    assert rdhs.eval_key_errors(ek, dhs.sk[0], t, ring.w, 2) == 0
    bent = [list(k) for k in dhs.ek]
    bent[2][5] = (bent[2][5] + 1) % ring.q(0)
    assert rdhs.eval_key_errors(ref_ntt(bent, 0), dhs.sk[0], t, ring.w,
                                2) > 0
    ref = rg.gate(ref_ntt([ca], 0), ref_ntt([cb], 0), ek, t, 0, 2)[0]
    o = zp.u32_to_i64(out.data)
    assert int((o != ref).sum()) == 0
    dec = rdhs.decrypt(o[None], dhs.sk[1], t, 1, 2)[0]
    m_bits = rdhs.poly_bits([c % 2 for c in ring.poly_mod])
    assert rdhs.poly_bits(dec) == rdhs.gf2_mulmod(
        rdhs.poly_bits(pa), rdhs.poly_bits(pb), m_bits)
    o2 = o.clone()
    o2[0, 0] = (o2[0, 0] + 1) % ring.primes[0]  # one word off: one bit off
    dec2 = rdhs.decrypt(o2[None], dhs.sk[1], t, 1, 2)[0]
    assert rdhs.poly_bits(dec2) != rdhs.poly_bits(dec)


# Borghoff et al., ASIACRYPT 2012, appendix: (plaintext, k0, k1, ciphertext)
PAPER_VECTORS = [
    (0x0000000000000000, 0x0000000000000000, 0x0000000000000000,
     0x818665AA0D02DFDA),
    (0xFFFFFFFFFFFFFFFF, 0x0000000000000000, 0x0000000000000000,
     0x604AE6CA03C20ADA),
    (0x0000000000000000, 0xFFFFFFFFFFFFFFFF, 0x0000000000000000,
     0x9FB51935FC3DF524),
    (0x0000000000000000, 0x0000000000000000, 0xFFFFFFFFFFFFFFFF,
     0x78A54CBE737BB7EF),
    (0x0123456789ABCDEF, 0x0000000000000000, 0xFEDCBA9876543210,
     0xAE25AD3CA8FA9CCF),
]


@pytest.mark.parametrize("vec", PAPER_VECTORS)
def test_prince_paper_vectors(vec):
    m, k0, k1, c = vec
    assert prince.encrypt(m, k0, k1) == c


def test_prince_known_answers_of_the_reference():
    """Prince.cu:96 (A = 0, B = ones, C = 0) and the per-round states of
    Prince.cu:108-147, as the port's model states them."""
    from cuhe_tpu_torch.models.prince import Prince

    ones = (1 << 64) - 1
    bits = "".join(map(str, prince.to_bits(prince.encrypt(0, ones, 0))))
    assert bits == Prince.EXPECTED_FINAL
    for rnd, state in Prince.EXPECTED_ROUNDS.items():
        s = prince.encrypt(0, ones, 0, layers=rnd + 1)
        assert "".join(map(str, prince.to_bits(s))) == state


@pytest.mark.parametrize("inverse", [False, True])
def test_sbox_terms_are_the_ciphers_table(inverse):
    """The reference S-box layer's sums of monomials, on plain bits."""
    table = prince.SBOX_INV if inverse else prince.SBOX
    for v in range(16):
        bits = dict(zip("abcd", ((v >> s) & 1 for s in (3, 2, 1, 0))))
        out = 0
        for terms in (sbox.INVERSE if inverse else sbox.FORWARD):
            bit = 0
            for term in terms:
                bit ^= 1 if term == "1" else min(bits[b] for b in term)
            out = (out << 1) | bit
        assert out == table[v]
