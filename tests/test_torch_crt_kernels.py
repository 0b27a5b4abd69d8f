"""The front ends of the elementwise kernels off the gate step (K5-K8,
csrc/crt_ops.cu and csrc/pointwise.cu) on the CPU, where each runs its
plain version, against the JAX package bit for bit (tolerance 0):

  * K5 `crt.crt_from_raw` against `cuhe_tpu.ops.crt.crt_from_raw` at 1, 5,
    20 and 32 words and 1, 7 and 25 primes, with rows of words 0, 1 and
    2^32 - 1, and at 1, 17 and 32 words with the small primes 2, 3, 251,
    65521, 65537, with primes just below 2^32 and with both in one call;
  * K6 `pointwise.ntt_add` / `ntt_add_nx1` against `modp.add_modp` and
    `ntt_add_nx1`, y full-shaped, a [pnum, n] table and a plaintext's [n],
    at the canonical edge words (P - 1 in every pairing);
  * K7 `crt_add_nx1` (a plaintext of 2^32 - 1 on residues p - 1),
    `crt_add_int` / `crt_mul_int` (a = 0, 1, mod_msg - 1, a >= p, 2^32 -
    1) against the JAX functions, and PRINCE's round constants and NOT
    (`crt_add_int_rows`, `crt_add_int`) on the light ring against
    `cuhe_tpu/models/prince.py`;
  * K8 `crt.icrt_split_halves` and `icrt_combine_halves` on 1, 2, 3, 4, 5
    and 8 shards of partials M - 1, 0 and random against JAX's
    `icrt_psum_combine` (its psum under `jax.vmap`).

The kernels' arithmetic by hand in Python ints (csrc/crt_ops.cu has no CPU
run): K5's chunk widths keep its 64-bit sum below 2^32 d, and its dot
product and 2/1 division give the plain version's residues; K8's clamped
quotient equals the plain version's conditional subtracts, its estimate is
exact after one fix, and chip_smoke.py's `combine_ref` (which holds the
kernel on MAX_SHARDS shards on the card) equals the plain version.

Also: the front ends' shape and dtype rules on the CPU, the plain versions
count no call on the CPU, and chip_smoke.py's byte bounds of K5-K8 equal a
hand count at PRINCE level 0.  The card's side is chip_smoke.py phase 2
(kernel == plain) and its main-path phases (no plain version called)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cuhe_tpu.context import Context as JContext
from cuhe_tpu.models import prince as jpr
from cuhe_tpu.ops import crt as jcrt
from cuhe_tpu.ops import modp as jmodp
from cuhe_tpu.ops import pointwise as jpw
from cuhe_tpu.params import make_params as jmake_params
from cuhe_tpu_torch import hostmath as hm
from cuhe_tpu_torch.context import Context
from cuhe_tpu_torch.models import prince as pr
from cuhe_tpu_torch.ops import _cuda, crt, modp
from cuhe_tpu_torch.ops import pointwise as pw
from cuhe_tpu_torch.params import make_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PRINCE = (25, 2, 16, 25, 25, 21845)      # 25 primes, 20 words at level 0
LIGHT = chip_smoke.LIGHT_PRINCE          # tests/test_prince.py's light ring
P = modp.P
CANON = (0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, P - 2, P - 1)


def _eq(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _eq(g, w)
        return
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _mus(primes):
    mus = np.array([jmodp.barrett_mu(int(p)) for p in primes], np.uint64)
    return (jnp.asarray(mus[:, 0].astype(np.uint32)),
            jnp.asarray(mus[:, 1].astype(np.uint32)))


def _primes(count):
    return np.array(make_params(*PRINCE).crt_primes[:count], dtype=np.uint32)


def _residues(rng, primes, shape):
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return (x % primes.astype(np.uint64)[:, None]).astype(np.uint32)


def _pairs(vals, shape):
    v = np.asarray(vals, dtype=np.uint64).reshape(shape)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


# ---- K5: RAW -> CRT ----

@pytest.mark.parametrize("pnum", [1, 7, 25])
@pytest.mark.parametrize("words", [1, 5, 20, 32])
def test_crt_from_raw_matches_jax(words, pnum):
    """Rows of words all 0, all 1 and all 2^32 - 1, then random rows."""
    rng = np.random.default_rng(100 * words + pnum)
    raw = rng.integers(0, 1 << 32, size=(5, words, 64),
                       dtype=np.uint64).astype(np.uint32)
    raw[0], raw[1], raw[2] = 0, 1, 0xFFFFFFFF
    raw[3, :, :4] = 0xFFFFFFFF
    primes = _primes(pnum)
    got = crt.crt_from_raw(*_t(raw, primes))
    assert tuple(got.shape) == (5, pnum, 64)
    want = jcrt.crt_from_raw(jnp.asarray(raw), jnp.asarray(primes),
                             _mus(primes))
    _eq(got, want)
    # and against Python ints on the edge rows
    for r in range(3):
        ints = hm.words_to_ints(raw[r])
        np.testing.assert_array_equal(
            got[r].numpy(), [[v % int(p) for v in ints] for p in primes])


def _below_2_32(count):
    chain, v = [], 1 << 32
    while len(chain) < count:
        v = hm.prev_prime(v - 1)
        chain.append(v)
    return chain


SMALL_PRIMES = [2, 3, 251, 65521, 65537]
# five primes each: one JAX shape a word count
PRIME_SETS = {
    "small": SMALL_PRIMES,
    "below-2^32": _below_2_32(5),
    "mixed": [2, _below_2_32(1)[0], 251, _below_2_32(2)[1], 65537],
}


@pytest.mark.parametrize("which", list(PRIME_SETS))
@pytest.mark.parametrize("words", [1, 17, 32])
def test_crt_from_raw_matches_jax_at_small_and_large_primes(words, which):
    """K5's normalising shift runs from 30 bits (p = 2, 3) to 0 (p just
    below 2^32), and its chunk widths from 32 bits (1 word) to 26 (32)."""
    rng = np.random.default_rng(300 + words)
    raw = rng.integers(0, 1 << 32, size=(4, words, 32),
                       dtype=np.uint64).astype(np.uint32)
    raw[0], raw[1], raw[2] = 0, 1, 0xFFFFFFFF
    primes = np.array(PRIME_SETS[which], dtype=np.uint32)
    got = crt.crt_from_raw(*_t(raw, primes))
    want = jcrt.crt_from_raw(jnp.asarray(raw), jnp.asarray(primes),
                             _mus(primes))
    _eq(got, want)
    for r in range(4):
        ints = hm.words_to_ints(raw[r])
        np.testing.assert_array_equal(
            got[r].numpy(), [[v % int(p) for v in ints] for p in primes])


# ---- K6: the Z_P pair sum ----

@pytest.mark.parametrize("form", ["full", "table", "plaintext"])
def test_ntt_add_matches_jax(form):
    """y of x's shape, a [pnum, n] table broadcast over the batch, a
    plaintext's [n] over the planes (ntt_add_nx1); the first values are
    every pairing of the canonical edge words, P - 1 among them."""
    rng = np.random.default_rng(7)
    shape = (3, 4, 128)
    e = len(CANON)
    a = _pairs(rng.integers(0, P, size=shape, dtype=np.uint64), shape)
    b_shape = {"full": shape, "table": shape[1:], "plaintext": shape[2:]}[form]
    b = _pairs(rng.integers(0, P, size=b_shape, dtype=np.uint64), b_shape)
    ea = _pairs([x for x in CANON for _ in CANON], (e * e,))
    eb = _pairs([y for _ in CANON for y in CANON], (e * e,))
    for v, ev in zip(a, ea):
        v[0, 0, : e * e] = ev
    for v, ev in zip(b, eb):
        v.reshape(-1)[: e * e] = ev
    if form == "plaintext":
        got = pw.ntt_add_nx1(_t(*a), _t(*b))
        want = jpw.ntt_add_nx1(tuple(map(jnp.asarray, a)),
                               tuple(map(jnp.asarray, b)))
    else:
        got = pw.ntt_add(_t(*a), _t(*b))
        want = jmodp.add_modp(tuple(map(jnp.asarray, a)),
                              tuple(map(jnp.asarray, b)))
    _eq(got, want)
    vals = modp.u64_from_pair(got[0][0, 0, : e * e], got[1][0, 0, : e * e])
    assert vals.tolist() == [(x + y) % P for x in CANON for y in CANON]


@pytest.mark.parametrize("x_shape, y_shape", [
    ((3, 4, 128), (1, 4, 128)), ((4, 128), (3, 4, 128)),
    ((3, 4, 128), (4, 1))], ids=["y-leading-1", "x-smaller", "y-inner-1"])
def test_ntt_add_takes_only_a_suffix_shape_on_the_cpu(x_shape, y_shape):
    def zeros(shape):
        return (torch.zeros(shape, dtype=torch.uint32),) * 2

    with pytest.raises(ValueError, match="y must end x's shape"):
        pw.ntt_add(zeros(x_shape), zeros(y_shape))


# ---- K7: the CRT plaintext and constant ops ----

@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "batch"])
def test_crt_add_nx1_matches_jax(lead):
    """A plaintext word of 2^32 - 1 on residues p - 1: the 33-bit sum."""
    primes = _primes(7)
    rng = np.random.default_rng(20 + len(lead))
    x = _residues(rng, primes, lead + (7, 128))
    x[..., :3] = (primes - 1)[:, None]
    s = rng.integers(0, 1 << 32, size=128, dtype=np.uint64).astype(np.uint32)
    s[:2] = 0xFFFFFFFF
    got = pw.crt_add_nx1(*_t(x, s, primes))
    want = jpw.crt_add_nx1(jnp.asarray(x), jnp.asarray(s),
                           jnp.asarray(primes), _mus(primes))
    _eq(got, want)


@pytest.mark.parametrize("which", ["0", "1", "mod_msg-1", "p+7", "2^32-1"])
def test_crt_add_and_mul_int_match_jax(which):
    params = make_params(*LIGHT)
    primes = np.array(params.crt_primes, dtype=np.uint32)
    a = {"0": 0, "1": 1, "mod_msg-1": params.mod_msg - 1,
         "p+7": int(primes.max()) + 7, "2^32-1": 0xFFFFFFFF}[which]
    rng = np.random.default_rng(30)
    x = _residues(rng, primes, (2, len(primes), 128))
    x[0, :, 0] = primes - 1
    x[1, :, 0] = 0
    tx, tp = _t(x, primes)
    jx, jp = jnp.asarray(x), jnp.asarray(primes)
    _eq(pw.crt_add_int(tx, a, tp), jpw.crt_add_int(jx, a, jp))
    _eq(pw.crt_mul_int(tx, a, tp), jpw.crt_mul_int(jx, a, jp, _mus(primes)))
    np.testing.assert_array_equal(tx.numpy(), x)  # the input is kept


@pytest.fixture(scope="module")
def light_princes():
    """(port Prince, JAX Prince) on the light ring over bare contexts (no
    keys): the round constants and the NOT need only the primes."""
    jp = jpr.Prince(dhs=SimpleNamespace(ctx=JContext(jmake_params(*LIGHT))))
    p = pr.Prince(dhs=SimpleNamespace(ctx=Context(make_params(*LIGHT),
                                                  device="cpu")))
    return p, jp


@pytest.mark.parametrize("lvl", [0, 1])
def test_prince_round_constants_and_not_match_jax(light_princes, lvl):
    p, jp = light_princes
    params = p.ctx.params
    pn = params.num_crt_prime_lvl(lvl)
    primes = np.array(params.crt_primes[:pn], dtype=np.uint64)
    rng = np.random.default_rng(40 + lvl)
    state = (rng.integers(0, 1 << 62, size=(64, pn, params.crt_len),
                          dtype=np.uint64) % primes[None, :, None])
    state[:, :, 0] = primes - 1          # coefficient 0 at p - 1
    state = state.astype(np.uint32)
    ts, js = torch.from_numpy(state), jnp.asarray(state)
    for rnd in (0, 5, 11):
        _eq(p.add_rc(ts, rnd, lvl), jp.add_rc(js, rnd, lvl))
    _eq(p._cnot(ts, lvl), jp._ops(lvl)["cnot"](js))


# ---- K8: the crt-sharded ICRT's split and combine ----

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5, 8])
def test_icrt_split_and_combine_match_jax(n_shards):
    """Partials M - 1 on every shard (the most subtracts), 0, and random
    partials below M, at the light ring's M (5 words): the halves summed
    over the shards and combined equal JAX's psum-and-combine."""
    params = make_params(*LIGHT)
    q, _, _ = params.icrt_consts(0)
    words = params.words_coeff(0)
    m_words = hm.ints_to_words([q], words)[:, 0].astype(np.uint32)
    rng = np.random.default_rng(50 + n_shards)
    parts = []
    for _ in range(n_shards):
        vals = [q - 1, 0] + [int(v) % q for v in
                             rng.integers(0, 1 << 62, size=14) * (1 << 62)]
        parts.append(hm.ints_to_words(vals, words).reshape(1, words, 16))
    parts = np.stack(parts)                             # [shards, 1, w, 16]
    halves = [crt.icrt_split_halves(torch.from_numpy(v)) for v in parts]
    for h, v in zip(halves, parts):
        assert h.dtype == torch.int32
        np.testing.assert_array_equal(h[0].numpy(), v & 0xFFFF)
        np.testing.assert_array_equal(h[1].numpy(), v >> 16)
    total = sum(halves)
    got = crt.icrt_combine_halves(total[0], total[1],
                                  torch.from_numpy(m_words), n_shards)
    want = jax.vmap(lambda v: jcrt.icrt_psum_combine(
        v, jnp.asarray(m_words), "crt", n_shards), axis_name="crt")(
            jnp.asarray(parts))
    for r in range(n_shards):
        _eq(got, want[r])
    sums = [sum(hm.words_to_ints(v[0])[j] for v in parts) % q
            for j in range(16)]
    assert hm.words_to_ints(got[0].numpy()) == sums


# ---- the kernels' arithmetic by hand (csrc/crt_ops.cu) ----

M32 = 0xFFFFFFFF


def _chunk_bits(words):
    """K5's chunk width B (raw_chunk_bits): the widest with N 2^B <= 2^32,
    N = ceil(32 words / B) chunks."""
    b = 32
    while -(-32 * words // b) << b > 1 << 32:
        b -= 1
    return b


def _div_2by1(u, d, v):
    """(q, r) of u = q d + r as `div_2by1` computes them in u32 words."""
    u1, u0 = u >> 32, u & M32
    e = v * u1 + u
    assert e < 1 << 64                  # v u1 + u does not overflow
    q1 = ((e >> 32) + 1) & M32
    r = (u0 - q1 * d) & M32
    if r > e & M32:
        q1, r = (q1 - 1) & M32, (r + d) & M32
    if r >= d:
        q1, r = q1 + 1, r - d
    return q1, r


def _normalised(p):
    """K5's and K8's (d, v, s): d = p 2^s in [2^31, 2^32), v its
    reciprocal floor((2^64 - 1) / d) - 2^32."""
    s = 32 - p.bit_length()
    d = p << s
    return d, ((1 << 64) - 1) // d - (1 << 32), s


def _k5_model(coeff, words, p):
    """K5 on one coefficient (a Python int of `words` words) and prime p
    >= 2: the chunks' dot product with the table of p, one 2/1 division."""
    b = _chunk_bits(words)
    n = -(-32 * words // b)
    d, v, s = _normalised(p)
    c, table = 1 << s, []
    for _ in range(n):                   # raw_table_prime
        table.append(c)
        c = _div_2by1(c << b, d, v)[1]
    total = sum(((coeff >> (k * b)) & ((1 << b) - 1)) * table[k]
                for k in range(n))
    assert total < d << 32               # so below 2^64: one u64 holds it
    return _div_2by1(total, d, v)[1] >> s


@pytest.mark.parametrize("words", range(1, 33))
def test_crt_from_raw_kernel_arithmetic_by_hand(words):
    """Every width: N chunks of B bits cover the words and N 2^B <= 2^32,
    so the sum of N products (each below 2^B d) is below 2^32 d < 2^64;
    the model gives x mod p at the extremes of x and p."""
    b = _chunk_bits(words)
    n = -(-32 * words // b)
    assert n * b >= 32 * words and n << b <= 1 << 32
    assert {1: (32, 1), 20: (27, 24), 32: (26, 40)}.get(words, (b, n)) == (b, n)
    top = (1 << (32 * words)) - 1
    rng = np.random.default_rng(words)
    xs = [0, 1, top, top - 1, 1 << (32 * words - 1)] + [
        int.from_bytes(rng.bytes(4 * words), "little") for _ in range(3)]
    for p in SMALL_PRIMES + _below_2_32(2) + [(1 << 31) + 11]:
        d, _, _ = _normalised(p)
        assert n * ((1 << b) - 1) * (d - 1) < d << 32 <= 1 << 64
        assert [_k5_model(x, words, p) for x in xs] == [x % p for x in xs]


def _plain_subtracts(total, m, rounds):
    """`rounds` conditional subtracts of M from a non-negative total, each
    where the total is at least M (the plain combine for top >= 0)."""
    for _ in range(rounds):
        if total >= m:
            total -= m
    return total


def _k8_model(s, top, m, words, rounds):
    """K8's combine on one coefficient: s the rippled words (an int below
    2^(32 words)), top the signed carry; the quotient estimate from the
    window of T' 2^32 at M's bit length, clamped, one pass, one fix."""
    t = (max(top, 0) << (32 * words)) + s
    big = m.bit_length()
    if not big:
        return s
    mt = (m << 32) >> big                # M_t, in [2^31, 2^32)
    tt = (t << 32) >> big                # T_t
    if tt >= 1 << 48:
        k = rounds
    else:
        md = mt + 1
        q = tt >> 32 if md == 1 << 32 else _div_2by1(
            tt, md, ((1 << 64) - 1) // md - (1 << 32))[0]
        assert q in (t // m, t // m - 1)
        k = min(q, rounds)
    rest = t - k * m
    assert rest >= 0
    if k < rounds and rest >= m:
        rest -= m
    return rest % (1 << (32 * words))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8, 64, crt.MAX_SHARDS])
def test_icrt_combine_quotient_clamp_by_hand(n_shards):
    """For non-negative totals T below n_shards M and above it, T - min(
    floor(T / M), rounds) M equals `rounds` conditional subtracts, and the
    kernel's estimate gives it; at any M (one word under 5, all ones, a
    power of two)."""
    rounds = max(1, n_shards - 1)
    rng = np.random.default_rng(n_shards)
    words = 5
    q = make_params(*LIGHT).icrt_consts(0)[0]
    for m in (q, 1, 3, (1 << 32) - 5, (1 << 160) - 1, 1 << 159):
        limit = min(n_shards, 70) * m
        totals = [0, m - 1, m, limit - 1, limit, limit + m, 2 * limit]
        totals += [int.from_bytes(rng.bytes(24), "little") % (2 * limit + 1)
                   for _ in range(40)]
        for total in totals:
            want = total - min(total // m, rounds) * m
            if rounds <= 64:
                assert _plain_subtracts(total, m, rounds) == want
            s, top = total % (1 << 160), total >> 160
            if top < 1 << 15:
                assert _k8_model(s, top, m, words, rounds) == want % (1 << 160)


@pytest.mark.parametrize("n_shards", [1, 2, 5, 64])
def test_combine_ref_matches_the_plain_combine_on_any_halves(n_shards):
    """chip_smoke.combine_ref (the card's check at MAX_SHARDS shards) and
    K8's model equal the plain version on int32 halves of any value: a
    negative top word, carries both ways, M = 0, 1 and all ones."""
    rng = np.random.default_rng(70 + n_shards)
    words = 5
    lo = rng.integers(-1 << 31, 1 << 31, size=(2, words, 24), dtype=np.int64)
    hi = rng.integers(-1 << 31, 1 << 31, size=(2, words, 24), dtype=np.int64)
    lo[1] = rng.integers(-3, 1 << 18, size=(words, 24))
    hi[1] = rng.integers(-3, 1 << 18, size=(words, 24))
    hi[1, :, :4] = (1 << 31) - 1
    q = make_params(*LIGHT).icrt_consts(0)[0]
    tl, th = (torch.from_numpy(v.astype(np.int32)) for v in (lo, hi))
    rounds = max(1, n_shards - 1)
    for m in (q, 0, 1, (1 << 160) - 1):
        mw = torch.tensor([(m >> (32 * i)) & M32 for i in range(words)],
                          dtype=torch.int64)
        want = crt.icrt_combine_halves_plain(tl, th, mw, n_shards)
        ref = chip_smoke.combine_ref(lo.tolist(), hi.tolist(), m, n_shards)
        assert modp.to_i64(want).tolist() == ref
        for r in range(2):
            for j in range(24):
                carry = s = 0
                for w in range(words):
                    t = int(lo[r, w, j]) + int(hi[r, w, j]) * 65536 + carry
                    s |= (t & M32) << (32 * w)
                    carry = t >> 32
                got = _k8_model(s, carry, m, words, rounds)
                assert got == sum(ref[r][w][j] << (32 * w)
                                  for w in range(words))


# ---- the front ends' rules on the CPU, and the plain versions' counts ----

def test_front_ends_check_shapes_on_the_cpu():
    x = torch.zeros((2, 3, 8), dtype=torch.uint32)
    p = torch.ones(3, dtype=torch.uint32)
    with pytest.raises(ValueError, match="1..32 words"):
        crt.crt_from_raw(torch.zeros((2, 33, 8), dtype=torch.uint32), p)
    with pytest.raises(ValueError, match="primes"):
        crt.crt_from_raw(x, torch.ones((1, 3), dtype=torch.uint32))
    with pytest.raises(ValueError, match="expected"):
        pw.crt_add_nx1(x, torch.zeros(4, dtype=torch.uint32), p)
    with pytest.raises(ValueError, match="leading shape"):
        pw.crt_add_int_rows(x, torch.zeros(3, dtype=torch.uint32), p)
    with pytest.raises(ValueError, match="not a uint32"):
        pw.crt_add_int(x, 1 << 32, p)
    with pytest.raises(ValueError, match="not a uint32"):
        pw.crt_mul_int(x, -1, p)
    with pytest.raises(ValueError, match="primes"):
        pw.crt_add_int(x, 1, torch.ones(2, dtype=torch.uint32))
    h = torch.zeros((2, 3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="shards"):
        crt.icrt_combine_halves(h, h, torch.ones(3, dtype=torch.uint32), 0)
    with pytest.raises(ValueError, match="words"):
        crt.icrt_combine_halves(h, h, torch.ones(2, dtype=torch.uint32), 2)


def test_plain_versions_count_no_call_on_the_cpu():
    """`_cuda.PLAIN_CALLS` counts a plain version's calls on CUDA tensors
    only: CPU calls leave it empty, and `reset_launches` clears it."""
    _cuda.reset_launches()
    x = torch.zeros((2, 3, 8), dtype=torch.uint32)
    p = torch.tensor([5, 7, 11], dtype=torch.uint32)
    pair = (x, x)
    crt.crt_from_raw(x, p)
    pw.ntt_add(pair, pair)
    pw.crt_add_int(x, 1, p)
    crt.icrt_combine_halves(*crt.icrt_split_halves(x), p, 2)
    assert not _cuda.PLAIN_CALLS
    _cuda.count_plain("zp_add", torch.empty(0, device="meta"))
    assert not _cuda.PLAIN_CALLS
    _cuda.PLAIN_CALLS["zp_add"] += 1
    _cuda.reset_launches()
    assert not _cuda.PLAIN_CALLS


# ---- the byte bounds of chip_smoke.py, by hand at PRINCE level 0 ----

B, PNUM, N, WORDS = 32, 25, 32768, 20
PLANE = B * PNUM * N * 4                # one u32 plane of the step: 104.9 MB
HALF = N // 2


@pytest.mark.parametrize("case", [
    # the state's encryption: 64 ciphertexts of 20 RAW words in, 25 residue
    # planes out, the primes once
    ("crt_from_raw", lambda: chip_smoke.crt_from_raw_model(64, WORDS, PNUM,
                                                           HALF),
     64 * WORDS * HALF * 4 + 64 * PNUM * HALF * 4 + PNUM * 4, 188.7),
    # the XOR of two batches: a, b and the output, each a pair of planes
    ("zp_add", lambda: chip_smoke.zp_add_model(B * PNUM * N, B * PNUM * N),
     6 * PLANE, 629.1),
    # the round constants: 64 x 25 rows in and out, the primes and the 64
    # values once
    ("crt_scalar rows", lambda: chip_smoke.crt_scalar_model(
        64 * PNUM, PNUM, HALF, "rows"),
     2 * 64 * PNUM * HALF * 4 + PNUM * 4 + 64 * 4, 209.7),
    # the S-box's NOT at level 1: 16 x 24 rows in and out, 24 primes
    ("crt_scalar int", lambda: chip_smoke.crt_scalar_model(
        16 * (PNUM - 1), PNUM - 1, HALF, "int"),
     2 * 16 * (PNUM - 1) * HALF * 4 + (PNUM - 1) * 4, 50.3),
    # a plaintext added to a ciphertext: the polynomial once more
    ("crt_scalar poly", lambda: chip_smoke.crt_scalar_model(
        PNUM, PNUM, HALF, "poly"),
     2 * PNUM * HALF * 4 + PNUM * 4 + HALF * 4, 3.3),
    # a (2, 2) rank's partial of 16 ciphertexts: 20 words in, two int32
    # halves out; the combine: two halves in, the words out, M once
    ("icrt_split16", lambda: chip_smoke.icrt_halves_model(16 * WORDS * HALF),
     16 * WORDS * HALF * 12, 62.9),
    ("icrt_combine16", lambda: chip_smoke.icrt_halves_model(
        16 * WORDS * HALF, WORDS), 16 * WORDS * HALF * 12 + WORDS * 4, 62.9),
], ids=lambda c: c[0])
def test_crt_ops_byte_bounds_by_hand(case):
    _, model, want, mb = case
    nbytes, _ = model()
    assert nbytes == want
    assert round(nbytes / 1e6, 1) == mb
