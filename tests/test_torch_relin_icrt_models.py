"""Python-int models of the arithmetic of csrc/relin.cu and csrc/icrt.cu, on
the CPU, where no kernel runs.

* The multiply-accumulate adds each 64 x 64 -> 128-bit product unreduced
  into an even and an odd accumulator of 64-bit words with the carries of
  goldilocks.cuh::gl_acc_mac, and folds their sum once with gl_acc_reduce
  (a carry chain, gl_reduce128's carry chain, then gl_sub of the top word
  times 2^32).
  The model follows those instructions word by word and is held against
  sums of `modp.mul_modp64` / `modp.add_modp64`, the arithmetic of
  relin_mulacc's plain version.
* The ICRT accumulates s = sum_i y_i (M / p_i) with no reduction, estimates
  k = floor(s / M) in floating point from the top words of s and M, subtracts
  k M and fixes the result up with one conditional add or subtract of M.
  The model follows the kernel's steps and is held against
  `icrt_to_raw_plain` and the JAX package's `icrt_to_raw`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuhe_tpu.ops import crt as jcrt
from cuhe_tpu.ops import modp as jmodp
from cuhe_tpu_torch import hostmath as hm
from cuhe_tpu_torch.entry import ENTRY_PARAMS, PRINCE_PARAMS
from cuhe_tpu_torch.ops import crt, modp
from cuhe_tpu_torch.ops import ntt_kernels as nk
from cuhe_tpu_torch.params import make_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = modp.P
M32 = 0xFFFFFFFF
EDGES = (0, 1, P - 1, (1 << 32) - 1, 1 << 32)


# ---------------------------------------------------------------------------
# the multiply-accumulate
# ---------------------------------------------------------------------------

class _Carry:
    """32-bit adds with PTX's carry flag: add / addc, sub / subc."""

    def __init__(self):
        self.cf = 0

    def add(self, a, b, cc=True, use=False):
        t = a + b + (self.cf if use else 0)
        if cc:
            self.cf = t >> 32
        return t & M32

    def sub(self, a, b, cc=True, use=False):
        t = a - b - (self.cf if use else 0)
        if cc:
            self.cf = 1 if t < 0 else 0
        return t & M32


M64 = (1 << 64) - 1


def acc_mac(acc, x, y):
    """gl_acc_mac on (e01, e23, e4, o01, o2): four wide products, the even
    part x0 y0 + x1 y1 2^64 added by one 64-bit carry chain, the odd
    products x0 y1 and x1 y0 by one add each, every carry caught."""
    x0, x1, y0, y1 = x & M32, x >> 32, y & M32, y >> 32
    e01, e23, e4, o01, o2 = acc
    t = e01 + x0 * y0
    e01, c = t & M64, t >> 64
    t = e23 + x1 * y1 + c
    e23, c = t & M64, t >> 64
    e4 = (e4 + c) & M32
    for u, v in ((x0, y1), (x1, y0)):
        t = o01 + u * v
        o01, c = t & M64, t >> 64
        o2 = (o2 + c) & M32
    return e01, e23, e4, o01, o2


def reduce128(lo, hi):
    """gl_reduce128's carry chain, instruction by instruction."""
    c = _Carry()
    l0, l1, hl, hh = lo & M32, lo >> 32, hi & M32, hi >> 32
    r0 = c.sub(l0, hh)
    r1 = c.sub(l1, 0, use=True)
    k = c.sub(0, 0, use=True)
    r0 = c.sub(r0, k)
    r1 = c.sub(r1, 0, cc=False, use=True)
    u0 = c.sub(0, hl)
    u1 = c.sub(hl, 0, cc=False, use=True)
    r0 = c.add(r0, u0)
    r1 = c.add(r1, u1, use=True)
    k = c.add(0, 0, cc=False, use=True)
    k = (0 - k) & M32
    r0 = c.add(r0, k)
    r1 = c.add(r1, 0, cc=False, use=True)
    x0 = c.add(r0, M32)
    x1 = c.add(r1, 0, use=True)
    k = c.add(0, 0, cc=False, use=True)
    return (x1 << 32 | x0) if k else (r1 << 32 | r0)


def gl_sub(a, b):
    """gl_sub's carry chain: a - b, on a borrow minus 2^32 - 1."""
    c = _Carry()
    d0 = c.sub(a & M32, b & M32)
    d1 = c.sub(a >> 32, b >> 32, use=True)
    bw = c.sub(0, 0, cc=False, use=True)
    d0 = c.sub(d0, bw)
    d1 = c.sub(d1, 0, cc=False, use=True)
    return d1 << 32 | d0


def reduce160(r):
    """The fold of gl_acc_reduce: five words r0..r4 below 2^160."""
    v = reduce128(r[1] << 32 | r[0], r[3] << 32 | r[2])
    return gl_sub(v, r[4] << 32)


def acc_reduce(acc):
    """gl_acc_reduce: the odd words added at word 1 (one carry chain), then
    the fold."""
    e01, e23, e4, o01, o2 = acc
    c = _Carry()
    r1 = c.add(e01 >> 32, o01 & M32)
    r2 = c.add(e23 & M32, o01 >> 32, use=True)
    r3 = c.add(e23 >> 32, o2, use=True)
    r4 = c.add(e4, 0, cc=False, use=True)
    return reduce160([e01 & M32, r1, r2, r3, r4])


def mulacc_model(acc, ds, es):
    """The kernel's output for one (b, p, k): the accumulator starts at the
    previous partial (or 0), takes every product, and is folded once."""
    a = (acc, 0, 0, 0, 0)
    for d, e in zip(ds, es):
        a = acc_mac(a, d, e)
    e01, e23, e4, o01, o2 = a
    assert e01 + (e23 << 64) + (e4 << 128) + (o01 << 32) + (o2 << 96) == \
        acc + sum(d * e for d, e in zip(ds, es))
    return acc_reduce(a)


def mulacc_reference(acc, ds, es):
    """acc + sum d e mod P with the plain version's arithmetic: [c, m] int
    columns of digits and keys, acc [m] (or None)."""
    def pair(v):
        v = np.asarray(v, dtype=np.uint64)
        return (torch.from_numpy((v & np.uint64(M32)).astype(np.int64)),
                torch.from_numpy((v >> np.uint64(32)).astype(np.int64)))

    out = None if acc is None else pair(acc)
    for d, e in zip(ds, es):
        prod_ = modp.mul_modp64(pair(d), pair(e))
        out = prod_ if out is None else modp.add_modp64(out, prod_)
    return [int(lo) | int(hi) << 32 for lo, hi in zip(*out)]


def _check_mulacc(ds, es, acc):
    """ds, es: [c, m] Python ints; acc: [m] or None."""
    want = mulacc_reference(acc, ds, es)
    for col in range(len(want)):
        got = mulacc_model(0 if acc is None else acc[col],
                           [d[col] for d in ds], [e[col] for e in es])
        assert got == want[col], (col, got, want[col])


@pytest.mark.parametrize("with_acc", (False, True))
@pytest.mark.parametrize("c", (1, 7, 8, 40, 1024))
def test_lazy_mulacc_model_matches_modp_sums(c, with_acc):
    rng = np.random.default_rng(c * 2 + with_acc)
    cols = 14 if c == 1024 else 24
    edge = np.array(EDGES, dtype=np.uint64)
    # column 0: every operand P - 1 (the largest accumulator); columns 1..5
    # one edge value throughout; then edge values mixed, then random < P
    ds = rng.integers(0, P, size=(c, cols), dtype=np.uint64)
    es = rng.integers(0, P, size=(c, cols), dtype=np.uint64)
    mixed = slice(len(EDGES) + 1, 2 * len(EDGES) + 1)
    ds[:, mixed] = rng.choice(edge, size=(c, len(EDGES)))
    es[:, mixed] = rng.choice(edge, size=(c, len(EDGES)))
    for i, v in enumerate(EDGES):
        ds[:, 1 + i] = es[:, 1 + i] = v
    ds[:, 0] = es[:, 0] = P - 1
    acc = None
    if with_acc:
        acc = rng.integers(0, P, size=cols, dtype=np.uint64)
        acc[:len(EDGES) + 1] = [P - 1, *EDGES]
        acc = [int(v) for v in acc]
    _check_mulacc([[int(v) for v in row] for row in ds],
                  [[int(v) for v in row] for row in es], acc)


def test_lazy_accumulator_bound_is_the_stated_limit():
    # LAZY_MAX_DIGITS products of the largest 64-bit operands on the largest
    # 64-bit partial: the even and odd parts' top words (below the count
    # plus one, and twice the count) and the value fit their words
    top = (1 << 64) - 1
    limit = nk.LAZY_MAX_DIGITS
    assert limit == (1 << 31) - 1
    assert (top + limit * M32 * M32 * (1 + (1 << 64))) >> 128 <= limit
    assert (limit * 2 * M32 * M32) >> 64 < 2 * limit < 1 << 32
    assert limit * top * top + top < 1 << 160
    # every operand P - 1 over the limit: the fold gives the sum mod P
    total = (P - 1) + limit * (P - 1) ** 2
    assert reduce160([total >> (32 * i) & M32 for i in range(5)]) == total % P


def test_reduce160_folds_every_word():
    rng = np.random.default_rng(3)
    words = [0, 1, M32, 1 << 31, M32 - 1]
    vals = [sum(w << (32 * i) for i, w in enumerate(ws))
            for ws in ([words[(i + j) % 5] for i in range(5)]
                       for j in range(5))]
    vals += [int(v) for v in rng.integers(0, 1 << 63, size=16,
                                          dtype=np.uint64)]
    vals += [int.from_bytes(rng.bytes(20), "little") for _ in range(64)]
    vals += [(1 << 160) - 1, P, 2 * P, P << 96, M32 << 128 | (P - 1)]
    for v in vals:
        r = [v >> (32 * i) & M32 for i in range(5)]
        assert reduce160(r) == v % P, hex(v)


def test_relin_tile_covers_the_planes_within_the_kernel_limit():
    for batch in (1, 2, 3, 8, 32, 33, 1000):
        for pnum in (1, 3, 4, 5, 24, 25, 26, 40, 41, 200):
            bg, pg = nk.relin_tile(batch, pnum)
            assert bg >= 1 and pg >= 1
            assert nk.RELIN_POSITIONS * bg * pg <= 640  # kMaxThreads
            # csrc/relin.cu Tile::smem: 3 staged digits and the row sources
            rows = nk.RELIN_RB * bg + nk.RELIN_RP * pg
            assert 3 * rows * 2 * 32 * 4 + 2 * rows * 16 <= 48 * 1024
            # no more ciphertext groups than the batch fills
            assert bg == 1 or nk.RELIN_RB * (bg - 1) < batch
            assert nk.RELIN_RP * pg >= min(
                pnum, nk.RELIN_RP * nk.RELIN_MAX_PLANE_GROUPS)
    # PRINCE level 0: 8 ciphertexts by all 25 planes, 640 threads
    assert nk.relin_tile(32, 25) == (4, 5)


# ---------------------------------------------------------------------------
# the ICRT
# ---------------------------------------------------------------------------

def _f64(x):
    return float(x)  # IEEE double, as the kernel's (double) conversions


def icrt_model(residues, primes, bi, mi, m, words, stats=None, force=None):
    """The kernel's value for one coefficient, as its words: Barrett y_i,
    the unreduced multiword sum, k from the top words, s - k M, the fix-up.
    `stats` counts the fix-ups taken; `force` replaces the estimate by
    floor(s / M) + force, to reach a fix-up the data do not."""
    width = -(-words // 4) * 4  # the instantiation that runs
    s = 0
    for x, p, b, mi_i in zip(residues, primes, bi, mi):
        mu = ((1 << 64) - 1) // p
        t = x * b
        r = t - ((t * mu) >> 64) * p
        y = r - p if r >= p else r
        assert y == t % p
        s += y * mi_i
    assert s < len(primes) * m < 1 << (32 * (width + 1))
    sw = [s >> (32 * w) & M32 for w in range(width + 1)]
    mw = [m >> (32 * w) & M32 for w in range(width)]
    top = max([w for w in range(words) if mw[w]], default=0)
    mtop = _f64(mw[top]) + (_f64(mw[top - 1]) * 2.0 ** -32 if top else 0.0)
    sd = 0.0
    for w in range(width + 1):
        e = w - top
        if e == 1:
            sd += _f64(sw[w]) * 2.0 ** 32
        if e == 0:
            sd += _f64(sw[w])
        if e == -1:
            sd += _f64(sw[w]) * 2.0 ** -32
    k = int(sd / mtop)
    assert abs(k - s // m) <= 1
    if force is not None:
        k = s // m + force
    r = s - k * m  # the words' two's complement over width + 1 words
    if r < 0:
        r += m
        kind = "add"
    elif r >= m:
        r -= m
        kind = "sub"
    else:
        kind = "none"
    if stats is not None:
        stats[kind] = stats.get(kind, 0) + 1
    assert 0 <= r < m
    return [r >> (32 * w) & M32 for w in range(words)]


def _consts(params):
    pr = make_params(*params)
    pn = pr.num_crt_prime
    q, mi, bi = pr.icrt_consts(0)
    return list(pr.crt_primes[:pn]), bi, mi, q, pr.words_coeff(0)


def _icrt_inputs(primes, mi, m, rng, cols=64):
    """Residue columns of 0, 1, M - 1, M // 2, integers next to multiples
    of M / p_i, every residue p_i - 1, and random residues."""
    special = [0, 1, m - 1, m // 2]
    for i, p in enumerate(primes):
        special += [j * mi[i] + d for j in (1, p // 2, p - 1)
                    for d in (-1, 0, 1)]
    x = np.stack([rng.integers(0, p, size=len(special) + cols + 1)
                  for p in primes]).astype(np.uint32)
    for col, v in enumerate(special):
        x[:, col] = [v % p for p in primes]
    x[:, len(special)] = np.array(primes) - 1
    return x


@pytest.mark.parametrize("params", (ENTRY_PARAMS, PRINCE_PARAMS),
                         ids=("entry", "prince_l0"))
def test_icrt_single_reduction_model_matches_plain_and_jax(params):
    primes, bi, mi, m, words = _consts(params)
    rng = np.random.default_rng(len(primes))
    x = _icrt_inputs(primes, mi, m, rng)
    m_words = hm.ints_to_words([m], words)[:, 0]
    mi_words = np.stack([hm.ints_to_words([v], words)[:, 0] for v in mi])
    pr_np = np.array(primes, np.uint32)
    bi_np = np.array(bi, np.uint32)
    plain = crt.icrt_to_raw_plain(*(torch.from_numpy(np.array(a)) for a in
                                    (x, pr_np, bi_np, mi_words, m_words)))
    mus = np.array([jmodp.barrett_mu(int(p)) for p in primes], np.uint64)
    jax_out = np.asarray(jcrt.icrt_to_raw(
        jnp.asarray(x), jnp.asarray(pr_np),
        (jnp.asarray(mus[:, 0].astype(np.uint32)),
         jnp.asarray(mus[:, 1].astype(np.uint32))),
        jnp.asarray(bi_np), jnp.asarray(mi_words), jnp.asarray(m_words)))
    np.testing.assert_array_equal(plain.numpy(), jax_out)
    stats = {}
    for col in range(x.shape[1]):
        got = icrt_model([int(v) for v in x[:, col]], primes, bi, mi, m,
                         words, stats)
        assert got == [int(v) for v in jax_out[:, col]], col
    # the estimate is exact on most columns
    assert stats.get("none", 0) > x.shape[1] // 2, stats
    # an estimate one too large or one too small is fixed up
    for force, kind in ((1, "add"), (-1, "sub")):
        stats = {}
        for col in range(x.shape[1]):
            vals = [int(v) for v in x[:, col]]
            if sum(vals) == 0:  # s = 0: floor(s / M) - 1 is no estimate
                continue
            got = icrt_model(vals, primes, bi, mi, m, words, stats, force)
            assert got == [int(v) for v in jax_out[:, col]], (force, col)
        assert set(stats) == {kind}, stats


@pytest.mark.parametrize("words", (1, 2, 3, 4, 5, 8, 9, 13, 20, 31, 32))
def test_icrt_model_at_every_width(words):
    # `words` primes just below 2^32: M fills exactly `words` words
    primes, v = [], 1 << 32
    while len(primes) < words:
        v = hm.prev_prime(v - 1)
        primes.append(v)
    m = 1
    for p in primes:
        m *= p
    assert (m.bit_length() + 31) // 32 == words
    mi = [m // p for p in primes]
    bi = [hm.modinv(v % p, p) for v, p in zip(mi, primes)]
    rng = np.random.default_rng(words)
    x = _icrt_inputs(primes, mi, m, rng, cols=16)
    plain = crt.icrt_to_raw_plain(
        torch.from_numpy(x), torch.tensor(primes, dtype=torch.int64),
        torch.tensor(bi, dtype=torch.int64),
        torch.from_numpy(np.stack([hm.ints_to_words([v], words)[:, 0]
                                   for v in mi]).astype(np.int64)),
        torch.from_numpy(hm.ints_to_words([m], words)[:, 0].astype(np.int64)))
    for col in range(x.shape[1]):
        got = icrt_model([int(v) for v in x[:, col]], primes, bi, mi, m,
                         words)
        assert got == [int(v) for v in plain[:, col]], col
        assert hm.words_to_ints(np.array(got, np.uint32)[:, None])[0] == \
            hm.crt_combine([int(v) for v in x[:, col]], primes)


@pytest.mark.parametrize("shards", (2, 3, 4))
@pytest.mark.parametrize("params", (ENTRY_PARAMS, PRINCE_PARAMS),
                         ids=("entry", "prince_l0"))
def test_icrt_model_on_a_subset_of_the_primes(params, shards):
    """A crt-sharded step runs the ICRT of each rank's primes against the
    global M (parallel/mesh.py::icrt_to_raw_sharded): its unreduced sum is
    below k M for k primes, and the kernel's one reduction still gives the
    value in [0, M), equal to the plain version's; the ranks' partials
    summed mod M give the ICRT of all the primes."""
    from cuhe_tpu_torch.parallel.mesh import crt_split

    primes, bi, mi, m, words = _consts(params)
    rng = np.random.default_rng(100 + shards)
    x = _icrt_inputs(primes, mi, m, rng, cols=16)
    mi_words = np.stack([hm.ints_to_words([v], words)[:, 0] for v in mi])
    m_words = torch.from_numpy(hm.ints_to_words([m], words)[:, 0]
                               .astype(np.int64))
    total = [0] * x.shape[1]
    for c0, c1 in crt_split(len(primes), shards):
        plain = crt.icrt_to_raw_plain(
            torch.from_numpy(x[c0:c1]),
            torch.tensor(primes[c0:c1], dtype=torch.int64),
            torch.tensor(bi[c0:c1], dtype=torch.int64),
            torch.from_numpy(mi_words[c0:c1].astype(np.int64)), m_words)
        for col in range(x.shape[1]):
            vals = [int(v) for v in x[c0:c1, col]]
            got = icrt_model(vals, primes[c0:c1], bi[c0:c1], mi[c0:c1], m,
                             words)
            assert got == [int(v) for v in plain[:, col]], (c0, col)
            part = hm.words_to_ints(np.array(got, np.uint32)[:, None])[0]
            assert part == sum(y * mi_i for y, mi_i in zip(
                [v * b % p for v, b, p in zip(vals, bi[c0:c1],
                                              primes[c0:c1])],
                mi[c0:c1])) % m
            total[col] += part
    for col in range(x.shape[1]):
        assert total[col] % m == hm.crt_combine(
            [int(v) for v in x[:, col]], primes)
