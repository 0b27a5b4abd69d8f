"""The front ends of the elementwise Z_P / CRT kernels (csrc/pointwise.cu)
on the CPU, where each runs its plain version, against the JAX package bit
for bit (tolerance 0): K1 `pointwise.ntt_mul` against `modp.mul_modp`, K2
`barrett.barrett_combine` inside `barrett_reduce` against the JAX
`barrett_reduce`, K3 `pointwise.mod_switch_dropped` (the dropped plane
apart, over an uneven split of the planes) against the JAX `mod_switch`, K4
`pointwise.crt_add` against the JAX `crt_add`.  Inputs come from numpy
seeds and the extremes (pair words P - 1, P, 2^64 - 1; residues p - 1 and
0; dirty residues about (p_t - 1) / 2 with mod_msg 2, 3 and 16).  Also: a
meta-device tensor and a wrong dtype raise at every front end of K1-K8
(K5-K8 against JAX: test_torch_crt_kernels.py), `GateStep(plain=True)` reaches
no kernel front end, and chip_smoke.py's byte bounds equal a hand count at
PRINCE level 0.  The card's side is chip_smoke.py phase 2 (kernel ==
plain)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from cuhe_tpu.context import Context as JContext
from cuhe_tpu.ops import barrett as jbarrett
from cuhe_tpu.ops import modp as jmodp
from cuhe_tpu.ops import pointwise as jpw
from cuhe_tpu.params import make_params as jmake_params
from cuhe_tpu_torch import entry
from cuhe_tpu_torch.ops import barrett, modp
from cuhe_tpu_torch.ops import crt as crt_ops
from cuhe_tpu_torch.ops import ntt_kernels as nk
from cuhe_tpu_torch.ops import pointwise as pw
from cuhe_tpu_torch.parallel.mesh import crt_split
from cuhe_tpu_torch.step import GateStep

ENTRY = (3, 2, 16, 50, 25, 8191)       # n = 16384, mod_len 8190 < n/2
P = modp.P
# pair words at the edges of Z_P and of 64 bits (mul_modp takes a, b < 2^64)
EDGE_WORDS = (0, 1, 2, P - 2, P - 1, P, P + 1, (1 << 32) - 1, 1 << 32,
              (1 << 63) + 5, (1 << 64) - 2, (1 << 64) - 1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread while this module runs: the test workers
    share the machine's cores, and the plain NTTs' spinning OpenMP threads
    multiplied these tests' time several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jctx():
    return JContext(jmake_params(*ENTRY))


def _eq(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _eq(g, w)
        return
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pair(vals, shape):
    v = np.asarray(vals, dtype=np.uint64).reshape(shape)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def _t(pair):
    return tuple(torch.from_numpy(np.array(v)) for v in pair)


def _j(pair):
    return tuple(jnp.asarray(v) for v in pair)


def _random_pair(rng, shape):
    return tuple(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                 .astype(np.uint32) for _ in range(2))


def _residues(rng, primes, shape):
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return (x % primes.astype(np.uint64)[:, None]).astype(np.uint32)


# ---- K1: the Z_P pair product ----

@pytest.mark.parametrize("form", ["full", "table", "plaintext"])
def test_ntt_mul_matches_jax(form):
    """b of a's shape, a [pnum, n] table broadcast over the batch (Barrett's
    products), a plaintext's [n] over the planes (ntt_mul_nx1); the first
    rows are every pairing of the edge words."""
    rng = np.random.default_rng(11)
    shape = (3, 4, 256)
    a = _random_pair(rng, shape)
    b_shape = {"full": shape, "table": shape[1:], "plaintext": shape[2:]}[form]
    b = _random_pair(rng, b_shape)
    e = len(EDGE_WORDS)
    ea = _pair([x for x in EDGE_WORDS for _ in EDGE_WORDS], (e * e,))
    eb = _pair([y for _ in EDGE_WORDS for y in EDGE_WORDS], (e * e,))
    for v, ev in zip(a, ea):
        v[0, 0, : e * e] = ev
    for v, ev in zip(b, eb):
        v.reshape(-1)[: e * e] = ev
    if form == "plaintext":
        got = pw.ntt_mul_nx1(_t(a), _t(b))
        want = jpw.ntt_mul_nx1(_j(a), _j(b))
    else:
        got = pw.ntt_mul(_t(a), _t(b))
        want = jmodp.mul_modp(_j(a), _j(b))
    _eq(got, want)
    # the edge pairings against Python ints too
    vals = modp.u64_from_pair(got[0][0, 0, : e * e], got[1][0, 0, : e * e])
    assert vals.tolist() == [x * y % P for x in EDGE_WORDS for y in EDGE_WORDS]


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, (1 << 64) - 1), min_size=8, max_size=8),
       st.lists(st.integers(0, (1 << 64) - 1), min_size=4, max_size=4))
def test_ntt_mul_any_words(a, b):
    got = pw.ntt_mul(_t(_pair(a, (2, 4))), _t(_pair(b, (4,))))
    want = jmodp.mul_modp(_j(_pair(a, (2, 4))), _j(_pair(b, (4,))))
    _eq(got, want)


@pytest.mark.parametrize("x_shape, y_shape", [
    ((3, 4, 256), (1, 4, 256)), ((4, 256), (3, 4, 256)),
    ((3, 4, 256), (4, 1))], ids=["y-leading-1", "x-smaller", "y-inner-1"])
def test_ntt_mul_takes_only_a_suffix_shape_on_the_cpu(x_shape, y_shape):
    """y must end x's shape on the CPU as on the card (K1 indexes a suffix):
    pairs that torch would broadcast otherwise raise before the plain
    version runs."""
    def zeros(shape):
        return (torch.zeros(shape, dtype=torch.uint32),) * 2

    with pytest.raises(ValueError, match="y must end x's shape"):
        pw.ntt_mul(zeros(x_shape), zeros(y_shape))


# ---- K2: Barrett's combine, through barrett_reduce ----

@functools.lru_cache(maxsize=None)
def _jax_reduce_fn(mod_len, n):
    """One jitted JAX barrett_reduce per (mod_len, n): the cases of one
    shape share its compile."""
    return jax.jit(functools.partial(jbarrett.barrett_reduce, mod_len=mod_len,
                                     n=n, layout="mat"))


def _jax_reduce(f, mod_len, n, u, m, m_crt, primes, mus):
    return _jax_reduce_fn(mod_len, n)(
        jnp.asarray(f), u_ntt=_j(u), m_ntt=_j(m), m_crt=jnp.asarray(m_crt),
        primes=jnp.asarray(primes), mus=_j(mus))


def _port_reduce(f, mod_len, n, u, m, m_crt, primes):
    return barrett.barrett_reduce(
        torch.from_numpy(f), mod_len=mod_len, n=n, u_ntt=_t(u), m_ntt=_t(m),
        m_crt=torch.from_numpy(m_crt), primes=torch.from_numpy(primes))


def _edge_rows(f, primes, mod_len):
    """Ciphertext 0: residues p - 1 in plane 0, 0 in plane 1, and a zero
    coefficient x^mod_len in every plane of ciphertext 1 (t = 0: no
    correction by m_crt)."""
    f[0, 0] = primes[0] - 1
    f[0, 1] = 0
    f[1, :, mod_len] = 0


def test_barrett_reduce_matches_jax_entry_ring(jctx):
    """The entry ring's tables: mod_len = 8190 < n/2 = 8192, so output
    coefficients 8190 and 8191 take the high-half subtract directly."""
    pn, n, mod_len = jctx.params.num_crt_prime, jctx.n, jctx.mod_len
    assert mod_len < n // 2
    primes = jctx.primes_np
    f = _residues(np.random.default_rng(21), primes, (2, pn, n))
    _edge_rows(f, primes, mod_len)
    u = tuple(np.array(v) for v in jctx.u_ntt)
    m = tuple(np.array(v) for v in jctx.m_ntt)
    got = _port_reduce(f, mod_len, n, u, m, jctx.m_crt_np, primes)
    want = _jax_reduce(f, mod_len, n, u, m, jctx.m_crt_np, primes,
                       jctx.mus_np)
    assert tuple(got.shape) == (2, pn, n // 2)
    _eq(got, want)


@pytest.mark.parametrize("mod_len", [8190, 8192], ids=["below_half", "half"])
def test_barrett_reduce_matches_jax_any_tables(jctx, mod_len):
    """The same function of its inputs with random tables, at a
    simple_dhs-shaped ring (mod_len < n/2) and at PRINCE's shape
    (mod_len = n/2: the high-half subtract reaches the output only through
    t = src[mod_len]); n = 16384 and the entry ring's primes."""
    n = 16384
    rng = np.random.default_rng(22 + mod_len)
    primes = jctx.primes_np
    pn = len(primes)
    f = _residues(rng, primes, (2, pn, n))
    _edge_rows(f, primes, mod_len)
    u = _pair(rng.integers(0, P, size=(pn, n), dtype=np.uint64), (pn, n))
    m = _pair(rng.integers(0, P, size=(pn, n), dtype=np.uint64), (pn, n))
    m_crt = _residues(rng, primes, (pn, n // 2))
    mus = tuple(np.array(v) for v in jctx.mus_np)
    got = _port_reduce(f, mod_len, n, u, m, m_crt, primes)
    want = _jax_reduce(f, mod_len, n, u, m, m_crt, primes, mus)
    _eq(got, want)


def test_barrett_combine_ignores_c1_below_mod_len(jctx):
    """The combine reads no coefficient of c1 below mod_len, which the
    plain version zeroes first as the JAX package does: the card's kernel
    drops that mask."""
    pn, n, mod_len = jctx.params.num_crt_prime, jctx.n, jctx.mod_len
    primes = torch.from_numpy(jctx.primes_np)
    rng = np.random.default_rng(23)
    f, c1, c2 = (torch.from_numpy(_residues(rng, jctx.primes_np, (2, pn, n)))
                 for _ in range(3))
    m_crt = torch.from_numpy(jctx.m_crt_np)
    got = barrett.barrett_combine(f, c1, c2, m_crt, primes, mod_len=mod_len,
                                  n=n)
    c1_low0 = c1.clone()
    c1_low0[..., :mod_len] = 0
    want = barrett.barrett_combine_plain(f, c1_low0, c2, m_crt, primes,
                                         mod_len=mod_len, n=n)
    _eq(got, want.numpy())


# ---- K3: the modulus switch, the dropped plane apart ----

def _switch_inputs(jctx, seed, length=512):
    pn = jctx.params.num_crt_prime
    primes = jctx.primes_np
    x = _residues(np.random.default_rng(seed), primes, (2, pn, length))
    pt = int(primes[pn - 1])
    c = (pt - 1) // 2
    special = [0, 1, 2, c - 2, c - 1, c, c + 1, c + 2, pt - 2, pt - 1]
    x[0, pn - 1, : len(special)] = special
    x[1, pn - 1, : len(special)] = special
    x[0, : pn - 1, : len(special)] = 0
    x[1, : pn - 1, : len(special)] = (primes[: pn - 1] - 1)[:, None]
    invp = jctx.invp_np[pn - 1, : pn - 1]
    return x, primes, invp


@pytest.mark.parametrize("mod_msg", [2, 3, 16])
def test_mod_switch_matches_jax(jctx, mod_msg):
    """mod_switch, and mod_switch_dropped over the uneven split of the
    entry ring's 4 planes into 2 + 1 + 1 (each part's kept planes with the
    dropped plane passed apart, as the crt-sharded step does), joined,
    against the JAX mod_switch; dirty residues about (p_t - 1) / 2, kept
    residues 0 and p - 1 (negative differences)."""
    x, primes, invp = _switch_inputs(jctx, 30 + mod_msg)
    pn = x.shape[1]
    want = np.asarray(jpw.mod_switch(
        jnp.asarray(x), jnp.asarray(primes), _j(jctx.mus_np),
        jnp.asarray(invp), mod_msg))
    tx, tp, ti = (torch.from_numpy(v) for v in (x, primes, invp))
    _eq(pw.mod_switch(tx, tp, ti, mod_msg), want)
    dropped = tx[:, pn - 1].contiguous()
    parts = []
    for c0, c1 in crt_split(pn, 3):
        k = min(c1, pn - 1) - c0
        sp = torch.from_numpy(np.append(primes[c0:c0 + k], primes[pn - 1]))
        parts.append(pw.mod_switch_dropped(tx[:, c0:c1], dropped, sp,
                                           ti[c0:c0 + k], mod_msg))
    assert [p.shape[1] for p in parts] == [2, 1, 0]
    _eq(torch.cat(parts, dim=1), want)


@settings(max_examples=25, deadline=None)
@given(st.integers(2, 16), st.integers(0, 2 ** 32 - 1))
def test_mod_switch_any_dirty(mod_msg, seed):
    """Random residues and mod_msg: the port's switch equals JAX's."""
    pr = jmake_params(*ENTRY)
    primes = np.array(pr.crt_primes, dtype=np.uint32)
    pn = len(primes)
    x = _residues(np.random.default_rng(seed), primes, (1, pn, 8))
    pt = int(primes[pn - 1])
    invp = np.array([pow(pt, -1, int(p)) for p in primes[: pn - 1]],
                    dtype=np.uint32)
    mus = tuple(np.array(v, dtype=np.uint32) for v in zip(
        *[jmodp.barrett_mu(int(p)) for p in primes]))
    want = jpw.mod_switch(jnp.asarray(x), jnp.asarray(primes), _j(mus),
                          jnp.asarray(invp), mod_msg)
    _eq(pw.mod_switch(torch.from_numpy(x), torch.from_numpy(primes),
                      torch.from_numpy(invp), mod_msg), want)


# ---- K4: the CRT add ----

@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "batch"])
def test_crt_add_matches_jax(jctx, lead):
    """One ciphertext and a batch; p - 1 + p - 1, p - 1 + 0 and 0 + 0."""
    primes = jctx.primes_np
    rng = np.random.default_rng(40 + len(lead))
    x = _residues(rng, primes, lead + (len(primes), 256))
    y = _residues(rng, primes, x.shape)
    x[..., :2] = (primes - 1)[:, None]
    y[..., :1] = (primes - 1)[:, None]
    y[..., 1:3] = 0
    x[..., 2] = 0
    _eq(pw.crt_add(torch.from_numpy(x), torch.from_numpy(y),
                   torch.from_numpy(primes)),
        jpw.crt_add(jnp.asarray(x), jnp.asarray(y), jnp.asarray(primes)))


# ---- the front ends' checks and dispatch ----

def _front_end_calls(x_pair, crt, primes, invp, mod_len, n, halves):
    """Each front end with `crt` (or x_pair's first word) as the operand of
    the tested dtype; icrt_combine16's is M's words, since its halves are
    int32 (`halves`, on the tested device)."""
    return {
        "ntt_mul": lambda: pw.ntt_mul(x_pair, x_pair),
        "barrett_combine": lambda: barrett.barrett_combine(
            x_pair[0], x_pair[0], x_pair[0], crt[0], primes, mod_len=mod_len,
            n=n),
        "mod_switch": lambda: pw.mod_switch(crt, primes, invp, 2),
        "crt_add": lambda: pw.crt_add(crt, crt, primes),
        "ntt_add": lambda: pw.ntt_add(x_pair, x_pair),
        "crt_from_raw": lambda: crt_ops.crt_from_raw(crt, primes),
        "crt_add_nx1": lambda: pw.crt_add_nx1(crt, crt[0, 0], primes),
        "crt_add_int": lambda: pw.crt_add_int(crt, 1, primes),
        "crt_add_int_rows": lambda: pw.crt_add_int_rows(crt, crt[:, 0, 0],
                                                        primes),
        "crt_mul_int": lambda: pw.crt_mul_int(crt, 3, primes),
        "icrt_split16": lambda: crt_ops.icrt_split_halves(crt),
        "icrt_combine16": lambda: crt_ops.icrt_combine_halves(
            halves, halves, crt[0, :, 0], 2),
    }


@pytest.mark.parametrize("name", ["ntt_mul", "barrett_combine", "mod_switch",
                                  "crt_add", "ntt_add", "crt_from_raw",
                                  "crt_add_nx1", "crt_add_int",
                                  "crt_add_int_rows", "crt_mul_int",
                                  "icrt_split16", "icrt_combine16"])
def test_front_ends_reject_meta_and_wrong_dtype(name):
    """A meta-device tensor raises (no plain version, no kernel), and so
    does a float32 or an int32 operand on the CPU (the plain versions take
    uint32; on the card `_cuda.check` refuses any other dtype)."""
    n, pn = 64, 3

    def u32(shape, device):
        return torch.zeros(shape, dtype=torch.uint32, device=device)

    for device, dtype, err in (("meta", torch.uint32, ValueError),
                               ("cpu", torch.float32, TypeError),
                               ("cpu", torch.int32, TypeError)):
        pair = (torch.zeros((2, pn, n), dtype=dtype, device=device),
                u32((2, pn, n), device))
        crt = torch.zeros((2, pn, n // 2), dtype=dtype, device=device)
        halves = torch.zeros((2, pn, n // 2), dtype=torch.int32,
                             device=device)
        calls = _front_end_calls(pair, crt, u32((pn,), device),
                                 u32((pn - 1,), device), n // 4, n, halves)
        with pytest.raises(err):
            calls[name]()


def test_plain_gate_step_reaches_no_front_end(monkeypatch):
    """GateStep(plain=True) runs the plain versions themselves: with the
    kernel front ends' dispatch (`ntt_kernels._is_cpu`, which K1-K4 and
    the NTT and relinearization front ends call) made to raise, it still
    runs on the CPU and equals the default step, which the patch stops."""
    step, args = entry.entry(device="cpu")
    args = tuple(a[:1].contiguous() for a in args)
    want = step(*args)

    def refuse(t):
        raise AssertionError("a kernel front end was called")

    monkeypatch.setattr(nk, "_is_cpu", refuse)
    got = GateStep(step.ctx, 0, plain=True)(*args)
    _eq(got, want.numpy())
    with pytest.raises(AssertionError, match="front end"):
        GateStep(step.ctx, 0)(*args)


# ---- the byte bounds of chip_smoke.py, by hand at PRINCE level 0 ----

B, PNUM, N = 32, 25, 32768          # prince_l0: one u32 plane 104.9 MB
PLANE = B * PNUM * N * 4


@pytest.mark.parametrize("case", [
    # the AND: a, b and the output, each a pair of u32 planes
    ("and", lambda: chip_smoke.zp_mul_model(B * PNUM * N, B * PNUM * N),
     6 * PLANE, 629.1),
    # a Barrett product: a and the output pairs, the [25, n] table pair once
    ("barrett product", lambda: chip_smoke.zp_mul_model(B * PNUM * N,
                                                        PNUM * N),
     4 * PLANE + PNUM * N * 8, 426.0),
    # the combine at mod_len = n/2: f and c2 below n/2 (half a plane each),
    # the output's half plane, c1 only at index mod_len, f, c1, c2 at index
    # mod_len (past n/2) in each of the 800 rows, m_crt below mod_len - 1
    # and the primes
    ("barrett combine", lambda: chip_smoke.barrett_combine_model(
        B * PNUM, PNUM, N, N // 2),
     3 * PLANE // 2 + 3 * B * PNUM * 4 + PNUM * (N // 2 - 1) * 4 + PNUM * 4,
     158.9),
    # the switch: 25 planes of n/2 in (24 kept and the dropped one), 24 out,
    # 25 primes and 24 inverses
    ("mod switch", lambda: chip_smoke.mod_switch_model(B, PNUM - 1, N // 2),
     B * (2 * PNUM - 1) * (N // 2) * 4 + (2 * PNUM - 1) * 4, 102.8),
], ids=lambda c: c[0])
def test_pointwise_byte_bounds_by_hand(case):
    _, model, want, mb = case
    nbytes, _ = model()
    assert nbytes == want
    assert round(nbytes / 1e6, 1) == mb
