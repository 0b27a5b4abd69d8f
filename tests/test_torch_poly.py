"""The port's polynomial layer (cuhe_tpu_torch/poly.py) and the Context's
per-level conversions equal the JAX package's bit for bit (tolerance 0) on
the CPU, at make_params(3, 2, 16, 50, 25, 8191) with the same numpy-seeded
eval keys: r2c / c2r / c2n / n2c / mod_switch / relin at levels 0 and 1
and mul_one_many at level 0, each gate (plaintext variants included), mod_switch_to,
to_ints, poly_mul_ints and poly_mul_one_to_many; and the poly path's
AND -> relin -> modSwitch on one ciphertext equals GateStep on a batch of 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuhe_tpu import poly as jpoly
from cuhe_tpu.context import Context as JContext
from cuhe_tpu.ops import pointwise as jpw
from cuhe_tpu.params import make_params as jmake_params
from cuhe_tpu_torch import hostmath as hm
from cuhe_tpu_torch import poly
from cuhe_tpu_torch.context import Context
from cuhe_tpu_torch.ops import crt
from cuhe_tpu_torch.ops import pointwise as pw
from cuhe_tpu_torch.params import make_params
from cuhe_tpu_torch.step import GateStep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = (3, 2, 16, 50, 25, 8191)
# levels 0 and 1 (level 2, the last, is reached by mod_switch_to): each
# level of each conversion is one more XLA compile on the JAX side
LEVELS = (0, 1)


@pytest.fixture(scope="module")
def contexts():
    jctx = JContext(jmake_params(*CFG))
    rng = np.random.default_rng(0)
    pr = jctx.params
    shape = (pr.num_eval_key, pr.num_crt_prime, pr.ntt_len)
    ek = (rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32),
          rng.integers(0, 0xFFFFFFFF, size=shape, dtype=np.uint64).astype(np.uint32))
    jctx.set_eval_keys(*ek)
    ctx = Context(make_params(*CFG), device="cpu")
    ctx.set_eval_keys(*ek)
    return jctx, ctx


def _rand_poly(rng, n, q):
    return [int.from_bytes(rng.bytes((q.bit_length() + 23) // 8), "little") % q
            for _ in range(n)]


def _np(x):
    """numpy of a tensor, a jax array or a pair of either."""
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want):
    got, want = _np(got), _np(want)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _raw(ctx, lvl, seed, batch=None):
    """RAW words of random coefficients mod q_lvl, numpy [.., words, n/2]."""
    pr = ctx.params
    rng = np.random.default_rng(seed)
    q = pr.coeff_modulus(lvl)
    polys = [_rand_poly(rng, pr.mod_len, q) for _ in range(batch or 1)]
    words = np.stack([hm.ints_to_words(p, pr.words_coeff(lvl), pr.raw_len)
                      for p in polys])
    return words if batch else words[0]


@pytest.mark.parametrize("lvl", LEVELS)
def test_crt_from_raw_and_icrt_equal_jax(contexts, lvl):
    jctx, ctx = contexts
    raw = _raw(ctx, lvl, 10 + lvl)
    c = ctx.r2c(lvl, torch.from_numpy(raw))
    _eq(c, jctx._jit_r2c(lvl)(jnp.asarray(raw)))
    # the ICRT inverts it: RAW words of coefficients < q_lvl
    back = ctx.c2r(lvl, c)
    _eq(back, jctx._jit_c2r(lvl)(jnp.asarray(c.numpy())))
    np.testing.assert_array_equal(back.numpy(), raw)


def test_crt_from_raw_batched_and_at_word_edges():
    rng = np.random.default_rng(3)
    primes = np.array(make_params(*CFG).crt_primes, dtype=np.uint32)
    raw = rng.integers(0, 1 << 32, size=(2, 3, 5, 64), dtype=np.uint64)
    raw[0, 0, :, :4] = 0xFFFFFFFF
    raw = raw.astype(np.uint32)
    got = crt.crt_from_raw(torch.from_numpy(raw), torch.from_numpy(primes))
    assert tuple(got.shape) == (2, 3, len(primes), 64)
    for idx in np.ndindex(2, 3):
        ints = hm.words_to_ints(raw[idx])
        want = np.array([[v % p for v in ints] for p in primes.tolist()])
        np.testing.assert_array_equal(got[idx].numpy(), want)


def test_crt_pointwise_ops_equal_jax(contexts):
    """The CRT-domain gate arithmetic at its edges: residues p_i - 1 and 0,
    plaintext words up to 2^32 - 1 (a 33-bit sum), integers past p_i."""
    jctx, ctx = contexts
    primes = ctx.primes_np
    rng = np.random.default_rng(4)
    x = (rng.integers(0, 1 << 32, size=(2, len(primes), 256), dtype=np.uint64)
         % primes[:, None]).astype(np.uint32)
    y = (rng.integers(0, 1 << 32, size=x.shape, dtype=np.uint64)
         % primes[:, None]).astype(np.uint32)
    x[0, :, :2] = (primes - 1)[:, None]
    x[1, :, 0] = 0
    y[0, :, :2] = (primes - 1)[:, None]
    s = rng.integers(0, 1 << 32, size=256, dtype=np.uint64).astype(np.uint32)
    s[:2] = 0xFFFFFFFF
    tx, ty, ts, tp = (torch.from_numpy(v) for v in (x, y, s, primes))
    jx, jy, js, jp = (jnp.asarray(v) for v in (x, y, s, primes))
    mus = tuple(jnp.asarray(v) for v in jctx.mus_np)
    _eq(pw.crt_add(tx, ty, tp), jpw.crt_add(jx, jy, jp))
    _eq(pw.crt_add_nx1(tx, ts, tp), jpw.crt_add_nx1(jx, js, jp, mus))
    for a in (1, 12345, int(primes[0]) + 7, 0xFFFFFFFF):
        _eq(pw.crt_add_int(tx, a, tp), jpw.crt_add_int(jx, a, jp))
        _eq(pw.crt_mul_int(tx, a, tp), jpw.crt_mul_int(jx, a, jp, mus))
    # the inputs are left as they were
    np.testing.assert_array_equal(tx.numpy(), x)


@pytest.mark.parametrize("lvl", LEVELS)
def test_c2n_n2c_mod_switch_equal_jax(contexts, lvl):
    jctx, ctx = contexts
    a = ctx.r2c(lvl, torch.from_numpy(_raw(ctx, lvl, 20 + lvl)))
    b = ctx.r2c(lvl, torch.from_numpy(_raw(ctx, lvl, 30 + lvl)))
    na, nb = ctx.c2n(a), ctx.c2n(b)
    _eq(na, jctx._jit_c2n(lvl)(jnp.asarray(a.numpy())))
    # not a product: the inverse NTT gives the residues back
    back = ctx.n2c(lvl, False, na)
    np.testing.assert_array_equal(back.numpy(), a.numpy())
    _eq(back, jctx._jit_n2c(lvl, False)(tuple(jnp.asarray(v) for v in _np(na))))
    # a product: inverse NTT, then Barrett mod m(x)
    prod = pw.ntt_mul(na, nb)
    red = ctx.n2c(lvl, True, prod)
    _eq(red, jctx._jit_n2c(lvl, True)(tuple(jnp.asarray(v) for v in _np(prod))))
    if lvl + 1 < ctx.params.depth:
        _eq(ctx.mod_switch(lvl, red),
            jctx._jit_mod_switch(lvl)(jnp.asarray(red.numpy())))


@pytest.mark.parametrize("lvl", LEVELS)
def test_relin_equals_jax(contexts, lvl):
    jctx, ctx = contexts
    raw = _raw(ctx, lvl, 40 + lvl)
    _eq(ctx.relin(lvl, torch.from_numpy(raw)),
        jctx._jit_relin(lvl)(jnp.asarray(raw)))


def test_relin_without_eval_keys_raises():
    ctx = Context(make_params(*CFG), device="cpu")
    with pytest.raises(RuntimeError, match="relinearization keys"):
        ctx.relin(0, torch.zeros((4, 8192), dtype=torch.uint32))


# ---------------------------------------------------------------------------
# the poly layer against cuhe_tpu/poly.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def operands(contexts):
    jctx, ctx = contexts
    pr = ctx.params
    rng = np.random.default_rng(7)
    q = pr.coeff_modulus(0)
    a, b = (_rand_poly(rng, pr.mod_len, q) for _ in range(2))
    msg = [int(v) for v in rng.integers(0, 2, pr.mod_len)]

    def conv(mod, c, to):
        return getattr(mod, to)(c[0], mod.ctxt_from_ints(c[1], 0))

    out = {}
    for name, v in (("a", a), ("b", b)):
        for to in ("to_crt", "to_ntt"):
            out[name, to] = (conv(poly, (ctx, v), to),
                             conv(jpoly, (jctx, v), to))
    out["pt", "ntt"] = (poly.ptxt_to_ntt(ctx, poly.ptxt_from_ints(msg)),
                        jpoly.ptxt_to_ntt(jctx, jpoly.ptxt_from_ints(msg)))
    out["pt", "crt"] = (poly.ptxt_to_crt(ctx, poly.ptxt_from_ints(msg)),
                        jpoly.ptxt_to_crt(jctx, jpoly.ptxt_from_ints(msg)))
    out["ints"] = (a, b, msg)
    return out


def _same_ct(ctx, jctx, ct, jct):
    assert (ct.level, ct.domain, ct.is_prod) == (jct.level, jct.domain,
                                                 jct.is_prod)
    _eq(ct.data, jct.data)
    assert poly.to_ints(ctx, ct) == jpoly.to_ints(jctx, jct)


def test_conversions_equal_jax(contexts, operands):
    jctx, ctx = contexts
    for key in (("a", "to_crt"), ("a", "to_ntt"), ("b", "to_ntt")):
        _same_ct(ctx, jctx, *operands[key])
    for key in (("pt", "ntt"), ("pt", "crt")):
        pt, jpt = operands[key]
        assert pt.domain == jpt.domain
        _eq(pt.data, jpt.data)
    a = operands["ints"][0]
    raw = poly.to_raw(ctx, poly.ctxt_from_ints(a, 0))
    assert raw.domain == poly.RAW and poly.to_ints(ctx, raw) == a


@pytest.mark.parametrize("gate", ["and", "and_ptxt", "xor_crt", "xor_ntt",
                                  "xor_ptxt_crt", "xor_ptxt_ntt", "not"])
def test_gates_equal_jax(contexts, operands, gate):
    jctx, ctx = contexts
    a_c, a_n, b_c, b_n = (operands[k] for k in (
        ("a", "to_crt"), ("a", "to_ntt"), ("b", "to_crt"), ("b", "to_ntt")))
    pt_n, pt_c = operands["pt", "ntt"], operands["pt", "crt"]
    call = {
        "and": ("c_and", a_n, b_n), "and_ptxt": ("c_and_ptxt", a_n, pt_n),
        "xor_crt": ("c_xor", a_c, b_c), "xor_ntt": ("c_xor", a_n, b_n),
        "xor_ptxt_crt": ("c_xor_ptxt", a_c, pt_c),
        "xor_ptxt_ntt": ("c_xor_ptxt", a_n, pt_n), "not": ("c_not", a_c),
    }[gate]
    name, args = call[0], call[1:]
    got = getattr(poly, name)(ctx, *(x[0] for x in args))
    want = getattr(jpoly, name)(jctx, *(x[1] for x in args))
    _same_ct(ctx, jctx, got, want)


def test_gates_decrypt_to_plain_arithmetic(contexts, operands):
    """The gates' host values: XOR is the sum mod q, NOT adds 1 to the
    constant coefficient, AND with a plaintext is the product mod m(x)."""
    _, ctx = contexts
    a, b, msg = operands["ints"]
    q = ctx.params.coeff_modulus(0)
    x = poly.c_xor(ctx, operands["a", "to_crt"][0], operands["b", "to_crt"][0])
    assert poly.to_ints(ctx, x) == [(u + v) % q for u, v in zip(a, b)]
    x = poly.c_xor_ptxt(ctx, operands["a", "to_ntt"][0], operands["pt", "ntt"][0])
    assert poly.to_ints(ctx, x) == [(u + m) % q for u, m in zip(a, msg)]
    x = poly.c_not(ctx, operands["a", "to_crt"][0])
    assert poly.to_ints(ctx, x) == [(a[0] + 1) % q] + a[1:]
    x = poly.c_and_ptxt(ctx, operands["a", "to_ntt"][0], operands["pt", "ntt"][0])
    assert poly.to_ints(ctx, x) == poly.poly_mul_ints(ctx, a, msg, 0)


def test_relin_mod_switch_to_equal_jax(contexts, operands):
    jctx, ctx = contexts
    a_n, b_n = operands["a", "to_ntt"], operands["b", "to_ntt"]
    got = poly.relin(ctx, poly.c_and(ctx, a_n[0], b_n[0]))
    want = jpoly.relin(jctx, jpoly.c_and(jctx, a_n[1], b_n[1]))
    _same_ct(ctx, jctx, got, want)
    _same_ct(ctx, jctx, poly.mod_switch_to(ctx, got, 2),
             jpoly.mod_switch_to(jctx, want, 2))
    step = poly.mod_switch(ctx, poly.mod_switch(ctx, got))
    _eq(poly.mod_switch_to(ctx, got, 2).data, step.data)
    with pytest.raises(ValueError, match="last level"):
        poly.mod_switch(ctx, step)
    with pytest.raises(ValueError, match="unavailable"):
        poly.mod_switch_to(ctx, got, 3)


def test_poly_mul_equals_jax(contexts, operands, monkeypatch):
    jctx, ctx = contexts
    a, b, msg = operands["ints"]
    pr = ctx.params
    assert (poly.poly_mul_ints(ctx, a, b, 0)
            == jpoly.poly_mul_ints(jctx, a, b, 0))
    # Context.mul_one_many against the JAX closure poly_mul_ints ran
    raws = np.stack([hm.ints_to_words(v, pr.words_coeff(0), pr.raw_len)
                     for v in (a, b, msg, a)])
    a_ntt = operands["a", "to_ntt"]
    _eq(ctx.mul_one_many(0, torch.from_numpy(raws), a_ntt[0].data),
        jctx._jit_mul_one_many(0, 4)(jnp.asarray(raws), a_ntt[1].data))
    bs = [a, b, msg, [0] * pr.mod_len, [1] + [0] * (pr.mod_len - 1)]
    want = jpoly.poly_mul_one_to_many(jctx, a, bs, 0)
    assert poly.poly_mul_one_to_many(ctx, a, bs, 0) == want
    assert want[4] == a  # times 1
    # in batches of 2: the same products
    monkeypatch.setattr(poly, "MUL_MANY_CHUNK", 2)
    assert poly.poly_mul_one_to_many(ctx, a, bs, 0) == want


def test_poly_path_equals_gate_step_batch_1(contexts, operands):
    _, ctx = contexts
    a_n, b_n = operands["a", "to_ntt"][0], operands["b", "to_ntt"][0]
    got = poly.mod_switch(ctx, poly.relin(ctx, poly.c_and(ctx, a_n, b_n)))
    assert got.level == 1 and got.domain == poly.CRT
    step = GateStep(ctx, 0)
    want = step(*(v[None] for v in a_n.data + b_n.data))
    assert tuple(want.shape) == (1,) + tuple(got.data.shape)
    np.testing.assert_array_equal(got.data.numpy(), want[0].numpy())


def test_single_prime_level_passes_data_through():
    """At a level whose q is one CRT prime, RAW <-> CRT passes the data
    through unchanged (CuHE.cu:366-382): level 1 of make_params(2, 2, 16,
    20, 20, 8191), q = 1048571 < 2^20."""
    cfg = (2, 2, 16, 20, 20, 8191)
    ctx = Context(make_params(*cfg), device="cpu")
    jctx = JContext(jmake_params(*cfg))
    pr = ctx.params
    assert pr.log_coeff(1) <= pr.log_crt_prime and pr.words_coeff(1) == 1
    rng = np.random.default_rng(5)
    a = _rand_poly(rng, pr.mod_len, pr.coeff_modulus(1))
    raw = poly.to_raw(ctx, poly.ctxt_from_ints(a, 1))
    c = poly.to_crt(ctx, raw)
    assert c.domain == poly.CRT and c.data is raw.data
    assert poly.to_raw(ctx, c).data is c.data
    _eq(c.data, jpoly.to_crt(jctx, jpoly.ctxt_from_ints(a, 1)).data)
    assert poly.to_ints(ctx, c) == a
