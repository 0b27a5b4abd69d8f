"""The port's global-context API (cuhe_tpu_torch/api.py) and checkpoints
(cuhe_tpu_torch/utils/checkpoint.py), on the CPU, against the JAX package
bit for bit (tolerance 0).

The API tests mirror tests/test_api.py and tests/test_api_extras.py
(setParameters -> initCuHE -> x2n -> cAnd -> relin -> modSwitch -> x2z) and
compare each result with the JAX package's.  The checkpoints are the same
.npz format both ways: a JAX checkpoint loads in the port and a port
checkpoint in the JAX package, with equal arrays, and a factorization
mismatch is refused by both.
"""

import numpy as np
import pytest
import torch

from cuhe_tpu import api as japi
from cuhe_tpu import poly as jpoly
from cuhe_tpu.utils import checkpoint as jckpt
from cuhe_tpu_torch import api, poly
from cuhe_tpu_torch.ops import ntt
from cuhe_tpu_torch.utils import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = (3, 2, 16, 50, 25, 8191)


@pytest.fixture(scope="module")
def contexts():
    api.setParameters(*CFG)
    ctx = api.initCuHE(device="cpu")
    japi.setParameters(*CFG)
    jctx = japi.initCuHE()
    rng = np.random.default_rng(0)
    pr = ctx.params
    shape = (pr.num_eval_key, pr.num_crt_prime, pr.ntt_len)
    ek = (rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32),
          rng.integers(0, 0xFFFFFFFF, size=shape, dtype=np.uint64).astype(np.uint32))
    api.initRelinearization(*ek)
    japi.initRelinearization(*ek)
    yield jctx, ctx
    api.resetParameters()
    japi.resetParameters()


def _rand_poly(rng, n, q):
    return [int.from_bytes(rng.bytes((q.bit_length() + 23) // 8), "little") % q
            for _ in range(n)]


def test_domain_state_machine_and_xor(contexts):
    _, ctx = contexts
    assert api.context() is ctx
    n_coeff = ctx.params.mod_len
    rng = np.random.default_rng(3)
    q = ctx.params.coeff_moduli[0]
    a = [int(v) for v in rng.integers(0, min(q, 1 << 40), size=n_coeff)]
    b = [int(v) for v in rng.integers(0, min(q, 1 << 40), size=n_coeff)]
    x, y = api.CuCtxt(a, level=0), api.CuCtxt(b, level=0)
    assert x.domain == poly.ZZX
    x.x2c()
    y.x2r().x2c()
    assert x.domain == poly.CRT and y.domain == poly.CRT
    assert api.cXor(x, y).x2z() == [(ai + bi) % q for ai, bi in zip(a, b)]


def test_cand_relin_modswitch_equal_jax(contexts):
    _, ctx = contexts
    n_coeff = ctx.params.mod_len
    rng = np.random.default_rng(5)
    a = [int(v) for v in rng.integers(0, 1 << 20, size=n_coeff)]
    b = [int(v) for v in rng.integers(0, 1 << 20, size=n_coeff)]

    z = api.cAnd(api.CuCtxt(a, 0).x2n(), api.CuCtxt(b, 0).x2n())
    jz = japi.cAnd(japi.CuCtxt(a, 0).x2n(), japi.CuCtxt(b, 0).x2n())
    prod = z.copy()
    assert prod.x2z() == jz.copy().x2z()
    fa = poly.to_ntt(ctx, poly.ctxt_from_ints(a, 0))
    fb = poly.to_ntt(ctx, poly.ctxt_from_ints(b, 0))
    assert prod.x2z() == poly.to_ints(ctx, poly.c_and(ctx, fa, fb))
    z.relin().modSwitch()
    jz.relin().modSwitch()
    assert z.level == 1 and z.logq() == ctx.params.log_coeff(1)
    assert z.x2z() == jz.x2z()


def test_cnot_and_modswitch(contexts):
    _, ctx = contexts
    rng = np.random.default_rng(9)
    a = [int(v) for v in rng.integers(0, 1 << 20, size=ctx.params.mod_len)]
    x = api.CuCtxt(a, level=0)
    x.x2c()
    y = api.cNot(x)
    assert y.level == 0
    y.modSwitch()
    assert y.level == 1 and y.logq() == ctx.params.log_coeff(1)
    jy = japi.cNot(japi.CuCtxt(a, level=0).x2c()).modSwitch()
    assert y.x2z() == jy.x2z()
    assert api.CuCtxt(a, 0).x2c().modSwitch(2).level == 2


def test_ptxt_gates_equal_jax(contexts):
    """cAnd(ct, pt) / cXor(ct, pt): the NX1 broadcasts (CuHE.cu:123-202)."""
    _, ctx = contexts
    pr = ctx.params
    q = pr.coeff_modulus(0)
    rng = np.random.default_rng(11)
    a = _rand_poly(rng, pr.mod_len, q)
    msg = [int(b) for b in rng.integers(0, 2, pr.mod_len)]
    want = [(x + m) % q for x, m in zip(a, msg)]
    for to in ("x2n", "x2c"):
        ct = getattr(api.CuCtxt(a, 0), to)()
        pt = getattr(api.CuPtxt(msg), to)()
        assert pt.domain == {"x2n": poly.NTT, "x2c": poly.CRT}[to]
        assert api.cXor(ct, pt).x2z() == want
        jct = getattr(japi.CuCtxt(a, 0), to)()
        assert japi.cXor(jct, getattr(japi.CuPtxt(msg), to)()).x2z() == want
    got = api.cAnd(api.CuCtxt(a, 0).x2n(), api.CuPtxt(msg).x2n()).x2z()
    jgot = japi.cAnd(japi.CuCtxt(a, 0).x2n(), japi.CuPtxt(msg).x2n()).x2z()
    assert got == jgot == poly.poly_mul_ints(ctx, a, msg, 0)
    with pytest.raises(ValueError, match="NTT -> CRT"):
        api.CuPtxt(msg).x2n().x2c()


def test_globals_and_aliases(contexts, monkeypatch):
    _, ctx = contexts
    assert api.c_and is api.cAnd and api.init_cuhe is api.initCuHE
    assert api.set_parameters is api.setParameters
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    api.multiGPUs(2)
    assert api.numGPUs() == 2
    api.multiGPUs(1)
    assert api.numGPUs() == 4
    monkeypatch.setattr(api, "_params", None)
    with pytest.raises(RuntimeError, match="setParameters"):
        api.initCuHE(device="cpu")
    monkeypatch.undo()
    api.setContext(ctx)
    assert api.context() is ctx and api._params is ctx.params


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

def _ciphertexts(jctx, ctx, seed):
    pr = ctx.params
    a = _rand_poly(np.random.default_rng(seed), pr.mod_len, pr.coeff_modulus(0))
    return a, [(to, getattr(poly, to)(ctx, poly.ctxt_from_ints(a, 0)),
                getattr(jpoly, to)(jctx, jpoly.ctxt_from_ints(a, 0)))
               for to in ("to_raw", "to_crt", "to_ntt")]


def _arrays(ct):
    data = ct.data if isinstance(ct.data, tuple) else (ct.data,)
    return [v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for v in data]


def _same(ct, jct):
    assert (ct.level, ct.domain, ct.is_prod) == (jct.level, jct.domain,
                                                 jct.is_prod)
    for x, y in zip(_arrays(ct), _arrays(jct), strict=True):
        assert x.dtype == y.dtype == np.uint32
        np.testing.assert_array_equal(x, y)


def test_checkpoint_jax_to_port_and_back(contexts, tmp_path):
    jctx, ctx = contexts
    a, cts = _ciphertexts(jctx, ctx, 21)
    for to, ct, jct in cts:
        path = str(tmp_path / f"{to}_jax.npz")
        jckpt.save_ctxt(path, jct)
        back = ckpt.load_ctxt(path, device="cpu")
        _same(back, jct)
        _same(back, ct)
        assert poly.to_ints(ctx, back) == a
        path = str(tmp_path / f"{to}_port.npz")
        ckpt.save_ctxt(path, ct)
        jback = jckpt.load_ctxt(path)
        _same(ct, jback)
        assert jpoly.to_ints(jctx, jback) == a
    # a product in the NTT domain keeps its flag
    x = poly.c_and(ctx, cts[2][1], cts[2][1])
    path = str(tmp_path / "prod.npz")
    ckpt.save_ctxt(path, x)
    _same(ckpt.load_ctxt(path, device="cpu"), jckpt.load_ctxt(path))
    with pytest.raises(ValueError, match="host-domain"):
        ckpt.save_ctxt(path, poly.ctxt_from_ints(a, 0))


def test_checkpoint_rejects_factorization_mismatch(contexts, tmp_path):
    jctx, ctx = contexts
    _, cts = _ciphertexts(jctx, ctx, 22)
    path = str(tmp_path / "ct.npz")
    ckpt.save_ctxt(path, cts[2][1])
    z = dict(np.load(path))
    assert int(z["format_version"]) == ckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION
    good = z["ntt_factorization"].copy()
    assert tuple(good) == ntt.factors(ctx.n)
    z["ntt_factorization"] = np.asarray([good[0] // 2, good[1] * 2])
    np.savez_compressed(path, **z)
    for load in (lambda: ckpt.load_ctxt(path, device="cpu"),
                 lambda: jckpt.load_ctxt(path)):
        with pytest.raises(ValueError, match="factorization"):
            load()
    # unversioned NTT-domain checkpoints are refused as well
    z.pop("format_version")
    z["ntt_factorization"] = good
    np.savez_compressed(path, **z)
    with pytest.raises(ValueError, match="unversioned"):
        ckpt.load_ctxt(path, device="cpu")


def test_state_checkpoint_both_ways(tmp_path):
    st = np.arange(24, dtype=np.uint32).reshape(2, 3, 4)
    n = 16384
    for i, (save, load) in enumerate((
            (jckpt.save_state, lambda p, **k: ckpt.load_state(p, device="cpu", **k)),
            (ckpt.save_state, jckpt.load_state))):
        path = str(tmp_path / f"st{i}.npz")
        save(path, torch.from_numpy(st) if save is ckpt.save_state else st,
             3, done=1)
        back, lvl = load(path)
        assert lvl == 3 and np.array_equal(np.asarray(back), st)
        path = str(tmp_path / f"st{i}_ntt.npz")
        save(path, st, 3, ntt_len=n)
        back, _ = load(path, ntt_len=n)
        assert np.array_equal(np.asarray(back), st)
    z = dict(np.load(path))
    z["ntt_factorization"] = np.asarray([64, 256])
    np.savez_compressed(path, **z)
    with pytest.raises(ValueError, match="factorization"):
        ckpt.load_state(path, ntt_len=n, device="cpu")
    # saved without the tag, loaded as NTT-domain data
    path = str(tmp_path / "plain.npz")
    ckpt.save_state(path, st, 0)
    with pytest.raises(ValueError, match="without an NTT factorization"):
        ckpt.load_state(path, ntt_len=n, device="cpu")
