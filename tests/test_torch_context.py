"""The port's Context (cuhe_tpu_torch/context.py): its own tables equal the
JAX Context's bit for bit, a context built from the JAX Context's numpy
state equals one built from the parameters, and the state round-trips."""

import numpy as np
import pytest
import torch

from cuhe_tpu.context import Context as JContext
from cuhe_tpu.params import make_params as jmake_params
from cuhe_tpu_torch.context import Context
from cuhe_tpu_torch.params import make_params

CFG = (3, 2, 16, 50, 25, 8191)


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


def _jax_state(jctx):
    pr = jctx.params
    pair = lambda p: tuple(np.asarray(v) for v in p)  # noqa: E731
    return {
        "params": (pr.depth, pr.mod_msg, pr.log_relin, pr.log_coeff_min,
                   pr.log_coeff_cut, pr.m_size),
        "primes_np": jctx.primes_np, "mus_np": jctx.mus_np,
        "invp_np": jctx.invp_np, "icrt": jctx._icrt,
        "m_crt_np": jctx.m_crt_np, "m_ntt": pair(jctx.m_ntt),
        "u_ntt": pair(jctx.u_ntt), "ek": pair(jctx.ek_ntt),
    }


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    assert tuple(a["params"]) == tuple(b["params"])
    for k in ("primes_np", "invp_np", "m_crt_np"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("mus_np", "m_ntt", "u_ntt", "ek"):
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a["icrt"].keys() == b["icrt"].keys()
    for lvl in a["icrt"]:
        for x, y in zip(a["icrt"][lvl], b["icrt"][lvl]):
            np.testing.assert_array_equal(x, y)


def test_context_tables_equal_jax(contexts):
    jctx, ctx = contexts
    assert ctx.n == jctx.n and ctx.mod_len == jctx.mod_len
    assert ctx.params.crt_primes == jctx.params.crt_primes
    assert ctx.m_ntt[0].dtype == torch.uint32
    _assert_state_equal(ctx.numpy_state(), _jax_state(jctx))


def test_from_numpy_state_round_trips(contexts):
    jctx, ctx = contexts
    loaded = Context.from_numpy_state(_jax_state(jctx), device="cpu")
    _assert_state_equal(loaded.numpy_state(), ctx.numpy_state())
    again = Context.from_numpy_state(loaded.numpy_state(), device="cpu")
    _assert_state_equal(again.numpy_state(), ctx.numpy_state())


def test_from_numpy_state_rejects_bad_state(contexts):
    jctx, _ = contexts
    state = _jax_state(jctx)
    with pytest.raises(KeyError):
        Context.from_numpy_state({k: v for k, v in state.items() if k != "ek"},
                                 device="cpu")
    bad = dict(state, primes_np=state["primes_np"][::-1].copy())
    with pytest.raises(ValueError):
        Context.from_numpy_state(bad, device="cpu")
    bad = dict(state, m_ntt=tuple(v[:, :8] for v in state["m_ntt"]))
    with pytest.raises(ValueError):
        Context.from_numpy_state(bad, device="cpu")
