"""The port's homomorphic PRINCE (cuhe_tpu_torch/models/prince.py) against the
JAX package's, on the CPU, bit for bit (tolerance 0):

  * the tables (round constants, M', ShiftRow) and the known answers;
  * each linear layer (AddRoundKey, AddRC, M', ShiftRow and its inverse,
    MixColumn and its inverse, the key expansion) on random CRT states at
    make_params(3, 2, 16, 50, 25, 8191), levels 0 and 1;
  * the S-box layer, forward and inverse, against the JAX package's staged
    layer (its default form) on the setup of
    tests/test_prince.py::test_sbox_stages_match_monolithic_layer: random
    eval keys from numpy default_rng(5), a random level-0 state.

The circuit end to end (the light depth-5 ring, against the JAX package
and the known answers; checkpoint and resume) is in
test_torch_prince_circuit.py and test_torch_prince_resume.py.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuhe_tpu.context import Context as JContext
from cuhe_tpu.models import prince as jpr
from cuhe_tpu.params import make_params as jmake_params
from cuhe_tpu_torch.context import Context
from cuhe_tpu_torch.models import prince as pr
from cuhe_tpu_torch.params import make_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = (3, 2, 16, 50, 25, 8191)


def test_tables_and_known_answers_equal_jax():
    assert pr.CIRCUIT_DEPTH == jpr.CIRCUIT_DEPTH == 25
    assert pr.RC_HEX == jpr.RC_HEX
    for rnd in range(12):
        assert pr.rc_bits(rnd) == jpr.rc_bits(rnd)
    np.testing.assert_array_equal(pr.mp_index_table(), jpr.mp_index_table())
    for inverse in (False, True):
        np.testing.assert_array_equal(pr.shiftrow_perm(inverse),
                                      jpr.shiftrow_perm(inverse))
    assert pr.Prince.EXPECTED_FINAL == jpr.Prince.EXPECTED_FINAL
    assert pr.Prince.EXPECTED_ROUNDS == jpr.Prince.EXPECTED_ROUNDS


def _random_state(rng, params, lvl, rows=64):
    pn = params.num_crt_prime_lvl(lvl)
    ps = np.array(params.crt_primes[:pn], dtype=np.uint64)
    return (rng.integers(0, 1 << 62, size=(rows, pn, params.crt_len),
                         dtype=np.uint64) % ps[None, :, None]).astype(np.uint32)


@pytest.fixture(scope="module")
def linear_princes():
    """(port Prince, JAX Prince) over bare contexts (no keys): the linear
    layers need only the primes."""
    jp = jpr.Prince(dhs=SimpleNamespace(ctx=JContext(jmake_params(*CFG))))
    p = pr.Prince(dhs=SimpleNamespace(ctx=Context(make_params(*CFG),
                                                  device="cpu")))
    return p, jp


@pytest.mark.parametrize("lvl", [0, 1])
def test_linear_layers_equal_jax(linear_princes, lvl):
    p, jp = linear_princes
    params = p.ctx.params
    rng = np.random.default_rng(60 + lvl)
    s, k = (_random_state(rng, params, lvl) for _ in range(2))
    ts, tk = torch.from_numpy(s), torch.from_numpy(k)
    js, jk = jnp.asarray(s), jnp.asarray(k)

    def same(got, want, what):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)

    same(p.add_round_key(ts, tk, lvl), jp.add_round_key(js, jk, lvl),
         "add_round_key")
    for rnd in (0, 1, 11):
        same(p.add_rc(ts, rnd, lvl), jp.add_rc(js, rnd, lvl), f"add_rc {rnd}")
    same(p.m_p(ts, lvl), jp.m_p(js, lvl), "m_p")
    same(p.shift_row(ts), jp.shift_row(js), "shift_row")
    same(p.inv_shift_row(ts), jp.inv_shift_row(js), "inv_shift_row")
    same(p.mix_column(ts, lvl), jp.mix_column(js, lvl), "mix_column")
    same(p.inv_mix_column(ts, lvl), jp.inv_mix_column(js, lvl),
         "inv_mix_column")
    same(p.key_expansion(tk, lvl), jp.key_expansion(jk, lvl), "key_expansion")
    # the key planes cut to a level's primes, as encrypt_blocks adds them
    pn = params.num_crt_prime_lvl(lvl + 1)
    same(p.add_round_key(ts[:, :pn], tk[:, :pn], lvl + 1),
         jp.add_round_key(js[:, :pn], jk[:, :pn], lvl + 1), "cut planes")
    # nothing writes into its input (add_rc writes coefficient 0 of a copy)
    np.testing.assert_array_equal(ts.numpy(), s)
    np.testing.assert_array_equal(tk.numpy(), k)


@pytest.fixture(scope="module")
def sbox_setup():
    """The CPU setup of test_sbox_stages_match_monolithic_layer, in both
    packages: random eval keys and a random level-0 state from
    default_rng(5)."""
    params = jmake_params(*CFG)
    jctx = JContext(params)
    rng = np.random.default_rng(5)
    shape = (params.num_eval_key, params.num_crt_prime, params.ntt_len)
    ek_lo = rng.integers(0, 1 << 32, size=shape,
                         dtype=np.uint64).astype(np.uint32)
    ek_hi = rng.integers(0, 0xFFFFFFFF, size=shape,
                         dtype=np.uint64).astype(np.uint32)
    jctx.set_eval_keys(ek_lo, ek_hi)
    state = _random_state(rng, params, 0)
    ctx = Context(make_params(*CFG), device="cpu")
    ctx.set_eval_keys(ek_lo, ek_hi)
    return (pr.Prince(dhs=SimpleNamespace(ctx=ctx)),
            jpr.Prince(dhs=SimpleNamespace(ctx=jctx)), state)


@pytest.mark.parametrize("inverse", [False, True])
def test_sbox_layer_equals_jax_stages(sbox_setup, inverse):
    p, jp, state = sbox_setup
    stages = [(nm, jax.jit(fn)) for nm, fn in
              jp._build_sbox_stages(0, inverse)]
    want = np.asarray(jp._run_sbox_stages(stages, jnp.asarray(state),
                                          jp.table_args()))
    p.level = 0
    got = p.sbox_layer(torch.from_numpy(state), inverse=inverse)
    assert p.level == 2
    assert got.dtype == torch.uint32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
