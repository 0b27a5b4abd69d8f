"""The port's polynomial Barrett reduction and modulus switch
(cuhe_tpu_torch/ops/barrett.py, ops/pointwise.py) against the JAX package,
bit for bit, on the entry configuration's tables."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuhe_tpu.context import Context as JContext
from cuhe_tpu.ops import barrett as jbarrett
from cuhe_tpu.ops import pointwise as jpw
from cuhe_tpu.params import make_params
from cuhe_tpu_torch.context import KERNELS
from cuhe_tpu_torch.ops import barrett, pointwise
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = (3, 2, 16, 50, 25, 8191)


@pytest.fixture(scope="module")
def jctx():
    return JContext(make_params(*CFG))


def _residues(seed, primes, shape):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return (x % primes.astype(np.uint64)[:, None]).astype(np.uint32)


def test_barrett_reduce_matches_jax(jctx):
    pn, n = jctx.params.num_crt_prime, jctx.n
    primes = jctx.primes_np
    f = _residues(1, primes, (2, pn, n))
    u = tuple(np.array(v) for v in jctx.u_ntt)
    m = tuple(np.array(v) for v in jctx.m_ntt)
    got = barrett.barrett_reduce(
        torch.from_numpy(f), mod_len=jctx.mod_len, n=n,
        u_ntt=tuple(map(torch.from_numpy, u)),
        m_ntt=tuple(map(torch.from_numpy, m)),
        m_crt=torch.from_numpy(jctx.m_crt_np), primes=torch.from_numpy(primes),
        ops=KERNELS)
    reduce = jax.jit(functools.partial(
        jbarrett.barrett_reduce, mod_len=jctx.mod_len, n=n, layout="mat"))
    want = reduce(jnp.asarray(f), u_ntt=jctx.u_ntt, m_ntt=jctx.m_ntt,
                  m_crt=jnp.asarray(jctx.m_crt_np), primes=jnp.asarray(primes),
                  mus=(jnp.asarray(jctx.mus_np[0]), jnp.asarray(jctx.mus_np[1])))
    assert got.shape == (2, pn, n // 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mod_switch_matches_jax(jctx):
    pn = jctx.params.num_crt_prime
    primes = jctx.primes_np
    x = _residues(2, primes, (2, pn, 4096))
    # dirty values on both sides of (p_t - 1) / 2 and odd/even, so that
    # x - dirty is negative for some planes (jnp % takes the divisor's sign)
    pt = int(primes[pn - 1])
    x[0, pn - 1, :6] = [0, 1, pt - 1, pt - 2, (pt - 1) // 2, (pt + 1) // 2]
    x[0, : pn - 1, :6] = 0
    invp = jctx.invp_np[pn - 1, : pn - 1]
    got = pointwise.mod_switch(torch.from_numpy(x), torch.from_numpy(primes),
                               torch.from_numpy(invp), jctx.params.mod_msg)
    want = jpw.mod_switch(jnp.asarray(x), jnp.asarray(primes),
                          (jnp.asarray(jctx.mus_np[0]),
                           jnp.asarray(jctx.mus_np[1])),
                          jnp.asarray(invp), jctx.params.mod_msg)
    assert got.shape == (2, pn - 1, 4096)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

