"""The inverse NTT of a Z_P product (`ntt_kernels.inv_linear_mul`), which
the card runs as one launch of the one-pass inverse taking the product at
its load, on the CPU: its plain version equals K1's plain version then the
plain inverse, and the JAX package's `mul_modp` then `inv_linear`, bit for
bit at 16k, 32k and 64k, with the second operand full-shaped and broadcast
as a [pnum, n] table, on edge words; `barrett_reduce` through either set
of front ends equals the JAX package's; `GateStep(plain=True)` equals the
step as it was composed with K1 apart.  The card's side is
tests/test_torch_ntt_card.py and chip_smoke.py phase 2."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuhe_tpu.ops import barrett as jbarrett
from cuhe_tpu.ops import modp as jmodp
from cuhe_tpu.ops import ntt_kernels as jnk
from cuhe_tpu_torch import entry
from cuhe_tpu_torch.context import KERNELS, PLAIN
from cuhe_tpu_torch.ops import barrett, modp
from cuhe_tpu_torch.ops import ntt_kernels as nk
from cuhe_tpu_torch.ops import pointwise as pw
from cuhe_tpu_torch.step import GateStep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = modp.P
SIZES = (16384, 32768, 65536)
# words < P whose halves are 0, 1 and 2^32 - 1, and words at and above P:
# the product takes any 64-bit words
EDGES = (0, 1, P - 1, (1 << 32) - 1, 1 << 32, P, (1 << 64) - 1)
PRIMES = np.array([4294967291, 65537, 7681], np.uint32)


def _words(seed, shape):
    """uint64 words < P, with every edge word in each row and every
    fifth word of the rest an edge word."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=shape, dtype=np.uint64)
    edges = np.array(EDGES, np.uint64)
    v[..., :len(EDGES)] = edges
    pick = rng.random(shape) < 0.2
    v[pick] = edges[rng.integers(0, len(EDGES), size=int(pick.sum()))]
    return v


def _np_pair(v):
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def _t(pair):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in pair)


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _jmu(p):
    mus = np.array([jmodp.barrett_mu(int(q)) for q in p], np.uint64)
    return (jnp.asarray(mus[:, 0].astype(np.uint32)),
            jnp.asarray(mus[:, 1].astype(np.uint32)))


@pytest.mark.parametrize("y_shape", ("full", "broadcast"))
@pytest.mark.parametrize("n", SIZES)
def test_inverse_of_a_product_matches_k1_then_inverse_and_jax(n, y_shape):
    x = _np_pair(_words(n, (2, 3, n)))
    y = _np_pair(_words(n + 1, (2, 3, n) if y_shape == "full" else (3, n)))
    p = torch.from_numpy(PRIMES)
    got = nk.inv_linear_mul(_t(x), _t(y), n, p)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (2, 3, n)
    plain = nk.inv_linear_mul_plain(_t(x), _t(y), n, p)
    composed = nk.inv_linear_plain(pw.ntt_mul_plain(_t(x), _t(y)), n, p)
    want = jnk.inv_linear(jmodp.mul_modp(_j(x), _j(y)), n,
                          jnp.asarray(PRIMES), _jmu(PRIMES), layout="mat")
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), composed.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("x_shape, y_shape", [
    ((2, 3, 16384), (2, 16384)),       # not a suffix of x's shape
    ((2, 3, 16384), (4, 3, 16384)),    # longer than x's shape
    ((2, 3, 8192), (3, 8192)),         # not of length n
], ids=("not_a_suffix", "longer", "not_n"))
def test_inverse_of_a_product_refuses_a_shape(x_shape, y_shape):
    x = (torch.zeros(x_shape, dtype=torch.uint32),) * 2
    y = (torch.zeros(y_shape, dtype=torch.uint32),) * 2
    with pytest.raises(ValueError, match="inv_linear_mul"):
        nk.inv_linear_mul(x, y, 16384, torch.from_numpy(PRIMES))


@functools.lru_cache(maxsize=None)
def _jax_reduce_fn(mod_len, n):
    return jax.jit(functools.partial(jbarrett.barrett_reduce, mod_len=mod_len,
                                     n=n, layout="mat"))


@pytest.mark.parametrize("ops", (KERNELS, PLAIN), ids=("front_end", "plain"))
def test_barrett_reduce_with_inverse_of_a_product_matches_jax(ops):
    """PRINCE's shape (mod_len = n/2) at n = 16384, random tables and
    residues, plane 0 of ciphertext 0 all p - 1."""
    n, mod_len = 16384, 8192
    rng = np.random.default_rng(20)
    f = (rng.integers(0, 1 << 32, size=(2, 3, n), dtype=np.uint64)
         % PRIMES.astype(np.uint64)[:, None]).astype(np.uint32)
    f[0, 0] = PRIMES[0] - 1
    u, m = (_np_pair(_words(s, (3, n))) for s in (21, 22))
    m_crt = (rng.integers(0, 1 << 32, size=(3, n // 2), dtype=np.uint64)
             % PRIMES.astype(np.uint64)[:, None]).astype(np.uint32)
    got = barrett.barrett_reduce(
        torch.from_numpy(f), mod_len=mod_len, n=n, u_ntt=_t(u), m_ntt=_t(m),
        m_crt=torch.from_numpy(m_crt), primes=torch.from_numpy(PRIMES),
        ops=ops)
    mus = np.array([jmodp.barrett_mu(int(q)) for q in PRIMES], np.uint64)
    want = _jax_reduce_fn(mod_len, n)(
        jnp.asarray(f), u_ntt=_j(u), m_ntt=_j(m), m_crt=jnp.asarray(m_crt),
        primes=jnp.asarray(PRIMES),
        mus=(jnp.asarray(mus[:, 0].astype(np.uint32)),
             jnp.asarray(mus[:, 1].astype(np.uint32))))
    assert tuple(got.shape) == (2, 3, n // 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _k1_then_inverse(x, y, n, p):
    return nk.inv_linear_plain(pw.ntt_mul_plain(x, y), n, p)


class _StepWithK1(GateStep):
    """The step as it was composed before the products moved into the
    inverses: the AND and Barrett's two products each by K1's plain
    version, then the plain inverse."""

    def __init__(self, ctx, lvl):
        super().__init__(ctx, lvl, plain=True)
        self.ops = dataclasses.replace(PLAIN, inv_mul=_k1_then_inverse)


def test_plain_gate_step_output_is_unchanged():
    step, args = entry.entry(device="cpu")
    args = tuple(a[:1].contiguous() for a in args)
    got = GateStep(step.ctx, 0, plain=True)(*args)
    want = _StepWithK1(step.ctx, 0)(*args)
    assert tuple(got.shape) == (1, 3, 8192)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
