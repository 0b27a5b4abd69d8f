"""The port's Z_P pair arithmetic (cuhe_tpu_torch/ops/modp.py) against the
JAX package's modp and a Python big-int oracle, bit for bit, with the edge
values of tests/test_modp.py (near P, near 2^32, 0, 2^64 - 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuhe_tpu.ops import modp as jmodp
from cuhe_tpu_torch.ops import modp
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = modp.P
N = 1 << 12
SPECIAL = (0, 1, 0xFFFFFFFF, 1 << 32, (1 << 32) + 1, P - 2, P - 1, P, P + 1,
           (1 << 64) - 1, (1 << 64) - 2, P + 2, 1 << 63)


def _rand_u64(seed, canonical):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 64, size=N, dtype=np.uint64)
    x[: len(SPECIAL)] = np.array(SPECIAL, dtype=np.uint64)
    if canonical:
        x = (x.astype(object) % P).astype(np.uint64)
    return x


def _both(x):
    """(port pair, JAX pair) of the same uint64 values."""
    return modp.pair_from_u64(x), jmodp.pair_from_u64(x)


def _u64(pair):
    return np.asarray(pair[0]).astype(np.uint64) | (
        np.asarray(pair[1]).astype(np.uint64) << np.uint64(32))


@pytest.mark.parametrize("name,oracle,canonical", [
    ("add_modp", lambda a, b: (a + b) % P, True),
    ("sub_modp", lambda a, b: (a - b) % P, True),
    ("mul_modp", lambda a, b: (a * b) % P, False),
])
def test_pair_ops_match_jax_and_oracle(name, oracle, canonical):
    a, b = _rand_u64(1, canonical), _rand_u64(2, canonical)[::-1].copy()
    (pa, ja), (pb, jb) = _both(a), _both(b)
    got = getattr(modp, name)(pa, pb)
    assert got[0].dtype == torch.uint32
    want = getattr(jmodp, name)(ja, jb)
    np.testing.assert_array_equal(_u64(got), _u64(want))
    ref = [oracle(int(x), int(y)) for x, y in zip(a, b)]
    np.testing.assert_array_equal(_u64(got), np.array(ref, dtype=np.uint64))


def test_canonicalize_and_mod_u32():
    x = _rand_u64(3, canonical=False)
    px, jx = _both(x)
    np.testing.assert_array_equal(_u64(modp.canonicalize(px)),
                                  _u64(jmodp.canonicalize(jx)))
    for p in (4294967291, 65537, 7681, 3):
        got = modp.mod_u32(px, torch.tensor([p]).to(torch.uint32))
        mu = jmodp.barrett_mu(p)
        want = jmodp.mod_u32(jx, jnp.uint32(p), (jnp.uint32(mu[0]),
                                                 jnp.uint32(mu[1])))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), np.array([int(v) % p for v in x], dtype=np.uint32))


def test_mulmod_u32_and_conversions():
    rng = np.random.default_rng(4)
    p = 4294967291
    a = rng.integers(0, p, size=N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, p, size=N, dtype=np.uint64).astype(np.uint32)
    a[:2] = b[:2] = p - 1
    got = modp.mulmod_u32(torch.from_numpy(a), torch.from_numpy(b),
                          torch.tensor([p]).to(torch.uint32))
    mu = jmodp.barrett_mu(p)
    want = jmodp.mulmod_u32(jnp.asarray(a), jnp.asarray(b), jnp.uint32(p),
                            (jnp.uint32(mu[0]), jnp.uint32(mu[1])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert modp.barrett_mu(p) == jmodp.barrett_mu(p)
    u = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    wide = modp.to_i64(torch.from_numpy(u))
    assert wide.tolist() == [int(v) for v in u]
    np.testing.assert_array_equal(modp.to_u32(wide).numpy(), u)


# Word values on both sides of 2^31 and at 2^32 - 1: their products cross
# 2^63 and reach (2^32 - 1)^2, which an int64 multiply wraps modulo 2^64.
WORDS = (0, 1, 3, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 2,
         (1 << 32) - 1)
# canonical values whose bit patterns sit at the int64 sign boundary and
# near P
CANON = (0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, (1 << 63) + 1,
         P - (1 << 32), P - 2, P - 1)


def _bits(vals):
    """Python ints < 2^64 -> their int64 bit patterns."""
    return torch.tensor([v - (1 << 64) if v >> 63 else v for v in vals],
                        dtype=torch.int64)


def _ints(bits):
    return [v % (1 << 64) for v in bits.tolist()]


def _wrap_case(name):
    """(got, want) of one wrapping operation of ops/modp.py on every pair
    of its extreme inputs, as Python ints."""
    if name == "mul32":
        a = [x for x in WORDS for _ in WORDS]
        b = [y for _ in WORDS for y in WORDS]
        lo, hi = modp.mul32(torch.tensor(a), torch.tensor(b))
        return (list(zip(lo.tolist(), hi.tolist())),
                [(x * y & 0xFFFFFFFF, x * y >> 32) for x, y in zip(a, b)])
    if name == "pack64":  # word pairs up to 2^64 - 1, reduced below P
        vals = list(CANON) + [P, P + 1, (1 << 64) - 2, (1 << 64) - 1]
        lo = torch.tensor([v & 0xFFFFFFFF for v in vals])
        hi = torch.tensor([v >> 32 for v in vals])
        return _ints(modp.pack64(lo, hi)), [v % P for v in vals]
    a = [x for x in CANON for _ in CANON]
    b = [y for _ in CANON for y in CANON]
    if name == "mul_bits64":
        w = (torch.tensor([y & 0xFFFFFFFF for y in b]),
             torch.tensor([y >> 32 for y in b]))
        return (_ints(modp.mul_bits64(_bits(a), w)),
                [x * y % P for x, y in zip(a, b)])
    op = {"add_bits64": lambda x, y: (x + y) % P,
          "sub_bits64": lambda x, y: (x - y) % P}[name]
    got = getattr(modp, name)(_bits(a), _bits(b))
    return _ints(got), [op(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("name", ["mul32", "pack64", "add_bits64",
                                  "sub_bits64", "mul_bits64"])
def test_wrapping_ops_at_the_extremes(name):
    """The operations whose int64 intermediates wrap modulo 2^64 equal
    Python ints on every pair of extreme inputs."""
    got, want = _wrap_case(name)
    assert got == want
