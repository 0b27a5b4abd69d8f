"""The port's NTT front ends (cuhe_tpu_torch/ops/ntt_kernels.py) against the
JAX package: the Pallas kernels in interpret mode at 16k, the XLA path at
32k (the (256, 128) factorization that fixes the mat layout), and the DFT
oracle.  On the CPU the front ends run their plain versions; the CUDA
kernels are held against the same plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import torch

from cuhe_tpu.ops import modp as jmodp
from cuhe_tpu.ops import ntt_kernels as jnk
from cuhe_tpu_torch.ops import modp, ntt
from cuhe_tpu_torch.ops import ntt_kernels as nk

PRIMES = np.array([4294967291, 65537, 7681], np.uint32)


def _jmu(p):
    mus = np.array([jmodp.barrett_mu(int(q)) for q in p], np.uint64)
    return (jnp.asarray(mus[:, 0].astype(np.uint32)),
            jnp.asarray(mus[:, 1].astype(np.uint32)))


def _coeffs(seed, b, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(b, n // 2),
                        dtype=np.uint64).astype(np.uint32)


def _eq_pair(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_fwd_inv_match_pallas_interpret_16k():
    n = 16384
    x = _coeffs(1, 3, n)
    got = nk.fwd_linear(torch.from_numpy(x), n)
    want = jnk.ntt_fwd(jnp.asarray(x), n, layout="mat", bt=3, interpret=True)
    _eq_pair(got, (np.asarray(want[0]).reshape(3, n),
                   np.asarray(want[1]).reshape(3, n)))
    back = nk.inv_linear(got, n, torch.from_numpy(PRIMES))
    jback = jnk.intt_modcrt(want, n, jnp.asarray(PRIMES), _jmu(PRIMES),
                            layout="mat", bt=3, interpret=True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    # the round trip recovers the zero-extended input mod p
    full = np.concatenate([x, np.zeros_like(x)], axis=1).astype(np.uint64)
    np.testing.assert_array_equal(back.numpy(),
                                  (full % PRIMES[:, None]).astype(np.uint32))


def test_fwd_inv_match_xla_path_32k():
    n = 32768
    x = _coeffs(2, 2, n).reshape(1, 2, n // 2)
    got = nk.fwd_linear(torch.from_numpy(x), n)
    want = jnk.fwd_linear(jnp.asarray(x), n, layout="mat")
    _eq_pair(got, want)
    p = PRIMES[:2]
    back = nk.inv_linear(got, n, torch.from_numpy(p))
    jback = jnk.inv_linear(want, n, jnp.asarray(p), _jmu(p), layout="mat")
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_fwd_matches_dft_oracle():
    """out[k] = sum_j x[j] g^((65536/n) j k) mod P, read through the mat
    layout: NTT index k1 + n1*k2 sits at k1*n2 + k2."""
    n = 16384
    g = 15893793146607301539
    assert ntt.P == modp.P and pow(g, 1 << 16, modp.P) == 1
    w = pow(g, 65536 // n, modp.P)
    x = _coeffs(3, 1, n)
    lo, hi = nk.fwd_linear(torch.from_numpy(x), n)
    std = modp.u64_from_pair(ntt.mat_to_std(lo, n), ntt.mat_to_std(hi, n))[0]
    xs = [int(v) for v in x[0]]
    for k in (0, 1, 2, 777, n // 2, n - 1):
        wk = pow(w, k, modp.P)
        acc, cur = 0, 1
        for v in xs:
            acc += v * cur
            cur = cur * wk % modp.P
        assert int(std[k]) == acc % modp.P


def test_mat_std_permutes_are_inverse():
    n = 32768
    t = torch.arange(2 * n).reshape(2, n)
    assert torch.equal(ntt.mat_to_std(ntt.std_to_mat(t, n), n), t)
    n1, n2 = ntt.FACTORS[n]
    assert (n1, n2) == jnk._FACTORS[n] == (256, 128)
    # mat-linear index k1*n2 + k2 holds NTT index k1 + n1*k2
    mat = ntt.std_to_mat(t[:1], n)[0]
    assert int(mat[5 * n2 + 7]) == 5 + n1 * 7

