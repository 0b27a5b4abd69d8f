"""The port's ICRT (cuhe_tpu_torch/ops/crt.py) against the JAX package's
fused Pallas ICRT in interpret mode and its scan version, bit for bit, at
the entry configuration and a deeper prime chain (two word counts).  The
interpreted Pallas kernel takes minutes at the deeper chain, so there it is
held against the scan, which tests/test_poly_ops.py holds against the
fused kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuhe_tpu import hostmath as jhm
from cuhe_tpu.ops import crt as jcrt
from cuhe_tpu.ops import modp as jmodp
from cuhe_tpu.params import make_params
from cuhe_tpu_torch import hostmath as hm
from cuhe_tpu_torch.ops import crt


@pytest.mark.parametrize("cfg,fused", [((3, 2, 16, 50, 25, 8191), True),
                                       ((5, 2, 16, 50, 25, 8191), False)])
def test_icrt_matches_jax_fused_and_scan(cfg, fused):
    pr = make_params(*cfg)
    pn = pr.num_crt_prime
    q, mi, bi = pr.icrt_consts(0)
    w = pr.words_coeff(0)
    m_words = hm.ints_to_words([q], w)[:, 0]
    mi_words = np.stack([hm.ints_to_words([v], w)[:, 0] for v in mi])
    np.testing.assert_array_equal(m_words, jhm.ints_to_words([q], w)[:, 0])
    primes = np.array(pr.crt_primes, np.uint32)[:pn]
    bi_np = np.array(bi, np.uint32)
    mus = np.array([jmodp.barrett_mu(int(p)) for p in primes], np.uint64)
    mus_np = (mus[:, 0].astype(np.uint32), mus[:, 1].astype(np.uint32))
    rng = np.random.default_rng(5)
    x = rng.integers(0, primes[None, :, None], size=(2, pn, 1024)).astype(np.uint32)
    x[0, :, 0] = primes - 1  # the largest residues: the sum reaches past M
    x[0, :, 1] = 0

    got = crt.icrt_to_raw(*(torch.from_numpy(np.array(a)) for a in
                            (x, primes, bi_np, mi_words, m_words)))
    scan = jcrt.icrt_to_raw(jnp.asarray(x), jnp.asarray(primes),
                            (jnp.asarray(mus_np[0]), jnp.asarray(mus_np[1])),
                            jnp.asarray(bi_np), jnp.asarray(mi_words),
                            jnp.asarray(m_words))
    assert got.dtype == torch.uint32 and got.shape == (2, w, 1024)
    if fused:
        want = jcrt.icrt_to_raw_fused(jnp.asarray(x), primes, mus_np, bi_np,
                                      mi_words, m_words, interpret=True,
                                      block_cols=512)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))
    # and the value is the CRT combination, in [0, M)
    vals = hm.words_to_ints(got.numpy()[0][:, :4])
    for col, v in enumerate(vals):
        assert v == hm.crt_combine([int(r) for r in x[0, :, col]],
                                   [int(p) for p in primes])
