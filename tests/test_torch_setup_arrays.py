"""The DHS set-up's array forms on the CPU, against the forms they replace
and against plain references:

  * Barrett's quotient x^(2 mod_len - 1) div m(x), taken once over the
    integers and reduced mod each prime, equals the long division mod each
    prime, at the rings of simple_DHS, PRINCE and AES;
  * at AES's ring (m = 2^15 - 1: 1800 slots of degree 15) the Batcher's
    factors are the reference's (benchmark/reference/slots.py), T E = I
    over GF(2) (each idempotent decodes to its own slot alone), and the
    encoding of every-slot ones is the constant 1;
  * encryption into CRT residues on the device (`encrypt_crt`) gives the
    residues of `encrypt_many`'s integers, for the same draws, and leaves
    the sampler where `skip_encryptions` does.

The keys and the Batcher's matrices against the JAX package's:
tests/test_torch_dhs.py and tests/test_torch_dhs_host.py.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import slots
from cuhe_tpu_torch import hostmath as hm
from cuhe_tpu_torch.context import _poly_long_div_int, _poly_long_div_mod_p
from cuhe_tpu_torch.dhs import Batcher, CuDHS
from cuhe_tpu_torch.params import make_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("cfg", [(5, 2, 1, 61, 20, 8191),
                                 (25, 2, 16, 25, 25, 21845),
                                 (51, 2, 16, 48, 24, 32767)])
def test_barrett_quotient_over_the_integers(cfg):
    pr = make_params(*cfg)
    m, k = list(pr.poly_mod), 2 * pr.mod_len - 1
    q = _poly_long_div_int(k, m)
    assert q is not None
    for p in (pr.crt_primes[0], pr.crt_primes[-1]):
        assert (np.remainder(q, p) == _poly_long_div_mod_p(k, m, p)).all()


def test_batcher_at_the_aes_ring():
    pm = hm.gen_poly_mod(32767)
    b = Batcher(pm, 15, 1800)
    assert b.factors == slots.factors(32767)
    te = (b.T.astype(np.float32) @ b.E.astype(np.float32)) % 2
    assert (te == np.eye(1800)).all()
    assert b.encode_many([[1] * 1800])[0].tolist() == [1] + [0] * 26999
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (3, 1800))
    assert (b.decode_many(b.encode_many(bits)) == bits).all()


def test_encrypt_crt_is_encrypt_many_in_residues():
    cfg = (3, 2, 16, 50, 25, 8191)
    one, two = (CuDHS(*cfg, seed=9, device="cpu") for _ in range(2))
    rng = np.random.default_rng(6)
    msgs = [rng.integers(0, 2, n).tolist() for n in (1, 100, 8190)]
    for lvl in (0, 1):
        res = one.encrypt_crt(msgs, lvl)
        cts = two.encrypt_many(msgs, lvl)
        primes = one.params.crt_primes[: res.shape[1]]
        want = [[[c % p for c in ct] for p in primes] for ct in cts]
        got = res.view(torch.int32).to(torch.int64)[..., :8190].tolist()
        assert got == want
    two.skip_encryptions(3)
    one.encrypt_crt(msgs, 0)
    assert (one.sample_array() == two.sample_array()).all()
