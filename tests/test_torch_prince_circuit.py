"""The port's homomorphic PRINCE circuit against the JAX package's, end to
end on the CPU, bit for bit (tolerance 0), at the light depth-5 ring
CuDHS(5, 2, 16, 50, 25, 8191, seed=13) of tests/test_prince.py (the full
CuDHS(25, 2, 16, 25, 25, 21845) runs on the card in chip_smoke.py):

  * the same seed gives the same key strings in both packages;
  * encrypt_blocks(A=0, B=1, C=0, max_rounds=1) -- encryption of the
    message and keys, the first linear layers and the first S-box layer --
    gives the JAX package's state;
  * that state decrypts to the published round-0 vector (Prince.cu:108).

Rounds 1 and checkpoint / resume, on the port alone: test_torch_prince_resume.py.
"""

import numpy as np
import pytest

from cuhe_tpu.dhs import CuDHS as JCuDHS
from cuhe_tpu.models import prince as jpr
from cuhe_tpu_torch.dhs import CuDHS
from cuhe_tpu_torch.models import prince as pr
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = (5, 2, 16, 50, 25, 8191)
SEED = 13
A, B, C = [0] * 64, [1] * 64, [0] * 64


@pytest.fixture(scope="module")
def princes():
    return (pr.Prince(dhs=CuDHS(*CFG, seed=SEED, device="cpu")),
            jpr.Prince(dhs=JCuDHS(*CFG, seed=SEED)))


def test_key_strings_equal_jax(princes):
    p, jp = princes
    assert p.dhs.get_private_key() == jp.dhs.get_private_key()
    assert p.dhs.get_public_key() == jp.dhs.get_public_key()


@pytest.fixture(scope="module")
def first_layer(princes):
    """The state after S-box layer 1 in both packages, whose samplers are in
    the same state after keygen."""
    p, jp = princes
    got = p.encrypt_blocks(A, B, C, max_rounds=1)
    want = np.asarray(jp.encrypt_blocks(A, B, C, max_rounds=1))
    return got, want


def test_first_layer_state_equals_jax(princes, first_layer):
    p, jp = princes
    got, want = first_layer
    assert p.level == jp.level == 2
    assert tuple(got.shape) == (64, p.ctx.params.num_crt_prime_lvl(2),
                                p.ctx.params.crt_len)
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_layer_decrypts_to_round_0(princes, first_layer):
    p, _ = princes
    bits = p.decrypt_state(first_layer[0], 2)
    assert "".join(map(str, bits)) == pr.Prince.EXPECTED_ROUNDS[0]
