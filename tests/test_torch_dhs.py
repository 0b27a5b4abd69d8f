"""The port's DHS scheme (cuhe_tpu_torch/dhs.py) on the CPU against the JAX
package's, bit for bit (tolerance 0), at the light configuration
CuDHS(3, 2, 16, 50, 25, 8191, seed=7) (the shipped simple_DHS set,
CuDHS(5, 2, 1, 61, 20, 8191), runs on the card in chip_smoke.py):

  * the same seed gives the same private and public key strings;
  * encrypt, XOR, NOT and AND -> relin -> modSwitch give the JAX outputs,
    and they decrypt and decode to the plaintext bits (simple_DHS.cu);
  * keys carried across: a JAX private key decrypts in the port, and a port
    public key lets the JAX package encrypt what the port decrypts.
"""

import numpy as np
import pytest
import torch

from cuhe_tpu import poly as jpoly
from cuhe_tpu.dhs import CuDHS as JCuDHS
from cuhe_tpu_torch import poly
from cuhe_tpu_torch.dhs import CuDHS

CFG = (3, 2, 16, 50, 25, 8191)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread while this module runs: the test workers
    share the machine's cores, and each worker's spinning OpenMP threads
    multiplied these tests' CPU time several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def schemes():
    return CuDHS(*CFG, seed=7, device="cpu"), JCuDHS(*CFG, seed=7)


@pytest.fixture(scope="module")
def messages(schemes):
    dhs, _ = schemes
    rng = np.random.default_rng(777)
    return [[int(b) for b in rng.integers(0, 2, dhs.num_slot)]
            for _ in range(3)]


def test_key_strings_equal_jax(schemes):
    dhs, jdhs = schemes
    assert dhs.get_private_key() == jdhs.get_private_key()
    assert dhs.get_public_key() == jdhs.get_public_key()
    assert dhs.num_slot == jdhs.num_slot == 630
    for x, y in zip(dhs.ctx.ek_ntt, jdhs.ctx.ek_ntt):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.fixture(scope="module")
def ciphertexts(schemes, messages):
    """The three messages encrypted by both schemes, whose rngs are in the
    same state after keygen, so the ciphertexts are equal."""
    dhs, jdhs = schemes
    cts = [dhs.encrypt(dhs.batcher.encode(m), 0) for m in messages]
    jcts = [jdhs.encrypt(jdhs.batcher.encode(m), 0) for m in messages]
    assert cts == jcts
    return cts


def test_xor_not_equal_jax_and_decrypt(schemes, messages, ciphertexts):
    dhs, jdhs = schemes
    ctx, jctx = dhs.ctx, jdhs.ctx
    x, y = ciphertexts[:2]
    cz = poly.c_xor(ctx, *(poly.to_ntt(ctx, poly.ctxt_from_ints(c, 0))
                           for c in (x, y)))
    jz = jpoly.c_xor(jctx, *(jpoly.to_ntt(jctx, jpoly.ctxt_from_ints(c, 0))
                             for c in (x, y)))
    z = poly.to_ints(ctx, cz)
    assert z == jpoly.to_ints(jctx, jz)
    assert dhs.batcher.decode(dhs.decrypt(z, 0)) == [
        (a + b) % 2 for a, b in zip(messages[0], messages[1])]

    cn = poly.c_not(ctx, poly.to_crt(ctx, poly.ctxt_from_ints(x, 0)))
    jn = jpoly.c_not(jctx, jpoly.to_crt(jctx, jpoly.ctxt_from_ints(x, 0)))
    z = poly.to_ints(ctx, cn)
    assert z == jpoly.to_ints(jctx, jn)
    assert dhs.batcher.decode(dhs.decrypt(z, 0)) == [1 - b for b in messages[0]]


def test_and_relin_modswitch_equal_jax_and_decrypt(schemes, messages,
                                                   ciphertexts):
    dhs, jdhs = schemes
    ctx, jctx = dhs.ctx, jdhs.ctx
    x, y = ciphertexts[:2]
    cz = poly.c_and(ctx, *(poly.to_ntt(ctx, poly.ctxt_from_ints(c, 0))
                           for c in (x, y)))
    cz = poly.mod_switch(ctx, poly.relin(ctx, cz))
    jz = jpoly.c_and(jctx, *(jpoly.to_ntt(jctx, jpoly.ctxt_from_ints(c, 0))
                             for c in (x, y)))
    jz = jpoly.mod_switch(jctx, jpoly.relin(jctx, jz))
    assert cz.level == jz.level == 1
    np.testing.assert_array_equal(cz.data.numpy(), np.asarray(jz.data))
    z = poly.to_ints(ctx, cz)
    assert z == jpoly.to_ints(jctx, jz)
    want = [a * b for a, b in zip(messages[0], messages[1])]
    assert dhs.batcher.decode(dhs.decrypt(z, 1)) == want


def test_batched_encrypt_decrypt_equal_jax(schemes, messages):
    """encrypt_many / decrypt_many advance both rngs alike and agree."""
    dhs, jdhs = schemes
    encs = [dhs.batcher.encode(m) for m in messages]
    cts = dhs.encrypt_many(encs, 0)
    assert cts == jdhs.encrypt_many(encs, 0)
    outs = dhs.decrypt_many(cts, 0)
    assert outs == jdhs.decrypt_many(cts, 0)
    assert [dhs.batcher.decode(o) for o in outs] == messages
    bal = dhs.balance(cts[0], 0)
    assert bal == jdhs.balance(cts[0], 0)
    assert dhs.unbalance(bal, 0) == cts[0]


def test_keys_carried_across(schemes, messages):
    dhs, jdhs = schemes
    m = messages[2]
    # a JAX private key string, loaded by the port, decrypts JAX ciphertexts
    port = CuDHS(key_string=jdhs.get_private_key(), seed=99, device="cpu")
    jct = jdhs.encrypt(jdhs.batcher.encode(m), 0)
    assert port.batcher.decode(port.decrypt(jct, 0)) == m
    for x, y in zip(port.ctx.ek_ntt, jdhs.ctx.ek_ntt):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # a port public key lets the JAX package encrypt what the port decrypts
    jpub = JCuDHS(key_string=dhs.get_public_key(), seed=98)
    assert jpub.sk[0] is None
    ct = jpub.encrypt(jpub.batcher.encode(m), 0)
    assert dhs.batcher.decode(dhs.decrypt(ct, 0)) == m
    # and a port public key in the port itself cannot decrypt
    pub = CuDHS(key_string=dhs.get_public_key(), device="cpu")
    assert pub.get_public_key() == dhs.get_public_key()
    with pytest.raises(RuntimeError, match="private key"):
        pub.decrypt(ct, 0)
