"""One homomorphic SubBytes of cuhe_tpu_torch/models/aes.py on the CPU, at
a small DHS ring (CuDHS(6, 2, 16, 25, 25, 8191): 630 slots, 6 primes, the
layer's 5 levels): the 34 ANDs in their four batches, the wires switched
down to meet their operands, word for word the reference S-box circuit's
(benchmark/reference/aes_sbox.py, plain PyTorch on the same input and the
keygen's integer eval keys); and its output decrypts and decodes, slot by
slot, to the AES S-box of each slot's byte."""

import numpy as np
import torch

from benchmark.reference import aes as plain
from benchmark.reference import aes_sbox as ref_sbox
from benchmark.reference import dhs as rdhs
from benchmark.reference import gate as rg
from benchmark.reference import zp
from benchmark.reference.ring import Ring
from cuhe_tpu_torch.dhs import CuDHS
from cuhe_tpu_torch.models import aes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARAMS = (6, 2, 16, 25, 25, 8191)


def test_sub_bytes_is_the_reference_and_decrypts(monkeypatch):
    # one row a reference gate: on one CPU thread the fastest block
    monkeypatch.setattr(ref_sbox, "REF_BLOCK", 1)
    dhs = CuDHS(*PARAMS, seed=3, device="cpu")
    rng = np.random.default_rng(11)
    byte = rng.integers(0, 256, dhs.num_slot, dtype=np.uint8)
    bits = aes.byte_bits(byte[:, None]).T  # [8, slots]: one byte a slot
    state = aes.Wire(dhs.encrypt_crt(dhs.batcher.encode_many(bits), 0), 0)
    gates = aes.Ciphertexts(dhs)
    out = aes.AES(gates).sub_bytes(state)
    assert out.level == aes.LEVELS_PER_ROUND
    assert (gates.stats.relin_calls, gates.stats.products) == (4, 34)
    raw = dhs._ints_of_residues(out.data, out.level)
    dec = dhs.batcher.decode_many(dhs.decrypt_many(raw, out.level))
    assert (aes.bits_bytes(dec.T)[:, 0] == plain.SBOX[byte]).all()
    t = rg.Tables(Ring(*PARAMS), "cpu")
    ek = rdhs.ints_to_ntt(dhs.ek, t, 0, "cpu")
    want = ref_sbox.layer(zp.u32_to_i64(state.data), ek, t, 0, 2)
    assert torch.equal(zp.u32_to_i64(out.data), want)
