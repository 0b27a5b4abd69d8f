"""The aes128.block cell at a ring a CPU test can run: CuDHS(6, 2, 16, 25,
25, 8191) (630 slots, 6 primes) and the circuit cut to one round (its
SubBytes, ShiftRows and last AddRoundKey; 5 levels).  One sound run reads
`correct` with every check 0; its check, run again on the same run with one
fault planted each time, reads not correct:

  - one slot's bit flipped in the kept state (the slot's CRT idempotent
    added to one ciphertext, which flips that slot's plaintext bit);
  - one word of the kept SubBytes' output altered;
  - one coefficient of an eval key altered.

Each run is a few minutes on four CPU threads: `python -m pytest
benchmark/tests/test_bench_aes.py -p no:cacheprovider`.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from benchmark.core import spec
from benchmark.runners import aes_circuit
from benchmark.tests.small import PARAMS, run_small

SMALL = (6, 2, 16, 25, 25, 8191)


class Kept(aes_circuit.Runner):
    """The runner, kept for the faults, with the encode matrix."""

    last = None

    def release(self):
        self.E = self.haes.dhs.batcher.E
        super().release()
        Kept.last = self


@pytest.fixture(scope="module")
def run():
    cell = spec.resolve(spec.load_benchmark(), "aes128.block")
    cell.config["params"] = dict(zip(PARAMS, SMALL))
    cell.traffic.update({"rounds": 1, "keep_first": 1,
                         "profile": {"warm": 0, "calls": 1}})
    out = run_small(cell, runner_cls=Kept)
    return out, Kept.last


def _checks(rnr) -> dict:
    return {name: v for name, v, _ in rnr.check()}


def test_a_sound_run_is_correct(run):
    out, rnr = run
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert rnr.blocks >= 1 and rnr.level == 5


def test_a_flipped_slot_bit_is_caught(run):
    _, rnr = run
    saved = rnr.kept
    slot, row = 7, 5
    x = saved.data.view(torch.int32).to(torch.int64).clone()
    p = torch.tensor(rnr.ring.primes[: x.shape[1]])[:, None]
    e = torch.from_numpy(rnr.E[:, slot].astype(np.int64))
    x[row, :, : e.shape[0]] = torch.remainder(x[row, :, : e.shape[0]] + e, p)
    rnr.kept = copy.copy(saved)
    rnr.kept.at = {saved.level: x.to(torch.int32).view(torch.uint32)}
    try:
        checks = _checks(rnr)
    finally:
        rnr.kept = saved
    assert checks["wrong_bits"] == 1


def test_a_corrupted_sbox_word_is_caught(run):
    _, rnr = run
    saved = rnr.kept_sbox
    x, out, lvl = saved
    bad = out.clone()
    w = bad.view(torch.int32)
    w[3, 0, 5] = (int(w[3, 0, 5]) + 1) % rnr.ring.primes[0]
    rnr.kept_sbox = (x, bad, lvl)
    try:
        checks = _checks(rnr)
    finally:
        rnr.kept_sbox = saved
    assert checks["sbox_mismatched_words"] == 1


def test_a_corrupted_eval_key_is_caught(run):
    _, rnr = run
    q0 = rnr.ring.q(0)
    saved = rnr.ek_ints[1][0]
    rnr.ek_ints[1][0] = (saved + 1) % q0
    try:
        checks = _checks(rnr)
    finally:
        rnr.ek_ints[1][0] = saved
    assert checks["ek_wrong_coeffs"] > 0


# SHA-256 (first 16 hex digits) of, for seed 11 on the CPU: the private key
# string, the Batcher's E and T, the NTT-domain eval keys, and the
# ciphertexts of three seeded encoded messages at level 0 and one at level
# 1, as the set-up computed them in Python ints before it moved to CRT
# residues on the device (the JAX package's keys, by its tests).
SETUP_DIGESTS = {
    (5, 2, 1, 61, 20, 8191): ("deb9187653108037", "63516370c8ab4d07",
                              "41440886f8364b11", "370313ea152679f2"),
    (25, 2, 16, 25, 25, 21845): ("c661cefe1530c471", "45d88fff5d4547f6",
                                 "91fec981a7138484", "58ce888af1ea4da3"),
}


@pytest.mark.parametrize("cfg", list(SETUP_DIGESTS), ids=["simple_dhs",
                                                          "prince"])
def test_the_cells_setup_is_unchanged(cfg):
    """simple_dhs's and PRINCE's keys, matrices and ciphertexts, bit for
    bit: their cells do the same work."""
    import hashlib

    from cuhe_tpu_torch.dhs import CuDHS

    def digest(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()[:16]

    d = CuDHS(*cfg, seed=11, device="cpu")
    rng = np.random.default_rng(5)
    msgs = [d.batcher.encode([int(b) for b in rng.integers(0, 2,
                                                           d.num_slot)])
            for _ in range(3)]
    cts = d.encrypt_many(msgs, 0) + [d.encrypt(msgs[0], 1)]
    assert (digest(d.get_private_key().encode()),
            digest(d.batcher.E.tobytes() + d.batcher.T.tobytes()),
            digest(b"".join(np.ascontiguousarray(v.numpy()).tobytes()
                            for v in d.ctx.ek_ntt)),
            digest(repr(cts).encode())) == SETUP_DIGESTS[cfg]
