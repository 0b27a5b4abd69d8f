"""Whole homomorphic AES-128 circuits, one after another:
``HomomorphicAES.circuit(state, round_keys)`` (cuhe_tpu_torch/models/
aes.py), the 128 state ciphertexts from level 0 through 10 rounds.

Set-up runs keygen from the seed, encrypts the seed's blocks (one a
plaintext slot, every slot of every state bit) and the seed's key's 11
round keys, each at the level where it is added, and runs one circuit; the
window then times whole circuits on that state and those keys.

The check holds the circuit to the plain reference four ways:
  - the kept circuit's 128 ciphertexts (one of the first few, drawn from
    the seed), decrypted with the secret key and decoded over every slot
    (benchmark/reference/slots.py), against plain AES-128 of every slot's
    block (benchmark/reference/aes.py);
  - the kept and the last circuit's states against the first's, bit for
    bit, since the circuit draws nothing;
  - one SubBytes of the kept circuit, its round drawn from the seed, on 2
    seed-drawn bytes (16 ciphertexts), word for word against the reference
    S-box circuit (benchmark/reference/aes_sbox.py) on the same input;
  - every eval key against its relation to the secret key.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.core import traffic as tg
from benchmark.runners.gate_step import params_of
from benchmark.reference import aes as plain
from benchmark.reference import aes_sbox as rsbox
from benchmark.reference import dhs as rdhs
from benchmark.reference import gate as rg
from benchmark.reference import ntt, slots, zp
from benchmark.reference.ring import Ring

# the AES methods that the traced run wraps in spans
LAYER_METHODS = ("sub_bytes", "shift_rows", "mix_columns", "add_round_key")
KEEP_BYTES = 2  # bytes of the kept SubBytes, checked word for word
LEVELS_PER_ROUND = 5  # a SubBytes' levels (reference/aes_sbox.py)
DECRYPT_BLOCK = 16  # ciphertexts a block of the reference decryption


def decrypt_bits(ct: torch.Tensor, sk, t: rg.Tables, lvl: int,
                 mod_msg: int) -> torch.Tensor:
    """Residues int64 [B, pn, n/2] at lvl -> each ciphertext's plaintext
    coefficients mod mod_msg, int64 [B, mod_len]: c sk mod (m(x), q_lvl),
    centred (reference/dhs.py's decryption, a block at a time)."""
    ring = t.ring
    skr = rdhs.residues_of_ints(sk, t, lvl, ct.device)
    s = ntt.forward(skr, ring.n)
    outs = []
    for b in range(0, ct.shape[0], DECRYPT_BLOCK):
        prod = zp.mul(ntt.forward(ct[b: b + DECRYPT_BLOCK], ring.n), s)
        words = rg.icrt(rg.product_to_crt(prod, t, lvl), t, lvl)
        outs.append(rdhs.centred_mod(words, ring.q(lvl), mod_msg))
    return torch.cat(outs)[:, : ring.mod_len]


class Runner:
    def __init__(self, cell, seed, device, spans):
        from cuhe_tpu_torch.dhs import CuDHS
        from cuhe_tpu_torch.models.aes import HomomorphicAES

        tr = cell.traffic
        self.device, self.spans = device, spans
        self.params = params_of(cell.config)
        self.rounds = int(tr.get("rounds", 10))
        self.ring = Ring(*self.params)
        self.schedule = tg.Schedule(tr, seed)
        self.keep_round = self.schedule.pick(
            list(range(1, self.rounds + 1)), 1)[0]
        kept = self.schedule.pick(list(range(16)), KEEP_BYTES)
        self.keep_rows = torch.tensor([8 * j + i for j in kept
                                       for i in range(8)], device=device)
        with spans("bench.keygen"):
            dhs = CuDHS(*self.params, seed=seed, device=device)
        self.haes = HomomorphicAES(dhs, self.rounds)
        r = tg.rng(seed, 1)
        self.key = bytes(r.integers(0, 256, 16, dtype=np.uint8).tolist())
        self.messages = r.integers(0, 256, (dhs.num_slot, 16),
                                   dtype=np.uint8)
        with spans("bench.encrypt"):
            self.state = self.haes.encrypt_blocks(self.messages)
            self.round_keys = self.haes.encrypt_key(self.key)
        self.kept_sbox = None
        self.relin_calls = []
        if spans.on:  # a traced run: a span around each layer
            self._wrap_layers()
        self.op()  # every level's tables, every kernel: one whole circuit

    def _wrap_layers(self):
        a, sp = self.haes.aes, self.spans
        for name in LAYER_METHODS:
            fn = getattr(a, name)

            def wrapped(*args, _fn=fn, _name=f"bench.{name}", **kw):
                with sp(_name):
                    return _fn(*args, **kw)
            setattr(a, name, wrapped)

    def _kept_sub_bytes(self, inner):
        """The AES SubBytes of the kept circuit alone: round `keep_round`
        copies the input and output rows of the kept bytes to the host, so
        that no other circuit does any work for the check and no device
        memory stays held for it."""
        def rows(w):  # (int32 views: no uint32 gather on the card)
            return w.data.view(torch.int32)[self.keep_rows].cpu()

        def sub_bytes(state):
            self._round += 1
            if self._round != self.keep_round:
                return inner(state)
            x = rows(state)
            out = inner(state)
            self.kept_sbox = (x, rows(out), state.level)
            return out
        return sub_bytes

    def op(self, keep: bool = False):
        a = self.haes.aes
        inner = a.sub_bytes
        if keep:
            self._round = 0
            a.sub_bytes = self._kept_sub_bytes(inner)
        self.haes.stats.reset()
        try:
            with self.spans("bench.block"):
                out = self.haes.circuit(self.state, self.round_keys)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            if keep:
                a.sub_bytes = inner
        self.relin_calls.append(self.haes.stats.relin_calls)
        return out

    def window(self, seconds: float) -> dict:
        """Circuits one after another for `seconds`.  Kept for the check: a
        copy of the first circuit's state, the kept circuit's (drawn from
        the first few) and the last's."""
        self.kept_sbox = first = kept = None
        self.relin_calls = []
        blocks, t0 = 0, time.perf_counter()
        while True:
            keep = self.schedule.keep(blocks)
            out = self.op(keep)
            if first is None:  # (int32 view: no uint32 copy on the card)
                first = out.data.view(torch.int32).clone()
            if keep:
                kept = out
            blocks += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.level, self.blocks = out.level, blocks
        self.first, self.kept, self.last = first, kept, out
        return {"attempted": blocks, "blocks": blocks, "seconds": elapsed,
                "relin_calls": float(np.median(self.relin_calls))}

    def shapes(self) -> dict:
        return {"batch": 128, "n": self.ring.n}

    def release(self):
        dhs = self.haes.dhs
        self.sk, self.sk0, self.ek_ints = dhs.sk[self.level], dhs.sk[0], \
            dhs.ek
        self.num_slot = dhs.num_slot
        self.haes = self.state = self.round_keys = None

    def _wrong_bits(self, t) -> int:
        """Slot bits of the kept state that differ from plain AES-128 of
        every slot's block; all of them where none was kept."""
        ring = self.ring
        if self.kept is None:
            return 128 * self.num_slot
        bits = decrypt_bits(zp.u32_to_i64(self.kept.data), self.sk, t,
                            self.level, ring.mod_msg)
        got = slots.decode(bits, slots.decode_matrix(ring.m, ring.mod_len))
        want = np.unpackbits(plain.encrypt(self.messages, self.key,
                                           self.rounds), axis=1)
        # [slots, 128] -> [128, slots], as the state's rows
        want = torch.from_numpy(want.T.astype(np.int64)).to(got.device)
        return int((got[:, : want.shape[1]] != want).sum())

    def _sbox_mismatched(self, t, ek) -> int:
        """Words of the kept SubBytes' output unequal to the reference
        S-box circuit's on the same input; all of them where none was
        kept."""
        ring = self.ring
        if self.kept_sbox is None:
            lvl = LEVELS_PER_ROUND * self.keep_round
            return len(self.keep_rows) * ring.pn(lvl) * ring.half
        x, out, lvl = self.kept_sbox
        ref = rsbox.layer(zp.u32_to_i64(x.to(self.device)), ek, t, lvl,
                          ring.mod_msg)
        return int((zp.u32_to_i64(out.to(self.device)) != ref).sum())

    def check(self) -> list:
        ring, dev = self.ring, self.device
        t0 = time.perf_counter()
        differ = sum(not torch.equal(s.data.view(torch.int32), self.first)
                     for s in (self.kept, self.last) if s is not None)
        t = rg.Tables(ring, dev)
        wrong = self._wrong_bits(t)
        self._failed = self.blocks if wrong else differ
        t1 = time.perf_counter()
        ek = rdhs.ints_to_ntt(self.ek_ints, t, 0, dev)
        ek_wrong = rdhs.eval_key_errors(ek, self.sk0, t, ring.w,
                                        ring.mod_msg)
        t2 = time.perf_counter()
        sbox_bad = self._sbox_mismatched(t, ek)
        if sbox_bad and not wrong:
            self._failed += 1
        print(f"check parts: tables and state {t1 - t0:.3f} s, eval keys "
              f"{t2 - t1:.3f} s, SubBytes {time.perf_counter() - t2:.3f} s",
              file=sys.stderr)
        return [("ek_wrong_coeffs", ek_wrong, 0),
                ("sbox_mismatched_words", sbox_bad, 0),
                ("wrong_bits", wrong, 0),
                ("blocks_differing", differ, 0)]

    def failed(self) -> int:
        return self._failed
