"""Whole blocks of homomorphic PRINCE, one after another:
``Prince.encrypt_blocks(message, key0, key1)``, the port's princeEncrypt
schedule (examples/Prince/Prince.cu:148-188).

Set-up runs keygen from the seed and encrypts the seed's message and two
keys once, through ``Prince.encrypt_state``; the runner then gives its
Prince an ``encrypt_state`` that returns those states for those bits, so
the window times the circuit alone, the span the reference's Timer takes
(Prince.cu:83-87).

The check holds the circuit to the plain reference three ways:
  - the final state of one of the first blocks, drawn from the seed,
    decrypted with the secret key (benchmark/reference/dhs.py) against the
    plain cipher's 64 bits (benchmark/reference/prince.py); that block's
    and the last block's states must equal the first's bit for bit, since
    the circuit draws nothing;
  - one S-box layer of that block, drawn from the seed, word for word:
    the layer's output for a few nibbles against the reference S-box
    (benchmark/reference/sbox.py) run on the same input;
  - every eval key against its relation to the secret key.
The S-box layer is judged from the program's own input to it; the start
of the circuit is judged by the decrypted block.
"""

from __future__ import annotations

import time

import torch

from benchmark.core import traffic as tg
from benchmark.runners.gate_step import params_of
from benchmark.reference import dhs as rdhs
from benchmark.reference import gate as rg
from benchmark.reference import prince as plain
from benchmark.reference import sbox as rsbox
from benchmark.reference import zp
from benchmark.reference.ring import Ring

# the Prince methods that the traced run wraps in spans
LAYER_METHODS = ("sbox_layer", "mix_column", "inv_mix_column", "m_p",
                 "add_rc", "add_round_key", "key_expansion")
KEEP_NIBBLES = 2  # nibbles of the kept S-box layer, checked word for word


class Runner:
    LAYERS = 12  # S-box layers of a whole block

    def __init__(self, cell, seed, device, spans):
        from cuhe_tpu_torch.dhs import CuDHS
        from cuhe_tpu_torch.models.prince import Prince

        self.device, self.spans = device, spans
        self.params = params_of(cell.config)
        self.ring = Ring(*self.params)
        self.schedule = tg.Schedule(cell.traffic, seed)
        self.keep_layer = self.schedule.pick(list(range(self.LAYERS)), 1)[0]
        nibbles = self.schedule.pick(list(range(16)), KEEP_NIBBLES)
        self.keep_rows = torch.tensor([4 * j + b for j in nibbles
                                       for b in range(4)], device=device)
        with spans("bench.keygen"):
            self.prince = Prince(dhs=CuDHS(*self.params, seed=seed,
                                           device=device))
        r = tg.rng(seed, 1)
        self.words = [int.from_bytes(r.bytes(8), "big") for _ in range(3)]
        self.bits = [plain.to_bits(v) for v in self.words]
        with spans("bench.encrypt"):
            states = {}
            for b in self.bits:
                states.setdefault(tuple(b), self.prince.encrypt_state(b))
        self.prince.encrypt_state = lambda bits: states[tuple(bits)]
        self.kept_layer = None
        if spans.on:  # a traced run: a span around each layer
            self._wrap_layers()
        self.op()  # every level's tables, every kernel: one whole block

    def _kept_sbox(self, inner):
        """Prince's S-box method for the kept block alone: layer
        `keep_layer` copies its input and output rows of the kept nibbles
        to the host, so that no other block does any work for the check
        and no device memory stays held for it."""
        def rows(x):  # (int32 views: no uint32 gather on the card)
            return x.view(torch.int32)[self.keep_rows].cpu()

        def _sbox(state, lvl, inverse):
            layer, self._layer = self._layer, self._layer + 1
            if layer != self.keep_layer:
                return inner(state, lvl, inverse)
            x = rows(state)
            out = inner(state, lvl, inverse)
            self.kept_layer = (x, rows(out), lvl, inverse)
            return out
        return _sbox

    def _wrap_layers(self):
        p, sp = self.prince, self.spans
        for name in LAYER_METHODS:
            fn = getattr(p, name)

            def wrapped(*a, _fn=fn, _name=f"bench.{name}", **k):
                with sp(_name):
                    return _fn(*a, **k)
            setattr(p, name, wrapped)

    def _circuit(self):
        return self.prince.encrypt_blocks(*self.bits)

    def _plain(self) -> int:
        return plain.encrypt(*self.words)

    def op(self, keep: bool = False):
        p = self.prince
        if keep:
            self._layer = 0
            p._sbox = self._kept_sbox(p._sbox)
        try:
            with self.spans("bench.block"):
                out = self._circuit()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            if keep:
                del p._sbox
        return out

    def window(self, seconds: float) -> dict:
        """Blocks one after another for `seconds`.  Kept for the check: a
        copy of the first block's state, the kept block's (drawn from the
        first few) and the last's; the same memory whichever is kept, and
        none that grows with the blocks done."""
        self.kept_layer = first = kept = None
        blocks, t0 = 0, time.perf_counter()
        while True:
            keep = self.schedule.keep(blocks)
            out = self.op(keep)
            if first is None:  # (int32 view: no uint32 copy on the card)
                first = out.view(torch.int32).clone()
            if keep:
                kept = out
            blocks += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.level, self.blocks = self.prince.level, blocks
        self.first, self.kept, self.last = first, kept, out
        return {"attempted": blocks, "blocks": blocks, "seconds": elapsed}

    def shapes(self) -> dict:
        return {"batch": 64, "n": self.ring.n}

    def release(self):
        dhs = self.prince.dhs
        self.sk, self.sk0, self.ek_ints = dhs.sk[self.level], dhs.sk[0], \
            dhs.ek
        self.prince = None

    def _sbox_mismatched(self, t, ek) -> int:
        """Words of the kept S-box layer's output unequal to the reference
        S-box's on the same input; all of them where none was kept."""
        if self.kept_layer is None:
            lvl = 2 * self.keep_layer
            return len(self.keep_rows) * self.ring.pn(lvl + 2) * \
                self.ring.half
        x, out, lvl, inverse = (v.to(self.device) if torch.is_tensor(v)
                                else v for v in self.kept_layer)
        ref = rsbox.layer(zp.u32_to_i64(x), ek, t, lvl, self.ring.mod_msg,
                          inverse)
        return int((zp.u32_to_i64(out) != ref).sum())

    def check(self) -> list:
        ring, dev = self.ring, self.device
        differ = sum(not torch.equal(s.view(torch.int32), self.first)
                     for s in (self.kept, self.last) if s is not None)
        t = rg.Tables(ring, dev)
        wrong = 64  # a kept block that never came says nothing right
        if self.kept is not None:
            dec = rdhs.decrypt(zp.u32_to_i64(self.kept), self.sk, t,
                               self.level, ring.mod_msg, count=1)
            got = plain.from_bits([d[0] for d in dec])
            wrong = bin(got ^ self._plain()).count("1")
        self._failed = self.blocks if wrong else differ
        ek = rdhs.ints_to_ntt(self.ek_ints, t, 0, dev)
        ek_wrong = rdhs.eval_key_errors(ek, self.sk0, t, ring.w,
                                        ring.mod_msg)
        sbox_bad = self._sbox_mismatched(t, ek)
        if sbox_bad and not wrong:
            self._failed += 1
        return [("ek_wrong_coeffs", ek_wrong, 0),
                ("sbox_mismatched_words", sbox_bad, 0),
                ("wrong_bits", wrong, 0),
                ("blocks_differing", differ, 0)]

    def failed(self) -> int:
        return self._failed
