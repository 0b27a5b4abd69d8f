"""The controls and the planted faults that each cell's check has to fail.

The configurations state exact arithmetic mod the Goldilocks prime.  The
control is the step below that: Z_P products taken in float64, whose 53-bit
mantissa drops the low bits of a 64 x 64-bit product.  For the gate cells
the control is the plain reference itself put in the program's place with
float64 products; the circuit has no plain homomorphic counterpart, so its
control is the program with the S-box's products (kernel K1) in float64.
The faults: an answer altered where it is produced, half of a batch left
out, an S-box layer that returns its state unchanged, and an eval key
altered where keygen makes it.  `ShortCircuit` cuts the circuit to its
first S-box layer, for rings that a CPU test can run.
"""

from __future__ import annotations

import contextlib
import types

import torch

from benchmark.runners import dhs_and, gate_step, prince_circuit
from benchmark.reference import gate as rg
from benchmark.reference import prince as plain
from benchmark.reference import zp
from benchmark.reference.ring import Ring

TWO32 = float(1 << 32)


def float64_mul(a, b):
    """(a b) mod P through float64: the control's product."""
    fa = a[0].double() + a[1].double() * TWO32
    fb = b[0].double() + b[1].double() * TWO32
    r = torch.remainder(fa * fb, float(zp.P))
    hi = torch.floor(r / TWO32)
    lo = torch.clamp(r - hi * TWO32, 0, TWO32 - 1)
    return zp.canon(lo.long(), torch.clamp(hi, 0, TWO32 - 1).long())


@contextlib.contextmanager
def float64_products():
    """The reference's Z_P products in float64 while the block runs."""
    exact = zp.mul
    zp.mul = float64_mul
    try:
        yield
    finally:
        zp.mul = exact


def _control_gate(ring, tables, lvl, a, b, ek, block=4):
    outs = []
    with float64_products():
        for s in range(0, a[0].shape[0], block):
            rows = slice(s, s + block)
            outs.append(rg.gate(tuple(v[rows] for v in a),
                                tuple(v[rows] for v in b), ek, tables, lvl,
                                ring.mod_msg))
    return zp.i64_to_u32(torch.cat(outs))


class GateControl(gate_step.Runner):
    """The reference with float64 products in the gate step's place."""

    def __init__(self, cell, seed, device, spans):
        super().__init__(cell, seed, device, spans)
        ring, lvl = self.ring, self.lvl
        tables = rg.Tables(ring, device)
        ek = zp.from_u32(*self.step.ctx.ek_ntt)
        a = zp.from_u32(*self.inputs[:2])
        b = zp.from_u32(*self.inputs[2:])
        self.step = lambda *_: _control_gate(ring, tables, lvl, a, b, ek)


class GateFlipWord(gate_step.Runner):
    """One word of each answer altered where the step produces it."""

    def op(self):
        out = super().op().clone()
        out.view(torch.int32)[0, 0, 0] ^= 1
        return out


class GateHalfBatch(gate_step.Runner):
    """Half of the batch left out: the step runs on the first half only."""

    def op(self):
        half = self.batch // 2
        out = self.step(*(v[:half] for v in self.inputs))
        return torch.cat([out, torch.zeros_like(out)])


class AndControl(dhs_and.Runner):
    """The reference with float64 products in the AND gate's place."""

    def _gate(self, k):
        if not hasattr(self, "_tables"):
            self._tables = rg.Tables(self.ring, self.device)
            self._ek = zp.from_u32(*self.dhs.ctx.ek_ntt)
        a, b = self.pairs[k]
        out = _control_gate(self.ring, self._tables, self.lvl,
                            tuple(v[None] for v in zp.from_u32(*a.data)),
                            tuple(v[None] for v in zp.from_u32(*b.data)),
                            self._ek)
        return types.SimpleNamespace(data=out[0])


class AndFlipWord(dhs_and.Runner):
    def _gate(self, k):
        out = super()._gate(k)
        data = out.data.clone()
        data.view(torch.int32)[0, 0] ^= 1
        return types.SimpleNamespace(data=data)


def alter_eval_key(dhs, key: int = 1):
    """1 added to coefficient 0 of eval key `key`, and the keys installed
    again: a fault where keygen makes them."""
    q0 = dhs.coeff_mod[0]
    dhs.ek[key][0] = (dhs.ek[key][0] + 1) % q0
    dhs.init_relinearization()


class AndWrongKey(dhs_and.Runner):
    def __init__(self, cell, seed, device, spans):
        super().__init__(cell, seed, device, spans)
        alter_eval_key(self.dhs)


def _float64_ntt_mul(a, b):
    out = float64_mul(zp.from_u32(*a), zp.from_u32(*b))
    return zp.i64_to_u32(out[0]), zp.i64_to_u32(out[1])


class CircuitControl(prince_circuit.Runner):
    """The program with the S-box's products (K1) in float64."""

    def window(self, seconds):
        from cuhe_tpu_torch.ops import pointwise

        exact = pointwise.ntt_mul
        pointwise.ntt_mul = _float64_ntt_mul
        try:
            return super().window(seconds)
        finally:
            pointwise.ntt_mul = exact


class CircuitSboxUnchanged(prince_circuit.Runner):
    """Every S-box layer returns its state unchanged (the level still
    rises by 2; the state keeps the planes of the new level)."""

    def window(self, seconds):
        p = self.prince
        exact = p.sbox_layer
        ring = Ring(*self.params)

        def unchanged(state, inverse=False):
            p.level += 2
            return state[:, : ring.pn(p.level)].contiguous()

        p.sbox_layer = unchanged
        try:
            return super().window(seconds)
        finally:
            p.sbox_layer = exact


class CircuitFlipAnswer(prince_circuit.Runner):
    """One answer altered where the circuit produces it: 1 added to the
    constant coefficient of ciphertext 5 of the final state (in every
    residue plane), which flips the bit it decrypts to."""

    def op(self, keep=False):
        out = super().op(keep).clone()
        w = out.view(torch.int32)  # residues below p < 2^31
        for i, p in enumerate(self.ring.primes[: w.shape[1]]):
            w[5, i, 0] = (int(w[5, i, 0]) + 1) % p
        return out


class CircuitWrongKey(prince_circuit.Runner):
    def __init__(self, cell, seed, device, spans):
        super().__init__(cell, seed, device, spans)
        alter_eval_key(self.prince.dhs)


class ShortCircuit(prince_circuit.Runner):
    """The circuit cut after its first S-box layer, and the plain cipher's
    state there."""

    LAYERS = 1

    def _circuit(self):
        return self.prince.encrypt_blocks(*self.bits, max_rounds=1)

    def _plain(self) -> int:
        return plain.encrypt(*self.words, layers=1)


def short(runner):
    """`runner`, a circuit runner, cut as ShortCircuit cuts it."""
    if runner is None:
        return ShortCircuit
    return type(f"Short{runner.__name__}", (runner, ShortCircuit), {})
