"""The fused gate step (`cuhe_tpu_torch.step.GateStep`) on a batch of
ciphertext pairs, back to back: the throughput of AND -> relinearize ->
modulus switch.

Eval keys and operands are uniform values mod P drawn on the device from
the seed: the step's work does not depend on them, and no keygen is run.
The reference draws the same values again and follows the whole step
(benchmark/reference/gate.py).
"""

from __future__ import annotations

import time

import torch

from benchmark.core import traffic as tg
from benchmark.reference import gate as rg
from benchmark.reference import zp
from benchmark.reference.ring import Ring

PARAMS = ("d", "p", "w", "min", "cut", "m")
REF_BLOCK = 4  # ciphertexts per block of the reference


def params_of(config: dict) -> tuple:
    return tuple(int(config["params"][k]) for k in PARAMS)


def draw(seed: int, ring: Ring, batch: int, device):
    """(eval-key pair, a pair, b pair) of the seed, uint32 on the device."""
    gen = tg.device_generator(seed, 1, device)
    ek = tg.uniform_zp(gen, (ring.num_eval_key, ring.pnum, ring.n), device)
    shape = (batch, ring.pnum, ring.n)
    return ek, tg.uniform_zp(gen, shape, device), tg.uniform_zp(gen, shape,
                                                                 device)


class Runner:
    def __init__(self, cell, seed, device, spans):
        from cuhe_tpu_torch.context import Context
        from cuhe_tpu_torch.params import make_params
        from cuhe_tpu_torch.step import GateStep

        tr = cell.traffic
        self.seed, self.device, self.spans = seed, device, spans
        self.params = params_of(cell.config)
        self.ring = Ring(*self.params)
        self.batch, self.lvl = int(tr["batch"]), int(tr["level"])
        self.schedule = tg.Schedule(tr, seed)
        ctx = Context(make_params(*self.params), device)
        ek, a, b = draw(seed, self.ring, self.batch, device)
        pn = self.ring.pn(self.lvl)
        ctx.set_eval_keys(*ek)
        del ek
        self.step = GateStep(ctx, self.lvl)
        self.inputs = (a[0][:, :pn], a[1][:, :pn], b[0][:, :pn],
                       b[1][:, :pn])
        for _ in range(2):  # builds and loads the kernels
            self.op()

    def op(self):
        with self.spans("bench.step"):
            return self.step(*self.inputs)

    def _clock(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _ms(self, start, end) -> float:
        if self.device.type == "cuda":
            return start.elapsed_time(end)
        return (end - start) * 1e3

    def window(self, seconds: float) -> dict:
        """Steps back to back for `seconds`; a step counts where the device
        finished it inside the window (an event after each step)."""
        self.kept = {}
        start = self._clock()
        t0 = time.perf_counter()
        ends, i = [], 0
        while True:
            out = self.op()
            ends.append(self._clock())
            if self.schedule.keep(i):
                self.kept[i] = out
            i += 1
            if time.perf_counter() - t0 >= seconds + 0.02:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        done = [self._ms(start, e) for e in ends]
        inside = sum(1 for t in done if t <= seconds * 1e3)
        self.kept[i - 1] = out
        return {"attempted": i, "ct_done": inside * self.batch,
                "seconds": seconds}

    def shapes(self) -> dict:
        r = self.ring
        return {"batch": self.batch, "pn": r.pn(self.lvl), "n": r.n,
                "knum": r.knum(self.lvl), "w": r.w,
                "words": r.words(self.lvl)}

    def release(self):
        self.step = self.inputs = None

    def check(self) -> list:
        ring, lvl = self.ring, self.lvl
        pn = ring.pn(lvl)
        t = rg.Tables(ring, self.device)
        ek, a, b = draw(self.seed, ring, self.batch, self.device)
        ek = zp.from_u32(*ek)
        outs = [zp.u32_to_i64(o) for o in self.kept.values()]
        self._bad = [0] * len(outs)
        for s in range(0, self.batch, REF_BLOCK):
            rows = slice(s, s + REF_BLOCK)
            ref = rg.gate(zp.from_u32(a[0][rows, :pn], a[1][rows, :pn]),
                          zp.from_u32(b[0][rows, :pn], b[1][rows, :pn]),
                          ek, t, lvl, ring.mod_msg)
            for k, o in enumerate(outs):
                self._bad[k] += int((o[rows] != ref).sum())
        return [("mismatched_words", sum(self._bad), 0)]

    def failed(self) -> int:
        return sum(1 for v in self._bad if v)
