"""One client's AND gates on single ciphertexts through the port's gate
API: ``poly.mod_switch(ctx, poly.relin(ctx, poly.c_and(ctx, a, b)))``, each
waited for (simple_DHS.cu's AND, examples/run_simple_dhs.py).

Set-up runs the scheme's keygen from the seed and encrypts a pool of
plaintext pairs, random 0/1 polynomials of the seed; the window takes the
pairs round-robin.  The check runs the reference gate on the integer
ciphertexts and eval keys that keygen and encryption gave, and holds those
to what they claim by the reference alone: every eval key to its relation
to the secret key, and some of the program's answers, decrypted with the
secret key, to the plaintexts' product mod (m(x), 2).
"""

from __future__ import annotations

import time

import torch

from benchmark.core import traffic as tg
from benchmark.runners.gate_step import params_of
from benchmark.reference import dhs as rdhs
from benchmark.reference import gate as rg
from benchmark.reference import zp
from benchmark.reference.ring import Ring

REF_BLOCK = 4  # pairs per block of the reference


class Runner:
    def __init__(self, cell, seed, device, spans):
        from cuhe_tpu_torch import poly
        from cuhe_tpu_torch.dhs import CuDHS

        tr = cell.traffic
        self.poly, self.device, self.spans = poly, device, spans
        self.params = params_of(cell.config)
        self.ring = Ring(*self.params)
        self.lvl = int(tr["level"])
        self.schedule = tg.Schedule(tr, seed)
        with spans("bench.keygen"):
            self.dhs = CuDHS(*self.params, seed=seed, device=device)
        ctx = self.dhs.ctx
        n_len = self.ring.mod_len
        plain = tg.rng(seed, 1).integers(0, 2, (self.schedule.pool, 2,
                                                n_len))
        self.plain = plain.tolist()
        with spans("bench.encrypt"):
            self.cts = [[self.dhs.encrypt(p, self.lvl) for p in pair]
                        for pair in self.plain]
            self.pairs = [tuple(poly.to_ntt(ctx, poly.ctxt_from_ints(c,
                                                                     self.lvl))
                                for c in pair) for pair in self.cts]
        for k in range(self.schedule.pool):  # every pair, once
            self._gate(k)

    def _gate(self, k: int):
        poly, ctx, sp = self.poly, self.dhs.ctx, self.spans
        a, b = self.pairs[k]
        with sp("bench.gate"):
            with sp("bench.c_and"):
                x = poly.c_and(ctx, a, b)
            with sp("bench.relin"):
                x = poly.relin(ctx, x)
            with sp("bench.mod_switch"):
                x = poly.mod_switch(ctx, x)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return x

    def op(self):
        return self._gate(0)

    def window(self, seconds: float) -> dict:
        self.kept = {}
        lat, i = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k = self.schedule.input_of(i)
            s = time.perf_counter()
            out = self._gate(k)
            lat.append((time.perf_counter() - s) * 1e3)
            if self.schedule.keep(i):
                self.kept[i] = (k, out.data)
            i += 1
        self.kept[i - 1] = (k, out.data)  # the last answer, always
        return {"attempted": i, "latencies_ms": lat,
                "seconds": time.perf_counter() - t0}

    def shapes(self) -> dict:
        r = self.ring
        return {"batch": 1, "pn": r.pn(self.lvl), "n": r.n,
                "knum": r.knum(self.lvl), "w": r.w,
                "words": r.words(self.lvl)}

    def release(self):
        self.sk = self.dhs.sk[self.lvl + 1]
        self.sk0, self.ek_ints = self.dhs.sk[0], self.dhs.ek
        self.dhs = self.pairs = None

    def check(self) -> list:
        ring, lvl, dev = self.ring, self.lvl, self.device
        t = rg.Tables(ring, dev)
        ek = rdhs.ints_to_ntt(self.ek_ints, t, 0, dev)  # keys: level 0
        ek_wrong = rdhs.eval_key_errors(ek, self.sk0, t, ring.w,
                                        ring.mod_msg)
        used = sorted({k for k, _ in self.kept.values()})
        ref = {}
        for s in range(0, len(used), REF_BLOCK):
            ks = used[s: s + REF_BLOCK]
            a = rdhs.ints_to_ntt([self.cts[k][0] for k in ks], t, lvl, dev)
            b = rdhs.ints_to_ntt([self.cts[k][1] for k in ks], t, lvl, dev)
            out = rg.gate(a, b, ek, t, lvl, ring.mod_msg)
            ref.update({k: out[j] for j, k in enumerate(ks)})
        bad = {i: int((zp.u32_to_i64(o) != ref[k]).sum())
               for i, (k, o) in self.kept.items()}
        self._failed = {i for i, v in bad.items() if v}
        # decrypt some answers and hold them to the plaintexts' product
        m_bits = rdhs.poly_bits([c % 2 for c in ring.poly_mod])
        picks = self.schedule.pick(sorted(self.kept), self.schedule.decrypt)
        wrong = 0
        if picks:
            cts = torch.stack([zp.u32_to_i64(self.kept[i][1]) for i in picks])
            dec = rdhs.decrypt(cts, self.sk, t, lvl + 1, ring.mod_msg)
            for i, d in zip(picks, dec):
                pa, pb = self.plain[self.kept[i][0]]
                want = rdhs.gf2_mulmod(rdhs.poly_bits(pa), rdhs.poly_bits(pb),
                                       m_bits)
                diff = bin(rdhs.poly_bits(d) ^ want).count("1")
                wrong += diff
                if diff:
                    self._failed.add(i)
        return [("ek_wrong_coeffs", ek_wrong, 0),
                ("mismatched_words", sum(bad.values()), 0),
                ("wrong_plaintext_bits", wrong, 0)]

    def failed(self) -> int:
        return len(self._failed)
