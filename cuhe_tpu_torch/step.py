"""The fused homomorphic gate step: (a, b) -> mod_switch(relin(a AND b)).

Counterpart of ``cuhe_tpu/parallel/mesh.py:49-121``
(``batched_and_relin_modswitch``) with no mesh (the hot
path of every homomorphic circuit: DHS AND gates, the PRINCE S-box layers).
It takes batched NTT-domain ciphertext pairs ``[batch, pnum, n]`` (uint32,
mat-linear) and runs, in order:

  1. AND: pointwise mul mod P;                       (kernel K1)
  2. inverse NTT with the mod-p epilogue;             (kernel)
  3. polynomial Barrett: 2 forward, 2 inverse NTTs,   (kernels)
     2 products and the combine;                      (K1, K2)
  4. ICRT to RAW words;                              (kernel)
  5. relinearization: digit NTTs + eval-key mul-acc; (kernels)
  6. inverse NTT and Barrett again;                  (kernels)
  7. modulus switch, dropping one prime.              (kernel K3)

and returns CRT residues ``[batch, pnum-1, n/2]`` at level lvl+1.  The
tables are module buffers, so ``step(a_lo, a_hi, b_lo, b_hi)`` is the whole
call.  ``plain=True`` runs the plain PyTorch versions of all the kernels
on the module's device, and no front end: the reference the kernels are
held against on the card.
The ICRT (`_c2r`) and the modulus switch (`_mod_switch`) are the two steps
that look across prime planes; ``parallel/mesh.py::ShardedGateStep``
replaces just those two to run the step on a crt-sharded slice of the
planes.
"""

from __future__ import annotations

import torch
from torch import nn

from .context import Context
from .ops import barrett, crt
from .ops import ntt_kernels as nk
from .ops import pointwise as pw
from .ops.relin import relinearize


class GateStep(nn.Module):
    """Batched AND + relinearize + modswitch at one level of a Context."""

    def __init__(self, ctx: Context, lvl: int, *, plain: bool = False):
        super().__init__()
        if ctx.ek_ntt is None:
            raise RuntimeError("eval keys not initialised")
        pr = ctx.params
        t = ctx.level(lvl)
        self.ctx = ctx
        self.lvl = lvl
        self.n = ctx.n
        self.mod_len = ctx.mod_len
        self.mod_msg = pr.mod_msg
        self.w = pr.log_relin
        self.knum = pr.num_eval_key_lvl(lvl)
        self.pn = t.pn
        tables = {
            "primes": t.primes, "invp_last": t.invp_last, "bi": t.bi,
            "mi_words": t.mi_words, "m_words": t.m_words,
            "u_lo": t.u_ntt[0], "u_hi": t.u_ntt[1],
            "m_lo": t.m_ntt[0], "m_hi": t.m_ntt[1], "m_crt": t.m_crt,
            "ek_lo": ctx.ek_ntt[0], "ek_hi": ctx.ek_ntt[1],
        }
        for name, v in tables.items():
            self.register_buffer(name, v.contiguous(), persistent=False)
        if plain:
            self._fwd, self._inv = nk.fwd_linear_plain, nk.inv_linear_plain
            self._icrt = crt.icrt_to_raw_plain
            self._digits_mulacc = nk.relin_digits_mulacc_plain
            self._mul, self._combine = (pw.ntt_mul_plain,
                                        barrett.barrett_combine_plain)
            self._switch = pw.mod_switch_plain
        else:
            self._fwd, self._inv = nk.fwd_linear, nk.inv_linear
            self._icrt = crt.icrt_to_raw
            self._digits_mulacc = nk.relin_digits_mulacc
            self._mul, self._combine = pw.ntt_mul, barrett.barrett_combine
            self._switch = pw.mod_switch

    def _n2c_barrett(self, pair) -> torch.Tensor:
        full = self._inv(pair, self.n, self.primes)
        return barrett.barrett_reduce(
            full, mod_len=self.mod_len, n=self.n, u_ntt=(self.u_lo, self.u_hi),
            m_ntt=(self.m_lo, self.m_hi), m_crt=self.m_crt, primes=self.primes,
            fwd=self._fwd, inv=self._inv, mul=self._mul,
            combine=self._combine)

    def _c2r(self, red) -> torch.Tensor:
        return self._icrt(red, self.primes, self.bi, self.mi_words,
                          self.m_words)

    def _mod_switch(self, red) -> torch.Tensor:
        return self._switch(red, self.primes, self.invp_last, self.mod_msg)

    def forward(self, a_lo, a_hi, b_lo, b_hi) -> torch.Tensor:
        prod = self._mul((a_lo, a_hi), (b_lo, b_hi))
        raw = self._c2r(self._n2c_barrett(prod))
        r = relinearize(raw, self.ek_lo, self.ek_hi, w=self.w, knum=self.knum,
                        pnum=self.pn, n=self.n,
                        digits_mulacc=self._digits_mulacc)
        return self._mod_switch(self._n2c_barrett(r))
