"""The fused homomorphic gate step: (a, b) -> mod_switch(relin(a AND b)).

Counterpart of ``cuhe_tpu/parallel/mesh.py:49-121``
(``batched_and_relin_modswitch``) with no mesh (the hot
path of every homomorphic circuit: DHS AND gates, the PRINCE S-box layers).
It takes batched NTT-domain ciphertext pairs ``[batch, pnum, n]`` (uint32,
mat-linear) and returns CRT residues ``[batch, pnum-1, n/2]`` at level
lvl+1, composing the level's conversions (``context.py::LevelTables``):

  n2c of the product a * b (the AND taken inside the inverse NTT, then
  Barrett), c2r (the ICRT), relin, n2c of the product, mod_switch.

``step(a_lo, a_hi, b_lo, b_hi)`` is the whole call.  ``plain=True`` runs
the plain PyTorch versions of all the kernels on the context's device, and
no front end: the reference the kernels are held against on the card.
The ICRT (`_c2r`) and the modulus switch (`_mod_switch`) are the two steps
that look across prime planes; ``parallel/mesh.py::ShardedGateStep``
replaces just those two to run the step on a crt-sharded slice of the
planes.
"""

from __future__ import annotations

import torch

from .context import KERNELS, PLAIN, Context


class GateStep:
    """Batched AND + relinearize + modswitch at one level of a Context."""

    def __init__(self, ctx: Context, lvl: int, *, plain: bool = False):
        if ctx.ek_ntt is None:
            raise RuntimeError("eval keys not initialised")
        self.ctx = ctx
        self.t = ctx.level(lvl)
        self.ek_lo, self.ek_hi = ctx.ek_ntt
        self.ops = PLAIN if plain else KERNELS

    def _c2r(self, red) -> torch.Tensor:
        return self.t.c2r(red, self.ops)

    def _mod_switch(self, red) -> torch.Tensor:
        return self.t.mod_switch(red, self.ops)

    def __call__(self, a_lo, a_hi, b_lo, b_hi) -> torch.Tensor:
        t, ops = self.t, self.ops
        raw = self._c2r(t.n2c(True, (a_lo, a_hi), (b_lo, b_hi), ops))
        r = t.relin(raw, (self.ek_lo, self.ek_hi), ops)
        return self._mod_switch(t.n2c(True, r, ops=ops))
