"""One homomorphic S-box layer of PRINCE (examples/Prince/Prince.cu:204-460)
in plain PyTorch: what the layer makes of its input state, word for word.

A nibble's bits a, b, c, d (a the most significant) are four ciphertexts.
Each output bit of the S-box, or of its inverse, is a sum over GF(2) of
monomials of degree up to 3 and the constant 1 (`FORWARD`, `INVERSE`; a
test holds them to the cipher's table).  The layer makes them as Prince.cu
does:

  - ab and cd: the product, relinearized, switched to lvl + 1; ac, ad, bc,
    bd: the product, switched without relinearization; a, b, c, d switched;
  - abc, abd, acd, bcd at lvl + 1: ab c, ab d, cd a and cd b, products only;
  - each output: its terms added mod each prime, and the constant 1 as
    mod_msg - 1 added to coefficient 0 (cuHE's NOT);
  - the outputs relinearized and switched to lvl + 2.
"""

from __future__ import annotations

import torch

from . import gate, ntt, zp
from .gate import Tables

FORWARD = (("1", "a", "c", "ab", "bc", "abd", "acd", "bcd"),
           ("a", "d", "ac", "ad", "cd", "abc", "acd"),
           ("1", "ac", "bc", "bd", "abc", "bcd"),
           ("1", "a", "b", "ab", "ad", "bc", "cd", "bcd"))
INVERSE = (("1", "c", "d", "ab", "bc", "bd", "cd", "abc", "abd", "bcd"),
           ("b", "d", "ac", "bc", "bd", "cd", "acd", "bcd"),
           ("1", "ab", "ac", "bc", "bd", "bcd"),
           ("1", "a", "ab", "bc", "cd", "abd", "acd"))
# the cubic terms: which switched product times which switched bit
CUBIC = {"abc": ("ab", "c"), "abd": ("ab", "d"), "acd": ("cd", "a"),
         "bcd": ("cd", "b")}


def layer(state: torch.Tensor, ek, t: Tables, lvl: int, mod_msg: int,
          inverse: bool = False) -> torch.Tensor:
    """Residues int64 [4 k, pn, n/2] of k nibbles at lvl (the rows a, b, c,
    d of each in turn) -> their S-box's residues [4 k, pn - 2, n/2] at
    lvl + 2.  ek: the NTT-domain eval-key pair [num_eval_key, pnum, n]."""
    n, l1 = t.ring.n, lvl + 1

    def prod(x, y, lv):
        return gate.product_to_crt(zp.mul(x, y), t, lv)

    def relin(c, lv):
        return gate.product_to_crt(
            gate.relinearize(gate.icrt(c, t, lv), ek, t, lv), t, lv)

    def switch(c, lv):
        return gate.mod_switch(c, t, lv, mod_msg)

    bits = {b: state[i::4] for i, b in enumerate("abcd")}
    f = {b: ntt.forward(v, n) for b, v in bits.items()}
    m = {b: switch(v, lvl) for b, v in bits.items()}
    for u, v in ("ab", "cd"):
        m[u + v] = switch(relin(prod(f[u], f[v], lvl), lvl), lvl)
    for u, v in ("ac", "ad", "bc", "bd"):
        m[u + v] = switch(prod(f[u], f[v], lvl), lvl)
    g = {k: ntt.forward(m[k], n) for k in ("a", "b", "c", "d", "ab", "cd")}
    for k, (u, v) in CUBIC.items():
        m[k] = prod(g[u], g[v], l1)
    p = t.primes[: t.pn(l1)]
    outs = []
    for terms in (INVERSE if inverse else FORWARD):
        acc = torch.remainder(sum(m[k] for k in terms if k != "1"),
                              p[:, None])
        if "1" in terms:
            acc[..., 0] = torch.remainder(acc[..., 0] + mod_msg - 1, p)
        outs.append(acc)
    out = switch(relin(torch.cat(outs), l1), l1)
    # out0 of every nibble, then out1, ...: back to nibble order
    k = state.shape[0] // 4
    return torch.stack(out.split(k), dim=1).flatten(0, 1)
