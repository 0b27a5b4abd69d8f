"""One homomorphic AES S-box layer in plain PyTorch: what the layer makes
of its input state, word for word, through reference/gate.py's
conversions.

The circuit is Boyar and Peralta's depth-16 S-box ("A depth-16 circuit for
the AES S-box", 2012), written out again here: 34 ANDs at AND-depth 4 and
XOR / XNOR gates, inputs U0..U7 and outputs S0..S7 (0 the byte's most
significant bit; a test holds it to the AES S-box table).  On ciphertexts:

  - XOR: the sum mod each prime at the deeper operand's level, the other
    operand modulus-switched down to it one level at a time;
  - XNOR: the XOR, then mod_msg - 1 added to coefficient 0 (cuHE's NOT);
  - AND: at the deeper operand's level (the other switched down), the
    product, relinearized and switched one level down (`gate.gate`); the
    ANDs of one AND-depth are computed together, their rows in blocks.

The layer first switches its whole input one level down (the port's
`LEVELS_PER_ROUND`: a fresh ciphertext's noise for the S-box), so it takes
its input's level l to l + 5.
"""

from __future__ import annotations

import torch

from . import gate, ntt
from .gate import Tables

CIRCUIT = (
    "T1 = U0 ^ U3", "T2 = U0 ^ U5", "T3 = U0 ^ U6", "T4 = U3 ^ U5",
    "T5 = U4 ^ U6", "T6 = T1 ^ T5", "T7 = U1 ^ U2", "T8 = U7 ^ T6",
    "T9 = U7 ^ T7", "T10 = T6 ^ T7", "T11 = U1 ^ U5", "T12 = U2 ^ U5",
    "T13 = T3 ^ T4", "T14 = T6 ^ T11", "T15 = T5 ^ T11", "T16 = T5 ^ T12",
    "T17 = T9 ^ T16", "T18 = U3 ^ U7", "T19 = T7 ^ T18", "T20 = T1 ^ T19",
    "T21 = U6 ^ U7", "T22 = T7 ^ T21", "T23 = T2 ^ T22", "T24 = T2 ^ T10",
    "T25 = T20 ^ T17", "T26 = T3 ^ T16", "T27 = T1 ^ T12",
    "M1 = T13 & T6", "M2 = T23 & T8", "M3 = T14 ^ M1", "M4 = T19 & U7",
    "M5 = M4 ^ M1", "M6 = T3 & T16", "M7 = T22 & T9", "M8 = T26 ^ M6",
    "M9 = T20 & T17", "M10 = M9 ^ M6", "M11 = T1 & T15", "M12 = T4 & T27",
    "M13 = M12 ^ M11", "M14 = T2 & T10", "M15 = M14 ^ M11",
    "M16 = M3 ^ M2", "M17 = M5 ^ T24", "M18 = M8 ^ M7", "M19 = M10 ^ M15",
    "M20 = M16 ^ M13", "M21 = M17 ^ M15", "M22 = M18 ^ M13",
    "M23 = M19 ^ T25", "M24 = M22 ^ M23", "M25 = M22 & M20",
    "M26 = M21 ^ M25", "M27 = M20 ^ M21", "M28 = M23 ^ M25",
    "M29 = M28 & M27", "M30 = M26 & M24", "M31 = M20 & M23",
    "M32 = M27 & M31", "M33 = M27 ^ M25", "M34 = M21 & M22",
    "M35 = M24 & M34", "M36 = M24 ^ M25", "M37 = M21 ^ M29",
    "M38 = M32 ^ M33", "M39 = M23 ^ M30", "M40 = M35 ^ M36",
    "M41 = M38 ^ M40", "M42 = M37 ^ M39", "M43 = M37 ^ M38",
    "M44 = M39 ^ M40", "M45 = M42 ^ M41", "M46 = M44 & T6",
    "M47 = M40 & T8", "M48 = M39 & U7", "M49 = M43 & T16", "M50 = M38 & T9",
    "M51 = M37 & T17", "M52 = M42 & T15", "M53 = M45 & T27",
    "M54 = M41 & T10", "M55 = M44 & T13", "M56 = M40 & T23",
    "M57 = M39 & T19", "M58 = M43 & T3", "M59 = M38 & T22",
    "M60 = M37 & T20", "M61 = M42 & T1", "M62 = M45 & T4", "M63 = M41 & T2",
    "L0 = M61 ^ M62", "L1 = M50 ^ M56", "L2 = M46 ^ M48", "L3 = M47 ^ M55",
    "L4 = M54 ^ M58", "L5 = M49 ^ M61", "L6 = M62 ^ L5", "L7 = M46 ^ L3",
    "L8 = M51 ^ M59", "L9 = M52 ^ M53", "L10 = M53 ^ L4", "L11 = M60 ^ L2",
    "L12 = M48 ^ M51", "L13 = M50 ^ L0", "L14 = M52 ^ M61",
    "L15 = M55 ^ L1", "L16 = M56 ^ L0", "L17 = M57 ^ L1", "L18 = M58 ^ L8",
    "L19 = M63 ^ L4", "L20 = L0 ^ L1", "L21 = L1 ^ L7", "L22 = L3 ^ L12",
    "L23 = L18 ^ L2", "L24 = L15 ^ L9", "L25 = L6 ^ L10", "L26 = L7 ^ L9",
    "L27 = L8 ^ L10", "L28 = L11 ^ L14", "L29 = L11 ^ L17",
    "S0 = L6 ^ L24", "S1 = L16 ~ L26", "S2 = L19 ~ L28", "S3 = L6 ^ L21",
    "S4 = L20 ^ L22", "S5 = L25 ^ L29", "S6 = L13 ~ L27", "S7 = L6 ~ L23",
)
GATES = tuple((w[0], w[2], w[3], w[4]) for w in map(str.split, CIRCUIT))
# (out, a, gate, b)
REF_BLOCK = 16  # products a block of the reference gate


def and_depth() -> dict:
    """Each wire's AND-depth: the most ANDs on a path from an input."""
    d = {f"U{i}": 0 for i in range(8)}
    for out, a, op, b in GATES:
        d[out] = max(d[a], d[b]) + (op == "&")
    return d


def on_bits(byte: int) -> int:
    """The circuit on one byte's plain bits."""
    w = {f"U{i}": (byte >> (7 - i)) & 1 for i in range(8)}
    for out, a, op, b in GATES:
        v = w[a] ^ w[b] if op != "&" else w[a] & w[b]
        w[out] = v ^ 1 if op == "~" else v
    return sum(w[f"S{i}"] << (7 - i) for i in range(8))


def layer(state: torch.Tensor, ek, t: Tables, lvl: int,
          mod_msg: int) -> torch.Tensor:
    """Residues int64 [8 k, pn, n/2] of k bytes at lvl (row 8 j + i: bit i
    of byte j) -> their S-box's residues [8 k, pn - 5, n/2] at lvl + 5.
    ek: the NTT-domain eval-key pair [num_eval_key, pnum, n]."""
    n = t.ring.n
    state = gate.mod_switch(state, t, lvl, mod_msg)
    lvl += 1
    level = {f"U{i}": lvl for i in range(8)}  # each wire's own level
    wires = {f"U{i}": {lvl: state[i::8]} for i in range(8)}

    def at(name, lv):
        have = wires[name]
        top = max(have)
        while top < lv:
            have[top + 1] = gate.mod_switch(have[top], t, top, mod_msg)
            top += 1
        return have[lv]

    def xor(out, a, op, b):
        lv = max(level[a], level[b])
        p = t.primes[: t.pn(lv), None]
        v = torch.remainder(at(a, lv) + at(b, lv), p)
        if op == "~":
            v[..., 0] = torch.remainder(v[..., 0] + mod_msg - 1, p[:, 0])
        level[out], wires[out] = lv, {lv: v}

    def ands(gates):
        """Every AND of one AND-depth at once, REF_BLOCK rows a call."""
        lv = max(max(level[a], level[b]) for _, a, _, b in gates)
        x = torch.cat([at(a, lv) for _, a, _, _ in gates])
        y = torch.cat([at(b, lv) for _, _, _, b in gates])
        outs = [gate.gate(ntt.forward(x[s: s + REF_BLOCK], n),
                          ntt.forward(y[s: s + REF_BLOCK], n), ek, t, lv,
                          mod_msg) for s in range(0, x.shape[0], REF_BLOCK)]
        for (out, _, _, _), v in zip(gates, torch.cat(outs).split(
                state.shape[0] // 8)):
            level[out], wires[out] = lv + 1, {lv + 1: v}

    depth = and_depth()
    for d in range(max(depth.values()) + 1):
        for g in GATES:
            if g[2] != "&" and depth[g[0]] == d:
                xor(*g)
        batch = [g for g in GATES if g[2] == "&" and depth[g[0]] == d + 1]
        if batch:
            ands(batch)
    outs = [at(f"S{i}", lvl + 4) for i in range(8)]
    return torch.stack(outs, dim=1).flatten(0, 1)
