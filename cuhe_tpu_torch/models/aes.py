"""Homomorphic AES-128, bitsliced, on the DHS scheme: the evaluation of
Doroz, Hu and Sunar, "Homomorphic AES Evaluation Using the Modified LTV
Scheme" (DCC 80, 2016; ePrint 2014/039), on the port's normal path.

The state is 128 ciphertexts, one a bit: row 8 j + i holds bit i (i = 0 the
most significant) of state byte j (AES's column-major order, j = 4 c + r),
and each ciphertext's plaintext slots hold that bit of as many independent
blocks (1,800 at m = 2^15 - 1).  A round:

  - SubBytes: Boyar and Peralta's depth-16 S-box circuit ("A depth-16
    circuit for the AES S-box", 2012): 34 ANDs at AND-depth 4 and XOR /
    XNOR gates, on all 16 bytes at once.  The ANDs of one AND-depth in all
    16 S-boxes are one batch: one inverse NTT with the product taken at its
    load, one ICRT, one relinearization, one inverse NTT, one modulus
    switch (`LevelTables.n2c` / `c2r` / `relin` / `mod_switch`, the
    composition `step.GateStep` runs).  The state is switched one level
    down first (`LEVELS_PER_ROUND`), so the layer takes it 5 levels down;
    a wire that skips levels is switched down to meet its operands;
  - ShiftRows: a permutation of the state's rows;
  - MixColumns: XORs over GF(2) (none in round 10);
  - AddRoundKey: XOR with the round key's 128 ciphertexts, each encrypted
    once at the level where it is added (5 r for key r).  The key schedule
    runs in the clear, by the key's owner.

The circuit is written once over a gate set: `PlainBits` runs it on 0/1
arrays (the tests, the key schedule's SubWord), `Ciphertexts` on CRT
ciphertexts of a `CuDHS`.  Each layer runs inside a
``torch.profiler.record_function("aes.<layer>")`` range, and `AESStats`
counts a circuit's relinearizations, relinearized products and modulus
switches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dhs import CuDHS
from ..ops import pointwise as pw

ROUNDS = 10
# Levels a round takes: the state is switched one level down as it enters
# the S-box, then the S-box's AND-depth of 4.  With 24-bit primes (the
# largest an exact 64k transform allows) one level an AND-depth lets the
# noise that a round's XORs add to the state square from round 2 on; the
# extra switch brings it back to a fresh ciphertext's each round.
LEVELS_PER_ROUND = 5

# Boyar and Peralta's depth-16 S-box circuit: (output, gate, a, b), gate
# "^" XOR, "&" AND, "~" XNOR; inputs U0..U7 and outputs S0..S7, bit 0 the
# byte's most significant.
SBOX_CIRCUIT = (
    # top linear layer
    ("T1", "^", "U0", "U3"), ("T2", "^", "U0", "U5"),
    ("T3", "^", "U0", "U6"), ("T4", "^", "U3", "U5"),
    ("T5", "^", "U4", "U6"), ("T6", "^", "T1", "T5"),
    ("T7", "^", "U1", "U2"), ("T8", "^", "U7", "T6"),
    ("T9", "^", "U7", "T7"), ("T10", "^", "T6", "T7"),
    ("T11", "^", "U1", "U5"), ("T12", "^", "U2", "U5"),
    ("T13", "^", "T3", "T4"), ("T14", "^", "T6", "T11"),
    ("T15", "^", "T5", "T11"), ("T16", "^", "T5", "T12"),
    ("T17", "^", "T9", "T16"), ("T18", "^", "U3", "U7"),
    ("T19", "^", "T7", "T18"), ("T20", "^", "T1", "T19"),
    ("T21", "^", "U6", "U7"), ("T22", "^", "T7", "T21"),
    ("T23", "^", "T2", "T22"), ("T24", "^", "T2", "T10"),
    ("T25", "^", "T20", "T17"), ("T26", "^", "T3", "T16"),
    ("T27", "^", "T1", "T12"),
    # the shared non-linear middle
    ("M1", "&", "T13", "T6"), ("M2", "&", "T23", "T8"),
    ("M3", "^", "T14", "M1"), ("M4", "&", "T19", "U7"),
    ("M5", "^", "M4", "M1"), ("M6", "&", "T3", "T16"),
    ("M7", "&", "T22", "T9"), ("M8", "^", "T26", "M6"),
    ("M9", "&", "T20", "T17"), ("M10", "^", "M9", "M6"),
    ("M11", "&", "T1", "T15"), ("M12", "&", "T4", "T27"),
    ("M13", "^", "M12", "M11"), ("M14", "&", "T2", "T10"),
    ("M15", "^", "M14", "M11"), ("M16", "^", "M3", "M2"),
    ("M17", "^", "M5", "T24"), ("M18", "^", "M8", "M7"),
    ("M19", "^", "M10", "M15"), ("M20", "^", "M16", "M13"),
    ("M21", "^", "M17", "M15"), ("M22", "^", "M18", "M13"),
    ("M23", "^", "M19", "T25"), ("M24", "^", "M22", "M23"),
    ("M25", "&", "M22", "M20"), ("M26", "^", "M21", "M25"),
    ("M27", "^", "M20", "M21"), ("M28", "^", "M23", "M25"),
    ("M29", "&", "M28", "M27"), ("M30", "&", "M26", "M24"),
    ("M31", "&", "M20", "M23"), ("M32", "&", "M27", "M31"),
    ("M33", "^", "M27", "M25"), ("M34", "&", "M21", "M22"),
    ("M35", "&", "M24", "M34"), ("M36", "^", "M24", "M25"),
    ("M37", "^", "M21", "M29"), ("M38", "^", "M32", "M33"),
    ("M39", "^", "M23", "M30"), ("M40", "^", "M35", "M36"),
    ("M41", "^", "M38", "M40"), ("M42", "^", "M37", "M39"),
    ("M43", "^", "M37", "M38"), ("M44", "^", "M39", "M40"),
    ("M45", "^", "M42", "M41"), ("M46", "&", "M44", "T6"),
    ("M47", "&", "M40", "T8"), ("M48", "&", "M39", "U7"),
    ("M49", "&", "M43", "T16"), ("M50", "&", "M38", "T9"),
    ("M51", "&", "M37", "T17"), ("M52", "&", "M42", "T15"),
    ("M53", "&", "M45", "T27"), ("M54", "&", "M41", "T10"),
    ("M55", "&", "M44", "T13"), ("M56", "&", "M40", "T23"),
    ("M57", "&", "M39", "T19"), ("M58", "&", "M43", "T3"),
    ("M59", "&", "M38", "T22"), ("M60", "&", "M37", "T20"),
    ("M61", "&", "M42", "T1"), ("M62", "&", "M45", "T4"),
    ("M63", "&", "M41", "T2"),
    # bottom linear layer
    ("L0", "^", "M61", "M62"), ("L1", "^", "M50", "M56"),
    ("L2", "^", "M46", "M48"), ("L3", "^", "M47", "M55"),
    ("L4", "^", "M54", "M58"), ("L5", "^", "M49", "M61"),
    ("L6", "^", "M62", "L5"), ("L7", "^", "M46", "L3"),
    ("L8", "^", "M51", "M59"), ("L9", "^", "M52", "M53"),
    ("L10", "^", "M53", "L4"), ("L11", "^", "M60", "L2"),
    ("L12", "^", "M48", "M51"), ("L13", "^", "M50", "L0"),
    ("L14", "^", "M52", "M61"), ("L15", "^", "M55", "L1"),
    ("L16", "^", "M56", "L0"), ("L17", "^", "M57", "L1"),
    ("L18", "^", "M58", "L8"), ("L19", "^", "M63", "L4"),
    ("L20", "^", "L0", "L1"), ("L21", "^", "L1", "L7"),
    ("L22", "^", "L3", "L12"), ("L23", "^", "L18", "L2"),
    ("L24", "^", "L15", "L9"), ("L25", "^", "L6", "L10"),
    ("L26", "^", "L7", "L9"), ("L27", "^", "L8", "L10"),
    ("L28", "^", "L11", "L14"), ("L29", "^", "L11", "L17"),
    ("S0", "^", "L6", "L24"), ("S1", "~", "L16", "L26"),
    ("S2", "~", "L19", "L28"), ("S3", "^", "L6", "L21"),
    ("S4", "^", "L20", "L22"), ("S5", "^", "L25", "L29"),
    ("S6", "~", "L13", "L27"), ("S7", "~", "L6", "L23"),
)
SBOX_INPUTS = tuple(f"U{i}" for i in range(8))
SBOX_OUTPUTS = tuple(f"S{i}" for i in range(8))


def and_depths(circuit=SBOX_CIRCUIT) -> dict:
    """Each wire's AND-depth: the most ANDs on a path from an input."""
    depth = {u: 0 for u in SBOX_INPUTS}
    for out, gate, a, b in circuit:
        depth[out] = max(depth[a], depth[b]) + (gate == "&")
    return depth


def schedule(circuit=SBOX_CIRCUIT) -> list:
    """The circuit as steps, each a linear gate or a batch of ANDs: the
    XOR and XNOR gates whose output has AND-depth k, in the circuit's
    order, then the ANDs of AND-depth k + 1 as one batch, for k = 0, 1, ..
    With each step, the wires that no later step reads (the outputs
    excepted), to be dropped after it: [(gates, is_and, dead names)]."""
    depth = and_depths(circuit)
    steps = []
    for k in range(max(depth.values()) + 1):
        steps += [([g], False) for g in circuit
                  if g[1] != "&" and depth[g[0]] == k]
        ands = [g for g in circuit if g[1] == "&" and depth[g[0]] == k + 1]
        steps += [(ands, True)] if ands else []
    last = {}
    for i, (gates, _) in enumerate(steps):
        for _, _, a, b in gates:
            last[a] = last[b] = i
    dead = [[] for _ in steps]
    for name, i in last.items():
        if name not in SBOX_OUTPUTS:
            dead[i].append(name)
    return [(gates, is_and, tuple(d))
            for (gates, is_and), d in zip(steps, dead)]


def shift_rows_perm() -> np.ndarray:
    """out[row] = in[perm[row]] over the 128 state rows: state byte 4 c + r
    takes byte 4 ((c + r) mod 4) + r."""
    perm = np.zeros(128, dtype=np.int64)
    for c in range(4):
        for r in range(4):
            src = 4 * ((c + r) % 4) + r
            for i in range(8):
                perm[8 * (4 * c + r) + i] = 8 * src + i
    return perm


def mix_columns_matrix() -> np.ndarray:
    """MixColumns as a 0/1 matrix [128, 128] over GF(2): out row o is the
    XOR of the in rows i with M[o, i] = 1.  b_r = 2 a_r + 3 a_(r+1) +
    a_(r+2) + a_(r+3) in GF(2^8), 2 a = xtime(a)."""
    def xtime(byte_rows):  # bit i of 2 a: rows of a, i = 0 the MSB
        out = [set() for _ in range(8)]
        for i in range(8):
            if i < 7:
                out[i] ^= {byte_rows[i + 1]}
            if i in (3, 4, 6, 7):  # x^8 = x^4 + x^3 + x + 1
                out[i] ^= {byte_rows[0]}
        return out

    m = np.zeros((128, 128), dtype=np.uint8)
    for c in range(4):
        rows = [[8 * (4 * c + r) + i for i in range(8)] for r in range(4)]
        for r in range(4):
            a0, a1, a2, a3 = (rows[(r + k) % 4] for k in range(4))
            x0, x1 = xtime(a0), xtime(a1)
            for i in range(8):
                terms = x0[i] ^ x1[i] ^ {a1[i]} ^ {a2[i]} ^ {a3[i]}
                for t in terms:
                    m[8 * (4 * c + r) + i, t] ^= 1
    return m


def linear_terms(m: np.ndarray) -> list:
    """A 0/1 matrix's rows as index columns: term t of output o is
    cols[t][o] (-1 where row o has fewer than t + 1 terms)."""
    width = int(m.sum(axis=1).max())
    cols = np.full((width, m.shape[0]), -1, dtype=np.int64)
    for o in range(m.shape[0]):
        idx = np.nonzero(m[o])[0]
        cols[: len(idx), o] = idx
    return list(cols)


# ---------------------------------------------------------------------------
# the key schedule, in the clear (FIPS-197 section 5.2)
# ---------------------------------------------------------------------------

def byte_bits(values) -> np.ndarray:
    """Bytes [.., k] -> bits [.., 8 k], most significant first."""
    v = np.asarray(values, dtype=np.uint8)
    return np.unpackbits(v[..., None], axis=-1).reshape(v.shape[:-1] +
                                                       (8 * v.shape[-1],))


def bits_bytes(bits) -> np.ndarray:
    """Bits [.., 8 k], most significant first -> bytes [.., k]."""
    b = np.asarray(bits, dtype=np.uint8)
    return np.packbits(b.reshape(b.shape[:-1] + (-1, 8)), axis=-1)[..., 0]


def sbox_table() -> np.ndarray:
    """The S-box of all 256 bytes, by the circuit on plain bits."""
    u = byte_bits(np.arange(256, dtype=np.uint8)[:, None])  # [256, 8]
    out = sbox(PlainBits(), [u[:, i] for i in range(8)])
    return bits_bytes(np.stack(out, axis=1))[:, 0]


def expand_key(key: bytes) -> np.ndarray:
    """AES-128's 11 round keys, uint8 [11, 16], each in state order."""
    if len(key) != 16:
        raise ValueError("AES-128 takes a 16-byte key")
    s = sbox_table()
    w = [list(key[4 * i: 4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [int(s[b]) for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = (rcon << 1) ^ (0x11B if rcon & 0x80 else 0)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.array(w, dtype=np.uint8).reshape(11, 16)


# ---------------------------------------------------------------------------
# gate sets
# ---------------------------------------------------------------------------

class PlainBits:
    """The circuit on 0/1 uint8 arrays: a wire is an array, one element a
    lane; the state is [128, lanes]."""

    def drop(self, state):
        return state

    def xor(self, a, b):
        return a ^ b

    def xnor(self, a, b):
        return a ^ b ^ 1

    def and_many(self, pairs: list) -> list:
        return [a & b for a, b in pairs]

    def rows(self, state, i: int, step: int):
        return state[i::step]

    def interleave(self, wires: list):
        return np.stack(wires, axis=1).reshape((-1,) + wires[0].shape[1:])

    def index(self, idx: np.ndarray):
        return idx

    def take(self, state, idx):
        return state[idx]

    def xor_rows(self, out, rows, other):
        out = out.copy()
        out[rows] ^= other
        return out


@dataclasses.dataclass
class AESStats:
    """A circuit's work on the scheme, counted with no synchronisation:
    relinearizations (one a batch of ANDs), the products they take, and
    modulus switches (calls, each a batch)."""

    relin_calls: int = 0
    products: int = 0
    switches: int = 0

    def reset(self):
        self.relin_calls = self.products = self.switches = 0


class Wire:
    """A batch of CRT ciphertexts [k, pn, n/2] at a level, and the same
    switched down to deeper levels as they are asked for."""

    def __init__(self, data: torch.Tensor, level: int):
        self.level = level
        self.at = {level: data}

    @property
    def data(self) -> torch.Tensor:
        return self.at[self.level]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the first axis, for a uint32 x (PyTorch's CUDA gather
    takes no uint32: the words move through an int32 view)."""
    return x.view(torch.int32)[idx].view(torch.uint32)


class Ciphertexts:
    """The circuit on CRT ciphertexts of a `CuDHS`, on its context's
    device: XOR is K4, NOT K7 on coefficient 0, a batch of ANDs the level's
    conversions; a wire is a `Wire`, the state a `Wire` of 128 rows."""

    def __init__(self, dhs: CuDHS, stats: AESStats | None = None):
        self.dhs, self.ctx = dhs, dhs.ctx
        self.stats = stats if stats is not None else AESStats()

    def switch(self, wires: list, level: int) -> None:
        """Bring every wire down to `level`: one modulus switch a level for
        all the wires that pass it."""
        todo = [w for w in wires if max(w.at) < level]
        for lvl in range(min((max(w.at) for w in todo), default=level), level):
            batch = [w for w in todo if max(w.at) == lvl]
            if not batch:
                continue
            x = torch.cat([w.at[lvl] for w in batch]) if len(batch) > 1 \
                else batch[0].at[lvl]
            y = self.ctx.level(lvl).mod_switch(x)
            self.stats.switches += 1
            for w, part in zip(batch, y.split([w.at[lvl].shape[0]
                                                 for w in batch])):
                w.at[lvl + 1] = part

    def drop(self, w: Wire) -> Wire:
        """The wire switched one level down, as a new wire."""
        self.stats.switches += 1
        return Wire(self.ctx.level(w.level).mod_switch(w.data), w.level + 1)

    def _pair(self, a: Wire, b: Wire):
        lvl = max(a.level, b.level)
        self.switch([a, b], lvl)
        return a.at[lvl], b.at[lvl], lvl

    def xor(self, a: Wire, b: Wire) -> Wire:
        x, y, lvl = self._pair(a, b)
        return Wire(pw.crt_add(x, y, self.ctx.level(lvl).primes), lvl)

    def xnor(self, a: Wire, b: Wire) -> Wire:
        w = self.xor(a, b)
        return Wire(pw.crt_add_int(w.data, self.dhs.params.mod_msg - 1,
                                   self.ctx.level(w.level).primes), w.level)

    def and_many(self, pairs: list) -> list:
        """Every product of `pairs` relinearized and switched one level
        down, as one batch at the deepest operand's level."""
        lvl = max(max(a.level, b.level) for a, b in pairs)
        self.switch([w for p in pairs for w in p], lvl)
        t, ctx = self.ctx.level(lvl), self.ctx
        k = pairs[0][0].data.shape[0]
        # every NTT-domain value is a temporary, which `n2c` drops before
        # Barrett's own (at level 4 of the AES ring, 7 GB each)
        raw = t.c2r(t.n2c(True,
                          ctx.c2n(torch.cat([p[0].at[lvl] for p in pairs])),
                          ctx.c2n(torch.cat([p[1].at[lvl] for p in pairs]))))
        out = t.mod_switch(t.n2c(True, t.relin(raw, ctx.ek_ntt)))
        del raw
        self.stats.relin_calls += 1
        self.stats.products += out.shape[0]
        self.stats.switches += 1
        return [Wire(v, lvl + 1) for v in out.split(k)]

    def rows(self, state: Wire, i: int, step: int) -> Wire:
        return Wire(state.data[i::step].contiguous(), state.level)

    def interleave(self, wires: list) -> Wire:
        lvl = max(w.level for w in wires)
        self.switch(wires, lvl)
        x = torch.stack([w.at[lvl] for w in wires], dim=1).flatten(0, 1)
        return Wire(x, lvl)

    def index(self, idx: np.ndarray) -> torch.Tensor:
        """Row indices, on the device once (a copy to the device waits for
        the work queued before it)."""
        return torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(
            self.ctx.device)

    def take(self, state: Wire, idx: torch.Tensor) -> Wire:
        return Wire(_take_rows(state.data, idx), state.level)

    def xor_rows(self, out: Wire, rows: torch.Tensor, other: Wire) -> Wire:
        """out with other's rows added to its rows `rows`."""
        x = out.data.clone()
        part = pw.crt_add(_take_rows(x, rows), other.data,
                          self.ctx.level(out.level).primes)
        x.view(torch.int32)[rows] = part.view(torch.int32)
        return Wire(x, out.level)


# ---------------------------------------------------------------------------
# the circuit, once over a gate set
# ---------------------------------------------------------------------------

def sbox(g, u: list) -> list:
    """The S-box circuit on eight input wires U0..U7 (U0 the most
    significant bit of each lane's byte) -> the eight output wires.  A wire
    is dropped after the last step that reads it."""
    w = dict(zip(SBOX_INPUTS, u))
    del u
    for gates, is_and, dead in SCHEDULE:
        if is_and:
            outs = g.and_many([(w[a], w[b]) for _, _, a, b in gates])
            w.update(zip((o for o, _, _, _ in gates), outs))
        else:
            out, gate, a, b = gates[0]
            w[out] = (g.xor if gate == "^" else g.xnor)(w[a], w[b])
        for name in dead:
            del w[name]
    return [w[s] for s in SBOX_OUTPUTS]


SCHEDULE = schedule()
SHIFT_ROWS = shift_rows_perm()
MIX_TERMS = linear_terms(mix_columns_matrix())


def _range(name: str):
    return torch.profiler.record_function(f"aes.{name}")


class AES:
    """AES-128 over a gate set: `encrypt(state, round_keys)` runs the whole
    cipher on a 128-row state, a round key a round (11, each the state's
    shape, at the level where it is added for ciphertexts)."""

    def __init__(self, gates, rounds: int = ROUNDS):
        self.g, self.rounds = gates, rounds
        self._shift = gates.index(SHIFT_ROWS)
        self._mix = [gates.index(MIX_TERMS[0])]
        for cols in MIX_TERMS[1:]:
            rows = np.nonzero(cols >= 0)[0]
            self._mix.append((gates.index(rows), gates.index(cols[rows])))

    def sub_bytes(self, state):
        g = self.g
        with _range("sub_bytes"):
            state = g.drop(state)
            u = [g.rows(state, i, 8) for i in range(8)]
            del state
            return g.interleave(sbox(g, u))

    def shift_rows(self, state):
        with _range("shift_rows"):
            return self.g.take(state, self._shift)

    def mix_columns(self, state):
        g = self.g
        with _range("mix_columns"):
            out = g.take(state, self._mix[0])
            for rows, cols in self._mix[1:]:
                out = g.xor_rows(out, rows, g.take(state, cols))
            return out

    def add_round_key(self, state, key):
        with _range("add_round_key"):
            return self.g.xor(state, key)

    def encrypt(self, state, round_keys: list):
        """The cipher cut to `rounds` rounds (the last without MixColumns,
        AES's own form for 10)."""
        state = self.add_round_key(state, round_keys[0])
        for r in range(1, self.rounds + 1):
            state = self.shift_rows(self.sub_bytes(state))
            if r < self.rounds:
                state = self.mix_columns(state)
            state = self.add_round_key(state, round_keys[r])
        return state


def encrypt_plain(blocks: np.ndarray, key: bytes,
                  rounds: int = ROUNDS) -> np.ndarray:
    """AES-128 of uint8 blocks [B, 16] through the circuit on plain bits:
    what the homomorphic circuit computes slot by slot."""
    keys = expand_key(key)
    state = byte_bits(blocks).T  # [128, B]
    ks = [np.repeat(byte_bits(k)[:, None], len(blocks), axis=1)
          for k in keys[: rounds + 1]]
    out = AES(PlainBits(), rounds).encrypt(state, ks)
    return bits_bytes(out.T)


class HomomorphicAES:
    """AES-128 on a `CuDHS`: the state's 128 ciphertexts at level 0 hold a
    block a slot; the round keys are encrypted once, key r at level 5 r,
    every slot the same key bit."""

    def __init__(self, dhs: CuDHS, rounds: int = ROUNDS):
        need = LEVELS_PER_ROUND * rounds + 1
        if dhs.params.depth < need:
            raise ValueError(f"{rounds} rounds take {need} levels; the "
                             f"scheme has {dhs.params.depth}")
        self.dhs, self.rounds = dhs, rounds
        self.stats = AESStats()
        self.gates = Ciphertexts(dhs, self.stats)
        self.aes = AES(self.gates, rounds)

    def encrypt_blocks(self, blocks: np.ndarray) -> Wire:
        """uint8 [slots <= num_slot, 16] -> the state at level 0, block b
        in slot b."""
        bits = byte_bits(blocks).T  # [128, B]
        plain = self.dhs.batcher.encode_many(bits)
        return Wire(self.dhs.encrypt_crt(plain, 0), 0)

    def encrypt_key(self, key: bytes) -> list:
        """The round keys' ciphertexts, key r at level 5 r."""
        keys = expand_key(key)
        enc = self.dhs.batcher.encode_many([[0] * self.dhs.num_slot,
                                            [1] * self.dhs.num_slot])
        out = []
        for r in range(self.rounds + 1):
            lvl = LEVELS_PER_ROUND * r
            out.append(Wire(self.dhs.encrypt_crt(enc[byte_bits(keys[r])],
                                                 lvl), lvl))
        return out

    def circuit(self, state: Wire, round_keys: list) -> Wire:
        """The whole cipher on the state: level 0 -> 5 `rounds`."""
        return self.aes.encrypt(state, round_keys)
