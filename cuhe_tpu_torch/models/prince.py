"""Homomorphic PRINCE block cipher, the reference's flagship application.

Counterpart of ``cuhe_tpu/models/prince.py`` (the reference's
examples/Prince/Prince.{h,cu}).  The whole 64-ciphertext state is one
batched CRT tensor ``[64, pnum, n/2]`` on the context's device; the linear
layers are index gathers, CRT adds (K4) and round-constant adds (K7) on
that device; an S-box layer evaluates all 16 nibbles as one batch through
the Context's per-level conversions, so on a card every NTT, ICRT,
relinearization and elementwise op runs the port's CUDA kernels.

The gate schedule of the S-box layer (which products are relinearized,
where the modulus switches happen) follows Prince.cu:204-322 and 339-460,
since it fixes the noise growth and the level bookkeeping: six pairwise
products, relinearization of ab and cd only, a modulus switch of the ten
linear and quadratic terms, the XOR algebra one level down, four cubic
products, then a final relinearization and modulus switch.  The level rises
by 2 a layer.  The JAX package also runs the layer as separately compiled
stages, for its TPU compiler's limits; eager PyTorch needs one form only,
and it gives the same bits.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import hostmath as hm
from ..context import Context
from ..dhs import CuDHS
from ..ops import pointwise as pw
from ..utils.timer import timed

CIRCUIT_DEPTH = 25  # Prince.cu:8

# Published PRINCE round constants (RC0..RC11); the reference stores the same
# values as a bit table (Prince.cu:10-34), MSB-first per 64-bit word.
RC_HEX = [
    0x0000000000000000, 0x13198A2E03707344, 0xA4093822299F31D0,
    0x082EFA98EC4E6C89, 0x452821E638D01377, 0xBE5466CF34E90C6C,
    0x7EF84F78FD955CB1, 0x85840851F1AC43AA, 0xC882D32F25323C54,
    0x64A51195E0E3610D, 0xD3B5A399CA0C2399, 0xC0AC29B7C97C50DD,
]


def rc_bits(rnd: int) -> list[int]:
    v = RC_HEX[rnd]
    return [(v >> (63 - i)) & 1 for i in range(64)]


def _mp_skip0(i: int) -> int:
    # block M0^: output i of a 16-bit block sums its column group minus one
    # position (pattern recovered from Prince.cu:476-491)
    return 4 * ((i % 4 - i // 4) % 4) + (i % 4)


def mp_index_table() -> np.ndarray:
    """[64, 3] input indices summed into each M' output (Prince.cu:472-550)."""
    out = np.zeros((64, 3), dtype=np.int32)
    block_kind = [0, 1, 1, 0]  # M' = diag(M0^, M1^, M1^, M0^)
    for b in range(4):
        for i in range(16):
            skip = _mp_skip0((i + 4 * block_kind[b]) % 16)
            group = [4 * k + i % 4 for k in range(4)]
            sel = [g for g in group if g != skip]
            out[16 * b + i] = [16 * b + s for s in sel]
    return out


def _apply_block_rotation(perm: list[int], i0: int, rot: int):
    idx = [i0 + d for d in (0, 1, 2, 3)] + \
          [i0 + 16 + d for d in (0, 1, 2, 3)] + \
          [i0 + 32 + d for d in (0, 1, 2, 3)] + \
          [i0 + 48 + d for d in (0, 1, 2, 3)]
    vals = [perm[j] for j in idx]
    for k, j in enumerate(idx):
        perm[j] = vals[(k + 4 * rot) % 16]


def shiftrow_perm(inverse: bool) -> np.ndarray:
    """out[i] = in[perm[i]] for ShiftRow / inv_ShiftRow (Prince.cu:552-664)."""
    perm = list(range(64))
    rots = {4: 1, 8: 2, 12: 3}
    for i0, r in rots.items():
        _apply_block_rotation(perm, i0, r if not inverse else (4 - r) % 4)
    return np.array(perm, dtype=np.int32)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64)).to(device)


# PyTorch's CUDA gather and roll take no uint32 tensors: they move the
# states' words through an int32 view of the same bits.
def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the first axis, for a uint32 x."""
    return x.view(torch.int32)[idx].view(torch.uint32)


class Prince:
    """Homomorphic PRINCE over a CuDHS instance (Prince.h:3-36)."""

    EXPECTED_FINAL = ("100111111011010100011001001101011111110000111101"
                      "1111010100100100")  # Prince.cu:96
    EXPECTED_ROUNDS = {  # per-round known-answer states (Prince.cu:108-147)
        0: "0100010001000100010001000100010001000100010001000100010001000100",
        1: "1100000111000101111011011001100010100001001010100010000110111011",
        2: "0001010111110110111001101000001101110010101111110010111100010111",
        3: "0000111110110100100011001100001110111010101010110110101101110000",
    }

    def __init__(self, dhs: CuDHS | None = None, seed: int | None = 7,
                 device="cuda"):
        """PRINCE over `dhs`, or over a new CuDHS(CIRCUIT_DEPTH, 2, 16, 25,
        25, 21845) with keys from `seed` on `device`.  The state lives on
        the scheme's context's device."""
        self.dhs = dhs or CuDHS(CIRCUIT_DEPTH, 2, 16, 25, 25, 21845,
                                seed=seed, device=device)
        self.ctx: Context = self.dhs.ctx
        self.level = 0
        dev = self.ctx.device
        self._mp_idx = _index(mp_index_table(), dev)
        self._sr = _index(shiftrow_perm(False), dev)
        self._isr = _index(shiftrow_perm(True), dev)

    # ------------------------------------------------------------------
    # host <-> device state
    # ------------------------------------------------------------------
    def encrypt_state(self, bits: list[int]) -> torch.Tensor:
        """64 bits -> CRT-domain batched ciphertext state [64, pnum, clen]."""
        return self.dhs.encrypt_crt([[b] for b in bits], 0)

    def decrypt_state(self, state: torch.Tensor, lvl: int) -> list[int]:
        """Decrypt constant terms of all 64 ciphertexts."""
        pr = self.ctx.params
        raw = self.ctx.c2r(lvl, state).cpu().numpy()
        cts = [hm.words_to_ints(raw[i])[: pr.mod_len] for i in range(raw.shape[0])]
        outs = self.dhs.decrypt_many(cts, lvl)
        return [o[0] if o else 0 for o in outs]

    # ------------------------------------------------------------------
    # linear layers (device, CRT domain)
    # ------------------------------------------------------------------
    def _crt_add(self, x, y, lvl):
        return pw.crt_add(x, y, self.ctx.level(lvl).primes)

    def _add_coeff0(self, x, c, lvl):
        """A fresh state with (x[..., 0] + c) mod p_i in coefficient 0 of
        every plane: c an int, or uint32 of x's leading shape (one value a
        ciphertext); K7 on the card (`pointwise.crt_add_int`,
        `crt_add_int_rows`)."""
        primes = self.ctx.level(lvl).primes
        if isinstance(c, torch.Tensor):
            return pw.crt_add_int_rows(x, c, primes)
        return pw.crt_add_int(x, c, primes)

    def add_round_key(self, state, key_state, lvl):
        return self._crt_add(state, key_state, lvl)

    def add_rc(self, state, rnd, lvl):
        rc = torch.from_numpy(np.array(rc_bits(rnd), dtype=np.uint32))
        return self._add_coeff0(state, rc.to(state.device), lvl)

    def m_p(self, state, lvl):
        g = [_take(state, self._mp_idx[:, k]) for k in range(3)]  # [64, pn, n]
        return self._crt_add(self._crt_add(g[0], g[1], lvl), g[2], lvl)

    def shift_row(self, state):
        return _take(state, self._sr)

    def inv_shift_row(self, state):
        return _take(state, self._isr)

    def mix_column(self, state, lvl):
        return self.shift_row(self.m_p(state, lvl))

    def inv_mix_column(self, state, lvl):
        return self.m_p(self.inv_shift_row(state), lvl)

    def key_expansion(self, key_state, lvl):
        """key' = rotate-right-by-1, then key'[63] += key[0] (Prince.cu:664-672)."""
        rot = torch.roll(key_state.view(torch.int32), 1, dims=0).view(
            torch.uint32)
        rot[63] = self._crt_add(rot[63], key_state[0], lvl)
        return rot

    # ------------------------------------------------------------------
    # S-box layer (device)
    # ------------------------------------------------------------------
    def _cnot(self, x, lvl):
        """NOT: coefficient 0 plus mod_msg - 1 (cuhe's cNot)."""
        return self._add_coeff0(x, self.ctx.params.mod_msg - 1, lvl)

    def _relin(self, lvl, c):
        """CRT ciphertexts of products -> relinearized CRT ciphertexts."""
        ctx = self.ctx
        return ctx.n2c(lvl, True, ctx.relin(lvl, ctx.c2r(lvl, c)))

    def _sbox(self, state, lvl: int, inverse: bool):
        """One full S-box substitution layer, 16 nibbles batched: the state
        at level lvl -> the state at level lvl + 2 (Prince.cu:204-322,
        339-460)."""
        ctx = self.ctx
        mul = pw.ntt_mul
        cat = torch.cat

        # nibble bits a, b, c, d: [4, 16, pn, clen], to the NTT domain
        abcd = torch.stack([state[0::4], state[1::4], state[2::4],
                            state[3::4]])
        lo, hi = ctx.c2n(abcd)
        A, B, C, D = ((lo[i], hi[i]) for i in range(4))
        # each name is dropped once used: at level 0 of the PRINCE ring
        # every one of these tensors is hundreds of MB
        del lo, hi
        # six pairwise products; relinearize ab and cd (batched [2*16]),
        # only reduce the others
        ab, cd = mul(A, B), mul(C, D)
        rl = self._relin(lvl, ctx.n2c(
            lvl, True, (cat([ab[0], cd[0]]), cat([ab[1], cd[1]]))))
        del ab, cd
        others = [mul(A, C), mul(A, D), mul(B, C), mul(B, D)]
        del A, B, C, D
        ot = ctx.n2c(lvl, True, (cat([o[0] for o in others]),
                                 cat([o[1] for o in others])))
        del others
        # modulus switch of all ten terms to lvl + 1
        sw = ctx.mod_switch(lvl, cat([rl, ot, abcd.flatten(0, 1)]))
        del rl, ot, abcd
        (ab1, cd1, ac1, ad1, bc1, bd1, a1, b1, c1, d1) = sw.split(16)

        lvl1 = lvl + 1

        def x(u, v):
            return self._crt_add(u, v, lvl1)

        def cnot(u):
            return self._cnot(u, lvl1)

        if not inverse:
            # out0 = a+c+ab+bc+1 ; out1 = a+d+ac+ad+cd
            # out2 = ac+bc+bd+1  ; out3 = a+b+ab+ad+bc+cd+1
            out0 = cnot(x(x(x(a1, c1), ab1), bc1))
            out1 = x(x(x(x(a1, d1), ac1), ad1), cd1)
            out2 = cnot(x(x(ac1, bc1), bd1))
            out3 = cnot(x(x(x(x(x(a1, b1), ab1), ad1), bc1), cd1))
        else:
            # out0 = c+d+ab+bc+bd+cd+1 ; out1 = b+d+ac+bc+bd+cd
            # out2 = ab+ac+bc+bd+1     ; out3 = a+ab+bc+cd+1
            out0 = cnot(x(x(x(x(x(c1, d1), ab1), bc1), bd1), cd1))
            out1 = x(x(x(x(x(b1, d1), ac1), bc1), bd1), cd1)
            out2 = cnot(x(x(x(ab1, ac1), bc1), bd1))
            out3 = cnot(x(x(x(a1, ab1), bc1), cd1))

        # cubic terms at lvl + 1: NTT of a, b, c, d, ab, cd
        lo, hi = ctx.c2n(cat([a1, b1, c1, d1, ab1, cd1]))
        del sw, ab1, cd1, ac1, ad1, bc1, bd1, a1, b1, c1, d1
        A1, B1, C1, D1, AB1, CD1 = zip(lo.split(16), hi.split(16))
        del lo, hi
        cubic = [mul(AB1, D1), mul(CD1, A1), mul(CD1, B1), mul(AB1, C1)]
        del A1, B1, C1, D1, AB1, CD1
        abd_c, acd_c, bcd_c, abc_c = ctx.n2c(
            lvl1, True, (cat([c[0] for c in cubic]),
                         cat([c[1] for c in cubic]))).split(16)
        del cubic
        if not inverse:
            out0 = x(x(x(out0, abd_c), acd_c), bcd_c)
            out1 = x(x(out1, abc_c), acd_c)
            out2 = x(x(out2, abc_c), bcd_c)
            out3 = x(out3, bcd_c)
        else:
            out0 = x(x(x(out0, abc_c), abd_c), bcd_c)
            out1 = x(x(out1, acd_c), bcd_c)
            out2 = x(out2, bcd_c)
            out3 = x(x(out3, abd_c), acd_c)

        # final relin + modswitch of the four outputs -> lvl + 2
        outs = ctx.mod_switch(lvl1, self._relin(lvl1, cat([out0, out1, out2,
                                                           out3])))
        # reassemble [64] in nibble order
        return torch.stack(outs.split(16), dim=1).flatten(0, 1)

    def sbox_layer(self, state, inverse: bool = False):
        """The S-box layer at the current level; the level rises by 2.
        With CUHE_PRINCE_TIMING=1 it prints its time (utils/timer.py)."""
        if os.environ.get("CUHE_PRINCE_TIMING", "0") == "1":
            with timed(f"  sbox_layer lvl={self.level} inverse={inverse}",
                       self.ctx.device, file=sys.stderr):
                out = self._sbox(state, self.level, inverse)
        else:
            out = self._sbox(state, self.level, inverse)
        self.level += 2
        return out

    # ------------------------------------------------------------------
    # full circuit (princeEncrypt, Prince.cu:148-188)
    # ------------------------------------------------------------------
    def encrypt_blocks(self, message_bits, key0_bits, key1_bits,
                       max_rounds: int | None = None, check=None,
                       resume=None, on_layer=None):
        """Run the PRINCE circuit homomorphically.

        message/key bits: lists of 64 ints.  Returns the final CRT-domain
        state (level CIRCUIT_DEPTH-1) or, with max_rounds set, the state
        after that many S-box layers (for known-answer testing).

        resume: optional (state, level, done_layers) from a checkpoint
        taken right after S-box layer `done_layers` (utils.checkpoint /
        run_prince.py --resume): the key ciphertexts are re-derived
        (deterministic for a fixed seed; the message's samples are drawn
        and its encryption skipped), the circuit fast-forwards past the
        first `done_layers` S-box layers and continues from the saved state.
        check(round, state, level) is invoked after every S-box layer run
        from here; on_layer(done, state, level) after every applied S-box
        layer (checkpoint hook).  The reference has no mid-circuit
        persistence at all.
        """
        self.level = 0
        if resume is None:
            state = self.encrypt_state(message_bits)
        else:
            # the saved state replaces the message's ciphertexts: only their
            # samples are drawn, so that the keys' are the straight run's
            self.dhs.skip_encryptions(len(message_bits))
        k0 = self.encrypt_state(key0_bits)
        k1 = self.encrypt_state(key1_bits)
        skip = 0
        if resume is not None:
            state = resume[0].to(self.ctx.device)
            self.level, skip = int(resume[1]), int(resume[2])
        live = skip == 0
        rnd = 0
        done = 0

        def sbox(s, inverse):
            # fast-forward guard: layers <= skip were in the checkpoint
            nonlocal done, live
            done += 1
            if done <= skip:
                live = done == skip
                return s
            s = self.sbox_layer(s, inverse=inverse)
            if on_layer is not None:
                on_layer(done, s, self.level)
            return s

        def lin(s, fn):
            # linear ops re-run only once the resume point is reached
            return fn(s) if live else s

        def ms_key(k):
            # Key ciphertexts are added at the current level by reducing their
            # coefficients mod q_lvl (reference addRoundKey + coeffReduce,
            # Prince.cu:460-463 + 204-206).  q_lvl divides q_0, so in CRT form
            # this is simply dropping the cut prime planes.
            pn = self.ctx.params.num_crt_prime_lvl(self.level)
            return k[:, :pn]

        state = lin(state, lambda s: self.add_round_key(s, k0, 0))
        state = lin(state, lambda s: self.add_round_key(s, k1, 0))
        state = lin(state, lambda s: self.add_rc(s, rnd, 0))

        for _ in range(5):
            rnd += 1
            state = sbox(state, inverse=False)
            if check is not None and live:
                check(rnd - 1, state, self.level)
            if max_rounds is not None and done >= max_rounds:
                return state
            lvl = self.level
            state = lin(state, lambda s: self.mix_column(s, lvl))
            state = lin(state, lambda s: self.add_rc(s, rnd, lvl))
            state = lin(state,
                        lambda s: self.add_round_key(s, ms_key(k1), lvl))

        state = sbox(state, inverse=False)
        if check is not None and live:
            check(rnd, state, self.level)
        if max_rounds is not None and done >= max_rounds:
            return state

        state = lin(state, lambda s: self.m_p(s, self.level))
        state = sbox(state, inverse=True)
        if check is not None and live:
            check(rnd + 1, state, self.level)
        if max_rounds is not None and done >= max_rounds:
            return state

        for _ in range(5):
            rnd += 1
            lvl = self.level
            state = lin(state,
                        lambda s: self.add_round_key(s, ms_key(k1), lvl))
            state = lin(state, lambda s: self.add_rc(s, rnd, lvl))
            state = lin(state, lambda s: self.inv_mix_column(s, lvl))
            state = sbox(state, inverse=True)
            if check is not None and live:
                check(rnd + 1, state, self.level)
            if max_rounds is not None and done >= max_rounds:
                return state
        rnd += 1
        lvl = self.level
        state = self.add_rc(state, rnd, lvl)
        k1l = ms_key(k1)
        state = self.add_round_key(state, k1l, lvl)
        k0l = self.key_expansion(ms_key(k0), lvl)
        state = self.add_round_key(state, k0l, lvl)
        return state

    def run_known_answer(self, max_rounds: int | None = None, *, check=None,
                         on_layer=None):
        """Reference main(): A=0, B=1, C=0 (Prince.cu:68-96); `check` and
        `on_layer` as for encrypt_blocks."""
        A = [0] * 64
        B = [1] * 64
        C = [0] * 64
        return self.encrypt_blocks(A, B, C, max_rounds=max_rounds,
                                   check=check, on_layer=on_layer)
