"""DHS (Doroz-Hu-Sunar) leveled SHE scheme + plaintext batching.

Counterpart of ``cuhe_tpu/dhs.py`` (the reference's examples/DHS/DHS.{h,cu}).
Keygen and encryption work in CRT residues on the context's device: small
sampled polynomials become residues through a table of their few distinct
values, products run through the device pipeline (the reference uses NTL
and offloads only its products through mulZZX, DHS.cu:212-252), f^-1 comes
from the native per-prime XGCD, and the integer coefficients (the key
strings, `encrypt_many`'s output, decryption's input) come from one ICRT.
Host sampling draws from ``numpy.random.default_rng(seed)`` in the JAX
package's order, so the same seed gives the same keys and ciphertexts.
Batching (DHS.cu:418-530) is two GF(2) matrices (encode/decode are linear
maps), built via cyclotomic cosets in GF(2^d) instead of trial division
over all degree-d binary polys -- same factors, same ascending order -- and
every factor's division and idempotent at once, a bit a step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import hostlib, poly
from . import hostmath as hm
from .context import Context, resolve_device
from .ops import pointwise as pw
from .params import make_params
from .serialize import Picklable, PicklableMap


class Batcher:
    """Plaintext SIMD packing over the GF(2) factors of m(x).

    Equivalent of the reference Batcher (DHS.cu:418-530), restricted (like
    the reference, DHS.cu:423-426) to mod_msg == 2.
    """

    def __init__(self, poly_mod: list[int], f_degree: int, f_size: int):
        self.f_degree = f_degree
        self.size = f_size
        m_bits = 0
        for i, c in enumerate(poly_mod):
            if c % 2:
                m_bits |= 1 << i
        self.m_bits = m_bits
        self.mod_len = len(poly_mod) - 1
        self._E32 = self._T32 = None  # float32 copies, made at first use
        self._build_factors()
        self._build_matrices()

    def _build_factors(self):
        """Irreducible degree-d GF(2) factors of m(x), ascending order.

        The reference finds them by trial division over all 2^d candidates
        (DHS.cu:439-459); since every factor is the minimal polynomial of a
        primitive m-th root of unity in GF(2^d), we build them from the
        cyclotomic cosets of 2 mod m and sort -- identical set and order.
        """
        d = self.f_degree
        # recover the ring index m from the degree structure: ord_m(2) = d
        # and deg m(x) = phi(m).  m is supplied indirectly; find it from the
        # factor count: phi(m) = mod_len.  The caller context knows m, so we
        # accept any m with 2^d = 1 mod m dividing the group order.
        gf = hm.GF2e(d)
        m = self._ring_index = self._infer_ring_index(d)
        gen_exp = gf.order // m
        seen = set()
        cosets = []
        for s in range(1, m):
            if math.gcd(s, m) != 1 or s in seen:
                continue
            coset = []
            t = s
            while t not in seen:
                seen.add(t)
                coset.append(t)
                t = t * 2 % m
            cosets.append(coset)
        facs = [gf.minpoly_of_coset(c, gen_exp) for c in cosets]
        facs.sort()
        if len(facs) != self.size:
            raise ValueError("factor count mismatch")
        self.factors = facs

    def _infer_ring_index(self, d: int):
        # deg m(x) = phi(m) = size * d; m divides 2^d - 1; m(x) | x^m - 1.
        target = self.size * d
        group = (1 << d) - 1
        for m in range(3, group + 1):
            if group % m == 0 and hm.euler_totient(m) == target:
                # verify x^m == 1 mod m(x): m(x) divides x^m - 1
                r = hm.gf2_mod((1 << m) ^ 1, self.m_bits)
                if r == 0:
                    return m
        raise ValueError("cannot infer ring index")

    def _build_matrices(self):
        """E [mod_len, size]: column i holds the CRT idempotent e_i = m_i
        (m_i^-1 mod f_i) of factor f_i, m_i = m(x) / f_i (deg e_i < mod_len,
        so no reduction mod m(x) is needed); T [size, mod_len]: T[i, k] is
        the constant coefficient of x^k mod f_i.  Every factor at once, a
        bit a step: each polynomial is a row of 0/1 bytes."""
        n, d, size = self.mod_len, self.f_degree, self.size
        fs = np.array(self.factors, dtype=np.int64)
        m = np.array([(self.m_bits >> k) & 1 for k in range(n + 1)],
                     dtype=np.int64)
        # m_i, by long division of m(x) by every f_i, top coefficient first
        q = np.zeros((size, n - d + 1), dtype=np.uint8)
        r = np.zeros(size, dtype=np.int64)
        for k in range(n, -1, -1):
            r = (r << 1) | m[k]
            top = (r >> d) & 1
            if k <= n - d:
                q[:, k] = top
            r ^= fs * top
        assert not r.any()
        # m_i mod f_i, then its inverse mod f_i (degree < d: Python ints)
        r = np.zeros(size, dtype=np.int64)
        for k in range(n - d, -1, -1):
            r = (r << 1) | q[:, k]
            r ^= fs * ((r >> d) & 1)
        ni = np.array([hm.gf2_inv_mod(int(a), int(f))
                       for a, f in zip(r, fs)], dtype=np.int64)
        # e_i = m_i n_i: a carry-less product of degree < mod_len
        e = np.zeros((size, n), dtype=np.uint8)
        for j in range(d):
            bit = ((ni >> j) & 1).astype(np.uint8)[:, None]
            e[:, j: j + n - d + 1] ^= q & bit
        self.E = np.ascontiguousarray(e.T)
        # decode matrix T [size, mod_len]: T[i,k] = const coeff of x^k mod f_i
        states = np.ones(size, dtype=np.int64)
        T = np.zeros((n, size), dtype=np.uint8)
        for k in range(n):
            T[k] = states & 1
            states = states << 1
            states ^= fs * ((states >> d) & 1)
        self.T = np.ascontiguousarray(T.T)

    def encode_many(self, bits) -> np.ndarray:
        """[B, <= size] bits a slot -> [B, mod_len] plaintext coefficients
        (uint8 0/1): E times each row, mod 2 (float32 products: the sums,
        at most `size`, are exact)."""
        v = np.zeros((len(bits), self.size), dtype=np.float32)
        for i, row in enumerate(bits):
            row = np.asarray(row, dtype=np.int64)[: self.size]
            v[i, : len(row)] = row & 1
        return (v @ self._e32().T).astype(np.int64).astype(np.uint8) & 1

    def decode_many(self, coeffs) -> np.ndarray:
        """[B, <= mod_len] coefficients (any ints, read mod 2) -> [B, size]
        slot bits (uint8)."""
        v = np.zeros((len(coeffs), self.mod_len), dtype=np.float32)
        for i, row in enumerate(coeffs):
            row = row[: self.mod_len]
            v[i, : len(row)] = (np.asarray(row) & 1 if isinstance(
                row, np.ndarray) else [int(c) & 1 for c in row])
        return (v @ self._t32().T).astype(np.int64).astype(np.uint8) & 1

    def _e32(self) -> np.ndarray:
        if self._E32 is None:
            self._E32 = self.E.astype(np.float32)
        return self._E32

    def _t32(self) -> np.ndarray:
        if self._T32 is None:
            self._T32 = self.T.astype(np.float32)
        return self._T32

    def encode(self, mess_bits: list[int]) -> list[int]:
        """bits per slot -> plaintext polynomial coefficients (0/1)."""
        return [int(x) for x in self.encode_many([mess_bits])[0]]

    def decode(self, coeffs: list[int]) -> list[int]:
        return [int(x) for x in self.decode_many([coeffs])[0]]


class CuDHS:
    """The DHS scheme (examples/DHS/DHS.h:68-110)."""

    def __init__(self, d=None, p=None, w=None, min_=None, cut=None, m=None,
                 *, key_string: str | None = None, seed: int | None = None,
                 context: Context | None = None, device="cuda"):
        """Generate keys for the parameters, or load them from `key_string`.
        The tables and eval keys live on `context`'s device if a context is
        given, else on a new context's on `device`."""
        self.device = context.device if context is not None else \
            resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self.B = 1  # sampling bound (DHS.cu:49)
        self._pk_ntt = None  # pk_0 in the NTT domain, made at first use
        if key_string is not None:
            self._init_from_keys(key_string)
            return
        self.params = make_params(d, p, w, min_, cut, m)
        self.ctx = context if context is not None else Context(self.params,
                                                               self.device)
        self.poly_mod = list(self.params.poly_mod)
        self.coeff_mod = [self.params.coeff_modulus(l)
                          for l in range(self.params.depth)]
        self.key_gen()
        self._setup_batcher()

    # ------------------------------------------------------------------
    def _setup_batcher(self):
        fd = self.factor_degree()
        self.num_slot = self.params.mod_len // fd
        self.batcher = Batcher(self.poly_mod, fd, self.num_slot)

    def factor_degree(self) -> int:
        """Smallest t with (p^t - 1) % m == 0 (DHS.cu:273-278)."""
        t = 1
        while (pow(self.params.mod_msg, t) - 1) % self.params.m_size != 0:
            t += 1
        return t

    # ------------------------------------------------------------------
    # key generation (DHS.cu:206-362)
    # ------------------------------------------------------------------
    def sample_array(self) -> np.ndarray:
        """Uniform coefficients in [-B, B] (DHS.cu:371-376), int64."""
        return self._rng.integers(0, 2 * self.B + 1,
                                  self.params.mod_len) - self.B

    def _reduce(self, coeffs: list[int], lvl: int) -> list[int]:
        q = self.coeff_mod[lvl]
        return [int(c) % q for c in coeffs]

    # Polynomials a batch of keygen's eval-key products and of the
    # encryptions: bounds the device temporaries at the largest ring.
    CHUNK = 16

    def _raw_of_small(self, x: np.ndarray, lvl: int,
                      mult: int = 1) -> torch.Tensor:
        """Ints [B, <= mod_len] with few distinct values, times `mult` ->
        the RAW words of each mod q_lvl, uint32 [B, words, raw_len] on the
        device: each distinct value's words once, gathered on the device."""
        pr = self.params
        q, words = self.coeff_mod[lvl], pr.words_coeff(lvl)
        lo = int(x.min()) if x.dtype == np.int64 and x.size else 0
        if x.dtype == np.int64 and x.size and int(x.max()) - lo < 1024:
            vals, idx = np.arange(lo, int(x.max()) + 1), x - lo
        else:
            vals, idx = np.unique(x, return_inverse=True)
        table = hm.ints_to_words([int(v) * mult % q for v in vals], words)
        table = torch.from_numpy(np.ascontiguousarray(table.T)).to(
            self.device).view(torch.int32)  # [values, words]
        idx = torch.from_numpy(idx.reshape(x.shape)).to(self.device)
        out = torch.zeros((x.shape[0], words, pr.raw_len), dtype=torch.int32,
                          device=self.device)
        out[..., : x.shape[1]] = table[idx].transpose(-1, -2)
        return out.view(torch.uint32)

    def _residues_of_small(self, x: np.ndarray, lvl: int,
                           mult: int = 1) -> torch.Tensor:
        """Ints [B, <= mod_len] times `mult` -> CRT residues uint32 [B, pn,
        raw_len] on the device (K5 on a card)."""
        return self.ctx.r2c(lvl, self._raw_of_small(x, lvl, mult))

    def _ints_of_residues(self, res: torch.Tensor,
                          lvl: int) -> list[list[int]]:
        """CRT residues [B, pn, raw_len] -> each polynomial's coefficients
        in [0, q_lvl) as Python ints (the ICRT on the device)."""
        raw = poly.to_raw(self.ctx, poly.Ctxt(level=lvl, domain=poly.CRT,
                                              data=res)).data.cpu().numpy()
        n = self.params.mod_len
        return [hm.words_to_ints(r[:, :n]) for r in raw]

    def _mul_table(self, res: torch.Tensor, table, lvl: int) -> torch.Tensor:
        """CRT residues [B, pn, raw_len] times an NTT-domain [pnum, n]
        table, mod m(x): CRT residues [B, pn, raw_len]."""
        pn = self.params.num_crt_prime_lvl(lvl)
        return self.ctx.n2c(lvl, True, self.ctx.c2n(res),
                            tuple(v[:pn].contiguous() for v in table))

    def _find_inverse(self, f) -> torch.Tensor | None:
        """f^-1 mod (q0, m(x)) as CRT residues uint32 [pnum, raw_len] on the
        device, by a per-CRT-prime XGCD; f: the key's small ints.

        Replaces NTL ZZ_pE inv (DHS.cu:377-393): q0 is composite, so invert
        modulo each prime factor (the native `hostlib.poly_inv_batch`, on
        every device).  The inverse is unique, so its residues are the JAX
        package's, whichever of its two XGCD routes (numpy or its native
        library) that one took.
        """
        pr = self.params
        primes = np.array(pr.crt_primes, dtype=np.int64)
        n = pr.mod_len
        fs = np.remainder(np.asarray(f, dtype=np.int64)[None, :n],
                          primes[:, None])
        ms = np.remainder(np.array(self.poly_mod, dtype=np.int64)[None, :],
                          primes[:, None])
        res, ok = hostlib.poly_inv_batch(fs, ms, primes)
        if (ok != 0).any():
            return None
        out = np.zeros((len(primes), pr.raw_len), dtype=np.uint32)
        out[:, :n] = res
        return torch.from_numpy(out).to(self.device)

    def key_gen(self):
        """genPkSk (DHS.cu:306-339): f = 1 + p f', pk = p g f^-1 mod q0, in
        CRT residues on the device; the integers of sk and pk at every
        level for the key strings and decryption."""
        pr = self.params
        self.pk = [None] * pr.depth
        self.sk = [None] * pr.depth
        self.ek = None
        while True:
            f = self.sample_array() * pr.mod_msg
            f[0] += 1
            f_inv = self._find_inverse(f)
            if f_inv is not None:
                break
        pg = self._residues_of_small(self.sample_array()[None], 0,
                                     pr.mod_msg)
        pk0 = self._mul_table(pg, self.ctx.c2n(f_inv), 0)
        self._pk_ntt = self.ctx.c2n(pk0[0])
        self.pk[0] = self._ints_of_residues(pk0, 0)[0]
        for i in range(pr.depth):
            self.sk[i] = self._reduce(f, i)
            if i:
                self.pk[i] = self._reduce(self.pk[i - 1], i)
        if pr.log_relin > 0:
            self._gen_ek(f)

    def _gen_ek(self, f: np.ndarray):
        """genEk (DHS.cu:340-362): ek_i = pk0 s_i + p e_i + 2^(w i) sk, in
        CRT residues on the device, a chunk of keys at a time; their
        integers by the ICRT.  f: the secret key's small ints."""
        pr = self.params
        nk = pr.num_eval_key
        ss = np.stack([self.sample_array() for _ in range(nk)])
        es = np.stack([self.sample_array() for _ in range(nk)])
        primes = self.ctx.level(0).primes
        parts, self.ek = [], []
        for k0 in range(0, nk, self.CHUNK):
            ks = range(k0, min(k0 + self.CHUNK, nk))
            prod = self._mul_table(self._residues_of_small(ss[k0: ks.stop], 0),
                                   self._pk_ntt, 0)
            noise = self._residues_of_small(es[k0: ks.stop], 0, pr.mod_msg)
            tw = torch.cat([self._residues_of_small(
                f[None], 0, 1 << (pr.log_relin * i)) for i in ks])
            eki = pw.crt_add(pw.crt_add(prod, noise, primes), tw, primes)
            self.ek += self._ints_of_residues(eki, 0)
            parts.append(self.ctx.c2n(eki))
        self.ctx.set_eval_keys(torch.cat([p[0] for p in parts]),
                               torch.cat([p[1] for p in parts]))

    def init_relinearization(self):
        """initRelin (Relinearization.cu:43-73): eval keys -> NTT domain,
        device-resident [num_eval_key, pnum, ntt_len], converted as one
        batch of RAW polynomials at level 0."""
        pr = self.params
        raw = np.stack([hm.ints_to_words(eki, pr.words_coeff(0), pr.raw_len)
                        for eki in self.ek])
        ct = poly.Ctxt(level=0, domain=poly.RAW,
                       data=torch.from_numpy(raw).to(self.ctx.device))
        self.ctx.set_eval_keys(*poly.to_ntt(self.ctx, ct).data)

    # ------------------------------------------------------------------
    # primitives (DHS.cu:212-270)
    # ------------------------------------------------------------------
    def _pk_table(self):
        """pk_0 in the NTT domain [pnum, n] (pk_lvl's planes are its first
        pn), made once."""
        if self._pk_ntt is None:
            pk0 = self._residues_of_small(
                np.array([self.pk[0]], dtype=object), 0)[0]
            self._pk_ntt = self.ctx.c2n(pk0)
        return self._pk_ntt

    def encrypt_crt(self, msgs, lvl: int) -> torch.Tensor:
        """Encrypt each message (coefficients, at most mod_len; lists of
        ints or an array [B, <= mod_len]) at level lvl: CRT residues uint32
        [B, pn, raw_len] on the device, pk_lvl s + p e + m mod each prime.
        Draws every message's s, then every e, as `encrypt_many`."""
        pr = self.params
        ss = np.stack([self.sample_array() for _ in range(len(msgs))])
        es = np.stack([self.sample_array() for _ in range(len(msgs))])
        plain = self._message_array(msgs)
        add = es * pr.mod_msg if plain.dtype != object else \
            es.astype(object) * pr.mod_msg
        add[:, : plain.shape[1]] += plain
        primes = self.ctx.level(lvl).primes
        outs = []
        for b0 in range(0, len(msgs), self.CHUNK):
            rows = slice(b0, b0 + self.CHUNK)
            prod = self._mul_table(self._residues_of_small(ss[rows], lvl),
                                   self._pk_table(), lvl)
            outs.append(pw.crt_add(prod, self._residues_of_small(add[rows],
                                                                 lvl), primes))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def _message_array(self, msgs) -> np.ndarray:
        """Messages -> [B, L] int64 (object where a value does not fit)."""
        n = self.params.mod_len
        if isinstance(msgs, np.ndarray):
            return msgs[:, :n].astype(np.int64)
        width = max((min(len(m), n) for m in msgs), default=0)
        try:
            out = np.zeros((len(msgs), width), dtype=np.int64)
            for i, m in enumerate(msgs):
                out[i, : min(len(m), n)] = m[:n]
        except OverflowError:
            out = np.zeros((len(msgs), width), dtype=object)
            for i, m in enumerate(msgs):
                out[i, : min(len(m), n)] = [int(c) for c in m[:n]]
        return out

    def encrypt(self, coeffs: list[int], lvl: int) -> list[int]:
        return self.encrypt_many([coeffs], lvl)[0]

    def encrypt_many(self, msgs: list[list[int]], lvl: int) -> list[list[int]]:
        """Batched encrypt: the ciphertexts' coefficients in [0, q_lvl)."""
        return self._ints_of_residues(self.encrypt_crt(msgs, lvl), lvl)

    def skip_encryptions(self, count: int) -> None:
        """Draw the samples of `count` encryptions without encrypting: the
        sampler ends where `encrypt_many` of `count` messages leaves it."""
        for _ in range(2 * count):
            self.sample_array()

    def decrypt_many(self, cts: list[list[int]], lvl: int,
                     max_mul_path: int = 1) -> list[list[int]]:
        """Batched decrypt (one sk multiply round per path)."""
        pr = self.params
        q = self.coeff_mod[lvl]
        ts = [self._reduce(c, lvl) for c in cts]
        rounds = max_mul_path if pr.log_relin > 0 else 1
        for _ in range(rounds):
            ts = poly.poly_mul_one_to_many(self.ctx, self.sk[lvl], ts, lvl)
        half = (q - 1) // 2
        return [[(c - q if c > half else c) % pr.mod_msg for c in t]
                for t in ts]

    def decrypt(self, coeffs: list[int], lvl: int, max_mul_path: int = 1) -> list[int]:
        if self.sk[0] is None:
            raise RuntimeError("operation not available without private key")
        pr = self.params
        q = self.coeff_mod[lvl]
        t = self._reduce(coeffs, lvl)
        rounds = max_mul_path if pr.log_relin > 0 else 1
        for _ in range(rounds):
            t = poly.poly_mul_ints(self.ctx, t, self.sk[lvl], lvl)
        out = []
        half = (q - 1) // 2
        for c in t:
            if c > half:
                c -= q
            out.append(c % pr.mod_msg)
        return out

    def balance(self, coeffs: list[int], lvl: int) -> list[int]:
        q = self.coeff_mod[lvl]
        h = (q - 1) // 2
        return [c - q if c > h else c for c in coeffs]

    def unbalance(self, coeffs: list[int], lvl: int) -> list[int]:
        q = self.coeff_mod[lvl]
        return [c + q if c < 0 else c for c in coeffs]

    # ------------------------------------------------------------------
    # key serialization (DHS.cu:57-189), reference string format
    # ------------------------------------------------------------------
    def _public_picklables(self) -> list[Picklable]:
        pr = self.params
        ps = [Picklable("d", [pr.depth]), Picklable("p", [pr.mod_msg]),
              Picklable("w", [pr.log_relin]), Picklable("min", [pr.log_coeff_min]),
              Picklable("cut", [pr.log_coeff_cut]), Picklable("m", [pr.m_size]),
              Picklable("coeffMod", self.coeff_mod),
              Picklable("polyMod", self.poly_mod)]
        for i in range(pr.depth):
            ps.append(Picklable(f"pk{i}", self.pk[i]))
        for i in range(pr.num_eval_key if pr.log_relin > 0 else 0):
            ps.append(Picklable(f"ek{i}", self.ek[i]))
        return ps

    def get_public_key(self) -> str:
        return PicklableMap(self._public_picklables()).to_string()

    def get_private_key(self) -> str:
        ps = self._public_picklables()
        for i in range(self.params.depth):
            ps.append(Picklable(f"sk{i}", self.sk[i]))
        return PicklableMap(ps).to_string()

    def _init_from_keys(self, key: str):
        pm = PicklableMap.from_string(key)
        d = pm.get("d").coeffs[0]
        p = pm.get("p").coeffs[0]
        w = pm.get("w").coeffs[0]
        min_ = pm.get("min").coeffs[0]
        cut = pm.get("cut").coeffs[0]
        m = pm.get("m").coeffs[0]
        self.params = make_params(d, p, w, min_, cut, m)
        pr = self.params
        self.ctx = Context(pr, self.device)
        self.coeff_mod = pm.get("coeffMod").coeffs
        self.poly_mod = pm.get("polyMod").coeffs
        self.pk = [pm.get(f"pk{i}").coeffs for i in range(pr.depth)]
        if pm.has("sk0"):
            self.sk = [pm.get(f"sk{i}").coeffs for i in range(pr.depth)]
        else:
            self.sk = [None] * pr.depth
        if pr.log_relin > 0:
            self.ek = [pm.get(f"ek{i}").coeffs for i in range(pr.num_eval_key)]
            self.init_relinearization()
        else:
            self.ek = None
        self._setup_batcher()
