"""DHS (Doroz-Hu-Sunar) leveled SHE scheme + plaintext batching.

Counterpart of ``cuhe_tpu/dhs.py`` (the reference's examples/DHS/DHS.{h,cu}):
keygen / encrypt / decrypt stay host-side big-int math like the reference's
(which uses NTL and only offloads polynomial multiplication through mulZZX,
DHS.cu:212-252), with the polynomial products running through the device
pipeline (poly.poly_mul_ints, poly.poly_mul_one_to_many).  Host sampling
draws from ``numpy.random.default_rng(seed)`` in the JAX package's order, so
the same seed gives the same keys.  Batching (DHS.cu:418-530) is two GF(2)
matrices (encode/decode are linear maps), built via cyclotomic cosets in
GF(2^d) instead of trial division over all degree-d binary polys -- same
factors, same ascending order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import hostlib, poly
from . import hostmath as hm
from .context import Context, resolve_device
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
        m_bits = self.m_bits
        n = self.mod_len
        enc_cols = []
        for f in self.factors:
            mi, rem = hm.gf2_divmod(m_bits, f)
            assert rem == 0
            ni = hm.gf2_inv_mod(mi, f)
            mxn = hm.gf2_mod(hm.gf2_mul(mi, ni), m_bits)
            enc_cols.append(mxn)
        # encode matrix E [mod_len, size]
        E = np.zeros((n, self.size), dtype=np.uint8)
        for i, mxn in enumerate(enc_cols):
            for b in range(n):
                if (mxn >> b) & 1:
                    E[b, i] = 1
        self.E = E
        # decode matrix T [size, mod_len]: T[i,k] = const coeff of x^k mod f_i
        fs = np.array(self.factors, dtype=np.uint64)
        d = self.f_degree
        states = np.ones(self.size, dtype=np.uint64)
        T = np.zeros((self.size, n), dtype=np.uint8)
        for k in range(n):
            T[:, k] = (states & np.uint64(1)).astype(np.uint8)
            states = states << np.uint64(1)
            over = (states >> np.uint64(d)) & np.uint64(1)
            states ^= fs * over
        self.T = T

    def encode(self, mess_bits: list[int]) -> list[int]:
        """bits per slot -> plaintext polynomial coefficients (0/1)."""
        v = np.zeros(self.size, dtype=np.uint8)
        for i, b in enumerate(mess_bits[: self.size]):
            v[i] = int(b) & 1
        out = (self.E.astype(np.int32) @ v.astype(np.int32)) & 1
        return [int(x) for x in out]

    def decode(self, coeffs: list[int]) -> list[int]:
        v = np.zeros(self.mod_len, dtype=np.int32)
        for i, c in enumerate(coeffs[: self.mod_len]):
            v[i] = int(c) & 1
        out = (self.T.astype(np.int32) @ v) & 1
        return [int(x) for x in out]


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
    def sample(self) -> list[int]:
        """Uniform coefficients in [-B, B] (DHS.cu:371-376)."""
        return [int(v) - self.B for v in
                self._rng.integers(0, 2 * self.B + 1, self.params.mod_len)]

    def _reduce(self, coeffs: list[int], lvl: int) -> list[int]:
        q = self.coeff_mod[lvl]
        return [c % q for c in coeffs]

    def _find_inverse(self, f: list[int]) -> list[int] | None:
        """f^-1 mod (q0, m(x)) via per-CRT-prime XGCD + CRT combine.

        Replaces NTL ZZ_pE inv (DHS.cu:377-393): q0 is composite, so invert
        modulo each prime factor (the native `hostlib.poly_inv_batch`, on
        every device) and CRT-combine coefficients.  The inverse is unique,
        so this equals the JAX package's, whichever of its two XGCD routes
        (numpy or its native library) that one took.
        """
        pr = self.params
        primes = pr.crt_primes
        n = pr.mod_len
        f = list(f[:n]) + [0] * (n - len(f))
        fs = np.array([[c % p for c in f] for p in primes], dtype=np.int64)
        ms = np.array([[c % p for c in self.poly_mod] for p in primes],
                      dtype=np.int64)
        res, ok = hostlib.poly_inv_batch(fs, ms, np.array(primes,
                                                          dtype=np.int64))
        if (ok != 0).any():
            return None
        # CRT-combine coefficient-wise: sum_i (r_i b_i mod p_i) M/p_i mod M
        M = self.coeff_mod[0]
        mi = [M // p for p in primes]
        terms = [(res[i] * hm.modinv(mi[i] % p, p) % p).tolist()
                 for i, p in enumerate(primes)]
        return [sum(t * m for t, m in zip(col, mi)) % M for col in zip(*terms)]

    def key_gen(self):
        pr = self.params
        self.pk = [None] * pr.depth
        self.sk = [None] * pr.depth
        self.ek = None
        # genPkSk (DHS.cu:306-339)
        while True:
            ft = self.sample()
            f = [c * pr.mod_msg for c in ft]
            f[0] += 1
            f = self._reduce(f, 0)
            f_inv = self._find_inverse(f)
            if f_inv is not None:
                break
        g = self._reduce(self.sample(), 0)
        self.sk[0] = f
        pk0 = poly.poly_mul_ints(self.ctx, g, f_inv, 0)
        pk0 = [c * pr.mod_msg for c in pk0]
        self.pk[0] = self._reduce(pk0, 0)
        self.sk[0] = self._reduce(self.sk[0], 0)
        for i in range(1, pr.depth):
            self.sk[i] = self._reduce(self.sk[i - 1], i)
            self.pk[i] = self._reduce(self.pk[i - 1], i)
        if pr.log_relin > 0:
            self._gen_ek()

    def _gen_ek(self):
        """genEk (DHS.cu:340-362): ek_i = pk0*s + p*e + 2^(w i)*sk."""
        pr = self.params
        q0 = self.coeff_mod[0]
        nk = pr.num_eval_key
        ss = [self._reduce(self.sample(), 0) for _ in range(nk)]
        es = [self.sample() for _ in range(nk)]
        prods = poly.poly_mul_one_to_many(self.ctx, self.pk[0], ss, 0)
        self.ek = []
        for i in range(nk):
            tw = 1 << (pr.log_relin * i)
            tp = self._reduce([c * tw for c in self.sk[0]], 0)
            eki = [(a + b * pr.mod_msg + c) % q0
                   for a, b, c in zip(prods[i], es[i], tp)]
            self.ek.append(eki)
        self.init_relinearization()

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
    def encrypt(self, coeffs: list[int], lvl: int) -> list[int]:
        pr = self.params
        s = self._reduce(self.sample(), lvl)
        e = self.sample()
        t = poly.poly_mul_ints(self.ctx, self.pk[lvl], s, lvl)
        t = [(a + b * pr.mod_msg + (coeffs[i] if i < len(coeffs) else 0))
             for i, (a, b) in enumerate(zip(t, e))]
        return self._reduce(t, lvl)

    def encrypt_many(self, msgs: list[list[int]], lvl: int) -> list[list[int]]:
        """Batched encrypt: shares one NTT of pk."""
        pr = self.params
        ss = [self._reduce(self.sample(), lvl) for _ in msgs]
        es = [self.sample() for _ in msgs]
        prods = poly.poly_mul_one_to_many(self.ctx, self.pk[lvl], ss, lvl)
        out = []
        for m, e, t in zip(msgs, es, prods):
            c = [(a + b * pr.mod_msg + (m[i] if i < len(m) else 0))
                 for i, (a, b) in enumerate(zip(t, e))]
            out.append(self._reduce(c, lvl))
        return out

    def skip_encryptions(self, count: int) -> None:
        """Draw the samples of `count` encryptions without encrypting: the
        sampler ends where `encrypt_many` of `count` messages leaves it."""
        for _ in range(2 * count):
            self.sample()

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
