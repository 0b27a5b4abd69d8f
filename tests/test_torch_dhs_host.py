"""The port's host-side DHS tools equal the JAX package's (tolerance 0): the
polynomial XGCD of keygen (against JAX's numpy XGCD and its native
library's inverse), the GF(2) / GF(2^d) tools, the Batcher's encode and
decode matrices at m = 8191, 21845 and 73, and the key-string format."""

import numpy as np
import pytest

from cuhe_tpu import hostmath as jhm
from cuhe_tpu import serialize as jser
from cuhe_tpu.dhs import Batcher as JBatcher
from cuhe_tpu_torch import hostmath as hm
from cuhe_tpu_torch import serialize as ser
from cuhe_tpu_torch.dhs import Batcher
from cuhe_tpu_torch.params import make_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _keygen_f(rng, mod_len, q):
    """f = 1 + 2 f' with f' uniform in {-1, 0, 1}, mod q (DHS keygen)."""
    f = [2 * (int(v) - 1) for v in rng.integers(0, 3, mod_len)]
    f[0] += 1
    return [c % q for c in f]


@pytest.mark.parametrize("cfg", [(3, 2, 16, 50, 25, 8191),
                                 (5, 2, 1, 61, 20, 8191)])
def test_xgcd_equals_jax_and_native(cfg):
    pr = make_params(*cfg)
    rng = np.random.default_rng(1)
    f = _keygen_f(rng, pr.mod_len, pr.coeff_modulus(0))
    m = list(pr.poly_mod)
    p = pr.crt_primes[0]
    fp = np.array(f, dtype=object) % p
    mp = np.array(m, dtype=object) % p
    inv = hm.poly_xgcd_mod_p(fp, mp, p)
    np.testing.assert_array_equal(inv, jhm.poly_xgcd_mod_p(fp, mp, p))
    # f * inv = 1 mod (m(x), p), by a plain product and division
    prod = np.convolve(np.asarray(fp, dtype=object), inv.astype(object)) % p
    mm = np.array(m, dtype=object) % p
    for i in range(len(prod) - 1, len(m) - 2, -1):
        c = prod[i]
        if c:
            prod[i - len(m) + 1: i + 1] = (prod[i - len(m) + 1: i + 1]
                                           - c * mm) % p
    assert prod[0] == 1 and not prod[1: len(m) - 1].any()
    if jhm.native_available():
        n = pr.mod_len
        out, ok = jhm.poly_inv_batch_native(
            np.array([fp[:n]], dtype=np.int64),
            np.array([mp], dtype=np.int64), np.array([p], dtype=np.int64))
        assert ok[0] == 0
        np.testing.assert_array_equal(inv[:n], out[0])
        assert not inv[n:].any()


def test_xgcd_not_invertible():
    p = 7
    m = np.array([1, 0, 1], dtype=np.int64)
    f = np.array([0, 0], dtype=np.int64)  # zero has no inverse
    assert hm.poly_xgcd_mod_p(f, m, p) is None
    assert jhm.poly_xgcd_mod_p(f, m, p) is None
    # x^2 - 1 = (x - 1)(x + 1): x - 1 shares a factor
    m = np.array([p - 1, 0, 1], dtype=np.int64)
    f = np.array([p - 1, 1], dtype=np.int64)
    assert hm.poly_xgcd_mod_p(f, m, p) is None


def test_gf2_tools_equal_jax():
    rng = np.random.default_rng(2)
    for _ in range(50):
        a, b = (int(v) for v in rng.integers(1, 1 << 40, 2))
        f = int(rng.integers(1 << 20, 1 << 21)) | 1
        assert hm.gf2_mul(a, b) == jhm.gf2_mul(a, b)
        assert hm.gf2_mod(a, f) == jhm.gf2_mod(a, f)
        assert hm.gf2_divmod(a, f) == jhm.gf2_divmod(a, f)
        assert hm.gf2_xgcd(a, f) == jhm.gf2_xgcd(a, f)
        assert hm.gf2_powmod(a, b & 0xFFFF, f) == jhm.gf2_powmod(a, b & 0xFFFF, f)
        assert hm.gf2_deg(a) == jhm.gf2_deg(a)
    for d in (2, 3, 5, 9, 13, 16):
        assert hm.primitive_poly(d) == jhm.primitive_poly(d)
        assert hm.gf2_irreducible(hm.primitive_poly(d), d)
    f = hm.primitive_poly(9)
    for a in (3, 77, 300):
        inv = hm.gf2_inv_mod(a, f)
        assert inv == jhm.gf2_inv_mod(a, f)
        assert hm.gf2_mod(hm.gf2_mul(a, inv), f) == 1
    with pytest.raises(ValueError):
        hm.gf2_inv_mod(f, f)
    for d in (9, 13):
        g, jg = hm.GF2e(d), jhm.GF2e(d)
        assert g.poly == jg.poly and g.order == jg.order
        np.testing.assert_array_equal(g.exp, jg.exp)
        np.testing.assert_array_equal(g.log, jg.log)
        assert g.mul(5, 77) == jg.mul(5, 77)
        # the Frobenius coset of 1: the minimal polynomial of the generator
        coset = [(1 << i) % g.order for i in range(d)]
        assert g.minpoly_of_coset(coset, 1) == jg.minpoly_of_coset(coset, 1) \
            == g.poly


@pytest.mark.parametrize("m,d", [(8191, 13), (21845, 16), (73, 9)])
def test_batcher_matrices_equal_jax(m, d):
    pm = hm.gen_poly_mod(m)
    assert pm == jhm.gen_poly_mod(m)
    slots = (len(pm) - 1) // d
    b, jb = Batcher(pm, d, slots), JBatcher(pm, d, slots)
    assert b.factors == jb.factors
    np.testing.assert_array_equal(b.E, jb.E)
    np.testing.assert_array_equal(b.T, jb.T)
    rng = np.random.default_rng(m)
    bits = [int(v) for v in rng.integers(0, 2, slots)]
    enc = b.encode(bits)
    assert enc == jb.encode(bits) and b.decode(enc) == bits
    # decode is GF(2)-linear: decode(enc(a) ^ enc(c)) == a xor c slotwise
    c = [int(v) for v in rng.integers(0, 2, slots)]
    summed = [(x + y) % 2 for x, y in zip(enc, b.encode(c))]
    assert b.decode(summed) == [x ^ y for x, y in zip(bits, c)]


def test_serialize_strings_equal_jax():
    big = 2**512 + 12345
    items = [("sk0", [1, 22, 333, -4, 0]), ("q", [big, -big]), ("e", [])]
    pm = ser.PicklableMap([ser.Picklable(k, v) for k, v in items])
    jpm = jser.PicklableMap([jser.Picklable(k, v) for k, v in items])
    s = pm.to_string()
    assert s == jpm.to_string()
    assert s.split("\n")[0] == "sk0,1,22,333,-4,0"
    back = ser.PicklableMap.from_string(jpm.to_string())
    assert [(p.key, p.coeffs) for p in back.picklables] == items
    assert back.has("q") and not back.has("zzz")
    with pytest.raises(KeyError):
        back.get("zzz")
    p = ser.Picklable("k", [1, 2, 3], separator=" ")
    assert p.pickle() == jser.Picklable("k", [1, 2, 3], separator=" ").pickle()
    assert ser.Picklable.from_string("k 1 2 3", separator=" ").coeffs == [1, 2, 3]
    assert p.values_string() == "1 2 3"
