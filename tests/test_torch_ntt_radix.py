"""The host side of csrc/ntt.cu's radix-16 passes, on the CPU: the shifts of
the roots of unity that are powers of two (against `pow` in Python ints and
the JAX package's generator), the shift multiply `mul_pow2` (against
`modp.mul_modp64`), the 16 x L/16 split with the kernels' index maps
(against `dft64`'s sub-transforms and a Python-int DFT), the Barrett
reduction of the inverse's column pass (against `%`), the generic-product
count and the inverse's chunks."""

import numpy as np
import pytest
import torch

from cuhe_tpu import hostmath as jhm
from cuhe_tpu_torch.ops import modp, ntt
from cuhe_tpu_torch.ops import ntt_kernels as nk
from cuhe_tpu_torch.params import make_params
from cuhe_tpu_torch.entry import PRINCE_PARAMS
from cuhe_tpu_torch.probes import ablate
from cuhe_tpu_torch.probes.timing import radix16_products

P = modp.P
SIZES = (16384, 32768, 65536)
EDGES = (0, 1, P - 1, (1 << 32) - 1, 1 << 32)


def _pair(values):
    v = np.asarray(values, dtype=np.uint64)
    return (torch.from_numpy((v & np.uint64(modp.M32)).astype(np.int64)),
            torch.from_numpy((v >> np.uint64(32)).astype(np.int64)))


def _ints(pair):
    return [int(lo) | (int(hi) << 32) for lo, hi in zip(*pair)]


@pytest.mark.parametrize("n", SIZES)
def test_root_shifts_are_the_roots(n):
    w = pow(jhm.NTT_GEN, 65536 // n, P)  # the JAX package's length-n root
    for length in (8, 16, 32, 64):
        fwd = ntt.root_shift(n, length)
        inv = ntt.root_shift(n, length, inverse=True)
        assert 0 <= fwd < 192 and 0 <= inv < 192
        assert pow(2, fwd, P) == pow(w, n // length, P)
        assert pow(2, inv, P) == pow(jhm.modinv(w, P), n // length, P)
        assert pow(2, fwd + inv, P) == 1
    assert ntt.root_shift(n, 64) == 3 and ntt.root_shift(n, 64, True) == 189
    for inverse in (False, True):  # the shifts the kernels are compiled for
        assert ntt.root_shift(n, 64, inverse) == nk.KERNEL_SHIFT64[inverse]
        nk.check_root_shift(n, inverse)


def test_root_shift_check_refuses_another_shift(monkeypatch):
    monkeypatch.setattr(nk, "KERNEL_SHIFT64", {False: 6, True: 186})
    for inverse in (False, True):
        with pytest.raises(ValueError, match="compiled for"):
            nk.check_root_shift(32768, inverse)


@pytest.mark.parametrize("length", (128, 256, 3, 0))
def test_root_shift_raises_where_no_power_of_two_is_the_root(length):
    with pytest.raises(ValueError):
        ntt.root_shift(32768, length)


@pytest.mark.parametrize("s", (0, 3, 12, 31, 32, 63, 64, 95, 96, 180, 189))
def test_mul_pow2_equals_the_product(s):
    rng = np.random.default_rng(s)
    values = list(EDGES) + [int(v) % P for v in rng.integers(
        0, 1 << 64, size=64, dtype=np.uint64)]
    x = _pair(values)
    got = ntt.mul_pow2(x, s)
    two_s = pow(2, s, P)
    want = modp.mul_modp64(x, (torch.tensor(two_s & modp.M32),
                               torch.tensor(two_s >> 32)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _ints(got) == [v * two_s % P for v in values]


@pytest.mark.parametrize("n,length", ((16384, 128), (32768, 128),
                                      (32768, 256), (65536, 256)))
@pytest.mark.parametrize("inverse", (False, True))
def test_radix16_split_equals_the_sub_transform(n, length, inverse):
    rng = np.random.default_rng(length + inverse)
    x = rng.integers(0, P, size=(3, length), dtype=np.uint64)
    x[0, :5] = np.array(EDGES, dtype=np.uint64)
    lo, hi = _pair(x.reshape(-1))
    lo, hi = lo.reshape(3, length), hi.reshape(3, length)
    got = ntt.dft64_radix16(lo, hi, n, inverse, length)
    want = ntt.dft64(lo, hi, n, inverse, length)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", SIZES)
def test_radix16_split_of_a_half_zero_column(n):
    """The forward column pass: rows j1 >= n1/2 are zero, and the first
    level of each length-16 DFT is a shift; against a Python-int DFT."""
    n1, _ = ntt.factors(n)
    rng = np.random.default_rng(n)
    x = rng.integers(0, P, size=(2, n1), dtype=np.uint64)
    x[:, n1 // 2:] = 0
    lo, hi = _pair(x.reshape(-1))
    got = ntt.dft64_radix16(lo.reshape(2, n1), hi.reshape(2, n1), n,
                            length=n1, half_zero=True)
    w = pow(pow(jhm.NTT_GEN, 65536 // n, P), n // n1, P)
    for b in range(2):
        xs = [int(v) for v in x[b]]
        want = [sum(xs[j] * pow(w, j * k, P) for j in range(n1 // 2)) % P
                for k in range(n1)]
        assert _ints((got[0][b], got[1][b])) == want


@pytest.mark.parametrize("p", (3, 7681, 0xFFF1, 65537, 4294967291, "prince"))
def test_barrett_mod_equals_remainder(p):
    primes = (make_params(*PRINCE_PARAMS).crt_primes if p == "prince"
              else (p,))
    rng = np.random.default_rng(7)
    for q in primes:
        xs = [0, q - 1, q, 5 * q - 1, 5 * q + 1, (P - 1) // q * q - 1,
              (P - 1) // q * q + 1, P - 1, (1 << 64) - 1]
        xs += [int(v) for v in rng.integers(0, 1 << 64, size=200,
                                            dtype=np.uint64)]
        for x in xs:
            assert modp.barrett_mod_u64(x, q) == x % q, (x, q)


def test_generic_products_per_pass_are_under_one_per_coefficient():
    # inner twiddles that are not shifts: half at L = 256, a quarter at 128
    assert radix16_products(256) == 128
    assert radix16_products(128) == 32
    for n in SIZES:
        for name in ("cols_notw", "rows", "inv_nomod", "inv_cols"):
            assert 0 < ablate.kernel_products((name,), n) < n
        # the four-step twiddle: one product per coefficient, and its
        # recurrence one per coefficient but the first of each thread's M
        n1, n2 = ntt.factors(n)
        for name, base, m in (("cols", "cols_notw", n1 // 16),
                              ("inv_rows", "rows", n2 // 16)):
            assert (ablate.kernel_products((name,), n)
                    == ablate.kernel_products((base,), n) + 2 * n - n // m)
        assert ablate.kernel_products(("cols_io",), n) == 0
        assert (ablate.kernel_products(("fwd_linear",), n)
                == ablate.kernel_products(("cols", "rows"), n))


@pytest.mark.parametrize("n", SIZES)
def test_inverse_chunk_bounds_the_scratch(n):
    # u64 scratch of one chunk: 256 MiB; PRINCE level 0's 800 transforms of
    # 32k fit one chunk
    assert nk.inv_chunk(n) * 8 * n == nk.INV_SCRATCH_BYTES
    assert nk.inv_chunk(32768) >= 32 * 25
