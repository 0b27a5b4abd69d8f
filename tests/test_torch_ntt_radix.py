"""The host side of csrc/ntt.cu's radix-16 passes, on the CPU: the shifts of
the roots of unity that are powers of two (against `pow` in Python ints and
the JAX package's generator), the shift multiply `mul_pow2` (against
`modp.mul_modp64`), the 16 x L/16 split with the kernels' index maps
(against `dft64`'s sub-transforms and a Python-int DFT), the Barrett
reduction of the inverse's column pass (against `%`), the generic-product
count, and the one-pass transforms' cluster sizes and layouts."""

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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
        # the transforms count the one-pass kernels they launch
        assert (ablate.kernel_products(("fwd_linear",), n)
                == ablate.kernel_products(("fwd_cluster",), n))
        assert (ablate.kernel_products(("inv_linear",), n)
                == ablate.kernel_products(("inv_cluster",), n))


@pytest.mark.parametrize("n", SIZES)
def test_inverse_cluster_fits_its_blocks_an_sm(n):
    """The one-pass inverse's cluster size: at most 8 blocks, each holding
    whole warps of rows and whole sub-DFTs of the column pass; two or more
    blocks' shares (rows padded by a word, the Barrett constant, the
    runtime's reserved KiB) in one SM's 228 KiB, four where a cluster of up
    to 8 allows it, and half the cluster too large for four."""
    n1, n2 = ntt.factors(n)
    k = nk.inv_cluster(n)
    blocks = nk.inv_cluster_blocks(n, k)
    # the (cluster, blocks per SM) csrc/ntt.cu's launcher instantiates
    assert (k, blocks) == {16384: (4, 4), 32768: (8, 4), 65536: (8, 3)}[n]
    assert k <= 8 and n1 % k == 0 and (n1 // 16) % k == 0 and n1 // k >= 32
    assert nk.inv_cluster_bytes(n, k) == n1 // k * (n2 + 1) * 8 + 8
    share = nk.inv_cluster_bytes(n, k) + 1024
    assert 2 <= blocks <= 4 and blocks * share <= 228 * 1024
    assert blocks == 4 or k == 8
    half_cluster_share = nk.inv_cluster_bytes(n, k // 2) + 1024
    assert 4 * half_cluster_share > 228 * 1024


@pytest.mark.parametrize("n", SIZES)
def test_inverse_cluster_layout_covers_the_transform(n):
    """csrc/ntt.cu's cluster::inv_cols layout: block r's local row
    jb MK + al holds row k1 = M1 jb + MK r + al (M1 = n1/16, MK = M1/K),
    so the blocks' rows are every row once, each block's rows are whole
    length-16 sub-DFTs a = k1 mod M1 of the column pass, and element kb of
    sub-DFT a, which the first column stage writes at local row kb MK + al
    of block a // MK, is where the second stage reads it; the load puts
    element j = a2 + M2 jb of a row at position jb + 16 a2, a permutation
    of the row's n2 positions."""
    n1, n2 = ntt.factors(n)
    k = nk.inv_cluster(n)
    m1, m2 = n1 // 16, n2 // 16
    mk = m1 // k
    owner = {}
    for r in range(k):
        for jb in range(16):
            for al in range(mk):
                owner[m1 * jb + mk * r + al] = (r, jb * mk + al)
    assert sorted(owner) == list(range(n1))
    for a in range(m1):
        blocks = {owner[a + m1 * jb][0] for jb in range(16)}
        assert blocks == {a // mk}
        for kb in range(16):
            assert owner[a + m1 * kb] == (a // mk, kb * mk + a % mk)
    positions = sorted(jb + 16 * a2 for a2 in range(m2) for jb in range(16))
    assert positions == list(range(n2))


@pytest.mark.parametrize("n", SIZES)
def test_one_pass_inverse_product_count(n):
    """The one-pass inverse's generic products (probes' line): a product
    for every element kb > 0 of both length-16 stages, where the two passes
    shift most, and the row pass's four-step twiddle with its recurrence."""
    _, n2 = ntt.factors(n)
    m2 = n2 // 16
    want = 2 * (n // 16) * 15 + n + n // m2 * (m2 - 1)
    assert ablate.kernel_products(("inv_linear",), n) == want
    assert want > ablate.kernel_products(("inv_rows", "inv_cols"), n)


@pytest.mark.parametrize("n", SIZES)
def test_one_pass_forward_product_count(n):
    """The one-pass forward's generic products: the inverse's inner
    twiddles, a product for every element kb > 0 of both length-16 stages,
    and the column pass's four-step twiddle with its recurrence."""
    n1, _ = ntt.factors(n)
    m1 = n1 // 16
    want = 2 * (n // 16) * 15 + n + n // m1 * (m1 - 1)
    assert ablate.kernel_products(("fwd_linear",), n) == want
    assert want > ablate.kernel_products(("cols", "rows"), n)


@pytest.mark.parametrize("n", SIZES)
def test_forward_cluster_fits_its_blocks_an_sm(n):
    """The one-pass forward shares the inverse's sizing functions
    (`inv_cluster`, `inv_cluster_blocks`): its block holds the same n1/K
    padded rows without the Barrett constant, so the inverse's blocks an SM
    fit; and the kernel's shapes hold: every warp has a task of the first
    column stage, a block's rows are whole warps, and its store whole
    16-byte vectors a thread."""
    n1, n2 = ntt.factors(n)
    k = nk.inv_cluster(n)
    blocks = nk.inv_cluster_blocks(n, k)
    fwd_bytes = n1 // k * (n2 + 1) * 8
    assert fwd_bytes == nk.inv_cluster_bytes(n, k) - 8
    assert (k, blocks) == {16384: (4, 4), 32768: (8, 4), 65536: (8, 3)}[n]
    assert blocks * (fwd_bytes + 1024) <= 228 * 1024
    m1, mk, kb = n1 // 16, n1 // 16 // k, 16 // k
    assert mk >= 1 and kb * m1 == n1 // k and (n1 // k) % 32 == 0
    assert mk * (n2 // 32) >= 8
    assert (n1 // k) * (n2 // 4) % 256 == 0


def _col_at(j2: int, m2: int) -> int:
    """csrc/ntt.cu cluster::fwd_cols' col_at: element j2 = a2 + M2 jb of a
    row at position 16 a2 + (jb ^ a2 16/M2)."""
    a2, jb = j2 % m2, j2 // m2
    return 16 * a2 + (jb ^ (a2 * 16 // m2))


@pytest.mark.parametrize("n", SIZES)
def test_forward_cluster_layout_covers_the_transform(n):
    """cluster::fwd_cols' layout in index arithmetic: the blocks load every
    input row j1 < n1/2 of every column once; the first column stage's
    element kb of sub-DFT a lands in block kb // KB at local row
    (kb % KB) M1 + a, each local row of each block once, and the second
    stage reads sub-DFTs a = 0 .. M1 - 1 of its kb in order; local row
    kbl M1 + ka of block r holds k1 = KB r + kbl + 16 ka, every k1 once;
    col_at permutes a row's positions, fills each bank of a column tile
    twice and gives the first row stage the 16 positions it writes; and
    the store covers every (k1, k2) once, at k1 n2 + k2, a half warp's
    shared reads in distinct banks."""
    n1, n2 = ntt.factors(n)
    k = nk.inv_cluster(n)
    m1, m2 = n1 // 16, n2 // 16
    mk, kb_per = m1 // k, 16 // k
    rows = kb_per * m1
    loaded = []
    for r in range(k):
        for t in range(mk * (n2 // 32)):
            a = mk * r + t % mk
            for lane in range(32):
                j2 = (t // mk) * 32 + lane
                loaded += [(a + m1 * jb) * n2 + j2 for jb in range(8)]
    assert sorted(loaded) == list(range(n // 2))
    pushed = {}
    for a in range(m1):
        for kb in range(16):
            dest = (kb // kb_per, (kb % kb_per) * m1 + a)
            assert dest not in pushed
            pushed[dest] = (a, kb)
    assert sorted(pushed) == [(r, lr) for r in range(k) for lr in range(rows)]
    k1s = []
    for r in range(k):
        for kbl in range(kb_per):
            kb = kb_per * r + kbl
            assert [pushed[(r, kbl * m1 + a)] for a in range(m1)] == [
                (a, kb) for a in range(m1)]
            k1s += [kb + 16 * ka for ka in range(m1)]
    assert sorted(k1s) == list(range(n1))
    pos = [_col_at(j2, m2) for j2 in range(n2)]
    assert sorted(pos) == list(range(n2))
    for tile in range(n2 // 32):
        banks = [pos[tile * 32 + lane] % 16 for lane in range(32)]
        assert sorted(banks) == sorted(list(range(16)) * 2)
        for half in (0, 16):
            assert len({b for b in banks[half:half + 16]}) == 16
    for a2 in range(m2):
        assert sorted(pos[a2 + m2 * jb] for jb in range(16)) == list(
            range(16 * a2, 16 * a2 + 16))
    stored = []
    for r in range(k):
        for i0 in range(0, rows * n2 // 4, 16):
            half = []
            for i in range(i0, i0 + 16):
                hv = i >> 4
                lr = ((i >> 2) & 3) + 4 * (hv // m2)
                vec = (i & 3) + 4 * (hv % m2)
                half.append((lr, vec))
                k1 = kb_per * r + lr // m1 + 16 * (lr % m1)
                stored += [k1 * n2 + 4 * vec + q for q in range(4)]
            for q in range(4):
                assert len({(lr * (n2 + 1) + 4 * vec + q) % 16
                            for lr, vec in half}) == 16
    assert sorted(stored) == list(range(n))
