"""The one-pass NTTs (csrc/ntt.cu, cluster::inv_cols and cluster::fwd_cols)
on the card.  The inverse: bit-equal to its plain version at every length,
at 1, 3, 7 and 800 transforms, on edge words and at the configurations'
smallest and largest primes; its variant that takes a Z_P product at the
load (`ntt_kernels.inv_linear_mul`) bit-equal to K1 (`pointwise.ntt_mul`)
then the inverse, with the second operand full-shaped and broadcast; and
one PRINCE level-0 gate step launches it for each of its six inverse
transforms, five of them of a product, and K1 never, with the output of
the plain step.  The forward: bit-equal to its plain version at every
length and the same counts on edge words; its digit variant
(`ntt_kernels.ntt_fwd_digits`) bit-equal to its plain version at PRINCE's
and simple_dhs's windows and at windows that straddle a word or run past
the top word; and the gate step runs it for its four forwards and its
digits, and the two-pass kernels never.  Marked ``card``: they skip
without a CUDA device.

This module imports no JAX, so that it runs where JAX is not installed,
without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_ntt_card.py --noconftest \\
        -o addopts="" -p no:cacheprovider -m card -q
"""

import re

import pytest
import torch

from cuhe_tpu_torch import entry
from cuhe_tpu_torch.ops import _cuda, modp
from cuhe_tpu_torch.ops import ntt_kernels as nk
from cuhe_tpu_torch.ops import pointwise as pw
from cuhe_tpu_torch.params import make_params
from cuhe_tpu_torch.step import GateStep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = modp.P
SIZES = (16384, 32768, 65536)
COUNTS = (1, 3, 7, 800)
# canonical words whose halves are 0, 1 and 2^32 - 1
EDGES = (0, 1, P - 1, (1 << 32) - 1, 1 << 32)
CONFIG_PRIMES = sorted({p for params in (entry.ENTRY_PARAMS,
                                         entry.PRINCE_PARAMS,
                                         entry.SIMPLE_DHS_PARAMS)
                        for p in make_params(*params).crt_primes})


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


def _u32(t: torch.Tensor) -> torch.Tensor:
    return modp.to_u32(t)


def _pair(count: int, n: int, dev, seed: int):
    """A uint32 pair [count, n] of words < P: random, with the first row of
    each edge word whole and every fifth word of the rest an edge word."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lo = torch.randint(0, 1 << 32, (count, n), generator=g, device=dev)
    hi = torch.randint(0, (1 << 32) - 1, (count, n), generator=g, device=dev)
    edge_lo = torch.tensor([e & modp.M32 for e in EDGES], device=dev)
    edge_hi = torch.tensor([e >> 32 for e in EDGES], device=dev)
    pick = torch.randint(0, len(EDGES), (count, n), generator=g, device=dev)
    pick[:len(EDGES)] = torch.arange(min(count, len(EDGES)),
                                     device=dev)[:, None]
    where = torch.rand((count, n), generator=g, device=dev) < 0.2
    where[:len(EDGES)] = True
    lo = torch.where(where, edge_lo[pick], lo)
    hi = torch.where(where, edge_hi[pick], hi)
    return _u32(lo), _u32(hi)


@pytest.mark.card
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n", SIZES)
def test_one_pass_inverse_is_bit_equal(card, n, count):
    xp = _pair(count, n, card, seed=n + count)
    ends = (CONFIG_PRIMES[0], CONFIG_PRIMES[-1])
    p = _u32(torch.tensor([ends[i % 2] for i in range(count)],
                          dtype=torch.int64, device=card))
    _cuda.reset_launches()
    got = nk.inv_linear(xp, n, p)
    assert _cuda.LAUNCHES == {"ntt_inv_cluster": 1}
    want = nk.inv_linear_plain(xp, n, p)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _primes(count: int, dev) -> torch.Tensor:
    ends = (CONFIG_PRIMES[0], CONFIG_PRIMES[-1])
    return _u32(torch.tensor([ends[i % 2] for i in range(count)],
                             dtype=torch.int64, device=dev))


def _words_above_p(pair, count: int):
    """The pair with its first 8 words of each of the first 3 rows set to
    P, P + 1 and 2^64 - 1: the product takes any 64-bit words."""
    lo, hi = (v.clone() for v in pair)
    for r, word in enumerate((P, P + 1, (1 << 64) - 1)[:count]):
        lo[r, :8] = _u32(torch.tensor(word & modp.M32))
        hi[r, :8] = _u32(torch.tensor(word >> 32))
    return lo, hi


@pytest.mark.card
@pytest.mark.parametrize("y_shape", ("full", "broadcast"))
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n", SIZES)
def test_inverse_of_a_product_is_bit_equal(card, n, count, y_shape):
    """inv_linear_mul against K1 then the inverse, on the card, and against
    the plain version.  Broadcast: x as [count / k, k, n] (k = 25, the
    PRINCE planes, where it divides count, else 1) by a [k, n] table."""
    k = 25 if count % 25 == 0 else 1
    xp = _words_above_p(_pair(count, n, card, seed=3 * n + count), count)
    rows = count if y_shape == "full" else k
    yp = _words_above_p(_pair(rows, n, card, seed=5 * n + count), rows)
    xp = tuple(v.view(count // k, k, n) for v in xp)
    yp = tuple(v.view(count // k, k, n) if y_shape == "full" else v
               for v in yp)
    p = _primes(count, card).view(count // k, k)
    _cuda.reset_launches()
    got = nk.inv_linear_mul(xp, yp, n, p)
    assert _cuda.LAUNCHES == {"ntt_inv_cluster_mul": 1}
    want = nk.inv_linear(pw.ntt_mul(xp, yp), n, p)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if count <= 7:  # the plain version is slow at 800 transforms
        plain = nk.inv_linear_mul_plain(xp, yp, n, p)
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


@pytest.mark.card
def test_gate_step_runs_six_one_pass_inverses(card):
    step, args = entry.make_prince_l0_step(batch=2, device=card)
    step(*args)
    _cuda.reset_launches()
    step(*args)
    torch.cuda.synchronize()
    assert (_cuda.LAUNCHES["ntt_inv_cluster"]
            + _cuda.LAUNCHES["ntt_inv_cluster_mul"]) == 6
    assert "ntt_inv_modcrt" not in _cuda.LAUNCHES


@pytest.mark.card
def test_gate_step_takes_its_products_in_the_inverses(card):
    """The AND and Barrett's four table products go into the inverses they
    feed: 5 launches of the inverse of a product, 1 of the plain inverse,
    none of K1; the output equals the plain step's."""
    step, args = entry.make_prince_l0_step(batch=2, device=card)
    step(*args)
    _cuda.reset_launches()
    got = step(*args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ntt_inv_cluster_mul"] == 5
    assert _cuda.LAUNCHES["ntt_inv_cluster"] == 1
    assert _cuda.LAUNCHES["zp_mul"] == 0
    want = GateStep(step.ctx, 0, plain=True)(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _coeffs(shape, dev, seed: int):
    """uint32 coefficients: random, with the first row of each edge word's
    halves whole and every fifth word of the rest one of them."""
    halves = sorted({h for e in EDGES for h in (e & modp.M32, e >> 32)})
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rows, width = shape[:-1].numel(), shape[-1]
    x = torch.randint(0, 1 << 32, (rows, width), generator=g, device=dev)
    edge = torch.tensor(halves, device=dev)
    pick = torch.randint(0, len(halves), (rows, width), generator=g,
                         device=dev)
    pick[:len(halves)] = torch.arange(min(rows, len(halves)),
                                      device=dev)[:, None]
    where = torch.rand((rows, width), generator=g, device=dev) < 0.2
    where[:len(halves)] = True
    return _u32(torch.where(where, edge[pick], x)).reshape(shape)


def _equal(got, want) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


@pytest.mark.card
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n", SIZES)
def test_one_pass_forward_is_bit_equal(card, n, count):
    x = _coeffs(torch.Size((count, n // 2)), card, seed=7 * n + count)
    _cuda.reset_launches()
    got = nk.fwd_linear(x, n)
    assert _cuda.LAUNCHES == {"ntt_fwd": 1}
    want = nk.fwd_linear_plain(x, n)
    torch.cuda.synchronize()
    assert _equal(got, want)


# (w, words, j0, digits, batch): PRINCE's 40 digits of 16 bits over 20
# words; simple_dhs's 141 one-bit digits over 5 words; and 24-bit windows
# over 3 words, at bits 0, 24, 48, 72, 96: one inside a word, two across a
# word boundary, one whose high word is past the top word, one past it
DIGIT_WINDOWS = {"prince": (16, 20, 0, 40, 2), "simple_dhs": (1, 5, 0, 141, 1),
                 "straddle": (24, 3, 0, 5, 3)}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(DIGIT_WINDOWS))
@pytest.mark.parametrize("n", SIZES)
def test_one_pass_digit_forward_is_bit_equal(card, n, case):
    w, words, j0, c, batch = DIGIT_WINDOWS[case]
    raw = _coeffs(torch.Size((batch, words, n // 2)), card, seed=11 * n + w)
    _cuda.reset_launches()
    got = nk.ntt_fwd_digits(raw, n, w=w, j0=j0, c=c)
    assert _cuda.LAUNCHES == {"ntt_fwd_digits": 1}
    want = nk.ntt_fwd_digits_plain(raw, n, w=w, j0=j0, c=c)
    torch.cuda.synchronize()
    assert _equal(got, want)


def _device_kernels(run) -> dict:
    """Launches of each device kernel by name in one call of `run`
    (torch.profiler; a profile with no device kernel is taken again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if names:
            return names
    pytest.fail("the profiler recorded no device kernel")


@pytest.mark.card
def test_gate_step_runs_five_one_pass_forwards(card):
    """The step's four forwards and its relinearization digits run the
    one-pass forward, one launch each; the two-pass kernels (the column
    pass fwd_cols outside the cluster namespace, the row pass ntt_rows)
    never run; the output equals the plain step's."""
    step, args = entry.make_prince_l0_step(batch=2, device=card)
    step(*args)
    _cuda.reset_launches()
    kernels = _device_kernels(lambda: step(*args))
    assert _cuda.LAUNCHES["ntt_fwd"] == 4
    assert _cuda.LAUNCHES["ntt_fwd_digits"] == 1
    assert sum(c for k, c in kernels.items() if "cluster::fwd_cols" in k) == 5
    assert not [k for k in kernels if "ntt_rows" in k
                or re.search(r"(?<!cluster::)fwd_cols", k)]
    got = step(*args)
    want = GateStep(step.ctx, 0, plain=True)(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
