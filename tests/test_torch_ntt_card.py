"""The one-pass inverse NTT (csrc/ntt.cu, cluster::inv_cols) on the card:
bit-equal to its plain version at every length, at 1, 3, 7 and 800
transforms, on edge words and at the configurations' smallest and largest
primes; its variant that takes a Z_P product at the load
(`ntt_kernels.inv_linear_mul`) bit-equal to K1 (`pointwise.ntt_mul`) then
the inverse, with the second operand full-shaped and broadcast; and one
PRINCE level-0 gate step launches it for each of its six inverse
transforms, five of them of a product, and K1 never, with the output of
the plain step.  Marked ``card``: they skip without a CUDA device.

This module imports no JAX, so that it runs where JAX is not installed,
without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_ntt_card.py --noconftest \\
        -o addopts="" -p no:cacheprovider -m card -q
"""

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
