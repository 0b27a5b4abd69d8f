"""One composition of a level's conversions (`context.py::LevelTables`):
`GateStep` equals `Context`'s own conversions composed as the step composes
them, with the AND's product taken by K1 or inside the inverse; and a crt
rank's cut of a level's tables (`LevelTables.planes`) equals a contiguous
copy of each table's planes, for every rank of `crt_split`.  The entry
ring, on the CPU."""

import numpy as np
import pytest
import torch

from cuhe_tpu_torch import entry
from cuhe_tpu_torch.ops import pointwise as pw
from cuhe_tpu_torch.parallel import mesh as pmesh
from cuhe_tpu_torch.step import GateStep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def keyed():
    step, args = entry.entry(device="cpu")
    return step.ctx, tuple(a[:1].contiguous() for a in args)


@pytest.mark.parametrize("product", ("k1", "fused"))
def test_gate_step_is_the_contexts_composition(keyed, product):
    ctx, args = keyed
    a, b = args[:2], args[2:]
    if product == "k1":
        red = ctx.n2c(0, True, pw.ntt_mul(a, b))
    else:
        red = ctx.n2c(0, True, a, b)
    want = ctx.mod_switch(0, ctx.n2c(0, True, ctx.relin(0, ctx.c2r(0, red))))
    got = GateStep(ctx, 0)(*args)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (1, 3, 8192)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# level 0 has 4 planes, level 1 has 3 (which do not split over 4 ranks)
@pytest.mark.parametrize("lvl, n_crt", ((0, 2), (0, 4), (1, 2), (1, 3)))
def test_rank_cut_of_a_levels_tables(keyed, lvl, n_crt):
    ctx, _ = keyed
    t = ctx.level(lvl)
    for c0, c1 in pmesh.crt_split(t.pn, n_crt):
        r = t.planes(c0, c1)
        assert r.pn == c1 - c0
        for name in ("primes", "bi", "mi_words", "m_crt"):
            want = pmesh._cut(getattr(t, name), 0, c0, c1)
            assert getattr(r, name).is_contiguous()
            assert torch.equal(getattr(r, name).view(torch.int32),
                               want.view(torch.int32))
        for name in ("u_ntt", "m_ntt"):
            for got, full in zip(getattr(r, name), getattr(t, name)):
                assert got.is_contiguous()
                assert torch.equal(got.view(torch.int32),
                                   pmesh._cut(full, 0, c0, c1).view(
                                       torch.int32))
        assert r.m_words is t.m_words and r.invp_last is t.invp_last
        for name in ("n", "mod_len", "mod_msg", "w", "knum"):
            assert getattr(r, name) == getattr(t, name)
