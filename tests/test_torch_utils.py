"""The port's timer and debug utilities (cuhe_tpu_torch/utils/timer.py,
utils/debug.py) on the CPU: with CUHE_SAFER on, each value check raises on
the same bad inputs as the JAX package's (a non-canonical mod-P pair, a
residue >= its prime) and passes the same good ones; with it off, each is a
no-op; OTimer sums its start/stop intervals, `timed` prints, and `trace`
writes a torch.profiler trace."""

import numpy as np
import pytest
import torch

from cuhe_tpu.utils import debug as jdebug
from cuhe_tpu.utils import timer as jtimer
from cuhe_tpu_torch.utils import debug, timer

P = (1 << 64) - (1 << 32) + 1
M32 = (1 << 32) - 1
PRIMES = np.array([1073741789, 33554393, 65537], dtype=np.uint32)


def _pair(values):
    v = np.array(values, dtype=np.uint64)
    return (v & np.uint64(M32)).astype(np.uint32), \
        (v >> np.uint64(32)).astype(np.uint32)


def _residues(rng, bump=None):
    """[3, 40] residues < PRIMES; `bump` = (plane, column) set to its prime."""
    x = (rng.integers(0, 1 << 40, (3, 40)) % PRIMES[:, None]).astype(np.uint32)
    if bump is not None:
        x[bump] = PRIMES[bump[0]]
    return x


PAIRS = {
    "canonical": ([0, 1, P - 1, M32, 1 << 32, P - 2], False),
    "P": ([5, P], True),
    "P + 1": ([P + 1, 3], True),
    "2^64 - 1": ([(1 << 64) - 1], True),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_check_canonical_pair_agrees_with_jax(monkeypatch, name):
    values, bad = PAIRS[name]
    lo, hi = _pair(values)
    monkeypatch.setattr(debug, "SAFER", True)
    monkeypatch.setattr(jdebug, "SAFER", True)
    for check, args in ((debug.check_canonical_pair,
                         (torch.from_numpy(lo), torch.from_numpy(hi))),
                        (jdebug.check_canonical_pair, (lo, hi))):
        if bad:
            with pytest.raises(AssertionError, match="non-canonical"):
                check(*args, what=name)
        else:
            check(*args, what=name)
    # off: a no-op on the same inputs
    monkeypatch.setattr(debug, "SAFER", False)
    monkeypatch.setattr(jdebug, "SAFER", False)
    debug.check_canonical_pair(torch.from_numpy(lo), torch.from_numpy(hi))
    jdebug.check_canonical_pair(lo, hi)


@pytest.mark.parametrize("bump", [None, (0, 0), (1, 17), (2, 39)])
def test_check_residues_agrees_with_jax(monkeypatch, bump):
    x = _residues(np.random.default_rng(3), bump)
    monkeypatch.setattr(debug, "SAFER", True)
    monkeypatch.setattr(jdebug, "SAFER", True)
    for check, args in ((debug.check_residues,
                         (torch.from_numpy(x), torch.from_numpy(PRIMES))),
                        (jdebug.check_residues, (x, PRIMES))):
        if bump is not None:
            with pytest.raises(AssertionError, match="residue >= prime"):
                check(*args)
        else:
            check(*args)
    monkeypatch.setattr(debug, "SAFER", False)
    monkeypatch.setattr(jdebug, "SAFER", False)
    debug.check_residues(torch.from_numpy(x), torch.from_numpy(PRIMES))
    jdebug.check_residues(x, PRIMES)


def test_check_residues_on_a_batch(monkeypatch):
    """[batch, pnum, L]: the primes go along the planes."""
    x = np.stack([_residues(np.random.default_rng(s)) for s in range(4)])
    monkeypatch.setattr(debug, "SAFER", True)
    debug.check_residues(torch.from_numpy(x), torch.from_numpy(PRIMES))
    x[3, 2, 5] = PRIMES[2]
    with pytest.raises(AssertionError):
        debug.check_residues(torch.from_numpy(x), torch.from_numpy(PRIMES))


def test_otimer_accumulates_like_jax(capsys):
    for t in (timer.OTimer(), timer.OTimer("cpu"), jtimer.OTimer()):
        assert t.ms == 0.0
        t.stop()  # stop without start: nothing
        assert t.ms == 0.0
        t.start()
        sum(range(20000))
        t.stop()
        first = t.ms
        assert first > 0
        t.start()
        sum(range(20000))
        t.stop()
        assert t.ms > first
        t.show("heSetup")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and all(o.startswith("heSetup\t") for o in out)
    assert all(o.endswith(" ms") for o in out)


def test_timed_prints(capsys):
    with timer.timed("layer", "cpu") as t:
        sum(range(20000))
    with jtimer.timed("layer"):
        sum(range(20000))
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(o.startswith("layer: ") for o in out)
    assert float(out[0].split()[1]) == pytest.approx(t.ms, abs=1e-3)


def test_trace_writes_a_profile(tmp_path):
    with timer.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in tmp_path.rglob("*") if f.is_file()]
    assert files and all(f.stat().st_size > 0 for f in files)
