"""The resident mesh (cuhe_tpu_torch/parallel/session.py) on the CPU over
Gloo: a (2, 2) session whose rank 0 is the test process runs several
operations in lockstep and returns every rank's result (or, posted, only
rank 0's); a rank that raises or exits makes rank 0 raise within the
session's timeout; close() leaves no child process.  Also the collectives'
counters and spans (cuhe_tpu_torch/parallel/mesh.py).  The ranks' side is
in tests/torch_session_cases.py."""

import time

import pytest
import torch
import torch.distributed as dist

import torch_session_cases as cases
from cuhe_tpu_torch.parallel import mesh as pmesh
from cuhe_tpu_torch.parallel.session import MeshSession
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TIMEOUT = 60.0
FAIL_TIMEOUT = 20.0


def _gone(session: MeshSession) -> bool:
    return not dist.is_initialized() and not any(
        p.is_alive() for p in session._procs)


def test_lockstep_operations_return_every_rank_result():
    with MeshSession(2, 2, cases.setup, 10, backend="gloo", device="cpu",
                     timeout=TIMEOUT) as s:
        where = s.run("where")
        assert [w[:3] for w in where] == [(0, 0, 0), (1, 0, 1), (2, 1, 0),
                                          (3, 1, 1)]
        # rank 0 is this process, the others are the session's workers
        assert [w[3] for w in where[1:]] == [p.pid for p in s._procs]
        # crt rows {0, 1} and {2, 3}: (10 + r) * x summed over each row
        assert s.run("crt_sum", 3) == [63, 63, 75, 75]
        assert s.run("crt_sum", -1) == [-21, -21, -25, -25]
        # batch columns {0, 2} and {1, 3}, each rank's rows in batch order
        rows = s.run("batch_rows")
        assert rows[0] == rows[2] == [[0] * 3] * 2 + [[2] * 3] * 2
        assert rows[1] == rows[3] == [[1] * 3] * 2 + [[3] * 3] * 2
        # posted: every rank runs it in turn, rank 0's result comes back
        assert s.post("crt_sum", 2) == 42
        assert s.post("where")[:3] == (0, 0, 0)
        # the state persists between operations, on every rank
        calls, n, nbytes, seconds = zip(*s.run("count"))
        assert calls == (6, 6, 6, 6)
        # counted without a timing: three int64 sums and a gather of 2 x 24 B
        assert n == ({"all_reduce": 3, "all_gather": 1},) * 4
        assert nbytes == ({"all_reduce": 24, "all_gather": 48},) * 4
        assert seconds == ({},) * 4
    assert _gone(s) and s.exitcodes == [0, 0, 0]
    with pytest.raises(RuntimeError, match="closed"):
        s.run("where")


def test_collectives_run_inside_their_profiler_ranges():
    with MeshSession(2, 2, cases.setup, 0, backend="gloo", device="cpu",
                     timeout=TIMEOUT) as s:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            s.run("crt_sum", 1)
            s.run("batch_rows")
        names = {e.name for e in prof.events()}
    assert {"mesh.all_reduce", "mesh.all_gather"} <= names
    assert _gone(s)


@pytest.mark.parametrize("how", ["raises", "exits"])
def test_a_failing_rank_makes_rank_0_raise(how):
    """Rank 3 fails where ranks 0-2 wait in an all-reduce over the whole
    world: rank 0 raises naming it, well inside the timeout, and the
    session is closed with every worker gone."""
    s = MeshSession(2, 2, cases.setup, 0, backend="gloo", device="cpu",
                    timeout=FAIL_TIMEOUT)
    assert s.run("where")[3][:3] == (3, 1, 1)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 3") as err:
        s.run("fail_on", 3, how)
    assert time.monotonic() - t0 < FAIL_TIMEOUT
    want = "planted failure" if how == "raises" else "exited"
    assert want in str(err.value)
    assert _gone(s)


def test_a_posted_failure_is_raised_by_the_next_call():
    s = MeshSession(2, 2, cases.setup, 0, backend="gloo", device="cpu",
                    timeout=FAIL_TIMEOUT)
    assert s.post("raise_on", 3) == 0
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 3 failed") as err:
        s.run("where")
    assert time.monotonic() - t0 < FAIL_TIMEOUT
    assert "planted failure on rank 3" in str(err.value)
    assert _gone(s)


class _Tensor:
    """Stands for a CUDA tensor: a synchronisation would be called on it."""

    is_cuda = True
    nbytes = 1000
    device = "cuda:0"


def test_collectives_are_counted_without_synchronising(monkeypatch):
    """count_collectives adds calls and bytes with no device
    synchronisation and no seconds; time_collectives adds the seconds,
    synchronising around each call."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", syncs.append)
    m = pmesh.Mesh(2, 2, range(4), 0, "cpu")
    ran = []
    stats = pmesh.CommStats()
    m.count_collectives(stats)
    m.crt._run("all_reduce", ran.append, _Tensor())
    m.batch._run("all_gather", ran.append, _Tensor(), nbytes=2000)
    assert len(ran) == 2 and syncs == []
    assert stats.calls == {"all_reduce": 1, "all_gather": 1}
    assert stats.bytes == {"all_reduce": 1000, "all_gather": 2000}
    assert not stats.seconds
    m.time_collectives(stats)
    m.crt._run("all_reduce", ran.append, _Tensor())
    assert syncs == ["cuda:0", "cuda:0"]
    assert stats.calls["all_reduce"] == 2 and stats.bytes["all_reduce"] == 2000
    assert set(stats.seconds) == {"all_reduce"}
    m.count_collectives(None)
    m.crt._run("all_reduce", ran.append, _Tensor())
    assert len(ran) == 4 and stats.calls["all_reduce"] == 2
    assert m.crt.stats is None and not m.crt.timed


class _Graph:
    """Stands for torch.cuda.CUDAGraph: records what the step launched
    while it was capturing, and replays that."""

    log: list = []
    live = None

    def __init__(self):
        self.ops = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert _Graph.live is None
        _Graph.live = self

    def capture_end(self):
        _Graph.live = None

    def pool(self):
        return 0

    def replay(self):
        _Graph.log.extend(self.ops)


def test_graph_step_cuts_its_graphs_at_the_collectives(monkeypatch):
    """graph_step captures kernels into graphs and keeps each collective out
    of them: at capture the collectives are not made; at each replay the
    graphs and the collectives come in the step's order, the collectives
    counted as the eager step's."""
    import contextlib

    class _Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    m = pmesh.Mesh(2, 2, range(4), 0, "cpu")
    made = []
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, group=None: made.append(("all_reduce",
                                                           t.shape)))
    monkeypatch.setattr(dist, "broadcast",
                        lambda t, src=None, group=None: made.append(
                            ("broadcast", src)))

    def kernel(name):
        if _Graph.live is not None:
            _Graph.live.ops.append(name)
        else:
            _Graph.log.append(name)

    def step(x):
        kernel("k1")
        m.crt.all_reduce_sum(x)
        kernel("k2")
        m.batch.broadcast(x, 1)
        kernel("k3")
        return x

    _Graph.log = []
    stats = pmesh.CommStats()
    m.count_collectives(stats)
    x = torch.zeros(3, dtype=torch.int32)
    replay, out = pmesh.graph_step(m, step, x)
    # the warm call ran eagerly; the capture made no collective
    assert _Graph.log == ["k1", "k2", "k3"] and len(made) == 2
    assert out is x and m.crt.cut is None and m.batch.cut is None
    _Graph.log, made[:] = [], []
    replay()
    replay()
    assert _Graph.log == ["k1", "k2", "k3"] * 2
    assert made == [("all_reduce", (3,)), ("broadcast", 2)] * 2
    assert stats.calls == {"all_reduce": 3, "broadcast": 3}
