"""Spans kept by the harness, and the reading of a torch.profiler trace.

`Spans` records named host intervals around the harness's calls into the
program's layers (name, start, end, parent), in memory.  While a profile is
on, each span is also a ``record_function`` range, so the trace holds it on
the device's timeline and an idle gap can be named by the span open during
it.  `profile_region` reduces a profile over one marked region to the
device's busy time, its idle gaps, the time of each device operation, and
the share of device time in PyTorch's own kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

REGION = "bench.region"
_NO_SPAN = contextlib.nullcontext()

# Device operations that are PyTorch's (or its libraries'), by their own
# namespaces and names; every other kernel is the program's own.
PYTORCH_MARKS = ("at::", "at_cuda_detail", "c10::", "cub::", "cutlass",
                 "Memcpy", "Memset", "memcpy", "memset")


def is_pytorch_kernel(name: str) -> bool:
    return any(m in name for m in PYTORCH_MARKS)


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    parent: int | None


class Spans:
    """Named host intervals; `sync` makes each span wait for the device at
    its end, so that its length holds the device work it enqueued.  Spans
    that are not `on` record nothing and cost one call: an untraced run
    reads no span, and keeps its timed path free of them."""

    def __init__(self, device: torch.device, sync: bool = False,
                 ranges: bool = False, on: bool = True):
        self.device, self.sync, self.ranges = device, sync, ranges
        self.on = on
        self.done: list[Span] = []
        self._open: list[int] = []

    def __call__(self, name: str):
        return self._span(name) if self.on else _NO_SPAN

    @contextlib.contextmanager
    def _span(self, name: str):
        parent = self._open[-1] if self._open else None
        idx = len(self.done)
        self.done.append(Span(name, time.perf_counter(), 0.0, parent))
        self._open.append(idx)
        rf = (torch.profiler.record_function(name) if self.ranges
              else contextlib.nullcontext())
        try:
            with rf:
                yield
                if self.sync and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            self._open.pop()
            self.done[idx].end = time.perf_counter()

    def named(self, name: str) -> list[Span]:
        return [s for s in self.done if s.name == name]


@dataclasses.dataclass
class Profile:
    calls: int                # operations inside the region
    window_s: float           # the region's length on the trace's clock
    busy_s: float             # union of device operations inside it
    ops: list                 # (name, start_us, end_us) of device operations
    host_ranges: list         # (name, start_us, end_us) of record_function
    region: tuple             # (start_us, end_us) of the region

    @property
    def device_s_by_name(self) -> dict:
        out: dict = {}
        for name, s, e in self.ops:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps with no device operation inside the region,
        each named by the innermost span open at its middle."""
        r0, r1 = self.region
        gaps, cur = [], r0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if r1 > cur:
            gaps.append((cur, r1))
        named = []
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            inner = [r for r in self.host_ranges
                     if r[1] <= mid <= r[2] and r[0] != REGION]
            name = (min(inner, key=lambda r: r[2] - r[1])[0] if inner
                    else "host")
            named.append([name, (g1 - g0) / 1e6])
        return sorted(named, key=lambda g: -g[1])[:top]


def _union(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_region(fn, warm: int, calls: int, device: torch.device,
                   spans: Spans | None = None) -> Profile:
    """Profile `warm` calls of fn() and then `calls` more inside a marked
    region that ends with a synchronise; the profiler drops a region's
    first launches, so the warm calls open it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if spans is not None:
        spans.ranges = True
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(warm):
            fn()
        sync()
        with torch.profiler.record_function(REGION):
            for _ in range(calls):
                fn()
            sync()
    if spans is not None:
        spans.ranges = False
    evs = prof.events()
    region = [e for e in evs if e.name == REGION]
    if not region:
        raise RuntimeError("the profile holds no region mark")
    r0, r1 = region[0].time_range.start, region[0].time_range.end
    ops, host = [], []
    for e in evs:
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith("bench."):  # a span, also as a device range
            if e.device_type != DeviceType.CUDA:
                host.append((e.name, s, t))
        elif e.device_type == DeviceType.CUDA:
            if s >= r0 and t <= r1:
                ops.append((e.name, s, t))
    busy = _union([(s, t) for _, s, t in ops]) / 1e6
    return Profile(calls=calls, window_s=(r1 - r0) / 1e6, busy_s=busy,
                   ops=ops, host_ranges=host, region=(r0, r1))


def breakdown(prof: Profile, top: int = 10) -> dict:
    ops = sorted(prof.device_s_by_name.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": prof.idle_gaps(top)}
