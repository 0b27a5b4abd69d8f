"""Wall-clock timing and profiling helpers.

Counterpart of ``cuhe_tpu/utils/timer.py``: the reference's otimer
(examples/Prince/Timer.{h,cu}) and a trace around a block.  PyTorch queues
CUDA work and returns before the card has done it, so on a CUDA device
every clock reading here is taken after ``torch.cuda.synchronize``; on the
CPU the clock is read as it is.  `trace` records a ``torch.profiler`` trace
(the CPU, and the card where there is one) in place of the JAX package's
``tpu_trace``.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class OTimer:
    """start/stop/show wall-clock milliseconds (Timer.cu:9-23), summed over
    start/stop pairs; with a CUDA `device`, each reading waits for the
    work queued on it."""

    def __init__(self, device=None):
        self.device = device
        self._t0 = None
        self._ms = 0.0

    def start(self):
        _sync(self.device)
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            _sync(self.device)
            self._ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    def show(self, label: str = ""):
        print(f"{label}\t{self._ms:.3f} ms")

    @property
    def ms(self) -> float:
        return self._ms


@contextlib.contextmanager
def timed(label: str, device=None, file=None):
    """Print the block's wall-clock milliseconds as "label: t ms"."""
    t = OTimer(device)
    t.start()
    yield t
    t.stop()
    print(f"{label}: {t.ms:.3f} ms", file=file, flush=True)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace of the block into `logdir` (a
    TensorBoard trace file; CPU activity, and the card's where one is
    available)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
