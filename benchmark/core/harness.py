"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the check against the plain reference, and the result line.

A runner (benchmark/runners/<traffic's "runner">.py) holds the program
under test for one kind of traffic.  It is built by ``Runner(cell, seed,
device, spans)``, which loads and warms up every shape the window uses,
and offers:

  window(seconds) -> dict   the measured window (see each runner)
  op()                      one operation, for the traced stretch
  shapes() -> dict          the sizes that the byte models read
  release()                 drop the program's state before the check
  check() -> list           (name, value, limit) of each compared number
  failed() -> int           operations whose answer was wrong or missing

The harness times set-up from the process start to the window, reads the
metrics through their readers, and prints the line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import sys
import time

import torch

from . import trace
from .spec import Cell

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cuhe_tpu")


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    seed: int
    seconds: float
    setup_s: float
    window: dict
    peak_bytes: int
    spans: trace.Spans
    shapes: dict
    profile: trace.Profile | None = None


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def load_runner(cell: Cell):
    name = cell.traffic["runner"]
    return importlib.import_module(f"benchmark.runners.{name}").Runner


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, runner_cls=None) -> dict:
    """Run the cell once; returns the result line's object."""
    runner_cls = runner_cls or load_runner(cell)
    spans = trace.Spans(device, sync=traced, on=traced)
    rnr = runner_cls(cell, seed, device, spans)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # set-up's objects (keygen's integers, tables) leave the collector's
    # scans, so that the window does not pay for them
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    window = rnr.window(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(cell=cell, seed=seed, seconds=seconds, setup_s=setup_s,
              window=window, peak_bytes=peak, spans=spans,
              shapes=rnr.shapes())
    if traced:
        spans.sync = False
        prof_cfg = cell.traffic["profile"]
        run.profile = trace.profile_region(rnr.op, prof_cfg["warm"],
                                           prof_cfg["calls"], device, spans)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    gc.unfreeze()
    rnr.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = rnr.check()
    print(f"timing: setup {setup_s:.3f} s, window {seconds} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    # the last look before the result: nothing after the window, the
    # reference's check included, may have loaded JAX or the JAX package
    bad = forbidden_loaded()
    if bad:
        raise RuntimeError(f"the run loaded {bad}")
    out = {
        "correct": all(v <= lim for _, v, lim in checks) and bool(checks),
        "attempted": int(window["attempted"]),
        "failed": int(rnr.failed()),
        "metrics": metrics,
        "device": device_info(device, cell.chips, peak),
    }
    if traced:
        out["device"]["busy_s"] = run.profile.busy_s
        out["device"]["window_s"] = run.profile.window_s
        out["breakdown"] = trace.breakdown(run.profile)
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def device_info(device: torch.device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def emit(result: dict) -> None:
    """The compared numbers as the last lines of stderr, then the result as
    the last line of stdout."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
