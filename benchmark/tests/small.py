"""Cells of BENCHMARK.json cut to sizes that a CPU test can run (the
circuit also to one S-box layer: `controls.short`)."""

from __future__ import annotations

import time

import torch

from benchmark.core import harness, spec

PARAMS = ("d", "p", "w", "min", "cut", "m")
LIGHT = (3, 2, 16, 50, 25, 8191)  # the JAX package's entry ring
LIGHT5 = (5, 2, 16, 50, 25, 8191)  # a ring deep enough for two S-box layers

SMALL = {
    "prince.gate_b32": (LIGHT, {"batch": 2}),
    "simple_dhs.and_b1": (LIGHT, {"pool": 2, "keep_every": 2, "decrypt": 2,
                                  "profile": {"warm": 1, "calls": 2}}),
    "prince.circuit": (LIGHT5, {"keep_first": 1,
                                "profile": {"warm": 0, "calls": 1}}),
}


def small_cell(name: str, params=None, **traffic) -> spec.Cell:
    cell = spec.resolve(spec.load_benchmark(), name)
    p, t = SMALL[name]
    cell.config["params"] = dict(zip(PARAMS, params or p))
    cell.traffic.update(t)
    cell.traffic.update(traffic)
    return cell


def run_small(cell, seed=2 ** 31 + 7, seconds=0.5, traced=False,
              runner_cls=None) -> dict:
    return harness.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                            time.perf_counter(), runner_cls=runner_cls)
