"""On the card, at each cell's own size: the control and the planted faults
(tests/controls.py) have to come out not correct on three seeds, in a
window long enough for the circuit to reach its kept block.  Prints
each run's compared numbers, the upper readings that the limits are set
against.

    python -m pytest benchmark/tests/test_bench_card.py -m card \\
        -o addopts="" -p no:cacheprovider -s -q
"""

from __future__ import annotations

import json
import time

import pytest

from benchmark.core import harness, spec
from benchmark.tests import controls

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
RUNS = {"prince.gate_b32.control": controls.GateControl,
        "simple_dhs.and_b1.control": controls.AndControl,
        "simple_dhs.and_b1.wrong_key": controls.AndWrongKey,
        "prince.circuit.control": controls.CircuitControl,
        "prince.circuit.wrong_key": controls.CircuitWrongKey}


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_control_and_faults_fail_at_the_cells_size(card, run, seed):
    cell = run.rsplit(".", 1)[0]
    c = spec.resolve(spec.load_benchmark(), cell)
    out = harness.run_cell(c, seed, 3.0, False, card, time.perf_counter(),
                           runner_cls=RUNS[run])
    print("control", json.dumps({"run": run, "seed": seed,
                                 "attempted": out["attempted"],
                                 "checks": out["checks"]}), flush=True)
    assert out["correct"] is False
