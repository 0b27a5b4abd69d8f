"""The harness: every cell resolves to its files, BENCHMARK.json keeps its
format, the result line has its keys, the readers and byte models read
what they should, and run.py refuses to run without a card."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.core import spec, trace
from benchmark.core import traffic as tg
from benchmark.core.harness import Run
from benchmark.tests.small import run_small, small_cell

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(BENCH, cell)
    assert c.config["name"] == c.config_name
    assert (spec.BENCH_DIR / "runners" / f"{c.traffic['runner']}.py").is_file()
    names = [m.name for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(m.read)


def test_benchmark_json_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and NAME.match(c["name"])
        assert (spec.ROOT / c["file"]).is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        assert len(spec.resolve(BENCH, w["name"]).end_to_end) >= 2
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    out = run_small(small_cell("prince.gate_b32"), traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    assert list(out) == keys + ["checks"]  # the compared numbers come last
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["mismatched_words"] == {"value": 0, "limit": 0}
    # a CPU run reads no device number: peak memory and the trace's
    # metrics stay out, and a step longer than the window counts none
    if traced:
        assert out["metrics"] == {}
    else:
        assert "setup_s" in out["metrics"]
        assert {"gate_ct_per_s", "setup_s"} >= set(out["metrics"])
    json.dumps(out)


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_py_without_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _run_py(spec.ROOT)
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_run_py_in_a_bare_tree_fails(tmp_path):
    """Only BENCHMARK.json and benchmark/: no program, no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_py(tmp_path)
    assert r.returncode != 0
    assert "{" not in r.stdout


def _metric_module(name):
    import importlib.util

    s = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}", spec.METRICS_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_byte_models_at_prince_level_0():
    """chip_smoke.py's step_kernel_models / mulacc_model at B = 32,
    pnum = 25, n = 32768, 40 digits of 16 bits over 20 words."""
    ntt = _metric_module("ntt_roofline")
    relin = _metric_module("relin_roofline")
    assert ntt.fwd_bytes(32, 25, 32768) == 262_144_000  # B1
    assert ntt.inv_bytes(32, 25, 32768) == 314_572_800  # B2
    assert relin.mulacc_bytes(32, 25, 32768, 40) == 807_403_520  # B4
    # B6: 20 RAW words in, 40 digit transforms out
    assert ntt.digits_bytes(32, 32768, 20, 40, 16) == \
        32 * 20 * 16384 * 4 + 40 * 32 * 32768 * 8


def _run(window=None, spans=None, profile=None, shapes=None):
    return Run(cell=None, seed=1, seconds=10.0, setup_s=12.5,
               window=window or {}, peak_bytes=3 << 30,
               spans=spans or trace.Spans(__import__("torch").device("cpu")),
               shapes=shapes or {}, profile=profile)


def test_readers_read_what_they_should():
    lat = [1.0] * 95 + [5.0] * 5
    # the 95th percentile by linear interpolation: 1 + 0.05 * (5 - 1)
    assert spec.load_reader("gate_ms_p95")(
        _run({"latencies_ms": lat})) == pytest.approx(1.2)
    assert spec.load_reader("circuit_ms")(
        _run({"blocks": 40, "seconds": 10.0})) == 250.0
    assert spec.load_reader("gate_ct_per_s")(
        _run({"ct_done": 4096, "seconds": 10.0})) == 409.6
    assert spec.load_reader("peak_mem_gib")(_run()) == 3.0
    assert spec.load_reader("setup_s")(_run()) == 12.5
    # no trace, no per-layer number: the reader returns nothing, never 0
    for name in ("ntt_roofline", "relin_roofline", "idle_pct.step",
                 "gate.kernels", "step.pytorch_pct", "circuit.sbox_ms",
                 "setup.keygen_s"):
        assert spec.load_reader(name)(_run()) is None


def test_profile_readers_on_a_made_trace():
    ops = [("void at::native::copy", 0.0, 100.0),
           ("void (anonymous namespace)::fwd_cols<false, 2, 8>", 100.0,
            500.0),
           ("(anonymous namespace)::relin_mulacc_kernel", 600.0, 900.0)]
    prof = trace.Profile(calls=1, window_s=1e-3, busy_s=900e-6, ops=ops,
                         host_ranges=[("bench.step", 0.0, 1000.0)],
                         region=(0.0, 1000.0))
    shapes = {"batch": 1, "pn": 1, "n": 16384, "knum": 1, "w": 16,
              "words": 1}
    run = _run(profile=prof, shapes=shapes)
    assert spec.load_reader("idle_pct.step")(run) == pytest.approx(10.0)
    # 100 of the 800 us of device time are PyTorch's copy
    assert spec.load_reader("step.pytorch_pct")(run) == pytest.approx(12.5)
    assert spec.load_reader("gate.kernels")(run) == 3
    relin = _metric_module("relin_roofline")
    assert spec.load_reader("relin_roofline")(run) == pytest.approx(
        100 * relin.mulacc_bytes(1, 1, 16384, 1) / 3.35e12 / 300e-6)
    assert prof.idle_gaps() == [["bench.step", 100e-6], ["bench.step",
                                                         100e-6]]


def test_sbox_spans_sum_per_block():
    import torch

    sp = trace.Spans(torch.device("cpu"))
    for _ in range(3):
        with sp("bench.block"):
            for _ in range(2):
                with sp("bench.sbox_layer"):
                    pass
    run = _run(spans=sp)
    v = spec.load_reader("circuit.sbox_ms")(run)
    per = [sum(s.end - s.start for s in sp.done
               if s.name == "bench.sbox_layer" and s.parent == b)
           for b, s in enumerate(sp.done) if s.name == "bench.block"]
    assert v == pytest.approx(1e3 * sorted(per)[1])


def test_schedule_is_the_seeds():
    t = {"pool": 16, "keep_every": 64, "keep_first": 32, "decrypt": 4}
    a, b = tg.Schedule(t, 2 ** 33 + 5), tg.Schedule(t, 2 ** 33 + 5)
    assert [a.input_of(i) for i in range(40)] == \
        [b.input_of(i) for i in range(40)]
    assert sorted(a.input_of(i) for i in range(16)) == list(range(16))
    assert [i for i in range(200) if a.keep(i)] == \
        [i for i in range(200) if b.keep(i)]
    assert a.pick(list(range(100)), 4) == b.pick(list(range(100)), 4)
