"""The four-card cell `prince.gate_b32.mesh4` on the CPU: its runner through
the harness, on a (2, 2) Gloo mesh of the port's `MeshSession` at the light
ring and batch 4.  The sound run is correct with no mismatched word; a run
in which one rank's eval-key slice is corrupted is not."""

from __future__ import annotations

import pytest

from benchmark.core import spec
from benchmark.runners import mesh_gate_step
from benchmark.tests.small import LIGHT, PARAMS, run_small

CELL = "prince.gate_b32.mesh4"
BAD_RANK = 3


def small_mesh_cell() -> spec.Cell:
    cell = spec.resolve(spec.load_benchmark(), CELL)
    cell.config["params"] = dict(zip(PARAMS, LIGHT))
    cell.traffic.update({"batch": 4, "keep_first": 2})
    return cell


def wrong_key_setup(mesh, *args):
    """`rank_setup`, with one word of rank BAD_RANK's eval-key slice
    altered after its warm-up."""
    state = mesh_gate_step.rank_setup(mesh, *args)
    if mesh.rank == BAD_RANK:
        state.step.ek_lo[0, 0, 0] ^= 1
    return state


class WrongKeySlice(mesh_gate_step.Runner):
    SETUP = staticmethod(wrong_key_setup)


def test_mesh_cell_is_correct_on_a_gloo_mesh():
    out = run_small(small_mesh_cell(), seconds=1.0)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["mismatched_words"] == {"value": 0, "limit": 0}
    assert out["attempted"] >= 1
    # a CPU run reads no device number
    assert {"gate_ct_per_s", "setup_s"} >= set(out["metrics"])


def test_a_corrupted_key_slice_is_not_correct():
    out = run_small(small_mesh_cell(), seconds=1.0, runner_cls=WrongKeySlice)
    assert out["correct"] is False
    assert out["checks"]["mismatched_words"]["value"] > 0
    assert out["failed"] >= 1


@pytest.mark.parametrize("traced", [False, True])
def test_mesh_readers_without_a_device_trace_read_nothing(traced):
    """The new per-layer readers on a run with no trace or no collective
    kernel give no number, never 0."""
    from benchmark.core import trace
    from benchmark.core.harness import Run

    ops = [("void (anonymous namespace)::fwd_cols<false, 2, 8>", 0.0, 50.0)]
    prof = trace.Profile(calls=1, window_s=1e-4, busy_s=50e-6, ops=ops,
                         host_ranges=[], region=(0.0, 100.0))
    run = Run(cell=None, seed=1, seconds=1.0, setup_s=1.0, window={},
              peak_bytes=0, spans=None, shapes={},
              profile=prof if traced else None)
    for name in ("mesh.collective_pct", "mesh.collective_mb"):
        assert spec.load_reader(name)(run) is None
    assert (spec.load_reader("idle_pct.mesh")(run) is None) is not traced


def test_collective_share_counts_only_exposed_time():
    """100 us window: compute 0-40, NCCL 30-70 (10 of it under compute),
    a copy 60-65 (under NCCL): exposed NCCL time is 70 - 40 - 5 = 25 us.
    The program's range over the collective is no operation of its own."""
    from benchmark.core import trace
    from benchmark.core.harness import Run

    ops = [("void cuhe::k1", 0.0, 40.0),
           ("ncclDevKernel_AllReduce_Sum_i32_RING_LL", 30.0, 70.0),
           ("mesh.all_reduce", 30.0, 70.0),
           ("Memcpy DtoD", 60.0, 65.0)]
    prof = trace.Profile(calls=1, window_s=100e-6, busy_s=70e-6, ops=ops,
                         host_ranges=[], region=(0.0, 100.0))
    run = Run(cell=None, seed=1, seconds=1.0, setup_s=1.0,
              window={"collective_bytes_per_step": 70_254_592.0},
              peak_bytes=0, spans=None, shapes={}, profile=prof)
    assert spec.load_reader("mesh.collective_pct")(run) == pytest.approx(25.0)
    assert spec.load_reader("mesh.collective_mb")(run) == pytest.approx(
        70.254592)
    assert spec.load_reader("idle_pct.mesh")(run) == pytest.approx(30.0)
