"""Each cell's check comes out false on its control and on each fault the
cell can have, with the rest of a run driven as the harness drives it (on
the CPU, at small rings, without the look for a card)."""

from __future__ import annotations

import pytest

from benchmark.tests import controls
from benchmark.tests.small import run_small, small_cell


def _false(out, *names):
    assert out["correct"] is False
    assert any(out["checks"][n]["value"] > out["checks"][n]["limit"]
               for n in names)


def test_gate_sound_run_is_correct():
    out = run_small(small_cell("prince.gate_b32"))
    assert out["correct"] is True and out["failed"] == 0


@pytest.mark.parametrize("runner", [controls.GateControl,
                                    controls.GateFlipWord,
                                    controls.GateHalfBatch],
                         ids=["control", "flip_word", "half_batch"])
def test_gate_check_fails(runner):
    out = run_small(small_cell("prince.gate_b32"), runner_cls=runner)
    _false(out, "mismatched_words")
    assert out["failed"] >= 1


@pytest.mark.parametrize("runner,name", [
    (controls.AndControl, "mismatched_words"),
    (controls.AndFlipWord, "mismatched_words"),
    (controls.AndWrongKey, "ek_wrong_coeffs")],
    ids=["control", "flip_word", "wrong_key"])
def test_and_check_fails(runner, name):
    out = run_small(small_cell("simple_dhs.and_b1"), seconds=1.0,
                    runner_cls=runner)
    _false(out, name)


def test_and_sound_run_is_correct():
    out = run_small(small_cell("simple_dhs.and_b1"), seconds=1.0)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.fixture(scope="module")
def circuit_runs():
    """The circuit's sound run and its broken ones at the light ring, cut
    to one S-box layer (a few minutes on the CPU)."""
    cell = small_cell("prince.circuit", params=(3, 2, 16, 50, 25, 8191))
    return {name: run_small(cell, seconds=0.1, runner_cls=controls.short(d))
            for name, d in (("sound", None),
                            ("control", controls.CircuitControl),
                            ("unchanged", controls.CircuitSboxUnchanged),
                            ("flip", controls.CircuitFlipAnswer),
                            ("wrong_key", controls.CircuitWrongKey))}


def test_circuit_sound_run_is_correct(circuit_runs):
    out = circuit_runs["sound"]
    assert out["correct"] is True
    # the reference S-box agreed with the port's layer word for word
    assert set(out["checks"]) >= {"sbox_mismatched_words", "ek_wrong_coeffs"}
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("name,number", [
    ("control", "sbox_mismatched_words"),
    ("unchanged", "sbox_mismatched_words"),
    ("flip", "wrong_bits"),
    ("wrong_key", "ek_wrong_coeffs")])
def test_circuit_check_fails(circuit_runs, name, number):
    _false(circuit_runs[name], number)
