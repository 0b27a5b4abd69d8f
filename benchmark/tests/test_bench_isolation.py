"""What the benchmark may load and read: no JAX and no JAX package
anywhere in it, nothing of the program in its reference, none of the JAX
package's old benchmark files."""

from __future__ import annotations

import ast
import re
import subprocess
import sys
import types

import pytest

from benchmark.core import harness, spec
from benchmark.runners import gate_step
from benchmark.tests.small import run_small, small_cell

FORBIDDEN = set(harness.FORBIDDEN_MODULES)
SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py"))


def _imports(path) -> set[str]:
    """Top-level names of every module the file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                    "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(spec.BENCH_DIR)))
def test_no_jax_anywhere(path):
    """Whole top-level names: cuhe_tpu_torch is not cuhe_tpu."""
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (spec.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    mods = _imports(path)
    assert "cuhe_tpu_torch" not in mods
    assert mods <= {"__future__", "math", "functools", "numpy", "torch"}


# the JAX package's TPU benchmark and its records
OLD = re.compile(r"\bbench\.py\b|BENCH_r\d|MULTICHIP_r\d|BASELINE\.|"
                 r"bench_details|bench_r\d")


def test_reads_no_old_benchmark_file():
    for path in SOURCES:
        if "tests" not in path.parts:
            assert not OLD.search(path.read_text()), path


def test_forbidden_names_compare_whole():
    sys.modules["cuhe_tpu_torch_fake_for_test"] = sys.modules[__name__]
    try:
        assert "cuhe_tpu_torch_fake_for_test" not in harness.forbidden_loaded()
    finally:
        del sys.modules["cuhe_tpu_torch_fake_for_test"]
    sys.modules["cuhe_tpu.fake_for_test"] = sys.modules[__name__]
    try:
        assert harness.forbidden_loaded() == ["cuhe_tpu"]
    finally:
        del sys.modules["cuhe_tpu.fake_for_test"]


def test_a_run_loads_no_jax():
    """Every module a run imports, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.core import harness, spec\n"
        "from benchmark.runners import gate_step, dhs_and, prince_circuit\n"
        "import cuhe_tpu_torch.step, cuhe_tpu_torch.dhs\n"
        "import cuhe_tpu_torch.models.prince\n"
        "b = spec.load_benchmark()\n"
        "[spec.resolve(b, w['name']) for w in b['workloads']]\n"
        "print(harness.forbidden_loaded())\n" % str(spec.ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


class _CheckLoadsTheJaxPackage(gate_step.Runner):
    """A check that imports a module of the JAX package."""

    def check(self):
        sys.modules[FAKE] = types.ModuleType(FAKE)
        return super().check()


FAKE = "cuhe_tpu.fake_for_test"


def test_a_check_that_loads_the_jax_package_gives_no_result():
    """The look at sys.modules comes after the reference's check, last
    before the result."""
    try:
        with pytest.raises(RuntimeError, match="cuhe_tpu"):
            run_small(small_cell("prince.gate_b32"),
                      runner_cls=_CheckLoadsTheJaxPackage)
    finally:
        sys.modules.pop(FAKE, None)
