"""The port stands alone: cuhe_tpu_torch and chip_smoke.py import neither jax
nor anything of cuhe_tpu (nor a file of native/), the kernel modules import
without nvcc or a card, and an entry point asked for CUDA without a card
raises instead of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cuhe_tpu_torch import api, context, entry, run_prince
from cuhe_tpu_torch.dhs import CuDHS
from cuhe_tpu_torch.models.prince import Prince
from cuhe_tpu_torch.ops import _cuda
from cuhe_tpu_torch.ops import ntt_kernels as nk
from cuhe_tpu_torch.params import make_params
from cuhe_tpu_torch.utils import checkpoint

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "cuhe_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
MODULES = sorted(
    "cuhe_tpu_torch." + ".".join(p.relative_to(REPO / "cuhe_tpu_torch")
                                 .with_suffix("").parts)
    for p in (REPO / "cuhe_tpu_torch").rglob("*.py") if p.name != "__init__.py")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "cuhe_tpu", "native")


def test_no_file_imports_jax_or_cuhe_tpu():
    assert len(PORT_FILES) > 10
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"
        # nor loads the JAX package's native library
        assert "libcuhe_host" not in path.read_text(), path


def test_host_sources_name_no_file_of_the_jax_package():
    """The port's C++ host sources are its own: they name no file of
    native/ and not the JAX package's host library."""
    sources = sorted((REPO / "cuhe_tpu_torch" / "csrc").rglob("*.cpp"))
    assert sources
    for path in sources:
        text = path.read_text()
        assert "native/" not in text, path
        assert "libcuhe_host" not in text, path


def test_importing_the_port_loads_neither_jax_nor_cuhe_tpu():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "from cuhe_tpu_torch.ops import _cuda\n"
            + "assert _cuda.lib.cache_info().currsize == 0, 'built at import'\n"
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'cuhe_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()


def test_cuda_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        context.Context(make_params(*entry.ENTRY_PARAMS))
    with pytest.raises(RuntimeError, match="no card"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no card"):
        entry.make_prince_l0_step(batch=2)
    with pytest.raises(RuntimeError, match="no card"):
        CuDHS(*entry.ENTRY_PARAMS, seed=7)
    with pytest.raises(RuntimeError, match="no card"):
        CuDHS(key_string="d,3")
    with pytest.raises(RuntimeError, match="no card"):
        entry.simple_dhs(seed=7)
    api.setParameters(*entry.ENTRY_PARAMS)
    try:
        with pytest.raises(RuntimeError, match="no card"):
            api.initCuHE()
        with pytest.raises(RuntimeError, match="no card"):
            api.context()
    finally:
        api.resetParameters()
    with pytest.raises(RuntimeError, match="no card"):
        checkpoint.load_ctxt("unused.npz")
    with pytest.raises(RuntimeError, match="no card"):
        checkpoint.load_state("unused.npz")


def test_front_ends_take_only_cpu_or_cuda_tensors():
    n = 16384
    meta = torch.empty((1, n // 2), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="device"):
        nk.fwd_linear(meta, n)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.check(torch.zeros(4, dtype=torch.uint32), "x", torch.uint32)


def test_prince_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        Prince(seed=7)
    with pytest.raises(RuntimeError, match="no card"):
        run_prince.main(["--rounds", "1"])


def _rank_fn(mesh):  # never reached: the checks raise before any rank starts
    return mesh.rank


def test_parallel_entry_points_without_a_card_raise(monkeypatch):
    from cuhe_tpu_torch.parallel import mesh as pmesh
    from cuhe_tpu_torch.parallel import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        run.spawn(1, 2, _rank_fn, backend="gloo")
    with pytest.raises(RuntimeError, match="no card"):
        run.main(["--mesh", "1x2", "--backend", "gloo"])
    one = pmesh.Mesh(1, 1, [0], 0, device="cuda")
    with pytest.raises(RuntimeError, match="no card"):
        entry.sharded_entry(one)
    with pytest.raises(RuntimeError, match="no card"):
        entry.make_sharded_prince_l0_step(one, batch=2)


def test_nccl_takes_one_card_per_rank(monkeypatch):
    """NCCL on ranks that share a card, or on the CPU, raises and names
    the Gloo backend; nothing switches the backend."""
    from cuhe_tpu_torch.parallel import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        run.spawn(2, 2, _rank_fn, backend="nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):
        run.spawn(1, 2, _rank_fn, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        run.spawn(1, 2, _rank_fn, backend="mpi", device="cpu")
