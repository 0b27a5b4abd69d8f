"""The port's probes (cuhe_tpu_torch/probes) against the TPU probe scripts.

On the CPU the front ends run their plain versions; the kernels are held
against the same plain versions on the card by chip_smoke.py.  The scripts'
Pallas kernels run in interpret mode: the calibration kernels through
``pallas_call(..., interpret=True)`` on their kernel bodies, the ablations
under ``force_tpu_interpret_mode()``, at small batches (B = 8 at 16k,
B = 16 at 32k) instead of the scripts' 512.

Importing a script sets JAX's persistent compilation cache to the repo's
``.jax_cache`` (tpu_probe_calib.py:14-17 and the like); the `scripts`
fixture restores both settings before anything compiles.
"""

import collections
import importlib.util
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cuhe_tpu.ops import modp as jmodp
from cuhe_tpu.ops import ntt_kernels as jnk
from cuhe_tpu_torch.ops import modp, ntt
from cuhe_tpu_torch.ops import ntt_kernels as nk
from cuhe_tpu_torch.probes import ablate, calib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = ("tpu_probe_calib", "tpu_probe_inv_ablate", "tpu_probe_fwd32_ablate")
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


def _config():
    return {k: getattr(jax.config, k) for k in _CACHE_KEYS}


@pytest.fixture(scope="module")
def scripts():
    """The three probe scripts as modules, with JAX's cache settings as
    they were before the imports."""
    saved = _config()
    mods = {}
    try:
        for name in SCRIPTS:
            spec = importlib.util.spec_from_file_location(
                f"_probe_{name}", REPO / "scripts" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    assert _config() == saved
    return mods


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def test_loading_the_scripts_leaves_the_jax_cache_unset(scripts):
    assert jax.config.jax_compilation_cache_dir is None
    assert set(scripts) == set(SCRIPTS)


# ---------------------------------------------------------------------------
# P2: add / xor / shift (bench_vpu's vpu_kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reps", [64, 5])
def test_alu_matches_vpu_kernel(scripts, reps):
    rows, cols = 16, 128
    x = calib.alu_inputs(rows, cols, "cpu")
    want = pl.pallas_call(
        scripts["tpu_probe_calib"].vpu_kernel(reps), grid=(1,),
        in_specs=[pl.BlockSpec((rows, cols), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((rows, cols), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.uint32),
        interpret=True)(jnp.asarray(_u32(x)))
    np.testing.assert_array_equal(_u32(calib.alu(x, reps=reps)),
                                  np.asarray(want))


def _sass(loop_body, name="alu_kernelEPKjPjii"):
    """A kernel's code as `cuobjdump -sass` prints it: a prologue, a loop
    over `loop_body` (opcode and operands per instruction) closed by a
    backward branch, and the epilogue's self-branch."""
    lines = ["\tcode for sm_90a", f"\t\tFunction : _ZN12_GLOBAL__N_1{name}",
             '\t.headerflags\t@"EF_CUDA_SM90"']
    body = ["LDC R1, c[0x0][0x28]", "@P6 BRA 0x{end:x}"] + loop_body
    start = 0x20
    body += [f"@P6 BRA 0x{start:x}", "EXIT", "BRA 0x{end:x}"]
    end = 0x10 * (len(body) - 1)
    for i, ins in enumerate(body):
        ins = ins.format(end=end)
        lines.append(f"        /*{0x10 * i:04x}*/                   {ins} ;"
                     f"                /* 0x000000011a1b7824 */")
        lines.append(" " * 84 + "/* 0x000fe200078e0203 */")
    return "\n".join(lines) + "\n"


# the loop of csrc/probe_alu.cu as nvcc 12.8 builds it for sm_90a: 4
# unrolled steps of 8 elements, each add an IMAD.IADD on the FMA pipe
_ALU_LOOP = ["IMAD.IADD R27, R26, 0x1, R11", "SHF.R.U32.HI R26, RZ, 0x3, R26",
             "LOP3.LUT R22, R27, R26, RZ, 0x3c, !PT"] * 32 + [
    "UIADD3 UR4, UR4, 0x4, URZ", "UISETP.NE.AND UP0, UPT, UR4, UR5, UPT",
    "PLOP3.LUT P6, PT, PT, PT, UP0, 0x80, 0x0"]


@pytest.mark.parametrize("add,peak", [
    # shifts and xors hold the ALU pipe, 64 of the loop's 100 instructions
    ("IMAD.IADD R27, R26, 0x1, R11", 96.0),
    # with every add on the ALU pipe too, three results per ALU slot
    ("IADD3 R27, R26, R11, RZ", 64.0)])
def test_alu_peak_from_the_loop_sass(add, peak):
    loop = [add if op.startswith("IMAD.IADD") else op for op in _ALU_LOOP]
    sass = _sass(["IMAD R0, R0, 0x100, R3"], "other_kernelEv") + _sass(loop)
    mix = calib.sass_loop(sass, "alu_kernel")
    assert mix["SHF.R.U32.HI"] == mix["LOP3.LUT"] == 32
    assert sum(mix.values()) == len(loop) + 1  # and the backward branch
    assert calib.alu_peak_per_clock(mix) == peak
    with pytest.raises(ValueError, match="no kernel"):
        calib.sass_loop(sass, "dot_kernel")


def test_a_time_under_its_bound_raises():
    from cuhe_tpu_torch.probes.timing import check_bound
    check_bound("at the bound", 0.1, 0.1)
    with pytest.raises(AssertionError, match="bound model is wrong"):
        check_bound("under the bound", 0.0956, 0.0963)


# ---------------------------------------------------------------------------
# P1: tensor-core dot (bench_dot's dot_kernel)
# ---------------------------------------------------------------------------

# bench_dot's inputs at 128^3, then the shapes and fills that the card's
# check holds the kernel to (calib.DOT_CHECKS; the grid is the card's only)
_DOT_CASES = [pytest.param(kind, 128, 128, 128, None, id=kind)
              for kind in ("int8", "bf16")] + [
    pytest.param(kind, m, k, n, fill, id=tag.replace(" ", "-"))
    for tag, kind, m, k, n, grid, fill in calib.DOT_CHECKS]


@pytest.mark.parametrize("kind,m,k,n,fill", _DOT_CASES)
def test_dot_matches_dot_kernel(scripts, kind, m, k, n, fill):
    """int8 bit for bit; bf16 within |got - want| <= k 2^-24 (|x| @ |w|):
    both sides sum exact float32 products of bf16 values in float32, in
    different orders."""
    if fill is None:
        x, w = calib.dot_inputs(m, k, n, kind, "cpu")
    else:
        x, w = calib.dot_check_inputs(kind, m, k, n, fill, "cpu")
    if kind == "int8":
        jx, jw, acc = jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jnp.int32
    else:
        jx = jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
        jw = jnp.asarray(w.view(torch.int16).numpy()).view(jnp.bfloat16)
        acc = jnp.float32
    want = np.asarray(pl.pallas_call(
        scripts["tpu_probe_calib"].dot_kernel(jx.dtype, acc, 1), grid=(2,),
        in_specs=[pl.BlockSpec((m, k), lambda i: (0, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((m, n), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((m, n), acc), interpret=True)(jx, jw))
    got = calib.dot(x, w, grid=calib.DOT_GRID).numpy()
    if kind == "int8":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        if fill is None:  # the int8 inputs are the script's, bit for bit
            rng = np.random.default_rng(0)
            np.testing.assert_array_equal(
                x.numpy(),
                rng.integers(-100, 100, size=(m, k)).astype(np.int8))
    else:
        assert got.dtype == np.float32
        tol = calib.dot_tolerance(x, w).numpy()
        assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_dot_error_holds_the_kernel_to_the_plain_version(kind):
    x, w = calib.dot_inputs(128, 128, 128, kind, "cpu")
    want = calib.dot_plain(x, w)
    assert calib.dot_error(want.clone(), want, x, w) == 0.0
    off = want.clone()
    if kind == "int8":
        off[3, 5] += 1
    else:
        off[3, 5] += 2 * float(calib.dot_tolerance(x, w)[3, 5])
    with pytest.raises(AssertionError, match="kernel"):
        calib.dot_error(off, want, x, w)


def test_kernel_line_has_one_entry_per_probe_kernel():
    from cuhe_tpu_torch.probes import suite
    names = list(calib.SOURCES) + [ablate.COUNTERS[q] for q in ablate.PASSES]
    rec = dict(probe="P", shape="s", ms=1.0, plain_ms=2.0, library_ms=None,
               bound_ms=0.5, bound_by="bytes", max_abs_err=0.0)
    records = [dict(rec, kernel=k, line=True) for k in names]
    records.append(dict(rec, kernel="cols+rows", line=False))
    entries = suite.kernel_line(records, {k: 2 for k in names})
    assert [e["name"] for e in entries] == names
    assert all(e["launches"] == 2 and e["source"].startswith(
        "cuhe_tpu_torch/csrc/") for e in entries)
    with pytest.raises(AssertionError, match="not launched"):
        suite.kernel_line(records, {k: 2 for k in names[1:]})
    with pytest.raises(AssertionError, match="without"):
        suite.kernel_line(records[1:], {k: 2 for k in names})


# ---------------------------------------------------------------------------
# P3: the inverse, stopped at the ablation's variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["stage1", "nomod", "full"])
def test_inv_variants_match_ablation(scripts, variant):
    """Bit for bit: stage1 and nomod are the lo words of canonical values on
    both sides; full is intt_modcrt with every transform mod 0xFFF1."""
    n, batch = 16384, 8
    x = ablate.inv_probe_input(batch, n)
    c = jnp.asarray(_u32(x[0]).reshape(batch, 128, 128))
    with pltpu.force_tpu_interpret_mode():
        if variant == "full":
            p = jnp.asarray(np.full(batch, ablate.INV_PROBE_PRIME, np.uint32))
            mu = jmodp.barrett_mu(ablate.INV_PROBE_PRIME)
            want = jnk.intt_modcrt(
                (c, c), n, p, (jnp.full(batch, mu[0], jnp.uint32),
                               jnp.full(batch, mu[1], jnp.uint32)),
                layout="mat", bt=8)
        else:
            want = scripts["tpu_probe_inv_ablate"].make_ablate(variant)(c)
    got = ablate.lo_plane(ablate.inv_ablate(variant, x, n))
    np.testing.assert_array_equal(_u32(got),
                                  np.asarray(want).reshape(batch, n))


# ---------------------------------------------------------------------------
# P4: the forward, stopped at the ablation's variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch,bt", [(16384, 8, 8), (32768, 16, 16)])
@pytest.mark.parametrize("variant", ["twiddle", "full"])
def test_fwd_variants_match_ablation(scripts, variant, n, batch, bt):
    """Bit for bit: twiddle is the lo words of the canonical column pass;
    full is ntt_fwd.  (P4's stage1 is a lazy representative on the TPU,
    held only by its plain definition below.)"""
    x = ablate.fwd_probe_input(batch, n)
    jx = jnp.asarray(_u32(x))
    got = ablate.fwd_ablate(variant, x, n)
    with pltpu.force_tpu_interpret_mode():
        if variant == "full":
            want = jnk.ntt_fwd(jx, n, layout="mat", bt=bt)
        else:
            make = scripts["tpu_probe_fwd32_ablate"].make_ablate
            step = make(n, bt, variant)
            cv = inspect.getclosurevars(step).nonlocals
            want = cv["call"](jx, cv["tw0"], cv["tw1"], *cv["t_np"])
    if variant == "full":
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(_u32(g),
                                          np.asarray(wnt).reshape(batch, n))
    else:
        np.testing.assert_array_equal(_u32(ablate.lo_plane(got)),
                                      np.asarray(want).reshape(batch, n))


# ---------------------------------------------------------------------------
# the passes against their definitions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16384, 32768])
def test_io_variants_are_load_and_store(n):
    n1, n2 = ntt.FACTORS[n]
    rev1 = ntt.bitrev_index(n1, "cpu").numpy()
    rev2 = ntt.bitrev_index(n2, "cpu").numpy()
    x = ablate.fwd_probe_input(2, n, seed=3)
    lo, hi = ablate.cols_io(x, n)
    pad = np.zeros((2, n1, n2), np.uint32)
    pad[:, : n1 // 2] = _u32(x).reshape(2, n1 // 2, n2)
    np.testing.assert_array_equal(_u32(lo).reshape(2, n1, n2), pad[:, rev1])
    assert not _u32(hi).any()

    pair = nk.fwd_linear(x, n)
    words = modp.u64_from_pair(*pair).reshape(2, n1, n2)
    got = ablate.rows_io(pair, n).numpy().view(np.uint64).reshape(2, n1, n2)
    np.testing.assert_array_equal(got, words[:, :, rev2])


@pytest.mark.parametrize("n", [16384, 32768])
def test_cols_notw_is_the_column_dft(n):
    """B[k1, j2] = sum_{j1 < n1/2} x[j1, j2] w^(n2 j1 k1) mod P, and cols is
    B times w^(k1 j2)."""
    n1, n2 = ntt.FACTORS[n]
    P = modp.P
    w = pow(15893793146607301539, 65536 // n, P)
    x = ablate.fwd_probe_input(1, n, seed=4)
    xm = _u32(x).reshape(n1 // 2, n2)
    b = modp.u64_from_pair(*ablate.cols_notw(x, n)).reshape(n1, n2)
    c = modp.u64_from_pair(*ablate.cols(x, n)).reshape(n1, n2)
    for k1, j2 in ((0, 0), (1, 0), (3, 5), (n1 - 1, n2 - 1), (n1 // 2, 77)):
        want = sum(int(xm[j1, j2]) * pow(w, n2 * j1 * k1, P)
                   for j1 in range(n1 // 2)) % P
        assert int(b[k1, j2]) == want
        assert int(c[k1, j2]) == want * pow(w, k1 * j2, P) % P


def test_passes_compose_to_the_transforms():
    n = 32768
    x = ablate.fwd_probe_input(2, n, seed=5)
    fwd = nk.fwd_linear(x, n)
    for g, wnt in zip(ablate.rows(ablate.cols(x, n), n), fwd):
        assert torch.equal(g.view(torch.int32), wnt.view(torch.int32))
    p = modp.to_u32(torch.tensor([4294967291, 65537]))
    a = ablate.inv_rows(fwd, n)
    out = ablate.inv_cols(a, n, p)
    assert torch.equal(out.view(torch.int32),
                       nk.inv_linear(fwd, n, p).view(torch.int32))
    # without the mod p, the inverse gives back the zero-extended input
    lo, hi = ablate.inv_nomod(a, n)
    xi = modp.to_i64(x)
    assert torch.equal(modp.to_i64(lo),
                       torch.cat([xi, torch.zeros_like(xi)], 1))
    assert not modp.to_i64(hi).any()


def test_pass_models_count_bytes_and_products():
    n, count = ablate.PRINCE_SHAPE
    assert ablate.pass_model(("cols_io",), n, count) == (count * 10 * n, {})
    nbytes, ops = ablate.pass_model(("cols",), n, count)
    _, notw = ablate.pass_model(("cols_notw",), n, count)
    assert nbytes == count * 10 * n and ops["mul64"] > notw["mul64"] > 0
    # a transform moves its input and output only, as chip_smoke counts it
    assert ablate.pass_model(("fwd_linear",), n, count)[0] == count * 10 * n
    assert (ablate.pass_model(("inv_linear",), n, count)[0]
            == count * (12 * n + 4))
    assert (ablate.pass_model(("inv_rows", "inv_nomod"), n, count)[0]
            == count * 16 * n)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_probes_without_a_card_raise(monkeypatch):
    from cuhe_tpu_torch.probes import __main__ as probes_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (probes_main.main, lambda: calib.mul_rates(),
               lambda: calib.dot_rate(128, 128, 128, "int8"),
               lambda: calib.sample_sm_clock()):
        with pytest.raises(RuntimeError, match="no card"):
            fn()
    with pytest.raises(ValueError, match="card"):
        calib.alu_rate(16, 128, {"max_mhz": 1980.0}, collections.Counter(),
                       device="cpu")


def test_module_entry_point_fails_without_a_card():
    out = subprocess.run([sys.executable, "-m", "cuhe_tpu_torch.probes"],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "no card" in out.stderr
    assert not out.stdout.strip()


def test_step_split_separates_port_kernels_and_idle_time():
    """`step_time.split` (the A/B step timings and chip_smoke.py's
    profiles): device rows only, the port's kernels by name, the PyTorch
    share of the busy time, the idle share against the run's time; no
    device time gives no shares."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from cuhe_tpu_torch.probes import step_time

    def ev(key, us, count, dt=DeviceType.CUDA):
        return SimpleNamespace(key=key, self_device_time_total=us,
                               count=count, device_type=dt)

    events = [ev("void zp_mul_kernel<4>(...)", 3000.0, 5),
              ev("void at::native::elementwise_kernel<...>", 1000.0, 4),
              ev("cudaLaunchKernel", 9000.0, 9, DeviceType.CPU),
              ev("void barrett_combine_kernel(...)", 4000.0, 2)]
    sp = step_time.split(SimpleNamespace(key_averages=lambda: events), 10.0)
    assert [r[0] for r in sp["rows"]] == [events[3].key, events[0].key,
                                          events[1].key]
    assert sp["port_rows"] == [(events[3].key, 4.0, 2),
                               (events[0].key, 3.0, 5)]
    assert (sp["busy_ms"], sp["port_kernels_ms"],
            sp["pytorch_kernels_ms"]) == (8.0, 7.0, 1.0)
    assert sp["pytorch_share"] == pytest.approx(0.125)
    assert sp["idle_share"] == pytest.approx(0.2)
    none = step_time.split(SimpleNamespace(key_averages=lambda: events[2:3]),
                           10.0)
    assert none["busy_ms"] == 0 and none["rows"] == []
    assert none["pytorch_share"] is None and none["idle_share"] is None
