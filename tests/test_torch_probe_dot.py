"""P1's launch arithmetic, front-end contract, stop points and SASS reading
(cuhe_tpu_torch/probes/calib.py), on the CPU.

The kernel itself (csrc/probe_dot.cu) runs on the card only, where
chip_smoke.py phase 5 holds it against `dot_plain`; what the CPU can check
is the Python around it: which tile width and how many persistent blocks
the host picks, that the blocks' stride loop covers every unit once, that
calls outside the contract raise before a launch, and that the SASS check
finds wgmma and TMA instructions where they are and fails where they are
not.
"""

import collections

import numpy as np
import pytest
import torch

from cuhe_tpu_torch.probes import calib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("m,n,grid,sms", [
    (1024, 1024, 64, 132), (1024, 128, 64, 132), (128, 128, 64, 132),
    (128, 384, 3, 132), (256, 512, 1, 132), (128, 256, 1, 8),
    (384, 640, 5, 7)])
def test_dot_launch_config_covers_every_unit_once(m, n, grid, sms):
    cfg = calib.dot_launch_config(m, n, grid, sms)
    assert cfg["bn"] == (256 if n % 256 == 0 else 128)
    assert cfg["tiles"] == (m // 128) * (n // cfg["bn"])
    assert cfg["units"] == grid * cfg["tiles"]
    assert cfg["blocks"] == min(sms, cfg["units"]) <= sms
    seen = collections.Counter(
        calib.dot_unit(u, cfg, n)
        for b in range(cfg["blocks"])
        for u in range(b, cfg["units"], cfg["blocks"]))
    want = {(c, r, col) for c in range(grid) for r in range(0, m, 128)
            for col in range(0, n, cfg["bn"])}
    assert set(seen) == want
    assert set(seen.values()) == {1}


def test_dot_launch_config_at_the_timed_shapes():
    got = {s: calib.dot_launch_config(s[0], s[2], calib.DOT_GRID, 132)
           for s in calib.DOT_SHAPES}
    # 1024 x 1024: 32 tiles of 128 x 256 per copy, every SM busy
    assert got[(1024, 1024, 1024)] == {"bn": 256, "tiles": 32,
                                       "units": 2048, "blocks": 132}
    # 1024 x 128: 8 tiles of 128 x 128 per copy
    assert got[(1024, 128, 1024)]["bn"] == 256
    assert got[(1024, 128, 1024)]["units"] == 2048
    # 128^3: one tile per copy, 64 units on 64 of the 132 SMs
    assert got[(128, 128, 128)] == {"bn": 128, "tiles": 1, "units": 64,
                                    "blocks": 64}


def _cpu_checks(monkeypatch):
    """Let the kernel path's argument checks run on CPU tensors: the
    device check is the one that needs a card."""
    monkeypatch.setattr(calib._cuda, "check", lambda *a, **k: None)


@pytest.mark.parametrize("shape,kind,grid,err,match", [
    ((128, 128, 128), "f32", 1, TypeError, "int8 or bfloat16"),
    ((100, 128, 128), "int8", 1, ValueError, "multiples of 128"),
    ((128, 128, 200), "int8", 1, ValueError, "multiples of 128"),
    ((128, 32, 128), "int8", 1, ValueError, "k \\* itemsize"),
    ((128, 16, 128), "bf16", 1, ValueError, "k \\* itemsize"),
    ((128, 128, 128), "int8", 0, ValueError, "grid"),
    ((128, 128, 128), "bf16", 65536, ValueError, "grid")])
def test_dot_rejects_calls_outside_the_contract(monkeypatch, shape, kind,
                                                grid, err, match):
    _cpu_checks(monkeypatch)
    m, k, n = shape
    dtype = {"int8": torch.int8, "bf16": torch.bfloat16,
             "f32": torch.float32}[kind]
    x, w = torch.zeros((m, k), dtype=dtype), torch.zeros((k, n), dtype=dtype)
    with pytest.raises(err, match=match):
        calib._dot_args(x, w, grid)


def test_dot_rejects_inner_dims_that_differ(monkeypatch):
    _cpu_checks(monkeypatch)
    x = torch.zeros((128, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="inner dims"):
        calib._dot_args(x, torch.zeros((256, 128), dtype=torch.int8), 1)


def test_dot_kernel_path_refuses_cpu_tensors_and_odd_alignment():
    x = torch.zeros((128, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        calib._dot_args(x, x, 1)
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        calib.dot(x.float(), x.float())


@pytest.mark.parametrize("stop", ["loads_only", "mma_only"])
@pytest.mark.parametrize("kind,dtype", [("int8", torch.int32),
                                        ("bf16", torch.float32)])
def test_dot_stop_points_write_zeros(stop, kind, dtype):
    x, w = calib.dot_inputs(128, 64, 256, kind, "cpu")
    out = calib.dot_stop(x, w, stop, grid=3)
    assert out.dtype == dtype and out.shape == (128, 256)
    assert not out.any()
    assert calib.DOT_STOPS[stop] in calib.SOURCES


def test_dot_stop_rejects_an_unknown_stop():
    x, w = calib.dot_inputs(128, 128, 128, "int8", "cpu")
    with pytest.raises(ValueError, match="stop point"):
        calib.dot_stop(x, w, "stores_only")


@pytest.mark.parametrize("fill,value", [("min", 16_777_216),
                                        ("max", 16_516_096),
                                        ("minmax", -16_646_144)])
def test_dot_extreme_int8_sums_are_exact(fill, value):
    case = next(c for c in calib.DOT_CHECKS if c[-1] == fill)
    _, kind, m, k, n, _, _ = case
    x, w = calib.dot_check_inputs(kind, m, k, n, fill, "cpu")
    out = calib.dot_plain(x, w)
    assert k == 1024 and bool((out == value).all())


def test_dot_mixed_exponents_span_the_range():
    x, w = calib.dot_check_inputs("bf16", 256, 1024, 256, "exp", "cpu")
    e = np.log2(np.abs(x.float().numpy()))
    assert e.min() < -29 and e.max() > 30
    tol = calib.dot_tolerance(x, w)
    assert bool((tol > 0).all())


def _sass_function(name, loops):
    """A kernel's code as `cuobjdump -sass` prints it, with one loop (closed
    by a backward branch) per list of instructions in `loops`."""
    body = ["LDC R1, c[0x0][0x28]"]
    for loop in loops:
        start = len(body)
        body += loop + [f"@P0 BRA 0x{0x10 * start:x}"]
    body += ["EXIT", f"BRA 0x{0x10 * (len(body) + 1):x}"]
    lines = ["\tcode for sm_90a", f"\t\tFunction : _ZN12_GLOBAL__N_1{name}"]
    lines += [f"        /*{0x10 * i:04x}*/                   {ins} ;"
              for i, ins in enumerate(body)]
    return "\n".join(lines) + "\n"


_PRODUCER = ["SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4+0x20], R3",
             "UTMALDG.2D [UR8], [UR12]", "UTMALDG.2D [UR16], [UR12]",
             "IADD3 R2, R2, 0x1, RZ"]


def _consumer(op):
    return (["WARPGROUP.ARRIVE"]
            + [f"{op}.64x256x16.F32.BF16 R24, gdesc[UR4], R24, gsb0"] * 4
            + ["WARPGROUP.DEPBAR.LE gsb0, 0x1", "SYNCS.ARRIVE.TRANS64 RZ"])


def _dot_sass(drop=None):
    text = _sass_function("other_kernelEv", [["IMAD R0, R0, 0x2, R1"]])
    for flag, op in ((0, "IGMMA"), (1, "HGMMA")):
        for bn in calib.DOT_BN:
            for mode in (0, 1, 2):
                name = f"dot_kernelILb{flag}ELi{bn}ELi{mode}EEEv14CUtensorMap"
                cons = _consumer(op if mode != 1 else "NOP")
                prod = _PRODUCER if (flag, bn, "tma") != drop else _PRODUCER[:1]
                if (flag, bn, "mma") == drop:
                    cons = _consumer("NOP")
                text += _sass_function(name, [prod, cons])
    return text


def test_dot_sass_counts_read_the_wgmma_and_tma_loops():
    counts = calib.dot_sass_counts(_dot_sass())
    assert set(counts) == {f"{k} bn={b}" for k in ("int8", "bf16")
                           for b in calib.DOT_BN}
    assert counts["bf16 bn=256"] == {"HGMMA": 4, "UTMALDG": 2}
    assert counts["int8 bn=128"] == {"IGMMA": 4, "UTMALDG": 2}


@pytest.mark.parametrize("drop", [(1, 256, "mma"), (0, 128, "tma")])
def test_dot_sass_counts_fail_without_wgmma_or_tma(drop):
    with pytest.raises(AssertionError, match="in its loops"):
        calib.dot_sass_counts(_dot_sass(drop))
