"""The probes as one run on the card: the probe kernels held against their
plain versions at extra shapes (`check`), then every measurement (`run`),
one line each, and the probe kernels' entries of the kernels line
(`kernel_line`).

`run` measures, with CUDA-event medians:
  * the SM clock under load and the integer multiply rates (csrc/calib.cu);
  * P1, the tensor-core dot rate, at bench_dot's three shapes in int8 and
    bf16, beside the plain version and cuBLAS for the same work, per call
    and back to back; its two stop points at 1024^3; the wgmma and TMA
    instructions in its loops (`cuobjdump -sass`);
  * P2, the add / xor / shift rate, at bench_vpu's two shapes, against the
    peak of its kernel's loop as `cuobjdump -sass` shows it;
  * P3 and P4, the inverse and forward NTT stopped at each of the TPU
    probes' variants, at the probes' shapes;
  * every pass of the forward and inverse NTT at PRINCE level 0's shapes
    (800 transforms of n = 32768), beside the whole transforms.
Each timed kernel's output is held against its plain version's on the same
inputs, and each time against its bound; a mismatch, or a time under its
bound, raises.  Each line ends with the card's name and power limit.
"""

from __future__ import annotations

import torch

from ..ops import _cuda, modp
from ..ops import ntt_kernels as nk
from . import ablate, calib
from .timing import (PLAIN_REPS, REPS, bound, check_bound, cuda_ms_out,
                     gpu_line, require_card)


def _rand_u32(gen, shape, device, high=1 << 32):
    return modp.to_u32(torch.randint(0, high, shape, generator=gen,
                                     device=device, dtype=torch.int64))


def _rand_pair(gen, shape, device):
    """uint32 pair of values < P."""
    return (_rand_u32(gen, shape, device),
            _rand_u32(gen, shape, device, 0xFFFFFFFF))


def _rand_u64(gen, shape, device):
    """int64 tensor of u64 values < P."""
    return ablate.u64_bits(*(modp.to_i64(t)
                             for t in _rand_pair(gen, shape, device)))


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _pass_args(name: str, n: int, count: int, gen, device):
    """Random inputs of pass `name` over `count` transforms."""
    if name.startswith("cols"):
        return (_rand_u32(gen, (count, n // 2), device), n)
    if name in ("rows", "rows_io", "inv_rows"):
        return (_rand_pair(gen, (count, n), device), n)
    if name == "inv_nomod":
        return (_rand_u64(gen, (count, n), device), n)
    primes = torch.tensor([4294967291, 3, 65537, 7681], dtype=torch.int64)
    p = modp.to_u32(primes.repeat(count // 4 + 1)[:count]).to(device)
    return (_rand_u64(gen, (count, n), device), n, p)


def _same(tag: str, got, want) -> None:
    torch.cuda.synchronize()
    if not _equal(got, want):
        raise AssertionError(f"{tag}: kernel != plain")


def check(device="cuda", log=print) -> None:
    """Hold the probe kernels against their plain versions on the card at
    the shapes `run` does not time (`run` compares every output it times):
    P1 at `calib.DOT_CHECKS` (int8 bit for bit, bf16 within
    `calib.dot_tolerance`), P2 at a size that is no multiple of a block,
    and every NTT pass on 8 transforms of 16k and of 32k, inv_cols with a
    prime per transform.  Raises on the first mismatch."""
    dev = require_card(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, kind, m, k, n, grid, fill in calib.DOT_CHECKS:
        x, w = calib.dot_check_inputs(kind, m, k, n, fill, dev)
        got = calib.dot(x, w, grid=grid)
        err = calib.dot_error(got, calib.dot_plain(x, w), x, w)
        cfg = calib.dot_launch_config(m, n, grid, sms)
        log(f"[probe-check] P1 {tag} {m}x{k}x{n} x{grid} (bn {cfg['bn']}, "
            f"{cfg['blocks']} blocks): max |kernel - plain| {err:.3e}, "
            f"within tolerance")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    x = calib.alu_inputs(3, 1000, dev)
    _same("P2 alu 3x1000", calib.alu(x, grid=calib.ALU_GRID),
          calib.alu_plain(x))
    log("[probe-check] P2 alu 3x1000: bit-exact")
    for n in (16384, 32768):
        for name in ablate.PASSES:
            args = _pass_args(name, n, 8, gen, dev)
            tag = f"pass {name} n={n} x8"
            _same(tag, getattr(ablate, name)(*args),
                  getattr(ablate, f"{name}_plain")(*args))
            log(f"[probe-check] {tag}: bit-exact")


def _plain_chain(passes, x, n):
    """The plain versions of `passes`, one after the other, on x; for
    inv_linear, mod INV_PROBE_PRIME, as P3's `full` runs it."""
    out = x
    for name in passes:
        if name == "fwd_linear":
            out = nk.fwd_linear_plain(out, n)
        elif name == "inv_linear":
            p = modp.to_u32(torch.tensor([ablate.INV_PROBE_PRIME]))
            out = nk.inv_linear_plain(out, n, p.to(out[0].device))
        else:
            out = getattr(ablate, f"{name}_plain")(out, n)
    return out


def run(device="cuda", log=print, rates: dict | None = None,
        clock: dict | None = None) -> list[dict]:
    """Every measurement, logged one line each with the card; returns the
    records (probe, kernel, shape, ms, plain_ms, library_ms, bound_ms,
    bound_by, max_abs_err, and `line` on the record of each probe kernel
    that the kernels line reports).  Every timed kernel output is held
    against the plain version's, and every time against its bound
    (`check_bound`).  `rates` and `clock` are measured here unless given."""
    dev = require_card(device)
    card = gpu_line()
    records = []
    if clock is None:
        clock = calib.sample_sm_clock(dev)
    if rates is None:
        rates = calib.mul_rates(dev)
    log(f"[calib] {calib.rates_line(rates, clock)} [{card}]")

    def add(rec, line=False):
        check_bound(f"{rec['probe']} {rec['shape']}", rec["ms"],
                    rec["bound_ms"])
        if "burst_ms" in rec:
            check_bound(f"{rec['probe']} {rec['shape']} back to back",
                        rec["burst_ms"], rec["bound_ms"])
        rec["line"] = line
        records.append(rec)
        return rec

    dot_line = max(calib.DOT_SHAPES, key=lambda s: s[0] * s[1] * s[2])
    for m, k, n in calib.DOT_SHAPES:
        for kind in ("int8", "bf16"):
            r = add(calib.dot_rate(m, k, n, kind, device=dev),
                    (m, k, n) == dot_line)
            share = 100 * r["rate"] / r["peak"]
            log(f"[probe] P1 dot {kind} {r['shape']} (bn {r['bn']}, "
                f"{r['blocks']} blocks): kernel {r['ms']:.4f} ms"
                f" = {r['rate'] / 1e12:.2f} T op/s ({share:.2f} %"
                f" of the data sheet's {r['peak'] / 1e12:.0f} T), cuBLAS "
                f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max "
                f"|kernel - plain| {r['max_abs_err']:.3e}; back to back "
                f"{r['burst_ms']:.4f} ms a call, cuBLAS "
                f"{r['library_burst_ms']:.4f} [{card}]")
    for stop in calib.DOT_STOPS:
        for kind in ("int8", "bf16"):
            r = add(calib.dot_stop_rate(stop, kind, device=dev),
                    kind == "int8")
            log(f"[probe] {r['probe']} {kind} {r['shape']}: kernel "
                f"{r['ms']:.4f} ms = {r['rate'] / 1e12:.2f} T op/s of the "
                f"product ({100 * r['rate'] / r['peak']:.2f} % of "
                f"{r['peak'] / 1e12:.0f} T), TMA {r['tma_bytes'] / 1e9:.3f} GB"
                f" = {r['tma_bytes'] / (r['ms'] * 1e-3) / 1e12:.2f} TB/s "
                f"into shared memory, plain (zeros) {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), output "
                f"zeros as the plain version's; back to back "
                f"{r['burst_ms']:.4f} ms a call [{card}]")
    counts = calib.dot_sass_counts(_cuda.sass())
    log(f"[probe] P1 loops (cuobjdump -sass): {counts}")
    mix = calib.alu_loop_mix()
    log(f"[probe] P2 loop (cuobjdump -sass): {dict(mix)}; at most "
        f"{calib.alu_peak_per_clock(mix):.2f} results per clock per SM")
    for rows, cols in calib.ALU_SHAPES:
        r = add(calib.alu_rate(rows, cols, clock, mix, device=dev),
                (rows, cols) == max(calib.ALU_SHAPES))
        share = 100 * r["rate"] / r["peak"]
        log(f"[probe] P2 alu {r['shape']}: kernel {r['ms']:.4f} ms = "
            f"{r['rate'] / 1e12:.3f} T u32 op/s ({share:.1f} %"
            f" of {r['peak'] / 1e12:.3f} T at {clock['max_mhz']:.0f} MHz), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) [{card}]")

    def timed(probe, kernel, shape, fn, plain, nbytes, ops, count,
              line=False, passes=None, n=None):
        ms, got = cuda_ms_out(fn, REPS)
        plain_ms, want = cuda_ms_out(plain, PLAIN_REPS)
        _same(f"{probe} {shape}", got, want)
        del got, want
        b_ms, b_by = bound(nbytes, ops, rates)
        rec = add(dict(probe=probe, kernel=kernel, shape=shape, ms=ms,
                       plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=0.0,
                       us_per_transform=ms * 1e3 / count), line)
        kern = ""
        if passes:  # what the NTT kernels do and how many blocks fit an SM
            rec["products_per_coef"] = ablate.kernel_products(passes, n) / n
            names = [q for name in passes
                     for q in ablate.TRANSFORM_PASSES.get(name, (name,))]
            rec["blocks_per_sm"] = {q: ablate.blocks_per_sm(q, n, dev)
                                    for q in names}
            kern = (f", {rec['products_per_coef']:.4f} generic products/coef,"
                    f" blocks/SM {rec['blocks_per_sm']}")
        log(f"[probe] {probe} {shape}: {ms:.4f} ms = "
            f"{rec['us_per_transform']:.4f} us/transform, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}){kern}, "
            f"bit-exact [{card}]")

    for n, batch in ablate.INV_PROBE_SHAPES:
        x = ablate.inv_probe_input(batch, n, dev)
        for variant, passes in ablate.INV_VARIANTS.items():
            timed(f"P3 {variant}", "+".join(passes), f"n={n} B={batch}",
                  lambda: ablate.inv_ablate(variant, x, n),
                  lambda: _plain_chain(passes, x, n),
                  *ablate.pass_model(passes, n, batch), batch,
                  passes=passes, n=n)
    for n, batch in ablate.FWD_PROBE_SHAPES:
        x = ablate.fwd_probe_input(batch, n, dev)
        for variant, passes in ablate.FWD_VARIANTS.items():
            timed(f"P4 {variant}", "+".join(passes), f"n={n} B={batch}",
                  lambda: ablate.fwd_ablate(variant, x, n),
                  lambda: _plain_chain(passes, x, n),
                  *ablate.pass_model(passes, n, batch), batch,
                  passes=passes, n=n)

    n, count = ablate.PRINCE_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(2028)
    for name in ablate.PASSES:
        args = _pass_args(name, n, count, gen, dev)
        timed(f"pass {name}", ablate.COUNTERS[name], f"prince_l0 {count}x{n}",
              lambda: getattr(ablate, name)(*args),
              lambda: getattr(ablate, f"{name}_plain")(*args),
              *ablate.pass_model((name,), n, count), count, line=True,
              passes=(name,), n=n)
        del args
    x = _rand_u32(gen, (count, n // 2), dev)
    xp = _rand_pair(gen, (count, n), dev)
    p = _pass_args("inv_cols", n, count, gen, dev)[2]
    timed("B1 ntt_fwd", "ntt_fwd", f"prince_l0 {count}x{n}",
          lambda: nk.fwd_linear(x, n), lambda: nk.fwd_linear_plain(x, n),
          *ablate.pass_model(("fwd_linear",), n, count), count,
          passes=("fwd_linear",), n=n)
    timed("B2 ntt_inv_modcrt", "ntt_inv_modcrt", f"prince_l0 {count}x{n}",
          lambda: nk.inv_linear(xp, n, p),
          lambda: nk.inv_linear_plain(xp, n, p),
          *ablate.pass_model(("inv_linear",), n, count), count,
          passes=("inv_linear",), n=n)
    torch.cuda.empty_cache()
    return records


def kernel_line(records: list[dict], launches: dict) -> list[dict]:
    """The `kernels` JSON entries of the probe kernels, one per launch
    counter, from its record marked `line` in `run`'s records and with its
    launches in that run.  Raises if a probe kernel has no entry or was not
    launched."""
    sources = {**calib.SOURCES, **ablate.SOURCES}
    entries = []
    for r in records:
        if not r["line"]:
            continue
        name = r["kernel"]
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} was not launched in the probe run")
        source, replaces = sources[name]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    missing = set(sources) - {e["name"] for e in entries}
    if missing or len(entries) != len(sources):
        raise AssertionError(f"probe kernels without one kernels-line "
                             f"record: {sorted(missing)}")
    return entries
