#!/usr/bin/env python3
"""Drive the PyTorch port's homomorphic gate step on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build the CUDA kernels of cuhe_tpu_torch/csrc with nvcc (sm_90a), read
     the SASS instructions per product of the multiply-accumulate's digit
     loop and per prime of the ICRT's loop, and measure the card's integer
     multiply rates (csrc/calib.cu), which the operation side of each
     kernel's bound uses, and the SM clock under load;
  2. hold every kernel bit for bit against its plain PyTorch version on the
     card, and time both (CUDA events, median after warm-up) at the gate
     step's shapes, with each kernel's resident blocks per SM; the NTTs also
     at 16k, 32k and 64k, on inputs made of edge values (0, 1, P-1, 2^32-1,
     2^32 and whole rows of each), and the inverse at transform counts
     below, at and past its chunk; the ICRT at every word count 1..32 and on
     edge residues; the multiply-accumulate at a later digit chunk with a
     partial, at fewer planes than the keys hold, on edge values and with
     every operand P-1, and all digits in launches of 8 against one launch;
  3. the entry configuration (16k ring, 4 primes, batch 2): the step on the
     card with the kernels equals the step on the CPU with the plain
     versions (which the tests hold against the JAX package);
  4. PRINCE level 0 (n = 32768, 25 primes, 40 digits, batch 32): the first
     two ciphertexts against the plain path on the card, then the launch
     counts of one batch-32 step (the main path), its time and peak memory,
     and the device time of each kernel in it (torch.profiler);
  5. the probes (cuhe_tpu_torch/probes, `python3 -m cuhe_tpu_torch.probes`):
     every probe kernel and NTT pass against its plain version on the card,
     then the probe run, with its own launch counts: tensor-core dots (P1),
     add / xor / shift (P2), the NTT passes at the TPU stage ablations'
     points (P3, P4) and at PRINCE level 0's shapes, each timed output
     held against its plain version's.
Every kernel time is held against its bound: a time under it fails the run.
It prints a `kernels` JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  It needs one card and no network.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path


def log(msg: str) -> None:
    print(msg, flush=True)


def profile_step(run, step_ms: float, card: str) -> None:
    """Device time of one step by kernel (torch.profiler), split into the
    port's CUDA kernels and PyTorch's own kernels, and the idle share
    against the step's CUDA-event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        log("[profile] the profiler recorded no device time: not measured")
        return
    port = [r for r in rows if any(
        s in r[0] for s in ("fwd_cols", "ntt_rows", "inv_cols", "icrt_kernel",
                            "relin_mulacc_kernel"))]
    ours = sum(ms for _, ms, _ in port)
    log(f"[profile] one batch-32 step: device busy {busy:.3f} ms "
        f"(port kernels {ours:.3f} ms, PyTorch kernels {busy - ours:.3f} ms), "
        f"{len(rows)} kernel names, idle share "
        f"{max(0.0, 1 - busy / step_ms):.3f} of {step_ms:.3f} ms [{card}]")
    for k, ms, cnt in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{cnt:<5d} {k[:90]}")
    for k, ms, cnt in port:  # device time of each port kernel in the step
        log(f"[profile] port {ms:9.3f} ms  x{cnt:<5d} {k[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from cuhe_tpu_torch import entry as port_entry
    from cuhe_tpu_torch import hostmath as hm
    from cuhe_tpu_torch.ops import _cuda, crt, modp
    from cuhe_tpu_torch.ops import ntt_kernels as nk
    from cuhe_tpu_torch.ops.relin import digit_chunk
    from cuhe_tpu_torch.params import make_params
    from cuhe_tpu_torch.probes import ablate
    from cuhe_tpu_torch.probes import calib as probe_calib
    from cuhe_tpu_torch.probes import suite as probe_suite
    from cuhe_tpu_torch.probes.timing import (bound, check_bound, cuda_ms,
                                              gpu_line, ntt_products)
    from cuhe_tpu_torch.step import GateStep

    card = gpu_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build -------------------------------------------------------
    so, build_s = _cuda.build()
    _cuda.lib()
    log(f"[build] {so.name} in {build_s:.1f} s")
    # instructions of the multiply-accumulate's digit loop (unrolled twice)
    # per product, and of the ICRT's prime loop per prime, at PRINCE level
    # 0's 20 words: each the kernel's loop with the most wide multiplies
    sass = _cuda.sass()
    loop = probe_calib.sass_loop(sass, "relin_mulacc_kernel", "IMAD.WIDE")
    per = sum(loop.values()) / (2 * nk.RELIN_RB * nk.RELIN_RP)
    log(f"[sass] relin_mulacc digit loop: {sum(loop.values())} instructions "
        f"for 2 x {nk.RELIN_RB} x {nk.RELIN_RP} products, {per:.2f} per "
        f"product; {dict(loop.most_common(8))}")
    loop = probe_calib.sass_loop(sass, "icrt_kernelILi20E", "IMAD.WIDE")
    log(f"[sass] icrt (20 words) prime loop: {sum(loop.values())} "
        f"instructions per prime; {dict(loop.most_common(8))}")
    del sass
    clock = probe_calib.sample_sm_clock(dev)
    rates = probe_calib.mul_rates(dev)
    log(f"[calib] {probe_calib.rates_line(rates, clock)} [{card}]")

    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)

    def rand_u32(shape, high=1 << 32):
        return modp.to_u32(torch.randint(0, high, shape, generator=gen,
                                         device=dev, dtype=torch.int64))

    def rand_pair(shape):  # values < P
        return rand_u32(shape), rand_u32(shape, 0xFFFFFFFF)

    # edge values of the Goldilocks arithmetic: of a word < P, and of a u32
    p_mod = (1 << 64) - (1 << 32) + 1
    edges = (0, 1, p_mod - 1, (1 << 32) - 1, 1 << 32)
    edges_u32 = (0, 1, (1 << 32) - 1, 1 << 31, (1 << 32) - 2)

    def edge_index(rows, width, k):
        """[rows, width] indices < k: row r < k all r, the rest random."""
        idx = torch.randint(0, k, (rows, width), generator=gen, device=dev)
        idx[:k] = torch.arange(min(rows, k), device=dev)[:, None]
        return idx

    def edge_u32(shape):
        """uint32 of `edges_u32`, one constant row of each first."""
        v = torch.tensor(edges_u32, dtype=torch.int64, device=dev)
        idx = edge_index(shape[:-1].numel(), shape[-1], len(edges_u32))
        return modp.to_u32(v[idx]).reshape(shape)

    def edge_pair(shape):
        """uint32 pair of `edges`, one constant row of each first."""
        idx = edge_index(shape[:-1].numel(), shape[-1], len(edges))
        return tuple(modp.to_u32(torch.tensor(
            [(e >> sh) & 0xFFFFFFFF for e in edges], dtype=torch.int64,
            device=dev)[idx]).reshape(shape) for sh in (0, 32))

    def same(a, b) -> bool:
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def compare(name, shape_tag, kern, plain):
        """Raise unless the kernel's output equals the plain version's bit
        for bit (the tolerance is 0, so the max abs error is 0)."""
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not same(got, want):
            raise AssertionError(f"{name} {shape_tag}: kernel != plain")
        log(f"[kernel] {name} {shape_tag}: bit-exact")

    # ---- 2. every kernel against its plain version ------------------------
    results = {}
    for n in (16384, 32768, 65536):
        x = rand_u32((8, n // 2))
        compare("ntt_fwd", f"n={n} x8", lambda: nk.fwd_linear(x, n),
                lambda: nk.fwd_linear_plain(x, n))
        pr_ = torch.tensor([4294967291, 3, 65537, 7681] * 2,
                           device=dev, dtype=torch.int64)
        xp = rand_pair((8, n))
        compare("ntt_inv_modcrt", f"n={n} x8",
                lambda: nk.inv_linear(xp, n, modp.to_u32(pr_)),
                lambda: nk.inv_linear_plain(xp, n, modp.to_u32(pr_)))
        # the add, subtract and fold at their edges
        x = edge_u32(torch.Size((8, n // 2)))
        compare("ntt_fwd", f"n={n} x8 edge values",
                lambda: nk.fwd_linear(x, n),
                lambda: nk.fwd_linear_plain(x, n))
        xp = edge_pair(torch.Size((8, n)))
        compare("ntt_inv_modcrt", f"n={n} x8 edge values",
                lambda: nk.inv_linear(xp, n, modp.to_u32(pr_)),
                lambda: nk.inv_linear_plain(xp, n, modp.to_u32(pr_)))
        raw = edge_u32(torch.Size((2, 3, n // 2)))
        compare("ntt_fwd_digits", f"n={n} 4 digits x2 edge values",
                lambda: nk.ntt_fwd_digits(raw, n, w=16, j0=1, c=4),
                lambda: nk.ntt_fwd_digits_plain(raw, n, w=16, j0=1, c=4))
    # the inverse runs its two passes chunk by chunk: one chunk short, one
    # chunk, and two chunks and one transform
    n = 65536
    chunk = nk.inv_chunk(n)
    for count in (chunk - 1, chunk, 2 * chunk + 1):
        xp = rand_pair((count, n))
        pc = modp.to_u32(pr_.repeat(count // 8 + 1)[:count])
        compare("ntt_inv_modcrt", f"n={n} x{count} (chunk {chunk})",
                lambda: nk.inv_linear(xp, n, pc),
                lambda: nk.inv_linear_plain(xp, n, pc))
        del xp, pc
        torch.cuda.empty_cache()

    # the ICRT at every word count it takes, 1..32 (each instantiated width
    # and its zero padding): M the product of `words` primes just below 2^32
    chain, v = [], 1 << 32
    while len(chain) < crt.MAX_WORDS:
        v = hm.prev_prime(v - 1)
        chain.append(v)
    for words in range(1, crt.MAX_WORDS + 1):
        ps, m = chain[:words], 1
        for v in ps:
            m *= v
        mi = [m // v for v in ps]

        def u32(vals):
            return modp.to_u32(torch.tensor(vals, dtype=torch.int64,
                                            device=dev))

        args = (u32(ps), u32([hm.modinv(a % v, v) for a, v in zip(mi, ps)]),
                u32([hm.ints_to_words([a], words)[:, 0].tolist()
                     for a in mi]),
                u32(hm.ints_to_words([m], words)[:, 0].tolist()))
        pt = torch.tensor(ps, dtype=torch.int64, device=dev)
        ce = torch.remainder(torch.randint(0, 1 << 32, (2, words, 300),
                                           generator=gen, device=dev,
                                           dtype=torch.int64), pt[:, None])
        ce[0, :, :2] = pt[:, None] - 1
        ce[0, :, 2:4] = 0
        ce = modp.to_u32(ce)
        got, want = crt.icrt_to_raw(ce, *args), crt.icrt_to_raw_plain(ce, *args)
        torch.cuda.synchronize()
        if not same(got, want):
            raise AssertionError(f"icrt {words} words: kernel != plain")
    log(f"[kernel] icrt at 1..{crt.MAX_WORDS} words: bit-exact")

    for tag, params, batch in (("entry", port_entry.ENTRY_PARAMS, 2),
                               ("prince_l0", port_entry.PRINCE_PARAMS, 32)):
        pr = make_params(*params)
        n, pn = pr.ntt_len, pr.num_crt_prime
        words, knum, w = pr.words_coeff(0), pr.num_eval_key_lvl(0), pr.log_relin
        c = digit_chunk(batch, n, knum)
        primes = torch.tensor(pr.crt_primes, device=dev, dtype=torch.int64)
        q, mi, bi = pr.icrt_consts(0)
        m_words = modp.to_u32(torch.tensor(
            hm.ints_to_words([q], words)[:, 0].astype("int64"), device=dev))
        mi_words = modp.to_u32(torch.tensor(
            [hm.ints_to_words([v], words)[:, 0].astype("int64").tolist()
             for v in mi], device=dev))
        bi_t = modp.to_u32(torch.tensor(bi, device=dev, dtype=torch.int64))
        p_u32 = modp.to_u32(primes)

        x = rand_u32((batch, pn, n // 2))
        xp = rand_pair((batch, pn, n))
        crt_in = modp.to_u32(torch.remainder(
            torch.randint(0, 1 << 32, (batch, pn, n // 2), generator=gen,
                          device=dev, dtype=torch.int64), primes[:, None]))
        raw = rand_u32((batch, words, n // 2))
        ek = rand_pair((knum, pn, n))
        # the step's digit chunk (all digits at both configurations)
        dig = nk.ntt_fwd_digits(raw, n, w=w, j0=0, c=c)
        cases = {
            "ntt_fwd": (lambda: nk.fwd_linear(x, n),
                        lambda: nk.fwd_linear_plain(x, n)),
            "ntt_inv_modcrt": (lambda: nk.inv_linear(xp, n, p_u32),
                               lambda: nk.inv_linear_plain(xp, n, p_u32)),
            "icrt": (lambda: crt.icrt_to_raw(crt_in, p_u32, bi_t, mi_words,
                                             m_words),
                     lambda: crt.icrt_to_raw_plain(crt_in, p_u32, bi_t,
                                                   mi_words, m_words)),
            "ntt_fwd_digits": (
                lambda: nk.ntt_fwd_digits(raw, n, w=w, j0=0, c=c),
                lambda: nk.ntt_fwd_digits_plain(raw, n, w=w, j0=0, c=c)),
            "relin_mulacc": (
                lambda: nk.relin_mulacc(dig, ek, j0=0, pnum=pn),
                lambda: nk.relin_mulacc_plain(dig, ek, j0=0, pnum=pn)),
        }
        # a later chunk, as a batch or level whose digits do not fit one
        # chunk runs it: a nonzero bit offset into the words, and a previous
        # chunk's partial to add (8 digits, the earlier chunk size at
        # prince_l0)
        j1 = min(8, knum // 2)
        c1 = min(8, knum - j1)
        dig1 = nk.ntt_fwd_digits(raw, n, w=w, j0=j1, c=c1)
        acc = rand_pair((batch, pn, n))
        compare("ntt_fwd_digits", f"{tag} digits {j1}..{j1 + c1 - 1}",
                lambda: dig1,
                lambda: nk.ntt_fwd_digits_plain(raw, n, w=w, j0=j1, c=c1))
        later = (lambda: nk.relin_mulacc(dig1, ek, j0=j1, pnum=pn, acc=acc),
                 lambda: nk.relin_mulacc_plain(dig1, ek, j0=j1, pnum=pn,
                                               acc=acc))
        compare("relin_mulacc", f"{tag} digits {j1}..{j1 + c1 - 1} + acc",
                *later)
        # the last digit chunk of 8, whose window runs past the top word
        last = (knum - 1) // 8 * 8
        compare("ntt_fwd_digits", f"{tag} digits {last}..{knum - 1}",
                lambda: nk.ntt_fwd_digits(raw, n, w=w, j0=last, c=knum - last),
                lambda: nk.ntt_fwd_digits_plain(raw, n, w=w, j0=last,
                                                c=knum - last))
        # fewer planes than the eval keys hold (a level above 0)
        compare("relin_mulacc", f"{tag} pnum {pn - 1} of {pn}",
                lambda: nk.relin_mulacc(dig1, ek, j0=j1, pnum=pn - 1),
                lambda: nk.relin_mulacc_plain(dig1, ek, j0=j1, pnum=pn - 1))
        # the multiply-add at its edges: a mix of edge values with a
        # partial, and the largest accumulator (every operand P - 1, over
        # all the step's digits)
        de = edge_pair(dig1[0].shape)
        eke, acce = edge_pair(ek[0].shape), edge_pair(acc[0].shape)
        compare("relin_mulacc", f"{tag} edge values",
                lambda: nk.relin_mulacc(de, eke, j0=j1, pnum=pn, acc=acce),
                lambda: nk.relin_mulacc_plain(de, eke, j0=j1, pnum=pn,
                                              acc=acce))
        del de, eke, acce
        top, ektop, acctop = (
            tuple(modp.to_u32(torch.full(t.shape, v, dtype=torch.int64,
                                         device=dev)) for v in (0, 0xFFFFFFFF))
            for t in (dig[0], ek[0], acc[0]))  # P - 1 = (0, 2^32 - 1)
        compare("relin_mulacc", f"{tag} every operand P-1, {c} digits + acc",
                lambda: nk.relin_mulacc(top, ektop, j0=0, pnum=pn,
                                        acc=acctop),
                lambda: nk.relin_mulacc_plain(top, ektop, j0=0, pnum=pn,
                                              acc=acctop))
        del top, ektop, acctop
        # the ICRT at its edges, on a batch of 3 and 1000 columns (no
        # multiple of the 256-column block): residues of 0, 1, M - 1 (every
        # residue p_i - 1), M // 2, and of integers next to multiples of
        # M / p_i, then random residues
        special = [0, 1, q - 1, q // 2]
        for i in range(pn):
            special += [j * mi[i] + d for j in (1, pr.crt_primes[i] - 1)
                        for d in (-1, 0, 1)]
        ce = torch.remainder(torch.randint(0, 1 << 32, (3, pn, 1000),
                                           generator=gen, device=dev,
                                           dtype=torch.int64),
                             primes[:, None])
        ce[0, :, :len(special)] = torch.tensor(
            [[v % p for v in special] for p in pr.crt_primes[:pn]],
            device=dev)
        ce[1] = primes[:, None] - 1
        ce = modp.to_u32(ce)
        compare("icrt", f"{tag} edge values, 3 x 1000",
                lambda: crt.icrt_to_raw(ce, p_u32, bi_t, mi_words, m_words),
                lambda: crt.icrt_to_raw_plain(ce, p_u32, bi_t, mi_words,
                                              m_words))
        del ce
        span = min(words, (w * c - 1) // 32 + 2)
        prods = ntt_products(n)

        def mulacc_model(cc, with_acc):
            """(bytes, multiplies) of relin_mulacc over cc digits: the
            previous partial is read only where one is given"""
            return ((cc * batch + cc * pn + (2 if with_acc else 1)
                     * batch * pn) * n * 8, {"mul64": cc * batch * pn * n})

        model = {  # (bytes, multiplies by kind) of one call at these shapes
            "ntt_fwd": (batch * pn * (n // 2 * 4 + n * 8),
                        {"mul64": batch * pn * prods}),
            # n^-1 folds into a twiddle pass; the mod p is not a multiply
            "ntt_inv_modcrt": (batch * pn * n * 12,
                               {"mul64": batch * pn * prods}),
            # per coefficient and prime: y = x * b_i, then y times each
            # nonzero word of M/p_i
            "icrt": (batch * (pn + words) * (n // 2) * 4,
                     {"mad32": batch * (n // 2) * sum(
                         1 + (v.bit_length() + 31) // 32 for v in mi)}),
            "ntt_fwd_digits": (batch * span * (n // 2) * 4 + c * batch * n * 8,
                               {"mul64": c * batch * prods}),
            "relin_mulacc": mulacc_model(c, False),
        }
        # resident blocks per SM of each kernel's launches at these shapes
        occupancy = {
            "ntt_fwd": lambda: {q: ablate.blocks_per_sm(q, n, dev)
                                for q in ("cols", "rows")},
            "ntt_inv_modcrt": lambda: {q: ablate.blocks_per_sm(q, n, dev)
                                       for q in ("inv_rows", "inv_cols")},
            "ntt_fwd_digits": lambda: {q: ablate.blocks_per_sm(q, n, dev)
                                       for q in ("digits", "rows")},
            "icrt": lambda: crt.icrt_blocks_per_sm(pn, words, dev),
            "relin_mulacc": lambda: nk.relin_blocks_per_sm(batch, pn, dev),
        }
        reps_plain = 3 if tag == "prince_l0" else 5
        for name, (kern, plain) in cases.items():
            compare(name, tag, kern, plain)
            ms = cuda_ms(kern, 20)
            plain_ms = cuda_ms(plain, reps_plain)
            b_ms, b_by = bound(*model[name], rates)
            check_bound(f"{name} {tag}", ms, b_ms)
            results[(name, tag)] = dict(ms=ms, plain_ms=plain_ms,
                                        bound_ms=b_ms, bound_by=b_by)
            log(f"[time] {name} {tag}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"blocks/SM {occupancy[name]()} [{card}]")
        # the later chunk's launch; and all the digits in launches of 8,
        # as the step ran them with a 64 MiB digit chunk, against one
        # launch over all of them
        ms = cuda_ms(later[0], 20)
        b_ms, b_by = bound(*mulacc_model(c1, True), rates)
        check_bound(f"relin_mulacc {tag} later chunk", ms, b_ms)
        log(f"[time] relin_mulacc {tag} digits {j1}..{j1 + c1 - 1} + acc: "
            f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
        if knum > 8:
            chunks = [(j, min(8, knum - j)) for j in range(0, knum, 8)]
            digs = [nk.ntt_fwd_digits(raw, n, w=w, j0=j, c=cc)
                    for j, cc in chunks]
            dig_all = nk.ntt_fwd_digits(raw, n, w=w, j0=0, c=knum)

            def chunked():
                a = None
                for (j, _), d in zip(chunks, digs):
                    a = nk.relin_mulacc(d, ek, j0=j, pnum=pn, acc=a)
                return a

            def whole():
                return nk.relin_mulacc(dig_all, ek, j0=0, pnum=pn)

            compare("relin_mulacc", f"{tag} {len(chunks)} launches of 8 "
                    f"digits, against one of {knum}", chunked, whole)
            ms, ms1 = cuda_ms(chunked, 20), cuda_ms(whole, 20)
            log(f"[time] relin_mulacc {tag} {knum} digits: {ms:.4f} ms in "
                f"{len(chunks)} launches, {ms1:.4f} ms in one [{card}]")
            del digs, dig_all
        del x, xp, crt_in, raw, ek, dig, dig1, acc
        torch.cuda.empty_cache()

    # ---- 3. entry configuration: card == CPU ------------------------------
    step_cpu, args_cpu = port_entry.entry(device="cpu")
    want = step_cpu(*args_cpu)
    step_gpu, args_gpu = port_entry.entry(device=dev)
    got = step_gpu(*args_gpu)
    torch.cuda.synchronize()
    if tuple(got.shape) != (2, 3, 8192) or not same(got.cpu(), want):
        raise AssertionError("entry step: card != CPU")
    digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    log(f"[entry] step on card == step on CPU, uint32 {tuple(got.shape)}, "
        f"sha256 {digest}")
    entry_ms = cuda_ms(lambda: step_gpu(*args_gpu), 10)
    log(f"[entry] step {entry_ms:.3f} ms for 2 ciphertexts [{card}]")
    del step_cpu, args_cpu, step_gpu, args_gpu

    # ---- 4. PRINCE level 0, full size -------------------------------------
    t0 = time.perf_counter()
    step, args = port_entry.make_prince_l0_step(batch=32, device=dev)
    torch.cuda.synchronize()
    log(f"[prince] context + keys + inputs in {time.perf_counter() - t0:.1f} s")
    two = tuple(a[:2].contiguous() for a in args)
    ref = GateStep(step.ctx, 0, plain=True)(*two)
    got2 = step(*two)
    torch.cuda.synchronize()
    if not same(got2, ref):
        raise AssertionError("prince: kernels != plain on the first 2 ciphertexts")
    log("[prince] 2 ciphertexts: kernel step == plain step on the card")

    _cuda.reset_launches()
    out = step(*args)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    log(f"[prince] launches in one batch-32 step: {launches}")
    if tuple(out.shape) != (32, 24, 16384) or not same(out[:2].contiguous(), got2):
        raise AssertionError("prince: batch-32 rows 0..1 != the 2-ciphertext run")
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(*args), 5)
    peak = torch.cuda.max_memory_allocated()
    log(f"[prince] step {step_ms:.3f} ms per 32 ciphertexts, "
        f"{step_ms / 32:.4f} ms per ciphertext, peak memory {peak / 2**30:.2f} GiB "
        f"[{card}]")

    profile_step(lambda: step(*args), step_ms, card)
    del step, args, two, ref, got2, out
    torch.cuda.empty_cache()

    # ---- 5. probes ---------------------------------------------------------
    t0 = time.perf_counter()
    probe_suite.check(dev, log)
    _cuda.reset_launches()
    records = probe_suite.run(dev, log, rates=rates, clock=clock)
    torch.cuda.synchronize()
    probe_launches = dict(_cuda.LAUNCHES)
    log(f"[probes] launches in the probe run: {probe_launches}; "
        f"{time.perf_counter() - t0:.1f} s with the checks")

    sources = {"ntt_fwd": ("cuhe_tpu_torch/csrc/ntt.cu",
                           "cuhe_tpu/ops/ntt_kernels.py:330"),
               "ntt_inv_modcrt": ("cuhe_tpu_torch/csrc/ntt.cu",
                                  "cuhe_tpu/ops/ntt_kernels.py:1014"),
               "icrt": ("cuhe_tpu_torch/csrc/icrt.cu",
                        "cuhe_tpu/ops/crt.py:113"),
               "ntt_fwd_digits": ("cuhe_tpu_torch/csrc/ntt.cu",
                                  "cuhe_tpu/ops/ntt_kernels.py:432"),
               "relin_mulacc": ("cuhe_tpu_torch/csrc/relin.cu",
                                "cuhe_tpu/ops/ntt_kernels.py:556")}
    kernels = []
    for name, (src, rep) in sources.items():
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        r = results[(name, "prince_l0")]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": 0, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    kernels += probe_suite.kernel_line(records, probe_launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
