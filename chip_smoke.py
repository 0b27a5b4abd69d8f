#!/usr/bin/env python3
"""Drive the PyTorch port's homomorphic gate step, DHS scheme, PRINCE
circuit and multi-device step on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build the CUDA kernels of cuhe_tpu_torch/csrc with nvcc (sm_90a), read
     the SASS instructions per product of the multiply-accumulate's digit
     loop, per prime of the ICRT's loop and per (word, prime) of K5's prime
     loop, K5's and K8's combine's registers, spills and resident blocks
     per SM (`probes/crt_ops_time.py`), and the wgmma and TMA load
     instructions in the loops of P1's dot kernels (none fails the run),
     and measure the card's integer multiply rates (csrc/calib.cu), which
     the operation side of each kernel's bound uses, and the SM clock under
     load;
  2. hold the plain versions' wrapping int64 arithmetic (ops/modp.py:
     `mul32`, `pack64`, `add_bits64`, `sub_bits64`, `mul_bits64`) against
     Python ints at the extremes on the card (`modp_wrap_extremes`); hold
     every kernel bit for bit against its plain PyTorch version on the
     card, and time both (CUDA events, median after warm-up) at the gate
     step's shapes, with each kernel's resident blocks per SM; the NTTs also
     at 16k, 32k and 64k, on inputs made of edge values (0, 1, P-1, 2^32-1,
     2^32 and whole rows of each), and the inverse at transform counts
     below, at and past its chunk; the ICRT at every word count 1..32 and on
     edge residues; the multiply-accumulate at a later digit chunk with a
     partial, at fewer planes than the keys hold, on edge values and with
     every operand P-1, and all digits in launches of 8 against one launch;
     and every B kernel at the DHS scheme's shapes (`dhs_shapes`): one
     ciphertext with no batch axis and with a batch of 1 at each level of
     CuDHS(5, 2, 1, 61, 20, 8191), 1-bit windows over 141 digits, keygen's
     batch of 141; and at the PRINCE circuit's (`prince_shapes`): level 1's
     relinearization of 64 ciphertexts (38 digits in two chunks, 24 of 25
     planes) and B1, B2, B3 at the deepest levels' 2 and 1 primes; and at
     a crt-sharded step's (`shard_shapes`): B3 on subsets of the primes
     against the global M, B4 on eval-key slices of 13 and 12 planes, B1's
     column- and row-block passes over 2, 4 and 8 ranks (column blocks of
     64, 32 and 16); and the elementwise kernels of csrc/pointwise.cu (K1
     the Z_P product, K2 Barrett's combine, K3 the modulus switch, K4 the
     CRT add; `pointwise_shapes`) at prince_l0's shapes, timed against
     their plain versions and byte bounds, at simple_dhs's and the entry
     ring's (mod_len < n/2), PRINCE levels 1, 23 and 24, a (2, 2) rank's
     planes with the dropped plane apart, and at their extremes; and the
     elementwise kernels off the step (K5 RAW -> CRT, K6 the Z_P sum, K7
     the CRT plaintext and constant ops, K8 the sharded ICRT's split and
     combine, csrc/crt_ops.cu and pointwise.cu; `crt_ops_shapes`), timed at
     prince_l0's shapes and a (2, 2) and (1, 4) rank's, and checked at
     simple_dhs's (keygen's batch of 141), the entry and light PRINCE
     rings', PRINCE levels 1, 23, 24, every word count 1..32, prime counts
     across the kernel's blocks, and their extremes;
  3. the entry configuration (16k ring, 4 primes, batch 2): the step on the
     card with the kernels equals the step on the CPU with the plain
     versions (which the tests hold against the JAX package);
  4. PRINCE level 0 (n = 32768, 25 primes, 40 digits, batch 32): the first
     two ciphertexts against the plain path on the card, then the launch
     counts of one batch-32 step (the main path: K1 5, K2 2 and K3 1
     launches and no plain elementwise version called on the card, or the
     run fails), its time and peak memory, and the device
     time of each kernel in it, the port's and every PyTorch kernel left
     (torch.profiler);
  5. the probes (cuhe_tpu_torch/probes, `python3 -m cuhe_tpu_torch.probes`):
     every probe kernel and NTT pass against its plain version on the card
     (P1's TMA + wgmma dot at 16 extra shapes and fills: the 128-wide tile,
     K tails, 1 and 3 copies, int8 extremes, bf16 mixed exponents),
     then the probe run, with its own launch counts: tensor-core dots (P1)
     and their two stop points (TMA ring only, wgmma only),
     add / xor / shift (P2), the NTT passes at the TPU stage ablations'
     points (P3, P4) and at PRINCE level 0's shapes, each timed output
     held against its plain version's;
  6. the DHS scheme on the card (`dhs_scheme`): the light configuration's
     keys, ciphertexts and gate outputs equal the CPU's; the shipped
     CuDHS(5, 2, 1, 61, 20, 8191) keygen (timed by phase), XOR, NOT and
     AND -> relin -> modSwitch decrypting right, a CuDHS from the private
     key string, the launch counts of the encryption (K5 must launch), of
     one XOR (K6), NOT (K7) and AND gate (every B kernel and K1-K3), none
     with a plain elementwise version on the card, and each gate's time,
     device busy time, PyTorch-kernel share and idle share;
  7. homomorphic PRINCE (cuhe_tpu_torch/models/prince.py): (a) the light
     ring CuDHS(5, 2, 16, 50, 25, 8191, seed=13), card == CPU through S-box
     layer 1, rounds 0 and 1 right, checkpoint after layer 1 and resume
     bit-equal (`prince_light`); (b) Prince(seed=7) at the full
     CuDHS(25, 2, 16, 25, 25, 21845): keygen timed by phase, then the
     known-answer circuit through all 12 S-box layers, each layer's time,
     launches (every B kernel, K1-K4 and K7 in every layer, and no plain
     elementwise version), peak memory and decrypt,
     rounds 0-3 and the final state against the published vectors
     (`prince_full`);
  8. parallel (cuhe_tpu_torch/parallel, `parallel_phase`): the device
     count; the B kernels at a (2, 2) rank's shapes of the PRINCE level-0
     step and B1's block passes timed against their bounds; then 8 ranks
     on this card over Gloo (`phase8_rank`): (a) the entry step on meshes
     (2, 2) and (1, 3) (2 + 1 + 1 planes: the last rank holds only the
     dropped prime) and (b) the PRINCE level-0 step at batch 32 on (2, 2),
     each gathered output bit-equal to phases 3 and 4 and every B kernel,
     K1, K2 and K8 launched on every rank (K3 where a rank keeps planes),
     no plain elementwise version called on the card, with
     each rank's step time, peak memory, eval-key bytes and time in
     collectives; (c) one n = 32768 NTT across 8, 4 and 2 ranks equal to
     B1's; (d) NCCL at (1, device count) against the
     unsharded step where there are two cards or more, else the line
     `nccl: skipped: one device`.
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


# the elementwise kernels (csrc/pointwise.cu) by launch counter, and their
# launches in one gate step (the AND, Barrett's two products twice; the
# combine twice; the switch); K4 runs on PRINCE's path, not the step's
POINTWISE_STEP_LAUNCHES = {"zp_mul": 5, "barrett_combine": 2,
                           "mod_switch": 1}


def profile_step(run, step_ms: float, card: str, label: str,
                 reps: int = 1) -> None:
    """Device time of `reps` runs by kernel (torch.profiler), split into
    the port's CUDA kernels and PyTorch's own kernels, and the idle share
    against the runs' CUDA-event time, `step_ms` each
    (`probes/step_time.py::split`, which the A/B timings of the step use
    too).  Busy times are per run; the kernel rows are the `reps` runs'
    totals.  A profile with no device time is taken again, twice at
    most: a profile of a one-launch gate has come back empty."""
    import torch
    from cuhe_tpu_torch.probes.step_time import split
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that recorded no device time is retried
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        sp = split(prof, step_ms * reps)
        if sp["busy_ms"] > 0:
            break
    busy, ours = sp["busy_ms"] / reps, sp["port_kernels_ms"] / reps
    if busy <= 0:
        log(f"[profile] {label}: the profiler recorded no device time: not "
            "measured")
        return
    runs = f" (per run of {reps})" if reps > 1 else ""
    log(f"[profile] {label}{runs}: device busy {busy:.3f} ms "
        f"(port kernels {ours:.3f} ms, PyTorch kernels "
        f"{sp['pytorch_kernels_ms'] / reps:.3f} ms, share "
        f"{sp['pytorch_share']:.3f}), {len(sp['rows'])} kernel names, idle "
        f"share {sp['idle_share']:.3f} of {step_ms:.3f} ms [{card}]")
    for k, ms, cnt in sp["port_rows"]:  # device time of each port kernel
        log(f"[profile] port {ms:9.3f} ms  x{cnt:<5d} {k[:90]}")
    for k, ms, cnt in sp["rows"]:  # every PyTorch kernel left
        if (k, ms, cnt) not in sp["port_rows"]:
            log(f"[profile] torch {ms:9.3f} ms  x{cnt:<5d} {k[:90]}")


def dhs_shapes(dev, card, compare, rand_u32, rand_pair) -> None:
    """Phase 2 at the DHS scheme's shapes (CuDHS(5, 2, 1, 61, 20, 8191)):
    every B kernel on one ciphertext with no batch axis and with a batch of
    1, at each level's primes and ICRT words (7 primes and 5 words at level
    0 down to 3 and 2 at level 4), relinearization with 1-bit windows over
    all 141 (level 0) and 121 (level 1) digits in one chunk, the
    multiply-accumulate at 7 and 6 of the keys' 7 planes, and keygen's
    batch of 141 polynomials."""
    import torch
    from cuhe_tpu_torch import entry as port_entry
    from cuhe_tpu_torch.context import Context
    from cuhe_tpu_torch.ops import crt, modp
    from cuhe_tpu_torch.ops import ntt_kernels as nk
    from cuhe_tpu_torch.params import make_params
    from cuhe_tpu_torch.probes.timing import cuda_ms

    ctx = Context(make_params(*port_entry.SIMPLE_DHS_PARAMS), dev)
    pr, n = ctx.params, ctx.n

    def residues(shape, primes):
        return modp.to_u32(torch.remainder(
            modp.to_i64(rand_u32(shape)), modp.to_i64(primes)[:, None]))

    for lvl in range(pr.depth):
        t = ctx.level(lvl)
        pn, words = t.pn, pr.words_coeff(lvl)
        icrt_args = (t.primes, t.bi, t.mi_words, t.m_words)
        for lead in ((), (1,)):
            tag = (f"simple_dhs lvl {lvl}, {pn} primes, {words} words, "
                   f"lead {lead}")
            x = rand_u32(lead + (pn, n // 2))
            xp = rand_pair(lead + (pn, n))
            ce = residues(lead + (pn, n // 2), t.primes)
            cases = {
                "ntt_fwd": (lambda: nk.fwd_linear(x, n),
                            lambda: nk.fwd_linear_plain(x, n)),
                "ntt_inv_modcrt": (lambda: nk.inv_linear(xp, n, t.primes),
                                   lambda: nk.inv_linear_plain(xp, n,
                                                               t.primes)),
                "icrt": (lambda: crt.icrt_to_raw(ce, *icrt_args),
                         lambda: crt.icrt_to_raw_plain(ce, *icrt_args)),
            }
            for name, (kern, plain) in cases.items():
                compare(name, tag, kern, plain)
                if lvl == 0 and not lead:
                    log(f"[time] {name} {tag}: kernel "
                        f"{cuda_ms(kern, 20):.4f} ms, plain "
                        f"{cuda_ms(plain, 3):.4f} ms [{card}]")
    # relinearization: every digit in one chunk, one ciphertext
    w = pr.log_relin
    ek = rand_pair((pr.num_eval_key, pr.num_crt_prime, n))
    for lvl in (0, 1):
        t = ctx.level(lvl)
        words, knum = pr.words_coeff(lvl), pr.num_eval_key_lvl(lvl)
        for lead in ((), (1,)):
            raw = rand_u32(lead + (words, n // 2))
            tag = (f"simple_dhs lvl {lvl}, w {w}, {knum} digits, {t.pn} of "
                   f"{pr.num_crt_prime} planes, lead {lead}")
            dig = nk.ntt_fwd_digits(raw, n, w=w, j0=0, c=knum)
            cases = {
                "ntt_fwd_digits": (
                    lambda: dig,
                    lambda: nk.ntt_fwd_digits_plain(raw, n, w=w, j0=0,
                                                    c=knum)),
                "relin_mulacc": (
                    lambda: nk.relin_mulacc(dig, ek, j0=0, pnum=t.pn),
                    lambda: nk.relin_mulacc_plain(dig, ek, j0=0,
                                                  pnum=t.pn)),
            }
            for name, (kern, plain) in cases.items():
                compare(name, tag, kern, plain)
            if lvl == 0 and not lead:
                digits_ms = cuda_ms(
                    lambda: nk.ntt_fwd_digits(raw, n, w=w, j0=0, c=knum), 20)
                mulacc_ms = cuda_ms(cases["relin_mulacc"][0], 20)
                log(f"[time] {tag}: ntt_fwd_digits {digits_ms:.4f} ms, "
                    f"relin_mulacc {mulacc_ms:.4f} ms, tile "
                    f"{nk.relin_tile(1, t.pn)} [{card}]")
    # keygen's batch: the 141 eval keys (and their products) at level 0
    t = ctx.level(0)
    keys = pr.num_eval_key
    x = rand_u32((keys, t.pn, n // 2))
    xp = rand_pair((keys, t.pn, n))
    ce = residues((keys, t.pn, n // 2), t.primes)
    tag = f"simple_dhs keygen batch {keys} x {t.pn} primes"
    compare("ntt_fwd", tag, lambda: nk.fwd_linear(x, n),
            lambda: nk.fwd_linear_plain(x, n))
    compare("ntt_inv_modcrt", tag, lambda: nk.inv_linear(xp, n, t.primes),
            lambda: nk.inv_linear_plain(xp, n, t.primes))
    compare("icrt", tag,
            lambda: crt.icrt_to_raw(ce, t.primes, t.bi, t.mi_words, t.m_words),
            lambda: crt.icrt_to_raw_plain(ce, t.primes, t.bi, t.mi_words,
                                          t.m_words))
    del ctx, ek, x, xp, ce
    torch.cuda.empty_cache()


def prince_shapes(dev, card, compare, rand_u32, rand_pair) -> None:
    """Phase 2 at the shapes only the PRINCE circuit gives the kernels
    (CuDHS(25, 2, 16, 25, 25, 21845), n = 32768): relinearization of the 64
    ciphertexts of level 1 (38 digits, 24 of the keys' 25 planes), whose
    digit NTTs (64 x 38 x 32768 x 8 B) exceed DIGIT_SCRATCH_BYTES, so the
    front end runs them in chunks, each multiply-accumulate adding the
    previous chunk's partial; and B1, B2, B3 at the deepest levels' 2 and 1
    primes (ICRT words at levels 23 and 24), on the 64-ciphertext state."""
    import torch
    from cuhe_tpu_torch import entry as port_entry
    from cuhe_tpu_torch import hostmath as hm
    from cuhe_tpu_torch.ops import crt, modp
    from cuhe_tpu_torch.ops import ntt_kernels as nk
    from cuhe_tpu_torch.ops.relin import digit_chunk, relinearize
    from cuhe_tpu_torch.params import make_params

    pr = make_params(*port_entry.PRINCE_PARAMS)
    n, w, batch = pr.ntt_len, pr.log_relin, 64
    knum, pn, words = (pr.num_eval_key_lvl(1), pr.num_crt_prime_lvl(1),
                       pr.words_coeff(1))
    c = digit_chunk(batch, n, knum)
    chunks = [(j, min(c, knum - j)) for j in range(0, knum, c)]
    if len(chunks) < 2:
        raise AssertionError(f"prince level 1: {knum} digits in one chunk")
    raw = rand_u32((batch, words, n // 2))
    ek = rand_pair((pr.num_eval_key, pr.num_crt_prime, n))
    tag = (f"prince lvl 1, {batch} ciphertexts, {knum} digits in chunks "
           f"{chunks}, {pn} of {pr.num_crt_prime} planes")
    acc = None
    for j0, cc in chunks:
        dig = nk.ntt_fwd_digits(raw, n, w=w, j0=j0, c=cc)
        compare("ntt_fwd_digits", f"{tag}: digits {j0}..{j0 + cc - 1}",
                lambda: dig,
                lambda: nk.ntt_fwd_digits_plain(raw, n, w=w, j0=j0, c=cc))
        prev = acc
        acc = nk.relin_mulacc(dig, ek, j0=j0, pnum=pn, acc=prev)
        compare("relin_mulacc", f"{tag}: digits {j0}..{j0 + cc - 1}"
                + (" + partial" if prev is not None else ""),
                lambda: acc,
                lambda: nk.relin_mulacc_plain(dig, ek, j0=j0, pnum=pn,
                                              acc=prev))
        del dig
    compare("relinearize", tag,
            lambda: relinearize(raw, *ek, w=w, knum=knum, pnum=pn, n=n),
            lambda: relinearize(raw, *ek, w=w, knum=knum, pnum=pn, n=n,
                                digits_mulacc=nk.relin_digits_mulacc_plain))
    del raw, ek, acc
    torch.cuda.empty_cache()
    primes = [int(v) for v in pr.crt_primes]
    for lvl in (pr.depth - 2, pr.depth - 1):
        pn, words = pr.num_crt_prime_lvl(lvl), pr.words_coeff(lvl)
        q, mi, bi = pr.icrt_consts(lvl)

        def u32(vals):
            return modp.to_u32(torch.tensor(vals, dtype=torch.int64,
                                            device=dev))

        p_u32 = u32(primes[:pn])
        icrt_args = (p_u32, u32(list(bi)),
                     u32([hm.ints_to_words([v], words)[:, 0].tolist()
                          for v in mi]),
                     u32(hm.ints_to_words([q], words)[:, 0].tolist()))
        tag = f"prince lvl {lvl}, {pn} primes, {words} ICRT words, x{batch}"
        x = rand_u32((batch, pn, n // 2))
        xp = rand_pair((batch, pn, n))
        ce = modp.to_u32(torch.remainder(modp.to_i64(x),
                                         modp.to_i64(p_u32)[:, None]))
        compare("ntt_fwd", tag, lambda: nk.fwd_linear(x, n),
                lambda: nk.fwd_linear_plain(x, n))
        compare("ntt_inv_modcrt", tag, lambda: nk.inv_linear(xp, n, p_u32),
                lambda: nk.inv_linear_plain(xp, n, p_u32))
        compare("icrt", tag, lambda: crt.icrt_to_raw(ce, *icrt_args),
                lambda: crt.icrt_to_raw_plain(ce, *icrt_args))
    log(f"[kernel] prince shapes: every B kernel bit-exact [{card}]")


def mulacc_model(batch: int, pn: int, n: int, cc: int, with_acc: bool):
    """(bytes, multiplies) of relin_mulacc over cc digits: the previous
    partial is read only where one is given."""
    return ((cc * batch + cc * pn + (2 if with_acc else 1) * batch * pn)
            * n * 8, {"mul64": cc * batch * pn * n})


def step_kernel_models(batch: int, pn: int, n: int, words: int, c: int,
                       span: int, mi) -> dict:
    """(bytes, multiplies by kind) of one call of each B kernel at the
    step's shapes: batch ciphertexts of pn planes, the ICRT's words and
    M/p_i (mi), c digits whose windows span `span` RAW words."""
    from cuhe_tpu_torch.probes.timing import ntt_products

    prods = ntt_products(n)
    return {
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
        "relin_mulacc": mulacc_model(batch, pn, n, c, False),
    }


def zp_mul_model(count: int, b_count: int) -> tuple:
    """(bytes, multiplies) of K1 (`pointwise.ntt_mul`): `count` pair
    words of a and of the output, b's `b_count` (broadcast) read once, one
    64 x 64-bit product a word."""
    return (count * 16 + b_count * 8, {"mul64": count})


def barrett_combine_model(rows: int, pnum: int, n: int, mod_len: int):
    """(bytes, multiplies) of K2 (`barrett.barrett_combine`) on `rows`
    rows of n residues: f and c2 below n/2, c1 where the high range
    [mod_len, 2 mod_len) meets them, the three words at index mod_len where
    it lies past n/2, the output's n/2, and m_crt below mod_len - 1 and the
    primes once.  No multiplies."""
    half = n // 2
    c1 = max(0, min(2 * mod_len, half) - mod_len)
    per_row = 2 * half + c1 + (3 if mod_len >= half else 0) + half
    return (rows * per_row * 4 + pnum * (min(mod_len - 1, half) + 1) * 4, {})


def mod_switch_model(rows: int, k: int, length: int) -> tuple:
    """(bytes, multiplies) of K3 (`pointwise.mod_switch_dropped`): each
    row's k kept planes and its dropped plane read once, k planes written,
    the k + 1 primes and k inverses once; one 32 x 32-bit product an output
    word (the difference times p_t^-1)."""
    return (rows * (2 * k + 1) * length * 4 + (2 * k + 1) * 4,
            {"mad32": rows * k * length})


def crt_add_model(rows: int, pnum: int, length: int) -> tuple:
    """(bytes, multiplies) of K4 (`pointwise.crt_add`): x, y and the
    output once, the primes once."""
    return (3 * rows * length * 4 + pnum * 4, {})


def pointwise_shapes(dev, card, compare, rand_u32, rand_pair, rates) -> dict:
    """Phase 2 for the elementwise Z_P / CRT kernels (csrc/pointwise.cu):
    K1 `ntt_mul`, K2 `barrett_combine`, K3 `mod_switch_dropped` and K4
    `crt_add`, each bit for bit against its plain version
      * at prince_l0's shapes (32 ciphertexts, 25 planes, n = 32768: the
        AND, Barrett's products by a [25, n] table, the combine with
        mod_len = n/2, the mod switch to 24 planes, the S-box's and the
        linear layers' adds), each timed against its plain version and its
        bound;
      * at simple_dhs's and the entry ring's (n = 16384, mod_len = 8190 <
        n/2: output coefficients 8190, 8191 take the high-half subtract),
        with no batch axis and a batch of 1;
      * at PRINCE level 1 (64 ciphertexts, 24 planes) and levels 23-24 (2
        and 1 planes);
      * at a (2, 2) rank's shard shapes (16 ciphertexts, 13 / 12 planes,
        the dropped plane given apart, as the broadcast gives it), the two
        ranks' kept planes together equal to the unsharded switch;
      * at the extremes: pair words P - 1, P and 2^64 - 1 (hi P_HI) in
        every pairing, residues p - 1 and 0, a plane whose coefficient
        x^mod_len is 0, dirty residues at (p_t - 1)/2 and either side of
        it, with mod_msg 2, 3 and 16 (ep != 0).
    Returns the prince_l0 timings by kernel name (the kernels line)."""
    import torch
    from cuhe_tpu_torch import entry as port_entry
    from cuhe_tpu_torch import hostmath as hm
    from cuhe_tpu_torch.ops import barrett, modp
    from cuhe_tpu_torch.ops import pointwise as pw
    from cuhe_tpu_torch.parallel.mesh import crt_split
    from cuhe_tpu_torch.params import make_params
    from cuhe_tpu_torch.probes.timing import bound, check_bound, cuda_ms

    def u32(vals):
        return modp.to_u32(torch.tensor(vals, dtype=torch.int64, device=dev))

    def residues(shape, primes):
        """Random residues of [.., pnum, L] mod the planes' primes."""
        return modp.to_u32(torch.remainder(
            modp.to_i64(rand_u32(shape)), modp.to_i64(primes)[:, None]))

    def ring(params):
        pr = make_params(*params)
        ps = [int(v) for v in pr.crt_primes]
        return pr, ps

    def switch_args(ps, pn):
        """(primes [pn], invp_last [pn - 1]) of a level with pn planes."""
        pt = ps[pn - 1]
        return u32(ps[:pn]), u32([hm.modinv(pt % p, p) for p in ps[:pn - 1]])

    def check_all(tag, pr, ps, lead, pn, mod_msg=None):
        """K1-K4 at one ring, level width pn and leading shape."""
        n, mod_len = pr.ntt_len, pr.mod_len
        half = n // 2
        p = u32(ps[:pn])
        a, b = rand_pair(lead + (pn, n)), rand_pair(lead + (pn, n))
        tab = rand_pair((pn, n))
        compare("zp_mul", f"{tag} x {tuple(a[0].shape)}",
                lambda: pw.ntt_mul(a, b), lambda: pw.ntt_mul_plain(a, b))
        compare("zp_mul", f"{tag} x {tuple(a[0].shape)} by [{pn}, {n}]",
                lambda: pw.ntt_mul(a, tab), lambda: pw.ntt_mul_plain(a, tab))
        f, c1, c2 = (residues(lead + (pn, n), p) for _ in range(3))
        mc = residues((pn, half), p)
        compare("barrett_combine", f"{tag} {tuple(f.shape)} mod_len {mod_len}",
                lambda: barrett.barrett_combine(f, c1, c2, mc, p,
                                                mod_len=mod_len, n=n),
                lambda: barrett.barrett_combine_plain(f, c1, c2, mc, p,
                                                      mod_len=mod_len, n=n))
        x, y = residues(lead + (pn, half), p), residues(lead + (pn, half), p)
        compare("crt_add", f"{tag} {tuple(x.shape)}",
                lambda: pw.crt_add(x, y, p), lambda: pw.crt_add_plain(x, y, p))
        if pn > 1:
            sp, inv = switch_args(ps, pn)
            msg = pr.mod_msg if mod_msg is None else mod_msg
            compare("mod_switch", f"{tag} {tuple(x.shape)} -> {pn - 1} planes",
                    lambda: pw.mod_switch(x, sp, inv, msg),
                    lambda: pw.mod_switch_plain(x, sp, inv, msg))

    # ---- prince_l0: the step's shapes, timed ----
    pr, ps = ring(port_entry.PRINCE_PARAMS)
    n, pn, batch, mod_len = pr.ntt_len, pr.num_crt_prime, 32, pr.mod_len
    half = n // 2
    p = u32(ps)
    timings = {}

    def timed(name, tag, kern, plain, model):
        compare(name, tag, kern, plain)
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
        b_ms, b_by = bound(*model, rates)
        check_bound(f"{name} {tag}", ms, b_ms)
        log(f"[time] {name} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}), {model[0] / 1e6:.1f} MB "
            f"[{card}]")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    a, b = rand_pair((batch, pn, n)), rand_pair((batch, pn, n))
    count = a[0].numel()
    timed("zp_mul", f"prince_l0 AND x{batch}", lambda: pw.ntt_mul(a, b),
          lambda: pw.ntt_mul_plain(a, b), zp_mul_model(count, count))
    del b
    u = rand_pair((pn, n))
    timings["zp_mul"] = timed(
        "zp_mul", f"prince_l0 Barrett product x{batch} by [{pn}, {n}]",
        lambda: pw.ntt_mul(a, u), lambda: pw.ntt_mul_plain(a, u),
        zp_mul_model(count, u[0].numel()))
    del a, u
    f, c1, c2 = (residues((batch, pn, n), p) for _ in range(3))
    # coefficient x^mod_len of ciphertext 0 zero in every plane: t = 0
    for v in (f, c1, c2):
        v[0, :, mod_len] = 0
    mc = residues((pn, half), p)
    timings["barrett_combine"] = timed(
        "barrett_combine", f"prince_l0 x{batch}",
        lambda: barrett.barrett_combine(f, c1, c2, mc, p, mod_len=mod_len,
                                        n=n),
        lambda: barrett.barrett_combine_plain(f, c1, c2, mc, p,
                                              mod_len=mod_len, n=n),
        barrett_combine_model(batch * pn, pn, n, mod_len))
    del f, c1, c2
    crt_in = residues((batch, pn, half), p)
    sp, inv = switch_args(ps, pn)
    timings["mod_switch"] = timed(
        "mod_switch", f"prince_l0 x{batch} {pn} -> {pn - 1} planes",
        lambda: pw.mod_switch(crt_in, sp, inv, pr.mod_msg),
        lambda: pw.mod_switch_plain(crt_in, sp, inv, pr.mod_msg),
        mod_switch_model(batch, pn - 1, half))
    # the S-box's adds at level 1 (16 ciphertexts, 24 planes; the kernels
    # line) and the linear layers' at level 0 (64 ciphertexts, 25 planes)
    p1 = u32(ps[:pn - 1])
    x, y = residues((16, pn - 1, half), p1), residues((16, pn - 1, half), p1)
    timings["crt_add"] = timed(
        "crt_add", "prince S-box x16, 24 planes",
        lambda: pw.crt_add(x, y, p1), lambda: pw.crt_add_plain(x, y, p1),
        crt_add_model(16 * (pn - 1), pn - 1, half))
    x, y = residues((64, pn, half), p), residues((64, pn, half), p)
    timed("crt_add", "prince linear layer x64, 25 planes",
          lambda: pw.crt_add(x, y, p), lambda: pw.crt_add_plain(x, y, p),
          crt_add_model(64 * pn, pn, half))
    del x, y, crt_in
    torch.cuda.empty_cache()

    # ---- the other rings and levels ----
    for name, params in (("simple_dhs", port_entry.SIMPLE_DHS_PARAMS),
                         ("entry", port_entry.ENTRY_PARAMS)):
        rpr, rps = ring(params)
        for lead in ((), (1,), (2,)):
            check_all(f"{name} lvl 0, lead {lead}", rpr, rps, lead,
                      rpr.num_crt_prime)
    for lvl in (1, pr.depth - 2, pr.depth - 1):
        check_all(f"prince lvl {lvl} x64", pr, ps, (64,),
                  pr.num_crt_prime_lvl(lvl))
    torch.cuda.empty_cache()

    # ---- a (2, 2) rank's shapes: 16 ciphertexts, 13 / 12 planes ----
    red = residues((16, pn, half), p)
    whole = pw.mod_switch_plain(red, sp, inv, pr.mod_msg)
    dropped = red[:, pn - 1].contiguous()  # what the broadcast delivers
    kept = []
    for c0, c1_ in crt_split(pn, 2):
        k = min(c1_, pn - 1) - c0
        mine = red[:, c0:c1_].contiguous()
        args = (mine, dropped, u32(ps[c0:c0 + k] + [ps[pn - 1]]),
                inv[c0:c0 + k].contiguous(), pr.mod_msg)
        got = pw.mod_switch_dropped(*args)
        compare("mod_switch", f"rank planes {c0}..{c1_ - 1}, {k} kept, "
                "dropped plane apart", lambda: got,
                lambda: pw.mod_switch_dropped_plain(*args))
        kept.append(got)
        check_all(f"rank planes {c0}..{c1_ - 1} x16", pr, ps[c0:c1_], (16,),
                  c1_ - c0)
    compare("mod_switch", "(2, 2) ranks' kept planes together",
            lambda: torch.cat(kept, dim=1), lambda: whole)
    # a dropped plane of another dtype raises; its words are not taken as
    # uint32 (the front end views them as int32 to pass a row stride)
    for dt in (torch.int32, torch.float32):
        try:
            pw.mod_switch_dropped(args[0], dropped.view(dt), *args[2:])
        except TypeError:
            continue
        raise AssertionError(f"mod_switch_dropped took a {dt} dropped plane")
    log("[phase 2] mod_switch_dropped: an int32 or a float32 dropped plane "
        "raises TypeError")
    del red, whole, dropped, kept

    # ---- extremes ----
    P = modp.P
    words = (0, 1, P - 1, P, P + 1, (1 << 32) - 1, 1 << 32, (1 << 63) + 5,
             (1 << 64) - 2, (1 << 64) - 1)
    av = [x for x in words for _ in words]
    bv = [y for _ in words for y in words]
    av += [0] * (-len(av) % 4)
    bv += [0] * (-len(bv) % 4)

    def pair(vals):
        return (u32([v & 0xFFFFFFFF for v in vals]),
                u32([v >> 32 for v in vals]))

    ea, eb = pair(av), pair(bv)
    got = pw.ntt_mul(ea, eb)
    want = pw.ntt_mul_plain(ea, eb)
    compare("zp_mul", f"extremes ({len(words)} x {len(words)} words)",
            lambda: got, lambda: want)
    vals = modp.u64_from_pair(*got).tolist()
    if vals != [x * y % P for x, y in zip(av, bv)]:
        raise AssertionError("zp_mul extremes != Python ints")
    rpr, rps = ring(port_entry.SIMPLE_DHS_PARAMS)
    rn, rpn, rml = rpr.ntt_len, rpr.num_crt_prime, rpr.mod_len
    rp = u32(rps)
    pm1 = modp.to_u32(modp.to_i64(rp)[:, None].expand(rpn, rn) - 1)
    zero = torch.zeros_like(pm1)
    for name, (f, c1, c2) in {"p - 1, 0, 0": (pm1, zero, zero),
                              "0, p - 1, p - 1": (zero, pm1, pm1),
                              "p - 1 everywhere": (pm1, pm1, pm1),
                              "0 everywhere": (zero, zero, zero)}.items():
        mc = residues((rpn, rn // 2), rp)
        compare("barrett_combine", f"simple_dhs extremes f, c1, c2 = {name}",
                lambda: barrett.barrett_combine(f, c1, c2, mc, rp,
                                                mod_len=rml, n=rn),
                lambda: barrett.barrett_combine_plain(f, c1, c2, mc, rp,
                                                      mod_len=rml, n=rn))
    for name, x in (("p - 1", pm1), ("0", zero)):
        x = x[:, : rn // 2].contiguous()
        compare("crt_add", f"simple_dhs extremes {name} + {name}",
                lambda: pw.crt_add(x, x, rp),
                lambda: pw.crt_add_plain(x, x, rp))
    sp, inv = switch_args(rps, rpn)
    pt = rps[rpn - 1]
    centre = (pt - 1) // 2
    special = [0, 1, 2, 3, centre - 2, centre - 1, centre, centre + 1,
               centre + 2, centre + 3, pt - 3, pt - 2, pt - 1]
    crt_e = residues((3, rpn, 64), rp)
    crt_e[:, rpn - 1, : len(special)] = u32(special)
    crt_e[1, : rpn - 1] = modp.to_u32(modp.to_i64(rp[: rpn - 1])[:, None]
                                      .expand(rpn - 1, 64) - 1)
    crt_e[2, : rpn - 1] = 0
    for msg in (2, 3, 16):
        compare("mod_switch", f"simple_dhs extremes, dirty at (p_t - 1)/2 "
                f"+/- 3, mod_msg {msg}",
                lambda: pw.mod_switch(crt_e, sp, inv, msg),
                lambda: pw.mod_switch_plain(crt_e, sp, inv, msg))
    log(f"[kernel] pointwise K1-K4: bit-exact at every shape and extreme "
        f"[{card}]")
    return timings


def crt_from_raw_model(rows: int, words: int, pnum: int,
                       length: int) -> tuple:
    """(bytes, multiplies) of K5 (`crt.crt_from_raw`): the RAW words in and
    the residues out once, the primes once; at least one 32 x 32-bit
    product for each reduction, a word into a residue."""
    return ((rows * (words + pnum) * length + pnum) * 4,
            {"mad32": rows * words * pnum * length})


def zp_add_model(count: int, b_count: int) -> tuple:
    """(bytes, multiplies) of K6 (`pointwise.ntt_add`): as K1's, with no
    multiplies."""
    return (count * 16 + b_count * 8, {})


def crt_scalar_model(rows: int, pnum: int, length: int, mode: str) -> tuple:
    """(bytes, multiplies) of K7: x in and the whole output once, the
    primes once, and the plaintext polynomial ("poly", `crt_add_nx1`, a
    reduction an output word), the values of the leading rows ("rows", one
    per ciphertext) or none ("int"); the coefficient-0 modes reduce one
    word a row."""
    extra = {"poly": length, "rows": rows // pnum, "int": 0}[mode]
    red = rows * length if mode == "poly" else rows
    return ((2 * rows * length + pnum + extra) * 4, {"mad32": red})


def icrt_halves_model(count: int, words: int = 0) -> tuple:
    """(bytes, multiplies) of K8's split (`crt.icrt_split_halves`: `count`
    words in, two int32 halves out) and combine (`icrt_combine_halves`:
    two halves in, a word out, and M's `words`)."""
    return (count * 12 + words * 4, {})


def combine_ref(lo: list, hi: list, m: int, n_shards: int) -> list:
    """`crt.icrt_combine_halves_plain`'s result in Python ints, for int32
    halves lo, hi (nested lists [rows, words, L]) of any value and M = m:
    with s the rippled words and top the signed carry out of the last, its
    max(1, n_shards - 1) conditional subtracts of M (each where top > 0 or
    s >= M) leave s - k M mod 2^(32 words), k = min(floor(T / M), rounds),
    T = top 2^(32 words) + s where top > 0, else s (a subtract with top <= 0
    leaves top alone).  tests/test_torch_crt_kernels.py holds this against
    the plain version."""
    rounds, out = max(1, n_shards - 1), []
    for lr, hr in zip(lo, hi):
        words, length = len(lr), len(lr[0])
        rows = [[0] * length for _ in range(words)]
        for j in range(length):
            s = carry = 0
            for w in range(words):
                t = lr[w][j] + hr[w][j] * 65536 + carry
                s |= (t & 0xFFFFFFFF) << (32 * w)
                carry = t >> 32
            total = (carry << (32 * words)) + s if carry > 0 else s
            k = min(total // m, rounds) if m else 0
            v = (s - k * m) % (1 << (32 * words))
            for w in range(words):
                rows[w][j] = (v >> (32 * w)) & 0xFFFFFFFF
        out.append(rows)
    return out


def time_kernel(compare, rates, card, name, tag, kern, plain, model) -> dict:
    """Hold a kernel against its plain version, time both (CUDA events,
    one front-end call, medians) and the kernel against its bound (a time
    under it fails the run); returns the kernels line's numbers."""
    from cuhe_tpu_torch.probes.timing import bound, check_bound, cuda_ms

    compare(name, tag, kern, plain)
    ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
    b_ms, b_by = bound(*model, rates)
    check_bound(f"{name} {tag}", ms, b_ms)
    log(f"[time] {name} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), {model[0] / 1e6:.1f} MB "
        f"[{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def crt_ops_shapes(dev, card, compare, rand_u32, rand_pair, rates) -> dict:
    """Phase 2 for the elementwise kernels off the gate step (K5
    `crt.crt_from_raw`, K6 `pointwise.ntt_add`, K7 `crt_add_nx1` /
    `crt_add_int` / `crt_add_int_rows` / `crt_mul_int`, K8
    `crt.icrt_split_halves` / `icrt_combine_halves`), each bit for bit
    against its plain version
      * at prince_l0's shapes, timed against the plain version and the byte
        bound: the state's encryption (64 ciphertexts of 20 words to 25
        planes), the XOR of two [32, 25, 32768] pairs, the round constants
        of 64 ciphertexts and the S-box's NOT at level 1 (16 x 24 planes),
        and a (2, 2) and a (1, 4) rank's ICRT split and combine (16 / 32
        ciphertexts, 20 words, 2 / 4 shards);
      * at simple_dhs's (one ciphertext of 5 words, 7 planes; keygen's
        batch of 141 and its chunk of 64), the entry ring's, the light
        PRINCE ring's, PRINCE levels 1, 23 and 24;
      * at every word count 1..32 (25 primes), at 1, 7, 8, 9, 16, 17, 32,
        33, 40, 103, 128, 129 and 130 primes (K5 builds the constants of
        up to 128 primes a block), also with primes just below 2^32, and
        with the small primes 2, 3, 251, 65521, 65537 alone and mixed with
        primes just below 2^32 in one call, at 1, 2, 17, 20, 27, 28 and 32
        words (K5's chunk widths 32, 30, 27 and 26 bits);
      * at the extremes: RAW rows of 0, 1 and 2^32 - 1 words; pair words 0,
        1, P - 2, P - 1, 2^32 - 1, 2^32, 2^63 in every pairing (against
        Python ints too); residues p - 1 and 0 with a plaintext of 2^32 -
        1; a = 0, 1, mod_msg - 1, p + 7 and 2^32 - 1; partials M - 1 on
        1, 2, 3, 4, 5, 8 and 64 shards, and on MAX_SHARDS shards against
        Python ints; int32 halves of any value (a negative top word among
        them) against M, 1, 2^32 - 5, 0 and 2^640 - 1 on 1, 2, 5, 8 and 64
        shards, and on MAX_SHARDS against Python ints (`combine_ref`).
    K5's and K8's combine's device time per launch at prince_l0's shapes
    comes from torch.profiler over 12 launches after 3 warm-up calls.
    Returns the timings by kernel name (the kernels line)."""
    import torch
    from cuhe_tpu_torch import entry as port_entry
    from cuhe_tpu_torch import hostmath as hm
    from cuhe_tpu_torch.ops import crt, modp
    from cuhe_tpu_torch.ops import pointwise as pw
    from cuhe_tpu_torch.params import make_params
    from cuhe_tpu_torch.probes import crt_ops_time

    def u32(vals):
        return modp.to_u32(torch.tensor(vals, dtype=torch.int64, device=dev))

    def residues(shape, primes):
        return modp.to_u32(torch.remainder(
            modp.to_i64(rand_u32(shape)), modp.to_i64(primes)[:, None]))

    def timed(*args):
        return time_kernel(compare, rates, card, *args)

    def raw_check(tag, shape, ps):
        raw, p = rand_u32(shape), u32(ps)
        compare("crt_from_raw", f"{tag} {shape} -> {len(ps)} planes",
                lambda: crt.crt_from_raw(raw, p),
                lambda: crt.crt_from_raw_plain(raw, p))

    def scalar_checks(tag, x, ps, mod_msg):
        """K7's four front ends on residues x [.., pnum, L] mod ps."""
        p = u32(ps)
        s = rand_u32(x.shape[-1:])
        s[:2] = u32([0xFFFFFFFF] * 2)
        compare("crt_scalar", f"{tag} nx1 {tuple(x.shape)}",
                lambda: pw.crt_add_nx1(x, s, p),
                lambda: pw.crt_add_nx1_plain(x, s, p))
        for a in (0, 1, mod_msg - 1, max(ps) + 7, 0xFFFFFFFF):
            compare("crt_scalar", f"{tag} add_int {a} {tuple(x.shape)}",
                    lambda: pw.crt_add_int(x, a, p),
                    lambda: pw.crt_add_int_plain(x, a, p))
            compare("crt_scalar", f"{tag} mul_int {a} {tuple(x.shape)}",
                    lambda: pw.crt_mul_int(x, a, p),
                    lambda: pw.crt_mul_int_plain(x, a, p))
        if x.dim() > 2:
            c = rand_u32(x.shape[:-2])
            c.view(-1)[:1] = u32([0xFFFFFFFF])
            compare("crt_scalar", f"{tag} add_int_rows {tuple(x.shape)}",
                    lambda: pw.crt_add_int_rows(x, c, p),
                    lambda: pw.crt_add_int_rows_plain(x, c, p))

    timings = {}
    # ---- K5 at prince_l0 (the state's encryption), timed ----
    pr = make_params(*port_entry.PRINCE_PARAMS)
    n, pn, words = pr.ntt_len, pr.num_crt_prime, pr.words_coeff(0)
    half = n // 2
    ps = [int(v) for v in pr.crt_primes]
    p = u32(ps)
    raw = rand_u32((64, words, half))
    timings["crt_from_raw"] = timed(
        "crt_from_raw", f"prince_l0 state x64, {words} words -> {pn} planes",
        lambda: crt.crt_from_raw(raw, p),
        lambda: crt.crt_from_raw_plain(raw, p),
        crt_from_raw_model(64, words, pn, half))
    k5_dev = crt_ops_time.device_ms(lambda: crt.crt_from_raw(raw, p),
                                    "crt_from_raw_kernel")
    log(f"[profile] crt_from_raw prince_l0 state x64: device "
        f"{k5_dev[0]} ms per launch over {k5_dev[1]} profiled launches "
        f"(after {crt_ops_time.WARM} outside the profile) [{card}]")
    if not k5_dev[1]:
        raise AssertionError("crt_from_raw: the profiler recorded no launch")
    del raw
    # ---- K6: the XOR of two prince_l0 batches, timed ----
    a, b = rand_pair((32, pn, n)), rand_pair((32, pn, n))
    count = a[0].numel()
    timings["zp_add"] = timed(
        "zp_add", "prince_l0 XOR x32", lambda: pw.ntt_add(a, b),
        lambda: pw.ntt_add_plain(a, b), zp_add_model(count, count))
    pt = rand_pair((n,))
    compare("zp_add", "prince_l0 x32 + plaintext [n]",
            lambda: pw.ntt_add_nx1(a, pt), lambda: pw.ntt_add_plain(a, pt))
    del a, b
    # ---- K7: PRINCE's round constants at level 0 and the S-box's NOT at
    # level 1, timed ----
    x = residues((64, pn, half), p)
    rc = u32([i % 2 for i in range(64)])
    timings["crt_scalar"] = timed(
        "crt_scalar", "prince round constants x64, 25 planes",
        lambda: pw.crt_add_int_rows(x, rc, p),
        lambda: pw.crt_add_int_rows_plain(x, rc, p),
        crt_scalar_model(64 * pn, pn, half, "rows"))
    p1 = u32(ps[:pn - 1])
    x1 = residues((16, pn - 1, half), p1)
    timed("crt_scalar", "prince S-box NOT x16, 24 planes",
          lambda: pw.crt_add_int(x1, pr.mod_msg - 1, p1),
          lambda: pw.crt_add_int_plain(x1, pr.mod_msg - 1, p1),
          crt_scalar_model(16 * (pn - 1), pn - 1, half, "int"))
    del x, x1
    # ---- K8: a (2, 2) and a (1, 4) rank's ICRT split and combine, timed;
    # partials below M (the top word below M's), one row of M - 1 ----
    q, _, _ = pr.icrt_consts(0)
    mw = [int(v) for v in hm.ints_to_words([q], words)[:, 0]]
    m_words = u32(mw)
    mm1 = u32([(q - 1) >> (32 * i) & 0xFFFFFFFF for i in range(words)])

    def partials(count, shape):
        out = []
        for _ in range(count):
            v = rand_u32(shape)
            v[:, words - 1] = modp.to_u32(torch.remainder(
                modp.to_i64(v[:, words - 1]), mw[words - 1]))
            out.append(v)
        out[0][0, :, :64] = mm1[:, None]
        return out

    for shards, batch, tag in ((2, 16, "(2, 2)"), (4, 32, "(1, 4)")):
        parts = partials(shards, (batch, words, half))
        mine = parts[0]
        sp = timed("icrt_split16", f"{tag} rank x{batch}, {words} words",
                   lambda: crt.icrt_split_halves(mine),
                   lambda: crt.icrt_split_halves_plain(mine),
                   icrt_halves_model(mine.numel()))
        halves = sum(crt.icrt_split_halves(v) for v in parts)
        cb = timed("icrt_combine16", f"{tag} rank x{batch}, {words} words, "
                   f"{shards} shards", lambda: crt.icrt_combine_halves(
                       halves[0], halves[1], m_words, shards),
                   lambda: crt.icrt_combine_halves_plain(
                       halves[0], halves[1], m_words, shards),
                   icrt_halves_model(mine.numel(), words))
        cb_dev = crt_ops_time.device_ms(
            lambda: crt.icrt_combine_halves(halves[0], halves[1], m_words,
                                            shards), "icrt_combine16_kernel")
        log(f"[profile] icrt_combine16 {tag} rank x{batch}, {shards} "
            f"shards: device {cb_dev[0]} ms per launch over {cb_dev[1]} "
            f"profiled launches [{card}]")
        if not cb_dev[1]:
            raise AssertionError("icrt_combine16: the profiler recorded no "
                                 "launch")
        if shards == 2:
            timings["icrt_split16"], timings["icrt_combine16"] = sp, cb
        del parts, mine, halves
    torch.cuda.empty_cache()

    # ---- the other rings and levels ----
    for name, params in (("simple_dhs", port_entry.SIMPLE_DHS_PARAMS),
                         ("entry", port_entry.ENTRY_PARAMS),
                         ("light prince", LIGHT_PRINCE)):
        rpr = make_params(*params)
        rn, rpn, rwords = rpr.ntt_len, rpr.num_crt_prime, rpr.words_coeff(0)
        rps = [int(v) for v in rpr.crt_primes]
        extra = ((141,), (64,)) if name == "simple_dhs" else ()
        for lead in ((), (1,), (2,)) + extra:
            raw_check(f"{name} lead {lead}", lead + (rwords, rn // 2), rps)
        for lead in ((), (1,), (2,)):
            xa, xb = rand_pair(lead + (rpn, rn)), rand_pair(lead + (rpn, rn))
            ptx = rand_pair((rn,))
            compare("zp_add", f"{name} {tuple(xa[0].shape)}",
                    lambda: pw.ntt_add(xa, xb),
                    lambda: pw.ntt_add_plain(xa, xb))
            compare("zp_add", f"{name} {tuple(xa[0].shape)} + plaintext",
                    lambda: pw.ntt_add_nx1(xa, ptx),
                    lambda: pw.ntt_add_plain(xa, ptx))
            scalar_checks(f"{name} lead {lead}",
                          residues(lead + (rpn, rn // 2), u32(rps)), rps,
                          rpr.mod_msg)
    for lvl in (1, pr.depth - 2, pr.depth - 1):
        lpn, lwords = pr.num_crt_prime_lvl(lvl), pr.words_coeff(lvl)
        raw_check(f"prince lvl {lvl} x64", (64, lwords, half), ps[:lpn])
        scalar_checks(f"prince lvl {lvl}",
                      residues((64, lpn, half), u32(ps[:lpn])), ps[:lpn],
                      pr.mod_msg)
    torch.cuda.empty_cache()

    # ---- K5 at every word count, at the prime blocks' edges, with primes
    # just below 2^32, and on RAW rows of 0, 1 and 2^32 - 1 words ----
    chain, v = [], 1 << 32
    while len(chain) < 40:
        v = hm.prev_prime(v - 1)
        chain.append(v)
    for w in range(1, crt.MAX_WORDS + 1):
        raw_check(f"{w} words", (2, w, 256), ps)
    for k in (1, 7, 8, 9, 16, 17, 32, 33, 40, 103, 128, 129, 130):
        raw_check(f"{k} primes", (2, 20, 256), (ps * 6)[:k])
        raw_check(f"{k} primes below 2^32", (2, 20, 256), (chain * 4)[:k])
    # small primes (a normalising shift of up to 30 bits), and small primes
    # mixed with primes just below 2^32 in one call
    small = [2, 3, 251, 65521, 65537]
    mixed = [v for pair in zip(small, chain) for v in pair]
    for w in (1, 2, 17, 20, 27, 28, 32):
        raw_check(f"{w} words, small primes", (2, w, 256), small)
        raw_check(f"{w} words, small and large primes", (2, w, 256), mixed)
    for eps in (ps, chain[:25], small, mixed):
        ep = u32(eps)
        raw = rand_u32((4, 32, 256))
        for r, val in enumerate((0, 1, 0xFFFFFFFF)):
            raw[r] = u32([val])
        raw[3, :, :8] = u32([0xFFFFFFFF])
        compare("crt_from_raw", f"edge words, primes {eps[0]}..",
                lambda: crt.crt_from_raw(raw, ep),
                lambda: crt.crt_from_raw_plain(raw, ep))

    # ---- K6 at the extremes, against Python ints too ----
    P = modp.P
    canon = (0, 1, 2, P - 2, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63,
             (1 << 63) + 1)
    av = [x for x in canon for _ in canon]
    bv = [y for _ in canon for y in canon]
    av += [0] * (-len(av) % 4)
    bv += [0] * (-len(bv) % 4)
    ea = (u32([v & 0xFFFFFFFF for v in av]), u32([v >> 32 for v in av]))
    eb = (u32([v & 0xFFFFFFFF for v in bv]), u32([v >> 32 for v in bv]))
    got = pw.ntt_add(ea, eb)
    compare("zp_add", f"extremes ({len(canon)} x {len(canon)} words)",
            lambda: got, lambda: pw.ntt_add_plain(ea, eb))
    if modp.u64_from_pair(*got).tolist() != [(x + y) % P
                                             for x, y in zip(av, bv)]:
        raise AssertionError("zp_add extremes != Python ints")

    # ---- K7 at the extremes: x = p - 1 and 0, a plaintext of 2^32 - 1 ----
    rpr = make_params(*port_entry.SIMPLE_DHS_PARAMS)
    rps = [int(v) for v in rpr.crt_primes]
    top = u32([[v - 1] * 256 for v in rps])
    for name, xe in (("p - 1", top), ("0", torch.zeros_like(top))):
        se = u32([0xFFFFFFFF] * 256)
        compare("crt_scalar", f"extremes x = {name}, plaintext 2^32 - 1",
                lambda: pw.crt_add_nx1(xe, se, u32(rps)),
                lambda: pw.crt_add_nx1_plain(xe, se, u32(rps)))
        scalar_checks(f"extremes x = {name}", xe[None], rps, rpr.mod_msg)

    # ---- K8 at the extremes: partials M - 1 on every shard ----
    part = partials(1, (3, words, 64))[0]
    part[0] = mm1[:, None]
    part[1] = 0
    for shards in (1, 2, 3, 4, 5, 8, 64):
        h = crt.icrt_split_halves(part) * shards
        compare("icrt_combine16", f"{shards} shards of partials M - 1, 0 "
                "and random", lambda: crt.icrt_combine_halves(
                    h[0], h[1], m_words, shards),
                lambda: crt.icrt_combine_halves_plain(h[0], h[1], m_words,
                                                      shards))
    shards = crt.MAX_SHARDS
    h = crt.icrt_split_halves(part[:1, :, :4].contiguous()) * shards
    vals = modp.to_i64(crt.icrt_combine_halves(
        h[0], h[1], m_words, shards)[0].cpu()).tolist()
    want = (q - 1) * shards % q
    if any(sum(vals[i][j] << (32 * i) for i in range(words)) != want
           for j in range(4)):
        raise AssertionError(f"icrt_combine16 on {shards} shards of M - 1 != "
                             "Python ints")
    log(f"[kernel] icrt_combine16 on {shards} shards of partials M - 1: "
        "equal to Python ints")
    # int32 halves no all-reduce gives (negative, any size; a negative top),
    # against M, M = 1, M of one word under 20 words, M = 0 and 2^640 - 1
    lo = rand_u32((2, words, 256)).view(torch.int32)
    hi = rand_u32((2, words, 256)).view(torch.int32)
    lo[1] = lo[1].remainder(1 << 18) - 3
    hi[1] = hi[1].remainder(1 << 18) - 3
    hi[1, :, :4] = (1 << 31) - 1
    for mname, mv in (("M", q), ("1", 1), ("2^32 - 5", (1 << 32) - 5),
                      ("0", 0), ("2^640 - 1", (1 << (32 * words)) - 1)):
        mx = u32([(mv >> (32 * i)) & 0xFFFFFFFF for i in range(words)])
        for shards in (1, 2, 5, 8, 64):
            compare("icrt_combine16", f"int32 halves of any value, M = "
                    f"{mname}, {shards} shards",
                    lambda: crt.icrt_combine_halves(lo, hi, mx, shards),
                    lambda: crt.icrt_combine_halves_plain(lo, hi, mx, shards))
        got = crt.icrt_combine_halves(lo, hi, mx, crt.MAX_SHARDS)
        want = combine_ref(lo.cpu().tolist(), hi.cpu().tolist(), mv,
                           crt.MAX_SHARDS)
        if modp.to_i64(got).cpu().tolist() != want:
            raise AssertionError(f"icrt_combine16 on int32 halves, M = "
                                 f"{mname}, {crt.MAX_SHARDS} shards != "
                                 "Python ints")
    log(f"[kernel] icrt_combine16 on int32 halves of any value: equal to the "
        f"plain version at 1..64 shards and to Python ints at "
        f"{crt.MAX_SHARDS}")
    log(f"[kernel] K5-K8: bit-exact at every shape and extreme [{card}]")
    return timings


def modp_wrap_extremes(dev) -> None:
    """The plain versions' int64 operations whose intermediates wrap modulo
    2^64 (ops/modp.py: a word product up to (2^32 - 1)^2, bit-pattern sums
    and products), on the card, against Python ints on every pair of
    extreme inputs: words on both sides of 2^31 and at 2^32 - 1, canonical
    values at the int64 sign boundary and near P (tests/test_torch_modp.py
    holds the same cases on the CPU)."""
    import torch
    from cuhe_tpu_torch.ops import modp

    P = modp.P
    words = (0, 1, 3, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 2,
             (1 << 32) - 1)
    canon = (0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
             (1 << 63) + 1, P - (1 << 32), P - 2, P - 1)

    def t(vals):
        return torch.tensor(vals, dtype=torch.int64, device=dev)

    def bits(vals):
        return t([v - (1 << 64) if v >> 63 else v for v in vals])

    def ints(x):
        return [v % (1 << 64) for v in x.cpu().tolist()]

    a = [x for x in words for _ in words]
    b = [y for _ in words for y in words]
    lo, hi = modp.mul32(t(a), t(b))
    cases = {"mul32": (list(zip(lo.cpu().tolist(), hi.cpu().tolist())),
                       [(x * y & 0xFFFFFFFF, x * y >> 32)
                        for x, y in zip(a, b)])}
    vals = list(canon) + [P, P + 1, (1 << 64) - 2, (1 << 64) - 1]
    cases["pack64"] = (ints(modp.pack64(t([v & 0xFFFFFFFF for v in vals]),
                                        t([v >> 32 for v in vals]))),
                       [v % P for v in vals])
    a = [x for x in canon for _ in canon]
    b = [y for _ in canon for y in canon]
    cases["add_bits64"] = (ints(modp.add_bits64(bits(a), bits(b))),
                           [(x + y) % P for x, y in zip(a, b)])
    cases["sub_bits64"] = (ints(modp.sub_bits64(bits(a), bits(b))),
                           [(x - y) % P for x, y in zip(a, b)])
    cases["mul_bits64"] = (ints(modp.mul_bits64(bits(a), (
        t([y & 0xFFFFFFFF for y in b]), t([y >> 32 for y in b])))),
        [x * y % P for x, y in zip(a, b)])
    for name, (got, want) in cases.items():
        if got != want:
            raise AssertionError(f"modp.{name} on the card != Python ints at "
                                 "the extremes")
    log(f"[modp] {', '.join(cases)}: equal to Python ints at the extremes on "
        "the card")


def shard_shapes(dev, card, compare, rand_u32, rand_pair) -> None:
    """Phase 2 at the shapes only a crt-sharded step gives the kernels
    (parallel/mesh.py), at PRINCE level 0 (n = 32768, 25 primes, 40
    digits) on a rank's 16 ciphertexts: the ICRT (B3) of each rank's primes
    of `crt_split(25, 2)` and `crt_split(25, 4)` against the global M, whose
    partials, split into halves and summed mod M (`crt.icrt_split_halves`
    and `icrt_combine_halves`, K8 around the all-reduce), equal the ICRT of
    all 25; the multiply-accumulate (B4) on
    the contiguous eval-key slices of 13 and 12 planes, equal to the plain
    version's planes c0..c1-1 over the whole keys; and B1's two passes on
    each column block and row block of 2, 4 and 8 ranks (8: column blocks of
    16, narrower than the pass's 32-column tile), which together equal the
    whole transform."""
    import torch
    from cuhe_tpu_torch import entry as port_entry
    from cuhe_tpu_torch import hostmath as hm
    from cuhe_tpu_torch.ops import crt, modp, ntt
    from cuhe_tpu_torch.ops import ntt_kernels as nk
    from cuhe_tpu_torch.parallel.mesh import crt_split
    from cuhe_tpu_torch.params import make_params

    pr = make_params(*port_entry.PRINCE_PARAMS)
    n, w, batch = pr.ntt_len, pr.log_relin, 16
    pn, words, knum = (pr.num_crt_prime, pr.words_coeff(0),
                       pr.num_eval_key_lvl(0))
    q, mi, bi = pr.icrt_consts(0)

    def u32(vals):
        return modp.to_u32(torch.tensor(vals, dtype=torch.int64, device=dev))

    p_all = u32(list(pr.crt_primes[:pn]))
    bi_all = u32(list(bi))
    mi_all = u32([hm.ints_to_words([v], words)[:, 0].tolist() for v in mi])
    m_words = u32(hm.ints_to_words([q], words)[:, 0].tolist())
    ce = modp.to_u32(torch.remainder(modp.to_i64(rand_u32((batch, pn, n // 2))),
                                     modp.to_i64(p_all)[:, None]))
    ce[0, :, :64] = modp.to_u32(modp.to_i64(p_all)[:, None] - 1)  # M - 1
    whole = crt.icrt_to_raw(ce, p_all, bi_all, mi_all, m_words)
    for shards in (2, 4):
        halves = 0
        for c0, c1 in crt_split(pn, shards):
            args = (ce[:, c0:c1].contiguous(), p_all[c0:c1], bi_all[c0:c1],
                    mi_all[c0:c1].contiguous(), m_words)
            part = crt.icrt_to_raw(*args)
            compare("icrt", f"prince lvl 0 primes {c0}..{c1 - 1} of {pn}, "
                    f"global M, x{batch}", lambda: part,
                    lambda: crt.icrt_to_raw_plain(*args))
            halves = halves + crt.icrt_split_halves(part)
        compare("icrt", f"prince lvl 0, partials of {shards} shards summed "
                "mod M", lambda: crt.icrt_combine_halves(
                    halves[0], halves[1], m_words, shards), lambda: whole)
    del ce, whole, halves

    raw = rand_u32((batch, words, n // 2))
    ek = rand_pair((pr.num_eval_key, pn, n))
    dig = nk.ntt_fwd_digits(raw, n, w=w, j0=0, c=knum)
    full = nk.relin_mulacc_plain(dig, ek, j0=0, pnum=pn)
    for c0, c1 in crt_split(pn, 2):
        ek_s = tuple(v[:, c0:c1].contiguous() for v in ek)
        compare("relin_mulacc", f"prince lvl 0 eval-key planes {c0}..{c1 - 1}"
                f" ({c1 - c0} planes), {knum} digits x{batch}",
                lambda: nk.relin_mulacc(dig, ek_s, j0=0, pnum=c1 - c0),
                lambda: tuple(v[..., c0:c1, :] for v in full))
    del raw, ek, dig, full, ek_s
    torch.cuda.empty_cache()

    n1, n2 = ntt.factors(n)
    x = rand_u32((64, n // 2))
    want = nk.fwd_linear(x, n)
    for shards in (2, 4, 8):
        cols, rows = n2 // shards, n1 // shards
        xm = x.view(torch.int32).reshape(64, n1 // 2, n2)
        mid = []
        for r in range(shards):
            xb = xm[..., r * cols:(r + 1) * cols].contiguous().view(torch.uint32)
            got = nk.fwd_cols_block(xb, n, r * cols)
            compare("ntt_fwd_cols_block", f"n={n} columns {r * cols}.."
                    f"{(r + 1) * cols - 1} x64", lambda: got,
                    lambda: nk.fwd_cols_block_plain(xb, n, r * cols))
            mid.append(torch.stack([v.view(torch.int32) for v in got]))
        mid = torch.cat(mid, dim=-1)                       # [2, 64, n1, n2]
        outs = []
        for r in range(shards):
            blk = tuple(mid[i, :, r * rows:(r + 1) * rows].contiguous()
                        .view(torch.uint32) for i in (0, 1))
            got = nk.fwd_rows_block(blk, n)
            compare("ntt_fwd_rows_block", f"n={n} rows {r * rows}.."
                    f"{(r + 1) * rows - 1} x64", lambda: got,
                    lambda: nk.fwd_rows_block_plain(blk, n))
            outs.append(torch.stack([v.view(torch.int32) for v in got]))
        whole = torch.cat(outs, dim=-2).reshape(2, 64, n)
        compare("ntt_fwd", f"n={n} the blocks of {shards} shards", lambda: (
            whole[0].view(torch.uint32), whole[1].view(torch.uint32)),
            lambda: want)
    log(f"[kernel] shard shapes: B3 on prime subsets, B4 on eval-key slices, "
        f"B1's block passes bit-exact [{card}]")


def block_pass_models(n: int, count: int, shards: int) -> dict:
    """(bytes, multiplies) of B1's block passes on one rank's blocks of
    `count` transforms split over `shards` ranks (its first block of
    columns, j2 < n2/shards, whose four-step twiddles w^(k1 j2) are counted
    where they are not a power of two)."""
    import numpy as np
    from cuhe_tpu_torch.ops import ntt
    from cuhe_tpu_torch.probes.timing import ntt_products

    n1, n2 = ntt.factors(n)
    cols, rows = n2 // shards, n1 // shards
    k1, j2 = np.arange(n1)[:, None], np.arange(cols)[None, :]
    tw = int(np.count_nonzero(k1 * j2 % (n // 64)))
    return {"ntt_fwd_cols_block": (count * (n1 // 2 * cols * 4 + n1 * cols * 8),
                                   {"mul64": count * (cols * ntt_products(n1)
                                                      + tw)}),
            "ntt_fwd_rows_block": (count * rows * n2 * 16,
                                   {"mul64": count * rows
                                    * ntt_products(n2)})}


NTT_SHARDED_ROWS = 64  # transforms of phase 8 (c)


def phase8_rank(world, seed: int) -> dict:
    """One rank of phase 8 (8 ranks on cuda:0 over Gloo): (a) the entry
    step on meshes (2, 2) and (1, 3) (ranks 0-3, 0-2), (b) the PRINCE
    level-0 step at batch 32 on (2, 2) (ranks 0-3), (c) one n = 32768
    forward NTT of NTT_SHARDED_ROWS rows across 8, 4 and 2 ranks, each
    rank's block against its block of B1's transform of the same rows in
    natural order."""
    import torch
    from cuhe_tpu_torch.ops import _cuda, ntt
    from cuhe_tpu_torch.ops import ntt_kernels as nk
    from cuhe_tpu_torch.parallel import mesh as pmesh
    from cuhe_tpu_torch.parallel import run

    dev = world.device
    out = {"rank": world.rank}
    for name, nb, nc in (("entry 2x2", 2, 2), ("entry 1x3", 1, 3)):
        m = pmesh.make_mesh(nb, nc, dev, ranks=range(nb * nc))
        if m is not None:
            out[name] = run.run_step(m, "entry")
    torch.cuda.empty_cache()
    m = pmesh.make_mesh(2, 2, dev, ranks=range(4))
    if m is not None:
        out["prince 2x2"] = run.run_step(m, "prince_l0", 32, profile=True)
    del m
    torch.cuda.empty_cache()
    n = 32768
    n1, n2 = ntt.factors(n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)  # the same rows on every rank
    x = torch.randint(0, 1 << 32, (NTT_SHARDED_ROWS, n // 2), generator=gen,
                      device=dev, dtype=torch.int64)
    x = x.to(torch.int32).view(torch.uint32)
    for s in (8, 4, 2):
        m = pmesh.make_mesh(1, s, dev, ranks=range(s))
        if m is None:
            continue
        fn = pmesh.ntt_fwd_sharded(m, n)
        torch.cuda.synchronize(dev)
        _cuda.reset_launches()
        lo, hi = fn(x)
        torch.cuda.synchronize(dev)
        launches = dict(_cuda.LAUNCHES)
        rows = n1 // s
        k1 = slice(m.c * rows, (m.c + 1) * rows)
        want = [ntt.mat_to_std(v.view(torch.int32), n).reshape(
            -1, n2, n1)[..., k1] for v in nk.fwd_linear(x, n)]
        same = all(torch.equal(g.view(torch.int32), w_)
                   for g, w_ in zip((lo, hi), want))
        out[f"ntt {s}"] = {"equal": same, "launches": launches,
                           "shape": tuple(lo.shape)}
    return out


def parallel_phase(dev, card, rates, rand_u32, rand_pair, entry_out,
                   prince_out) -> tuple[dict, dict, dict]:
    """Phase 8: the sharded step and NTT (parallel/mesh.py) on 8 ranks that
    share cuda:0 over Gloo (collectives carry CUDA tensors through the
    host: no time here is a claim about interconnects), the gathered
    outputs held bit for bit against phases 3 and 4; then NCCL, one rank per
    card, where there are two cards or more.  First, in this process alone
    on the card, the B kernels' times at a (2, 2) rank's shapes and the
    block passes' at (c)'s.  Returns (the block passes' timings, their
    launches in (c), summed over the ranks, and K8's launches in (b)'s
    first step, summed over its ranks)."""
    import torch
    from cuhe_tpu_torch import entry as port_entry
    from cuhe_tpu_torch import hostmath as hm
    from cuhe_tpu_torch.ops import crt, modp, ntt
    from cuhe_tpu_torch.ops import ntt_kernels as nk
    from cuhe_tpu_torch.parallel import mesh as pmesh
    from cuhe_tpu_torch.parallel import run
    from cuhe_tpu_torch.params import make_params
    from cuhe_tpu_torch.probes.timing import bound, check_bound, cuda_ms

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    log(f"[parallel] torch.cuda.device_count() = {count}")

    # the B kernels at a (2, 2) rank's shapes of the PRINCE level-0 step:
    # 16 ciphertexts, 13 or 12 planes, the ICRT of those primes against
    # the global M, the multiply-accumulate on that slice of the keys
    pr = make_params(*port_entry.PRINCE_PARAMS)
    n, w, knum = pr.ntt_len, pr.log_relin, pr.num_eval_key_lvl(0)
    words = pr.words_coeff(0)
    q, mi, bi = pr.icrt_consts(0)
    batch = 16

    def u32(vals):
        return modp.to_u32(torch.tensor(vals, dtype=torch.int64, device=dev))

    m_words = u32(hm.ints_to_words([q], words)[:, 0].tolist())
    for c0, c1 in pmesh.crt_split(pr.num_crt_prime, 2):
        k = c1 - c0
        p_k = u32(list(pr.crt_primes[c0:c1]))
        icrt_args = (p_k, u32(list(bi[c0:c1])),
                     u32([hm.ints_to_words([v], words)[:, 0].tolist()
                          for v in mi[c0:c1]]), m_words)
        x = rand_u32((batch, k, n // 2))
        xp = rand_pair((batch, k, n))
        ce = modp.to_u32(torch.remainder(modp.to_i64(x),
                                         modp.to_i64(p_k)[:, None]))
        raw = rand_u32((batch, words, n // 2))
        ek = rand_pair((knum, k, n))
        dig = nk.ntt_fwd_digits(raw, n, w=w, j0=0, c=knum)
        span = min(words, (w * knum - 1) // 32 + 2)
        models = step_kernel_models(batch, k, n, words, knum, span, mi[c0:c1])
        cases = {
            "ntt_fwd": (lambda: nk.fwd_linear(x, n),
                        lambda: nk.fwd_linear_plain(x, n)),
            "ntt_inv_modcrt": (lambda: nk.inv_linear(xp, n, p_k),
                               lambda: nk.inv_linear_plain(xp, n, p_k)),
            "icrt": (lambda: crt.icrt_to_raw(ce, *icrt_args),
                     lambda: crt.icrt_to_raw_plain(ce, *icrt_args)),
            "ntt_fwd_digits": (
                lambda: nk.ntt_fwd_digits(raw, n, w=w, j0=0, c=knum),
                lambda: nk.ntt_fwd_digits_plain(raw, n, w=w, j0=0, c=knum)),
            "relin_mulacc": (
                lambda: nk.relin_mulacc(dig, ek, j0=0, pnum=k),
                lambda: nk.relin_mulacc_plain(dig, ek, j0=0, pnum=k)),
        }
        for name, (kern, plain) in cases.items():
            ms, plain_ms = cuda_ms(kern, 10), cuda_ms(plain, 2)
            b_ms, b_by = bound(*models[name], rates)
            check_bound(f"{name} shard {k} planes", ms, b_ms)
            log(f"[time] {name} prince_l0 rank block x{batch}, planes "
                f"{c0}..{c1 - 1}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
        del x, xp, ce, raw, ek, dig
        torch.cuda.empty_cache()

    # B1's block passes at the shapes of (c), one rank's first blocks; the
    # kernels line keeps the 2-rank shapes' times
    timings = {}
    n1, n2 = ntt.factors(n)
    for shards in (8, 4, 2):
        cols, rows = n2 // shards, n1 // shards
        xb = rand_u32((NTT_SHARDED_ROWS, n1 // 2, cols))
        mid = rand_pair((NTT_SHARDED_ROWS, rows, n2))
        models = block_pass_models(n, NTT_SHARDED_ROWS, shards)
        for name, kern, plain in (
                ("ntt_fwd_cols_block", lambda: nk.fwd_cols_block(xb, n, 0),
                 lambda: nk.fwd_cols_block_plain(xb, n, 0)),
                ("ntt_fwd_rows_block", lambda: nk.fwd_rows_block(mid, n),
                 lambda: nk.fwd_rows_block_plain(mid, n))):
            ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
            b_ms, b_by = bound(*models[name], rates)
            check_bound(f"{name} {shards} shards", ms, b_ms)
            timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by)
            log(f"[time] {name} n={n} over {shards} ranks x"
                f"{NTT_SHARDED_ROWS}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
    torch.cuda.empty_cache()

    # (a)-(c): 8 ranks on this card over Gloo, started once
    t1 = time.perf_counter()
    ranks = run.spawn(2, 4, phase8_rank, 2026, backend="gloo", device="cuda",
                      timeout=600)
    log(f"[parallel] 8 ranks over Gloo on cuda:0 in "
        f"{time.perf_counter() - t1:.1f} s")
    # every rank of (a) and (b) has n_crt > 1: each runs K8 around the ICRT's
    # all-reduce
    b_kernels = ("ntt_fwd", "ntt_inv_modcrt", "icrt", "ntt_fwd_digits",
                 "relin_mulacc", "zp_mul", "barrett_combine", "icrt_split16",
                 "icrt_combine16")
    k8_launches = {}
    for name, want, n_ranks in (("entry 2x2", entry_out, 4),
                                ("entry 1x3", entry_out, 3),
                                ("prince 2x2", prince_out, 4)):
        res = [r[name] for r in ranks[:n_ranks]]
        got = res[0]["output"]
        if got.shape != tuple(want.shape) or not (got == want.numpy()).all():
            raise AssertionError(f"{name}: gathered output != the unsharded "
                                 "step's on the card")
        if len({r["sha256"] for r in res}) != 1:
            raise AssertionError(f"{name}: the ranks gathered different "
                                 "outputs")
        for r in res:
            missing = [k for k in b_kernels if r["launches"].get(k, 0) < 1]
            if missing:
                raise AssertionError(f"{name} rank {r['rank']}: {missing} "
                                     "not launched")
            if r["plain_calls"]:
                raise AssertionError(f"{name} rank {r['rank']}: plain "
                                     f"versions called on the card: "
                                     f"{r['plain_calls']}")
            log(run.report(r, f"parallel {name} gloo, {card}"))
            if name == "prince 2x2":
                for k in ("icrt_split16", "icrt_combine16"):
                    k8_launches[k] = (k8_launches.get(k, 0)
                                      + r["launches"][k])
                # K8's device time in the profiled step
                for k, ms, cnt in r["profile"]["port_rows"]:
                    if "icrt_split16" in k or "icrt_combine16" in k:
                        log(f"[profile] rank {r['rank']} port {ms:9.3f} ms "
                            f" x{cnt:<3d} {k[:60]}")
        # the last rank of (1, 3) keeps no plane of the switch
        if not any(r["launches"].get("mod_switch", 0) for r in res):
            raise AssertionError(f"{name}: mod_switch launched on no rank")
        log(f"[parallel] {name}: gathered {got.shape} == the unsharded card "
            f"output bit for bit, every B kernel, zp_mul, barrett_combine and "
            f"K8 launched on every rank, no plain version")
    block_launches = {}
    for s in (8, 4, 2):
        for r in ranks[:s]:
            res = r[f"ntt {s}"]
            if not res["equal"]:
                raise AssertionError(f"ntt_fwd_sharded over {s} ranks: rank "
                                     f"{r['rank']}'s block != B1's")
            for k in ("ntt_fwd_cols_block", "ntt_fwd_rows_block"):
                if res["launches"].get(k, 0) < 1:
                    raise AssertionError(f"ntt over {s}: {k} not launched on "
                                         f"rank {r['rank']}")
                block_launches[k] = block_launches.get(k, 0) + res["launches"][k]
        log(f"[parallel] ntt_fwd_sharded n={n} x{NTT_SHARDED_ROWS} over {s} "
            f"ranks: every block == B1's transform in natural order; "
            f"launches {[r[f'ntt {s}']['launches'] for r in ranks[:s]]}")

    # (d): NCCL, one rank per card
    if count >= 2:
        t1 = time.perf_counter()
        res = run.spawn(1, count, run.run_step, "prince_l0", 32, True,
                        backend="nccl", device="cuda", timeout=600)
        if not res[0]["equal"]:
            raise AssertionError("nccl: gathered output != the unsharded step")
        for r in res:
            if r["plain_calls"]:
                raise AssertionError(f"nccl rank {r['rank']}: plain versions "
                                     f"called on the card: "
                                     f"{r['plain_calls']}")
            log(run.report(r, f"parallel nccl 1x{count}, {card}"))
        log(f"nccl: 1x{count} bit-equal to the unsharded step in "
            f"{time.perf_counter() - t1:.1f} s [{card}]")
    else:
        log("nccl: skipped: one device")
    log(f"[parallel] phase 8 in {time.perf_counter() - t0:.1f} s")
    return timings, block_launches, k8_launches


class CallTimer:
    """Wall time (device synchronised) of calls to some functions, by name:
    each (owner, attribute) is wrapped while the timer is open."""

    def __init__(self, targets):
        self.targets = targets
        self.seconds = {}

    def __enter__(self):
        import functools

        import torch

        self.saved = []
        for owner, attr in self.targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            key = f"{getattr(owner, '__name__', owner)}.{attr}"

            @functools.wraps(fn)
            def timed(*a, _fn=fn, _key=key, **k):
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                self.seconds[_key] = (self.seconds.get(_key, 0.0)
                                      + time.perf_counter() - t0)
                return out
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)
        return False


def dhs_scheme(dev, card) -> dict:
    """Phase 6, the DHS scheme on the card.  (a) The light configuration
    CuDHS(3, 2, 16, 50, 25, 8191, seed=7) on the card and on the CPU: equal
    key strings, ciphertexts and gate outputs, decoding to the plaintext
    bits.  (b) The reference's shipped CuDHS(5, 2, 1, 61, 20, 8191) on the
    card: timed keygen, encrypt, XOR / NOT / AND -> relin -> modSwitch
    decrypting right, a second scheme from the private key string
    decrypting the same ciphertext, the launch counts of the encryption,
    of the three gates together and of one XOR, NOT and AND gate each (the
    encryption must launch K5, the XOR K6, the NOT K7, the AND each B
    kernel and K1-K3; no plain elementwise version may run on the card in
    any of them), each gate's time, device busy time, PyTorch-kernel share
    and idle share.  Returns the launches of K5 in the encryption and of
    K6 in one XOR (the kernels line)."""
    import numpy as np
    import torch
    from cuhe_tpu_torch import dhs as port_dhs
    from cuhe_tpu_torch import entry as port_entry
    from cuhe_tpu_torch import poly
    from cuhe_tpu_torch.ops import _cuda
    from cuhe_tpu_torch.probes.timing import cuda_ms

    def gates(scheme, cts):
        """XOR (NTT), NOT (CRT) and AND -> relin -> modSwitch of the first
        two ciphertexts: (their host coefficients, the AND's level)."""
        ctx = scheme.ctx
        x, y = (poly.to_ntt(ctx, poly.ctxt_from_ints(c, 0)) for c in cts[:2])
        xor = poly.to_ints(ctx, poly.c_xor(ctx, x, y))
        cnot = poly.to_ints(ctx, poly.c_not(
            ctx, poly.to_crt(ctx, poly.ctxt_from_ints(cts[0], 0))))
        z = poly.mod_switch(ctx, poly.relin(ctx, poly.c_and(ctx, x, y)))
        return {"xor": xor, "not": cnot, "and": poly.to_ints(ctx, z)}, z.level

    def check_decrypt(scheme, outs, msgs, tag):
        dec = scheme.batcher.decode
        want = {"xor": [a ^ b for a, b in zip(msgs[0], msgs[1])],
                "not": [1 - a for a in msgs[0]],
                "and": [a & b for a, b in zip(msgs[0], msgs[1])]}
        lvl = {"xor": 0, "not": 0, "and": 1}
        for g, v in outs.items():
            if dec(scheme.decrypt(v, lvl[g])) != want[g]:
                raise AssertionError(f"{tag}: {g} decrypts wrong")
        log(f"[dhs] {tag}: XOR, NOT and AND -> relin -> modSwitch decrypt "
            f"and decode right ({len(msgs[0])} slots)")

    # ---- (a) light configuration: card == CPU ----
    light = port_entry.ENTRY_PARAMS
    t0 = time.perf_counter()
    gpu = port_dhs.CuDHS(*light, seed=7, device=dev)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = port_dhs.CuDHS(*light, seed=7, device="cpu")
    t_cpu = time.perf_counter() - t0
    if gpu.get_private_key() != cpu.get_private_key():
        raise AssertionError("light DHS: card and CPU private keys differ")
    rng = np.random.default_rng(7)
    msgs = [[int(b) for b in rng.integers(0, 2, gpu.num_slot)]
            for _ in range(2)]
    cts = [gpu.encrypt(gpu.batcher.encode(m), 0) for m in msgs]
    if cts != [cpu.encrypt(cpu.batcher.encode(m), 0) for m in msgs]:
        raise AssertionError("light DHS: card and CPU ciphertexts differ")
    outs, lvl = gates(gpu, cts)
    if lvl != 1 or outs != gates(cpu, cts)[0]:
        raise AssertionError("light DHS: card and CPU gate outputs differ")
    check_decrypt(gpu, outs, msgs, "light CuDHS(3,2,16,50,25,8191) card")
    log(f"[dhs] light: keys, ciphertexts and XOR / NOT / AND outputs on the "
        f"card == on the CPU; keygen {t_gpu:.2f} s card, {t_cpu:.2f} s CPU "
        f"[{card}]")
    del gpu, cpu

    # ---- (b) the shipped simple_DHS configuration, on the card ----
    timer = CallTimer([(port_dhs, "Context"),
                       (port_dhs.CuDHS, "_find_inverse"),
                       (poly, "poly_mul_one_to_many"),
                       (port_dhs.CuDHS, "init_relinearization"),
                       (port_dhs.CuDHS, "_setup_batcher")])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timer:
        dhs = port_entry.simple_dhs(seed=2026, device=dev)
        torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    pr = dhs.params
    ek = dhs.ctx.ek_ntt
    shape = (pr.num_eval_key, pr.num_crt_prime, pr.ntt_len)
    if tuple(ek[0].shape) != shape:
        raise AssertionError(f"simple_dhs: eval keys {tuple(ek[0].shape)}, "
                             f"expected {shape}")
    phases = ", ".join(f"{k} {v:.2f} s" for k, v in timer.seconds.items())
    log(f"[dhs] simple_dhs CuDHS{port_entry.SIMPLE_DHS_PARAMS}: keygen "
        f"(context, keys, {shape[0]} eval keys [{shape[1]}, {shape[2]}] in "
        f"the NTT domain, batcher, {dhs.num_slot} slots) "
        f"{keygen_s:.2f} s ({phases}); eval keys "
        f"{2 * ek[0].numel() * 4 / 1e6:.1f} MB; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    rng = np.random.default_rng(2026)
    msgs = [[int(b) for b in rng.integers(0, 2, dhs.num_slot)]
            for _ in range(2)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    cts = [dhs.encrypt(dhs.batcher.encode(m), 0) for m in msgs]
    torch.cuda.synchronize()
    enc_s = (time.perf_counter() - t0) / len(cts)
    torch.cuda.synchronize()
    path = {"encrypt": (dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS))}
    _cuda.reset_launches()
    outs, lvl = gates(dhs, cts)
    torch.cuda.synchronize()
    path["gates"] = (dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS))
    if lvl != 1:
        raise AssertionError(f"simple_dhs: AND gate ended at level {lvl}")
    check_decrypt(dhs, outs, msgs, "simple_dhs CuDHS(5,2,1,61,20,8191)")
    t0 = time.perf_counter()
    dec = dhs.batcher.decode(dhs.decrypt(outs["and"], 1))
    dec_s = time.perf_counter() - t0
    # a second scheme from the private key string decrypts the same gate
    t0 = time.perf_counter()
    key = dhs.get_private_key()
    dhs2 = port_dhs.CuDHS(key_string=key, device=dev)
    load_s = time.perf_counter() - t0
    if dhs2.batcher.decode(dhs2.decrypt(outs["and"], 1)) != dec or             dhs2.get_private_key() != key:
        raise AssertionError("simple_dhs: the key-string scheme decrypts "
                             "otherwise")
    log(f"[dhs] simple_dhs: encrypt {enc_s:.3f} s a message, decrypt "
        f"{dec_s:.3f} s (host included); a CuDHS from the private key "
        f"string ({len(key) / 1e6:.1f} MB) in {load_s:.2f} s decrypts the "
        f"AND gate alike [{card}]")
    del dhs2

    # one XOR, NOT and AND -> relin -> modSwitch: launches, time, profile
    ctx = dhs.ctx
    x, y = (poly.to_ntt(ctx, poly.ctxt_from_ints(c, 0)) for c in cts)
    xc = poly.to_crt(ctx, poly.ctxt_from_ints(cts[0], 0))

    def and_gate():
        return poly.mod_switch(ctx, poly.relin(ctx, poly.c_and(ctx, x, y)))

    want = and_gate()
    for name, run in (("xor", lambda: poly.c_xor(ctx, x, y)),
                      ("not", lambda: poly.c_not(ctx, xc)),
                      ("and", and_gate)):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        got = run()
        torch.cuda.synchronize()
        path[name] = (dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS))
    # the kernels each path must launch: K5 in the encryption (RAW -> CRT),
    # K6 in the NTT-domain XOR, K7 in the NOT, the B kernels and K1-K3 in
    # the AND gate
    needs = {"encrypt": ("crt_from_raw",), "gates": ("crt_from_raw",
                                                     "zp_add", "crt_scalar"),
             "xor": ("zp_add",), "not": ("crt_scalar",),
             "and": ("ntt_fwd", "ntt_inv_modcrt", "icrt", "ntt_fwd_digits",
                     "relin_mulacc", *POINTWISE_STEP_LAUNCHES)}
    for name, (launches, plain) in path.items():
        log(f"[dhs] launches in simple_dhs {name}: {launches}")
        if plain:
            raise AssertionError(f"simple_dhs {name}: plain versions called "
                                 f"on the card: {plain}")
        for k in needs[name]:
            if launches.get(k, 0) < 1:
                raise AssertionError(f"simple_dhs {name}: {k} not launched")
    if not torch.equal(got.data.view(torch.int32), want.data.view(torch.int32)):
        raise AssertionError("simple_dhs AND gate: two runs differ")
    gate_ms = {
        "xor (NTT)": cuda_ms(lambda: poly.c_xor(ctx, x, y), 20),
        "not (CRT)": cuda_ms(lambda: poly.c_not(ctx, xc), 20),
        "and -> relin -> modSwitch": cuda_ms(and_gate, 20),
    }
    log("[dhs] simple_dhs gate times (CUDA events, median of 20, one "
        "ciphertext): " + ", ".join(f"{k} {v:.4f} ms"
                                    for k, v in gate_ms.items())
        + f" [{card}]")
    profile_step(lambda: poly.c_xor(ctx, x, y), gate_ms["xor (NTT)"], card,
                 "simple_dhs XOR (NTT domain), batch 1", reps=20)
    profile_step(lambda: poly.c_not(ctx, xc), gate_ms["not (CRT)"], card,
                 "simple_dhs NOT (CRT domain), batch 1", reps=20)
    profile_step(and_gate, gate_ms["and -> relin -> modSwitch"], card,
                 "one simple_dhs AND -> relin -> modSwitch, batch 1")
    # one encryption (host sampling and big-int packing included), for
    # K5's device time in it
    enc = dhs.batcher.encode(msgs[0])
    profile_step(lambda: dhs.encrypt(enc, 0), enc_s * 1e3, card,
                 "one simple_dhs encryption (host included)")
    return {"crt_from_raw": path["encrypt"][0]["crt_from_raw"],
            "zp_add": path["xor"][0]["zp_add"]}


LIGHT_PRINCE = (5, 2, 16, 50, 25, 8191)  # tests/test_prince.py's light ring
KAT_BITS = ([0] * 64, [1] * 64, [0] * 64)  # A, B, C of Prince.cu:68-96


def prince_light(dev, card) -> None:
    """Phase 7 (a), the light ring CuDHS(5, 2, 16, 50, 25, 8191, seed=13):
    the same seed gives the card and the CPU the same key strings and
    ciphertexts, and S-box layer 1 the same state, bit for bit, decrypting
    to the round-0 vector; a straight run of two layers on the card, saved
    after layer 1, and a Prince of the same seed resumed from that file give
    the same layer 2, which decrypts to the round-1 vector."""
    import tempfile

    import torch
    from cuhe_tpu_torch.dhs import CuDHS
    from cuhe_tpu_torch.models.prince import Prince
    from cuhe_tpu_torch.utils import checkpoint as ckpt

    def prince(device):
        return Prince(dhs=CuDHS(*LIGHT_PRINCE, seed=13, device=device))

    def same(a, b):
        return a.shape == b.shape and torch.equal(
            a.cpu().view(torch.int32), b.cpu().view(torch.int32))

    def expect(p, state, lvl, rd, tag):
        bits = "".join(map(str, p.decrypt_state(state, lvl)))
        if bits != Prince.EXPECTED_ROUNDS[rd]:
            raise AssertionError(f"light PRINCE {tag}: round {rd} decrypts "
                                 f"to {bits}")

    t0 = time.perf_counter()
    cpu = prince("cpu")
    want = cpu.encrypt_blocks(*KAT_BITS, max_rounds=1)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpu = prince(dev)
    if gpu.dhs.get_private_key() != cpu.dhs.get_private_key():
        raise AssertionError("light PRINCE: card and CPU key strings differ")
    layers = {}
    build = Path(__file__).resolve().parent / "cuhe_tpu_torch" / "_build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = str(Path(tmp) / "layer01.npz")

        def on_layer(done, state, lvl):
            layers[done] = (state, lvl)
            if done == 1:
                ckpt.save_state(path, state, lvl, done=done)

        got = gpu.encrypt_blocks(*KAT_BITS, max_rounds=2, on_layer=on_layer)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        if not same(layers[1][0], want) or layers[1][1] != cpu.level:
            raise AssertionError("light PRINCE: card and CPU layer 1 differ")
        expect(gpu, *layers[1], 0, "card")
        expect(gpu, got, gpu.level, 1, "card")
        state, lvl = ckpt.load_state(path, device=dev)
        again = prince(dev).encrypt_blocks(
            *KAT_BITS, max_rounds=2, resume=(state, lvl, 1))
    if not same(again, got):
        raise AssertionError("light PRINCE: resumed layer 2 != straight run")
    log(f"[prince] light CuDHS{LIGHT_PRINCE}: keys, ciphertexts and S-box "
        f"layer 1 on the card == on the CPU ({cpu_s:.1f} s with keygen on "
        f"the CPU, {gpu_s:.1f} s for 2 layers with keygen on the card); "
        f"rounds 0 and 1 decrypt right; saved after layer 1 and resumed, "
        f"layer 2 is bit-equal [{card}]")


def prince_full(dev, card) -> dict:
    """Phase 7 (b), the PRINCE ring CuDHS(25, 2, 16, 25, 25, 21845) on the
    card: keygen timed by phase, with its peak memory; then the known-answer
    circuit, all 12 S-box layers, each decrypted and held against the
    published vector where there is one (rounds 0-3) and the final state
    against EXPECTED_FINAL.  One line per layer: its levels, time, each
    kernel's launches (every B kernel, K1-K4 and K7 must launch in every
    layer, and no plain elementwise version may run on the card), peak
    memory and decrypt time; then the circuit's totals.  Returns the
    launches summed over the 12 layers."""
    import torch
    from cuhe_tpu_torch import dhs as port_dhs
    from cuhe_tpu_torch import hostlib, poly
    from cuhe_tpu_torch.models.prince import Prince
    from cuhe_tpu_torch.ops import _cuda

    timer = CallTimer([(port_dhs, "Context"), (hostlib, "poly_inv_batch"),
                       (port_dhs.CuDHS, "_find_inverse"),
                       (poly, "poly_mul_ints"), (port_dhs.CuDHS, "_gen_ek"),
                       (port_dhs.CuDHS, "init_relinearization"),
                       (port_dhs.CuDHS, "_setup_batcher")])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timer:
        p = Prince(seed=7, device=dev)
        torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    sec = timer.seconds
    phases = {
        "context": sec["cuhe_tpu_torch.dhs.Context"],
        "native XGCD": sec["cuhe_tpu_torch.hostlib.poly_inv_batch"],
        "CRT combine of f^-1": (sec["CuDHS._find_inverse"]
                                - sec["cuhe_tpu_torch.hostlib.poly_inv_batch"]),
        "pk product": sec["cuhe_tpu_torch.poly.poly_mul_ints"],
        "eval keys": (sec["CuDHS._gen_ek"]
                      - sec["CuDHS.init_relinearization"]),
        "init_relinearization": sec["CuDHS.init_relinearization"],
        "batcher": sec["CuDHS._setup_batcher"],
    }
    pr = p.ctx.params
    ek = p.ctx.ek_ntt
    log(f"[prince] keygen CuDHS(25,2,16,25,25,21845) {keygen_s:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items())
        + f"; {pr.num_eval_key} eval keys {2 * ek[0].numel() * 4 / 1e6:.1f} "
        f"MB; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{card}]")

    sbox = p.sbox_layer
    layer = {}
    first = {}

    def timed_sbox(state, inverse=False):
        lvl = p.level
        first.setdefault("state", state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = sbox(state, inverse=inverse)
        torch.cuda.synchronize()
        layer.update(ms=(time.perf_counter() - t) * 1e3, lvl=lvl,
                     inverse=inverse, launches=dict(_cuda.LAUNCHES),
                     plain=dict(_cuda.PLAIN_CALLS),
                     peak=torch.cuda.max_memory_allocated())
        return out

    p.sbox_layer = timed_sbox
    rows = []

    def check(rd, state, lvl):
        t = time.perf_counter()
        bits = "".join(map(str, p.decrypt_state(state, lvl)))
        dec_s = time.perf_counter() - t
        want = Prince.EXPECTED_ROUNDS.get(rd)
        verdict = "no published vector" if want is None else "OK"
        launches = layer["launches"]
        log(f"[prince] layer {len(rows) + 1} (round {rd}, "
            f"{'inverse' if layer['inverse'] else 'forward'}): level "
            f"{layer['lvl']} -> {lvl}, {pr.num_crt_prime_lvl(layer['lvl'])} "
            f"-> {pr.num_crt_prime_lvl(lvl)} primes, {layer['ms']:.1f} ms, "
            f"launches {launches}, peak {layer['peak'] / 2**30:.2f} GiB, "
            f"decrypt {dec_s:.2f} s, {bits} {verdict} [{card}]")
        if want is not None and bits != want:
            raise AssertionError(f"PRINCE round {rd}: {bits} != {want}")
        for name in ("ntt_fwd", "ntt_inv_modcrt", "icrt", "ntt_fwd_digits",
                     "relin_mulacc", *POINTWISE_STEP_LAUNCHES, "crt_add",
                     "crt_scalar"):
            if launches.get(name, 0) < 1:
                raise AssertionError(f"PRINCE layer {len(rows) + 1}: {name} "
                                     f"not launched")
        if layer["plain"]:
            raise AssertionError(f"PRINCE layer {len(rows) + 1}: plain "
                                 f"versions called on the card: "
                                 f"{layer['plain']}")
        rows.append((layer["ms"], dec_s, launches, layer["peak"]))

    t0 = time.perf_counter()
    state = p.run_known_answer(check=check)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    t = time.perf_counter()
    bits = "".join(map(str, p.decrypt_state(state, p.level)))
    final_dec_s = time.perf_counter() - t
    if len(rows) != 12 or bits != Prince.EXPECTED_FINAL:
        raise AssertionError(f"PRINCE final state, {len(rows)} layers: {bits} "
                             f"!= {Prince.EXPECTED_FINAL}")
    launches = {}
    for _, _, row, _ in rows:
        for k, v in row.items():
            launches[k] = launches.get(k, 0) + v
    layers_ms = sum(r[0] for r in rows)
    decrypt_s = sum(r[1] for r in rows)
    log(f"[prince] known answer: 12 S-box layers decrypt to the final "
        f"vector {bits} (EXPECTED_FINAL, level {p.level}) in {total_s:.2f} s "
        f"(S-box layers {layers_ms / 1e3:.3f} s, per-layer decrypts "
        f"{decrypt_s:.2f} s, the rest -- encryption of message and keys, "
        f"linear layers -- {total_s - layers_ms / 1e3 - decrypt_s:.2f} s); "
        f"final decrypt {final_dec_s:.2f} s; launches in the 12 layers "
        f"{launches}; peak of a layer "
        f"{max(r[3] for r in rows) / 2**30:.2f} GiB [{card}]")
    # where the time of the costliest layer (level 0, 25 primes) goes
    profile_step(lambda: p._sbox(first["state"], 0, False), rows[0][0], card,
                 "S-box layer 1 (level 0 -> 2)")
    return launches


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
    from cuhe_tpu_torch.probes import crt_ops_time
    from cuhe_tpu_torch.probes import suite as probe_suite
    from cuhe_tpu_torch.probes.timing import (bound, check_bound, cuda_ms,
                                              gpu_line)
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
    # K5 and K8's combine at PRINCE level 0's 20 words: registers, stack
    # and local bytes (spills) per thread, resident blocks per SM, and K5's
    # instructions per (word, prime) of its prime loop
    words0 = make_params(*port_entry.PRINCE_PARAMS).words_coeff(0)
    for name, ev in crt_ops_time.evidence(so, sass, words0).items():
        loop = ev.get("sass_loop")
        log(f"[sass] {name} ({ev['function']}): {ev['reg']} registers, "
            f"stack {ev['stack']} B, local {ev['local']} B, shared "
            f"{ev['shared']} B; {ev['blocks_per_sm']} resident blocks of 256 "
            f"threads per SM (compute capability 9.0's rules)"
            + (f"; prime loop {loop['instructions']} instructions for "
               f"{loop['word_prime_pairs']} (word, prime) pairs, "
               f"{loop['per_word_prime']:.2f} per pair, "
               f"{loop['wide_multiplies']} wide multiplies; "
               f"{loop['opcodes']}" if loop else ""))
    # P1's dot kernels: wgmma (HGMMA / IGMMA) in the consumers' loop and TMA
    # loads (UTMALDG) in the producer's; raises if either is missing
    log(f"[sass] P1 dot kernels' loops: {probe_calib.dot_sass_counts(sass)}")
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
    modp_wrap_extremes(dev)
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
        model = step_kernel_models(batch, pn, n, words, c, span, mi)
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
        b_ms, b_by = bound(*mulacc_model(batch, pn, n, c1, True), rates)
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

    dhs_shapes(dev, card, compare, rand_u32, rand_pair)
    prince_shapes(dev, card, compare, rand_u32, rand_pair)
    shard_shapes(dev, card, compare, rand_u32, rand_pair)
    pw_timings = pointwise_shapes(dev, card, compare, rand_u32, rand_pair,
                                  rates)
    pw_timings.update(crt_ops_shapes(dev, card, compare, rand_u32, rand_pair,
                                     rates))

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
    entry_out = got.cpu()  # phase 8 gathers the sharded step's to it
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
    for name, want_n in POINTWISE_STEP_LAUNCHES.items():
        if launches.get(name, 0) != want_n:
            raise AssertionError(f"prince step: {name} launched "
                                 f"{launches.get(name, 0)} times, expected "
                                 f"{want_n}")
    if tuple(out.shape) != (32, 24, 16384) or not same(out[:2].contiguous(), got2):
        raise AssertionError("prince: batch-32 rows 0..1 != the 2-ciphertext run")
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(*args), 5)
    peak = torch.cuda.max_memory_allocated()
    if _cuda.PLAIN_CALLS:
        raise AssertionError(f"prince step: plain versions called on the "
                             f"card: {dict(_cuda.PLAIN_CALLS)}")
    log(f"[prince] step {step_ms:.3f} ms per 32 ciphertexts, "
        f"{step_ms / 32:.4f} ms per ciphertext, peak memory {peak / 2**30:.2f} GiB "
        f"[{card}]")

    profile_step(lambda: step(*args), step_ms, card, "one batch-32 step")
    prince_out = out.cpu()
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

    # ---- 6. the DHS scheme ------------------------------------------------
    t0 = time.perf_counter()
    dhs_launches = dhs_scheme(dev, card)
    log(f"[dhs] phase 6 in {time.perf_counter() - t0:.1f} s")

    # ---- 7. homomorphic PRINCE ----------------------------------------------
    t0 = time.perf_counter()
    prince_light(dev, card)
    prince_launches = prince_full(dev, card)
    log(f"[prince] phase 7 in {time.perf_counter() - t0:.1f} s")

    # ---- 8. multi-device: the sharded step and NTT --------------------------
    block_timings, block_launches, k8_launches = parallel_phase(
        dev, card, rates, rand_u32, rand_pair, entry_out, prince_out)

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
    # the elementwise kernels: launches in phase 4's step (K1-K3), in
    # phase 7's 12 S-box layers (K4, K7), in phase 6's encryption (K5) and
    # XOR gate (K6), and on the (2, 2) ranks of phase 8 (b)'s step (K8)
    path_launches = {k: launches.get(k, 0) for k in POINTWISE_STEP_LAUNCHES}
    for k in ("crt_add", "crt_scalar"):
        path_launches[k] = prince_launches.get(k, 0)
    path_launches.update(dhs_launches)
    path_launches.update(k8_launches)
    pw_src, crt_src = ("cuhe_tpu_torch/csrc/pointwise.cu",
                       "cuhe_tpu_torch/csrc/crt_ops.cu")
    for name, src, rep in (
            ("zp_mul", pw_src, "cuhe_tpu/ops/modp.py:188"),
            ("barrett_combine", pw_src, "cuhe_tpu/ops/barrett.py:29"),
            ("mod_switch", pw_src, "cuhe_tpu/ops/pointwise.py:75"),
            ("crt_add", pw_src, "cuhe_tpu/ops/pointwise.py:38"),
            ("crt_from_raw", crt_src, "cuhe_tpu/ops/crt.py:26"),
            ("zp_add", pw_src, "cuhe_tpu/ops/modp.py:152"),
            ("crt_scalar", crt_src, "cuhe_tpu/ops/pointwise.py:45"),
            ("icrt_split16", crt_src, "cuhe_tpu/ops/crt.py:165"),
            ("icrt_combine16", crt_src, "cuhe_tpu/ops/crt.py:165")):
        if path_launches.get(name, 0) < 1:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": path_launches[name],
                        "max_abs_err": 0, **pw_timings[name],
                        "library_ms": None})
    # B1's block passes: launches in phase 8 (c), summed over the ranks
    for name, r in block_timings.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "cuhe_tpu_torch/csrc/ntt.cu",
                        "replaces": "cuhe_tpu/ops/ntt_kernels.py:330",
                        "launches": block_launches[name], "max_abs_err": 0,
                        **r, "library_ms": None})
    kernels += probe_suite.kernel_line(records, probe_launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
