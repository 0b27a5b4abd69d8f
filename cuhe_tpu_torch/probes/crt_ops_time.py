"""Time and inspect K5 (`crt.crt_from_raw`) and K8's combine
(`crt.icrt_combine_halves`) of one checkout of the port at PRINCE level
0's shapes, so that two trees can be compared in turns inside one call on
the card.

    python3 cuhe_tpu_torch/probes/crt_ops_time.py [--tree DIR] [--label NAME]

Run as a file, not as a module: it imports ``cuhe_tpu_torch`` from DIR (by
default the checkout that holds this file), so that an older tree, unpacked
with ``git archive`` into a directory, is measured by the same code.  It
builds that tree's kernels and prints one JSON line: the label and tree,
the card's name and power limit, and

  * per case (K5: the PRINCE state's encryption, RAW [64, 20, 16384] -> 25
    planes; K8's combine: a (2, 2) rank's [16, 20, 16384] halves of 2
    shards and a (1, 4) rank's [32, 20, 16384] of 4), inputs made on the
    card from a fixed seed: the median of one front-end call (CUDA events,
    20 calls after a warm-up, host time included), the time per call of 50
    back-to-back calls between two events, the device time per launch that
    ``torch.profiler`` records over 12 launches after 3 warm-up calls outside
    the profiled region (with the launches it recorded), a sha256 of the
    output, and whether it equals the plain version's bit for bit (the run
    raises if not);
  * per kernel, the instantiation those cases run (20 words; the older K5
    ran a block of 32 primes): registers, stack, shared and local bytes per
    thread as ``cuobjdump --dump-resource-usage`` prints them for the built
    library, resident blocks of 256 threads per SM from those by Hopper's
    occupancy rules, and for K5 the SASS
    of its innermost loop with wide multiplies (this design's prime loop,
    the older one's word loop): its instructions, the (word, prime) pairs
    one pass covers and the instructions per pair.

Raises without a card.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import math
import re
import subprocess
import sys
from pathlib import Path

BATCH_K5 = 64      # the PRINCE state: 64 ciphertexts
K8_CASES = (("(2, 2)", 16, 2), ("(1, 4)", 32, 4))  # rank, batch, shards
REPS, BURST, PROFILED, WARM = 20, 50, 12, 3
THREADS = 256      # both kernels' block size

# Hopper (compute capability 9.0): per SM
SM_REGS, SM_THREADS, SM_BLOCKS, SM_SMEM = 65536, 2048, 32, 233472
BLOCK_SMEM_RESERVED, REG_UNIT = 1024, 256

_RESOURCE = re.compile(r"Function ([^\s:]+):\s*\n\s*REG:(\d+) STACK:(\d+) "
                       r"SHARED:(\d+) LOCAL:(\d+)")


def blocks_per_sm(regs: int, smem: int, threads: int = THREADS) -> int:
    """Resident blocks per SM of a kernel with `regs` registers a thread and
    `smem` bytes of shared memory a block, by compute capability 9.0's
    rules (registers allocated per warp in units of 256)."""
    warps = math.ceil(threads / 32)
    per_warp = math.ceil(regs * 32 / REG_UNIT) * REG_UNIT
    by_regs = SM_REGS // (per_warp * warps) if regs else SM_BLOCKS
    by_smem = SM_SMEM // (smem + BLOCK_SMEM_RESERVED)
    return min(SM_BLOCKS, SM_THREADS // threads, by_regs, by_smem)


def resource_usage(so: Path, nvcc: str) -> dict:
    """{mangled kernel name: {reg, stack, shared, local}} of the library."""
    tool = Path(nvcc).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-resource-usage", str(so)],
                         capture_output=True, text=True, check=True).stdout
    usage = {m[1]: dict(zip(("reg", "stack", "shared", "local"),
                            map(int, m.groups()[1:])))
             for m in _RESOURCE.finditer(out)}
    if not usage:
        raise RuntimeError("no resource usage in cuobjdump's output:\n"
                           + out[:2000])
    return usage


def device_ms(fn, kernel: str, launches: int = PROFILED,
              warm: int = WARM) -> tuple:
    """(device ms per launch, launches recorded) of the kernels whose name
    holds `kernel` that ``torch.profiler`` records over `launches` calls of
    fn(), after `warm` calls outside the profiled region (the profiler
    drops launches at the start of a region); (None, 0) if it records
    none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(r[1] for r in rows)
    return (sum(r[0] for r in rows) / count if count else None), count


def inner_loop(sass: str, kernel: str, marker: str) -> collections.Counter:
    """Opcodes of the shortest loop (a backward branch and the instructions
    back to its target) of the kernel whose name holds `kernel`, in
    `cuobjdump -sass` text, among the loops that hold a wide multiply
    (IMAD.WIDE*) and an instruction whose opcode starts with `marker`."""
    from cuhe_tpu_torch.probes.calib import _SASS_INSTRUCTION

    for function in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, code = function.partition("\n")
        if kernel not in name:
            continue
        ins = [(int(a, 16), op, rest)
               for a, op, rest in _SASS_INSTRUCTION.findall(code)]
        where = {a: i for i, (a, _, _) in enumerate(ins)}
        loops = [[op for _, op, _ in ins[where[t]: i + 1]]
                 for i, (a, op, rest) in enumerate(ins)
                 if op == "BRA" and rest.startswith("0x")
                 and (t := int(rest.split()[0], 16)) < a and t in where]
        loops = [ops for ops in loops
                 if any(o.startswith("IMAD.WIDE") for o in ops)
                 and any(o.startswith(marker) for o in ops)]
        if not loops:
            raise ValueError(f"{name}: no loop with IMAD.WIDE and {marker}")
        return collections.Counter(min(loops, key=len))
    raise ValueError(f"no kernel named *{kernel}* in the SASS")


def pick(names, part: str) -> str:
    hits = [n for n in names if part in n]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} kernels named *{part}*: {hits}")
    return hits[0]


def evidence(so: Path, sass: str, words: int) -> dict:
    """Per kernel (K5 "crt_from_raw", K8's "icrt_combine16"), of the
    instantiation that runs at `words` words in the library `so` of the
    tree on the path (whose SASS is `sass`): its resource usage, resident
    blocks per SM and, for K5, its loop's SASS (see the module's
    docstring)."""
    from cuhe_tpu_torch.ops import _cuda

    usage = resource_usage(so, _cuda._nvcc())
    # this design's instantiation at `words`, or the older K5's block of 32
    # primes and its one K8 combine
    new = f"crt_from_raw_kernelILi{words}E" in sass
    k5 = pick(usage, f"crt_from_raw_kernelILi{words if new else 32}E")
    k8 = pick(usage, f"icrt_combine16_kernel{f'ILi{words}E' if new else 'E'}")
    kernels = {}
    for name, mangled in (("crt_from_raw", k5), ("icrt_combine16", k8)):
        u = usage[mangled]
        kernels[name] = {"function": mangled, **u,
                         "blocks_per_sm": blocks_per_sm(u["reg"],
                                                        u["shared"])}
    # the innermost loop with wide multiplies and a store (this design: one
    # pass per prime, a store per coefficient) or a load (the older one:
    # one pass per word, into a block of 32 primes)
    ops = inner_loop(sass, k5, "STG" if new else "LDG")

    def count(prefix):
        return sum(c for o, c in ops.items() if o.startswith(prefix))

    pairs = count("STG") * words if new else count("LDG") * 32
    total = sum(ops.values())
    kernels["crt_from_raw"]["sass_loop"] = {
        "instructions": total, "word_prime_pairs": pairs,
        "per_word_prime": total / pairs if pairs else None,
        "wide_multiplies": count("IMAD.WIDE"),
        "opcodes": dict(ops.most_common(10))}
    return kernels


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no card: the kernels are measured on a CUDA "
                           "device only")
    import cuhe_tpu_torch
    from cuhe_tpu_torch import entry
    from cuhe_tpu_torch import hostmath as hm
    from cuhe_tpu_torch.ops import _cuda, crt, modp
    from cuhe_tpu_torch.params import make_params
    from cuhe_tpu_torch.probes.timing import cuda_ms, cuda_ms_burst, gpu_line

    if Path(cuhe_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {cuhe_tpu_torch.__file__}, not {tree}")
    card = gpu_line()
    so, build_s = _cuda.build()
    _cuda.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)

    def rand_u32(shape):
        return modp.to_u32(torch.randint(0, 1 << 32, shape, generator=gen,
                                         device=dev, dtype=torch.int64))

    def measure(name, kernel, fn, plain):
        out = fn()
        same = torch.equal(out.view(torch.int32), plain().view(torch.int32))
        if not same:
            raise AssertionError(f"{name}: kernel != plain")
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        ms, burst = cuda_ms(fn, REPS), cuda_ms_burst(fn, BURST)
        dev_ms, launches = device_ms(fn, kernel)
        return {"ms": ms, "burst_ms": burst, "device_ms": dev_ms,
                "profiled_launches": launches, "sha256": digest,
                "equal_plain": same}

    pr = make_params(*entry.PRINCE_PARAMS)
    n, pn, words = pr.ntt_len, pr.num_crt_prime, pr.words_coeff(0)
    half = n // 2
    cases = {}
    p = modp.to_u32(torch.tensor([int(v) for v in pr.crt_primes],
                                 dtype=torch.int64, device=dev))
    raw = rand_u32((BATCH_K5, words, half))
    cases["crt_from_raw"] = measure(
        "crt_from_raw", "crt_from_raw_kernel", lambda: crt.crt_from_raw(raw, p),
        lambda: crt.crt_from_raw_plain(raw, p))
    del raw
    q, _, _ = pr.icrt_consts(0)
    mw = [int(v) for v in hm.ints_to_words([q], words)[:, 0]]
    m_words = modp.to_u32(torch.tensor(mw, dtype=torch.int64, device=dev))
    for tag, batch, shards in K8_CASES:
        lo = torch.zeros((batch, words, half), dtype=torch.int64, device=dev)
        hi = torch.zeros_like(lo)
        for _ in range(shards):  # partials below M: the top word below M's
            v = modp.to_i64(rand_u32((batch, words, half)))
            v[:, words - 1] %= mw[words - 1]
            lo += v & 0xFFFF
            hi += v >> 16
        lo, hi = lo.to(torch.int32), hi.to(torch.int32)
        cases[f"icrt_combine16 {tag}"] = measure(
            f"icrt_combine16 {tag}", "icrt_combine16_kernel",
            lambda: crt.icrt_combine_halves(lo, hi, m_words, shards),
            lambda: crt.icrt_combine_halves_plain(lo, hi, m_words, shards))
        del lo, hi
    torch.cuda.empty_cache()

    kernels = evidence(so, _cuda.sass(), words)
    res = {"label": args.label, "tree": str(tree), "card": card,
           "build_s": build_s, "cases": cases, "kernels": kernels}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
