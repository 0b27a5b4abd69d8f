"""Time the PRINCE level-0 gate step of one checkout of the port, so that
two trees can be compared in turns inside one call on the card.

    python3 cuhe_tpu_torch/probes/step_time.py [--tree DIR] [--label NAME]

Run as a file, not as a module: it imports ``cuhe_tpu_torch`` from DIR (by
default the checkout that holds this file), so that an older tree, unpacked
with ``git archive`` into a directory, is timed by the same code.  It builds
that tree's kernels, makes ``entry.make_prince_l0_step(32)`` (n = 32768,
25 primes, 40 digits, random keys and inputs from fixed seeds: the step
chip_smoke.py's phase 4 times) and prints one JSON line: the label and
tree, the card's name and power limit, the step's median ms over 20
CUDA-event-timed steps after one warm-up, ms per ciphertext, peak device
memory, a sha256 of the output, and `split` of ``torch.profiler`` over one
more step.  Raises without a card.

`split` is this file's, whichever tree is timed, and chip_smoke.py's
profiles call it too, so that both measure one thing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

# the port's kernels by a part of their device names (K1's and K6's body
# is zp_binary_kernel; trees before it named K1's zp_mul_kernel)
PORT_KERNEL_NAMES = ("fwd_cols", "ntt_rows", "inv_cols", "icrt_kernel",
                     "relin_mulacc_kernel", "zp_binary_kernel",
                     "zp_mul_kernel", "barrett_combine_kernel",
                     "mod_switch_kernel", "crt_add_kernel",
                     "crt_from_raw_kernel", "crt_scalar_kernel",
                     "icrt_split16_kernel", "icrt_combine16_kernel")
BATCH = 32  # ciphertexts in the timed step
REPS = 20  # timed steps


def split(prof, run_ms: float) -> dict:
    """A profiled run's device time by kernel (``torch.profiler``'s
    `prof`), split into the port's kernels and PyTorch's own, and the idle
    share against `run_ms`, the run's CUDA-event time.  `rows` and
    `port_rows` are (name, device ms, launches), the longest first;
    `pytorch_share` and `idle_share` are None when no device time was
    recorded."""
    from torch.autograd import DeviceType

    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    port_rows = [r for r in rows
                 if any(s in r[0] for s in PORT_KERNEL_NAMES)]
    busy = sum(ms for _, ms, _ in rows)
    port = sum(ms for _, ms, _ in port_rows)
    return {
        "rows": rows, "port_rows": port_rows, "busy_ms": busy,
        "port_kernels_ms": port, "pytorch_kernels_ms": busy - port,
        "pytorch_share": (busy - port) / busy if busy > 0 else None,
        "idle_share": max(0.0, 1 - busy / run_ms) if busy > 0 else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("no card: the step is timed on a CUDA device only")
    import cuhe_tpu_torch
    from cuhe_tpu_torch import entry
    from cuhe_tpu_torch.ops import _cuda

    if Path(cuhe_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {cuhe_tpu_torch.__file__}, not {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _cuda.build()
    step, inputs = entry.make_prince_l0_step(batch=BATCH, device="cuda")
    out = step(*inputs)
    torch.cuda.synchronize()
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(*inputs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*inputs)
        torch.cuda.synchronize()
    prof_split = split(prof, ms)
    res = {
        "label": args.label, "tree": str(tree), "card": card,
        "batch": BATCH, "step_ms": ms, "ms_per_ct": ms / BATCH,
        "step_ms_all": times, "peak_gib": peak / 2 ** 30, "sha256": digest,
        **{k: v for k, v in prof_split.items()
           if k not in ("rows", "port_rows")},
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
