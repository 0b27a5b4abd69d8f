"""Run one cell of the benchmark of cuhe_tpu_torch once, on this machine.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout.  It finds the cell in BENCHMARK.json, its
configuration, its traffic mix (benchmark/traffic/) and its metric readers
(benchmark/metrics/) by name, builds the program on the card, warms it up,
measures for S seconds, checks what the timed path produced against the
plain reference (benchmark/reference/), and prints one JSON line last.  With
--trace 1 it reports the cell's per-layer metrics from spans and a
torch.profiler trace instead of its end-to-end metrics.  It exits non-zero,
with no result, without enough CUDA devices, or if JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program builds its kernels into cuhe_tpu_torch/_build/, inside
    # the checkout, and uses no other build or kernel cache
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.core import harness, spec

    cell = spec.resolve(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
