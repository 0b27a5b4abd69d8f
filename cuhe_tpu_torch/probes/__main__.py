"""python3 -m cuhe_tpu_torch.probes: every probe on the card, held against
its plain version first, one line per measurement.  No CPU path: without a
card it raises."""

from __future__ import annotations

import sys

from . import suite
from .timing import gpu_line, require_card


def main() -> int:
    dev = require_card("cuda")
    print(f"card: {gpu_line()}", flush=True)

    def log(msg: str) -> None:
        print(msg, flush=True)
    suite.check(dev, log)
    suite.run(dev, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
