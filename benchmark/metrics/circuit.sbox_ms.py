"""circuit.sbox_ms: ms of the S-box layers of one PRINCE block, from the
harness's spans around each Prince.sbox_layer call (synchronised at the
span's end), summed per block; the median over the window's blocks."""

import statistics


def read(run):
    spans = run.spans.done
    per_block: dict = {}
    for s in spans:
        if s.name == "bench.sbox_layer" and s.parent is not None:
            blk = s.parent
            while blk is not None and spans[blk].name != "bench.block":
                blk = spans[blk].parent
            if blk is not None:
                per_block[blk] = per_block.get(blk, 0.0) + (s.end - s.start)
    if not per_block:
        return None
    return 1e3 * statistics.median(per_block.values())
