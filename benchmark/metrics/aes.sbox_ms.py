"""aes.sbox_ms: ms of the SubBytes layers of one AES-128 circuit, from the
harness's spans around each AES.sub_bytes call (synchronised at the span's
end), summed per circuit; the median over the window's circuits."""

import statistics


def read(run):
    spans = run.spans.done
    per_block: dict = {}
    for s in spans:
        if s.name == "bench.sub_bytes" and s.parent is not None:
            blk = s.parent
            while blk is not None and spans[blk].name != "bench.block":
                blk = spans[blk].parent
            if blk is not None:
                per_block[blk] = per_block.get(blk, 0.0) + (s.end - s.start)
    if not per_block:
        return None
    return 1e3 * statistics.median(per_block.values())
