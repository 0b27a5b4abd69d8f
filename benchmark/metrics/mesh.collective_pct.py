"""mesh.collective_pct: percent of rank 0's traced stretch in which a
collective's device kernel (a name with "nccl") runs and no other device
operation does: the collectives' exposed share, which overlapping them with
the kernels would lower and their own length alone would not show.  The
program's ``mesh.<collective>`` ranges, which the trace also lays on the
device's timeline over their kernels, are no operation of their own."""

from benchmark.core.trace import _union


def is_collective(name: str) -> bool:
    return "nccl" in name.lower()


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    ops = [(n, s, e) for n, s, e in p.ops if not n.startswith("mesh.")]
    if not any(is_collective(n) for n, _, _ in ops):
        return None
    busy = _union([(s, e) for _, s, e in ops])
    rest = _union([(s, e) for n, s, e in ops if not is_collective(n)])
    return 100.0 * (busy - rest) / 1e6 / p.window_s
