"""step.pytorch_pct: percent of the gate step's device time in kernels that
are PyTorch's own (its namespaces, copies and fills), not the program's."""

from benchmark.core.trace import is_pytorch_kernel


def read(run):
    p = run.profile
    if p is None or not p.ops:
        return None
    total = sum(e - s for _, s, e in p.ops)
    torch_s = sum(e - s for n, s, e in p.ops if is_pytorch_kernel(n))
    return 100.0 * torch_s / total if total > 0 else None
