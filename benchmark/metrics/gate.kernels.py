"""gate.kernels: device operations per batch-1 AND gate (the program's
kernels and PyTorch's), counted in the traced stretch."""


def read(run):
    p = run.profile
    if p is None or not p.ops:
        return None
    return len(p.ops) / p.calls
