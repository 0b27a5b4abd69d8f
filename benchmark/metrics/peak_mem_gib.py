"""peak_mem_gib: torch.cuda.max_memory_allocated() over the whole run, set-up
included, read when the window closes."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
