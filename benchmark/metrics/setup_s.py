"""setup_s: seconds from process start to the first timed operation (build,
keygen, encryption and warm-up included)."""


def read(run):
    return run.setup_s
