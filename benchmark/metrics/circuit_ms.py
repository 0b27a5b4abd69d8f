"""circuit_ms: the whole window over the PRINCE blocks completed in it."""


def read(run):
    w = run.window
    if not w.get("blocks"):
        return None
    return 1e3 * w["seconds"] / w["blocks"]
