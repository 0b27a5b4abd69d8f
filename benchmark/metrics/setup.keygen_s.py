"""setup.keygen_s: seconds in the span around the scheme's constructor
(CuDHS keygen: Batcher, XGCD, public and eval keys)."""


def read(run):
    spans = run.spans.named("bench.keygen")
    if not spans:
        return None
    return sum(s.end - s.start for s in spans)
