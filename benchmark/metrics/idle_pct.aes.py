"""Percent of a short steady traced stretch, after warm-up calls inside the
profile, in which no operation ran on the device."""

from benchmark.core.readers import idle_pct


def read(run):
    return idle_pct(run)
