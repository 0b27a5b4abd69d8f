"""The one traffic generator: it reads a mix's parameters
(benchmark/traffic/<mix>.json) and a seed, and says which input each
operation of a closed loop takes and which answers are kept for the check.

A mix's keys:
  runner        the runner module that holds the program for this traffic
  loop          "closed": one client, each operation after the last answer
  batch         ciphertexts per operation
  level         circuit level of the operands
  pool          distinct inputs, taken round-robin (1: one input throughout)
  keep_every    keep every k-th answer for the check, from a seeded offset
  keep_first    also keep one answer drawn from the first this many
                (a circuit: the block whose S-box layer is kept)
  decrypt       kept answers that are also decrypted by the reference
  profile       {"warm": w, "calls": c}: the traced stretch
"""

from __future__ import annotations

import numpy as np
import torch

P_HI_MAX = (1 << 32) - 1  # hi words below this keep (lo, hi) below P


def rng(seed: int, stream: int) -> np.random.Generator:
    """numpy stream `stream` of the seed (any non-negative int)."""
    return np.random.default_rng([int(seed), stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 1 << 62)))
    return g


def uniform_zp(gen: torch.Generator, shape, device):
    """A uint32 (lo, hi) pair of values below the Goldilocks prime, drawn
    on the device."""
    from benchmark.reference.zp import i64_to_u32

    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=device,
                       dtype=torch.int64)
    hi = torch.randint(0, P_HI_MAX, shape, generator=gen, device=device,
                       dtype=torch.int64)
    return i64_to_u32(lo), i64_to_u32(hi)


class Schedule:
    """Which input each operation takes and which answers are kept."""

    def __init__(self, traffic: dict, seed: int):
        if traffic.get("loop", "closed") != "closed":
            raise ValueError("only closed loops are generated")
        r = rng(seed, 0)
        self.pool = int(traffic.get("pool", 1))
        self.order = r.permutation(self.pool)
        self.keep_every = int(traffic.get("keep_every", 0))
        self.offset = (int(r.integers(0, self.keep_every))
                       if self.keep_every else 0)
        first = int(traffic.get("keep_first", 0))
        self.first = int(r.integers(0, first)) if first else None
        self.decrypt = int(traffic.get("decrypt", 0))
        self._r = r

    def input_of(self, i: int) -> int:
        return int(self.order[i % self.pool])

    def keep(self, i: int) -> bool:
        if self.first is not None and i == self.first:
            return True
        return bool(self.keep_every) and i % self.keep_every == self.offset

    def pick(self, items: list, count: int) -> list:
        """`count` of `items`, drawn from the seed."""
        if len(items) <= count:
            return list(items)
        idx = self._r.choice(len(items), size=count, replace=False)
        return [items[i] for i in sorted(idx)]
