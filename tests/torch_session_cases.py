"""The ranks' side of tests/test_torch_mesh_session.py: a state that every
rank of a `MeshSession` builds once (`setup`), and the operations that the
test runs on all of them in lockstep.  Imports no JAX: the workers import
this module by name."""

from __future__ import annotations

import os

import torch

from cuhe_tpu_torch.parallel import mesh as pmesh


def setup(mesh, base: int):
    return Ranks(mesh, base)


class Ranks:
    """Counts with collectives on either axis of its rank's mesh; the
    collectives' calls and bytes are counted, not timed."""

    def __init__(self, mesh, base: int):
        self.mesh, self.base = mesh, base
        self.calls = 0
        self.stats = pmesh.CommStats()
        mesh.count_collectives(self.stats)

    def where(self):
        self.calls += 1
        return (self.mesh.rank, self.mesh.b, self.mesh.c, os.getpid())

    def crt_sum(self, x: int) -> int:
        """The sum over this rank's crt axis of (base + rank) * x."""
        self.calls += 1
        t = torch.tensor([(self.base + self.mesh.rank) * x],
                         dtype=torch.int64)
        return int(self.mesh.crt.all_reduce_sum(t)[0])

    def batch_rows(self):
        """The batch axis' all-gather of a [2, 3] uint32 block per rank."""
        self.calls += 1
        t = torch.full((2, 3), self.mesh.rank, dtype=torch.uint32)
        return pmesh.gather_batch(t, self.mesh).view(torch.int32).tolist()

    def count(self):
        return self.calls, dict(self.stats.calls), dict(self.stats.bytes), \
            dict(self.stats.seconds)

    def raise_on(self, rank: int) -> int:
        """Rank `rank` raises; the others return their rank at once."""
        if self.mesh.rank == rank:
            raise ValueError(f"planted failure on rank {rank}")
        return self.mesh.rank

    def fail_on(self, rank: int, how: str):
        """Rank `rank` raises (or exits) where the others sum over the
        whole world."""
        if self.mesh.rank == rank:
            if how == "exits":
                os._exit(3)
            raise ValueError(f"planted failure on rank {rank}")
        t = torch.ones(1, dtype=torch.int64)
        torch.distributed.all_reduce(t)
        return int(t[0])
