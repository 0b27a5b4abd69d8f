"""The rank side of tests/test_torch_mesh.py: every case of that file in one
start of 8 Gloo ranks on the CPU (``parallel.run.spawn``).

It imports torch and the port only, so that the ranks do not load JAX; the
test process holds what rank 0 returns against the JAX package.  Every rank
makes every mesh once, in the same order (each `make_mesh` creates process
groups on all of them), then runs every case; a rank outside a case's mesh
holds None for it and goes on to the next case.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from cuhe_tpu_torch import entry
from cuhe_tpu_torch.ops import pointwise as pw
from cuhe_tpu_torch.parallel import mesh as pmesh

# (name, n_batch, n_crt): the meshes of the cases; world 8 = 4 x 2
ICRT_MESHES = (("4x2", 4, 2), ("2x4", 2, 4), ("1x3", 1, 3))
STEP_MESHES = (("4x2", 4, 2), ("2x4", 2, 4), ("2x1", 2, 1), ("1x3", 1, 3))
NTT_SHARDS = (8, 4, 2)
ROUNDTRIP_MESHES = (("4x2", 4, 2), ("1x3", 1, 3))
NTT_N = 16384
STEP_BATCH = 4


def _meshes(world: int) -> dict:
    """Every mesh of the cases, made once each and in the same order on
    every rank: {(n_batch, n_crt): this rank's mesh, or None}."""
    shapes = sorted({(nb, nc) for _, nb, nc in
                     ICRT_MESHES + STEP_MESHES + ROUNDTRIP_MESHES}
                    | {(1, s) for s in NTT_SHARDS})
    return {(nb, nc): pmesh.make_mesh(
        nb, nc, "cpu", ranks=None if nb * nc == world else range(nb * nc))
        for nb, nc in shapes}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.int32).numpy()
                          .tobytes()).hexdigest()


def run_cases(world_mesh, inputs: dict) -> dict:
    """Every case on this rank.  Rank 0 returns {case: numpy output}; every
    rank returns, for the cases that check it, what its own block holds."""
    first = world_mesh.rank == 0
    out = {"rank": world_mesh.rank}

    def keep(name, value):
        if first:
            out[name] = value

    # make_mesh raises where the mesh's size is not the world's
    try:
        pmesh.make_mesh(3, 3, "cpu")
    except ValueError as e:
        out["wrong_world"] = str(e)

    meshes = _meshes(len(world_mesh.ranks))

    # ICRT over a crt-sharded prime axis (B3's plain version + all-reduce)
    ctx = entry.keyed_context(entry.ENTRY_PARAMS, "cpu")
    t = ctx.level(0)
    crt_in = torch.from_numpy(inputs["crt"])
    for name, nb, nc in ICRT_MESHES:
        m = meshes[nb, nc]
        if m is None:
            continue
        c0, c1 = pmesh.crt_split(t.pn, nc)[m.c]
        raw = pmesh.icrt_to_raw_sharded(
            m, pmesh.shard_ciphertext(crt_in, m), t.primes[c0:c1],
            t.bi[c0:c1], t.mi_words[c0:c1], t.m_words)
        full = pmesh.gather_batch(raw, m)
        keep(f"icrt {name}", full.numpy())
        out[f"icrt {name} block"] = _digest(raw)

    # one forward NTT across 8, 4 and 2 ranks
    x = torch.from_numpy(inputs["ntt_x"])
    for s in NTT_SHARDS:
        m = meshes[1, s]
        if m is None:
            continue
        lo, hi = pmesh.ntt_fwd_sharded(m, NTT_N)(x)
        full = [m.crt.all_gather(v).movedim(0, -2).reshape(
            v.shape[:-1] + (-1,)) for v in (lo, hi)]
        keep(f"ntt {s}", np.stack([v.numpy() for v in full]))

    # the sharded gate step on batch 4
    args = tuple(torch.from_numpy(v) for v in inputs["step_args"])
    for name, nb, nc in STEP_MESHES:
        m = meshes[nb, nc]
        if m is None:
            continue
        step = pmesh.ShardedGateStep(ctx, 0, m)
        local = step(*(pmesh.shard_ciphertext(a, m) for a in args))
        keep(f"step {name}", pmesh.gather_batch(local, m).numpy())
        c0, c1 = step.planes
        out[f"step {name} block"] = (m.b, m.c, c0, c1, tuple(local.shape),
                                     _digest(local))
        out[f"step {name} keys"] = (
            tuple(step.ek_lo.shape),
            torch.equal(step.ek_lo.view(torch.int32),
                        ctx.ek_ntt[0][:, c0:c1].view(torch.int32))
            and torch.equal(step.ek_hi.view(torch.int32),
                            ctx.ek_ntt[1][:, c0:c1].view(torch.int32)))

    # the pointwise AND on a (4, 2) mesh, and shard -> gather round trips
    m = meshes[4, 2]
    a = tuple(pmesh.shard_ciphertext(v, m) for v in args)
    prod = pw.ntt_mul(a[:2], a[2:])
    keep("and 4x2", np.stack([pmesh.gather_ciphertext(v, m).numpy()
                              for v in prod]))
    for name, nb, nc in ROUNDTRIP_MESHES:
        m = meshes[nb, nc]
        if m is None:
            continue
        keep(f"roundtrip {name}", pmesh.gather_ciphertext(
            pmesh.shard_ciphertext(args[0], m), m).numpy())
    return out
