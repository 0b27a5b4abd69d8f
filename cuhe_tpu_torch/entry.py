"""Entry points: the gate step at the JAX package's entry configuration and
at PRINCE level 0, and the DHS scheme at the reference's shipped
configuration.

`entry()` is the twin of ``__graft_entry__.entry()``: the same parameters,
``make_params(3, 2, 16, 50, 25, 8191)`` (16k ring, 4 primes), the same
numpy-seeded random eval keys (rng 0) and batch-2 inputs (rng 1), so its
step returns the JAX step's output bit for bit.

`make_prince_l0_step()` is the repo's flagship workload, homomorphic PRINCE
(``CuDHS(25, 2, 16, 25, 25, 21845)``, cuhe_tpu/models/prince.py:108) at its
level-0 gate: n = 32768, 25 primes, 40 eval-key digits, and the S-box's
batched AND of 32 ciphertexts.  Keys and inputs are random, from the same
seeds: the step's work does not depend on their values.

`sharded_entry(mesh)` and `make_sharded_prince_l0_step(mesh)` are their
twins on a (batch, crt) mesh of ranks (``parallel/mesh.py``): each rank
builds the same keys and inputs from the same seeds, then keeps its block
of them, so the gathered output equals the unsharded step's.

`simple_dhs()` is the DHS scheme at the reference's shipped simple_DHS
configuration (``CuDHS(5, 2, 1, 61, 20, 8191)``, examples/run_simple_dhs.py):
n = 16384, 7 primes at level 0, 141 one-bit eval keys, depth 5, 630 slots.

All run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import Context, resolve_device
from .dhs import CuDHS
from .parallel.mesh import Mesh, ShardedGateStep, shard_ciphertext
from .params import make_params
from .step import GateStep

ENTRY_PARAMS = (3, 2, 16, 50, 25, 8191)
PRINCE_PARAMS = (25, 2, 16, 25, 25, 21845)
SIMPLE_DHS_PARAMS = (5, 2, 1, 61, 20, 8191)


def _random_pairs(rng, shape, count):
    """`count` (lo, hi) uint32 pairs of values < P, drawn as the JAX entry
    draws them (hi < 0xffffffff)."""
    out = []
    for _ in range(count):
        lo = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
        hi = rng.integers(0, 0xFFFFFFFF, size=shape, dtype=np.uint64)
        out += [lo.astype(np.uint32), hi.astype(np.uint32)]
    return out


def keyed_context(params_args, device="cuda") -> Context:
    """Context of make_params(*params_args) with random eval keys (rng 0)."""
    params = make_params(*params_args)
    ctx = Context(params, resolve_device(device))
    rng = np.random.default_rng(0)
    shape = (params.num_eval_key, params.num_crt_prime, params.ntt_len)
    ctx.set_eval_keys(*_random_pairs(rng, shape, 1))
    return ctx


def _example_arrays(ctx: Context, batch: int):
    rng = np.random.default_rng(1)
    shape = (batch, ctx.params.num_crt_prime, ctx.n)
    return _random_pairs(rng, shape, 2)


def example_batch(ctx: Context, batch: int):
    """(a_lo, a_hi, b_lo, b_hi) uint32 [batch, pnum, n] on ctx.device, from
    numpy rng 1."""
    return tuple(torch.from_numpy(v).to(ctx.device)
                 for v in _example_arrays(ctx, batch))


def entry(device="cuda"):
    """(step, args): the level-0 gate step of the entry configuration and
    its batch-2 inputs; ``step(*args)`` is uint32 [2, 3, 8192]."""
    ctx = keyed_context(ENTRY_PARAMS, device)
    return GateStep(ctx, 0), example_batch(ctx, 2)


def make_prince_l0_step(batch: int = 32, device="cuda"):
    """(step, args): the PRINCE level-0 gate step at `batch` ciphertexts,
    with random eval keys (rng 0) and inputs (rng 1)."""
    ctx = keyed_context(PRINCE_PARAMS, device)
    return GateStep(ctx, 0), example_batch(ctx, batch)


def _sharded_step(params_args, mesh: Mesh, batch: int):
    ctx = keyed_context(params_args, mesh.device)
    step = ShardedGateStep(ctx, 0, mesh)
    ctx.ek_ntt = None  # the step holds this rank's planes of the keys
    args = tuple(shard_ciphertext(torch.from_numpy(v), mesh).to(mesh.device)
                 for v in _example_arrays(ctx, batch))
    return step, args


def sharded_entry(mesh: Mesh):
    """(step, args): `entry()` on this rank's block of `mesh`; the step's
    output is uint32 [2 / n_batch, 3, 8192]."""
    return _sharded_step(ENTRY_PARAMS, mesh, 2)


def make_sharded_prince_l0_step(mesh: Mesh, batch: int = 32):
    """(step, args): `make_prince_l0_step(batch)` on this rank's block of
    `mesh`: batch / n_batch ciphertexts, its planes of the 25, and its
    planes of the eval keys."""
    return _sharded_step(PRINCE_PARAMS, mesh, batch)


def simple_dhs(seed: int | None = None, device="cuda") -> CuDHS:
    """The DHS scheme at SIMPLE_DHS_PARAMS: keygen (141 eval keys in the NTT
    domain) with host sampling from numpy rng `seed`."""
    return CuDHS(*SIMPLE_DHS_PARAMS, seed=seed, device=device)
