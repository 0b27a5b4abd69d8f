"""Checked-mode helpers (the reference's Debug.h CSC/CCE + `#define safer`).

Counterpart of ``cuhe_tpu/utils/debug.py``, on torch tensors.  The
reference wraps every CUDA call in CSC()/CCE() macros and optionally
synchronises after each launch (cuhe/Debug.h:35-64); here every kernel
front end already raises on a launch error (``ops/_cuda.py``).  What is
left to check is *value-domain* corruption: non-canonical mod-P pairs and
residues >= p.  With CUHE_SAFER=1 in the environment the helpers below
raise on a violation; otherwise they return at once, so the hot path stays
clean.  Like the JAX package's, no module calls them: they are for a
caller chasing a fault.
"""

from __future__ import annotations

import os

import torch

from ..ops import modp

SAFER = os.environ.get("CUHE_SAFER", "0") == "1"


def check_canonical_pair(lo: torch.Tensor, hi: torch.Tensor,
                         what: str = "value") -> None:
    """Raise unless the uint32 pair is a canonical Z_P element (< P)."""
    if not SAFER:
        return
    # v >= P = 2^64 - 2^32 + 1 exactly where hi = 2^32 - 1 and lo >= 1
    bad = (modp.to_i64(hi) == modp.P_HI) & (modp.to_i64(lo) >= 1)
    if bool(bad.any()):
        v = modp.u64_from_pair(lo[bad], hi[bad])
        raise AssertionError(f"{what}: non-canonical mod-P value "
                             f"{int(v.max()):#x}")


def check_residues(x: torch.Tensor, primes: torch.Tensor,
                   what: str = "crt") -> None:
    """Raise unless CRT planes [.., pnum, L] hold residues < p_i."""
    if not SAFER:
        return
    p = modp.to_i64(primes.to(x.device)).reshape(-1, 1)
    if bool((modp.to_i64(x) >= p).any()):
        raise AssertionError(f"{what}: residue >= prime")
