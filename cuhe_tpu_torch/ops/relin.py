"""Relinearization (key switching) after a ciphertext multiplication.

Counterpart of ``cuhe_tpu/ops/relin.py:67-156`` (reference
Relinearization.cu:43-88, Base.cu:345-385, 1024-1033):

    dst[.., p, :] = sum_j ntt(digit_j(raw)) * ek[j, p]

over the knum w-bit digits of the RAW coefficients.  The digits run in
chunks of c through the front ends' `digits_mulacc` (the two kernels of
``ops/ntt_kernels.relin_digits_mulacc``, or its plain version); c is sized
so that a chunk's digit NTTs, [c, batch, n] Goldilocks words, fit
`DIGIT_SCRATCH_BYTES` of device memory.  The TPU package's four tiers and
their VMEM-fit searches have no counterpart: device memory holds any chunk
the card is given.
"""

from __future__ import annotations

from math import prod

import torch

# Bound on one chunk's digit-NTT scratch: at PRINCE level 0 (batch 32,
# n = 32768) all 40 digits form one chunk, 320 MiB, so the multiply-
# accumulate runs once per step and its accumulator never leaves the
# registers between digits; a larger batch or level takes more chunks, each
# adding the previous chunk's partial.
DIGIT_SCRATCH_BYTES = 320 << 20


def digit_chunk(batch: int, n: int, knum: int) -> int:
    """Digits per chunk: as many as fit DIGIT_SCRATCH_BYTES, at least 1."""
    return max(1, min(knum, DIGIT_SCRATCH_BYTES // max(1, batch * n * 8)))


def relinearize(raw: torch.Tensor, ek_lo: torch.Tensor, ek_hi: torch.Tensor,
                *, w: int, knum: int, pnum: int, n: int, ops):
    """raw: uint32 [.., w32, n/2] RAW ciphertext words.

    ek_lo/ek_hi: uint32 [num_eval_key, pnum_max, n] eval keys, mat-linear;
    the first `knum` keys and `pnum` planes are used; ops: the front ends
    (``context.py::FrontEnds``).  Returns a mat-linear uint32 pair
    [.., pnum, n].
    """
    c = digit_chunk(prod(raw.shape[:-2]), n, knum)
    acc = None
    for j0 in range(0, knum, c):
        acc = ops.digits_mulacc(raw, (ek_lo, ek_hi), n, w=w, j0=j0,
                                c=min(c, knum - j0), pnum=pnum, acc=acc)
    return acc
