"""The port's relinearization (digit NTTs + eval-key multiply-accumulate,
cuhe_tpu_torch/ops/ntt_kernels.py and ops/relin.py) against the JAX
package's fused Pallas relinearization kernels in interpret mode
(relin_digits_mulacc, relin_digits_mulacc_p), its windowed-digit forward
kernel (ntt_fwd_digits) and its relinearize, at the shapes of
tests/test_ntt_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuhe_tpu.ops import ntt_kernels as jnk
from cuhe_tpu.ops import relin as jrelin
from cuhe_tpu_torch.context import KERNELS
from cuhe_tpu_torch.ops import ntt_kernels as nk
from cuhe_tpu_torch.ops import relin
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 16384


def _raw(seed, w32=4, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(b, w32, N // 2),
                        dtype=np.uint64).astype(np.uint32)


def _ek(seed, knum, pnum):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, size=(knum, pnum, N),
                      dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 0xFFFFFFFF, size=(knum, pnum, N),
                      dtype=np.uint64).astype(np.uint32)
    return lo, hi


def _t(pair):
    return tuple(torch.from_numpy(v) for v in pair)


def _eq_pair(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("w,j0,c", [
    (16, 0, 3),            # aligned windows (the relin width of the configs)
    (20, 1, 4),            # windows crossing word boundaries
    (13, 7, 3),            # the top window's high word lies past the last word
])
def test_fwd_digits_match_pallas_interpret(w, j0, c):
    raw = _raw(w * 100 + j0)
    got = nk.ntt_fwd_digits(torch.from_numpy(raw), N, w=w, j0=j0, c=c)
    want = jnk.ntt_fwd_digits(jnp.asarray(raw), N, w=w, j0=j0, c=c, bt=2,
                              layout="mat", interpret=True)
    _eq_pair(got, want)


def test_relin_digits_mulacc_matches_pallas_interpret():
    knum, pnum = 5, 3
    raw, ek = _raw(11), _ek(12, knum, pnum)
    got = nk.relin_digits_mulacc(torch.from_numpy(raw), _t(ek), N, w=16,
                                 j0=1, c=3, pnum=pnum)
    want = jnk.relin_digits_mulacc(jnp.asarray(raw), tuple(map(jnp.asarray, ek)),
                                   N, w=16, j0=1, c=3, pnum=pnum, bt=2,
                                   interpret=True)
    _eq_pair(got, want)
    # with a previous chunk's partial: acc + the chunk's sum
    acc = nk.relin_digits_mulacc(torch.from_numpy(raw), _t(ek), N, w=16,
                                 j0=0, c=1, pnum=pnum)
    both = nk.relin_digits_mulacc(torch.from_numpy(raw), _t(ek), N, w=16,
                                  j0=1, c=3, pnum=pnum, acc=acc)
    whole = nk.relin_digits_mulacc(torch.from_numpy(raw), _t(ek), N, w=16,
                                   j0=0, c=4, pnum=pnum)
    assert all(torch.equal(a, b) for a, b in zip(both, whole))


@pytest.mark.parametrize("pnum,pc,c,j0", [
    (3, 2, 3, 1),          # pnum padded to a multiple of pc in the TPU kernel
    (5, 2, 4, 0),          # several plane chunks
])
def test_relin_mulacc_matches_pnum_chunked_kernel(pnum, pc, c, j0):
    raw, ek = _raw(pnum * 37 + pc), _ek(pnum * 41 + pc, j0 + c, pnum)
    got = nk.relin_digits_mulacc(torch.from_numpy(raw), _t(ek), N, w=16,
                                 j0=j0, c=c, pnum=pnum)
    want = jnk.relin_digits_mulacc_p(jnp.asarray(raw),
                                     tuple(map(jnp.asarray, ek)), N, w=16,
                                     j0=j0, c=c, pnum=pnum, pc=pc, bt=2,
                                     interpret=True)
    _eq_pair(got, want)


def test_relinearize_matches_jax():
    knum, pnum = 5, 3
    raw, ek = _raw(99), _ek(100, knum, pnum)
    got = relin.relinearize(torch.from_numpy(raw), *_t(ek), w=16, knum=knum,
                            pnum=pnum, n=N, ops=KERNELS)
    want = jrelin.relinearize(jnp.asarray(raw), *map(jnp.asarray, ek), w=16,
                              knum=knum, pnum=pnum, n=N, layout="mat")
    _eq_pair(got, want)


def test_digit_chunk_is_sized_from_the_scratch_bound():
    # PRINCE level 0: batch 32, n = 32768 -> all 40 digits (320 MiB of digit
    # NTTs)
    assert relin.digit_chunk(32, 32768, 40) == 40
    # the entry configuration: all 7 digits in one chunk
    assert relin.digit_chunk(2, 16384, 7) == 7
    assert relin.digit_chunk(1 << 20, 65536, 40) == 1
