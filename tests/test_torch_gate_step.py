"""The port's gate step (AND + relinearize + modswitch) on the CPU equals the
JAX package's __graft_entry__.entry() step bit for bit: uint32 [2, 3, 8192]
at make_params(3, 2, 16, 50, 25, 8191), batch 2, the same seeded keys and
inputs.  The JAX side takes about half a minute on a CPU, so this stays one
file (one xdist worker under --dist loadfile)."""

import numpy as np
import torch

import __graft_entry__ as jax_entry
from cuhe_tpu_torch import entry
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_gate_step_matches_jax_entry():
    step, args = entry.entry(device="cpu")
    got = step(*args)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (2, 3, 8192)

    fn, jargs = jax_entry.entry()
    # same inputs on both sides
    for a, j in zip(args, jargs[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    want = np.asarray(fn(*jargs))
    np.testing.assert_array_equal(got.numpy(), want)
