"""The port's homomorphic PRINCE beyond its first layer, on the CPU, at the
light depth-5 ring CuDHS(5, 2, 16, 50, 25, 8191, seed=13), on the port
alone (the first layer is held against the JAX package in
test_torch_prince_circuit.py):

  * S-box layer 2 decrypts to the published round-1 vector (Prince.cu:108);
  * the state saved after layer 1 (utils/checkpoint.py) loads in the JAX
    package's cuhe_tpu.utils.checkpoint.load_state;
  * a Prince of the same seed resumed from that checkpoint gives layer 2
    bit for bit.
"""

import numpy as np
import pytest
import torch

from cuhe_tpu.utils import checkpoint as jckpt
from cuhe_tpu_torch.dhs import CuDHS
from cuhe_tpu_torch.models import prince as pr
from cuhe_tpu_torch.utils import checkpoint as ckpt

CFG = (5, 2, 16, 50, 25, 8191)
SEED = 13
A, B, C = [0] * 64, [1] * 64, [0] * 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread while this module runs: the test workers
    share the machine's cores, and each worker's spinning OpenMP threads
    multiplied these tests' CPU time several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prince():
    return pr.Prince(dhs=CuDHS(*CFG, seed=SEED, device="cpu"))


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Two S-box layers in one run, the state checkpointed after layer 1:
    (prince, {round: (state, level)}, final state, checkpoint path)."""
    path = str(tmp_path_factory.mktemp("prince") / "layer01.npz")
    p = _prince()
    seen = {}

    def check(rd, state, lvl):
        seen[rd] = (state, lvl)

    def on_layer(done, state, lvl):
        if done == 1:
            ckpt.save_state(path, state, lvl, done=done)

    state = p.encrypt_blocks(A, B, C, max_rounds=2, check=check,
                             on_layer=on_layer)
    return p, seen, state, path


def test_second_layer_decrypts_to_round_1(straight):
    p, seen, state, _ = straight
    assert p.level == 4 and sorted(seen) == [0, 1]
    assert seen[0][1] == 2 and seen[1][1] == 4 and seen[1][0] is state
    bits = p.decrypt_state(state, 4)
    assert "".join(map(str, bits)) == pr.Prince.EXPECTED_ROUNDS[1]


def test_checkpoint_loads_in_jax(straight):
    _, seen, _, path = straight
    state, lvl = jckpt.load_state(path)
    assert lvl == 2 and int(np.load(path)["done"]) == 1
    np.testing.assert_array_equal(np.asarray(state), seen[0][0].numpy())


def test_resume_after_layer_1_is_bit_equal(straight):
    _, _, want, path = straight
    state, lvl = ckpt.load_state(path, device="cpu")
    done = int(np.load(path)["done"])
    p2 = _prince()
    got = p2.encrypt_blocks(A, B, C, max_rounds=2, resume=(state, lvl, done))
    assert p2.level == 4
    np.testing.assert_array_equal(got.numpy(), want.numpy())
