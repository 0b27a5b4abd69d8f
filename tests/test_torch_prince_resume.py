"""The port's homomorphic PRINCE beyond its first layer, on the CPU, at the
light depth-5 ring CuDHS(5, 2, 16, 50, 25, 8191, seed=13), on the port
alone (the first layer is held against the JAX package in
test_torch_prince_circuit.py):

  * the state saved after S-box layer 1 (utils/checkpoint.py) holds that
    layer's state, level and layer count bit for bit, and loads in the JAX
    package's cuhe_tpu.utils.checkpoint.load_state;
  * a Prince of the same seed resumed from that checkpoint runs S-box
    layer 2 (its checks fire from the resume point on), and that layer
    decrypts to the published round-1 vector (Prince.cu:108).

One keygen serves both runs: each runs on a copy of the keyed scheme, whose
sampler is where a fresh CuDHS of the same seed leaves it after keygen, so
the resumed run re-derives the straight run's key ciphertexts.
"""

import copy

import numpy as np
import pytest

from cuhe_tpu.utils import checkpoint as jckpt
from cuhe_tpu_torch.dhs import CuDHS
from cuhe_tpu_torch.models import prince as pr
from cuhe_tpu_torch.utils import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = (5, 2, 16, 50, 25, 8191)
SEED = 13
A, B, C = [0] * 64, [1] * 64, [0] * 64


@pytest.fixture(scope="module")
def keyed():
    """The scheme right after keygen of the seed (copied for each run)."""
    return CuDHS(*CFG, seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def straight(keyed, tmp_path_factory):
    """S-box layer 1 from the start, the state checkpointed after it:
    (prince, {round: (state, level)}, state, checkpoint path)."""
    path = str(tmp_path_factory.mktemp("prince") / "layer01.npz")
    p = pr.Prince(dhs=copy.deepcopy(keyed))
    seen = {}

    def check(rd, state, lvl):
        seen[rd] = (state, lvl)

    def on_layer(done, state, lvl):
        ckpt.save_state(path, state, lvl, done=done)

    state = p.encrypt_blocks(A, B, C, max_rounds=1, check=check,
                             on_layer=on_layer)
    return p, seen, state, path


@pytest.fixture(scope="module")
def resumed(keyed, straight):
    """A Prince of the same seed resumed from the checkpoint through S-box
    layer 2: (prince, {round: (state, level)}, state)."""
    path = straight[3]
    state, lvl = ckpt.load_state(path, device="cpu")
    done = int(np.load(path)["done"])
    p2 = pr.Prince(dhs=copy.deepcopy(keyed))
    seen = {}

    def check(rd, s, level):
        seen[rd] = (s, level)

    got = p2.encrypt_blocks(A, B, C, max_rounds=2, check=check,
                            resume=(state, lvl, done))
    return p2, seen, got


def test_second_layer_decrypts_to_round_1(resumed):
    """Resumed at layer 1, the run's checks start at the resume point (the
    loaded state, round 0 at level 2) and its layer 2 decrypts right."""
    p2, seen, state = resumed
    assert p2.level == 4 and sorted(seen) == [0, 1]
    assert seen[0][1] == 2 and seen[1][1] == 4 and seen[1][0] is state
    bits = p2.decrypt_state(state, 4)
    assert "".join(map(str, bits)) == pr.Prince.EXPECTED_ROUNDS[1]


def test_checkpoint_loads_in_jax(straight):
    _, seen, _, path = straight
    state, lvl = jckpt.load_state(path)
    assert lvl == 2 and int(np.load(path)["done"]) == 1
    np.testing.assert_array_equal(np.asarray(state), seen[0][0].numpy())


def test_resume_after_layer_1_is_bit_equal(straight):
    """The checkpoint the resumed run starts from is the straight run's
    state after layer 1, bit for bit, at its level and layer count."""
    p, seen, want, path = straight
    assert p.level == 2 and sorted(seen) == [0]
    assert seen[0][0] is want and seen[0][1] == 2
    state, lvl = ckpt.load_state(path, device="cpu")
    assert lvl == p.level and int(np.load(path)["done"]) == 1
    assert state.dtype == want.dtype
    np.testing.assert_array_equal(state.numpy(), want.numpy())


def test_resume_skips_the_message_encryption_but_not_its_samples(keyed):
    """A resumed run draws the message's samples without encrypting it, so
    the keys' ciphertexts are those of the straight run."""
    enc, skip = copy.deepcopy(keyed), copy.deepcopy(keyed)
    enc.encrypt_many([[1], [0], [1]], 0)
    skip.skip_encryptions(3)
    assert enc._rng.bit_generator.state == skip._rng.bit_generator.state
    assert enc.encrypt([1], 0) == skip.encrypt([1], 0)
