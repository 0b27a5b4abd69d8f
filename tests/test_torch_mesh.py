"""The port's multi-device execution (cuhe_tpu_torch/parallel) against the
JAX package's (cuhe_tpu/parallel/mesh.py), bit for bit (tolerance 0), at
make_params(3, 2, 16, 50, 25, 8191) (16k ring, 4 primes) and the JAX
entry's seeded eval keys (rng 0):

  * icrt_to_raw_sharded on meshes (4, 2) and (2, 4) against the JAX
    shard_map ICRT on the same meshes of 8 virtual CPU devices, and on the
    ragged (1, 3) split (2 + 1 + 1 planes) against the unsharded ICRT;
  * ntt_fwd_sharded, one 16k NTT across 8, 4 and 2 ranks, against the JAX
    ntt_fwd_sharded on meshes (1, s);
  * ShardedGateStep on meshes (4, 2), (2, 4), (2, 1) and (1, 3) (whose last
    rank holds only the dropped prime) on batch 4, against the unsharded
    JAX step jax.jit(batched_and_relin_modswitch(ctx, 0)) (the JAX package
    holds its own sharded step equal to it, tests/test_sharding.py);
  * the pointwise AND and the shard -> gather round trip;
  * icrt_combine_halves against Python ints, crt_split and the Mesh's
    coordinates, with no process group.

The port's side runs in one start of 8 Gloo ranks on the CPU
(tests/torch_mesh_cases.py), while the test process computes the JAX side.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import torch_mesh_cases as cases
from cuhe_tpu.ops import crt as jcrt
from cuhe_tpu.ops import pointwise as jpw
from cuhe_tpu.parallel import mesh as jmesh
from cuhe_tpu_torch.ops import crt
from cuhe_tpu_torch.parallel import mesh as pmesh
from cuhe_tpu_torch.parallel import run
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def jctx():
    return jax_entry._make_ctx()


@pytest.fixture(scope="module")
def inputs(jctx):
    pr = jctx.params
    rng = np.random.default_rng(7)
    ps = np.array(pr.crt_primes[:4], dtype=np.uint64)
    return {
        "crt": (rng.integers(0, 1 << 62, size=(8, 4, pr.crt_len),
                             dtype=np.uint64)
                % ps[None, :, None]).astype(np.uint32),
        "ntt_x": rng.integers(0, 1 << 31, size=(2, cases.NTT_N // 2),
                              dtype=np.uint32),
        # the JAX entry's inputs (rng 1) at batch 4
        "step_args": jax_entry._example_batch(jctx, cases.STEP_BATCH),
    }


@pytest.fixture(scope="module")
def started(inputs):
    """The 8 ranks, started before the JAX side is computed."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run.spawn, 4, 2, cases.run_cases, inputs,
                          backend="gloo", device="cpu",
                          timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def want(started, jctx, inputs):
    """The JAX package's results, computed while the ranks run."""
    m_words, mi_words, bi = jctx._icrt[0]
    pn = jctx.params.num_crt_prime
    icrt_args = (jnp.asarray(inputs["crt"]), jnp.asarray(jctx.primes_np[:pn]),
                 jnp.asarray(jctx.mus_np[0][:pn]),
                 jnp.asarray(jctx.mus_np[1][:pn]), jnp.asarray(bi),
                 jnp.asarray(mi_words), jnp.asarray(m_words))
    out = {}
    for name, nb, nc in cases.ICRT_MESHES:
        if nb * nc == 8:
            fn = jmesh.icrt_to_raw_sharded(jmesh.make_mesh(nb, nc))
        else:
            fn = jax.jit(lambda c, p, ml, mh, b, mi, m: jcrt.icrt_to_raw(
                c, p, (ml, mh), b, mi, m))
        out[f"icrt {name}"] = np.asarray(fn(*icrt_args))
    for s in cases.NTT_SHARDS:
        mesh = jmesh.make_mesh(1, s, devices=jax.devices()[:s])
        got = jmesh.ntt_fwd_sharded(mesh, cases.NTT_N)(
            jnp.asarray(inputs["ntt_x"]))
        out[f"ntt {s}"] = np.stack([np.asarray(v) for v in got])
    args = tuple(jnp.asarray(v) for v in inputs["step_args"])
    step = jax.jit(jmesh.batched_and_relin_modswitch(jctx, 0))
    step_out = np.asarray(step(*args, *jmesh.step_table_args(jctx)))
    for name, _, _ in cases.STEP_MESHES:
        out[f"step {name}"] = step_out
    out["and 4x2"] = np.stack([np.asarray(v) for v in jax.jit(jpw.ntt_mul)(
        args[:2], args[2:])])
    for name, _, _ in cases.ROUNDTRIP_MESHES:
        out[f"roundtrip {name}"] = inputs["step_args"][0]
    return out


@pytest.fixture(scope="module")
def ranks(started, want):
    return started.result(timeout=SPAWN_TIMEOUT + 30)


CASES = ([f"icrt {m[0]}" for m in cases.ICRT_MESHES]
         + [f"ntt {s}" for s in cases.NTT_SHARDS]
         + [f"step {m[0]}" for m in cases.STEP_MESHES]
         + ["and 4x2"]
         + [f"roundtrip {m[0]}" for m in cases.ROUNDTRIP_MESHES])


@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_jax(case, ranks, want):
    got = ranks[0][case]
    assert got.dtype == want[case].dtype and got.shape == want[case].shape
    np.testing.assert_array_equal(got, want[case])


@pytest.mark.parametrize("mesh", [m[0] for m in cases.STEP_MESHES])
def test_step_blocks_and_key_slices(mesh, ranks):
    """Every rank of a crt axis returns the same [B_local, 3, 8192] block,
    whatever planes it holds (on (1, 3) the last rank holds only the
    dropped plane 3), and holds only its own planes of the eval keys."""
    nb, nc = dict((m[0], m[1:]) for m in cases.STEP_MESHES)[mesh]
    blocks = [r[f"step {mesh} block"] for r in ranks[: nb * nc]]
    splits = pmesh.crt_split(4, nc)
    for b in range(nb):
        row = [blk for blk in blocks if blk[0] == b]
        assert [blk[2:4] for blk in row] == splits
        assert {blk[4] for blk in row} == {(cases.STEP_BATCH // nb, 3, 8192)}
        assert len({blk[5] for blk in row}) == 1
    for r, (b, c, c0, c1, _, _) in zip(ranks, blocks):
        shape, equal = r[f"step {mesh} keys"]
        assert shape == (7, c1 - c0, 16384) and equal


def test_icrt_blocks_replicated_over_crt(ranks):
    """The combined ICRT is the same on every rank of a crt axis."""
    for name, nb, nc in cases.ICRT_MESHES:
        for b in range(nb):
            row = ranks[b * nc:(b + 1) * nc]
            assert len({r[f"icrt {name} block"] for r in row}) == 1


def test_make_mesh_on_a_world_of_another_size_raises(ranks):
    assert all("needs 9 ranks, have 8" in r["wrong_world"] for r in ranks)


M_WORDS = (0xFFFFFFFB, 0xFFFFFFEF, 0x7FFFFFFF)  # M < 2^95


@pytest.mark.parametrize("n_shards", range(1, 9))
def test_combine_halves_against_python_ints(n_shards):
    """Partials of M - 1 on every shard (the most subtracts), random
    partials below M, and zeros: icrt_combine_halves gives the sum mod M."""
    words = len(M_WORDS)
    m = sum(w << (32 * i) for i, w in enumerate(M_WORDS))
    rng = np.random.default_rng(n_shards)
    parts = [[m - 1] * 3 + [int(rng.integers(0, 1 << 62)) * (1 << 31) % m
                            for _ in range(5)] + [0]
             for _ in range(n_shards)]
    cols = len(parts[0])

    def planes(vals):
        return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for v in vals]
                         for i in range(words)], dtype=np.uint64)

    lo16 = sum(planes(p) & 0xFFFF for p in parts).astype(np.int32)
    hi16 = sum(planes(p) >> 16 for p in parts).astype(np.int32)
    got = crt.icrt_combine_halves(
        torch.from_numpy(lo16), torch.from_numpy(hi16),
        torch.tensor(M_WORDS, dtype=torch.int64), n_shards)
    want = planes([sum(p[j] for p in parts) % m for j in range(cols)])
    np.testing.assert_array_equal(crt.modp.to_i64(got).numpy(),
                                  want.astype(np.int64))


def test_crt_split():
    assert pmesh.crt_split(4, 3) == [(0, 2), (2, 3), (3, 4)]
    assert pmesh.crt_split(25, 4) == [(0, 7), (7, 13), (13, 19), (19, 25)]
    assert pmesh.crt_split(25, 2) == [(0, 13), (13, 25)]
    assert pmesh.crt_split(4, 4) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    for pnum in range(1, 30):
        for nc in range(1, pnum + 1):
            sizes = [c1 - c0 for c0, c1 in pmesh.crt_split(pnum, nc)]
            assert sum(sizes) == pnum and max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError, match="every rank needs a plane"):
        pmesh.crt_split(3, 4)


def test_mesh_coordinates_without_process_groups():
    m = pmesh.Mesh(2, 3, range(6), 4, "cpu")
    assert (m.b, m.c) == (1, 1) and m.shape == (2, 3)
    assert m.batch.ranks == (1, 4) and m.batch.index == 1
    assert m.crt.ranks == (3, 4, 5) and m.crt.index == 1
    assert m.axis("crt") is m.crt
    sub = pmesh.Mesh(1, 2, (5, 2), 2, "cpu")
    assert (sub.b, sub.c) == (0, 1) and sub.crt.ranks == (5, 2)
    with pytest.raises(ValueError, match="needs 6 ranks"):
        pmesh.Mesh(2, 3, range(5), 0, "cpu")
    with pytest.raises(ValueError, match="axis"):
        m.axis("model")


def test_collectives_are_timed_only_while_stats_are_attached():
    """A collective is just its call until `time_collectives` attaches a
    CommStats to both axes; then its seconds and calls are added to it."""
    m = pmesh.Mesh(2, 2, range(4), 3, "cpu")
    calls = []

    def op(t):
        calls.append(t)

    t = torch.zeros(2, dtype=torch.int32)
    m.crt._run("all_reduce", op, t)
    assert calls == [t] and m.crt.stats is None and m.batch.stats is None
    stats = pmesh.CommStats()
    m.time_collectives(stats)
    m.crt._run("all_reduce", op, t)
    m.batch._run("all_gather", op, t)
    assert len(calls) == 3
    assert stats.calls == {"all_reduce": 1, "all_gather": 1}
    assert set(stats.seconds) == {"all_reduce", "all_gather"}
    m.time_collectives(None)
    m.crt._run("all_reduce", op, t)
    assert len(calls) == 4 and stats.calls["all_reduce"] == 1
