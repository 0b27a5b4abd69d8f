"""Multi-device execution: a (batch, crt) grid of ranks, the crt-sharded
gate step, and one forward NTT split across devices.

Counterpart of ``cuhe_tpu/parallel/mesh.py``, which maps the reference's
multi-GPU model (a host thread per device, ciphertexts pinned to devices,
peer copies; CuHE.cu:42-45, 217-256) onto a JAX device mesh.  Here the mesh
is a grid of ``torch.distributed`` ranks, one device each, over two axes:

  batch : independent ciphertexts of a circuit, split evenly over the
          ranks of a crt column; no rank talks to another about them.
  crt   : the CRT-prime planes of one ciphertext, split into contiguous
          ranges (`crt_split`) whose sizes differ by at most one.  AND, the
          NTTs, Barrett and the eval-key multiply-accumulate are plane-local;
          the ICRT sums the ranks' partials with one all-reduce
          (`icrt_to_raw_sharded`); the modulus switch broadcasts the dropped
          prime's plane and all-gathers the kept ones (`ShardedGateStep`).
          The eval keys, the bulk of a level's memory, split with the planes.

Each rank runs the port's kernels on its own slice, so the sharded step
launches every kernel of the unsharded one, at its slice's shapes.  The
collectives go through `Axis`: a uint32 tensor travels as its int32 bit
cast (no collective of Gloo or NCCL takes uint32).  Each collective runs
inside a ``torch.profiler.record_function`` range ``mesh.<collective>``, so
a trace names its device kernel and any idle gap around it.  While a
`CommStats` is attached (`Mesh.count_collectives`), each collective's calls
and bytes are added to it on the host, with no device synchronisation;
`Mesh.time_collectives` also adds its seconds, with the device
synchronised before and after it (a probe's reading: it stalls the
stream).  Otherwise a collective is just the call.  Nothing is overlapped
with the kernels yet.
Gloo takes CUDA tensors in all four collectives used here (all_reduce,
broadcast, all_gather, all_to_all_single; PyTorch 2.11), carrying them
through the host, so ranks that share one card run over Gloo.

`graph_step` captures a rank's step as CUDA graphs cut at its collectives,
for a rank that runs the same step again and again (a resident mesh,
``session.py``): its host then launches a step for far less than the card
takes to run it.

`ntt_fwd_sharded` is one length-n forward NTT across the ranks of an axis:
B1's column pass on a block of columns, an all-to-all at the four-step
stage boundary (the transpose), B1's row pass on a block of rows.

The process groups come from `make_mesh` inside an initialised process
group; ``parallel/run.py`` starts the ranks (`spawn`, or ``torchrun``).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..context import Context
from ..ops import crt, ntt
from ..ops import ntt_kernels as nk
from ..ops import pointwise as pw
from ..step import GateStep


def _i32(t: torch.Tensor) -> torch.Tensor:
    """uint32 -> its int32 bit cast (what a collective and a CUDA copy
    take); any other dtype as it is."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _u32(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint32) if like.dtype == torch.uint32 else t


@dataclass
class CommStats:
    """Calls, bytes and seconds of a mesh's collectives, by collective.  The
    bytes of a call are those of its result on this rank (an all-gather's
    whole output); seconds are added only while the collectives are timed
    (`Mesh.time_collectives`)."""

    seconds: collections.Counter = field(default_factory=collections.Counter)
    calls: collections.Counter = field(default_factory=collections.Counter)
    bytes: collections.Counter = field(default_factory=collections.Counter)


@dataclass(eq=False)
class Axis:
    """One axis of a mesh, as this rank sees it: the global ranks along it
    (this rank's other coordinate fixed), this rank's index among them,
    and their process group."""

    name: str
    ranks: tuple[int, ...]
    index: int
    group: object = None
    stats: CommStats | None = None
    timed: bool = False
    cut: object = None  # set while `graph_step` captures a step

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _run(self, op: str, fn, *tensors, nbytes: int | None = None) -> None:
        """fn(*tensors), a torch.distributed call that writes its results
        into `tensors`, inside the profiler range ``mesh.<op>``; with
        `stats`, its call and its result's bytes (default: the first
        tensor's) are counted, and with `timed` it is timed with the device
        synchronised around it.  While a step is captured (`cut`), the
        call is not made but handed to `cut`, to run between the graphs."""
        if self.cut is not None:
            self.cut(lambda: self._run(op, fn, *tensors, nbytes=nbytes))
            return
        with torch.profiler.record_function(f"mesh.{op}"):
            st = self.stats
            if st is None:
                fn(*tensors)
                return
            st.calls[op] += 1
            st.bytes[op] += tensors[0].nbytes if nbytes is None else nbytes
            if not self.timed:
                fn(*tensors)
                return
            cuda = tensors[0].is_cuda
            if cuda:
                torch.cuda.synchronize(tensors[0].device)
            t0 = time.perf_counter()
            fn(*tensors)
            if cuda:
                torch.cuda.synchronize(tensors[0].device)
            st.seconds[op] += time.perf_counter() - t0

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t (int32 or int64) over the axis, in place."""
        self._run("all_reduce", lambda x: dist.all_reduce(x, group=self.group),
                  t)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """t from the rank at index `src` of the axis, in place."""
        self._run("broadcast", lambda x: dist.broadcast(
            x, src=self.ranks[src], group=self.group), _i32(t))
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: t of every rank of the axis, in axis order."""
        w = _i32(t.contiguous())
        out = [torch.empty_like(w) for _ in range(self.size)]
        self._run("all_gather", lambda *x: dist.all_gather(
            list(x[:-1]), x[-1], group=self.group), *out, w,
            nbytes=self.size * w.nbytes)
        return _u32(torch.stack(out), t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t [size, ...]: block q goes to the rank at index q; returns the
        blocks received, the one from the rank at index q at q."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all: dim 0 is {t.shape[0]}, the axis "
                             f"has {self.size} ranks")
        w = _i32(t.contiguous())
        out = torch.empty_like(w)
        self._run("all_to_all", lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), out, w)
        return _u32(out, t)


class Mesh:
    """A (batch, crt) grid of ranks: ``ranks[b * n_crt + c]`` is the global
    rank at (b, c).  This rank's coordinates are (b, c); `batch` is the
    axis of its crt column (the ranks that share c), `crt` that of its
    batch row (the ranks that share b).  Without process groups (the
    defaults) it only says who is where."""

    def __init__(self, n_batch: int, n_crt: int, ranks, rank: int, device, *,
                 batch_group=None, crt_group=None):
        ranks = tuple(int(r) for r in ranks)
        if n_batch < 1 or n_crt < 1 or len(ranks) != n_batch * n_crt:
            raise ValueError(f"a {n_batch} x {n_crt} mesh needs "
                             f"{n_batch * n_crt} ranks, got {len(ranks)}")
        if len(set(ranks)) != len(ranks) or rank not in ranks:
            raise ValueError(f"rank {rank} is not once in {ranks}")
        self.shape = (n_batch, n_crt)
        self.ranks = ranks
        self.rank = rank
        self.device = torch.device(device)
        self.b, self.c = divmod(ranks.index(rank), n_crt)
        self.batch = Axis("batch", ranks[self.c::n_crt], self.b, batch_group)
        self.crt = Axis("crt", ranks[self.b * n_crt:(self.b + 1) * n_crt],
                        self.c, crt_group)

    def count_collectives(self, stats: CommStats | None, *,
                          timed: bool = False) -> None:
        """Add the calls and bytes of each collective on either axis to
        `stats`, on the host; with `timed`, also its seconds, with the
        device synchronised around it.  None stops the counting."""
        for ax in (self.batch, self.crt):
            ax.stats, ax.timed = stats, timed and stats is not None

    def time_collectives(self, stats: CommStats | None) -> None:
        """`count_collectives` with the seconds: each collective on either
        axis synchronises the device around it; None stops the timing."""
        self.count_collectives(stats, timed=True)

    def axis(self, name: str) -> Axis:
        if name not in ("batch", "crt"):
            raise ValueError(f"no mesh axis {name!r}: 'batch' or 'crt'")
        return getattr(self, name)


def make_mesh(n_batch: int, n_crt: int, device, ranks=None) -> Mesh | None:
    """The (n_batch, n_crt) mesh over `ranks` (default: the whole world, in
    rank order) of the initialised default process group.

    Every rank of the world calls it, with the same arguments and in the
    same order as every other (each process group is created by all of
    them); a rank outside `ranks` gets None.  Raises unless the mesh's size
    equals the number of ranks (the world's, without `ranks`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.run.spawn, or torchrun)")
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if len(ranks) != n_batch * n_crt:
        raise ValueError(f"a {n_batch} x {n_crt} mesh needs "
                         f"{n_batch * n_crt} ranks, have {len(ranks)}")
    if not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} outside the world of {world}")
    batch_groups = [dist.new_group(list(ranks[c::n_crt]))
                    for c in range(n_crt)]
    crt_groups = [dist.new_group(list(ranks[b * n_crt:(b + 1) * n_crt]))
                  for b in range(n_batch)]
    me = dist.get_rank()
    if me not in ranks:
        return None
    b, c = divmod(ranks.index(me), n_crt)
    return Mesh(n_batch, n_crt, ranks, me, device,
                batch_group=batch_groups[c], crt_group=crt_groups[b])


def graph_step(mesh: Mesh, step, *args):
    """`step(*args)` of this rank (CUDA tensors), captured once as CUDA
    graphs cut at its collectives, for a caller that runs the same step on
    the same buffers again and again: a rank's host takes longer to launch
    a step's kernels than its card takes to run them.

    Returns (replay, out): replay() launches the graphs in order and makes
    each collective of `mesh` between them, on the buffers of the capture,
    as the step would (counted, timed and ranged as any collective), and
    writes the result into `out`, the same tensor at every replay (a caller
    that keeps an output clones it).  The collectives stay out of the
    graphs: they run as the eager step's do.  The graphs share one memory
    pool, in the order of their capture, which is thread-local, so that
    other threads (NCCL's watchdog) may use the device meanwhile.  One
    call of the step runs first, on the capturing stream."""
    dev = mesh.device
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(*args)
    torch.cuda.synchronize(dev)
    graphs, parts = [], []

    def begin():
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=graphs[0].pool() if graphs else None,
                        capture_error_mode="thread_local")
        graphs.append(g)

    def cut(call):
        graphs[-1].capture_end()
        parts.extend((graphs[-1].replay, call))
        begin()

    axes = (mesh.batch, mesh.crt)
    with torch.cuda.stream(side):
        try:
            for ax in axes:
                ax.cut = cut
            begin()
            out = step(*args)
            graphs[-1].capture_end()
            parts.append(graphs[-1].replay)
        finally:
            for ax in axes:
                ax.cut = None
    torch.cuda.current_stream(dev).wait_stream(side)

    def replay():
        for part in parts:
            part()

    return replay, out


def crt_split(pnum: int, n_crt: int) -> list[tuple[int, int]]:
    """The planes [c0, c1) of each crt rank: contiguous ranges whose sizes
    differ by at most one, the larger ones first (25 over 4: 7, 6, 6, 6;
    4 over 3: 2, 1, 1, the last rank holding only the last plane)."""
    if not 1 <= n_crt <= pnum:
        raise ValueError(f"{pnum} planes over {n_crt} crt ranks: every rank "
                         f"needs a plane")
    q, r = divmod(pnum, n_crt)
    out, c0 = [], 0
    for c in range(n_crt):
        out.append((c0, c0 + q + (c < r)))
        c0 = out[-1][1]
    return out


def shard_ciphertext(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a ciphertext batch x [batch, pnum, ...]: its
    batch rows (batch splits evenly over the batch axis) and its planes
    (`crt_split`), contiguous."""
    nb, nc = mesh.shape
    if x.shape[0] % nb:
        raise ValueError(f"batch {x.shape[0]} does not split over {nb} ranks")
    per = x.shape[0] // nb
    c0, c1 = crt_split(x.shape[1], nc)[mesh.c]
    return _u32(_i32(x)[mesh.b * per:(mesh.b + 1) * per, c0:c1].contiguous(),
                x)


def gather_planes(local: torch.Tensor, axis: Axis, sizes) -> torch.Tensor:
    """All-gather over `axis` of blocks of planes [.., sizes[q], L] (dim -2)
    that differ in size: each is padded to the largest, gathered, and cut
    back; returns [.., sum(sizes), L] in axis order."""
    top = max(sizes)
    w = _i32(local)
    pad = w.new_zeros(w.shape[:-2] + (top, w.shape[-1]))
    pad[..., : w.shape[-2], :] = w
    parts = axis.all_gather(pad)
    return _u32(torch.cat([parts[q][..., : sizes[q], :]
                           for q in range(axis.size)], dim=-2), local)


def gather_batch(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-gather over the batch axis of blocks [B_local, ...]: the whole
    batch [n_batch * B_local, ...] on every rank of the crt column."""
    parts = mesh.batch.all_gather(local)
    return parts.reshape((-1,) + tuple(local.shape[1:]))


def gather_ciphertext(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole ciphertext batch on every rank from the blocks that
    `shard_ciphertext` cut: the planes over the crt axis, then the batch."""
    n = torch.tensor([local.shape[-2]], dtype=torch.int64, device=local.device)
    sizes = mesh.crt.all_gather(n)[:, 0].tolist()
    return gather_batch(gather_planes(local, mesh.crt, sizes), mesh)


def icrt_to_raw_sharded(mesh: Mesh, crt_local, primes, bi, mi_words,
                        m_words) -> torch.Tensor:
    """ICRT over a crt-sharded prime axis.

    crt_local: uint32 [.., k, L], this rank's planes; primes, bi [k] and
    mi_words [k, words] their constants; m_words [words] the global M.  The
    ICRT kernel (B3) sums this rank's primes into a value in [0, M), and
    `crt.icrt_psum_combine` adds the crt ranks' partials mod M with one
    all-reduce.  Returns RAW uint32 [.., words, L], the same on every rank
    of the crt axis."""
    part = crt.icrt_to_raw(crt_local, primes, bi, mi_words, m_words)
    return crt.icrt_psum_combine(part, m_words, mesh.crt, mesh.crt.size)


def _cut(t: torch.Tensor, dim: int, c0: int, c1: int) -> torch.Tensor:
    """A contiguous copy of planes c0..c1-1 of t along dim."""
    return _u32(_i32(t).narrow(dim, c0, c1 - c0).contiguous(), t)


class ShardedGateStep(GateStep):
    """`GateStep` on this rank's block of a (batch, crt) mesh.

    Takes the rank's block of the NTT-domain operands, uint32 [B_local, k,
    n] with k = c1 - c0 planes of `crt_split(pnum, n_crt)`, and returns the
    level-lvl+1 CRT residues of its B_local ciphertexts, uint32 [B_local,
    pnum-1, n/2], the same on every rank of its crt axis (`gather_batch`
    gives the whole batch).  The module holds only its planes of the level
    tables and of the eval keys ([knum, k, n], cut once here): a caller
    that built `ctx` for this step alone drops ``ctx.ek_ntt`` afterwards,
    so that the rank keeps only its slice of the keys.

    Every step but two is plane-local and runs as in GateStep, on the
    rank's planes: the ICRT sums the crt ranks' partials
    (`icrt_to_raw_sharded`), and the modulus switch takes the dropped
    prime's plane from the last crt rank, which holds it (a broadcast), and
    all-gathers the kept planes."""

    _PLANE_TABLES = ("primes", "bi", "mi_words", "u_lo", "u_hi", "m_lo",
                     "m_hi", "m_crt")

    def __init__(self, ctx: Context, lvl: int, mesh: Mesh):
        super().__init__(ctx, lvl)
        self.mesh = mesh
        pn = self.pn
        split = crt_split(pn, mesh.crt.size)
        c0, c1 = split[mesh.crt.index]
        self.planes = (c0, c1)
        self.p_last = int(ctx.primes_np[pn - 1])
        # each crt rank's planes below the dropped one
        self.kept = [max(0, min(q1, pn - 1) - q0) for q0, q1 in split]
        for name in self._PLANE_TABLES:
            setattr(self, name, _cut(getattr(self, name), 0, c0, c1))
        self.ek_lo = _cut(self.ek_lo, 1, c0, c1)
        self.ek_hi = _cut(self.ek_hi, 1, c0, c1)
        k = self.kept[mesh.crt.index]
        self.invp_last = _cut(self.invp_last, 0, c0, c0 + k)
        # the modulus switch's primes: this rank's kept planes', then p_t
        self.register_buffer("switch_primes", torch.from_numpy(np.array(
            list(ctx.primes_np[c0:c0 + k]) + [self.p_last],
            dtype=np.uint32)).to(self.primes.device), persistent=False)
        self.pn = c1 - c0

    def _c2r(self, red) -> torch.Tensor:
        return icrt_to_raw_sharded(self.mesh, red, self.primes, self.bi,
                                   self.mi_words, self.m_words)

    def _mod_switch(self, red) -> torch.Tensor:
        axis = self.mesh.crt
        owner = axis.size - 1
        if axis.index == owner:
            dirty = _cut(red, -2, self.pn - 1, self.pn)[..., 0, :]
        else:
            dirty = torch.empty(red.shape[:-2] + red.shape[-1:],
                                dtype=red.dtype, device=red.device)
        axis.broadcast(dirty, owner)
        mine = pw.mod_switch_dropped(red, dirty, self.switch_primes,
                                     self.invp_last, self.mod_msg)
        return gather_planes(mine, axis, self.kept)


def ntt_fwd_sharded(mesh: Mesh, n: int, axis: str = "crt"):
    """One length-n forward NTT split across the s ranks of a mesh axis.

    Returns fn(x): x uint32 [.., n/2] the coefficients (the same on every
    rank of the axis, as the JAX function's replicated input); each rank
    takes its column block j2 of the [n1/2, n2] coefficient matrix and
    returns its block of the global output [.., n2, n1] (natural NTT
    order: element [k2, k1] is NTT index k1 + n1 k2), the pair uint32
    [.., n2, n1/s] of columns k1 = i n1/s .. (i+1) n1/s - 1 for the rank at
    index i.  In between: B1's column pass of the block, with the global
    twiddle w^(k1 j2); an all-to-all that splits k1 and joins j2 (the
    four-step transpose); B1's row pass of the rank's n1/s rows k1; the
    transpose of the block into natural order.  Raises unless s divides
    n1 and n2 (s = 8 at n = 32768 gives column blocks of 16: the column
    pass takes a block of any power of two of columns)."""
    n1, n2 = ntt.factors(n)
    ax = mesh.axis(axis)
    s = ax.size
    if n1 % s or n2 % s:
        raise ValueError(f"shard count {s} must divide n1={n1}, n2={n2}")
    cols, rows = n2 // s, n1 // s
    j2_0 = ax.index * cols

    def call(x: torch.Tensor):
        lead = tuple(x.shape[:-1])
        xb = _i32(x).reshape(lead + (n1 // 2, n2))[..., j2_0:j2_0 + cols]
        lo, hi = nk.fwd_cols_block(_u32(xb.contiguous(), x), n, j2_0)
        # [.., n1, C] -> [s, 2, .., R, C]: rows k1 of block q to rank q
        send = torch.stack((_i32(lo), _i32(hi))).reshape(
            (2,) + lead + (s, rows, cols)).movedim(-3, 0)
        got = ax.all_to_all(send)            # [s, 2, .., R, C] by source
        c = got.movedim(0, -2).reshape((2,) + lead + (rows, n2))
        d = nk.fwd_rows_block((_u32(c[0].contiguous(), x),
                               _u32(c[1].contiguous(), x)), n)
        return tuple(_u32(_i32(v).transpose(-1, -2).contiguous(), x)
                     for v in d)

    return call
