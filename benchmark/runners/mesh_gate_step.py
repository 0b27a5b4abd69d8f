"""The crt-sharded gate step (`cuhe_tpu_torch.parallel.mesh.ShardedGateStep`)
on a resident (batch, crt) mesh of ranks, one card each: cuHE's multi-GPU
gate step, the mix's whole batch of ciphertext pairs a step over the mesh,
back to back.

The ranks are the port's own `MeshSession` (NCCL on CUDA, Gloo on the CPU):
this process is rank 0, on the harness's device, and every rank builds its
state once (`rank_setup`).  Each rank draws the keys and operands of
`gate_step.draw` from the seed, keeps its block (`shard_ciphertext`: its
ciphertexts, its planes) and its planes of the eval keys, and drops the
rest; no keygen runs.  On a card each rank captures its step once as
CUDA graphs cut at its collectives (`parallel.mesh.graph_step`) and
replays them, with the collectives between: a rank's host takes longer to
launch a step's kernels than its card takes to run them.  The steps are posted (`MeshSession.post`), so no
rank's host waits for another's.

A step counts where every rank finished it inside the window: each rank
records an event after each step against a start event recorded after a
synchronise, and the latest finish over the ranks is the step's.  Each rank
keeps one seed-drawn step of the first `keep_first` and the last step of
the window.  Before the session closes, rank 0 gathers them (the batch
axis, then the crt axis: both crt columns' copies of the whole batch), and
the check compares every copy word for word with the plain reference, as
`gate_step` does.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.core import traffic as tg
from benchmark.reference.ring import Ring
from benchmark.runners import gate_step
from cuhe_tpu_torch.parallel import mesh as pmesh
from cuhe_tpu_torch.parallel.session import MeshSession

SESSION_TIMEOUT = 300.0  # seconds: start-up, a step, or a rank's failure


def rank_setup(mesh, params, lvl, batch, seed, traffic):
    return RankStep(mesh, params, lvl, batch, seed, traffic)


class RankStep:
    """One rank's block of the step, its inputs, clocks and kept outputs."""

    def __init__(self, mesh, params, lvl, batch, seed, traffic):
        from cuhe_tpu_torch.context import Context
        from cuhe_tpu_torch.params import make_params

        self.mesh, self.device = mesh, mesh.device
        self.schedule = tg.Schedule(traffic, seed)
        ring = Ring(*params)
        pn = ring.pn(lvl)
        ctx = Context(make_params(*params), self.device)
        ek, a, b = gate_step.draw(seed, ring, batch, self.device)
        ctx.set_eval_keys(*ek)
        del ek
        self.step = pmesh.ShardedGateStep(ctx, lvl, mesh)
        ctx.ek_ntt = None  # the step holds this rank's planes of the keys
        self.inputs = tuple(pmesh.shard_ciphertext(v[:, :pn], mesh)
                            for v in (*a, *b))
        del a, b
        self.stats = pmesh.CommStats()  # counted, not timed
        mesh.count_collectives(self.stats)
        self.step(*self.inputs)  # builds and loads the kernels, opens groups
        self.counting = False
        # on a card, the step is captured once and replayed: a rank's host
        # enqueues a step's launches more slowly than its card runs them
        self.replay = None
        if self.device.type == "cuda":
            self.replay, self.out = pmesh.graph_step(mesh, self.step,
                                                     *self.inputs)

    # an event on a card, the host's clock on the CPU, as gate_step's
    _clock = gate_step.Runner._clock
    _ms = gate_step.Runner._ms

    def run_step(self) -> None:
        if self.replay is None:
            self.out = self.step(*self.inputs)
        else:
            self.replay()
        if self.counting:
            self.ends.append(self._clock())
            if self.schedule.keep(len(self.ends) - 1):
                self.kept[len(self.ends) - 1] = self.out.clone()

    def start(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.bytes.clear()
        self.kept, self.ends = {}, []
        self.counting = True
        self.t0 = self._clock()

    def finish(self) -> tuple[list, float]:
        """The ms from the start to each step's end, and the bytes this
        rank moved in collectives a step."""
        self.counting = False
        if self.ends:
            self.kept[len(self.ends) - 1] = self.out.clone()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return ([self._ms(self.t0, e) for e in self.ends],
                sum(self.stats.bytes.values()) / max(1, len(self.ends)))

    def gather(self):
        """Rank 0: the kept steps' outputs of both crt columns, {step:
        [n_crt, batch, pn - 1, n / 2]}; None on the other ranks."""
        out = {}
        for i in sorted(self.kept):
            whole = pmesh.gather_batch(self.kept[i], self.mesh)
            out[i] = self.mesh.crt.all_gather(whole)
        self.kept = {}
        return out if self.mesh.rank == self.mesh.ranks[0] else None


class Runner(gate_step.Runner):
    """`gate_step.Runner`'s check, reference and shapes, on the mesh."""

    SETUP = staticmethod(rank_setup)

    def __init__(self, cell, seed, device, spans):
        tr = cell.traffic
        self.seed, self.device, self.spans = seed, device, spans
        self.params = gate_step.params_of(cell.config)
        self.ring = Ring(*self.params)
        self.batch, self.lvl = int(tr["batch"]), int(tr["level"])
        n_batch, n_crt = (int(v) for v in tr["mesh"])
        self.session = MeshSession(
            n_batch, n_crt, self.SETUP, self.params, self.lvl, self.batch,
            seed, dict(tr), backend="nccl" if device.type == "cuda" else "gloo",
            device=device.type, timeout=SESSION_TIMEOUT)

    def op(self):
        """One step on every rank, posted: no rank's host waits for
        another's (the collectives keep the cards in step)."""
        with self.spans("bench.mesh_step"):
            self.session.post("run_step")

    def window(self, seconds: float) -> dict:
        """Steps back to back on every rank for `seconds`."""
        self.session.run("start")
        t0 = time.perf_counter()
        i = 0
        while True:
            self.op()
            i += 1
            if time.perf_counter() - t0 >= seconds + 0.02:
                break
        ranks = self.session.run("finish")
        done = [max(ends[k] for ends, _ in ranks) for k in range(i)]
        inside = sum(1 for t in done if t <= seconds * 1e3)
        return {"attempted": i, "ct_done": inside * self.batch,
                "seconds": seconds, "collective_bytes_per_step": ranks[0][1]}

    def release(self):
        t0 = time.perf_counter()
        gathered = self.session.run("gather")[0]
        t1 = time.perf_counter()
        self.session.close()
        print(f"mesh: gather {t1 - t0:.3f} s, close "
              f"{time.perf_counter() - t1:.3f} s, ranks 1-"
              f"{len(self.session.exitcodes)} exit codes "
              f"{self.session.exitcodes}", file=sys.stderr)
        # one output of the whole batch a kept step and crt column
        self.kept = {(i, c): v[c] for i, v in gathered.items()
                     for c in range(v.shape[0])}
