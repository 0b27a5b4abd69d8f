"""A resident mesh: ranks that stay up and run operations on command.

`run.spawn` starts a mesh's ranks, runs one function on each and tears
them down.  A deployment keeps its ranks and feeds them work, and the
process that serves or times the work is one of them.  `MeshSession` is
that mesh:

  * the calling process joins as rank 0, on the first device (cuda:0 for
    CUDA); ranks 1..R-1 are spawned once, one device each (as `spawn`
    places them), and the kernels are built once, by rank 0, first;
  * every rank builds its state once, ``state = setup(mesh, *args)``
    (`setup` a module-level function: the workers import it by name);
  * ``run(name, *args)`` calls ``state.<name>(*args)`` on every rank, in
    lockstep, and returns the results in rank order: rank 0's as it is, a
    worker's pickled (keep it off the device: plain values, numpy, CPU
    tensors);
  * ``post(name, *args)`` does the same without waiting for the workers:
    they run the operation in turn, and only rank 0's result comes back;
  * ``close()`` stops the workers and destroys the process groups.

Control travels on one pipe a worker, off the device stream: rank 0 sends
each worker the operation's name and arguments, runs its own part, then,
for `run`, waits for every worker's answer.  Nothing of it touches the
device.  A round trip costs each step a few hundred microseconds of every
host and ties the ranks' hosts together, so a loop of steps posts them:
each rank's host then runs ahead of its card as a single process would,
and the collectives alone keep the cards in step.

A worker that raises sends its traceback and exits, which closes its end of
the process groups: a Gloo peer waiting on it fails at once, an NCCL peer at
the groups' `timeout`.  A worker that dies closes its pipe.  Either way rank
0 raises, after closing the session, within `timeout` seconds; so does a
worker that does not answer in that time.  No worker outlives `close()`,
and the workers are daemons of the caller.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import threading
import time
import traceback
from multiprocessing import connection

import torch
import torch.distributed as dist

from ..ops import _cuda
from .mesh import make_mesh
from .run import _rank_device, check_backend

JOIN_SECONDS = 30.0  # a worker's time to leave after `close()`
FAILURE_SECONDS = 5.0  # after one rank's failure, the wait for others'


def _worker(rank, world, shape, backend, device, store, timeout,
            conn) -> None:
    """Rank `rank`'s process: build the state, then run what rank 0 sends
    until it sends None or its pipe closes.  A failure is reported before
    the process groups go down."""
    torch.set_num_threads(1)
    try:
        try:
            setup, args = conn.recv()
            dev = _rank_device(torch.device(device), rank)
            conn.send((True, None))  # started: rank 0 may join the group
            dist.init_process_group(
                backend, init_method=f"file://{store}", rank=rank,
                world_size=world, timeout=datetime.timedelta(seconds=timeout))
            state = setup(make_mesh(*shape, dev), *args)
            conn.send((True, None))
            while (msg := conn.recv()) is not None:
                name, op_args, reply = msg
                value = getattr(state, name)(*op_args)
                if reply:
                    conn.send((True, value))
            if dev.type == "cuda":  # the last collectives reach the peers
                torch.cuda.synchronize(dev)
        except EOFError:  # rank 0 is gone
            pass
        except Exception:  # reported to rank 0, which raises
            try:
                conn.send((False, traceback.format_exc()))
            except OSError:
                pass
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


class MeshSession:
    """An (n_batch, n_crt) mesh whose rank 0 is this process; see the
    module's docstring.  A context manager: leaving it closes it."""

    def __init__(self, n_batch: int, n_crt: int, setup, *args, backend: str,
                 device="cuda", timeout: float = 300.0):
        if dist.is_initialized():
            raise RuntimeError("this process is already in a process group")
        world = n_batch * n_crt
        dev = check_backend(backend, device, world)
        if dev.type == "cuda":
            _cuda.build()  # once, here: not one nvcc build per rank
        self.timeout = timeout
        self.state = None
        self._tmp = tempfile.TemporaryDirectory()
        self._procs, self._conns = [], []
        self._open, self._failed = True, False
        self.device = None
        store = os.path.join(self._tmp.name, "store")
        mp = torch.multiprocessing.get_context("spawn")
        try:
            for rank in range(1, world):
                mine, theirs = mp.Pipe()
                p = mp.Process(target=_worker, daemon=True, args=(
                    rank, world, (n_batch, n_crt), backend, str(dev), store,
                    timeout, theirs))
                p.start()
                theirs.close()  # its death must close the pipe here
                self._procs.append(p)
                self._conns.append(mine)
            for c in self._conns:
                c.send((setup, args))
            self._collect(timeout)  # every worker started first
            self.device = _rank_device(dev, 0)
            dist.init_process_group(backend, init_method=f"file://{store}",
                                    rank=0, world_size=world,
                                    timeout=datetime.timedelta(
                                        seconds=timeout))
            self.mesh = make_mesh(n_batch, n_crt, self.device)
            self.state = setup(self.mesh, *args)
            self._collect(timeout)
        except BaseException:
            self._fail()
            raise

    def run(self, name: str, *args) -> list:
        """state.<name>(*args) on every rank; the results in rank order.
        Raises, after closing the session, if a rank raises or dies, or a
        worker does not answer within `timeout`."""
        return self._call(name, args, True)

    def post(self, name: str, *args):
        """state.<name>(*args) on every rank, without waiting for the
        workers; returns rank 0's result.  A worker's failure is raised by
        the next `post` or `run`."""
        return self._call(name, args, False)

    def _call(self, name: str, args: tuple, reply: bool):
        if not self._open:
            raise RuntimeError("the mesh session is closed")
        try:
            # nothing is owed by a worker between calls but a failure
            if connection.wait(self._conns, timeout=0):
                self._collect(FAILURE_SECONDS)
            for c in self._conns:
                c.send((name, args, reply))
            try:
                mine = getattr(self.state, name)(*args)
            except Exception as exc:  # a worker's failure may be the cause
                try:
                    self._collect(min(FAILURE_SECONDS, self.timeout))
                except RuntimeError as workers:
                    raise workers from exc
                except TimeoutError:
                    pass
                raise
            return [mine] + self._collect(self.timeout) if reply else mine
        except BaseException:
            self._fail()
            raise

    def _collect(self, timeout: float) -> list:
        """Every worker's next answer, in rank order.  Raises RuntimeError
        naming each rank that failed or exited (waiting a little after the
        first for the others), TimeoutError if a worker has not answered
        within `timeout` seconds."""
        got, bad = {}, {}
        waiting = dict(zip(self._conns, range(1, len(self._conns) + 1)))
        deadline = time.monotonic() + timeout
        while waiting:
            ready = connection.wait(list(waiting), timeout=max(
                0.0, deadline - time.monotonic()))
            if not ready:
                break
            for c in ready:
                rank = waiting.pop(c)
                ok, value = self._answer(c, rank)
                (got if ok else bad)[rank] = value
            if bad:
                deadline = min(deadline, time.monotonic() + FAILURE_SECONDS)
        if bad:
            raise RuntimeError("\n".join(f"rank {r} {v}"
                                         for r, v in sorted(bad.items())))
        if waiting:
            raise TimeoutError(f"ranks {sorted(waiting.values())} did not "
                               f"answer in {timeout} s")
        return [got[r] for r in sorted(got)]

    def _answer(self, c, rank: int) -> tuple:
        """(True, the value) or (False, what went wrong)."""
        try:
            ok, value = c.recv()
        except EOFError:
            p = self._procs[rank - 1]
            p.join(timeout=5)
            return False, f"exited (code {p.exitcode})"
        return (True, value) if ok else (False, f"failed:\n{value}")

    def _fail(self) -> None:
        """Stop everything at once: the session is unusable."""
        self._failed = True
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        self.close()

    def close(self) -> None:
        """Stop the workers and destroy the process groups, rank 0's while
        the workers destroy theirs (NCCL's shutdown may wait for every
        rank), then join them.  After a failure the workers are gone first
        and rank 0 waits a bounded time for its own shutdown.  Records the
        workers' exit codes in `exitcodes`.  Idempotent."""
        if not self._open:
            return
        self._open = False
        if not self._failed and self.device is not None and \
                self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for c in self._conns:
            try:
                c.send(None)
            except OSError:  # the worker is gone
                pass
        self.state = None
        if dist.is_initialized():
            if self._failed:
                t = threading.Thread(target=dist.destroy_process_group,
                                     daemon=True)
                t.start()
                t.join(JOIN_SECONDS)
            else:
                dist.destroy_process_group()
        deadline = time.monotonic() + JOIN_SECONDS
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.exitcodes = [p.exitcode for p in self._procs]
        for c in self._conns:
            c.close()
        self._tmp.cleanup()

    def __enter__(self) -> MeshSession:
        return self

    def __exit__(self, *exc) -> None:
        self.close()
