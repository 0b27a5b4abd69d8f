"""Start the ranks of a (batch, crt) mesh and run the sharded gate step.

    python3 -m cuhe_tpu_torch.parallel.run --mesh BxC [--config entry|prince_l0]
        [--batch N] [--backend nccl|gloo] [--device cuda|cpu]
    torchrun --standalone --nproc-per-node R -m cuhe_tpu_torch.parallel.run \\
        --mesh BxC --config prince_l0 --batch 32

Without torchrun, `spawn` starts B*C ranks itself; under torchrun (RANK in
the environment) each rank takes cuda:LOCAL_RANK over NCCL.  Every rank
runs the sharded step of the configuration (``entry.sharded_entry``,
``entry.make_sharded_prince_l0_step``) once to count its kernel launches,
then once timed; rank 0 then runs the unsharded step on the same inputs
and the command exits 1 unless the gathered output equals it bit for bit.
Each rank prints its time, peak memory, eval-key bytes, time in
collectives and launches.

The backend is the caller's choice and is never switched: "nccl" takes one
card per rank, "gloo" the CPU and ranks that share a card (each rank takes
cuda:(rank mod the card count)).  The device defaults to "cuda" and raises
without a card.  The kernels are built once before the ranks run (by the
parent of `spawn`, by local rank 0 under torchrun).  A mesh that stays up
and takes work from one of its ranks is ``session.py``'s `MeshSession`.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import os
import pickle
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .. import entry
from ..context import resolve_device
from ..ops import _cuda
from ..probes.timing import gpu_line
from .mesh import CommStats, gather_batch, make_mesh

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, device, world: int) -> torch.device:
    """The device of a run of `world` ranks on `backend`; raises where the
    backend cannot take it (NCCL on the CPU or on ranks that share a card)
    or where CUDA is asked for without a card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' takes CUDA tensors: run the CPU "
                             "over backend='gloo'")
        cards = torch.cuda.device_count()
        if cards < world:
            raise ValueError(f"backend='nccl' takes one card per rank: {world} "
                             f"ranks, {cards} cards; ranks that share a card "
                             f"run over backend='gloo'")
    return resolve_device(dev)


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    if dev.type != "cuda":
        return dev
    index = rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _rank_main(rank, world, shape, backend, device, store, timeout, call,
               results) -> None:
    torch.set_num_threads(1)
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        dev = _rank_device(torch.device(device), rank)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(make_mesh(*shape, dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(n_batch: int, n_crt: int, fn, *args, backend: str, device="cuda",
          timeout: float = 600.0) -> list:
    """Run fn(mesh, *args) on each rank of an (n_batch, n_crt) mesh, in
    n_batch * n_crt processes started with the spawn method (CUDA does not
    survive fork), and return the ranks' results in rank order.

    The ranks meet through a FileStore in a temporary directory (no TCP
    port) and set one PyTorch thread each.  fn and args reach them as a
    pickle in that directory (fn a module-level function): a start
    method's own pipe would make each start wait for the previous rank's
    imports once the arguments outgrow the pipe's buffer.  The results come
    back pickled through a queue (numpy arrays or plain values).  Raises,
    after stopping every rank, if a rank raises, dies, or the ranks are not
    done within `timeout` seconds."""
    world = n_batch * n_crt
    dev = check_backend(backend, device, world)
    if dev.type == "cuda":
        _cuda.build()  # once, here: not one nvcc build per rank
    mp = torch.multiprocessing.get_context("spawn")
    results = mp.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [mp.Process(target=_rank_main, daemon=True, args=(
            rank, world, (n_batch, n_crt), backend, str(dev),
            os.path.join(tmp, "store"), timeout, call, results))
            for rank in range(world)]
        for p in procs:
            p.start()
        try:
            got = {}
            deadline = time.monotonic() + timeout
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} "
                                       f"not done in {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = {r: p.exitcode for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None}
                    if dead:
                        raise RuntimeError(f"ranks exited without a result: "
                                           f"{dead}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
            return [got[r] for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_step(mesh, config: str = "entry", batch: int = 2,
             reference: bool = False, *, profile: bool = False) -> dict:
    """One rank's run of the sharded step of `config` ("entry": batch 2;
    "prince_l0": `batch` ciphertexts): a first step whose kernel launches
    are counted, a timed one, and one whose collectives are timed.  Returns
    the rank's coordinates, planes, step seconds, peak device bytes,
    eval-key bytes, seconds and calls in collectives, the first step's
    launches and calls of plain elementwise versions on the card
    (`_cuda.PLAIN_CALLS`), and the gathered output's shape and sha256; rank
    0 of the mesh also returns the output (numpy) and, with `reference`,
    whether it equals the unsharded step's on the same inputs.  With
    `profile` (a CUDA device; every rank of the mesh passes it), a fourth
    step runs under torch.profiler: "profile" holds its device time split
    into the port's kernels and PyTorch's (`probes/step_time.py::split`,
    the collectives' copies among PyTorch's), and the idle share against
    the timed step."""
    dev = mesh.device
    if config == "entry":
        step, args = entry.sharded_entry(mesh)
    elif config == "prince_l0":
        step, args = entry.make_sharded_prince_l0_step(mesh, batch)
    else:
        raise ValueError(f"config {config!r}: 'entry' or 'prince_l0'")
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launches()
    step(*args)
    _sync(dev)
    launches = dict(_cuda.LAUNCHES)
    plain_calls = dict(_cuda.PLAIN_CALLS)
    t0 = time.perf_counter()
    out = step(*args)
    _sync(dev)
    seconds = time.perf_counter() - t0
    # a third step with its collectives timed (each synchronises the device)
    stats = CommStats()
    mesh.time_collectives(stats)
    step(*args)
    mesh.time_collectives(None)
    comm = dict(stats.seconds)
    calls = dict(stats.calls)
    prof = (_profile(step, args, seconds * 1e3)
            if profile and dev.type == "cuda" else None)
    full = gather_batch(out, mesh).cpu()
    res = {"rank": mesh.rank, "coords": (mesh.b, mesh.c),
           "planes": step.planes, "batch": int(args[0].shape[0]),
           "step_s": seconds,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None),
           "ek_bytes": step.ek_lo.nbytes + step.ek_hi.nbytes,
           "comm_s": sum(comm.values()), "comm": comm, "calls": calls,
           "launches": launches, "plain_calls": plain_calls,
           "shape": tuple(full.shape),
           "sha256": hashlib.sha256(full.numpy().tobytes()).hexdigest()}
    if prof is not None:
        res["profile"] = prof
    if mesh.rank == mesh.ranks[0]:
        res["output"] = full.numpy()
        if reference:
            ref_step, ref_args = (entry.entry(dev) if config == "entry" else
                                  entry.make_prince_l0_step(batch, dev))
            want = ref_step(*ref_args).cpu()
            res["equal"] = torch.equal(full.view(torch.int32),
                                       want.view(torch.int32))
    return res


def _profile(step, args, step_ms: float) -> dict:
    """One step under torch.profiler, split by `step_time.split` (all the
    port's rows, the ten longest of all); "collective_ms" is the part of
    PyTorch's time
    in the collectives' copies and records (Gloo moves CUDA tensors
    through the host)."""
    from torch.profiler import ProfilerActivity, profile

    from ..probes.step_time import split

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    sp = split(prof, step_ms)
    sp["collective_ms"] = sum(ms for k, ms, _ in sp["rows"] if k.startswith(
        ("Memcpy", "Memset", "gloo:", "nccl")))
    sp["rows"] = sp["rows"][:10]
    return sp


def report(res: dict, tag: str) -> str:
    peak = ("not measured" if res["peak_bytes"] is None
            else f"{res['peak_bytes'] / 2**30:.3f} GiB")
    return (f"[{tag}] rank {res['rank']} {res['coords']} planes "
            f"{res['planes'][0]}..{res['planes'][1] - 1} batch {res['batch']}: "
            f"step {res['step_s'] * 1e3:.3f} ms, peak {peak}, eval keys "
            f"{res['ek_bytes'] / 1e6:.1f} MB, collectives "
            f"{res['comm_s'] * 1e3:.3f} ms {res['calls']}, launches "
            f"{res['launches']}" + _profile_line(res.get("profile")))


def _profile_line(sp) -> str:
    if sp is None:
        return ""
    if sp["busy_ms"] <= 0:
        return "; profile: no device time recorded"
    return (f"; profiled step: device busy {sp['busy_ms']:.3f} ms (port "
            f"kernels {sp['port_kernels_ms']:.3f}, PyTorch "
            f"{sp['pytorch_kernels_ms']:.3f}, share "
            f"{sp['pytorch_share']:.3f}, of which the collectives' copies and "
            f"records {sp['collective_ms']:.3f}), idle share "
            f"{sp['idle_share']:.3f} of the timed step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cuhe_tpu_torch.parallel.run")
    ap.add_argument("--mesh", required=True, help="BxC: batch x crt ranks")
    ap.add_argument("--config", choices=("entry", "prince_l0"),
                    default="entry")
    ap.add_argument("--batch", type=int, default=32,
                    help="ciphertexts of prince_l0 (entry has 2)")
    ap.add_argument("--backend", choices=BACKENDS, default="nccl")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    nb, nc = (int(v) for v in a.mesh.lower().split("x"))
    batch = 2 if a.config == "entry" else a.batch
    if "RANK" in os.environ:  # torchrun: one process per rank
        world = int(os.environ["WORLD_SIZE"])
        dev = check_backend(a.backend, a.device, int(os.environ.get(
            "LOCAL_WORLD_SIZE", world)))
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        dev = _rank_device(dev, local)
        dist.init_process_group(a.backend, init_method="env://")
        try:
            if dev.type == "cuda":
                if local == 0:  # one build per host
                    _cuda.build()
                dist.barrier()
            res = run_step(make_mesh(nb, nc, dev), a.config, batch, True)
        finally:
            dist.destroy_process_group()
        results = [res]
    else:
        results = spawn(nb, nc, run_step, a.config, batch, True,
                        backend=a.backend, device=a.device)
    card = gpu_line() if torch.device(a.device).type == "cuda" else "cpu"
    for res in results:
        print(report(res, f"{a.config} {nb}x{nc} {a.backend} {card}"),
              flush=True)
    ok = all(r.get("equal", True) for r in results)
    if any("equal" in r for r in results):
        print(f"[{a.config}] gathered output {results[0]['shape']} "
              f"{'==' if ok else '!='} the unsharded step's, sha256 "
              f"{results[0]['sha256']}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
