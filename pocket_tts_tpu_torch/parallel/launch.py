"""Spawning the ranks of a ("data", "model") mesh and running work on them.

The JAX package runs a mesh from ONE controller: `jax.devices()` lists the
chips and GSPMD moves the data. The port runs it as SPMD over
torch.distributed: one process per rank, each holding its own block of
the params and of the batch state, all running the same program
(`parallel/sharding.py` says which block).

`RankGroup(data, model, backend, device)` spawns the data * model ranks
once and keeps them: each initializes the process group (rendezvous through
a file in a temporary directory, never a TCP port, so that groups started
side by side cannot collide), builds the mesh with `make_mesh` and then
runs the jobs `run(fn, *args)` hands it: `fn(mesh, *args)` on every rank,
with the ranks' return values back in rank order. A rank that raises, or
dies, fails the job in the caller with that rank's traceback, and the
group is stopped (the other ranks may wait in a collective the failed rank
never joins). `launch(fn, data, model, ...)` is one job on a group of its
own.

Backends: "gloo" runs on CPU tensors, and on CUDA tensors through host
copies; it is the one backend that runs several ranks on ONE card, since
NCCL refuses two ranks on one device. The collectives of
`parallel/sharding.py` all take tensors on the mesh's device, as "nccl"
would need, but no run has shown "nccl": it needs a card per rank. The
ranks of a group with device "cuda" use card `rank % device_count()`.
`fn` and its arguments are pickled into the ranks (the spawn start
method): `fn` must be a module-level function.
"""
from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import shutil
import tempfile
import time
import traceback


def _rank_main(rank, world, data, model, backend, device, init_file,
               threads, conn):
    import torch
    import torch.distributed as dist
    from .sharding import make_mesh
    try:
        if threads:
            torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank)
        mesh = make_mesh(data, model, device_type=device)
        conn.send(("ready", None))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        job = conn.recv()
        if job is None:
            break
        fn, args = job
        try:
            conn.send(("ok", fn(mesh, *args)))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
            return
    dist.destroy_process_group()


class RankGroup:
    """data * model ranks spawned once, running jobs until `close`."""

    def __init__(self, data: int, model: int = 1, backend: str = "gloo",
                 device: str = "cpu", threads: int = 1,
                 timeout: float = 600.0):
        self.data, self.model = data, model
        self.world = data * model
        self.timeout = timeout
        self._tmp = tempfile.mkdtemp(prefix="ptt_mesh_")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for rank in range(self.world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, self.world, data, model, backend, device,
                      os.path.join(self._tmp, "rendezvous"), threads, child))
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self._collect("starting the ranks")

    def _collect(self, what: str) -> list:
        """Each rank's reply in rank order; raises (and stops the group)
        when one raised, died or ran past the timeout."""
        out = [None] * self.world
        pending = dict(enumerate(self._conns))
        deadline = time.monotonic() + self.timeout
        while pending:
            left = deadline - time.monotonic()
            ready = mpc.wait(list(pending.values()) +
                             [self._procs[r].sentinel for r in pending],
                             timeout=max(left, 0))
            if not ready:
                self.close(kill=True)
                raise TimeoutError(f"mesh ranks {sorted(pending)} did not "
                                   f"finish {what} in {self.timeout} s")
            for rank in list(pending):
                conn = pending[rank]
                try:
                    reply = conn.recv() if conn.poll() else None
                except EOFError:   # the rank died before replying
                    reply = None
                if reply is not None:
                    status, value = reply
                    if status == "err":
                        self.close(kill=True)
                        raise RuntimeError(
                            f"mesh rank {rank} failed in {what}:\n{value}")
                    out[rank] = value
                    del pending[rank]
                elif not self._procs[rank].is_alive():
                    code = self._procs[rank].exitcode
                    self.close(kill=True)
                    raise RuntimeError(f"mesh rank {rank} exited with code "
                                       f"{code} in {what}")
        return out

    def run(self, fn, *args) -> list:
        """fn(mesh, *args) on every rank; their return values, rank by
        rank."""
        if not self._procs:
            raise RuntimeError("the rank group is closed")
        for conn in self._conns:
            conn.send((fn, args))
        return self._collect(getattr(fn, "__name__", repr(fn)))

    def close(self, kill: bool = False) -> None:
        """Stop every rank (at once when kill) and remove the rendezvous
        directory."""
        for conn, proc in zip(self._conns, self._procs):
            if not kill and proc.is_alive():
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for proc in self._procs:
            if kill:
                proc.kill()
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def launch(fn, data: int, model: int = 1, backend: str = "gloo",
           device: str = "cpu", args=(), threads: int = 1,
           timeout: float = 600.0) -> list:
    """fn(mesh, *args) on data * model fresh ranks; their return values in
    rank order. A rank's failure is raised here."""
    with RankGroup(data, model, backend, device, threads, timeout) as group:
        return group.run(fn, *args)
