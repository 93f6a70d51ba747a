"""Spawning the ranks of a ("data", "model") mesh and running work on them.

The JAX package runs a mesh from ONE controller: `jax.devices()` lists the
chips and GSPMD moves the data. The port runs it as SPMD over
torch.distributed: one process per rank, each holding its own block of
the params and of the batch state, all running the same program
(`parallel/sharding.py` says which block).

`RankGroup(data, model, backend=None, device="cuda")` spawns the data *
model ranks once and keeps them: each initializes the process group
(rendezvous through a file in a temporary directory, never a TCP port, so
that groups started side by side cannot collide), builds the mesh with
`make_mesh` and then runs the jobs `run(fn, *args)` hands it: `fn(mesh,
*args)` on every rank, with the ranks' return values back in rank order.
A rank that raises, or dies, fails the job in the caller with that rank's
traceback, and the group is stopped (the other ranks may wait in a
collective the failed rank never joins). `launch(fn, data, model, ...)` is
one job on a group of its own.

Backends (`resolve`): `backend=None` is "nccl" on "cuda" and "gloo" on
"cpu". Under "nccl" rank r takes card r, so the group needs a card per
rank; it raises before spawning anything when the device is "cpu" or the
ranks outnumber the cards, and it never falls back to gloo or to the
CPU. chip_smoke.py's phase 12 runs 2 x 2, 1 x 4 and 4 x 1 meshes this way
on four H100s, each held to one card's audio, the ranks of a "model"
group bit for bit. "gloo" runs on CPU tensors, and on CUDA tensors through
host copies; named explicitly with device "cuda" it is the one backend
that runs several ranks on ONE card (rank r on card r % device_count()),
since NCCL refuses two ranks on one device: chip_smoke.py's phase 11.

With device "cuda" the caller builds the kernel library (ops/cuda_lib.py)
before spawning, once, and every rank loads it from the caller's build
directory (`cuda_lib.set_build_dir`): no rank runs nvcc. A failed build
raises in the caller with nvcc's output. Each rank holds one card for its
life, so the per-process caches of card properties (the SM count and
cluster occupancy the kernel plans read) hold for the rank's card.
`fn` and its arguments are pickled into the ranks (the spawn start
method): `fn` must be a module-level function.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import shutil
import tempfile
import time
import traceback

BACKENDS = ("nccl", "gloo")
# seconds `close` gives the ranks to leave before it kills them
CLOSE_GRACE = 30.0


def resolve(data: int, model: int = 1, backend=None,
            device: str = "cuda") -> tuple:
    """(backend, device) of a data x model group: backend None is "nccl"
    on "cuda" and "gloo" on "cpu". "nccl" raises (nothing spawned) on the
    CPU and when the ranks outnumber the cards; nothing switches backend
    or device on its own."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: a mesh runs on 'cuda' or "
                         "'cpu'")
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        world = data * model
        if device == "cpu":
            raise ValueError(
                f"backend 'nccl' runs on cards, not on the CPU: a {data} x "
                f"{model} mesh of {world} ranks on device 'cpu' takes "
                "backend 'gloo'")
        import torch
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"backend 'nccl' takes one card a rank: a {data} x {model} "
                f"mesh has {world} ranks and this machine {cards} cards "
                "(backend 'gloo' runs several ranks on one card)")
    return backend, device


def _rank_main(rank, world, data, model, backend, device, init_file,
               threads, pg_timeout, build_dir, conn):
    import torch
    import torch.distributed as dist
    from ..ops import cuda_lib
    from .sharding import make_mesh
    try:
        cuda_lib.set_build_dir(build_dir)
        if threads:
            torch.set_num_threads(threads)
        kw = dict(init_method=f"file://{init_file}", world_size=world,
                  rank=rank, timeout=datetime.timedelta(seconds=pg_timeout))
        if backend == "nccl":
            # card r; device_id makes NCCL set up its communicator here,
            # so a fault shows at start
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        elif device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, **kw)
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

    def __init__(self, data: int, model: int = 1, backend=None,
                 device: str = "cuda", threads: int = 1,
                 timeout: float = 600.0):
        from ..ops import cuda_lib
        self.backend, self.device = resolve(data, model, backend, device)
        self.data, self.model = data, model
        self.world = data * model
        self.timeout = timeout
        if self.device == "cuda":
            cuda_lib.library()
        self._conns, self._procs = [], []
        self._tmp = tempfile.mkdtemp(prefix="ptt_mesh_")
        ctx = mp.get_context("spawn")
        # a collective that a failed rank never joins ends as an error on
        # the others before the group's own deadline kills them
        pg_timeout = max(0.8 * timeout, timeout - 60.0)
        for rank in range(self.world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, self.world, data, model, self.backend,
                      self.device, os.path.join(self._tmp, "rendezvous"),
                      threads, pg_timeout, cuda_lib.build_dir(), child))
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
        """Stop every rank and remove the rendezvous directory. Without
        kill each rank leaves its job loop and destroys its process group,
        and a rank still alive after CLOSE_GRACE seconds in all (one stuck
        in a job or a collective) is killed; with kill every rank is
        killed at once."""
        procs = [p for p in self._procs if p.is_alive()]
        if not kill:
            for conn, proc in zip(self._conns, self._procs):
                if proc.is_alive():
                    try:
                        conn.send(None)
                    except (BrokenPipeError, OSError):
                        pass
            deadline = time.monotonic() + CLOSE_GRACE
            for proc in procs:
                proc.join(timeout=max(deadline - time.monotonic(), 0))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        for proc in procs:
            proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def launch(fn, data: int, model: int = 1, backend=None,
           device: str = "cuda", args=(), threads: int = 1,
           timeout: float = 600.0) -> list:
    """fn(mesh, *args) on data * model fresh ranks; their return values in
    rank order. A rank's failure is raised here."""
    with RankGroup(data, model, backend, device, threads, timeout) as group:
        return group.run(fn, *args)
