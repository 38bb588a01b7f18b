"""Starting the rank processes and their process group.

vitx is one program over every device (SPMD, ``jax.jit`` over a mesh);
the port runs one process per rank. ``spawn`` starts ``world`` rank
processes with ``torch.multiprocessing`` (start method ``spawn``: each
child imports the port afresh) and returns what each rank's function
returned; ``lead`` does the same with rank 0 in the calling process (a
server's front end, which that process's signals stop); ``from_env``
joins a group that ``torchrun``'s environment
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``). Both initialise the group, set the
rank's device (``cuda:{local_rank % device_count}``, or the CPU when the
caller asks) and hand the rank function a ``RankContext``.

The backend rule, applied before the group starts and printed on rank 0:
``nccl`` when every rank on the host has a CUDA device of its own,
``gloo`` when ranks share a device (two ranks on one card) or run on the
CPU. No run swaps one backend for the other after a failure.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist

# how long a collective may wait for a peer before the group gives up
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class RankContext:
    """What a rank function receives: its global and local rank, the
    world size, its device and the group's backend."""
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str

    def generator(self, seed: int) -> torch.Generator:
        """An explicit generator on the rank's device seeded with
        ``seed`` (every rank of a step draws the same stream and keeps
        its own rows of it, ``vitx_torch.core.draws``)."""
        return torch.Generator(device=self.device).manual_seed(int(seed))


def choose_backend(device_type: str, local_world: int) -> tuple:
    """-> (backend, reason): the backend rule of this module's doc."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    n = torch.cuda.device_count()
    if local_world > n:
        return "gloo", f"{local_world} ranks share {n} CUDA device(s)"
    return "nccl", f"each of {local_world} ranks has a CUDA device"


def init_rank(rank: int, world: int, init_method: str, *, device="cuda",
              local_rank: int | None = None,
              local_world: int | None = None) -> RankContext:
    """Initialise this process as ``rank`` of ``world``: its device first
    (CUDA: ``cuda:{local_rank % device_count}``, set current), then the
    group over ``init_method`` with the backend of ``choose_backend``."""
    from vitx_torch.core.device import resolve_device

    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dev.type == "cpu":
        # ranks on one host's CPU share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    backend, reason = choose_backend(dev.type, local_world)
    if rank == 0:
        print(f"vitx_torch.parallel: {world} ranks, backend {backend} "
              f"({reason})", flush=True)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    return RankContext(rank, world, local_rank, dev, backend)


def from_env(device="cuda") -> RankContext:
    """Join the group ``torchrun``'s environment describes."""
    env = os.environ
    return init_rank(int(env["RANK"]), int(env["WORLD_SIZE"]), "env://",
                     device=device,
                     local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
                     local_world=int(env.get("LOCAL_WORLD_SIZE",
                                             env["WORLD_SIZE"])))


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(fn, rank: int, world: int, init_method: str, device, args,
            results) -> None:
    try:
        ctx = init_rank(rank, world, init_method, device=device)
        try:
            out = fn(ctx, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


class RankError(RuntimeError):
    """A rank process failed; the message holds its traceback."""


def _start(fn, ranks, world: int, init_method: str, device, args) -> tuple:
    """Start ``ranks`` as child processes -> ({rank: process}, the queue
    their results arrive on)."""
    import torch.multiprocessing as mpm

    mpc = mpm.get_context("spawn")
    results = mpc.Queue()
    procs = {r: mpc.Process(target=_worker, args=(fn, r, world, init_method,
                                                  device, args, results),
                            daemon=True)
             for r in ranks}
    for p in procs.values():
        p.start()
    return procs, results


def _gather(procs: dict, results, timeout: float,
            failure: str | None = None) -> dict:
    """Every child's result -> {rank: result}; on a failure (a rank's
    exception, a rank dead without a result, ``timeout`` seconds gone, or
    ``failure`` already) the others are stopped and ``RankError``
    raised."""
    out = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while len(out) < len(procs) and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in procs.items()
                        if p.exitcode not in (None, 0)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
                elif datetime.datetime.now() > deadline:
                    failure = f"no result from every rank in {timeout} s"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs.values():
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RankError(failure)
    return out


def spawn(fn, world: int, args: tuple = (), *, device="cuda",
          init_method: str | None = None, timeout: float = 1800.0) -> list:
    """Run ``fn(ctx, *args)`` on ``world`` rank processes -> the list of
    their results by rank. ``fn`` must be importable by name (the
    children start afresh) and return something picklable. The
    rendezvous is ``init_method`` (``file://...`` or ``tcp://...``; by
    default a free port on localhost). When a rank fails, the others are
    stopped and ``RankError`` carries the failing rank's traceback; so it
    does when no result arrives within ``timeout`` seconds."""
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    procs, results = _start(fn, range(world), world, init_method, device,
                            args)
    out = _gather(procs, results, timeout)
    return [out[r] for r in range(world)]


def lead(fn, world: int, args: tuple = (), *, device="cuda",
         init_method: str | None = None, timeout: float = 1800.0) -> list:
    """``spawn`` with rank 0 run in this process: ``fn(ctx, *args)`` here
    and on ``world - 1`` rank processes beside it -> the results by rank.
    When rank 0 raises (a ``KeyboardInterrupt`` among them) the others are
    stopped and the exception goes on."""
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    procs, results = _start(fn, range(1, world), world, init_method, device,
                            args)
    try:
        ctx = init_rank(0, world, init_method, device=device)
        try:
            first = fn(ctx, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        for p in procs.values():
            p.terminate()
            p.join(timeout=60)
        raise
    out = _gather(procs, results, timeout)
    return [first] + [out[r] for r in range(1, world)]
