"""Start the ranks of a mesh, one process each.

``run(fn, mesh_shape, device, args)`` calls ``fn(rank_device, *args)`` on
each of the ``data · model`` ranks in a process group and returns global
rank 0's result. Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the
process is already one rank: it joins the group and calls ``fn`` itself.
Otherwise the ranks are spawned (start method ``spawn``: a child imports
``torch`` and this package afresh, never the caller's modules) and joined
over ``tcp://localhost`` on a free port. Rank ``r`` takes ``cuda:(r %
device_count)``. If one rank fails, the others are stopped and ``run``
raises.

Rank 0 hands its result over as a file: ``torch.save`` into a temporary
directory of the parent's, which the parent reads with ``torch.load``
once every rank has exited. A result so passed holds no live resource of
the rank (a tensor sent through a queue is a handle to the sender's
memory, gone once it exits), and no rank blocks on a pipe however large
the result is.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from genmmrec_tpu_torch.parallel.mesh import backend_for, shape_dims

# how long a rank waits in a collective for the others
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(rank: int, world: int, init_method: str, device) -> torch.device:
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend_for(device, world), init_method=init_method, world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT
    )
    return dev


def _rank_main(rank: int, world: int, init_method: str, device, fn, args, result_path: str) -> None:
    dev = _join(rank, world, init_method, device)
    try:
        out = fn(dev, *args)
        if rank == 0:
            part = result_path + ".part"
            torch.save(out, part)
            os.replace(part, result_path)
    finally:
        dist.destroy_process_group()


def run(fn: Callable, mesh_shape: dict, device="cuda", args: tuple = ()):
    """``fn(rank_device, *args)`` on the ``data · model`` ranks of
    ``mesh_shape``; returns global rank 0's result."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dev = _join(rank, size, "env://", device)
        try:
            return fn(dev, *args)
        finally:
            dist.destroy_process_group()
    d, m = shape_dims(mesh_shape)
    world = d * m
    ctx = mp.get_context("spawn")
    init = f"tcp://localhost:{_free_port()}"
    with tempfile.TemporaryDirectory(prefix="genmmrec_launch_") as tmp:
        result_path = os.path.join(tmp, "rank0.pt")
        procs = [
            ctx.Process(target=_rank_main, args=(r, world, init, str(device), fn, args, result_path), daemon=False)
            for r in range(world)
        ]
        for p in procs:
            p.start()
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} of {world} exited with code {codes[failed[0]]}")
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
        if not os.path.exists(result_path):
            raise RuntimeError(f"rank 0 of {world} exited without a result")
        return torch.load(result_path, weights_only=False)
