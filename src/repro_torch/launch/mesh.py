"""Client meshes: starting the ranks of the sharded engine.

PyTorch counterpart of ``repro.launch.mesh``'s ``make_client_mesh``.
The JAX package simulates a mesh on one host by forcing host devices;
here each rank is a process with one device, and ``run_on_mesh`` starts
them:

* one rank runs in the calling process, on a ``HashStore``;
* P > 1 ranks are P worker processes started with the ``spawn`` method,
  meeting through a ``FileStore`` in a temporary directory (no port to
  clash with other runs), each on one thread of torch.

The backend follows the device: gloo for ``cpu``, NCCL for ``cuda``
(rank r on card r; more ranks than cards is refused: NCCL cannot put two
ranks on one card). Nothing falls back from one to the other.

The function a worker runs must be importable by its module path (it is
pickled), so worker entry points live in the launchers
(``launch.train``, ``launch.shard_check``). ``fn(mesh, *args)`` runs on
every rank; rank 0's return value comes back to the caller (pass plain
data: numpy arrays, not tensors).
"""

from __future__ import annotations

import math
import os
import queue as queue_mod
import tempfile
import traceback
from datetime import timedelta
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.shard import BACKENDS, check_cards
from repro_torch.device import resolve_device

__all__ = ["check_cards", "make_client_mesh", "mesh_dim_names",
           "parse_mesh", "run_on_mesh"]
# a collective that waits this long has lost a rank
_TIMEOUT = timedelta(minutes=10)


def mesh_dim_names(shape: Sequence[int]) -> Tuple[str, ...]:
    """The JAX package's client-mesh names: ("data",) for 1-D shapes,
    ("pod", "data") for 2-D, generic names for higher ranks."""
    return {1: ("data",), 2: ("pod", "data")}.get(
        len(shape), tuple(f"clients{i}" for i in range(len(shape))))


def make_client_mesh(shape: Sequence[int], device_type: str) -> DeviceMesh:
    """The mesh whose EVERY dim carries clients, over the started process
    group (rank r at the row-major coordinate r)."""
    shape = tuple(int(s) for s in shape)
    return DeviceMesh(device_type,
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=mesh_dim_names(shape))


def parse_mesh(text: str) -> Tuple[int, ...]:
    """'2' or '4,2' -> (2,) or (4, 2); raises ValueError otherwise."""
    shape = tuple(int(x) for x in text.split(","))
    if not shape or any(s < 1 for s in shape):
        raise ValueError(text)
    return shape


def _start(rank: int, world: int, shape, device_type: str, store):
    """Join the process group and build the mesh; returns the rank's
    device."""
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(BACKENDS[device_type], store=store, rank=rank,
                            world_size=world, timeout=_TIMEOUT)
    return dev


def _worker(rank: int, world: int, shape, device_type: str, store_path: str,
            fn: Callable, args, results) -> None:
    torch.set_num_threads(1)
    try:
        _start(rank, world, shape, device_type,
               dist.FileStore(store_path, world))
        try:
            out = fn(make_client_mesh(shape, device_type), *args)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            results.put(("ok", out))
    except BaseException:     # reported to the parent, which raises
        results.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise


def run_on_mesh(fn: Callable, shape: Sequence[int], device=None,
                args: Sequence[Any] = (), timeout: float = 1800.0):
    """Run ``fn(mesh, *args)`` on every rank of a client mesh of
    ``shape`` on ``device`` (default: the card) and return rank 0's
    result. A rank that raises stops the run: the others are ended and
    the error is raised here."""
    shape = tuple(int(s) for s in shape)
    world = math.prod(shape)
    device_type = resolve_device(device).type
    check_cards(world, device_type)
    if world == 1:
        if dist.is_initialized():
            raise RuntimeError("a process group is already started in this "
                               "process; the one-rank mesh starts its own")
        _start(0, 1, shape, device_type, dist.HashStore())
        try:
            return fn(make_client_mesh(shape, device_type), *args)
        finally:
            dist.destroy_process_group()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, world, shape, device_type,
                                   os.path.join(tmp, "store"), fn,
                                   tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            try:
                status, out = results.get(timeout=timeout)
            except queue_mod.Empty:
                raise RuntimeError(f"the mesh {shape} gave no result in "
                                   f"{timeout:.0f} s") from None
            if status != "ok":
                raise RuntimeError(f"a rank of the mesh {shape} failed: "
                                   f"{out}")
            for p in procs:
                p.join(timeout=60)
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
