"""Process-group start-up for multi-GPU training (port of
gatv2_tpu/parallel/multihost.py) on torch.distributed.

One process per rank. Under torchrun the environment names each process
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/MASTER_PORT)
and `initialize()` joins the group from it; `--mesh N` without torchrun
starts N local ranks itself (a `RankPool`, which can also keep them for
several jobs) and passes the same facts explicitly.

The transport is chosen, never silently: NCCL when every rank on this host
has a card of its own; gloo on the CPU, or when ranks share a card (NCCL
refuses two ranks on one device; gloo routes CUDA tensors through host
memory). It can be asked for explicitly (`backend=`), and NCCL asked for
with two ranks on one card raises. `transport_line()` states the choice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist


def is_multihost_env() -> bool:
    """True when launched by torchrun (or any launcher setting its
    environment) with more than one process."""
    return os.environ.get("WORLD_SIZE", "1") not in ("", "1") and bool(
        os.environ.get("RANK"))


@dataclasses.dataclass(frozen=True)
class RankInfo:
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    backend: str  # 'nccl' | 'gloo'
    device: torch.device  # this rank's device


def _cuda_count(device: str) -> int:
    return torch.cuda.device_count() if device == "cuda" else 0


def choose_backend(device: str, local_world_size: int,
                   backend: str = "auto") -> str:
    """The transport for `local_world_size` ranks of this host on
    `device` ('cuda' or 'cpu'): NCCL when every rank has a card of its
    own, gloo otherwise. backend='nccl' or 'gloo' asks for one; NCCL with
    ranks sharing a card, or on the CPU, raises."""
    if backend not in ("auto", "nccl", "gloo"):
        raise ValueError(
            f"backend must be 'auto', 'nccl' or 'gloo', got {backend!r}")
    cards = _cuda_count(device)
    if device == "cuda" and cards == 0:
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run the "
            "ranks on the CPU over gloo")
    own_card = device == "cuda" and local_world_size <= cards
    if backend == "nccl" and not own_card:
        where = ("the CPU" if device == "cpu" else
                 f"{cards} card(s) for {local_world_size} ranks")
        raise RuntimeError(
            f"NCCL needs a card per rank, but this host has {where}: NCCL "
            f"refuses two ranks on one device; use gloo")
    if backend == "auto":
        return "nccl" if own_card else "gloo"
    return backend


def rank_device(device: str, local_rank: int) -> torch.device:
    """cuda:(local_rank % device_count), or the CPU when asked."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(*, device: str = "cuda", backend: str = "auto",
               rank: int | None = None, world_size: int | None = None,
               local_rank: int | None = None,
               local_world_size: int | None = None,
               init_method: str | None = None,
               timeout_s: float | None = None) -> RankInfo:
    """Join the process group. The rank facts default to torchrun's
    environment; `init_method` to tcp://MASTER_ADDR:MASTER_PORT;
    `timeout_s` bounds a collective's wait (torch's default otherwise)."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else local_rank)
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    chosen = choose_backend(device, local_world_size, backend)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        init_method = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                       f"{env.get('MASTER_PORT', '29500')}")
    if not dist.is_initialized():
        kw = {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(chosen, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    return RankInfo(rank, world_size, local_rank, local_world_size, chosen,
                    dev)


def transport_line(info: RankInfo) -> str:
    """`Transport: ...` — which backend carries the collectives, and
    where the ranks run."""
    n = info.world_size
    cards = torch.cuda.device_count() if info.device.type == "cuda" else 0
    if info.device.type == "cpu":
        where = f"{n} ranks on the CPU"
    elif info.local_world_size <= cards:
        where = f"{n} ranks, one card each"
    elif cards == 1:
        where = f"{n} ranks share cuda:0"
    else:
        where = f"{n} ranks share {cards} cards"
    return f"Transport: {info.backend}, {where}"


def process_summary(info: RankInfo) -> str:
    return (f"process {info.rank}/{info.world_size} (local "
            f"{info.local_rank}/{info.local_world_size}) on {info.device}")


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _set_cpu_threads(device: str, threads: int | None) -> None:
    if device == "cpu" and threads:
        torch.set_num_threads(threads)


def _pool_rank(local_rank, nprocs, port, device, backend, threads,
               timeout_s, conn):
    _set_cpu_threads(device, threads)
    info = initialize(device=device, backend=backend, rank=local_rank,
                      world_size=nprocs, local_rank=local_rank,
                      local_world_size=nprocs,
                      init_method=f"tcp://localhost:{port}",
                      timeout_s=timeout_s)
    try:
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                conn.send((True, fn(info, *args, **kwargs)))
            except BaseException:
                conn.send((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`nprocs` local ranks kept for several jobs, so a caller that runs
    many checks pays the processes' start and the group's rendezvous once.
    `run(fn, *args)` runs fn(RankInfo, *args) on every rank and returns
    the ranks' results in rank order (keyword arguments pass through
    too); a rank's exception is raised here
    with its traceback (a rank left waiting in a collective gives up after
    `timeout_s`, torch's default when None). fn must be importable by name
    (the ranks are new processes). Use as a context manager: leaving it
    stops every rank."""

    def __init__(self, nprocs: int, *, device: str = "cuda",
                 backend: str = "auto", threads: int | None = None,
                 timeout_s: float | None = None):
        import torch.multiprocessing as mp

        choose_backend(device, nprocs, backend)
        ctx = mp.get_context("spawn")
        port = free_port()
        self._conns, self._procs = [], []
        for r in range(nprocs):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_pool_rank, daemon=True, args=(
                r, nprocs, port, device, backend, threads, timeout_s, child))
            p.start()
            self._conns.append(parent)
            self._procs.append(p)

    def run(self, fn: Callable, *args, **kwargs) -> list[Any]:
        for c in self._conns:
            c.send((fn, args, kwargs))
        results = [c.recv() for c in self._conns]
        for r, (ok, value) in enumerate(results):
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{value}")
        return [v for _, v in results]

    def close(self) -> None:
        for c in self._conns:
            with contextlib.suppress(OSError, BrokenPipeError):
                c.send(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
