"""Process groups for the mesh backend.

One machine per ``torch.distributed`` rank. Nothing here touches CUDA or
a process group at import. The process-group backend follows one rule
(``process_group_backend``):

* NCCL when every rank has a card of its own (``device="cuda"`` and no
  more ranks on a host than cards);
* gloo when ranks share a card or run on the CPU (gloo stages CUDA
  tensors through the host).

A failure to initialize raises; it never switches to the other backend.
Every group is created with an explicit timeout, so a rank that stops
answering fails the others instead of hanging them.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, Optional, Sequence

# seconds a collective (or the group's start) waits for every rank
DEFAULT_TIMEOUT_S = 600


def process_group_backend(device: str, local_ranks: int,
                          cards: Optional[int] = None) -> str:
    """"nccl" when ``device`` is "cuda" and each of the ``local_ranks``
    ranks of this host has a card of its own (``cards``: the host's card
    count, default ``torch.cuda.device_count()``), else "gloo"."""
    if str(device).startswith("cuda"):
        if cards is None:
            import torch
            cards = torch.cuda.device_count()
        if 0 < local_ranks <= cards:
            return "nccl"
    return "gloo"


def initialize_multi_host(coordinator_address: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None, *,
                          device: str = "cuda",
                          init_method: Optional[str] = None,
                          local_ranks: int = 1,
                          timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join (or skip) a process group; returns its world size.

    With no arguments and no group this is a no-op single-process launch
    (returns 1). With ``coordinator_address`` ("host:port", TCP) or
    ``init_method`` (any ``torch.distributed`` URL, e.g. a ``file://``
    store), ``num_processes`` ranks join with this one as
    ``process_id``; the backend is ``process_group_backend(device,
    local_ranks)``. On the card each rank takes card ``process_id %
    cards`` as its current device (before the group starts).
    """
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    explicit = (coordinator_address is not None or init_method is not None
                or num_processes is not None or process_id is not None)
    if not explicit:
        return 1
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process launch needs num_processes and "
                         "process_id")
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("a multi-process launch needs "
                             "coordinator_address or init_method")
        init_method = f"tcp://{coordinator_address}"
    backend = process_group_backend(device, local_ranks)
    if str(device).startswith("cuda"):
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def machine_mesh(m: Optional[int] = None):
    """The group of one machine per rank: the default (world) group.
    ``m`` defaults to the world size and must equal it."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise ValueError("machine_mesh needs an initialized process group "
                         "(initialize_multi_host or python -m "
                         "repro_torch.launch)")
    n = dist.get_world_size()
    m = n if m is None else int(m)
    if m != n:
        raise ValueError(
            f"machine_mesh places one machine per rank: m={m} but the "
            f"process group has {n} ranks")
    return dist.group.WORLD


def _rank_main(rank: int, fn: Callable, nprocs: int, device: str,
               store: str, timeout_s: float, args: Sequence[Any]) -> None:
    import torch
    import torch.distributed as dist
    if not str(device).startswith("cuda"):
        torch.set_num_threads(1)      # one core a rank
    initialize_multi_host(num_processes=nprocs, process_id=rank,
                          device=device, init_method=f"file://{store}",
                          local_ranks=nprocs, timeout_s=timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn: Callable, nprocs: int, args: Sequence[Any] = (), *,
                device: str = "cuda", store_dir: Optional[str] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(rank, *args)`` on ``nprocs`` local ranks of one group
    (start method ``spawn``, a ``file://`` store under ``store_dir``,
    default a new temporary directory). ``fn`` must be importable by
    name. On the card the kernels are built here, once, before the ranks
    start; a rank that fails fails the call."""
    import torch.multiprocessing as mp
    if str(device).startswith("cuda"):
        from repro_torch.kernels.build import build_all
        build_all()
    d = tempfile.mkdtemp(prefix="mesh-", dir=store_dir)
    store = os.path.join(d, "store")
    mp.start_processes(_rank_main, nprocs=nprocs, join=True,
                       start_method="spawn",
                       args=(fn, nprocs, device, store, timeout_s,
                             tuple(args)))
