"""Multi-process bootstrap of the torch port: a ``torch.distributed``
process group, so that the sharded functions of :mod:`..parallel` and
``inference.sample_chains_sharded`` run over the cards of several
processes (or hosts) unchanged.

Counterpart of ``pybnesian_tpu/runtime/distributed.py``; the contract is
the same:

- one Python process per host (or per card), each seeing its local cards;
- :func:`initialize` wires the group from explicit arguments or the
  ``PBN_COORDINATOR`` / ``PBN_NUM_PROCESSES`` / ``PBN_PROCESS_ID``
  environment variables: ``init_process_group`` with
  ``init_method="tcp://<coordinator>"``, over NCCL when the port's device is
  a card and gloo on the CPU. torch has no counterpart of JAX's pod
  auto-detection, so a group needs all three;
- :func:`global_mesh` then builds a mesh over every process's devices,
  with ``data`` spanning the processes; pass it to ``parallel.sharded_*``.

Single-process use is a no-op: ``initialize()`` returns False and
``global_mesh()`` is the local mesh.
"""

from __future__ import annotations

import datetime
import os

import torch

from .device import default_device, visible_devices

__all__ = [
    "initialize",
    "shutdown",
    "is_distributed",
    "global_mesh",
    "process_summary",
]

#: how long a process waits for the others, at start-up and in every
#: collective, before it raises (JAX's initialization timeout)
TIMEOUT = datetime.timedelta(seconds=300)

_INITIALIZED = False
_LOCAL_DEVICE_IDS = None
_DEVICE_COUNTS = None  # every process's local device count, by rank


def rank_and_size():
    """The running ``torch.distributed`` group's (rank, world size), or
    (0, 1) when none runs."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_devices():
    if _LOCAL_DEVICE_IDS is not None:
        return [torch.device("cuda", i) for i in _LOCAL_DEVICE_IDS]
    return visible_devices()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> bool:
    """Start the process group.

    Each argument resolves as in the JAX package: explicit argument, then
    its ``PBN_*`` environment variable. Returns True when a group was
    started (or already runs), False for the single-process no-op (no
    coordinator, and one process or none given). ``local_device_ids``
    limits this process to those cards. Raises ``ValueError`` when a group
    is asked for without all of address, count and id."""
    global _INITIALIZED, _LOCAL_DEVICE_IDS, _DEVICE_COUNTS
    if _INITIALIZED:
        return True

    coordinator_address = coordinator_address or os.environ.get(
        "PBN_COORDINATOR"
    )
    if num_processes is None and "PBN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PBN_NUM_PROCESSES"])
    if process_id is None and "PBN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PBN_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        # single process — nothing to wire
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a process group needs a coordinator address, a process count "
            "and a process id: pass them, or set PBN_COORDINATOR, "
            "PBN_NUM_PROCESSES and PBN_PROCESS_ID")

    _LOCAL_DEVICE_IDS = (list(local_device_ids)
                         if local_device_ids is not None else None)
    backend = "nccl" if default_device().type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_local_devices()[0])
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    counts = [None] * num_processes
    torch.distributed.all_gather_object(counts, len(_local_devices()))
    _DEVICE_COUNTS = counts
    _INITIALIZED = True
    return True


def shutdown() -> None:
    global _INITIALIZED, _LOCAL_DEVICE_IDS, _DEVICE_COUNTS
    if _INITIALIZED:
        torch.distributed.destroy_process_group()
        _INITIALIZED = False
        _LOCAL_DEVICE_IDS = _DEVICE_COUNTS = None


def is_distributed() -> bool:
    """True when a process group of more than one process runs."""
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def global_mesh(fam: int = 1, local_devices=None):
    """(data, fam) mesh over every process's devices (every process must
    call this with the same arguments): the devices in rank order, so
    ``data`` spans the processes and its sums cross them, while each
    process holds whole rows of ``fam`` (which carries no collective).
    ``local_devices`` overrides this process's devices (default: its
    cards, or the CPU under ``use_device("cpu")``); repeating one gives
    virtual shards."""
    from ..parallel import Mesh, _object_array

    local = [torch.device(d) for d in (
        local_devices if local_devices is not None else _local_devices())]
    names = [[str(d) for d in local]]
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        names = [None] * rank_and_size()[1]
        torch.distributed.all_gather_object(names, [str(d) for d in local])
    devices = [torch.device(n) for ns in names for n in ns]
    owners = [rank for rank, ns in enumerate(names) for _ in ns]
    n = len(devices)
    if n % fam != 0:
        raise ValueError("fam axis must divide the global device count")
    return Mesh(_object_array(devices, (n // fam, fam)), ("data", "fam"),
                processes=owners)


def process_summary() -> dict:
    """This process's place in the group, with the JAX package's keys;
    ``global_devices`` counts every process's cards (gathered once, by
    :func:`initialize`)."""
    rank, world = rank_and_size()
    local = _local_devices()
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": [str(d) for d in local],
        "global_devices": (sum(_DEVICE_COUNTS) if _DEVICE_COUNTS is not None
                           else len(local)),
        "initialized_multiprocess": _INITIALIZED,
    }
