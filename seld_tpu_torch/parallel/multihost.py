"""Multi-process execution: one process drives one device.

The port's counterpart of ``seld_tpu/parallel/multihost.py``. The JAX package
brings processes up with ``jax.distributed.initialize`` and lets GSPMD place
the collectives; here the processes form a ``torch.distributed`` group and
the collectives are explicit (``parallel/cross_rank.py``,
``training/steps.py``).

- :func:`initialize`: the process group over TCP, configured by the same
  three variables the JAX package reads (``JAX_COORDINATOR_ADDRESS``,
  ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so one launcher drives both
  packages; with no configuration a single-process no-op.
- :func:`barrier`, :func:`process_info`, :func:`shard_for_host`.
- :func:`allgather_rows`: every rank's rows, concatenated in rank order.
- :func:`global_batch`: this rank's rows of a global batch on its device, or,
  where the global rows do not split evenly over the data axis, the whole
  batch gathered onto every rank (computed whole, as the JAX package
  replicates such a batch).

Every collective has the group's timeout (``timeout_s``, 600 s by default):
a rank that never arrives fails the others instead of hanging them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600
_state = {"device": None, "timeout_s": DEFAULT_TIMEOUT_S}


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_device_ids=None, *,
               backend: Optional[str] = None, device: str = "cuda",
               timeout_s: int = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up the process group; returns True if more than one process
    takes part.

    The arguments default to ``JAX_COORDINATOR_ADDRESS`` (``host:port`` of
    rank 0's TCP store), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. With
    ``device='cuda'`` the process takes CUDA device ``local_device_ids[0]``,
    else ``process_id`` modulo the visible devices, and the backend is
    ``nccl``; with ``device='cpu'`` it is ``gloo``. ``backend`` sets it
    explicitly (``gloo`` runs several ranks on one card; NCCL refuses two
    ranks on one device)."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID")
    if coordinator_address is None or not num_processes or num_processes <= 1:
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes} processes")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: no CUDA device; pass device='cpu'")
        if local_device_ids is not None:
            ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
            index = int(ids[0])
        else:
            index = process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
        _state["device"] = torch.device("cuda", index)
    elif kind == "cpu":
        _state["device"] = torch.device("cpu")
    else:
        raise ValueError(f"no multi-process support for device {device!r}")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    _state["timeout_s"] = int(timeout_s)
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    barrier("seld_tpu_torch_init")
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state["device"] = None


def local_device(default: str = "cuda") -> torch.device:
    """The device :func:`initialize` gave this process, else ``default``."""
    return _state["device"] if _state["device"] is not None else torch.device(default)


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier(name: str, timeout_s: Optional[int] = None) -> None:
    """Wait until every process arrives. Under gloo a rank that does not
    arrive within ``timeout_s`` (default: the group's) fails the barrier
    with its rank named; under nccl the group's timeout holds."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    timeout = datetime.timedelta(seconds=timeout_s or _state["timeout_s"])
    if dist.get_backend() == "gloo":
        try:
            dist.monitored_barrier(timeout=timeout, wait_all_ranks=True)
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r}: {e}") from e
    else:
        dist.barrier()


def shard_for_host(global_batch_size: int, num_hosts: Optional[int] = None,
                   host_id: Optional[int] = None) -> Tuple[int, int, int]:
    """(local batch size, row start, row stop) of this process's contiguous
    block of a global batch: ``num_hosts`` equal blocks in rank order, the
    order :func:`allgather_rows` restores."""
    rank, world = process_info()
    num_hosts = world if num_hosts is None else num_hosts
    host_id = rank if host_id is None else host_id
    if global_batch_size % num_hosts:
        raise ValueError(f"global batch {global_batch_size} not divisible by {num_hosts} hosts")
    local = global_batch_size // num_hosts
    return local, host_id * local, (host_id + 1) * local


def _comm_device() -> torch.device:
    """Where collectives' buffers live: the card under nccl, else the host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def row_counts(n_local: int) -> list:
    """Every rank's row count, in rank order."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [int(n_local)]
    dev = _comm_device()
    mine = torch.tensor([n_local], dtype=torch.int64, device=dev)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [int(t.item()) for t in out]


def allgather_rows(local: np.ndarray, counts: Optional[Sequence[int]] = None) -> np.ndarray:
    """Every rank's rows of ``local`` concatenated in rank order, on every
    rank (the metric pass runs alike on each). Ranks may hold different row
    counts (``counts``, else gathered first)."""
    local = np.ascontiguousarray(local)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    counts = row_counts(len(local)) if counts is None else list(counts)
    dev = _comm_device()
    top = max(counts)
    buf = torch.zeros((top, *local.shape[1:]), dtype=torch.from_numpy(local[:0]).dtype,
                      device=dev)
    buf[:len(local)] = torch.from_numpy(local).to(dev)
    out = [torch.empty_like(buf) for _ in counts]
    dist.all_gather(out, buf)
    return np.concatenate([o[:n].cpu().numpy() for o, n in zip(out, counts)])


def global_batch(mesh, *local_arrays: np.ndarray, device: Optional[torch.device] = None):
    """Host-local rows -> ``(tensors on device, sharded)``, in the arrays'
    dtypes.

    ``sharded`` True: each tensor is this rank's rows of the global batch,
    which the step computes with its statistics summed over the ranks. A
    batch whose global row count does not split evenly over ``mesh``'s data
    axis (ranks holding different counts) cannot be; it is gathered onto
    every rank, and ``sharded`` is False: every rank computes the whole
    batch, as the JAX package replicates it."""
    dev = device or local_device()
    counts = row_counts(len(local_arrays[0]))
    n_data = mesh.shape["data"] if mesh is not None else 1
    sharded = len(set(counts)) == 1 and sum(counts) % n_data == 0
    if not sharded:
        local_arrays = [allgather_rows(np.asarray(a), counts) for a in local_arrays]
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in local_arrays)
    return tensors, sharded
