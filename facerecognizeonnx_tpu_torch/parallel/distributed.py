"""Multi-process initialization of `torch.distributed`.

Port of `facerecognizeonnx_tpu/parallel/distributed.py`. One process
drives one device (see `parallel/mesh.py`), so a job of N devices is N
processes that each call this first, with the launcher's conventional
environment variables:

    from facerecognizeonnx_tpu_torch.parallel.distributed import init_distributed
    init_distributed()  # reads COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
    mesh = make_mesh(("model",))          # spans every process's device
    sharded_topk_search(q, gallery, k, mesh=mesh)

A single process never needs it: `make_mesh` starts a one-rank group on
its own. Once such a group exists, a call here for one process is a
no-op and a call for more raises (it must come before any mesh), as
`jax.distributed.initialize` must come before any device use.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# every process group of the port: a rank that waits longer than this on
# a collective fails instead of hanging its caller
GROUP_TIMEOUT = timedelta(seconds=60)


def backend_for(device_type: str) -> str:
    """NCCL for CUDA devices, Gloo for the CPU. A CUDA device without
    NCCL raises: nothing falls back to Gloo or to the CPU."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch build lacks")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {device_type!r}")


def bind_device(device_type: str, rank: int) -> torch.device:
    """The one device of `rank`: cuda:{rank % device_count} (made the
    current CUDA device) or the CPU."""
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Initialize the default process group from the arguments or the
    environment (COORDINATOR_ADDRESS host:port, NUM_PROCESSES,
    PROCESS_ID): `tcp://` rendezvous, NCCL for device "cuda", Gloo for
    "cpu", and this rank's device made current. Idempotent: an "already
    initialized" error is swallowed, any other propagates."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    device_type = torch.device(device).type
    if dist.is_initialized():
        if (num_processes or 1) == 1:
            return
        raise RuntimeError(
            f"init_distributed for {num_processes} processes must come before any "
            f"mesh: a process group of {dist.get_world_size()} rank(s) already exists"
        )
    world = num_processes or 1
    rank = process_id or 0
    backend = backend_for(device_type)
    if device_type == "cuda":
        bind_device(device_type, rank)
    try:
        if coordinator_address is None:
            if world != 1:
                raise ValueError(f"{world} processes need a COORDINATOR_ADDRESS")
            dist.init_process_group(
                backend, store=dist.HashStore(), rank=0, world_size=1,
                timeout=GROUP_TIMEOUT,
            )
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=world, rank=rank, timeout=GROUP_TIMEOUT,
            )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise
