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

The CLI's counterpart of "every local device" (`jax.devices()`):
`ranks_for` says how many ranks a mode runs on a host's cards, and
`start_ranks` makes this process rank 0 of that many, starting the
others as `RankProcesses` (one process per card, the same command with
the three variables set). `tools/multichip_parallel.py` starts its
ranks with the same class.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from typing import Callable, Dict, Iterable, Optional, Sequence

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


# how long the ranks a process started may take to exit after it is done
EXIT_TIMEOUT_S = 300.0
LOG_TAIL = 4000  # bytes of a failed rank's output that are shown


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ranks_for(mode: str, n_cards: int, batch: int = 1, dp: int = 0,
              sharded: bool = False) -> int:
    """How many ranks, one per card, a CLI mode runs on a host of
    `n_cards` visible cards (the JAX CLI's use of `jax.devices()`):
    `train` the largest count that divides its batch, `serve` min(dp,
    n_cards) (every card for dp -1 or `sharded`), every other mode one."""
    n_cards = max(1, int(n_cards))
    if mode == "train":
        return max(d for d in range(1, n_cards + 1) if batch % d == 0)
    if mode == "serve":
        if sharded or dp == -1:
            return n_cards
        return min(max(int(dp), 1), n_cards)
    return 1


class RankProcesses:
    """`cmd` started once for each rank in `ranks` of a `world`-rank group
    that meets at `address` (host:port), the launcher's variables set in
    each environment. Ranks in `passthrough` write to this process's
    stdout and stderr; the others to a temporary file each, whose tail is
    shown when that rank fails. Each starts in a session of its own, so
    a terminal's signals reach only the process that started them."""

    def __init__(self, cmd: Sequence[str], ranks: Iterable[int], world: int, address: str,
                 passthrough: Iterable[int] = (), env: Optional[dict] = None):
        base = dict(os.environ if env is None else env, COORDINATOR_ADDRESS=address,
                    NUM_PROCESSES=str(world))
        self.procs: Dict[int, subprocess.Popen] = {}
        self._logs: Dict[int, object] = {}
        passthrough = set(passthrough)
        try:
            for r in ranks:
                log = None if r in passthrough else tempfile.TemporaryFile()
                self._logs[r] = log
                self.procs[r] = subprocess.Popen(
                    list(cmd), env=dict(base, PROCESS_ID=str(r)), stdout=log,
                    stderr=None if log is None else subprocess.STDOUT, start_new_session=True,
                )
        except BaseException:
            self.kill()
            raise

    def tail(self, rank: int) -> str:
        log = self._logs.get(rank)
        if log is None:
            return "(its output is above)"
        log.flush()
        size = log.seek(0, os.SEEK_END)
        log.seek(max(0, size - LOG_TAIL))
        return log.read().decode(errors="replace")

    def failed(self) -> list:
        """[(rank, exit code)] of the ranks that exited non-zero."""
        return [(r, p.returncode) for r, p in self.procs.items()
                if p.poll() is not None and p.returncode != 0]

    def report(self, rank: int, what: str) -> None:
        print(f"rank {rank} {what}; its output ends:\n{self.tail(rank)}", file=sys.stderr,
              flush=True)

    def kill(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self, timeout: float) -> int:
        """Wait up to `timeout` s for every rank; 0 when all exited 0, else
        1 after showing each failed or still running rank's output (the
        ones still running are killed)."""
        deadline = time.monotonic() + timeout
        late = []
        for r, p in self.procs.items():
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                late.append(r)
        self.kill()
        for r in late:
            self.report(r, f"still running after {timeout:.0f} s (killed)")
        bad = [(r, rc) for r, rc in self.failed() if r not in late]
        for r, rc in bad:
            self.report(r, f"exit {rc}")
        return 1 if late or bad else 0

    def watch(self, on_failure: Callable[[int, int], None]) -> None:
        """A daemon thread that calls on_failure(rank, exit code) for the
        first rank that exits non-zero, then stops."""

        def run():
            while True:
                bad = self.failed()
                if bad:
                    on_failure(*bad[0])
                    return
                if all(p.poll() is not None for p in self.procs.values()):
                    return
                time.sleep(0.2)

        threading.Thread(target=run, daemon=True, name="rank-watch").start()


def start_ranks(n_ranks: int, cmd: Sequence[str], device: str = "cuda",
                env: Optional[dict] = None) -> Optional[RankProcesses]:
    """Put this process in the process group of a command that runs on
    `n_ranks` ranks, and return the ranks it started, if any.

    With COORDINATOR_ADDRESS in the environment (a test or an outside
    launcher started the ranks) it joins that group. Otherwise, on a
    CUDA device with n_ranks > 1, it starts `cmd` for ranks 1..n_ranks-1
    on a free localhost port and becomes rank 0; else it is one rank on
    its own. No fallback: a rank that exits non-zero before this process
    is done ends this process with exit code 1 and that rank's output
    (a thread watches them), and a failed rendezvous raises."""
    if "COORDINATOR_ADDRESS" in os.environ or n_ranks <= 1 or torch.device(device).type != "cuda":
        init_distributed(device=device)
        return None
    address = f"127.0.0.1:{free_port()}"
    procs = RankProcesses(cmd, range(1, n_ranks), n_ranks, address, env=env)

    def fail(rank, rc):
        procs.report(rank, f"exit {rc}")
        procs.kill()
        sys.stdout.flush()
        os._exit(1)  # this process may be waiting in a collective with that rank

    procs.watch(fail)
    try:
        init_distributed(address, n_ranks, 0, device=device)
    except BaseException:
        procs.kill()
        raise
    return procs
