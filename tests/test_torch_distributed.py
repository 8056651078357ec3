"""`parallel/distributed.py` of the port: environment parsing,
idempotency and error propagation with a recording fake of
`torch.distributed.init_process_group`, and two real ranks that meet on
`tcp://127.0.0.1:<free port>` through `init_distributed` and the
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID variables, then run a
cross-rank all-gather, the row-sharded gallery search and the
data-parallel embed (tests/test_distributed.py of the JAX package; its
4-process form is the 4-rank spawn of tests/test_torch_parallel.py).

The CLI's launcher: its rank count per mode on a faked card count (the
launch itself replaced by a recorder, so nothing is spawned), and
`RankProcesses` showing a failed rank's exit code and output.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.cli import main as cli
from facerecognizeonnx_tpu_torch.parallel import distributed
from tests.torch_ranks import run_ranks

REPO = str(Path(__file__).resolve().parent.parent)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(257, 64)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    inputs = {
        "g257": g,
        "rec32": bridge.init_params_numpy("iresnet18", seed=2, input_size=32),
        "crops32": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
    }
    outs = run_ranks(tmp_path_factory.mktemp("tcp"), 2, ["dist"], inputs, tcp=True)
    return inputs, [o["dist"] for o in outs]


def test_two_tcp_ranks_all_gather(two_ranks):
    _, outs = two_ranks
    for o in outs:
        np.testing.assert_array_equal(o["ranks"], [0.0, 1.0])
        assert int(o["backend"]) == 1  # Gloo for the CPU


def test_two_tcp_ranks_sharded_search(two_ranks):
    inputs, outs = two_ranks
    g = inputs["g257"]
    full = (g[:8] @ g.T + 1.0) / 2.0
    for o in outs:
        assert o["idx"].shape == (8, 3) and (o["idx"][:, 0] == np.arange(8)).all()
        np.testing.assert_allclose(o["sims"][:, 0], 1.0, atol=1e-5)
        np.testing.assert_allclose(o["sims"], np.sort(full, axis=1)[:, -3:][:, ::-1],
                                   rtol=0, atol=1e-6)


def test_two_tcp_ranks_batch_embed(two_ranks):
    _, outs = two_ranks
    for o in outs:
        assert o["feats"].shape == (4, 512)
        np.testing.assert_allclose(o["feats"], o["plain"], rtol=0, atol=1e-5)


@pytest.fixture
def fake_init(monkeypatch):
    """Records init_process_group calls; the second and later raise the
    "already initialized" error a real second call would."""
    calls = []

    def fake(backend, init_method=None, world_size=-1, rank=-1, store=None, timeout=None):
        calls.append((backend, init_method, world_size, rank))
        if len(calls) > 1:
            raise RuntimeError("process group already initialized")

    monkeypatch.setattr(dist, "init_process_group", fake)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    return calls


def test_env_parsing_and_idempotency(monkeypatch, fake_init):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "8")
    monkeypatch.setenv("PROCESS_ID", "3")
    distributed.init_distributed(device="cpu")
    assert fake_init == [("gloo", "tcp://10.0.0.1:1234", 8, 3)]
    distributed.init_distributed(device="cpu")  # second call: swallowed
    # explicit arguments beat the environment
    distributed.init_distributed("1.2.3.4:99", 2, 1, device="cpu")
    assert fake_init[-1] == ("gloo", "tcp://1.2.3.4:99", 2, 1)


def test_unrelated_runtime_error_propagates(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="unreachable"):
        distributed.init_distributed("x:1", 2, 0, device="cpu")


def test_after_a_mesh(monkeypatch):
    """Once a group exists: one process is a no-op, more raise."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    distributed.init_distributed("x:1", 1, 0, device="cpu")
    with pytest.raises(RuntimeError, match="before any mesh"):
        distributed.init_distributed("x:1", 2, 0, device="cpu")


def test_backends():
    assert distributed.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError, match="backend"):
        distributed.backend_for("meta")
    if dist.is_nccl_available():
        assert distributed.backend_for("cuda") == "nccl"
    else:  # a CUDA mesh without NCCL raises: no Gloo or CPU fallback
        with pytest.raises(RuntimeError, match="NCCL"):
            distributed.backend_for("cuda")


class _Launched(Exception):
    pass


@pytest.mark.parametrize("argv,cards,want", [
    (["serve"], 4, 1),
    (["serve", "--dp", "2"], 4, 2),
    (["serve", "--dp", "8"], 4, 4),
    (["serve", "--dp", "-1"], 4, 4),
    (["serve", "--sharded"], 4, 4),
    (["serve", "--dp", "-1"], 1, 1),
    (["serve", "--dp", "-1", "--cpu"], 4, 1),
    (["train", "IDS"], 4, 3),  # 6 images: batch min(32, 6) = 6 → 3 ranks
    (["train", "IDS", "--batch", "4"], 4, 4),
    (["train", "IDS", "--batch", "4"], 3, 2),
    (["train", "IDS", "--batch", "4", "--cpu"], 4, 1),
])
def test_cli_rank_count(monkeypatch, tmp_path, argv, cards, want):
    """One rank per card: `train` the most cards dividing its batch,
    `serve` min(--dp, cards), every card for --dp -1 and --sharded, one
    rank with --cpu; the ranks re-run the same command."""
    for who in ("a", "b", "c"):
        (tmp_path / who).mkdir()
        for i in range(2):
            (tmp_path / who / f"{i}.png").write_bytes(b"")  # listed, never read
    argv = [str(tmp_path) if a == "IDS" else a for a in argv]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    seen = []

    def record(n_ranks, cmd, device="cuda", env=None):
        seen.append((n_ranks, cmd, device))
        raise _Launched

    monkeypatch.setattr(distributed, "start_ranks", record)
    with pytest.raises(_Launched):
        cli.main(argv)
    n_ranks, cmd, device = seen[0]
    assert n_ranks == want and device == ("cpu" if "--cpu" in argv else "cuda")
    assert cmd == [sys.executable, "-m", "facerecognizeonnx_tpu_torch", *argv]


def test_other_modes_take_one_rank():
    for mode in ("detect", "enroll", "identify", "export", "eval", "webcam"):
        assert distributed.ranks_for(mode, 8, batch=8, dp=-1, sharded=True) == 1


def test_a_failed_rank_is_reported(capfd):
    """A rank that exits non-zero fails the wait with its exit code and
    the tail of its output; the watch thread names it."""
    code = "import os, sys; print('rank says', os.environ['PROCESS_ID']); " \
           "sys.exit(3 if os.environ['PROCESS_ID'] == '2' else 0)"
    procs = distributed.RankProcesses([sys.executable, "-c", code], [1, 2], 3,
                                      "127.0.0.1:1")
    failed = []
    procs.watch(lambda r, rc: failed.append((r, rc)))
    assert procs.wait(60) == 1
    err = capfd.readouterr().err
    assert "rank 2 exit 3; its output ends:\nrank says 2" in err and "rank 1" not in err
    for _ in range(100):
        if failed:
            break
        time.sleep(0.05)
    assert failed == [(2, 3)]


def test_a_rank_that_fails_ends_the_command():
    """`start_ranks` on the card path: rank 1 exits 3 while rank 0 waits
    for it (its rendezvous faked by a sleep), and rank 0 exits 1 within
    seconds, showing rank 1's output; it does not carry on alone."""
    code = (
        "import sys, time\n"
        "from facerecognizeonnx_tpu_torch.parallel import distributed\n"
        "distributed.init_distributed = lambda *a, **kw: time.sleep(60)\n"
        "distributed.start_ranks(2, [sys.executable, '-c', "
        "'import sys; print(\"rank one starting\"); sys.exit(3)'], device='cuda')\n"
        "print('carried on')\n"
    )
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=REPO)
    assert proc.returncode == 1 and time.monotonic() - t0 < 30
    assert "rank 1 exit 3; its output ends:\nrank one starting" in proc.stderr
    assert "carried on" not in proc.stdout
