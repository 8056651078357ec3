"""`parallel/distributed.py` of the port: environment parsing,
idempotency and error propagation with a recording fake of
`torch.distributed.init_process_group`, and two real ranks that meet on
`tcp://127.0.0.1:<free port>` through `init_distributed` and the
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID variables, then run a
cross-rank all-gather, the row-sharded gallery search and the
data-parallel embed (tests/test_distributed.py of the JAX package; its
4-process form is the 4-rank spawn of tests/test_torch_parallel.py).
"""

import numpy as np
import pytest
import torch.distributed as dist

from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.parallel import distributed
from tests.torch_ranks import run_ranks


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
