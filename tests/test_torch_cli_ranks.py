"""The CLI's `train` and `serve --dp 2` on two Gloo ranks joined through
the launcher's variables (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID: what the CLI sets for the ranks it starts on a host with
cards, and what an outside launcher sets), against the same commands on
one rank.

Every process starts at once, one torch thread each, through
`tests/torch_ranks.py`'s `cli_command` (the CLI with auto_config wrapped
to float32). Weights: SCRFD-500m biased to find faces on the folder's
images (`chip_smoke.detection_bias`) at --det-size 128, and a seeded
MobileFaceNet (`--rec-arch mbf`, the buffalo_s recognizer: the
cheapest embed of the families, so the six processes fit the CPU).

- `train --align` on 4 identities × 2 noise PNGs, 2 steps at batch 8:
  the two ranks split the cropping, all-gather the crops and step on a
  (2, 1) mesh. Their saved `.npz` is held against the one-rank run's
  under the bars of `tests/test_torch_train_step.py::hold_step`: loss
  rel 1e-5; BN statistics within 1e-4 of scale; the backbone's update
  within 1e-2 relative L2.
- `serve --dp 2`: rank 0 serves HTTP and relays. 8 concurrent
  /identify requests answer as the one-rank `serve` does: the same
  faces and names, boxes within 1e-3 px, sims within 1e-4 (the payload
  rounds to 4 decimals). One /enroll reaches the follower's bank, and
  SIGTERM to rank 0 drains both ranks, which exit 0, rank 0 saving the
  gallery once.
"""

import glob
import json
import re
import signal
import subprocess
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import detection_bias, png_bytes
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.parallel.distributed import free_port
from facerecognizeonnx_tpu_torch.utils.checkpoint import _flatten, load_params, save_params
from tests.test_torch_train_step import _l2, hold_leaves
from tests.torch_ranks import cli_command, cli_env

DEADLINE_S = 240.0


def _start(tmp, tag, argv, world=1):
    """`world` ranks of the CLI; returns [(Popen, log path)]."""
    launcher = {}
    if world > 1:
        launcher = dict(COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}", NUM_PROCESSES=world)
    procs = []
    for r in range(world):
        log = tmp / f"{tag}{r}.log"
        env = cli_env(**launcher, **({"PROCESS_ID": r} if world > 1 else {}))
        with open(log, "wb") as f:
            procs.append((subprocess.Popen(cli_command(argv), env=env, cwd=tmp, stdout=f,
                                           stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, deadline):
    for p, log in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return [(p.returncode, log.read_text()) for p, log in procs]


def _port(log: Path, proc, deadline) -> int:
    while time.monotonic() < deadline and proc.poll() is None:
        m = re.search(r"服务已启动: http://[0-9.]+:(\d+)", log.read_text())
        if m:
            return int(m.group(1))
        time.sleep(0.2)
    raise AssertionError(f"serve never listened:\n{log.read_text()[-3000:]}")


def _post(port, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=DEADLINE_S) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_ranks")
    rng = np.random.default_rng(71)
    images = []
    for i in range(4):
        (tmp / "ids" / f"id{i}").mkdir(parents=True)
        for j in range(2):
            img = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
            (tmp / "ids" / f"id{i}" / f"{j}.png").write_bytes(png_bytes(img[..., ::-1].copy()))
            images.append(img)
    det, rec = str(tmp / "det.npz"), str(tmp / "rec.npz")
    save_params(det, detection_bias(bridge.init_params_numpy("500m", seed=0),
                                    torch.from_numpy(np.stack(images))))
    save_params(rec, bridge.init_params_numpy("mbf", seed=1))
    feats = rng.normal(size=(50, 512)).astype(np.float32)
    bank = GalleryBank(device="cpu")
    bank.add_batch([f"g{i}" for i in range(50)], feats / np.linalg.norm(feats, axis=1,
                                                                         keepdims=True))
    for tag in ("one", "two"):
        bank.save(str(tmp / f"{tag}.npz"))
    models = ["--det-model", det, "--det-size", "128", "--rec-arch", "mbf", "--cpu"]
    train = ["train", "ids", "--align", "--steps", "2", "--batch", "8", *models]
    serve = ["serve", "--rec-model", rec, "--port", "0", *models]
    deadline = time.monotonic() + DEADLINE_S
    procs = {
        "train_one": _start(tmp, "train_one", train + ["--out", "t1.npz"]),
        "train_two": _start(tmp, "train_two", train + ["--out", "t2.npz"], world=2),
        "serve_one": _start(tmp, "serve_one", serve + ["--gallery", "one.npz"]),
        "serve_two": _start(tmp, "serve_two", serve + ["--gallery", "two.npz", "--dp", "2"],
                            world=2),
    }
    try:
        ports = {k: _port(procs[k][0][1], procs[k][0][0], deadline)
                 for k in ("serve_one", "serve_two")}
        files = sorted(glob.glob(str(tmp / "ids" / "*" / "*.png")))
        jobs = [(k, f) for k in ports for f in files]  # both servers at once
        with ThreadPoolExecutor(len(jobs)) as ex:
            got = list(ex.map(
                lambda j: _post(ports[j[0]], "/identify?top_k=3", Path(j[1]).read_bytes()), jobs))
        answers = {k: [a for (kk, _), a in zip(jobs, got) if kk == k] for k in ports}
        enrolled = {k: _post(port, "/enroll?name=alice", Path(files[0]).read_bytes())
                    for k, port in ports.items()}
        for k in ports:
            procs[k][0][0].send_signal(signal.SIGTERM)
        done = {k: _wait(v, deadline) for k, v in procs.items()}
    finally:
        for v in procs.values():
            for p, _ in v:
                if p.poll() is None:
                    p.kill()
    return tmp, done, answers, enrolled


def _ok(done, key):
    for r, (rc, log) in enumerate(done[key]):
        assert rc == 0, f"{key} rank {r} exit {rc}:\n{log[-3000:]}"
    return [log for _, log in done[key]]


def _loss(log: str) -> float:
    return float(re.search(r"step 2/2 loss ([0-9.]+)", log).group(1))


def test_two_rank_train_matches_one_rank(runs):
    tmp, done, _, _ = runs
    one, two = _ok(done, "train_one")[0], _ok(done, "train_two")
    assert "进程组: gloo × 2 ranks (rank 0: cpu)" in two[0] and "mesh data=2" in two[0]
    assert "数据: 8/8 张裁剪, 2 个 rank 分担" in two[0] and "mesh data=1" in one
    assert "训练完成" not in two[1]  # only rank 0 prints
    assert abs(_loss(two[0]) - _loss(one)) <= 1e-5 * abs(_loss(one))
    got, want = _flatten(load_params(str(tmp / "t2.npz"))), _flatten(load_params(
        str(tmp / "t1.npz")))
    before = _flatten(bridge.init_params_numpy("mbf", seed=0))
    assert got.keys() == want.keys()
    stats = [k for k in want if k.endswith(("/mean", "/var"))]
    hold_leaves({k: got[k] for k in stats}, {k: want[k] for k in stats})
    weights = [k for k in want if k not in stats]
    upd = {k: got[k] - before[k] for k in weights}
    assert _l2(upd, {k: want[k] - before[k] for k in weights}, weights) <= 1e-2
    assert any(not np.array_equal(got[k], before[k]) for k in weights)


def test_two_rank_serve_matches_one_rank(runs):
    _, done, answers, _ = runs
    _ok(done, "serve_one")
    _ok(done, "serve_two")
    n_faces = 0
    for a, b in zip(answers["serve_two"], answers["serve_one"], strict=True):
        assert len(a["faces"]) == len(b["faces"])
        for fa, fb in zip(a["faces"], b["faces"]):
            assert fa["names"] == fb["names"]
            np.testing.assert_allclose(fa["box"], fb["box"], rtol=0, atol=1e-3)
            np.testing.assert_allclose(fa["sims"], fb["sims"], rtol=0, atol=1e-4 + 1e-9)
            n_faces += 1
    assert n_faces


def test_relay_enroll_and_sigterm_drain(runs):
    tmp, done, _, enrolled = runs
    lead, follower = _ok(done, "serve_two")
    assert enrolled["serve_two"] == enrolled["serve_one"] == {
        "enrolled": True, "name": "alice", "gallery_size": 51}
    assert "identify 数据并行: 2 设备" in lead and "gallery 已保存 → two.npz (51 条)" in lead
    # the follower served every relayed identify (and the warm-up) and took
    # the enroll, and saved nothing
    assert "所有 rank 已排空 (请求, gallery 条数, 最后一条): [(9, 51, 'alice'), (9, 51, " \
        "'alice')]" in lead
    assert "gallery 已保存" not in follower and "服务已启动" not in follower
    for tag in ("one", "two"):
        assert GalleryBank.load(str(tmp / f"{tag}.npz"), device="cpu").names[-1] == "alice"
    torch.testing.assert_close(
        torch.from_numpy(GalleryBank.load(str(tmp / "two.npz"), device="cpu").features),
        torch.from_numpy(GalleryBank.load(str(tmp / "one.npz"), device="cpu").features),
        rtol=0, atol=1e-5)
