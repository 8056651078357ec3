"""The port's CLI (cli/main.py) on the CPU, and its --json documents
against the JAX package's CLI.

Both CLIs load the same `.npz` weights (tests/test_torch_app.py's
seeded_weights: SCRFD-500m biased to find faces on the test images,
IResNet-18) at --det-size 128, and both packages' auto_config is wrapped
here to add compute_dtype="float32" (on the CPU both pick the gather
warp). Images: two 128×128 PNGs (letterbox = identity) and one 192×256
PNG of 2×2-repeated noise (scale 0.5 exactly, so every letterbox gives
the same pixels); the webcam runs the 128×128 synthetic source (seeded
noise with the test images' statistics, so the detector finds faces
there too). The JAX CLI runs three times: compare, bulk detect and
multi-probe identify; their documents must have the same keys and face
counts, boxes within 1 px and similarities within 1e-4.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import facerecognizeonnx_tpu.config as jax_config
from chip_smoke import png_bytes
from facerecognizeonnx_tpu.cli.main import main as jax_main
from facerecognizeonnx_tpu_torch.cli import main as cli
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.runtime.native import letterbox_native
from tests.test_torch_app import seeded_weights

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _float32(monkeypatch):
    for mod in (jax_config, cli):
        auto = mod.auto_config
        monkeypatch.setattr(
            mod, "auto_config",
            lambda _auto=auto, **kw: _auto(**{"compute_dtype": "float32", **kw}),
        )


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(61)
    small = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    images = [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(2)]
    images.append(np.repeat(np.repeat(small, 2, axis=0), 2, axis=1))
    paths = []
    for i, img in enumerate(images):
        paths.append(str(root / f"p{i}.png"))
        Path(paths[-1]).write_bytes(png_bytes(np.ascontiguousarray(img[..., ::-1])))
    boxed = np.stack([letterbox_native(im, 128)[0] for im in images])
    det, rec = seeded_weights(root, boxed)
    models = ["--det-model", det, "--rec-model", rec, "--rec-arch", "iresnet18",
              "--det-size", "128"]
    return root, paths, models


def run(main, argv, capsys):
    """(rc, stdout parsed as exactly one JSON document, stderr)."""
    rc = main(argv + ["--json", "--cpu"])
    out = capsys.readouterr()
    return rc, json.loads(out.out), out.err


def _same_faces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["box"], w["box"], atol=1.0)
        assert abs(g["score"] - w["score"]) <= 1e-3
        for gm, wm in zip(g.get("matches", []), w.get("matches", [])):
            assert gm["name"] == wm["name"]
            assert abs(gm["similarity"] - wm["similarity"]) <= 1e-4


def test_json_documents_match_jax(files, capsys):
    root, paths, models = files
    gallery = str(root / "g.npz")
    rc, doc, _ = run(cli.main, ["enroll", *paths, "--gallery", gallery, *models], capsys)
    assert rc == 0 and doc["enrolled"] == ["p0", "p1", "p2"]
    for argv in (["compare", paths[0], paths[2]], ["detect", *paths],
                 ["identify", *paths, "--gallery", gallery]):
        rc, got, err = run(cli.main, argv + models, capsys)
        jrc, want, _ = run(jax_main, argv + models, capsys)
        assert rc == jrc == 0 and set(got) == set(want), argv
        if argv[0] == "compare":
            assert "相似度" in err  # the human output went to stderr
            assert got["n_faces"] == want["n_faces"] and got["same"] == want["same"]
            assert abs(got["similarity"] - want["similarity"]) <= 1e-4
            _same_faces(got["faces"], want["faces"])
            continue
        assert [im["path"] for im in got["images"]] == [im["path"] for im in want["images"]]
        for g, w in zip(got["images"], want["images"]):
            assert g["faces"]
            _same_faces(g["faces"], w["faces"])
        if argv[0] == "identify":
            # each probe's best face is the face it enrolled
            assert [im["faces"][0]["label"] for im in got["images"]] == ["p0", "p1", "p2"]
        else:
            assert got["total_faces"] == want["total_faces"] > 0


def test_every_ported_mode(files, capsys, tmp_path):
    _, paths, models = files
    gallery = str(tmp_path / "g.npz")
    rc, doc, _ = run(cli.main, ["detect", paths[0], *models], capsys)
    assert rc == 0 and doc["total_faces"] > 0 and os.path.exists(paths[0][:-4] + "_out.jpg")
    rc, doc, _ = run(cli.main, ["simple", paths[0], paths[1], *models], capsys)
    assert rc == 0 and doc["mode"] == "simple" and 0 <= doc["similarity"] <= 1
    rc, doc, _ = run(cli.main, ["enroll", paths[0], *models, "--gallery", gallery], capsys)
    assert rc == 0 and doc["gallery_size"] == 1
    rc, doc, _ = run(cli.main, ["identify", paths[0], *models, "--gallery", gallery], capsys)
    assert rc == 0 and doc["faces"][0]["label"] == "p0"  # the single-probe contract
    for extra in ([], ["--track"], ["--track", "--adaptive-embed"]):
        n = 4 if extra else 2
        rc, doc, _ = run(cli.main, ["webcam", f"synthetic:128x128x{n}", "--enroll-first",
                                    *extra, *models], capsys)
        assert rc == 0 and doc["frames"] == n, extra
        if extra:
            assert doc["track"]["total_frames"] == n
            assert ("embed_bucket" in doc["track"]) == ("--adaptive-embed" in extra)
    # --track with an existing gallery labels tracks by 1:N search
    rc, doc, _ = run(cli.main, ["webcam", "synthetic:128x128x4", "--track", "--gallery",
                                gallery, *models], capsys)
    assert rc == 0 and doc["track"]["total_frames"] == 4
    rc, doc, _ = run(cli.main, ["doctor", "--gallery", gallery, "--pack", "buffalo_s"], capsys)
    assert rc == 0 and doc["backend"]["platform"] == "cpu"
    assert doc["gallery"]["rows"] == 1 and doc["real_model_parity"]["status"] == "skipped"
    assert set(doc["packs"]) == {"buffalo_sc", "buffalo_s", "buffalo_m", "buffalo_l"}
    assert doc["build_cache"]["dir"].endswith("_build")
    # without --json: the banner and the reference's Chinese stdout
    assert cli.main(["compare", paths[0], paths[1], *models, "--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("InsightFace") and "特征维度: 512" in out and "结果:" in out


def test_usage_and_det_size_errors(files, capsys):
    _, paths, _ = files
    assert cli.main(["compare", paths[0], "--cpu"]) == -1
    assert "无效的命令或参数" in capsys.readouterr().out
    assert cli.main(["detect", paths[0], "--det-size", "100", "--cpu"]) == -1
    assert "32 的倍数" in capsys.readouterr().out


def test_without_cuda_and_without_cpu(files, capsys, monkeypatch):
    _, paths, models = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["detect", paths[0], *models]) != 0
    assert "torch.cuda.is_available() is False" in capsys.readouterr().out
    assert cli.main(["detect", paths[0], *models, "--json"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "torch.cuda.is_available() is False" in out.err


@pytest.mark.parametrize("argv, item", [
    (["bench"], "item 8"), (["train", "d"], "item 17"), (["eval", "d"], "item 17"),
])
def test_unported_modes_and_options_raise(argv, item):
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        cli.main(argv + ["--cpu"])


@pytest.fixture
def plain_gallery(files, tmp_path, capsys):
    """The gallery of a plain enroll of the three test images (after the
    float32 wrap of auto_config, a function-scoped fixture)."""
    _, paths, models = files
    gallery = str(tmp_path / "plain.npz")
    assert cli.main(["enroll", *paths, "--gallery", gallery, *models, "--json", "--cpu"]) == 0
    capsys.readouterr()
    return gallery


_SERVE_PLAIN = {}


def _serve_once(monkeypatch, argv, image):
    """`serve` in process: the real make_server, one identify through its
    service, then the serve loop ends as on Ctrl-C. Returns (make_server
    kwargs, the IdentifyResult)."""
    from facerecognizeonnx_tpu_torch.pipeline import server as srv

    seen = {}
    real = srv.make_server

    def recording(*a, **kw):
        server = real(*a, **kw)
        seen["kw"], seen["result"] = kw, server.frt_service.identify(image, top_k=3)

        def stop():
            raise KeyboardInterrupt

        server.serve_forever = stop
        return server

    monkeypatch.setattr(srv, "make_server", recording)
    cli.main(argv + ["--port", "0", "--cpu"])
    return seen["kw"], seen["result"]


@pytest.mark.parametrize("case", ["enroll_sharded", "enroll_experts", "identify_sharded",
                                  "serve_dp", "serve_sharded"])
def test_parallel_options(files, plain_gallery, tmp_path, capsys, monkeypatch, case):
    """--sharded, --experts and --dp on a one-rank Gloo mesh in process,
    against the same command without them."""
    from facerecognizeonnx_tpu_torch.io.imageio import imread

    _, paths, models = files
    plain = GalleryBank.load(plain_gallery, device="cpu")
    if case.startswith("enroll"):
        gallery = str(tmp_path / "g.npz")
        extra = (["--sharded"] if case == "enroll_sharded"
                 else ["--experts", f"{models[3]},{models[3]}"])  # --rec-model twice
        rc, doc, err = run(cli.main, ["enroll", *paths, "--gallery", gallery, *models, *extra],
                           capsys)
        assert rc == 0 and doc["enrolled"] == ["p0", "p1", "p2"]
        got = GalleryBank.load(gallery, device="cpu")
        assert got.names == plain.names
        np.testing.assert_allclose(got.features, plain.features, rtol=0, atol=1e-5)
        if case == "enroll_experts":
            assert doc["experts"] == 2 and "专家并行注册: 2 个识别器" in err
        return
    if case == "identify_sharded":  # the noise image: 28 faces, the others ~40 each
        argv = ["identify", paths[2], *models, "--gallery", plain_gallery]
        rc, want, _ = run(cli.main, argv, capsys)
        rc2, got, _ = run(cli.main, argv + ["--sharded"], capsys)
        assert rc == rc2 == 0 and got["faces"]
        _same_faces(got["faces"], want["faces"])
        assert [f["label"] for f in got["faces"]] == [f["label"] for f in want["faces"]]
        return
    image = imread(paths[0])
    argv = ["serve", *models, "--gallery", plain_gallery]
    if "want" not in _SERVE_PLAIN:  # the plain serve's answer, shared by both cases
        _SERVE_PLAIN["want"] = _serve_once(monkeypatch, argv, image)[1]
    want = _SERVE_PLAIN["want"]
    capsys.readouterr()
    extra = ["--dp", "2"] if case == "serve_dp" else ["--sharded"]
    kw, got = _serve_once(monkeypatch, argv + extra, image)
    out = capsys.readouterr().out
    if case == "serve_dp":  # one process drives one device: --dp clamps to 1
        assert "--dp 2 请求, 本机只有 1 设备 → dp=1" in out and kw["mesh"] is None
    else:
        assert kw["sharded"] is True
    assert got.names == want.names and got.valid.any()
    np.testing.assert_allclose(got.sims, want.sims, rtol=0, atol=1e-6)


def test_onnx_pack_files_and_real_models_raise(files, tmp_path, monkeypatch, capsys):
    """Empty .onnx files on disk are loaded, not passed over: the pack's
    detector fails to load (the CLI exits -1), and doctor's real-model
    parity runs and reports the failure (tests/test_torch_onnx_api.py
    loads real exports)."""
    _, paths, _ = files
    for name in ("det_500m.onnx", "w600k_r50.onnx"):
        (tmp_path / name).write_bytes(b"")
    with pytest.raises(SystemExit) as exc:
        cli.main(["detect", paths[0], "--pack", "buffalo_sc", "--model-dir", str(tmp_path),
                  "--cpu"])
    assert exc.value.code == -1
    assert "Error loading model: cannot load ONNX model" in capsys.readouterr().out
    monkeypatch.setenv("FRT_REAL_MODELS_DIR", str(tmp_path))
    assert cli.main(["doctor", "--json", "--cpu"]) == 0
    rmp = json.loads(capsys.readouterr().out)["real_model_parity"]
    assert rmp["status"] == "FAIL" and rmp["dir"] == str(tmp_path)


def test_serve_sigterm_persists_gallery(files, tmp_path):
    """serve in its own process: SIGTERM stops accepting, drains the
    service and saves the gallery, and the process exits 0."""
    _, paths, models = files
    gallery = str(tmp_path / "g.npz")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "facerecognizeonnx_tpu_torch", "serve", "--cpu", *models,
         "--gallery", gallery, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO,
    )
    try:
        port = None
        deadline = time.time() + 300
        for line in proc.stdout:
            m = re.search(r"http://[0-9.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
            assert time.time() < deadline, "server never came up"
        assert port, "startup line not seen"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/enroll?name=alice",
                                     data=Path(paths[0]).read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            assert json.loads(r.read())["enrolled"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        bank = GalleryBank.load(gallery, device="cpu")
        assert bank.names == ["alice"]
    finally:
        if proc.poll() is None:
            proc.kill()
