"""AOT export of the port's fused step (pipeline/aot.py): `.frtz` bundles
and baked programs against the port's live step and the JAX package's,
`swap_params`, the format checks (a JAX bundle among them), and the
wiring through IdentifyService, make_server and the CLI.

Sizes of tests/test_aot.py: 128² frames, float32, pre_nms_topk=64,
max_faces=16, iresnet18. The weights are `seeded_weights` (numpy trees,
the detector biased to find ~32 faces a frame), loaded by both packages'
FaceDetector / FaceRecognizer, so both hold the same BN-folded models.
On the CPU the program's custom ops run the plain versions of the
kernels (tests/test_torch_warp.py and tests/test_torch_detect.py hold
those to the JAX package); chip_smoke.py phase 15 replays the bundle as
a CUDA graph on the card.
"""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias, png_bytes
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.pipeline.aot import save_bundle as j_save_bundle
from facerecognizeonnx_tpu.pipeline.fused import frames_to_features as j_frames_to_features
from facerecognizeonnx_tpu_torch import bridge, make_server
from facerecognizeonnx_tpu_torch.cli import main as cli
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.errors import InvalidInputError, ModelLoadError
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.pipeline import aot
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features
from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService
from tests.test_torch_app import load_both, seeded_weights

SIZE, B, K = 128, 2, 4
SMALL = dict(det_input_size=SIZE, compute_dtype="float32", pre_nms_topk=64, max_faces=16,
             rec_arch="iresnet18")
CFG = PipelineConfig(warp_impl="cuda", **SMALL)
JCFG = JaxConfig(warp_impl="pallas", warp_interpret=True, **SMALL)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Frames, the weight files, both packages' models, the port's live
    step and one bundle of it (its path and a loaded AotPipeline)."""
    root = tmp_path_factory.mktemp("aot")
    rng = np.random.default_rng(71)
    frames = rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    paths = seeded_weights(root, frames)
    (det, rec), (jdet, jrec) = load_both(paths, CFG, JCFG)
    with torch.no_grad():
        live = frames_to_features(det.params, rec.params, torch.from_numpy(frames), CFG, K)
    path = aot.save_bundle(str(root / "step.frtz"), det.params, rec.params, CFG, B, K)
    return dict(root=root, frames=frames, paths=paths, port=(det, rec), jax=(jdet, jrec),
                live=live, path=path, pipe=aot.load_bundle(path, device="cpu"))


def _hold_to_live(out, live, feat_atol):
    dets, feats = live
    boxes, scores, kps, valid, got = out
    np.testing.assert_array_equal(valid.numpy(), dets.valid.numpy())
    np.testing.assert_allclose(boxes.numpy(), dets.boxes.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(kps.numpy(), dets.kps.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(scores.numpy(), dets.scores.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), feats.numpy(), atol=feat_atol, rtol=0)


def test_bundle_roundtrip_matches_live_step(world):
    pipe = world["pipe"]
    assert pipe.batch == B and pipe.max_faces_embed == K
    assert pipe.config == CFG and pipe.meta["program"] == "torch.export"
    assert world["live"][0].valid[:, :K].sum() >= 2  # faces were found
    out = pipe(world["frames"])
    _hold_to_live(out, world["live"], 1e-5)
    again = pipe(torch.from_numpy(world["frames"]))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    with zipfile.ZipFile(world["path"]) as z:  # the weights are not in the program
        assert z.getinfo("program.pt2").file_size < z.getinfo("params.npz").file_size / 4


def test_bundle_matches_jax_live_step(world):
    """The port's bundle vs the JAX package's jitted frames_to_features on
    the same folded weights, within tests/test_torch_pipeline.py's bars."""
    jdet, jrec = world["jax"]
    fn = jax.jit(lambda f: j_frames_to_features(jdet.params, jrec.params, f, JCFG, K))
    with jax.default_matmul_precision("highest"):
        w_dets, w_feats = jax.tree_util.tree_map(np.asarray, fn(jnp.asarray(world["frames"])))
    boxes, _, kps, valid, feats = world["pipe"](world["frames"])
    np.testing.assert_array_equal(valid.numpy(), w_dets.valid)
    np.testing.assert_allclose(boxes.numpy(), w_dets.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(kps.numpy(), w_dets.kps, atol=1e-3, rtol=0)
    slot = w_dets.valid[:, :K]
    f = feats.numpy()
    assert (f[~slot] == 0).all() and (w_feats[~slot] == 0).all()
    assert (f * w_feats).sum(-1)[slot].min() >= 1 - 1e-5


def _reseeded(world, part):
    """Other seeded weights for `part` ("detector" / "recognizer"), as
    BN-folded modules."""
    from facerecognizeonnx_tpu_torch.models import arcface, scrfd

    if part == "detector":
        tree = detection_bias(bridge.init_params_numpy("500m", seed=5),
                              torch.from_numpy(world["frames"]))
        return scrfd.fold_inference_params(bridge.params_from_numpy(tree, "cpu"))
    return arcface.fold_inference_params(
        bridge.params_from_numpy(bridge.init_params_numpy("iresnet18", seed=7), "cpu"))


@pytest.mark.parametrize("parts", [("recognizer",), ("detector",), ("detector", "recognizer")])
def test_swap_params_matches_live_step_on_new_weights(world, parts):
    """swap_params copies new leaves into the tensors the program reads:
    the same loaded program then gives the live step's outputs on the new
    weights (3e-5, tests/test_aot.py's bar), and swapping back restores
    the bundle's own."""
    pipe = world["pipe"]
    det, rec = (m.params for m in world["port"])
    new = {p: _reseeded(world, p) for p in parts}
    det2, rec2 = new.get("detector", det), new.get("recognizer", rec)
    pipe.swap_params(det_params=new.get("detector"), arc_params=new.get("recognizer"))
    try:
        out = pipe(world["frames"])
        with torch.no_grad():
            live2 = frames_to_features(det2, rec2, torch.from_numpy(world["frames"]), CFG, K)
        _hold_to_live(out, live2, 3e-5)
        assert not torch.allclose(out[4], world["live"][1])
    finally:
        pipe.swap_params(det_params=det, arc_params=rec)
    _hold_to_live(pipe(world["frames"]), world["live"], 1e-5)


@pytest.mark.parametrize("case", ["leaf_count", "shape"])
def test_swap_params_rejects_another_architecture(world, case):
    arch, dim = ("iresnet34", 512) if case == "leaf_count" else ("iresnet18", 256)
    from facerecognizeonnx_tpu_torch.models import arcface

    other = arcface.fold_inference_params(bridge.params_from_numpy(
        bridge.init_params_numpy(arch, seed=3, feature_dim=dim), "cpu"))
    with pytest.raises(ModelLoadError, match="leaves" if case == "leaf_count" else "leaf"):
        world["pipe"].swap_params(arc_params=other)
    _hold_to_live(world["pipe"](world["frames"]), world["live"], 1e-5)


@pytest.fixture(scope="module")
def jax_bundle(world):
    """A .frtz written by the JAX package's save_bundle (StableHLO)."""
    jdet, jrec = world["jax"]
    path = str(world["root"] / "jax.frtz")
    j_save_bundle(path, jdet.params, jrec.params, JaxConfig(**SMALL), batch=1,
                  max_faces_embed=K)
    return path


def _write_zip(path, entries):
    with zipfile.ZipFile(path, "w") as z:
        for name, data in entries.items():
            z.writestr(name, data)
    return str(path)


@pytest.mark.parametrize("case", ["wrong_shape", "wrong_dtype", "garbage", "missing",
                                  "jax_bundle", "no_meta", "other_version",
                                  "corrupt_program"])
def test_bundle_rejects(world, case, tmp_path, request):
    frames = world["frames"]
    if case in ("wrong_shape", "wrong_dtype"):
        bad = frames[:1] if case == "wrong_shape" else frames.astype(np.float32)
        with pytest.raises(InvalidInputError, match="static"):
            world["pipe"](bad)
        return
    with zipfile.ZipFile(world["path"]) as z:
        parts = {n: z.read(n) for n in z.namelist()}
    meta = json.loads(parts["meta.json"])
    path, match = str(tmp_path / "x.frtz"), "valid .frtz"
    if case == "garbage":
        Path(path).write_bytes(b"not a zip")
    elif case == "missing":
        match = "not found"
    elif case == "jax_bundle":
        path, match = request.getfixturevalue("jax_bundle"), "JAX package"
    elif case == "no_meta":
        _write_zip(path, {k: v for k, v in parts.items() if k != "meta.json"})
    elif case == "other_version":
        _write_zip(path, {**parts, "meta.json": json.dumps({**meta, "format_version": 2})})
        match = "unsupported"
    else:
        _write_zip(path, {**parts, "program.pt2": b"\0" * 64})
        match = "corrupt"
    with pytest.raises(ModelLoadError, match=match):
        aot.load_bundle(path, device="cpu")


@pytest.mark.parametrize("loader", ["load_bundle", "load_fused"])
def test_loading_onto_cuda_needs_a_card(world, loader, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        getattr(aot, loader)(world["path"])  # device="cuda" is the default


def test_save_bundle_rejects_what_is_not_a_native_module(world):
    det, rec = world["port"]
    tree = bridge.tree_from_module(rec.params)
    with pytest.raises(ModelLoadError, match="native modules"):
        aot.save_bundle(str(world["root"] / "t.frtz"), det.params, tree, CFG, B, K)


def test_save_fused_roundtrip_and_rejects(world):
    """The baked flavour: weights inside the program."""
    det, rec = world["port"]
    path = aot.save_fused(str(world["root"] / "fused.pt2"), det.params, rec.params, CFG, B, K)
    fn = aot.load_fused(path, device="cpu")
    _hold_to_live(fn(world["frames"]), world["live"], 1e-5)
    _hold_to_live(aot.load_fused(Path(path).read_bytes(), device="cpu")(world["frames"]),
                  world["live"], 1e-5)
    with pytest.raises(ModelLoadError, match="corrupt"):
        aot.load_fused(b"not a program", device="cpu")
    with pytest.raises(ModelLoadError, match="cannot read"):
        aot.load_fused(str(world["root"] / "missing.pt2"), device="cpu")


# ---------------------------------------------------------------- the wiring


def _bank(world):
    """Rows: the live step's valid features, named by frame and slot."""
    dets, feats = world["live"]
    names, rows = [], []
    for b in range(B):
        for k in range(K):
            if dets.valid[b, k]:
                names.append(f"f{b}s{k}")
                rows.append(feats[b, k].numpy())
    bank = GalleryBank(device="cpu")
    bank.add_batch(names, np.stack(rows))
    return bank


def _answers(service, frames, top_k=2):
    futures = [service.identify_async(f, top_k=top_k) for f in frames]
    try:
        return [fu.result(300) for fu in futures]
    finally:
        service.close()


@pytest.mark.parametrize("aot_as", ["path", "pipeline"])
def test_identify_service_aot_matches_live_service(world, aot_as):
    det, rec = world["port"]
    bank = _bank(world)
    frames = list(world["frames"]) * 2
    live = _answers(IdentifyService(det.params, rec.params, bank, CFG, max_batch=B,
                                    max_faces=K, device="cpu"), frames)
    served = IdentifyService(None, None, bank, aot=world["path"] if aot_as == "path"
                             else world["pipe"], device="cpu")
    assert (served.cfg, served.max_batch, served.max_faces) == (CFG, B, K)
    got = _answers(served, frames)
    for g, w in zip(got, live):
        np.testing.assert_array_equal(g.valid, w.valid)
        np.testing.assert_allclose(g.boxes, w.boxes, atol=1e-3)
        assert g.names == w.names
        np.testing.assert_allclose(g.sims, w.sims, atol=1e-5)
    # each frame's faces find their own enrolled rows
    own = [n[0].startswith(f"f{i % B}s") for i, r in enumerate(got) for n in r.names if n]
    assert len(own) >= 2 and all(own)


@pytest.mark.parametrize("kw", [dict(fuse_search=True), dict(mesh=2),
                                dict(adaptive_embed=True), dict(valid_cap=2)],
                         ids=["fuse_search", "mesh", "adaptive_embed", "valid_cap"])
def test_identify_service_aot_exclusions(kw):
    with pytest.raises(ValueError, match="aot"):
        IdentifyService(None, None, GalleryBank(device="cpu"), aot="x.frtz", device="cpu",
                        **kw)


def test_make_server_serves_identify_from_the_bundle(world):
    det, rec = world["port"]
    bank = _bank(world)
    server = make_server(det, rec, bank, port=0, aot=world["pipe"], device="cpu")
    try:
        service = server.frt_service
        assert service.aot is world["pipe"]
        got = service.identify(world["frames"][0], top_k=1)
        want = _answers(IdentifyService(det.params, rec.params, bank, CFG, max_batch=B,
                                        max_faces=K, device="cpu"), world["frames"][:1], 1)[0]
        assert got.names == want.names
        np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-3)
    finally:
        server.server_close()
        server.frt_service.close()


@pytest.fixture(scope="module")
def cli_bundle(world, tmp_path_factory):
    """`export out.frtz` through the CLI (float32, the seeded files)."""
    out = str(tmp_path_factory.mktemp("cli") / "out.frtz")
    args = ["export", out, "--det-model", world["paths"][0], "--rec-model",
            world["paths"][1], "--rec-arch", "iresnet18", "--det-size", str(SIZE),
            "--batch", str(B), "--cpu"]
    mp = pytest.MonkeyPatch()
    auto = cli.auto_config
    mp.setattr(cli, "auto_config", lambda **kw: auto(**{"compute_dtype": "float32", **kw}))
    try:
        return out, args, cli.main(args + ["--json"])
    finally:
        mp.undo()


def test_cli_export_frtz(world, cli_bundle, capsys):
    out, _, rc = cli_bundle
    assert rc == 0
    pipe = aot.load_bundle(out, device="cpu")
    assert pipe.batch == B and pipe.config.det_input_size == SIZE
    det, rec = world["port"]  # the same files, loaded as the CLI loads them
    with torch.no_grad():
        live = frames_to_features(det.params, rec.params, torch.from_numpy(world["frames"]),
                                  pipe.config, pipe.max_faces_embed)
    _hold_to_live(pipe(world["frames"]), live, 1e-5)


def test_cli_serve_aot_answers_identify(world, cli_bundle, tmp_path):
    """serve --aot in its own process answers /identify from the bundle
    as an in-process IdentifyService on that bundle does."""
    out, _, _ = cli_bundle
    png = tmp_path / "q.png"
    png.write_bytes(png_bytes(np.ascontiguousarray(world["frames"][0][..., ::-1])))
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "facerecognizeonnx_tpu_torch", "serve", "--cpu", "--aot", out,
         "--det-model", world["paths"][0], "--rec-model", world["paths"][1], "--rec-arch",
         "iresnet18", "--det-size", str(SIZE), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO,
    )
    try:
        port, lines = None, []
        deadline = time.time() + 300
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"http://[0-9.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
            assert time.time() < deadline, "server never came up"
        assert port, "startup line not seen"
        assert any("AOT" in line for line in lines), lines
        req = urllib.request.Request(f"http://127.0.0.1:{port}/identify?top_k=1",
                                     data=png.read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            faces = json.loads(r.read())["faces"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    want = _answers(IdentifyService(None, None, GalleryBank(device="cpu"), aot=out,
                                    device="cpu"), world["frames"][:1])[0]
    assert len(faces) == int(want.valid.sum()) > 0
    np.testing.assert_allclose([f["box"] for f in faces], want.boxes[want.valid], atol=0.01)


def test_frames_shape_and_config_survive_the_bundle(world):
    """meta.json carries the config as JSON: tuples come back as tuples."""
    meta = world["pipe"].meta
    assert meta["outputs"] == list(aot.OUTPUTS) and meta["n_leaves"] == len(meta["leaves"])
    assert world["pipe"].frames_shape == (B, SIZE, SIZE, 3)
    assert dataclasses.asdict(world["pipe"].config) == dataclasses.asdict(CFG)
    assert isinstance(world["pipe"].config.strides, tuple)
