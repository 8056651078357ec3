"""Rank programs of the port's parallel tests: real `torch.distributed`
ranks over Gloo on the CPU.

A test module calls `run_ranks(tmp_dir, world, checks, inputs)` once per
world shape (from a module-scoped fixture), or `spawn_ranks` to compute
its JAX references while the ranks run. It writes `inputs` (a tree
of numpy arrays: weights as the numpy trees `bridge` takes, data) to an
`.npz`, starts `world` processes of this file, and returns each rank's
outputs: a dict {check name: tree of numpy arrays}. Each rank runs every
named check of `CHECKS` in order (all ranks in the same order: the
collectives pair up) and writes its outputs to an `.npz`.

The ranks import torch and the port only, never JAX: this file has no
JAX import and the ranks do not load `tests/conftest.py`. Each rank pins
one torch thread and meets the others through a FileStore in the run
directory (no port to race for), or with `tcp=True` through
`init_distributed` and COORDINATOR_ADDRESS on a free localhost port.
Every process group times out after 60 s, so a rank waiting on a
collective that a peer never joins fails within a minute; the parent
also kills every rank still running after `timeout` seconds (a backstop
for a hang outside the collectives, sized for a loaded CPU).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- parent side


class Spawned:
    """Ranks started by `spawn_ranks`; `result()` waits for them."""

    def __init__(self, run_dir, world, procs, timeout):
        self.run_dir, self.world, self.procs = run_dir, world, procs
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self._outs = None

    def result(self):
        """[outputs of rank r] once every rank has exited 0."""
        from facerecognizeonnx_tpu_torch.utils.checkpoint import load_params

        if self._outs is not None:
            return self._outs
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=max(1.0, self.deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            tails = [(p.communicate()[0] or "")[-2000:] for p in self.procs]
            raise AssertionError(f"ranks still running after {self.timeout} s:\n"
                                 + "\n".join(tails))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        self._outs = [load_params(os.path.join(self.run_dir, f"out{r}.npz"))
                      for r in range(self.world)]
        return self._outs


def spawn_ranks(run_dir, world: int, checks, inputs, tcp: bool = False,
                timeout: float = 180.0) -> Spawned:
    """Start `checks` on `world` Gloo ranks and return at once (a module
    computes its JAX references while they run)."""
    from facerecognizeonnx_tpu_torch.parallel.distributed import free_port
    from facerecognizeonnx_tpu_torch.utils.checkpoint import save_params

    run_dir = str(run_dir)
    os.makedirs(run_dir, exist_ok=True)
    save_params(os.path.join(run_dir, "inputs.npz"), inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    if tcp:
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}", NUM_PROCESSES=str(world))
    procs = []
    for r in range(world):
        if tcp:
            env["PROCESS_ID"] = str(r)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), run_dir,
             ",".join(checks), "tcp" if tcp else "file"],
            env=dict(env), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    return Spawned(run_dir, world, procs, timeout)


def run_ranks(run_dir, world: int, checks, inputs, tcp: bool = False, timeout: float = 180.0):
    """Run `checks` on `world` Gloo ranks; returns [outputs of rank r]."""
    return spawn_ranks(run_dir, world, checks, inputs, tcp, timeout).result()


# ---------------------------------------------------------------- rank side


def _np(t):
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _raises(fn, exc, match) -> np.ndarray:
    """1 when fn raises `exc` with `match` in its message, else 0."""
    try:
        fn()
    except exc as e:
        return np.int32(match in str(e))
    return np.int32(0)


def _cfg(**kw):
    from facerecognizeonnx_tpu_torch.config import PipelineConfig

    base = dict(det_input_size=128, compute_dtype="float32", pre_nms_topk=64, max_faces=16)
    base.update(kw)
    return PipelineConfig(**base)


def _models(inp, cfg_rec_key="rec"):
    from facerecognizeonnx_tpu_torch import bridge

    return (bridge.params_from_numpy(inp["det"], device="cpu"),
            bridge.params_from_numpy(inp[cfg_rec_key], device="cpu"))


def _blockwise(fn, frames, world):
    """The unsharded call `fn` on each rank's block of the zero-padded
    batch, joined: what a dp program computes."""
    import torch

    from facerecognizeonnx_tpu_torch.types import Detections

    padded = np.concatenate([frames, np.zeros((-len(frames) % world,) + frames.shape[1:],
                                              frames.dtype)])
    with torch.no_grad():
        parts = [fn(torch.from_numpy(b)) for b in np.split(padded, world)]
    n = len(frames)
    dets = Detections(*(torch.cat(ts)[:n] for ts in zip(*(p[0] for p in parts))))
    return (dets,) + tuple(torch.cat(ts)[:n] for ts in zip(*(p[1:] for p in parts)))


def _dets(d):
    return {"boxes": _np(d.boxes), "scores": _np(d.scores), "kps": _np(d.kps),
            "valid": _np(d.valid)}


# --- parallel: mesh, sharded search, batched embed, dp programs


def check_mesh(inp, rank, world):
    from facerecognizeonnx_tpu_torch.parallel.mesh import axis_size, make_mesh

    m2 = make_mesh(("data", "model"), (world // 2, 2) if world >= 2 else (1, 1), device="cpu")
    m1 = make_mesh(("model",), device="cpu")
    d = make_mesh(("data", "model"), device="cpu")
    return {
        "dm": np.int32([axis_size(m2, "data"), axis_size(m2, "model")]),
        "model": np.int32(axis_size(m1, "model")),
        "default": np.int32([axis_size(d, "data"), axis_size(d, "model")]),
        "bad": _raises(lambda: make_mesh(("data",), (3,), device="cpu"), ValueError,
                       "mesh shape (3,)"),
        "same": np.int32(make_mesh(("model",), device="cpu") is m1),
    }


def check_search(inp, rank, world):
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import sharded_topk_search

    out = {}
    for name, k in (("g1000", 5), ("g1003", 7), ("g3", 10)):
        s, i = sharded_topk_search(inp[f"q_{name}"], inp[name], k, device="cpu")
        out[name] = {"sims": _np(s), "idx": _np(i)}
    return out


def check_bank(inp, rank, world):
    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank

    bank = GalleryBank(device="cpu")
    feats = inp["bank"]
    bank.add_batch([f"id{i}" for i in range(len(feats))], feats)
    q = feats[7:9]
    out = {}
    for tag, sharded in (("sharded", True), ("dense", False)):
        names, sims = bank.search(q, top_k=3, sharded=sharded)
        out[tag] = {"idx": np.int32([[int(n[2:]) for n in row] for row in names]), "sims": sims}
    return out


def check_embed(inp, rank, world):
    import torch

    from facerecognizeonnx_tpu_torch.embed.pipeline import embed_crops
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import sharded_batch_embed

    cfg = _cfg()
    crops = inp["crops"]
    got = sharded_batch_embed(inp["rec"], crops, cfg, device="cpu")
    with torch.no_grad():
        from facerecognizeonnx_tpu_torch import bridge

        rec = bridge.params_from_numpy(inp["rec"], device="cpu")
        want = embed_crops(rec, torch.from_numpy(crops), cfg)
    return {"got": _np(got), "plain": _np(want)}


def check_dp(inp, rank, world):
    import torch

    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import sharded_frames_to_features
    from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features

    cfg = _cfg()
    det, rec = _models(inp)
    frames = inp["frames3"]
    dets, feats = sharded_frames_to_features(det, rec, frames, cfg, max_faces_embed=4,
                                             device="cpu")
    with torch.no_grad():
        pd, pf = frames_to_features(det, rec, torch.from_numpy(frames), cfg, 4)
    return {"got": {**_dets(dets), "feats": _np(feats)},
            "plain": {**_dets(pd), "feats": _np(pf)}}


def check_dp_w8a8(inp, rank, world):
    import torch

    from facerecognizeonnx_tpu_torch.models.quant import quantize_recognizer
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import sharded_frames_to_features
    from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features

    cfg = _cfg(rec_input_size=32)
    det, rec = _models(inp, "rec32")
    qrec = quantize_recognizer(rec, torch.from_numpy(inp["calib32"]), torch.float32,
                               min_channels=128)
    frames = inp["frames3"]
    dets, feats = sharded_frames_to_features(det, qrec, frames, cfg, max_faces_embed=4,
                                             device="cpu")
    pd, pf = _blockwise(lambda b: frames_to_features(det, qrec, b, cfg, 4), frames, world)
    return {"got": {**_dets(dets), "feats": _np(feats)},
            "plain": {**_dets(pd), "feats": _np(pf)}}


def check_dp_matches(inp, rank, world):
    import torch

    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import make_dp_program
    from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_matches

    cfg = _cfg(warp_impl="cuda")
    det, rec = _models(inp)
    program, mesh = make_dp_program(det, rec, cfg, max_faces_embed=2, search_top_k=3,
                                    device="cpu")
    frames, bank = inp["frames4"], inp["bank16"]
    dets, feats, sims, idx = program(frames, bank, 12)
    pd, pf, ps, pi = _blockwise(
        lambda b: frames_to_matches(det, rec, b, torch.from_numpy(bank), 12, cfg, 2, 3),
        frames, world)
    return {"got": {**_dets(dets), "feats": _np(feats), "sims": _np(sims), "idx": _np(idx)},
            "plain": {**_dets(pd), "feats": _np(pf), "sims": _np(ps), "idx": _np(pi)}}


# --- distributed: the tcp:// rendezvous through init_distributed


def check_dist(inp, rank, world):
    import torch
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch.embed.pipeline import embed_crops
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import (
        sharded_batch_embed,
        sharded_topk_search,
    )

    got = [torch.zeros(1) for _ in range(world)]
    dist.all_gather(got, torch.tensor([float(rank)]))  # every rank sees every rank
    g = inp["g257"]
    sims, idx = sharded_topk_search(g[:8], g, 3, mesh=make_mesh(("model",), device="cpu"))
    cfg = _cfg(rec_input_size=32)
    feats = sharded_batch_embed(inp["rec32"], inp["crops32"], cfg,
                                mesh=make_mesh(("data",), device="cpu"))
    from facerecognizeonnx_tpu_torch import bridge

    with torch.no_grad():
        plain = embed_crops(bridge.params_from_numpy(inp["rec32"], device="cpu"),
                            torch.from_numpy(inp["crops32"]), cfg)
    return {"ranks": _np(torch.cat(got)), "backend": np.int32(dist.get_backend() == "gloo"),
            "sims": _np(sims), "idx": _np(idx), "feats": _np(feats), "plain": _np(plain)}


# --- tensor parallel


def check_tp(inp, rank, world):
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh
    from facerecognizeonnx_tpu_torch.parallel.tensor_parallel import tp_embed_crops

    cfg = _cfg()
    crops = inp["crops5"]
    tp2 = make_mesh(("model",), (2,), ranks=[0, 1], device="cpu")
    tp4 = make_mesh(("model",), (4,), device="cpu")
    dxt = make_mesh(("data", "model"), (2, 2), device="cpu")
    return {
        "r18_folded_tp2": _np(tp_embed_crops(inp["r18_folded"], crops, cfg, mesh=tp2)),
        "r18_tp4": _np(tp_embed_crops(inp["r18"], crops, cfg, mesh=tp4)),
        "r18_dpxtp": _np(tp_embed_crops(inp["r18"], crops, cfg, mesh=dxt)),
        "vit_tp2": _np(tp_embed_crops(inp["vit"], crops, cfg, mesh=tp2)),
        "vit_folded_dpxtp": _np(tp_embed_crops(inp["vit_folded"], crops, cfg, mesh=dxt)),
        "vit_heads": _raises(lambda: tp_embed_crops(inp["vit"], crops, cfg, mesh=tp4),
                             ValueError, "heads"),
    }


# --- pipeline parallel


def check_pp(inp, rank, world):
    import torch

    from facerecognizeonnx_tpu_torch.models.quant import quantize_recognizer
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh
    from facerecognizeonnx_tpu_torch.parallel.pipeline_stage import (
        pipelined_frames_to_features,
    )
    from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features

    cfg = _cfg()
    det, rec = _models(inp)
    frames = inp["frames4"]
    stage = make_mesh(("stage",), (2,), ranks=[0, 1], device="cpu")
    dxp = make_mesh(("data", "stage"), (2, 2), device="cpu")
    sxm = make_mesh(("stage", "model"), (2, 2), device="cpu")
    out = {}
    for name, mesh, n_micro, b in (("stage", stage, 2, 4), ("dp_pp", dxp, 2, 4),
                                   ("micro4_b3", stage, 4, 3), ("pp_tp", sxm, 2, 4)):
        dets, feats = pipelined_frames_to_features(
            det, inp["rec"] if name == "pp_tp" else rec, frames[:b], cfg, mesh=mesh,
            max_faces_embed=4, n_micro=n_micro,
        )
        out[name] = {**_dets(dets), "feats": _np(feats)}
    with torch.no_grad():
        pd, pf = frames_to_features(det, rec, torch.from_numpy(frames), cfg, 4)
    out["plain"] = {**_dets(pd), "feats": _np(pf)}
    qrec = quantize_recognizer(rec, torch.from_numpy(inp["calib"]), torch.float32,
                               min_channels=128)
    out["quant_tp"] = _raises(
        lambda: pipelined_frames_to_features(det, qrec, frames, cfg, mesh=sxm),
        ValueError, "plain native param")
    out["bad_stage"] = _raises(
        lambda: pipelined_frames_to_features(
            det, rec, frames, cfg, mesh=make_mesh(("stage",), (4,), device="cpu")),
        ValueError, "stage")
    return out


# --- expert parallel


def check_ep(inp, rank, world):
    import torch

    from facerecognizeonnx_tpu_torch import bridge
    from facerecognizeonnx_tpu_torch.embed.pipeline import embed_crops
    from facerecognizeonnx_tpu_torch.parallel.expert_parallel import ep_embed_crops
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh

    cfg = _cfg(rec_input_size=32)
    experts = list(inp["experts"])
    crops = inp["crops8"]
    ex4 = make_mesh(("expert",), (4,), device="cpu")
    ex2 = make_mesh(("expert",), (2,), ranks=[0, 1], device="cpu")
    ex1 = make_mesh(("expert",), (1,), ranks=[0], device="cpu")
    dxe = make_mesh(("data", "expert"), (2, 2), device="cpu")
    cases = {
        "one_per_shard": (experts, [0, 1, 2, 3, 3, 2, 1, 0], crops, dict(mesh=ex4,
                          capacity_factor=2.0)),
        "two_per_shard": (experts, [3, 3, 0, 1, 2, 0, 1, 2], crops, dict(mesh=ex2,
                          capacity_factor=2.0)),
        "single_rank": (experts, [2, 0, 1, 3, 0, 0, 3, 1], crops, dict(mesh=ex1,
                        capacity_factor=1.5)),
        "dp_x_ep": (experts[:2], [0, 1, 1, 0, 1, 0, 0, 1], crops, dict(
            mesh=dxe, data_axis="data", capacity_factor=2.0)),
        "drop": (experts, [0] * 8, crops, dict(mesh=ex4, capacity_factor=1.0,
                                                overflow="drop")),
        "rerun": (experts, [0] * 8, crops, dict(mesh=ex4, capacity_factor=1.0)),
        "rerun_invalid": (experts[:2], [0, -1, 1, 1, 1, 99, 1, 1], crops, dict(
            mesh=ex2, capacity_factor=1.0)),
        "invalid": (experts[:2], [0, -1, 7, 1, 0, 99, 1, -3], crops, dict(
            mesh=ex2, capacity_factor=4.0)),
        "odd_batch": (experts, [1, 2, 0], crops[:3], dict(mesh=ex4, capacity_factor=4.0)),
        "default_mesh": (experts[:2], [0, 1, 1, 0, 1, 0, 0, 1], crops, dict(device="cpu")),
    }
    out = {}
    for name, (ex, ids, c, kw) in cases.items():
        feats, routed = ep_embed_crops(ex, np.asarray(ids), c, cfg, **kw)
        out[name] = {"feats": feats, "routed": routed}
    # each expert alone on every crop: the port's unsharded call
    with torch.no_grad():
        out["alone"] = np.stack([
            _np(embed_crops(bridge.params_from_numpy(t, device="cpu"),
                            torch.from_numpy(crops), cfg)) for t in experts])
    out["bogus"] = _raises(lambda: ep_embed_crops(experts[:2], np.zeros(8), crops, cfg,
                                                  mesh=ex2, overflow="bogus"),
                           ValueError, "overflow")
    out["data_axis"] = _raises(lambda: ep_embed_crops(experts[:2], np.zeros(8), crops, cfg,
                                                      data_axis="data", device="cpu"),
                               ValueError, "data_axis")
    return out


def check_enroll_experts(inp, rank, world):
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh
    from facerecognizeonnx_tpu_torch.pipeline.api import FaceDetector
    from facerecognizeonnx_tpu_torch.pipeline.enroll import enroll_batch

    cfg = _cfg(rec_input_size=32, rec_arch="iresnet18")
    detector = FaceDetector(cfg, device="cpu")
    assert detector.load_model(inp["det_path"].item())
    images = list(inp["images"])
    names = [f"p{i}" for i in range(len(images))]
    experts = list(inp["experts"][:2])
    mesh = make_mesh(("expert",), (2,), ranks=[0, 1], device="cpu")
    bank, enrolled = enroll_batch(detector, None, names, images, cfg=cfg, mesh=mesh,
                                  experts=experts, device="cpu")
    return {"enrolled": np.int32([int(n[1:]) for n in enrolled]), "feats": bank.features}


# --- the service: one worker thread issues every collective


def check_service(inp, rank, world):
    """IdentifyService(sharded=True, mesh=world) on every rank, the same
    requests (and then requests with bank updates between them) in the
    same order, but each rank's caller paced differently so the ranks'
    queues fill at other times; against the plain service."""
    import time

    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
    from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService

    cfg = _cfg()
    det, rec = _models(inp)
    bank = GalleryBank(device="cpu")
    bank.add_batch([f"id{i}" for i in range(len(inp["bank"]))], inp["bank"])
    images = list(inp["images"])
    out = {}
    for tag, kw in (("ours", dict(sharded=True, mesh=world)), ("plain", {})):
        svc = IdentifyService(det, rec, bank, cfg, max_batch=2, batch_window_ms=20.0,
                              max_faces=4, device="cpu", **kw)
        futures = []
        for i, im in enumerate(images):
            futures.append(svc.identify_async(im, top_k=3))
            if tag == "ours":
                time.sleep(0.03 * ((i + rank) % 3))  # rank-dependent pacing
        res = [f.result(timeout=60) for f in futures]
        svc.close()
        out[tag] = {
            "valid": np.stack([r.valid for r in res]),
            "sims": np.stack([r.sims for r in res]),
            "names": np.int32([[[int(n[2:]) for n in row] + [-1] * (3 - len(row))
                                for row in r.names] for r in res]),
            "batches": np.int32(svc.stats()["batches"]),
        }
    # bank updates between the requests: submitted without waiting (rank-
    # dependent pacing) to the mesh service, one call at a time to the
    # plain one. Every answer lists the whole bank (top_k > its rows), so
    # each shows which updates came before it.
    extra = np.random.default_rng(3).normal(size=(2, 512)).astype(np.float32)
    steps = [("id", 0), ("add", "id90", 0), ("id", 1), ("id", 0), ("remove", "id3"),
             ("id", 2), ("add", "id91", 1), ("remove", "id90"), ("id", 1), ("id", 2)]
    top_k = 25
    for tag, kw in (("ours_updates", dict(sharded=True, mesh=world)), ("plain_updates", {})):
        ubank = GalleryBank(device="cpu")
        ubank.add_batch([f"id{i}" for i in range(len(inp["bank"]))], inp["bank"])
        svc = IdentifyService(det, rec, ubank, cfg, max_batch=2, batch_window_ms=20.0,
                              max_faces=4, device="cpu", **kw)
        futures = []
        for i, (op, *arg) in enumerate(steps):
            if op == "id":
                fut = svc.identify_async(images[arg[0]], top_k=top_k)
                futures.append(fut)
            elif op == "add":
                fut = svc.update_bank("add", arg[0], extra[arg[1]])
            else:
                fut = svc.update_bank("remove", arg[0])
            if tag == "ours_updates":
                time.sleep(0.03 * ((i + rank) % 3))
            else:
                fut.result(timeout=60)
        res = [f.result(timeout=60) for f in futures]
        svc.close()
        out[tag] = {
            "valid": np.stack([r.valid for r in res]),
            "sims": np.stack([r.sims for r in res]),
            "names": np.int32([[[int(n[2:]) for n in row] + [-1] * (top_k - len(row))
                                for row in r.names] for r in res]),
        }
    return out


# --- training: the partial-FC ArcFace step over data × model meshes


def check_train(inp, rank, world):
    """One SGD step from each JAX state in `inp` ("s0".."s2") on each mesh
    shape (every rank in each), and a checkpoint round trip on the last
    mesh: each rank returns its losses, backbone trees, classifier blocks
    and traces after each step."""
    import collections
    import tempfile

    import torch

    from facerecognizeonnx_tpu_torch import bridge
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh
    from facerecognizeonnx_tpu_torch.train.trainer import make_train_step
    from facerecognizeonnx_tpu_torch.utils.checkpoint import load_train_state, save_train_state

    cfg = _cfg(rec_input_size=32)
    trace_state = collections.namedtuple("TraceState", "trace")

    def from_jax(s, mesh):
        return bridge.train_state_from_numpy(
            s["params"], s["classifier"], (trace_state((s["trace"], s["trace_cls"])), ()),
            s["step"], mesh=mesh)

    out = {}
    for name, shape in (("dp", (world, 1)), ("mp", (1, world)), ("dxm", (2, world // 2))):
        mesh = make_mesh(("data", "model"), shape, device="cpu")
        step = make_train_step(mesh, cfg, lr=float(inp["lr"]))
        out[name] = {}
        for k in range(3):
            state, loss = step(from_jax(inp[f"s{k}"], mesh), inp["images"], inp["labels"])
            out[name][f"s{k}"] = {
                "loss": np.float32(loss),
                "params": bridge.tree_from_module(state.model),
                "classifier": _np(state.classifier),
                "trace": bridge.tree_from_tensors(state.model, state.opt_state["trace"]),
                "trace_cls": _np(state.opt_state["trace"]["classifier"]),
                "step": _np(state.step),
            }
    # one directory for all ranks: rank 0 makes it, the others read its name
    obj = [tempfile.mkdtemp() if rank == 0 else None]
    torch.distributed.broadcast_object_list(obj, src=0)
    path = os.path.join(obj[0], "state.ckpt")
    save_train_state(path, state, mesh=mesh)
    back = load_train_state(path, from_jax(inp["s0"], mesh), mesh=mesh)

    def leaves(s):
        return (list(s.model.state_dict().values()) + [s.classifier, s.step]
                + list(s.opt_state["trace"].values()))

    out["ckpt_equal"] = np.int32(all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                                       leaves(state))))
    return out


CHECKS = {
    "mesh": check_mesh,
    "search": check_search,
    "bank": check_bank,
    "embed": check_embed,
    "dp": check_dp,
    "dp_w8a8": check_dp_w8a8,
    "dp_matches": check_dp_matches,
    "dist": check_dist,
    "tp": check_tp,
    "pp": check_pp,
    "ep": check_ep,
    "enroll_experts": check_enroll_experts,
    "service": check_service,
    "train": check_train,
}


def _rank_main(rank: int, world: int, run_dir: str, checks, mode: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch.parallel.distributed import GROUP_TIMEOUT, init_distributed
    from facerecognizeonnx_tpu_torch.utils.checkpoint import load_params, save_params

    torch.set_num_threads(1)
    if mode == "tcp":
        init_distributed(device="cpu")  # COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
    else:
        store = dist.FileStore(os.path.join(run_dir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=GROUP_TIMEOUT)
    assert dist.get_world_size() == world and dist.get_rank() == rank
    inputs = load_params(os.path.join(run_dir, "inputs.npz"))
    out = {name: CHECKS[name](inputs, rank, world) for name in checks}
    save_params(os.path.join(run_dir, f"out{rank}.npz"), out)
    dist.destroy_process_group()
    print(f"OK rank={rank} world={world}")


def cli_command(argv) -> list:
    """The port's CLI run by this file (`_cli_main`): float32, one torch
    thread."""
    return [sys.executable, os.path.abspath(__file__), "cli", *argv]


def cli_env(**launcher) -> dict:
    """The environment of a `cli_command` process, with the launcher's
    variables (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) given."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    for key in ("XLA_FLAGS", "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(key, None)
    env.update({k: str(v) for k, v in launcher.items()})
    return env


def _cli_main(argv) -> int:
    """The CLI with auto_config wrapped to float32 (as tests/test_torch_cli.py
    wraps it in process)."""
    sys.path.insert(0, REPO)
    import torch

    from facerecognizeonnx_tpu_torch.cli import main as cli

    torch.set_num_threads(1)
    auto = cli.auto_config
    cli.auto_config = lambda **kw: auto(**{"compute_dtype": "float32", **kw})
    return cli.main(argv)


if __name__ == "__main__" and sys.argv[1] == "cli":
    sys.exit(_cli_main(sys.argv[2:]))
elif __name__ == "__main__":
    try:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                   sys.argv[4].split(","), sys.argv[5])
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # never wait on peers that may hang
