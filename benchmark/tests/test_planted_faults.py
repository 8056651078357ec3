"""A run whose timed path is broken underneath must come out not
correct: an answer altered where the program produces it (the rows of
the gallery top-k, the features, the detections), through each drive.
The harness's look for a chip is skipped by running on the CPU, where
the program takes its kernels' plain versions."""

from __future__ import annotations

import pytest
import torch

from benchmark import run as bench


def _rows_shifted(topk):
    def f(x, k):
        v, i = topk(x, k)
        return v, (i + 1) % x.shape[-1]
    return f


def _features_rolled(embed):
    def f(*a, **kw):
        return torch.roll(embed(*a, **kw), 1, dims=-1)
    return f


def _landmarks_moved(post):
    """A bias under the old 4 px pairing tolerance: every landmark one
    pixel to the right."""
    def f(*a, **kw):
        d = post(*a, **kw)
        return d._replace(kps=d.kps + torch.tensor([1.0, 0.0]))
    return f


def _one_slot_dropped(post):
    """A fault confined to one frame: its best detection suppressed."""
    def f(*a, **kw):
        d = post(*a, **kw)
        valid = d.valid.clone()
        valid[0, 0] = False
        return d._replace(valid=valid)
    return f


def _boxes_moved(post):
    def f(*a, **kw):
        d = post(*a, **kw)
        return d._replace(boxes=d.boxes + 8.0 * d.valid[..., None], kps=d.kps + 8.0)
    return f


@pytest.mark.parametrize("name, module", [
    ("sc_dense8", "facerecognizeonnx_tpu_torch.pipeline.fused"),
    ("sc_adaptive2", "facerecognizeonnx_tpu_torch.pipeline.bucketed"),
])
@pytest.mark.parametrize("fault", ["rows", "features", "detections", "landmarks", "one_slot"])
def test_planted_fault_is_not_correct(name, module, fault, tiny, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    fused = importlib.import_module("facerecognizeonnx_tpu_torch.pipeline.fused")
    if fault == "rows":
        monkeypatch.setattr(mod, "topk_stable", _rows_shifted(mod.topk_stable))
    elif fault == "features":
        monkeypatch.setattr(mod, "embed_crops", _features_rolled(mod.embed_crops))
    else:
        plant = {"detections": _boxes_moved, "landmarks": _landmarks_moved,
                 "one_slot": _one_slot_dropped}[fault]
        monkeypatch.setattr(fused, "postprocess", plant(fused.postprocess))
    res = bench.run(name, 23, 0.5, False, device="cpu", cell=tiny(name))
    assert res["correct"] is False, res["checks"]
