"""The plain reference runs at tiny sizes and its parts match textbook
versions: sequential greedy NMS, a warp at integer positions, rounding."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import identify as ri
from benchmark.reference import nets, warp


def _greedy_loop(boxes, valid, thr):
    """Textbook greedy NMS over score-sorted boxes, one box at a time."""
    b = np.trunc(boxes)
    x1, y1 = b[:, 0], b[:, 1]
    x2 = x1 + np.trunc(boxes[:, 2] - boxes[:, 0])
    y2 = y1 + np.trunc(boxes[:, 3] - boxes[:, 1])
    keep = []
    for i in range(len(boxes)):
        if not valid[i]:
            keep.append(False)
            continue
        ok = True
        for j in range(i):
            if not keep[j]:
                continue
            iw = max(min(x2[i], x2[j]) - max(x1[i], x1[j]), 0.0)
            ih = max(min(y2[i], y2[j]) - max(y1[i], y1[j]), 0.0)
            inter = iw * ih
            union = (x2[i] - x1[i]) * (y2[i] - y1[i]) + (x2[j] - x1[j]) * (y2[j] - y1[j]) - inter
            if inter / max(union, 1e-12) > thr:
                ok = False
                break
        keep.append(ok)
    return np.array(keep)


def test_greedy_nms_equals_the_sequential_loop():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 60, (3, 40, 2)).astype(np.float32)
    wh = rng.uniform(5, 30, (3, 40, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    valid = rng.uniform(size=(3, 40)) < 0.9
    got = ri.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(valid), 0.4).numpy()
    for f in range(3):
        assert (got[f] == _greedy_loop(boxes[f], valid[f], 0.4)).all()


def test_pyramid_levels_are_rounded_two_by_two_means():
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))
    lv = warp.pyramid(frames)
    f = frames[0].double().numpy()
    l1 = (f[0::2, 0::2] + f[1::2, 0::2] + f[0::2, 1::2] + f[1::2, 1::2]) / 4
    assert np.array_equal(lv[1][0].permute(1, 2, 0).numpy(), np.round(l1))
    assert [t.shape[-1] for t in lv] == [64, 32, 16, 8]


def test_level_choice_follows_the_face_size():
    # dst = s * src: the inverse spans 111 / s + 2 source px per 112 output px
    for s, level in ((1.0 / 0.9, 0), (0.9, 1), (0.25, 3)):
        Ms = torch.tensor([[[[s, 0.0, 0.0], [0.0, s, 0.0]]]])
        assert int(warp.face_table(Ms)[0, 0]) == level, s


def test_warp_of_a_flat_frame_is_flat_and_empty_slots_are_zero():
    frames = torch.full((1, 300, 300, 3), 200, dtype=torch.uint8)
    Ms = torch.tensor([[[[0.8, 0.1, -60.0], [-0.1, 0.8, -50.0]]] * 2]).reshape(1, 2, 2, 3)
    crops = warp.warp_xm(frames, Ms, torch.tensor([[True, False]]))
    # the y hat weights are rounded to bfloat16, so they sum to 1 within 2^-8
    want = torch.full_like(crops[0, 0], (200 - 127.5) / 128.0).float()
    assert (crops[0, 0].float() - want).abs().max() <= 200 * 2.0 ** -8 / 128 + 2.0 ** -8
    assert not crops[0, 1].any()


def test_float8_rounds_coarser_than_bfloat16():
    x = torch.randn(1000)
    e16 = (nets.BF16.operand(x) - x).abs().max()
    e8 = (nets.FP8.operand(x) - x).abs().max()
    assert 0 < e16 < e8


def test_the_two_halves_run_at_a_tiny_size(tiny):
    from benchmark import weights

    cell = tiny("sc_dense8")
    cfg = dict(cell["config"], top_k=3)
    det = cfg["detector"]
    det_tree = weights.scrfd_tree(det, 1, "cpu")
    rec_tree = weights.recognizer_tree(cfg["recognizer"], 2, "cpu")
    frames = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8)
    d = ri.detect_slots(frames, det_tree, det["plan"], cfg, nets.BF16)
    assert d["boxes"].shape == (2, 8, 4) and d["kps"].shape == (2, 8, 5, 2)
    s = ri.serve(frames, d["kps"], d["boxes"], torch.ones(2, 8, dtype=torch.bool), rec_tree,
                 "iresnet", None, torch.randn(50, 512), 3, nets.BF16)
    assert s["feats"].shape == (2, 8, 512) and s["idx"].shape == (2, 8, 3)
    n = torch.linalg.vector_norm(s["feats"], dim=-1)
    assert torch.allclose(n, torch.ones_like(n), atol=1e-5)
