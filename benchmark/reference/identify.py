"""The frame → identity path in plain torch, in two halves: `detect_slots`
(normalize, SCRFD, anchor decode, score threshold, top-k, greedy NMS on
integer-truncated rects, compaction, the first K slots) and `serve`
(align + warp at given landmarks, the recognizer, L2 norm, the 1:N
top-k over the unpadded gallery).

Every step follows the published insightface semantics that the
configuration names (SCRFD anchor-free decode, strict `score >
threshold`, IoU > threshold suppresses, ties in index order), with the
rounding points of `nets.py`. It imports nothing of the program under
test and takes only what the benchmark made: frames, param trees, the
gallery rows.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import nets, warp


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """BGR uint8 → RGB (px - 127.5) / 128, rounded to bfloat16."""
    return ((frames_u8.flip(-1).to(torch.float32) - 127.5) * (1.0 / 128.0)).to(torch.bfloat16)


def decode(outs: Dict, size: int):
    scores, boxes, kps = [], [], []
    for stride in sorted(outs):
        s, bb, kk = outs[stride]
        hw = size // stride
        ys, xs = torch.meshgrid(torch.arange(hw), torch.arange(hw), indexing="ij")
        c = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32) * stride
        c = c.repeat_interleave(nets.NUM_ANCHORS, 0).to(s.device)
        d = bb * stride
        scores.append(s[..., 0])
        boxes.append(torch.stack([c[:, 0] - d[..., 0], c[:, 1] - d[..., 1],
                                  c[:, 0] + d[..., 2], c[:, 1] + d[..., 3]], -1))
        k = kk * stride
        kps.append(k.reshape(*k.shape[:-1], 5, 2) + c[:, None, :])
    return torch.cat(scores, -1), torch.cat(boxes, -2), torch.cat(kps, -3)


def _sorted_desc(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _rows(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def greedy_nms(boxes, valid, thr: float):
    """Score-sorted (B, N, 4) boxes → keep (B, N): a box survives unless a
    kept box ranked above it overlaps it by IoU > thr, IoU taken on
    (int)x1, (int)y1, (int)(x2 - x1), (int)(y2 - y1) rects."""
    x1, y1 = torch.trunc(boxes[..., 0]), torch.trunc(boxes[..., 1])
    x2 = x1 + torch.trunc(boxes[..., 2] - boxes[..., 0])
    y2 = y1 + torch.trunc(boxes[..., 3] - boxes[..., 1])
    iw = torch.clamp_min(torch.minimum(x2[..., :, None], x2[..., None, :])
                         - torch.maximum(x1[..., :, None], x1[..., None, :]), 0.0)
    ih = torch.clamp_min(torch.minimum(y2[..., :, None], y2[..., None, :])
                         - torch.maximum(y1[..., :, None], y1[..., None, :]), 0.0)
    inter = iw * ih
    area = (x2 - x1) * (y2 - y1)
    iou = inter / torch.clamp_min(area[..., :, None] + area[..., None, :] - inter, 1e-12)
    above = torch.triu(iou > thr, diagonal=1)  # [j, i]: j ranks above i and overlaps
    keep = valid
    while True:  # the greedy order's unique fixpoint
        nxt = valid & ~(above & keep[:, :, None]).any(dim=1)
        if torch.equal(nxt, keep):
            return keep
        keep = nxt


def detect(frames_u8, det_tree, det_plan, cfg: Dict, prec):
    """→ (boxes (B, M, 4), scores (B, M), kps (B, M, 5, 2), valid (B, M))
    with M = cfg["max_faces"] slots, survivors first in score order."""
    outs = nets.scrfd(det_tree, normalize(frames_u8), prec, det_plan, frames_u8.device)
    scores, boxes, kps = decode(outs, frames_u8.shape[1])
    thr = cfg["score_threshold"]
    ranked = torch.where(scores > thr, scores, torch.full_like(scores, -1.0))
    top_s, idx = _sorted_desc(ranked, cfg["pre_nms_topk"])
    top_b, top_k = _rows(boxes, idx), _rows(kps, idx)
    valid = top_s > thr
    keep = greedy_nms(top_b, valid, cfg["nms_threshold"])
    top_s = torch.where(valid, top_s, torch.full_like(top_s, float("-inf")))
    sel = torch.argsort((~keep).to(torch.int32), dim=-1, stable=True)[:, : cfg["max_faces"]]
    v = _rows(keep, sel)
    zero = torch.zeros((), device=frames_u8.device)
    return (torch.where(v[..., None], _rows(top_b, sel), zero),
            torch.where(v, _rows(top_s, sel), zero),
            torch.where(v[..., None, None], _rows(top_k, sel), zero), v)


def embed(rec_tree, rec_kind: str, rec_plan, crops, prec):
    """(N, 112, 112, 3) bf16 crops → (N, 512) L2-normalized float32."""
    dev = crops.device
    if rec_kind == "iresnet":
        f = nets.iresnet(rec_tree, crops, prec, dev)
    else:
        f = nets.mobilefacenet(rec_tree, crops, prec, rec_plan, dev)
    n = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    return torch.where(n > 0, f / torch.clamp_min(n, 1e-20), f)


def detect_slots(frames_u8, det_tree, det_plan, cfg: Dict, det_prec):
    """The detect half for one block of frames: the first K slots'
    boxes, scores, kps and detection mask. `det_prec` rounds the
    detector's operands (`nets.Precision`)."""
    K = cfg["faces_per_frame"]
    boxes, scores, kps, valid = detect(frames_u8, det_tree, det_plan, cfg, det_prec)
    return {"boxes": boxes[:, :K], "scores": scores[:, :K], "kps": kps[:, :K],
            "det_valid": valid[:, :K]}


def serve(frames_u8, kps, boxes, valid, rec_tree, rec_kind, rec_plan, gallery, top_k: int,
          rec_prec):
    """The serve half for one block of frames at the given slots' landmarks
    and boxes (B, K, 5, 2) / (B, K, 4): align, warp, embed the `valid`
    slots (others zero), and the top-k over the unpadded gallery (G, 512),
    the benchmark's unnormalized draw. Returns features, top-k sims on
    the (cos + 1) / 2 scale, their rows, and every row's sim."""
    B, H, W = frames_u8.shape[:3]
    K = kps.shape[1]
    Ms = warp.align_matrices(kps, boxes, H, W)
    crops = warp.warp_xm(frames_u8, Ms, valid)
    feats = embed(rec_tree, rec_kind, rec_plan, crops.reshape(B * K, 112, 112, 3), rec_prec)
    feats = feats.reshape(B, K, -1) * valid[..., None].to(torch.float32)
    g = gallery.to(torch.float32)
    gn = torch.linalg.vector_norm(g, dim=1, keepdim=True)
    g = torch.where(gn > 0, g / torch.clamp_min(gn, 1e-20), g)
    sims = (feats.reshape(B * K, -1) @ g.t() + 1.0) * 0.5
    v, i = _sorted_desc(sims, top_k)
    return {"feats": feats, "sims": v.reshape(B, K, top_k), "idx": i.reshape(B, K, top_k),
            "sim_rows": sims.reshape(B, K, -1)}
