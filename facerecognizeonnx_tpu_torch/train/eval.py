"""Verification-protocol evaluation (LFW-style) for embedding models,
and detection AP.

The port's own copy of `facerecognizeonnx_tpu/train/eval.py` (numpy
only): k-fold cross-validated verification accuracy with the threshold
selected on held-out folds, TAR@FAR operating points, and WIDER-style
AP@IoU for face detection. Similarities use the framework's (cos+1)/2
scale (reference src/face_recognizer.cpp:333), so thresholds here are
directly comparable to the CLI/API match threshold.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def pair_similarities(feats1: np.ndarray, feats2: np.ndarray) -> np.ndarray:
    """(N, D) x (N, D) L2-normalized embeddings → (N,) similarities on
    the (cos+1)/2 scale."""
    f1 = np.asarray(feats1, np.float32)
    f2 = np.asarray(feats2, np.float32)
    return ((f1 * f2).sum(axis=-1) + 1.0) / 2.0


def _accuracy(sims: np.ndarray, same: np.ndarray, thr: float) -> float:
    pred = sims > thr
    return float((pred == same).mean())


def verification_accuracy(
    sims: Sequence[float],
    same: Sequence[bool],
    n_folds: int = 10,
    thresholds: np.ndarray | None = None,
) -> Dict[str, float]:
    """K-fold cross-validated verification accuracy.

    For each fold: pick the threshold maximizing accuracy on the OTHER
    folds, score it on this fold — the threshold is never tuned on the
    data it is scored on (standard LFW protocol).

    Returns {"accuracy", "accuracy_std", "best_threshold"} — the
    threshold is the mean of the per-fold selections, usable directly
    as a `match_threshold` config value.
    """
    sims = np.asarray(sims, np.float32)
    same = np.asarray(same, bool)
    assert sims.shape == same.shape and sims.ndim == 1
    n = sims.shape[0]
    assert n >= n_folds, f"need >= {n_folds} pairs, have {n}"
    if thresholds is None:
        thresholds = np.arange(0.0, 1.0001, 0.0025, dtype=np.float32)

    folds = np.array_split(np.arange(n), n_folds)
    accs, thrs = [], []
    for fold in folds:
        test_mask = np.zeros(n, bool)
        test_mask[fold] = True
        train_s, train_y = sims[~test_mask], same[~test_mask]
        fold_accs = [(thr, _accuracy(train_s, train_y, thr)) for thr in thresholds]
        best_thr = max(fold_accs, key=lambda t: t[1])[0]
        accs.append(_accuracy(sims[test_mask], same[test_mask], best_thr))
        thrs.append(best_thr)
    return {
        "accuracy": float(np.mean(accs)),
        "accuracy_std": float(np.std(accs)),
        "best_threshold": float(np.mean(thrs)),
    }


def tar_at_far(
    sims: Sequence[float], same: Sequence[bool], far: float = 1e-3
) -> Dict[str, float]:
    """True-accept rate at a fixed false-accept rate.

    The threshold is the (1-far) quantile of the IMPOSTOR similarity
    distribution; TAR is the fraction of genuine pairs above it.
    """
    sims = np.asarray(sims, np.float32)
    same = np.asarray(same, bool)
    neg = np.sort(sims[~same])
    pos = sims[same]
    assert neg.size > 0 and pos.size > 0, "need both genuine and impostor pairs"
    # Exactly m = floor(far*n) impostors must sit STRICTLY above the
    # threshold, so pick the (n-1-m)-th sorted impostor. The previous
    # floor((1-far)*n) form was still off by one whenever far*n was an
    # integer (it reduces to n - far*n, i.e. the MAX impostor at
    # far=1e-3, n=1000 — admitting 0 instead of 1); indexing from m
    # directly is correct for both the integer and fractional cases.
    m = min(neg.size - 1, int(np.floor(far * neg.size)))
    k = neg.size - 1 - m
    thr = float(neg[k])
    return {
        "tar": float((pos > thr).mean()),
        "far": far,
        "threshold": thr,
    }


def evaluate_pairs(
    embed_fn,
    images1: np.ndarray,
    images2: np.ndarray,
    same: Sequence[bool],
    n_folds: int = 10,
) -> Dict[str, float]:
    """End-to-end: embed both sides with `embed_fn((N, S, S, 3) uint8
    BGR crops) -> (N, D) L2-normalized feats`, then run the protocol."""
    f1 = np.asarray(embed_fn(np.asarray(images1)))
    f2 = np.asarray(embed_fn(np.asarray(images2)))
    sims = pair_similarities(f1, f2)
    out = verification_accuracy(sims, same, n_folds=n_folds)
    out.update({f"tar_at_far_{far:g}": tar_at_far(sims, same, far)["tar"]
                for far in (1e-2, 1e-3)})
    return out


# ------------------------------------------- detection evaluation (mAP)


def box_iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy boxes → (N, M) IoU (float, area-normalized).

    Float IoU — the DETECTION-QUALITY metric; the device NMS's
    integer-truncated IoU mode exists only to reproduce reference
    survivor sets (reference src/face_detector.cpp:340-354), not for
    scoring.
    """
    a = np.asarray(boxes_a, np.float32)[:, None, :]  # (N, 1, 4)
    b = np.asarray(boxes_b, np.float32)[None, :, :]  # (1, M, 4)
    ix = np.maximum(
        0.0, np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])
    )
    iy = np.maximum(
        0.0, np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])
    )
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = np.maximum(area_a + area_b - inter, 1e-12)
    return inter / union


def detection_average_precision(
    detections: Sequence[Dict],
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """WIDER-style AP@IoU for face detection over a set of images.

    detections: per image, {"boxes": (N, 4) xyxy predicted,
    "scores": (N,), "gt": (M, 4) xyxy ground truth}. Greedy one-to-one
    matching in global score order (the standard VOC/WIDER protocol:
    each GT matches at most one prediction; duplicates are false
    positives). Returns AP (area under the interpolated PR curve),
    precision/recall at the end of the sweep, and counts.

    """
    rows = []  # (score, is_tp) in global score order
    n_gt = 0
    for img in detections:
        boxes = np.asarray(img["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(img["scores"], np.float32).reshape(-1)
        gt = np.asarray(img["gt"], np.float32).reshape(-1, 4)
        n_gt += len(gt)
        order = np.argsort(-scores)
        taken = np.zeros(len(gt), bool)
        iou = box_iou_matrix(boxes, gt) if len(boxes) and len(gt) else None
        for i in order:
            tp = False
            if iou is not None:
                cand = np.where(~taken, iou[i], -1.0)
                j = int(cand.argmax()) if len(cand) else -1
                if j >= 0 and cand[j] >= iou_threshold:
                    taken[j] = True
                    tp = True
            rows.append((float(scores[i]), tp))
    if not rows or n_gt == 0:
        return {"ap": 0.0, "precision": 0.0, "recall": 0.0, "n_gt": n_gt,
                "n_det": len(rows)}
    rows.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in rows])
    fps = np.cumsum([not r[1] for r in rows])
    recall = tps / n_gt
    precision = tps / np.maximum(tps + fps, 1)
    # VOC-style interpolation: precision envelope, integrate over recall
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    r_prev = 0.0
    ap = 0.0
    for r, p in zip(recall, prec_env):
        ap += (r - r_prev) * p
        r_prev = r
    return {
        "ap": float(ap),
        "precision": float(precision[-1]),
        "recall": float(recall[-1]),
        "n_gt": int(n_gt),
        "n_det": len(rows),
    }
