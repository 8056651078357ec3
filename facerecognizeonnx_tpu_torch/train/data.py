"""Identity-folder dataset for ArcFace fine-tuning.

Port of `facerecognizeonnx_tpu/train/data.py`. Layout: root/<identity_
name>/*.jpg — the standard face-recognition training layout. Images are
detected and aligned once through the inference pipeline (the same
5-point warp the embedder sees at serving time: on the card, the NMS
kernel and the x-major warp kernel), cached as uint8 crops, and served
as shuffled (images, labels) batches normalized to [-1, 1] RGB. The
listing, labels, batches and augmentation are the JAX package's, numpy
call for numpy call.

On a mesh every rank draws the same global batches, so every rank needs
the same crop cache. `load_crops(mesh)` fills it before training: the
ranks of the "data" axis split the images, each crops its share on its
own card, and the crops are all-gathered in rounds of at most
`CROP_ROUND_S` seconds of cropping each, so no rank waits in a
collective much longer than that while another crops (the groups time
out after 60 s). Splitting, rather than every rank cropping the whole
folder, divides the cropping time by the number of ranks.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

CROP_ROUND_S = 10.0  # cropping time per all-gather round of load_crops


class IdentityFolderDataset:
    def __init__(
        self,
        root: str,
        detector=None,
        cfg=None,
        min_images_per_id: int = 1,
    ):
        self.root = root
        self.classes: List[str] = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.samples: List[Tuple[str, int]] = []
        kept = []
        for label, name in enumerate(self.classes):
            files = sorted(
                f
                for pattern in ("*.jpg", "*.jpeg", "*.png", "*.bmp")
                for f in glob.glob(os.path.join(root, name, pattern))
            )
            if len(files) >= min_images_per_id:
                kept.append(name)
                for f in files:
                    self.samples.append((f, len(kept) - 1))
        self.classes = kept
        self._detector = detector
        self._cfg = cfg
        self._crop_cache: dict = {}

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self) -> int:
        return len(self.samples)

    def _load_crop(self, path: str) -> Optional[np.ndarray]:
        if path in self._crop_cache:
            return self._crop_cache[path]
        from facerecognizeonnx_tpu_torch.io.imageio import imread

        image = imread(path)
        if image is None:
            return None
        crop = None
        if self._detector is not None:
            faces = self._detector.detect(image)
            if faces:
                import torch

                from facerecognizeonnx_tpu_torch.embed.pipeline import align_faces
                from facerecognizeonnx_tpu_torch.types import face_boxes_to_arrays

                cfg = self._cfg or self._detector.cfg
                dev = self._detector.device
                dets = face_boxes_to_arrays(faces[:1], 1)
                with torch.no_grad():
                    aligned = align_faces(
                        torch.from_numpy(np.ascontiguousarray(image)).to(dev),
                        dets.kps.to(dev),
                        dets.boxes.to(dev),
                        cfg,
                    )[0]
                crop = aligned.cpu().numpy().astype(np.uint8)
        if crop is None:  # no detector / no face → center-ish resize
            from facerecognizeonnx_tpu_torch.runtime.native import (
                letterbox_native,
                native_available,
            )

            size = (self._cfg.rec_input_size if self._cfg else 112)
            if native_available():
                crop, _ = letterbox_native(image, size)
            else:
                import cv2

                crop = cv2.resize(image, (size, size))
        self._crop_cache[path] = crop
        return crop

    def load_crops(self, mesh=None, axis: str = "data") -> int:
        """Fill the crop cache with every image's crop; returns how many
        images gave one. With `mesh`, rank i of the `axis` line crops
        images i, i + n, ... and every rank of the line ends with every
        crop (module docstring): a collective over that line, so each of
        its ranks calls it."""
        from facerecognizeonnx_tpu_torch.parallel.mesh import axis_size

        paths = [p for p, _ in self.samples]
        n = 1 if mesh is None else axis_size(mesh, axis)
        if n == 1:
            return sum(self._load_crop(p) is not None for p in paths)
        import torch

        from facerecognizeonnx_tpu_torch.parallel.mesh import all_gather_into_tensor, mesh_device

        group, dev = mesh.get_group(axis), mesh_device(mesh)
        cfg = self._cfg or (self._detector.cfg if self._detector is not None else None)
        size = cfg.rec_input_size if cfg is not None else 112
        mine = list(range(mesh.get_local_rank(axis), len(paths), n))
        pos = 0
        while True:
            # crop for up to CROP_ROUND_S (at least one image while any is left)
            ids, crops = [], []
            t_end = time.perf_counter() + CROP_ROUND_S
            while pos < len(mine) and (not ids or time.perf_counter() < t_end):
                crop = self._load_crop(paths[mine[pos]])
                if crop is not None:
                    ids.append(mine[pos])
                    crops.append(crop)
                pos += 1
            state = torch.empty((n, 2), dtype=torch.int64, device=dev)  # (crops, finished)
            all_gather_into_tensor(state, torch.tensor([[len(ids), int(pos == len(mine))]],
                                                       device=dev), group)
            m, done = int(state[:, 0].max()), bool(state[:, 1].all())
            if m:
                block = np.zeros((m, size, size, 3), np.uint8)
                block[:len(crops)] = crops
                idx = np.full(m, -1, np.int64)
                idx[:len(ids)] = ids
                got = torch.empty((n * m, size, size, 3), dtype=torch.uint8, device=dev)
                all_gather_into_tensor(got, torch.from_numpy(block).to(dev), group)
                got_idx = torch.empty(n * m, dtype=torch.int64, device=dev)
                all_gather_into_tensor(got_idx, torch.from_numpy(idx).to(dev), group)
                got = got.cpu().numpy()
                for row, i in enumerate(got_idx.cpu().tolist()):
                    if i >= 0:
                        self._crop_cache[paths[i]] = got[row]
            if done:
                break
        return sum(p in self._crop_cache for p in paths)

    def crop(self, path: str) -> Optional[np.ndarray]:
        """The cached aligned (S, S, 3) uint8 BGR crop for one dataset
        image path (None if the image is unreadable). Public accessor
        for evaluation protocols that pair crops across identities."""
        return self._load_crop(path)

    @staticmethod
    def _augment(x_u8: np.ndarray, rng: np.random.Generator, jitter: int) -> np.ndarray:
        """ArcFace-standard train-time augmentation on a (B, S, S, 3)
        uint8 batch: per-sample random horizontal flip (p=0.5, THE one
        augmentation every ArcFace recipe uses) plus optional ±jitter px
        edge-padded translation. Host-side numpy — runs on crops already
        cached, so it never touches the detect/align path."""
        b, s = x_u8.shape[0], x_u8.shape[1]
        out = x_u8.copy()
        flip = rng.random(b) < 0.5
        out[flip] = out[flip, :, ::-1]
        if jitter > 0:
            pad = np.pad(
                out, ((0, 0), (jitter, jitter), (jitter, jitter), (0, 0)),
                mode="edge",
            )
            shifts = rng.integers(0, 2 * jitter + 1, size=(b, 2))
            out = np.stack(
                [pad[i, dy : dy + s, dx : dx + s] for i, (dy, dx) in enumerate(shifts)]
            )
        return out

    def batches(
        self,
        batch_size: int,
        seed: int = 0,
        epochs: Optional[int] = None,
        augment: bool = False,
        jitter: int = 4,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (images (B, S, S, 3) float32 in [-1, 1] RGB, labels (B,)).

        augment=True applies train-time augmentation (random horizontal
        flip + ±jitter px translation) AFTER the crop cache — the
        default for `cli train`; evaluation paths leave it off so eval
        batches stay deterministic."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.samples))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                crops, labels = [], []
                for i in idx:
                    path, label = self.samples[i]
                    crop = self._load_crop(path)
                    if crop is None:
                        continue
                    crops.append(crop)
                    labels.append(label)
                if not crops:
                    continue
                x = np.stack(crops)
                if augment:
                    x = self._augment(x, rng, jitter)
                x = x.astype(np.float32)
                x = (x[..., ::-1] - 127.5) / 128.0  # BGR→RGB, [-1, 1]
                yield x, np.asarray(labels, np.int32)
            epoch += 1
