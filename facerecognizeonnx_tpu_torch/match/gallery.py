"""1:N identification gallery.

Port of `facerecognizeonnx_tpu/match/gallery.py`. The bank keeps its
rows on the host (numpy, L2-normalized) and, per bank version, a copy on
`device` for searches. Search methods, with their JAX counterparts (a
JAX name passed to `search` raises, naming the port's):

  "dense"  ↔ "xla":    materialize (Q, G) sims, stable top-k
                       (`ops/gallery_cuda.gallery_topk_reference`)
  "tiled"  ↔ "tiled":  exact two-stage top-k (`gallery_topk_tiled`)
  "cuda"   ↔ "pallas": the streaming kernel csrc/gallery_topk.cu
                       (`gallery_topk_cuda`; its plain version on a CPU
                       bank)
  "auto":              "cuda" once Q·G > 2·10⁹ on a CUDA bank (the (Q, G)
                       sims would not fit), else "dense" — the JAX rule.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.config import resolve_device
from facerecognizeonnx_tpu_torch.errors import GalleryError, InvalidInputError
from facerecognizeonnx_tpu_torch.ops.gallery_cuda import (
    MAX_K,
    gallery_topk_cuda,
    gallery_topk_reference,
    gallery_topk_tiled,
)

METHODS = ("auto", "dense", "tiled", "cuda")
JAX_METHODS = {"xla": "dense", "pallas": "cuda"}
AUTO_KERNEL_ELEMENTS = 2_000_000_000  # Q·G above which "auto" streams


def auto_uses_kernel(n_queries: int, n_rows: int, device: torch.device) -> bool:
    """method="auto"'s rule, kept from the JAX package: stream through the
    kernel when the (Q, G) sims would pass 2·10⁹ elements on a CUDA bank."""
    return n_queries * n_rows > AUTO_KERNEL_ELEMENTS and device.type == "cuda"


class _Store:
    """One version of the bank: (names, feats) plus the device copies of
    THIS version. Mutations install a whole new _Store, so a search that
    took `bank._store` once works on one consistent snapshot even while
    another thread enrolls or removes: labels cannot misalign with rows.
    The device cache spares an upload per search and keeps the bf16 copy
    at rest."""

    __slots__ = ("names", "feats", "cache")

    def __init__(self, names: List[str], feats: np.ndarray, cache=None):
        self.names = names
        self.feats = feats
        self.cache: dict = {} if cache is None else cache


class GalleryBank:
    """Enrolled (name, feature) rows with 1:N search on `device` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, feature_dim: int = 512, device="cuda"):
        self.feature_dim = feature_dim
        self.device = resolve_device(device)
        self._store = _Store([], np.zeros((0, feature_dim), np.float32))
        # serializes the mutators' read-modify-write of _store; readers
        # never take it (they snapshot _store once)
        self._mu = threading.Lock()

    def __len__(self) -> int:
        return len(self._store.names)

    @property
    def names(self) -> List[str]:
        return list(self._store.names)

    @property
    def features(self) -> np.ndarray:
        return self._store.feats

    def add(self, name: str, feature) -> None:
        feat = np.asarray(feature, np.float32).reshape(1, -1)
        if feat.shape[1] != self.feature_dim:
            raise GalleryError(
                f"feature dim {feat.shape[1]} != bank dim {self.feature_dim}"
            )
        norm = np.linalg.norm(feat)
        if norm > 0:
            feat = feat / norm
        with self._mu:
            store = self._store
            self._store = _Store(
                store.names + [name], np.concatenate([store.feats, feat], axis=0)
            )

    def add_batch(self, names: Sequence[str], features) -> None:
        feats = np.asarray(features, np.float32)
        norms = np.linalg.norm(feats, axis=1, keepdims=True)
        feats = np.where(norms > 0, feats / np.maximum(norms, 1e-20), feats)
        with self._mu:
            store = self._store
            self._store = _Store(
                store.names + list(names), np.concatenate([store.feats, feats], axis=0)
            )

    def remove(self, name: str) -> int:
        """Remove every enrollment under `name`; returns how many rows
        went. The device copies invalidate like any other mutation."""
        with self._mu:
            store = self._store
            keep = [i for i, n in enumerate(store.names) if n != name]
            removed = len(store.names) - len(keep)
            if removed:
                self._store = _Store([store.names[i] for i in keep], store.feats[keep])
        return removed

    def rename(self, old: str, new: str) -> int:
        """Relabel every enrollment under `old` to `new`; returns the row
        count. The features are untouched, so the device cache carries
        over to the new store version."""
        with self._mu:
            store = self._store
            names = [new if n == old else n for n in store.names]
            n = sum(1 for a, b in zip(store.names, names) if a != b)
            if n:
                self._store = _Store(names, store.feats, cache=store.cache)
        return n

    def _device_feats(
        self, dtype: Optional[torch.dtype] = None, store: Optional[_Store] = None
    ) -> torch.Tensor:
        """`store`'s rows on the bank's device at `dtype` (default f32),
        cached on that store version (two racing fills upload twice, the
        last wins — benign)."""
        store = self._store if store is None else store
        key = "float32" if dtype is None else str(dtype).replace("torch.", "")
        if key not in store.cache:
            arr = torch.from_numpy(np.ascontiguousarray(store.feats)).to(self.device)
            store.cache[key] = arr if dtype is None else arr.to(dtype)
        return store.cache[key]

    def device_bank_padded(
        self, min_rows: int = 64, store: Optional[_Store] = None
    ) -> Tuple[torch.Tensor, int, List[str]]:
        """(device rows zero-padded to a power-of-two bucket ≥ min_rows,
        n_real, names snapshot): the operand of the one-dispatch fused
        identify (`pipeline.fused.frames_to_matches`), which masks the
        pad rows by n_real. Cached per bucket on the store version."""
        store = self._store if store is None else store
        n = store.feats.shape[0]
        gpad = min_rows
        while gpad < n:
            gpad *= 2
        key = ("pad", gpad)
        if key not in store.cache:
            arr = np.zeros((gpad, self.feature_dim), np.float32)
            arr[:n] = store.feats
            store.cache[key] = torch.from_numpy(arr).to(self.device)
        return store.cache[key], n, store.names

    # ------------------------------------------------------------ search

    def search(
        self,
        queries,
        top_k: int = 1,
        sharded: bool = False,
        method: str = "auto",
        storage_dtype: Optional[torch.dtype] = None,
    ) -> Tuple[List[List[str]], np.ndarray]:
        """(Q, D) L2-normalized queries → (names [Q][top_k], sims (Q, top_k))
        on the (cos+1)/2 scale, against one snapshot of the bank.

        method: "auto" | "dense" | "tiled" | "cuda" (module docstring).
        storage_dtype (dense only, e.g. torch.bfloat16) searches a copy
        of the bank kept at that type — a capacity option; the products
        and sums stay float32. sharded=True (rows spread over devices)
        is not ported yet (ROADMAP.md Queue A item 16)."""
        return self._search(self._store, queries, top_k, sharded, method, storage_dtype)

    def _search(self, store, queries, top_k, sharded=False, method="auto",
                storage_dtype=None):
        if method in JAX_METHODS:
            raise ValueError(
                f"method={method!r} is the JAX package's name; the port's is "
                f"{JAX_METHODS[method]!r}"
            )
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        if sharded:
            raise NotImplementedError(
                "sharded gallery search is not ported yet (ROADMAP.md Queue A item 16)"
            )
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.ndim != 2 or queries.shape[1] != self.feature_dim:
            raise InvalidInputError(
                f"query shape {queries.shape} incompatible with "
                f"{self.feature_dim}-d gallery"
            )
        if not store.names:
            return [[] for _ in range(len(queries))], np.zeros((len(queries), 0))
        top_k = min(top_k, len(store.names))
        q = torch.from_numpy(queries).to(self.device)
        use_kernel = method == "cuda" or (
            method == "auto" and auto_uses_kernel(len(queries), len(store.names), self.device)
        )
        with torch.no_grad():
            if use_kernel:
                s, i = gallery_topk_cuda(q, self._device_feats(store=store), top_k)
            elif method == "tiled":
                if top_k > MAX_K:
                    raise ValueError(
                        f"method='tiled' supports top_k <= {MAX_K} (tile size); "
                        f"got top_k={top_k} — use method='dense' or 'auto'"
                    )
                s, i = gallery_topk_tiled(
                    q, self._device_feats(store=store), top_k, tile=MAX_K
                )
            else:
                s, i = gallery_topk_reference(
                    q, self._device_feats(storage_dtype, store=store), top_k,
                    storage_dtype,
                )
        sims, idx = s.cpu().numpy(), i.cpu().numpy()
        names = [[store.names[j] for j in row] for row in idx]
        return names, sims

    def find_duplicates(
        self, threshold: float = 0.8, chunk: int = 128
    ) -> List[Tuple[str, str, float]]:
        """Pairs of rows whose similarity exceeds `threshold` on the
        (cos+1)/2 scale: (name_i, name_j, sim) with i < j, sorted by
        descending similarity (same-name pairs included). Runs as chunked
        self-queries on the bank's device."""
        store = self._store
        n = len(store.names)
        if n < 2:
            return []
        bank = self._device_feats(store=store)
        out: List[Tuple[str, str, float]] = []
        with torch.no_grad():
            for lo in range(0, n, chunk):
                rows = bank[lo: lo + chunk]
                sims = ((rows @ bank.t() + 1.0) * 0.5).cpu().numpy()
                # strictly upper-triangle pairs: each pair reports once
                upper = np.arange(n)[None, :] > np.arange(lo, lo + sims.shape[0])[:, None]
                for r, j in zip(*np.nonzero((sims > threshold) & upper)):
                    out.append((store.names[lo + r], store.names[j], float(sims[r, j])))
        out.sort(key=lambda t: -t[2])
        return out

    # ----------------------------------------------------------- persist

    def save(self, path: str) -> None:
        """Write the bank as `.npz` (keys features, names as JSON,
        feature_dim), the JAX package's format."""
        store = self._store  # one consistent version on disk
        np.savez(
            path, features=store.feats, names=json.dumps(store.names),
            feature_dim=self.feature_dim,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "GalleryBank":
        if not os.path.exists(path):
            raise GalleryError(f"gallery file not found: {path}")
        with np.load(path, allow_pickle=False) as data:
            bank = cls(feature_dim=int(data["feature_dim"]), device=device)
            bank._store = _Store(
                list(json.loads(str(data["names"]))),
                np.asarray(data["features"], np.float32),
            )
        return bank
