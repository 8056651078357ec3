"""Ahead-of-time export of the fused step (torch.export), replayed as one
CUDA graph.

Port of `facerecognizeonnx_tpu/pipeline/aot.py`. The deployment unit is
the fused detect → align → embed step (`frames_to_features`) for one
frame batch shape, traced once with `torch.export` and loaded without
running any model-building Python. Its outputs are boxes, scores, kps,
valid and features. The step's hand-written kernels (the pyramid and the
x-major warp of csrc/warp_xm.cu, the NMS of csrc/nms_greedy.cu) are
`torch.library` custom ops, so the program holds them as nodes whose CUDA
registration launches the kernel and whose CPU registration runs the
plain version: one exported program runs on either device. Programs are
saved with their tensors on the CPU and placed on the device asked for
at load.

Two artifact flavours, as in the reference:

- `save_fused` / `load_fused`: the weights baked into the program.
- `save_bundle` / `load_bundle`: one `.frtz` zip of `meta.json`, the
  `torch.export` program (`program.pt2`) taking the param leaves as
  arguments, and an index-keyed `params.npz` of those leaves (the
  models' `state_dict` values, detector first). `AotPipeline.swap_params`
  drops refreshed weights into a loaded bundle without exporting again.

On a CUDA device `AotPipeline` captures the step as one CUDA graph at its
first call (after warm-up calls on a side stream, which build the
kernels' libraries and let cuDNN pick its algorithms) and afterwards
copies the frames into the graph's static input and replays it: one
graph launch per step in place of some 1,400 eager launches. Nothing in
the step reads the host, so nothing breaks the capture.

A `.frtz` written by the JAX package holds a StableHLO program, which
this package cannot run; `load_bundle` names it and raises
`ModelLoadError`.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import zipfile
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.errors import InvalidInputError, ModelLoadError
# the step's custom ops must be registered before a program holding them loads
from facerecognizeonnx_tpu_torch.ops import nms as _nms  # noqa: F401
from facerecognizeonnx_tpu_torch.ops import warp_cuda as _warp_cuda  # noqa: F401
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features

PROGRAM_KIND = "torch.export"
FRTZ_VERSION = 1
OUTPUTS = ("boxes", "scores", "kps", "valid", "features")
_META = "meta.json"
_PROGRAM = "program.pt2"
_PARAMS = "params.npz"
_JAX_PROGRAM = "program.bin"
# warm-up calls before a capture: the first builds the kernels' libraries,
# the others run with everything cached, as the capture will
WARMUP_CALLS = 3


class _Fused(nn.Module):
    """det + rec → the fused step's five outputs, for one config."""

    def __init__(self, det, rec, cfg: PipelineConfig, max_faces_embed: int):
        super().__init__()
        self.det, self.rec = det, rec
        self.cfg, self.max_faces_embed = cfg, max_faces_embed

    def forward(self, frames_u8: torch.Tensor):
        dets, feats = frames_to_features(
            self.det, self.rec, frames_u8, self.cfg, self.max_faces_embed
        )
        return dets.boxes, dets.scores, dets.kps, dets.valid, feats


class _LeafStep(nn.Module):
    """The fused step with the param leaves as arguments: forward(*leaves,
    frames). The models sit in a tuple, outside the module tree, so the
    exported program holds no weights of its own."""

    def __init__(self, fused: _Fused, names: Sequence[str]):
        super().__init__()
        self._fused = (fused,)
        self._names = list(names)

    def forward(self, *args):
        state = dict(zip(self._names, args[:-1]))
        return torch.func.functional_call(self._fused[0], state, (args[-1],))


def _check_models(det_params, arc_params) -> None:
    from facerecognizeonnx_tpu_torch.onnx_import import OnnxRunner

    for model in (det_params, arc_params):
        if isinstance(model, OnnxRunner) or not isinstance(model, nn.Module):
            raise ModelLoadError(
                ".frtz bundles need the port's native modules (an OnnxRunner runs "
                "the graph executor, whose weights are not the module's leaves): "
                "map the .onnx to a native module (FaceRecognizer.load_model) or "
                "use save_fused, which bakes the weights in"
            )


def _frames_spec(cfg: PipelineConfig, batch: int, device) -> torch.Tensor:
    size = cfg.det_input_size
    return torch.zeros((batch, size, size, 3), dtype=torch.uint8, device=device)


def _model_device(model) -> torch.device:
    for t in model.state_dict().values():
        return t.device
    return torch.device("cpu")


def _export(module: nn.Module, args: Tuple) -> torch.export.ExportedProgram:
    with torch.no_grad():
        ep = torch.export.export(module, args, strict=False)
    # saved device-neutral: load_* places the program where it is asked
    return move_to_device_pass(ep, "cpu")


def _serialize(ep: torch.export.ExportedProgram) -> bytes:
    # the example inputs would be saved too: for a bundle, a second copy
    # of every weight
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _deserialize(data: bytes, device: torch.device) -> torch.export.ExportedProgram:
    try:
        ep = torch.export.load(io.BytesIO(data))
    except Exception as e:  # a corrupt archive raises whatever its reader meets
        raise ModelLoadError(f"corrupt AOT program: {e}") from e
    return move_to_device_pass(ep, device)


def export_fused(
    det_params,
    arc_params,
    cfg: PipelineConfig,
    batch: int,
    max_faces_embed: int = 8,
) -> bytes:
    """Export the fused detect→align→embed step with the weights baked in
    for a (batch, S, S, 3) uint8 frame batch. Returns the program's
    bytes (the caller persists them)."""
    fused = _Fused(det_params, arc_params, cfg, max_faces_embed)
    ep = _export(fused, (_frames_spec(cfg, batch, _model_device(fused)),))
    return _serialize(ep)


def save_fused(path: str, *args, **kwargs) -> str:
    data = export_fused(*args, **kwargs)
    with open(path, "wb") as f:
        f.write(data)
    return path


def load_fused(path_or_bytes: Union[str, bytes, bytearray], device="cuda") -> Callable:
    """Load a program written by `save_fused` onto `device` → callable
    frames_u8 (B, S, S, 3) → (boxes, scores, kps, valid, features).

    Raises ModelLoadError on a missing or corrupt program."""
    dev = resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        try:
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        except OSError as e:
            raise ModelLoadError(f"cannot read AOT program: {e}") from e
    module = _deserialize(data, dev).module()

    def run(frames_u8):
        with torch.no_grad():
            return module(torch.as_tensor(np.asarray(frames_u8, np.uint8), device=dev))

    return run


# --------------------------------------------------------------------------
# .frtz bundles: program + weights in one file, weights as call arguments


def save_bundle(
    path: str,
    det_params,
    arc_params,
    cfg: PipelineConfig,
    batch: int,
    max_faces_embed: int = 8,
) -> str:
    """Export the fused step with the leaves as arguments and write the
    single-file .frtz bundle. det_params / arc_params: the port's SCRFD
    and recognizer modules, on any device."""
    _check_models(det_params, arc_params)
    fused = _Fused(det_params, arc_params, cfg, max_faces_embed)
    state = fused.state_dict()
    names, leaves = list(state), [t.detach() for t in state.values()]
    frames = _frames_spec(cfg, batch, _model_device(fused))
    ep = _export(_LeafStep(fused, names), (*leaves, frames))
    meta = {
        "program": PROGRAM_KIND,
        "format_version": FRTZ_VERSION,
        "torch": torch.__version__,
        "config": dataclasses.asdict(cfg),
        "batch": batch,
        "max_faces_embed": max_faces_embed,
        "n_leaves": len(leaves),
        "n_det_leaves": sum(1 for n in names if n.startswith("det.")),
        "leaves": names,
        "outputs": list(OUTPUTS),
    }
    buf = io.BytesIO()
    np.savez(buf, **{f"{i:05d}": t.cpu().numpy() for i, t in enumerate(leaves)})
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_META, json.dumps(meta, indent=1))
        z.writestr(_PROGRAM, _serialize(ep))
        z.writestr(_PARAMS, buf.getvalue())
    os.replace(tmp, path)
    return path


def _config_from(meta_config: dict) -> PipelineConfig:
    # JSON has no tuples
    return PipelineConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in meta_config.items()})


class AotPipeline:
    """A loaded .frtz bundle: ``pipe(frames_u8)`` runs the fused step and
    returns (boxes, scores, kps, valid, features) as fresh tensors on the
    bundle's device.

    On a CUDA device the first call captures the step as one CUDA graph;
    every call copies its frames into the graph's static input and
    replays it. On the CPU each call runs the program."""

    def __init__(self, program: torch.export.ExportedProgram, leaves: List[torch.Tensor],
                 meta: dict, device: torch.device):
        self.meta = meta
        self.config = _config_from(meta["config"])
        self.batch = int(meta["batch"])
        self.max_faces_embed = int(meta["max_faces_embed"])
        self.device = device
        self._module = program.module()
        self._leaves = leaves
        self._n_det = int(meta["n_det_leaves"])
        self._lock = threading.Lock()
        self._graph = None
        self._static_in: Optional[torch.Tensor] = None
        self._static_out: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def frames_shape(self) -> Tuple[int, int, int, int]:
        s = self.config.det_input_size
        return (self.batch, s, s, 3)

    def swap_params(self, det_params=None, arc_params=None) -> None:
        """Drop in refreshed weights (same architecture and shapes) without
        exporting again: each new leaf is copied in place into the tensor
        the program (and a captured graph) reads, so the graph stays valid.
        Raises ModelLoadError on a leaf count, shape or dtype mismatch."""
        parts = []
        if det_params is not None:
            parts.append((0, "detector", det_params))
        if arc_params is not None:
            parts.append((self._n_det, "recognizer", arc_params))
        new = []
        for start, what, model in parts:
            values = list(model.state_dict().values())
            want = self._n_det if start == 0 else len(self._leaves) - self._n_det
            if len(values) != want:
                raise ModelLoadError(
                    f"swap_params: the {what} has {len(values)} leaves, the bundle {want}"
                )
            for i, v in enumerate(values, start):
                dst = self._leaves[i]
                if tuple(v.shape) != tuple(dst.shape) or v.dtype != dst.dtype:
                    raise ModelLoadError(
                        f"swap_params: leaf {self.meta['leaves'][i]} is {v.dtype} "
                        f"{tuple(v.shape)}, the bundle's {dst.dtype} {tuple(dst.shape)}"
                    )
                new.append((dst, v))
        with self._lock, torch.no_grad():
            for dst, v in new:
                dst.copy_(v)

    def _capture(self) -> None:
        self._static_in = torch.zeros(self.frames_shape, dtype=torch.uint8, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self._module(*self._leaves, self._static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_out = tuple(self._module(*self._leaves, self._static_in))
        self._graph = graph

    def __call__(self, frames_u8) -> Tuple[torch.Tensor, ...]:
        """(batch, S, S, 3) uint8 frames (numpy or tensor) → (boxes, scores,
        kps, valid, features)."""
        if isinstance(frames_u8, torch.Tensor):
            frames = frames_u8
        else:
            frames = torch.from_numpy(np.ascontiguousarray(frames_u8))
        if tuple(frames.shape) != self.frames_shape or frames.dtype != torch.uint8:
            raise InvalidInputError(
                f"the AOT program is exported for uint8 frames {self.frames_shape}; got "
                f"{frames.dtype} {tuple(frames.shape)} (AOT shapes are static: export "
                f"another batch size if needed)"
            )
        with self._lock, torch.no_grad():
            if self.device.type != "cuda":
                return tuple(self._module(*self._leaves, frames.to(self.device)))
            if self._graph is None:
                self._capture()
            self._static_in.copy_(frames, non_blocking=True)
            self._graph.replay()
            # fresh tensors: the next replay overwrites the static outputs
            return tuple(t.clone() for t in self._static_out)


def _jax_bundle(names: Sequence[str], meta: dict) -> bool:
    return meta.get("program") != PROGRAM_KIND and (
        _JAX_PROGRAM in names or "platforms" in meta
    )


def load_bundle(path: str, device="cuda") -> AotPipeline:
    """Load a .frtz bundle written by `save_bundle` onto `device` (the
    program and its leaves). Raises ModelLoadError on a missing, corrupt or
    foreign bundle, such as one the JAX package wrote."""
    dev = resolve_device(device)
    if not os.path.exists(path):
        raise ModelLoadError(f"AOT bundle not found: {path}")
    try:
        with zipfile.ZipFile(path, "r") as z:
            names = z.namelist()
            meta = json.loads(z.read(_META).decode("utf-8"))
            if _jax_bundle(names, meta):
                raise ModelLoadError(
                    f"{path} was written by the JAX package's save_bundle (a StableHLO "
                    f"program, format_version {meta.get('format_version')}), which this "
                    "package cannot run: export the models again with "
                    "facerecognizeonnx_tpu_torch.pipeline.aot.save_bundle"
                )
            program = z.read(_PROGRAM)
            params_bytes = z.read(_PARAMS)
    except (zipfile.BadZipFile, KeyError, ValueError) as e:
        raise ModelLoadError(f"not a valid .frtz bundle: {path}: {e}") from e
    if meta.get("program") != PROGRAM_KIND or meta.get("format_version") != FRTZ_VERSION:
        raise ModelLoadError(
            f"unsupported bundle: program={meta.get('program')!r} format_version="
            f"{meta.get('format_version')} (this build reads {PROGRAM_KIND!r} version "
            f"{FRTZ_VERSION})"
        )
    ep = _deserialize(program, dev)
    try:
        with np.load(io.BytesIO(params_bytes)) as data:
            arrays = [data[k] for k in sorted(data.files)]
    except (OSError, ValueError) as e:
        raise ModelLoadError(f"bundle params corrupt: {e}") from e
    if len(arrays) != int(meta["n_leaves"]):
        raise ModelLoadError(
            f"bundle params corrupt: {len(arrays)} leaves, meta says {meta['n_leaves']}"
        )
    leaves = [torch.from_numpy(a).to(dev) for a in arrays]
    return AotPipeline(ep, leaves, meta, dev)
