#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py        # from the repo root, on a host with a CUDA card

Phases (any failure exits non-zero; there is no CPU path):
  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for matmuls, and for convolutions inside the float32 checks
     (`tf32_off`; the bf16 path's convolutions run in float32 on bf16
     operands, which TF32 holds exactly)
  2. build every csrc/*.cu (warp_xm, warp_ym, gallery_topk, nms_greedy)
     with nvcc for sm_90a, one nvcc per source, and the native host
     runtime with g++, all started together
  3. the x-major warp (csrc/warp_xm.cu: pyramid launch, resample launch
     that computes its own face table) vs its plain-torch versions on the
     card, bit for bit: the pyramid at 640x640, 251x317 and 8x8; the
     table the kernel writes vs face_params_xm over an adversarial sweep
     of 320 faces (`table_sweep_matrices`) and those faces' crops; 16
     frames of 640x640, K=8 faces each over levels 0-3, frame edges, one
     degenerate matrix and a mixed valid mask, raw and epilogue outputs
     and the whole call; 2 frames of 251x317; the launches of one call;
     pyramid, resample and whole-call times beside their bounds
  4. small-input agreement: frames_to_matches at 128x128 with iresnet18 in
     float32, kernel path on the card vs the port's CPU path (the plain
     warp, which tests/test_torch_pipeline.py holds against the JAX package)
  5. the main path at full width: SCRFD-500m at 640x640 and IResNet-50,
     both BN-folded, random weights from a seed, bfloat16, B=8 frames,
     K=8 face slots, through frames_to_matches against a 10,000 x 512
     gallery padded to 16,384 rows; then with skip_invalid_faces=False;
     the same detections through the plain warp (crops held against the
     kernel's at these shapes, features by cosine); frames/s and faces/s
     (median of 10 after warm-up), a per-stage time split and the
     device operations of one step and of its align stage (profiler); the
     step launches the NMS kernel (csrc/nms_greedy.cu), counted
  6. the y-major warp (csrc/warp_ym.cu: one resample launch that computes
     its own face table, after phase 3's pyramid launch) vs its plain
     versions on the card, bit for bit: the table the kernel writes vs
     face_params_ym over the y-major sweep (`table_sweep_matrices(layout=
     "ymajor")`, 320 faces) and the x-major one, and those faces' crops;
     raw and xpass_bf16 crops and the whole call on phase 3's 640x640
     frames (B=16, K=8) and 251x317 frames; its path `warp_cuda.
     warp_affine` (default layout): 1 pyramid + 1 warp_ym launch per call,
     counted, and traced over 3 calls (only those two kernels, at most 2
     operations a call); resample, xpass_bf16 and whole-call times, graph
     and eager, beside their bounds and the plain versions'

  7. the gallery top-k kernel vs its plain version for k in {1, 5, 32,
     100, 512}, Q in {1, 128, 300} and G in {5, 100,000, 100,003} (k <= G),
     D=512, with 1,000 planted duplicate rows in the large galleries;
     padding never wins; self-queries; at Q=128, G=100,000: kernel, plain
     and library composite times, median of 20 in turns, beside the
     3xTF32 bound
  8. `GalleryBank.search(method="auto")` on a 500,000 x 512 bank with
     4,096 queries (Q·G > 2·10^9): it must launch the gallery kernel once;
     64 of its rows held against the plain version
  9. the identify path at full width: FaceDetector (SCRFD-500m, 640) and
     FaceRecognizer (IResNet-50, bf16) on the card, enroll_batch of 64
     frames plus 9,936 random rows (a 10,000-row bank), IdentifyService
     two-dispatch and fuse_search with 64 concurrent requests each
 10. native + bucketed identify: the port's native host runtime built
     with g++ (`runtime/native.py`; codecs if the host has libjpeg /
     libpng), its letterbox held bit for bit against `letterbox_numpy`
     (a numpy transcription of frt_runtime.cc) at 720x1280, 251x317 and
     16x77 and timed against the torch host letterbox it replaces; PNG
     decode and the threaded loader where the codecs built; the
     occupancy-adaptive `BucketedEmbedPipeline` on phase 5's models and
     frames at 2/8 occupancy (valid_cap=2) against `frames_to_features`
     (equal boxes, scores and masks, cosine >= 0.9999 per valid slot,
     zeros elsewhere), then a full-occupancy step that forces one
     correction, the launches of one step (1 pyramid + 1 warp_xm), the
     bucket chosen and the step time against the dense step; the
     slots beyond a short bucket zero; `IdentifyService(adaptive_embed=
     True)` in both modes on 64 concurrent 720x1280 requests (native
     letterbox, not the identity) against the dense service's names;
     `VideoPipeline` over 16 of those frames, dense and adaptive, with
     equal labels; and the histogram of NMS fixpoint iterations of the
     plain version (`nms_greedy_reference`) run on the candidates of phase
     5's frames and the camera frames, outside any timed window (the path
     itself runs the kernel, which has no such count)
 11. the model families at full width, each through frames_to_matches on
     phase 5's frames (B=8, 640x640, K=8) and gallery, bf16, seeded
     weights, the detections recipe (`bias_detector`): the buffalo_sc
     (phase 5's SCRFD-500m + IResNet-50, the phase's baseline), buffalo_l
     (SCRFD-10g + IResNet-50), buffalo_m (2.5g + r50) and buffalo_s (500m
     + MobileFaceNet) packs through `load_pack`, buffalo_sc with
     quant="w8a8" and buffalo_s with quant="w8a8-fast", then SCRFD tpu and
     500m_s2d with r50, mbf_large and vit_t (with 500m) through
     load_model; per configuration 1 warp_xm_pyramid + 1 warp_xm launch
     per step (and _int_mm launches only where quantized); unquantized:
     the same models in float32 (TF32 off): at least 3/4 of the bf16
     step's valid slots have a float32 detection whose box coordinates lie
     within 4 px (bf16 and float32 detections are not equal on these
     frames: scores near 0.5, IoUs near the NMS threshold and boxes by a
     pixel or two move), and the recognizer's features on the step's
     crops against the step's bf16 features, cosine >= 0.999; quantized:
     detections equal to the unquantized pack's bf16 step, for one batch
     of 2 crops every quantized op's int32 accumulator from torch._int_mm
     equal to the int64 plain version (on the host), features at cosine
     >= 0.97 to the unquantized ones on 64 noise crops (the calibration's
     kind of input, as tests/test_quant.py) and recorded on the step's
     crops (the default noise calibration fits warped crops less: the JAX
     package's own w8a8 of the same seeded IResNet-50 reads 0.843 there
     on the CPU); step ms and faces/s (median of 10) and the device
     operations of a step
 12. the serving surface on phase 9's models (SCRFD-500m 640, IResNet-50
     bf16, warp_impl="cuda"): (a) `make_server` over a bank of 64 enrolled
     frames plus 936 random rows, with Bearer auth, driven by
     `IdentifyClient`: healthz, a 401 without the token, 4 enrolls from PNG
     bytes, 32 /identify from 8 client threads, a 16-frame identify_stream,
     a DELETE and a /metrics scrape; the payloads held against the
     server's IdentifyService on the decoded images (faces and boxes
     equal, names equal clear of near-ties, sims within 1e-3: a frame's
     bf16 features move with its row in the batch, `SERVED_SIM_BAR`),
     req/s and p50/p99 of both; then 8 requests one at a time, each row 0
     of its own batch on both sides: sims within 1e-4; (b) `TrackingVideoPipeline`
     over 32 frames of 640x480 (4 scenes of the VideoSource synthetic
     recipe, each held 8 frames: random-weight detectors find other faces
     after any shift), dense and adaptive, batch 4, refresh_every 8: ids
     persist through a scene, embed_frames < total, 1 warp_xm + 1 pyramid
     launch per refresh dispatch, no refresh slot holding another face
     than the detect-only run's (`slot_mismatches`), labels equal,
     embed_fraction and frames/s; (c) the CLI in process with --json
     (detect bulk and single, compare, simple, enroll, identify single and
     multi-probe, webcam --track --enroll-first, doctor), each stdout
     parsed as one JSON document, detect and compare with `imwrite`
     replaced by a recorder (the GPU host has neither cv2 nor PIL), then
     `python3 -m facerecognizeonnx_tpu_torch serve` in its own process
     (through the CLI's launcher: its startup line `进程组: nccl × 1
     rank`): POST /enroll, SIGTERM, exit 0 with the gallery saved; wall
     times.
     Images reach the port as PNG bytes: the GPU host's native runtime
     builds without codecs, so `io.imageio.decode_png` reads them
 13. ONNX interop at buffalo_sc width (`phase_onnx`): (a) phase 5's
     SCRFD-500m (unfolded, cls bias of the detections recipe) and
     IResNet-50 exported with `onnx_export` (2.4 and 174.5 MB) and loaded
     back through `FaceDetector.load_model(det.onnx)` (an OnnxRunner) and
     `FaceRecognizer.load_model(r50.onnx)` (mapped natively, its
     self-verify cosine printed); export, parse, map and first-call
     times; the runner's heads against the native SCRFD on the same
     unfolded weights at bf16 (scores within one bf16 ulp: the fast
     path's sigmoid rounds to bf16, as JAX's; bbox and kps within
     REG_BAR); (b) `frames_to_matches` on phase 5's frames and gallery
     (B=8, K=8, bf16) with the runner detector and the mapped recognizer,
     then with the recognizer forced through the executor: 1 warp_xm + 1
     pyramid launch a step each, held against the native models on the
     same weights (the detector unfolded as the graph is; phase 5's
     folded SCRFD rounds otherwise at bf16, and that step is printed
     beside without a bar): valid masks equal, at least 3/4 of the slots
     paired with a box within BOX_BAR px, feature cosine >= 1 - 1e-3
     (`realmodels.COSINE_TOL`), gallery rows equal outside near-ties; the
     mapped recognizer bit-equal to phase 5's on phase 5's crops; step ms
     and device operations of the native, runner + mapped and runner +
     executor steps; (c) a det_500m-shaped graph at 640² (`det500m_
     shaped`: the spec of tests/oracles/scrfd_nas_onnx.py) written with
     the port's writer: fast vs reference executor within 1e-2 (float32,
     TF32 off), a B=8 call equal to eight B=1 calls within 1e-4, and
     `frames_to_matches` through it; (d) the CLI in process: `export
     out.onnx` (the seeded IResNet-50) and `export --detector` from a
     .npz, both byte-equal to (a)'s files, `detect` with both .onnx
     models, and `doctor` with FRT_REAL_MODELS_DIR pointing at (a)'s files
     under the real names: real-model parity armed and ok
 14. the NMS kernel (csrc/nms_greedy.cu, `nms.nms_greedy`) vs its plain
     version (`nms_greedy_reference`, the fixpoint loop), keep masks bit
     for bit: phase 5's candidates (B=8, K=512, int_rects), the 12-box
     suppression chain of tests/test_torch_detect.py, and `nms_edge_boxes`
     sweeps with overlaps at IoU 0.4 exactly or within a few float32 ulps
     (int_rects True and False, K=512, B=1 and B=16, valid masks with
     holes); kernel and plain times at phase 5's candidates beside the
     bound
 14b. the IResNet epilogue (csrc/conv_epilogue.cu) vs its plain version,
     bit for bit, in each form at C = 64 / 128 / 256 / 512 with ties, NaN,
     ±inf and −0.0 planted; the folded IResNet-50 at B=512 in bf16, fused
     vs eager (`arcface.fusable` patched off), features bit for bit; the
     kernel's time over one forward's 49 calls beside its bytes bound and
     the plain versions'; no launch on MobileFaceNet or the detector.
     `python3 chip_smoke.py --only conv_epilogue` runs this phase alone
 15. the fused step as AOT bundles (pipeline/aot.py): (a) `save_bundle`
     of phase 5's models (bf16, B=8, K=8, 640²), `load_bundle` onto the
     card, the step captured as one CUDA graph at the first call and
     replayed: valid masks equal the eager `frames_to_features`, boxes
     within 1e-3, features' cosine and max|d| printed; the witness: each
     kernel's device-side launch counter (`nms.device_launches`,
     `warp_cuda.device_launches`) moves by exactly one per replay over
     N_REPLAYS replays, while the Python counters stay at 0; eager step
     and replay in turns, median of 10 with min-max, and the device
     operations of each; (b) the same in float32 with TF32 off: features
     within 1e-5, and after `swap_params` to another seeded IResNet-50
     within 3e-5 of the eager step on it; (c) the CLI's `export out.frtz
     --cpu` (a program traced from CPU tensors), loaded and replayed on the
     card against the eager step on its leaves, and
     `IdentifyService(aot=path)` against the live service on 16 requests
     (masks, boxes and top names equal outside near-ties); (d) `serve
     --aot out.frtz` in its own process answers /identify as the bundle
     does in process, and exits 0 on SIGTERM
 16. the parallel layer (`parallel/`, `phase_parallel`) over a real NCCL
     group of one rank: (a) `init_distributed` from COORDINATOR_ADDRESS
     (a free localhost port), NUM_PROCESSES=1 and PROCESS_ID=0, backend
     nccl and world size 1 asserted; (b) `sharded_topk_search` at Q=128,
     G=100,003 (1,000 planted duplicate rows), D=512, k=5 against
     `gallery_topk_reference` and `GalleryBank.search` "dense" and "cuda":
     sims within 1.67e-6 (the kernel's bar), indices equal outside
     near-ties; `search(sharded=True)` names equal; times beside the
     dense and kernel searches; (c) `make_dp_program` on phase 5's models,
     frames and gallery, with and without search_top_k: every output
     bit-equal to the eager `frames_to_features` / `frames_to_matches`;
     one warp_xm, one pyramid and one nms_greedy launch per call (the
     Python counters, and the device counters over N_DP_CALLS calls); dp
     and eager steps in turns, median of 10 with min-max; (c2) the
     bucketed embed's mesh form (`BucketedEmbedPipeline(mesh=data,
     search_top_k=5)`) bit-equal to the bucketed step without a mesh in
     bf16, and in float32 (TF32 off) within rtol 1e-4 / atol 1e-4 of
     the dp step with search (the JAX dryrun's bar); `make_dp_program`
     with a `quantize_recognizer` (w8a8) copy bit-equal to the eager w8a8
     step; one launch of each kernel per call of each; (d)
     `sharded_batch_embed` bit-equal to `embed_crops` on 64 IResNet-50
     crops (bf16), `tp_embed_crops` within rtol 1e-4 / atol 1e-5 in
     float32 with TF32 off; (e) `ep_embed_crops` with two seeded
     IResNet-50 experts in float32 (TF32 off): every routed face within
     1e-5 of its expert alone, one case overflowing and finished by
     rerun; (f) `IdentifyService(mesh=1, sharded=True)` against the
     plain service on 16 requests: top-1 names equal, sims within 1e-5;
     (g) one line: the pipeline stage is held on the CPU only (its stage
     axis is 2, and NCCL refuses two ranks on one GPU); the group lives
     on into phase 17
 17. training on the card (`phase_train`): (a) an identity folder of 8
     ids × 4 seeded noise PNGs of 640x480 in a temp directory, detected
     by phase 5's SCRFD-500m (`bias_detector`) and aligned through
     `IdentityFolderDataset` (bf16, warp "cuda"): one warp_xm, one
     pyramid and one nms_greedy launch per image, every crop bit-equal to
     the plain warp's on the same matrices; (b) one IResNet-50 step (112²,
     512-d, float32, TF32 off) at B=8 on the card against the port's CPU
     step from the same seeded state and batch: loss within rel 1e-5, BN
     statistics within STAT_BAR, classifier and momentum within 1e-4 of
     their scale, the backbone's update and momentum within UPDATE_BAR
     relative L2 (a PReLU input within float32 noise of 0 may take the
     other side of the kink); remat=True against plain over 2 steps,
     loss within rel 1e-5; (b2) the step on a (1, 1) ("data", "model")
     mesh of phase 16's one-rank NCCL group bit-equal to the mesh=None
     step on the same state and batch (float32, TF32 off, cuDNN
     deterministic: the backward's convolutions otherwise may differ
     run to run), and `IdentityFolderDataset.load_crops` over that mesh:
     its crops equal (a)'s, one launch of each kernel per image; (c) speed at B=128, C=93,431 (arcface_torch's
     ms1mv3_r50 per-GPU batch and class count), TF32 as the port leaves
     it: ms/step median of 10 after 3 warm-up steps with min-max,
     images/s, peak memory, the loss on the one batch falling; (d) `fit`
     for 6 steps with a checkpoint at 3: the run resumed from it equals
     the uninterrupted run bit for bit (cuDNN deterministic for this
     check); (e) `train_detector` on SCRFD-500m at 640², B=8, 20 Adam
     steps on phase 5's frames with seeded boxes (the loss falls), and
     one step at B=2 on the card against the CPU (TF32 off): loss within
     rel 1e-5, ≥ 99.9% of the weights within 1e-6 + 1e-5·|w|, all
     within 2·lr; (f) the CLI: `train <root> --align --steps 3 --batch 8`
     and `eval <root> --align --json` in subprocesses (`train` through
     the CLI's launcher: `进程组: nccl × 1 rank`, mesh data=1), then
     `enroll` and `identify --rec-model` of the trained `.npz` in process
 18. the bench mode (`phase_bench`): `python -m
     facerecognizeonnx_tpu_torch.bench --config all --iters 5`, then its
     configs headline_mbf_q8 and headline_occ_adaptive_q8 by name, then
     `python -m facerecognizeonnx_tpu_torch.cli bench`, each a subprocess
     at the default batch of 128 frames; each line of record printed;
     fails on a config with an error or without a value, and where a
     config of the fused step launched no warp_xm, warp_xm_pyramid or
     nms_greedy kernel in its timed region, or `gallery` no gallery_topk
 19. one JSON line of the kernels (warp_xm, warp_xm_pyramid and
     nms_greedy also give their launches on each other path:
     `dp_launches` (one call of the dp step), `bucketed_launches` (one
     call of the bucketed mesh form), `w8a8_dp_launches` (one call of
     the w8a8 dp step), `train_launches` (phase 17's crops),
     `train_mesh_launches` (the crops over the (1, 1) mesh) and
     `bench_launches` (per bench config, its timed region); gallery_topk
     gives `bench_launches` of the gallery config), the nvidia-smi line,
     and last {"ok": true, "device": {...}}

Each path is driven with every launch counter set to 0 just before it
and read just after; launches made to compare a kernel with its plain
version are not counted.

Times: a kernel's time (and the library call's) is device time, its
wrapper call captured once in a CUDA graph and replayed 5 times between
two CUDA events, median of 20 such rounds, so no host work falls between
launches; a plain version's time is its eager call between two CUDA
events (its own host launch gaps included), median of 20. The warp and
gallery kernels are also timed that way, as earlier runs timed them.

Detections recipe (tests/test_torch_pipeline.py uses it too): random
SCRFD weights score every anchor about σ(−4.59) ≈ 0.01, so nothing clears
0.5. `detection_bias` runs the detector once with the cls bias at 0 and
sets the bias to minus the median over frames of the midpoint between
each frame's 32nd and 33rd largest logits, so about 32 anchors per
frame clear 0.5.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import http.client
import io
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import unittest.mock
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from facerecognizeonnx_tpu_torch import FaceDetector, FaceRecognizer, bridge
from facerecognizeonnx_tpu_torch.cli import main as cli_main
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.detect.decode import decode_outputs
from facerecognizeonnx_tpu_torch.detect.pipeline import nms_candidates
from facerecognizeonnx_tpu_torch.embed.pipeline import (
    _align_matrices,
    align_faces_batch,
    embed_crops,
)
from facerecognizeonnx_tpu_torch.io.imageio import VideoSource, decode_image, imread
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.match.similarity import similarity_matrix
from facerecognizeonnx_tpu_torch.models import arcface, layers, packs, quant, scrfd
from facerecognizeonnx_tpu_torch.ops import conv_epilogue, gallery_cuda, nms, warp_cuda
from facerecognizeonnx_tpu_torch.ops.image import letterbox, normalize_to_rgb
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
from facerecognizeonnx_tpu_torch.pipeline import aot, bucketed
from facerecognizeonnx_tpu_torch.pipeline.client import IdentifyClient, ServiceError
from facerecognizeonnx_tpu_torch.pipeline.enroll import enroll_batch
from facerecognizeonnx_tpu_torch.pipeline.fused import (
    detect_topk,
    frames_to_features,
    frames_to_matches,
)
from facerecognizeonnx_tpu_torch.pipeline.server import _faces_payload, make_server
from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService, _Request
from facerecognizeonnx_tpu_torch.pipeline.track import TrackingVideoPipeline
from facerecognizeonnx_tpu_torch.pipeline.video import VideoPipeline
from facerecognizeonnx_tpu_torch.runtime import native
from facerecognizeonnx_tpu_torch.utils import checkpoint, realmodels

EPI = (127.5, 128.0)
# the card's published peaks (H100 SXM data sheet, at 700 W): device
# memory rate, float32 outside the tensor cores (an FMA is 2 ops), and
# dense TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12
# float32 operations per output pixel of the warp kernels, counted from
# their source (coordinates, 4 hat weights, 4 y taps and 2 x taps on 3
# channels; the epilogue adds 6)
WARP_OPS_PER_PIXEL = 80
# float32 operations per candidate pair of the NMS kernel's IoU, counted
# from its source: 4 min / max, 2 widths, 2 clamps, the product, the
# union's add and subtract, its clamp, the division and the compare
NMS_OPS_PER_PAIR = 14
COUNTERS = {
    "warp_xm": warp_cuda.warp_affine_xm,
    "warp_xm_pyramid": warp_cuda.build_pyramid,
    "warp_ym": warp_cuda.warp_affine_ym,
    "gallery_topk": gallery_cuda.gallery_topk_cuda,
    "nms_greedy": nms.nms_greedy,
}
BUILDS = {
    "csrc/warp_xm.cu": warp_cuda.build_library,
    "csrc/warp_ym.cu": warp_cuda.build_library_ym,
    "csrc/gallery_topk.cu": gallery_cuda.build_library,
    "csrc/nms_greedy.cu": nms.build_library,
    "csrc/conv_epilogue.cu": conv_epilogue.build_library,
    # the host runtime (g++), built beside the kernels
    "runtime/cc/frt_runtime.cc": lambda: (native._load(), ""),
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graph_timer(fn, reps=5):
    """A timer of fn's device time: fn captured once in a CUDA graph; each
    call of the timer replays it `reps` times between two CUDA events and
    returns ms per replay."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()

    def one() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    return one


def eager_timer(fn, warmup=3):
    """A timer of fn's eager call between two CUDA events (ms)."""
    for _ in range(warmup):
        fn()

    def one() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    return one


def in_turns(*timers, iters=20):
    """Median of `iters` rounds of each timer, run in turns."""
    rounds = [[t() for t in timers] for _ in range(iters)]
    return [statistics.median(r[i] for r in rounds) for i in range(len(timers))]


def device_trace(fn, calls=1):
    """(the names of the device operations traced, kernel launches called)
    in `calls` calls of fn under one torch.profiler window; no names where
    the profiler sees nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    names = [e.name for e in events if e.device_type == DeviceType.CUDA]
    called = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                 "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    return names, called


def device_ops(fn):
    """(device operations traced, kernel launches called) in one call of fn,
    under torch.profiler; 0 where the profiler sees nothing."""
    names, called = device_trace(fn)
    return len(names), called


def wall_ms(fn, iters=10, warmup=3) -> float:
    """Median host time of fn() in ms, synchronized (for code with host syncs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def face_matrix(scale, theta, tx, ty):
    """Forward src→dst similarity taking a face of the given scale and
    rotation around (tx, ty) to the 112 crop."""
    A = scale * np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    Ainv = np.linalg.inv(A)
    return np.hstack([Ainv, (-Ainv @ np.array([tx, ty]))[:, None]]).astype(np.float32)


def spread_matrices(rng, B, K, H, W):
    scales = (0.6, 0.9, 1.3, 1.9, 2.6, 5.0, 11.0, 0.8)
    out = np.zeros((B, K, 2, 3), np.float32)
    for b in range(B):
        for k in range(K):
            edge = (k + b) % 3
            tx = (-10.0, W * 0.5, W - 8.0)[edge] + rng.uniform(-4, 4)
            ty = (H - 6.0, 12.0, H * 0.5)[edge] + rng.uniform(-4, 4)
            out[b, k] = face_matrix(scales[k % len(scales)], rng.uniform(-1.2, 1.2), tx, ty)
    out[0, K - 1] = 0.0  # degenerate
    return out


def _nearest_hits(cands: np.ndarray, values: np.ndarray, target: float, n: int):
    """The n candidates whose values lie nearest `target`, one per value."""
    order = np.argsort(np.abs(values.astype(np.float64) - target), kind="stable")
    picked, seen = [], set()
    for i in order:
        if values[i] not in seen:
            seen.add(values[i])
            picked.append(cands[i])
        if len(picked) == n:
            break
    return picked


def _table_inputs(M: np.ndarray):
    """Per forward affine: (extent, x_min, y_min) as `face_params_xm` sees them."""
    inv = warp_cuda.invert_affine(torch.from_numpy(M))
    span_x = (112 - 1) * (inv[:, 0, 0].abs() + inv[:, 0, 1].abs()) + 2.0
    span_y = (112 - 1) * (inv[:, 1, 0].abs() + inv[:, 1, 1].abs()) + 2.0
    *_, x_min, y_min = warp_cuda._scaled_inverse(torch.from_numpy(M)[:, None])
    return torch.maximum(span_x, span_y).numpy(), x_min.numpy(), y_min.numpy()


def table_sweep_matrices(seed=11, layout="xmajor") -> np.ndarray:
    """(N, 2, 3) float32 forward affines, N = 320, on the edges of a
    layout's face table: source extents at COVER·2^l and the float32 values
    next to it (l = 0..3, plain and rotated), window minima x_min / y_min on
    and one ulp off multiples of the layout's origin rounding (x-major 16 /
    128; y-major 128 / 16, with origins at and past its 512 / 528 clips),
    singular and near-singular matrices, translations past ±30000, mirrored
    and rotated matrices (negative coefficients), then random similarities."""
    rng = np.random.default_rng(seed)
    steps = (1.0 + np.arange(-160, 161) * 2.0 ** -23).astype(np.float32)
    faces = []
    for lvl in range(4):
        T = 110.0 * 2 ** lvl
        for theta in (0.0, 0.3):
            cs, sn = np.cos(theta), np.sin(theta)
            s = np.float32(111.0 * (abs(cs) + abs(sn)) / (T - 2.0)) * steps
            M = np.zeros((len(s), 2, 3), np.float32)
            M[:, 0, 0], M[:, 0, 1], M[:, 1, 0], M[:, 1, 1] = s * cs, -s * sn, s * sn, s * cs
            M[:, :, 2] = rng.uniform(0, 300, (1, 2)).astype(np.float32)
            faces += _nearest_hits(M, _table_inputs(M)[0], T, 16)
    if layout == "xmajor":
        targets = [(0, 16.0 * m) for m in range(1, 9)] + [(1, 128.0 * m) for m in range(1, 5)]
    else:
        targets = [(0, 128.0 * m) for m in range(1, 7)] + [
            (1, 16.0 * m) for m in (1, 2, 3, 8, 16, 32, 33, 34, 35, 41)]
    for axis, target in targets:
        t0 = -target * 1.25  # forward scale 1.25: x_min = -tx / 1.25
        M = np.zeros((len(steps), 2, 3), np.float32)
        M[:, 0, 0] = M[:, 1, 1] = 1.25
        M[:, axis, 2] = np.float32(t0) * steps
        M[:, 1 - axis, 2] = -40.0
        faces += _nearest_hits(M, _table_inputs(M)[1 + axis], target, 3)
    special = [
        np.zeros((2, 3)),
        [[1, 2, 30], [2, 4, 40]],                    # rank 1
        [[1e-7, 0, 5], [0, 1e-7, 5]],                # det 1e-14, raised to 1e-12
        [[1e-6, 0, 0], [0, 1e-6, 0]],                # det at 1e-12
        [[1.01e-6, 0, 3], [0, 1e-6, 3]],
        [[1e3, 1e3, 1], [1e3, 1e3, 1]],              # singular, huge inverse
        [[1e20, 1e20, 1e10], [1e20, 1e20, -1e10]],   # inverse overflows
        [[-1e19, 1e25, 3e30], [1e25, 1e19, -3e30]],
        [[0, 1, 0], [1, 0, 0]],                      # axes swapped
        [[-1, 0, 700], [0, -1, 700]],                # 180 degrees
        [[-0.5, 0, 300], [0, 0.5, 20]],              # mirrored
        [[3e-3, 0, 0], [0, 3e-3, 0]],                # far beyond level 3
        [[1, 0, 4e4], [0, 1, -4e4]],                 # translations past ±30000
        [[1, 0, -1e6], [0, 1, 1e6]],
        [[0.01, 0, 500], [0, 0.01, 500]],
        [[50, 0, -3e4], [0, 50, 3e4]],
    ]
    faces += [np.asarray(m, np.float32) for m in special]
    while len(faces) < 320:
        scale = np.exp(rng.uniform(np.log(0.05), np.log(20.0)))
        theta = rng.uniform(-np.pi, np.pi)
        m = face_matrix(scale, theta, *rng.uniform(-200, 800, 2))
        if rng.uniform() < 0.3:
            m[:, :2] *= np.array([[-1.0], [1.0]], np.float32)  # mirrored
        faces.append(m)
    return np.stack(faces).astype(np.float32)


def table_bits_equal(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per face: every entry equal bit for bit, or both NaN."""
    same = got.view(torch.int32) == want.view(torch.int32)
    return (same | (torch.isnan(got) & torch.isnan(want))).all(dim=-1)


def nms_edge_boxes(rng, B, K, int_rects):
    """(B, K, 4) float32 boxes in score order whose overlaps sit at the NMS
    threshold 0.4: rows of 4 boxes of one size, each shifted from the last
    by 3/7 of the width (or, in a third of the rows, of the height), so
    that two neighbours overlap by IoU 2/5. With int_rects the sizes are
    multiples of 7 and the shifts whole, so the IoU of the truncated rects
    is 2/5 exactly or a pixel off it (shifts of 3/7 ± 1 px, and corner
    fractions that truncation drops); without, every coordinate is nudged
    by up to 4 float32 ulps, so IoUs fall within a few ulps of 0.4. The
    rows are shuffled together, so chains of suppression interleave."""
    out = np.empty((B, K, 4), np.float32)
    for b in range(B):
        boxes = []
        while len(boxes) < K:
            x, y = np.floor(rng.uniform(0, 400, 2))
            if int_rects:
                m, n = rng.integers(2, 20, 2)
                w, h = 7.0 * m, 7.0 * n
                step = 3.0 * m + rng.integers(-1, 2), 3.0 * n + rng.integers(-1, 2)
            else:
                w, h = rng.uniform(14, 140, 2)
                step = 3 * w / 7, 3 * h / 7
            dx, dy = (step[0], 0.0) if rng.uniform() < 2 / 3 else (0.0, step[1])
            for i in range(4):
                boxes.append([x + i * dx, y + i * dy, x + i * dx + w, y + i * dy + h])
        box = np.asarray(boxes[:K], np.float32)
        if int_rects:
            box += rng.uniform(0, 1, box.shape).astype(np.float32)
        else:
            nudge = rng.integers(-4, 5, box.shape).astype(np.int32)
            box = (box.view(np.int32) + nudge).view(np.float32)
        out[b] = box[rng.permutation(K)]
    return out


def nms_inputs(det_model, frames_u8: torch.Tensor, cfg: PipelineConfig):
    """The candidate sets the main path hands its NMS for these frames:
    (boxes (B, pre_nms_topk, 4) in score order, valid (B, pre_nms_topk))."""
    dtype = cfg.torch_compute_dtype
    with torch.no_grad():
        x = normalize_to_rgb(frames_u8, cfg.pixel_mean, cfg.pixel_scale, dtype=dtype)
        scores, boxes, kps = decode_outputs(det_model(x, dtype), cfg.det_input_size,
                                            cfg.num_anchors)
        boxes, _, _, valid = nms_candidates(scores, boxes, kps, 1.0, cfg)
    return boxes, valid


def nms_plain_histogram(runs, cfg: PipelineConfig) -> dict:
    """{fixpoint iterations: calls} of the plain NMS (`nms_greedy_reference`,
    which counts them) on the candidates that each (detector, frames) pair
    of `runs` gives; the path itself runs the kernel, which has no such
    count. Outside any timed window."""
    nms.nms_fixed.iterations.clear()
    for det_model, frames_u8 in runs:
        boxes, valid = nms_inputs(det_model, frames_u8, cfg)
        nms.nms_greedy_reference(boxes, valid, cfg.nms_threshold, cfg.nms_int_rects)
    return dict(sorted(nms.nms_fixed.iterations.items()))


def detection_bias(det_tree, frames_u8: torch.Tensor, per_frame=32):
    """A copy of the SCRFD tree whose cls bias lets ~per_frame anchors per
    frame clear 0.5 (module docstring)."""
    tree = {**det_tree, "head": {**det_tree["head"]}}
    tree["head"]["cls"] = {"w": det_tree["head"]["cls"]["w"],
                           "b": np.zeros_like(det_tree["head"]["cls"]["b"])}
    model = bridge.params_from_numpy(tree, frames_u8.device)
    x = (frames_u8.flip(-1).float() - 127.5) / 128.0
    with torch.no_grad():
        outs = model(x)
    logits = torch.logit(torch.cat([outs[s][0][..., 0] for s in (8, 16, 32)], -1))
    ranked = torch.sort(logits, dim=-1, descending=True).values
    nth = (ranked[:, per_frame - 1] + ranked[:, per_frame]) / 2  # between two anchors
    tree["head"]["cls"]["b"] = np.full_like(tree["head"]["cls"]["b"], -float(nth.median()))
    return tree


def bias_detector(det: FaceDetector, frames_u8: torch.Tensor, per_frame=32) -> None:
    """`detection_bias` on a FaceDetector loaded from its seed: the tree
    load_model(None) built, biased, and its cls bias set in place (the cls
    conv has no BN, so the fold left it as it is)."""
    tree = detection_bias(bridge.init_params_numpy(det.cfg.scrfd_variant, seed=det.cfg.seed),
                          frames_u8, per_frame)
    bias = det.params.cls.bias
    bias.data.copy_(torch.from_numpy(tree["head"]["cls"]["b"]).to(bias.device))


@contextlib.contextmanager
def tf32_off():
    """float32 convolutions in full float32. cuDNN takes TF32 by default,
    which the bf16 path keeps: its convolutions run in float32 on bf16
    operands, which TF32 holds exactly."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def letterbox_numpy(img: np.ndarray, dsize: int):
    """frt_letterbox (runtime/cc/frt_runtime.cc) transcribed in float32
    numpy, operation for operation: the reference geometry, (uint8)(v +
    0.5f). Returns ((dsize, dsize, 3) uint8, scale)."""
    f32 = np.float32
    sh, sw = img.shape[:2]
    scale = min(f32(dsize) / f32(sw), f32(dsize) / f32(sh))
    nw, nh = int(f32(sw) * scale), int(f32(sh) * scale)
    out = np.zeros((dsize, dsize, 3), np.uint8)
    if nw <= 0 or nh <= 0:
        return out, 1.0

    def axis(n, size):
        s = (np.arange(n, dtype=f32) + f32(0.5)) * f32(size) / f32(n) - f32(0.5)
        fl = np.floor(s)
        i = fl.astype(np.int64)
        return s - fl, np.clip(i, 0, size - 1), np.clip(i + 1, 0, size - 1)

    wx, x0, x1 = axis(nw, sw)
    wy, y0, y1 = axis(nh, sh)
    wx, wy = wx[None, :, None], wy[:, None, None]
    one = f32(1)
    p = img.astype(f32)
    v = ((one - wy) * (one - wx) * p[y0][:, x0] + (one - wy) * wx * p[y0][:, x1]
         + wy * (one - wx) * p[y1][:, x0] + wy * wx * p[y1][:, x1])
    out[:nh, :nw] = (v + f32(0.5)).astype(np.uint8)
    return out, float(scale)


def png_bytes(pixels: np.ndarray, filter_type: int = 0) -> bytes:
    """An 8-bit PNG of the array, written with the standard library: grey
    (H, W) or (H, W, 1), grey + alpha (H, W, 2), RGB (H, W, 3) or RGBA
    (H, W, 4); every scanline filtered with `filter_type` (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth)."""
    import struct
    import zlib

    h, w = pixels.shape[:2]
    px = pixels.reshape(h, w, -1)
    ch = px.shape[2]
    x = px.reshape(h, w * ch).astype(np.int16)
    a = np.zeros_like(x)  # the byte one pixel left, the byte above, and above-left
    a[:, ch:] = x[:, :-ch]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, ch:] = x[:-1, :-ch]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = (np.zeros_like(x), a, b, (a + b) // 2, paeth)[filter_type]
    rows = np.concatenate(
        [np.full((h, 1), filter_type, np.uint8), ((x - pred) % 256).astype(np.uint8)], axis=1
    )

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def check_features(feats, valid, n_rows=None, idx=None):
    assert torch.isfinite(feats).all(), "non-finite features"
    norms = feats.norm(dim=-1)
    assert torch.allclose(norms[valid], torch.ones_like(norms[valid]), atol=1e-3), norms[valid]
    assert (feats[~valid] == 0).all(), "invalid slots must be zero"
    if idx is not None:
        assert (idx[valid] < n_rows).all(), "a valid slot matched a padding row"


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_OPS_PER_S):
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def warp_read_bytes(prm, H, W, K, win_x, win_y, valid=None) -> int:
    """Distinct pyramid bytes that a warp over this face table reads:
    the 2x2 taps of every output pixel of every computed face that fall
    inside its window and its level (3 bytes each)."""
    dev = prm.device
    sizes = warp_cuda.level_sizes(H, W)
    offs = torch.tensor([0] + list(np.cumsum([h * w for h, w in sizes])[:-1]), device=dev)
    frame_px = sum(h * w for h, w in sizes)
    faces = torch.arange(prm.shape[0], device=dev)
    if valid is not None:
        faces = faces[valid.reshape(-1)]
    p = prm[faces]
    level = p[:, 0].long()
    hl = torch.tensor([h for h, _ in sizes], device=dev)[level][:, None]
    wl = torch.tensor([w for _, w in sizes], device=dev)[level][:, None]
    pix = torch.arange(112 * 112, device=dev, dtype=torch.float32)
    fi, fj = torch.floor(pix / 112), pix % 112
    lx = (p[:, 3:4] * fj + p[:, 4:5] * fi + p[:, 7:8]).clamp(-2.0, win_x + 1.0)
    ly = (p[:, 5:6] * fj + p[:, 6:7] * fi + p[:, 8:9]).clamp(-2.0, win_y + 1.0)
    ids = []
    for dx in (0, 1):
        for dy in (0, 1):
            xw, yw = torch.floor(lx).long() + dx, torch.floor(ly).long() + dy
            gx, gy = p[:, 1:2].long() + xw, p[:, 2:3].long() + yw
            ok = (xw >= 0) & (xw < win_x) & (yw >= 0) & (yw < win_y) & (gx < wl) & (gy < hl)
            pid = (faces // K)[:, None] * frame_px + offs[level][:, None] + gy * wl + gx
            ids.append(pid[ok])
    return 3 * int(torch.unique(torch.cat(ids)).numel())


def check_topk(kv, ki, rv, ri, r_next, bar=1e-5):
    """Kernel top-k (kv, ki) vs plain (rv, ri): sims within `bar`; indices
    identical wherever the plain sims around a position (r_next: the
    plain (k+1)-th value, past the last column) differ by more than
    `bar`; equal sims in ascending index. Returns (max |Δsim|, ties)."""
    err = float((kv - rv).abs().max())
    assert err <= bar, f"gallery sims deviate {err}"
    nxt = torch.cat([rv[:, 1:], r_next[:, None]], 1)
    prev = torch.cat([torch.full_like(rv[:, :1], float("inf")), rv[:, :-1]], 1)
    clear = ((prev - rv) > bar) & ((rv - nxt) > bar)
    assert torch.equal(ki[clear], ri[clear].to(ki.dtype)), "gallery indices differ"
    ties = kv[:, 1:] == kv[:, :-1]
    assert (ki[:, 1:] > ki[:, :-1])[ties].all(), "tied sims not in ascending index"
    return err, int(ties.sum())


def build_all() -> float:
    """Build every kernel source at once (one nvcc each); log ptxas."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        logs = dict(zip(BUILDS, pool.map(lambda fn: fn()[1], BUILDS.values())))
    secs = time.perf_counter() - t0
    log(f"build {', '.join(BUILDS)} in parallel: {secs:.2f} s")
    for source, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {source}: {line.strip()}")
    return secs


def phase_warp_xm(dev, rng):
    """The x-major warp's two launches vs their plain versions, bit for
    bit; their times. Returns (resample entry, pyramid entry, the frames
    and matrices phase 6 reuses)."""
    B, K, H, W = 16, 8, 640, 640
    frames = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)
    Ms = torch.from_numpy(spread_matrices(rng, B, K, H, W)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(B, K)) < 0.6).to(dev)
    odd = torch.from_numpy(rng.integers(0, 256, (2, 251, 317, 3), dtype=np.uint8)).to(dev)
    odd_Ms = torch.from_numpy(spread_matrices(rng, 2, K, 251, 317)).to(dev)
    tiny = torch.from_numpy(rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)).to(dev)
    for f in (frames, odd, tiny):
        assert torch.equal(warp_cuda.build_pyramid(f), warp_cuda.build_pyramid_reference(f)), \
            f"pyramid differs from its plain version at {tuple(f.shape[1:3])}"

    # the table the kernel computes and writes, over the adversarial sweep
    sweep = torch.from_numpy(table_sweep_matrices()).to(dev).reshape(-1, K, 2, 3)
    sweep_frames = torch.from_numpy(
        rng.integers(0, 256, (sweep.shape[0], H, W, 3), dtype=np.uint8)).to(dev)
    sweep_pyr = warp_cuda.build_pyramid(sweep_frames)
    sweep_out, table = warp_cuda.resample_xm(sweep_frames, sweep_pyr, sweep)
    want = warp_cuda.face_params_xm(sweep)
    same = table_bits_equal(table, want)
    assert same.all(), f"kernel table differs on faces {torch.nonzero(~same).flatten().tolist()}"
    finite = torch.isfinite(want).all(dim=1)
    sweep_ref = warp_cuda.resample_xm_reference(sweep_frames, sweep_pyr, want, K)
    assert torch.equal(sweep_out.reshape(len(want), -1)[finite],
                       sweep_ref.reshape(len(want), -1)[finite]), "sweep crops differ"
    levels_sweep = {int(v) for v in want[finite, 0].tolist()}

    # crops: raw, epilogue with a mixed valid mask, the whole call, odd sides
    pyr, prm = warp_cuda.build_pyramid(frames), warp_cuda.face_params_xm(Ms)
    levels = sorted(set(prm[:, 0].int().tolist()))
    assert levels == [0, 1, 2, 3], levels
    pairs = [
        (warp_cuda.resample_xm(frames, pyr, Ms)[0],
         warp_cuda.resample_xm_reference(frames, pyr, prm, K)),
        (warp_cuda.resample_xm(frames, pyr, Ms, EPI, valid)[0],
         warp_cuda.resample_xm_reference(frames, pyr, prm, K, EPI, valid)),
        (warp_cuda.warp_affine_xm(frames, Ms, EPI, valid),
         warp_cuda.warp_affine_xm_reference(frames, Ms, EPI, valid)),
        (warp_cuda.warp_affine_xm(odd, odd_Ms),
         warp_cuda.warp_affine_xm_reference(odd, odd_Ms)),
    ]
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    assert all(torch.equal(a, b) for a, b in pairs), f"crops deviate from plain ({err})"
    assert (pairs[1][0][~valid] == 0).all() and (pairs[2][0][~valid] == 0).all()
    reset_counts()
    warp_cuda.warp_affine_xm(frames, Ms, EPI, valid)
    torch.cuda.synchronize()
    per_call = read_counts()
    assert per_call["warp_xm"] == per_call["warp_xm_pyramid"] == 1, per_call
    log(f"warp_xm vs plain, bit for bit: pyramid at 640x640, 251x317, 8x8; kernel table = "
        f"face_params_xm on {len(want)} sweep faces ({int((~finite).sum())} with NaN entries, "
        f"levels {sorted(levels_sweep)}) and their crops; crops raw, epilogue + mixed valid, "
        f"whole call (B={B}, K={K}, {H}x{W}, levels {levels}) and 251x317: max|d| {err:.3g}; "
        f"launches per warp_affine_xm call: pyramid {per_call['warp_xm_pyramid']}, resample "
        f"{per_call['warp_xm']}")

    all_valid = torch.ones_like(valid)
    t_pyr, t_pyr_plain, t_res, t_res_plain, t_all, t_all_plain, t_res_eager, t_all_eager = \
        in_turns(
            graph_timer(lambda: warp_cuda.build_pyramid(frames)),
            eager_timer(lambda: warp_cuda.build_pyramid_reference(frames)),
            graph_timer(lambda: warp_cuda.resample_xm(frames, pyr, Ms, EPI, all_valid)),
            eager_timer(lambda: warp_cuda.resample_xm_reference(
                frames, pyr, warp_cuda.face_params_xm(Ms), K, EPI, all_valid)),
            graph_timer(lambda: warp_cuda.warp_affine_xm(frames, Ms, EPI, all_valid)),
            eager_timer(lambda: warp_cuda.warp_affine_xm_reference(frames, Ms, EPI, all_valid)),
            eager_timer(lambda: warp_cuda.resample_xm(frames, pyr, Ms, EPI, all_valid)),
            eager_timer(lambda: warp_cuda.warp_affine_xm(frames, Ms, EPI, all_valid)),
        )
    n_out = B * K * 112 * 112
    pyr_bound, pyr_by = bound_ms(frames.numel() + pyr.numel(), 5 * pyr.numel())
    res_bytes = (warp_read_bytes(prm, H, W, K, warp_cuda.WIN_X, warp_cuda.WIN_Y, all_valid)
                 + Ms.numel() * 4 + prm.numel() * 4 + B * K + n_out * 3 * 2)
    res_bound, res_by = bound_ms(res_bytes, n_out * WARP_OPS_PER_PIXEL)
    all_bound, _ = bound_ms(frames.numel() + pyr.numel() + res_bytes,
                            5 * pyr.numel() + n_out * WARP_OPS_PER_PIXEL)
    log(f"warp_xm times (B={B}, K={K}, epilogue, all slots valid; median of 20, in turns): "
        f"pyramid kernel {t_pyr:.4f} ms | plain {t_pyr_plain:.4f} | bound {pyr_bound:.4f} "
        f"({pyr_by}); resample kernel (table included) {t_res:.4f} ms | plain (face_params_xm "
        f"+ resample_xm_reference) {t_res_plain:.4f} | bound {res_bound:.4f} ({res_by}); "
        f"whole warp_affine_xm {t_all:.4f} ms | plain {t_all_plain:.4f} | bound "
        f"{all_bound:.4f} (bytes); eager calls between CUDA events (host gaps included): "
        f"resample {t_res_eager:.4f} ms, whole call {t_all_eager:.4f} ms")
    xm = dict(max_abs_err=err, ms=t_res, plain_ms=t_res_plain, bound_ms=res_bound,
              bound_by=res_by, library_ms=None)
    pyramid = dict(max_abs_err=0.0, ms=t_pyr, plain_ms=t_pyr_plain, bound_ms=pyr_bound,
                   bound_by=pyr_by, library_ms=None)
    return xm, pyramid, (frames, Ms, odd, odd_Ms, K)


def phase_ymajor(frames, Ms, odd, odd_Ms, K) -> dict:
    """The y-major warp's launch (its table included) vs its plain versions,
    bit for bit; its times; then its path: `warp_cuda.warp_affine` with its
    default layout."""
    dev = frames.device
    B, H, W = frames.shape[:3]
    rng = np.random.default_rng(12)
    # the table the kernel computes and writes, over the y-major sweep and the
    # x-major one; the crops of the faces whose table is finite
    swept = []
    for layout in ("ymajor", "xmajor"):
        sweep = torch.from_numpy(table_sweep_matrices(layout=layout)).to(dev).reshape(-1, K, 2, 3)
        sweep_frames = torch.from_numpy(
            rng.integers(0, 256, (sweep.shape[0], H, W, 3), dtype=np.uint8)).to(dev)
        sweep_pyr = warp_cuda.build_pyramid(sweep_frames)
        sweep_out, table = warp_cuda.resample_ym(sweep_frames, sweep_pyr, sweep)
        want = warp_cuda.face_params_ym(sweep)
        same = table_bits_equal(table, want)
        bad = torch.nonzero(~same).flatten().tolist()
        assert same.all(), f"{layout} sweep: kernel table differs on faces {bad}"
        finite = torch.isfinite(want).all(dim=1)
        sweep_ref = warp_cuda.resample_ym_reference(sweep_frames, sweep_pyr, want, K)
        assert torch.equal(sweep_out.reshape(len(want), -1)[finite],
                           sweep_ref.reshape(len(want), -1)[finite]), f"{layout} sweep crops differ"
        levels = sorted({int(v) for v in want[finite, 0].tolist()})
        swept.append(f"{layout} {len(want)} faces ({int((~finite).sum())} with NaN entries, "
                     f"levels {levels})")

    # crops, raw and xpass_bf16, and the whole call: 640x640 B=16 K=8, 251x317
    err = 0.0
    for f_, m_ in ((frames, Ms), (odd, odd_Ms)):
        pyr_, prm_ = warp_cuda.build_pyramid(f_), warp_cuda.face_params_ym(m_)
        for xbf in (False, True):
            got, table = warp_cuda.resample_ym(f_, pyr_, m_, xbf)
            want = warp_cuda.resample_ym_reference(f_, pyr_, prm_, K, xbf)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            assert table_bits_equal(table, prm_).all(), f"table differs at {tuple(f_.shape[1:3])}"
            d = float((got - want).abs().max())
            err = max(err, d)
            assert torch.equal(got, want), \
                f"y-major crops deviate {d} (xpass_bf16={xbf}, {tuple(f_.shape[1:3])})"
        whole = warp_cuda.warp_affine(f_, m_)
        assert torch.equal(whole, warp_cuda.warp_affine_ym_reference(f_, m_)), "whole call differs"
    pyr, prm = warp_cuda.build_pyramid(frames), warp_cuda.face_params_ym(Ms)
    levels = sorted(set(prm[:, 0].int().tolist()))
    assert levels == [0, 1, 2, 3], levels

    # its path: the counterpart of warp_affine_pallas, default layout
    reset_counts()
    out = warp_cuda.warp_affine(frames, Ms)
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts["warp_ym"] == 1 and counts["warp_xm_pyramid"] == 1, \
        f"warp_affine(layout='ymajor') launches {counts}, want 1 pyramid + 1 warp_ym"
    assert counts["warp_xm"] == 0 and counts["gallery_topk"] == 0, counts
    assert torch.equal(out, warp_cuda.resample_ym(frames, pyr, Ms)[0])
    # every device operation of the call is one of its two kernels: a
    # trace can come back short of an event (runs on an H100 traced 1 of
    # the 2 launches the counters had counted, three single-call traces in
    # a row), so 3 calls are traced in one window: at most 2 operations a
    # call, each a pyramid or warp_ym launch, both seen (or the profiler
    # sees nothing at all)
    names, called = device_trace(lambda: warp_cuda.warp_affine(frames, Ms), calls=3)
    kinds = {"pyramid" if "pyramid_kernel" in n else "warp_ym" if "warp_ym_kernel" in n else n
             for n in names}
    traced = len(names)
    assert traced <= 2 * 3 and (kinds == {"pyramid", "warp_ym"} or not names), \
        f"warp_affine(layout='ymajor') traces {names} ({called} launches called in 3 calls)"

    t_res, t_bf16, t_res_plain, t_bf16_plain, t_all, t_all_plain, t_all_eager, t_res_eager = \
        in_turns(
            graph_timer(lambda: warp_cuda.resample_ym(frames, pyr, Ms)),
            graph_timer(lambda: warp_cuda.resample_ym(frames, pyr, Ms, True)),
            eager_timer(lambda: warp_cuda.resample_ym_reference(
                frames, pyr, warp_cuda.face_params_ym(Ms), K)),
            eager_timer(lambda: warp_cuda.resample_ym_reference(
                frames, pyr, warp_cuda.face_params_ym(Ms), K, True)),
            graph_timer(lambda: warp_cuda.warp_affine(frames, Ms)),
            eager_timer(lambda: warp_cuda.warp_affine_ym_reference(frames, Ms)),
            eager_timer(lambda: warp_cuda.warp_affine(frames, Ms)),
            eager_timer(lambda: warp_cuda.resample_ym(frames, pyr, Ms)),
        )
    n_out = B * K * 112 * 112
    res_bytes = (warp_read_bytes(prm, H, W, K, warp_cuda.YM_WIN_X, warp_cuda.YM_WIN_Y)
                 + Ms.numel() * 4 + prm.numel() * 4 + n_out * 3 * 4)
    res_bound, res_by = bound_ms(res_bytes, n_out * WARP_OPS_PER_PIXEL)
    all_bound, all_by = bound_ms(frames.numel() + pyr.numel() + res_bytes,
                                 5 * pyr.numel() + n_out * WARP_OPS_PER_PIXEL)
    log(f"warp_ym vs plain, bit for bit: kernel table = face_params_ym on the sweeps "
        f"({'; '.join(swept)}) and their finite faces' crops; crops raw and xpass_bf16 and "
        f"the whole warp_affine call (B={B}, K={K}, {H}x{W}, levels {levels}; 2 frames of "
        f"{odd.shape[1]}x{odd.shape[2]}): max|d| {err:.3g} (bar: torch.equal); warp_affine(default "
        f"layout) launches: pyramid {counts['warp_xm_pyramid']}, warp_ym {counts['warp_ym']}; "
        f"device operations traced / kernel launches called in 3 calls: {traced} / {called}, "
        f"each a pyramid or warp_ym launch")
    log(f"warp_ym times (B={B}, K={K}, {H}x{W}, raw f32 unless noted; median of 20, in turns): "
        f"resample kernel (table included) {t_res:.4f} ms | plain (face_params_ym + "
        f"resample_ym_reference) {t_res_plain:.4f} | bound {res_bound:.4f} ({res_by}); "
        f"xpass_bf16 kernel {t_bf16:.4f} ms | plain {t_bf16_plain:.4f}; whole warp_affine "
        f"{t_all:.4f} ms | plain {t_all_plain:.4f} | bound {all_bound:.4f} ({all_by}); eager "
        f"calls between CUDA events (host gaps included): whole call {t_all_eager:.4f} ms, "
        f"resample {t_res_eager:.4f} ms")
    return dict(launches=counts["warp_ym"], max_abs_err=err, ms=t_res, plain_ms=t_res_plain,
                bound_ms=res_bound, bound_by=res_by, library_ms=None)


def _gallery(gen, Q, G, D, dev, dups=0):
    g = torch.nn.functional.normalize(torch.randn(G, D, generator=gen, device=dev), dim=-1)
    q = torch.nn.functional.normalize(torch.randn(Q, D, generator=gen, device=dev), dim=-1)
    if dups:
        perm = torch.randperm(G, generator=gen, device=dev)
        src, dst = perm[:dups // 2], perm[dups // 2: dups]
        g[dst] = g[src]  # each source row now has an exact copy elsewhere
        q[: min(Q, 16)] = g[src[: min(Q, 16)]]  # queries whose top-k ties
    return q, g


def phase_gallery(dev) -> dict:
    """The gallery kernel vs its plain version over k, Q and G; times at
    Q=128, G=100,000."""
    gen = torch.Generator(device=dev).manual_seed(5)
    D = 512
    err, ties, cases = 0.0, {}, 0
    for G in (5, 100_000, 100_003):
        for Q in (1, 128, 300):
            q, g = _gallery(gen, Q, G, D, dev, dups=1_000 if G > 1_000 else 0)
            for k in (1, 5, 32, 100, 512):
                if k > G:
                    continue
                kv, ki = gallery_cuda.gallery_topk_cuda(q, g, k)
                rv, ri = gallery_cuda.gallery_topk_reference(q, g, min(k + 1, G))
                torch.cuda.synchronize()
                # past the last row, a (k+1)-th value no sim can be near
                nxt = rv[:, k] if G > k else torch.full_like(rv[:, 0], -10.0)
                assert kv.shape == ki.shape == (Q, k) and int(ki.max()) < G
                e, n_ties = check_topk(kv, ki, rv[:, :k], ri[:, :k], nxt)
                err = max(err, e)
                ties[(Q, G, k)] = n_ties
                cases += 1
    planted = {key: n for key, n in ties.items() if key[1] > 1_000 and key[0] >= 128}
    assert all(n > 0 for key, n in planted.items() if key[2] >= 5), planted
    # padding never wins (k = G = 5), and self-queries rank first at 1.0
    q5, g5 = _gallery(gen, 3, 5, D, dev)
    kv, ki = gallery_cuda.gallery_topk_cuda(q5, g5 * 0.01, 5)
    assert int(ki.max()) < 5 and torch.isfinite(kv).all()
    assert torch.equal(ki.sort(dim=1).values.cpu(), torch.arange(5).repeat(3, 1).int())
    Q, G = 128, 100_000
    q, g = _gallery(gen, Q, G, D, dev, dups=1_000)
    kv, ki = gallery_cuda.gallery_topk_cuda(g[:8], g, 2)  # (or an exact copy of itself)
    assert (kv[:, 0] >= 1.0 - 1e-5).all() and torch.equal(g[ki[:, 0].long()], g[:8])
    half = torch.full((1,), 0.5, device=dev)
    ms, plain_ms, library_ms, ms_512, eager_5, eager_512 = in_turns(
        graph_timer(lambda: gallery_cuda.gallery_topk_cuda(q, g, 5)),
        eager_timer(lambda: gallery_cuda.gallery_topk_reference(q, g, 5)),
        graph_timer(lambda: torch.topk(torch.addmm(half, q, g.t(), alpha=0.5), 5)),
        graph_timer(lambda: gallery_cuda.gallery_topk_cuda(q, g, 512), reps=2),
        eager_timer(lambda: gallery_cuda.gallery_topk_cuda(q, g, 5)),
        eager_timer(lambda: gallery_cuda.gallery_topk_cuda(q, g, 512)),
    )
    n_bytes = 4 * (Q * D + G * D) + 8 * Q * 5
    # float32-accurate products on the tensor cores: three TF32 passes
    bound, by = bound_ms(n_bytes, 3 * 2 * Q * G * D, PEAK_TF32_OPS_PER_S)
    f32_bound, _ = bound_ms(n_bytes, 2 * Q * G * D)
    log(f"gallery kernel vs plain ({cases} cases: k in 1/5/32/100/512, Q in 1/128/300, G in "
        f"5/100,000/100,003, D={D}, 1,000 planted duplicate rows in the large galleries): sims "
        f"max|d| {err:.3g} (bar 1e-5), indices identical outside 1e-5 near-ties, exact ties in "
        f"ascending index (Q=128, G=100,000: {ties[(128, 100_000, 5)]} at k=5, "
        f"{ties[(128, 100_000, 512)]} at k=512); G=5 k=5 no padding; self-queries first at 1.0")
    log(f"gallery times at Q={Q}, G={G:,}, k=5 (median of 20, in turns): kernel {ms:.4f} ms | "
        f"plain {plain_ms:.4f} ms | library composite topk(addmm) {library_ms:.4f} ms | bound "
        f"{bound:.4f} ms ({by}, 3xTF32 at 495 TFLOP/s; {f32_bound:.4f} ms as f32 CUDA-core "
        f"FMA) | k=512 kernel {ms_512:.4f} ms; eager calls between CUDA events (host gaps "
        f"included): k=5 {eager_5:.4f} ms, k=512 {eager_512:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def phase_auto(dev, G=500_000, Q=4_096) -> int:
    """GalleryBank.search(method="auto") past the 2·10^9 boundary on a
    CUDA bank must stream through the kernel; returns its launches."""
    gen = torch.Generator(device=dev).manual_seed(6)
    D = 512
    q, g = _gallery(gen, Q, G, D, dev)
    bank = GalleryBank(D, device=dev)
    bank.add_batch([f"row{i}" for i in range(G)], g.cpu().numpy())
    del g
    queries = q.cpu().numpy()
    bank.search(queries[:1], 1)  # uploads the bank (cached on its version)
    reset_counts()
    t0 = time.perf_counter()
    names, sims = bank.search(queries, 5, method="auto")
    secs = time.perf_counter() - t0
    launches = read_counts()["gallery_topk"]
    assert launches == 1, f"auto search launched the gallery kernel {launches} times"
    assert len(names) == Q and sims.shape == (Q, 5)
    rv, ri = gallery_cuda.gallery_topk_reference(q[:64], bank._device_feats(), 6)
    idx = torch.tensor([[int(n[3:]) for n in row] for row in names[:64]], device=dev)
    err, _ = check_topk(torch.from_numpy(sims[:64]).to(dev), idx, rv[:, :5], ri[:, :5],
                        rv[:, 5])
    log(f"GalleryBank.search(method='auto') at Q={Q} x G={G:,} (Q·G = {Q * G:.3g} > 2e9, "
        f"bank {G * D * 4 / 1e9:.2f} GB on the card): gallery kernel launches {launches}; "
        f"first 64 rows vs plain: sims max|d| {err:.3g}; one search {secs * 1e3:.1f} ms "
        f"(host clock, queries in and names out)")
    del bank
    torch.cuda.empty_cache()
    return launches


def phase_identify(dev, rng, cfg=None, n_enroll=64, n_bank=10_000, n_req=64):
    """The 1:N identify path at full width through the user entry points;
    returns the FaceDetector and FaceRecognizer it loaded."""
    cfg = cfg or PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    size = cfg.det_input_size
    frames = rng.integers(0, 256, (n_enroll, size, size, 3), dtype=np.uint8)
    det, rec = FaceDetector(cfg, device=dev), FaceRecognizer(cfg, device=dev)
    tree = detection_bias(bridge.init_params_numpy(cfg.scrfd_variant, seed=cfg.seed),
                          torch.from_numpy(frames).to(dev))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "det.npz")
        checkpoint.save_params(path, tree)
        assert det.load_model(path), "FaceDetector.load_model failed"
    assert rec.load_model(), "FaceRecognizer.load_model failed"
    names = [f"person{i:02d}" for i in range(n_enroll)]
    reset_counts()
    t0 = time.perf_counter()
    bank, kept = enroll_batch(det, rec, names, list(frames), device=dev)
    torch.cuda.synchronize()
    enroll_s = time.perf_counter() - t0
    assert kept == names, f"enrolled {len(kept)} of {n_enroll} frames"
    extra = np.random.default_rng(7).normal(size=(n_bank - n_enroll, 512)).astype(np.float32)
    bank.add_batch([f"random{i}" for i in range(len(extra))], extra)
    assert len(bank) == n_bank
    requests = [frames[i % n_enroll] for i in range(n_req)]
    results, rates, lat = {}, {}, {}
    for mode in ("two-dispatch", "fuse_search"):
        kw = dict(max_batch=8, max_faces=8, search_top_k=5, fuse_search=mode == "fuse_search",
                  device=dev)
        warm = IdentifyService(det.params, rec.params, bank, cfg, **kw)
        [f.result(300) for f in [warm.identify_async(im, 5) for im in requests[:16]]]
        warm.close()
        svc = IdentifyService(det.params, rec.params, bank, cfg, **kw)
        t0 = time.perf_counter()
        futs = [svc.identify_async(im, 5) for im in requests]
        results[mode] = [f.result(300) for f in futs]
        wall = time.perf_counter() - t0
        st = svc.stats()
        svc.close()
        rates[mode] = n_req / wall
        lat[mode] = st["latency_ms"]
    counts = read_counts()
    assert counts["warp_xm"] > 0, "the identify path did not launch the warp kernel"
    # one batch of 8 split by hand (the service is closed): host letterbox,
    # dispatch (letterbox included; synchronized), resolve; median of 5
    splits = []
    for _ in range(5):
        batch = [_Request(image=im, top_k=5) for im in requests[:8]]
        t0 = time.perf_counter()
        for r in batch:
            svc._letterbox(r.image)
        t1 = time.perf_counter()
        ctx = svc._dispatch(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        svc._resolve(ctx)
        t3 = time.perf_counter()
        splits.append(((t1 - t0) * 1e3, (t2 - t1 - (t1 - t0)) * 1e3, (t3 - t2) * 1e3))
    lb_ms, disp_ms, res_ms = (statistics.median(x) for x in zip(*splits))
    sim_err, exact = 0.0, 0
    for a, b in zip(results["two-dispatch"], results["fuse_search"]):
        assert np.array_equal(a.valid, b.valid) and a.valid[0], "slot 0 empty or masks differ"
        sim_err = max(sim_err, float(np.abs(a.sims - b.sims).max()))
        exact += a.names == b.names
        for j in np.nonzero(a.valid)[0]:
            gaps = np.abs(np.diff(a.sims[j])) > 1e-5  # near-ties may swap
            clear = np.concatenate([[True], gaps]) & np.concatenate([gaps, [True]])
            assert [n for n, c in zip(a.names[j], clear) if c] == \
                [n for n, c in zip(b.names[j], clear) if c], (a.names[j], b.names[j])
        assert a.sims[0, 0] >= 0.99, f"a request's top-1 sim is {a.sims[0, 0]}"
    assert sim_err <= 1e-3, sim_err
    top1 = min(float(r.sims[0, 0]) for r in results["two-dispatch"])
    log(f"identify path (SCRFD-500m {size} + {cfg.rec_arch} {cfg.compute_dtype}, enroll "
        f"{n_enroll} frames in "
        f"{enroll_s:.2f} s, bank {len(bank):,} rows; IdentifyService max_batch=8, "
        f"max_faces=8, search_top_k=5, {n_req} concurrent requests): two-dispatch "
        f"{rates['two-dispatch']:.1f} req/s p50 {lat['two-dispatch']['p50']} ms p99 "
        f"{lat['two-dispatch']['p99']} ms | fuse_search {rates['fuse_search']:.1f} req/s "
        f"p50 {lat['fuse_search']['p50']} ms p99 {lat['fuse_search']['p99']} ms; modes: "
        f"{exact}/{n_req} identical name lists (the rest differ only inside 1e-5 "
        f"near-ties), sims max|d| {sim_err:.3g} (bar 1e-3); top-1 sim min {top1:.5f} "
        f"(bar 0.99); one fuse_search batch of 8 by hand: host letterbox {lb_ms:.2f} ms, "
        f"dispatch less letterbox {disp_ms:.2f} ms, resolve {res_ms:.2f} ms (median of 5); "
        f"launches {counts}")
    return det, rec


def camera_frames(rng, n, h=720, w=1280):
    """n (h, w, 3) frames of noise whose letterbox to 640 keeps the
    statistics the detections recipe was set on: each is a (h/2, w/2)
    noise image repeated 2x2, which the letterbox's exact 0.5 scale
    samples back."""
    small = rng.integers(0, 256, (n, h // 2, w // 2, 3), dtype=np.uint8)
    return [np.repeat(np.repeat(f, 2, axis=0), 2, axis=1) for f in small]


def names_outside_ties(a, b, dev):
    """Per valid slot, the positions where `a` and `b` must hold the same
    name when each name's sim moved by at most `dev`: those whose sims lie
    more than 2·dev from both neighbours in `a`, the last position only if
    nothing ranked below it could pass it (it is never sure). Returns
    (positions checked, positions equal)."""
    checked = equal = 0
    for j in np.nonzero(a.valid)[0]:
        gaps = np.abs(np.diff(a.sims[j])) > 2 * dev
        clear = np.concatenate([[True], gaps]) & np.concatenate([gaps, [False]])
        for p in np.nonzero(clear)[0]:
            checked += 1
            equal += a.names[j][p] == b.names[j][p]
    return checked, equal


def phase_native_bucketed(dev, rng, det, rec, frames, api, cfg=None, camera_hw=(720, 1280),
                          n_req=64) -> dict:
    """The native host runtime, the bucketed embed at full width, the
    adaptive service and the video pipeline (module docstring, phase 10)."""
    cfg = cfg or PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    size = cfg.det_input_size
    B, K, CAP = frames.shape[0], 8, 2
    out = {}

    # ---- the native runtime (built in phase 2)
    assert native.native_available(), "the native runtime did not build (g++)"
    codecs = native.codecs_available()
    for hw in ((720, 1280), (251, 317), (16, 77)):
        img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        got, scale = native.letterbox_native(img, 640)
        want, want_scale = letterbox_numpy(img, 640)
        assert np.array_equal(got, want) and scale == want_scale, f"letterbox differs at {hw}"
    img = rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    nat_ms, torch_ms = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        native.letterbox_native(img, 640)
        t1 = time.perf_counter()
        letterbox(torch.from_numpy(img), 640)[0].numpy().astype(np.uint8)
        t2 = time.perf_counter()
        nat_ms.append((t1 - t0) * 1e3)
        torch_ms.append((t2 - t1) * 1e3)
    out["letterbox_ms"] = (statistics.median(nat_ms), statistics.median(torch_ms))
    codec_note = "not run: the library built without codecs (no libjpeg / libpng here)"
    if codecs:
        small = rng.integers(0, 256, (6, 61, 83, 3), dtype=np.uint8)
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for i, im in enumerate(small):
                paths.append(os.path.join(tmp, f"im{i}.png"))
                with open(paths[-1], "wb") as f:
                    f.write(png_bytes(im))
            with open(paths[0], "rb") as f:
                assert np.array_equal(native.decode_native(f.read()), small[0][..., ::-1])
            with native.NativeImageLoader(paths, 64, threads=2) as loader:
                got = {i: (fr, sc) for i, fr, sc in loader}
        assert sorted(got) == list(range(len(paths)))
        for i, im in enumerate(small):
            want, sc = letterbox_numpy(np.ascontiguousarray(im[..., ::-1]), 64)
            assert np.array_equal(got[i][0], want) and got[i][1] == sc, f"loader item {i}"
        codec_note = "PNG decode and the threaded loader (6 files) equal the transcription"
    log(f"native runtime ({native._load()._name}): codecs_available() "
        f"{codecs}; letterbox = letterbox_numpy bit for bit at 720x1280, 251x317, 16x77; "
        f"{codec_note}; one 720x1280 frame to 640 (median of 20, host clock): native "
        f"{out['letterbox_ms'][0]:.3f} ms, torch host letterbox {out['letterbox_ms'][1]:.3f} ms")

    # ---- the bucketed embed at full width, 2/8 occupancy
    with torch.no_grad():
        dense = frames_to_features(det, rec, frames, cfg, K, valid_cap=CAP)
    pipe = bucketed.BucketedEmbedPipeline(det, rec, cfg, K, valid_cap=CAP, device=dev)
    pipe(frames)  # the first step guesses full occupancy
    reset_counts()
    dets, feats, n = pipe(frames)
    torch.cuda.synchronize()
    step_counts = read_counts()
    assert step_counts["warp_xm"] == step_counts["warp_xm_pyramid"] == 1, step_counts
    assert step_counts["nms_greedy"] == 1, step_counts
    assert n == B * CAP and pipe.last_bucket == 32 and pipe.corrections == 0, \
        (n, pipe.last_bucket, pipe.corrections)
    for a, b in zip(dets, dense[0]):
        assert torch.equal(a, b), "bucketed detections differ from the dense path's"
    slot = torch.arange(K, device=dev)[None, :].expand(B, K) < CAP
    assert (feats[~slot] == 0).all() and (dense[1][~slot] == 0).all()
    cos = float((feats * dense[1]).sum(-1)[slot].min())
    with torch.no_grad():
        _, crops_c, perm, valid_flat, _ = bucketed.detect_and_compact(det, frames, cfg, K,
                                                                      valid_cap=CAP)
        # the same 16 crops embedded in a batch of 32 and of 64: what the
        # batch shape alone moves in bfloat16 (cuDNN / cuBLAS pick their
        # kernels per shape, and the embed rounds to bf16 at every layer)
        n_valid = B * CAP
        alone = embed_crops(rec, crops_c[:32], cfg, normalized=True)[:n_valid]
        in64 = embed_crops(rec, crops_c, cfg, normalized=True)[:n_valid]
        shape_cos = float((alone * in64).sum(-1).min())
        # a bucket short of the valid crops: the crops beyond it get zeros
        short = bucketed.embed_compacted(rec, crops_c, perm, valid_flat, cfg, K, 8)
    assert (short.reshape(B * K, -1)[perm[8:]] == 0).all()
    assert (short.reshape(B * K, -1)[perm[:8]].norm(dim=-1) > 0.99).all()
    # float32 (TF32 off): the bucketed path equals the dense one to
    # tests/test_bucketed.py's 1e-5; bfloat16: cosine >= 0.999, the bar the
    # main path holds bf16 features to (phase 5)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    pipe32 = bucketed.BucketedEmbedPipeline(det, rec, f32, K, valid_cap=CAP, device=dev)
    with tf32_off():
        pipe32(frames)
        _, feats32, _ = pipe32(frames)
        with torch.no_grad():
            dense32 = frames_to_features(det, rec, frames, f32, K, valid_cap=CAP)[1]
    err32 = float((feats32 - dense32).abs().max())
    assert pipe32.last_bucket == 32 and err32 <= 1e-5, (pipe32.last_bucket, err32)
    assert cos >= 0.999, f"bucketed vs dense bf16 features: cosine {cos}"
    with torch.no_grad():
        bucket_ms = wall_ms(lambda: pipe(frames))
        dense_ms = wall_ms(lambda: frames_to_features(det, rec, frames, cfg, K, valid_cap=CAP))
    pipe.valid_cap = None  # a spike to the detector's own occupancy
    _, feats_full, n_full = pipe(frames)
    with torch.no_grad():
        dense_full = frames_to_features(det, rec, frames, cfg, K)[1]
    full = torch.linalg.vector_norm(dense_full, dim=-1) > 0
    assert n_full > 32 and pipe.corrections == 1 and pipe.last_bucket == 64, \
        (n_full, pipe.corrections, pipe.last_bucket)
    cos_full = float((feats_full * dense_full).sum(-1)[full].min())
    assert cos_full >= 0.9999, cos_full
    out["bucket"] = (bucket_ms, dense_ms)
    log(f"bucketed embed (SCRFD-500m {size} + {cfg.rec_arch} {cfg.compute_dtype}, B={B}, K={K}, "
        f"valid_cap={CAP}: "
        f"{n}/{B * K} slots): bucket {32} (default buckets {bucketed.default_buckets(B * K)}), "
        f"launches per step {step_counts}; detections equal the dense path's; features vs "
        f"dense: float32 max|d| {err32:.3g} (bar 1e-5), bfloat16 cosine min {cos:.6f} (bar "
        f"0.999; the same crops in batches of 32 and 64: {shape_cos:.6f}), other slots zero; "
        f"a bucket of 8 under 16 valid crops "
        f"zeroes the 8 beyond it; spike to {n_full} faces: corrections "
        f"{pipe.corrections}, bucket {pipe.last_bucket}, cosine vs dense {cos_full:.6f}; step "
        f"(median of 10, wall, synchronized): bucketed {bucket_ms:.3f} ms, dense "
        f"{dense_ms:.3f} ms at the same occupancy | card: {nvidia_smi()}")

    # ---- the adaptive service on 720x1280 requests (native letterbox)
    face_det, face_rec = api
    images = camera_frames(rng, n_req, *camera_hw)
    names = [f"cam{i:02d}" for i in range(n_req)]
    # enrolled as the service sees them (the warp kernels take frames up
    # to 640x640, as the reference's do): each frame's top face finds itself
    boxed = [native.letterbox_native(im, size)[0] for im in images]
    bank, kept = enroll_batch(face_det, face_rec, names, boxed, device=dev)
    assert len(kept) == n_req, f"enrolled {len(kept)} of {n_req} camera frames"
    extra = np.random.default_rng(8).normal(size=(1_000, 512)).astype(np.float32)
    bank.add_batch([f"random{i}" for i in range(len(extra))], extra)
    results, service = {}, {}
    for fuse in (False, True):
        for adaptive in (False, True):
            kw = dict(max_batch=8, max_faces=K, search_top_k=5, fuse_search=fuse,
                      adaptive_embed=adaptive, valid_cap=CAP, device=dev)
            warm = IdentifyService(face_det.params, face_rec.params, bank, cfg, **kw)
            [f.result(300) for f in [warm.identify_async(im, 5) for im in images[:16]]]
            warm.close()
            svc = IdentifyService(face_det.params, face_rec.params, bank, cfg, **kw)
            t0 = time.perf_counter()
            futs = [svc.identify_async(im, 5) for im in images]
            results[fuse, adaptive] = [f.result(300) for f in futs]
            wall = time.perf_counter() - t0
            service[fuse, adaptive] = (n_req / wall, svc.stats()["latency_ms"])
            svc.close()
        sim_err, checked, equal = 0.0, 0, 0
        for i, (a, b) in enumerate(zip(results[fuse, True], results[fuse, False])):
            assert np.array_equal(a.valid, b.valid) and a.valid[0], "masks differ"
            assert np.allclose(a.boxes, b.boxes, atol=1e-3), "boxes differ"
            # each request's top face was enrolled under its own name
            assert a.names[0][0] == b.names[0][0] == names[i], (i, a.names[0], b.names[0])
            sim_err = max(sim_err, float(np.abs(a.sims - b.sims).max()))
            c, e = names_outside_ties(b, a, 2.24e-2)
            checked, equal = checked + c, equal + e
        # |Δsim| <= |Δf| / 2 = 2.24e-2 at the bucketed check's cosine bar 0.999
        assert sim_err <= 2.24e-2 and equal == checked, (sim_err, equal, checked)
        same = sum(a.names == b.names for a, b in zip(results[fuse, True], results[fuse, False]))
        out["service", fuse] = (service[fuse, True], service[fuse, False], same, sim_err)
        mode = "fuse_search" if fuse else "two-dispatch"
        (ra, la), (rd, ld) = service[fuse, True], service[fuse, False]
        log(f"IdentifyService {mode}, {n_req} concurrent {camera_hw[0]}x{camera_hw[1]} requests "
            f"(native letterbox to {size}), "
            f"max_batch=8, K={K}, valid_cap={CAP}, bank {len(bank):,} rows: adaptive "
            f"{ra:.1f} req/s p50 {la['p50']} p99 {la['p99']} ms | dense {rd:.1f} req/s p50 "
            f"{ld['p50']} p99 {ld['p99']} ms; every slot-0 top-1 is the request's own enrolled "
            f"name in both; name lists {same}/{n_req} identical, and equal on all {checked} "
            f"positions clear of near-ties (sims > 4.48e-2 apart); sims max|d| {sim_err:.3g} "
            f"(bar 2.24e-2) | card: {nvidia_smi()}")

    # ---- the video pipeline, dense and adaptive
    ref = bank.features[0]
    runs = {}
    for adaptive in (False, True):
        video = VideoPipeline(face_det.params, face_rec.params, cfg, batch=8,
                              max_faces_embed=K, adaptive_embed=adaptive, device=dev)
        runs[adaptive] = list(video.run(iter(images[:16]), ref_feature=ref))
    assert len(runs[False]) == len(runs[True]) == 16
    near, n_faces, n_match = 0, 0, 0
    for d, a in zip(runs[False], runs[True]):
        assert np.array_equal(d[1].valid, a[1].valid), "video masks differ"
        sims = (d[2] @ ref + 1.0) / 2.0
        for k, (ld, la) in enumerate(zip(d[3], a[3])):
            if abs(sims[k] - cfg.match_threshold) <= 2.24e-2 and ld:
                near += 1  # within the bf16 bar of the threshold: may flip
            else:
                assert ld == la, (d[0], k, ld, la, sims[k])
        n_faces += sum(1 for x in d[3] if x)
        n_match += d[3].count("Match")
    assert runs[False][0][3][0] == "Match", runs[False][0][3]
    sims_all = np.concatenate([(d[2][d[1].valid[:K]] @ ref + 1.0) / 2.0 for d in runs[False]])
    log(f"VideoPipeline over 16 camera frames (batch 8, K={K}), dense and adaptive: masks "
        f"equal, labels equal on {n_faces - near} of {n_faces} faces ({near} within 2.24e-2 "
        f"of the {cfg.match_threshold} threshold); {n_match} Match against frame 0's enrolled "
        f"face; sims to it min {sims_all.min():.4f} median {np.median(sims_all):.4f}")

    cams = [torch.from_numpy(np.stack(boxed[i:i + 8])).to(dev) for i in range(0, n_req, 8)]
    hist = nms_plain_histogram([(det, frames)] + [(face_det.params, c) for c in cams], cfg)
    log(f"NMS fixpoint iterations per call of the plain version (nms_greedy_reference) on the "
        f"candidates of phase 5's frames and of the {n_req} letterboxed camera frames, in "
        f"batches of 8 (iterations: calls): {hist}; the path runs csrc/nms_greedy.cu, one "
        f"greedy scan with no host read")
    out["nms_hist"] = hist
    return out


# crops of the batch whose int32 accumulators are held against the int64
# plain version, which runs on the host (IResNet-50: ~3 GMAC a crop)
N_ACC_CROPS = 2
FAMILIES = [
    # (label, pack, quant, scrfd_variant, rec_arch): a pack through
    # load_pack, or the detector and recognizer through their load_model;
    # buffalo_sc (phase 5's models) first: the phase's own baseline
    ("buffalo_sc", "buffalo_sc", None, None, None),
    ("buffalo_l", "buffalo_l", None, None, None),
    ("buffalo_m", "buffalo_m", None, None, None),
    ("buffalo_s", "buffalo_s", None, None, None),
    ("buffalo_sc w8a8", "buffalo_sc", "w8a8", None, None),
    ("buffalo_s w8a8-fast", "buffalo_s", "w8a8-fast", None, None),
    ("tpu + iresnet50", None, None, "tpu", "iresnet50"),
    ("500m_s2d + iresnet50", None, None, "500m_s2d", "iresnet50"),
    ("500m + mbf_large", None, None, "500m", "mbf_large"),
    ("500m + vit_t", None, None, "500m", "vit_t"),
]


def load_family(dev, pack, quant_opt, variant, arch):
    """(FaceDetector, FaceRecognizer) of one configuration, seeded weights."""
    if pack:
        return packs.load_pack(pack, quant=quant_opt, device=dev)
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda",
                         scrfd_variant=variant, rec_arch=arch)
    det, rec = FaceDetector(cfg, device=dev), FaceRecognizer(cfg, device=dev)
    assert det.load_model() and rec.load_model(), "load_model failed"
    return det, rec


def paired_slots(d_a, d_b, K, tol=4.0):
    """(How many valid top-K slots of `d_a` have a detection of `d_b` in
    the same frame, any of its valid rows, with every box coordinate
    within `tol` pixels; the largest such distance among them). Boxes by
    coordinates, not IoU: random-weight regressions give inverted boxes."""
    n, worst = 0, 0.0
    for f in range(d_a.valid.shape[0]):
        a = d_a.boxes[f, :K][d_a.valid[f, :K]].float()
        b = d_b.boxes[f][d_b.valid[f]].float()
        if len(a) == 0 or len(b) == 0:
            continue
        dist = (a[:, None] - b[None]).abs().amax(-1).amin(-1)
        near = dist <= tol
        n += int(near.sum())
        if near.any():
            worst = max(worst, float(dist[near].max()))
    return n, worst


def int_mm_reference_threads(a, w, n=8):
    """`quant.int_mm_reference` over n row blocks on n host threads (the
    int64 matmul runs on one core and lets go of the GIL)."""
    with ThreadPoolExecutor(n) as pool:
        return torch.cat(list(pool.map(lambda blk: quant.int_mm_reference(blk, w), a.chunk(n))))


def check_int8_accumulators(rec_model, crops):
    """One forward of the quantized recognizer over `crops`: every QConv's
    and QLinear's int32 accumulator from torch._int_mm on the card equal,
    bit for bit, to the int64 plain version on the host. Returns the
    number of ops checked."""
    checked = []

    def hook(mod, args):
        xq = quant.quantize_act(args[0], mod.in_scale)
        w_host = mod.w_q.cpu()
        before = quant.int_mm.launches
        if isinstance(mod, quant.QConv):
            acc = mod.accumulate(xq)
            ref = quant.conv_int32(xq.cpu(), w_host, mod.kh, mod.kw, mod.stride, mod.padding,
                                   int_mm_reference_threads)
        else:
            acc = quant.int_mm(xq, mod.w_q)
            ref = int_mm_reference_threads(xq.cpu(), w_host)
        assert quant.int_mm.launches == before + 1, "the accumulator did not come from _int_mm"
        assert torch.equal(acc.cpu(), ref), \
            f"_int_mm accumulator differs from the plain version in {type(mod).__name__}"
        checked.append(mod)

    ops = [m for m in rec_model.modules() if isinstance(m, (quant.QConv, quant.QLinear))]
    hooks = [m.register_forward_pre_hook(hook) for m in ops]
    try:
        with torch.no_grad():
            embed_crops(rec_model, crops, PipelineConfig(), normalized=True)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    assert len(checked) == len(ops), (len(checked), len(ops))
    return len(checked)


def phase_families(dev, frames, bank, n_rows, K, top_k, smi):
    """The model families at full width through frames_to_matches (phase
    11 of the module docstring)."""
    B = frames.shape[0]
    rows = []
    for label, pack, quant_opt, variant, arch in FAMILIES:
        t_cfg = time.perf_counter()
        det, rec = load_family(dev, pack, quant_opt, variant, arch)
        bias_detector(det, frames)
        cfg = dataclasses.replace(det.cfg, compute_dtype="bfloat16", warp_impl="cuda")

        def run(c, rec_model=rec.params):
            return frames_to_matches(det.params, rec_model, frames, bank, n_rows, c, K, top_k)

        with torch.no_grad():
            reset_counts()
            quant.int_mm.launches = 0
            dets, feats, sims, idx = run(cfg)
            torch.cuda.synchronize()
            counts, mm = read_counts(), quant.int_mm.launches
            assert counts == {"warp_xm": 1, "warp_xm_pyramid": 1, "warp_ym": 0,
                              "gallery_topk": 0, "nms_greedy": 1}, (label, counts)
            assert (mm > 0) == bool(quant_opt), (label, mm)
            slot_valid = dets.valid[:, :K]
            assert slot_valid.any(dim=-1).all(), f"{label}: a frame found no faces"
            check_features(feats, slot_valid, n_rows, idx)
            assert feats.shape == (B, K, 512) and sims.shape == idx.shape == (B, K, top_k)
            # the step's crops (its detections, the kernel's warp)
            _, top = detect_topk(det.params, frames, cfg, K)
            assert torch.equal(top.boxes, dets.boxes[:, :K]), f"{label}: detections moved"
            crops = align_faces_batch(frames, top.kps, top.boxes, cfg, top.valid, True)
            crops = crops.reshape(B * K, 112, 112, 3)
            if quant_opt:
                # the same pack unquantized, bf16: the same detections; every
                # int32 accumulator of one batch against the plain version;
                # the quantized features against its bf16 ones on the step's
                # crops (recorded) and on crops of the calibration's kind,
                # uniform noise as tests/test_quant.py (bar 0.97)
                ref = FaceRecognizer(dataclasses.replace(rec.cfg, recognizer_quant="none"),
                                     device=dev)
                assert ref.load_model()
                rdets, rfeats, _, _ = run(cfg, ref.params)
                assert torch.equal(rdets.valid, dets.valid), f"{label}: detections differ"
                assert torch.equal(rdets.boxes, dets.boxes), f"{label}: detections differ"
                n_ops = check_int8_accumulators(rec.params, crops[:N_ACC_CROPS])
                step_cos = (feats * rfeats).sum(-1)[slot_valid]
                noise = torch.from_numpy(np.random.default_rng(1).integers(
                    0, 256, (B * K, 112, 112, 3), dtype=np.uint8)).to(dev)
                noise_cos = float((embed_crops(rec.params, noise, cfg)
                                   * embed_crops(ref.params, noise, cfg)).sum(-1).min())
                assert noise_cos >= 0.97, f"{label}: quantized vs bf16 cosine {noise_cos}"
                detail = (f"detections equal the unquantized pack's; {n_ops} int32 "
                          f"accumulators of one batch of {N_ACC_CROPS} crops bit-equal to the "
                          f"int64 plain version; quantized vs bf16 features cosine min "
                          f"{noise_cos:.5f} on {B * K} noise crops (bar 0.97), on the step's "
                          f"crops min {float(step_cos.min()):.5f} median "
                          f"{float(step_cos.median()):.5f} (recorded); {mm} _int_mm "
                          f"launches per step")
                del ref
            else:
                # the same models in float32 (TF32 off): the detector's
                # detections against the bf16 step's by box; the recognizer
                # on the step's crops against its bf16 features
                with tf32_off():
                    d32 = detect_topk(det.params, frames,
                                      dataclasses.replace(cfg, compute_dtype="float32"), K)[0]
                    f32 = embed_crops(rec.params, crops, cfg, torch.float32, normalized=True)
                torch.cuda.synchronize()
                paired, worst = paired_slots(dets, d32, K)
                n_valid = int(slot_valid.sum())
                same = sum(torch.equal(dets.valid[f], d32.valid[f]) for f in range(B))
                assert paired >= 0.75 * n_valid, f"{label}: {paired}/{n_valid} paired"
                cos = float((feats * f32.reshape(B, K, -1)).sum(-1)[slot_valid].min())
                assert cos >= 0.999, f"{label}: bf16 vs float32 feature cosine {cos}"
                detail = (f"float32 detector: {same}/{B} frames with equal masks, "
                          f"{paired}/{n_valid} bf16 slots with a float32 detection within "
                          f"4 px (farthest {worst:.2f} px); bf16 vs "
                          f"float32 features on the step's crops cosine min {cos:.6f} "
                          f"(bar 0.999)")
            step_ms = wall_ms(lambda: run(cfg))
            ops = device_ops(lambda: run(cfg))
        rows.append(dict(config=label, step_ms=step_ms, faces_per_s=B * K / step_ms * 1e3,
                         device_ops=ops[0], launches_called=ops[1]))
        log(f"family {label} ({det.cfg.scrfd_variant} + {rec.cfg.rec_arch}, B={B}, K={K}, "
            f"{frames.shape[1]}x{frames.shape[2]}, bf16): {int(slot_valid.sum())}/{B * K} slots, "
            f"launches per step "
            f"{counts}; {detail}; step (median of 10) {step_ms:.3f} ms = "
            f"{B * K / step_ms * 1e3:.1f} faces/s; device operations {ops[0]} traced / "
            f"{ops[1]} launched; {time.perf_counter() - t_cfg:.1f} s | card: {smi}")
        del det, rec
        torch.cuda.empty_cache()
    return rows


def _cli_json(argv):
    """One in-process CLI run with --json: (the parsed stdout, which must
    be exactly one JSON document, wall s). Human output is kept aside and
    shown only if the run fails."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main.main(argv + ["--json"])
    wall = time.perf_counter() - t0
    assert rc == 0, (argv, rc, err.getvalue()[-3000:])
    return json.loads(out.getvalue()), wall


# A frame's bf16 features on the card depend on its row in the batch (up
# to 6.48e-4 max|d| between two rows, bit-equal in the same row whatever
# the other frames: tools/diag_serving_determinism.py), and a server
# coalesces requests into rows by their timing; so sims are held to
# 1e-3 > |Δf|/2 + the payload's rounding (5e-5), and names where sims
# stand further than twice that apart
SERVED_SIM_BAR = 1e-3


def _same_faces(got, want, where, bar=SERVED_SIM_BAR):
    """Two face lists of the payload (`/identify`, the stream, or an
    IdentifyResult through `_faces_payload`): the same faces and boxes
    (rounded to 0.01 px), the top-1 name equal, the other names equal
    where the sims are clear of near-ties, sims within `bar`. Returns
    max |Δsim|."""
    assert len(got) == len(want) > 0, (where, len(got), len(want))
    err = 0.0
    for g, w in zip(got, want):
        assert np.abs(np.asarray(g["box"]) - w["box"]).max() <= 0.011, (where, g["box"], w["box"])
        ws = np.asarray(w["sims"])
        err = max(err, float(np.abs(np.asarray(g["sims"]) - ws).max()))
        gaps = np.abs(np.diff(ws)) > 2 * bar
        clear = np.concatenate([[True], gaps]) & np.concatenate([gaps, [True]])
        clear[0] = True
        assert [n for n, c in zip(g["names"], clear) if c] == \
            [n for n, c in zip(w["names"], clear) if c], (where, g["names"], w["names"])
    assert err <= bar, (where, err)
    return err


def phase_serving(dev, rng, det, rec, video_hw=(480, 640), cli_args=()):
    """The serving surface (module docstring, phase 12): the HTTP server and
    client, the tracker, the CLI in-process and `serve` in its own process.
    video_hw: the tracker's and the webcam's frame size; cli_args: flags
    added to every CLI run (a rehearsal on the CPU passes --cpu and small
    sizes)."""
    cfg = det.cfg
    size, n_bank, top_k = cfg.det_input_size, 1_000, 5
    t_phase = time.perf_counter()

    # ---- (a) HTTP: make_server + IdentifyClient
    frames = rng.integers(0, 256, (68, size, size, 3), dtype=np.uint8)
    bank, kept = enroll_batch(det, rec, [f"person{i:02d}" for i in range(64)], list(frames[:64]),
                              device=dev)
    assert len(kept) == 64, f"enrolled {len(kept)} of 64 frames"
    extra = np.random.default_rng(9).normal(size=(n_bank - 64, 512)).astype(np.float32)
    bank.add_batch([f"random{i}" for i in range(len(extra))], extra)
    pngs = [png_bytes(np.ascontiguousarray(f[..., ::-1])) for f in frames]
    token = "chip-smoke"
    reset_counts()
    server = make_server(det, rec, bank, port=0, auth_token=token, device=dev)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_address[1]
        client = IdentifyClient("127.0.0.1", port, token=token, timeout=300)
        assert client.healthz() == {"status": "ok", "gallery_size": n_bank}
        try:
            IdentifyClient("127.0.0.1", port, timeout=60).healthz()
            raise AssertionError("a request without the token was answered")
        except ServiceError as e:
            assert e.status == 401, e.status
        for i in range(64, 68):  # 4 new names, enrolled from PNG bytes
            assert client.enroll(f"new{i}", pngs[i])["enrolled"], i
        assert len(bank) == n_bank + 4
        probes = list(range(60, 68))  # 4 enrolled at start, 4 over HTTP
        order = [probes[i % len(probes)] for i in range(32)]

        def ask(i):
            t0 = time.perf_counter()
            faces = client.identify(pngs[i], top_k=top_k)
            return faces, (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(ask, order))
        http_wall = time.perf_counter() - t0
        stream_frames = [probes[i % len(probes)] for i in range(16)]
        lines = list(client.identify_stream((pngs[i] for i in stream_frames), top_k=top_k))
        # the same decoded images through the server's IdentifyService in process
        images = [decode_image(pngs[i]) for i in order]
        assert all(np.array_equal(im, frames[i]) for im, i in zip(images, order))
        svc = server.frt_service
        done = {}
        t0 = time.perf_counter()
        futs = [svc.identify_async(im, top_k) for im in images]
        for j, f in enumerate(futs):
            f.add_done_callback(lambda _, j=j: done.__setitem__(j, time.perf_counter()))
        results = [f.result(300) for f in futs]
        svc_wall = time.perf_counter() - t0
        svc_lat = np.array([(done[j] - t0) * 1e3 for j in range(len(futs))])
        http_err = stream_err = 0.0
        for j, ((faces, _), res) in enumerate(zip(answers, results)):
            want = _faces_payload(res, top_k)
            http_err = max(http_err, _same_faces(faces, want, f"/identify {j}"))
            name = f"person{order[j]:02d}" if order[j] < 64 else f"new{order[j]}"
            assert faces[0]["names"][0] == name, (j, faces[0]["names"], name)
        assert [x["frame"] for x in lines] == list(range(16)), "stream out of order"
        for x, i in zip(lines, stream_frames):
            stream_err = max(stream_err, _same_faces(
                x["faces"], answers[order.index(i)][0], f"stream frame {x['frame']}"))
        # one request at a time: each frame is row 0 of its own batch on both
        # sides, so the served sims equal the service's up to the payload's
        # rounding to 4 places; their latencies split off the HTTP layer's
        # share (PNG decode, JSON, sockets) of one request
        seq_err, seq_http, seq_svc = 0.0, [], []
        for i in probes:
            t0 = time.perf_counter()
            want = _faces_payload(svc.identify(decode_image(pngs[i]), top_k), top_k)
            t1 = time.perf_counter()
            got = client.identify(pngs[i], top_k=top_k)
            seq_svc.append((t1 - t0) * 1e3)
            seq_http.append((time.perf_counter() - t1) * 1e3)
            seq_err = max(seq_err, _same_faces(got, want, f"sequential /identify {i}", bar=1e-4))
        removed = client.remove("new64")
        assert removed["removed"] == 1 and removed["gallery_size"] == n_bank + 3
        faces = client.identify(pngs[64], top_k=top_k)
        assert faces and "new64" not in faces[0]["names"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/metrics", headers={"Authorization": f"Bearer {token}"})
        resp = conn.getresponse()
        metrics = resp.read().decode()
        conn.close()
        assert resp.status == 200 and f"frt_gallery_size {n_bank + 3}" in metrics
        assert 'frt_latency_ms{quantile="0.99"}' in metrics
    finally:
        server.shutdown()
        server.server_close()
        server.frt_service.close()
    http_counts = read_counts()
    assert http_counts["warp_xm"] > 0, "the HTTP path did not launch the warp kernel"
    http_lat = np.array([ms for _, ms in answers])
    log(f"HTTP serving (make_server, SCRFD-500m {size} + {cfg.rec_arch} {cfg.compute_dtype}, "
        f"bank {n_bank:,} rows + 4 enrolled over HTTP from PNG bytes, Bearer auth, max_batch=8, "
        f"top_k={top_k}): healthz, 401 without the token, 32 /identify from 8 client threads: "
        f"{32 / http_wall:.1f} req/s, p50 {np.percentile(http_lat, 50):.1f} ms p99 "
        f"{np.percentile(http_lat, 99):.1f} ms (client clock) | the same 32 decoded images "
        f"through the server's IdentifyService in process: {32 / svc_wall:.1f} req/s, p50 "
        f"{np.percentile(svc_lat, 50):.1f} ms p99 {np.percentile(svc_lat, 99):.1f} ms; payloads "
        f"vs the service's answers: faces and boxes equal, names equal clear of near-ties, "
        f"sims max|d| {http_err:.3g} (bar {SERVED_SIM_BAR:g}: a frame's row in the batch moves "
        f"bf16 features); {len(probes)} sent one at a time, each row 0 of its own batch as in "
        f"process: sims max|d| {seq_err:.3g} (bar 1e-4), median ms HTTP "
        f"{np.median(seq_http):.1f} | in process (decode included) {np.median(seq_svc):.1f}; "
        f"each probe's top-1 its own name; a 16-frame identify_stream in frame order vs the "
        f"/identify answers: sims max|d| {stream_err:.3g}; DELETE new64 then "
        f"absent; /metrics scraped; launches {http_counts} | card: {nvidia_smi()}")

    # ---- (b) the tracker: 4 scenes of the VideoSource recipe, 8 frames each
    vh, vw = video_hw
    scenes = list(VideoSource(f"synthetic:{vw}x{vh}x4").frames())
    video = [scenes[i // 8] for i in range(32)]
    first = det.detect(video[0])
    assert first, "the tracker's first frame has no face"
    ref = rec.extract_feature(video[0], first[0])
    runs = {}
    for adaptive in (False, True):
        pipe = TrackingVideoPipeline(det.params, rec.params, cfg, batch=4, refresh_every=8,
                                     adaptive_embed=adaptive, device=dev)
        embed, dispatches = pipe._embed, []

        def counted(x, n, embed=embed, dispatches=dispatches):
            dispatches.append(n)
            return embed(x, n)

        pipe._embed = counted
        reset_counts()
        t0 = time.perf_counter()
        out = [(i, {k: v.copy() for k, v in d.items()},
                [None if t is None else (t.track_id, t.label) for t in tracks])
               for i, d, tracks in pipe.run(iter(video), ref_feature=ref)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        st = pipe.stats()
        assert len(out) == 32 and st["total_frames"] == 32, st
        assert 0 < st["embed_frames"] < st["total_frames"], st
        assert counts["warp_xm"] == counts["warp_xm_pyramid"] == len(dispatches) > 0, \
            (counts, dispatches)
        assert pipe.slot_mismatches == 0, \
            f"{pipe.slot_mismatches} refresh slots hold another face than the detect-only run's"
        ids = [sorted(t[0] for t in slots if t is not None) for _, _, slots in out]
        assert all(ids[i] == ids[0] for i in range(8)) and ids[0], "track ids did not persist"
        runs[adaptive] = (out, st, wall, len(dispatches), sum(dispatches), counts)
    near = n_labels = 0
    for (_, d, ds), (_, a, as_) in zip(runs[False][0], runs[True][0]):
        assert np.array_equal(d["valid"], a["valid"]) and np.array_equal(d["boxes"], a["boxes"])
        for td, ta in zip(ds, as_):
            assert (td is None) == (ta is None) and (td is None or td[0] == ta[0])
            if td is not None:
                n_labels += 1
                near += td[1] != ta[1]
    # labels differ only within the bf16 bar of the threshold (phase 10's
    # video check): each differing one is counted; fewer than 1 in 16 may
    assert near * 16 <= n_labels, (near, n_labels)
    (_, sd, wd, nd, fd, cd), (_, sa, wa, na, fa, ca) = runs[False], runs[True]
    log(f"TrackingVideoPipeline over 32 frames of {vw}x{vh} (4 scenes of the VideoSource "
        f"synthetic recipe, 8 frames each), batch 4, K=8, refresh_every=8, labels against frame "
        f"0's first face: dense embed_fraction {sd['embed_fraction']:.3f} "
        f"({sd['embed_frames']}/32 frames in {nd} refresh dispatches, {fd} real frames), "
        f"{32 / wd:.1f} frames/s | adaptive embed_fraction {sa['embed_fraction']:.3f} "
        f"({na} dispatches, last bucket {sa['embed_bucket']}, corrections "
        f"{sa['embed_corrections']}), {32 / wa:.1f} frames/s; track ids persist across a "
        f"scene; slots of a refresh run not holding the detect-only run's face: 0 (both); "
        f"labels equal on {n_labels - near} of {n_labels} tracked slots; launches dense {cd}, "
        f"adaptive {ca} (1 warp_xm + 1 pyramid per refresh dispatch)")

    # ---- (c) the CLI: in process with --json, then `serve` in its own process
    modes = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(4):
            paths.append(os.path.join(tmp, f"face{i}.png"))
            with open(paths[-1], "wb") as f:
                f.write(pngs[i])
        det_path = os.path.join(tmp, "det.npz")
        checkpoint.save_params(det_path, detection_bias(
            bridge.init_params_numpy(cfg.scrfd_variant, seed=cfg.seed),
            torch.from_numpy(frames[:4]).to(dev)))
        gallery = os.path.join(tmp, "gallery.npz")
        models = ["--det-model", det_path, *cli_args]
        written = []

        def record(path, image):  # no encoder on this host (module docstring)
            written.append((os.path.basename(path), image.shape))
            return True

        reset_counts()
        real_imwrite = cli_main.imwrite
        cli_main.imwrite = record
        try:
            doc, modes["detect (bulk, 4 files)"] = _cli_json(["detect", *paths, *models])
            assert doc["total_faces"] > 0 and all(im["faces"] for im in doc["images"]), doc
            doc, modes["detect"] = _cli_json(["detect", paths[0], *models])
            assert doc["total_faces"] > 0
            doc, modes["compare"] = _cli_json(["compare", paths[0], paths[1], *models])
            assert 0 <= doc["similarity"] <= 1 and len(doc["faces"]) == 2, doc
        finally:
            cli_main.imwrite = real_imwrite
        assert [w[0] for w in written] == ["face0_out.jpg", "face0_out.jpg"], written
        assert written[0][1] == (size, size, 3) and written[1][1] == (size, 2 * size, 3), written
        doc, modes["simple"] = _cli_json(["simple", paths[0], paths[1], *models])
        assert 0 <= doc["similarity"] <= 1
        doc, modes["enroll (4 files)"] = _cli_json(["enroll", *paths, "--gallery", gallery,
                                                    *models])
        assert doc["enrolled"] == ["face0", "face1", "face2", "face3"], doc
        doc, modes["identify"] = _cli_json(["identify", paths[2], "--gallery", gallery,
                                            *models])
        assert doc["faces"][0]["label"] == "face2", doc["faces"][0]
        doc, modes["identify (4 probes)"] = _cli_json(["identify", *paths, "--gallery", gallery,
                                                       *models])
        assert [im["faces"][0]["label"] for im in doc["images"]] == \
            ["face0", "face1", "face2", "face3"], doc
        doc, modes["webcam --track"] = _cli_json(
            ["webcam", f"synthetic:{vw}x{vh}x8", "--track", "--enroll-first", *models])
        assert doc["frames"] == 8 and doc["track"]["embed_frames"] > 0, doc
        doc, modes["doctor"] = _cli_json(["doctor", "--gallery", gallery, *cli_args])
        assert doc["backend"]["platform"] == dev.type and doc["gallery"]["rows"] == 4, doc
        cli_counts = read_counts()
        assert cli_counts["warp_xm"] > 0, "the CLI did not launch the warp kernel"

        # `serve` in its own process: start → first answer, SIGTERM → exit
        serve_gallery = os.path.join(tmp, "served.npz")
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "facerecognizeonnx_tpu_torch", "serve", "--port", "0",
             "--gallery", serve_gallery, *models],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        seen, t_models, group_line = [], None, ""
        try:
            port = None
            for line in proc.stdout:
                seen.append(line)
                if line.startswith("进程组: "):
                    group_line = line.strip()
                if t_models is None and "所有模型加载成功" in line:
                    t_models = time.perf_counter()
                m = re.search(r"http://[0-9.]+:(\d+)", line)
                if m:
                    port = int(m.group(1))
                    break
            assert port and t_models, "".join(seen)[-3000:]
            backend = "nccl" if dev.type == "cuda" else "gloo"
            assert group_line.startswith(f"进程组: {backend} × 1 rank (rank 0:"), group_line
            t_up = time.perf_counter()
            served = IdentifyClient("127.0.0.1", port, timeout=300).enroll("alice", pngs[3])
            t_answer = time.perf_counter()
            assert served["enrolled"], served
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            t_exit = time.perf_counter()
            assert rc == 0, (rc, proc.stdout.read()[-3000:])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert GalleryBank.load(serve_gallery, device=dev).names == ["alice"]
    log(f"CLI in process (--json; one JSON document each, parsed; the models at full width, "
        f"{cfg.rec_arch} seeded, the detector from a .npz; detect and compare end in imwrite, "
        f"replaced here by a recorder of the image's shape: this host has no encoder), wall s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in modes.items())
        + f"; identify: each probe's top label its own enrolled name; doctor platform "
        f"{dev.type}; "
        f"launches {cli_counts} | `python3 -m facerecognizeonnx_tpu_torch serve` in its own "
        f"process ('{group_line}'): start -> models loaded {t_models - t0:.2f} s, -> listening {t_up - t0:.2f} s, "
        f"-> first answer (POST /enroll) "
        f"{t_answer - t0:.2f} s; SIGTERM -> exit 0 in {t_exit - t_answer:.2f} s, the gallery "
        f"saved with the name | phase {time.perf_counter() - t_phase:.1f} s | card: "
        f"{nvidia_smi()}")


# ---------------------------------------------------------------- phase 13: ONNX

# the det_500m shape (the spec of tests/oracles/scrfd_nas_onnx.py, which
# this script cannot import: it reaches the JAX package): a NAS residual
# depthwise backbone, taps at strides 8/16/32, one head trunk per stride
NAS_BACKBONE = [
    ("conv", 3, 16, 2), ("dwsep", 16, 16, 1, True), ("dwsep", 16, 24, 2, False),
    ("dwsep", 24, 24, 1, True), ("dwsep", 24, 40, 2, False), ("dwsep", 40, 40, 1, True),
    ("dwsep", 40, 72, 2, False), ("dwsep", 72, 72, 1, True), ("dwsep", 72, 112, 2, False),
    ("dwsep", 112, 112, 1, True),
]
NAS_TAPS = {5: 8, 7: 16, 9: 32}  # backbone index → stride
NAS_HEAD = 32
# 3 strides × {scores, bbox, kps} in scrambled order, opaque names
NAS_OUTPUTS = [(8, "kps", 10, "471"), (32, "cls", 1, "451"), (16, "box", 4, "466"),
               (8, "cls", 1, "443"), (32, "kps", 10, "473"), (8, "box", 4, "462"),
               (16, "cls", 1, "447"), (16, "kps", 10, "472"), (32, "box", 4, "470")]
# the bars of utils/realmodels.py: fast vs reference executor, features
EXEC_BAR = 1e-2
BOX_BAR = 0.5  # px: a box of the .onnx step paired with one of the native step
# the graph's heads against the native SCRFD on the same (unfolded)
# weights at bf16: scores within one bf16 ulp in [0.5, 1) (the fast
# path's sigmoid rounds to bf16, as JAX's does), bbox and kps in stride
# units (float32 there: bf16 × the float32 scale promotes)
SCORE_BAR, REG_BAR = 2.0 ** -8, 0.25


def det500m_shaped(seed: int, size: int) -> bytes:
    """A det_500m-shaped .onnx written with the port's writer: seeded
    weights (BN statistics non-trivial), each head ending in the torch
    export glue Transpose → Shape → Gather → Squeeze → Div → Unsqueeze →
    Concat → Reshape(−1, C), so the outputs are batch-folded (B·H·W·A, C)."""
    from facerecognizeonnx_tpu_torch.onnx_export import writer as W

    rng = np.random.default_rng(seed)
    nodes, inits, n = [], [], [0]

    def name(tag):
        n[0] += 1
        return f"{tag}_{n[0]}"

    def init(nm, arr):
        inits.append(W.tensor(nm, np.ascontiguousarray(arr)))
        return nm

    def op(op_type, inputs, **attrs):
        out = name(op_type.lower())
        nodes.append(W.node(op_type, inputs, [out], **attrs))
        return out

    def conv(x, cin, cout, k, stride, groups=1):
        out = name("conv")
        w = rng.standard_normal((cout, cin // groups, k, k)) * (2.0 / (k * k * cin // groups)) ** 0.5
        init(out + "_w", w.astype(np.float32))
        init(out + "_b", (rng.standard_normal(cout) * 0.01).astype(np.float32))
        nodes.append(W.node("Conv", [x, out + "_w", out + "_b"], [out], strides=[stride, stride],
                            pads=[k // 2] * 4, kernel_shape=[k, k], group=groups))
        return out

    def bn(x, c):
        out = name("bn")
        stats = (rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
                 rng.standard_normal(c) * 0.1, rng.uniform(0.5, 1.5, c))
        names = [init(out + s, a.astype(np.float32)) for s, a in zip("gbmv", stats)]
        nodes.append(W.node("BatchNormalization", [x] + names, [out], epsilon=1e-5))
        return out

    x, taps = "input", {}
    for i, spec in enumerate(NAS_BACKBONE):
        if spec[0] == "conv":
            _, cin, cout, s = spec
            x = op("Relu", [bn(conv(x, cin, cout, 3, s), cout)])
        else:
            _, cin, cout, s, res = spec
            y = op("Relu", [bn(conv(x, cin, cin, 3, s, groups=cin), cin)])
            y = bn(conv(y, cin, cout, 1, 1), cout)
            x = op("Relu", [op("Add", [x, y])]) if res else op("Relu", [y])
        if i in NAS_TAPS:
            taps[NAS_TAPS[i]] = (x, cout)
    init("neg_one", np.asarray([-1], np.int64))
    init("anchors_c", np.asarray([2], np.int64))
    init("axis3", np.asarray([3], np.int64))
    nodes.append(W.node("Squeeze", ["anchors_c"], ["anchors_c_scalar"], axes=[0]))
    trunks = {s: op("Relu", [bn(conv(t, c, NAS_HEAD, 3, 1), NAS_HEAD)])
              for s, (t, c) in taps.items()}
    for s, kind, cols, out_name in NAS_OUTPUTS:
        t = conv(trunks[s], NAS_HEAD, 2 * cols, 3, 1)
        if kind == "cls":
            t = op("Sigmoid", [t])
        perm = op("Transpose", [t], perm=[0, 2, 3, 1])
        ac = op("Squeeze", [op("Gather", [op("Shape", [perm]), "axis3"], axis=0)], axes=[0])
        c1 = op("Unsqueeze", [op("Div", [ac, "anchors_c_scalar"])], axes=[0])
        nodes.append(W.node("Reshape", [perm, op("Concat", ["neg_one", c1], axis=0)],
                            [out_name]))
    return W.model(W.graph(nodes, inits, [("input", [1, 3, size, size])],
                           [(o[3], [None, None]) for o in NAS_OUTPUTS]))


def _cli_quiet(argv) -> float:
    """One in-process CLI run whose output is kept aside (shown only if it
    fails); its wall s."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = cli_main.main(argv)
    assert rc == 0, (argv, rc, out.getvalue()[-3000:])
    return time.perf_counter() - t0


def head_diff(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for s in want for g, w in zip(got[s], want[s]))


def paired(dets_a, dets_b, K, bar=BOX_BAR):
    """[(frame, slot of a, slot of b, box max|d|)]: each valid top-K slot of
    `a` paired with the valid top-K slot of `b` in its frame whose box
    coordinates lie nearest (all within `bar` px), each slot of `b` used
    once."""
    pairs = []
    for f in range(dets_a.valid.shape[0]):
        ja = torch.nonzero(dets_a.valid[f, :K]).flatten().tolist()
        jb = torch.nonzero(dets_b.valid[f, :K]).flatten().tolist()
        if not ja or not jb:
            continue
        dist = (dets_a.boxes[f, ja].float()[:, None] - dets_b.boxes[f, jb].float()[None]
                ).abs().amax(-1)
        used = set()
        for ia, j in enumerate(ja):
            order = torch.argsort(dist[ia]).tolist()
            ib = next((i for i in order if i not in used), None)
            if ib is not None and float(dist[ia, ib]) <= bar:
                used.add(ib)
                pairs.append((f, j, jb[ib], float(dist[ia, ib])))
    return pairs


def hold_to_native(label, got, native, K, bar=BOX_BAR):
    """One .onnx step against a native step on the same frames: valid
    masks, boxes paired within `bar` px, features and gallery names on the
    pairs (module docstring, phase 13). Returns the line's numbers."""
    dets, feats, sims, idx = got
    n_dets, n_feats, n_sims, n_idx = native
    masks_equal = int((dets.valid[:, :K] == n_dets.valid[:, :K]).all(dim=1).sum())
    pairs = paired(n_dets, dets, K, bar)
    n_valid = int(n_dets.valid[:, :K].sum())
    cos = [float((feats[f, j] * n_feats[f, jn]).sum()) for f, jn, j, _ in pairs]
    sim_dev = max((float((sims[f, j] - n_sims[f, jn]).abs().max()) for f, jn, j, _ in pairs),
                  default=0.0)
    checked = equal = 0
    for f, jn, j, _ in pairs:  # names (gallery rows) clear of near-ties, as names_outside_ties
        s = n_sims[f, jn].cpu().numpy()
        gaps = np.abs(np.diff(s)) > 2 * sim_dev
        clear = np.concatenate([[True], gaps]) & np.concatenate([gaps, [False]])
        for p in np.nonzero(clear)[0]:
            checked += 1
            equal += int(idx[f, j, p]) == int(n_idx[f, jn, p])
    out = dict(masks_equal=masks_equal, paired=len(pairs), valid=n_valid,
               box_max=max((p[3] for p in pairs), default=0.0), cos_min=min(cos, default=-1.0),
               sim_dev=sim_dev,
               same_slot=sum(p[1] == p[2] for p in pairs),
               names_checked=checked, names_equal=equal)
    log(f"  {label}: valid masks equal in {masks_equal}/{len(dets.valid)} "
        f"frames; {len(pairs)}/{n_valid} native slots paired with a box within {bar} px "
        f"(max|d| {out['box_max']:.4g}; {sum(p[1] == p[2] for p in pairs)} in the same slot); "
        f"feature cos min {out['cos_min']:.6f} (bar "
        f"{1 - realmodels.COSINE_TOL}); sims max|d| {sim_dev:.3g}; names equal {equal}/"
        f"{checked} outside near-ties")
    return out


def phase_onnx(dev, frames, det_tree, rec_tree, native_models, native, bank, n_rows, K,
               top_k, smi, cli_args=()):
    """ONNX interop at buffalo_sc width (module docstring, phase 13).
    cli_args: flags added to every CLI run (a rehearsal on the CPU passes
    --cpu)."""
    from facerecognizeonnx_tpu_torch import onnx_export
    from facerecognizeonnx_tpu_torch.models.arcface import IResNet
    from facerecognizeonnx_tpu_torch.onnx_import import OnnxRunner, proto
    from facerecognizeonnx_tpu_torch.onnx_import.native_map import map_recognizer

    t_phase = time.perf_counter()
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    B = frames.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        det_path, rec_path = os.path.join(tmp, "det.onnx"), os.path.join(tmp, "r50.onnx")
        # ---- (a) round trip: export, parse, load, map
        t0 = time.perf_counter()
        det_bytes = onnx_export.export_detector(bridge.params_from_numpy(det_tree, dev), det_path)
        t1 = time.perf_counter()
        rec_bytes = onnx_export.export_recognizer(bridge.params_from_numpy(rec_tree, dev), rec_path)
        t2 = time.perf_counter()
        graph = proto.load_model(rec_path)
        t3 = time.perf_counter()
        mapped = map_recognizer(graph, "iresnet50", device=dev)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        assert isinstance(mapped, IResNet), "the exported IResNet-50 did not map natively"
        det_api, rec_api = FaceDetector(cfg, device=dev), FaceRecognizer(cfg, device=dev)
        t5 = time.perf_counter()
        assert det_api.load_model(det_path) and isinstance(det_api.params, OnnxRunner)
        t6 = time.perf_counter()
        assert rec_api.load_model(rec_path) and isinstance(rec_api.params, IResNet)
        torch.cuda.synchronize()
        t7 = time.perf_counter()
        runner, rec_onnx = det_api.params, rec_api.params
        # the native SCRFD on the same weights as the graph: unfolded (phase
        # 5's is BN-folded, which moves bf16 roundings: module docstring)
        det_unfolded = bridge.params_from_numpy(det_tree, dev)
        with torch.no_grad():
            x = (frames.flip(-1).float() - 127.5) / 128.0
            t8 = time.perf_counter()
            heads = runner(x, torch.bfloat16)
            torch.cuda.synchronize()
            t9 = time.perf_counter()
            want = det_unfolded(x, torch.bfloat16)
            folded = native_models[0](x, torch.bfloat16)
        score_d = max(float((heads[s][0].float() - want[s][0]).abs().max()) for s in want)
        reg_d = max(float((heads[s][i] - want[s][i]).abs().max()) for s in want for i in (1, 2))
        fold_d = (max(float((folded[s][0] - want[s][0]).abs().max()) for s in want),
                  max(float((folded[s][i] - want[s][i]).abs().max()) for s in want for i in (1, 2)))
        assert heads[8][0].dtype == torch.bfloat16 and heads[8][1].dtype == torch.float32
        log(f"(a) round trip at buffalo_sc width: export det {len(det_bytes) / 1e6:.2f} MB in "
            f"{t1 - t0:.2f} s, r50 {len(rec_bytes) / 1e6:.1f} MB in {t2 - t1:.2f} s; parse r50 "
            f"{t3 - t2:.2f} s; map_recognizer (module on the card + self-verify through the "
            f"executor) {t4 - t3:.2f} s, verify cosine {mapped.verify_cosine:.7f}; "
            f"FaceDetector.load_model(det.onnx) -> OnnxRunner {t6 - t5:.2f} s; "
            f"FaceRecognizer.load_model(r50.onnx) -> IResNet (mapped, folded) {t7 - t6:.2f} s, "
            f"verify cosine {rec_onnx.verify_cosine:.7f}; the runner's first B={B} call "
            f"(uploads the weights) {t9 - t8:.2f} s; heads vs the native SCRFD on the same "
            f"weights, unfolded, bf16: scores max|d| {score_d:.4g} (bar {SCORE_BAR}), bbox/kps "
            f"{reg_d:.4g} (bar {REG_BAR}); phase 5's folded SCRFD vs unfolded: scores "
            f"{fold_d[0]:.4g}, bbox/kps {fold_d[1]:.4g} | card: {smi}")
        assert score_d <= SCORE_BAR and reg_d <= REG_BAR, (score_d, reg_d)

        # ---- (b) the main path from .onnx
        rec_exec = OnnxRunner(rec_path, kind="arcface", device=dev)
        steps = {"native": native_models, "native, detector unfolded": (det_unfolded,
                                                                        native_models[1]),
                 "runner + mapped": (runner, rec_onnx), "runner + executor": (runner, rec_exec)}
        results, counts, times = {}, {}, {}
        with torch.no_grad():
            for label, (dm, rm) in steps.items():
                def step(dm=dm, rm=rm):
                    return frames_to_matches(dm, rm, frames, bank, n_rows, cfg, K, top_k)
                reset_counts()
                out = step()
                torch.cuda.synchronize()
                counts[label] = read_counts()
                assert counts[label]["warp_xm"] == counts[label]["warp_xm_pyramid"] == 1, \
                    (label, counts[label])
                check_features(out[1], out[0].valid[:, :K], n_rows, out[3])
                results[label] = out
                times[label] = (wall_ms(step), device_ops(step))
        log(f"(b) frames_to_matches from .onnx (B={B}, K={K}, bf16, 640², gallery "
            f"{n_rows} rows): launches per step {counts['runner + mapped']} (mapped), "
            f"{counts['runner + executor']} (executor)")
        base = results["native, detector unfolded"]
        agree = {label: hold_to_native(f"{label} vs the native step, detector unfolded",
                                       results[label], base, K)
                 for label in ("runner + mapped", "runner + executor")}
        for label, a in agree.items():
            assert a["masks_equal"] == B and a["paired"] >= 0.75 * a["valid"], (label, a)
            assert a["cos_min"] >= 1 - realmodels.COSINE_TOL, (label, a)
            assert a["names_equal"] == a["names_checked"] > 0, (label, a)
        hold_to_native("runner + mapped vs phase 5's step (detector folded; no bar)",
                       results["runner + mapped"], native, K, bar=4.0)
        # the recognizers alone on the native step's own crops
        n_dets = native[0]
        crops = align_faces_batch(frames, n_dets.kps[:, :K], n_dets.boxes[:, :K], cfg,
                                  n_dets.valid[:, :K], True).reshape(B * K, 112, 112, 3)
        with torch.no_grad():
            f_nat = embed_crops(native_models[1], crops, cfg, normalized=True)
            f_map = embed_crops(rec_onnx, crops, cfg, normalized=True)
            f_exe = embed_crops(rec_exec, crops, cfg, normalized=True)
        v = n_dets.valid[:, :K].reshape(-1)
        same_crops_mapped = bool(torch.equal(f_map, f_nat))
        exec_cos = float((f_exe * f_nat).sum(-1)[v].min())
        assert same_crops_mapped and exec_cos >= 1 - realmodels.COSINE_TOL, exec_cos
        log(f"  on the native step's crops: the mapped recognizer's features equal the "
            f"native's bit for bit: {same_crops_mapped}; the executor's cos min "
            f"{exec_cos:.6f}")
        log("  step (median of 10) / device operations traced / launched: " + "; ".join(
            f"{k} {t:.3f} ms / {o[0]} / {o[1]}" for k, (t, o) in times.items()) + f" | card: {smi}")

        # ---- (c) the det_500m shape on the card
        nas_path = os.path.join(tmp, "det_500m_shaped.onnx")
        with open(nas_path, "wb") as f:
            f.write(det500m_shaped(3, 640))
        fast, ref = OnnxRunner(nas_path, device=dev), OnnxRunner(nas_path, fast=False, device=dev)
        with torch.no_grad(), tf32_off():
            x1 = x[:1]
            exec_d = head_diff(fast(x1), ref(x1))
            batched = fast(x)
            per_frame = max(head_diff({s: tuple(t[b:b + 1] for t in batched[s]) for s in batched},
                                      fast(x[b:b + 1])) for b in range(B))
        rows = {s: tuple(batched[s][0].shape) for s in sorted(batched)}
        assert exec_d <= EXEC_BAR and per_frame <= 1e-4, (exec_d, per_frame)
        with torch.no_grad():
            reset_counts()
            nas_out = frames_to_matches(fast, rec_onnx, frames, bank, n_rows, cfg, K, top_k)
            torch.cuda.synchronize()
        nas_counts = read_counts()
        assert nas_counts["warp_xm"] == nas_counts["warp_xm_pyramid"] == 1, nas_counts
        check_features(nas_out[1], nas_out[0].valid[:, :K], n_rows, nas_out[3])
        log(f"(c) det_500m-shaped graph at 640² (batch-folded 2-D outputs, glue chains, "
            f"scrambled order): fast vs reference executor max|d| {exec_d:.3g} (bar {EXEC_BAR}, "
            f"f32, TF32 off); B={B} call vs {B} B=1 calls, per frame max|d| {per_frame:.3g} "
            f"(bar 1e-4), heads unfolded to {rows}; frames_to_matches with it: "
            f"{int(nas_out[0].valid[:, :K].sum())}/{B * K} slots, launches {nas_counts}")

        # ---- (d) the CLI in process
        png = os.path.join(tmp, "frame0.png")
        with open(png, "wb") as f:
            f.write(png_bytes(np.ascontiguousarray(frames[0].flip(-1).cpu().numpy())))
        det_npz = os.path.join(tmp, "det.npz")
        checkpoint.save_params(det_npz, det_tree)
        cli_modes = {}
        out_rec, out_det = os.path.join(tmp, "cli_r50.onnx"), os.path.join(tmp, "cli_det.onnx")
        cli_modes["export (seeded r50)"] = _cli_quiet(["export", out_rec, *cli_args])
        cli_modes["export --detector"] = _cli_quiet(["export", out_det, "--detector",
                                                     "--det-model", det_npz, *cli_args])
        with open(out_rec, "rb") as f:
            rec_same = f.read() == rec_bytes
        with open(out_det, "rb") as f:
            det_same = f.read() == det_bytes
        assert rec_same and det_same, (rec_same, det_same)
        written = []
        real_imwrite = cli_main.imwrite
        cli_main.imwrite = lambda path, image: written.append(image.shape) or True
        try:
            doc, cli_modes["detect (.onnx models)"] = _cli_json(
                ["detect", png, "--det-model", det_path, "--rec-model", rec_path, *cli_args])
        finally:
            cli_main.imwrite = real_imwrite
        detect_faces = doc["total_faces"]
        assert detect_faces > 0 and written, doc
        real = os.path.join(tmp, "real")
        os.makedirs(real)
        os.symlink(det_path, os.path.join(real, realmodels.DET_FILE))
        os.symlink(rec_path, os.path.join(real, realmodels.REC_FILE))
        saved = os.environ.get("FRT_REAL_MODELS_DIR")
        os.environ["FRT_REAL_MODELS_DIR"] = real
        try:
            doc, cli_modes["doctor (real-model parity armed)"] = _cli_json(["doctor", *cli_args])
        finally:
            if saved is None:
                del os.environ["FRT_REAL_MODELS_DIR"]
            else:
                os.environ["FRT_REAL_MODELS_DIR"] = saved
        rmp = doc["real_model_parity"]
        assert rmp["status"] == "ok" and rmp["recognizer"]["mapped_native"], rmp
        log(f"(d) CLI in process: export bytes equal (a)'s files: r50 {rec_same}, det "
            f"{det_same}; detect --det-model det.onnx --rec-model r50.onnx --json: "
            f"{detect_faces} faces; doctor with FRT_REAL_MODELS_DIR: real-model parity "
            f"{rmp['status']} (fast vs reference {rmp['detector']['fast_vs_ref_maxdiff']:.3g}, "
            f"served vs executor cosine {rmp['recognizer']['exec_cosine']:.6f}, mapped "
            f"{rmp['recognizer']['mapped_native']}); wall s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in cli_modes.items()))
    log(f"phase {time.perf_counter() - t_phase:.1f} s | card: {smi}")


# ---------------------------------------------------------------- phases 14-15: NMS, AOT

# replays of the captured step between two reads of the kernels' device counters
N_REPLAYS = 5


def chain_case():
    """tests/test_torch_detect.py's suppression chain of 3·ITERS_PER_CHECK
    boxes (each overlaps only the next, at IoU 3/17) beside a clustered
    frame, in candidate order: (boxes (2, 12, 4), valid, threshold 0.1)."""
    n = 3 * nms.ITERS_PER_CHECK
    x1 = np.arange(n, dtype=np.float32) * 7.0
    chain = np.stack([x1, np.zeros(n), x1 + 10.0, np.full(n, 10.0)], -1)
    rng = np.random.default_rng(4)
    centers = rng.uniform(20, 300, (6, 2))[rng.integers(0, 6, n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    clustered = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    return np.stack([chain, clustered]).astype(np.float32), np.ones((2, n), bool), 0.1


def phase_nms(dev, rng, det, frames, cfg) -> dict:
    """csrc/nms_greedy.cu vs its plain version, bit for bit, on phase 5's
    candidates, the 12-box chain and the edge sweeps; its time beside its
    bound and the plain loop's. Returns its kernels-line entry."""
    main_boxes, main_valid = nms_inputs(det, frames, cfg)
    cases = {"phase 5's candidates": (main_boxes, main_valid, cfg.nms_threshold,
                                      cfg.nms_int_rects)}
    cases["12-box chain"] = (*chain_case(), True)
    for int_rects in (True, False):
        for nb in (1, 16):
            boxes = nms_edge_boxes(rng, nb, 512, int_rects)
            cases[f"edge sweep int_rects={int_rects} B={nb}"] = (
                boxes, rng.uniform(0, 1, (nb, 512)) > 0.15, 0.4, int_rects)
    kept, edges = {}, 0
    for label, (boxes, valid, thr, int_rects) in cases.items():
        boxes, valid = torch.as_tensor(boxes, device=dev), torch.as_tensor(valid, device=dev)
        got = nms.nms_greedy(boxes, valid, thr, int_rects)
        want = nms.nms_greedy_reference(boxes, valid, thr, int_rects)
        torch.cuda.synchronize()
        assert torch.equal(got, want), \
            f"NMS kernel vs plain, {label}: {int((got != want).sum())} candidates differ"
        kept[label] = f"{int(got.sum())}/{int(valid.sum())}"
        if label == "12-box chain":  # every other box of the chain survives
            assert got[0].tolist() == [i % 2 == 0 for i in range(got.shape[1])], got[0]
        if label.startswith("edge"):
            ib = nms._int_rects(boxes) if int_rects else boxes
            ulps = (nms.iou_matrix(ib, ib).view(torch.int32)
                    - torch.tensor(0.4, device=dev).view(torch.int32)).abs()
            edges += int((torch.triu(ulps <= 4, diagonal=1)).sum())
    thr, ir = cfg.nms_threshold, cfg.nms_int_rects
    nms_ms, plain_ms = in_turns(
        graph_timer(lambda: nms.nms_greedy(main_boxes, main_valid, thr, ir)),
        eager_timer(lambda: nms.nms_greedy_reference(main_boxes, main_valid, thr, ir)),
    )
    n_b, n_k = main_valid.shape
    # the IoUs this run's data needs: each valid candidate's row, over the
    # candidates after it (what the kernel computes)
    pairs = int((n_k - 1 - torch.nonzero(main_valid)[:, 1]).sum())
    bound, bound_by = bound_ms(n_b * n_k * (16 + 1 + 1), pairs * NMS_OPS_PER_PAIR)
    log(f"nms_greedy vs plain (the fixpoint loop), keep masks bit for bit: "
        + ", ".join(f"{k} {v} kept" for k, v in kept.items())
        + f"; the edge sweeps hold {edges} pairs within 4 ulps of IoU 0.4 | at phase 5's "
        f"candidates (B={n_b}, K={n_k}, {int(main_valid.sum())} valid, {pairs:,} IoUs; "
        f"median of 20 in turns): kernel {nms_ms:.4f} ms (CUDA-graph replays), plain "
        f"{plain_ms:.4f} ms (eager, its host reads included), bound {bound:.5f} ms "
        f"({bound_by}) | card: {nvidia_smi()}")
    return dict(ms=nms_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None, max_abs_err=0.0)


CONV_EPILOGUE_ENTRY = dict(
    name="conv_epilogue", route="cuda", source="facerecognizeonnx_tpu_torch/csrc/conv_epilogue.cu",
    replaces="no Pallas kernel: the eager passes between a folded bf16 IResNet's convolutions "
             "(XLA fuses them in the JAX package)",
)
# the forms of the IResNet epilogue: (alpha, identity, bn, write_f32, write_bf16)
EPILOGUE_FORMS = {
    "stem": (True, None, True, True, True),
    "conv1": (True, None, False, True, False),
    "conv2 + residual": (False, "res", True, False, True),
    "conv2 + shortcut conv": (False, "down", True, True, False),
    "last conv2": (False, "res", True, False, False),
}


def jitter_bn(tree, rng):
    """In place: a param tree's BatchNorm statistics and affines and PReLU
    slopes drawn from `rng`, in place of the initializer's (0, 1, 1, 0 and
    0.25). Returns the tree."""
    for sub in tree.values() if isinstance(tree, dict) else tree:
        if isinstance(sub, dict) and {"scale", "bias", "mean", "var"} <= set(sub):
            c = sub["mean"].shape
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            sub["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            sub["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        elif isinstance(sub, dict) and set(sub) == {"alpha"}:
            sub["alpha"] = rng.uniform(-0.1, 0.5, sub["alpha"].shape).astype(np.float32)
        elif isinstance(sub, (dict, list)):
            jitter_bn(sub, rng)
    return tree


def epilogue_case(gen, dev, form, shape):
    """Seeded inputs of one epilogue form at `shape` (N, C, H, W), every
    activation channels-last: y with bf16 ties of y + bias, NaN, ±inf and
    −0.0 planted, a bias with −0.0 channels, PReLU slopes of both signs, a
    residual with NaN and −0.0. Returns conv_epilogue's keyword arguments."""
    alpha_on, identity, bn_on, write_f32, write_bf16 = EPILOGUE_FORMS[form]
    N, C, H, W = shape

    def cl(t):
        return t.contiguous(memory_format=torch.channels_last).to(dev)

    bias = torch.randn(C, generator=gen)
    bias[::7] = -0.0
    # y + bias exactly halfway between two bf16 values (Sterbenz: exact)
    m = bias.to(torch.bfloat16)
    nxt = (m.view(torch.int16) + 1).view(torch.bfloat16)
    tie = (m.float() + nxt.float()) * 0.5
    y = torch.randn(shape, generator=gen) * 3
    y[:, :, ::3] = (tie - bias).view(1, C, 1, 1).expand(N, C, H, W)[:, :, ::3]
    flat = y.view(-1)
    idx = torch.randperm(flat.numel(), generator=gen)[:64]
    flat[idx[:16]] = float("nan")
    flat[idx[16:24]] = float("inf")
    flat[idx[24:32]] = float("-inf")
    flat[idx[32:]] = -0.0
    kw = dict(y=cl(y), bias=bias.to(dev), write_f32=write_f32, write_bf16=write_bf16)
    if alpha_on:
        kw["alpha"] = (torch.rand(C, generator=gen) * 0.6 - 0.1).to(torch.bfloat16).float().to(dev)
    if identity == "res":
        r = torch.randn(shape, generator=gen).to(torch.bfloat16)
        r.view(-1)[idx[:8]] = float("nan")
        r.view(-1)[idx[40:]] = -0.0
        kw["res"] = cl(r)
    elif identity == "down":
        kw["down"] = (cl(torch.randn(shape, generator=gen) * 2), torch.randn(C, generator=gen).to(dev))
    if bn_on:
        bn = layers.BatchNorm(torch.rand(C, generator=gen) + 0.5, torch.randn(C, generator=gen),
                              torch.randn(C, generator=gen), torch.rand(C, generator=gen) + 0.5)
        kw["bn"] = arcface.bn_tables(bn.to(dev))
    return kw


def same_bits(a, b) -> bool:
    """Equal shapes and bits (NaN payloads and the sign of zero included)."""
    if a is None or b is None:
        return a is None and b is None
    as_int = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(as_int), b.view(as_int))


def phase_conv_epilogue(dev) -> dict:
    """csrc/conv_epilogue.cu vs its plain version, bit for bit, in every
    form at C = 64 / 128 / 256 / 512; the folded IResNet-50 at B=512 in
    bf16, fused vs eager; the kernel's time over one forward's 49 calls
    beside its bytes bound and the plain versions' time; launches on the
    MobileFaceNet and detector forwards. Returns its kernels-line entry."""
    gen = torch.Generator().manual_seed(19)
    checked = 0
    for C, hw in ((64, (14, 14)), (128, (14, 9)), (256, (7, 9)), (512, (7, 7))):
        for form in EPILOGUE_FORMS:
            kw = epilogue_case(gen, dev, form, (3, C, *hw))
            got = conv_epilogue.conv_epilogue(**kw)
            want = conv_epilogue.conv_epilogue_reference(**kw)
            torch.cuda.synchronize()
            for name, a, b in zip(("f32", "bf16", "bn"), got, want):
                assert same_bits(a, b), f"conv_epilogue vs plain, {form} C={C}: {name} differs"
                checked += 0 if a is None else a.numel()
    log(f"conv_epilogue vs plain, bit for bit: {len(EPILOGUE_FORMS)} forms at C = 64 / 128 / "
        f"256 / 512, {checked:,} outputs (ties, NaN, ±inf and −0.0 planted)")

    B = 512
    rng = np.random.default_rng(19)
    tree = jitter_bn(bridge.init_params_numpy("iresnet50", seed=1), rng)
    rec = arcface.fold_inference_params(bridge.params_from_numpy(tree, dev))
    x = torch.from_numpy(rng.uniform(-1, 1, (B, 112, 112, 3)).astype(np.float32)).to(
        dev, torch.bfloat16)
    bf16 = torch.bfloat16

    def eager():
        with unittest.mock.patch.object(arcface, "fusable", lambda *a: False):
            return rec(x, bf16)

    calls, launch = [], arcface.conv_epilogue

    def recorded(*args, **kw):
        calls.append((args, kw))
        return launch(*args, **kw)

    with torch.no_grad():
        conv_epilogue.conv_epilogue.launches = 0
        fused = rec(x, bf16)
        torch.cuda.synchronize()
        per_forward = conv_epilogue.conv_epilogue.launches
        n_blocks = sum(len(s) for s in rec.stages)
        assert per_forward == 1 + 2 * n_blocks, per_forward
        want = eager()
        assert torch.isfinite(want).all(), "the eager IResNet-50 gave non-finite features"
        err = float((fused - want).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(fused, want).min())
        fused_ms, eager_ms = in_turns(eager_timer(lambda: rec(x, bf16)), eager_timer(eager),
                                      iters=10)
        fused_ops, eager_ops = device_ops(lambda: rec(x, bf16))[0], device_ops(eager)[0]
        with unittest.mock.patch.object(arcface, "conv_epilogue", recorded):
            rec(x, bf16)
        n_bytes = 0
        for args, kw in calls:
            y = args[0]
            n_out = 4 * kw.get("write_f32", False) + 2 * kw.get("write_bf16", False)
            n_out += 4 * (kw.get("bn") is not None)
            n_in = 4 + (2 if kw.get("res") is not None else 0)
            n_in += 4 if kw.get("down") is not None else 0
            n_bytes += y.numel() * (n_in + n_out)

        def kernels():
            for args, kw in calls:
                launch(*args, **kw)

        def plains():
            for args, kw in calls:
                conv_epilogue.conv_epilogue_reference(*args, **kw)

        kernel_ms, plain_ms = in_turns(graph_timer(kernels), eager_timer(plains), iters=10)
        del calls[:]
        # the other recognizer and the detector launch none
        conv_epilogue.conv_epilogue.launches = 0
        mbf = bridge.params_from_numpy(bridge.init_params_numpy("mbf", seed=2), dev)
        mbf(x[:64], bf16)
        det = scrfd.fold_inference_params(
            bridge.params_from_numpy(bridge.init_params_numpy("500m", seed=0), dev))
        det(torch.zeros((2, 640, 640, 3), device=dev), bf16)
        torch.cuda.synchronize()
        other = conv_epilogue.conv_epilogue.launches
        assert other == 0, other
    bound, bound_by = bound_ms(n_bytes, 0.0)
    assert same_bits(fused, want), (
        f"fused IResNet-50 vs eager at B={B}: features differ by {err:.3g} (min cos {cos:.7f})")
    log(f"IResNet-50 folded, bf16, B={B} crops: fused vs eager features bit for bit; "
        f"{per_forward} conv_epilogue launches a forward; device operations {fused_ops} "
        f"(fused) / {eager_ops} (eager); forward (median of 10 in turns) {fused_ms:.3f} ms "
        f"fused, {eager_ms:.3f} ms eager | the 49 epilogues: kernel {kernel_ms:.4f} ms "
        f"(CUDA-graph replays), plain {plain_ms:.4f} ms (eager), bound {bound:.4f} ms "
        f"({bound_by}, {n_bytes / 1e9:.2f} GB) | MobileFaceNet and detector forwards: "
        f"{other} launches | card: {nvidia_smi()}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None, max_abs_err=0.0, launches=per_forward,
                mobilefacenet_launches=0, detector_launches=0, shape=f"IResNet-50, B={B}",
                forward_ms=dict(fused=fused_ms, eager=eager_ms),
                device_ops=dict(fused=fused_ops, eager=eager_ops))


def _bundle_state(path: str):
    """The leaves of a .frtz bundle as {"det": state_dict, "rec": state_dict}
    (meta.json's names, params.npz's index-keyed arrays)."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            arrays = [npz[k] for k in sorted(npz.files)]
    out = {"det": {}, "rec": {}}
    for name, arr in zip(meta["leaves"], arrays):
        part, key = name.split(".", 1)
        out[part][key] = torch.from_numpy(arr)
    return out


def _hold_replay(label, got, dets, feats, K, feat_bar=None):
    """A replay's outputs against an eager step's: valid masks equal, boxes
    within 1e-3; features within feat_bar, else measured. Returns (box
    max|d|, feature cosine min over valid slots, feature max|d|)."""
    boxes, _, _, valid, f = got
    assert torch.equal(valid, dets.valid), f"{label}: valid masks differ from the eager step's"
    box_err = float((boxes - dets.boxes).abs().max())
    assert box_err <= 1e-3, (label, box_err)
    slot = valid[:, :K]
    assert slot.any(), f"{label}: no faces"
    check_features(f, slot)
    err = float((f - feats).abs().max())
    assert feat_bar is None or err <= feat_bar, (label, err, feat_bar)
    return box_err, float((f * feats).sum(-1)[slot].min()), err


def phase_aot(dev, frames, det_tree, rec_tree, det, rec, cfg=None, cli_args=()):
    """The fused step as `.frtz` bundles (module docstring, phase 15)."""
    t_phase = time.perf_counter()
    B, K = frames.shape[0], 8
    cfg = cfg or PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    frames_np = frames.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        # ---- (a) phase 5's models: export, load, capture, replay (bf16)
        path = os.path.join(tmp, "main.frtz")
        t0 = time.perf_counter()
        aot.save_bundle(path, det, rec, cfg, B, K)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipe = aot.load_bundle(path, device=dev)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = pipe(frames)
        torch.cuda.synchronize()
        t_capture = time.perf_counter() - t0
        eager = frames_to_features(det, rec, frames, cfg, K)
        box_err, bf16_cos, bf16_err = _hold_replay("bf16 replay", got, *eager, K)

        # the witness: each kernel counts its launches on the device
        before = (nms.device_launches(), *warp_cuda.device_launches())
        for _ in range(N_REPLAYS):
            pipe(frames)
        after = (nms.device_launches(), *warp_cuda.device_launches())
        moved = dict(zip(("nms_greedy", "warp_xm_pyramid", "warp_xm"),
                         (a - b for a, b in zip(after, before))))
        assert list(moved.values()) == [N_REPLAYS] * 3, \
            f"device launch counts over {N_REPLAYS} replays: {moved}"
        reset_counts()
        pipe(frames)
        torch.cuda.synchronize()
        assert all(v == 0 for v in read_counts().values()), "a replay ran Python launches"

        # eager step and replay in turns, host clock around synchronized calls
        def eager_step():
            frames_to_features(det, rec, frames, cfg, K)

        times = {"eager": [], "replay": []}
        for _ in range(10):
            for name, fn in (("eager", eager_step), ("replay", lambda: pipe(frames))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        ops = {"eager": device_ops(eager_step), "replay": device_ops(lambda: pipe(frames))}
        stats = {k: (statistics.median(v), min(v), max(v)) for k, v in times.items()}

        # ---- (b) float32 (TF32 off): the replay within 1e-5, and after
        # swap_params within 3e-5 of the eager step on the new weights
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        path32 = os.path.join(tmp, "main32.frtz")
        aot.save_bundle(path32, det, rec, cfg32, B, K)
        pipe32 = aot.load_bundle(path32, device=dev)
        rec2 = arcface.fold_inference_params(
            bridge.params_from_numpy(bridge.init_params_numpy(cfg.rec_arch, seed=5), dev))
        with tf32_off():
            _, cos32, err32 = _hold_replay(
                "float32 replay", pipe32(frames),
                *frames_to_features(det, rec, frames, cfg32, K), K, feat_bar=1e-5)
            before32 = pipe32(frames)[4]
            pipe32.swap_params(arc_params=rec2)
            swapped = pipe32(frames)
            _, _, err_swap = _hold_replay(
                "float32 replay after swap_params", swapped,
                *frames_to_features(det, rec2, frames, cfg32, K), K, feat_bar=3e-5)
        moved_by_swap = float((swapped[4] - before32).abs().max())
        assert moved_by_swap > 1e-2, "swap_params left the features where they were"
        del pipe32
        log(f"AOT bundle of phase 5's models (SCRFD-{cfg.scrfd_variant} {cfg.det_input_size} + "
            f"{cfg.rec_arch}, folded, B={B}, K={K}): save_bundle {t_save:.2f} s ({os.path.getsize(path) / 1e6:.1f} MB), "
            f"load_bundle {t_load:.2f} s, first call (warm-up + capture) {t_capture:.2f} s; "
            f"bf16 replay vs eager frames_to_features: valid masks equal, boxes max|d| "
            f"{box_err:.3g} (bar 1e-3), features cosine min {bf16_cos:.7f}, max|d| "
            f"{bf16_err:.3g}; float32 (TF32 off): features max|d| {err32:.3g} (bar 1e-5, "
            f"cosine min {cos32:.7f}), after swap_params to {cfg.rec_arch} seed 5 {err_swap:.3g} "
            f"(bar 3e-5; the swap moved them by {moved_by_swap:.3g}) | device launch counts "
            f"over {N_REPLAYS} replays {moved} (Python counts 0) | step, median of 10 in "
            f"turns [min-max], wall, synchronized: eager {stats['eager'][0]:.3f} ms "
            f"[{stats['eager'][1]:.3f}-{stats['eager'][2]:.3f}], replay "
            f"{stats['replay'][0]:.3f} ms [{stats['replay'][1]:.3f}-{stats['replay'][2]:.3f}] "
            f"(frames copied in, 5 outputs copied out); device operations traced / kernel "
            f"launches called: eager {ops['eager'][0]} / {ops['eager'][1]}, replay "
            f"{ops['replay'][0]} / {ops['replay'][1]} | card: {nvidia_smi()}")

        # ---- (c) the CLI's `export out.frtz` (models loaded on the CPU, so
        # the program is traced from CPU tensors) served on the card by
        # IdentifyService(aot=path) against the live service
        det_path, rec_path = os.path.join(tmp, "det.npz"), os.path.join(tmp, "rec.npz")
        checkpoint.save_params(det_path, det_tree)
        checkpoint.save_params(rec_path, rec_tree)
        models = ["--det-model", det_path, "--rec-model", rec_path, *cli_args]
        cli_path = os.path.join(tmp, "cli.frtz")
        doc, t_export = _cli_json(["export", cli_path, "--batch", str(B), "--cpu", *models])
        assert doc["format"] == "frtz" and doc["batch"] == B, doc
        state = _bundle_state(cli_path)
        det_c, rec_c = copy.deepcopy(det), copy.deepcopy(rec)
        det_c.load_state_dict(state["det"])
        rec_c.load_state_dict(state["rec"])
        t0 = time.perf_counter()
        cli_pipe = aot.load_bundle(cli_path, device=dev)
        cli_cfg = cli_pipe.config
        cli_eager = frames_to_features(det_c, rec_c, frames, cli_cfg, K)
        cli_box, cli_cos, cli_err = _hold_replay("CPU-exported bundle on the card",
                                                 cli_pipe(frames), *cli_eager, K)
        t_cli_run = time.perf_counter() - t0
        dets_c, feats_c = cli_eager
        names, rows = [], []
        for b in range(B):
            for k in range(K):
                if dets_c.valid[b, k]:
                    names.append(f"f{b}s{k}")
                    rows.append(feats_c[b, k].cpu().numpy())
        bank = GalleryBank(device=dev)
        bank.add_batch(names, np.stack(rows))
        extra = np.random.default_rng(15).normal(size=(1_000, 512)).astype(np.float32)
        bank.add_batch([f"random{i}" for i in range(len(extra))], extra)
        requests = [frames_np[i % B] for i in range(2 * B)]
        answers = {}
        for label, svc in (
            ("live", lambda: IdentifyService(det_c, rec_c, bank, cli_cfg, max_batch=B,
                                             max_faces=K, device=dev)),
            ("aot", lambda: IdentifyService(None, None, bank, aot=cli_path, device=dev)),
        ):
            service = svc()
            [f.result(600) for f in [service.identify_async(im, 5) for im in requests[:B]]]
            t0 = time.perf_counter()
            answers[label] = [f.result(600) for f in
                              [service.identify_async(im, 5) for im in requests]]
            answers[label + " s"] = time.perf_counter() - t0
            service.close()
        aot_service = IdentifyService(None, None, bank, aot=cli_pipe, device=dev)
        checked = equal = top1 = 0
        for i, (a, w) in enumerate(zip(answers["aot"], answers["live"])):
            assert np.array_equal(a.valid, w.valid) and a.valid.any(), f"request {i}: masks"
            assert np.allclose(a.boxes, w.boxes, atol=1e-3), f"request {i}: boxes"
            c, e = names_outside_ties(w, a, SERVED_SIM_BAR)
            checked, equal = checked + c, equal + e
            top1 += sum(a.names[j][0] == w.names[j][0] for j in np.nonzero(a.valid)[0])
        assert equal == checked and checked >= len(requests), (equal, checked)

        # ---- (d) `serve --aot` in its own process
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "facerecognizeonnx_tpu_torch", "serve", "--port", "0",
             "--aot", cli_path, *models],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        seen, marks = [], {}
        try:
            port = None
            for line in proc.stdout:
                seen.append(line)
                for key, text in (("models", "所有模型加载成功"), ("bundle", "AOT")):
                    if key not in marks and text in line:
                        marks[key] = time.perf_counter() - t0
                m = re.search(r"http://[0-9.]+:(\d+)", line)
                if m:
                    port = int(m.group(1))
                    break
            assert port and "bundle" in marks, "".join(seen)[-3000:]
            t_up = time.perf_counter() - t0
            faces = IdentifyClient("127.0.0.1", port, timeout=300).identify(
                png_bytes(np.ascontiguousarray(frames_np[0][..., ::-1])), top_k=1)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            assert rc == 0, (rc, proc.stdout.read()[-3000:])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        want = aot_service.identify(frames_np[0], top_k=1)
        aot_service.close()
        assert len(faces) == int(want.valid.sum()) > 0, (len(faces), want.valid)
        served_err = float(np.abs(np.asarray([f["box"] for f in faces])
                                  - want.boxes[want.valid]).max())
        assert served_err <= 1e-2, served_err
    log(f"CLI `export out.frtz --batch {B} --cpu` (traced from CPU tensors) {t_export:.2f} s, "
        f"loaded and replayed on the card vs the eager step on its leaves: valid masks "
        f"equal, boxes max|d| {cli_box:.3g}, features cosine min {cli_cos:.7f} max|d| "
        f"{cli_err:.3g} ({t_cli_run:.2f} s with the load) | IdentifyService(aot=path) vs the "
        f"live service, {len(requests)} concurrent frames of phase 5, bank {len(bank):,} rows: "
        f"masks and boxes equal, top-1 names {top1} of {sum(int(a.valid.sum()) for a in answers['aot'])} "
        f"slots equal, names equal on all {checked} positions clear of near-ties; "
        f"{answers['aot s']:.3f} s vs {answers['live s']:.3f} s live | `serve --aot` in its "
        f"own process, s after start: models loaded {marks.get('models', float('nan')):.2f}, "
        f"bundle loaded and captured {marks['bundle']:.2f}, listening {t_up:.2f}; /identify answered "
        f"{len(faces)} faces, boxes within {served_err:.3g} of the in-process bundle's, "
        f"SIGTERM -> exit 0 | phase {time.perf_counter() - t_phase:.1f} s")


PARALLEL_SEARCH_BAR = 1.67e-6  # the gallery kernel's sims bar at these shapes
N_DP_CALLS = 5


def _timed_in_turns(fns: dict, rounds=10) -> dict:
    """Host clock around synchronized calls, the callables in turns:
    name → (median, min, max) ms."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(v), min(v), max(v)) for k, v in times.items()}


def phase_parallel(dev, rng, frames, det, rec, bank, n_rows, K, top_k, cfg):
    """The parallel layer on one card over a real NCCL group (module
    docstring, phase 16). Returns the launches counted on the dp path."""
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch.parallel import mesh as pmesh
    from facerecognizeonnx_tpu_torch.parallel.distributed import free_port, init_distributed
    from facerecognizeonnx_tpu_torch.parallel.expert_parallel import ep_embed_crops
    from facerecognizeonnx_tpu_torch.parallel.sharded_ops import (
        make_dp_program,
        sharded_batch_embed,
        sharded_topk_search,
    )
    from facerecognizeonnx_tpu_torch.parallel.tensor_parallel import tp_embed_crops

    # ---- (a) a real NCCL group of one rank, through the launcher variables
    launcher = dict(COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}", NUM_PROCESSES="1",
                    PROCESS_ID="0")
    os.environ.update(launcher)
    try:
        init_distributed(device="cuda")
    finally:  # the CLI processes of phase 17 start groups of their own
        for key in launcher:
            os.environ.pop(key)
    backend, world = dist.get_backend(), dist.get_world_size()
    assert backend == "nccl" and world == 1, (backend, world)
    data = pmesh.make_mesh(("data",), device="cuda")
    model = pmesh.make_mesh(("model",), device="cuda")
    assert pmesh.mesh_device(data) == dev
    log(f"parallel: process group backend {backend}, world size {world}, rank device "
        f"{pmesh.mesh_device(data)} (init_distributed from COORDINATOR_ADDRESS / "
        f"NUM_PROCESSES=1 / PROCESS_ID=0)")

    # ---- (b) the sharded search against the bank's dense and kernel searches
    gen = torch.Generator(device=dev).manual_seed(12)
    Q, G, D, k = 128, 100_003, 512, 5
    q, g = _gallery(gen, Q, G, D, dev, dups=1_000)
    sbank = GalleryBank(device=dev)
    sbank.add_batch([str(i) for i in range(G)], g.cpu().numpy())
    sv, si = sharded_topk_search(q, g, k, mesh=model)
    rv, ri = gallery_cuda.gallery_topk_reference(q, g, k + 1)
    err, ties = check_topk(sv, si, rv[:, :k], ri[:, :k], rv[:, k], bar=PARALLEL_SEARCH_BAR)
    qn = q.cpu().numpy()
    for method, sharded in (("dense", False), ("cuda", False), ("dense", True)):
        names, sims = sbank.search(qn, k, method=method, sharded=sharded)
        bi = torch.tensor([[int(n) for n in row] for row in names], device=dev)
        e2, _ = check_topk(sv, si, torch.from_numpy(sims).to(dev), bi, rv[:, k],
                           bar=PARALLEL_SEARCH_BAR)
        err = max(err, e2)
    search_ms, dense_ms, kernel_ms = in_turns(
        eager_timer(lambda: sharded_topk_search(q, g, k, mesh=model)),
        eager_timer(lambda: gallery_cuda.gallery_topk_reference(q, g, k)),
        eager_timer(lambda: gallery_cuda.gallery_topk_cuda(q, g, k)),
    )
    log(f"sharded_topk_search (Q={Q}, G={G:,}, D={D}, k={k}, NCCL all-gather over 1 rank) vs "
        f"GalleryBank.search dense and cuda and gallery_topk_reference: sims max|d| {err:.3g} "
        f"(bar {PARALLEL_SEARCH_BAR:g}), indices equal outside near-ties ({ties} exact ties, "
        f"ascending index), search(sharded=True) the same; eager between CUDA events "
        f"(median of 20, in turns): sharded {search_ms:.4f} ms | dense {dense_ms:.4f} ms | "
        f"kernel {kernel_ms:.4f} ms")

    # ---- (c) the dp step at full width, with and without the fused search
    program, _ = make_dp_program(det, rec, cfg, mesh=data, max_faces_embed=K)
    matches, _ = make_dp_program(det, rec, cfg, mesh=data, max_faces_embed=K,
                                 search_top_k=top_k)
    with torch.no_grad():
        reset_counts()
        dets, feats = program(frames)
        torch.cuda.synchronize()
        dp_counts = read_counts()
        e_dets, e_feats = frames_to_features(det, rec, frames, cfg, K)
        m_out = matches(frames, bank, n_rows)
        e_out = frames_to_matches(det, rec, frames, bank, n_rows, cfg, K, top_k)
        for got, want in ((tuple(dets) + (feats,), tuple(e_dets) + (e_feats,)),
                          (tuple(m_out[0]) + m_out[1:], tuple(e_out[0]) + e_out[1:])):
            for a, b in zip(got, want):
                assert torch.equal(a, b), "the dp step differs from the eager step"
        assert all(dp_counts[n] == 1 for n in ("warp_xm", "warp_xm_pyramid", "nms_greedy")), \
            dp_counts
        before = (nms.device_launches(), *warp_cuda.device_launches())
        for _ in range(N_DP_CALLS):
            program(frames)
        after = (nms.device_launches(), *warp_cuda.device_launches())
        moved = [a - b for a, b in zip(after, before)]
        assert moved == [N_DP_CALLS] * 3, f"device launches over {N_DP_CALLS} dp calls: {moved}"
        stats = _timed_in_turns({
            "dp": lambda: program(frames),
            "eager": lambda: frames_to_features(det, rec, frames, cfg, K),
            "dp_search": lambda: matches(frames, bank, n_rows),
            "eager_search": lambda: frames_to_matches(det, rec, frames, bank, n_rows, cfg, K,
                                                      top_k),
        })
    check_features(feats, dets.valid[:, :K])
    fmt = {n: f"{m:.3f} ms ({lo:.3f}-{hi:.3f})" for n, (m, lo, hi) in stats.items()}
    log(f"dp step (make_dp_program over the 1-rank NCCL 'data' mesh, SCRFD-500m 640 + "
        f"IResNet-50 folded, bf16, B={frames.shape[0]}, K={K}): dets, features (and sims, "
        f"indices with search_top_k={top_k}) bit-equal to the eager step; launches in one "
        f"call {dp_counts}; device counters moved {moved} over {N_DP_CALLS} calls "
        f"(nms, pyramid, warp_xm); median of 10 with min-max, in turns: dp {fmt['dp']} | "
        f"eager {fmt['eager']} | dp+search {fmt['dp_search']} | eager+search "
        f"{fmt['eager_search']}")

    # ---- (c2) the bucketed embed's mesh form, and the dp step of a w8a8 recognizer
    with torch.no_grad():
        pipes = {name: bucketed.BucketedEmbedPipeline(det, rec, cfg, max_faces_embed=K,
                                                      search_top_k=top_k, mesh=m, device=dev)
                 for name, m in (("mesh", data), ("plain", None))}
        outs = {}
        for name, pipe in pipes.items():
            pipe(frames, bank, n_rows)  # the first step guesses full occupancy
            reset_counts()
            outs[name] = pipe(frames, bank, n_rows)
            torch.cuda.synchronize()
            if name == "mesh":
                b_counts = read_counts()
        for a, b in zip(tuple(outs["mesh"][0]) + outs["mesh"][1:],
                        tuple(outs["plain"][0]) + outs["plain"][1:]):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), \
                "the bucketed mesh form differs from the bucketed step"
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        with tf32_off():
            m32, _ = make_dp_program(det, rec, cfg32, mesh=data, max_faces_embed=K,
                                     search_top_k=top_k)
            b32 = bucketed.BucketedEmbedPipeline(det, rec, cfg32, max_faces_embed=K,
                                                 search_top_k=top_k, mesh=data, device=dev)
            b32(frames, bank, n_rows)
            got32, want32 = b32(frames, bank, n_rows), m32(frames, bank, n_rows)
        assert torch.equal(got32[0].valid, want32[0].valid), "bucketed masks differ (f32)"
        torch.testing.assert_close(got32[1], want32[1], rtol=1e-4, atol=1e-4)
        b_err = float((got32[1] - want32[1]).abs().max())
        calib = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (8, 112, 112, 3))
                                 .astype(np.float32)).to(dev)
        qrec = quant.quantize_recognizer(rec, calib, cfg.torch_compute_dtype)
        qprog, _ = make_dp_program(det, qrec, cfg, mesh=data, max_faces_embed=K)
        reset_counts()
        q_dets, q_feats = qprog(frames)
        torch.cuda.synchronize()
        q_counts = read_counts()
        e_dets, e_feats = frames_to_features(det, qrec, frames, cfg, K)
        for a, b in zip(tuple(q_dets) + (q_feats,), tuple(e_dets) + (e_feats,)):
            assert torch.equal(a, b), "the w8a8 dp step differs from the eager w8a8 step"
    for counts in (b_counts, q_counts):
        assert all(counts[n] == 1 for n in ("warp_xm", "warp_xm_pyramid", "nms_greedy")), counts
    log(f"BucketedEmbedPipeline(mesh=1-rank 'data', search_top_k={top_k}) bit-equal to the "
        f"bucketed step without a mesh (bf16, bucket {pipes['mesh'].last_bucket}, "
        f"{int(outs['mesh'][-1])} faces); in float32 (TF32 off) against make_dp_program("
        f"search_top_k={top_k}): masks equal, features max|d| {b_err:.3g} (bar rtol 1e-4 / atol "
        f"1e-4, the JAX dryrun's); launches in one call {b_counts} | make_dp_program with a "
        f"quantize_recognizer (w8a8) copy bit-equal to the eager w8a8 step; launches in one "
        f"call {q_counts}")

    # ---- (d) sharded_batch_embed and tp_embed_crops on one rank, B=64
    crops = torch.from_numpy(rng.integers(0, 256, (64, 112, 112, 3), dtype=np.uint8)).to(dev)
    with torch.no_grad():
        got = sharded_batch_embed(rec, crops, cfg, mesh=data)
        assert torch.equal(got, embed_crops(rec, crops, cfg)), "sharded_batch_embed differs"
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        with tf32_off():
            tp = tp_embed_crops(rec, crops, cfg32, mesh=model)
            want32 = embed_crops(rec, crops, cfg32)
    torch.testing.assert_close(tp, want32, rtol=1e-4, atol=1e-5)
    tp_err = float((tp - want32).abs().max())
    log(f"sharded_batch_embed (64 IResNet-50 crops, bf16) bit-equal to embed_crops; "
        f"tp_embed_crops (float32, TF32 off, 1-rank 'model' axis) max|d| {tp_err:.3g} "
        f"(bar rtol 1e-4 / atol 1e-5)")

    # ---- (e) two seeded IResNet-50 experts on the one-rank expert mesh
    experts = [bridge.init_params_numpy("iresnet50", seed=s) for s in (7, 8)]
    ecrops = crops[:16].cpu().numpy()
    expert = pmesh.make_mesh(("expert",), device="cuda")
    with torch.no_grad(), tf32_off():
        alone = torch.stack([embed_crops(bridge.params_from_numpy(t, dev),
                                         torch.from_numpy(ecrops).to(dev), cfg32)
                             for t in experts]).cpu().numpy()
        ep_err = 0.0
        for ids, cf in (([0, 1] * 8, 2.0), ([0] * 16, 1.0)):  # the second overflows
            ep_feats, routed = ep_embed_crops(experts, np.asarray(ids), ecrops, cfg32,
                                              mesh=expert, capacity_factor=cf)
            assert routed.all()
            want = alone[np.asarray(ids), np.arange(16)]
            ep_err = max(ep_err, float(np.abs(ep_feats - want).max()))
    assert ep_err <= 1e-5, ep_err
    log(f"ep_embed_crops (2 seeded IResNet-50 experts, 16 crops, float32 TF32 off, 1-rank "
        f"expert mesh; alternating ids at capacity_factor 2, then all on expert 0 at 1.0, "
        f"which overflows and finishes by rerun): every face routed, max|d| vs its expert "
        f"alone {ep_err:.3g} (bar 1e-5)")

    # ---- (f) IdentifyService(mesh=1, sharded=True) vs the plain service
    gallery = GalleryBank(device=dev)
    gallery.add_batch([f"id{i}" for i in range(n_rows)], bank[:n_rows].cpu().numpy())
    requests = [frames[i % frames.shape[0]].cpu().numpy() for i in range(16)]
    svc = {name: IdentifyService(det, rec, gallery, cfg, max_batch=8, max_faces=K,
                                 device=dev, **kw)
           for name, kw in (("mesh", dict(mesh=1, sharded=True)), ("plain", {}))}
    try:
        res = {name: [s.identify(im, top_k=top_k) for im in requests]
               for name, s in svc.items()}
    finally:
        for s in svc.values():
            s.close()
    same = sum(a.names == b.names for a, b in zip(res["mesh"], res["plain"]))
    for a, b in zip(res["mesh"], res["plain"]):
        assert np.array_equal(a.valid, b.valid) and a.valid.any()
        assert [n[:1] for n in a.names] == [n[:1] for n in b.names], "top-1 names differ"
        assert np.abs(a.sims - b.sims).max() <= 1e-5
    log(f"IdentifyService(mesh=1, sharded=True) vs the plain service, 16 requests one at a "
        f"time: top-1 names equal on every face, {same}/16 identical name lists, sims within "
        f"1e-5")

    # ---- (g) the pipeline stage
    log("pipelined_frames_to_features: its stage axis must be 2 and NCCL refuses two ranks "
        "on one GPU, so it is held on the CPU only (tests/test_torch_pipeline_stage.py, "
        "4 Gloo ranks; tools/multichip_parallel.py on four cards)")
    kernels = ("warp_xm", "warp_xm_pyramid", "nms_greedy")
    return {form: {n: counts[n] for n in kernels}
            for form, counts in (("dp", dp_counts), ("bucketed", b_counts),
                                 ("w8a8_dp", q_counts))}


# ---------------------------------------------------------------- phase 17: training

TRAIN_IDS, TRAIN_PER_ID = 8, 4  # the identity folder: 8 identities × 4 images
TRAIN_HW = (480, 640)
SPEED_B, SPEED_C = 128, 93_431  # arcface_torch configs/ms1mv3_r50.py: per-GPU batch, classes
STAT_BAR = 1e-3  # BN statistics: card vs CPU, of each statistic's scale
UPDATE_BAR = 1e-2  # the backbone's update and momentum: relative L2 (PReLU kinks)


def write_identity_folder(root: str, rng, hw=TRAIN_HW) -> list:
    """TRAIN_IDS identities × TRAIN_PER_ID seeded noise PNGs of hw (H, W)
    under root/<id>/; returns the BGR images in listing order."""
    images = []
    for i in range(TRAIN_IDS):
        os.makedirs(os.path.join(root, f"id{i}"))
        for j in range(TRAIN_PER_ID):
            img = rng.integers(0, 256, tuple(hw) + (3,), dtype=np.uint8)
            with open(os.path.join(root, f"id{i}", f"{j}.png"), "wb") as f:
                f.write(png_bytes(img[..., ::-1]))
            images.append(img)
    return images


def train_arrays(state) -> dict:
    """A train state as flat numpy leaves in JAX keys: "p/<param>",
    "t/<param>" (the momentum), "classifier", "trace_cls"."""
    flat = {f"p/{k}": v for k, v in checkpoint._flatten(bridge.tree_from_module(state.model)).items()}
    trace = {k: v for k, v in state.opt_state["trace"].items() if k != "classifier"}
    flat.update({f"t/{k}": v for k, v in checkpoint._flatten(
        bridge.tree_from_tensors(state.model, trace)).items()})
    flat["classifier"] = state.classifier.detach().cpu().numpy()
    flat["trace_cls"] = state.opt_state["trace"]["classifier"].cpu().numpy()
    return flat


def step_errors(got: dict, want: dict, before: dict) -> dict:
    """Card state vs CPU state after the same step from `before`: BN
    statistics (mean against the channel's std, var relative), the
    classifier and its momentum (of the leaf's scale), and the backbone's
    update and momentum (relative L2 over the backbone)."""
    stats = [k for k in want if k.startswith("p/") and k.endswith(("/mean", "/var"))]
    weights = [k for k in want if k.startswith("p/") and k not in stats]
    stat_err = 0.0
    for k in stats:
        if k.endswith("/mean"):
            sd = np.sqrt(want[k[:-5] + "/var"])
            stat_err = max(stat_err, float(np.max(np.abs(got[k] - want[k]) / sd)))
        else:
            stat_err = max(stat_err, float(np.max(np.abs(got[k] - want[k]) / want[k])))

    def l2(keys, a, b, base=None):
        da = np.concatenate([(a[k] - (base[k] if base else 0)).ravel() for k in keys])
        db = np.concatenate([(b[k] - (base[k] if base else 0)).ravel() for k in keys])
        return float(np.linalg.norm(da - db) / np.linalg.norm(db))

    cls_err = max(float(np.max(np.abs(got[k] - want[k])) / max(np.abs(want[k]).max(), 0.01))
                  for k in ("classifier", "trace_cls"))
    return {
        "stats": stat_err,
        "classifier": cls_err,
        "update": l2(weights, got, want, before),
        "momentum": l2(["t/" + k[2:] for k in weights], got, want),
    }


def phase_train(dev, rng, frames, det_tree, smi, hw=TRAIN_HW, det_size=640, arch="iresnet50",
                speed=(SPEED_B, SPEED_C), cli_args=()) -> dict:
    """Training on the card (module docstring, phase 17): the identity
    folder of hw images through a det_size detector, `arch` steps, the
    speed run at speed = (B, C), the detector fine-tuned on `frames`.
    Returns the launches of the train data path per kernel."""
    from facerecognizeonnx_tpu_torch.train.data import IdentityFolderDataset
    from facerecognizeonnx_tpu_torch.train.detector import train_detector
    from facerecognizeonnx_tpu_torch.train.fit import fit
    from facerecognizeonnx_tpu_torch.train.trainer import init_train_state, make_train_step
    from facerecognizeonnx_tpu_torch.types import face_boxes_to_arrays

    tmp = tempfile.mkdtemp(prefix="frt_train_")
    root = os.path.join(tmp, "ids")
    images = write_identity_folder(root, rng, hw)
    n_img = len(images)

    # ---- (a) the data path: detect (NMS kernel) → align (x-major warp kernel)
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda", det_input_size=det_size)
    det = FaceDetector(cfg, device=dev)
    assert det.load_model(None)
    boxed = np.zeros((n_img, det_size, det_size, 3), np.uint8)
    boxed[:, :hw[0], :hw[1]] = np.stack(images)  # the letterbox at scale 1
    bias_detector(det, torch.from_numpy(boxed).to(dev))
    ds = IdentityFolderDataset(root, detector=det, cfg=cfg)
    assert ds.num_classes == TRAIN_IDS and len(ds) == n_img
    t0 = time.perf_counter()
    reset_counts()
    crops = [ds.crop(path) for path, _ in ds.samples]
    torch.cuda.synchronize()
    train_counts = read_counts()
    data_s = time.perf_counter() - t0
    for name in ("warp_xm", "warp_xm_pyramid", "nms_greedy"):
        assert train_counts[name] == n_img, (name, train_counts)
    n_equal = 0
    with torch.no_grad():
        for (path, _), crop in zip(ds.samples, crops):
            image = imread(path)
            faces = det.detect(image)
            assert faces, f"no face in {path}"
            d = face_boxes_to_arrays(faces[:1], 1)
            M = _align_matrices(d.kps[None].to(dev), d.boxes[None].to(dev), *hw, 112)
            plain = warp_cuda.warp_affine_xm_reference(
                torch.from_numpy(image)[None].to(dev), M, None, None)[0, 0]
            n_equal += int(np.array_equal(plain.cpu().numpy().astype(np.uint8), crop))
    assert n_equal == n_img, f"{n_img - n_equal} crops differ from the plain warp's"
    log(f"train data: {TRAIN_IDS} ids × {TRAIN_PER_ID} PNGs {hw[1]}x{hw[0]}, "
        f"{data_s:.2f} s to decode+detect+align {n_img}; launches warp_xm "
        f"{train_counts['warp_xm']}, pyramid {train_counts['warp_xm_pyramid']}, nms_greedy "
        f"{train_counts['nms_greedy']} (one each per image); crops bit-equal to the plain "
        f"warp's on the same matrices: {n_equal}/{n_img}")

    # ---- (b) one train step at full width, card vs CPU; remat vs plain
    rcfg = PipelineConfig(compute_dtype="float32")
    x8, y8 = next(ds.batches(8, seed=0))
    n_cls = 1000
    with tf32_off():
        card = init_train_state(0, n_cls, rcfg, arch, device=dev)
        cpu = init_train_state(0, n_cls, rcfg, arch, device="cpu")
        before = train_arrays(cpu)
        step = make_train_step(None, rcfg)
        card, loss_card = step(card, x8, y8)
        cpu, loss_cpu = step(cpu, x8, y8)
        errs = step_errors(train_arrays(card), train_arrays(cpu), before)
        loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
        assert loss_rel <= 1e-5, (float(loss_card), float(loss_cpu))
        assert errs["stats"] <= STAT_BAR and errs["classifier"] <= 1e-4, errs
        assert errs["update"] <= UPDATE_BAR and errs["momentum"] <= UPDATE_BAR, errs
        remat_losses = {}
        for remat in (False, True):
            st = init_train_state(0, n_cls, rcfg, arch, device=dev)
            rstep = make_train_step(None, rcfg, remat=remat)
            ls = []
            for _ in range(2):
                st, loss = rstep(st, x8, y8)
                ls.append(float(loss))
            remat_losses[remat] = ls
        remat_rel = max(abs(a - b) / abs(b) for a, b in zip(remat_losses[True],
                                                             remat_losses[False]))
        assert remat_rel <= 1e-5, remat_losses
    del card, cpu, st
    log(f"train step {arch} 112² f32 (TF32 off), B=8 C={n_cls}, card vs CPU: loss "
        f"{float(loss_card):.6f} vs {float(loss_cpu):.6f} (rel {loss_rel:.2e}, bar 1e-5); BN "
        f"stats {errs['stats']:.2e} (bar {STAT_BAR:g}), classifier+momentum "
        f"{errs['classifier']:.2e} (bar 1e-4), backbone update {errs['update']:.2e} and "
        f"momentum {errs['momentum']:.2e} rel L2 (bar {UPDATE_BAR:g}); remat vs plain, 2 "
        f"steps: loss rel {remat_rel:.2e} (bar 1e-5)")

    # ---- (b2) the mesh form: phase 16's one-rank group, a (1, 1) ("data", "model") mesh
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(("data", "model"), (1, 1), device=dev)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the backward's convolutions repeat bit for bit
    try:
        with tf32_off():
            stepped = {}
            for name, m in (("mesh", mesh), ("plain", None)):
                st = init_train_state(0, n_cls, rcfg, arch, mesh=m, device=dev)
                st, loss = make_train_step(m, rcfg)(st, x8, y8)
                stepped[name] = (train_arrays(st), float(loss))
            del st
    finally:
        torch.backends.cudnn.deterministic = prev
    (a, la), (b, lb) = stepped["mesh"], stepped["plain"]
    mesh_equal = la == lb and all(np.array_equal(a[k], b[k]) for k in b)
    assert mesh_equal, "the (1, 1)-mesh train step differs from the mesh=None step"
    mds = IdentityFolderDataset(root, detector=det, cfg=cfg)
    reset_counts()
    n_mesh = mds.load_crops(mesh=mesh)
    torch.cuda.synchronize()
    mesh_counts = read_counts()
    assert n_mesh == n_img and all(np.array_equal(mds.crop(p), c)
                                   for (p, _), c in zip(ds.samples, crops))
    for name in ("warp_xm", "warp_xm_pyramid", "nms_greedy"):
        assert mesh_counts[name] == n_img, (name, mesh_counts)
    log(f"train step on the (1, 1) mesh of the one-rank NCCL group (phase 16's), B=8, f32 TF32 "
        f"off, cuDNN deterministic: loss {la:.6f}, every leaf bit-equal to the mesh=None step; "
        f"load_crops over the mesh: {n_mesh} crops equal to (a)'s, launches warp_xm "
        f"{mesh_counts['warp_xm']}, pyramid {mesh_counts['warp_xm_pyramid']}, nms_greedy "
        f"{mesh_counts['nms_greedy']}")

    # ---- (c) speed at full width: B=128, C=93,431
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(3)
    speed_b, speed_c = speed
    xb = (torch.rand((speed_b, 112, 112, 3), generator=gen) * 2 - 1).to(dev)
    yb = torch.randint(0, speed_c, (speed_b,), generator=gen).to(dev)
    state = init_train_state(1, speed_c, rcfg, arch, device=dev)
    step = make_train_step(None, rcfg)
    losses = []
    for _ in range(3):
        state, loss = step(state, xb, yb)
        losses.append(loss)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, loss = step(state, xb, yb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()  # the 3 warm-up steps, then the 10 timed
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    med = statistics.median(times)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    del state, xb
    torch.cuda.empty_cache()
    log(f"train speed {arch} 112² f32 (TF32 as the port leaves it: cuDNN on, matmul "
        f"off), B={speed_b} C={speed_c}: {med:.2f} ms/step median of 10 after 3 warm-up "
        f"(min {min(times):.2f}, max {max(times):.2f}) = {speed_b / med * 1e3:.1f} images/s; "
        f"peak memory {peak_mib:.0f} MiB; loss on the one batch {losses[0]:.4f} at step 1, "
        f"{losses[3]:.4f} at step 4, {losses[-1]:.4f} at step 13 | card: {smi}")

    # ---- (d) fit with a checkpoint at 3 of 6, resumed vs uninterrupted
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batches = list(ds.batches(8, seed=1, epochs=2))[:6]
        quiet = dict(log_every=0, log=lambda *_: None)
        ckpt = os.path.join(tmp, "fit.ckpt")
        step = make_train_step(None, rcfg)
        straight, _ = fit(init_train_state(2, TRAIN_IDS, rcfg, arch, device=dev),
                          step, iter(batches), 6, **quiet)
        fit(init_train_state(2, TRAIN_IDS, rcfg, arch, device=dev), step,
            iter(batches[:3]), 6, ckpt_path=ckpt, ckpt_every=3, **quiet)
        resumed, hist = fit(init_train_state(2, TRAIN_IDS, rcfg, arch, device=dev),
                            step, iter(batches), 6, ckpt_path=ckpt, **quiet)
    finally:
        torch.backends.cudnn.deterministic = prev
    a, b = train_arrays(resumed), train_arrays(straight)
    fit_equal = all(np.array_equal(a[k], b[k]) for k in b)
    assert int(resumed.step) == int(straight.step) == 6 and fit_equal, "resume differs"
    del resumed, straight
    log(f"fit: 6 steps with a checkpoint at 3 ({os.path.getsize(ckpt) / 2**20:.0f} MiB); the "
        f"run resumed from it equals the uninterrupted run bit for bit (cuDNN deterministic "
        f"for this check)")

    # ---- (e) detector fine-tuning: SCRFD-500m 640², B=8, 20 Adam steps
    boxes = []
    for _ in range(frames.shape[0]):
        side = frames.shape[1]
        xy = rng.uniform(0.03, 0.75, (2, 2)).astype(np.float32) * side
        wh = rng.uniform(0.06, 0.2, (2, 2)).astype(np.float32) * side
        boxes.append(np.concatenate([xy, xy + wh], 1))
    frames_np = frames.cpu().numpy()
    dcfg = PipelineConfig(compute_dtype="float32", det_input_size=frames.shape[1])
    t0 = time.perf_counter()
    _, det_losses = train_detector(frames_np, boxes, dcfg, steps=20, batch=8, init_params=det_tree,
                                   log_every=0, device=dev)
    det_s = time.perf_counter() - t0
    assert det_losses[-1] < det_losses[0], det_losses
    lr = 2e-3
    with tf32_off():
        outs = {}
        for where in (dev, "cpu"):
            model, ls = train_detector(frames_np, boxes, dcfg, steps=1, batch=2, lr=lr,
                                       init_params=det_tree, log_every=0, device=where)
            outs[str(where)] = (checkpoint._flatten(bridge.tree_from_module(model)), ls[0])
    (g, gl), (w, wl) = outs[str(dev)], outs["cpu"]
    det_loss_rel = abs(gl - wl) / abs(wl)
    n = close = 0
    worst = 0.0
    for k in w:
        if k.endswith(("/mean", "/var")):
            continue
        d = np.abs(g[k] - w[k])
        worst = max(worst, float(d.max()))
        n += d.size
        close += int((d <= 1e-6 + 1e-5 * np.abs(w[k])).sum())
    assert det_loss_rel <= 1e-5 and worst <= 2 * lr + 1e-5 and close >= 0.999 * n, \
        (det_loss_rel, worst, close / n)
    log(f"detector fine-tuning SCRFD-500m {frames.shape[1]}² f32, B=8: 20 Adam steps in "
        f"{det_s:.2f} s, loss "
        f"{det_losses[0]:.4f} → {det_losses[-1]:.4f}; one step B=2 card vs CPU (TF32 off): loss "
        f"rel {det_loss_rel:.2e} (bar 1e-5), weights {close / n:.6f} within 1e-6+1e-5|w| "
        f"(bar 0.999), max|d| {worst:.2e} (bar 2·lr: Adam's first step is lr·sign(g))")

    # ---- (f) the CLI: train and eval in subprocesses, identify in process
    det_npz, rec_npz = os.path.join(tmp, "det.npz"), os.path.join(tmp, "rec.npz")
    checkpoint.save_params(det_npz, detection_bias(bridge.init_params_numpy("500m", seed=0),
                                                   torch.from_numpy(boxed).to(dev)))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    base = [sys.executable, "-m", "facerecognizeonnx_tpu_torch"]
    t0 = time.perf_counter()
    sizes = ["--det-size", str(det_size), "--rec-arch", arch, *cli_args]
    run = subprocess.run(base + ["train", root, "--align", "--steps", "3", "--batch", "8",
                                 "--det-model", det_npz, "--out", rec_npz, *sizes],
                         capture_output=True, text=True, timeout=300, env=env)
    train_s = time.perf_counter() - t0
    assert run.returncode == 0 and os.path.isfile(rec_npz), run.stdout[-3000:] + run.stderr[-3000:]
    assert "训练完成: 3 步" in run.stdout, run.stdout[-2000:]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    group_line = re.search(r"进程组: .*", run.stdout).group(0)
    assert group_line.startswith(f"进程组: {backend} × 1 rank (rank 0:") and \
        "mesh data=1" in run.stdout, run.stdout[-2000:]
    t0 = time.perf_counter()
    run = subprocess.run(base + ["eval", root, "--align", "--det-model", det_npz, "--rec-model",
                                 rec_npz, "--json", *sizes],
                         capture_output=True, text=True, timeout=300, env=env)
    eval_s = time.perf_counter() - t0
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    report = json.loads(run.stdout.strip().splitlines()[-1])
    assert report["mode"] == "eval" and 0.0 <= report["accuracy"] <= 1.0, report
    assert report["identities"] == TRAIN_IDS and report["images"] == n_img, report
    gallery = os.path.join(tmp, "g.npz")
    paths = [p for p, _ in ds.samples]
    common = ["--det-model", det_npz, "--rec-model", rec_npz, "--gallery", gallery, *sizes]
    _cli_json(["enroll", paths[0], paths[1], *common])
    doc, _ = _cli_json(["identify", paths[2], *common])
    assert doc["gallery_size"] == 2 and doc["faces"], doc
    log(f"CLI: `train <root> --align --steps 3 --batch 8` {train_s:.1f} s (subprocess; "
        f"'{group_line}', mesh data=1) wrote "
        f"{os.path.getsize(rec_npz) / 2**20:.0f} MiB; `eval <root> --align` {eval_s:.1f} s: "
        f"accuracy {report['accuracy']:.4f} over {report['genuine_pairs']}+"
        f"{report['impostor_pairs']} pairs; `identify --rec-model` of it: "
        f"{len(doc['faces'])} face(s), top {doc['faces'][0]['label']}")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    import torch.distributed as dist

    dist.destroy_process_group()  # phase 16's
    kernels = ("warp_xm", "warp_xm_pyramid", "nms_greedy")
    return {form: {k: counts[k] for k in kernels}
            for form, counts in (("train", train_counts), ("train_mesh", mesh_counts))}


BENCH_KERNELS = ("warp_xm", "warp_xm_pyramid", "nms_greedy")
# the bench configs that run the fused step, so every kernel of BENCH_KERNELS
HEADLINE_FAMILY = (
    "headline", "headline_mbf", "headline_q8", "headline_onnx", "headline_occ",
    "headline_occ_adaptive", "headline_occ_adaptive_mbf", "headline_mbf_q8",
    "headline_occ_adaptive_q8", "cli bench",
)
BENCH_NAMED = ("headline_mbf_q8", "headline_occ_adaptive_q8")  # not in `all`


def _bench_run(argv, timeout, module="facerecognizeonnx_tpu_torch.bench"):
    """`python -m module argv` from the repo root → (stdout lines, s)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True,
                         timeout=timeout, cwd=root, env=dict(os.environ, PYTHONPATH=root))
    secs = time.perf_counter() - t0
    assert run.returncode == 0, (f"{module} {argv}: exit {run.returncode}\n"
                                 f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    return run.stdout.strip().splitlines(), secs


def _compact(doc) -> str:
    return json.dumps({k: doc.get(k) for k in ("metric", "value", "unit", "vs_baseline")})


def phase_bench(iters=5) -> dict:
    """The bench mode (facerecognizeonnx_tpu_torch/bench.py) as a user runs
    it, each run a subprocess at the default batch (128): `--config all`,
    the two configs `all` leaves out by name, and the CLI's `bench`. Fails
    on a config that carries an error or lacks a value, and where a config
    of the fused step launched no warp_xm, warp_xm_pyramid or nms_greedy
    kernel in its timed region, or `gallery` no gallery_topk. Returns
    {kernel: {config: launches}} for the kernels line."""
    from facerecognizeonnx_tpu_torch import bench

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="frt_bench_")
    detail = os.path.join(tmp, "bench_detail.json")
    lines, all_s = _bench_run(["--config", "all", "--iters", str(iters), "--detail", detail], 600)
    assert len(lines) == 2, lines[-3:]  # the full document, then the line of record
    full, compact = json.loads(lines[0]), json.loads(lines[1])
    assert len(lines[1]) <= 1900, len(lines[1])
    with open(detail) as f:
        assert json.load(f) == full, "the detail file differs from the full line"
    log(f"bench --config all --iters {iters}: {all_s:.1f} s; its line of record: {lines[1]}")
    results = {"headline": full}  # the headline's result is the document's top level
    results.update(full["detail"]["configs"])
    assert set(results) == set(bench.ORDER), sorted(results)
    for name in BENCH_NAMED:
        out, secs = _bench_run(["--config", name, "--iters", str(iters)], 300)
        assert len(out) == 1, out[-3:]
        results[name] = json.loads(out[0])
        log(f"bench --config {name}: {secs:.1f} s: {_compact(results[name])}")
    out, cli_s = _bench_run(["bench"], 300, module="facerecognizeonnx_tpu_torch.cli")
    results["cli bench"] = json.loads(out[-1])
    log(f"`python -m facerecognizeonnx_tpu_torch.cli bench`: {cli_s:.1f} s: "
        f"{_compact(results['cli bench'])}")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)

    errors = {name: r.get("error", r.get("detail", {}).get("error"))
              for name, r in results.items()
              if "error" in r or "error" in r.get("detail", {}) or "value" not in r}
    assert not errors, f"bench configs failed: {errors}"
    for name, r in results.items():
        assert np.isfinite(r["value"]) and r["value"] > 0, (name, r["value"])
        assert r["vs_baseline"] is None, (name, r["vs_baseline"])
    launches = {k: {} for k in BENCH_KERNELS + ("gallery_topk",)}
    for name in HEADLINE_FAMILY:
        counts = results[name]["detail"]["launches"]
        for k in BENCH_KERNELS:
            assert counts[k] > 0, f"bench config {name} launched no {k} kernel: {counts}"
            launches[k][name] = counts[k]
    for name in ("serve", "latency", "video"):
        counts = results[name]["detail"]["launches"]
        for k in BENCH_KERNELS:
            launches[k][name] = counts[k]
    n = results["gallery"]["detail"]["launches"]["gallery_topk"]
    assert n > 0, "bench config gallery launched no gallery_topk kernel"
    launches["gallery_topk"]["gallery"] = n
    card = results["headline"]["detail"]["device"]
    log(f"bench phase: {time.perf_counter() - t_phase:.1f} s in all; every config has a value "
        f"and no error; launches {json.dumps(launches)} | device {card}")
    return launches


def main() -> int:
    t0 = time.perf_counter()

    def phase(n):
        log(f"-- phase {n} at {time.perf_counter() - t0:.1f} s")

    # ---- 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device: {kind} x{torch.cuda.device_count()} | nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for matmuls; cuDNN convolutions take TF32 (exact on the bf16 path's "
        "operands) except inside the float32 checks (tf32_off)")

    if sys.argv[1:] == ["--only", "conv_epilogue"]:
        # the epilogue kernel's phase alone (its build, checks and times)
        log(f"build csrc/conv_epilogue.cu: {conv_epilogue.build_library()[1].strip()}")
        entry = phase_conv_epilogue(dev)
        log(json.dumps({"kernels": [dict(CONV_EPILOGUE_ENTRY, **entry)]}))
        log(smi)
        return 0

    # ---- 2. build every kernel source
    phase(2)
    build_all()

    # ---- 3. the x-major warp kernels vs their plain versions
    phase(3)
    rng = np.random.default_rng(0)
    xm, pyramid, warp_case = phase_warp_xm(dev, rng)

    # ---- 4. small input: the card's kernel path vs the port's CPU path (f32)
    phase(4)
    small_cfg = PipelineConfig(det_input_size=128, compute_dtype="float32", warp_impl="cuda")
    small_frames = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    small_det_tree = detection_bias(
        bridge.init_params_numpy("500m", seed=3), torch.from_numpy(small_frames)
    )
    small_det = bridge.params_from_numpy(small_det_tree, "cpu")
    small_rec = bridge.params_from_numpy(bridge.init_params_numpy("iresnet18", seed=4), "cpu")
    small_bank = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(48, 512)).astype(np.float32)), dim=-1
    )
    with torch.no_grad(), tf32_off():
        cpu = frames_to_matches(small_det, small_rec, torch.from_numpy(small_frames),
                                small_bank, 40, small_cfg, 4, 3)
        warp_cuda.warp_affine_xm.launches = 0
        gpu = frames_to_matches(small_det.to(dev), small_rec.to(dev),
                                torch.from_numpy(small_frames).to(dev),
                                small_bank.to(dev), 40, small_cfg, 4, 3)
        torch.cuda.synchronize()
    small_launches = warp_cuda.warp_affine_xm.launches
    assert small_launches > 0
    gdets, gfeats = gpu[0], gpu[1].cpu()
    assert torch.equal(gdets.valid.cpu(), cpu[0].valid), "detections differ GPU vs CPU"
    box_err = float((gdets.boxes.cpu() - cpu[0].boxes).abs().max())
    sv = cpu[0].valid[:, :4]
    assert sv.any(), "small input found no faces"
    small_cos = float((gfeats * cpu[1]).sum(-1)[sv].min())
    assert box_err <= 1e-2 and small_cos >= 1 - 1e-4, (box_err, small_cos)
    log(f"small input 128x128 f32, card vs CPU path: valid masks equal, "
        f"boxes max|d| {box_err:.3g}, feature cos min {small_cos:.7f}, "
        f"{int(sv.sum())} faces, warp launches {small_launches}")

    # ---- 5. the main path at full width
    phase(5)
    B, K, TOP_K, N_ROWS, G_PAD = 8, 8, 5, 10_000, 16_384
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda")
    frames = torch.from_numpy(
        rng.integers(0, 256, (B, 640, 640, 3), dtype=np.uint8)
    ).to(dev)
    det_tree = detection_bias(bridge.init_params_numpy("500m", seed=0), frames)
    det = scrfd.fold_inference_params(bridge.params_from_numpy(det_tree, dev))
    rec_tree = bridge.init_params_numpy("iresnet50", seed=1)
    rec = arcface.fold_inference_params(bridge.params_from_numpy(rec_tree, dev))
    gen = torch.Generator(device="cpu").manual_seed(2)
    bank = torch.zeros((G_PAD, 512), dtype=torch.float32)
    bank[:N_ROWS] = torch.nn.functional.normalize(torch.randn(N_ROWS, 512, generator=gen), dim=-1)
    bank = bank.to(dev)

    def run(c):
        return frames_to_matches(det, rec, frames, bank, N_ROWS, c, K, TOP_K)

    with torch.no_grad():
        reset_counts()
        conv_epilogue.conv_epilogue.launches = 0
        dets, feats, sims, idx = run(cfg)
        torch.cuda.synchronize()
        main_counts = read_counts()
        main_epilogues = conv_epilogue.conv_epilogue.launches
        assert main_epilogues > 0 and main_epilogues % 49 == 0, \
            f"the main path's IResNet-50 launched {main_epilogues} epilogues, not 49 a forward"
        main_launches = main_counts["warp_xm"]
        assert main_launches > 0, "the main path did not launch the warp kernel"
        assert main_counts["warp_xm_pyramid"] > 0, "the main path built no pyramid"
        assert main_counts["nms_greedy"] > 0, "the main path did not launch the NMS kernel"
        slot_valid = dets.valid[:, :K]
        assert slot_valid.any(dim=-1).all(), "a frame found no faces"
        check_features(feats, slot_valid, N_ROWS, idx)
        assert feats.shape == (B, K, 512) and sims.shape == idx.shape == (B, K, TOP_K)

        noskip_cfg = dataclasses.replace(cfg, skip_invalid_faces=False)
        warp_cuda.warp_affine_xm.launches = 0
        _, feats_ns, _, idx_ns = run(noskip_cfg)
        torch.cuda.synchronize()
        noskip_launches = warp_cuda.warp_affine_xm.launches
        assert noskip_launches > 0
        check_features(feats_ns, slot_valid, N_ROWS, idx_ns)
        noskip_cos = float((feats_ns * feats).sum(-1)[slot_valid].min())
        assert noskip_cos >= 0.999, noskip_cos

        # the same detections through the plain warp; the kernel's crops at
        # the main path's shapes held against it
        M = _align_matrices(dets.kps[:, :K], dets.boxes[:, :K], 640, 640, 112)
        crops = warp_cuda.warp_affine_xm_reference(frames, M, EPI, slot_valid)
        kcrops = warp_cuda.warp_affine_xm(frames, M, EPI, slot_valid)
        main_err = float((kcrops.float() - crops.float()).abs().max())
        assert torch.equal(kcrops, crops), f"main-path crops deviate {main_err}"
        plain = embed_crops(rec, crops.reshape(B * K, 112, 112, 3), cfg, normalized=True)
        plain = plain.reshape(B, K, -1) * slot_valid[..., None]
        plain_cos = float((plain * feats).sum(-1)[slot_valid].min())
        assert plain_cos >= 0.999, plain_cos
    occupancy = int(slot_valid.sum())
    log(f"main path (SCRFD-500m 640 + IResNet-50, folded, bf16, B={B}, K={K}, gallery "
        f"{N_ROWS}/{G_PAD} rows): {occupancy}/{B * K} slots occupied, "
        f"{int(dets.count().sum())} detections; warp launches {main_launches} "
        f"(skip; pyramid {main_counts['warp_xm_pyramid']}) / {noskip_launches} (no skip); "
        f"kernel vs plain crops max|d| {main_err:.3g} (bar: bit-identical); cos vs no-skip "
        f"{noskip_cos:.6f}, "
        f"vs plain warp {plain_cos:.6f} (bar 0.999)")

    with torch.no_grad():
        step_ms = wall_ms(lambda: run(cfg))
        noskip_ms = wall_ms(lambda: run(noskip_cfg))
        # per-stage split of one step (host clock, synchronized)
        _, top = detect_topk(det, frames, cfg, K)
        crops = align_faces_batch(frames, top.kps, top.boxes, cfg, top.valid, True)
        flat = crops.reshape(B * K, 112, 112, 3)
        f = embed_crops(rec, flat, cfg, normalized=True)
        detect_ms = wall_ms(lambda: detect_topk(det, frames, cfg, K))
        align_ms = wall_ms(
            lambda: align_faces_batch(frames, top.kps, top.boxes, cfg, top.valid, True)
        )
        embed_ms = wall_ms(lambda: embed_crops(rec, flat, cfg, normalized=True))
        match_ms = wall_ms(lambda: topk_stable(similarity_matrix(f, bank), TOP_K))
        step_ops = device_ops(lambda: run(cfg))
        align_ops = device_ops(
            lambda: align_faces_batch(frames, top.kps, top.boxes, cfg, top.valid, True)
        )
    log(f"main path step (median of 10): {step_ms:.3f} ms = {B / step_ms * 1e3:.1f} "
        f"frames/s, {B * K / step_ms * 1e3:.1f} faces/s (K={K} slots per frame); "
        f"skip_invalid_faces=False {noskip_ms:.3f} ms | card: {smi}")
    log(f"stages (median of 10): detect+NMS {detect_ms:.3f} ms | align+warp "
        f"{align_ms:.3f} ms | embed {embed_ms:.3f} ms | match {match_ms:.3f} ms | "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"device operations (torch.profiler, one call; kernels and copies as traced / "
        f"kernel launches as called): step {step_ops[0]} / {step_ops[1]}, align+warp stage "
        f"{align_ops[0]} / {align_ops[1]}")

    # ---- 6. the y-major warp kernel, and its path
    phase(6)
    ym = phase_ymajor(*warp_case)

    # ---- 7. the gallery top-k kernel vs its plain version
    phase(7)
    gallery = phase_gallery(dev)

    # ---- 8. GalleryBank.search(method="auto") past the 2·10^9 boundary
    phase(8)
    gallery["launches"] = phase_auto(dev)

    # ---- 9. the identify path at full width
    phase(9)
    api = phase_identify(dev, rng)

    # ---- 10. the native runtime, the bucketed embed, adaptive serving, video
    phase(10)
    phase_native_bucketed(dev, rng, det, rec, frames, api)

    # ---- 11. the model families at full width
    phase(11)
    phase_families(dev, frames, bank, N_ROWS, K, TOP_K, smi)

    # ---- 12. the serving surface: HTTP, the tracker, the CLI
    phase(12)
    phase_serving(dev, rng, *api)

    # ---- 13. ONNX interop at buffalo_sc width
    phase(13)
    phase_onnx(dev, frames, det_tree, rec_tree, (det, rec), (dets, feats, sims, idx), bank,
               N_ROWS, K, TOP_K, smi)

    # ---- 14. the NMS kernel vs its plain version
    phase(14)
    nms_entry = phase_nms(dev, rng, det, frames, cfg)

    # ---- 14b. the IResNet epilogue kernel vs its plain version
    phase("14b")
    epilogue_entry = phase_conv_epilogue(dev)
    torch.cuda.empty_cache()

    # ---- 15. the fused step as .frtz bundles, replayed as one CUDA graph
    phase(15)
    phase_aot(dev, frames, det_tree, rec_tree, det, rec)

    # ---- 16. the parallel layer over a real NCCL group
    phase(16)
    par_launches = phase_parallel(dev, rng, frames, det, rec, bank, N_ROWS, K, TOP_K, cfg)

    # ---- 17. training on the card
    phase(17)
    train_launches = phase_train(dev, rng, frames, det_tree, smi)
    # launches per path and kernel: phase 16's dp, bucketed mesh and w8a8 dp
    # calls, phase 17's crops (alone and over the mesh)
    paths = {**par_launches, **train_launches}

    def on_paths(name):
        return {f"{path}_launches": counts[name] for path, counts in paths.items()}

    # ---- 18. the bench mode, as a user runs it
    phase(18)
    torch.cuda.empty_cache()  # the bench's processes need the card's memory
    bench_launches = phase_bench()

    # ---- 19. result lines
    phase(19)
    kernels = [
        dict(name="warp_xm", route="cuda",
             source="facerecognizeonnx_tpu_torch/csrc/warp_xm.cu",
             replaces="facerecognizeonnx_tpu/ops/warp_pallas.py:273 (_kernel_xm, with the "
                      "face table of _warp_affine_pallas_xm, :422-492)",
             launches=main_launches, **on_paths("warp_xm"),
             bench_launches=bench_launches["warp_xm"], **xm),
        dict(name="warp_xm_pyramid", route="cuda",
             source="facerecognizeonnx_tpu_torch/csrc/warp_xm.cu",
             replaces="facerecognizeonnx_tpu/ops/warp_pallas.py:249 (build_pyramid_xm, the "
                      "prologue of _warp_affine_pallas_xm)",
             launches=main_counts["warp_xm_pyramid"],
             **on_paths("warp_xm_pyramid"),
             bench_launches=bench_launches["warp_xm_pyramid"], **pyramid),
        dict(name="warp_ym", route="cuda",
             source="facerecognizeonnx_tpu_torch/csrc/warp_ym.cu",
             replaces="facerecognizeonnx_tpu/ops/warp_pallas.py:101 (_kernel)", **ym),
        dict(name="gallery_topk", route="cuda",
             source="facerecognizeonnx_tpu_torch/csrc/gallery_topk.cu",
             replaces="facerecognizeonnx_tpu/ops/pallas_gallery.py:60 (_kernel)",
             bench_launches=bench_launches["gallery_topk"], **gallery),
        dict(name="nms_greedy", route="cuda",
             source="facerecognizeonnx_tpu_torch/csrc/nms_greedy.cu",
             replaces="facerecognizeonnx_tpu/ops/nms.py:100-112 (nms_fixed's lax.while_loop; "
                      "no Pallas kernel)",
             launches=main_counts["nms_greedy"], **on_paths("nms_greedy"),
             bench_launches=bench_launches["nms_greedy"], **nms_entry),
        dict(CONV_EPILOGUE_ENTRY, **dict(epilogue_entry, launches=main_epilogues)),
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
