"""CLI entry point — the reference's four modes plus the framework's extras.

Port of `facerecognizeonnx_tpu/cli/main.py`, with the same arguments,
stdout contract and `--json` contract. Reference modes:
  detect <image>             — detect + report + annotated output
  compare <img1> <img2>      — detect both, embed faces[0], compare @0.6
  simple <img1> <img2>       — whole-image embed (no detection), compare
  webcam [source]            — frame loop; 's' enrolls, 'q' quits

Extras:
  enroll <dir|images...> --gallery g.npz     — batched gallery enrollment
  identify <image...> --gallery g.npz        — 1:N search
  serve --port 8080                          — HTTP identify/enroll service
  export out.onnx [--detector]               — the recognizer (or detector)
                                               as an ONNX graph
  export out.frtz [--batch 8]                — the whole fused step as an
                                               AOT bundle (pipeline/aot.py)
  doctor                                     — environment diagnosis
  --json                                     — one JSON document on stdout,
                                               human output on stderr

Weights: `.npz` or `.onnx` (--det-model / --rec-model, or a --pack whose
files are in --model-dir), seeded random weights otherwise. Every mode
runs on the CUDA card unless `--cpu` is given; without a card and
without `--cpu` the CLI prints why and returns non-zero. `serve --aot
b.frtz` answers /identify from a bundle; `enroll --experts a.npz,b.npz`
routes each face to a specialist recognizer by yaw, `identify/serve
--sharded` spread the gallery rows over the ranks of the process group,
and `serve --dp N` serves data-parallel over its first N ranks (clamped
to the group's size: one process drives one device). Not ported yet,
and raising NotImplementedError that names its ROADMAP.md item: the
modes bench, train and eval.

Headless by default: annotated images are written next to the input
(`<name>_out.jpg`, which needs cv2 or PIL to encode); `--show` opens
windows when a display exists.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import json
import os
import sys
import time

import numpy as np

from facerecognizeonnx_tpu_torch.config import PipelineConfig, auto_config, resolve_device
from facerecognizeonnx_tpu_torch.io.imageio import VideoSource, imread, imwrite
from facerecognizeonnx_tpu_torch.pipeline.api import FaceDetector, FaceRecognizer
from facerecognizeonnx_tpu_torch.utils.draw import draw_face_info

UNPORTED_MODES = {
    "bench": "the bench harness is not ported (ROADMAP.md, the note at Queue A item 8)",
    "train": "training is not ported yet (ROADMAP.md Queue A item 17)",
    "eval": "evaluation is not ported yet (ROADMAP.md Queue A item 17)",
}


def _load_models(args):
    detector = FaceDetector(_cfg(args), device=args.device)
    if not detector.load_model(args.det_model):
        print(f"无法加载人脸检测模型: {args.det_model}")
        sys.exit(-1)
    recognizer = FaceRecognizer(_cfg(args), device=args.device)
    if not recognizer.load_model(args.rec_model):
        print(f"无法加载人脸识别模型: {args.rec_model}")
        sys.exit(-1)
    quant = getattr(args, "quant", "none")
    if quant != "none":
        # w8a8 = every conv int8; w8a8-fast = the wide convs only
        calib = None
        if args.quant_calib:
            from facerecognizeonnx_tpu_torch.pipeline.enroll import detect_align_crops

            images = [im for im in (imread(p) for p in _expand(args.quant_calib))
                      if im is not None]
            crops = detect_align_crops(detector, images, device=args.device)
            if len(crops):
                calib = crops
                print(f"int8 校准: {len(crops)} 张对齐人脸")
            else:
                print("int8 校准: 未检测到人脸, 回退到合成噪声")
        recognizer.quantize(calib_crops=calib, min_channels=128 if quant == "w8a8-fast" else 0)
    print("\n所有模型加载成功!")
    return detector, recognizer


def _cfg(args) -> PipelineConfig:
    overrides = dict(
        detector_weights=args.det_model,
        recognizer_weights=args.rec_model,
        rec_arch=args.rec_arch,
        scrfd_variant=args.det_variant,
    )
    if args.det_size:
        overrides["det_input_size"] = args.det_size
    return auto_config(**overrides)


def _expand(patterns):
    """Files, directories (their entries, sorted) and globs → paths."""
    paths = []
    for pattern in patterns:
        if os.path.isdir(pattern):
            paths += sorted(glob.glob(os.path.join(pattern, "*")))
        else:
            paths += sorted(glob.glob(pattern)) or [pattern]
    return paths


def _show_or_save(args, name: str, image, src_path: str | None = None):
    if args.show:
        import cv2

        cv2.imshow(name, image)
        cv2.waitKey(0)
    else:
        out = os.path.splitext(src_path)[0] + "_out.jpg" if src_path else f"{name}.jpg"
        imwrite(out, image)
        print(f"结果已保存: {out}")


def _face_json(f):
    """FaceBox → plain-JSON dict (--json contract)."""
    x, y, w, h = (float(v) for v in f.box)
    return {
        "box": [x, y, w, h],
        "score": float(f.score),
        "landmarks": np.asarray(f.landmarks, np.float64).reshape(5, 2).tolist(),
    }


def mode_detect(args):
    detector, _ = _load_models(args)
    print("\n=== 测试人脸检测 ===")
    paths = _expand(args.images)
    if len(paths) > 1:
        # bulk: the native loader decodes + letterboxes the files on host
        # threads while the device detects batches (detect_files)
        all_faces = detector.detect_files(paths)
        total = 0
        for path, faces in zip(paths, all_faces):
            total += len(faces)
            print(f"{os.path.basename(path)}: 检测到 {len(faces)} 个人脸")
            for i, f in enumerate(faces):
                x, y, w, h = f.box
                print(f"  人脸 {i + 1}: 位置({x}, {y}, {w}, {h}) 置信度: {f.score:.6g}")
        print(f"共 {len(paths)} 张图像, {total} 个人脸")
        return {
            "mode": "detect",
            "images": [
                {"path": p, "faces": [_face_json(f) for f in faces]}
                for p, faces in zip(paths, all_faces)
            ],
            "total_faces": total,
        }
    image = imread(paths[0])
    if image is None:
        print(f"无法读取图像: {paths[0]}")
        return
    print(f"图像尺寸: {image.shape[1]}x{image.shape[0]}")
    faces = detector.detect(image)
    print(f"检测到 {len(faces)} 个人脸")
    for i, f in enumerate(faces):
        x, y, w, h = f.box
        print(f"人脸 {i + 1}: 位置({x}, {y}, {w}, {h}) 置信度: {f.score:.6g}")
        draw_face_info(image, f)
    _show_or_save(args, "detection", image, paths[0])
    return {
        "mode": "detect",
        "images": [{"path": paths[0], "faces": [_face_json(f) for f in faces]}],
        "total_faces": len(faces),
    }


def mode_compare(args):
    detector, recognizer = _load_models(args)
    print("\n=== 测试人脸识别与比对 ===")
    image1, image2 = imread(args.images[0]), imread(args.images[1])
    if image1 is None:
        print(f"无法读取图像1: {args.images[0]}")
        return
    if image2 is None:
        print(f"无法读取图像2: {args.images[1]}")
        return
    print(f"图像1尺寸: {image1.shape[1]}x{image1.shape[0]}")
    print(f"图像2尺寸: {image2.shape[1]}x{image2.shape[0]}")
    faces1 = detector.detect(image1)
    faces2 = detector.detect(image2)
    if not faces1 or not faces2:
        print("未检测到人脸")
        return
    print(f"图像1检测到 {len(faces1)} 个人脸")
    print(f"图像2检测到 {len(faces2)} 个人脸")
    print("提取图像1的人脸特征...")
    feature1 = recognizer.extract_feature(image1, faces1[0])
    print("提取图像2的人脸特征...")
    feature2 = recognizer.extract_feature(image2, faces2[0])
    if feature1.size == 0 or feature2.size == 0:
        print("特征提取失败")
        return
    print(f"特征维度: {feature1.size}")
    similarity = recognizer.compare_faces(feature1, feature2)
    print(f"相似度: {similarity:.6f}")
    threshold = 0.6  # the reference's
    if similarity > threshold:
        print(f"结果: 同一人 (相似度: {similarity:.6f} > {threshold})")
    else:
        print(f"结果: 不同人 (相似度: {similarity:.6f} <= {threshold})")
    draw_face_info(image1, faces1[0], "Image 1")
    draw_face_info(image2, faces2[0], "Image 2", similarity)
    h = max(image1.shape[0], image2.shape[0])

    def pad(im):
        return np.pad(im, ((0, h - im.shape[0]), (0, 0), (0, 0)))

    _show_or_save(args, "comparison", np.hstack([pad(image1), pad(image2)]), args.images[0])
    return {
        "mode": "compare",
        "similarity": float(similarity),
        "same": bool(similarity > threshold),
        "threshold": threshold,
        "faces": [_face_json(faces1[0]), _face_json(faces2[0])],
        "n_faces": [len(faces1), len(faces2)],
    }


def mode_simple(args):
    _, recognizer = _load_models(args)
    print("\n=== 测试人脸识别与比对（简化模式 - 无检测） ===")
    image1, image2 = imread(args.images[0]), imread(args.images[1])
    if image1 is None:
        print(f"无法读取图像1: {args.images[0]}")
        return
    if image2 is None:
        print(f"无法读取图像2: {args.images[1]}")
        return
    print("\n处理图像1...")
    print(f"原始尺寸: {image1.shape[1]}x{image1.shape[0]}")
    feature1 = recognizer.extract_feature_simple(image1)
    print("\n处理图像2...")
    print(f"原始尺寸: {image2.shape[1]}x{image2.shape[0]}")
    feature2 = recognizer.extract_feature_simple(image2)
    if feature1.size == 0 or feature2.size == 0:
        print("\n特征提取失败")
        return
    print(f"\n特征维度: {feature1.size}")
    similarity = recognizer.compare_faces(feature1, feature2)
    print(f"\n相似度: {similarity:.6f}")
    threshold = 0.6
    if similarity > threshold:
        print(f"结果: 同一人 (相似度: {similarity:.6f} > {threshold})")
    else:
        print(f"结果: 不同人 (相似度: {similarity:.6f} <= {threshold})")
    return {
        "mode": "simple",
        "similarity": float(similarity),
        "same": bool(similarity > threshold),
        "threshold": threshold,
    }


def mode_webcam(args):
    """The reference's frame loop (or --track's tracker). Returns a
    summary document: frames and frames/s, plus the tracker's stats()."""
    detector, recognizer = _load_models(args)
    print("\n=== 实时人脸检测 ===")
    print("按 'q' 退出, 按 's' 保存参考人脸")
    source = args.images[0] if args.images else 0
    if isinstance(source, str) and source.isdigit():
        source = int(source)
    cap = VideoSource(source)
    if not cap.is_open():
        print("无法打开摄像头")
        return
    if args.track:
        return _webcam_tracked(args, detector, recognizer, cap)
    ref_feature = None
    n_frames = 0
    t0 = time.time()
    for frame in cap.frames():
        faces = detector.detect(frame)
        if ref_feature is not None and faces:
            feats = recognizer.extract_features(frame, faces)
            for face, feat in zip(faces, feats):
                sim = recognizer.compare_faces(ref_feature, feat)
                label = "Match" if sim > 0.6 else "Unknown"
                draw_face_info(frame, face, label, sim)
        else:
            for face in faces:
                draw_face_info(frame, face)
        n_frames += 1
        if args.show:
            import cv2

            info = f"Faces: {len(faces)}"
            if ref_feature is not None:
                info += " | Reference set"
            cv2.putText(frame, info, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
            cv2.imshow("realtime", frame)
            key = chr(cv2.waitKey(1) & 0xFF)
            if key == "q":
                break
            if key == "s" and faces:
                ref_feature = recognizer.extract_feature(frame, faces[0])
                print("已保存参考人脸特征")
        elif args.enroll_first and faces and ref_feature is None:
            ref_feature = recognizer.extract_feature(frame, faces[0])
            print("已保存参考人脸特征")
    dt = time.time() - t0
    cap.release()
    if n_frames:
        print(f"frames={n_frames} fps={n_frames / dt:.1f}")
    return {"mode": "webcam", "frames": n_frames, "fps": n_frames / dt if n_frames else 0.0}


def _webcam_tracked(args, detector, recognizer, cap):
    """--track: IOU tracker + per-track embedding cache
    (pipeline/track.py): the embed runs only for new or refresh-due
    tracks. Headless-batched, so --enroll-first takes the reference
    feature from the first detected face. An existing --gallery file
    upgrades labels to 1:N identities (top-1 per track)."""
    import itertools

    from facerecognizeonnx_tpu_torch.pipeline.track import TrackingVideoPipeline

    bank = None
    # --enroll-first keeps the reference's one-feature Match/Unknown
    # semantics even if a gallery file happens to exist
    if not args.enroll_first and args.gallery and os.path.exists(args.gallery):
        from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank

        bank = GalleryBank.load(args.gallery, device=args.device)
        print(f"gallery: {len(bank)} 条 ({args.gallery}) — 1:N 标签")
    frames = cap.frames()
    ref_feature = None
    if bank is None and args.enroll_first:
        for frame in frames:
            faces = detector.detect(frame)
            if faces:
                ref_feature = recognizer.extract_feature(frame, faces[0])
                print("已保存参考人脸特征")
                frames = itertools.chain([frame], frames)
                break

    pipe = TrackingVideoPipeline(
        detector.params, recognizer.params, detector.cfg, batch=4,
        adaptive_embed=args.adaptive_embed, device=args.device,
    )
    n_frames, t0 = 0, time.time()
    for _idx, _dets, _tracks in pipe.run(frames, ref_feature=ref_feature, bank=bank):
        n_frames += 1
    dt = time.time() - t0
    cap.release()
    s = pipe.stats()
    if n_frames:
        print(
            f"frames={n_frames} fps={n_frames / dt:.1f} "
            f"tracks={s['active_tracks']} "
            f"embed_fraction={s['embed_fraction']:.2f}"
        )
    return {"mode": "webcam", "frames": n_frames, "fps": n_frames / dt if n_frames else 0.0,
            "track": s}


def mode_enroll(args):
    """Batched gallery enrollment (pipeline/enroll.py): one detect per
    distinct image shape, one batched align, ONE embed for every crop."""
    detector, recognizer = _load_models(args)
    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
    from facerecognizeonnx_tpu_torch.pipeline.enroll import enroll_batch

    paths = _expand(args.images)
    bank = (GalleryBank.load(args.gallery, device=args.device) if os.path.exists(args.gallery)
            else GalleryBank(device=args.device))
    names, images = [], []
    for path in paths:
        image = imread(path)
        if image is None:
            continue
        names.append(os.path.splitext(os.path.basename(path))[0])
        images.append(image)
    experts = None
    if args.experts:
        experts = []
        for path in args.experts.split(","):
            path = path.strip()
            r = FaceRecognizer(recognizer.cfg, device=args.device)
            if not r.load_model(path):
                print(f"专家识别器加载失败: {path}")
                sys.exit(-1)
            experts.append(r.params)
        print(f"专家并行注册: {len(experts)} 个识别器, 按姿态路由 (route_by_yaw)")
    bank, enrolled = enroll_batch(detector, recognizer, names, images, bank=bank,
                                  experts=experts, device=args.device)
    bank.save(args.gallery)
    print(f"已注册 {len(enrolled)}/{len(paths)} 张人脸 → {args.gallery} (共 {len(bank)} 条)")
    return {
        "mode": "enroll",
        "enrolled": list(enrolled),
        "requested": len(paths),
        "gallery": args.gallery,
        "gallery_size": len(bank),
        "experts": len(experts) if experts else 0,
    }


def mode_identify(args):
    """1:N identification. One probe → per-face top-5; several probes
    (files / globs / directories) → batched detect (detect_batch) + ONE
    gallery search over every face of every probe."""
    detector, recognizer = _load_models(args)
    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank

    bank = GalleryBank.load(args.gallery, device=args.device)
    if not len(bank):
        print(f"gallery 为空: {args.gallery} — 先用 enroll 注册")
        return -1
    images, kept_paths = [], []
    for path in _expand(args.images):
        image = imread(path)
        if image is None:
            print(f"无法读取图像: {path}")
            continue
        images.append(image)
        kept_paths.append(path)
    if not images:
        return -1
    per_image = (
        detector.detect_batch(images) if len(images) > 1 else [detector.detect(images[0])]
    )
    # embed per probe (its faces in one batch), then ONE gallery search
    # over every face of every probe
    flat_feats, owners = [], []
    for img_i, (image, faces) in enumerate(zip(images, per_image)):
        if faces:
            flat_feats.append(np.asarray(recognizer.extract_features(image, faces)))
            owners += [(img_i, f) for f in faces]
    out_images = [{"path": p, "faces": []} for p in kept_paths]
    if not owners:
        print("未检测到人脸")
        result = {"mode": "identify", "images": out_images, "gallery_size": len(bank)}
        if len(images) == 1:
            result["faces"] = []  # keep the single-probe JSON contract
        return result
    names, sims = bank.search(np.concatenate(flat_feats, axis=0), top_k=min(5, len(bank)),
                              sharded=args.sharded)
    face_no = {}
    for (img_i, face), nrow, srow in zip(owners, names, sims):
        best = nrow[0] if srow[0] > 0.6 else "Unknown"
        face_no[img_i] = face_no.get(img_i, 0) + 1
        prefix = f"{os.path.basename(kept_paths[img_i])} " if len(images) > 1 else ""
        print(
            f"{prefix}人脸 {face_no[img_i]}: {best} "
            + " ".join(f"{n}:{s:.3f}" for n, s in zip(nrow, srow))
        )
        out_images[img_i]["faces"].append({
            **_face_json(face),
            "label": best,
            "matches": [{"name": str(n), "similarity": float(s)} for n, s in zip(nrow, srow)],
        })
    result = {"mode": "identify", "images": out_images, "gallery_size": len(bank)}
    if len(images) == 1:  # keep the single-probe JSON contract
        result["faces"] = out_images[0]["faces"]
    return result


def mode_serve(args):
    """HTTP identification service (pipeline/server.py): micro-batched
    /identify + /enroll over the loaded models and gallery. SIGTERM
    stops accepting, drains the service worker and saves the gallery."""
    import signal
    import threading

    detector, recognizer = _load_models(args)
    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
    from facerecognizeonnx_tpu_torch.pipeline.server import make_server

    bank = (GalleryBank.load(args.gallery, device=args.device) if os.path.exists(args.gallery)
            else GalleryBank(device=args.device))
    dp = args.dp or 0
    if dp != 0:
        import torch.distributed as dist

        # one process drives one device: the ranks of its process group
        n_local = dist.get_world_size() if dist.is_initialized() else 1
        want = n_local if dp == -1 else dp
        # the service meshes over ranks[:dp]; clamp so the startup line
        # reports the mesh actually built (one card asked for --dp 8
        # serves fine, on one device)
        dp = min(want, n_local)
        if dp < want:
            print(f"--dp {want} 请求, 本机只有 {n_local} 设备 → dp={dp}")
    server = make_server(
        detector, recognizer, bank, host=args.host, port=args.port,
        auth_token=args.auth_token, sharded=args.sharded, aot=args.aot,
        mesh=dp if dp > 1 else None, fuse_search=args.fuse_search,
        adaptive_embed=args.adaptive_embed, device=args.device,
    )
    if args.aot:
        print(f"identify 热路径使用 AOT 程序包: {args.aot}")
    if dp > 1:
        print(f"identify 数据并行: {dp} 设备")
    if args.fuse_search:
        print("identify 单次调度: gallery top-k 已融合进设备程序")
    if args.adaptive_embed:
        print("identify 自适应嵌入: embed 开销随检测到的人脸数伸缩")
    host, port = server.server_address[:2]
    print(f"服务已启动: http://{host}:{port}  (gallery: {len(bank)} 条)", flush=True)

    # graceful drain on SIGTERM (the deployment kill signal): stop
    # accepting, let in-flight micro-batches finish, persist the gallery
    # in the finally below — the same path as Ctrl-C
    def _term(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    prev = signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.server_close()
        server.frt_service.close()
        if args.gallery and len(bank):
            bank.save(args.gallery)
            print(f"gallery 已保存 → {args.gallery} ({len(bank)} 条)", flush=True)


def mode_export(args):
    """Serialize models for deployment, dispatched on the output path:

    *.onnx — the recognizer (or with --detector the detector) as an ONNX
    graph (onnx_export/), loadable by ONNX Runtime. Weights from
    --rec-model / --det-model (`.npz`), else seeded; the module is
    exported UNFOLDED: the graph carries explicit BatchNormalization
    nodes, as the published w600k files do.

    *.frtz — the whole fused detect→align→embed step as an AOT bundle
    (pipeline/aot.save_bundle) of the models `serve` would load (BN
    folded); `--batch` fixes the frame batch (default 8)."""
    from facerecognizeonnx_tpu_torch import bridge
    from facerecognizeonnx_tpu_torch.onnx_export import export_detector, export_recognizer
    from facerecognizeonnx_tpu_torch.pipeline.api import _load_onnx, _load_tree, _to_module

    cfg = _cfg(args)
    out = args.images[0]
    if out.endswith(".frtz"):
        from facerecognizeonnx_tpu_torch.pipeline.aot import save_bundle

        detector, recognizer = _load_models(args)
        batch = args.batch or 8
        save_bundle(out, detector.params, recognizer.params, detector.cfg, batch=batch)
        size = os.path.getsize(out)
        print(f"已导出 AOT 程序包: {out} ({size / 1e6:.1f} MB, batch={batch})")
        return {"mode": "export", "out": out, "format": "frtz", "batch": batch,
                "bytes": size}

    def load(path, init_fn):
        if path is not None and path.endswith(".onnx"):
            return _load_onnx(path, args.device)  # a runner, which export rejects
        return _to_module(_load_tree(path, init_fn), args.device)

    if args.detector:
        model = load(args.det_model,
                     lambda: bridge.init_params_numpy(cfg.scrfd_variant, seed=cfg.seed))
        data = export_detector(model, out, input_size=cfg.det_input_size)
    else:
        model = load(args.rec_model, lambda: bridge.init_params_numpy(
            cfg.rec_arch, seed=cfg.seed + 1, input_size=cfg.rec_input_size,
            feature_dim=cfg.feature_dim,
        ))
        data = export_recognizer(model, out, input_size=cfg.rec_input_size)
    print(f"已导出 ONNX 模型: {out} ({len(data) / 1e6:.1f} MB)")


def mode_doctor(args):
    """Environment diagnosis: the torch backend, the native runtime and
    its codecs, the kernel build cache, the packs' files, a gallery."""
    import torch

    from facerecognizeonnx_tpu_torch import version
    from facerecognizeonnx_tpu_torch.models.packs import PACKS
    from facerecognizeonnx_tpu_torch.ops import _nvcc
    from facerecognizeonnx_tpu_torch.runtime import native

    report = {"mode": "doctor", "version": version.__version__}
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        devices = ["cpu"]
    report["backend"] = {
        "platform": dev.type,
        "devices": devices,
        "device_count": len(devices),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
    }
    print(f"torch backend: {dev.type} × {len(devices)} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    for d in devices:
        print(f"  {d}")
    report["native_runtime"] = {
        "available": native.native_available(),
        "codecs": native.codecs_available(),
    }
    print(
        "native runtime: "
        + ("可用" + (" +codecs" if report["native_runtime"]["codecs"] else "")
           if report["native_runtime"]["available"]
           else "不可用 (纯 Python 回退)")
    )
    build_dir = str(_nvcc.BUILD_DIR)
    n_built = len(os.listdir(build_dir)) if os.path.isdir(build_dir) else 0
    report["build_cache"] = {"dir": build_dir, "entries": n_built}
    print(f"kernel build cache: {build_dir} ({n_built} 条)")
    packs = {}
    for name, pack in PACKS.items():
        det = os.path.join(args.model_dir, pack.det_file)
        rec = os.path.join(args.model_dir, pack.rec_file)
        packs[name] = {
            "det_file": pack.det_file,
            "det_present": os.path.exists(det),
            "rec_file": pack.rec_file,
            "rec_present": os.path.exists(rec),
        }
        status = [
            f"{pack.det_file}{'✓' if packs[name]['det_present'] else '✗'}",
            f"{pack.rec_file}{'✓' if packs[name]['rec_present'] else '✗'}",
        ]
        print(f"pack {name}: {' '.join(status)}")
    report["packs"] = packs
    report["model_dir"] = args.model_dir
    print("模型文件缺失时使用确定性初始化权重 (语义/性能路径不变)")
    # the real buffalo_sc files, wherever findable, arm the parity proof
    from facerecognizeonnx_tpu_torch.utils.realmodels import (
        DET_FILE,
        REC_FILE,
        find_real_models,
        run_real_model_parity,
    )

    found = find_real_models(args.model_dir)
    if found is None:
        report["real_model_parity"] = {"status": "skipped", "reason": "files absent"}
        print(
            "real-model parity: SKIPPED (files absent — set FRT_REAL_MODELS_DIR or place "
            f"{DET_FILE} + {REC_FILE} in the model dir)"
        )
    else:
        try:
            parity = run_real_model_parity(found["det"], found["rec"], cfg=_cfg(args),
                                           device=dev)
            report["real_model_parity"] = {"status": "ok", "dir": found["dir"], **parity}
            print(
                f"real-model parity: OK ({found['dir']} — exec cosine "
                f"{parity['recognizer']['exec_cosine']:.6f}, native-mapped="
                f"{parity['recognizer']['mapped_native']})"
            )
        except Exception as e:  # noqa: BLE001 — a failing proof IS the diagnosis
            report["real_model_parity"] = {"status": "FAIL", "dir": found["dir"],
                                           "error": str(e)}
            print(f"real-model parity: FAIL — {e}")
    if os.path.exists(args.gallery):
        from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank

        try:
            bank = GalleryBank.load(args.gallery, device=dev)
            dup = [
                (a, b, s) for a, b, s in bank.find_duplicates(threshold=0.8)
                if a != b  # same-name rows are intentional multi-enrolls
            ]
            report["gallery"] = {
                "path": args.gallery,
                "rows": len(bank),
                "identities": len(set(bank.names)),
                "cross_name_duplicates": [
                    {"a": a, "b": b, "sim": round(s, 4)} for a, b, s in dup[:20]
                ],
            }
            print(f"gallery {args.gallery}: {len(bank)} 条 / "
                  f"{report['gallery']['identities']} 个身份")
            if dup:
                print(f"疑似重复注册 (不同名字, 相似度 > 0.80): {len(dup)} 对")
                for a, b, s in dup[:5]:
                    print(f"  {a} ≈ {b}  ({s:.4f})")
        except Exception as e:  # noqa: BLE001 — a broken file IS the diagnosis
            report["gallery"] = {"path": args.gallery, "error": str(e)}
            print(f"gallery 加载失败: {e}")
    return report


@contextlib.contextmanager
def _stdout_to_stderr():
    """Send everything written to stdout to stderr: Python's prints, and
    writes to file descriptor 1 by native code or child processes (a
    first-use build, a driver warning)."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            yield
    finally:
        sys.stderr.flush()
        ctypes.CDLL(None).fflush(None)  # C stdio buffers, before fd 1 returns
        os.dup2(saved, 1)
        os.close(saved)


def main(argv=None):
    json_mode = "--json" in (argv if argv is not None else sys.argv[1:])
    if not json_mode:
        print("InsightFace GPU Demo - buffalo_sc 模型 (facerecognizeonnx_tpu_torch)")
        print("========================================")
    parser = argparse.ArgumentParser(prog="facerecognizeonnx_tpu_torch")
    parser.add_argument(
        "mode",
        choices=["detect", "compare", "simple", "webcam", "enroll", "identify",
                 "bench", "export", "serve", "train", "eval", "doctor"],
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="machine-readable: ONE JSON document on stdout, human output on "
        "stderr (detect/compare/simple/webcam/enroll/identify/doctor)",
    )
    parser.add_argument("images", nargs="*")
    parser.add_argument("--det-model", default=None, help=".npz or .onnx detector weights")
    parser.add_argument("--rec-model", default=None, help=".npz or .onnx recognizer weights")
    parser.add_argument("--gallery", default="gallery.npz")
    parser.add_argument(
        "--rec-arch",
        default="iresnet50",
        choices=["iresnet18", "iresnet34", "iresnet50", "iresnet100",
                 "mbf", "mbf_large", "vit_t", "vit_s", "vit_b"],
        help="recognizer family member (w600k_r50=iresnet50, w600k_mbf=mbf)",
    )
    parser.add_argument(
        "--det-variant",
        default="500m",
        choices=["500m", "2.5g", "10g", "500m_s2d", "tpu"],
        help="SCRFD detector family member (det_500m default)",
    )
    parser.add_argument(
        "--pack",
        default=None,
        choices=["buffalo_sc", "buffalo_s", "buffalo_m", "buffalo_l"],
        help="named buffalo pack: sets --det-variant/--rec-arch; seeded weights "
        "unless the pack's .onnx files are in --model-dir",
    )
    parser.add_argument("--model-dir", default="models",
                        help="pack directory holding det_*.onnx / w600k_*.onnx")
    parser.add_argument("--sharded", action="store_true",
                        help="identify/serve: shard the gallery rows over the ranks")
    parser.add_argument("--aot", default=None,
                        help="serve: answer /identify from a .frtz AOT bundle (export out.frtz)")
    parser.add_argument("--dp", type=int, default=0,
                        help="serve: data-parallel rank count (-1 = every rank of the "
                        "process group; clamped to its size)")
    parser.add_argument(
        "--fuse-search",
        action="store_true",
        help="serve: one-dispatch identify — the gallery top-k runs in the device "
        "step (requests asking for more than 5 matches take the host-side search)",
    )
    parser.add_argument("--experts", default=None, metavar="W1,W2,...",
                        help="enroll: expert recognizers routed by yaw")
    parser.add_argument(
        "--adaptive-embed",
        action="store_true",
        help="serve/webcam --track: occupancy-adaptive bucketed embed — the embed "
        "packs DETECTED faces into a power-of-two bucket sized by recent occupancy",
    )
    parser.add_argument("--quant", default="none", choices=["none", "w8a8", "w8a8-fast"],
                        help="int8 recognizer: w8a8 = full, w8a8-fast = the wide convs only")
    parser.add_argument(
        "--quant-calib", nargs="+", default=None, metavar="IMAGE",
        help="images (files/dirs/globs) whose detected+aligned faces calibrate the "
        "int8 activation scales (default: synthetic noise)",
    )
    parser.add_argument("--detector", action="store_true",
                        help="export: the detector (train: not ported yet)")
    parser.add_argument(
        "--det-size", type=int, default=None,
        help="detector input size override (default 640, the reference's)",
    )
    parser.add_argument("--show", action="store_true", help="open display windows")
    parser.add_argument(
        "--track", action="store_true",
        help="webcam: IOU tracker + per-track embedding cache (embed only new / "
        "refresh-due tracks instead of every face every frame)",
    )
    parser.add_argument("--host", default="127.0.0.1", help="serve: bind host")
    parser.add_argument("--port", type=int, default=8080, help="serve: bind port")
    parser.add_argument(
        "--auth-token",
        default=os.environ.get("FRT_AUTH_TOKEN"),
        help="serve: require 'Authorization: Bearer <token>' on every request "
        "(default: FRT_AUTH_TOKEN env var; unset = open)",
    )
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host CPU instead of the CUDA card")
    parser.add_argument("--enroll-first", action="store_true",
                        help="webcam: enroll the first detected face automatically")
    parser.add_argument("--batch", type=int, default=None,
                        help="export out.frtz: the bundle's frame batch (default 8); "
                        "train/eval (not ported yet)")
    for flag, kw in (("--steps", dict(type=int, default=200)),
                     ("--lr", dict(type=float, default=None)),
                     ("--margin", dict(type=float, default=0.5)),
                     ("--out", dict(default="trained_rec.npz")),
                     ("--train-ckpt", dict(default=None)),
                     ("--ckpt-every", dict(type=int, default=0)),
                     ("--pairs", dict(type=int, default=2000)),
                     ("--folds", dict(type=int, default=10)),
                     ("--pairs-file", dict(default=None)),
                     ("--det-gt", dict(default=None)),
                     ("--det-iou", dict(type=float, default=0.5))):
        parser.add_argument(flag, help="train/eval (not ported yet)", **kw)
    parser.add_argument("--no-augment", action="store_true", help="train (not ported yet)")
    parser.add_argument("--align", action="store_true", help="train/eval (not ported yet)")
    args = parser.parse_args(argv)
    args.device = "cpu" if args.cpu else "cuda"

    if args.json:
        # human output (the banner of a pack, builds, diagnostics) goes to
        # stderr; stdout carries exactly one JSON document
        with _stdout_to_stderr():
            ret = _run(args)
        if isinstance(ret, dict):
            print(json.dumps(ret, ensure_ascii=False), flush=True)
            return 0
        return ret or 0
    ret = _run(args)
    return 0 if isinstance(ret, dict) else (ret or 0)


def _run(args):
    if args.mode in UNPORTED_MODES:
        raise NotImplementedError(f"{args.mode}: {UNPORTED_MODES[args.mode]}")
    if args.det_size and args.det_size % 32:
        # strides go to 32: the head grids are input_size//stride and must
        # tile the conv pyramid exactly
        print(f"--det-size 必须是 32 的倍数 (得到 {args.det_size})")
        return -1
    if args.pack:
        from facerecognizeonnx_tpu_torch.models.packs import resolve_pack

        pack, det_path, rec_path = resolve_pack(args.pack, args.model_dir)
        args.det_variant = pack.det_variant
        args.rec_arch = pack.rec_arch
        # explicit --det-model/--rec-model beat the pack's files
        args.det_model = args.det_model or det_path
        args.rec_model = args.rec_model or rec_path
        print(
            f"模型包 {args.pack}: det_{pack.det_variant} + {pack.rec_arch}"
            + (f" ({args.model_dir}/)" if det_path or rec_path else " (确定性初始化权重)")
        )
    dispatch = {
        "detect": mode_detect,
        "compare": mode_compare,
        "simple": mode_simple,
        "webcam": mode_webcam,
        "enroll": mode_enroll,
        "identify": mode_identify,
        "serve": mode_serve,
        "export": mode_export,
        "doctor": mode_doctor,
    }
    need = {"detect": 1, "compare": 2, "simple": 2, "webcam": 0, "enroll": 1,
            "identify": 1, "serve": 0, "export": 1, "doctor": 0}
    if len(args.images) < need[args.mode]:
        print("无效的命令或参数")
        return -1
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"{e} (CLI: --cpu)")
        return -1
    return dispatch[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
