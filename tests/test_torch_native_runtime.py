"""The port's native host runtime vs the JAX package's, bit for bit.

Both packages build their own copy of frt_runtime.cc with g++ (the port
into its gitignored `_build/`, with -ffp-contract=off, which changes
nothing on an x86-64 host); the same seeded inputs go through both
sets of bindings, and every output must be equal.
"""

import io
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from facerecognizeonnx_tpu.runtime import native as j_native
from facerecognizeonnx_tpu_torch.runtime import native

LETTERBOX_SHAPES = [(480, 640), (720, 1280), (128, 128), (16, 77), (1280, 720), (251, 317)]


def jax_native_built() -> bool:
    """Whether the JAX package's runtime library loads; its codecs as the
    value. That package builds the library with `make` in its source
    folder at first use, and test processes that start together can race
    there: one may load the file while another rewrites it, and the loser
    caches the failure. Retry until the file is whole."""
    for _ in range(10):
        if j_native.native_available():
            return j_native.codecs_available()
        time.sleep(1.0)
        j_native._build_failed = False
    raise AssertionError("the JAX package's native runtime does not load")


@pytest.fixture(scope="module", autouse=True)
def _both_built():
    jax_native_built()
    assert native.native_available()


@pytest.mark.parametrize("hw", LETTERBOX_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("target", [640, 128])
def test_letterbox_equals_jax_runtime(hw, target):
    img = np.random.default_rng(hw[0] * 7 + hw[1]).integers(0, 256, hw + (3,), dtype=np.uint8)
    got, scale = native.letterbox_native(img, target)
    want, want_scale = j_native.letterbox_native(img, target)
    assert got.dtype == np.uint8 and got.shape == (target, target, 3)
    assert scale == want_scale
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(720, 1280), (251, 317), (16, 77)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_letterbox_equals_its_numpy_transcription(hw):
    """chip_smoke.letterbox_numpy, which holds the library on the GPU host
    (no JAX there), is the same function bit for bit."""
    from chip_smoke import letterbox_numpy

    img = np.random.default_rng(hw[1]).integers(0, 256, hw + (3,), dtype=np.uint8)
    got, scale = native.letterbox_native(img, 640)
    want, want_scale = letterbox_numpy(img, 640)
    np.testing.assert_array_equal(got, want)
    assert scale == want_scale


def test_letterbox_rejects_a_non_bgr_image():
    with pytest.raises(ValueError):
        native.letterbox_native(np.zeros((8, 8), np.uint8), 16)


def _clustered(rng, n, float_coords):
    c = rng.uniform(20, 200, (6, 2))[rng.integers(0, 6, n)] + rng.normal(0, 5, (n, 2))
    wh = rng.uniform(15, 50, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    return (boxes if float_coords else np.round(boxes)).astype(np.float32)


@pytest.mark.parametrize("int_rects", [True, False])
@pytest.mark.parametrize("float_coords", [True, False], ids=["float_rects", "int_rects_in"])
def test_nms_equals_jax_runtime(int_rects, float_coords):
    rng = np.random.default_rng(5)
    boxes = _clustered(rng, 96, float_coords)
    scores = np.round(rng.uniform(0, 1, 96), 2).astype(np.float32)  # ties included
    got = native.nms_native(boxes, scores, 0.4, int_rects=int_rects)
    want = j_native.nms_native(boxes, scores, 0.4, int_rects=int_rects)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_frame_ring_roundtrip_blocking_and_drain():
    rng = np.random.default_rng(0)
    ring = native.FrameRing(2, (8, 8, 3))
    frames = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    assert ring.push(frames[0], 0.5) and ring.push(frames[1], 0.25)
    assert len(ring) == 2
    assert not ring.push(frames[0], timeout_ms=50)  # full: times out
    ring.close()
    assert not ring.push(frames[0], timeout_ms=50)  # closed
    for f, s in zip(frames, (0.5, 0.25)):  # a closed ring drains first
        out, scale = ring.pop()
        np.testing.assert_array_equal(out, f)
        assert scale == s
    assert ring.pop() is None
    with pytest.raises(ValueError):
        native.FrameRing(1, (4, 4, 3)).push(np.zeros((4, 5, 3), np.uint8))


def test_frame_ring_threads_keep_fifo_order():
    ring = native.FrameRing(3, (4, 4, 3))
    frames = np.random.default_rng(1).integers(0, 256, (40, 4, 4, 3), dtype=np.uint8)

    def produce():
        for i, f in enumerate(frames):
            while not ring.push(f, float(i), timeout_ms=100):
                pass
        ring.close()

    t = threading.Thread(target=produce)
    t.start()
    seen = []
    while (item := ring.pop(timeout_ms=5000)) is not None:
        seen.append(item)
    t.join(10)
    assert not t.is_alive() and len(seen) == len(frames)
    for i, (f, s) in enumerate(seen):
        assert s == float(i)
        np.testing.assert_array_equal(f, frames[i])


def test_prefetch_loader_equals_jax_letterbox():
    rng = np.random.default_rng(2)
    src = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(5)]
    loader = native.PrefetchLoader(iter(src), target=64, capacity=2)
    got = list(loader.frames())
    loader.join(5)
    assert len(got) == 5
    for (frame, scale), img in zip(got, src):
        want, want_scale = j_native.letterbox_native(img, 64)
        np.testing.assert_array_equal(frame, want)
        assert scale == want_scale


def test_prefetch_loader_close_stops_an_endless_source():
    def endless():
        frame = np.zeros((32, 32, 3), np.uint8)
        while True:
            yield frame

    loader = native.PrefetchLoader(endless(), target=16, capacity=2)
    frames = loader.frames()
    next(frames)
    loader.close()
    assert not loader._thread.is_alive()


def _encode(img_rgb, fmt):
    buf = io.BytesIO()
    Image.fromarray(img_rgb).save(buf, fmt, **({"quality": 95} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _need_codecs():
    if not jax_native_built():
        pytest.skip("the JAX package's runtime was built without codecs")
    assert native.codecs_available()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_decode_and_decode_letterbox_equal_jax(fmt):
    _need_codecs()
    img = np.random.default_rng(3).integers(0, 256, (61, 83, 3), dtype=np.uint8)
    data = _encode(img, fmt)
    got = native.decode_native(data)
    np.testing.assert_array_equal(got, j_native.decode_native(data))
    if fmt == "PNG":
        np.testing.assert_array_equal(got, img[..., ::-1])  # BGR out
    frame, scale = native.decode_letterbox_native(data, 64)
    want, want_scale = j_native.decode_letterbox_native(data, 64)
    np.testing.assert_array_equal(frame, want)
    assert scale == want_scale
    assert native.decode_native(b"not an image") is None
    assert native.decode_native(b"\xff\xd8\xff\xe0" + b"\x00" * 16) is None


def test_native_image_loader_and_imread(tmp_path):
    _need_codecs()
    from facerecognizeonnx_tpu.io.imageio import imread as j_imread
    from facerecognizeonnx_tpu_torch.io.imageio import imread

    rng = np.random.default_rng(4)
    paths = []
    for i in range(7):
        img = rng.integers(0, 256, (50 + i, 70, 3), dtype=np.uint8)
        p = tmp_path / f"im{i}.{'png' if i % 2 else 'jpg'}"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    (tmp_path / "bad.jpg").write_bytes(b"junk")
    paths += [str(tmp_path / "bad.jpg"), str(tmp_path / "missing.png")]
    with native.NativeImageLoader(paths, 64, threads=2, capacity=3) as loader:
        got = {idx: (frame, scale) for idx, frame, scale in loader}
    assert sorted(got) == list(range(len(paths)))  # every input accounted for
    assert got[7][0] is None and got[8][0] is None  # corrupt and missing
    for i in range(7):
        with open(paths[i], "rb") as f:
            want, want_scale = j_native.decode_letterbox_native(f.read(), 64)
        np.testing.assert_array_equal(got[i][0], want)
        assert got[i][1] == want_scale
        np.testing.assert_array_equal(imread(paths[i]), j_imread(paths[i]))
    assert imread(str(tmp_path / "missing.png")) is None


def test_native_image_loader_early_close(tmp_path):
    _need_codecs()
    img = np.random.default_rng(6).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    paths = []
    for i in range(24):
        Image.fromarray(img).save(tmp_path / f"i{i}.png")
        paths.append(str(tmp_path / f"i{i}.png"))
    loader = native.NativeImageLoader(paths, 32, threads=2, capacity=2)
    it = iter(loader)
    next(it)
    next(it)  # the workers now wait on the full queue
    loader.close()  # joins them without a deadlock
    assert loader._h is None


def test_library_builds_into_the_gitignored_build_dir():
    so = Path(native._load()._name)
    pkg = Path(native.__file__).resolve().parent.parent
    assert so.parent == pkg / "_build" and so.name.startswith("frt_runtime_")
    assert not list((pkg / "runtime").rglob("*.so"))
    assert "facerecognizeonnx_tpu_torch/_build/" in (pkg.parent / ".gitignore").read_text()


def test_imwrite_and_video_source_equal_jax(tmp_path):
    from facerecognizeonnx_tpu.io.imageio import VideoSource as JaxSource
    from facerecognizeonnx_tpu.io.imageio import imread as j_imread
    from facerecognizeonnx_tpu_torch.io.imageio import VideoSource, imread, imwrite

    src, ref = VideoSource("synthetic:40x30x3"), JaxSource("synthetic:40x30x3")
    assert src.is_open()
    got, want = list(src.frames()), list(ref.frames())
    assert len(got) == 3 and got[0].shape == (30, 40, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    src.release()
    path = str(tmp_path / "frame.png")
    assert imwrite(path, got[1])
    np.testing.assert_array_equal(imread(path), got[1])
    np.testing.assert_array_equal(j_imread(path), got[1])


def test_letterbox_host_takes_native_else_the_torch_letterbox(monkeypatch):
    """The service's and the video path's host letterbox: the native one
    (rounds) where it builds, else the torch letterbox truncated to uint8
    (the reference's own fallback)."""
    import torch

    from facerecognizeonnx_tpu_torch.ops import image

    img = np.random.default_rng(8).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    got, scale = image.letterbox_host(img, 128)
    want, want_scale = native.letterbox_native(img, 128)
    np.testing.assert_array_equal(got, want)
    assert scale == want_scale
    monkeypatch.setattr(native, "native_available", lambda: False)
    got, scale = image.letterbox_host(img, 128)
    padded, want_scale = image.letterbox(torch.from_numpy(img), 128)
    np.testing.assert_array_equal(got, padded.numpy().astype(np.uint8))
    assert scale == want_scale and got.dtype == np.uint8
