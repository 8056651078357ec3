"""The port's PNG reader (`io.imageio.decode_png`) and the decode chain.

`decode_png` is the last decoder of `decode_image` / `imread` (native
codecs, cv2, PIL, then it): on a host without the codecs, cv2 and PIL
it is the only one. It must give what cv2.imdecode(IMREAD_COLOR) gives,
bit for bit: PNGs of every colour type it reads, each with every filter
type on all its scanlines (written by chip_smoke.png_bytes), and PNGs
that cv2 writes (its own filter choice per line).
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from chip_smoke import png_bytes
from facerecognizeonnx_tpu_torch.io import imageio
from facerecognizeonnx_tpu_torch.io.imageio import decode_image, decode_png, imread, imwrite
from facerecognizeonnx_tpu_torch.runtime import native


def _cv2_decode(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize("filter_type", range(5), ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["grey", "grey_alpha", "rgb", "rgba"])
def test_decode_png_matches_cv2(channels, filter_type):
    px = np.random.default_rng(channels * 5 + filter_type).integers(
        0, 256, (23, 37, channels), dtype=np.uint8
    )
    data = png_bytes(px, filter_type)
    got, want = decode_png(data), _cv2_decode(data)
    assert want is not None and got is not None
    assert got.dtype == np.uint8 and got.shape == want.shape == (23, 37, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(31, 45), (31, 45, 3), (31, 45, 4)], ids=["grey", "bgr", "bgra"])
def test_decode_png_matches_cv2_written_files(shape):
    rng = np.random.default_rng(3)
    # a smooth ramp plus noise, so cv2's encoder picks more than one filter
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])).astype(np.uint8)
    img = (ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
           + rng.integers(0, 8, shape, dtype=np.uint8))
    ok, enc = cv2.imencode(".png", img)
    assert ok
    np.testing.assert_array_equal(decode_png(enc.tobytes()), _cv2_decode(enc.tobytes()))


def _scanlines(data: bytes) -> np.ndarray:
    """The filtered scanlines (each led by its filter type) of a PNG of
    png_bytes, as rows of one array."""
    height = struct.unpack(">I", data[20:24])[0]
    length = struct.unpack(">I", data[33:37])[0]  # the IDAT after the IHDR
    return np.frombuffer(zlib.decompress(data[41:41 + length]), np.uint8).reshape(height, -1)


@pytest.mark.parametrize("shape", [(1, 9), (9, 1), (23, 37), (37, 23)],
                         ids=["one_row", "one_column", "wide", "tall"])
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
def test_decode_png_mixed_filter_rows(channels, shape):
    """Each scanline with a filter type of its own, as libpng's adaptive
    filtering writes them (the reader undoes such an image by anti-
    diagonals); one row and one column are its shortest diagonals."""
    rng = np.random.default_rng(channels * 7 + shape[0])
    px = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    filtered = [_scanlines(png_bytes(px, t)) for t in range(5)]
    types = rng.integers(0, 5, shape[0])
    types[shape[0] // 2] = 4  # at least one Paeth row
    body = zlib.compress(np.stack([filtered[t][y] for y, t in enumerate(types)]).tobytes())
    header = png_bytes(px)[:33]  # the signature and IHDR
    data = (header + struct.pack(">I", len(body)) + b"IDAT" + body
            + struct.pack(">I", zlib.crc32(b"IDAT" + body))
            + struct.pack(">I", 0) + b"IEND" + struct.pack(">I", zlib.crc32(b"IEND")))
    want = _cv2_decode(data)
    assert want is not None
    np.testing.assert_array_equal(decode_png(data), want)


def _with_header_byte(data: bytes, offset: int, value: int) -> bytes:
    """The PNG with one IHDR field byte replaced (CRC left stale: the
    reader does not check it)."""
    at = 8 + 8 + offset  # signature, then the chunk's length and tag
    return data[:at] + bytes([value]) + data[at + 1:]


def test_decode_png_refuses_what_it_does_not_read():
    rng = np.random.default_rng(5)
    ok, enc16 = cv2.imencode(".png", rng.integers(0, 65535, (9, 11, 3), dtype=np.uint16))
    assert ok and enc16.tobytes()[24] == 16  # a 16-bit file
    assert decode_png(enc16.tobytes()) is None
    data = png_bytes(rng.integers(0, 256, (9, 11, 3), dtype=np.uint8))
    assert decode_png(_with_header_byte(data, 12, 1)) is None  # interlaced (Adam7)
    assert decode_png(_with_header_byte(data, 9, 3)) is None  # palette
    assert decode_png(data[:40]) is None  # cut inside the image data
    assert decode_png(b"not an image") is None
    header = data[:33]  # the signature and IHDR
    assert decode_png(header) is None  # no image data
    row = zlib.compress(b"\x05" + bytes(33))  # filter type 5 does not exist
    one_row = _with_header_byte(header, 7, 1)  # height 1
    assert decode_png(one_row + struct.pack(">I", len(row)) + b"IDAT" + row) is None


@pytest.fixture
def only_the_png_reader(monkeypatch):
    """decode_image / imread with the native decoder, cv2 and PIL away."""
    monkeypatch.setattr(native, "decode_native", lambda data: None)
    monkeypatch.setattr(imageio, "_cv2", lambda: None)
    monkeypatch.setattr(imageio, "_pil_image", lambda: None)


def test_decode_chain_reaches_the_png_reader(only_the_png_reader, tmp_path):
    rgb = np.random.default_rng(8).integers(0, 256, (17, 29, 3), dtype=np.uint8)
    data = png_bytes(rgb, 4)
    want = np.ascontiguousarray(rgb[..., ::-1])
    np.testing.assert_array_equal(decode_image(data), want)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(imread(str(path)), want)
    ok, jpg = cv2.imencode(".jpg", want)
    assert decode_image(jpg.tobytes()) is None  # no JPEG decoder is left
    assert imread(str(tmp_path / "missing.png")) is None
    with pytest.raises(RuntimeError, match="no image encoder"):
        imwrite(str(tmp_path / "out.png"), want)


def test_decode_chain_order(tmp_path):
    """With every decoder present, JPEG and PNG bytes decode as cv2 does
    (native codecs or cv2 first), and imread reads the file's bytes."""
    bgr = np.random.default_rng(2).integers(0, 256, (40, 52, 3), dtype=np.uint8)
    for ext in (".png", ".jpg", ".bmp"):
        ok, enc = cv2.imencode(ext, bgr)
        assert ok
        np.testing.assert_array_equal(decode_image(enc.tobytes()), _cv2_decode(enc.tobytes()))
        path = tmp_path / f"x{ext}"
        path.write_bytes(enc.tobytes())
        np.testing.assert_array_equal(imread(str(path)), cv2.imread(str(path)))
