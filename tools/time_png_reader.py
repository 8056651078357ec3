"""Time the port's PNG reader (`io.imageio.decode_png`) on a 640x480 RGB
frame written with each PNG filter type, and check it, with the whole
image Paeth-filtered, against a per-byte plain version of the unfilter.

Run from the repository root: python3 tools/time_png_reader.py
Prints one line per filter type (median of 5 decodes, host clock) and the
plain version's time. Needs only numpy: it runs on a host without cv2.
"""

import statistics
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from chip_smoke import png_bytes  # noqa: E402
from facerecognizeonnx_tpu_torch.io.imageio import _unfilter, decode_png  # noqa: E402


def unfilter_plain(raw: np.ndarray, bpp: int) -> np.ndarray:
    """The PNG unfilter byte by byte, in the specification's order."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    up = bytes(stride)  # the row above the first is zeros
    for y in range(h):
        ftype, cur = int(raw[y, 0]), bytearray(raw[y, 1:].tobytes())
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + (0, a, b, (a + b) >> 1, paeth)[ftype]) & 0xFF
        out[y] = np.frombuffer(bytes(cur), np.uint8)
        up = bytes(cur)
    return out


def median_ms(fn, n=5):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    rgb = np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    for ftype, name in enumerate(("none", "sub", "up", "average", "paeth")):
        data = png_bytes(rgb, ftype)
        assert np.array_equal(decode_png(data), rgb[..., ::-1])
        print(f"decode_png 640x480 RGB, filter {name}: {median_ms(lambda: decode_png(data)):.1f} ms")
    raw = np.random.default_rng(1).integers(0, 256, (480, 1 + 640 * 3), dtype=np.uint8)
    raw[:, 0] = 4
    assert np.array_equal(_unfilter(raw, 3), unfilter_plain(raw, 3))
    print(f"unfilter, 640x480 RGB all Paeth: {median_ms(lambda: _unfilter(raw, 3)):.1f} ms | "
          f"per-byte plain version {median_ms(lambda: unfilter_plain(raw, 3), n=1):.1f} ms "
          f"(equal)")


if __name__ == "__main__":
    main()
