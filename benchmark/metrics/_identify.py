"""What the identify cells' per-layer readers share. A cell's `family`
(its workload file) names the end-to-end metrics it reports, and so the
readers that serve it: "dense" cells report `frames_per_s` and
`batch_ms_p95`, read by the unsuffixed readers; "bucketed" cells report
`frames_per_s.bucketed` and `batch_ms_p95.bucketed`, read by the
`.bucketed` ones. A reader returns None in a cell of another family."""

from benchmark.counts import peaks
from benchmark.metrics._roofline import kernel_s


def serves(s, family: str) -> bool:
    return s.get("kind") == "identify" and s.get("family") == family


def detect_ms(s, family: str):
    """Device ms per batch of the detect layer: the detector's forward and
    everything launched after it until the recognizer starts (decode,
    top-k, the NMS kernel, the align matrices, compaction), the warp
    kernels left out (they are the align layer's)."""
    layers = s.get("layers_s", {})
    if not serves(s, family) or not s["batches"] or "detect" not in layers:
        return None
    warps = kernel_s(s, "warp_xm_kernel") + kernel_s(s, "pyramid_kernel")
    total = layers["detect"] + layers.get("detect_post", 0.0) - warps
    return total / s["batches"] * 1e3


def embed_ms(s, family: str):
    """Device ms per batch inside the recognizer's forward."""
    if not serves(s, family) or not s["batches"] or "embed" not in s.get("layers_s", {}):
        return None
    return s["layers_s"]["embed"] / s["batches"] * 1e3


def dispatch_ms(s, family: str):
    """Host ms inside the entry point's dispatching call per batch (the
    benchmark's span around `frames_to_matches` or `start`), over the
    window's batches outside the profiled part."""
    d = s.get("host", {}).get("dispatch_s")
    if not serves(s, family) or not d:
        return None
    return 1e3 * sum(d) / len(d)


def device_idle(s, family: str):
    """Share of the traced window in which no operation ran on the device."""
    if not serves(s, family) or s.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu(s, family: str):
    """The whole step's model FLOPs (detector, recognizer on the served
    faces, the 1:N match) over the traced window, as a share of the peak
    of the configuration's precision."""
    if not serves(s, family) or s.get("window_s", 0) <= 0:
        return None
    return 100.0 * s["work"]["model_flops"] / (s["window_s"] * peaks.FLOPS[s["precision"]])
