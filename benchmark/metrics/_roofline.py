"""A hand-written kernel's share of its roofline: the least time its
calls could take on the chip (bytes over the HBM peak or operations over
the compute peak, whichever is larger, summed over the traced calls)
over their traced device time. The work is what the traced batches
needed, however many launches they took."""

from benchmark.counts import peaks


def kernel_s(s, symbol: str) -> float:
    """Traced device seconds of the device functions named `symbol`."""
    return sum(k["s"] for n, k in s.get("ops", {}).items() if symbol in n)


def share(s, kernel: str, symbol: str):
    """`kernel`: its key in the drive's work counts; `symbol`: its device
    function's name in the trace."""
    w = s.get("work", {}).get("kernels", {}).get(kernel)
    t = kernel_s(s, symbol)
    if not w or t <= 0:
        return None
    return 100.0 * peaks.roofline_s(w["flops"], w["bytes"], s["precision"]) / t
