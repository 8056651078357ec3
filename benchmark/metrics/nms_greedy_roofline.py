"""`nms_greedy`'s share of its roofline (metrics/_roofline.py) in the dense cells,
bytes from benchmark/counts/kernels.py, time of the device function
`nms_greedy_kernel`."""

from benchmark.metrics import _identify
from benchmark.metrics._roofline import share

UNIT = "%"


def read(s):
    return share(s, "nms_greedy", "nms_greedy_kernel") if _identify.serves(s, "dense") else None
