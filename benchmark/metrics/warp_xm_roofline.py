"""`warp_xm`'s share of its roofline (metrics/_roofline.py) in the dense cells,
bytes from benchmark/counts/kernels.py, time of the device function
`warp_xm_kernel`."""

from benchmark.metrics import _identify
from benchmark.metrics._roofline import share

UNIT = "%"


def read(s):
    return share(s, "warp_xm", "warp_xm_kernel") if _identify.serves(s, "dense") else None
