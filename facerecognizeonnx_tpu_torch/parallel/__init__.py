"""The parallel layer of the port on `torch.distributed`: the mesh
(`mesh.py`, one device per rank), the sharded gallery search and the
data-parallel programs (`sharded_ops.py`), tensor, expert and pipeline
parallelism, and multi-process initialization (`distributed.py`)."""

from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh
from facerecognizeonnx_tpu_torch.parallel.sharded_ops import (
    sharded_batch_embed,
    sharded_topk_search,
)

__all__ = ["make_mesh", "sharded_topk_search", "sharded_batch_embed"]
