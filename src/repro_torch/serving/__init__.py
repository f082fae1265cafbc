"""The serving subsystem of the port: BNNServer over compile(), on one
device or data-parallel over a mesh (DESIGN.md §9/§10/§11).

The counterpart of ``repro.serving``: pow2 batch bucketing with ragged
row-validity masking and a bounded set of CUDA graphs (one per
dispatch level, ``repro_torch.graph.replay``), a continuously-batched
request queue (admission window + dispatch-ahead on a server-owned
stream) with latency percentiles and a ``stats()`` surface, and the
failure-handling contract (errors.py typed taxonomy; deadlines, bounded
queue, poison-batch bisection, a fallback to the ``"torch"`` backend
on the same card, supervised worker loops, ``health()``).  Placement
(``placement.py``) splits request rows over a mesh's data axes and
replicates the parameters per device.
"""

from repro_torch.serving.bucketing import (
    bucket_for,
    bucket_sizes,
    dispatch_grid,
    mask_levels,
    mask_step,
    pow2_ceil,
    ragged_valid,
    split_rows,
    trace_bound,
)
from repro_torch.serving.errors import (
    BackendFault,
    PoisonRequest,
    RequestTimeout,
    ServerOverloaded,
    ServingError,
)
from repro_torch.serving.placement import (
    data_mesh,
    ensure_owned,
    replicate,
    shard_batch,
)
from repro_torch.serving.server import BNNServer

__all__ = [
    "BackendFault",
    "BNNServer",
    "PoisonRequest",
    "RequestTimeout",
    "ServerOverloaded",
    "ServingError",
    "bucket_for",
    "bucket_sizes",
    "data_mesh",
    "dispatch_grid",
    "ensure_owned",
    "mask_levels",
    "mask_step",
    "pow2_ceil",
    "ragged_valid",
    "replicate",
    "shard_batch",
    "split_rows",
    "trace_bound",
]
