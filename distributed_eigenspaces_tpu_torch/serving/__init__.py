"""The read path: versioned eigenbasis registry, micro-batched query server
and the projection engine under it, single device.

- :mod:`.registry`: append-only store of immutable basis versions with a
  lock-free ``latest()`` pointer and a crash-safe disk tier whose format is
  the JAX package's.
- :mod:`.transform`: :class:`TransformEngine`, projection / reconstruction
  / residual energy with the basis as an operand and rows padded to
  buckets; ``serve_dtype`` bfloat16 and int8 run the serve kernels.
- :mod:`.server`: :class:`QueryServer`, deadline micro-batched admission,
  a double-buffered basis swap, per-request error isolation.
- :mod:`.drift`: :class:`DriftMonitor`, served residual energy and a
  refit's angle gap folded into a drift score; past threshold the refit
  publishes as a new version.
- :mod:`.replication`: :class:`ReplicaRegistry` replicas tailing one
  committed store under a staleness bound, and the :class:`PublisherLease`
  single-writer election with epoch fencing.
"""

from distributed_eigenspaces_tpu_torch.serving.drift import DriftMonitor
from distributed_eigenspaces_tpu_torch.serving.registry import (
    BasisVersion,
    EigenbasisRegistry,
    VersionRetired,
)
from distributed_eigenspaces_tpu_torch.serving.replication import (
    LeaseLost,
    PublisherLease,
    ReplicaRegistry,
)
from distributed_eigenspaces_tpu_torch.serving.server import (
    BreakerOpen,
    DeadlineExceeded,
    QueryServer,
    ServedProjection,
    ServerClosed,
    ServerOverloaded,
)
from distributed_eigenspaces_tpu_torch.serving.transform import (
    TransformEngine,
    bucket_rows,
)

__all__ = [
    "BasisVersion",
    "BreakerOpen",
    "DeadlineExceeded",
    "DriftMonitor",
    "EigenbasisRegistry",
    "LeaseLost",
    "PublisherLease",
    "QueryServer",
    "ReplicaRegistry",
    "ServedProjection",
    "ServerClosed",
    "ServerOverloaded",
    "TransformEngine",
    "VersionRetired",
    "bucket_rows",
]
