"""Online distributed PCA in PyTorch, with hand-written CUDA kernels for
Hopper (H100).

A port of ``distributed_eigenspaces_tpu`` (the JAX package, kept as the
reference) that mirrors its layout: ``config``, ``ops``, ``parallel``,
``algo``, ``data``, ``api``. It imports neither JAX nor the JAX package.
Entry points run on ``device="cuda"`` unless the caller asks for another
device, and raise when no card is present.
"""

from __future__ import annotations

from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit
from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data.synthetic import planted_spectrum

__all__ = [
    "OnlineDistributedPCA",
    "OnlineState",
    "PCAConfig",
    "entry",
    "make_scan_fit",
    "make_train_step",
    "planted_spectrum",
]


def entry(*, device="cuda", v0=None):
    """``(step, (state, x))``: the online round plus state update on the
    flagship configuration of ``__graft_entry__.entry()`` (m=4, n=128,
    d=256, k=8, subspace solver at 12 iterations, the same ``x``).
    ``v0`` overrides the cold start basis (default: seeded draw)."""
    import numpy as np
    import torch

    m, n, d, k = 4, 128, 256, 8
    cfg = PCAConfig(
        dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=10,
        solver="subspace", subspace_iters=12,
    )
    step = make_train_step(cfg, device=device, v0=v0)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((m, n, d)), dtype=torch.float32)
    state = OnlineState.initial(d, device=device)
    return step, (state, x.to(state.sigma_tilde.device))
