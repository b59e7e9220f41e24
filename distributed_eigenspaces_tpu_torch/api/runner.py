"""Extraction of the final estimate from the running state.

Counterpart of ``extract_dense`` in ``distributed_eigenspaces_tpu/api/
runner.py``. The reference's other whole-fit kinds (segmented, sketch,
fleet, feature-sharded) are not ported yet (ROADMAP.md Queue 1 item 9f).
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import initial_basis, merged_top_k


def extract_dense(cfg: PCAConfig, sigma_tilde: torch.Tensor, v0=None) -> torch.Tensor:
    """Top-k of the running projector average by the configured solver and
    orthonormalization, at ``max(cfg.subspace_iters, 16)`` iterations from
    ``v0`` (default: :func:`~..ops.linalg.initial_basis` from ``cfg.seed``)
    under the subspace solver. ``solver="distributed"`` resolves to the
    subspace solver here at any d, as in the reference: the state is a dense
    d x d already, so the factor-operator extract has nothing to save."""
    return merged_top_k(
        sigma_tilde.float(), cfg.k, cfg.resolved_local_solver(),
        max(cfg.subspace_iters, 16), cfg.orth_method,
        v0=initial_basis(
            cfg.dim, cfg.k, seed=cfg.seed, device=sigma_tilde.device, v0=v0
        ),
    )
