"""Eigensolves from matvec access only: the large-d (crossover) merge and
extract, on one device.

Counterpart of ``distributed_eigenspaces_tpu/solvers``. ``PCAConfig`` holds
the dispatch: ``solver="distributed"`` sends the merge through
:func:`merged_top_k_distributed` when ``dim > eigh_crossover_d``
(``cfg.uses_distributed_solve()``). The parallel-deflation solvers
(``solvers/deflation.py``) are not ported yet (ROADMAP.md Queue 1 item 13).
The exports are the reference's; ``fused_factor_matvec`` is reached, as
there, from ``solvers.distributed``.
"""

from distributed_eigenspaces_tpu_torch.solvers.distributed import (
    dist_canonicalize_signs,
    dist_extract_top_k,
    dist_merged_top_k,
    dist_rayleigh_ritz,
    dist_subspace_eig,
    factor_matvec,
    lowrank_matvec,
    merged_top_k_distributed,
    subspace_residual,
)

__all__ = [
    "dist_canonicalize_signs",
    "dist_extract_top_k",
    "dist_merged_top_k",
    "dist_rayleigh_ritz",
    "dist_subspace_eig",
    "factor_matvec",
    "lowrank_matvec",
    "merged_top_k_distributed",
    "subspace_residual",
]
