"""Eigensolves from matvec access only: the large-d (crossover) merge and
extract, the parallel-deflation lanes and elastic k, on one device or a
mesh of ranks.

Counterpart of ``distributed_eigenspaces_tpu/solvers``. ``PCAConfig`` holds
the dispatch: ``solver="distributed"`` sends the merge through
:func:`merged_top_k_distributed` when ``dim > eigh_crossover_d``
(``cfg.uses_distributed_solve()``), ``solver="deflation"`` through
:func:`merged_top_k_deflation` (``cfg.uses_deflation_solve()``). The mesh
variants (``dist_merged_top_k``, ``dist_deflation_eig``,
``dist_merged_top_k_deflation``, and ``axis_name=`` on the others) run
inside ``parallel.mesh.mesh_scope``. The exports are the
reference's; ``fused_factor_matvec`` is reached, as there, from
``solvers.distributed``.
"""

from distributed_eigenspaces_tpu_torch.solvers.deflation import (
    deflation_eig,
    dist_deflation_eig,
    dist_merged_top_k_deflation,
    grow_basis,
    grow_directions,
    merged_top_k_deflation,
)
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
    "deflation_eig",
    "dist_canonicalize_signs",
    "dist_deflation_eig",
    "dist_extract_top_k",
    "dist_merged_top_k",
    "dist_merged_top_k_deflation",
    "dist_rayleigh_ritz",
    "dist_subspace_eig",
    "factor_matvec",
    "grow_basis",
    "grow_directions",
    "lowrank_matvec",
    "merged_top_k_deflation",
    "merged_top_k_distributed",
    "subspace_residual",
]
