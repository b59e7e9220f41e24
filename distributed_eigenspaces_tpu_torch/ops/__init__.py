"""Numeric kernels of the port: the linear algebra of the online-PCA round
(``ops.linalg``) and the hand-written Hopper kernels behind it (``gram``,
``serve_project``, ``matvec_gram``, ``gram_s8`` routes). The exports are the
reference's ``ops`` exports but one: ``ops.gram`` is the port's Gram kernel
module, so the plain ``gram`` function is reached as ``ops.linalg.gram`` (or
at the package's top level), never rebinding the module's name here."""

from distributed_eigenspaces_tpu_torch.ops.linalg import (
    canonicalize_signs,
    merge_projectors,
    merged_top_k,
    merged_top_k_lowrank,
    orthonormalize,
    principal_angles,
    principal_angles_degrees,
    projector,
    subspace_iteration,
    top_k_eigvecs,
    top_k_eigvecs_streaming,
)

__all__ = [
    "orthonormalize",
    "merged_top_k",
    "merged_top_k_lowrank",
    "top_k_eigvecs",
    "canonicalize_signs",
    "principal_angles",
    "principal_angles_degrees",
    "projector",
    "merge_projectors",
    "subspace_iteration",
    "top_k_eigvecs_streaming",
]
