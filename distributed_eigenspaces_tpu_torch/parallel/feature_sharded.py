"""The collective forms of the distributed solvers' helpers.

Counterpart of the helpers of ``distributed_eigenspaces_tpu/parallel/
feature_sharded.py`` (``_psum_if``, ``_chol_qr``, ``chol_qr2``,
``_small_eigh_desc``): CholeskyQR2 of a row-sharded ``(..., d_local, k)``
block, its ``k x k`` Gram summed over ``axis_name`` so the block is
orthonormal globally. With ``axis_name=None`` every function is its
one-device twin in ``ops/linalg.py``, bit for bit. The feature-sharded
trainer itself is not ported yet (ROADMAP.md Queue 1 item 15).
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.ops.linalg import _sym, chol_apply
from distributed_eigenspaces_tpu_torch.parallel.mesh import psum


def _psum_if(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis_name``, or ``x`` itself."""
    return psum(x, axis_name) if axis_name else x


def _chol_qr(v: torch.Tensor, axis_name, eps: float = 1e-7) -> torch.Tensor:
    """One CholeskyQR pass on a row-sharded ``v``: the Gram reduced over
    ``axis_name``, then the same Cholesky and triangular solve on every
    rank's rows."""
    g = _psum_if(torch.matmul(v.mT, v), axis_name)
    return chol_apply(v, g, eps)


def chol_qr2(v: torch.Tensor, axis_name=None) -> torch.Tensor:
    """CholeskyQR2 of a row-sharded block: two passes, jitter ``1e-7 *
    trace`` (``ops.linalg.chol_qr2`` when ``axis_name`` is None)."""
    return _chol_qr(_chol_qr(v, axis_name), axis_name)


def _small_eigh_desc(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``eigh`` of a small replicated symmetric matrix, descending."""
    w, q = torch.linalg.eigh(_sym(g))
    return torch.flip(w, dims=(-1,)), torch.flip(q, dims=(-1,))
