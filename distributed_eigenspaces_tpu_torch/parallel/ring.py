"""Explicit ring collectives over a mesh axis (``ppermute`` schedules).

Counterpart of ``distributed_eigenspaces_tpu/parallel/ring.py``: the sum and
the gather of the process group (``parallel.mesh.psum`` / ``all_gather``)
done again as ``size - 1`` hops of a cyclic +1 neighbour exchange
(``parallel.mesh.ppermute``), the communication pattern of ring attention.
Each hop moves one block between ring neighbours only, so per-hop traffic
and memory are constant in the axis size. ``collectives="ring"`` on the
feature-sharded trainers (``parallel/feature_sharded.py``) and the
distributed merge (``solvers/distributed.py``) routes their switchable
reductions here.

One departure from the reference, on purpose. The reference's
``ring_psum`` adds each received block to a running sum, so device ``i``
computes ``x_i + x_{i-1} + ...`` and the replicated result differs across
devices in its last bits. The port's feature-sharded trainers take host
branches on replicated values (``s``, the sketch's ``omega^T y``, the step
count) and rest on every rank holding the same bits. So :func:`ring_psum`
here is :func:`ring_all_gather` (the same ``size - 1`` hops, the same
bytes a hop) followed by a sum of the gathered blocks in source-index
order: one result, bit for bit, on every rank.
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

__all__ = ["ring_all_gather", "ring_psum"]


def _ring_blocks(x: torch.Tensor, axis_name: str) -> list:
    """Every rank's ``x`` along ``axis_name``, indexed by source: this rank's
    own, then ``size - 1`` forward hops, the block after hop ``h`` being the
    one of the rank ``h`` behind."""
    size = pmesh.axis_size(axis_name)
    idx = pmesh.axis_index(axis_name)
    blocks = [None] * size
    blocks[idx] = x
    cur = x
    for hop in range(1, size):
        cur = pmesh.ppermute(cur, axis_name)
        blocks[(idx - hop) % size] = cur
    return blocks


def ring_all_gather(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """All-gather over ``axis_name`` as an explicit ring: the ``(size *
    x.shape[0], ...)`` concatenation of ``parallel.mesh.all_gather(x,
    axis_name)``, each shard placed at its source index."""
    return torch.cat(_ring_blocks(x, axis_name), dim=0)


def ring_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """All-reduce-sum over ``axis_name`` as an explicit ring: the ring
    gather, then the blocks summed in source-index order, so every rank
    holds the same bits (see the module docstring)."""
    blocks = _ring_blocks(x, axis_name)
    out = blocks[0]
    for b in blocks[1:]:
        out = out + b
    return out
