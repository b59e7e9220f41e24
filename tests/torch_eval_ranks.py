"""Rank program of the eval harness's mesh test (``tests/test_torch_evals.py``).

It runs in every rank of a gloo group that ``parallel.mesh.launch`` starts,
on the CPU, and returns the report. This module imports torch and the port
only, so no rank ever imports JAX; it is not a test file itself (pytest
collects ``test_*.py``).
"""

from __future__ import annotations

from distributed_eigenspaces_tpu_torch.evals import run_eval


def eval_rank(rank, world, name, overrides, blocks, v0):
    """``run_eval(name)`` on this rank of the group, on the given blocks and
    cold start."""
    return run_eval(name, device="cpu", blocks=blocks, v0=v0, **overrides)
