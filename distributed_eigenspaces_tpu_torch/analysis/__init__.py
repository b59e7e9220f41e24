"""Program-contract analysis of the PyTorch port (counterpart of
``distributed_eigenspaces_tpu/analysis/``, with its module names).

Audits the port's programs against declarative **program contracts** by
running each once at audit shapes, plus the AST concurrency lint over the
threaded runtime. Two passes over the programs:

1. **kernel tile budget** (:mod:`.contracts` over the ``KernelLaunch``
   records of ``ops/``): every operand extent one CTA owns is bounded — a
   kernel that gives a whole ``(rows, d)`` operand to one CTA runs on one SM;
2. **memory footprint** (:mod:`.contracts` over a ``TorchDispatchMode``
   trace): no dense ``d x d`` buffer in a factor-only program.

``scripts/torch_analyze.py`` drives them over the matrix, and the gate is
self-testing: :mod:`.mutations` seeds one violation per class and requires
each to be caught. :mod:`.hlo` holds the collective byte model of the eval
reports' ``ici_model`` block.

The package ``__init__`` stays lazy: submodules resolve on first attribute
access.
"""

from __future__ import annotations

_LAZY = {
    "contracts": "distributed_eigenspaces_tpu_torch.analysis.contracts",
    "hlo": "distributed_eigenspaces_tpu_torch.analysis.hlo",
    "programs": "distributed_eigenspaces_tpu_torch.analysis.programs",
    "ast_lints": "distributed_eigenspaces_tpu_torch.analysis.ast_lints",
    "report": "distributed_eigenspaces_tpu_torch.analysis.report",
    "mutations": "distributed_eigenspaces_tpu_torch.analysis.mutations",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    import importlib

    if name in _LAZY:
        mod = importlib.import_module(_LAZY[name])
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
