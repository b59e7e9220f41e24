"""Program-contract analysis of the PyTorch port (counterpart of
``distributed_eigenspaces_tpu/analysis/``, with its module names).

Audits the port's programs against declarative **program contracts** by
running each once at audit shapes — the mesh programs on one launch of
ranks — plus the AST concurrency lint over the threaded runtime. The passes
over the programs:

1. **collective schedule** (:mod:`.contracts` over :mod:`.hlo`): per-program
   collective op kinds and payload bounds as functions of ``(d, k, m, B)``,
   read from the collectives each run handed to ``torch.distributed``, the
   ranks' agreement, and the declared per-tier wire dtypes;
2. **kernel tile budget** (:mod:`.contracts` over the ``KernelLaunch``
   records of ``ops/``): every operand extent one CTA owns is bounded — a
   kernel that gives a whole ``(rows, d)`` operand to one CTA runs on one SM;
3. **memory footprint** (:mod:`.contracts` over a ``TorchDispatchMode``
   trace): no dense ``d x d`` buffer in a factor-only program;
4. **cost model** (:mod:`.costmodel`): per-program FLOPs, memory bytes and
   per-mesh-axis collective bytes x hops, budget-enforced per op and
   diff-gated against the committed ``ANALYSIS_COSTS_TORCH.json``;
5. **sharding contracts** (:mod:`.shardings`): declared layouts against the
   shapes every rank of a mesh program held and its traced buffers — silent
   replication of a ``(d, k)`` buffer is a violation.

:mod:`.planner` prices configurations with the cost model and the card's
calibration record into a ``plan-v1`` artifact (``ANALYSIS_PLAN_TORCH.json``,
the CLI's ``--plan``). ``scripts/torch_analyze.py`` drives them over the
matrix, and the gate is self-testing: :mod:`.mutations` seeds one violation
per class and requires each to be caught.

The package ``__init__`` stays lazy: submodules resolve on first attribute
access; the audit's entry points re-export from :mod:`.hlo`.
"""

from __future__ import annotations

_LAZY = {
    "contracts": "distributed_eigenspaces_tpu_torch.analysis.contracts",
    "costmodel": "distributed_eigenspaces_tpu_torch.analysis.costmodel",
    "hlo": "distributed_eigenspaces_tpu_torch.analysis.hlo",
    "planner": "distributed_eigenspaces_tpu_torch.analysis.planner",
    "programs": "distributed_eigenspaces_tpu_torch.analysis.programs",
    "ast_lints": "distributed_eigenspaces_tpu_torch.analysis.ast_lints",
    "report": "distributed_eigenspaces_tpu_torch.analysis.report",
    "mutations": "distributed_eigenspaces_tpu_torch.analysis.mutations",
    "shardings": "distributed_eigenspaces_tpu_torch.analysis.shardings",
}

#: the audit's stable entry points, re-exported from :mod:`.hlo` as the
#: reference's package does
_HLO_API = (
    "AuditParseError",
    "CollectiveOp",
    "assert_no_dense_collective",
    "audit_compiled",
    "ici_step_model",
    "parse_collectives",
    "scaling_projection",
)

__all__ = sorted(_LAZY) + sorted(_HLO_API)


def __getattr__(name: str):
    import importlib

    if name in _LAZY:
        mod = importlib.import_module(_LAZY[name])
        globals()[name] = mod
        return mod
    if name in _HLO_API:
        mod = importlib.import_module(_LAZY["hlo"])
        obj = getattr(mod, name)
        globals()[name] = obj
        return obj
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
