"""Declarative program contracts and the checkers that enforce them, for the
PyTorch port.

Counterpart of ``distributed_eigenspaces_tpu/analysis/contracts.py``. The
JAX analyzer reads XLA artifacts (jaxprs, partitioned HLO); the port runs
its programs, so each pass reads a torch-native source of the same facts:

- *collective schedule* (:func:`check_collectives`, rules
  ``collective-op``, ``collective-payload``, ``collective-schedule``,
  ``collective-wire-dtype``): the records of the collectives one run handed
  to ``torch.distributed`` (``parallel.mesh.recording_collectives``, read by
  :mod:`.hlo`), on a mesh of ranks. The scan family moves only the ``(m, d,
  k)`` factor stack, the feature-sharded cores add k-wide sums, the tree
  moves the basis and its tier Gram, fleet and serve programs move nothing;
  every rank of a mesh program must record the same schedule;
- *kernel tile budget* (:func:`check_pallas`, rule ``pallas-block``): the
  :class:`~..ops.geometry.KernelLaunch` records of the program's
  hand-written kernels. A Pallas block ref is what one grid step owns; on
  Hopper the CTAs run at once and a loop inside the CTA replaces the
  sequential grid axis, so the bound is on the extent of each operand that
  one CTA reads, writes or stages over its life. A kernel that gives a whole
  ``(rows, d)`` operand to one CTA is legal and exact, and runs on one of
  the card's 132 SMs: only this bound catches it;
- *memory footprint* (:func:`check_memory`, rule ``dense-buffer``):
  ``factor_only`` programs may hold no buffer with two or more axes each
  ``>= dense_dim``, the shape class of a materialized ``d x d``. The shapes
  are every aten op's outputs (and the program's inputs) during one call,
  traced under a ``TorchDispatchMode`` (``programs.trace_buffers``); this
  runs on the CPU as on the card;
- *declared layouts* (:mod:`.shardings`, rules ``silent-replication``,
  ``sharding-contract``): the ``sharding=`` block of a mesh contract names
  the buffers that must be held sharded (or replicated) over which mesh
  axes; each rank's local shapes are held against the global ones the
  program's build states, and its buffer trace against a floor no
  un-sharded ``(d, k)`` may reach;
- *cost budget* (``costmodel.check_built``, rule ``cost-bound``): no single
  collective moves more bytes than the payload ceiling at 4 bytes an
  element.

Per-op payload bounds mean what the reference's mean: the element count of
the collective's per-device result (a gather's whole output, a sum's
operand). One convention differs: an all-to-all counts the whole buffer a
rank hands over, where the reference's HLO parser keeps one chunk of a
tuple-shaped all-to-all; the port's count is the larger, so its bound is
never looser (:mod:`.hlo`).

Not checked here yet: baked constants (ROADMAP Queue 1, waiting for item
9g). Checkers return :class:`Violation` records, never raise on a breach;
the report aggregates and formats them.

The audited shapes keep every non-feature dimension below ``dense_dim``,
which makes "two axes >= dense_dim" exactly the dense-matrix class;
:func:`check_memory` refuses an audit config that breaks that premise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

from distributed_eigenspaces_tpu_torch.analysis.shardings import (
    WILD,
    DeclaredBuffer,
    ShardingContract,
)


@dataclass(frozen=True)
class ProgramParams:
    """The shape parameters a contract's bounds are functions of (the
    reference's fields, so one set of values builds both)."""

    d: int
    k: int
    m: int = 1
    n: int = 1
    T: int = 1
    B: int = 1
    rows: int = 1
    n_feature_shards: int = 1
    n_workers_mesh: int = 1
    sketch_width: int = 0
    #: parallel-deflation lane count (the ``components`` axis size): lane
    #: width is k / components
    components: int = 1
    #: merge-tree fan-ins leaf->root (tree_merge programs only): the
    #: tier-local Gram psum is (f*k)^2 per tier
    tier_fan_ins: tuple[int, ...] = ()
    #: merge-tree tier axis names leaf->root: the mesh axes the cost model
    #: attributes per-tier wire bytes to
    tier_axes: tuple[str, ...] = ()
    #: per-tier wire dtype declarations leaf->root, aligned with
    #: ``tier_axes`` ("fp32" / "bf16" / "int8"); empty = no wire policy
    #: declared, and the dtype rule is skipped. Sums (psum) are exempt:
    #: accumulation is fp32 even on compressed tiers
    tier_wire_dtypes: tuple[str, ...] = ()

    @property
    def d_local(self) -> int:
        return self.d // max(self.n_feature_shards, 1)


@dataclass(frozen=True)
class Violation:
    """One contract breach, formatted to be actionable from CI output
    alone: program + rule + where."""

    program: str
    rule: str  # collective-op / collective-payload / dense-buffer / ...
    message: str
    location: str = ""  # collective record, traced op, kernel launch, file:line

    def format(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.program}: {self.rule}: {self.message}{loc}"


@dataclass(frozen=True)
class ProgramContract:
    """What one program kind may look like when it runs."""

    name: str
    description: str
    #: collective op kinds allowed in a run's records (empty = zero
    #: collectives by construction)
    allowed_collectives: frozenset[str] = frozenset()
    #: per-device payload ceiling in ELEMENTS as a function of params;
    #: None with empty allowed_collectives (nothing to bound)
    max_payload_elems: Callable[[ProgramParams], int] | None = None
    #: a mesh program must actually record collectives — guards against the
    #: audit passing vacuously on a run that never left one rank
    require_collectives: bool = False
    #: "factor_only": no buffer with >= 2 axes each >= dense_dim;
    #: "dense_state": the carried state is legitimately d x d (solo /
    #: fleet / tree trainers) — shape rule skipped, footprint still reported
    memory_policy: str = "factor_only"
    #: the dimension the dense-buffer rule measures against (defaults to
    #: the per-rank feature width — d_local on feature-sharded programs)
    dense_dim: Callable[[ProgramParams], int] = field(default=lambda p: p.d_local)
    #: declared layouts: which buffers must be held sharded over which mesh
    #: axes — the silent-replication gate. None = no sharding contract
    #: (programs without one are skipped with a named reason, never passed
    #: vacuously)
    sharding: ShardingContract | None = None
    #: kernel tile budget: ceiling in ELEMENTS on every operand extent one
    #: CTA owns, in every recorded launch. None = no kernel contract
    max_block_elems: Callable[[ProgramParams], int] | None = None
    #: a kernel-contract program must actually launch a hand-written kernel
    #: — guards against the audit passing vacuously on a plain-version build
    require_pallas: bool = False


def _factor_stack(p: ProgramParams) -> int:
    """The merge's gathered factor stack — the payload ceiling every
    trainer contract quotes: ``m * d_local * max(k, sketch_width)``."""
    return p.m * p.d_local * max(p.k, p.sketch_width)


def _deflation_stack(p: ProgramParams) -> int:
    """Parallel deflation's payload ceiling: the largest thing a rank may
    move is the cross-lane gather of its own ``(d_local, k/L)`` panel —
    gathered size ``d_local * k`` — or the merge's worker factor stack when
    the operand is an m-wide concat. The deflation corrections are ``(L,
    kb, kb)`` blocks (k x k class), strictly below both; a lane gathering
    the full DEFLATED operand over features is d-wide and blows this
    bound."""
    return max(_factor_stack(p), p.d_local * p.k)


def _tree_bound(p: ProgramParams) -> int:
    """The tiered tree's payload ceiling: every tier moves at most the
    single ``(d, k)`` basis (all-to-all of the row-split factors /
    all-gather at the tier boundary) or the tier-local ``(f*k, f*k)``
    factor Gram (one psum) — never the flat route's m-wide factor stack
    and never a dense ``d x d``."""
    kf = max(p.k, p.sketch_width)
    gram = max(((f * kf) ** 2 for f in p.tier_fan_ins), default=0)
    return max(p.d_local * kf, gram)


# -- the registry ------------------------------------------------------------

#: Contract per program KIND (programs.py maps each audited program to one):
#: the reference's collective schedules, memory policies and ``sharding=``
#: blocks.
CONTRACTS: dict[str, ProgramContract] = {
    "scan_fit": ProgramContract(
        name="scan_fit",
        description=(
            "whole-fit scan (solo / masked / pipelined / interval): the "
            "only collective is the per-step all-gather of the "
            "(m, d, k) factor stack; dense d x d state is carried but "
            "never crosses the mesh"
        ),
        allowed_collectives=frozenset({"all-gather"}),
        max_payload_elems=_factor_stack,
        require_collectives=True,
        memory_policy="dense_state",
        sharding=ShardingContract(buffers=(
            DeclaredBuffer(
                "step blocks", "in",
                dims=lambda p: (WILD, p.m, p.n, p.d),
                spec=lambda p: (None, "workers", None, None),
            ),
            DeclaredBuffer(
                "carried state", "in",
                dims=lambda p: (p.d, p.d),
                spec=lambda p: (None, None),
            ),
        )),
    ),
    "feature_sharded": ProgramContract(
        name="feature_sharded",
        description=(
            "feature-sharded scan/sketch cores: k-wide reductions and "
            "the per-shard factor gather only, every payload bounded "
            "by the factor stack; NO dense d x d buffer exists on any "
            "rank (the low-rank carry is the whole point)"
        ),
        allowed_collectives=frozenset({"all-gather", "all-reduce"}),
        max_payload_elems=_factor_stack,
        require_collectives=True,
        memory_policy="factor_only",
        sharding=ShardingContract(
            buffers=(
                DeclaredBuffer(
                    "feature-sharded basis", "in",
                    dims=lambda p: (p.d, WILD),
                    spec=lambda p: ("features", None),
                ),
                DeclaredBuffer(
                    "feature blocks", "in",
                    dims=lambda p: (WILD, p.m, p.n, p.d),
                    spec=lambda p: (None, "workers", None, "features"),
                ),
                DeclaredBuffer(
                    "feature-sharded basis", "out",
                    dims=lambda p: (p.d, WILD),
                    spec=lambda p: ("features", None),
                ),
            ),
            # THE d-ceiling rule: no rank may hold a full-d buffer with
            # >= 2 companion elements — an un-sharded (d, k)
            replicated_axis_floor=lambda p: p.d,
        ),
    ),
    "tree_merge": ProgramContract(
        name="tree_merge",
        description=(
            "tiered-mesh tree fit: per-tier sharded merge "
            "updates only — all-to-all of the row-split (d, k) "
            "factors, one all-reduce of the (f*k, f*k) tier Gram, and "
            "the (d, k) basis all-gather at each tier boundary; the "
            "flat route's m-wide factor-stack gather must NOT appear, "
            "and no collective ever moves a dense d x d"
        ),
        allowed_collectives=frozenset({"all-to-all", "all-reduce", "all-gather"}),
        max_payload_elems=_tree_bound,
        require_collectives=True,
        memory_policy="dense_state",
        sharding=ShardingContract(buffers=(
            DeclaredBuffer(
                "step blocks", "in",
                dims=lambda p: (WILD, p.m, p.n, p.d),
                # the worker dim factors over ALL tier axes (compared as a
                # set)
                spec=lambda p: (None, p.tier_axes, None, None),
            ),
            DeclaredBuffer(
                "carried state", "in",
                dims=lambda p: (p.d, p.d),
                spec=lambda p: (None, None),
            ),
        )),
    ),
    "fleet_fit": ProgramContract(
        name="fleet_fit",
        description=(
            "B-tenant batched whole fit: pure data parallelism over "
            "the fleet axis — ZERO collectives by construction; dense "
            "per-tenant state is carried but never crosses the mesh"
        ),
        allowed_collectives=frozenset(),
        memory_policy="dense_state",
        sharding=ShardingContract(buffers=(
            DeclaredBuffer(
                "tenant blocks", "in",
                dims=lambda p: (p.B, WILD, WILD, WILD, p.d),
                spec=lambda p: ("workers", None, None, None, None),
            ),
            DeclaredBuffer(
                "tenant state", "in",
                dims=lambda p: (p.B, p.d, p.d),
                spec=lambda p: ("workers", None, None),
            ),
            DeclaredBuffer(
                "tenant state", "out",
                dims=lambda p: (p.B, p.d, p.d),
                spec=lambda p: ("workers", None, None),
            ),
            DeclaredBuffer(
                "tenant basis history", "out",
                dims=lambda p: (p.B, WILD, p.d, WILD),
                spec=lambda p: ("workers", None, None, None),
            ),
        )),
    ),
    "serve_transform": ProgramContract(
        name="serve_transform",
        description=(
            "serving kernels (project / reconstruct / residual): "
            "row-local matmuls — ZERO collectives, and factor-only "
            "memory (no program may materialize V V^T). The fp32 project "
            "is the fixed-order serve kernel on the card, whose launches "
            "are recorded"
        ),
        allowed_collectives=frozenset(),
        memory_policy="factor_only",
        dense_dim=lambda p: p.d,
        # every row-indexed buffer that appears must be workers-sharded,
        # the basis replicated BY DESIGN on this below-crossover engine (d
        # fits one device); above ``cfg.eigh_crossover_d`` serving runs the
        # sharded-basis engine instead, whose ``dist_serve`` contract
        # declares the basis sharded over 'features'
        sharding=ShardingContract(buffers=(
            DeclaredBuffer(
                "row activations", "in",
                dims=lambda p: (p.rows, p.d),
                spec=lambda p: ("workers", None),
                required=False,
            ),
            DeclaredBuffer(
                "row codes", "in",
                dims=lambda p: (p.rows, WILD),
                spec=lambda p: ("workers", None),
                required=False,
            ),
            DeclaredBuffer(
                "replicated basis", "in",
                dims=lambda p: (p.d, WILD),
                spec=lambda p: (None, None),
                required=False,
            ),
            DeclaredBuffer(
                "row outputs", "out",
                dims=lambda p: (p.rows, WILD),
                spec=lambda p: ("workers", None),
                required=False,
            ),
            DeclaredBuffer(
                "reconstructed rows", "out",
                dims=lambda p: (p.rows, p.d),
                spec=lambda p: ("workers", None),
                required=False,
            ),
            DeclaredBuffer(
                "row scalars", "out",
                dims=lambda p: (p.rows,),
                spec=lambda p: ("workers",),
                required=False,
            ),
        )),
    ),
    "dist_solve": ProgramContract(
        name="dist_solve",
        description=(
            "distributed eigensolve: merge / extract above the crossover as "
            "subspace iteration on row-sharded factors — the worker "
            "factor-stack gather plus k-wide sums over 'features' "
            "(CholeskyQR2 Grams, factor matvecs, the Rayleigh-Ritz reduce) "
            "only; nothing quadratic in m*k, nothing d-wide, never a dense "
            "d x d, and the result stays a (d_local, k) row shard"
        ),
        allowed_collectives=frozenset({"all-gather", "all-reduce"}),
        max_payload_elems=_factor_stack,
        require_collectives=True,
        memory_policy="factor_only",
        sharding=ShardingContract(
            buffers=(
                DeclaredBuffer(
                    "worker factor stack", "in",
                    dims=lambda p: (p.m, p.d, WILD),
                    spec=lambda p: ("workers", "features", None),
                    required=False,
                ),
                DeclaredBuffer(
                    "worker mask", "in",
                    dims=lambda p: (p.m,),
                    spec=lambda p: ("workers",),
                    required=False,
                ),
                DeclaredBuffer(
                    "row-sharded state factors", "in",
                    dims=lambda p: (p.d, WILD),
                    spec=lambda p: ("features", None),
                    required=False,
                ),
                DeclaredBuffer(
                    "replicated spectrum", "in",
                    dims=lambda p: (p.sketch_width,),
                    spec=lambda p: (None,),
                    required=False,
                ),
                DeclaredBuffer(
                    "sharded eigenbasis", "out",
                    dims=lambda p: (p.d, WILD),
                    spec=lambda p: ("features", None),
                ),
            ),
            # the d-ceiling rule, as the sharded trainers': no rank may
            # hold an un-sharded full-d buffer
            replicated_axis_floor=lambda p: p.d,
        ),
    ),
    "deflation_solve": ProgramContract(
        name="deflation_solve",
        description=(
            "parallel-deflation eigensolve: k lanes model-parallel over the "
            "'components' mesh axis, each iterating a (d_local, k/L) block "
            "against the factor operand with deflation corrections from "
            "lower lanes. Collectives are the cross-lane gather of one lane "
            "panel (d_local * k gathered), the (L, kb, kb) correction-"
            "coefficient sums over 'features', and CholeskyQR2 / "
            "Rayleigh-Ritz k-wide Grams — corrections ride as k x k "
            "blocks, never d x d, never an above-floor replicated d x k; "
            "the result stays a (d_local, k) row shard"
        ),
        allowed_collectives=frozenset({"all-gather", "all-reduce"}),
        max_payload_elems=_deflation_stack,
        require_collectives=True,
        memory_policy="factor_only",
        sharding=ShardingContract(
            buffers=(
                DeclaredBuffer(
                    # THE components-axis witness: the per-lane seed blocks
                    # enter sharded over ('components', 'features'), which
                    # makes the audit non-vacuous on that axis
                    "lane seed blocks", "in",
                    dims=lambda p: (
                        p.components,
                        p.d,
                        p.k // max(p.components, 1),
                    ),
                    spec=lambda p: ("components", "features", None),
                ),
                DeclaredBuffer(
                    "row-sharded state factors", "in",
                    dims=lambda p: (p.d, WILD),
                    spec=lambda p: ("features", None),
                    required=False,
                ),
                DeclaredBuffer(
                    "replicated spectrum", "in",
                    dims=lambda p: (p.sketch_width,),
                    spec=lambda p: (None,),
                    required=False,
                ),
                DeclaredBuffer(
                    "worker factor stack", "in",
                    dims=lambda p: (p.m, p.d, WILD),
                    spec=lambda p: ("workers", "features", None),
                    required=False,
                ),
                DeclaredBuffer(
                    # replicated over 'components' (every lane slot
                    # computes the same finish), row-sharded over
                    # 'features' — the born-sharded output of dist_solve
                    "sharded eigenbasis", "out",
                    dims=lambda p: (p.d, WILD),
                    spec=lambda p: ("features", None),
                ),
            ),
            replicated_axis_floor=lambda p: p.d,
        ),
    ),
    "dist_serve": ProgramContract(
        name="dist_serve",
        description=(
            "sharded-basis serving (above the crossover): the SAME "
            "row-local kernels on (d_local, k) basis shards, plus the one "
            "rows x k projection sum the sharding makes necessary — no "
            "collective ever moves the basis, and the dense (d, k) never "
            "assembles on one rank. The fp32 project is the fixed-order "
            "serve kernel on each rank's (rows, d_local) shard"
        ),
        allowed_collectives=frozenset({"all-reduce"}),
        # the projection / input-energy sums carry per-row k-wide (or
        # scalar) payloads — never anything d-wide
        max_payload_elems=lambda p: p.rows * max(p.k, 1),
        # reconstruct is row-local on the shards — zero collectives — so
        # presence is enforced per kind by the sharding pass, not globally
        require_collectives=False,
        memory_policy="factor_only",
        dense_dim=lambda p: p.d,
        sharding=ShardingContract(
            buffers=(
                DeclaredBuffer(
                    "row activations", "in",
                    dims=lambda p: (p.rows, p.d),
                    spec=lambda p: ("workers", "features"),
                    required=False,
                ),
                DeclaredBuffer(
                    "row codes", "in",
                    dims=lambda p: (p.rows, WILD),
                    spec=lambda p: ("workers", None),
                    required=False,
                ),
                DeclaredBuffer(
                    "feature-sharded basis", "in",
                    dims=lambda p: (p.d, WILD),
                    spec=lambda p: ("features", None),
                    required=False,
                ),
                DeclaredBuffer(
                    "row outputs", "out",
                    dims=lambda p: (p.rows, WILD),
                    spec=lambda p: ("workers", None),
                    required=False,
                ),
                DeclaredBuffer(
                    "reconstructed rows", "out",
                    dims=lambda p: (p.rows, p.d),
                    spec=lambda p: ("workers", "features"),
                    required=False,
                ),
                DeclaredBuffer(
                    "row scalars", "out",
                    dims=lambda p: (p.rows,),
                    spec=lambda p: ("workers",),
                    required=False,
                ),
            ),
            replicated_axis_floor=lambda p: p.d,
        ),
    ),
    "serve_pallas": ProgramContract(
        name="serve_pallas",
        description=(
            "fused serve / solver Pallas kernels: the "
            "quantized dequant->project family and the fused "
            "matvec+Gram sweep — ZERO collectives, factor-only "
            "memory, and every kernel block ref (inputs, outputs, "
            "scratch) bounded by the VMEM tile budget; a kernel that "
            "maps the full (rows, d) operand into one block has "
            "silently stopped tiling. On the card: every operand extent "
            "one CTA reads, writes or stages over its life is bounded "
            "the same way; a kernel that gives the full (rows, d) "
            "operand to one CTA runs on one SM of 132"
        ),
        allowed_collectives=frozenset(),
        memory_policy="factor_only",
        dense_dim=lambda p: p.d,
        # 131072 f32 elems = 512 KiB per block — the serve tile targets
        # (256 rows x 512 d) at their ceiling; a full-operand block at the
        # kernel-audit shapes (256 x 1024) is 2x over
        max_block_elems=lambda p: 131072,
        require_pallas=True,
    ),
    "population_merge": ProgramContract(
        name="population_merge",
        description=(
            "population-scale cohort reduce: the hardened "
            "Byzantine-tolerant merge of one sampled cohort's (d, k) "
            "client summaries — the ONLY collective is the all-gather "
            "of the cohort-sharded factor stack, so per-round payloads "
            "are bounded by COHORT size (m := cohort), never by the "
            "population; the clip / trim / screen pipeline runs "
            "replicated post-gather and nothing population-sized or "
            "dense d x d ever crosses the mesh"
        ),
        allowed_collectives=frozenset({"all-gather"}),
        max_payload_elems=_factor_stack,
        require_collectives=True,
        memory_policy="factor_only",
        sharding=ShardingContract(buffers=(
            DeclaredBuffer(
                "cohort stack", "in",
                dims=lambda p: (p.m, p.d, WILD),
                spec=lambda p: ("workers", None, None),
            ),
            DeclaredBuffer(
                "arrival mask", "in",
                dims=lambda p: (p.m,),
                spec=lambda p: ("workers",),
            ),
            DeclaredBuffer(
                "merged basis", "out",
                dims=lambda p: (p.d, WILD),
                spec=lambda p: (None, None),
            ),
            DeclaredBuffer(
                "survivor mask", "out",
                dims=lambda p: (p.m,),
                spec=lambda p: (None,),
                required=False,
            ),
        )),
    ),
}


# -- checkers ----------------------------------------------------------------

#: the collective op kinds that MOVE data (and so carry a wire codec);
#: reductions (all-reduce) are exempt — accumulation stays fp32 even on
#: compressed tiers (int8 has no closed addition)
_DATA_MOVERS = frozenset({"all-gather", "all-to-all"})

#: the dtype token each wire codec puts on the wire
WIRE_HLO_TOKEN = {"fp32": "f32", "bf16": "bf16", "int8": "s8"}


def _check_wire_dtypes(
    params: ProgramParams,
    ops,
    contract: ProgramContract,
    *,
    program: str,
) -> list[Violation]:
    """Rule ``collective-wire-dtype``: the declared per-tier wire policy
    against the dtypes the run's data movers actually carried.

    Positive half: every tier declared non-fp32 must have at least one
    data-moving collective carrying that codec's dtype token (bf16 / s8)
    over the tier's axis — a policy the program silently ignored is a
    compression that never happened.

    Negative half: an f32 data-mover above the ``d_local * kf / 2``
    elements floor on a tier declared compressed is a full-width payload on
    a wire the policy narrowed (the ``wire_dtype_drift`` mutant). The floor
    keeps the weight gathers and int8 fp32 scale sidecars — both tiny and
    f32 by design — out of scope.

    The reference matches a mover to its tier by replica-group size (HLO
    carries no axis names) and leaves a group size shared by an fp32 tier
    alone; the port's records name the axis, so the match is exact. gloo
    moves bf16 as bf16, so the reference's float-normalization escape (an
    f32 mover fed by a convert) has no counterpart here.
    """
    out: list[Violation] = []
    tiers = list(zip(params.tier_axes, params.tier_fan_ins, params.tier_wire_dtypes))
    kf = max(params.k, params.sketch_width, 1)
    floor = params.d_local * kf // 2
    movers = [o for o in ops if o.op in _DATA_MOVERS]
    for axis, fan, dtype in tiers:
        if dtype == "fp32":
            continue
        token = WIRE_HLO_TOKEN[dtype]
        if not any(o.axis == axis and o.dtype == token for o in movers):
            out.append(Violation(
                program=program,
                rule="collective-wire-dtype",
                message=(
                    f"tier {axis!r} (fan-in {fan}) declares wire dtype "
                    f"{dtype!r} but no data-moving collective carries "
                    f"{token} over {axis!r} — the declared "
                    "compression never reaches the wire "
                    f"(contract {contract.name!r})"
                ),
                location=f"tier_wire_dtypes[{axis!r}]={dtype!r}",
            ))
    declared = {axis: dtype for axis, _, dtype in tiers}
    for o in movers:
        if o.dtype != "f32" or o.elems <= floor:
            continue
        dtype = declared.get(o.axis, "fp32")
        if dtype != "fp32":
            out.append(Violation(
                program=program,
                rule="collective-wire-dtype",
                message=(
                    f"{o.op} moves {o.elems} f32 elems over {o.axis!r} "
                    f"(a group of {o.group_size}), but the tier is declared "
                    f"compressed ({o.axis}={dtype}) — a full-width fp32 "
                    "payload is riding a wire the policy narrowed "
                    f"(contract {contract.name!r})"
                ),
                location=o.line,
            ))
    return out


def check_collectives(
    contract: ProgramContract,
    params: ProgramParams,
    records,
    *,
    program: str,
) -> tuple[list[Violation], dict]:
    """Pass 1: the per-program collective schedule against the records of
    one run (``parallel.mesh.recording_collectives``; rank 0's in a mesh
    program). Returns (violations, metrics)."""
    from distributed_eigenspaces_tpu_torch.analysis import hlo as _hlo

    out: list[Violation] = []
    ops = _hlo.parse_collectives(records)
    metrics = {
        "n_collectives": len(ops),
        "max_payload_elems": max((o.elems for o in ops), default=0),
        "ops": {},
    }
    for o in ops:
        key = f"{o.op} {o.dtype}[{','.join(map(str, o.shape))}]"
        metrics["ops"][key] = metrics["ops"].get(key, 0) + 1
    for o in ops:
        if o.op not in contract.allowed_collectives:
            allowed = sorted(contract.allowed_collectives) or ["<none>"]
            out.append(Violation(
                program=program,
                rule="collective-op",
                message=(
                    f"{o.op} {o.dtype}{list(o.shape)} is not in the "
                    f"contract's allowed set {allowed} "
                    f"(contract {contract.name!r})"
                ),
                location=o.line,
            ))
    if contract.max_payload_elems is not None:
        bound = contract.max_payload_elems(params)
        for o in ops:
            if o.elems > bound:
                out.append(Violation(
                    program=program,
                    rule="collective-payload",
                    message=(
                        f"{o.op} payload {o.elems} elems exceeds the "
                        f"contract bound {bound} (= factor stack at "
                        f"d={params.d}, k={params.k}, m={params.m}) — "
                        "the merge must move factors, not dense "
                        f"matrices (contract {contract.name!r})"
                    ),
                    location=o.line,
                ))
    if contract.require_collectives and not ops:
        out.append(Violation(
            program=program,
            rule="collective-schedule",
            message=(
                "mesh program recorded no collectives at all — the "
                "audit would pass vacuously (did it run on one rank?) "
                f"(contract {contract.name!r})"
            ),
        ))
    if params.tier_wire_dtypes:
        out.extend(_check_wire_dtypes(params, ops, contract, program=program))
    return out, metrics


def check_schedule(built) -> list[Violation]:
    """Every rank of a mesh program must record the same collective
    schedule (SPMD): each difference between a rank's records and rank 0's
    (``programs`` finds them) is one ``collective-schedule`` violation."""
    return [
        Violation(
            program=built.name,
            rule="collective-schedule",
            message=(
                f"{diff} — every rank of a mesh program must make the same "
                f"collectives in the same order (contract {built.contract!r})"
            ),
        )
        for diff in built.schedule_diffs
    ]


def check_memory(
    contract: ProgramContract,
    params: ProgramParams,
    *,
    program: str,
    buffers=(),
) -> tuple[list[Violation], dict]:
    """The memory-footprint contract over a trace of ``(where, shape,
    dtype)`` buffers (``programs.trace_buffers``): ``factor_only`` programs
    may not hold any dense ``>= (t, t)`` buffer."""
    out: list[Violation] = []
    t = contract.dense_dim(params)
    # the premise that makes the shape rule exact: every non-feature
    # config dimension sits below the threshold (see module docstring)
    small = {"m": params.m, "n": params.n, "T": params.T, "B": params.B,
             "k": params.k, "rows": params.rows}
    offenders = {nm: v for nm, v in small.items() if v >= t}
    if offenders:
        raise ValueError(
            f"audit config for {program!r} breaks the dense-shape "
            f"premise: {offenders} >= dense_dim {t} — shrink the "
            "audited shapes (analysis/programs.py) so the two-large-"
            "axes rule stays exactly the dense-matrix class"
        )
    buffers = list(buffers)
    metrics: dict = {
        "dense_dim": t,
        "policy": contract.memory_policy,
        "n_buffers": len(buffers),
        "max_buffer_elems": max(
            (math.prod(shape) for _, shape, _ in buffers), default=0
        ),
    }
    if contract.memory_policy != "factor_only":
        return out, metrics
    for where, shape, dtype in buffers:
        if sum(1 for s in shape if s >= t) >= 2:
            out.append(Violation(
                program=program,
                rule="dense-buffer",
                message=(
                    f"the program materializes a dense {dtype} buffer "
                    f"{list(shape)} (>= 2 axes >= {t}) in a factor-only "
                    "program — the d-ceiling invariant is that no device "
                    f"ever holds a d x d (contract {contract.name!r})"
                ),
                location=f"traced op: {where}",
            ))
    return out, metrics


def check_pallas(
    contract: ProgramContract,
    params: ProgramParams,
    launches,
    *,
    program: str,
) -> tuple[list[Violation], dict]:
    """The kernel tile budget over a program's :class:`KernelLaunch`
    records: every operand extent one CTA owns is bounded by
    ``max_block_elems``. The memory pass cannot see this failure mode: a
    kernel that gives the whole operand to one CTA compiles, runs and is
    exact — it only leaves all but one SM idle."""
    out: list[Violation] = []
    launches = list(launches)
    metrics: dict = {
        "n_pallas_calls": len(launches),
        "max_block_elems_seen": max(
            (e for launch in launches for e in launch.operand_elems().values()),
            default=0,
        ),
    }
    if contract.max_block_elems is None:
        metrics["policy"] = "unchecked"
        return out, metrics
    bound = contract.max_block_elems(params)
    metrics["block_bound_elems"] = bound
    for launch in launches:
        grid = (
            f"a grid of {list(launch.grid)} CTAs" if launch.grid is not None
            else "an occupancy-sized grid"
        )
        for name, extent in launch.operands:
            elems = math.prod(extent)
            if elems > bound:
                out.append(Violation(
                    program=program,
                    rule="pallas-block",
                    message=(
                        f"kernel {launch.kernel!r} gives one CTA operand "
                        f"{name!r} {list(extent)} = {elems} elems, over the "
                        f"tile budget {bound} — the launch ({grid} of "
                        f"{launch.threads} threads) hands (nearly) the whole "
                        "operand to one CTA, so one SM streams it while the "
                        f"rest of the card idles (contract {contract.name!r})"
                    ),
                    location=f"{launch.source}: {launch.kernel}",
                ))
    if contract.require_pallas and not launches:
        out.append(Violation(
            program=program,
            rule="pallas-presence",
            message=(
                "program launches no hand-written kernel at all — the tile "
                "audit would pass vacuously (did the build take the plain "
                f"version?) (contract {contract.name!r})"
            ),
        ))
    return out, metrics


def check_program(built) -> tuple[list[Violation], dict]:
    """Every pass over one :class:`~.programs.BuiltProgram`: collectives
    (and, on a mesh, the ranks' agreement) + memory + kernel tiles +
    declared layouts (every rank's) + the cost model's byte budget. Returns
    ``(violations, metrics)`` — the report aggregates."""
    from distributed_eigenspaces_tpu_torch.analysis import costmodel
    from distributed_eigenspaces_tpu_torch.analysis import shardings as _sh

    contract = CONTRACTS[built.contract]
    violations: list[Violation] = []
    v, col = check_collectives(
        contract, built.params, built.collectives, program=built.name
    )
    violations += v + check_schedule(built)
    v, mem = check_memory(
        contract, built.params, program=built.name, buffers=built.buffers
    )
    violations += v
    v, pallas = check_pallas(
        contract, built.params, built.launches, program=built.name
    )
    violations += v
    v, shard = _sh.check_built(built, contract)
    violations += v
    v, costs = costmodel.check_built(built)
    violations += v
    return violations, {
        "contract": contract.name,
        "ok": not violations,
        "collectives": col,
        "memory": mem,
        "pallas": pallas,
        "shardings": shard,
        "costs": costs,
        "launches": [launch.to_json() for launch in built.launches],
        "setup_launches": [launch.to_json() for launch in built.setup_launches],
    }
