"""Declarative program contracts and the checkers that enforce them, for the
PyTorch port on one card.

Counterpart of ``distributed_eigenspaces_tpu/analysis/contracts.py``. The
JAX analyzer reads XLA artifacts (jaxprs, partitioned HLO); the port runs
eagerly, so each pass that applies reads a torch-native source of the same
facts:

- *kernel tile budget* (:func:`check_pallas`, rule ``pallas-block``): the
  :class:`~..ops.geometry.KernelLaunch` records of the program's
  hand-written kernels. A Pallas block ref is what one grid step owns; on
  Hopper the CTAs run at once and a loop inside the CTA replaces the
  sequential grid axis, so the bound is on the extent of each operand that
  one CTA reads, writes or stages over its life. A kernel that gives a whole
  ``(rows, d)`` operand to one CTA is legal and exact, and runs on one of
  the card's 132 SMs: only this bound catches it.
- *memory footprint* (:func:`check_memory`, rule ``dense-buffer``):
  ``factor_only`` programs may hold no buffer with two or more axes each
  ``>= dense_dim``, the shape class of a materialized ``d x d``. The shapes
  are every aten op's outputs (and the program's inputs) during one call,
  traced under a ``TorchDispatchMode`` (``programs.trace_buffers``); this
  runs on the CPU as on the card.

Collective schedules, sharding contracts, baked constants and the cost model
are not checked here yet (ROADMAP Queue 1 item 17b says what each waits for).
Checkers return :class:`Violation` records, never raise on a breach; the
report aggregates and formats them.

The audited shapes keep every non-feature dimension below ``dense_dim``,
which makes "two axes >= dense_dim" exactly the dense-matrix class;
:func:`check_memory` refuses an audit config that breaks that premise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class ProgramParams:
    """The shape parameters a contract's bounds are functions of."""

    d: int
    k: int
    m: int = 1
    n: int = 1
    T: int = 1
    B: int = 1
    rows: int = 1
    sketch_width: int = 0


@dataclass(frozen=True)
class Violation:
    """One contract breach, formatted to be actionable from CI output
    alone: program + rule + where."""

    program: str
    rule: str  # dense-buffer / pallas-block / pallas-presence / lint rules
    message: str
    location: str = ""  # traced op, kernel launch, or file:line for lints

    def format(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.program}: {self.rule}: {self.message}{loc}"


@dataclass(frozen=True)
class ProgramContract:
    """What one program kind may look like when it runs."""

    name: str
    description: str
    #: "factor_only": no buffer with >= 2 axes each >= dense_dim;
    #: "dense_state": the carried state is legitimately d x d (rule skipped)
    memory_policy: str = "factor_only"
    #: the dimension the dense-buffer rule measures against
    dense_dim: Callable[[ProgramParams], int] = field(default=lambda p: p.d)
    #: kernel tile budget: ceiling in ELEMENTS on every operand extent one
    #: CTA owns, in every recorded launch. None = no kernel contract
    max_block_elems: Callable[[ProgramParams], int] | None = None
    #: a kernel-contract program must actually launch a hand-written kernel
    #: — guards against the audit passing vacuously on a plain-version build
    require_pallas: bool = False


#: Contract per program KIND (programs.py maps each audited program to one).
CONTRACTS: dict[str, ProgramContract] = {
    "serve_transform": ProgramContract(
        name="serve_transform",
        description=(
            "serving kernels (project / reconstruct / residual): "
            "row-local matmuls — ZERO collectives, and factor-only "
            "memory (no program may materialize V V^T). On the card: one "
            "device, so no collective can appear; the fp32 project is the "
            "fixed-order serve kernel, whose launches are recorded"
        ),
        memory_policy="factor_only",
        dense_dim=lambda p: p.d,
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
        memory_policy="factor_only",
        dense_dim=lambda p: p.d,
        # 131072 f32 elems = 512 KiB per block — the serve tile targets
        # (256 rows x 512 d) at their ceiling; a full-operand block at the
        # kernel-audit shapes (256 x 1024) is 2x over
        max_block_elems=lambda p: 131072,
        require_pallas=True,
    ),
}


# -- checkers ----------------------------------------------------------------


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
    """Both passes over one :class:`~.programs.BuiltProgram`. Returns
    ``(violations, metrics)`` — the report aggregates."""
    contract = CONTRACTS[built.contract]
    violations: list[Violation] = []
    v, mem = check_memory(
        contract, built.params, program=built.name, buffers=built.buffers
    )
    violations += v
    v, pallas = check_pallas(
        contract, built.params, built.launches, program=built.name
    )
    violations += v
    return violations, {
        "contract": contract.name,
        "ok": not violations,
        "memory": mem,
        "pallas": pallas,
        "launches": [launch.to_json() for launch in built.launches],
    }
