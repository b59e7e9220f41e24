"""Sharding contracts: declared layouts, checked against what each rank held.

Counterpart of ``distributed_eigenspaces_tpu/analysis/shardings.py``. The
d-ceiling leg (distributed eigensolve, sharded ``(d, k)`` bases end to end)
extends the "no d x d buffer" memory contract to "no un-sharded (d, k)
buffer"; silent replication is where that breaks without a sound. This
module is that rule as a contract family:

- each :class:`~.contracts.ProgramContract` declares the layout its inputs
  and outputs must have (:class:`DeclaredBuffer` patterns over
  :class:`~.contracts.ProgramParams` shapes, entries as in a
  ``PartitionSpec``);
- a mesh program's build states the GLOBAL shape of every tensor leaf of
  its inputs and its output (the reference's avals), and every rank records
  the LOCAL shape it actually held (:class:`HeldShapes`). The port has no
  compiled shardings to read: a rank's layout is its local tensors, and the
  mesh's axis sizes say what each declaration means. A dim declared sharded
  over an axis set must be held at ``global / prod(axis sizes)``; held
  whole, it is **silent replication** (rule ``silent-replication``); held
  at another extent, or sharded where it is declared replicated, it is a
  ``sharding-contract`` breach. Each message names the program, the buffer,
  its global shape, the rank and ``in[i]`` / ``out[i]``;
- an intermediate-buffer floor (the feature-sharded, dist and deflation
  programs) scans each rank's buffer trace (``programs.trace_buffers``): no
  rank may hold a buffer with an axis of at least the floor (the global
  ``d``) and two or more other elements, the un-sharded ``(d, k)``
  intermediate the distributed-solve path must never materialize.

Every rank's verdict counts. Violations never raise; they aggregate through
:func:`~.contracts.check_program` like every other pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves

#: dims-pattern wildcard: matches any axis strictly below the program's dense
#: threshold (so a wildcard can never swallow a d-wide axis and bind a
#: declared pattern to the wrong buffer)
WILD = None


@dataclass(frozen=True)
class DeclaredBuffer:
    """One declared buffer: a GLOBAL shape pattern (ints exact, ``WILD`` =
    any axis below the dense threshold) and the layout every leaf the
    pattern matches must be held in.

    ``spec(params)`` entries mirror a ``PartitionSpec``: ``None`` =
    replicated dim, an axis name, or a tuple of axis names (compared as
    SETS: mesh factorings reorder tier axes freely)."""

    name: str
    role: str  # "in" | "out"
    dims: Callable[..., tuple]
    spec: Callable[..., tuple]
    #: required patterns that match no leaf are a violation (a stale
    #: contract is a claim nobody checks); optional ones simply skip
    required: bool = True


@dataclass(frozen=True)
class ShardingContract:
    """The sharding half of a program contract."""

    buffers: tuple[DeclaredBuffer, ...]
    #: per-rank buffers with an axis >= this floor AND >= 2 remaining
    #: elements are un-sharded (d, k) intermediates. None = no intermediate
    #: rule (dense_state programs legitimately carry d x d)
    replicated_axis_floor: Callable[..., int] | None = None
    #: at least one declared-SHARDED buffer must be held sharded, or the
    #: audit passed vacuously (did the program really shard anything?)
    require_some: bool = True


@dataclass(frozen=True)
class HeldShapes:
    """What one rank of a mesh program held: the local shape of every
    tensor leaf of its inputs and of its output (pytree order), and the
    entries of its buffer trace ``(where, shape, dtype)`` that reach the
    contract's floor."""

    rank: int
    ins: tuple[tuple[int, ...], ...]
    outs: tuple[tuple[int, ...], ...]
    buffers: tuple = ()


def _shapes(tree) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(int(s) for s in t.shape) for t in tree_leaves(tree)
                 if isinstance(t, torch.Tensor))


def held_shapes(rank: int, args, out, buffers=(), floor: int | None = None) -> HeldShapes:
    """The :class:`HeldShapes` of one call ``out = fn(*args)`` on ``rank``;
    ``buffers`` (its trace) is kept where an axis reaches ``floor`` (none
    without one)."""
    wide = () if floor is None else tuple(
        b for b in buffers if b[1] and max(b[1]) >= floor)
    return HeldShapes(rank=rank, ins=_shapes(args), outs=_shapes(out), buffers=wide)


def _spec_sets(entries, rank: int) -> tuple[frozenset, ...]:
    """Normalize PartitionSpec-like entries to per-dim axis-name sets,
    padded with replicated dims to ``rank``."""
    out = []
    for e in list(entries)[:rank]:
        if e is None:
            out.append(frozenset())
        elif isinstance(e, (tuple, list)):
            out.append(frozenset(str(a) for a in e))
        else:
            out.append(frozenset({str(e)}))
    while len(out) < rank:
        out.append(frozenset())
    return tuple(out)


def _fmt_sets(sets) -> str:
    def one(s):
        if not s:
            return "None"
        return "+".join(sorted(s))

    return "(" + ", ".join(one(s) for s in sets) + ")"


def _matches(pattern, shape, wildcard_max: int) -> bool:
    if len(pattern) != len(shape):
        return False
    for want, have in zip(pattern, shape):
        if want is WILD:
            if have >= wildcard_max:
                return False
        elif have != want:
            return False
    return True


def _fmt_held(glob, local) -> str:
    """How a leaf was held, as the report shows it: ``None`` for a whole
    dim, else the share of it a rank held."""
    return "(" + ", ".join("None" if g == h else f"1/{g // h}" if h and g % h == 0
                           else f"{h}/{g}" for g, h in zip(glob, local)) + ")"


# -- the checker -------------------------------------------------------------


def check_shardings(
    scontract: ShardingContract,
    params,
    *,
    program: str,
    dense_dim: int,
    axis_sizes: dict,
    in_global,
    out_global,
    held: HeldShapes,
) -> tuple[list, dict]:
    """The sharding pass over one rank: the declared layouts of the leaves
    whose GLOBAL shapes (``in_global`` / ``out_global``, stated by the
    program's build) match a declared pattern, against the local shapes
    the rank ``held``, on a mesh of ``axis_sizes``; then the rank's traced
    buffers against the floor. Returns ``(violations, metrics)``."""
    from distributed_eigenspaces_tpu_torch.analysis.contracts import Violation

    viols: list = []
    detail: list[dict] = []
    n_sharded_ok = 0
    r = held.rank

    def violation(rule, message, location=""):
        viols.append(Violation(program=program, rule=rule, message=message,
                               location=location))

    aligned = (
        len(in_global) == len(held.ins) and len(out_global) == len(held.outs)
        and all(len(g) == len(h) for g, h in zip(in_global, held.ins))
        and all(len(g) == len(h) for g, h in zip(out_global, held.outs))
    )
    if not aligned:
        violation("sharding-contract", (
            f"cannot align the declared global leaves with what rank {r} held "
            f"(in {[list(s) for s in in_global]} vs {[list(s) for s in held.ins]}, "
            f"out {[list(s) for s in out_global]} vs {[list(s) for s in held.outs]}) "
            "— the audit would silently check the wrong buffers"))
        return viols, {"checked": False, "reason": "misaligned leaves", "rank": r,
                       "buffers": detail}

    leaves = [("in", i, tuple(g), tuple(h))
              for i, (g, h) in enumerate(zip(in_global, held.ins))] + [
              ("out", i, tuple(g), tuple(h))
              for i, (g, h) in enumerate(zip(out_global, held.outs))]

    for buf in scontract.buffers:
        pattern = buf.dims(params)
        want = _spec_sets(buf.spec(params), len(pattern))
        matched = 0
        for role, idx, glob, local in leaves:
            if role != buf.role or not _matches(pattern, glob, dense_dim):
                continue
            matched += 1
            row = {
                "buffer": buf.name, "role": role, "leaf": idx, "rank": r,
                "shape": list(glob), "local": list(local),
                "declared": _fmt_sets(want),
                "held": _fmt_held(glob, local),
                "ok": True,
            }
            detail.append(row)
            where = f"{role}[{idx}] on rank {r}"
            what = f"{buf.name} ({role}[{idx}], global shape {list(glob)})"
            ok = True
            proof = False
            for dim, (w, g, h) in enumerate(zip(want, glob, local)):
                unknown = sorted(a for a in w if a not in axis_sizes)
                if unknown:
                    ok = False
                    violation("sharding-contract", (
                        f"{what} is declared sharded over {unknown} on dim {dim}, "
                        f"axes this mesh ({sorted(axis_sizes)}) does not have"), where)
                    continue
                factor = math.prod(int(axis_sizes[a]) for a in w)
                if g % factor == 0 and h == g // factor:
                    proof = proof or factor > 1
                    continue
                ok = False
                if w and h == g:
                    violation("silent-replication", (
                        f"{what} is declared sharded over {sorted(w)} on dim {dim} "
                        f"(held {g // factor} of {g} a rank) but rank {r} holds all "
                        f"{g} of it, REPLICATED (local shape {list(local)}) — an "
                        "un-sharded (d, k) buffer is exactly the regression the "
                        "d-ceiling contract forbids"), where)
                elif not w:
                    violation("sharding-contract", (
                        f"{what} is declared replicated on dim {dim} but rank {r} "
                        f"holds {h} of its {g} (local shape {list(local)}): sharded "
                        "— update the declared layout if this one is intentional"),
                        where)
                else:
                    violation("sharding-contract", (
                        f"{what} dim {dim} is declared sharded over {sorted(w)} "
                        f"({g // factor} of {g} a rank) but rank {r} holds {h} of "
                        f"it (local shape {list(local)})"), where)
            row["ok"] = ok
            if ok and proof:
                n_sharded_ok += 1
        if buf.required and matched == 0:
            violation("sharding-contract", (
                f"declared buffer {buf.name!r} (pattern {list(pattern)}, "
                f"{buf.role}) matched no leaf of the program — the sharding "
                "contract is stale; update the declaration in "
                "analysis/contracts.py"))

    floor = None
    if scontract.replicated_axis_floor is not None:
        floor = scontract.replicated_axis_floor(params)
        for where, dims, dtype in held.buffers:
            if not dims:
                continue
            widest = max(dims)
            rest = math.prod(dims) // widest if widest else 0
            if widest >= floor and rest >= 2:
                violation("silent-replication", (
                    f"rank {r} holds a {dtype} buffer {list(dims)} with a "
                    f"full-width axis (>= {floor}) and {rest} companion elements "
                    "— an un-sharded (d, k) intermediate materialized on one rank"),
                    f"traced op: {where} on rank {r}")

    if scontract.require_some and n_sharded_ok == 0 and not viols:
        violation("sharding-contract", (
            f"no declared-sharded buffer was held sharded on rank {r} — the "
            "sharding audit passed vacuously (did the program really shard "
            "anything?)"))

    return viols, {
        "checked": True,
        "rank": r,
        "n_declared": len(scontract.buffers),
        "n_sharded_ok": n_sharded_ok,
        "floor": floor,
        "buffers": detail,
    }


def check_built(built, contract) -> tuple[list, dict]:
    """The sharding pass over one ``BuiltProgram``: every rank's
    :class:`HeldShapes` against the contract's declarations, at the global
    leaves and mesh axes the program's build stated. Unsharded programs
    (``n_workers_mesh <= 1``: the one-device serve and kernel programs)
    are skipped with a named reason rather than checked against layouts
    that assume a mesh. Returns rank 0's metrics with every rank's count of
    violations; every rank's violations."""
    from distributed_eigenspaces_tpu_torch.analysis.contracts import Violation

    params = built.params
    scontract = getattr(contract, "sharding", None)
    if scontract is None:
        return [], {"checked": False, "reason": "no sharding contract"}
    if params.n_workers_mesh <= 1:
        return [], {"checked": False, "reason": "unsharded program"}
    if not built.held or built.leaves is None:
        return [Violation(
            program=built.name, rule="sharding-contract",
            message="a mesh program whose ranks recorded nothing they held "
                    "— the audit would pass vacuously")], {"checked": False,
                                                           "reason": "nothing held"}
    viols: list = []
    by_rank = {}
    metrics = None
    for held in built.held:
        v, m = check_shardings(
            scontract, params, program=built.name,
            dense_dim=contract.dense_dim(params), axis_sizes=built.leaves.axis_sizes,
            in_global=built.leaves.ins, out_global=built.leaves.outs, held=held,
        )
        viols += v
        by_rank[held.rank] = len(v)
        # rank 0's metrics, or the first rank's that could not be checked
        if metrics is None or (metrics["checked"] and not m["checked"]):
            metrics = m
    metrics = dict(metrics, axis_sizes=dict(built.leaves.axis_sizes),
                   n_violations_by_rank=by_rank)
    return viols, metrics
