"""The collective audit, read from the records of a run, and the collective
byte model of the eval reports' ``ici_model`` block.

Counterpart of ``distributed_eigenspaces_tpu/analysis/hlo.py``. The
reference parses the collectives out of compiled, SPMD-partitioned HLO; the
port compiles nothing, so it reads what a run handed to
``torch.distributed``: the records of ``parallel.mesh.recording_collectives``
(per call op, axis, dtype, elements, bytes, group size, tag and the result's
shape on this rank). :func:`parse_collectives` turns them into the
reference's :class:`CollectiveOp` and :func:`audit_compiled` into its audit
dict; :class:`AuditParseError` keeps its role: a record the audit cannot
account for (an unknown op or dtype, a shape that disagrees with the
elements handed over) raises by name, never guessed at.

Conventions against the reference's HLO:

- ``shape`` is the per-device result an HLO instruction prints: a gather's
  whole output (its own shard times the group), a sum's operand, an
  all-to-all's whole buffer, a permute's block;
- an all-to-all counts the whole buffer this rank hands over, where the
  reference's parser keeps the largest member of a tuple-shaped
  all-to-all, one chunk: the port's payload is the larger, so a bound read
  against it is never looser;
- every call of the run is one op, where the reference sees a scan body's
  collective once in the text: counts and wire bytes are the run's.

``ici_step_model`` and ``scaling_projection`` are the reference's
integers; the assumed link rate is the H100 SXM's NVLink instead of a TPU
interconnect link.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

#: the recorder's op names -> the HLO op names the contracts speak
_OP_NAMES = {
    "all_gather": "all-gather",
    "psum": "all-reduce",
    "pmax": "all-reduce",
    "all_to_all": "all-to-all",
    "ppermute": "collective-permute",
}

#: torch dtype names (as the recorder writes them) -> the HLO dtype tokens
_HLO_DTYPE = {
    "float64": "f64", "float32": "f32", "bfloat16": "bf16", "float16": "f16",
    "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2",
    "int64": "s64", "int32": "s32", "int16": "s16", "int8": "s8",
    "uint64": "u64", "uint32": "u32", "uint16": "u16", "uint8": "u8",
    "bool": "pred", "complex64": "c64", "complex128": "c128",
}

#: bytes per element of every HLO dtype token the table above produces
_ITEMSIZE = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}


class AuditParseError(RuntimeError):
    """A collective record the audit cannot weigh: an unknown op or dtype,
    or a shape that disagrees with what the rank handed over. Loud by
    design: an audit that guesses can read "no dense collectives" off a
    run it never understood."""


def itemsize_of(dtype: str, *, context: str = "") -> int:
    """Bytes per element for an HLO dtype token, or a loud
    :class:`AuditParseError` naming the dtype and the offending record."""
    try:
        return _ITEMSIZE[dtype]
    except KeyError:
        raise AuditParseError(
            f"unknown dtype {dtype!r} — the audit cannot weigh its payload; "
            "add it to analysis.hlo._ITEMSIZE"
            + (f" (offending record: {context.strip()!r})" if context else "")
        ) from None


@dataclass(frozen=True)
class CollectiveOp:
    op: str  # all-gather / all-reduce / ...
    dtype: str
    shape: tuple[int, ...]
    #: the record the op was read from, as one line — error context and the
    #: location of a contract violation
    line: str = field(default="", compare=False)
    #: the mesh axis the collective ran over (the record names it: no
    #: replica-group parsing) and that axis' size
    axis: str = ""
    group_size: int = 1
    #: the caller's label of a side payload (``int8_scale``, ``weights``)
    tag: str | None = None

    @property
    def elems(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def payload_bytes(self) -> int:
        return self.elems * itemsize_of(self.dtype, context=self.line)


def _line_of(rec: dict) -> str:
    shape = ",".join(str(s) for s in rec.get("shape", ()))
    tag = f" tag={rec['tag']}" if rec.get("tag") else ""
    return (f"{rec.get('op')} over {rec.get('axis')!r} (group of "
            f"{rec.get('group_size')}): {rec.get('dtype')}[{shape}], "
            f"{rec.get('elements')} elems handed over{tag}")


def parse_collectives(records) -> list[CollectiveOp]:
    """Every recorded collective as a :class:`CollectiveOp`, in call order.
    ``shape`` is the per-device result (the module docstring's
    conventions). Raises :class:`AuditParseError` on a record whose op or
    dtype the audit does not know, or whose shape disagrees with the
    elements handed over (a gather's result is its shard times the group,
    any other result is the tensor itself)."""
    out = []
    for rec in records:
        line = _line_of(rec)
        try:
            op = _OP_NAMES[rec["op"]]
            dtype = _HLO_DTYPE[rec["dtype"]]
        except KeyError as e:
            raise AuditParseError(
                f"collective record names an unknown {e.args[0]!r} — extend "
                f"analysis.hlo._OP_NAMES / _HLO_DTYPE (offending record: "
                f"{line!r})"
            ) from None
        shape = tuple(int(s) for s in rec["shape"])
        g = int(rec["group_size"])
        want = rec["elements"] * (g if op == "all-gather" else 1)
        if (math.prod(shape) if shape else 1) != want:
            raise AuditParseError(
                f"collective record's shape {list(shape)} does not hold the "
                f"{want} elements its op moves (offending record: {line!r})"
            )
        out.append(CollectiveOp(op=op, dtype=dtype, shape=shape, line=line,
                                axis=str(rec["axis"]), group_size=g,
                                tag=rec.get("tag")))
    return out


def audit_compiled(records) -> dict:
    """Summary of a run's collectives: per-(op, dtype, shape) counts plus
    the largest single payload — the number the dense-collective tripwire
    checks. The reference audits a compiled program; the port audits the
    records of one run of it (``parallel.mesh.recording_collectives``)."""
    ops = parse_collectives(records)
    counts: dict[str, int] = {}
    for o in ops:
        key = f"{o.op} {o.dtype}[{','.join(map(str, o.shape))}]"
        counts[key] = counts.get(key, 0) + 1
    return {
        "ops": counts,
        "n_collectives": len(ops),
        "max_payload_elems": max((o.elems for o in ops), default=0),
        "max_payload_bytes": max((o.payload_bytes for o in ops), default=0),
        "_parsed": ops,
    }


def assert_no_dense_collective(audit: dict, dim: int) -> None:
    """The regression tripwire: no collective payload may reach ``d^2``
    elements (or even half of it) — the structural invariant every
    sharded trainer maintains is that ONLY factor stacks (m·d·k) and
    k-wide reductions cross the mesh, never a dense d x d matrix. A
    reintroduced dense-projector psum trips this immediately."""
    limit = dim * dim // 2
    worst = audit["max_payload_elems"]
    if worst >= limit:
        offenders = [
            f"{o.op} {o.dtype}{list(o.shape)}"
            for o in audit["_parsed"]
            if o.elems >= limit
        ]
        raise AssertionError(
            f"dense collective detected: payload {worst} elems >= "
            f"d^2/2 = {limit} ({', '.join(offenders)}) — the merge must "
            "move factors, not d x d matrices (ops/linalg.py "
            "merged_top_k_lowrank)"
        )


#: one H100 SXM's NVLink rate each way (900 GB/s to the other cards of the
#: host, all to all: 450 GB/s in each direction)
NVLINK_GB_PER_SEC = 450.0


def ici_step_model(
    m: int, d: int, k: int, *,
    n_workers_mesh: int, n_feature_shards: int = 1, itemsize: int = 4,
) -> dict:
    """Documented per-step ICI byte model for the sharded trainers,
    ring-collective accounting (what XLA lowers to on a torus):

    - factor merge: ``all_gather`` of per-device ``(m/W, d_l, k)`` shards
      into ``(m, d_l, k)`` on each of W worker-mesh devices — each
      device moves ``(W-1)/W * m * d_l * k`` elements per step
      (``d_l = d / n_feature_shards``);
    - the dense alternative this design replaces: ``psum`` of a
      ``d x d`` projector — ``2 * (W-1)/W * d^2`` elements per device;
    - feature-axis reductions (sharded matvec / CholeskyQR Grams /
      sketch folds): k-wide payloads, O(n·k + k^2) elements — reported
      as a bound, not enumerated (each is <= the merge payload by
      construction; the audit asserts the ceiling).

    Returns modeled bytes/device/step for the factor route, the dense
    route, and their ratio — the number BASELINE.md's "16x less ICI
    traffic" claim quotes, now computed instead of asserted in prose.
    """
    w = max(n_workers_mesh, 1)
    d_local = d // max(n_feature_shards, 1)
    ring = (w - 1) / w if w > 1 else 0.0
    factor = ring * m * d_local * k * itemsize
    dense = 2.0 * ring * d * d * itemsize
    return {
        "factor_gather_bytes_per_step": int(factor),
        "dense_psum_bytes_per_step": int(dense),
        # None (not inf) when the worker axis is trivial — a 1-chip mesh
        # moves nothing, and inf is not valid strict JSON
        "dense_over_factor": (
            round(dense / factor, 2) if factor else None
        ),
        "model": "ring collectives: all_gather (W-1)/W*payload, "
                 "psum 2*(W-1)/W*payload, per device per step",
    }


def scaling_projection(
    m: int, d: int, k: int, *, step_seconds: float,
    n_workers_mesh: int, n_feature_shards: int = 1,
    ici_gbps: float = NVLINK_GB_PER_SEC,
) -> dict:
    """Collective-bytes-per-step vs step-time projection: at what mesh size
    does the merge's collective stop hiding behind the step's compute?
    ``ici_gbps`` defaults to :data:`NVLINK_GB_PER_SEC`, one H100 SXM's
    NVLink rate each way; the point of the field is the RATIO trend, not
    the last percent — both inputs are in the JSON so readers can
    re-anchor. The keys keep the reference's names (``ici`` there is the
    TPU's interconnect; here it is NVLink)."""
    model = ici_step_model(
        m, d, k,
        n_workers_mesh=n_workers_mesh,
        n_feature_shards=n_feature_shards,
    )
    wire_s = model["factor_gather_bytes_per_step"] / (ici_gbps * 1e9)
    return {
        **model,
        "assumed_ici_gb_per_sec": ici_gbps,
        "modeled_collective_seconds_per_step": round(wire_s, 9),
        "measured_step_seconds": round(step_seconds, 9),
        "collective_fraction_of_step": (
            round(wire_s / step_seconds, 6) if step_seconds > 0 else None
        ),
    }
