"""Analytic cost model: per-program FLOPs, memory bytes, and per-mesh-axis
collective bytes x hops of one run, pinned as a committed snapshot.

Counterpart of ``distributed_eigenspaces_tpu/analysis/costmodel.py``. Two
halves:

- **Measured** (:func:`measured_costs`): the reference reads
  ``compiled.cost_analysis()`` and parses replica groups out of HLO; the
  port reads what one run of the program did, on rank 0 of its mesh:
  FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, memory bytes as
  the buffer trace's inputs and op outputs (each read or written once),
  and every recorded collective attributed to the mesh axis its record
  names (ring accounting: ``(g-1)/g * payload`` per rank for gather-class
  ops, ``2 (g-1)/g`` for all-reduce, ``g-1`` hops — ``2 (g-1)`` for
  all-reduce). The counts are the run's: a collective a scan body makes
  every step counts every step (the reference sees it once in the text).

- **Modeled** (:func:`model_costs`, :func:`projections`): the reference's
  closed-form byte counts per contract kind as functions of
  :class:`~.contracts.ProgramParams`, copied as they are.

The committed snapshot (``ANALYSIS_COSTS_TORCH.json`` at the repo root) is
made on the CPU, by ``scripts/torch_analyze.py --costs --write-costs``:
``FlopCounterMode`` counts no FLOP inside a hand-written CUDA kernel, so a
snapshot of a run on the card would count a different program. On the CPU
the programs run their plain versions, and the file is deterministic for
the installed torch (a regeneration on clean HEAD is a no-op diff).
:func:`check_snapshot` diff-gates it (rule ``cost-drift``); on the card
``chip_smoke.py`` holds only ``collectives_per_axis`` and
``budget_bytes_per_op`` against it (gloo moves the same tensors on both
routes). :func:`check_cost_bound` enforces the closed-form per-op byte
budget on every program (rule ``cost-bound``).

The link anchors are the card's published rates, not measurements:
:data:`ICI_GB_PER_SEC` is NVLink 4 on one H100 SXM5 80GB (700 W): 900 GB/s
total, 450 GB/s each way (NVIDIA H100 Tensor Core GPU datasheet);
:data:`DCN_GB_PER_SEC` is the network across hosts, one 400 Gb/s NDR
InfiniBand port (ConnectX-7) per H100 SXM5, 50 GB/s each way (NVIDIA DGX
H100 datasheet). The names are the reference's, whose anchors are a TPU
v5e interconnect link and a data-centre network share.
"""

from __future__ import annotations

import json
import math
import os

import torch

from distributed_eigenspaces_tpu_torch.analysis import hlo as _hlo

SNAPSHOT_SCHEMA = "analysis-costs-v1"
SNAPSHOT_NAME = "ANALYSIS_COSTS_TORCH.json"

#: budgets are quoted at the f32 ceiling even where payloads are bf16 —
#: the bound must survive a dtype widening, not track it
BUDGET_ITEMSIZE = 4

#: published link rates of an H100 SXM5 80GB (700 W) node, GB/s each way:
#: NVLink 4 inside a host, one ConnectX-7 400 Gb/s port across hosts (the
#: module docstring names the sources). Not measured here.
ICI_GB_PER_SEC = 450.0
DCN_GB_PER_SEC = 50.0


def snapshot_path() -> str:
    """The committed snapshot lives at the repo root."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)), SNAPSHOT_NAME)


def load_snapshot(path: str | None = None) -> dict | None:
    path = path or snapshot_path()
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def dumps_snapshot(snap: dict) -> str:
    """The committed text of a snapshot (or a plan): sorted keys, two-space
    indent, one trailing newline — byte-equal across regenerations."""
    return json.dumps(snap, indent=2, sort_keys=True) + "\n"


# -- measured side -----------------------------------------------------------


def _buffer_bytes(buffers) -> int:
    total = 0
    for _, shape, dtype in buffers:
        dt = getattr(torch, str(dtype).replace("torch.", ""), None)
        if isinstance(dt, torch.dtype):
            total += math.prod(shape) * dt.itemsize
    return total


def measured_costs(built) -> dict:
    """FLOPs, memory bytes, and per-axis collective wire bytes / hops of one
    BuiltProgram's run (rank 0's in a mesh program)."""
    per_axis: dict[str, dict] = {}
    for op in _hlo.parse_collectives(built.collectives):
        g = op.group_size
        ring = (g - 1) / g if g > 1 else 0.0
        factor = 2.0 if op.op == "all-reduce" else 1.0
        ent = per_axis.setdefault(op.axis, {
            "bytes_on_wire": 0, "hops": 0, "n_ops": 0, "max_payload_bytes": 0,
        })
        ent["bytes_on_wire"] += int(round(factor * ring * op.payload_bytes))
        ent["hops"] += int(factor * (g - 1))
        ent["n_ops"] += 1
        ent["max_payload_bytes"] = max(ent["max_payload_bytes"], op.payload_bytes)
    return {
        "flops": int(built.flops or 0),
        "hbm_bytes_accessed": _buffer_bytes(built.buffers),
        "collectives_per_axis": {k: per_axis[k] for k in sorted(per_axis)},
    }


# -- modeled side ------------------------------------------------------------


def _ring(g: int) -> float:
    return (g - 1) / g if g > 1 else 0.0


def model_costs(kind: str, p, *, itemsize: int = BUDGET_ITEMSIZE) -> dict:
    """Closed-form per-axis collective byte terms per contract kind —
    the structural numbers the snapshot pins and the deadline budgets
    quote. Zero-collective kinds (fleet, serve) model an empty dict."""
    kf = max(p.k, p.sketch_width)
    out: dict[str, dict] = {}
    if kind == "scan_fit":
        w = max(p.n_workers_mesh, 1)
        out["workers"] = {
            "factor_gather_bytes_per_step": int(
                _ring(w) * p.m * p.d_local * kf * itemsize
            ),
        }
    elif kind == "feature_sharded":
        w = max(p.n_workers_mesh, 1)
        f = max(p.n_feature_shards, 1)
        out["workers"] = {
            "factor_gather_bytes_per_step": int(
                _ring(w) * p.m * p.d_local * kf * itemsize
            ),
        }
        out["features"] = {
            # k-wide reductions (sharded matvec / CholeskyQR Grams /
            # sketch folds): bounded by one (d_local, kf) panel psum
            "kwide_reduce_bytes_bound": int(
                2 * _ring(f) * p.d_local * kf * itemsize
            ),
        }
    elif kind == "dist_solve":
        w = max(p.n_workers_mesh, 1)
        f = max(p.n_feature_shards, 1)
        # the iterated block: k + a few oversample columns, capped by
        # the operator's factor width (solvers._default_oversample)
        width = max(p.m * kf, p.sketch_width, 1)
        blk = min(kf + 8, width)
        if p.m > 1:
            out["workers"] = {
                "factor_gather_bytes": int(
                    _ring(w) * p.m * p.d_local * kf * itemsize
                ),
            }
        out["features"] = {
            # per-iteration k-wide psums: CholeskyQR2 Grams (blk^2)
            # and the factor matvec's (width, blk) inner product
            "kwide_psum_bytes_bound": int(
                2 * _ring(f) * max(width * blk, blk * blk) * itemsize
            ),
        }
    elif kind == "deflation_solve":
        L = max(p.components, 1)
        f = max(p.n_feature_shards, 1)
        kb = max(p.k // L, 1)
        width = max(p.m * kf, p.sketch_width, 1)
        if p.m > 1:
            w = max(p.n_workers_mesh, 1)
            out["workers"] = {
                "factor_gather_bytes": int(
                    _ring(w) * p.m * p.d_local * kf * itemsize
                ),
            }
        out["components"] = {
            # per-sweep cross-lane gather of the own (d_local, kb)
            # panel — gathered size d_local * k, the contract ceiling
            "lane_gather_bytes_per_iter": int(
                _ring(L) * L * p.d_local * kb * itemsize
            ),
        }
        out["features"] = {
            # the (L, kb, kb) deflation-coefficient psum, CholeskyQR2
            # Grams, and the factor matvec's (width, kb) inner product
            "kwide_psum_bytes_bound": int(
                2 * _ring(f) * max(L * kb * kb, width * kb) * itemsize
            ),
        }
    elif kind == "dist_serve":
        f = max(p.n_feature_shards, 1)
        w = max(p.n_workers_mesh, 1)
        out["features"] = {
            # the projection / input-energy psum: per-device rows x k
            "project_psum_bytes": int(
                2 * _ring(f) * (p.rows // w) * kf * itemsize
            ),
        }
    elif kind == "tree_merge":
        # per-tier wire dtype: the two data movers ship at the declared
        # codec's itemsize; the Gram psum always stays at the caller's
        # (f32) itemsize — accumulation is never compressed. Programs
        # without a policy emit the uncompressed dicts.
        from distributed_eigenspaces_tpu_torch.parallel.wire import WIRE_ITEMSIZE

        wire = p.tier_wire_dtypes or ("fp32",) * len(p.tier_axes)
        for name, fan, dtype in zip(p.tier_axes, p.tier_fan_ins, wire):
            w_item = itemsize if dtype == "fp32" else WIRE_ITEMSIZE[dtype]
            out[name] = {
                "alltoall_factor_bytes": int(_ring(fan) * p.d_local * kf * w_item),
                "gram_psum_bytes": int(2 * _ring(fan) * (fan * kf) ** 2 * itemsize),
                "basis_gather_bytes": int(_ring(fan) * p.d_local * kf * w_item),
            }
            if dtype != "fp32":
                out[name]["wire_dtype"] = dtype
            if dtype == "int8":
                # the fp32 per-column scale sidecars: one (fan, 1, kf)
                # all_to_all row + one (1, kf) gather row per round
                out[name]["scale_sidecar_bytes"] = int(
                    _ring(fan) * (fan + 1) * kf * itemsize
                )
    return out


def check_cost_bound(
    kind: str, params, records, *, program: str
) -> tuple[list, dict]:
    """The closed-form byte budget, enforced: no single collective may
    move more bytes than the contract's payload ceiling at the f32
    itemsize. Catches payload drift the op-kind allowlist cannot — a
    tree tier moving the m-wide factor STACK (all-reduce is allowed!)
    instead of the (d, k) basis, or a dtype widening that doubles wire
    bytes at constant element count."""
    from distributed_eigenspaces_tpu_torch.analysis import contracts

    contract = contracts.CONTRACTS[kind]
    if contract.max_payload_elems is None:
        # zero-collective contracts: any op at all is a collective-op
        # violation already; there is no byte budget to apply
        return [], {"budget_bytes_per_op": 0}
    budget = contract.max_payload_elems(params) * BUDGET_ITEMSIZE
    viols = []
    for op in _hlo.parse_collectives(records):
        if op.payload_bytes > budget:
            viols.append(contracts.Violation(
                program=program,
                rule="cost-bound",
                message=(
                    f"{op.op} moves {op.payload_bytes} payload bytes "
                    f"per device, over the cost-model budget {budget} "
                    f"B (= {contract.max_payload_elems(params)} elems "
                    f"x {BUDGET_ITEMSIZE} B at d={params.d}, "
                    f"k={params.k}) — the schedule drifted from the "
                    f"modeled payload (contract {kind!r})"
                ),
                location=op.line,
            ))
    return viols, {"budget_bytes_per_op": int(budget)}


def check_built(built) -> tuple[list, dict]:
    """The cost pass over one BuiltProgram: measured costs + the per-op
    byte budget."""
    meas = measured_costs(built)
    viols, budget = check_cost_bound(
        built.contract, built.params, built.collectives, program=built.name,
    )
    return viols, {**meas, **budget}


# -- projections: the 4x claim + per-tier deadline budgets -------------------


def projections() -> dict:
    """Closed-form only (nothing runs): the flat-vs-tree payload ratio at
    the audit shapes and at a large-d topology, plus per-tier wire-byte
    deadline budgets at the link anchors. The snapshot commits these so
    the 4x structural claim is a diffable number."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import _D, _K, _M
    from distributed_eigenspaces_tpu_torch.parallel.wire import WIRE_ITEMSIZE

    def flat_elems(m, d, k):
        return m * d * k

    def tree_elems(d, k, fan_ins):
        return max(d * k, max(((f * k) ** 2 for f in fan_ins), default=0))

    audit_fan_ins = (2, 2)  # the matrix's ("chip", 2), ("host", 2)
    audit_flat = flat_elems(_M, _D, _K)
    audit_tree = tree_elems(_D, _K, audit_fan_ins)

    d, k, m = 32768, 8, 64
    tiers = (("chip", 16), ("host", 4))
    large_flat = flat_elems(m, d, k)
    large_tree = tree_elems(d, k, tuple(f for _, f in tiers))

    budgets = {}
    for name, fan in tiers:
        wire = int(_ring(fan) * (2 * d * k + 2 * (fan * k) ** 2) * BUDGET_ITEMSIZE)
        gbps = ICI_GB_PER_SEC if name == "chip" else DCN_GB_PER_SEC
        budgets[name] = {
            "fan_in": fan,
            "wire_bytes_per_round": wire,
            "assumed_gb_per_sec": gbps,
            "modeled_ms_per_round": round(wire / (gbps * 1e9) * 1e3, 4),
        }

    # wire compression at the same large-d topology: the host tier's two
    # data movers per round under each codec (the Gram psum is never
    # compressed and is left out of both sides of the ratio)
    host_fan = dict(tiers)["host"]
    mover_elems = 2 * _ring(host_fan) * d * k
    host_fp32 = mover_elems * WIRE_ITEMSIZE["fp32"]
    wire_proj = {
        "host_fan_in": host_fan,
        "fp32_mover_bytes_per_round": int(host_fp32),
    }
    for dtype in ("bf16", "int8"):
        b = mover_elems * WIRE_ITEMSIZE[dtype]
        if dtype == "int8":
            b += _ring(host_fan) * (host_fan + 1) * k * BUDGET_ITEMSIZE
        wire_proj[dtype] = {
            "mover_bytes_per_round": int(b),
            "reduction_vs_fp32": round(host_fp32 / b, 2),
        }

    return {
        "audit_shapes": {
            "d": _D, "k": _K, "m": _M,
            "tier_fan_ins": list(audit_fan_ins),
            "flat_payload_elems": audit_flat,
            "tree_payload_elems": audit_tree,
            "flat_over_tree": round(audit_flat / audit_tree, 2),
        },
        "large_d": {
            "d": d, "k": k, "m": m,
            "tier_fan_ins": [f for _, f in tiers],
            "flat_payload_elems": large_flat,
            "tree_payload_elems": large_tree,
            "flat_over_tree": round(large_flat / large_tree, 2),
        },
        "tier_deadline_budgets_large_d": budgets,
        "wire_compression_large_d": wire_proj,
        "model": (
            "ring collectives; per-round tier wire = all_to_all + "
            "boundary gather (2*d*k) + Gram psum (2*(f*k)^2), f32; "
            "wire_compression quotes the host tier's two data movers "
            "per codec (psum always f32), int8 incl. scale sidecars"
        ),
    }


# -- snapshot ----------------------------------------------------------------


def cost_snapshot(program_names=None, *, built=None) -> dict:
    """The committed artifact: per-program measured + modeled costs over
    the matrix, plus the projections. Built on the CPU (the module
    docstring says why); ``built`` (name -> BuiltProgram, from
    ``programs.build_matrix(device="cpu")``) reuses programs already run,
    so a caller that audits the matrix pays for its process group once."""
    from distributed_eigenspaces_tpu_torch.analysis import contracts, programs

    names = sorted(program_names or programs.MATRIX)
    if built is None:
        built, _ = programs.build_matrix(names, device="cpu")
    snap: dict = {"schema": SNAPSHOT_SCHEMA, "programs": {}}
    for name in names:
        b = built[name]
        if b.device.type != "cpu":
            raise ValueError(
                f"cost_snapshot: {name!r} ran on {b.device}; the snapshot is "
                "made on the CPU (FlopCounterMode counts no FLOP inside a "
                "hand-written CUDA kernel)"
            )
        bound = contracts.CONTRACTS[b.contract].max_payload_elems
        snap["programs"][name] = {
            "contract": b.contract,
            **measured_costs(b),
            "model": model_costs(b.contract, b.params),
            "budget_bytes_per_op": (
                int(bound(b.params) * BUDGET_ITEMSIZE) if bound else 0
            ),
        }
    snap["projections"] = projections()
    return snap


#: the fields of a program's snapshot entry :func:`check_snapshot` compares
SNAPSHOT_KEYS = (
    "contract", "flops", "hbm_bytes_accessed",
    "collectives_per_axis", "model", "budget_bytes_per_op",
)


def check_snapshot(current: dict, committed: dict | None, *, keys=SNAPSHOT_KEYS,
                   projections_too: bool = True) -> list:
    """Diff-gate: regenerated snapshot vs the committed one, exact
    structural compare over ``keys`` of each program (all of them by
    default; ``chip_smoke.py`` passes the two that hold on the card).
    Every mismatch is one ``cost-drift`` violation naming the program, the
    field, and both values; intentional changes re-commit via
    ``scripts/torch_analyze.py --costs --write-costs``."""
    from distributed_eigenspaces_tpu_torch.analysis.contracts import Violation

    viols: list = []

    def drift(message: str, location: str = "") -> None:
        viols.append(Violation(
            program="cost-snapshot", rule="cost-drift",
            message=message, location=location,
        ))

    if committed is None:
        drift(
            f"no committed {SNAPSHOT_NAME} found — generate it with "
            "scripts/torch_analyze.py --all --costs --write-costs and "
            "commit the file"
        )
        return viols
    if committed.get("schema") != current.get("schema"):
        drift(
            f"snapshot schema drifted: committed "
            f"{committed.get('schema')!r} != {current.get('schema')!r}"
        )
    cur = current.get("programs", {})
    com = committed.get("programs", {})
    for name in sorted(set(cur) | set(com)):
        if name not in com:
            drift(
                f"program {name!r} has no committed cost entry — "
                "regenerate the snapshot (--write-costs)",
                location=name,
            )
            continue
        if name not in cur:
            drift(
                f"committed cost entry {name!r} is no longer in the "
                "program matrix — regenerate the snapshot (--write-costs)",
                location=name,
            )
            continue
        for key in keys:
            if cur[name].get(key) != com[name].get(key):
                drift(
                    f"{name}: {key} drifted: committed "
                    f"{com[name].get(key)!r} != regenerated "
                    f"{cur[name].get(key)!r}",
                    location=name,
                )
    if projections_too and current.get("projections") != committed.get("projections"):
        drift("projections drifted: regenerate the snapshot")
    return viols
