"""Offline planner: a declared workload in, an auditable ``plan-v1``
artifact out — the cost model closing the configuration loop.

Counterpart of ``distributed_eigenspaces_tpu/analysis/planner.py``, with its
rules, candidate set, prices and JSON shapes. Every scale knob
(``merge_topology``, ``merge_wire_dtype``, ``merge_interval``,
``pipeline_merge``, serve bucket sizes, ``serve_continuous``, replica
count) is priced here instead of hand-picked:

- **Enumerate** candidate configs over the elastic surfaces only — merge-tree
  fan-in splits of the declared worker mesh, the (``pipeline_merge`` x
  ``merge_interval``) arms the calibration measured, serve bucket sizes,
  continuous vs deadline batching, replica counts up to the declared fleet.
- **Price** each candidate with the closed-form per-tier wire model at the
  declared link speeds (the ring formulas :func:`.costmodel.projections`
  commits) plus serve terms calibrated from the card's record,
  ``PLAN_CALIBRATION_H100.json`` (written by
  ``scripts/torch_plan_calibrate.py`` on an H100; FLOP-scaled from the
  record's own shape, so the calibration is exact at the record and a
  declared extrapolation elsewhere). The link speeds default to the card's
  published NVLink and network rates (:mod:`.costmodel`).
- **Refuse loudly** when the spec is infeasible: no tier split divides the
  worker mesh over the declared fleet (:class:`PlanInfeasible`), or every
  candidate's predicted p99 lands over the declared SLO / a tier budget over
  the round deadline (the rejection histogram rides the error).

The chosen config + predicted budgets are emitted as a deterministic JSON
artifact (no timestamps — regeneration on clean HEAD is a no-op diff) that
``cli.py --plan`` consumes and ``scripts/torch_analyze.py --plan``
diff-gates against the committed ``ANALYSIS_PLAN_TORCH.json`` (rule
``plan-drift``). :func:`self_check` re-verifies any plan against its own
declared budgets (rule ``plan-infeasible`` — the seeded
``plan_infeasible_accepted`` mutation's hook), and :func:`drift_check`
compares the plan's anchored predictions against the card's CURRENT record:
warn at :data:`DRIFT_WARN_RATIO` x, fail at :data:`DRIFT_FAIL_RATIO` x.
"""

from __future__ import annotations

import hashlib
import json
import os

from distributed_eigenspaces_tpu_torch.analysis import costmodel

PLAN_SCHEMA = "plan-v1"
PLAN_NAME = "ANALYSIS_PLAN_TORCH.json"

#: model-vs-measured drift gate: a calibrated prediction more than
#: WARN x off the current committed record warns in CI; FAIL x fails.
DRIFT_WARN_RATIO = 2.0
DRIFT_FAIL_RATIO = 5.0

#: the serve elastic surfaces the planner enumerates (the autoscaler
#: acts on the same set — one knob vocabulary for both halves)
_BUCKET_CANDIDATES = (4, 8, 16, 32)
_FLUSH_S_CANDIDATES = (0.02, 0.05)

#: workload spec: a CLOSED field set, like scenario specs — an unknown
#: field is a spec bug, not a default silently applied
_WORKLOAD_FIELDS = {
    "name", "d", "k", "m", "n", "qps", "fleet", "rows_per_query",
    "slo_p99_ms", "round_deadline_ms", "ici_gb_per_sec",
    "dcn_gb_per_sec",
}
_REQUIRED_FIELDS = {"d", "k", "m", "n", "qps", "slo_p99_ms"}

#: the audit-shape workload the gate plans (scripts/torch_analyze.py --plan): the
#: d=32768 pod the cost model's committed projections already price
DEFAULT_WORKLOAD = {
    "name": "audit_pod",
    "d": 32768, "k": 8, "m": 64, "n": 128,
    # the reference's workload and SLOs; only the link speeds are the
    # card's (costmodel.ICI_GB_PER_SEC / DCN_GB_PER_SEC)
    "qps": 250.0, "fleet": 8, "rows_per_query": 8,
    "slo_p99_ms": 500.0, "round_deadline_ms": 250.0,
    "ici_gb_per_sec": costmodel.ICI_GB_PER_SEC,
    "dcn_gb_per_sec": costmodel.DCN_GB_PER_SEC,
}


class PlanInfeasible(ValueError):
    """The declared workload admits NO feasible candidate — refused
    loudly with the per-reason rejection histogram, never silently
    planned anyway."""


def plan_file_path() -> str:
    """The committed artifact lives at the repo root, next to
    ``ANALYSIS_COSTS.json``."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(
        os.path.dirname(os.path.dirname(here)), PLAN_NAME
    )


def load_plan(path: str | None = None) -> dict | None:
    path = path or plan_file_path()
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def validate_workload(spec: dict) -> dict:
    """Loud validation of a declared workload: closed field set,
    required fields present, values positive and mutually coherent."""
    if not isinstance(spec, dict):
        raise ValueError(
            f"workload spec must be a dict, got {type(spec).__name__}"
        )
    extra = set(spec) - _WORKLOAD_FIELDS
    if extra:
        raise ValueError(
            f"unknown workload field(s) {sorted(extra)} — known fields: "
            f"{sorted(_WORKLOAD_FIELDS)}"
        )
    missing = _REQUIRED_FIELDS - set(spec)
    if missing:
        raise ValueError(
            f"workload spec missing required field(s) {sorted(missing)}"
        )
    out = dict(DEFAULT_WORKLOAD)
    out.update(spec)
    for field in ("d", "k", "m", "n", "fleet", "rows_per_query"):
        v = out[field]
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(
                f"workload {field} must be an int >= 1, got {v!r}"
            )
    for field in (
        "qps", "slo_p99_ms", "round_deadline_ms",
        "ici_gb_per_sec", "dcn_gb_per_sec",
    ):
        v = out[field]
        if not isinstance(v, (int, float)) or isinstance(
            v, bool
        ) or v <= 0:
            raise ValueError(
                f"workload {field} must be a positive number, got {v!r}"
            )
    if out["k"] > out["d"]:
        raise ValueError(
            f"workload needs k <= d, got k={out['k']}, d={out['d']}"
        )
    if not isinstance(out["name"], str) or not out["name"]:
        raise ValueError(
            f"workload name must be a non-empty string, got "
            f"{out['name']!r}"
        )
    return out


# -- calibration: committed smoke records as model anchors -------------------


#: the card's calibration record: written by
#: ``scripts/torch_plan_calibrate.py`` on an H100, one field a term
CALIBRATION_RECORD = "PLAN_CALIBRATION_H100.json"

#: the record -> the calibrated terms it anchors. Every term carries its
#: source record + field so the artifact is auditable.
_CALIBRATION_SOURCES = {
    CALIBRATION_RECORD: (
        "the card's serve kernel ms and continuous admit p99 at the "
        "wirespeed shape, deadline-batched serve p99 at the serve shape, "
        "warm first-serve ms, and the (pipeline_merge x merge_interval) "
        "grid with its 0.2 deg gate"
    ),
}

#: the record's term fields, and what each keeps beside its value
_TERM_EXTRAS = {
    "serve_admit_p99_ms": (),
    "serve_kernel_ms": ("at_rows_dk",),
    "serve_deadline_p99_ms": ("at_flush_ms",),
    "warm_first_serve_ms": (),
    "fit_schedule_arms": (),
}


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def load_calibration(root: str | None = None) -> dict:
    """The calibrated serve / compile / schedule terms, read from the
    card's record (:data:`CALIBRATION_RECORD`, never a CPU record). A
    missing record drops its terms, and a missing field its term (the
    planner falls back to the closed-form-only model and says so in the
    artifact) — never a crash, never a silent default."""
    root = root or _repo_root()
    calib: dict = {"sources": {}, "terms": {}}
    path = os.path.join(root, CALIBRATION_RECORD)
    if not os.path.exists(path):
        return calib
    with open(path, encoding="utf-8") as f:
        rec = json.load(f)
    calib["sources"][CALIBRATION_RECORD] = _CALIBRATION_SOURCES[CALIBRATION_RECORD]
    for name, extras in _TERM_EXTRAS.items():
        field = rec.get(name)
        if not isinstance(field, dict) or field.get("value") is None:
            continue
        term = {"value": field["value"]}
        for extra in extras:
            if extra in field:
                term[extra] = field[extra]
        term["source"] = f"{CALIBRATION_RECORD}:{name}"
        calib["terms"][name] = term
    return calib


def _schedule_arms(calib: dict) -> list[tuple[bool, int, float]]:
    """The (pipeline_merge, merge_interval, measured_speedup) arms the
    planner may choose from: only arms the committed grid MEASURED and
    whose 0.2 deg accuracy gate passed. Without the grid record only
    the identity arm (off, 1, 1.0) is admissible — an unmeasured
    schedule restructure is not a plannable win."""
    arms = [(False, 1, 1.0)]
    term = calib.get("terms", {}).get("fit_schedule_arms")
    if term is None:
        return arms
    for name, row in term["value"].items():
        if not row.get("gate_0p2deg_ok") or row.get("speedup") is None:
            continue
        try:
            pipe_tok, s_tok = name.split(",")
            pipe = pipe_tok.split("=")[1] == "on"
            s = int(s_tok.split("=")[1])
        except (IndexError, ValueError):
            continue
        if (pipe, s) != (False, 1):
            arms.append((pipe, s, float(row["speedup"])))
    return arms


# -- candidate enumeration ----------------------------------------------------


def _tier_splits(m: int, fleet: int) -> list[tuple | None]:
    """Merge topologies whose fan-in product divides the worker mesh
    over the declared fleet: flat (None) always, plus every two-tier
    ("chip", f_chip) / ("host", f_host) split with f_chip * f_host ==
    m and f_host <= fleet (the root tier cannot fan wider than the
    hosts it crosses). Workers must pack evenly onto hosts — a mesh no
    split divides is the caller's PlanInfeasible."""
    splits: list[tuple | None] = [None]
    if m % fleet != 0:
        return splits
    for f_host in range(2, min(m, fleet) + 1):
        if m % f_host:
            continue
        f_chip = m // f_host
        if f_chip < 2:
            continue
        splits.append((("chip", f_chip), ("host", f_host)))
    return splits


#: the wire policies the planner enumerates for tiered merges
#: uncompressed, and the host (DCN) tier narrowed to each
#: codec. Chip-tier compression is not enumerated — ICI is never the
#: binding constraint in the priced workloads, so it would only grow
#: the candidate set without changing any choice.
_WIRE_POLICY_CANDIDATES: tuple[dict | None, ...] = (
    None, {"host": "bf16"}, {"host": "int8"},
)


def enumerate_candidates(spec: dict, calib: dict) -> list[dict]:
    """The candidate configs, elastic surfaces only: tier splits x
    host-tier wire dtype x measured schedule arms x serve
    bucket/flush/continuous x replica counts (powers of two up to the
    fleet)."""
    replicas = []
    r = 1
    while r <= spec["fleet"]:
        replicas.append(r)
        r *= 2
    cands = []
    for topo in _tier_splits(spec["m"], spec["fleet"]):
        # flat merges have no tiers to compress (config refuses the
        # combination for the same reason)
        wire_opts = _WIRE_POLICY_CANDIDATES if topo else (None,)
        for wire in wire_opts:
            for pipe, interval, speedup in _schedule_arms(calib):
                if topo is not None and pipe:
                    continue  # merge_topology rejects pipeline_merge
                for bucket in _BUCKET_CANDIDATES:
                    for flush_s in _FLUSH_S_CANDIDATES:
                        for cont in (False, True):
                            for n_rep in replicas:
                                cands.append({
                                    "merge_topology": topo,
                                    "merge_wire_dtype": wire,
                                    "pipeline_merge": pipe,
                                    "merge_interval": interval,
                                    "schedule_speedup": speedup,
                                    "serve_bucket_size": bucket,
                                    "serve_flush_s": flush_s,
                                    "serve_continuous": cont,
                                    "replicas": n_rep,
                                })
    return cands


# -- pricing ------------------------------------------------------------------


def _fit_tiers(cand: dict, spec: dict) -> dict:
    """Per-tier wire bytes + modeled ms per merge round at the
    DECLARED link speeds — the exact ring formulas
    :func:`.costmodel.projections` commits, evaluated on this
    candidate's topology. Flat merges price the m-wide factor gather
    on one tier, over DCN whenever the mesh spans more than one
    host."""
    d, k, m = spec["d"], spec["k"], spec["m"]
    itemsize = costmodel.BUDGET_ITEMSIZE
    ici, dcn = spec["ici_gb_per_sec"], spec["dcn_gb_per_sec"]
    tiers = {}
    if cand["merge_topology"] is None:
        wire = int(costmodel._ring(m) * m * d * k * itemsize)
        # a flat merge's gather spans the whole mesh: single-host
        # fleets ride ICI, anything wider crosses DCN
        gbps = ici if spec["fleet"] == 1 else dcn
        tiers["workers"] = {
            "fan_in": m,
            "wire_bytes_per_round": wire,
            "assumed_gb_per_sec": gbps,
            "modeled_ms_per_round": round(wire / (gbps * 1e9) * 1e3, 4),
        }
    else:
        from distributed_eigenspaces_tpu_torch.parallel.wire import WIRE_ITEMSIZE

        policy = cand.get("merge_wire_dtype") or {}
        for name, fan in cand["merge_topology"]:
            # the two data movers ship at the tier's declared codec
            # width; the Gram psum stays f32 (accumulation is never
            # compressed) — the same split model_costs commits
            dtype = policy.get(name, "fp32")
            ring = costmodel._ring(fan)
            wire = int(
                ring * 2 * d * k * WIRE_ITEMSIZE[dtype]
                + ring * 2 * (fan * k) ** 2 * itemsize
            )
            if dtype == "int8":
                wire += int(ring * (fan + 1) * k * itemsize)
            gbps = ici if name == "chip" else dcn
            tiers[name] = {
                "fan_in": fan,
                "wire_bytes_per_round": wire,
                "assumed_gb_per_sec": gbps,
                "modeled_ms_per_round": round(
                    wire / (gbps * 1e9) * 1e3, 4
                ),
            }
            if dtype != "fp32":
                tiers[name]["wire_dtype"] = dtype
    return tiers


def _serve_terms(cand: dict, spec: dict, calib: dict) -> dict:
    """Predicted serve p99 decomposed the way the telemetry decomposes
    measured p99 (queue wait + compute), from the calibrated terms:
    admit/fill wait from the batching mode, kernel ms FLOP-scaled from
    the record's wirespeed shape, and a warm-path dispatch overhead of one
    hundredth of the warm first-serve time."""
    terms = calib.get("terms", {})
    qps_per_replica = spec["qps"] / cand["replicas"]
    rows_batch = cand["serve_bucket_size"] * spec["rows_per_query"]
    if cand["serve_continuous"]:
        admit = terms.get("serve_admit_p99_ms")
        wait_ms = float(admit["value"]) if admit else 0.1
    else:
        # deadline batching: wait for the bucket to fill, capped by the
        # flush deadline — at low per-replica qps the deadline IS the
        # p99 wait, which is what the serve smoke record measures
        fill_ms = (
            1e3 * (cand["serve_bucket_size"] - 1) / qps_per_replica
            if qps_per_replica > 0 else float("inf")
        )
        wait_ms = min(cand["serve_flush_s"] * 1e3, fill_ms)
    kern = terms.get("serve_kernel_ms")
    if kern:
        rows0, d0, k0 = kern["at_rows_dk"]
        compute_ms = float(kern["value"]) * (
            (rows_batch * spec["d"] * spec["k"]) / (rows0 * d0 * k0)
        )
    else:
        compute_ms = 0.5
    overhead = terms.get("warm_first_serve_ms")
    # warm-path dispatch overhead amortizes over the bucket; the cold
    # first-serve compile is a one-off the plan does not budget per query
    overhead_ms = (
        float(overhead["value"]) / 100.0 if overhead else 0.5
    )
    p99 = round(wait_ms + compute_ms + overhead_ms, 3)
    util = (
        compute_ms * qps_per_replica
        / max(cand["serve_bucket_size"], 1) / 1e3
    )
    return {
        "queue_wait_p99_ms": round(wait_ms, 3),
        "batch_compute_ms": round(compute_ms, 3),
        "dispatch_overhead_ms": round(overhead_ms, 3),
        "predicted_p99_ms": p99,
        "replica_utilization": round(util, 4),
        "qps_per_replica": round(qps_per_replica, 1),
    }


def price_candidate(cand: dict, spec: dict, calib: dict) -> dict:
    """One candidate's predicted budgets + scalar cost. The score is
    explicit in the artifact: amortized fit wire ms per step (merge
    every ``merge_interval`` steps, divided by the measured schedule
    speedup) + 0.01 x predicted serve p99 + 0.1 x replicas (capacity
    is not free)."""
    tiers = _fit_tiers(cand, spec)
    round_ms = sum(t["modeled_ms_per_round"] for t in tiers.values())
    fit_ms_per_step = round(
        round_ms / cand["merge_interval"] / cand["schedule_speedup"], 4
    )
    serve = _serve_terms(cand, spec, calib)
    score = round(
        fit_ms_per_step
        + 0.01 * serve["predicted_p99_ms"]
        + 0.1 * cand["replicas"],
        4,
    )
    return {
        "fit_tiers": tiers,
        "fit_round_ms": round(round_ms, 4),
        "fit_ms_per_step": fit_ms_per_step,
        "serve": serve,
        "score": score,
    }


def _reject_reason(priced: dict, spec: dict) -> str | None:
    """Why a priced candidate is infeasible, or None. The same checks
    :func:`self_check` re-applies to an emitted plan."""
    for name, tier in priced["fit_tiers"].items():
        if tier["modeled_ms_per_round"] > spec["round_deadline_ms"]:
            return f"tier_over_deadline:{name}"
    if priced["serve"]["predicted_p99_ms"] > spec["slo_p99_ms"]:
        return "p99_over_slo"
    if priced["serve"]["replica_utilization"] >= 1.0:
        return "replica_saturated"
    return None


# -- the plan -----------------------------------------------------------------


def make_plan(
    spec: dict | None = None, calibration: dict | None = None
) -> dict:
    """Enumerate, price, choose; emit the auditable artifact. Raises
    :class:`PlanInfeasible` (with the rejection histogram) when no
    candidate survives, and re-runs :func:`self_check` on the result
    so an emitted plan can never fail its own audit."""
    spec = validate_workload(spec or DEFAULT_WORKLOAD)
    calib = calibration if calibration is not None else load_calibration()
    if spec["m"] % spec["fleet"] != 0:
        raise PlanInfeasible(
            f"no topology divides the mesh: m={spec['m']} workers do "
            f"not pack onto fleet={spec['fleet']} hosts (m % fleet != "
            "0) — declare a fleet that divides the worker mesh"
        )
    candidates = enumerate_candidates(spec, calib)
    rejected: dict[str, int] = {}
    best = None
    for cand in candidates:
        priced = price_candidate(cand, spec, calib)
        reason = _reject_reason(priced, spec)
        if reason is not None:
            rejected[reason] = rejected.get(reason, 0) + 1
            continue
        key = (
            priced["score"],
            # deterministic tie-break: prefer fewer replicas, smaller
            # buckets, then the spelled-out config
            cand["replicas"],
            cand["serve_bucket_size"],
            json.dumps(cand, sort_keys=True, default=list),
        )
        if best is None or key < best[0]:
            best = (key, cand, priced)
    if best is None:
        raise PlanInfeasible(
            f"workload {spec['name']!r} admits no feasible candidate "
            f"out of {len(candidates)}: rejections "
            f"{json.dumps(dict(sorted(rejected.items())))} — relax the "
            f"SLO ({spec['slo_p99_ms']} ms), the round deadline "
            f"({spec['round_deadline_ms']} ms), or grow the fleet"
        )
    _, cand, priced = best
    overrides = {
        "merge_topology": (
            [list(t) for t in cand["merge_topology"]]
            if cand["merge_topology"] else None
        ),
        "merge_wire_dtype": cand["merge_wire_dtype"],
        "pipeline_merge": cand["pipeline_merge"],
        "merge_interval": cand["merge_interval"],
        "serve_bucket_size": cand["serve_bucket_size"],
        "serve_flush_s": cand["serve_flush_s"],
        "serve_continuous": cand["serve_continuous"],
        "replicas": cand["replicas"],
    }
    plan = {
        "schema": PLAN_SCHEMA,
        "workload": spec,
        "calibration": calib,
        "candidates_considered": len(candidates),
        "rejected": dict(sorted(rejected.items())),
        "chosen": {
            "config_overrides": overrides,
            "predicted": priced,
        },
        "objective": (
            "min fit_ms_per_step + 0.01*predicted_p99_ms + "
            "0.1*replicas over feasible candidates (tier ms <= "
            "round_deadline_ms, p99 <= slo_p99_ms, utilization < 1)"
        ),
        "drift_anchors": _drift_anchors(calib),
    }
    plan["plan_id"] = "plan-" + hashlib.sha256(
        json.dumps(
            {"workload": spec, "chosen": plan["chosen"]},
            sort_keys=True,
        ).encode()
    ).hexdigest()[:12]
    viols = self_check(plan)
    if viols:
        raise PlanInfeasible(
            "emitted plan failed its own self-check: "
            + "; ".join(v.format() for v in viols)
        )
    return plan


def _drift_anchors(calib: dict) -> dict:
    """The plan's model-anchored predictions AT THE RECORD SHAPES —
    ratio 1.0 against the records the calibration read, by
    construction. :func:`drift_check` later compares these stored
    values against the records CURRENT at check time: re-recording a
    term 2x slower (or changing the model) moves the ratio, and the gate
    warns/fails — the model-vs-measured drift gate."""
    anchors = {}
    for name in (
        "serve_admit_p99_ms", "serve_kernel_ms",
        "serve_deadline_p99_ms", "warm_first_serve_ms",
    ):
        term = calib.get("terms", {}).get(name)
        if term is not None and term.get("value") is not None:
            anchors[name] = {
                "predicted": term["value"], "source": term["source"],
            }
    return anchors


def self_check(plan: dict) -> list:
    """The planner's own audit, applied to any ``plan-v1`` dict (ours
    or a hand-edited one): predicted tier budgets within the declared
    round deadline, predicted p99 within the declared SLO, overrides
    buildable as a PCAConfig. Every breach is one ``plan-infeasible``
    violation — the rule the seeded ``plan_infeasible_accepted``
    mutation must see caught."""
    from distributed_eigenspaces_tpu_torch.analysis.contracts import Violation

    viols: list = []

    def refuse(message: str, location: str = "") -> None:
        viols.append(Violation(
            program="planner", rule="plan-infeasible",
            message=message, location=location,
        ))

    if plan.get("schema") != PLAN_SCHEMA:
        refuse(
            f"unknown plan schema {plan.get('schema')!r} (expected "
            f"{PLAN_SCHEMA!r})"
        )
        return viols
    spec = plan.get("workload", {})
    chosen = plan.get("chosen", {})
    predicted = chosen.get("predicted", {})
    deadline = spec.get("round_deadline_ms")
    for name, tier in (predicted.get("fit_tiers") or {}).items():
        ms = tier.get("modeled_ms_per_round")
        if deadline is not None and ms is not None and ms > deadline:
            refuse(
                f"predicted {name}-tier budget {ms} ms/round exceeds "
                f"the declared round deadline {deadline} ms — the "
                "plan accepts a merge that cannot close its rounds",
                location=f"chosen.predicted.fit_tiers.{name}",
            )
    p99 = (predicted.get("serve") or {}).get("predicted_p99_ms")
    slo = spec.get("slo_p99_ms")
    if p99 is not None and slo is not None and p99 > slo:
        refuse(
            f"predicted serve p99 {p99} ms exceeds the declared SLO "
            f"{slo} ms — the plan accepts a config that burns its "
            "error budget by construction",
            location="chosen.predicted.serve.predicted_p99_ms",
        )
    overrides = chosen.get("config_overrides")
    if overrides is not None:
        from distributed_eigenspaces_tpu_torch.config import PCAConfig

        try:
            kw = dict(overrides)
            topo = kw.get("merge_topology")
            if topo is not None:
                kw["merge_topology"] = tuple(
                    tuple(t) for t in topo
                )
            PCAConfig(
                dim=spec.get("d", 8), k=spec.get("k", 2),
                num_workers=spec.get("m", 1),
                rows_per_worker=spec.get("n", 1), **kw,
            )
        except (TypeError, ValueError) as e:
            refuse(
                f"chosen config overrides do not build a valid "
                f"PCAConfig: {e}",
                location="chosen.config_overrides",
            )
    return viols


# -- CI gates: artifact diff + model-vs-measured drift ------------------------


def check_plan(current: dict, committed: dict | None) -> list:
    """Diff-gate, exactly like :func:`.costmodel.check_snapshot`:
    regenerated plan vs the committed artifact, every mismatch one
    ``plan-drift`` violation naming the field and both values.
    Intentional changes re-commit via ``scripts/torch_analyze.py
    --plan --write-plan``."""
    from distributed_eigenspaces_tpu_torch.analysis.contracts import Violation

    viols: list = []

    def drift(message: str, location: str = "") -> None:
        viols.append(Violation(
            program="plan-snapshot", rule="plan-drift",
            message=message, location=location,
        ))

    if committed is None:
        drift(
            f"no committed {PLAN_NAME} found — generate it with "
            "scripts/torch_analyze.py --plan --write-plan and commit the "
            "file"
        )
        return viols
    for key in (
        "schema", "workload", "calibration", "candidates_considered",
        "rejected", "chosen", "objective", "drift_anchors", "plan_id",
    ):
        if current.get(key) != committed.get(key):
            drift(
                f"{key} drifted: committed {committed.get(key)!r} != "
                f"regenerated {current.get(key)!r}",
                location=key,
            )
    return viols


def drift_check(
    plan: dict | None = None, root: str | None = None
) -> list[dict]:
    """Model-vs-measured: the plan's stored drift anchors against the
    card's record as it is now (``root``'s :data:`CALIBRATION_RECORD`). One row per anchor with the ratio
    (symmetric, max(pred/meas, meas/pred)) and a status: ``ok`` below
    :data:`DRIFT_WARN_RATIO` x, ``warn`` below
    :data:`DRIFT_FAIL_RATIO` x, ``fail`` at or above — the thresholds
    CI applies. A missing record or anchor is a loud ``missing``
    row, not a silent pass."""
    plan = plan or load_plan()
    if plan is None:
        return [{
            "anchor": PLAN_NAME, "status": "missing",
            "detail": "no committed plan artifact to check",
        }]
    calib_now = load_calibration(root)
    rows = []
    for name, anchor in (plan.get("drift_anchors") or {}).items():
        pred = anchor.get("predicted")
        term = calib_now.get("terms", {}).get(name)
        meas = term.get("value") if term else None
        if pred is None or meas is None:
            rows.append({
                "anchor": name, "status": "missing",
                "predicted": pred, "measured": meas,
                "detail": anchor.get("source", ""),
            })
            continue
        pred_f, meas_f = float(pred), float(meas)
        if pred_f <= 0 or meas_f <= 0:
            ratio = float("inf") if pred_f != meas_f else 1.0
        else:
            ratio = max(pred_f / meas_f, meas_f / pred_f)
        status = (
            "ok" if ratio < DRIFT_WARN_RATIO
            else "warn" if ratio < DRIFT_FAIL_RATIO
            else "fail"
        )
        rows.append({
            "anchor": name, "status": status,
            "predicted": pred, "measured": meas,
            "ratio": round(ratio, 3),
            "source": anchor.get("source", ""),
        })
    return rows
