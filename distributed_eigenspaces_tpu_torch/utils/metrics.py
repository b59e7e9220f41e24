"""Structured metrics: ``MetricsLogger`` and ``log_line``.

The port's copy of ``distributed_eigenspaces_tpu/utils/metrics.py``. Per-step
records (throughput, step latency, the principal angle against a reference
subspace), the fault ledger of a supervised fit, and the event sections of
the serving, fleet, membership, merge, replication, population, solver and
controller layers, each folded into ``summary()``:

- every event list is a bounded :class:`~.telemetry.RingLog`: evicted
  entries fold into running aggregates (counters and mergeable log-bucket
  :class:`~.telemetry.Histogram` s), so a long-lived server never grows
  without limit and ``summary()`` stays correct after eviction;
- every event carries both clocks: ``t_mono`` (``time.perf_counter``,
  orders and subtracts correctly) and ``t_unix`` (``time.time``,
  correlates across processes);
- ``summary()["serving"]`` decomposes request latency into queue_wait /
  compile_stall / compute / other per percentile, and ``summary()["slo"]``
  reports rolling-window attainment and error-budget burn against declared
  p99 targets (``cfg.serve_slo_p99_ms`` / ``cfg.fleet_slo_p99_ms``);
- an attached :class:`~.telemetry.Tracer` (:meth:`MetricsLogger.
  attach_tracer`) receives per-step spans, so the exported Chrome trace
  covers fit, serve, fleet, drift and fault events together;
- an attached analysis verdict (:meth:`MetricsLogger.attach_analysis`,
  ``analysis.report.engine_report``) rides in ``summary()["analysis"]``.
"""
from __future__ import annotations

import json
import sys
import time
from typing import IO

import numpy as np

from distributed_eigenspaces_tpu_torch.utils.telemetry import (
    Histogram,
    RingLog,
    slo_summary,
    tracer_of,
)

#: default ring-buffer retention per event list (overridable per logger
#: and via ``PCAConfig.metrics_retention``)
DEFAULT_RETENTION = 4096

#: decomposition component keys, in report order: per-request latency =
#: queue_wait + compile_stall + compute + other (pre/post dispatch
#: overhead), all in seconds
DECOMP_KEYS = ("queue_wait_s", "compile_stall_s", "compute_s", "other_s")


def _host_tensor(v):
    """``v`` (a tensor on any device, or an array) as a CPU tensor."""
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.as_tensor(np.asarray(v))


def _stamp(rec: dict) -> dict:
    """Both clocks on every event: ``t_mono`` for
    ordering/durations, ``t_unix`` for cross-process correlation.
    ``t`` stays the monotonic stamp for existing consumers."""
    now_mono = time.perf_counter()
    rec.setdefault("t_mono", now_mono)
    rec.setdefault("t_unix", time.time())
    rec.setdefault("t", rec["t_mono"])
    return rec


class MetricsLogger:
    """Collects per-step metrics; optionally streams them as JSON lines.

    Use as an ``on_step`` callback factory::

        metrics = MetricsLogger(samples_per_step=m * n)
        online_distributed_pca(stream, cfg, on_step=metrics.on_step)
        print(metrics.summary())
    """

    def __init__(
        self,
        *,
        samples_per_step: int = 0,
        stream: IO | None = None,
        reference_subspace=None,
        retention: int = DEFAULT_RETENTION,
        slo_p99_ms: float | None = None,
        fleet_slo_p99_ms: float | None = None,
        tracer=None,
    ):
        self.samples_per_step = samples_per_step
        self.stream = stream
        self.reference_subspace = reference_subspace
        self.retention = retention
        #: declared serving SLO target (p99 request latency, ms) —
        #: ``summary()["slo"]["serve"]`` reports attainment against it
        self.slo_p99_ms = slo_p99_ms
        #: the fleet equivalent (p99 fit-request latency, ms)
        self.fleet_slo_p99_ms = fleet_slo_p99_ms
        #: optional ``telemetry.Tracer`` — per-step spans and compile
        #: events land on its exported timeline (:meth:`attach_tracer`)
        self.tracer = tracer
        #: per-step records (ring buffer; evictions fold into running
        #: throughput aggregates so the summary survives long runs)
        self.records = RingLog(retention, self._evict_step)
        #: structured fault events (runtime/supervisor.py): quarantined
        #: workers, retried pulls/steps, resumes — the run's fault
        #: ledger, surfaced by :meth:`summary`
        self.fault_records = RingLog(retention, self._evict_fault)
        #: ingest-pipeline counters (runtime/prefetch.py PrefetchStats),
        #: attached via :meth:`attach_ingest` — surfaced by
        #: :meth:`summary` under "ingest"
        self.ingest_stats = None
        #: query-serving events (serving/server.py QueryServer batches,
        #: serving/drift.py DriftMonitor refreshes) — surfaced by
        #: :meth:`summary` under "serving"
        self.serve_records = RingLog(retention, self._evict_serve)
        #: fleet-serving events (parallel/fleet.py FleetServer bucket
        #: dispatches) — surfaced by :meth:`summary` under "fleet"
        self.fleet_records = RingLog(retention, self._evict_fleet)
        #: elastic-membership events (runtime/membership.py
        #: MembershipTable / ElasticStream): joins, leaves,
        #: suspect→dead transitions, deadline-closed rounds — surfaced
        #: by :meth:`summary` under "membership"
        self.membership_records = RingLog(
            retention, self._evict_membership
        )
        #: live membership table (attach_membership) — its snapshot
        #: (states, generations, quorum) rides the summary
        self.membership_table = None
        #: hierarchical-merge events (runtime/tiers.py TieredStream /
        #: TierSet): per-tier round closes, stale folds, tier quorum
        #: transitions — surfaced by :meth:`summary` under "merge"
        self.merge_records = RingLog(retention, self._evict_merge)
        #: registry-replication events (serving/replication.py
        #: ReplicaRegistry installs / staleness breaches / fenced
        #: zombie commits, PublisherLease failovers) — surfaced by
        #: :meth:`summary` under "replication"
        self.replication_records = RingLog(
            retention, self._evict_replication
        )
        #: population-ingest events (runtime/population.py
        #: PopulationIngest): cohort round closes, client quarantines
        #: by reason, participation collapses/restores, trimmed-merge
        #: stats — surfaced by :meth:`summary` under "population"
        self.population_records = RingLog(
            retention, self._evict_population
        )
        #: eigensolver convergence events (solvers/ deflation lanes and
        #: gap-adaptive subspace stops): per-solve
        #: ``iters_used`` / residuals, per-lane — surfaced by
        #: :meth:`summary` under "solver"
        self.solver_records = RingLog(retention, self._evict_solver)
        #: control-plane decisions (runtime/controller.py Controller):
        #: every autoscaler action / rollback / freeze with
        #: the lineage ``{trigger, knob, from, to, plan_id}`` and the
        #: telemetry evidence that triggered it — surfaced by
        #: :meth:`summary` under "controller"
        self.controller_records = RingLog(
            retention, self._evict_controller
        )
        #: compile-lifecycle counters (utils/compile_cache.py
        #: CompileCache), attached via :meth:`attach_compile` —
        #: surfaced by :meth:`summary` under "compile"
        self.compile_cache = None
        #: live read-path health sources (serving/server.py
        #: ``QueryServer.health``), attached via
        #: :meth:`attach_serve_health` — merged into
        #: ``summary()["serving"]["health"]``
        self.serve_health_sources: list = []
        #: static-analysis verdict (analysis/report.py) — a report
        #: dict or a zero-arg callable producing one, attached via
        #: :meth:`attach_analysis`; surfaced by :meth:`summary`
        #: under "analysis"
        self.analysis_report = None
        self._last_time = None
        self._fit_trace = None
        # evicted-entry aggregates: what the ring buffers folded away
        self._step_agg = {
            "steps": 0, "sps_sum": 0.0, "sps_n": 0, "sps_max": None,
        }
        self._fault_agg: dict = {"count": 0, "by_kind": {}}
        self._serve_agg = self._fresh_dispatch_agg()
        self._serve_agg["drifts"] = 0
        # read-path health eviction aggregates: sheds by
        # reason, lane restart/death counts, breaker transitions — so
        # summary()["serving"]["health"] covers the whole run even
        # after ring-buffer eviction
        self._serve_agg["sheds_by_reason"] = {}
        self._serve_agg["lane_restarts"] = 0
        self._serve_agg["lane_deaths"] = 0
        self._serve_agg["breaker_trips"] = 0
        self._fleet_agg = self._fresh_dispatch_agg()
        # elastic-membership eviction aggregates: event
        # counts by kind, round outcomes (deadline closes, stale
        # folds), and the per-round arrival histogram — so
        # summary()["membership"] covers the whole run after eviction
        self._membership_agg = {
            "count": 0, "by_kind": {}, "rounds": 0,
            "deadline_closed": 0, "stale_folds": 0,
            "arrival_hist": {},
        }
        # hierarchical-merge eviction aggregates: event
        # counts by kind plus PER-TIER round outcomes (fan-in,
        # deadline closes, stale folds, arrival histogram) — so
        # summary()["merge"] covers the whole run after eviction
        self._merge_agg: dict = {
            "count": 0, "by_kind": {}, "tiers": {}, "wire": {},
        }
        # registry-replication eviction aggregates: event
        # counts by kind, install/staleness/fencing/failover counters,
        # failover recovery times, and the mergeable propagation-lag
        # histogram — so summary()["replication"] (propagation p99,
        # failover count + recovery_ms) covers the whole run after
        # ring-buffer eviction
        self._replication_agg: dict = {
            "count": 0, "by_kind": {}, "installs": 0, "stale": 0,
            "fenced": 0, "failovers": 0, "recovery_ms": [],
            "lag_hist": Histogram(),
        }
        # population-ingest eviction aggregates: event
        # counts by kind, cohort-round outcomes (participation decile
        # histogram, one-step-stale folds), quarantines by rejection
        # reason, and the running trim-fraction mean — so
        # summary()["population"] covers the whole run after eviction
        self._population_agg: dict = {
            "count": 0, "by_kind": {}, "rounds": 0, "stale_folds": 0,
            "participation_hist": {}, "rejects_by_reason": {},
            "trim_frac_sum": 0.0, "trim_frac_n": 0,
        }
        # solver-convergence eviction aggregates: solve
        # counts by kind plus PER-LANE iteration totals (sum/max,
        # early-stop count) — so summary()["solver"] covers the whole
        # run after ring-buffer eviction
        self._solver_agg: dict = {
            "count": 0, "by_kind": {}, "by_lane": {},
        }
        # control-plane eviction aggregates: decision counts
        # by kind plus per-knob action/rollback counters — so
        # summary()["controller"] covers the whole run after eviction
        self._controller_agg: dict = {
            "count": 0, "by_kind": {}, "by_knob": {}, "rollbacks": 0,
        }

    @staticmethod
    def _fresh_dispatch_agg() -> dict:
        """Eviction aggregate shared by the serving and fleet sections:
        counters plus mergeable latency histograms (total + the
        decomposition components), so percentiles survive eviction."""
        return {
            "events": 0, "requests": 0, "rejected": 0, "swaps": 0,
            "occ_sum": 0.0, "occ_n": 0,
            # batch-occupancy waste ledger: padded rows per
            # signature bucket, mean fill fraction, and the
            # admit-to-dispatch wait histogram the continuous-batching
            # claim is judged by
            "padded_rows": 0, "padded_by_sig": {},
            # heterogeneous-k bucketing waste: eigenvector
            # lanes fitted only because a tenant's k was padded up to
            # the shared bucket width, attributed by signature
            "padded_lanes": 0, "padded_lanes_by_sig": {},
            "fill_sum": 0.0, "fill_n": 0,
            "compile_misses": 0, "compile_stall_ms": 0.0,
            "by_sig": {}, "t_min": None, "t_max": None,
            "versions": set(),
            "slo_requests": 0, "slo_violations": 0,
            "hist": {
                "total_s": Histogram(),
                "admit_to_dispatch_s": Histogram(),
                **{k: Histogram() for k in DECOMP_KEYS},
            },
        }

    def start(self) -> "MetricsLogger":
        self._last_time = time.perf_counter()
        return self

    def on_step(self, t: int, state, v_bar=None) -> None:
        now = time.perf_counter()
        rec: dict = {"step": int(t)}
        if self._last_time is not None:
            dt = now - self._last_time
            rec["step_seconds"] = round(dt, 6)
            if self.samples_per_step:
                rec["samples_per_sec"] = round(self.samples_per_step / dt, 1)
            tr = tracer_of(self)
            if self._fit_trace is None:
                self._fit_trace = tr.new_trace("fit")
            tr.record_span(
                "pca_step", self._last_time, now,
                trace_id=self._fit_trace, category="fit",
                attrs={"step": int(t)},
            )
        if self.reference_subspace is not None and v_bar is not None:
            from distributed_eigenspaces_tpu_torch.ops.linalg import (
                principal_angles_degrees,
            )

            # both on the host in float64 (the port's angle function
            # re-orthonormalizes there): one device read a step
            rec["principal_angle_deg"] = round(
                float(
                    principal_angles_degrees(
                        _host_tensor(v_bar),
                        _host_tensor(self.reference_subspace),
                    ).max()
                ),
                4,
            )
        self._last_time = now
        _stamp(rec)
        self.records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def attach_ingest(self, stats) -> "MetricsLogger":
        """Attach a live ``runtime.prefetch.PrefetchStats`` — its final
        counters land in ``summary()["ingest"]``, so ingest-bound vs
        compute-bound runs are diagnosable from the run report (the
        counters keep mutating as the stream runs; summary reads the
        state at call time)."""
        self.ingest_stats = stats
        return self

    def attach_compile(self, cache) -> "MetricsLogger":
        """Attach a live ``utils.compile_cache.CompileCache``: its hit, miss
        and build-ms counters land in ``summary()["compile"]`` (read at
        summary time, like the ingest stats). An attached tracer is handed
        to the cache, so its hits and builds land on the exported timeline
        too."""
        self.compile_cache = cache
        if self.tracer is not None and getattr(cache, "tracer", None) is None:
            cache.tracer = self.tracer
        return self

    def attach_analysis(self, report) -> "MetricsLogger":
        """Attach a contract verdict (``analysis.report.engine_report``'s
        dict, or a zero-arg callable producing one, evaluated at summary
        time so it sees every bucket the run acquired). Lands in
        ``summary()["analysis"]`` — the run report carries the contract
        verdict alongside its latency numbers."""
        self.analysis_report = report
        return self

    def attach_serve_health(self, source) -> "MetricsLogger":
        """Attach a live read-path health source (a zero-arg callable
        returning a dict — ``QueryServer.health``). Multiple servers
        may attach (one per served signature); ``summary()["serving"]
        ["health"]`` merges them: counters sum, breaker states union,
        and the event-ledger counts (sheds / lane restarts / breaker
        trips) cover the whole run via the ring-buffer aggregates."""
        self.serve_health_sources.append(source)
        return self

    def attach_tracer(self, tracer) -> "MetricsLogger":
        """Attach a ``telemetry.Tracer``: per-step spans, serving /
        fleet / drift / fault spans from the instrumented components,
        and compile-cache events all record into ONE exportable
        timeline (``tracer.export_chrome_trace``)."""
        self.tracer = tracer
        if (
            self.compile_cache is not None
            and getattr(self.compile_cache, "tracer", None) is None
        ):
            self.compile_cache.tracer = tracer
        return self

    def fleet(self, event: dict) -> None:
        """Record one structured fleet-serving event — a dispatched fit
        bucket (``kind="bucket"``: tenant count, occupancy, signature,
        and the per-signature ``compile_stall_ms`` the dispatch paid
        acquiring its programs). Rides the same JSON stream as step
        records, tagged ``"fleet"``."""
        rec = {"fleet": event.get("kind", "bucket"), **event}
        _stamp(rec)
        self.fleet_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def serve(self, event: dict) -> None:
        """Record one structured serving event — a dispatched query
        micro-batch (``kind="batch"``: query count, per-query
        latencies + queue waits, occupancy, basis version, swap flag)
        or a drift refresh (``kind="drift"``: score, angle gap,
        published version). Rides the same JSON stream as step
        records, tagged ``"serve"``."""
        rec = {"serve": event.get("kind", "batch"), **event}
        _stamp(rec)
        self.serve_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def attach_membership(self, table) -> "MetricsLogger":
        """Attach a live ``runtime.membership.MembershipTable`` — its
        snapshot (per-slot states, generations, quorum) lands in
        ``summary()["membership"]["table"]`` (read at summary time,
        like the ingest stats)."""
        self.membership_table = table
        return self

    def membership(self, event: dict) -> None:
        """Record one structured membership event (an elastic-fleet
        lifecycle action or a closed round — ``runtime/membership.py``).
        Rides the same JSON stream as step records, tagged
        ``"membership"``."""
        rec = {"membership": event.get("kind", "unknown"), **event}
        _stamp(rec)
        self.membership_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def merge(self, event: dict) -> None:
        """Record one structured hierarchical-merge event (a tier-local
        round close, stale fold, or tier quorum transition —
        ``runtime/tiers.py``). Rides the same JSON stream as step
        records, tagged ``"merge"``."""
        rec = {"merge": event.get("kind", "unknown"), **event}
        _stamp(rec)
        self.merge_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def replication(self, event: dict) -> None:
        """Record one structured registry-replication event (a replica
        install with its propagation ``lag_ms``, a staleness-bound
        breach, a fenced zombie commit, or a publisher-lease failover —
        ``serving/replication.py``). Rides the same JSON stream as step
        records, tagged ``"replication"``."""
        rec = {"replication": event.get("kind", "unknown"), **event}
        _stamp(rec)
        self.replication_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def population(self, event: dict) -> None:
        """Record one structured population-ingest event (a cohort
        round close, a client quarantine with id + reason, a
        participation collapse/restore, or a hardened-merge stat —
        ``runtime/population.py``). Rides the same JSON stream as step
        records, tagged ``"population"``."""
        rec = {"population": event.get("kind", "unknown"), **event}
        _stamp(rec)
        self.population_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def solver(self, event: dict) -> None:
        """Record one structured eigensolver-convergence event
        (``kind="deflation"``: per-lane ``iters_used`` / ``residual``
        vectors from a gap-adaptive deflation solve, plus the armed
        ``tol`` and ``max_iters``; ``kind="subspace"``: the scalar
        equivalents from :func:`~..solvers.dist_subspace_eig`). Rides
        the same JSON stream as step records, tagged ``"solver"``."""
        rec = {"solver": event.get("kind", "unknown"), **event}
        _stamp(rec)
        self.solver_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def controller(self, event: dict) -> None:
        """Record one structured control-plane decision
        (``runtime/controller.py``): an autoscaler ``action`` /
        ``rollback`` with the full lineage ``{trigger, knob, from, to,
        plan_id}`` and the triggering telemetry evidence, a
        ``budget_exhausted`` freeze, or a lifecycle ``start``/``stop``.
        Rides the same JSON stream as step records, tagged
        ``"controller"``."""
        rec = {"controller": event.get("kind", "unknown"), **event}
        _stamp(rec)
        self.controller_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    def fault(self, event: dict) -> None:
        """Record one structured fault event (a supervisor detection /
        recovery action). Events ride the same JSON stream as step
        records, tagged ``"fault"`` so consumers can split them."""
        rec = {"fault": event.get("kind", "unknown"), **event}
        _stamp(rec)
        self.fault_records.append(rec)
        if self.stream is not None:
            print(json.dumps(rec), file=self.stream, flush=True)

    # -- eviction folds ------------------------------------------------------

    def _evict_step(self, rec: dict) -> None:
        agg = self._step_agg
        agg["steps"] += 1
        sps = rec.get("samples_per_sec")
        if sps is not None:
            agg["sps_sum"] += sps
            agg["sps_n"] += 1
            agg["sps_max"] = (
                sps if agg["sps_max"] is None else max(agg["sps_max"], sps)
            )

    def _evict_fault(self, rec: dict) -> None:
        agg = self._fault_agg
        agg["count"] += 1
        kind = rec.get("fault", "unknown")
        agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1

    def _evict_membership(self, rec: dict) -> None:
        agg = self._membership_agg
        agg["count"] += 1
        kind = rec.get("membership", "unknown")
        agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1
        if kind == "round_closed":
            self._fold_membership_round(agg, rec)

    @staticmethod
    def _fold_membership_round(agg: dict, rec: dict) -> None:
        agg["rounds"] += 1
        if rec.get("deadline_closed"):
            agg["deadline_closed"] += 1
        agg["stale_folds"] += len(rec.get("stale") or ())
        arrived = rec.get("arrived")
        if arrived is not None:
            key = str(int(arrived))
            hist = agg["arrival_hist"]
            hist[key] = hist.get(key, 0) + 1

    def _evict_merge(self, rec: dict) -> None:
        agg = self._merge_agg
        agg["count"] += 1
        kind = rec.get("merge", "unknown")
        agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1
        if kind == "tier_round":
            self._fold_merge_tier(agg["tiers"], rec)
        elif kind == "wire":
            self._fold_merge_wire(agg["wire"], rec)

    @staticmethod
    def _fold_merge_wire(wire: dict, rec: dict) -> None:
        """One per-tier wire-compression record
        (``parallel/wire.tier_wire_records``) into the per-tier wire
        aggregate: cumulative payload bytes vs the fp32 program, the
        declared codec + its per-round compression ratio, and the
        error-feedback residual norm (last seen + running max) — the
        write-path twin of the serve dtype ledger."""
        tier = rec.get("tier", "unknown")
        t = wire.setdefault(tier, {
            "wire_dtype": rec.get("wire_dtype"), "rounds": 0,
            "payload_bytes": 0, "fp32_bytes": 0,
        })
        t["rounds"] += 1
        t["wire_dtype"] = rec.get("wire_dtype", t["wire_dtype"])
        t["payload_bytes"] += int(rec.get("payload_bytes") or 0)
        t["fp32_bytes"] += int(rec.get("fp32_bytes") or 0)
        if rec.get("compression_ratio") is not None:
            t["compression_ratio"] = rec["compression_ratio"]
        norm = rec.get("ef_residual_norm")
        if norm is not None:
            t["ef_residual_norm"] = float(norm)
            t["ef_residual_norm_max"] = max(
                float(norm), t.get("ef_residual_norm_max", 0.0)
            )

    @staticmethod
    def _fold_merge_tier(tiers: dict, rec: dict) -> None:
        """One tier-round record into the per-tier aggregate — the
        membership round fold, keyed by tier name (the tree shape is
        part of the ledger: fan-in rides every record)."""
        tier = rec.get("tier", "unknown")
        t = tiers.setdefault(tier, {
            "fan_in": rec.get("fan_in"), "rounds": 0,
            "deadline_closed": 0, "stale_folds": 0, "arrival_hist": {},
        })
        t["rounds"] += 1
        if rec.get("deadline_closed"):
            t["deadline_closed"] += 1
        t["stale_folds"] += len(rec.get("stale") or ())
        arrived = rec.get("arrived")
        if arrived is not None:
            key = str(int(arrived))
            t["arrival_hist"][key] = t["arrival_hist"].get(key, 0) + 1

    def _evict_population(self, rec: dict) -> None:
        agg = self._population_agg
        agg["count"] += 1
        kind = rec.get("population", "unknown")
        agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1
        self._fold_population(agg, rec)

    @staticmethod
    def _fold_population(agg: dict, rec: dict) -> None:
        """One population-ingest record into the aggregate: cohort
        rounds bucket participation into a decile histogram (the
        membership arrival-hist rule, normalized because cohorts are
        sampled, not slotted), quarantines tally by rejection reason,
        merge stats feed the running trim-fraction mean."""
        kind = rec.get("population", "unknown")
        if kind == "round_closed":
            agg["rounds"] += 1
            agg["stale_folds"] += int(rec.get("stale") or 0)
            p = rec.get("participation")
            if p is not None:
                key = f"{int(float(p) * 10) / 10:.1f}"
                hist = agg["participation_hist"]
                hist[key] = hist.get(key, 0) + 1
        elif kind == "quarantine_client":
            reason = rec.get("reason", "unknown")
            rej = agg["rejects_by_reason"]
            rej[reason] = rej.get(reason, 0) + 1
        elif kind == "merge":
            tf = rec.get("trim_frac")
            if tf is not None:
                agg["trim_frac_sum"] += float(tf)
                agg["trim_frac_n"] += 1

    def _evict_solver(self, rec: dict) -> None:
        agg = self._solver_agg
        agg["count"] += 1
        kind = rec.get("solver", "unknown")
        agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1
        self._fold_solver(agg, rec)

    @staticmethod
    def _fold_solver(agg: dict, rec: dict) -> None:
        """One solver-convergence record into the aggregate: per-lane
        iteration totals (sum / max / solve count) plus how often the
        lane stopped EARLY (``iters_used < max_iters`` — the
        gap-adaptive win the counters exist to show). Scalar
        ``iters_used`` folds as a single lane 0."""
        used = rec.get("iters_used")
        if used is None:
            return
        if not isinstance(used, (list, tuple)):
            used = [used]
        max_iters = rec.get("max_iters")
        by_lane = agg["by_lane"]
        for lane, n in enumerate(used):
            st = by_lane.setdefault(
                lane,
                {"solves": 0, "iters_sum": 0, "iters_max": 0,
                 "early_stops": 0},
            )
            n = int(n)
            st["solves"] += 1
            st["iters_sum"] += n
            st["iters_max"] = max(st["iters_max"], n)
            if max_iters is not None and n < int(max_iters):
                st["early_stops"] += 1

    def _evict_controller(self, rec: dict) -> None:
        agg = self._controller_agg
        agg["count"] += 1
        kind = rec.get("controller", "unknown")
        agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1
        self._fold_controller(agg, rec)

    @staticmethod
    def _fold_controller(agg: dict, rec: dict) -> None:
        """One control-plane decision into the aggregate: per-knob
        action counts plus the rollback total — the numbers the
        A/B gates read even after the decision records themselves
        evicted."""
        kind = rec.get("controller")
        if kind in ("action", "rollback"):
            knob = rec.get("knob", "unknown")
            agg["by_knob"][knob] = agg["by_knob"].get(knob, 0) + 1
        if kind == "rollback":
            agg["rollbacks"] += 1

    def _controller_summary(self) -> dict:
        """The ``summary()["controller"]`` section: every
        retained control-plane decision verbatim — lineage ``{trigger,
        knob, from, to, plan_id}`` plus the telemetry evidence that
        triggered it — with counts by kind / by knob and the rollback
        total covering the whole run (evictions folded)."""
        agg = {
            "count": self._controller_agg["count"],
            "by_kind": dict(self._controller_agg["by_kind"]),
            "by_knob": dict(self._controller_agg["by_knob"]),
            "rollbacks": self._controller_agg["rollbacks"],
        }
        for r in self.controller_records:
            agg["count"] += 1
            kind = r.get("controller", "unknown")
            agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1
            self._fold_controller(agg, r)
        out: dict = {
            "decisions": agg["count"],
            "by_kind": agg["by_kind"],
            "rollbacks": agg["rollbacks"],
            # the events list holds the RETAINED window; evicted
            # decisions survive in the counters above
            "events": list(self.controller_records),
        }
        if agg["by_knob"]:
            out["by_knob"] = agg["by_knob"]
        if self.controller_records.evicted:
            out["events_evicted"] = self.controller_records.evicted
        return out

    def _solver_summary(self) -> dict:
        """Per-lane convergence counters: for each deflation
        lane, solve count, mean/max iterations, and the early-stop
        count the gap-adaptive criterion earned — live window + evicted
        aggregate."""
        agg = {
            "count": self._solver_agg["count"],
            "by_kind": dict(self._solver_agg["by_kind"]),
            "by_lane": {
                lane: dict(st)
                for lane, st in self._solver_agg["by_lane"].items()
            },
        }
        for r in self.solver_records:
            agg["count"] += 1
            kind = r.get("solver", "unknown")
            agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1
            self._fold_solver(agg, r)
        out: dict = {
            "solves": agg["count"], "by_kind": agg["by_kind"],
        }
        lanes = {}
        for lane in sorted(agg["by_lane"]):
            st = agg["by_lane"][lane]
            lanes[str(lane)] = {
                "solves": st["solves"],
                "mean_iters": round(st["iters_sum"] / st["solves"], 2),
                "max_iters": st["iters_max"],
                "early_stops": st["early_stops"],
            }
        if lanes:
            out["by_lane"] = lanes
        return out

    def _evict_replication(self, rec: dict) -> None:
        agg = self._replication_agg
        agg["count"] += 1
        self._fold_replication(agg, rec)
        if rec.get("replication") == "install":
            lag = rec.get("lag_ms")
            if lag is not None:
                # histograms carry seconds everywhere else; keep the
                # unit and convert back at report time
                agg["lag_hist"].record(max(float(lag), 1e-3) / 1e3)

    @staticmethod
    def _fold_replication(agg: dict, rec: dict) -> None:
        """One replication event into the counter aggregate — shared by
        eviction and the live-window pass in the summary."""
        kind = rec.get("replication", "unknown")
        agg["by_kind"][kind] = agg["by_kind"].get(kind, 0) + 1
        if kind == "install":
            agg["installs"] += 1
        elif kind == "stale":
            agg["stale"] += 1
        elif kind == "fenced":
            agg["fenced"] += 1
        elif kind == "failover":
            agg["failovers"] += 1
            if rec.get("recovery_ms") is not None:
                agg["recovery_ms"].append(
                    round(float(rec["recovery_ms"]), 3)
                )

    def _evict_serve(self, rec: dict) -> None:
        if rec.get("serve") == "drift":
            self._serve_agg["drifts"] += 1
            return
        if rec.get("serve") == "shed":
            reason = rec.get("reason", "overload")
            by = self._serve_agg["sheds_by_reason"]
            by[reason] = by.get(reason, 0) + rec.get("dropped", 1)
            return
        if rec.get("serve") == "lane":
            if rec.get("event") == "restart":
                self._serve_agg["lane_restarts"] += 1
            elif rec.get("event") == "dead":
                self._serve_agg["lane_deaths"] += 1
            return
        if rec.get("serve") == "breaker":
            if rec.get("event") == "open":
                self._serve_agg["breaker_trips"] += 1
            return
        if rec.get("serve") == "batch":
            self._fold_dispatch(
                self._serve_agg, rec, "queries", self.slo_p99_ms
            )

    def _evict_fleet(self, rec: dict) -> None:
        if rec.get("fleet") == "bucket":
            self._fold_dispatch(
                self._fleet_agg, rec, "tenants", self.fleet_slo_p99_ms
            )

    def _fold_dispatch(self, agg: dict, rec: dict, req_key: str,
                       slo_ms: float | None) -> None:
        """One evicted serve batch / fleet bucket into the running
        aggregate — the counters :meth:`summary` adds back, and the
        histograms its percentiles/decomposition merge with the live
        window."""
        agg["events"] += 1
        agg["requests"] += rec.get(req_key, 0)
        agg["rejected"] += rec.get("rejected", 0)
        if rec.get("swap"):
            agg["swaps"] += 1
        if "occupancy" in rec:
            agg["occ_sum"] += rec["occupancy"]
            agg["occ_n"] += 1
        pad = rec.get("padded_rows", 0)
        agg["padded_rows"] += pad
        if pad and "signature" in rec:
            sig = str(tuple(rec["signature"]))
            agg["padded_by_sig"][sig] = (
                agg["padded_by_sig"].get(sig, 0) + pad
            )
        lpad = rec.get("padded_lanes", 0)
        agg["padded_lanes"] += lpad
        if lpad and "signature" in rec:
            sig = str(tuple(rec["signature"]))
            agg["padded_lanes_by_sig"][sig] = (
                agg["padded_lanes_by_sig"].get(sig, 0) + lpad
            )
        ff = rec.get("fill_fraction")
        if ff is not None:
            agg["fill_sum"] += float(ff)
            agg["fill_n"] += 1
        for a in rec.get("admit_to_dispatch_s") or ():
            if a is not None:
                agg["hist"]["admit_to_dispatch_s"].record(
                    max(float(a), 1e-6)
                )
        agg["compile_misses"] += rec.get("compile_misses", 0)
        stall = rec.get("compile_stall_ms", 0.0)
        agg["compile_stall_ms"] += stall
        if stall and "signature" in rec:
            sig = str(tuple(rec["signature"]))
            agg["by_sig"][sig] = round(
                agg["by_sig"].get(sig, 0.0) + stall, 3
            )
        if "version" in rec:
            agg["versions"].add(rec["version"])
        t = rec.get("t_mono", rec.get("t"))
        if t is not None:
            agg["t_min"] = t if agg["t_min"] is None else min(agg["t_min"], t)
            agg["t_max"] = t if agg["t_max"] is None else max(agg["t_max"], t)
        for row in self._decomp_rows(rec):
            agg["hist"]["total_s"].record(row["total_s"])
            for k in DECOMP_KEYS:
                if row.get(k) is not None:
                    agg["hist"][k].record(row[k])
            if slo_ms is not None:
                agg["slo_requests"] += 1
                if row["total_s"] * 1e3 > slo_ms:
                    agg["slo_violations"] += 1

    # -- decomposition -------------------------------------------------------

    @staticmethod
    def _decomp_rows(rec: dict) -> list[dict]:
        """Per-request latency rows for one dispatch event. Every row
        has ``total_s``; the component keys are present when the event
        carried the decomposition fields (``queue_wait_s`` list +
        ``compute_s``), and then satisfy
        ``total = queue_wait + compile_stall + compute + other``
        exactly — the batch's compile stall and compute are shared by
        every request that rode it (each waited through both)."""
        lats = rec.get("query_latency_s") or rec.get("request_latency_s")
        if not lats:
            return []
        qws = rec.get("queue_wait_s")
        stall_s = (rec.get("compile_stall_ms") or 0.0) / 1e3
        compute = rec.get("compute_s")
        rows = []
        for i, lat in enumerate(lats):
            if lat is None:
                continue
            row: dict = {"total_s": float(lat)}
            qw = qws[i] if qws is not None and i < len(qws) else None
            if qw is not None and compute is not None:
                row["queue_wait_s"] = float(qw)
                row["compile_stall_s"] = stall_s
                row["compute_s"] = float(compute)
                row["other_s"] = max(
                    0.0, float(lat) - float(qw) - stall_s - float(compute)
                )
            rows.append(row)
        return rows

    def summary(self) -> dict:
        """Aggregate: total steps, mean/max throughput, final accuracy,
        the fault ledger when any fault was recorded, the serving /
        fleet dispatch sections (latency percentiles + decomposition),
        and — when an SLO target is declared — the ``"slo"`` section
        (attainment, error-budget burn). Ring-buffer evictions are
        already folded in: counts and percentiles cover the whole run,
        not just the retained window."""
        agg = self._step_agg
        out: dict = {"steps": agg["steps"] + len(self.records)}
        sps = [
            r["samples_per_sec"] for r in self.records
            if "samples_per_sec" in r
        ]
        sps_n = agg["sps_n"] + len(sps)
        if sps_n:
            out["mean_samples_per_sec"] = round(
                (agg["sps_sum"] + sum(sps)) / sps_n, 1
            )
            live_max = max(sps) if sps else None
            out["max_samples_per_sec"] = round(
                max(
                    v for v in (agg["sps_max"], live_max)
                    if v is not None
                ),
                1,
            )
        angles = [
            r["principal_angle_deg"]
            for r in self.records
            if "principal_angle_deg" in r
        ]
        if angles:
            out["final_principal_angle_deg"] = angles[-1]
        if self.fault_records or self._fault_agg["count"]:
            by_kind = dict(self._fault_agg["by_kind"])
            for r in self.fault_records:
                by_kind[r["fault"]] = by_kind.get(r["fault"], 0) + 1
            out["faults"] = {
                "count": self._fault_agg["count"] + len(self.fault_records),
                "by_kind": by_kind,
                # the events list holds the RETAINED window; evicted
                # events survive in count/by_kind above
                "events": list(self.fault_records),
            }
            if self.fault_records.evicted:
                out["faults"]["events_evicted"] = self.fault_records.evicted
        if self.ingest_stats is not None:
            out["ingest"] = self.ingest_stats.as_dict()
        if (
            self.membership_records
            or self._membership_agg["count"]
            or self.membership_table is not None
        ):
            out["membership"] = self._membership_summary()
        if self.merge_records or self._merge_agg["count"]:
            out["merge"] = self._merge_summary()
        if self.replication_records or self._replication_agg["count"]:
            out["replication"] = self._replication_summary()
        if self.population_records or self._population_agg["count"]:
            out["population"] = self._population_summary()
        if self.solver_records or self._solver_agg["count"]:
            out["solver"] = self._solver_summary()
        if self.controller_records or self._controller_agg["count"]:
            out["controller"] = self._controller_summary()
        if self.serve_records or self._serve_agg["events"]:
            out["serving"] = self._serving_summary()
        if self.fleet_records or self._fleet_agg["events"]:
            out["fleet"] = self._fleet_summary()
        slo = self._slo_summary(out)
        if slo:
            out["slo"] = slo
        episodes = self._episode_summaries()
        if episodes:
            out["episodes"] = episodes
        if self.compile_cache is not None:
            out["compile"] = self.compile_cache.stats()
        if self.analysis_report is not None:
            rep = self.analysis_report
            out["analysis"] = rep() if callable(rep) else rep
        return out

    # -- dispatch-section helpers --------------------------------------------

    @staticmethod
    def _stall_fields(records: list[dict], agg: dict) -> dict:
        """Shared compile-stall aggregation for the serving and fleet
        sections: total misses, total stall ms, and the per-signature
        stall breakdown that makes a p99 regression attributable to
        the exact shape that compiled inline."""
        out: dict = {
            "compile_misses": agg["compile_misses"] + sum(
                r.get("compile_misses", 0) for r in records
            ),
            "compile_stall_ms": round(
                agg["compile_stall_ms"] + sum(
                    r.get("compile_stall_ms", 0.0) for r in records
                ),
                3,
            ),
        }
        by_sig: dict[str, float] = dict(agg["by_sig"])
        for r in records:
            stall = r.get("compile_stall_ms", 0.0)
            if stall and "signature" in r:
                sig = str(tuple(r["signature"]))
                by_sig[sig] = round(by_sig.get(sig, 0.0) + stall, 3)
        if by_sig:
            out["compile_stall_ms_by_signature"] = by_sig
        return out

    def _occupancy_fields(self, batches: list[dict], agg: dict) -> dict:
        """Batch-occupancy metrics for the serving section:
        mean fill fraction (served rows / dispatched rows after bucket
        padding), padded-row waste per signature bucket, and
        admit-to-dispatch wait p50/p99 — the number continuous batching
        exists to shrink. Percentiles follow the latency-section rule:
        exact over the live window, log-bucket histogram estimates once
        the ring has evicted."""
        out: dict = {}
        fills = [
            r["fill_fraction"] for r in batches if "fill_fraction" in r
        ]
        fill_n = agg["fill_n"] + len(fills)
        if fill_n:
            out["mean_fill_fraction"] = round(
                (agg["fill_sum"] + sum(fills)) / fill_n, 4
            )
        total_pad = agg["padded_rows"] + sum(
            r.get("padded_rows", 0) for r in batches
        )
        if total_pad:
            out["padded_rows"] = total_pad
            by_sig: dict[str, int] = dict(agg["padded_by_sig"])
            for r in batches:
                pad = r.get("padded_rows", 0)
                if pad and "signature" in r:
                    sig = str(tuple(r["signature"]))
                    by_sig[sig] = by_sig.get(sig, 0) + pad
            if by_sig:
                out["padded_rows_by_signature"] = by_sig
        total_lpad = agg["padded_lanes"] + sum(
            r.get("padded_lanes", 0) for r in batches
        )
        if total_lpad:
            out["padded_lanes"] = total_lpad
            by_sig_l: dict[str, int] = dict(agg["padded_lanes_by_sig"])
            for r in batches:
                lpad = r.get("padded_lanes", 0)
                if lpad and "signature" in r:
                    sig = str(tuple(r["signature"]))
                    by_sig_l[sig] = by_sig_l.get(sig, 0) + lpad
            if by_sig_l:
                out["padded_lanes_by_signature"] = by_sig_l
        admits = [
            float(a)
            for r in batches
            for a in (r.get("admit_to_dispatch_s") or ())
            if a is not None
        ]
        evicted = agg["hist"]["admit_to_dispatch_s"].count > 0
        if admits and not evicted:
            ws = sorted(admits)
            out["admit_to_dispatch_p50_s"] = round(ws[len(ws) // 2], 6)
            out["admit_to_dispatch_p99_s"] = round(
                ws[min(len(ws) - 1, int(len(ws) * 0.99))], 6
            )
        elif evicted:
            h = agg["hist"]["admit_to_dispatch_s"].copy()
            h.record_many(max(a, 1e-6) for a in admits)
            out["admit_to_dispatch_p50_s"] = round(
                h.quantile(0.5) or 0.0, 6
            )
            out["admit_to_dispatch_p99_s"] = round(
                h.quantile(0.99) or 0.0, 6
            )
        return out

    def _latency_fields(self, records: list[dict], agg: dict) -> dict:
        """p50/p99 + decomposition for one dispatch section. With no
        evictions the percentiles are EXACT (sorted live latencies —
        bit-compatible with the earlier summary); once the ring
        has evicted, live rows merge into the eviction histograms and
        the percentiles are log-bucket estimates (within one bucket
        growth factor — ``telemetry.Histogram``)."""
        out: dict = {}
        rows = [row for r in records for row in self._decomp_rows(r)]
        evicted = agg["hist"]["total_s"].count > 0
        if not rows and not evicted:
            return out
        if not evicted:
            lat = sorted(row["total_s"] for row in rows)
            out["p50_latency_s"] = round(lat[len(lat) // 2], 6)
            out["p99_latency_s"] = round(
                lat[min(len(lat) - 1, int(len(lat) * 0.99))], 6
            )
        else:
            h = agg["hist"]["total_s"].copy()
            h.record_many(row["total_s"] for row in rows)
            out["p50_latency_s"] = round(h.quantile(0.5), 6)
            out["p99_latency_s"] = round(h.quantile(0.99), 6)
            out["latency_hist"] = h.as_dict()
        decomp = self._decomposition(rows, agg, evicted)
        if decomp:
            out["latency_decomposition"] = decomp
        return out

    def _decomposition(self, rows: list[dict], agg: dict,
                       evicted: bool) -> dict | None:
        """The latency decomposition block: per-percentile component
        breakdown. Exact mode reports the COMPONENTS OF the request at
        the percentile rank (so they sum to its total, ±rounding);
        histogram mode (after eviction) reports per-component
        percentile estimates and labels itself accordingly."""
        full = [r for r in rows if "queue_wait_s" in r]
        if not evicted:
            if not full:
                return None
            full.sort(key=lambda r: r["total_s"])
            n = len(full)

            def pick(rank: int) -> dict:
                r = full[rank]
                return {
                    "total_s": round(r["total_s"], 6),
                    **{k: round(r[k], 6) for k in DECOMP_KEYS},
                }

            mean = {
                "total_s": round(
                    sum(r["total_s"] for r in full) / n, 6
                ),
                **{
                    k: round(sum(r[k] for r in full) / n, 6)
                    for k in DECOMP_KEYS
                },
            }
            return {
                "source": "exact",
                "requests": n,
                "p50": pick(n // 2),
                "p99": pick(min(n - 1, int(n * 0.99))),
                "mean": mean,
            }
        # histogram mode: merge live rows into copies of the evicted
        # histograms, report per-component estimates
        hists = {k: agg["hist"][k].copy() for k in DECOMP_KEYS}
        total = agg["hist"]["total_s"].copy()
        for r in full:
            for k in DECOMP_KEYS:
                hists[k].record(r[k])
        total.record_many(r["total_s"] for r in rows)
        if not any(h.count for h in hists.values()):
            return None

        def est(q: float) -> dict:
            return {
                "total_s": round(total.quantile(q) or 0.0, 6),
                **{
                    k: round(hists[k].quantile(q) or 0.0, 6)
                    for k in DECOMP_KEYS
                },
            }

        return {
            "source": "histogram",
            "requests": total.count,
            "p50": est(0.5),
            "p99": est(0.99),
            "mean": {
                "total_s": round(total.mean or 0.0, 6),
                **{
                    k: round(hists[k].mean or 0.0, 6)
                    for k in DECOMP_KEYS
                },
            },
        }

    def _membership_summary(self) -> dict:
        """The ``summary()["membership"]`` section: event
        counts by kind (joins, admits, leaves, suspect→dead, quorum
        transitions), round outcomes (deadline-closed rounds, stale
        straggler folds, per-round arrival histogram), the retained
        event window, and — when a table is attached — its live
        snapshot. Evictions are folded in, so the counts cover the
        whole run."""
        agg = self._membership_agg
        by_kind = dict(agg["by_kind"])
        rounds = {
            "rounds": agg["rounds"],
            "deadline_closed": agg["deadline_closed"],
            "stale_folds": agg["stale_folds"],
            "arrival_hist": dict(agg["arrival_hist"]),
        }
        for r in self.membership_records:
            kind = r.get("membership", "unknown")
            by_kind[kind] = by_kind.get(kind, 0) + 1
            if kind == "round_closed":
                self._fold_membership_round(rounds, r)
        out: dict = {
            "events": agg["count"] + len(self.membership_records),
            "by_kind": by_kind,
            **rounds,
            # the retained window — evicted events survive in the
            # counters above (the faults-section rule)
            "recent": list(self.membership_records),
        }
        if self.membership_records.evicted:
            out["events_evicted"] = self.membership_records.evicted
        if self.membership_table is not None:
            out["table"] = self.membership_table.snapshot()
        return out

    def _merge_summary(self) -> dict:
        """The ``summary()["merge"]`` section: hierarchical-
        merge event counts by kind and the PER-TIER round ledger —
        fan-in, rounds, tier-deadline closes, one-step-stale folds, and
        the per-round arrival histogram — plus, under an active
        ``merge_wire_dtype`` policy, the per-tier WIRE ledger (codec, payload vs fp32 bytes, compression ratio, EF
        residual norm) and the retained event window. Evictions are
        folded in (the membership-section rule), so a long elastic
        run's tree stays fully accounted."""
        agg = self._merge_agg
        by_kind = dict(agg["by_kind"])
        tiers = {
            name: {**t, "arrival_hist": dict(t["arrival_hist"])}
            for name, t in agg["tiers"].items()
        }
        wire = {name: dict(t) for name, t in agg["wire"].items()}
        for r in self.merge_records:
            kind = r.get("merge", "unknown")
            by_kind[kind] = by_kind.get(kind, 0) + 1
            if kind == "tier_round":
                self._fold_merge_tier(tiers, r)
            elif kind == "wire":
                self._fold_merge_wire(wire, r)
        out: dict = {
            "events": agg["count"] + len(self.merge_records),
            "by_kind": by_kind,
            "tiers": tiers,
            "recent": list(self.merge_records),
        }
        if wire:
            out["wire"] = wire
        if self.merge_records.evicted:
            out["events_evicted"] = self.merge_records.evicted
        return out

    def _population_summary(self) -> dict:
        """The ``summary()["population"]`` section: event
        counts by kind, cohort-round outcomes (rounds, one-step-stale
        folds, per-round participation decile histogram), quarantines
        by rejection reason (the attribution ledger's roll-up), the
        mean trimmed-merge trim fraction, and the retained event
        window. Evictions are folded in (the membership-section rule),
        so the counts cover the whole run."""
        agg = self._population_agg
        folded = {
            "by_kind": dict(agg["by_kind"]),
            "rounds": agg["rounds"],
            "stale_folds": agg["stale_folds"],
            "participation_hist": dict(agg["participation_hist"]),
            "rejects_by_reason": dict(agg["rejects_by_reason"]),
            "trim_frac_sum": agg["trim_frac_sum"],
            "trim_frac_n": agg["trim_frac_n"],
        }
        for r in self.population_records:
            kind = r.get("population", "unknown")
            folded["by_kind"][kind] = folded["by_kind"].get(kind, 0) + 1
            self._fold_population(folded, r)
        out: dict = {
            "events": agg["count"] + len(self.population_records),
            "by_kind": folded["by_kind"],
            "rounds": folded["rounds"],
            "stale_folds": folded["stale_folds"],
            "participation_hist": folded["participation_hist"],
            "rejects_by_reason": folded["rejects_by_reason"],
            "recent": list(self.population_records),
        }
        if folded["trim_frac_n"]:
            out["mean_trim_frac"] = round(
                folded["trim_frac_sum"] / folded["trim_frac_n"], 4
            )
        if self.population_records.evicted:
            out["events_evicted"] = self.population_records.evicted
        return out

    def _replication_summary(self) -> dict:
        """The ``summary()["replication"]`` section: event
        counts by kind, replica installs / staleness breaches / fenced
        zombie commits, propagation-lag percentiles (exact over the
        live window; log-bucket histogram estimates once the ring has
        evicted — the latency-section rule), failover count + per-
        failover recovery_ms, and the retained event window."""
        agg = self._replication_agg
        fold = {
            "by_kind": dict(agg["by_kind"]), "installs": agg["installs"],
            "stale": agg["stale"], "fenced": agg["fenced"],
            "failovers": agg["failovers"],
            "recovery_ms": list(agg["recovery_ms"]),
        }
        live_lags: list[float] = []
        for r in self.replication_records:
            self._fold_replication(fold, r)
            if (
                r.get("replication") == "install"
                and r.get("lag_ms") is not None
            ):
                live_lags.append(float(r["lag_ms"]))
        out: dict = {
            "events": agg["count"] + len(self.replication_records),
            "by_kind": fold["by_kind"],
            "installs": fold["installs"],
            "stale": fold["stale"],
            "fenced": fold["fenced"],
            "failovers": fold["failovers"],
        }
        evicted = agg["lag_hist"].count > 0
        if live_lags and not evicted:
            lat = sorted(live_lags)
            out["propagation_p50_ms"] = round(lat[len(lat) // 2], 3)
            out["propagation_p99_ms"] = round(
                lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3
            )
        elif evicted:
            h = agg["lag_hist"].copy()
            h.record_many(max(v, 1e-3) / 1e3 for v in live_lags)
            out["propagation_p50_ms"] = round(
                (h.quantile(0.5) or 0.0) * 1e3, 3
            )
            out["propagation_p99_ms"] = round(
                (h.quantile(0.99) or 0.0) * 1e3, 3
            )
            out["lag_hist"] = h.as_dict()
        if fold["recovery_ms"]:
            out["failover_recovery_ms"] = fold["recovery_ms"]
        out["recent"] = list(self.replication_records)
        if self.replication_records.evicted:
            out["events_evicted"] = self.replication_records.evicted
        return out

    def _fleet_summary(self) -> dict:
        """The ``summary()["fleet"]`` section (mirrors ``["serving"]``):
        dispatched buckets, tenants served, mean bucket occupancy,
        request-latency percentiles + decomposition, and the
        compile-stall ledger."""
        agg = self._fleet_agg
        buckets = [
            r for r in self.fleet_records if r["fleet"] == "bucket"
        ]
        out: dict = {"buckets": agg["events"] + len(buckets)}
        if buckets or agg["events"]:
            out["tenants"] = agg["requests"] + sum(
                r.get("tenants", 0) for r in buckets
            )
            occ = [r["occupancy"] for r in buckets if "occupancy" in r]
            occ_n = agg["occ_n"] + len(occ)
            if occ_n:
                out["mean_occupancy"] = round(
                    (agg["occ_sum"] + sum(occ)) / occ_n, 4
                )
            # occupancy-waste ledger (heterogeneous-k
            # bucketing surfaces padded_lanes[_by_signature] here)
            out.update(self._occupancy_fields(buckets, agg))
            out.update(self._stall_fields(buckets, agg))
            out.update(self._latency_fields(buckets, agg))
        if self.fleet_records.evicted:
            out["events_evicted"] = self.fleet_records.evicted
        return out

    def _serving_summary(self) -> dict:
        """The ``summary()["serving"]`` section (mirrors ``["ingest"]``):
        qps over the served window, p50/p99 query latency decomposed
        into queue_wait / compile_stall / compute / other, mean batch
        occupancy, hot-swap count, and the latest drift score."""
        agg = self._serve_agg
        batches = [r for r in self.serve_records if r["serve"] == "batch"]
        out: dict = {"batches": agg["events"] + len(batches)}
        if batches or agg["events"]:
            live_q = sum(r.get("queries", 0) for r in batches)
            queries = agg["requests"] + live_q
            out["queries"] = queries
            out["rejected"] = agg["rejected"] + sum(
                r.get("rejected", 0) for r in batches
            )
            ts = [r["t_mono"] for r in batches] + [
                t for t in (agg["t_min"], agg["t_max"]) if t is not None
            ]
            span = (max(ts) - min(ts)) if ts else 0.0
            n_events = agg["events"] + len(batches)
            if n_events > 1 and span > 0:
                # arrival-window rate; a single batch has no window, so
                # its own dispatch time is the only honest denominator
                out["qps"] = round(queries / span, 1)
            else:
                secs = sum(r.get("batch_seconds", 0.0) for r in batches)
                if secs > 0:
                    out["qps"] = round(queries / secs, 1)
            occ = [r["occupancy"] for r in batches if "occupancy" in r]
            occ_n = agg["occ_n"] + len(occ)
            if occ_n:
                out["mean_occupancy"] = round(
                    (agg["occ_sum"] + sum(occ)) / occ_n, 4
                )
            out["swaps"] = agg["swaps"] + sum(
                1 for r in batches if r.get("swap")
            )
            versions = set(agg["versions"]) | {
                r["version"] for r in batches if "version" in r
            }
            out["versions_served"] = sorted(versions)
            out.update(self._occupancy_fields(batches, agg))
            out.update(self._stall_fields(batches, agg))
            out.update(self._latency_fields(batches, agg))
        health = self._health_summary()
        if health:
            out["health"] = health
        drifts = [r for r in self.serve_records if r["serve"] == "drift"]
        if drifts or agg["drifts"]:
            out["drift_refreshes"] = agg["drifts"] + len(drifts)
        if drifts:
            out["drift_score"] = drifts[-1].get("score")
            out["drift_published"] = [
                r["published"] for r in drifts
                if r.get("published") is not None
            ]
        if self.serve_records.evicted:
            out["events_evicted"] = self.serve_records.evicted
        return out

    def _health_summary(self) -> dict:
        """``summary()["serving"]["health"]``: the read
        path's resilience report. Counters (sheds by reason, lane
        restarts/deaths, breaker trips, recovery time) come from the
        EVENT stream — live window plus eviction aggregates, so they
        cover the whole run; the live snapshot (breaker states,
        in-flight depth, lane liveness) comes from the attached
        :meth:`attach_serve_health` sources — states, not counts, so
        multi-server merges never double-count."""
        agg = self._serve_agg
        sheds = dict(agg["sheds_by_reason"])
        lane_restarts = agg["lane_restarts"]
        lane_deaths = agg["lane_deaths"]
        breaker_trips = agg["breaker_trips"]
        recovery_ms = None
        for r in self.serve_records:
            kind = r.get("serve")
            if kind == "shed":
                reason = r.get("reason", "overload")
                sheds[reason] = sheds.get(reason, 0) + r.get("dropped", 1)
            elif kind == "lane":
                if r.get("event") == "restart":
                    lane_restarts += 1
                elif r.get("event") == "dead":
                    lane_deaths += 1
                elif r.get("event") == "recovered":
                    recovery_ms = r.get("recovery_ms")
            elif kind == "breaker" and r.get("event") == "open":
                breaker_trips += 1
        out: dict = {}
        if sheds:
            out["sheds"] = sheds
            out["shed_count"] = sum(sheds.values())
        if lane_restarts:
            out["lane_restarts"] = lane_restarts
        if lane_deaths:
            out["lane_deaths"] = lane_deaths
        if breaker_trips:
            out["breaker_trips"] = breaker_trips
        if recovery_ms is not None:
            out["recovery_ms"] = recovery_ms
        # live state from attached servers: breaker states union,
        # in-flight sum, lane liveness
        breakers: dict = {}
        inflight = 0
        lanes_alive: list[bool] = []
        for src in self.serve_health_sources:
            try:
                live = src()
            except Exception:
                continue
            breakers.update(live.get("breakers") or {})
            inflight += live.get("inflight", 0)
            if "lane_alive" in live:
                lanes_alive.append(bool(live["lane_alive"]))
            if live.get("last_recovery_ms") is not None:
                recovery_ms = live["last_recovery_ms"]
                out["recovery_ms"] = recovery_ms
        if breakers:
            out["breakers"] = breakers
        if self.serve_health_sources:
            out["inflight"] = inflight
            out["servers"] = len(self.serve_health_sources)
            if lanes_alive:
                out["lanes_alive"] = all(lanes_alive)
        return out

    @staticmethod
    def _recovery_from(
        t0: float, completions: list, target_ms: float, probe: int = 5
    ) -> float | None:
        """Recovery time (ms) from a fault injected at monotonic ``t0``
        back to SLO-attaining steady state: the earliest completion at
        or after ``t0`` from which the next ``probe`` consecutive
        requests (or all that remain, if fewer) ALL meet the target —
        one lucky fast request during the incident doesn't count as
        recovered. ``completions`` is the time-sorted
        ``(t_mono, latency_ms)`` stream; returns None when steady
        state was never regained."""
        for i in range(len(completions)):
            if completions[i][0] < t0:
                continue
            k = min(probe, len(completions) - i)
            if all(
                completions[j][1] <= target_ms for j in range(i, i + k)
            ):
                return round((completions[i][0] - t0) * 1e3, 3)
        return None

    def _episode_summaries(self) -> dict:
        """The ``summary()["episodes"]`` section: per-tier
        records sliced by the attached tracer's ``category="episode"``
        spans (``Tracer.episode`` — the scenario harness's markers).
        Each episode reports the SAME key set (None/0 when a field
        does not apply) so two runs of one spec produce structurally
        identical verdicts: window SLO attainment + burn, p99 and its
        queue_wait/compile_stall/compute decomposition, shed / lane /
        breaker / drift counts, fleet requests, membership events, and
        — for fault episodes — recovery back to SLO-attaining steady
        state. Slicing covers the RETAINED ring window (size scenario
        runs under ``retention``; a sliced long run under-counts
        loudly via ``events_evicted`` in the per-tier sections)."""
        tracer = self.tracer
        if tracer is None:
            return {}
        ep_spans = [
            sp for sp in tracer.snapshot() if sp.category == "episode"
        ]
        if not ep_spans:
            return {}
        batches = [
            r for r in self.serve_records if r.get("serve") == "batch"
        ]
        serve_events = list(self.serve_records)
        fleet_buckets = [
            r for r in self.fleet_records if r.get("fleet") == "bucket"
        ]
        membership = list(self.membership_records)
        # per-request completion stream for recovery scans: a request
        # completes at its batch's dispatch stamp
        completions = sorted(
            (r["t_mono"], lat * 1e3)
            for r in batches
            for lat in (r.get("query_latency_s") or ())
            if lat is not None
        )
        out: dict = {}
        for sp in ep_spans:
            t0 = sp.t_start_mono
            t1 = (
                sp.t_end_mono if sp.t_end_mono is not None
                else float("inf")
            )

            def _in(r, t0=t0, t1=t1):
                return t0 <= r.get("t_mono", r.get("t", 0.0)) <= t1

            win = [r for r in batches if _in(r)]
            lats_ms = [
                lat * 1e3
                for r in win
                for lat in (r.get("query_latency_s") or ())
                if lat is not None
            ]
            rows = [row for r in win for row in self._decomp_rows(r)]
            p99_ms = None
            if lats_ms:
                ws = sorted(lats_ms)
                p99_ms = round(
                    ws[min(len(ws) - 1, int(len(ws) * 0.99))], 3
                )
            slo = (
                slo_summary(self.slo_p99_ms, lats_ms, p99_ms=p99_ms)
                if self.slo_p99_ms is not None and lats_ms else None
            )
            decomp = (
                self._decomposition(rows, self._serve_agg, False)
                if rows else None
            )
            fault = bool(sp.attrs.get("fault"))
            recovery_ms = None
            recovered = None
            if fault and self.slo_p99_ms is not None:
                recovery_ms = self._recovery_from(
                    t0, completions, self.slo_p99_ms
                )
                recovered = recovery_ms is not None
            out[sp.name] = {
                "kind": sp.attrs.get("kind"),
                "fault": fault,
                "t_start_s": round(t0 - tracer.t0_mono, 6),
                "duration_s": round(sp.duration_s, 6),
                "requests": len(lats_ms),
                "rejected": sum(r.get("rejected", 0) for r in win),
                "sheds": sum(
                    r.get("dropped", 1) for r in serve_events
                    if r.get("serve") == "shed" and _in(r)
                ),
                "lane_restarts": sum(
                    1 for r in serve_events
                    if r.get("serve") == "lane"
                    and r.get("event") == "restart" and _in(r)
                ),
                "lane_deaths": sum(
                    1 for r in serve_events
                    if r.get("serve") == "lane"
                    and r.get("event") == "dead" and _in(r)
                ),
                "breaker_trips": sum(
                    1 for r in serve_events
                    if r.get("serve") == "breaker"
                    and r.get("event") == "open" and _in(r)
                ),
                "drift_refreshes": sum(
                    1 for r in serve_events
                    if r.get("serve") == "drift" and _in(r)
                ),
                "fleet_requests": sum(
                    r.get("tenants", 0) for r in fleet_buckets
                    if _in(r)
                ),
                "membership_events": sum(
                    1 for r in membership if _in(r)
                ),
                "p99_ms": p99_ms,
                "slo": slo,
                "latency_decomposition": decomp,
                "recovery_ms": recovery_ms,
                "recovered": recovered,
            }
        return out

    def _slo_summary(self, out: dict) -> dict:
        """The ``summary()["slo"]`` section: attainment + error-budget
        burn against the declared p99 targets. The live ring buffers
        are the rolling window; evicted requests count via the
        aggregates (folded with the target in force at eviction
        time)."""
        slo: dict = {}
        if self.slo_p99_ms is not None:
            lats = [
                lat * 1e3
                for r in self.serve_records
                if r.get("serve") == "batch"
                for lat in (r.get("query_latency_s") or ())
                if lat is not None
            ]
            agg = self._serve_agg
            if lats or agg["slo_requests"]:
                p99_s = out.get("serving", {}).get("p99_latency_s")
                slo["serve"] = slo_summary(
                    self.slo_p99_ms,
                    lats,
                    evicted_requests=agg["slo_requests"],
                    evicted_violations=agg["slo_violations"],
                    p99_ms=(
                        round(p99_s * 1e3, 3) if p99_s is not None else None
                    ),
                )
        if self.fleet_slo_p99_ms is not None:
            lats = [
                lat * 1e3
                for r in self.fleet_records
                if r.get("fleet") == "bucket"
                for lat in (r.get("request_latency_s") or ())
                if lat is not None
            ]
            agg = self._fleet_agg
            if lats or agg["slo_requests"]:
                p99_s = out.get("fleet", {}).get("p99_latency_s")
                slo["fleet"] = slo_summary(
                    self.fleet_slo_p99_ms,
                    lats,
                    evicted_requests=agg["slo_requests"],
                    evicted_violations=agg["slo_violations"],
                    p99_ms=(
                        round(p99_s * 1e3, 3) if p99_s is not None else None
                    ),
                )
        return slo


def log_line(msg: str, **fields) -> None:
    """One structured log line to stderr (replaces the reference's
    prints). Carries both clocks like every other event (``time`` stays
    for existing consumers; it is the unix stamp)."""
    rec = {
        "msg": msg,
        "time": time.time(),
        "t_unix": time.time(),
        "t_mono": time.perf_counter(),
        **fields,
    }
    print(json.dumps(rec), file=sys.stderr, flush=True)
