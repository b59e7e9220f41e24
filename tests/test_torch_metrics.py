"""Parity of ``utils/metrics.py`` with the JAX package's ``MetricsLogger``:
one event stream under a fixed clock gives equal summaries, key for key,
with and without ring-buffer eviction; the sinks that feed it (the query
server, the fleet server, the registry) report what they served."""

import itertools
import time

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.utils.metrics import MetricsLogger as JaxLogger
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.serving import EigenbasisRegistry, QueryServer
from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger
from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer

D, K = 32, 3
TIMEOUT = 60.0


def _events():
    """One stream of every sink's events, as the instrumented layers emit
    them (the field names of serving/server.py, parallel/fleet.py,
    runtime/membership.py, runtime/tiers.py, serving/replication.py,
    runtime/population.py, solvers/, runtime/controller.py and the
    supervisor's ledger)."""
    ev = []
    for t in range(1, 7):
        ev.append(("on_step", t))
    for i in range(5):
        ev.append(("serve", {
            "kind": "batch", "queries": 4, "rejected": i % 2, "rows": 40,
            "padded_rows": 24, "fill_fraction": 0.625,
            "admit_to_dispatch_s": [0.001 * (i + j) for j in range(4)],
            "batch_seconds": 0.002, "signature": [D, K],
            "compile_misses": 1 if i == 0 else 0,
            "compile_stall_ms": 3.5 if i == 0 else 0.0,
            "query_latency_s": [0.004 + 0.001 * j for j in range(4)],
            "queue_wait_s": [0.001 * j for j in range(4)], "compute_s": 0.0015,
            "dispatch_s": 0.002, "occupancy": 0.5, "version": 1 + i // 3,
            "swap": i == 3,
        }))
    ev += [("serve", {"kind": "shed", "reason": "deadline", "dropped": 2,
                      "signature": [D, K]}),
           ("serve", {"kind": "shed", "reason": "overload", "signature": [D, K]}),
           ("serve", {"kind": "lane", "event": "restart", "attempt": 1,
                      "error": "KillSwitch()", "backoff_s": 0.05}),
           ("serve", {"kind": "lane", "event": "recovered", "recovery_ms": 51.0}),
           ("serve", {"kind": "breaker_open", "signature": [D, K], "failures": 3}),
           ("serve", {"kind": "drift", "score": 0.4, "residual_drift": 0.3,
                      "angle_gap_deg": 9.0, "refit_rows": 512, "published": 2}),
           ("serve", {"kind": "registry", "event": "version retired", "version": 1})]
    for b in range(3):
        ev.append(("fleet", {
            "kind": "bucket", "tenants": 2 + b, "occupancy": (2 + b) / 8,
            "signature": [D, K, 4, 16], "compile_misses": int(b == 0),
            "compile_stall_ms": 12.0 if b == 0 else 0.0, "bucket_seconds": 0.3,
            "request_latency_s": [0.31 + 0.01 * j for j in range(2 + b)],
            "queue_wait_s": [0.01 * j for j in range(2 + b)], "compute_s": 0.28,
            "dispatch_s": 0.3, "padded_lanes": b,
        }))
    for s in range(1, 5):
        ev.append(("membership", {"kind": "round_closed", "step": s, "arrived": 8 - s,
                                  "members": 9, "arrived_slots": list(range(8 - s)),
                                  "late": [9], "stale": [9] if s > 1 else [],
                                  "deadline_closed": True, "quorum_frac": 0.9}))
    ev += [("membership", {"kind": "suspect", "slot": 2, "generation": 0,
                           "missed_ms": 120.0}),
           ("membership", {"kind": "dead", "slot": 2, "generation": 0}),
           ("membership", {"kind": "join", "slot": 2, "generation": 1}),
           ("membership", {"kind": "admit", "slot": 2, "generation": 1})]
    ev += [("merge", {"kind": "round_closed", "tier": "host", "fan_in": 2, "step": s,
                      "arrived": 2 - (s % 2), "stale": [1] if s % 2 else [],
                      "deadline_closed": bool(s % 2)}) for s in range(1, 4)]
    ev += [("replication", {"kind": "install", "replica": "r0", "version": v,
                            "epoch": 1, "lag_ms": 5.0 + v, "stale": False,
                            "grew_from": None}) for v in range(1, 4)]
    ev += [("replication", {"kind": "failover", "owner": "b", "epoch": 2,
                            "recovery_ms": 280.0})]
    ev += [("population", {"kind": "round_closed", "round": r, "participation": 0.6,
                           "stale": 1, "trim_frac": 0.05}) for r in range(1, 3)]
    ev += [("population", {"kind": "quarantine_client", "client": 7, "reason": "nonfinite"})]
    ev += [("solver", {"kind": "deflation", "lane": ln, "iters_used": 9 + ln,
                       "max_iters": 16, "residual": 1e-5}) for ln in range(3)]
    ev += [("controller", {"kind": "action", "knob": "flush_s", "trigger": "burn",
                           "from": 0.02, "to": 0.01, "plan_id": "p"}),
           ("controller", {"kind": "rollback", "knob": "flush_s", "trigger": "burn"})]
    ev += [("fault", {"kind": "quarantine_nonfinite", "step": 3, "workers": [2]}),
           ("fault", {"kind": "stream_retry", "step": 5, "error": "OSError('x')",
                      "attempt": 1, "backoff_s": 0.05}),
           ("fault", {"kind": "resume", "step": 6, "cursor": 384, "reason": "restart"})]
    return ev


def _run(cls, events, retention, monkeypatch):
    clock = itertools.count(1000.0, 0.25)
    wall = itertools.count(1.7e9, 0.25)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(time, "time", lambda: next(wall))
    m = cls(samples_per_step=64, retention=retention, slo_p99_ms=5.0,
            fleet_slo_p99_ms=400.0).start()
    for kind, payload in events:
        if kind == "on_step":
            m.on_step(payload, None)
        else:
            getattr(m, kind)(dict(payload))
    out = m.summary()
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("retention", [4096, 7, 2])
def test_summary_matches_the_reference_key_for_key(retention, monkeypatch):
    events = _events()
    got = _run(MetricsLogger, events, retention, monkeypatch)
    want = _run(JaxLogger, events, retention, monkeypatch)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert {"faults", "serving", "fleet", "membership", "merge", "replication",
            "population", "solver", "controller", "slo"} <= set(got)


def test_step_angle_against_a_reference_subspace():
    rng = np.random.default_rng(0)
    ref = np.linalg.qr(rng.standard_normal((D, K)))[0].astype(np.float32)
    m = MetricsLogger(reference_subspace=ref).start()
    m.on_step(1, None, torch.from_numpy(ref.copy()))
    tilt = ref.copy()
    tilt[:, 0] += 0.05 * rng.standard_normal(D).astype(np.float32)
    m.on_step(2, None, torch.from_numpy(tilt))
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    want = float(principal_angles_degrees(torch.from_numpy(tilt), torch.from_numpy(ref)).max())
    assert m.records[0]["principal_angle_deg"] == 0.0
    assert m.summary()["final_principal_angle_deg"] == round(want, 4)


def test_compile_and_analysis_attachments_name_their_items():
    m = MetricsLogger()
    with pytest.raises(NotImplementedError, match="item 16 .utils/compile_cache.py."):
        m.attach_compile(object())
    with pytest.raises(NotImplementedError, match="item 17b"):
        m.attach_analysis({})


def _basis(seed=0):
    return np.linalg.qr(np.random.default_rng(seed).standard_normal((D, K)))[0].astype(
        np.float32)


def test_query_server_reports_its_burst(monkeypatch):
    reg = EigenbasisRegistry()
    reg.publish(_basis())
    cfg = PCAConfig(dim=D, k=K, num_workers=2, rows_per_worker=8, serve_bucket_size=4,
                    serve_flush_s=0.01, serve_slo_p99_ms=10_000.0)
    m = MetricsLogger(retention=3)
    tracer = Tracer()
    m.attach_tracer(tracer)
    rng = np.random.default_rng(1)
    queries = [rng.standard_normal((1 + i % 3, D)).astype(np.float32) for i in range(10)]
    with QueryServer(reg, cfg, metrics=m, device="cpu") as srv:
        tickets = [srv.submit(q) for q in queries]
        for t in tickets:
            t.result(timeout=TIMEOUT)
        bad = srv.submit(np.full((1, D), np.nan, np.float32))
        with pytest.raises(ValueError, match="non-finite"):
            bad.result(timeout=TIMEOUT)
    s = m.summary()
    serving = s["serving"]
    assert serving["queries"] == 11 and serving["rejected"] == 1
    assert serving["batches"] >= 3 and m.serve_records.evicted > 0
    assert serving["versions_served"] == [1]
    assert serving["latency_decomposition"]["source"] == "histogram"
    assert "health" in serving
    assert s["slo"]["serve"]["requests"] == 11
    chains = {}
    for sp in tracer.snapshot():
        if (sp.trace_id or "").startswith("query"):
            chains.setdefault(sp.trace_id, set()).add(sp.name)
    assert len(chains) == 11
    assert all({"admit", "queue_wait", "dispatch"} <= c for c in chains.values())


def test_registry_log_lines_reach_the_logger(tmp_path):
    reg = EigenbasisRegistry(keep=2, registry_dir=str(tmp_path))
    reg.publish(_basis(0))
    reg.publish(_basis(1))
    # a torn snapshot (payload without its commit marker) on restart
    (tmp_path / "v00000099").mkdir()
    (tmp_path / "v00000099" / "basis.npz").write_bytes(b"torn")
    m = MetricsLogger()
    EigenbasisRegistry(keep=2, registry_dir=str(tmp_path), metrics=m)
    events = [r for r in m.serve_records if r["serve"] == "registry"]
    assert events and all(isinstance(r["event"], str) for r in events)


def test_fleet_server_reports_its_buckets():
    """``FleetServer(metrics=)``: one fleet event a bucket, the compile
    stall of a signature's first bucket and the lanes padded for a
    heterogeneous-k bucket attributed by signature, and each tenant's span
    chain under its trace."""
    from distributed_eigenspaces_tpu_torch.parallel import fleet

    cfg = PCAConfig(dim=D, k=3, num_workers=2, rows_per_worker=16, num_steps=2,
                    backend="local", fleet_bucket_size=2, fleet_flush_s=0.01,
                    fleet_pad_k=True, fleet_slo_p99_ms=60_000.0)
    m = MetricsLogger()
    tracer = Tracer()
    m.attach_tracer(tracer)
    rng = np.random.default_rng(4)
    problems = [rng.standard_normal((64, D)).astype(np.float32) for _ in range(3)]
    with fleet.FleetServer(cfg, device="cpu", metrics=m) as srv:
        tickets = [srv.submit(p) for p in problems]
        got = [t.result(timeout=TIMEOUT) for t in tickets]
    assert all(g.shape == (D, 3) for g in got)
    s = m.summary()
    f = s["fleet"]
    assert f["buckets"] == 2 and f["tenants"] == 3 and srv.metrics is m
    assert f["padded_lanes"] == 3 and sum(f["padded_lanes_by_signature"].values()) == 3
    assert f["compile_misses"] >= 1 and f["compile_stall_ms_by_signature"]
    assert s["slo"]["fleet"]["requests"] == 3
    chains = {}
    for sp in tracer.snapshot():
        if (sp.trace_id or "").startswith("fleet"):
            chains.setdefault(sp.trace_id, set()).add(sp.name)
    assert len(chains) == 3
    assert all({"admit", "queue_wait", "dispatch", "compute"} <= c for c in chains.values())
