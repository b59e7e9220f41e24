#!/usr/bin/env python3
"""Measure the planner's calibration terms on the card and write its record.

The port's counterpart of the benches whose records calibrate the
reference's planner (``bench.py --wirespeed``, ``--serve``, ``--coldstart``
and ``scripts/exp_pipeline.py``), at their shapes. One record,
``PLAN_CALIBRATION_H100.json``, holds the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and the four terms ``analysis/planner.py``'s ``load_calibration``
reads:

- ``serve_kernel_ms``: the fp32 serve kernel (``serve_split_kernel<float>``
  through ``ops/serve_project.py``) at the wirespeed shape's batch (8 rows
  a query x bucket 8 = 64 rows, d=64, k=8): CUDA events, median of 25;
- ``serve_admit_p99_ms``: continuous batching's admit-to-dispatch p99 on
  the wirespeed burst (d=64, k=8, 8 rows a query, bucket 8, 32 queries 4 ms
  apart over 4 tenants, 4 lanes, a publish mid-burst), every answer
  bit-equal to the estimator's ``transform``: the median of 5 bursts' p99s
  after one warm-up burst (a 32-request p99 is its largest wait, and the
  first burst meets each lane thread's first dispatch);
- ``serve_deadline_p99_ms``: deadline batching's request p99 at the serve
  shape (d=64, k=8, 8 rows a query, bucket 8, 16 queries in two bursts
  around a publish) with a 50 ms flush;
- ``warm_first_serve_ms``: the time from ``QueryServer`` construction
  (``prewarm=(16,)``) to the first served result in a process that finds
  its compile-cache directory warm, at the coldstart shape (d=96, k=4, 4
  workers, 48 rows, 6 steps, pipelined scan): one child process fills the
  directory, three more each time it (median);
- ``fit_schedule_arms``: the (``pipeline_merge`` x ``merge_interval``)
  grid at m=8, n=256, d=1024, k=8, 40 steps (bf16, int8 staging, 12 cold /
  2 warm iterations, Newton-Schulz warm), each arm ``evals.run_eval``'s
  median of 3 samples/s with its IQR (over its timed schedule of >= 240
  steps), the per-step ms of that schedule (its one cold step amortized),
  and the 0.2 deg gate against the (off, 1) arm's 40-step angle.

Usage (on the card):
    python3 scripts/torch_plan_calibrate.py [--out PLAN_CALIBRATION_H100.json]

The record is written to ``--out`` and printed as the last line. It needs
a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RECORD = "PLAN_CALIBRATION_H100.json"
#: the reference bench's wirespeed and serve shapes: (d, k, rows a query,
#: burst, bucket), with lanes / tenants / arrival gap and the flush
WIRESPEED = dict(dim=64, k=8, rows_per_query=8, burst=32, bucket=8, lanes=4, tenants=4,
                 arrival_gap_ms=4.0, flush_ms=50.0)
SERVE = dict(dim=64, k=8, rows_per_query=8, burst=16, bucket=8, flush_ms=50.0)
COLDSTART = dict(dim=96, k=4, workers=4, rows=48, steps=6)
GRID = dict(m=8, n=256, d=1024, k=8, steps=40)
BURSTS = 5  # measured wirespeed bursts (after one warm-up burst)
INTERVALS = (1, 2, 4, 8)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _serve_cfg(shape: dict, **kw):
    from distributed_eigenspaces_tpu_torch.config import PCAConfig

    return PCAConfig(
        dim=shape["dim"], k=shape["k"], num_workers=2, rows_per_worker=64, num_steps=2,
        solver="subspace", subspace_iters=8, backend="local",
        serve_bucket_size=shape["bucket"], serve_flush_s=shape["flush_ms"] / 1e3, **kw,
    )


def _fitted(cfg, dev, seed: int, n_queries: int, rows: int):
    """``(estimator, queries, direct answers)`` of one serve arm."""
    from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
    from distributed_eigenspaces_tpu_torch.data.synthetic import planted_spectrum

    spec = planted_spectrum(cfg.dim, k_planted=cfg.k, gap=20.0, noise=0.01, seed=7)
    fit_rows = cfg.num_steps * cfg.num_workers * cfg.rows_per_worker
    est = OnlineDistributedPCA(cfg, device=dev).fit(
        spec.sample(np.random.default_rng(1), fit_rows))
    rng = np.random.default_rng(seed)
    queries = [spec.sample(rng, rows).astype(np.float32) for _ in range(n_queries)]
    direct = [np.asarray(est.transform(q).cpu()) for q in queries]
    return est, queries, direct


def serve_kernel_ms(dev) -> dict:
    """The fp32 serve kernel at the wirespeed batch: CUDA events, median of
    25 after 3 warm calls."""
    import torch

    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    rows = WIRESPEED["rows_per_query"] * WIRESPEED["bucket"]
    d, k = WIRESPEED["dim"], WIRESPEED["k"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(dev)
    v = torch.from_numpy(np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32)).to(dev)
    for _ in range(3):
        sp.serve_project_f32_cuda(x, v)
    torch.cuda.synchronize()
    times = []
    for _ in range(25):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sp.serve_project_f32_cuda(x, v)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"value": round(statistics.median(times), 5), "at_rows_dk": [rows, d, k],
            "kernel": sp.serve_project_launch(rows, d, k, torch.float32, "f32").kernel,
            "method": "CUDA events, median of 25 one-call times"}


def serve_admit_p99_ms(dev) -> dict:
    """Continuous batching on the wirespeed burst: admit-to-dispatch p99."""
    from distributed_eigenspaces_tpu_torch.serving import (
        EigenbasisRegistry,
        QueryServer,
        TransformEngine,
    )
    from distributed_eigenspaces_tpu_torch.serving.transform import bucket_rows
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    w = WIRESPEED
    cfg = _serve_cfg(w, serve_dtype="float32")
    est, queries, direct = _fitted(cfg, dev, 23, w["burst"], w["rows_per_query"])
    registry = EigenbasisRegistry(keep=cfg.serve_keep_versions)
    v1 = registry.publish_fit(est)
    metrics = MetricsLogger(slo_p99_ms=cfg.serve_slo_p99_ms)
    engine = TransformEngine(cfg.dim, cfg.k, serve_dtype="float32", device=dev)
    # every bucket a batch of 1..bucket queries pads to, acquired and run
    for rows in sorted({bucket_rows(q * w["rows_per_query"]) for q in range(1, w["bucket"] + 1)}):
        engine.warm("project", rows)
    def burst(srv) -> tuple[list, list]:
        """One burst; ``(served, admit-to-dispatch seconds of its batches)``."""
        first = len(metrics.serve_records)
        tickets = []
        for i, q in enumerate(queries):
            if i == w["burst"] // 2:  # a publish mid-burst, the same basis
                registry.publish(v1.v, sigma_tilde=v1.sigma_tilde, step=v1.step,
                                 lineage={"producer": "plan_calibrate_swap"})
            tickets.append(srv.submit(q, tenant=f"t{i % w['tenants']}"))
            time.sleep(w["arrival_gap_ms"] / 1e3)
        served = [t.result(timeout=120) for t in tickets]
        admits = sorted(float(a) for r in metrics.serve_records[first:]
                        if r["serve"] == "batch"
                        for a in (r.get("admit_to_dispatch_s") or ()) if a is not None)
        return served, admits

    # one burst first, not counted: it meets every lane thread's first
    # dispatch; then BURSTS bursts, each its own p99 (the summary's index
    # rule), the term their median — one 32-request p99 is its maximum
    with QueryServer(registry, cfg, metrics=metrics, engine=engine, continuous=True,
                     num_lanes=w["lanes"], device=dev) as srv:
        burst(srv)
        runs = [burst(srv) for _ in range(BURSTS)]
    exact = all(np.array_equal(np.asarray(s.z), ref)
                for served, _ in runs for s, ref in zip(served, direct))
    p99s = [a[min(len(a) - 1, int(len(a) * 0.99))] * 1e3 for _, a in runs]
    p50s = [a[len(a) // 2] * 1e3 for _, a in runs]
    return {"value": round(statistics.median(p99s), 3),
            "burst_p99_ms": [round(x, 3) for x in p99s],
            "admit_p50_ms": round(statistics.median(p50s), 3),
            "bursts": BURSTS, "bit_exact_vs_direct": bool(exact), "shape": dict(w)}


def serve_deadline_p99_ms(dev) -> dict:
    """Deadline batching at the serve shape: request p99 (50 ms flush)."""
    from distributed_eigenspaces_tpu_torch.serving import (
        EigenbasisRegistry,
        QueryServer,
        TransformEngine,
    )
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    s = SERVE
    cfg = _serve_cfg(s)
    est, queries, direct = _fitted(cfg, dev, 11, s["burst"], s["rows_per_query"])
    registry = EigenbasisRegistry(keep=cfg.serve_keep_versions)
    v1 = registry.publish_fit(est)
    engine = TransformEngine(cfg.dim, cfg.k, device=dev)
    engine.warm("project", s["rows_per_query"])
    engine.warm("project", s["rows_per_query"] * s["bucket"])
    metrics = MetricsLogger(slo_p99_ms=3.0 * s["flush_ms"] + 100.0)
    half = s["burst"] // 2
    with QueryServer(registry, cfg, metrics=metrics, engine=engine, device=dev) as srv:
        first = [t.result(timeout=120) for t in [srv.submit(q) for q in queries[:half]]]
        registry.publish(v1.v, sigma_tilde=v1.sigma_tilde, step=v1.step,
                         lineage={"producer": "plan_calibrate_swap"})
        second = [t.result(timeout=120) for t in [srv.submit(q) for q in queries[half:]]]
    exact = all(np.array_equal(np.asarray(r.z), ref)
                for r, ref in zip(first + second, direct))
    serving = metrics.summary().get("serving", {})
    return {"value": round((serving.get("p99_latency_s") or 0.0) * 1e3, 3),
            "at_flush_ms": s["flush_ms"],
            "p50_latency_ms": round((serving.get("p50_latency_s") or 0.0) * 1e3, 3),
            "bit_exact_vs_direct": bool(exact), "shape": dict(s)}


def _coldstart_cfg(cache_dir):
    from distributed_eigenspaces_tpu_torch.config import PCAConfig

    c = COLDSTART
    return PCAConfig(
        dim=c["dim"], k=c["k"], num_workers=c["workers"], rows_per_worker=c["rows"],
        num_steps=c["steps"], solver="subspace", subspace_iters=8, warm_start_iters=2,
        pipeline_merge=True, backend="local", compile_cache_dir=cache_dir,
    )


def coldstart_child(cache_dir: str) -> int:
    """One child process over ``cache_dir``: the fit, then the time from
    ``QueryServer`` construction (prewarm on) to the first served result.
    A 2-step Cholesky loop on the card first pays the process's CUDA and
    solver start-up, which is no property of the compile cache (the
    reference child's warm-up rule)."""
    import torch

    from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
    from distributed_eigenspaces_tpu_torch.data.synthetic import planted_spectrum
    from distributed_eigenspaces_tpu_torch.serving import EigenbasisRegistry, QueryServer
    from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
        configure_persistent_cache,
    )
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    configure_persistent_cache(cache_dir)
    dev = torch.device("cuda")
    cfg = _coldstart_cfg(cache_dir)
    spec = planted_spectrum(cfg.dim, k_planted=cfg.k, gap=20.0, noise=0.01, seed=7)
    rows = cfg.num_steps * cfg.num_workers * cfg.rows_per_worker
    data = spec.sample(np.random.default_rng(5), rows)
    query = spec.sample(np.random.default_rng(6), 16).astype(np.float32)
    c = torch.eye(4, device=dev)
    for _ in range(2):
        c = torch.linalg.cholesky(c @ c.T + 4 * torch.eye(4, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = OnlineDistributedPCA(cfg, device=dev).fit(data)
    first_fit_s = time.perf_counter() - t0
    registry = EigenbasisRegistry(keep=cfg.serve_keep_versions)
    registry.publish_fit(est)
    metrics = MetricsLogger()
    t0 = time.perf_counter()
    with QueryServer(registry, cfg, metrics=metrics, prewarm=(len(query),),
                     device=dev) as srv:
        srv.wait_warm(timeout=300)
        srv.submit(query).result(timeout=300)
    first_serve_s = time.perf_counter() - t0
    batch = [r for r in metrics.serve_records if r["serve"] == "batch"][0]
    print(json.dumps({"first_fit_s": round(first_fit_s, 4),
                      "first_serve_s": round(first_serve_s, 4),
                      "prewarm_compile_misses": batch["compile_misses"],
                      "prewarm_compile_stall_ms": batch["compile_stall_ms"]}))
    return 0


def warm_first_serve_ms() -> dict:
    """One child fills a fresh cache directory, three more each read it warm;
    the median of the warm children's first-serve times."""
    base = tempfile.mkdtemp(prefix="det_plan_coldstart_")

    def child(cache_dir):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--coldstart-child", cache_dir],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"coldstart child failed (rc={r.returncode}):\n"
                               f"{r.stderr[-2000:]}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    warm_dir = os.path.join(base, "warm")
    seed = child(warm_dir)
    warm = [child(warm_dir) for _ in range(3)]
    serve_s = [w["first_serve_s"] for w in warm]
    return {"value": round(statistics.median(serve_s) * 1e3, 3),
            "warm_first_serve_s": serve_s, "seed_first_serve_s": seed["first_serve_s"],
            "warm_first_fit_s": [w["first_fit_s"] for w in warm],
            "prewarm_compile_misses": max(w["prewarm_compile_misses"] for w in warm),
            "prewarm_compile_stall_ms": max(w["prewarm_compile_stall_ms"] for w in warm),
            "shape": dict(COLDSTART)}


def fit_schedule_arms(dev) -> dict:
    """The (pipeline_merge x merge_interval) grid through ``evals.run_eval``
    (median of 3 + IQR + angle an arm); the 0.2 deg gate against (off, 1)."""
    from distributed_eigenspaces_tpu_torch.evals import run_eval

    g = GRID
    base = dict(dim=g["d"], k=g["k"], num_workers=g["m"], rows_per_worker=g["n"],
                subspace_iters=12, warm_start_iters=2, warm_orth_method="ns",
                compute_dtype="bfloat16", stage_dtype="int8")
    grid: dict = {}
    base_angle = None
    for pipe in (False, True):
        for s in INTERVALS:
            name = f"pipe={'on' if pipe else 'off'},s={s}"
            rep = run_eval("synthetic1024", device=dev, steps=g["steps"], repeats=3,
                           pipeline_merge=pipe, merge_interval=s, **base)
            timing = rep["timing"]
            angle = rep["principal_angle_deg"]
            if base_angle is None:  # the (off, 1) arm runs first
                base_angle = angle
            grid[name] = {
                "samples_per_sec": rep["samples_per_sec"],
                "iqr": timing["samples_per_sec_iqr"],
                "max_angle_deg": angle,
                # run_eval times a schedule of timed_steps (>= 240 on the
                # scan): one cold step among them, so the per-step time is
                # the warm step's to within 1/timed_steps
                "warm_ms_per_step": round(
                    timing["seconds_median"] / rep["timed_steps"] * 1e3, 4),
                "timed_steps": rep["timed_steps"],
                "angle_delta_vs_baseline_deg": round(angle - base_angle, 4),
                "gate_0p2deg_ok": bool(abs(angle - base_angle) <= 0.2),
            }
    b = grid["pipe=off,s=1"]["samples_per_sec"]
    arms = {}
    for name, row in grid.items():
        row["speedup_vs_baseline"] = round(row["samples_per_sec"] / b, 3)
        arms[name] = {"speedup": row["speedup_vs_baseline"],
                      "gate_0p2deg_ok": row["gate_0p2deg_ok"],
                      "warm_ms_per_step": row["warm_ms_per_step"]}
    return {"value": arms, "grid": grid, "workload": dict(g),
            "harness": "evals.run_eval('synthetic1024', ...) overrides"}


def measure_cheap(dev) -> dict:
    """The terms a smoke run re-measures (no cold processes)."""
    return {"serve_kernel_ms": serve_kernel_ms(dev),
            "serve_admit_p99_ms": serve_admit_p99_ms(dev),
            "serve_deadline_p99_ms": serve_deadline_p99_ms(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=RECORD, help="where the record goes")
    ap.add_argument("--coldstart-child", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.coldstart_child:
        return coldstart_child(args.coldstart_child)

    import torch

    from distributed_eigenspaces_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    rec = {"schema": "plan-calibration-v1", "card": card_line(),
           "device": {"kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()},
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "script": "scripts/torch_plan_calibrate.py"}
    rec.update(measure_cheap(dev))
    rec["warm_first_serve_ms"] = warm_first_serve_ms()
    rec["fit_schedule_arms"] = fit_schedule_arms(dev)
    rec["seconds"] = round(time.perf_counter() - t0, 1)
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(json.dumps(rec, indent=2, sort_keys=True) + "\n")
    ok = (rec["serve_admit_p99_ms"]["bit_exact_vs_direct"]
          and rec["serve_deadline_p99_ms"]["bit_exact_vs_direct"]
          and rec["warm_first_serve_ms"]["prewarm_compile_misses"] == 0)
    print(json.dumps(rec, sort_keys=True))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
