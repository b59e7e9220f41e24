#!/usr/bin/env python3
"""Where the time of the PyTorch port's read path goes, on one card.

    python3 scripts/torch_profile_serve.py [--trace PATH]

The workload is ``chip_smoke.py``'s serve burst: the planted top-10 basis
of ``planted_spectrum(3072, k_planted=10, seed=0)`` published to an
``EigenbasisRegistry``, and 64 queries of 1, 8 or 64 rows drawn from the
same spectrum (numpy, seed 1) submitted to a ``QueryServer`` at the default
bucket of 8 and flush of 0.02 s. For serve_dtype bfloat16 and int8, after
every bucket is warmed and one untimed burst, it prints one JSON line:

- ``spans``: from the engine's tracer, per request the queue wait and per
  batch the ``batch_compute`` time (host clock; the batch's projection,
  residual and copies back to the host), medians and maxima;
- ``profile``: one burst under ``torch.profiler``: wall seconds, the
  device's busy seconds (union of every kernel and copy interval), the idle
  share, the serve kernel's device seconds and its share of the busy time,
  the busiest device activities by name, and the count of kernel launches,
  copies and stream syncs.

``--trace`` also writes the last profiler Chrome trace there. The script
imports nothing of JAX or of the JAX package, needs a card, and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from torch_profile_fit import _union_seconds  # noqa: E402

D, K = 3072, 10
REGIONS = ("batch_compute",)
SERVE_KERNELS = ("serve_split_kernel",)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def burst(srv, queries):
    tickets = [srv.submit(q) for q in queries]
    return [t.result(timeout=300) for t in tickets]


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="write the profiler's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_serve: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.serving import EigenbasisRegistry, QueryServer
    from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    spec = dett.planted_spectrum(D, k_planted=K, seed=0)
    rng = np.random.default_rng(1)
    queries = [spec.sample(rng, int(r)) for r in rng.choice([1, 8, 64], size=64)]
    reg = EigenbasisRegistry()
    reg.publish(spec.top_k(K))
    cfg = dett.PCAConfig(dim=D, k=K)
    for serve_dtype in ("bfloat16", "int8"):
        with QueryServer(reg, dataclasses.replace(cfg, serve_dtype=serve_dtype)) as srv:
            eng = srv.engine
            v_dev = eng.place_basis(reg.latest())
            for b in (8, 16, 32, 64, 128, 256, 512):
                xz = torch.zeros((b, D), device=eng.device)
                eng.residual_energy(xz, eng.project(xz, v_dev))
            burst(srv, queries)  # start-up outside the windows
            eng.tracer = Tracer()
            burst(srv, queries)
            spans = eng.tracer.snapshot()
            qwait = [(s.t_end_mono - s.t_start_mono) * 1e3 for s in spans
                     if s.name == "queue_wait"]
            compute = [(s.t_end_mono - s.t_start_mono) * 1e3 for s in spans
                       if s.name == "batch_compute"]
            emit("spans", serve_dtype=serve_dtype, batches=len(compute),
                 batch_compute_ms_median=statistics.median(compute),
                 batch_compute_ms_max=max(compute), batch_compute_ms_sum=sum(compute),
                 queue_wait_ms_median=statistics.median(qwait),
                 queue_wait_ms_max=max(qwait), card=card)
            eng.tracer = Tracer()  # keeps the record_function regions on
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                burst(srv, queries)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
        events = prof.events()
        device = [e for e in events
                  if e.device_type == DeviceType.CUDA and e.name not in REGIONS]
        if not device:
            raise RuntimeError("the profiler recorded no device activity")
        busy_s = _union_seconds((e.time_range.start, e.time_range.end) for e in device)
        by_name: dict[str, float] = {}
        for e in device:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
        runtime = {name: sum(1 for e in events if e.name == name)
                   for name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cudaMemcpyAsync", "cudaStreamSynchronize")}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        kernel_s = sum(s for name, s in by_name.items()
                       if any(base in name for base in SERVE_KERNELS))
        emit("profile", serve_dtype=serve_dtype, wall_s=wall_s, device_busy_s=busy_s,
             idle_share=1.0 - busy_s / wall_s, serve_kernel_s=kernel_s,
             serve_kernel_share_of_device=kernel_s / busy_s, device_events=len(device),
             runtime_calls=runtime,
             top_device_s=[{"name": n[:120], "s": s} for n, s in top], card=card)
        if args.trace:
            os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
            prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
