#!/usr/bin/env python3
"""Where the time of the PyTorch port's CIFAR-10-shape fit goes, on one card.

    python3 scripts/torch_profile_fit.py [--trace PATH]

The configuration and data are those of ``chip_smoke.py``'s fit phase:
d=3072, k=10, m=8 workers x n=1024 rows, T=20 steps, subspace solver at
12 cold / 2 warm iterations, bf16 compute, on
``planted_spectrum(3072, k_planted=10, seed=0)`` drawn on the card. It
prints one JSON line per phase:

1. ``steps``: host seconds of each of the T steps of ``make_train_step``
   (the cold step, then the warm ones), each ended by
   ``torch.cuda.synchronize()``, after one untimed pass over the same
   steps has paid every library's start-up.
2. ``profile``: one whole ``OnlineDistributedPCA.fit`` under
   ``torch.profiler``: its wall seconds, the device's busy seconds (the
   union of the intervals of every kernel and copy), the idle share, the
   device time of the busiest kernels by name, the count of kernel
   launches, copies and stream syncs, and the host time inside the
   ``det_worker_solve`` / ``det_merge`` regions.

``--trace`` also writes the profiler's Chrome trace there. The script
imports nothing of JAX or of the JAX package, needs a card, and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, D, K, T = 8, 1024, 3072, 10, 20
REGIONS = ("det_worker_solve", "det_merge")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _union_seconds(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals (us) in s."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="write the profiler's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_fit: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = dett.PCAConfig(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
                         solver="subspace", subspace_iters=12, warm_start_iters=2,
                         compute_dtype="bfloat16")
    spec = dett.planted_spectrum(D, k_planted=K, seed=0)
    data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * M * N)
    blocks = data.to(torch.bfloat16).reshape(T, M, N, D)

    # 1. per-step host times; the first pass is untimed start-up
    step = dett.make_train_step(cfg)
    for _ in range(2):
        state, v_prev, times = dett.OnlineState.initial(D), None, []
        gram_mod.launches = 0
        for t in range(T):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, v_prev = step(state, blocks[t], v_prev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    emit("steps", cold_s=times[0], warm_median_s=statistics.median(times[1:]),
         warm_min_s=min(times[1:]), warm_max_s=max(times[1:]),
         total_s=sum(times), gram_launches=gram_mod.launches, card=card)

    # 2. one whole fit under the profiler
    dett.OnlineDistributedPCA(cfg).fit(data)  # start-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dett.OnlineDistributedPCA(cfg).fit(data)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    # the regions also appear on the device's timeline as annotations that
    # span their kernels; they are not device work of their own
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name not in REGIONS]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy_s = _union_seconds((e.time_range.start, e.time_range.end) for e in device)
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    host: dict[str, float] = {}
    for e in events:
        if e.name in REGIONS and e.device_type == DeviceType.CPU:
            host[e.name] = host.get(e.name, 0.0) + e.cpu_time_total * 1e-6
    runtime = {name: sum(1 for e in events if e.name == name)
               for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit("profile", wall_s=wall_s, device_busy_s=busy_s, idle_share=1.0 - busy_s / wall_s,
         device_events=len(device), runtime_calls=runtime, regions_host_s=host,
         top_device_s=[{"name": n[:120], "s": s} for n, s in top], card=card)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
