#!/usr/bin/env python3
"""Where the time of the PyTorch port's fits goes, on one card.

    python3 scripts/torch_profile_fit.py [--settings bf16|eval|clip768] [--trace PATH]

``--settings bf16`` (the default) and ``eval`` are ``chip_smoke.py``'s
CIFAR-10-shape fit phases: d=3072, k=10, m=8 workers x n=1024 rows, T=20
steps, subspace solver at 12 cold / 2 warm iterations, bf16 compute.
``bf16`` stages bf16 and orthonormalizes warm rounds by cholqr2, on
``planted_spectrum(3072, k_planted=10, seed=0)`` (``slice_fit``); ``eval``
is the cifar10 eval's own settings, int8 stage and
``warm_orth_method="ns"``, on ``planted_subspace(3072, k_planted=10,
gap=20, decay=0.8, noise=0.01, seed=0)`` (``slice_fit_eval``). Data is
drawn on the card. ``--settings clip768`` is the clip768 eval's
out-of-core route (``slice_clip768``): d=768, k=256, m=8, n=2048, T=10,
subspace 8 / 2 warm, bf16 compute, int8 rows written to a file under
``build/`` (4 distinct blocks of its planted subspace, one global scale)
and read back by ``bin_block_stream`` -> ``window_stream`` of 5 ->
``prefetch_stream`` (depth 1) -> ``make_segmented_fit(...).fit_windows``.
It prints one JSON line per phase:

1. ``steps``: host seconds of each of the T steps of ``make_train_step``
   on the blocks as the fit stages them (the cold step, then the warm
   ones), each ended by
   ``torch.cuda.synchronize()``, after one untimed pass over the same
   steps has paid every library's start-up.
2. ``profile``: one whole fit (``OnlineDistributedPCA.fit``, or for
   clip768 the segmented bin route) under ``torch.profiler``: its wall
   seconds, the device's busy seconds (the union of the intervals of every
   kernel and copy), the idle share, the device time of the busiest
   kernels by name, the count of kernel launches, copies and stream syncs,
   and the host time inside the ``det_worker_solve`` / ``det_merge``
   regions; for clip768 also the prefetch counters, among them
   ``wait_s``, the seconds the fit waited on the next window.

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
# the clip768 eval (distributed_eigenspaces_tpu/evals.py:121-126)
CLIP = dict(dim=768, k=256, num_workers=8, rows_per_worker=2048, num_steps=10,
            solver="subspace", subspace_iters=8, warm_start_iters=2,
            compute_dtype="bfloat16", backend="local")
CLIP_SEGMENT = 5
REGIONS = ("det_worker_solve", "det_merge", "det_mean_projector")


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


def clip768_file(dev, cfg) -> str:
    """The clip768 eval's int8 row file under ``build/``: 4 distinct blocks
    of ``planted_subspace(768, k_planted=256, gap=20, decay=max(0.8,
    0.05**(1/255)), noise=0.01, seed=0)``, one global scale, written
    cyclically over the T steps (as ``chip_smoke.py``'s ``slice_clip768``)."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.runtime.native import absmax_f32, quantize_i8

    spec = dett.planted_subspace(cfg.dim, k_planted=cfg.k, gap=20.0,
                                 decay=max(0.8, 0.05 ** (1 / (cfg.k - 1))), noise=0.01,
                                 seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = cfg.num_workers * cfg.rows_per_worker
    host = [spec.sample(gen, rows).cpu().numpy() for _ in range(4)]
    scale = 127.0 / max(max(absmax_f32(b) for b in host), 1e-30)
    steps = [quantize_i8(b, scale).tobytes() for b in host]
    out_dir = os.path.join(ROOT, "build", "profile_fit")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "clip768.i8")
    with open(path, "wb") as f:
        for t in range(cfg.num_steps):
            f.write(steps[t % 4])
    return path


def _clip768_blocks(path, cfg):
    import numpy as np
    import torch
    from distributed_eigenspaces_tpu_torch.data.bin_stream import bin_block_stream

    return bin_block_stream(path, dim=cfg.dim, num_workers=cfg.num_workers,
                            rows_per_worker=cfg.rows_per_worker, num_steps=cfg.num_steps,
                            dtype=np.int8, out_dtype=torch.int8)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--settings", choices=("bf16", "eval", "clip768"), default="bf16",
                    help="bf16 staging and cholqr2, the cifar10 eval's int8 stage and "
                         "ns, or the clip768 eval's segmented fit from an int8 file")
    ap.add_argument("--trace", help="write the profiler's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_fit: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.data.bin_stream import window_stream
    from distributed_eigenspaces_tpu_torch.data.stream import stage_blocks
    from distributed_eigenspaces_tpu_torch.runtime.prefetch import (
        PrefetchStats,
        prefetch_stream,
    )
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    stats = None
    if args.settings == "clip768":
        cfg = dett.PCAConfig(**CLIP)
        path = clip768_file(dev, cfg)
        blocks = torch.stack(list(_clip768_blocks(path, cfg))).to(dev)
        d, steps_t = cfg.dim, cfg.num_steps

        def whole_fit():
            nonlocal stats
            stats = PrefetchStats()
            windows = prefetch_stream(window_stream(_clip768_blocks(path, cfg), CLIP_SEGMENT),
                                      depth=1, stats=stats)
            try:
                return dett.make_segmented_fit(cfg, segment=CLIP_SEGMENT).fit_windows(
                    dett.SegmentState.initial(cfg.dim, cfg.k), windows)
            finally:
                windows.close()
    else:
        evals = args.settings == "eval"
        cfg = dett.PCAConfig(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
                             solver="subspace", subspace_iters=12, warm_start_iters=2,
                             compute_dtype="bfloat16",
                             stage_dtype="int8" if evals else None,
                             warm_orth_method="ns" if evals else None)
        if evals:
            spec = dett.planted_subspace(D, k_planted=K, gap=20.0, decay=0.8, noise=0.01,
                                         seed=0)
        else:
            spec = dett.planted_spectrum(D, k_planted=K, seed=0)
        data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * M * N)
        blocks = torch.stack(list(stage_blocks(data.reshape(T, M, N, D),
                                               cfg.resolved_stage_dtype())))
        d, steps_t = D, T

        def whole_fit():
            return dett.OnlineDistributedPCA(cfg).fit(data)

    # 1. per-step host times; the first pass is untimed start-up
    step = dett.make_train_step(cfg)
    for _ in range(2):
        state, v_prev, times = dett.OnlineState.initial(d), None, []
        gram_mod.launches = gram_mod.launches_s8 = 0
        for t in range(steps_t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, v_prev = step(state, blocks[t], v_prev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    emit("steps", cold_s=times[0], warm_median_s=statistics.median(times[1:]),
         warm_min_s=min(times[1:]), warm_max_s=max(times[1:]),
         total_s=sum(times), gram_launches=gram_mod.launches,
         s8_launches=gram_mod.launches_s8, settings=args.settings, card=card)
    del blocks

    # 2. one whole fit under the profiler
    whole_fit()  # start-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        whole_fit()
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
               for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                            "cudaMemcpyAsync", "cudaStreamSynchronize",
                            "cudaDeviceSynchronize")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    copies_s = sum(s for n, s in by_name.items() if n.startswith("Memcpy"))
    emit("profile", settings=args.settings, wall_s=wall_s, device_busy_s=busy_s,
         idle_share=1.0 - busy_s / wall_s, device_copies_s=copies_s,
         device_events=len(device), runtime_calls=runtime, regions_host_s=host,
         prefetch=None if stats is None else stats.as_dict(),
         top_device_s=[{"name": n[:120], "s": s} for n, s in top], card=card)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
