#!/usr/bin/env python3
"""How many kernels the merge's eigensolve launches, on one card: the
per-matrix loop ``torch.linalg.eigh`` runs above 32 x 32 against one
``cusolverDnXsyevBatched`` call (``ops/cusolver.py``), and where a solo fit
and a fleet fit spend their kernels.

    python3 scripts/torch_profile_eigh.py [--json PATH] [--no-fits]

1. ``eigh``: for each shape, ``torch.linalg.eigh`` and
   ``ops.cusolver.syev_batched`` on the same symmetric batch: kernels per
   call (``torch.profiler``, copies and memsets apart), device ms per call
   (the kernels' own time, 10 calls), the largest eigenvalue difference and
   the batched solver's largest residual ``|A V - V diag(w)|`` over the
   largest eigenvalue. Shapes: the mnist784 merge's (m k)^2 = 160^2 for one
   tenant and for 8, the workers' Rayleigh–Ritz 20^2 for 64, cifar10's
   80^2 for 8 and for one, clip768's Rayleigh–Ritz 256^2 for 8 workers, and
   the dense d^2 of a state's extraction at d = 768, 784 (one, and 8
   tenants) and 3072.
2. ``fits``: one solo scan fit and one 8-tenant fleet program at the
   mnist784 eval's settings on random blocks already on the card: kernels
   in all, and those of the eigensolvers (names with ``syev``, ``rotate``,
   ``offA``, ``laed``, ``lansy`` or ``sortsign``); first with the port's
   ``ops.cusolver.eigh``, then with ``torch.linalg.eigh`` in its place.

The card's name and power limit come first. It imports nothing of JAX or
of the JAX package, needs a card, and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

SHAPES = ((1, 160, 160), (8, 160, 160), (64, 20, 20), (8, 80, 80), (1, 80, 80),
          (8, 256, 256), (1, 768, 768), (1, 784, 784), (8, 784, 784), (1, 3072, 3072))
EIGH_MARKS = ("syev", "rotate", "offA", "laed", "lansy", "sortsign")


def kernel_events(fn, reps: int = 1):
    """The kernel events (copies, memsets and ``det_*`` regions apart) of
    ``reps`` calls of ``fn``, after one untimed call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset", "det_"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write every line to this file")
    ap.add_argument("--no-fits", action="store_true", help="the eigensolver shapes only")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_eigh: needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import cusolver
    from distributed_eigenspaces_tpu_torch.ops.cusolver import syev_batched
    from distributed_eigenspaces_tpu_torch.parallel import fleet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    lines = []

    def emit(**kw):
        lines.append(dict(kw, card=card))
        print(json.dumps(lines[-1]), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in SHAPES:
        x = torch.randn(shape, generator=gen, device=dev)
        a = x @ x.mT / shape[-1]
        out = {}
        for name, fn in (("torch.linalg.eigh", torch.linalg.eigh), ("syev_batched", syev_batched)):
            one = kernel_events(lambda: fn(a))
            ten = kernel_events(lambda: fn(a), reps=10)
            out[name] = dict(
                kernels=len(one),
                device_ms=sum(e.time_range.end - e.time_range.start for e in ten) / 10 * 1e-3,
                top=collections.Counter(e.name[:60] for e in one).most_common(3))
        w_t = torch.linalg.eigh(a)[0]
        w_b, v_b = syev_batched(a)
        scale = float(w_t.abs().max())
        resid = float((a @ v_b - v_b * w_b[:, None, :]).abs().max()) / scale
        emit(phase="eigh", shape=list(shape), max_eigenvalue_diff=float((w_t - w_b).abs().max()),
             syev_residual_rel=resid,
             **{k.replace(".", "_"): v for k, v in out.items()})

    if args.no_fits:
        write_json(args, lines)
        return 0
    cfg = dett.PCAConfig(dim=784, k=20, num_workers=8, rows_per_worker=1024, num_steps=20,
                         solver="subspace", subspace_iters=16, warm_start_iters=2,
                         compute_dtype="bfloat16", warm_orth_method="ns", backend="local")
    b = 8
    xs = torch.randn((b, 20, 8, 1024, 784), generator=gen, device=dev)
    actives = np.ones((b, 20), np.float32)
    fit = fleet.make_fleet_fit(cfg)
    solo = dett.make_scan_fit(cfg)
    for eigh in ("ops.cusolver.eigh", "torch.linalg.eigh"):
        if eigh == "torch.linalg.eigh":
            cusolver.eigh = torch.linalg.eigh
        for name, fn in (
                ("solo scan fit", lambda: solo(dett.OnlineState.initial(784, device=dev), xs[0])),
                (f"fleet program, {b} tenants",
                 lambda: fit(fleet.init_fleet_states(cfg, b), xs, actives))):
            events = kernel_events(fn)
            eig = [e for e in events if any(m in e.name for m in EIGH_MARKS)]
            emit(phase="fits", fit=name, eigh=eigh, kernels=len(events),
                 eigensolver_kernels=len(eig),
                 device_ms=sum(e.time_range.end - e.time_range.start for e in events) * 1e-3)
    write_json(args, lines)
    return 0


def write_json(args, lines) -> None:
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    sys.exit(main())
