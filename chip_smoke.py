#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

1. env: versions, the card (``nvidia-smi``), and the fp32 matmul
   precision (no TF32), which the port relies on but never sets.
2. build, build_serve, build_matvec_gram: ``csrc/gram.cu``,
   ``csrc/serve_project.cu`` and ``csrc/matvec_gram.cu`` compiled with nvcc
   for sm_90a, one process each, started together (seconds, ptxas
   register / spill lines).
3. parity: the Gram kernel against its plain PyTorch version on the card,
   fp32 and bf16, at the entry shape (4, 128, 256), the CIFAR-10 shape
   (8, 1024, 3072) and a ragged (3, 1000, 3000).
4. timing: kernel, plain version, ``torch.bmm`` yardstick and the bound,
   with CUDA events (median of 25 after warm-up).
5. slice: ``entry()``'s step 10 times (10 Gram launches), checked against
   the same step on the CPU; then ``OnlineDistributedPCA`` at the
   CIFAR-10 shape (d=3072, k=10, m=8, n=1024, T=20, subspace 12 / warm 2,
   bf16) on planted-spectrum data, which must recover the planted top-10
   within 1 degree with exactly one Gram launch (the cold step).
6. parity_serve: the serve kernels (bf16, int8 and the fixed-order fp32
   one) against their plain versions at (64, 256, 8), the CIFAR-10 serve
   shape (512, 3072, 10) and a ragged (1000, 3000, 10), fp32 x (and bf16
   x at the serve shape, but for the fp32 kernel, which takes fp32 x
   only); relative Frobenius error <= 1e-5, and the first 300 rows of a
   512-row launch equal, bit for bit, a 300-row launch of the same rows.
7. timing_serve: kernels, plain versions, ``torch.matmul`` on the fp32
   operands (and ``torch.mm(..., out_dtype=float32)`` on bf16 ones where
   this torch has it) and the bound at (512, 3072, 10) and
   (65536, 3072, 10).
8. slice_serve: the read path on the fit of 5b. The basis is published
   to an ``EigenbasisRegistry``; for serve_dtype bfloat16 and int8 a
   ``QueryServer`` (its self-check passes at construction) answers 64
   queries of 1, 8 or 64 planted-spectrum rows at the default bucket of
   8 and flush of 0.02 s, with the same basis republished halfway (a hot
   swap). Every served row must lie within 0.2 degrees of
   ``est.transform`` (fp32), both versions must be served, the swap must
   acquire no bucket, and each serve kernel must launch once per
   ``project`` dispatch. Then one bulk ``project`` of 50,000 rows per
   quantized dtype, and a float32 server on the same burst, whose
   served rows must equal ``est.transform``'s bit for bit (both take the
   fixed-order fp32 kernel, once per dispatch).
9. parity_matvec_gram: the fused matvec + Gram kernel of the large-d
   solver against its plain version at (256, 64, 16), the slice shape
   (12288, 200, 58) and a ragged (3000, 80, 13): relative Frobenius error
   <= 1e-5 on ``w`` and ``g``, ``g`` exactly symmetric, two launches bit
   for bit the same.
10. timing_matvec_gram: kernel, plain version, the ``torch.matmul``
   yardstick and the bound at the slice shape.
11. slice_dsolve: ``OnlineDistributedPCA`` with ``solver="distributed"``
   above the crossover at the ImageNet-patch shape (d=12288, k=50, m=4,
   n=2048, T=10, 16 cold / 1 warm iterations, bf16) on planted-spectrum
   data (decay 0.97), which must recover the planted top-50 within 1
   degree; then the fused solve on the fit's own operator (the last
   block's worker factors), which must agree with
   ``merged_top_k_distributed`` within 0.05 degrees in exactly 16 kernel
   launches (and, with ``tol=1e-6``, in as many launches as iterations);
   then ``dist_extract_top_k`` against a dense ``eigh`` at d=12288, r=100
   within 0.5 degrees.

Then the kernel table as one JSON line and, last, the result line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet), used for bound_ms
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-5, "bfloat16": 1e-4}
CIFAR = (8, 1024, 3072)
ENTRY = (4, 128, 256)
RAGGED = (3, 1000, 3000)
GRAM_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/gram.cu"
GRAM_REPLACES = "distributed_eigenspaces_tpu/ops/pallas_gram.py:57"
SERVE_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/serve_project.cu"
SERVE_REPLACES = {
    "bf16": "distributed_eigenspaces_tpu/ops/pallas_gram.py:184",
    "i8": "distributed_eigenspaces_tpu/ops/pallas_gram.py:232",
}
SERVE_TOL = 1e-5
SERVE_K = 10
SERVE_BURST = (512, 3072, SERVE_K)  # a full bucket: 8 queries x 64 rows
SERVE_BULK = (65536, 3072, SERVE_K)  # 50,000 rows padded to their bucket
SERVE_PARITY = ((64, 256, 8), SERVE_BURST, (1000, 3000, SERVE_K))
SERVE_F32_NOTE = ("no TPU kernel: the JAX package's fp32 projection is XLA at "
                  "Precision.HIGHEST (distributed_eigenspaces_tpu/serving/"
                  "transform.py:523); the port's fixed-order fp32 route")
MG_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/matvec_gram.cu"
MG_REPLACES = "distributed_eigenspaces_tpu/ops/pallas_gram.py:337"
MG_TOL = 1e-5
MG_SLICE = (12288, 200, 58)  # C (d, m*k) and the oversampled iterate at k=50
MG_PARITY = ((256, 64, 16), MG_SLICE, (3000, 80, 13))
DSOLVE = dict(dim=12288, k=50, num_workers=4, rows_per_worker=2048, num_steps=10)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    return float(((got - want).norm() / want.norm()).item())


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gram_bound(shape, dtype: str) -> tuple[float, str]:
    """Least time for the Gram of ``shape``: the input read once, the fp32
    output written once, and the m*n*d*(d+1) FLOP of the distinct output
    entries (the kernel computes the upper triangle and mirrors it)."""
    m, n, d = shape
    item = 4 if dtype == "float32" else 2
    bytes_s = (m * n * d * item + m * d * d * 4) / PEAK_BYTES_S
    ops_s = m * n * d * (d + 1) / PEAK_FLOPS[dtype]
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def serve_bound(shape, route: str) -> tuple[float, str]:
    """Least time for one serve projection of ``shape``: fp32 x read once,
    the basis read once (fp32, or int8 plus its k fp32 scales) and the
    fp32 z written once, against 2*rows*d*k bf16 products (fp32 ones for
    the fp32 route)."""
    rows, d, k = shape
    basis = d * k + 4 * k if route == "i8" else d * k * 4
    bytes_s = (rows * d * 4 + basis + rows * k * 4) / PEAK_BYTES_S
    ops_s = 2 * rows * d * k / PEAK_FLOPS["float32" if route == "f32" else "bfloat16"]
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def serve_operands(shape, dev, seed: int):
    """fp32 x (rows, d) and an orthonormal fp32 basis (d, k) on the card."""
    import torch

    rows, d, k = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, d), generator=gen, device=dev)
    v = torch.linalg.qr(torch.randn((d, k), generator=gen, device=dev))[0]
    return x, v.contiguous()


def serve_routes(sp, v, x_dtype="float32"):
    """Per serve kernel: its wrapper and its plain version on basis ``v``
    (the fp32 kernel only for fp32 x, the only x it takes)."""
    q, s = sp.quantize_basis_i8(v)
    routes = (
        ("bf16", lambda a: sp.serve_project_cuda(a, v),
         lambda a: sp.serve_project_plain(a, v), "launches"),
        ("i8", lambda a: sp.serve_project_i8_cuda(a, q, s),
         lambda a: sp.serve_project_i8_plain(a, q, s), "launches_i8"),
        ("f32", lambda a: sp.serve_project_f32_cuda(a, v),
         lambda a: sp.serve_project_f32_plain(a, v), "launches_f32"),
    )
    return routes if x_dtype == "float32" else routes[:2]


def parity_serve(dev) -> dict:
    """Both serve kernels against their plain versions; returns each
    kernel's largest absolute error over the cases."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    worst = {"bf16": 0.0, "i8": 0.0, "f32": 0.0}
    cases = [(shape, "float32") for shape in SERVE_PARITY] + [(SERVE_BURST, "bfloat16")]
    for seed, (shape, x_dtype) in enumerate(cases):
        x, v = serve_operands(shape, dev, seed)
        x = x.to(getattr(torch, x_dtype))
        for route, run, plain, counter in serve_routes(sp, v, x_dtype):
            before = getattr(sp, counter)
            got = run(x)
            torch.cuda.synchronize()
            check(getattr(sp, counter) == before + 1, f"{route}: launch counter did not move")
            want = plain(x)
            rel = rel_err(got, want)
            err = float((got - want).abs().max().item())
            padded = True
            if shape == SERVE_BURST:
                padded = bool(torch.equal(run(x[:300]), got[:300]))
            worst[route] = max(worst[route], err)
            emit("parity_serve", kernel=route, shape=list(shape), x_dtype=x_dtype,
                 rel_frobenius=rel, max_abs_err=err, tol=SERVE_TOL,
                 first_300_rows_bit_equal=padded)
            check(rel <= SERVE_TOL, f"serve {route} {shape} {x_dtype}: {rel} > {SERVE_TOL}")
            check(padded, f"serve {route}: 300 rows alone differ from a 512-row launch")
        del x, v
    return worst


def mm_bf16_out_fp32(a, b):
    """``torch.mm(a, b, out_dtype=torch.float32)``, or the reason this
    torch cannot run it (a yardstick only: the port never calls it)."""
    import torch

    try:
        return torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        return repr(e)[:200]


def timing_serve(dev, card: str) -> dict:
    """Kernel, plain, library times and the bound at the burst and bulk
    shapes (CUDA events, median of 25 after warm-up)."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    out = {}
    for shape in (SERVE_BURST, SERVE_BULK):
        x, v = serve_operands(shape, dev, seed=7)
        library_ms = time_ms(lambda: torch.matmul(x, v))
        xb, vb = x.to(torch.bfloat16), v.to(torch.bfloat16)
        probe = mm_bf16_out_fp32(xb, vb)
        if isinstance(probe, str):
            mm_ms, mm_note = None, probe
        else:
            mm_ms, mm_note = time_ms(lambda: mm_bf16_out_fp32(xb, vb)), None
        del xb, vb, probe
        for route, run, plain, _ in serve_routes(sp, v):
            ms = time_ms(lambda: run(x))
            plain_ms = time_ms(lambda: plain(x))
            bound_ms, bound_by = serve_bound(shape, route)
            out[(shape, route)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
            emit("timing_serve", kernel=route, shape=list(shape), kernel_ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 library="torch.matmul(x, v), fp32 operands",
                 mm_bf16_out_fp32_ms=mm_ms, mm_bf16_note=mm_note,
                 bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
                 card=card)
        del x, v
    return out


def row_angles_deg(z, ref):
    """Per-row angle in degrees between two (rows, k) projections (float64)."""
    import torch

    z, ref = torch.as_tensor(z).double(), torch.as_tensor(ref).double()
    cos = (z * ref).sum(1) / (z.norm(dim=1) * ref.norm(dim=1))
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def request_latencies_ms(tracer) -> list[float]:
    """Per request: admit start to dispatch end, from the engine's spans."""
    start, end = {}, {}
    for sp in tracer.snapshot():
        if sp.name == "admit":
            start[sp.trace_id] = sp.t_start_mono
        elif sp.name == "dispatch":
            end[sp.trace_id] = sp.t_end_mono
    return sorted((end[t] - start[t]) * 1e3 for t in start if t in end)


def slice_serve(est, spec, cfg, card: str) -> dict:
    """The read path end to end on the fit ``est``; returns each serve
    kernel's launches in its server's run (burst, and bulk for the
    quantized kernels)."""
    import dataclasses

    import numpy as np
    import torch
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from distributed_eigenspaces_tpu_torch.serving import (
        EigenbasisRegistry,
        QueryServer,
    )
    from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer

    rng = np.random.default_rng(1)
    queries = [spec.sample(rng, int(r)) for r in rng.choice([1, 8, 64], size=64)]
    direct = [est.transform(q).cpu() for q in queries]
    rows_total = sum(q.shape[0] for q in queries)
    reg = EigenbasisRegistry(keep=4)
    v1 = reg.publish_fit(est)
    bulk = spec.sample(torch.Generator(device=est.device).manual_seed(2), 50_000)
    bulk_direct = est.transform(bulk)
    launched = {}
    for serve_dtype, route in (("bfloat16", "bf16"), ("int8", "i8"), ("float32", "f32")):
        t0 = time.perf_counter()
        with QueryServer(reg, dataclasses.replace(cfg, serve_dtype=serve_dtype)) as srv:
            construct_s = time.perf_counter() - t0
            eng = srv.engine
            self_check_deg = eng.self_check()
            # every bucket a burst can pad to, both operations
            v_dev = eng.place_basis(reg.latest())
            for b in (8, 16, 32, 64, 128, 256, 512):
                xz = torch.zeros((b, eng.d), device=eng.device)
                eng.residual_energy(xz, eng.project(xz, v_dev))
            torch.cuda.synchronize()
            acquired = eng.compile_misses
            dispatches = [0]
            project = eng.project

            def counted(x, v, project=project, dispatches=dispatches):
                dispatches[0] += 1
                return project(x, v)

            eng.project = counted
            eng.tracer = Tracer()
            sp.launches = sp.launches_i8 = sp.launches_f32 = 0
            t_burst = time.perf_counter()
            served = []
            for half in (queries[:32], queries[32:]):
                if served:  # halfway: the same basis as a new version
                    reg.publish(v1.v, sigma_tilde=v1.sigma_tilde, step=v1.step,
                                lineage={**v1.lineage, "republished": True})
                tickets = [srv.submit(q) for q in half]
                served += [t.result(timeout=300) for t in tickets]
            burst_s = time.perf_counter() - t_burst
            swap_acquired = eng.compile_misses - acquired
            versions = sorted({r.version for r in served})
            angles = torch.cat([row_angles_deg(r.z, ref) for r, ref in zip(served, direct)])
            lat = request_latencies_ms(eng.tracer)
            stats = dict(
                serve_dtype=serve_dtype, construct_s=construct_s,
                self_check_deg=self_check_deg, queries=len(served), rows=rows_total,
                versions=versions, swaps=srv.swap_count,
                swap_acquisitions=swap_acquired, batches=dispatches[0],
                latency_p50_ms=statistics.median(lat),
                latency_p99_ms=float(np.percentile(lat, 99)),
                rows_per_s=rows_total / burst_s, burst_s=burst_s,
                max_angle_deg=float(angles.max()), card=card,
            )
            if route == "f32":
                exact = all(np.array_equal(r.z, ref.numpy()) for r, ref in zip(served, direct))
                diff = max(float(np.abs(r.z - ref.numpy()).max()) for r, ref in zip(served, direct))
                launched[route] = sp.launches_f32
                emit("slice_serve", served_vs_direct_bit_exact=exact,
                     served_vs_direct_max_abs_err=diff, launches=launched[route],
                     project_dispatches=dispatches[0], **stats)
                check(exact, f"float32 served z differs from est.transform by {diff}")
                check(launched[route] == dispatches[0],
                      f"float32: {launched[route]} launches for {dispatches[0]} dispatches")
            else:
                t0 = time.perf_counter()
                z_bulk = eng.project(bulk, v_dev)
                torch.cuda.synchronize()
                bulk_s = time.perf_counter() - t0
                bulk_angle = float(row_angles_deg(z_bulk, bulk_direct).max())
                launched[route] = getattr(sp, "launches" if route == "bf16" else "launches_i8")
                emit("slice_serve", launches=launched[route], project_dispatches=dispatches[0],
                     bulk_rows=bulk.shape[0], bulk_s=bulk_s, bulk_max_angle_deg=bulk_angle,
                     **stats)
                check(bulk_angle <= 0.2, f"{serve_dtype}: bulk row at {bulk_angle} deg > 0.2")
                check(launched[route] == dispatches[0],
                      f"{serve_dtype}: {launched[route]} launches for {dispatches[0]} dispatches")
            check(stats["max_angle_deg"] <= 0.2,
                  f"{serve_dtype}: served row at {stats['max_angle_deg']} deg > 0.2")
            check(len(versions) == 2, f"{serve_dtype}: versions served {versions}")
            check(swap_acquired == 0, f"{serve_dtype}: the swap acquired {swap_acquired} buckets")
    return launched


def matvec_gram_bound(shape) -> tuple[float, str]:
    """Least time for one fused sweep: C read twice (pass 0 and pass 1), v
    read once and w written once; 4*d*f*k + 2*d*k*k fp32 FLOP (the two
    products and the Gram)."""
    d, f, k = shape
    bytes_s = (2 * d * f + 2 * d * k + k * k) * 4 / PEAK_BYTES_S
    ops_s = (4 * d * f * k + 2 * d * k * k) / PEAK_FLOPS["float32"]
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def mg_operands(shape, dev, seed: int):
    """``C (d, f)`` and ``v (d, k)`` at the merge's scale: C's columns
    orthonormal times 0.5 (four workers' factors at weight 1/4), v an
    orthonormal block."""
    import torch

    d, f, k = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = torch.linalg.qr(torch.randn((d, f), generator=gen, device=dev))[0]
    v = torch.linalg.qr(torch.randn((d, k), generator=gen, device=dev))[0]
    return (0.5 * c).contiguous(), v.contiguous()


def parity_matvec_gram(dev) -> float:
    """The fused kernel against its plain version; returns the largest
    absolute error on ``w`` or ``g`` over the cases."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg

    worst = 0.0
    for seed, shape in enumerate(MG_PARITY):
        c, v = mg_operands(shape, dev, seed)
        before = mg.launches
        w, g = mg.matvec_gram_cuda(c, v)
        torch.cuda.synchronize()
        check(mg.launches == before + 1, "matvec_gram: launch counter did not move")
        pw, pg = mg.matvec_gram_plain(c, v)
        rel_w, rel_g = rel_err(w, pw), rel_err(g, pg)
        err = max(float((w - pw).abs().max()), float((g - pg).abs().max()))
        w2, g2 = mg.matvec_gram_cuda(c, v)
        repeat = bool(torch.equal(w, w2) and torch.equal(g, g2))
        symmetric = bool(torch.equal(g, g.mT))
        worst = max(worst, err)
        emit("parity_matvec_gram", shape=list(shape), rel_frobenius_w=rel_w,
             rel_frobenius_g=rel_g, max_abs_err=err, tol=MG_TOL,
             g_symmetric=symmetric, repeat_bit_identical=repeat)
        check(rel_w <= MG_TOL and rel_g <= MG_TOL,
              f"matvec_gram {shape}: w {rel_w}, g {rel_g} > {MG_TOL}")
        check(symmetric, f"matvec_gram {shape}: g is not symmetric")
        check(repeat, f"matvec_gram {shape}: two launches differ")
    return worst


def timing_matvec_gram(dev, card: str) -> dict:
    """Kernel, plain, library and bound at the slice shape (CUDA events,
    median of 25 after warm-up)."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg

    c, v = mg_operands(MG_SLICE, dev, seed=11)

    def library():
        w = torch.matmul(c, torch.matmul(c.T, v))
        return w, w.T @ w

    ms = time_ms(lambda: mg.matvec_gram_cuda(c, v))
    plain_ms = time_ms(lambda: mg.matvec_gram_plain(c, v))
    library_ms = time_ms(library)
    bound_ms, bound_by = matvec_gram_bound(MG_SLICE)
    emit("timing_matvec_gram", shape=list(MG_SLICE), kernel_ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, library="torch.matmul(C, torch.matmul(C.T, v)) + w.T @ w",
         bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms, card=card)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def synced_s(fn):
    """``(result, seconds)`` of ``fn()`` on the host clock, ending in a
    device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def slice_dsolve(dev, card: str) -> int:
    """The large-d solver path: the crossover fit, the fused solve on its
    own operator, and the factor extract against a dense eigh; returns
    the kernel's launches in the fused solve."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.algo.step import make_solve_core, merge_start
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.solvers import distributed as sd

    d, k, m, n, T = (DSOLVE[f] for f in ("dim", "k", "num_workers",
                                          "rows_per_worker", "num_steps"))
    cfg = dett.PCAConfig(**DSOLVE, solver="distributed", subspace_iters=16,
                         warm_start_iters=1, compute_dtype="bfloat16", backend="local")
    check(cfg.uses_distributed_solve(), "dsolve: the crossover merge is off")
    # the planted basis is numpy's QR of a 12288^2 matrix on the host
    t0 = time.perf_counter()
    spec = dett.planted_spectrum(d, k_planted=k, decay=0.97, seed=0)
    data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    truth = torch.as_tensor(spec.top_k(k))

    # 1. the fit; its merges take the unfused factor operator, as the reference's
    est = dett.OnlineDistributedPCA(cfg, device=dev)
    gram_mod.launches = mg.launches = 0
    _, fit_s = synced_s(lambda: est.fit(data))
    fit_launches = (gram_mod.launches, mg.launches)
    w = est.components_
    check(w.shape == (d, k) and bool(torch.isfinite(w).all()), "dsolve fit: components_")
    angle = float(principal_angles_degrees(w.cpu(), truth).max())
    _, fit2_s = synced_s(lambda: dett.OnlineDistributedPCA(cfg, device=dev).fit(data))
    samples = T * m * n
    emit("slice_dsolve", part="fit",
         config="imagenet-patch shape planted (decay 0.97), d=12288 k=50 m=4 n=2048 "
                "T=10 solver=distributed 16 cold / 1 warm bf16",
         trainer=est.trainer_used_, max_angle_deg=angle, data_s=data_s, fit_s=fit_s,
         samples_per_s=samples / fit_s, second_fit_s=fit2_s,
         second_samples_per_s=samples / fit2_s,
         gram_launches=fit_launches[0], matvec_gram_launches=fit_launches[1], card=card)
    check(angle <= 1.0, f"dsolve fit angle {angle} > 1 degree")

    # 2. the fused solve on the fit's own operator: the last block's factors
    x_last = data[-m * n:].reshape(m, n, d)
    vs = make_solve_core(cfg)(x_last, est.v0)
    cc = sd._scaled_factor_concat(vs, torch.ones((m,), device=dev))
    kk = k + sd._default_oversample(k, cc.shape[1])
    v_init = merge_start(cfg, device=dev)
    check(tuple(v_init.shape) == (d, kk), f"dsolve: merge start {tuple(v_init.shape)}")
    ref, unfused_s = synced_s(lambda: sd.merged_top_k_distributed(
        vs, k, iters=16, v_init=v_init))

    def fused(**kw):
        return sd.dist_subspace_eig(
            sd.factor_matvec(cc), d, k, iters=16, oversample=kk - k, v_init=v_init,
            matvec_gram=sd.fused_factor_matvec(cc), **kw)

    fused()  # warm-up (cuSOLVER handles)
    mg.launches = 0
    v_fused, fused_s = synced_s(fused)
    launches = mg.launches
    agree = float(principal_angles_degrees(v_fused.cpu(), ref.cpu()).max())
    mg.launches = 0
    (v_tol, info), _ = synced_s(lambda: fused(tol=1e-6, with_info=True))
    tol_launches = mg.launches
    emit("slice_dsolve", part="fused_solve", operator=[d, cc.shape[1]], block=kk,
         launches=launches, fused_vs_merged_deg=agree, fused_solve_s=fused_s,
         unfused_merge_s=unfused_s, tol_iters_used=info["iters_used"],
         tol_residual=info["residual"], tol_launches=tol_launches,
         fused_vs_truth_deg=float(principal_angles_degrees(v_fused.cpu(), truth).max()),
         card=card)
    check(launches == 16, f"dsolve: {launches} matvec_gram launches, want 16")
    check(agree <= 0.05, f"dsolve: fused solve {agree} deg from merged_top_k_distributed")
    check(tol_launches == info["iters_used"],
          f"dsolve: {tol_launches} launches for {info['iters_used']} iterations")
    del data, x_last, vs, cc, est

    # 3. the factor extract against a dense eigh of U diag(s) U^T
    r = 100
    gen = torch.Generator(device=dev).manual_seed(3)
    u = torch.linalg.qr(torch.randn((d, r), generator=gen, device=dev,
                                    dtype=torch.float64))[0].float()
    s_vec = torch.linspace(8.0, 1.0, r, device=dev)
    v_ex, extract_s = synced_s(lambda: sd.dist_extract_top_k(u, s_vec, k, iters=16))

    def dense():
        return torch.linalg.eigh((u * s_vec) @ u.T)[1][:, -k:].flip(-1)

    v_dense, eigh_s = synced_s(dense)
    extract_deg = float(principal_angles_degrees(v_ex.cpu(), v_dense.cpu()).max())
    emit("slice_dsolve", part="extract", d=d, r=r, k=k, extract_vs_eigh_deg=extract_deg,
         extract_s=extract_s, dense_eigh_s=eigh_s, card=card)
    check(extract_deg <= 0.5, f"dsolve extract {extract_deg} deg from the dense eigh")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import _build
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    dev = torch.device("cuda")

    # 1. env
    card = card_line()
    print(card, flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    check(torch.get_float32_matmul_precision() == "highest",
          "fp32 matmul precision is not 'highest'")
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], card=card,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # 2. build, every source at once
    t0 = time.perf_counter()
    _build.build_all(["gram", "serve_project", "matvec_gram"])
    for name in ("gram", "serve_project", "matvec_gram"):
        _build.load(name)
    seconds = time.perf_counter() - t0
    for phase, name, source in (("build", "gram", GRAM_SOURCE),
                                ("build_serve", "serve_project", SERVE_SOURCE),
                                ("build_matvec_gram", "matvec_gram", MG_SOURCE)):
        info = _build.build_info[name]
        emit(phase, source=source, seconds=seconds, nvcc_seconds=info["seconds"],
             ptxas=[ln.strip() for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln])

    # 3. parity on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = {}
    for shape in (ENTRY, CIFAR, RAGGED):
        for dtype in ("float32", "bfloat16"):
            x = torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
            before = gram_mod.launches
            got = gram_mod.gram_cuda(x)
            torch.cuda.synchronize()
            check(gram_mod.launches == before + 1, "launch counter did not move")
            want = gram_mod.gram_plain(x)
            rel = rel_err(got, want)
            err = float((got - want).abs().max().item())
            max_abs[(shape, dtype)] = err
            emit("parity", shape=list(shape), dtype=dtype, rel_frobenius=rel,
                 max_abs_err=err, tol=TOL[dtype],
                 symmetric=bool(torch.equal(got, got.mT)))
            check(rel <= TOL[dtype], f"gram {shape} {dtype}: {rel} > {TOL[dtype]}")
            check(torch.equal(got, got.mT), f"gram {shape} {dtype} is not symmetric")
            del x, got, want

    # 4. timing
    timing = {}
    for shape, dtype in ((CIFAR, "bfloat16"), (CIFAR, "float32"), (ENTRY, "float32")):
        x = torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
        ms = time_ms(lambda: gram_mod.gram_cuda(x))
        plain_ms = time_ms(lambda: gram_mod.gram_plain(x))
        library_ms = time_ms(lambda: torch.bmm(x.mT, x))
        bound_ms, bound_by = gram_bound(shape, dtype)
        timing[(shape, dtype)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
        emit("timing", shape=list(shape), dtype=dtype, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
             bound_by=bound_by, roofline_share=bound_ms / ms, card=card)
        del x

    # 5a. the flagship step, 10 rounds, against the same step on the CPU
    step, (state, x) = dett.entry()
    gram_mod.launches = 0
    for _ in range(10):
        state, v_bar = step(state, x)
    torch.cuda.synchronize()
    entry_launches = gram_mod.launches
    check(entry_launches == 10, f"entry: {entry_launches} Gram launches, want 10")
    check(state.step == 10 and bool(torch.isfinite(state.sigma_tilde).all()),
          "entry: state after 10 steps")
    cpu_step, (cpu_state, cpu_x) = dett.entry(device="cpu")
    cpu_state, cpu_v = cpu_step(cpu_state, cpu_x)
    gpu_state, gpu_v = step(dett.OnlineState.initial(256), x)
    sigma_err = float((gpu_state.sigma_tilde.cpu() - cpu_state.sigma_tilde).abs().max())
    v_angle = float(principal_angles_degrees(gpu_v.cpu(), cpu_v).max())
    emit("slice_entry", steps=10, gram_launches=entry_launches,
         sigma_vs_cpu_max_abs=sigma_err, v_bar_vs_cpu_deg=v_angle)
    check(sigma_err <= 1e-4 and v_angle <= 0.05, "entry: card and CPU steps disagree")

    # 5b. the CIFAR-10-shape fit on planted-spectrum data
    m, n, d = CIFAR
    k, T = 10, 20
    cfg = dett.PCAConfig(dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=T,
                         solver="subspace", subspace_iters=12, warm_start_iters=2,
                         compute_dtype="bfloat16")
    t0 = time.perf_counter()
    spec = dett.planted_spectrum(d, k_planted=k, seed=0)
    data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    est = dett.OnlineDistributedPCA(cfg)
    gram_mod.launches = 0
    t0 = time.perf_counter()
    est.fit(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = gram_mod.launches
    check(fit_launches == 1, f"fit: {fit_launches} Gram launches, want 1")
    w = est.components_
    truth = torch.as_tensor(spec.top_k(k))
    angle = float(principal_angles_degrees(w.cpu(), truth).max())
    check(w.shape == (d, k) and bool(torch.isfinite(w).all()), "fit: components_")
    # a second fit, after the first has paid every library's start-up
    t0 = time.perf_counter()
    dett.OnlineDistributedPCA(cfg).fit(data)
    torch.cuda.synchronize()
    fit2_s = time.perf_counter() - t0
    samples = T * m * n
    emit("slice_fit", config="cifar10-shape planted, d=3072 k=10 m=8 n=1024 T=20 bf16",
         trainer=est.trainer_used_, gram_launches=fit_launches,
         max_angle_deg=angle, data_s=data_s, fit_s=fit_s,
         samples_per_s=samples / fit_s, second_fit_s=fit2_s,
         second_samples_per_s=samples / fit2_s, card=card)
    check(angle <= 1.0, f"fit angle {angle} > 1 degree")

    # 6.-8. the read path
    serve_err = parity_serve(dev)
    serve_timing = timing_serve(dev, card)
    serve_launches = slice_serve(est, spec, cfg, card)
    del est, spec, data

    # 9.-11. the large-d solver path
    mg_err = parity_matvec_gram(dev)
    mg_timing = timing_matvec_gram(dev, card)
    mg_launches = slice_dsolve(dev, card)

    def row(name, shape, dtype, launches):
        t = timing[(shape, dtype)]
        return {"name": name, "route": "cuda", "source": GRAM_SOURCE,
                "replaces": GRAM_REPLACES, "launches": launches,
                "max_abs_err": max_abs[(shape, dtype)], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": list(shape)}

    def serve_row(name, route):
        t = serve_timing[(SERVE_BULK, route)]
        return {"name": name, "route": "cuda", "source": SERVE_SOURCE,
                "replaces": SERVE_REPLACES.get(route, SERVE_F32_NOTE),
                "launches": serve_launches[route],
                "max_abs_err": serve_err[route], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": list(SERVE_BULK)}

    print(json.dumps({"kernels": [
        row("gram_bf16", CIFAR, "bfloat16", fit_launches),
        row("gram_fp32", ENTRY, "float32", entry_launches),
        serve_row("serve_project_bf16", "bf16"),
        serve_row("serve_project_i8", "i8"),
        serve_row("serve_project_f32", "f32"),
        {"name": "matvec_gram", "route": "cuda", "source": MG_SOURCE,
         "replaces": MG_REPLACES, "launches": mg_launches, "max_abs_err": mg_err,
         "ms": mg_timing["ms"], "plain_ms": mg_timing["plain_ms"],
         "bound_ms": mg_timing["bound_ms"], "bound_by": mg_timing["bound_by"],
         "library_ms": mg_timing["library_ms"], "shape": list(MG_SLICE)},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
