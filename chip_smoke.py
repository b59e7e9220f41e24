#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

1. env: versions, the card (``nvidia-smi``), and the fp32 matmul
   precision (no TF32), which the port relies on but never sets.
2. build, build_serve, build_matvec_gram, build_mutant: ``csrc/gram.cu``,
   ``csrc/serve_project.cu``, ``csrc/matvec_gram.cu`` and
   ``csrc/mutant_full_block.cu`` compiled with nvcc for sm_90a, one process
   each, started together (seconds; per kernel instantiation its ptxas
   registers, spill stores and shared memory).
3. parity: the Gram kernels against their plain PyTorch version on the
   card, fp32 and bf16, at the entry shape (4, 128, 256), the CIFAR-10
   shape (8, 1024, 3072) and a ragged (3, 1000, 3000): relative Frobenius
   error <= 1e-5 (fp32) / 1e-4 (bf16), exactly symmetric; bf16 at these
   shapes takes the TMA + wgmma kernel (``launches_tma``). Then bf16 that
   TMA cannot read, on the ``mma.sync`` kernel (``launches`` moves,
   ``launches_tma`` does not), to the same tolerance: (3, 1000, 3001) and
   the ragged shape on a base 2 bytes off a 16-byte boundary. Then fp32 on
   every tile edge and copy width of its shape rule (``F32_CASES``: d = 3001,
   n = 1, a base 4 bytes off a 16-byte boundary), each launch recorded as
   ``gram_launch`` says.
4. timing: kernel, plain version, ``torch.bmm`` yardstick and the bound,
   with CUDA events (median of 25 after warm-up), and the device time of
   the kernel and of the yardstick under ``torch.profiler``; for bf16 x
   the yardstick is ``torch.bmm(..., out_dtype=float32)``, which writes the
   kernel's fp32 output, where this torch has it (the bf16-output ``bmm``
   beside it). Then one CIFAR-shape bf16 launch and one fp32 launch at the
   entry and the CIFAR shape, each under the launch recorder and the
   profiler: its profiled grid, block and shared memory must equal its
   ``gram_launch`` record.
5. slice: ``entry()``'s step 10 times (10 Gram launches), checked against
   the same step on the CPU; then ``OnlineDistributedPCA`` at the
   CIFAR-10 shape (d=3072, k=10, m=8, n=1024, T=20, subspace 12 / warm 2,
   bf16) on planted-spectrum data, which must recover the planted top-10
   within 1 degree with exactly one Gram launch (the cold step), on the
   TMA kernel.
6. parity_serve: the serve kernels (bf16, int8 and the fixed-order fp32
   one) against their plain versions at (64, 256, 8), the CIFAR-10 serve
   shape (512, 3072, 10), a ragged (1000, 3000, 10) and the bulk (65536,
   3072, 10), fp32 and bf16 x (but for the fp32 kernel, which takes fp32 x
   only); relative Frobenius error <= 1e-5, and the first 300 rows of a
   512-row launch, and the first 512 of a 65,536-row launch (one-pair
   column tiles against whole-k ones), equal, bit for bit, a launch of
   those rows alone.
7. timing_serve: kernels, plain versions, ``torch.matmul`` on the fp32
   operands (and ``torch.mm(..., out_dtype=float32)`` on bf16 ones where
   this torch has it) and the bound at the engine's 8-, 64- and 512-row
   buckets and the bulk 65,536 rows, d=3072, k=10: one call with CUDA
   events, and the device time of the kernel and of ``torch.matmul``
   under ``torch.profiler`` (20 calls; every kernel event of the 20 calls
   must be there, one per kernel call).
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
   (12288, 200, 58) and a ragged (3000, 80, 13) (the resident plan) and at
   (12288, 400, 58), (4000, 37, 200), (12288, 800, 58) and (2048, 96, 840)
   (the streamed plan, whose shared memory does not depend on f): relative
   Frobenius error <= 1e-5 on ``w`` and ``g``, ``g`` exactly symmetric, two
   launches bit for bit the same, each launch on its plan's kernel.
10. timing_matvec_gram: kernel, plain version, the ``torch.matmul``
   yardstick (cuBLAS's three calls) and the bound at the slice shape, one
   call with CUDA events and the device time of the kernel and of the
   three calls under ``torch.profiler``: seven windows of each, in turn,
   all printed, and their medians in the ``kernels`` line.
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
12. parity_mutant: the analyzer's one-CTA mutant kernel against its plain
   version (``torch.matmul``) at the audit shape (256, 1024, 8) and a
   ragged (100, 1000, 5): relative Frobenius error <= 1e-5 (FFMA in index
   order against cuBLAS fp32).
13. timing_mutant: kernel, plain version, ``torch.matmul`` and the byte
   bound at (256, 1024, 8), one call with CUDA events and the device time
   of the kernel and of ``torch.matmul``.
14. analysis: the port's analyzer on the card (``run_analysis`` and
   ``run_mutation_report``, device cuda) under the launch recorder and
   ``torch.profiler``: the 4 programs honour their contracts, every profiled
   kernel event has the grid, block and shared memory of its recorded
   ``KernelLaunch`` (one event per launch), and 5 of 5 seeded mutations are
   caught, the mutant's launch with grid [1, 1, 1].

Then the kernel table as one JSON line and, last, the result line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
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
GRAM_UNALIGNED_D = (3, 1000, 3001)  # d % 8 != 0: bf16 rows TMA cannot read
# fp32 on each tile edge and copy width of the shape rule (f32_tile,
# f32_vec), as (shape, base offset in elements): edge 64 with 16-byte and
# 4-byte copies (d % 4 != 0, ragged n); edge 128 with d % 4 != 0 and on an
# unaligned base; edge 32 with n = 1; edge 32, 4-byte copies; one entry
F32_CASES = (((8, 256, 512), 0), ((8, 100, 510), 0), (GRAM_UNALIGNED_D, 0), (RAGGED, 1),
             ((2, 1, 300), 0), ((5, 37, 130), 0), ((1, 1, 1), 0))
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
SERVE_PARITY = ((64, 256, 8), SERVE_BURST, (1000, 3000, SERVE_K), SERVE_BULK)
# rows of a launch held bit for bit against a launch of those rows alone:
# the burst's 512 rows and 300 of them take one-pair column tiles, the bulk
# launch whole-k tiles, so its first 512 rows cross the tile-width boundary
SERVE_PREFIX = {SERVE_BURST: 300, SERVE_BULK: 512}
# the engine's smallest buckets, a full one and the bulk project
SERVE_SHAPES = ((8, 3072, SERVE_K), (64, 3072, SERVE_K), SERVE_BURST, SERVE_BULK)
SERVE_F32_NOTE = ("no TPU kernel: the JAX package's fp32 projection is XLA at "
                  "Precision.HIGHEST (distributed_eigenspaces_tpu/serving/"
                  "transform.py:157-158); the port's fixed-order fp32 route, "
                  "on the split kernel with an fp32 basis")
MG_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/matvec_gram.cu"
MG_REPLACES = "distributed_eigenspaces_tpu/ops/pallas_gram.py:337"
MG_TOL = 1e-5
MG_WINDOWS = 7  # device-time windows of the kernel and of cuBLAS's three calls, in turn
MG_SLICE = (12288, 200, 58)  # C (d, m*k) and the oversampled iterate at k=50
MG_STREAMED = (12288, 400, 58)  # eight workers' factors: the slab streams
# sixteen workers' factors at k = 50, and the widest iterate the port has
# always taken (k' = 840): the streamed plan takes any f
MG_PARITY = ((256, 64, 16), MG_SLICE, (3000, 80, 13), MG_STREAMED, (4000, 37, 200),
             (12288, 800, 58), (2048, 96, 840))
DSOLVE = dict(dim=12288, k=50, num_workers=4, rows_per_worker=2048, num_steps=10)
MUTANT_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/mutant_full_block.cu"
MUTANT_REPLACES = "distributed_eigenspaces_tpu/analysis/mutations.py:352"
MUTANT_TOL = 1e-5
MUTANT_AUDIT = (256, 1024, 8)  # the JAX mutant's (rows, d, k)
MUTANT_PARITY = (MUTANT_AUDIT, (100, 1000, 5))
ANALYSIS_PROGRAMS = 4
ANALYSIS_MUTATIONS = 5


def ptxas_lines(log: str) -> list[str]:
    """The lines of an ``nvcc -Xptxas=-v`` log that give, per kernel (its
    ``Compiling entry function`` line), registers, spills and shared memory."""
    keys = ("Compiling entry function", "spill stores", "Used ")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]


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


def gram_geometry(dev, gen, shape, dtype: str, phase: str, kernel: str) -> None:
    """One Gram launch of ``shape`` and ``dtype`` under the launch recorder
    and the profiler: the launch must take ``kernel`` and the profiled event
    must have the grid, block and shared memory of the launch's record
    (``gram_launch``, the TMA kernel's grid sized on the card)."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import geometry
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
    gram_mod.gram_cuda(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_warm(dev)
        with geometry.recording() as launches:
            gram_mod.gram_cuda(x)
        torch.cuda.synchronize()
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(trace_dir, exist_ok=True)
    events = geometry.profiled_kernels(prof, geometry.RECORDED_KERNELS,
                                       os.path.join(trace_dir, f"chip_smoke_{phase}_trace.json"))
    mismatches = geometry.geometry_mismatches(events, launches)
    emit(phase, shape=list(shape), dtype=dtype, recorded=[la.to_json() for la in launches],
         profiled=[{k: ev[k] for k in ("symbol", "grid", "block", "smem", "dur_us")}
                   for ev in events], geometry_mismatches=mismatches)
    check(len(launches) == 1 and launches[0].kernel == kernel,
          f"{phase}: recorded {[la.kernel for la in launches]}, want {kernel}")
    want = gram_mod.gram_launch(*shape, x.dtype)
    check(launches[0] == (want if want.grid else want.resolved(launches[0].grid)),
          f"{phase}: the record is not gram_launch's")
    check(not mismatches, f"{phase}: profiled launch differs: {mismatches}")


def parity_serve(dev) -> dict:
    """Both serve kernels against their plain versions; returns each
    kernel's largest absolute error over the cases."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    worst = {"bf16": 0.0, "i8": 0.0, "f32": 0.0}
    cases = [(shape, x_dtype) for shape in SERVE_PARITY for x_dtype in ("float32", "bfloat16")]
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
            worst[route] = max(worst[route], err)
            prefix = {}
            if shape in SERVE_PREFIX:
                n = SERVE_PREFIX[shape]
                prefix[f"first_{n}_rows_bit_equal"] = bool(torch.equal(run(x[:n]), got[:n]))
            emit("parity_serve", kernel=route, shape=list(shape), x_dtype=x_dtype,
                 rel_frobenius=rel, max_abs_err=err, tol=SERVE_TOL, **prefix)
            check(rel <= SERVE_TOL, f"serve {route} {shape} {x_dtype}: {rel} > {SERVE_TOL}")
            check(all(prefix.values()),
                  f"serve {route} {x_dtype}: {prefix}: rows alone differ from the "
                  f"{shape[0]}-row launch")
            del got, want
        del x, v
    return worst


def bf16_out_fp32(op, a, b):
    """``op(a, b, out_dtype=torch.float32)`` (``torch.mm`` or ``torch.bmm``
    on bf16 operands), or the reason this torch cannot run it (a yardstick
    only: the port never calls it)."""
    import torch

    try:
        return op(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        return repr(e)[:200]


def profiler_warm(dev) -> None:
    """A few small kernels at the start of a ``torch.profiler`` window: the
    card's first launches in a window after earlier windows can go
    unrecorded, so what is measured comes after these."""
    import torch

    for _ in range(4):
        torch.ones(256, device=dev).sum()
        torch.cuda.synchronize()


PAUSE_S = 0.05  # the host's pause between the parts of a device_ms window


def profiled_window(fn, reps: int, warm: int) -> list:
    """The kernel events of one ``device_ms`` window, in order of their
    start on the card's clock: ``profiler_warm``'s kernels, a pause, ``warm``
    calls of ``fn``, a pause, ``reps`` calls, and a pause before the window
    closes, so that no record of the timed calls is still in flight. The
    profiler can leave out the first kernels of a window, at times every
    warm call (``scripts/torch_profiler_windows.py`` counts what a window
    records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_warm("cuda")
        time.sleep(PAUSE_S)
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def timed_events(events: list, reps: int, launches: int | None) -> tuple[list | None, int]:
    """The events of a window's ``reps`` timed calls and the index where
    they start: those after the last gap of at least the pause (the card
    idles through it; ``time_range`` is in microseconds), or every event
    where the profiler left out all that came before. None where the
    window lacks one: ``reps * launches`` events are wanted (where
    ``launches`` is None, for a library call, each kernel's count a
    multiple of ``reps``)."""
    pauses = [i for i in range(1, len(events))
              if events[i].time_range.start - events[i - 1].time_range.end >= 0.9e6 * PAUSE_S]
    cut = pauses[-1] if pauses else 0
    measured = events[cut:]
    per_name = collections.Counter(e.name for e in measured)
    if measured and all(n % reps == 0 for n in per_name.values()) and (
            launches is None or len(measured) == reps * launches):
        return measured, cut
    return None, cut


def device_ms(fn, reps: int = 20, launches: int | None = 1, warm: int = 5,
              windows: int = 5) -> float:
    """Device time of one call of ``fn`` under ``torch.profiler``: the
    kernels of ``reps`` calls in a ``profiled_window``, summed, over
    ``reps``. Events are told apart on the card's own clock, since the
    profiler's host and device clocks can disagree by more than a launch.
    A window that lacks an event of the timed calls (``timed_events``)
    would read low, so it is measured again, up to ``windows`` times, and
    the run fails after that."""
    import torch

    fn()
    torch.cuda.synchronize()
    for window in range(1, windows + 1):
        events = profiled_window(fn, reps, warm)
        measured, cut = timed_events(events, reps, launches)
        if measured:
            return sum(e.time_range.end - e.time_range.start for e in measured) / reps * 1e-3
        emit("device_ms", incomplete_window=window, reps=reps, launches=launches,
             events_before_pause=cut,
             events_after_pause=dict(collections.Counter(e.name for e in events[cut:])))
    check(False, f"device_ms: {windows} windows without every kernel event of {reps} calls")
    return 0.0


def timing_serve(dev, card: str) -> dict:
    """Kernel, plain, library times and the bound at each of
    ``SERVE_SHAPES`` (CUDA events around one call, median of 25 after
    warm-up), and the device time of the kernel and of the library call."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    out = {}
    for shape in SERVE_SHAPES:
        x, v = serve_operands(shape, dev, seed=7)
        library_ms = time_ms(lambda: torch.matmul(x, v))
        library_device_ms = device_ms(lambda: torch.matmul(x, v), launches=None)
        xb, vb = x.to(torch.bfloat16), v.to(torch.bfloat16)
        probe = bf16_out_fp32(torch.mm, xb, vb)
        if isinstance(probe, str):
            mm_ms, mm_note = None, probe
        else:
            mm_ms, mm_note = time_ms(lambda: bf16_out_fp32(torch.mm, xb, vb)), None
        del xb, vb, probe
        for route, run, plain, _ in serve_routes(sp, v):
            ms = time_ms(lambda: run(x))
            kernel_device_ms = device_ms(lambda: run(x))
            plain_ms = time_ms(lambda: plain(x))
            bound_ms, bound_by = serve_bound(shape, route)
            out[(shape, route)] = dict(ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
                                       library_ms=library_ms,
                                       library_device_ms=library_device_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
            emit("timing_serve", kernel=route, shape=list(shape), kernel_ms=ms,
                 kernel_device_ms=kernel_device_ms, plain_ms=plain_ms,
                 library_ms=library_ms, library_device_ms=library_device_ms,
                 library="torch.matmul(x, v), fp32 operands",
                 mm_bf16_out_fp32_ms=mm_ms, mm_bf16_note=mm_note,
                 bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
                 device_roofline_share=bound_ms / kernel_device_ms, card=card)
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
    """Least time for one fused sweep: C and v read once, w and g written
    once; 4*d*f*k + 2*d*k*k fp32 FLOP (the two products and the Gram)."""
    d, f, k = shape
    bytes_s = (d * f + 2 * d * k + k * k) * 4 / PEAK_BYTES_S
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

    from distributed_eigenspaces_tpu_torch.ops.geometry import recording

    worst = 0.0
    plans = set()
    for seed, shape in enumerate(MG_PARITY):
        c, v = mg_operands(shape, dev, seed)
        before = mg.launches
        with recording() as rec:
            w, g = mg.matvec_gram_cuda(c, v)
        torch.cuda.synchronize()
        check(mg.launches == before + 1, "matvec_gram: launch counter did not move")
        plan = mg.matvec_gram_plan(*shape)
        plans.add(plan["resident"])
        check([r.kernel for r in rec] == [mg.matvec_gram_launch(*shape).kernel],
              f"matvec_gram {shape}: recorded {[r.kernel for r in rec]}")
        pw, pg = mg.matvec_gram_plain(c, v)
        rel_w, rel_g = rel_err(w, pw), rel_err(g, pg)
        err = max(float((w - pw).abs().max()), float((g - pg).abs().max()))
        w2, g2 = mg.matvec_gram_cuda(c, v)
        repeat = bool(torch.equal(w, w2) and torch.equal(g, g2))
        symmetric = bool(torch.equal(g, g.mT))
        worst = max(worst, err)
        emit("parity_matvec_gram", shape=list(shape), kernel=rec[0].kernel,
             resident=plan["resident"], grid=list(rec[0].grid),
             dynamic_smem=rec[0].dynamic_smem, rel_frobenius_w=rel_w,
             rel_frobenius_g=rel_g, max_abs_err=err, tol=MG_TOL,
             g_symmetric=symmetric, repeat_bit_identical=repeat)
        check(rel_w <= MG_TOL and rel_g <= MG_TOL,
              f"matvec_gram {shape}: w {rel_w}, g {rel_g} > {MG_TOL}")
        check(symmetric, f"matvec_gram {shape}: g is not symmetric")
        check(repeat, f"matvec_gram {shape}: two launches differ")
        del c, v, w, g, w2, g2, pw, pg
    check(plans == {True, False}, f"matvec_gram parity ran plans {plans}, want both")
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
    # the two differ by less than one window's spread: MG_WINDOWS of each, in
    # turn, and their medians
    kernel_windows, library_windows = [], []
    for _ in range(MG_WINDOWS):
        kernel_windows.append(device_ms(lambda: mg.matvec_gram_cuda(c, v)))
        library_windows.append(device_ms(library, launches=None))
    kernel_device_ms = statistics.median(kernel_windows)
    library_device_ms = statistics.median(library_windows)
    bound_ms, bound_by = matvec_gram_bound(MG_SLICE)
    emit("timing_matvec_gram", shape=list(MG_SLICE),
         kernel=mg.matvec_gram_launch(*MG_SLICE).kernel, kernel_ms=ms,
         kernel_device_ms=kernel_device_ms, kernel_device_ms_windows=kernel_windows,
         plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_device_ms,
         library_device_ms_windows=library_windows,
         library="torch.matmul(C, torch.matmul(C.T, v)) + w.T @ w",
         bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
         device_roofline_share=bound_ms / kernel_device_ms, card=card)
    return dict(ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms, bound_ms=bound_ms, bound_by=bound_by)


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


def mutant_bound(shape) -> tuple[float, str]:
    """Least time for ``x @ v`` of ``shape``: x and v read once, o written
    once, in fp32, against 2*rows*d*k fp32 FLOP."""
    rows, d, k = shape
    bytes_s = (rows * d + d * k + rows * k) * 4 / PEAK_BYTES_S
    ops_s = 2 * rows * d * k / PEAK_FLOPS["float32"]
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def parity_mutant(dev) -> float:
    """The one-CTA mutant against its plain version; returns the largest
    absolute error over the cases."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb
    from distributed_eigenspaces_tpu_torch.ops.geometry import recording

    worst = 0.0
    for seed, shape in enumerate(MUTANT_PARITY):
        x, v = serve_operands(shape, dev, seed=20 + seed)
        before = mfb.launches
        with recording() as rec:
            got = mfb.mutant_full_block_cuda(x, v)
        torch.cuda.synchronize()
        check(mfb.launches == before + 1, "mutant: launch counter did not move")
        check(rec == [mfb.mutant_full_block_launch(*shape)],
              f"mutant: recorded {rec}, not the declared launch")
        want = mfb.mutant_full_block_plain(x, v)
        rel = rel_err(got, want)
        err = float((got - want).abs().max().item())
        worst = max(worst, err)
        emit("parity_mutant", shape=list(shape), rel_frobenius=rel, max_abs_err=err,
             tol=MUTANT_TOL, grid=list(rec[0].grid), threads=rec[0].threads,
             dynamic_smem=rec[0].dynamic_smem)
        check(rel <= MUTANT_TOL, f"mutant {shape}: {rel} > {MUTANT_TOL}")
    return worst


def timing_mutant(dev, card: str) -> dict:
    """Kernel, plain, library and bound at the audit shape (CUDA events,
    median of 25 after warm-up). The kernel is slow by design."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb

    x, v = serve_operands(MUTANT_AUDIT, dev, seed=22)
    ms = time_ms(lambda: mfb.mutant_full_block_cuda(x, v))
    kernel_device_ms = device_ms(lambda: mfb.mutant_full_block_cuda(x, v))
    plain_ms = time_ms(lambda: mfb.mutant_full_block_plain(x, v))
    library_ms = time_ms(lambda: torch.matmul(x, v))
    library_device_ms = device_ms(lambda: torch.matmul(x, v), launches=None)
    bound_ms, bound_by = mutant_bound(MUTANT_AUDIT)
    emit("timing_mutant", shape=list(MUTANT_AUDIT), kernel_ms=ms,
         kernel_device_ms=kernel_device_ms, plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms, library="torch.matmul(x, v), fp32",
         bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms, card=card)
    return dict(ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms, bound_ms=bound_ms, bound_by=bound_by)


def analysis(dev, card: str) -> dict:
    """The port's analyzer on the card, under the launch recorder and the
    profiler; returns each kernel's launches in that run."""
    import torch
    from distributed_eigenspaces_tpu_torch.analysis import report
    from distributed_eigenspaces_tpu_torch.ops import geometry
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from torch.profiler import ProfilerActivity, profile

    sp.launches = sp.launches_i8 = sp.launches_f32 = mg.launches = mfb.launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_warm(dev)
        with geometry.recording() as launches:
            rep = report.run_analysis(device=dev)
            mut = report.run_mutation_report(device=dev)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"serve_project_bf16": sp.launches, "serve_project_i8": sp.launches_i8,
              "serve_project_f32": sp.launches_f32, "matvec_gram": mg.launches,
              "mutant_full_block": mfb.launches}
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(trace_dir, exist_ok=True)
    events = geometry.profiled_kernels(prof, geometry.RECORDED_KERNELS,
                                       os.path.join(trace_dir, "chip_smoke_analysis_trace.json"))
    mismatches = geometry.geometry_mismatches(events, launches)
    for ev in events:
        emit("analysis", part="profiled_kernel", name=ev["name"], symbol=ev["symbol"],
             grid=ev["grid"], block=ev["block"], smem=ev["smem"], device_us=ev["dur_us"],
             args=ev["args"])
    for name, entry in rep["programs"].items():
        emit("analysis", part="program", program=name, ok=entry["ok"],
             contract=entry["contract"], pallas=entry["pallas"], memory=entry["memory"],
             launches=entry["launches"], violations=entry["violations"])
    emit("analysis", part="summary", device=rep["device"], ok=rep["ok"],
         n_violations=rep["n_violations"], lints=rep["lints"],
         mutations={r["mutation"]: r["caught"] for r in mut["mutations"]},
         recorded_launches=len(launches), profiled_events=len(events),
         kernels_device_us=sum(ev["dur_us"] or 0.0 for ev in events),
         geometry_mismatches=mismatches, launches=counts, seconds=seconds, card=card)
    # (a) every program honours its contract, with its kernels launched
    check(rep["ok"] and len(rep["programs"]) == ANALYSIS_PROGRAMS,
          f"analysis: {rep['n_violations']} violations over {list(rep['programs'])}")
    check(all(e["launches"] and all(la["grid"] for la in e["launches"])
              for e in rep["programs"].values()),
          "analysis: a program recorded no resolved kernel launch on the card")
    # (b) the declarations equal the card's launches, one event per launch
    check(not mismatches, f"analysis: profiled geometry differs: {mismatches}")
    check(len(events) == len(launches) > 0,
          f"analysis: {len(events)} profiled events for {len(launches)} launches")
    mutant = [e for e in events if e["symbol"] == "mutant_full_block_kernel"]
    check([e["grid"] for e in mutant] == [(1, 1, 1)],
          f"analysis: mutant grids {[e['grid'] for e in mutant]}")
    # (c) every ported mutation is caught
    caught = sum(r["caught"] for r in mut["mutations"])
    check(mut["ok"] and caught == ANALYSIS_MUTATIONS == len(mut["mutations"]),
          f"analysis: {caught} of {len(mut['mutations'])} mutations caught")
    check(all(n >= 1 for n in counts.values()), f"analysis: launches {counts}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import _build, geometry
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
    sources = ("gram", "serve_project", "matvec_gram", "mutant_full_block")
    _build.build_all(sources)
    for name in sources:
        _build.load(name)
    seconds = time.perf_counter() - t0
    for phase, name, source in (("build", "gram", GRAM_SOURCE),
                                ("build_serve", "serve_project", SERVE_SOURCE),
                                ("build_matvec_gram", "matvec_gram", MG_SOURCE),
                                ("build_mutant", "mutant_full_block", MUTANT_SOURCE)):
        info = _build.build_info[name]
        emit(phase, source=source, seconds=seconds, nvcc_seconds=info["seconds"],
             ptxas=ptxas_lines(info["log"]))

    # 3. parity on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = {}
    cases = [(shape, dtype, 0) for shape in (ENTRY, CIFAR, RAGGED)
             for dtype in ("float32", "bfloat16")]
    # bf16 that TMA cannot read takes the mma.sync kernel: d % 8 != 0, and
    # a base 2 bytes off a 16-byte boundary
    cases += [(GRAM_UNALIGNED_D, "bfloat16", 0), (RAGGED, "bfloat16", 1)]
    cases += [(shape, "float32", offset) for shape, offset in F32_CASES]
    f32_kernels = set()
    for shape, dtype, offset in cases:
        numel = shape[0] * shape[1] * shape[2]
        flat = torch.randn(numel + offset, generator=gen, device=dev)
        x = flat.to(getattr(torch, dtype))[offset:].view(shape)
        del flat
        before = (gram_mod.launches, gram_mod.launches_tma)
        with geometry.recording() as rec:
            got = gram_mod.gram_cuda(x)
        torch.cuda.synchronize()
        aligned = x.data_ptr() % 16 == 0
        tma = gram_mod.takes_tma(shape[2], x.dtype, aligned)
        want_launch = gram_mod.gram_launch(*shape, x.dtype, aligned)
        check([r.kernel for r in rec] == [want_launch.kernel],
              f"gram {shape} {dtype} offset {offset}: recorded {[r.kernel for r in rec]}, "
              f"gram_launch says {want_launch.kernel}")
        if dtype == "float32":
            f32_kernels.add(want_launch.kernel)
        check(tma == (dtype == "bfloat16" and shape[2] % 8 == 0 and not offset),
              f"gram {shape} {dtype} offset {offset}: the shape rule says TMA: {tma}")
        check((gram_mod.launches, gram_mod.launches_tma) == (before[0] + 1, before[1] + tma),
              f"gram {shape} {dtype}: launch counters {before} did not move as the "
              f"shape rule says (TMA: {tma})")
        want = gram_mod.gram_plain(x)
        rel = rel_err(got, want)
        err = float((got - want).abs().max().item())
        max_abs[(shape, dtype, offset)] = err
        emit("parity", shape=list(shape), dtype=dtype, base_offset_elements=offset,
             kernel=rec[0].kernel, grid=list(rec[0].grid), rel_frobenius=rel,
             max_abs_err=err, tol=TOL[dtype], tma_kernel=tma,
             symmetric=bool(torch.equal(got, got.mT)))
        check(rel <= TOL[dtype], f"gram {shape} {dtype}: {rel} > {TOL[dtype]}")
        check(torch.equal(got, got.mT), f"gram {shape} {dtype} is not symmetric")
        del x, got, want
    want_f32 = {f"gram_f32_kernel<{t}, {v}>" for t in gram_mod.F_TILES for v in (4, 1)}
    check(f32_kernels == want_f32, f"fp32 parity took {sorted(f32_kernels)}, "
                                   f"want every instance {sorted(want_f32)}")

    # 4. timing
    timing = {}
    for shape, dtype in ((CIFAR, "bfloat16"), (CIFAR, "float32"), (ENTRY, "float32")):
        x = torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
        ms = time_ms(lambda: gram_mod.gram_cuda(x))
        kernel_device_ms = device_ms(lambda: gram_mod.gram_cuda(x))
        plain_ms = time_ms(lambda: gram_mod.gram_plain(x))
        same_out_ms = library_ms = time_ms(lambda: torch.bmm(x.mT, x))
        library, same_out_note = "torch.bmm(x.mT, x)", None
        yardstick = lambda: torch.bmm(x.mT, x)  # noqa: E731
        if dtype == "bfloat16":  # bmm writes bf16 for bf16 x; the kernel fp32
            probe = bf16_out_fp32(torch.bmm, x.mT, x)
            if isinstance(probe, str):
                same_out_ms, same_out_note = None, probe
            else:
                yardstick = lambda: bf16_out_fp32(torch.bmm, x.mT, x)  # noqa: E731
                same_out_ms = time_ms(yardstick)
                library = "torch.bmm(x.mT, x, out_dtype=torch.float32)"
            del probe
        library_device_ms = device_ms(yardstick, launches=None)
        bound_ms, bound_by = gram_bound(shape, dtype)
        timing[(shape, dtype)] = dict(
            ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=same_out_ms if same_out_ms is not None else library_ms,
            library_device_ms=library_device_ms, library=library, bmm_ms=library_ms)
        emit("timing", shape=list(shape), dtype=dtype, kernel_ms=ms,
             kernel_device_ms=kernel_device_ms, plain_ms=plain_ms,
             library_ms=timing[(shape, dtype)]["library_ms"],
             library_device_ms=library_device_ms, library=library, bmm_ms=library_ms,
             bmm_fp32_out_ms=same_out_ms, bmm_fp32_out_note=same_out_note,
             bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
             device_roofline_share=bound_ms / kernel_device_ms, card=card)
        del x
    gram_geometry(dev, gen, CIFAR, "bfloat16", "gram_geometry", "gram_bf16_tma_kernel")
    for shape in (ENTRY, CIFAR):
        gram_geometry(dev, gen, shape, "float32", "gram_f32_geometry",
                      gram_mod.gram_launch(*shape, torch.float32).kernel)

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
    gram_mod.launches = gram_mod.launches_tma = 0
    t0 = time.perf_counter()
    est.fit(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = gram_mod.launches
    check(fit_launches == 1, f"fit: {fit_launches} Gram launches, want 1")
    check(gram_mod.launches_tma == 1, "fit: the Gram launch did not take the TMA kernel")
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

    # 12.-14. the analyzer's kernel gate and its mutant
    mutant_err = parity_mutant(dev)
    mutant_timing = timing_mutant(dev, card)
    analysis_launches = analysis(dev, card)

    def row(name, shape, dtype, launches, also=()):
        t = timing[(shape, dtype)]
        return {"name": name, "route": "cuda", "source": GRAM_SOURCE,
                "replaces": GRAM_REPLACES, "launches": launches,
                "max_abs_err": max_abs[(shape, dtype, 0)], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"],
                "library": t["library"], "bmm_ms": t["bmm_ms"], "shape": list(shape),
                "kernel": gram_mod.gram_launch(*shape, getattr(torch, dtype)).kernel,
                "at_shapes": [dict(timing[(other, dtype)], shape=list(other),
                                   max_abs_err=max_abs[(other, dtype, 0)]) for other in also]}

    def serve_row(name, route):
        t = serve_timing[(SERVE_BULK, route)]
        b = serve_timing[(SERVE_BURST, route)]
        return {"name": name, "route": "cuda", "source": SERVE_SOURCE,
                "replaces": SERVE_REPLACES.get(route, SERVE_F32_NOTE),
                "launches": serve_launches[route],
                "max_abs_err": serve_err[route], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": list(SERVE_BULK),
                "burst_shape": list(SERVE_BURST), "burst_ms": b["ms"],
                "burst_plain_ms": b["plain_ms"], "burst_bound_ms": b["bound_ms"],
                "burst_library_ms": b["library_ms"],
                "at_shapes": [dict(serve_timing[(shape, route)], shape=list(shape))
                              for shape in SERVE_SHAPES]}

    print(json.dumps({"kernels": [
        row("gram_bf16", CIFAR, "bfloat16", fit_launches),
        row("gram_fp32", ENTRY, "float32", entry_launches, also=(CIFAR,)),
        serve_row("serve_project_bf16", "bf16"),
        serve_row("serve_project_i8", "i8"),
        serve_row("serve_project_f32", "f32"),
        {"name": "matvec_gram", "route": "cuda", "source": MG_SOURCE,
         "replaces": MG_REPLACES, "launches": mg_launches, "max_abs_err": mg_err,
         "ms": mg_timing["ms"], "plain_ms": mg_timing["plain_ms"],
         "bound_ms": mg_timing["bound_ms"], "bound_by": mg_timing["bound_by"],
         "library_ms": mg_timing["library_ms"], "device_ms": mg_timing["device_ms"],
         "library_device_ms": mg_timing["library_device_ms"], "shape": list(MG_SLICE)},
        {"name": "mutant_full_block", "route": "cuda", "source": MUTANT_SOURCE,
         "replaces": MUTANT_REPLACES,
         "launches": analysis_launches["mutant_full_block"],
         "max_abs_err": mutant_err, "ms": mutant_timing["ms"],
         "plain_ms": mutant_timing["plain_ms"], "bound_ms": mutant_timing["bound_ms"],
         "bound_by": mutant_timing["bound_by"],
         "library_ms": mutant_timing["library_ms"], "device_ms": mutant_timing["device_ms"],
         "library_device_ms": mutant_timing["library_device_ms"],
         "shape": list(MUTANT_AUDIT)},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
