#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

1. env: versions, the card (``nvidia-smi``), and the fp32 matmul
   precision (no TF32), which the port relies on but never sets.
2. build: ``csrc/gram.cu`` compiled with nvcc for sm_90a (seconds,
   ptxas register / spill lines).
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

    # 2. build
    t0 = time.perf_counter()
    _build.load("gram")
    info = _build.build_info["gram"]
    emit("build", source=GRAM_SOURCE, seconds=time.perf_counter() - t0,
         nvcc_seconds=info["seconds"],
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

    def row(name, shape, dtype, launches):
        t = timing[(shape, dtype)]
        return {"name": name, "route": "cuda", "source": GRAM_SOURCE,
                "replaces": GRAM_REPLACES, "launches": launches,
                "max_abs_err": max_abs[(shape, dtype)], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        row("gram_bf16", CIFAR, "bfloat16", fit_launches),
        row("gram_fp32", ENTRY, "float32", entry_launches),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
