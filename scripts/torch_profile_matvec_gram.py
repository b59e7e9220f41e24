#!/usr/bin/env python3
"""Where the time of the fused matvec + Gram kernel goes, on one card.

    python3 scripts/torch_profile_matvec_gram.py

For ``chip_smoke.py``'s operands at the slice shape (12288, 200, 58) and at
two others, it prints one JSON line per shape:

- ``event_ms``: CUDA events around one ``matvec_gram_cuda`` call, median of
  25 after warm-up (the host's launch path included, as in ``chip_smoke.py``);
- ``device_us``: the kernel's device time per call under ``torch.profiler``
  (20 calls);
- ``through_phase_us``: device time per call of copies of
  ``csrc/matvec_gram.cu`` built to return after phase A, B, C or D (D is
  the whole kernel), CUDA events over 200 back-to-back calls, so the
  difference of two neighbours is one phase and its grid barrier. The
  copies are built into ``build/torch_kernels/`` and the port never loads
  them.

It imports nothing of JAX or of the JAX package, needs a card, and exits
non-zero without one.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((12288, 200, 58), (12288, 400, 58), (3072, 80, 18))
PHASES = ("A", "B", "C", "D")
# the kernel's phase comments, each preceded in a copy by an early return
MARKS = ("  // B. y = sum over slabs", "  // C. rows of w and their Gram",
         "  // D. g = sum over row items")


def build_copies(_build) -> dict:
    """One shared library per phase, returning after it (nvcc in parallel)."""
    src = (_build.CSRC / "matvec_gram.cu").read_text()
    for n, mark in enumerate(MARKS, 1):
        if mark not in src:
            raise RuntimeError(f"matvec_gram.cu has no line starting {mark!r}")
        src = src.replace(mark, f"#if DET_STOP_AFTER == {n}\n  return;\n#endif\n{mark}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "matvec_gram_phases.cu"
    path.write_text(src)
    procs = {}
    for n in range(1, len(PHASES) + 1):
        out = _build.BUILD_DIR / f"libmatvec_gram_phase{n}.so"
        procs[n] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DDET_STOP_AFTER={n}",
             "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the phase-{n} copy:\n{log}")
        lib = ctypes.CDLL(str(out))
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.det_matvec_gram_workspace.argtypes = [i, i, i]
        lib.det_matvec_gram_workspace.restype = ctypes.c_size_t
        lib.det_matvec_gram.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, ptr]
        lib.det_matvec_gram.restype = i
        libs[PHASES[n - 1]] = lib
    return libs


def through_phase_us(lib, c, v, reps: int = 200) -> float:
    import torch

    (d, f), k = c.shape, v.shape[1]
    w = torch.empty((d, k), device=c.device)
    g = torch.empty((k, k), device=c.device)
    ws = torch.empty((lib.det_matvec_gram_workspace(d, f, k),), dtype=torch.uint8,
                     device=c.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.det_matvec_gram(c.data_ptr(), v.data_ptr(), w.data_ptr(),
                                 g.data_ptr(), ws.data_ptr(), d, f, k, stream)
        if rc != 0:
            raise RuntimeError(f"phase copy launch failed: CUDA error {rc}")

    for _ in range(5):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_matvec_gram: torch.cuda.is_available() is False; "
              "needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from distributed_eigenspaces_tpu_torch.ops import _build
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
    from torch.profiler import ProfilerActivity, profile

    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    libs = build_copies(_build)
    for seed, shape in enumerate(SHAPES):
        c, v = chip_smoke.mg_operands(shape, dev, seed=11 + seed)
        event_ms = chip_smoke.time_ms(lambda: mg.matvec_gram_cuda(c, v))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                mg.matvec_gram_cuda(c, v)
            torch.cuda.synchronize()
        device_us = sum(
            e.self_device_time_total for e in prof.key_averages()
            if "matvec_gram_kernel" in e.key
        ) / 20
        phases = {p: through_phase_us(lib, c, v) for p, lib in libs.items()}
        bound_ms, bound_by = chip_smoke.matvec_gram_bound(shape)
        print(json.dumps({
            "phase": "matvec_gram_profile", "shape": list(shape), "event_ms": event_ms,
            "device_us": device_us, "through_phase_us": phases,
            "bound_us": bound_ms * 1e3, "bound_by": bound_by, "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
