#!/usr/bin/env python3
"""Where the time of the fused matvec + Gram kernel goes, on one card.

    python3 scripts/torch_profile_matvec_gram.py [--json OUT]

For ``chip_smoke.py``'s operands at the slice shape (12288, 200, 58) and at
four others ((12288, 400, 58), (12288, 800, 58) and (2048, 96, 840) take
the streamed plan), it builds copies of ``csrc/matvec_gram.cu`` and prints
one JSON line per shape:

- ``event_ms``: CUDA events around one ``matvec_gram_cuda`` call, median of
  25 after warm-up (the host's launch path included, as in ``chip_smoke.py``);
- ``device_us``: the kernel's device time per call under ``torch.profiler``
  (``chip_smoke.device_ms``, 20 calls);
- ``through_phase_us``: device time per call of copies that return before
  phase B, C or D (after A, B or C; D is the whole kernel), so the
  difference of two neighbours is one phase and its grid barrier;
- ``parts_us``: device time of copies with one part taken out: through A
  without the slab's loads (``A_no_loads``, the products run on whatever
  shared memory holds) or without its products (``A_no_products``),
  through C without its products (``C_no_products``) or without the Gram
  tile's update (``C_no_gram``), and the whole kernel on the streamed plan
  (``streamed``), to hold the resident plan against it.

The copies are built by ``scripts/torch_kernel_copies.py`` into
``build/torch_kernels/`` (the port never loads them). It prints the card's
name and power limit first, imports nothing of JAX or of the JAX package,
needs a card, and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch_kernel_copies as kc

SHAPES = ((12288, 200, 58), (12288, 400, 58), (12288, 800, 58), (3072, 80, 18),
          (2048, 96, 840))
SOURCE = "matvec_gram.cu"
# the kernel's phase comments: a copy returns before one of them
MARKS = ("  // B. y = sum over slabs", "  // C. y staged once per block",
         "  // D. g = sum over slabs")
A_LOADS = ("    stage_rows(smem_u32(cring + (size_t)st * RC * cst), a.c, r0, nr, RESIDENT ? 0 : "
           "4 * quad0(p),\n               cst, a.f, a.cvec);\n"
           "    stage_rows(smem_u32(vring + (size_t)st * RC * vst), a.v, r0, nr, RESIDENT ? 0 : "
           "4 * grp0(p),\n               vst, a.k, a.vvec);\n")
A_PRODUCTS = ("      if (mine > 0) fetch(row(0), ra);",
              "      if (!RESIDENT) __syncthreads();  // the stage may be refilled")
C_PRODUCTS = ("#pragma unroll 1\n        for (int i4 = i4_begin;",
              "        if (!RESIDENT) __syncthreads();  // the stage may be refilled")
C_GRAM = ("    // the lane pair's tile: u along row ta of the triangle, THREADS / 2 on",
          "    __syncthreads();  // wbuf and the stage are free")
PLAN_RULE = "  p.resident = resident <= (size_t)SMEM_MAX;"


def through(phase: str):
    """The copy that returns after ``phase`` (before the next one's comment)."""
    mark = MARKS["ABC".index(phase)]
    return lambda s: kc.edit(s, mark, "  return;\n" + mark, SOURCE)


def cut(start: str, end: str):
    """The copy without the text from ``start`` up to (not including) ``end``."""
    def edit(src: str) -> str:
        if src.count(start) != 1:
            raise RuntimeError(f"{SOURCE} has no single text {start!r}")
        i = src.index(start)
        return src[:i] + src[src.index(end, i):]
    return edit


def chain(*edits):
    def edit(src: str) -> str:
        for e in edits:
            src = e(src)
        return src
    return edit


def streamed(src: str) -> str:
    """The whole kernel on the streamed plan whatever the shape (its shared
    memory does not depend on f, so every shape fits)."""
    return kc.edit(src, PLAN_RULE, "  p.resident = 0;", SOURCE)


VARIANTS = {
    "kernel": lambda s: s,
    "thru_A": through("A"),
    "thru_B": through("B"),
    "thru_C": through("C"),
    "A_no_loads": chain(lambda s: kc.edit(s, A_LOADS, "", SOURCE), through("A")),
    "A_no_products": chain(cut(*A_PRODUCTS), through("A")),
    "C_no_products": chain(cut(*C_PRODUCTS), through("C")),
    "C_no_gram": chain(cut(*C_GRAM), through("C")),
    "streamed": streamed,
}
PARTS = ("A_no_loads", "A_no_products", "C_no_products", "C_no_gram", "streamed")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    if not kc.require_card("torch_profile_matvec_gram"):
        return 2
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg

    cs = kc.chip_smoke
    card = kc.card()
    libs = kc.build("matvec_gram", VARIANTS, {
        "det_matvec_gram_grid": [kc.INT, kc.INT, kc.INT],
        "det_matvec_gram": [kc.PTR] * 5 + [kc.INT] * 4 + [kc.PTR]})
    for lib in libs.values():
        lib.det_matvec_gram_workspace.argtypes = [kc.INT] * 3
        lib.det_matvec_gram_workspace.restype = ctypes.c_size_t
    results = []
    for seed, shape in enumerate(SHAPES):
        d, f, k = shape
        c, v = cs.mg_operands(shape, "cuda", seed=11 + seed)
        event_ms = cs.time_ms(lambda: mg.matvec_gram_cuda(c, v))
        device_us = cs.device_ms(lambda: mg.matvec_gram_cuda(c, v)) * 1e3
        w = torch.empty((d, k), device="cuda")
        g = torch.empty((k, k), device="cuda")
        copies = {}
        for name, lib in libs.items():
            ws = torch.empty((lib.det_matvec_gram_workspace(d, f, k),), dtype=torch.uint8,
                             device="cuda")
            blocks = lib.det_matvec_gram_grid(d, f, k)
            if blocks < 1:
                raise RuntimeError(f"{name} copy: grid query failed, CUDA error {-blocks}")

            def run(lib=lib, ws=ws, blocks=blocks, name=name):
                kc.checked(lib.det_matvec_gram(
                    c.data_ptr(), v.data_ptr(), w.data_ptr(), g.data_ptr(), ws.data_ptr(),
                    d, f, k, blocks, torch.cuda.current_stream().cuda_stream), name)

            copies[name] = cs.device_ms(run) * 1e3
        bound_ms, bound_by = cs.matvec_gram_bound(shape)
        row = {"phase": "matvec_gram_profile", "shape": list(shape),
               "kernel": mg.matvec_gram_launch(*shape).kernel, "event_ms": event_ms,
               "device_us": device_us,
               "through_phase_us": {"A": copies["thru_A"], "B": copies["thru_B"],
                                    "C": copies["thru_C"], "D": copies["kernel"]},
               "parts_us": {p: copies[p] for p in PARTS},
               "bound_us": bound_ms * 1e3, "bound_by": bound_by, "card": card}
        results.append(row)
        print(json.dumps(row), flush=True)
        del c, v, w, g
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump({"card": card, "results": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
