#!/usr/bin/env python3
"""Device times of the fp32 Gram, the fused matvec + Gram and the s8 Gram
kernels of a checkout, beside their PyTorch yardsticks, on one card.

    python3 scripts/torch_time_kernels.py [--root DIR] [--label NAME]
                                          [--only gram_fp32,matvec_gram,gram_s8]

``--root`` is the checkout whose kernels are built and timed (default: this
one), so that two commits can be compared in one run on one card: unpack
the other with ``git archive`` into a directory ``.gitignore`` lists and
run this script on each in turns (A, B, B, A). It uses that checkout's own
``chip_smoke.py`` helpers (``device_ms``, the operands) and prints one JSON
line per measurement: the fp32 Gram at the entry shape (4, 128, 256) and at
the CIFAR-10 shape (8, 1024, 3072) beside ``torch.bmm``, and the fused sweep
beside cuBLAS's three calls at the slice shape (12288, 200, 58) and at three
shapes of the streamed plan: eight and sixteen workers' factors at k = 50,
and k' = 840, and the s8 Gram route (``gram_s8_cuda``, every kernel it
launches in a call: one in a checkout of the ``mma.sync`` kernel, two in
one of the transpose and the TMA kernel) at the CIFAR-10 (8, 1024, 3072),
synthetic1024 (8, 2048, 1024) and mnist784 (8, 1024, 784) blocks beside
``torch._int_mm`` over the workers. Each line lists every window's device
time. The card's name and power limit come first. It imports nothing of JAX or of the JAX
package, needs a card, and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the fused sweep's streamed plan: eight and sixteen workers' factors at
# k = 50, and the widest iterate (k' = 840)
MG_STREAMED = ((12288, 400, 58), (12288, 800, 58), (2048, 96, 840))
# the int8 blocks of the cifar10, synthetic1024 and mnist784 evals
S8_SHAPES = ((8, 1024, 3072), (8, 2048, 1024), (8, 1024, 784))
WHAT = ("gram_fp32", "matvec_gram", "gram_s8")


def main(argv=None) -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here, help="the checkout to time")
    ap.add_argument("--label", default=None, help="a name for the checkout in the output")
    ap.add_argument("--reps", type=int, default=3, help="device_ms windows per measurement")
    ap.add_argument("--only", default=",".join(WHAT),
                    help=f"comma-separated subset of {', '.join(WHAT)}")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(WHAT):
        ap.error(f"--only takes {', '.join(WHAT)}, got {args.only}")
    if not torch.cuda.is_available():
        print("torch_time_kernels: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from distributed_eigenspaces_tpu_torch.ops import geometry
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg

    label = args.label or root
    card = cs.card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def emit(what, shape, kernel_ms, library, library_ms, **kw):
        print(json.dumps({"checkout": label, "what": what, "shape": list(shape),
                          "kernel_device_ms": kernel_ms, "library": library,
                          "library_device_ms": library_ms, **kw, "card": card}), flush=True)

    for shape in (cs.ENTRY, cs.CIFAR) if "gram_fp32" in only else ():
        x = torch.randn(shape, generator=gen, device="cuda")
        kernel = [cs.device_ms(lambda: gram_mod.gram_cuda(x)) for _ in range(args.reps)]
        library = [cs.device_ms(lambda: torch.bmm(x.mT, x), launches=None)
                   for _ in range(args.reps)]
        emit("gram_fp32", shape, kernel, "torch.bmm(x.mT, x)", library)
        del x
    for shape in (cs.MG_SLICE,) + MG_STREAMED if "matvec_gram" in only else ():
        c, v = cs.mg_operands(shape, "cuda", 11)

        def three_calls():
            w = torch.matmul(c, torch.matmul(c.T, v))
            return w, w.T @ w

        kernel = [cs.device_ms(lambda: mg.matvec_gram_cuda(c, v)) for _ in range(args.reps)]
        library = [cs.device_ms(three_calls, launches=None) for _ in range(args.reps)]
        emit("matvec_gram", shape, kernel,
             "torch.matmul(C, torch.matmul(C.T, v)) + w.T @ w", library)
        del c, v
    for shape in S8_SHAPES if "gram_s8" in only else ():
        x = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        with geometry.recording() as rec:
            gram_mod.gram_s8_cuda(x)
        launches = len(rec)  # the kernels one call launches in this checkout
        kernel = [cs.device_ms(lambda: gram_mod.gram_s8_cuda(x), launches=launches)
                  for _ in range(args.reps)]

        def int_mm():
            return [torch._int_mm(x[w].mT.contiguous(), x[w]) for w in range(shape[0])]

        library = [cs.device_ms(int_mm, launches=None) for _ in range(args.reps)]
        emit("gram_s8", shape, kernel, "torch._int_mm(x[w].mT.contiguous(), x[w]) per worker",
             library, kernels=[la.kernel for la in rec])
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
