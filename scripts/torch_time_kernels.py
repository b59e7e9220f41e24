#!/usr/bin/env python3
"""Device times of the fp32 Gram and the fused matvec + Gram kernels of a
checkout, beside their PyTorch yardsticks, on one card.

    python3 scripts/torch_time_kernels.py [--root DIR] [--label NAME]

``--root`` is the checkout whose kernels are built and timed (default: this
one), so that two commits can be compared in one run on one card: unpack
the other with ``git archive`` into a directory ``.gitignore`` lists and
run this script on each in turns (A, B, B, A). It uses that checkout's own
``chip_smoke.py`` helpers (``device_ms``, the operands) and prints one JSON
line per measurement: the fp32 Gram at the entry shape (4, 128, 256) and at
the CIFAR-10 shape (8, 1024, 3072) beside ``torch.bmm``, and the fused sweep
beside cuBLAS's three calls at the slice shape (12288, 200, 58) and at three
shapes of the streamed plan: eight and sixteen workers' factors at k = 50,
and k' = 840. The card's
name and power limit come first. It imports nothing of JAX or of the JAX
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


def main(argv=None) -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here, help="the checkout to time")
    ap.add_argument("--label", default=None, help="a name for the checkout in the output")
    ap.add_argument("--reps", type=int, default=3, help="device_ms windows per measurement")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_time_kernels: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg

    label = args.label or root
    card = cs.card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def emit(what, shape, kernel_ms, library, library_ms):
        print(json.dumps({"checkout": label, "what": what, "shape": list(shape),
                          "kernel_device_ms": kernel_ms, "library": library,
                          "library_device_ms": library_ms, "card": card}), flush=True)

    for shape in (cs.ENTRY, cs.CIFAR):
        x = torch.randn(shape, generator=gen, device="cuda")
        kernel = [cs.device_ms(lambda: gram_mod.gram_cuda(x)) for _ in range(args.reps)]
        library = [cs.device_ms(lambda: torch.bmm(x.mT, x), launches=None)
                   for _ in range(args.reps)]
        emit("gram_fp32", shape, kernel, "torch.bmm(x.mT, x)", library)
        del x
    for shape in (cs.MG_SLICE,) + MG_STREAMED:
        c, v = cs.mg_operands(shape, "cuda", 11)

        def three_calls():
            w = torch.matmul(c, torch.matmul(c.T, v))
            return w, w.T @ w

        kernel = [cs.device_ms(lambda: mg.matvec_gram_cuda(c, v)) for _ in range(args.reps)]
        library = [cs.device_ms(three_calls, launches=None) for _ in range(args.reps)]
        emit("matvec_gram", shape, kernel,
             "torch.matmul(C, torch.matmul(C.T, v)) + w.T @ w", library)
        del c, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
