#!/usr/bin/env python3
"""The fp32 serve route's basis budget, measured against two alternatives.

    python3 scripts/torch_profile_serve_f32.py [--json OUT]

``det_serve_project_f32`` runs the split serve kernel with an unrounded
fp32 basis, a 32-bit word per value. With whole-k column tiles (k = 10,
from 1,056 rows on) the basis of d = 3072 takes 33,792 words (135 KB),
over the bf16 routes' budget, so the fp32 route has a budget of its own.
This script builds copies of ``csrc/serve_project.cu`` and times the fp32
route of each at d = 3072, k = 10 and 2,048, 8,192 and 65,536 rows (fp32
x, an orthonormal basis):

- ``own_budget``: the source as it is (one CTA per SM holds the whole
  basis);
- ``bf16_budget``: the fp32 route held to the bf16 routes' budget, so the
  whole-k basis is restaged per 4-row item in d chunks;
- ``three_pairs``: tiles of at most 3 column pairs (6 columns), so k = 10
  takes two tiles whose basis fits the bf16 routes' budget, and x is read
  twice.

Each build's rows must equal the unchanged build's (the order of every
sum does not depend on the tile or the chunk). Times: CUDA events over 50
back-to-back launches, three rounds alternating the builds; one JSON line
per (build, rows). The copies are built by
``scripts/torch_kernel_copies.py``. It prints the card's name and power
limit first, imports nothing of JAX or of the JAX package, needs a card, and
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch_kernel_copies as kc

D, K = 3072, 10
ROWS = (2048, 8192, 65536)
ROUNDS, REPS = 3, 50
SOURCE = "serve_project.cu"

BUDGET = "constexpr int S_F32_BASIS_WORDS = 49152;"
NP_LINE = "  const int np = split_np(rows, k);\n#define DET_SPLIT_CASE"
VARIANTS = {
    "own_budget": lambda s: s,
    "bf16_budget": lambda s: kc.edit(
        s, BUDGET, "constexpr int S_F32_BASIS_WORDS = 24576;", SOURCE),
    "three_pairs": lambda s: kc.edit(
        s, NP_LINE, "  const int np = B == kF32 && split_np(rows, k) > 3 ? 3 : "
                    "split_np(rows, k);\n#define DET_SPLIT_CASE", SOURCE),
}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    if not kc.require_card("torch_profile_serve_f32"):
        return 2
    card = kc.card()
    libs = kc.build("serve_project", VARIANTS, {"det_serve_project_f32": [
        kc.PTR, kc.PTR, kc.PTR, kc.INT, kc.INT, kc.INT, kc.INT, kc.PTR]})
    gen = torch.Generator(device="cuda").manual_seed(0)
    v = torch.linalg.qr(torch.randn((D, K), generator=gen, device="cuda"))[0].contiguous()
    results = []
    for rows in ROWS:
        x = torch.randn((rows, D), generator=gen, device="cuda")
        outs = {name: torch.empty((rows, K), device="cuda") for name in libs}

        def launch(name, x=x, outs=outs, rows=rows):
            kc.checked(libs[name].det_serve_project_f32(
                x.data_ptr(), v.data_ptr(), outs[name].data_ptr(), rows, D, K, 1,
                torch.cuda.current_stream().cuda_stream), name)

        for name in libs:
            launch(name)
        torch.cuda.synchronize()
        for name in libs:
            if not torch.equal(outs[name], outs["own_budget"]):
                raise RuntimeError(f"{name} at {rows} rows: rows differ from the source's")
        fns = {name: (lambda name=name: launch(name)) for name in libs}
        for name, times in kc.rounds(fns, ROUNDS, REPS).items():
            row = {"build": name, "rows": rows, "d": D, "k": K, "ms_per_launch": times,
                   "rounds": ROUNDS, "reps": REPS, "card": card}
            results.append(row)
            print(json.dumps(row), flush=True)
        del x, outs
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
