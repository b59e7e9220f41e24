#!/usr/bin/env python3
"""The per-step fit with and without the prefetch producer, on one card.

    python3 scripts/torch_prefetch_ab.py [--reps 3]

Times ``chip_smoke.py``'s ``slice_fit_masked`` step trainer: the cifar10
eval's settings field for field (d=3072, k=10, m=8, n=1024, T=20, subspace
12 cold / 2 warm, bf16 compute, int8 stage, ns warm rounds) through
``OnlineDistributedPCA(cfg, trainer="step").fit(data, worker_masks=masks)``
with its (20, 8) masks, at ``prefetch_depth`` 0 and 2. Two sources of rows:
``rows_on_card`` (drawn on the card, as the phase draws them: each block a
view, the producer only hands it over) and ``rows_on_host`` (the same rows
as numpy: each block copied to the card in the loop, or by the producer
ahead of it). Each rep runs the depths in the order 0, 2, 2, 0 after one untimed
fit of each; every fit ends in ``torch.cuda.synchronize()``.

Prints one JSON line: the card and its power limit, and per source and
depth the host seconds of every fit, their median, and the largest
principal angle between the two depths' bases. Needs a card; imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = (0, 2)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prefetch_ab: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import distributed_eigenspaces_tpu_torch as dett
    from chip_smoke import EVAL_DATA, EVAL_FIT, MASK_DROPS
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    base = dett.PCAConfig(**EVAL_FIT)
    m, n, T = base.num_workers, base.rows_per_worker, base.num_steps
    masks = np.ones((T, m), np.float32)
    for steps, worker in MASK_DROPS:
        masks[list(steps), worker] = 0.0
    spec = dett.planted_subspace(base.dim, **EVAL_DATA)
    card_rows = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    sources = {"rows_on_card": card_rows, "rows_on_host": card_rows.cpu().numpy()}

    def fit(data, depth):
        cfg = dataclasses.replace(base, prefetch_depth=depth)
        est = dett.OnlineDistributedPCA(cfg, device=dev, trainer="step")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.fit(data, worker_masks=masks)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, est

    out = {"script": "scripts/torch_prefetch_ab.py", "card": card,
           "config": "cifar10 eval settings, slice_fit_masked's (20, 8) masks, "
                     "trainer='step'", "order": "0, 2, 2, 0 a rep", "reps": args.reps}
    for name, data in sources.items():
        ests = {depth: fit(data, depth)[1] for depth in DEPTHS}  # untimed
        secs = {depth: [] for depth in DEPTHS}
        for _ in range(args.reps):
            for depth in (0, 2, 2, 0):
                secs[depth].append(fit(data, depth)[0])
        angle = float(principal_angles_degrees(ests[0].components_.cpu(),
                                               ests[2].components_.cpu()).max())
        out[name] = {f"depth_{d}": {"s": s, "median_s": statistics.median(s)}
                     for d, s in secs.items()}
        out[name]["depth_0_vs_2_deg"] = angle
        out[name]["sigma_equal"] = bool(torch.equal(ests[0].state.sigma_tilde,
                                                    ests[2].state.sigma_tilde))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
