#!/usr/bin/env python3
"""Alternating A/B runs of ``chip_smoke.py`` in two checkouts, one card.

    python3 scripts/torch_smoke_ab.py --parent DIR --change DIR [--pairs 5] [--out DIR]

Runs ``python3 chip_smoke.py`` in the two checkouts in the order parent,
change, change, parent, parent, change, ... until each side has run
``--pairs`` times, so a drift of the machine over the call falls on both
sides alike. Each run's output goes to ``--out/<side><i>.log``. Then it
prints one JSON line per fit and side: the median, least and greatest of
that fit's seconds over the side's runs, from the smoke's own phase lines
(the second fit of ``slice_fit``, of ``slice_fit_eval``'s cifar10 and
synthetic1024 fits and of ``slice_dsolve``'s large-d fit; the first and
only fit of the later fits where the side has them). A run that exits
non-zero ends the script with its code.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (name, phase, keys the line must hold, seconds key)
FITS = (
    ("slice_fit", "slice_fit", {}, "second_fit_s"),
    ("cifar10", "slice_fit_eval", {"eval": "cifar10"}, "second_fit_s"),
    ("synthetic1024", "slice_fit_eval", {"eval": "synthetic1024"}, "second_fit_s"),
    ("large_d", "slice_dsolve", {"part": "fit"}, "second_fit_s"),
    ("clip768", "slice_clip768", {}, "fit_s"),
    ("segmented_checkpointed", "slice_fit_eval_segmented", {}, "fit_s"),
    ("masked", "slice_fit_masked", {}, "fit_s"),
    ("interval", "slice_fit_interval", {"knobs": {"merge_interval": 2}}, "fit_s"),
    ("pipelined", "slice_fit_interval",
     {"knobs": {"merge_interval": 2, "pipeline_merge": True}}, "fit_s"),
)


def fit_seconds(lines) -> dict:
    """``{fit name: seconds}`` from one smoke run's JSON phase lines."""
    out = {}
    for line in lines:
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        for name, phase, keys, field in FITS:
            if rec.get("phase") == phase and field in rec and all(
                    rec.get(k) == v for k, v in keys.items()):
                out[name] = rec[field]
    return out


def order(pairs: int) -> list:
    """parent, change, change, parent, ...: ``pairs`` runs of each side."""
    seq = []
    while len(seq) < 2 * pairs:
        seq += ["parent", "change"] if len(seq) % 4 == 0 else ["change", "parent"]
    return seq[:2 * pairs]


def summary(runs: dict) -> list:
    """One record per fit and side: median, least and greatest seconds."""
    rows = []
    for name, *_ in FITS:
        for side in ("parent", "change"):
            vals = [r[name] for r in runs[side] if name in r]
            if vals:
                rows.append({"fit": name, "side": side, "runs": len(vals),
                             "median_s": statistics.median(vals), "min_s": min(vals),
                             "max_s": max(vals), "all_s": vals})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--change", required=True, help="checkout of the change")
    ap.add_argument("--pairs", type=int, default=5, help="runs of each side")
    ap.add_argument("--out", default="chiprun_out/smoke_ab", help="directory of the run logs")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    runs = {"parent": [], "change": []}
    for side in order(args.pairs):
        i = len(runs[side]) + 1
        root = os.path.abspath(getattr(args, side))
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                              capture_output=True, text=True)
        with open(os.path.join(args.out, f"{side}{i}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(f"{side}{i}: chip_smoke.py exited {proc.returncode}", file=sys.stderr)
            return proc.returncode
        runs[side].append(fit_seconds(proc.stdout.splitlines()))
        print(json.dumps({"run": f"{side}{i}", "fits": runs[side][-1]}), flush=True)
    for row in summary(runs):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
