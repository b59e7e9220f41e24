#!/usr/bin/env python3
"""Scenario replay of the PyTorch/CUDA port on the card, judged by SLO.

    python3 scripts/torch_scenario.py [scenarios/ci_smoke.json] \
        [--out VERDICT.json] [--trace-out TRACE.json]

Replays a declarative scenario spec (``scenarios/*.json``) against the
port's full stack on the card (fit, registry, ``QueryServer``,
``FleetServer``, ``DriftMonitor``, elastic membership, population ingest)
through ``distributed_eigenspaces_tpu_torch.runtime.scenario``, and prints
the pure-telemetry verdict as ONE JSON line: per-episode SLO attainment and
error-budget burn, the p99 latency decomposition, shed / breaker /
lane-restart counts, and recovery time from each injected fault, every
judged number computed from ``MetricsLogger.summary()`` alone.

Exit code 0 iff every hard gate in the verdict holds. ``--out`` also writes
the verdict to a file; ``--trace-out`` exports the replay's Chrome trace
(episodes as a top-level Perfetto track). The autoscaler arms are a
``run_scenario(controller=, plan=)`` parameter, not a flag. It imports
nothing of JAX or of the JAX package, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# runnable as `python3 scripts/torch_scenario.py` from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument(
        "spec", nargs="?", default="scenarios/ci_smoke.json",
        help="scenario spec JSON (schema: docs/OBSERVABILITY.md "
             "'Scenario verdicts')",
    )
    p.add_argument(
        "--out", default=None,
        help="also write the verdict record to this path",
    )
    p.add_argument(
        "--trace-out", default=None,
        help="export the replay's Chrome trace (episodes as a "
             "top-level Perfetto track) to this path",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from distributed_eigenspaces_tpu_torch.runtime.scenario import run_scenario

    verdict, ok = run_scenario(args.spec, trace_out=args.trace_out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2)
            f.write("\n")
    print(json.dumps(verdict))
    if not ok:
        print(
            json.dumps({
                "scenario_fail": verdict.get("scenario_fail"),
                "spec": args.spec,
            }),
            file=sys.stderr,
        )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
