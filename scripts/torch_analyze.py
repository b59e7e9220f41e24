#!/usr/bin/env python3
"""Program-contract analyzer of the PyTorch port.

Runs every program of the port's audit matrix (``distributed_eigenspaces_
tpu_torch/analysis/programs.py``) once at its audit shapes and holds it
against its contract (``analysis/contracts.py``): the kernel tile budget
over the launch geometry of its hand-written kernels, and no dense d x d
buffer in a factor-only program. Then the lock-discipline lint over the
port's threaded runtime. ``--mutation-check`` also runs the self-test: each
seeded violation (a d x d temp, a kernel whose one CTA owns the whole
operand, three lock-discipline fixtures) must be CAUGHT.

Usage:
    python scripts/torch_analyze.py --all [--mutation-check] [--json OUT]
    python scripts/torch_analyze.py --all --mutation-check --device cpu
    python scripts/torch_analyze.py --programs pallas_matvec_gram,serve_project_solo
    python scripts/torch_analyze.py --lints-only
    python scripts/torch_analyze.py --list

It runs on the card (``--device cuda``, the default; it raises without one):
the kernels launch at the audit shapes and their recorded launches are
audited. ``--device cpu`` runs the plain versions and audits the launches
the ``*_launch`` functions declare for the same shapes.

Exit code 0 iff every audited program honours its contract, the lint is
clean and (with ``--mutation-check``) every seeded violation was caught.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="audit the full program matrix + lints")
    ap.add_argument("--programs", default=None,
                    help="comma-separated subset of the matrix")
    ap.add_argument("--lints-only", action="store_true",
                    help="run only the AST lint (no program runs)")
    ap.add_argument("--mutation-check", action="store_true",
                    help="also require every seeded violation caught")
    ap.add_argument("--list", action="store_true",
                    help="list the audited program matrix and exit")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the machine-readable report here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the programs run (default cuda; raises "
                         "without a card)")
    args = ap.parse_args(argv)

    from distributed_eigenspaces_tpu_torch.analysis import report as report_mod

    if args.list:
        from distributed_eigenspaces_tpu_torch.analysis import contracts, programs

        for name in programs.PROGRAMS:
            print(name)
        print("\ncontracts:")
        for key, c in contracts.CONTRACTS.items():
            print(f"  {key}: {c.description}")
        return 0
    if not (args.all or args.programs or args.lints_only):
        ap.error("pick one of --all / --programs / --lints-only / --list")

    t0 = time.time()
    out: dict = {"schema": report_mod.SCHEMA, "device": args.device}
    failures = 0
    if args.lints_only:
        rep = report_mod.run_analysis([], lints=True, device=args.device)
    else:
        subset = [s for s in args.programs.split(",") if s] if args.programs else None
        rep = report_mod.run_analysis(subset, lints=not args.programs,
                                      device=args.device)
    out["analysis"] = rep
    failures += rep["n_violations"]

    print(f"programs audited on {rep['device']}: {len(rep['programs'])}")
    for name, entry in rep["programs"].items():
        pal, mem = entry["pallas"], entry["memory"]
        print(f"  {name:26s} {'ok' if entry['ok'] else 'FAIL':4s} "
              f"contract={entry['contract']:16s} launches={pal['n_pallas_calls']} "
              f"max_cta_elems={pal['max_block_elems_seen']:6d} "
              f"policy={mem['policy']}")
    for key, entry in rep["lints"].items():
        print(f"  lint:{key:21s} {'ok' if entry['ok'] else 'FAIL'}"
              f"   violations={len(entry['violations'])}")
    for entries in (rep["programs"].values(), rep["lints"].values()):
        for entry in entries:
            for v in entry["violations"]:
                print(f"    VIOLATION {v['program']}: {v['rule']}: "
                      f"{v['message']} [{v['location']}]")

    if args.mutation_check:
        mut = report_mod.run_mutation_report(device=args.device)
        out["mutation_check"] = mut
        n_caught = sum(1 for r in mut["mutations"] if r["caught"])
        print(f"mutation check: {n_caught}/{len(mut['mutations'])} "
              "seeded violation classes caught")
        for r in mut["mutations"]:
            print(f"  {r['mutation']:24s} {'caught' if r['caught'] else 'MISSED'}  "
                  f"rule={r['expected_rule']}")
            failures += not r["caught"]

    out["elapsed_s"] = round(time.time() - t0, 2)
    out["ok"] = failures == 0
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2, sort_keys=True)
        print(f"report -> {args.json}")
    print(f"torch_analyze: {'PASS' if out['ok'] else 'FAIL'} ({out['elapsed_s']}s)")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
