#!/usr/bin/env python3
"""Program-contract analyzer of the PyTorch port.

Runs every program of the port's audit matrix (``distributed_eigenspaces_
tpu_torch/analysis/programs.py``: four single-device serve and kernel
programs, and 23 mesh programs on one launch of 4 gloo ranks) once at its
audit shapes and holds it against its contract (``analysis/contracts.py``):
the collective schedule and payload bounds read from the run's recorded
collectives, the kernel tile budget over the launch geometry of its
hand-written kernels, no dense d x d buffer in a factor-only program, the
declared layouts against the shapes every rank held (``analysis/
shardings.py``), and the cost model's per-op byte budget. Then the
lock-discipline lint over the port's threaded runtime.
``--mutation-check`` also runs the self-test: each of the 14 seeded
violations (a dense psum, a tree tier over its payload or byte budget, a
population gather, a dropped wire codec, a d x d temp, a (d, k) basis held
whole, a distributed solve or a deflation lane gathering d-wide rows, a
kernel whose one CTA owns the whole operand, an infeasible plan, three
lock-discipline fixtures) must be CAUGHT.

Usage:
    python scripts/torch_analyze.py --all [--mutation-check] [--json OUT]
    python scripts/torch_analyze.py --all --mutation-check --device cpu
    python scripts/torch_analyze.py --costs [--write-costs]
    python scripts/torch_analyze.py --plan [--write-plan]
    python scripts/torch_analyze.py --programs pallas_matvec_gram,scan_solo
    python scripts/torch_analyze.py --lints-only
    python scripts/torch_analyze.py --list

It runs on the card (``--device cuda``, the default; it raises without one):
the kernels launch at the audit shapes and their recorded launches are
audited, and the mesh programs' ranks share the card. ``--device cpu`` runs
the plain versions and audits the launches the ``*_launch`` functions
declare for the same shapes.

``--costs`` regenerates the cost snapshot and diff-gates it against the
committed ``ANALYSIS_COSTS_TORCH.json``; the snapshot is always made on the
CPU (``analysis/costmodel.py`` says why), whatever ``--device`` says.
``--write-costs`` commits it. ``--plan`` replans the default workload
(``analysis/planner.py``) from the card's calibration record
``PLAN_CALIBRATION_H100.json``, diff-gates the artifact against the
committed ``ANALYSIS_PLAN_TORCH.json`` and prints the model-vs-measured
drift rows: a ``warn`` row (>= 2x) is printed, a ``fail`` row (>= 5x) or a
``missing`` one fails. ``--write-plan`` commits the plan.

Exit code 0 iff every audited program honours its contract, the lint is
clean, the snapshot and the plan have no drift, and (with
``--mutation-check``) every seeded violation was caught.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _print_analysis(rep: dict) -> None:
    print(f"programs audited on {rep['device']}: {len(rep['programs'])}")
    for name, entry in rep["programs"].items():
        pal, mem, col = entry["pallas"], entry["memory"], entry["collectives"]
        shard = entry["shardings"]
        held = (f"sharded_ok={shard['n_sharded_ok']}" if shard["checked"]
                else f"layout={shard['reason'].replace(' ', '_')}")
        print(f"  {name:26s} {'ok' if entry['ok'] else 'FAIL':4s} "
              f"contract={entry['contract']:16s} collectives={col['n_collectives']:3d} "
              f"max_payload={col['max_payload_elems']:6d} "
              f"launches={pal['n_pallas_calls']} "
              f"max_cta_elems={pal['max_block_elems_seen']:6d} "
              f"policy={mem['policy']} {held}")
    for key, entry in rep["lints"].items():
        print(f"  lint:{key:21s} {'ok' if entry['ok'] else 'FAIL'}"
              f"   violations={len(entry['violations'])}")
    for entries in (rep["programs"].values(), rep["lints"].values()):
        for entry in entries:
            for v in entry["violations"]:
                print(f"    VIOLATION {v['program']}: {v['rule']}: "
                      f"{v['message']} [{v['location']}]")


def _costs(args, out: dict) -> int:
    """``--costs`` / ``--write-costs``: the snapshot, made on the CPU."""
    from distributed_eigenspaces_tpu_torch.analysis import costmodel
    from distributed_eigenspaces_tpu_torch.analysis.report import _violations_json

    snap = costmodel.cost_snapshot()
    if args.write_costs:
        path = costmodel.snapshot_path()
        with open(path, "w", encoding="utf-8") as f:
            f.write(costmodel.dumps_snapshot(snap))
        print(f"cost snapshot -> {path}")
    drift = costmodel.check_snapshot(snap, costmodel.load_snapshot())
    proj = snap["projections"]
    claims_ok = (proj["audit_shapes"]["flat_over_tree"] >= 4.0
                 and proj["large_d"]["flat_over_tree"] >= 4.0)
    out["costs"] = {"schema": snap["schema"], "snapshot": snap,
                    "drift": _violations_json(drift), "claims_ok": claims_ok,
                    "ok": not drift and claims_ok}
    print("cost model (made on the CPU):")
    for name, ent in snap["programs"].items():
        axes = ", ".join(f"{a}={e['bytes_on_wire']}B/{e['hops']}h"
                         for a, e in ent["collectives_per_axis"].items()) or "-"
        print(f"  {name:26s} flops={ent['flops']:8d} "
              f"budget/op={ent['budget_bytes_per_op']:6d}B wire[{axes}]")
    print(f"  tree payload: flat/tree = {proj['audit_shapes']['flat_over_tree']}x at "
          f"audit shapes, {proj['large_d']['flat_over_tree']}x at "
          f"d={proj['large_d']['d']} (claim >= 4x: {'ok' if claims_ok else 'FAIL'})")
    for name, b in proj["tier_deadline_budgets_large_d"].items():
        print(f"  tier {name:6s} fan_in={b['fan_in']:3d} "
              f"{b['wire_bytes_per_round']:>12d} B/round -> "
              f"{b['modeled_ms_per_round']} ms at {b['assumed_gb_per_sec']} GB/s")
    for v in drift:
        print(f"    VIOLATION {v.program}: {v.rule}: {v.message} [{v.location}]")
    return len(drift) + (not claims_ok)


def _plan(args, out: dict) -> int:
    """``--plan`` / ``--write-plan``: replan the default workload, diff-gate
    and drift-check it."""
    from distributed_eigenspaces_tpu_torch.analysis import costmodel, planner
    from distributed_eigenspaces_tpu_torch.analysis.report import _violations_json

    try:
        plan = planner.make_plan()
    except planner.PlanInfeasible as e:
        # the committed default workload must stay plannable
        print(f"plan: INFEASIBLE: {e}")
        out["plan"] = {"ok": False, "infeasible": str(e)}
        return 1
    if args.write_plan:
        path = planner.plan_file_path()
        with open(path, "w", encoding="utf-8") as f:
            f.write(costmodel.dumps_snapshot(plan))
        print(f"plan -> {path}")
    plan_drift = planner.check_plan(plan, planner.load_plan())
    rows = planner.drift_check(plan)
    n_warn = sum(1 for r in rows if r["status"] == "warn")
    n_fail = sum(1 for r in rows if r["status"] in ("fail", "missing"))
    out["plan"] = {"schema": plan["schema"], "plan_id": plan["plan_id"],
                   "chosen": plan["chosen"]["config_overrides"],
                   "predicted": plan["chosen"]["predicted"],
                   "drift": _violations_json(plan_drift),
                   "model_vs_measured": rows, "ok": not plan_drift and n_fail == 0}
    ch = plan["chosen"]
    print(f"plan: {plan['plan_id']} ({plan['candidates_considered']} candidates, "
          f"{sum(plan['rejected'].values())} rejected)")
    for knob, val in sorted(ch["config_overrides"].items()):
        print(f"  {knob:22s} = {val}")
    pred = ch["predicted"]
    print(f"  predicted serve p99 = {pred['serve']['predicted_p99_ms']} ms "
          f"(SLO {plan['workload']['slo_p99_ms']} ms), "
          f"fit {pred['fit_ms_per_step']} ms/step")
    print(f"model vs measured (warn >= {planner.DRIFT_WARN_RATIO}x, "
          f"fail >= {planner.DRIFT_FAIL_RATIO}x):")
    for r in rows:
        print(f"  {r['anchor']:26s} {r['status']:7s} predicted={r.get('predicted')} "
              f"measured={r.get('measured')} ratio={r.get('ratio', '-')}")
    for v in plan_drift:
        print(f"    VIOLATION {v.program}: {v.rule}: {v.message} [{v.location}]")
    if n_warn:
        print(f"  plan drift: {n_warn} anchor(s) in the warn band — re-record "
              "the calibration or revisit the model before they hit the fail "
              "threshold")
    return len(plan_drift) + n_fail


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
    ap.add_argument("--costs", action="store_true",
                    help="regenerate the cost snapshot (on the CPU) and "
                         "diff-gate it against ANALYSIS_COSTS_TORCH.json")
    ap.add_argument("--write-costs", action="store_true",
                    help="write the regenerated snapshot to "
                         "ANALYSIS_COSTS_TORCH.json")
    ap.add_argument("--plan", action="store_true",
                    help="replan the default workload, diff-gate it against "
                         "ANALYSIS_PLAN_TORCH.json, and drift-check the "
                         "plan's anchors against the card's record")
    ap.add_argument("--write-plan", action="store_true",
                    help="write the regenerated plan to ANALYSIS_PLAN_TORCH.json")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the machine-readable report here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the programs run (default cuda; raises "
                         "without a card)")
    args = ap.parse_args(argv)

    from distributed_eigenspaces_tpu_torch.analysis import report as report_mod

    if args.list:
        from distributed_eigenspaces_tpu_torch.analysis import contracts, programs

        for name in programs.MATRIX:
            print(name)
        print("\ncontracts:")
        for key, c in contracts.CONTRACTS.items():
            print(f"  {key}: {c.description}")
        return 0
    gates = (args.costs, args.write_costs, args.plan, args.write_plan)
    if not (args.all or args.programs or args.lints_only or any(gates)):
        ap.error("pick one of --all / --programs / --lints-only / --costs / "
                 "--plan / --list")

    t0 = time.time()
    out: dict = {"schema": report_mod.SCHEMA, "device": args.device}
    failures = 0
    if args.all or args.programs or args.lints_only:
        if args.lints_only:
            rep = report_mod.run_analysis([], lints=True, device=args.device)
        else:
            subset = [s for s in args.programs.split(",") if s] if args.programs else None
            rep = report_mod.run_analysis(subset, lints=not args.programs,
                                          device=args.device)
        out["analysis"] = rep
        failures += rep["n_violations"]
        _print_analysis(rep)

    if args.costs or args.write_costs:
        failures += _costs(args, out)
    if args.plan or args.write_plan:
        failures += _plan(args, out)

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
