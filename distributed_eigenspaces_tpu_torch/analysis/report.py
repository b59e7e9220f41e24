"""Aggregation: run the passes, emit one machine-readable report.

Counterpart of ``distributed_eigenspaces_tpu/analysis/report.py``:

- :func:`run_analysis` — the audit (program matrix + lints), what
  ``scripts/torch_analyze.py --all`` emits;
- :func:`run_mutation_report` — the self-test (:mod:`.mutations`).

Both run on ``device="cuda"`` unless the caller asks for the CPU, and raise
without a card. ``engine_report`` waits for ROADMAP Queue 1 item 17b (the port's
``MetricsLogger`` is ready for it).
"""

from __future__ import annotations

from distributed_eigenspaces_tpu_torch.device import resolve_device

SCHEMA = "analysis-torch-v1"


def _violations_json(viols) -> list[dict]:
    return [
        {
            "program": v.program,
            "rule": v.rule,
            "message": v.message,
            "location": v.location,
        }
        for v in viols
    ]


def run_analysis(
    program_names=None,
    *,
    lints: bool = True,
    root: str | None = None,
    device="cuda",
) -> dict:
    """The audit. ``program_names=None`` runs the whole matrix; pass a
    subset for a targeted run, ``[]`` for the lints alone."""
    from distributed_eigenspaces_tpu_torch.analysis import (
        ast_lints,
        contracts,
        programs,
    )

    dev = resolve_device(device)
    names = list(programs.PROGRAMS if program_names is None else program_names)
    report: dict = {
        "schema": SCHEMA,
        "device": str(dev),
        "programs": {},
        "lints": {},
        "ok": True,
        "n_violations": 0,
    }
    for name in names:
        built = programs.build_program(name, dev)
        viols, detail = contracts.check_program(built)
        detail["source"] = built.source
        detail["violations"] = _violations_json(viols)
        report["programs"][name] = detail
        report["n_violations"] += len(viols)
    if lints:
        viols = ast_lints.lint_concurrency(root)
        report["lints"]["concurrency"] = {
            "ok": not viols,
            "violations": _violations_json(viols),
        }
        report["n_violations"] += len(viols)
    report["ok"] = report["n_violations"] == 0
    return report


def run_mutation_report(device="cuda") -> dict:
    """The gate's self-test: every seeded violation class must be caught
    with its expected rule."""
    from distributed_eigenspaces_tpu_torch.analysis import mutations

    ok, records = mutations.run_mutation_checks(device)
    return {"schema": SCHEMA, "ok": ok, "mutations": records}
