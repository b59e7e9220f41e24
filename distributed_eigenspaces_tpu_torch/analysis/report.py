"""Aggregation: run the passes, emit one machine-readable report.

Counterpart of ``distributed_eigenspaces_tpu/analysis/report.py``:

- :func:`run_analysis` — the audit (program matrix + lints), what
  ``scripts/torch_analyze.py --all`` emits: per program the collective
  schedule, the memory footprint, the kernel tiles and the cost model's
  measured costs and byte budget;
- :func:`run_mutation_report` — the self-test (:mod:`.mutations`);
- :func:`engine_report` — audit a live ``TransformEngine``'s acquired
  bucket programs: the report ``MetricsLogger.attach_analysis`` lands in
  ``summary()["analysis"]``.

The first two run on ``device="cuda"`` unless the caller asks for the CPU,
and raise without a card. The program matrix's mesh programs and mesh
mutations come from one launch of ranks a process (``programs.
build_matrix``), which both share.
"""

from __future__ import annotations

from distributed_eigenspaces_tpu_torch.device import resolve_device

SCHEMA = "analysis-torch-v2"


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
    """The audit. ``program_names=None`` runs the whole matrix
    (``programs.MATRIX``); pass a subset for a targeted run, ``[]`` for the
    lints alone."""
    from distributed_eigenspaces_tpu_torch.analysis import (
        ast_lints,
        contracts,
        programs,
    )

    dev = resolve_device(device)
    names = list(programs.MATRIX if program_names is None else program_names)
    report: dict = {
        "schema": SCHEMA,
        "device": str(dev),
        "programs": {},
        "lints": {},
        "ok": True,
        "n_violations": 0,
    }
    built, _ = programs.build_matrix(names, device=dev)
    for name in names:
        viols, detail = contracts.check_program(built[name])
        detail["source"] = built[name].source
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


def engine_report(engine) -> dict:
    """Contract audit of a live ``TransformEngine``'s acquired bucket
    programs (``engine._cache``): each runs once on zero operands of its
    bucket's shape, under the collective recorder and the buffer trace,
    called directly — the engine's acquisition counters do not move.

    The memory pass runs only on buckets whose row count sits below ``d``
    (the premise that makes the dense-shape rule exact — a (rows, d)
    activation with rows >= d is legitimately 'dense' by shape and proves
    nothing). A sharded-basis engine is audited against the reference's
    ``dist_serve`` contract, not ported yet (ROADMAP Queue 1 item 17c)."""
    import torch

    from distributed_eigenspaces_tpu_torch.analysis import contracts
    from distributed_eigenspaces_tpu_torch.analysis.programs import trace_buffers
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    if getattr(engine, "basis_spec", None) is not None:
        raise NotImplementedError(
            "engine_report of a sharded-basis engine (the dist_serve "
            "contract) is not ported to distributed_eigenspaces_tpu_torch "
            "yet (ROADMAP.md Queue 1 item 17c)"
        )
    contract = contracts.CONTRACTS["serve_transform"]
    out: dict = {
        "schema": SCHEMA,
        "contract": contract.name,
        "programs": {},
        "ok": True,
        "n_violations": 0,
    }
    dev = engine.device
    for (kind, rows), fn in sorted(engine._cache.items()):
        params = contracts.ProgramParams(d=engine.d, k=engine.k, rows=rows)
        name = f"serve_{kind}_rows{rows}"
        width = engine.k if kind == "reconstruct" else engine.d
        second = (rows, engine.k) if kind == "residual" else (engine.d, engine.k)
        args = (torch.zeros((rows, width), dtype=engine.dtype, device=dev),
                torch.zeros(second, dtype=torch.float32, device=dev))
        with pmesh.recording_collectives() as log:
            _, buffers = trace_buffers(fn, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        viols, col = contracts.check_collectives(contract, params, log, program=name)
        entry: dict = {"collectives": col}
        if rows < contract.dense_dim(params):
            mv, mem = contracts.check_memory(
                contract, params, program=name, buffers=buffers
            )
            viols += mv
            entry["memory"] = mem
        entry["ok"] = not viols
        entry["violations"] = _violations_json(viols)
        out["programs"][name] = entry
        out["n_violations"] += len(viols)
    out["ok"] = out["n_violations"] == 0
    return out
