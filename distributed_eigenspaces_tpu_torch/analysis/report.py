"""Aggregation: run the passes, emit one machine-readable report.

Counterpart of ``distributed_eigenspaces_tpu/analysis/report.py``:

- :func:`run_analysis` — the audit (program matrix + lints), what
  ``scripts/torch_analyze.py --all`` emits: per program the collective
  schedule, the memory footprint, the kernel tiles, the declared layouts
  against every rank's held shapes and the cost model's measured costs and
  byte budget;
- :func:`run_mutation_report` — the self-test (:mod:`.mutations`);
- :func:`engine_report` — audit a live ``TransformEngine``'s acquired
  bucket programs (a sharded-basis engine's on every rank of its group):
  the report ``MetricsLogger.attach_analysis`` lands in
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

    A sharded-basis engine (``basis_spec``) is audited against the
    ``dist_serve`` contract, the others against ``serve_transform``. On a
    mesh of ranks every rank of the engine's group calls this together (a
    sharded bucket's run includes the sum over ``features`` the engine pairs
    with a projection), and each audits its own buckets: operands of its
    ``(rows, d_local)`` shard and ``(d_local, k)`` basis rows, whose
    layouts the sharding pass holds against the global ``(rows * workers,
    d)`` and ``(d, k)``.

    The memory pass, and the sharding pass of a sharded engine, run only on
    buckets whose row count sits below ``d`` (the premise that makes the
    shape rules exact — a (rows, d) activation with rows >= d is
    legitimately 'dense' by shape, and its rows axis reaches the floor of
    an un-sharded ``(d, k)``: it proves nothing)."""
    import torch

    from distributed_eigenspaces_tpu_torch.analysis import contracts
    from distributed_eigenspaces_tpu_torch.analysis.programs import trace_buffers
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    sharded = getattr(engine, "basis_spec", None) is not None
    contract = contracts.CONTRACTS["dist_serve" if sharded else "serve_transform"]
    out: dict = {
        "schema": SCHEMA,
        "contract": contract.name,
        "programs": {},
        "ok": True,
        "n_violations": 0,
    }
    dev = engine.device
    d_in = engine.d_local  # d itself unless the basis is sharded
    for (kind, rows), fn in sorted(engine._cache.items()):
        params = contracts.ProgramParams(d=engine.d, k=engine.k, rows=rows)
        name = f"serve_{kind}_rows{rows}"
        width = engine.k if kind == "reconstruct" else d_in
        second = (rows, engine.k) if kind == "residual" else (d_in, engine.k)
        args = (torch.zeros((rows, width), dtype=engine.dtype, device=dev),
                torch.zeros(second, dtype=torch.float32, device=dev))
        call = fn
        if sharded and kind == "project":  # with the engine's sum over features
            def call(x, v, fn=fn):
                return engine._psum(fn(x, v).float())
        with pmesh.recording_collectives() as log:
            result, buffers = trace_buffers(call, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        viols, col = contracts.check_collectives(contract, params, log, program=name)
        entry: dict = {"collectives": col}
        v, entry["shardings"] = _sharded_bucket_layout(
            engine, contract, kind, rows, args, result, buffers, name)
        viols += v
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


def _sharded_bucket_layout(engine, contract, kind, rows, args, result, buffers, name):
    """The sharding pass over one bucket of a sharded-basis engine on this
    rank: its operands and result against the global shapes of a bucket of
    ``rows`` rows on each of the mesh's workers (none on another engine,
    or where those rows reach ``d``)."""
    from distributed_eigenspaces_tpu_torch.analysis import contracts, shardings
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    if getattr(engine, "basis_spec", None) is None:
        return [], {"checked": False, "reason": "unsharded program"}
    axes = dict(engine.mesh.shape)
    rows_all = rows * axes.get(pmesh.WORKER_AXIS, 1)
    d, k = engine.d, engine.k
    if rows_all >= d:
        return [], {"checked": False, "reason": "rows >= d: the shape rules prove nothing"}
    glob = {"project": ([(rows_all, d), (d, k)], [(rows_all, k)]),
            "reconstruct": ([(rows_all, k), (d, k)], [(rows_all, d)]),
            "residual": ([(rows_all, d), (rows_all, k)], [(rows_all,), (rows_all,)])}[kind]
    params = contracts.ProgramParams(
        d=d, k=k, rows=rows_all, n_feature_shards=axes.get(pmesh.FEATURE_AXIS, 1),
        n_workers_mesh=axes.get(pmesh.WORKER_AXIS, 1))
    floor = contract.sharding.replicated_axis_floor(params)
    held = shardings.held_shapes(pmesh.rank(), args, result, buffers, floor)
    return shardings.check_shardings(
        contract.sharding, params, program=name, dense_dim=contract.dense_dim(params),
        axis_sizes=axes, in_global=glob[0], out_global=glob[1], held=held)
