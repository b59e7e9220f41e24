"""Mutation self-tests: the gate that checks the checker.

Counterpart of ``distributed_eigenspaces_tpu/analysis/mutations.py``, for
the mutations whose passes this package has, under the JAX keys and rules.
Each seeds ONE violation class — a reintroduced dense ``psum``, a tree tier
moving the factor stack, a materialized ``d x d`` temp, a ``(d, k)`` basis
held whole where it is declared sharded, a distributed solve or a deflation
lane gathering d-wide rows, a kernel whose one CTA owns the whole operand,
a plan whose budgets it cannot meet, a blocking call under a lock, … — and
requires the matching checker to flag it with the expected rule. A
static-analysis stage that can only pass is worthless.

The mesh mutants (:data:`MESH_SEEDS`) run their seeded collectives in the
ranks of the program matrix's one launch (``programs.build_matrix``), each
in the port's own mesh program idiom (``parallel.mesh`` collectives inside
a ``mesh_scope``), and the checkers read rank 0's records. On the card
``pallas_full_block`` really launches ``csrc/mutant_full_block.cu`` and
audits the launch it recorded; on the CPU it audits the launch
``mutant_full_block_launch`` declares. ``replicated_dk`` runs its step in
this process as rank 0 of a features mesh and hands the sharding pass what
that rank held. AST mutants are source-text fixtures
(copied verbatim from the JAX package) fed to
:func:`~.ast_lints.lint_concurrency_source`. Nothing here touches the tree.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_eigenspaces_tpu_torch.analysis import ast_lints, contracts
from distributed_eigenspaces_tpu_torch.device import resolve_device

_D = 64


# -- the seeded mesh collectives, run in the ranks of the matrix's launch -------


def _seed_dense_collective(device) -> None:
    """The design this framework replaced: a round that psums the dense
    d x d projector Gram of its workers' rows across the workers axis."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import rank_mesh
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    mesh = rank_mesh("workers", device)
    x = pmesh.worker_shard(mesh, torch.zeros((8, 8, _D)))  # (m_local, n, d)
    with pmesh.mesh_scope(mesh):
        pmesh.psum(torch.einsum("mnd,mne->de", x, x), pmesh.WORKER_AXIS)


def _seed_tree_dense_collective(device) -> None:
    """The tree shortcut the tier contract forbids: psum the dense d x d
    projector across a tier instead of the sharded (f*k)^2 Gram."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import rank_mesh
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    v = torch.zeros((_D, 2), device=device)
    with pmesh.mesh_scope(rank_mesh("tiered", device)):
        pmesh.psum(v @ v.T, "chip")


def _seed_tree_payload_drift(device) -> None:
    """A tree tier moving the flat (m, d, k) factor STACK instead of the
    merged (d, k) basis."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import rank_mesh
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    with pmesh.mesh_scope(rank_mesh("tiered", device)):
        pmesh.psum(torch.zeros((4, _D, 2), device=device), "chip")


def _seed_population_payload(device) -> None:
    """A cohort reduce that gathers the POPULATION-sized stack (1024
    clients, a quarter a rank) instead of the sampled cohort's."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import MESH_RANKS, rank_mesh
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    shard = torch.zeros((1024 // MESH_RANKS, _D, 2), device=device)
    with pmesh.mesh_scope(rank_mesh("workers", device)):
        pmesh.all_gather(shard, pmesh.WORKER_AXIS).mean(dim=0)


def _seed_wire_dtype_drift(device) -> None:
    """A tiered merge whose basis gather ships full-width fp32 on a tier
    whose policy says int8: the codec was dropped."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import rank_mesh
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    with pmesh.mesh_scope(rank_mesh("tiered", device)):
        pmesh.all_gather(torch.zeros((_D // 2, 2), device=device), "chip")


def _seed_dist_dense_gram(device) -> None:
    """A 'distributed' eigensolve that assembles the full row set over
    ``features`` and sums the DENSE d x d Gram there, instead of iterating
    on the row-sharded factors (workers 2 x features 2)."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import rank_mesh
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    with pmesh.mesh_scope(rank_mesh("features", device)):
        full = pmesh.all_gather(torch.zeros((_D, 8), device=device), pmesh.FEATURE_AXIS)
        pmesh.psum(full @ full.T, pmesh.FEATURE_AXIS)


def _seed_deflation_lane_gather(device) -> None:
    """A deflation lane that gathers the full DEFLATED operand over
    ``features`` (d-wide rows on every rank) instead of moving its own
    ``(d_local, k/L)`` panel over ``components`` (components 2 x features
    2)."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import rank_mesh
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    with pmesh.mesh_scope(rank_mesh("components", device)):
        full = pmesh.all_gather(torch.zeros((_D, 8), device=device), pmesh.FEATURE_AXIS)
        full.T @ full


#: mesh mutation name -> its seeded collectives, run once in every rank of
#: ``programs.build_matrix``'s launch under the collective recorder
MESH_SEEDS: dict[str, Callable[[torch.device], None]] = {
    "dense_collective": _seed_dense_collective,
    "tree_dense_collective": _seed_tree_dense_collective,
    "tree_payload_drift": _seed_tree_payload_drift,
    "population_payload": _seed_population_payload,
    "wire_dtype_drift": _seed_wire_dtype_drift,
    "dist_dense_gram": _seed_dist_dense_gram,
    "deflation_lane_gather": _seed_deflation_lane_gather,
}


def _recorded(name: str, device) -> tuple:
    from distributed_eigenspaces_tpu_torch.analysis.programs import mesh_mutant_records

    return mesh_mutant_records(device)[name]


_TREE = dict(tier_fan_ins=(2, 2), tier_axes=("chip", "host"))


def _mutant_dense_collective(device) -> list[contracts.Violation]:
    """A dense psum in a scan round: all-reduce is outside the scan_fit
    contract's allowed set."""
    params = contracts.ProgramParams(d=_D, k=2, m=8, n=8)
    viols, _ = contracts.check_collectives(
        contracts.CONTRACTS["scan_fit"], params, _recorded("dense_collective", device),
        program="mutant_dense_collective",
    )
    return viols


def _mutant_tree_dense_collective(device) -> list[contracts.Violation]:
    """A dense psum across a tier: all-reduce itself is in the tree
    contract's allowed set — the PAYLOAD bound is what must catch it."""
    params = contracts.ProgramParams(d=_D, k=2, m=4, n=8, **_TREE)
    viols, _ = contracts.check_collectives(
        contracts.CONTRACTS["tree_merge"], params,
        _recorded("tree_dense_collective", device),
        program="mutant_tree_dense_collective",
    )
    return viols


def _mutant_replicated_dk(device) -> list[contracts.Violation]:
    """The regression the sharding contracts exist for: a feature-sharded
    step whose ``(d, q)`` basis comes back WHOLE on every rank although the
    contract declares it sharded over ``features``. Rank 0 of workers 4 x
    features 2 takes its ``(d/2, q)`` rows; the step hands back all ``d``
    rows, as a gather over ``features`` inserted into it would. The
    ``silent-replication`` rule must name the program, the buffer's global
    shape and where (``out[0]`` on rank 0), from what the rank held."""
    from distributed_eigenspaces_tpu_torch.analysis import shardings
    from distributed_eigenspaces_tpu_torch.analysis.programs import _normal, trace_buffers

    d, q = 2 * _D, 2
    v = _normal((d, q), 18, device)
    mine, theirs = v[: d // 2], v[d // 2:]

    def step(rows):  # the regression: the whole basis back on this rank
        return 2.0 * torch.cat([rows, theirs])

    contract = contracts.CONTRACTS["feature_sharded"]
    params = contracts.ProgramParams(d=d, k=q, m=4, n=8, n_feature_shards=2,
                                     n_workers_mesh=4)
    out, buffers = trace_buffers(step, mine)
    held = shardings.held_shapes(0, (mine,), out, buffers,
                                 contract.sharding.replicated_axis_floor(params))
    viols, _ = shardings.check_shardings(
        contract.sharding, params, program="mutant_replicated_dk",
        dense_dim=contract.dense_dim(params), axis_sizes={"workers": 4, "features": 2},
        in_global=[(d, q)], out_global=[(d, q)], held=held,
    )
    return viols


def _mutant_dist_dense_gram(device) -> list[contracts.Violation]:
    """A distributed solve summing the dense d x d Gram over ``features``:
    both op kinds (all-gather, all-reduce) are in the dist_solve contract's
    allowed set — the PAYLOAD bound is what must catch it."""
    params = contracts.ProgramParams(d=2 * _D, k=2, m=4, n_feature_shards=2,
                                     n_workers_mesh=2)
    viols, _ = contracts.check_collectives(
        contracts.CONTRACTS["dist_solve"], params, _recorded("dist_dense_gram", device),
        program="mutant_dist_dense_gram",
    )
    return viols


def _mutant_deflation_lane_gather(device) -> list[contracts.Violation]:
    """A lane gathering the full deflated operand over ``features``:
    all-gather is in the deflation_solve contract's allowed set — the
    PAYLOAD bound (the ``d_local * k`` lane gather / factor stack) is what
    must catch it."""
    params = contracts.ProgramParams(d=2 * _D, k=8, m=1, n_feature_shards=2,
                                     n_workers_mesh=2, sketch_width=8, components=2)
    viols, _ = contracts.check_collectives(
        contracts.CONTRACTS["deflation_solve"], params,
        _recorded("deflation_lane_gather", device),
        program="mutant_deflation_lane_gather",
    )
    return viols


def _mutant_tree_payload_drift(device) -> list[contracts.Violation]:
    """The factor stack summed on a tier: the op kind is allowed, so only
    the cost model's per-op byte budget can catch the drift."""
    from distributed_eigenspaces_tpu_torch.analysis import costmodel

    params = contracts.ProgramParams(d=_D, k=2, m=4, n=8, **_TREE)
    viols, _ = costmodel.check_cost_bound(
        "tree_merge", params, _recorded("tree_payload_drift", device),
        program="mutant_tree_payload_drift",
    )
    return viols


def _mutant_population_payload(device) -> list[contracts.Violation]:
    """The population gathered instead of the cohort: all-gather is in
    the population_merge contract's allowed set, so the PAYLOAD bound (m
    := cohort, never population) is what must catch it."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import MESH_RANKS

    params = contracts.ProgramParams(d=_D, k=2, m=16, n_workers_mesh=MESH_RANKS)
    viols, _ = contracts.check_collectives(
        contracts.CONTRACTS["population_merge"], params,
        _recorded("population_payload", device),
        program="mutant_population_payload",
    )
    return viols


def _mutant_wire_dtype_drift(device) -> list[contracts.Violation]:
    """Tiers DECLARED int8 on the wire whose basis gather ships fp32: both
    halves of the ``collective-wire-dtype`` rule must fire."""
    params = contracts.ProgramParams(d=_D, k=2, m=4, n=8, **_TREE,
                                     tier_wire_dtypes=("int8", "int8"))
    viols, _ = contracts.check_collectives(
        contracts.CONTRACTS["tree_merge"], params, _recorded("wire_dtype_drift", device),
        program="mutant_wire_dtype_drift",
    )
    return viols


def _mutant_plan_infeasible(device) -> list:
    """A hand-built ``plan-v1`` whose predicted host-tier merge budget
    (640 ms/round) exceeds the workload's declared round deadline
    (50 ms): a planner that accepted this plan would schedule a merge
    that can never close its rounds. The planner's self-check must
    refuse it loudly (the ``plan_infeasible_accepted`` witness)."""
    from distributed_eigenspaces_tpu_torch.analysis import planner

    plan = {
        "schema": planner.PLAN_SCHEMA,
        "plan_id": "plan-seeded-infeasible",
        "workload": {
            "d": 1024, "k": 8, "m": 16, "n": 64,
            "qps": 100.0, "slo_p99_ms": 200.0,
            "round_deadline_ms": 50.0,
        },
        "chosen": {
            "config_overrides": {"merge_interval": 1},
            "predicted": {
                "fit_tiers": {
                    "host": {
                        "fan_in": 2,
                        "wire_bytes_per_round": 8_000_000_000,
                        "modeled_ms_per_round": 640.0,
                        "assumed_gb_per_sec": 12.5,
                    },
                },
                "serve": {"predicted_p99_ms": 120.0},
            },
        },
    }
    return planner.self_check(plan)


def _mutant_dense_temp(device) -> list[contracts.Violation]:
    """A factor-only program that materializes the d x d Gram."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import trace_buffers

    def gram(x):  # (rows, d) -> (d, d): exactly what serve must not do
        return x.T @ x

    _, buffers = trace_buffers(gram, torch.zeros((16, _D), device=device))
    contract = contracts.CONTRACTS["serve_transform"]
    params = contracts.ProgramParams(d=_D, k=2, rows=16)
    viols, _ = contracts.check_memory(
        contract, params, program="mutant_dense_temp", buffers=buffers
    )
    return viols


def _mutant_pallas_full_block(device) -> list[contracts.Violation]:
    """The tiling regression the kernel gate exists for: a projection whose
    single CTA owns the FULL (rows, d) operand. Legal and exact — one SM
    does the work while 131 idle — so only the per-CTA tile budget can
    catch it."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import (
        _normal,
        _orthonormal,
    )
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb
    from distributed_eigenspaces_tpu_torch.ops.geometry import recording

    d, rows, k = 1024, 256, 8
    if device.type == "cuda":
        x, v = _normal((rows, d), 5, device), _orthonormal(d, k, 6, device)
        with recording() as launches:
            mfb.mutant_full_block_cuda(x, v)
        torch.cuda.synchronize(device)
    else:
        launches = [mfb.mutant_full_block_launch(rows, d, k)]
    contract = contracts.CONTRACTS["serve_pallas"]
    params = contracts.ProgramParams(d=d, k=k, rows=rows)
    viols, _ = contracts.check_pallas(
        contract, params, launches, program="mutant_pallas_full_block"
    )
    return viols


_FIXTURE_BLOCKING = '''
import threading, time
class Worker:
    def __init__(self):
        self._lock = threading.Lock()
    def drain(self):
        with self._lock:
            self._thread.join()
            time.sleep(0.1)
'''

_FIXTURE_LOCK_ORDER = '''
import threading
class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._aux = threading.Lock()
    def swap(self):
        with self._lock:
            with self._aux:
                pass
'''

_FIXTURE_UNGUARDED = '''
import threading
class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
    def bump(self):
        with self._lock:
            self.count += 1
    def reset(self):
        self.count = 0
'''


def _ast_mutant(fixture: str, linter) -> Callable[[torch.device], list]:
    def run(device) -> list[contracts.Violation]:
        return linter(fixture, "seeded_fixture.py")

    return run


#: mutation name -> (expected rule, runner(device)). Every violation class
#: this analyzer claims to catch has exactly one seeded witness here.
MUTATIONS: dict[str, tuple[str, Callable[[torch.device], list]]] = {
    "dense_collective": ("collective-op", _mutant_dense_collective),
    "tree_dense_collective": ("collective-payload", _mutant_tree_dense_collective),
    "dense_temp": ("dense-buffer", _mutant_dense_temp),
    "replicated_dk": ("silent-replication", _mutant_replicated_dk),
    "dist_dense_gram": ("collective-payload", _mutant_dist_dense_gram),
    "deflation_lane_gather": ("collective-payload", _mutant_deflation_lane_gather),
    "tree_payload_drift": ("cost-bound", _mutant_tree_payload_drift),
    "population_payload": ("collective-payload", _mutant_population_payload),
    "pallas_full_block": ("pallas-block", _mutant_pallas_full_block),
    "plan_infeasible_accepted": ("plan-infeasible", _mutant_plan_infeasible),
    "wire_dtype_drift": ("collective-wire-dtype", _mutant_wire_dtype_drift),
    "blocking_under_lock": ("blocking-under-lock", _ast_mutant(
        _FIXTURE_BLOCKING, ast_lints.lint_concurrency_source
    )),
    "lock_order": ("lock-order", _ast_mutant(
        _FIXTURE_LOCK_ORDER, ast_lints.lint_concurrency_source
    )),
    "unguarded_shared_write": ("unguarded-shared-write", _ast_mutant(
        _FIXTURE_UNGUARDED, ast_lints.lint_concurrency_source
    )),
}


def run_mutation_checks(device="cuda") -> tuple[bool, list[dict]]:
    """Run every seeded mutation on ``device``; each must be CAUGHT with
    the expected rule. The mesh mutants read the records of the program
    matrix's launch (made here if this process has not made it). Returns
    (all_caught, per-mutation records)."""
    dev = resolve_device(device)
    records = []
    all_ok = True
    for name, (rule, runner) in MUTATIONS.items():
        viols = runner(dev)
        hits = [v for v in viols if v.rule == rule]
        caught = bool(hits)
        all_ok &= caught
        records.append({
            "mutation": name,
            "expected_rule": rule,
            "caught": caught,
            "n_violations": len(viols),
            "messages": [v.format() for v in hits[:2]],
        })
    return all_ok, records
