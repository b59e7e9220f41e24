"""The port's 14 mesh programs and its 6 new mutations, held against the JAX
analyzer on the CPU.

One process group for the whole file: ``programs.build_matrix`` runs every
mesh program and every seeded mesh mutation in ONE launch of 4 gloo ranks
(a module fixture; the build is cached a process). Each program must honour
its contract with every rank recording the same schedule; each new mutant
must be caught with the reference's rule; where the mesh is the reference's
own (the scan family on 4 workers, the tree on chip 2 x host 2) the
collective kinds and the largest payload must equal the reference's audit of
the same program; and the committed ``ANALYSIS_COSTS_TORCH.json`` must be
what this run regenerates, byte for byte. Every comparison is exact.
"""

import dataclasses
from pathlib import Path

import pytest

from distributed_eigenspaces_tpu.analysis import contracts as jcontracts
from distributed_eigenspaces_tpu.analysis import mutations as jmutations
from distributed_eigenspaces_tpu.analysis import programs as jprograms
from distributed_eigenspaces_tpu_torch.analysis import (
    contracts,
    costmodel,
    mutations,
    programs,
)

ROOT = Path(__file__).resolve().parents[1]
SAME_MESH = ["scan_solo", "scan_pipelined", "scan_interval2", "scan_pipelined_interval2",
             "scan_masked", "scan_masked_interval2", "tree_fit", "tree_fit_masked",
             "tree_fit_wire"]
NEW_MUTATIONS = ["dense_collective", "tree_dense_collective", "tree_payload_drift",
                 "population_payload", "wire_dtype_drift", "plan_infeasible_accepted"]


@pytest.fixture(scope="module")
def matrix():
    built, recorded = programs.build_matrix(device="cpu")
    return built, recorded


@pytest.mark.parametrize("name", list(programs.MESH_PROGRAMS))
def test_mesh_program_honours_its_contract(matrix, name):
    built = matrix[0][name]
    viols, detail = contracts.check_program(built)
    assert not viols, [v.format() for v in viols]
    assert built.schedule_diffs == () and built.device.type == "cpu"
    contract = contracts.CONTRACTS[built.contract]
    assert detail["ok"] and detail["contract"] == contract.name
    col = detail["collectives"]
    assert (col["n_collectives"] > 0) == contract.require_collectives
    if contract.max_payload_elems is not None:
        assert col["max_payload_elems"] <= contract.max_payload_elems(built.params)
    assert built.flops > 0 and built.buffers
    assert (ROOT / "distributed_eigenspaces_tpu_torch" / built.source).is_file()


def test_mesh_params_state_the_four_rank_mesh(matrix):
    """Where the reference takes 8 devices the port keeps 4 ranks, and its
    ProgramParams say so; the audit shapes are the reference's."""
    built = matrix[0]
    p = built["scan_solo"].params
    assert (p.d, p.k, p.m, p.n, p.T, p.n_workers_mesh) == (64, 2, 4, 8, 3, 4)
    p = built["feature_scan"].params
    assert (p.d, p.d_local, p.n_feature_shards, p.n_workers_mesh, p.T) == (128, 64, 2, 2, 6)
    assert built["feature_sketch"].params.sketch_width == 18
    p = built["fleet_b8"].params
    assert (p.B, p.n_workers_mesh) == (8, 4)
    p = built["population_reduce"].params
    assert (p.m, p.n_workers_mesh) == (16, 4)
    t = built["tree_fit_wire"].params
    assert (t.tier_fan_ins, t.tier_axes, t.tier_wire_dtypes) == (
        (2, 2), ("chip", "host"), ("bf16", "int8"))


@pytest.mark.parametrize("name", SAME_MESH)
def test_collective_kinds_and_max_payload_equal_the_reference(devices, matrix, name):
    """On the reference's own mesh the per-op bound means the same thing:
    the same kinds and the same largest payload. (The port's all-to-all
    counts the whole buffer, the reference's parser one tuple chunk; the
    largest payload here is a gather's whole output in both.)"""
    built = matrix[0][name]
    ref_built = jprograms.build_program(name)
    ref_viols, ref = jcontracts.check_program(ref_built)
    assert not ref_viols and built.contract == ref_built.contract
    _, port = contracts.check_program(built)
    kinds = {key.split()[0] for key in port["collectives"]["ops"]}
    ref_kinds = {key.split()[0] for key in ref["collectives"]["ops"]}
    assert kinds == ref_kinds
    assert port["collectives"]["max_payload_elems"] == ref["collectives"]["max_payload_elems"]
    assert port["costs"]["budget_bytes_per_op"] == ref["costs"]["budget_bytes_per_op"]
    assert set(port["costs"]["collectives_per_axis"]) == set(ref["costs"]["collectives_per_axis"])
    rp, p = ref_built.params, built.params
    assert (p.d, p.k, p.m, p.n, p.T, p.n_workers_mesh, p.tier_fan_ins, p.tier_axes,
            p.tier_wire_dtypes) == (rp.d, rp.k, rp.m, rp.n, rp.T, rp.n_workers_mesh,
                                    rp.tier_fan_ins, rp.tier_axes, rp.tier_wire_dtypes)


@pytest.mark.parametrize("name", NEW_MUTATIONS)
def test_new_mutation_caught_with_the_reference_rule(matrix, name):
    rule, runner = mutations.MUTATIONS[name]
    assert rule == jmutations.MUTATIONS[name][0]
    viols = runner(matrix[0]["scan_solo"].device)
    hits = [v for v in viols if v.rule == rule]
    assert hits, [v.format() for v in viols]
    assert hits[0].location and rule in hits[0].format()
    if name in mutations.MESH_SEEDS:
        assert matrix[1][name], name  # its collectives ran in the matrix's launch


def test_the_port_carries_eleven_of_the_seventeen_mutations():
    assert len(mutations.MUTATIONS) == 11 and set(mutations.MUTATIONS) <= set(jmutations.MUTATIONS)
    assert list(mutations.MUTATIONS) == [n for n in jmutations.MUTATIONS
                                         if n in mutations.MUTATIONS]
    assert len(programs.MATRIX) == 18 and set(programs.MATRIX) <= set(jprograms.PROGRAMS)
    assert list(programs.MATRIX) == [n for n in jprograms.PROGRAMS if n in programs.MATRIX]


def test_a_rank_that_records_another_schedule_is_a_violation(matrix):
    built = matrix[0]["scan_solo"]
    mine = list(built.collectives)
    theirs = mine[:1] + [dict(mine[1], shape=[8, 64, 2], elements=256)] + mine[2:]
    diffs = programs._diffs(mine, theirs, 3)
    assert len(diffs) == 1 and "rank 3" in diffs[0] and "call 1" in diffs[0]
    assert programs._diffs(mine, mine, 3) == []
    viols, _ = contracts.check_program(dataclasses.replace(built, schedule_diffs=tuple(diffs)))
    assert [v.rule for v in viols] == ["collective-schedule"]


def test_committed_cost_snapshot_regenerates_byte_equal(matrix):
    """``ANALYSIS_COSTS_TORCH.json`` is this run's snapshot, byte for byte
    (made on the CPU: FLOPs of the plain versions, the buffer trace's bytes,
    the recorded collectives)."""
    snap = costmodel.cost_snapshot(built=matrix[0])
    assert set(snap["programs"]) == set(programs.MATRIX)
    committed = (ROOT / costmodel.SNAPSHOT_NAME).read_text(encoding="utf-8")
    assert costmodel.dumps_snapshot(snap) == committed
    assert costmodel.check_snapshot(snap, costmodel.load_snapshot()) == []
