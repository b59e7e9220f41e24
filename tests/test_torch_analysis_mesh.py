"""The port's 23 mesh programs and its mesh and sharding mutations, held
against the JAX analyzer on the CPU.

One process group for the whole file: ``programs.build_matrix`` runs every
mesh program and every seeded mesh mutation in ONE launch of 4 gloo ranks
(a module fixture; the build is cached a process). Each program must honour
its contract with every rank recording the same schedule and every rank's
held shapes passing its declared layouts; each ported mutant must be caught
with the reference's rule; where the mesh is the reference's own (the scan
family on 4 workers, the tree on chip 2 x host 2) the collective kinds and
the largest payload must equal the reference's audit of the same program;
the new programs' bounds and declarations at the params of the mesh that
ran must equal the reference's contracts' at the same params; and the
committed ``ANALYSIS_COSTS_TORCH.json`` must be what this run regenerates,
byte for byte. Every comparison is exact, except the outputs': the serve
programs' rows gathered from the ranks within 1e-6 relative of the
reference engine's on the same numpy inputs, and the dist and deflation
solves within 0.01 degrees (the port's float64 principal angles) of the
reference's functions run on a JAX mesh of the same shape.
"""

import dataclasses
from pathlib import Path

import numpy as np
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
                 "population_payload", "wire_dtype_drift", "plan_infeasible_accepted",
                 "replicated_dk", "dist_dense_gram", "deflation_lane_gather"]
#: the programs this file added with the sharding contracts
SHARDED_NEW = ["serve_project", "serve_reconstruct", "serve_residual", "dist_merge",
               "dist_extract", "deflation_merge", "dist_serve_project",
               "dist_serve_reconstruct", "dist_serve_residual"]
#: programs that make collectives their contract does not require (the
#: reference's audit of each makes one all-reduce too)
COLLECTIVES_WITHOUT_REQUIREMENT = {"dist_serve_project": True, "dist_serve_residual": True}
#: programs with no matrix product (``FlopCounterMode`` counts products only)
NO_PRODUCT = {"serve_residual", "dist_serve_residual"}
ANGLE_DEG = 0.01
ROWS_RTOL = 1e-6


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
    assert (col["n_collectives"] > 0) == COLLECTIVES_WITHOUT_REQUIREMENT.get(
        name, contract.require_collectives)
    if contract.max_payload_elems is not None:
        assert col["max_payload_elems"] <= contract.max_payload_elems(built.params)
    # the residual buckets are sums of squares: no product for the counter
    assert (built.flops > 0) == (name not in NO_PRODUCT) and built.buffers
    assert (ROOT / "distributed_eigenspaces_tpu_torch" / built.source).is_file()
    # every rank's verdict: each held its share of a declared-sharded buffer
    shard = detail["shardings"]
    assert shard["checked"] and shard["n_sharded_ok"] >= 1, shard
    assert [h.rank for h in built.held] == list(range(programs.MESH_RANKS))
    assert shard["n_violations_by_rank"] == {r: 0 for r in range(programs.MESH_RANKS)}
    assert len(built.output) == programs.MESH_RANKS


@pytest.mark.parametrize("name", ["scan_solo", "feature_scan", "deflation_merge",
                                  "dist_serve_project"])
def test_a_rank_that_held_a_sharded_buffer_whole_is_silent_replication(matrix, name):
    """Not satisfied by construction: the same program with one rank's
    record of a declared-sharded input swapped for its global shape (the
    rank that took the whole block) is ``silent-replication`` on that rank
    alone, named with the buffer's global shape and where."""
    built = matrix[0][name]
    shard = contracts.check_program(built)[1]["shardings"]
    row = next(r for r in shard["buffers"] if r["role"] == "in" and r["local"] != r["shape"])
    held = built.held[2]
    ins = list(held.ins)
    ins[row["leaf"]] = tuple(row["shape"])
    whole = dataclasses.replace(held, ins=tuple(ins))
    bad = dataclasses.replace(built, held=built.held[:2] + (whole,) + built.held[3:])
    viols, detail = contracts.check_program(bad)
    hits = [v for v in viols if v.rule == "silent-replication"]
    assert hits and all(v.location == f"in[{row['leaf']}] on rank 2" for v in hits), (
        [v.format() for v in viols])
    assert str(row["shape"]) in hits[0].message and "REPLICATED" in hits[0].message
    assert detail["shardings"]["n_violations_by_rank"][2] == len(viols)


def test_dist_merge_draws_only_its_rows_of_the_trainers_start(matrix):
    """The merge program draws its start inside the audited call as the
    feature-sharded trainer does (``merge_start`` with the rank's rows):
    every rank's trace holds its ``(64, k')`` rows of it and no buffer with
    all 128 rows at that width."""
    built = matrix[0]["dist_merge"]
    kk = 2 + 6  # k plus the default oversample of the m k = 8 wide operator
    shapes = {tuple(b[1]) for b in built.buffers}
    assert (64, kk) in shapes and (128, kk) not in shapes
    for held in built.held:
        assert (128, kk) not in {tuple(b[1]) for b in held.buffers}, held.rank


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
    for name in ("serve_project", "serve_reconstruct", "serve_residual"):
        p = built[name].params
        assert (p.d, p.k, p.rows, p.n_workers_mesh) == (64, 2, 16, 4)
        assert built[name].leaves.axis_sizes == {"workers": 4, "features": 1}
    p = built["dist_merge"].params
    assert (p.d, p.k, p.m, p.n_feature_shards, p.n_workers_mesh) == (128, 2, 4, 2, 2)
    p = built["dist_extract"].params
    assert (p.d, p.k, p.m, p.n_feature_shards, p.n_workers_mesh, p.sketch_width) == (
        128, 2, 1, 2, 2, 8)
    p = built["deflation_merge"].params
    assert (p.d, p.k, p.components, p.n_feature_shards, p.sketch_width) == (128, 8, 2, 2, 8)
    assert built["deflation_merge"].leaves.axis_sizes == {"components": 2, "features": 2}
    for name in ("dist_merge", "dist_extract", "dist_serve_project"):
        assert built[name].leaves.axis_sizes == {"workers": 2, "features": 2}
    for name in ("dist_serve_project", "dist_serve_reconstruct", "dist_serve_residual"):
        p = built[name].params
        assert (p.d, p.k, p.rows, p.n_feature_shards, p.n_workers_mesh) == (128, 2, 16, 2, 2)


@pytest.mark.parametrize("name", SHARDED_NEW)
def test_new_program_bounds_and_layouts_equal_the_reference_at_its_params(matrix, name):
    """The contract of each new program, evaluated at the params of the
    4-rank mesh that ran, against the reference's contract of the same kind
    at the same params: payload bound, dense threshold, floor and every
    declared buffer's pattern, layout and ``required`` (exact)."""
    built = matrix[0][name]
    c, jc = contracts.CONTRACTS[built.contract], jcontracts.CONTRACTS[built.contract]
    p = built.params
    jp = jcontracts.ProgramParams(**dataclasses.asdict(p))
    assert (c.allowed_collectives, c.require_collectives, c.memory_policy) == (
        jc.allowed_collectives, jc.require_collectives, jc.memory_policy)
    assert c.dense_dim(p) == jc.dense_dim(jp)
    if jc.max_payload_elems is None:
        assert c.max_payload_elems is None
    else:
        assert c.max_payload_elems(p) == jc.max_payload_elems(jp)
    sc, jsc = c.sharding, jc.sharding
    assert sc.require_some == jsc.require_some
    if jsc.replicated_axis_floor is None:
        assert sc.replicated_axis_floor is None
    else:
        assert sc.replicated_axis_floor(p) == jsc.replicated_axis_floor(jp)
    assert [(b.name, b.role, b.dims(p), b.spec(p), b.required) for b in sc.buffers] == [
        (b.name, b.role, b.dims(jp), b.spec(jp), b.required) for b in jsc.buffers]


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


@pytest.mark.parametrize("name", SHARDED_NEW)
def test_new_program_collective_kinds_equal_the_reference(devices, matrix, name):
    """Each new program makes the collective kinds the reference's audit of
    the same program makes (on its 8-device mesh; the payloads differ with
    the mesh): none for the row-local serve buckets, the sharded
    reconstruct included, one all-reduce for the sharded project and
    residual, gathers and sums for the solves (exact)."""
    ref_viols, ref = jcontracts.check_program(jprograms.build_program(name))
    assert not ref_viols
    _, port = contracts.check_program(matrix[0][name])
    kinds = {key.split()[0] for key in port["collectives"]["ops"]}
    assert kinds == {key.split()[0] for key in ref["collectives"]["ops"]}
    assert (port["collectives"]["n_collectives"] > 0) == (
        ref["collectives"]["n_collectives"] > 0)


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


def test_the_port_carries_fourteen_of_the_seventeen_mutations():
    assert len(mutations.MUTATIONS) == 14 and set(mutations.MUTATIONS) <= set(jmutations.MUTATIONS)
    assert list(mutations.MUTATIONS) == [n for n in jmutations.MUTATIONS
                                         if n in mutations.MUTATIONS]
    assert set(jmutations.MUTATIONS) - set(mutations.MUTATIONS) == {
        "baked_constant", "host_sync", "traced_branch"}
    assert list(programs.MATRIX) == list(jprograms.PROGRAMS)
    assert len(programs.MESH_PROGRAMS) == 23 and len(mutations.MESH_SEEDS) == 7


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


# -- the new programs' outputs against the reference's ---------------------------


def _rows_by_coords(built, leaf, row_axis, col_axis=None):
    """The whole array of output ``leaf`` from every rank's block: rank
    ``r`` sits at ``r`` unravelled over the mesh's axis sizes (row-major);
    its block is its ``row_axis`` rows (and ``col_axis`` columns). Ranks that
    hold the same block must hold the same bits."""
    axes = built.leaves.axis_sizes
    names, sizes = list(axes), list(axes.values())
    blocks = {}
    for r, out in enumerate(built.output):
        coords = dict(zip(names, np.unravel_index(r, sizes)))
        key = (coords[row_axis], coords[col_axis] if col_axis else 0)
        got = out[leaf]
        if key in blocks:
            np.testing.assert_array_equal(got, blocks[key])
        blocks[key] = got
    n_rows = axes[row_axis]
    n_cols = axes[col_axis] if col_axis else 1
    return np.concatenate([np.concatenate([blocks[(i, j)] for j in range(n_cols)], axis=-1)
                           for i in range(n_rows)], axis=0)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ROWS_RTOL * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("name", ["serve_project", "serve_reconstruct", "serve_residual",
                                  "dist_serve_project", "dist_serve_reconstruct",
                                  "dist_serve_residual"])
def test_served_rows_equal_the_reference_engine(matrix, name):
    """The rows each rank served, gathered, against the reference's
    one-device ``TransformEngine`` on the same numpy inputs (its project,
    the reconstruction of that projection, the residual and input energies
    of it), within 1e-6 relative."""
    import jax.numpy as jnp

    from distributed_eigenspaces_tpu.serving.transform import TransformEngine as JEngine

    built = matrix[0][name]
    sharded = name.startswith("dist_")
    d = 128 if sharded else 64
    x = programs._normal((16, d), 14 if sharded else 0, "cpu").numpy()
    v = programs._orthonormal(d, 2, 15 if sharded else 1, "cpu").numpy()
    jeng = JEngine(d, 2)
    z = jeng.project(jnp.asarray(x), jnp.asarray(v))
    kind = name.rsplit("_", 1)[1]
    want = {"project": [z], "reconstruct": [jeng.reconstruct(z, jnp.asarray(v))],
            "residual": list(jeng.residual_energy(jnp.asarray(x), z))}[kind]
    assert len(built.output[0]) == len(want)
    for leaf, w in enumerate(want):
        col = "features" if sharded and kind == "reconstruct" else None
        _close(_rows_by_coords(built, leaf, "workers", col), np.asarray(w))


def _angle(a, b):
    import torch

    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    return float(principal_angles_degrees(torch.as_tensor(np.asarray(a, np.float64)),
                                          torch.as_tensor(np.asarray(b, np.float64))).max())


def _jsharded(fn, mesh, in_specs, out_specs):
    import jax
    from jax.sharding import NamedSharding

    from distributed_eigenspaces_tpu.parallel.mesh import shard_map

    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False),
                   in_shardings=tuple(NamedSharding(mesh, s) for s in in_specs))


def test_dist_and_deflation_solves_land_on_the_reference(devices, matrix):
    """``dist_merge``, ``dist_extract`` and ``deflation_merge`` (the rows of
    every rank gathered) against the reference's ``dist_merged_top_k``,
    ``dist_extract_top_k`` and ``dist_deflation_eig`` on a JAX mesh of the
    same shape (workers 2 x features 2; components 2 x features 2), on the
    same numpy operands, at the programs' two sweeps: within 0.01 degrees,
    the lanes each and the whole basis. The lanes start from the same seed
    blocks ``v0`` in both packages. The merge's and the extract's random
    starts cannot be the same draw (the reference folds ``PRNGKey(0)`` per
    row shard, the port draws each rank's rows with ``start_rows``): the
    merge's operand carries a gap that two sweeps settle (the workers'
    bases within 0.01 of one planted basis), and the extract starts warm
    from ``u[:, :k]`` with the random block at weight ``1e-3 / sqrt(d)``
    (the state's spectrum ``8 * 0.5**i``, a condition of 128)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from distributed_eigenspaces_tpu.parallel.mesh import make_component_mesh, make_mesh
    from distributed_eigenspaces_tpu.solvers import deflation as jdefl
    from distributed_eigenspaces_tpu.solvers import distributed as jdist

    built = matrix[0]
    vws, mask = programs.dist_merge_inputs()
    u, s = programs.state_factors()
    seeds = programs.deflation_seeds()
    jm = make_mesh(num_workers=2, num_feature_shards=2, devices=jax.devices()[:4])
    cm = make_component_mesh(2, 2, devices=jax.devices()[:4])
    rows = P("features", None)
    want = {
        "dist_merge": _jsharded(
            lambda a, m: jdist.dist_merged_top_k(a, 2, mask=m, iters=2), jm,
            (P("workers", "features", None), P("workers")), rows)(vws, mask),
        "dist_extract": _jsharded(
            lambda a, b: jdist.dist_extract_top_k(a, b, 2, iters=2), jm, (rows, P()),
            rows)(u, s),
        "deflation_merge": _jsharded(
            lambda v0, a, b: jdefl.dist_deflation_eig(
                jdist.lowrank_matvec(a, b, "features"), a.shape[0], 8, lanes=2, iters=2,
                v0=v0[0]),
            cm, (P("components", "features", None), rows, P()), rows)(seeds, u, s),
    }
    for name, w in want.items():
        got, w = _rows_by_coords(built[name], 0, "features"), np.asarray(w)
        assert got.shape == w.shape
        assert _angle(got, w) <= ANGLE_DEG, name
        if name == "deflation_merge":
            for lane in range(2):
                cols = slice(4 * lane, 4 * lane + 4)
                assert _angle(got[:, cols], w[:, cols]) <= ANGLE_DEG, lane
