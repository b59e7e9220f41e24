"""The port's cost model and collective audit (``analysis/costmodel.py``,
``analysis/hlo.py``, ``analysis/contracts.py``'s bounds) held against the
JAX package's, on the CPU. Nothing here starts a process group: the mesh
programs are ``tests/test_torch_analysis_mesh.py``'s.

Tolerances: every comparison is exact (bounds, model bytes, projections'
bytes, hops and ratios, audit dicts), except the projections' ms fields,
which are held to 1e-9 relative once the port's link anchors are set to the
reference's 90 / 12.5 GB/s.
"""

import math

import pytest

from distributed_eigenspaces_tpu.analysis import contracts as jcontracts
from distributed_eigenspaces_tpu.analysis import costmodel as jcost
from distributed_eigenspaces_tpu.analysis import hlo as jhlo
from distributed_eigenspaces_tpu_torch import analysis
from distributed_eigenspaces_tpu_torch.analysis import contracts, costmodel, hlo

#: every contract kind of the port
KINDS = ("scan_fit", "feature_sharded", "tree_merge", "fleet_fit",
         "population_merge", "serve_transform", "serve_pallas", "dist_solve",
         "deflation_solve", "dist_serve")

#: ProgramParams field sets: the matrix's mesh programs at the port's mesh,
#: at the reference's, and a large-d tree with a wire policy
PARAMS = [
    dict(d=64, k=2, m=4, n=8, T=3, n_workers_mesh=4),
    dict(d=128, k=2, m=4, n=8, T=6, n_feature_shards=2, n_workers_mesh=2, sketch_width=18),
    dict(d=128, k=2, m=4, n=8, T=6, n_feature_shards=2, n_workers_mesh=4),
    dict(d=64, k=2, m=4, n=8, T=3, n_workers_mesh=4, tier_fan_ins=(2, 2),
         tier_axes=("chip", "host"), tier_wire_dtypes=("bf16", "int8")),
    dict(d=32768, k=8, m=64, n=128, tier_fan_ins=(16, 4), tier_axes=("chip", "host"),
         tier_wire_dtypes=("fp32", "int8")),
    dict(d=64, k=2, m=16, n_workers_mesh=4),
    dict(d=64, k=2, m=16, n_workers_mesh=8),
    dict(d=64, k=2, m=4, n=8, T=3, B=8, n_workers_mesh=4),
]


@pytest.mark.parametrize("kw", PARAMS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("kind", KINDS)
def test_bounds_and_model_costs_equal_the_reference(kind, kw):
    """Exact: the same ProgramParams give the same payload ceiling, the
    same budget and the same modeled per-axis bytes in both packages."""
    p, jp = contracts.ProgramParams(**kw), jcontracts.ProgramParams(**kw)
    assert p.d_local == jp.d_local
    c, jc = contracts.CONTRACTS[kind], jcontracts.CONTRACTS[kind]
    assert (c.allowed_collectives, c.require_collectives, c.memory_policy) == (
        jc.allowed_collectives, jc.require_collectives, jc.memory_policy)
    assert c.dense_dim(p) == jc.dense_dim(jp)
    if jc.max_payload_elems is None:
        assert c.max_payload_elems is None
    else:
        assert c.max_payload_elems(p) == jc.max_payload_elems(jp)
    assert costmodel.model_costs(kind, p) == jcost.model_costs(kind, jp)
    assert costmodel.BUDGET_ITEMSIZE == jcost.BUDGET_ITEMSIZE == 4


@pytest.mark.parametrize("kind", ("dist_solve", "deflation_solve", "dist_serve"))
def test_model_costs_of_the_later_contracts_equal_the_reference(kind):
    """model_costs is copied whole: the dist, deflation and sharded-serve
    kinds price the same bytes at their own audit params (exact)."""
    for kw in (dict(d=128, k=2, m=4, n_feature_shards=2, n_workers_mesh=4),
               dict(d=128, k=8, m=1, n_feature_shards=2, n_workers_mesh=4, sketch_width=8,
                    components=4),
               dict(d=128, k=2, rows=16, n_feature_shards=2, n_workers_mesh=4)):
        p, jp = contracts.ProgramParams(**kw), jcontracts.ProgramParams(**kw)
        assert costmodel.model_costs(kind, p) == jcost.model_costs(kind, jp)


def _ms_fields(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _ms_fields(value, path + (key,))
    elif path and path[-1] in ("modeled_ms_per_round", "assumed_gb_per_sec"):
        yield path, tree


def _strip_ms(tree):
    if isinstance(tree, dict):
        return {k: _strip_ms(v) for k, v in tree.items()
                if k not in ("modeled_ms_per_round", "assumed_gb_per_sec")}
    return tree


def test_projections_bytes_exact_and_ms_at_the_reference_anchors(monkeypatch):
    """Bytes, hops, ratios and the model string exact; the ms fields to
    1e-9 relative once the port's link anchors are the reference's."""
    got = costmodel.projections()
    want = jcost.projections()
    assert _strip_ms(got) == _strip_ms(want)
    # the port's own anchors are the H100 SXM5 node's published rates
    assert (costmodel.ICI_GB_PER_SEC, costmodel.DCN_GB_PER_SEC) == (450.0, 50.0)
    budgets = got["tier_deadline_budgets_large_d"]
    assert budgets["chip"]["assumed_gb_per_sec"] == 450.0
    assert budgets["host"]["assumed_gb_per_sec"] == 50.0
    monkeypatch.setattr(costmodel, "ICI_GB_PER_SEC", jcost.ICI_GB_PER_SEC)
    monkeypatch.setattr(costmodel, "DCN_GB_PER_SEC", jcost.DCN_GB_PER_SEC)
    at_ref = dict(_ms_fields(costmodel.projections()))
    ref = dict(_ms_fields(want))
    assert at_ref.keys() == ref.keys() and ref
    for key, value in ref.items():
        assert math.isclose(at_ref[key], value, rel_tol=1e-9), key
    assert got["audit_shapes"]["flat_over_tree"] >= 4.0
    assert got["large_d"]["flat_over_tree"] >= 4.0


# -- the audit, read from records ---------------------------------------------------


def _rec(op="all_gather", axis="workers", dtype="float32", shape=(1, 64, 2), g=4, tag=None):
    """One record as ``parallel.mesh.recording_collectives`` writes it, of a
    tensor of ``shape`` handed over (a gather's result is g of them)."""
    shape = tuple(shape)
    handed = math.prod(shape)
    itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}.get(dtype, 4)
    whole = (g * shape[0], *shape[1:]) if op == "all_gather" else shape
    return {"op": op, "axis": axis, "dtype": dtype, "elements": handed,
            "bytes": handed * itemsize, "group_size": g, "tag": tag, "shape": list(whole)}


def test_records_read_into_the_reference_audit_shape():
    """The reference's CollectiveOp / audit dict from records (exact): a
    gather's payload is its whole output, as the HLO instruction's."""
    recs = [_rec(), _rec(), _rec("psum", "features", shape=(14, 14), g=2),
            _rec("all_to_all", "chip", "int8", (2, 32, 2), g=2),
            _rec("ppermute", "features", shape=(8, 2), g=2)]
    audit = hlo.audit_compiled(recs)
    assert audit["ops"] == {"all-gather f32[4,64,2]": 2, "all-reduce f32[14,14]": 1,
                            "all-to-all s8[2,32,2]": 1, "collective-permute f32[8,2]": 1}
    assert audit["n_collectives"] == 5
    assert (audit["max_payload_elems"], audit["max_payload_bytes"]) == (512, 2048)
    ops = audit["_parsed"]
    want = jhlo.CollectiveOp(op="all-gather", dtype="f32", shape=(4, 64, 2))
    assert (ops[0].op, ops[0].dtype, ops[0].shape) == (want.op, want.dtype, want.shape)
    assert (ops[0].elems, ops[0].payload_bytes) == (want.elems, want.payload_bytes)
    assert ops[3].payload_bytes == 128 and ops[3].axis == "chip" and ops[3].group_size == 2
    # the same tripwire, the same verdicts
    hlo.assert_no_dense_collective(audit, 64)
    with pytest.raises(AssertionError, match="dense collective detected"):
        hlo.assert_no_dense_collective(hlo.audit_compiled([_rec("psum", shape=(64, 64))]), 64)
    # exported from the package as the reference's
    for name in ("AuditParseError", "CollectiveOp", "assert_no_dense_collective",
                 "audit_compiled", "ici_step_model", "parse_collectives",
                 "scaling_projection"):
        assert getattr(analysis, name) is getattr(hlo, name)


@pytest.mark.parametrize("bad,what", [
    (dict(op="reduce_scatter"), "reduce_scatter"),
    (dict(dtype="float4"), "float4"),
    (dict(shape=[3, 64, 2]), "does not hold"),
])
def test_a_record_the_audit_cannot_account_for_raises(bad, what):
    rec = dict(_rec(), **bad)
    with pytest.raises(hlo.AuditParseError, match=what):
        hlo.parse_collectives([rec])


def test_measured_costs_ring_accounting_per_axis():
    """Ring bytes and hops per axis from the records (exact): a gather
    moves (g-1)/g of its output, a sum 2 (g-1)/g of its operand."""

    class Built:
        collectives = (_rec(), _rec("psum", "features", shape=(14, 14), g=2))
        buffers = (("<input>", (3, 64), "torch.float32"), ("aten.mm", (2, 2), "torch.bfloat16"))
        flops = 77

    got = costmodel.measured_costs(Built())
    assert got == {
        "flops": 77, "hbm_bytes_accessed": 3 * 64 * 4 + 2 * 2 * 2,
        "collectives_per_axis": {
            "features": {"bytes_on_wire": 784, "hops": 2, "n_ops": 1, "max_payload_bytes": 784},
            "workers": {"bytes_on_wire": 1536, "hops": 3, "n_ops": 1, "max_payload_bytes": 2048},
        },
    }


def test_cost_bound_and_collective_rules_on_records():
    """check_cost_bound / check_collectives on hand-made records: the tree's
    budget 512 B (128 elems), a stack psum over it, a flat gather outside
    the fleet's empty set; the wire rule's both halves."""
    p = contracts.ProgramParams(d=64, k=2, m=4, n=8, tier_fan_ins=(2, 2),
                                tier_axes=("chip", "host"))
    viols, meta = costmodel.check_cost_bound(
        "tree_merge", p, [_rec("psum", "chip", shape=(4, 64, 2), g=2)], program="x")
    assert meta == {"budget_bytes_per_op": 512} and [v.rule for v in viols] == ["cost-bound"]
    assert costmodel.check_cost_bound("fleet_fit", p, [_rec()], program="x") == (
        [], {"budget_bytes_per_op": 0})
    viols, _ = contracts.check_collectives(contracts.CONTRACTS["fleet_fit"], p, [_rec()],
                                           program="x")
    assert [v.rule for v in viols] == ["collective-op"]
    viols, _ = contracts.check_collectives(contracts.CONTRACTS["scan_fit"], p, [],
                                           program="x")
    assert [v.rule for v in viols] == ["collective-schedule"]
    wire = contracts.ProgramParams(**{**p.__dict__, "tier_wire_dtypes": ("bf16", "int8")})
    movers = [_rec("all_to_all", "chip", "bfloat16", (2, 32, 2), 2),
              _rec("all_to_all", "host", "int8", (2, 32, 2), 2),
              _rec("all_gather", "host", "float32", (1, 2), 2, tag="int8_scale")]
    viols, _ = contracts.check_collectives(contracts.CONTRACTS["tree_merge"], wire, movers,
                                           program="x")
    assert viols == []  # the fp32 scale sidecar sits below the floor
    drifted = movers[:1] + [_rec("all_gather", "host", "float32", (32, 2), 2)]
    viols, _ = contracts.check_collectives(contracts.CONTRACTS["tree_merge"], wire, drifted,
                                           program="x")
    # no s8 mover on the host tier, and a full-width fp32 one there
    assert [v.rule for v in viols] == ["collective-wire-dtype"] * 2
    assert "no data-moving collective carries s8" in viols[0].message
    assert "128 f32 elems" in viols[1].message


def test_check_snapshot_names_each_drift():
    snap = {"schema": costmodel.SNAPSHOT_SCHEMA, "projections": {"a": 1},
            "programs": {"p": {"contract": "scan_fit", "flops": 1, "hbm_bytes_accessed": 2,
                               "collectives_per_axis": {}, "model": {},
                               "budget_bytes_per_op": 8}}}
    assert costmodel.check_snapshot(snap, snap) == []
    drifted = {**snap, "programs": {"p": {**snap["programs"]["p"], "flops": 3}, "q": {}}}
    got = [v.message for v in costmodel.check_snapshot(drifted, snap)]
    assert any("p: flops drifted" in m for m in got) and any("'q'" in m for m in got)
    # the card's check holds only the collective fields
    assert costmodel.check_snapshot(
        {**drifted, "programs": {"p": drifted["programs"]["p"]}}, snap,
        keys=("collectives_per_axis", "budget_bytes_per_op"), projections_too=False) == []
    assert [v.rule for v in costmodel.check_snapshot(snap, None)] == ["cost-drift"]


# -- engine_report and the metrics sink -------------------------------------------


def test_engine_report_audits_the_acquired_buckets_like_the_reference(devices):
    """The same calls on both engines acquire the same buckets; both
    reports audit them against serve_transform and find them clean, and
    the port's report acquires nothing (its counters do not move)."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from distributed_eigenspaces_tpu.analysis import report as jreport
    from distributed_eigenspaces_tpu.serving.transform import TransformEngine as JEngine
    from distributed_eigenspaces_tpu_torch.analysis import report
    from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 64)).astype(np.float32)
    v = np.linalg.qr(rng.standard_normal((64, 2)))[0].astype(np.float32)
    eng, jeng = TransformEngine(64, 2, device="cpu"), JEngine(64, 2)
    z = eng.project(torch.from_numpy(x), torch.from_numpy(v))
    eng.reconstruct(z, torch.from_numpy(v))
    eng.residual_energy(torch.from_numpy(x), z)
    jz = jeng.project(jnp.asarray(x), jnp.asarray(v))
    jeng.reconstruct(jz, jnp.asarray(v))
    jeng.residual_energy(jnp.asarray(x), jz)
    before = eng.stats()
    rep = report.engine_report(eng)
    ref = jreport.engine_report(jeng)
    assert eng.stats() == before
    assert sorted(rep["programs"]) == sorted(ref["programs"])
    assert (rep["contract"], rep["ok"], rep["n_violations"]) == (
        ref["contract"], ref["ok"], ref["n_violations"]) == ("serve_transform", True, 0)
    for name, entry in rep["programs"].items():
        assert entry["collectives"]["n_collectives"] == 0 and entry["ok"]
        assert ("memory" in entry) == ("memory" in ref["programs"][name])
    m = MetricsLogger().attach_analysis(lambda: report.engine_report(eng))
    assert m.summary()["analysis"]["programs"].keys() == rep["programs"].keys()
