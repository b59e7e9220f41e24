"""The port's sharding pass (``analysis/shardings.py``) case by case against
the reference's (``tests/test_shardings.py``), on the CPU.

The reference reads a compiled executable's leaf shardings; the port holds
the local shapes a rank held against the global shapes its program's build
states, on a mesh of known axis sizes. Each case runs the reference's
checker on its compiled ``(128, 2)`` identity (workers 4 x features 2,
input sharded over ``features``, output as the case asks) and the port's on
the shapes a rank of the same layout holds, and requires the same verdict:
the same rule names, each message naming program, buffer shape and where.
No process group is started here (the matrix's programs are
``tests/test_torch_analysis_mesh.py``'s). Every comparison is exact.
"""

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributed_eigenspaces_tpu.analysis import shardings as jsh
from distributed_eigenspaces_tpu.analysis.contracts import ProgramParams as JParams
from distributed_eigenspaces_tpu.parallel.mesh import make_mesh
from distributed_eigenspaces_tpu_torch.analysis import contracts, shardings as sh
from distributed_eigenspaces_tpu_torch.analysis.contracts import ProgramParams
from distributed_eigenspaces_tpu_torch.analysis.shardings import (
    WILD,
    DeclaredBuffer,
    HeldShapes,
    ShardingContract,
)

D, Q = 128, 2
AXES = {"workers": 4, "features": 2}
KW = dict(d=D, k=Q, m=4, n=8, n_feature_shards=2, n_workers_mesh=4)
ROWS = (D // 2, Q)  # a rank's rows of the (D, Q) basis over features


def _basis_contract(mod, **kw):
    return mod.ShardingContract(
        buffers=(
            mod.DeclaredBuffer("basis in", "in", dims=lambda p: (p.d, mod.WILD),
                               spec=lambda p: ("features", None)),
            mod.DeclaredBuffer("basis out", "out", dims=lambda p: (p.d, mod.WILD),
                               spec=lambda p: ("features", None)),
        ),
        **kw,
    )


def _ref(scontract, out_spec, hlo=None):
    """The reference's verdict on its compiled identity with ``out_spec``."""
    mesh = make_mesh(num_workers=4, num_feature_shards=2)
    fn = jax.jit(lambda v: 2.0 * v, in_shardings=NamedSharding(mesh, P("features", None)),
                 out_shardings=NamedSharding(mesh, out_spec))
    arg = jax.ShapeDtypeStruct((D, Q), jnp.float32)
    compiled = fn.lower(arg).compile()
    return jsh.check_shardings(
        scontract, JParams(**KW), program="unit_program", dense_dim=D,
        in_avals=[arg], in_shardings=jax.tree_util.tree_leaves(compiled.input_shardings),
        out_avals=[arg], out_shardings=jax.tree_util.tree_leaves(compiled.output_shardings),
        hlo_text=compiled.as_text() if hlo is None else hlo,
    )


def _port(scontract, ins=(ROWS,), outs=(ROWS,), buffers=(), in_global=((D, Q),),
          out_global=((D, Q),), rank=1):
    """The port's verdict on what one rank held."""
    return sh.check_shardings(
        scontract, ProgramParams(**KW), program="unit_program", dense_dim=D,
        axis_sizes=AXES, in_global=list(in_global), out_global=list(out_global),
        held=HeldShapes(rank=rank, ins=tuple(ins), outs=tuple(outs), buffers=tuple(buffers)),
    )


def _rules(viols):
    return sorted(v.rule for v in viols)


def test_clean_sharded_program_passes(devices):
    ref, ref_m = _ref(_basis_contract(jsh), P("features", None))
    viols, metrics = _port(_basis_contract(sh))
    assert not viols and not ref, [v.format() for v in viols]
    assert metrics["checked"] and metrics["n_sharded_ok"] == ref_m["n_sharded_ok"] == 2
    assert all(row["ok"] for row in metrics["buffers"])
    assert [row["declared"] for row in metrics["buffers"]] == [
        row["declared"] for row in ref_m["buffers"]]
    assert [row["held"] for row in metrics["buffers"]] == ["(1/2, None)"] * 2


def test_silent_replication_names_shape_and_location(devices):
    """Declared sharded, held whole: the rank that got all D rows back."""
    ref, _ = _ref(_basis_contract(jsh), P())
    viols, _ = _port(_basis_contract(sh), outs=((D, Q),))
    assert _rules(viols) == _rules(ref) == ["silent-replication"]
    msg = viols[0].format()
    assert "unit_program" in msg and f"[{D}, {Q}]" in msg and "REPLICATED" in msg
    assert viols[0].location == "out[0] on rank 1"


def test_declared_replicated_but_held_sharded(devices):
    stale = lambda mod: mod.ShardingContract(  # noqa: E731
        buffers=(mod.DeclaredBuffer("basis in", "in", dims=lambda p: (p.d, mod.WILD),
                                    spec=lambda p: (None, None)),),
        require_some=False)
    ref, _ = _ref(stale(jsh), P("features", None))
    viols, _ = _port(stale(sh))
    assert _rules(viols) == _rules(ref) == ["sharding-contract"]
    assert "declared replicated" in viols[0].message and viols[0].location == "in[0] on rank 1"


def test_held_over_another_axis_set_is_a_contract_breach():
    """Sharded, but not as declared: a quarter of the rows (workers 4)
    where ``features`` alone would leave half."""
    viols, _ = _port(_basis_contract(sh, require_some=False), ins=((D // 4, Q),))
    assert _rules(viols) == ["sharding-contract"]
    assert "(64 of 128 a rank)" in viols[0].message and "holds 32 of it" in viols[0].message
    unknown = ShardingContract(buffers=(DeclaredBuffer(
        "basis in", "in", dims=lambda p: (p.d, WILD), spec=lambda p: ("chip", None)),),
        require_some=False)
    viols, _ = _port(unknown)
    assert _rules(viols) == ["sharding-contract"] and "does not have" in viols[0].message


def test_stale_pattern_matching_no_leaf_is_loud(devices):
    stale = lambda mod: mod.ShardingContract(  # noqa: E731
        buffers=(mod.DeclaredBuffer("ghost", "in", dims=lambda p: (999, mod.WILD),
                                    spec=lambda p: ("features", None)),),
        require_some=False)
    ref, _ = _ref(stale(jsh), P("features", None))
    viols, _ = _port(stale(sh))
    assert _rules(viols) == _rules(ref) == ["sharding-contract"]
    assert "matched no" in viols[0].message


def test_vacuous_contract_refused(devices):
    """require_some: a contract whose declared-sharded buffers all skip
    fails rather than passes."""
    vacuous = lambda mod: mod.ShardingContract(buffers=(mod.DeclaredBuffer(  # noqa: E731
        "optional ghost", "in", dims=lambda p: (999, mod.WILD),
        spec=lambda p: ("features", None), required=False),))
    ref, _ = _ref(vacuous(jsh), P("features", None))
    viols, _ = _port(vacuous(sh))
    assert _rules(viols) == _rules(ref) == ["sharding-contract"]
    assert "vacuously" in viols[0].message
    # a declared-sharded buffer whose axis has size 1 proves nothing either
    one = ShardingContract(buffers=(DeclaredBuffer(
        "rows", "in", dims=lambda p: (p.d, WILD), spec=lambda p: ("workers", None)),))
    viols, _ = sh.check_shardings(
        one, ProgramParams(**KW), program="unit_program", dense_dim=D,
        axis_sizes={"workers": 1, "features": 2}, in_global=[(D, Q)], out_global=[],
        held=HeldShapes(rank=0, ins=((D, Q),), outs=()))
    assert _rules(viols) == ["sharding-contract"] and "vacuously" in viols[0].message


def test_leaf_misalignment_is_a_violation_not_a_guess():
    viols, metrics = _port(_basis_contract(sh), in_global=((D, Q), (D, Q)))
    assert (metrics["checked"], metrics["reason"]) == (False, "misaligned leaves")
    assert _rules(viols) == ["sharding-contract"] and "cannot align" in viols[0].message
    viols, _ = _port(_basis_contract(sh), ins=((D // 2, Q, 1),))
    assert "cannot align" in viols[0].message


def test_an_unchecked_layout_prints_as_a_failure_with_its_reason(capsys):
    """A mesh program whose ranks recorded nothing they held is refused
    with a reason, and the analyzer's printout names it on a FAIL line."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from distributed_eigenspaces_tpu_torch.analysis import programs, report

    built = programs.build_program("serve_project_solo", device="cpu")
    bad = dataclasses.replace(built, params=dataclasses.replace(built.params, n_workers_mesh=4))
    viols, detail = contracts.check_program(bad)
    detail["violations"] = report._violations_json(viols)
    assert [v.rule for v in viols] == ["sharding-contract"]
    assert (detail["shardings"]["checked"], detail["shardings"]["reason"]) == (
        False, "nothing held")
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_analyze.py"
    spec = importlib.util.spec_from_file_location("torch_analyze_print", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cli._print_analysis({"device": "cpu", "programs": {"unit_program": detail}, "lints": {}})
    line = capsys.readouterr().out.splitlines()[1]
    assert "FAIL" in line and "layout=nothing_held" in line


def test_wildcard_never_swallows_a_dense_axis():
    """WILD matches only axes strictly below the dense threshold — a (d, d)
    buffer can never bind to a (d, WILD) pattern (as the reference's)."""
    for pattern, shape in (((D, WILD), (D, Q)), ((D, WILD), (D, D)), ((D, WILD), (D,)),
                           ((64, WILD), (D, Q))):
        assert sh._matches(pattern, shape, wildcard_max=D) == jsh._matches(
            pattern, shape, wildcard_max=D)
    assert sh._matches((D, WILD), (D, Q), wildcard_max=D)
    assert not sh._matches((D, WILD), (D, D), wildcard_max=D)


def test_spec_sets_tolerate_tier_axis_reorder():
    """Mesh factorings reorder tier axes freely — compared as sets, padded
    with replicated dims; and a tier spec over both axes of a chip 2 x host
    2 mesh expects a quarter of the dim whatever the order."""
    for entries, rank in (((("chip", "host"),), 1), ((("host", "chip"),), 1),
                          (("workers", None), 2), (("workers",), 3)):
        assert sh._spec_sets(entries, rank) == jsh._spec_sets(entries, rank)
    assert sh._spec_sets((("chip", "host"),), 1) == sh._spec_sets((("host", "chip"),), 1)
    for order in (("chip", "host"), ("host", "chip")):
        tier = ShardingContract(buffers=(DeclaredBuffer(
            "step blocks", "in", dims=lambda p: (WILD, p.m, p.n, p.d),
            spec=lambda p, o=order: (None, o, None, None)),))
        viols, m = sh.check_shardings(
            tier, ProgramParams(d=64, k=2, m=4, n=8, n_workers_mesh=4), program="p",
            dense_dim=64, axis_sizes={"host": 2, "chip": 2}, in_global=[(3, 4, 8, 64)],
            out_global=[], held=HeldShapes(rank=3, ins=((3, 1, 8, 64),), outs=()))
        assert not viols and m["n_sharded_ok"] == 1


def test_replicated_axis_floor_flags_full_d_intermediate(devices):
    """The intermediate-buffer floor: a rank's traced buffer holding a
    full-d axis with >= 2 companion elements is flagged even with no
    matching declared buffer, where the reference reads its HLO."""
    floor = lambda mod: mod.ShardingContract(  # noqa: E731
        buffers=_basis_contract(mod).buffers, replicated_axis_floor=lambda p: p.d)
    ref, _ = _ref(floor(jsh), P("features", None),
                  hlo=f"  %t = f32[{D},{Q}]{{1,0}} add(%a, %b)\n")
    traced = [("aten.cat.default", (D, Q), "torch.float32"),
              ("aten.mm.default", (D, 1), "torch.float32"),  # one companion: not a (d, k)
              ("aten.mm.default", (D // 2, Q), "torch.float32")]
    held = sh.held_shapes(1, (), (), traced, floor=D)
    assert [b[1] for b in held.buffers] == [(D, Q), (D, 1)]
    viols, _ = _port(floor(sh), buffers=held.buffers)
    assert _rules(viols) == _rules(ref) == ["silent-replication"]
    assert "full-width axis" in viols[0].message
    assert viols[0].location == "traced op: aten.cat.default on rank 1"


def test_check_built_skips_unsharded_with_named_reason(devices):
    from distributed_eigenspaces_tpu.analysis import contracts as jcontracts
    from distributed_eigenspaces_tpu.analysis import programs as jprograms
    from distributed_eigenspaces_tpu_torch.analysis import programs

    built = programs.build_program("serve_project_solo", device="cpu")
    viols, metrics = sh.check_built(built, contracts.CONTRACTS[built.contract])
    ref_built = jprograms.build_program("serve_project_solo")
    ref_viols, ref_m = jsh.check_built(ref_built, jcontracts.CONTRACTS[ref_built.contract])
    assert not viols and not ref_viols
    assert (metrics["checked"], metrics["reason"]) == (
        ref_m["checked"], ref_m["reason"]) == (False, "unsharded program")
    viols, metrics = sh.check_built(programs.build_program("pallas_matvec_gram", device="cpu"),
                                    contracts.CONTRACTS["serve_pallas"])
    assert not viols and metrics["reason"] == "no sharding contract"


def test_seeded_replicated_dk_mutant_caught_with_details(devices):
    """The mutation pin: the replicated (d, k) mutant is caught by
    silent-replication with program, the buffer's global shape and the
    location named, as the reference's is."""
    from distributed_eigenspaces_tpu.analysis import mutations as jmutations
    from distributed_eigenspaces_tpu_torch.analysis import mutations

    rule, runner = mutations.MUTATIONS["replicated_dk"]
    assert rule == jmutations.MUTATIONS["replicated_dk"][0] == "silent-replication"
    viols = runner(torch.device("cpu"))
    hits = [v for v in viols if v.rule == rule]
    ref = [v for v in jmutations.MUTATIONS["replicated_dk"][1]() if v.rule == rule]
    assert hits and ref, [v.format() for v in viols]
    v = hits[0]
    assert v.program == ref[0].program == "mutant_replicated_dk"
    assert "[128, 2]" in v.message and "[128, 2]" in ref[0].message
    assert v.location == "out[0] on rank 0"
