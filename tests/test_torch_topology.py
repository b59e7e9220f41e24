"""The hierarchical merge (``parallel/topology.py``) against the reference's.

The resolved tree (``resolve_topology``, ``member_count``, ``group_of``) and
its refusals; the stacked tree over the same numpy factor stack; then, on
four gloo ranks (one ``parallel.mesh.launch``, programs in
``tests/torch_tree_ranks.py``), one tier of the sharded update and the whole
sharded tree against the stacked one, and the tier-local whole fit
(``make_scan_fit`` on a tiered mesh, fp32, masked and under an int8 and a
bf16 wire policy) against the reference's ``make_tree_scan_fit`` on a
tiered mesh of four of its virtual CPU devices, the same data and cold
start (the reference's own ``PRNGKey(0)`` draw).

Tolerances: the stacked tree within 1e-3 degrees of the reference's (the
port's float64 angles); one tier bit-equal to the flat merge; the sharded
tier and tree within 0.1 degrees of the stacked tree (the slice's budget;
another summation order); the fp32 fits within 0.05 degrees and 1e-4 in
``sigma_tilde`` (the slices' fit tolerances, ``tests/test_torch_step.py``),
the wire fits within 0.05 degrees of the reference's wire fits and 0.2
degrees of the fp32 fit (the reference's own wire budget,
``tests/test_wire.py``); every rank's bases bit-equal to rank 0's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tree_ranks as ranks

from distributed_eigenspaces_tpu.algo.online import OnlineState as JaxState
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.parallel import topology as jtp
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    merged_top_k_lowrank,
    principal_angles_degrees,
)
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import topology as tp

SAME_DEG = 1e-3
TIER_DEG = 0.1
FIT_DEG = 0.05
WIRE_DEG = 0.2
SIGMA_ATOL = 1e-4
TIMEOUT = 240.0
D, K, M, N, T = 64, 4, 4, 64, 6
TIERS = (("chip", 2), ("host", 2))
BASE = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
            solver="subspace", subspace_iters=12, merge_topology=TIERS)
MASKS = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 1, 1], [0, 0, 0, 0],
                  [1, 1, 0, 1], [1, 1, 1, 1]], np.float32)


def _angle(a, b) -> float:
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _stack(m=8, d=D, k=K, seed=0):
    """``(m, d, k)`` orthonormal bases near one shared subspace."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((d, k))
    return np.stack([np.linalg.qr(u + 0.3 * rng.standard_normal((d, k)))[0]
                     for _ in range(m)]).astype(np.float32)


def _data(seed=3):
    spec = jsyn.planted_spectrum(D, k_planted=K, gap=20.0, noise=0.01, seed=seed)
    x = np.asarray(spec.sample(jax.random.PRNGKey(seed + 1), T * M * N)).reshape(T, M, N, D)
    return spec, x.astype(np.float32)


def _v0():
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (D, K), jnp.float32))


# -- the resolved tree --------------------------------------------------------------


@pytest.mark.parametrize("tiers,m,d", [
    ((("chip", 4), ("host", 2)), 8, 64),
    ((("all", 8),), 8, 64),
    ((("a", 2), ("b", 3), ("c", 2)), 12, 96),
    ((("leaf", 1), ("root", 4)), 4, 16),
])
def test_resolve_topology_member_count_and_group_of_match_the_reference(tiers, m, d):
    kw = dict(dim=d, k=2, num_workers=m, merge_topology=tiers)
    j, t = jtp.resolve_topology(JaxConfig(**kw)), tp.resolve_topology(PCAConfig(**kw))
    assert (t.tiers, t.names, t.fan_ins, t.num_workers) == (
        j.tiers, j.names, j.fan_ins, j.num_workers)
    for stage in range(len(tiers)):
        assert t.member_count(stage) == j.member_count(stage)
        assert [t.group_of(stage, w) for w in range(m)] == [
            j.group_of(stage, w) for w in range(m)]
    assert tp.resolve_topology(PCAConfig(dim=d, k=2, num_workers=m)) is None


@pytest.mark.parametrize("kw,match", [
    (dict(dim=30, num_workers=8, merge_topology=(("chip", 4), ("host", 2))), "must divide"),
    (dict(dim=64, num_workers=6, merge_topology=(("chip", 4), ("host", 2))), "multiply to"),
])
def test_resolve_topology_refuses_like_the_reference(kw, match):
    for cfg_cls, mod in ((JaxConfig, jtp), (PCAConfig, tp)):
        with pytest.raises(ValueError, match=match):
            mod.resolve_topology(cfg_cls(k=2, **kw))


@pytest.mark.parametrize("kw,match", [
    (dict(merge_topology=()), "non-empty"),
    (dict(merge_topology=(("chip",),)), "pairs"),
    (dict(merge_topology=(("", 2),)), "non-empty strings"),
    (dict(merge_topology=(("chip", 0),)), "int >= 1"),
    (dict(merge_topology=(("chip", True),)), "int >= 1"),
    (dict(merge_topology=(("chip", 2), ("chip", 2))), "unique"),
    (dict(merge_topology=(("chip", 2),), pipeline_merge=True, solver="subspace"),
     "pipeline_merge"),
    (dict(merge_topology=(("chip", 2),), backend="feature_sharded"), "feature_sharded"),
])
def test_config_refuses_bad_topologies_like_the_reference(kw, match):
    for cfg_cls in (JaxConfig, PCAConfig):
        with pytest.raises(ValueError, match=match):
            cfg_cls(dim=32, k=2, num_workers=2, **kw)


def test_config_normalizes_the_topology_as_the_reference():
    kw = dict(dim=32, k=2, num_workers=4, merge_topology=[["chip", 2], ["host", 2]])
    assert PCAConfig(**kw).merge_topology == JaxConfig(**kw).merge_topology == (
        ("chip", 2), ("host", 2))


# -- the stacked tree -----------------------------------------------------------------


@pytest.mark.parametrize("tiers,mask", [
    ((("chip", 4), ("host", 2)), None),
    ((("chip", 2), ("host", 4)), None),
    ((("a", 2), ("b", 2), ("c", 2)), None),
    ((("chip", 4), ("host", 2)), [1, 0, 1, 1, 0, 0, 1, 1]),
    ((("chip", 2), ("host", 4)), [0, 0, 1, 1, 1, 0, 0, 0]),
])
def test_tree_merge_stacked_matches_the_reference(tiers, mask):
    vs = _stack()
    topo = tp.MergeTopology(tiers)
    jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
    tmask = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    want = np.asarray(jtp.tree_merge_stacked(jnp.asarray(vs), K, jtp.MergeTopology(tiers),
                                             mask=jmask))
    got = tp.tree_merge_stacked(torch.from_numpy(vs), K, topo, mask=tmask).numpy()
    assert got.shape == (D, K)
    assert _angle(got, want) <= SAME_DEG


def test_root_tier_on_the_distributed_solve_matches_the_reference():
    """``root_dist_iters``: the root tier solved by
    ``merged_top_k_distributed`` (lower tiers exact), from the reference's
    ``PRNGKey(0)`` start of width k plus the root operator's oversample."""
    vs = _stack()
    tiers = (("chip", 4), ("host", 2))
    kk = K + min(8, 2 * K - K)
    v_init = np.array(jax.random.normal(jax.random.PRNGKey(0), (D, kk), jnp.float32))
    want = np.asarray(jtp.tree_merge_stacked(jnp.asarray(vs), K, jtp.MergeTopology(tiers),
                                             root_dist_iters=40))
    got = tp.tree_merge_stacked(torch.from_numpy(vs), K, tp.MergeTopology(tiers),
                                root_dist_iters=40, root_v_init=torch.from_numpy(v_init))
    assert _angle(got, want) <= SAME_DEG
    assert _angle(got, tp.tree_merge_stacked(torch.from_numpy(vs), K,
                                             tp.MergeTopology(tiers))) <= SAME_DEG


def test_one_tier_is_the_flat_merge_bit_for_bit_and_a_dead_group_adds_nothing():
    vs = torch.from_numpy(_stack())
    one = tp.tree_merge_stacked(vs, K, tp.MergeTopology((("all", 8),)))
    assert torch.equal(one, merged_top_k_lowrank(vs, K))
    mask = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], dtype=torch.float32)
    two = tp.tree_merge_stacked(vs, K, tp.MergeTopology((("chip", 4), ("host", 2))),
                                mask=mask)
    # the dead chip group merges to zeros with weight zero: the root is the
    # live group's merge alone
    assert _angle(two, merged_top_k_lowrank(vs[4:], K)) <= SAME_DEG
    dead = tp.tree_merge_stacked(vs, K, tp.MergeTopology((("chip", 4), ("host", 2))),
                                 mask=torch.zeros(8))
    assert not torch.any(dead)
    with pytest.raises(ValueError, match="covers"):
        tp.tree_merge_stacked(vs[:4], K, tp.MergeTopology((("chip", 4), ("host", 2))))


def test_merge_core_resolves_the_topology_once_and_none_is_the_flat_merge():
    from distributed_eigenspaces_tpu_torch.algo.step import merge_core, merge_knobs

    vs = torch.from_numpy(_stack(m=4))
    flat = merge_knobs(PCAConfig(**dict(BASE, merge_topology=None)))
    assert flat["topology"] is None
    assert torch.equal(merge_core(vs, K, **flat), merged_top_k_lowrank(vs, K))
    knobs = merge_knobs(PCAConfig(**BASE))
    assert knobs["topology"] == tp.MergeTopology(TIERS)
    assert torch.equal(merge_core(vs, K, **knobs),
                       tp.tree_merge_stacked(vs, K, tp.MergeTopology(TIERS)))


def test_the_tiered_route_refuses_outside_a_tiered_mesh():
    with pytest.raises(ValueError, match="merge_topology"):
        tp.make_tree_scan_fit(PCAConfig(**dict(BASE, merge_topology=None)), None)
    with pytest.raises(ValueError, match="do not match"):
        tp.make_tree_scan_fit(PCAConfig(**BASE), pmesh.local_mesh("cpu"))
    assert not tp.is_tiered_mesh(pmesh.local_mesh("cpu"), tp.MergeTopology(TIERS))
    with pytest.raises(RuntimeError, match="process group"):
        tp.make_tiered_mesh(tp.MergeTopology(TIERS), device="cpu")


# -- four ranks -------------------------------------------------------------------------


def _fit_cases():
    _, xs = _data()
    v0 = _v0()
    return [
        ("fp32", BASE, xs, v0, None, False),
        ("cold", dict(BASE, warm_start_iters=None), xs, v0, None, False),
        ("masked", BASE, xs, v0, MASKS, False),
        ("int8", dict(BASE, merge_wire_dtype={"host": "int8"}), xs, v0, None, True),
        ("bf16", dict(BASE, merge_wire_dtype={"chip": "bf16", "host": "bf16"}), xs, v0,
         None, True),
        ("fp32_policy", dict(BASE, merge_wire_dtype={"chip": "fp32", "host": "fp32"}), xs,
         v0, None, True),
        ("int8_masked", dict(BASE, merge_wire_dtype={"host": "int8"}), xs, v0, MASKS, True),
    ]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    vs = _stack(m=4)
    mask = np.array([1, 1, 0, 1], np.float32)
    out = pmesh.launch(ranks.topology_suite, 4, TIERS, vs, mask, _fit_cases(),
                       workdir=str(tmp_path_factory.mktemp("tree")), timeout=TIMEOUT)
    return vs, mask, out


def _jax_fit(kw, xs, masks, stats):
    jcfg = JaxConfig(**kw)
    mesh = jtp.make_tiered_mesh(jtp.resolve_topology(jcfg), devices=jax.devices()[:M])
    fit = jtp.make_tree_scan_fit(jcfg, mesh, masked=masks is not None,
                                 with_wire_stats=stats)
    args = (JaxState.initial(D), jnp.asarray(xs)) + (
        () if masks is None else (jnp.asarray(masks),))
    return fit(*args)


def test_sharded_tier_and_tree_on_four_ranks_match_the_stacked_tree(four_ranks):
    vs, mask, out = four_ranks
    topo = tp.MergeTopology(TIERS)
    tv, tm = torch.from_numpy(vs), torch.from_numpy(mask)
    for r in range(4):
        got = out[r]["merges"]
        assert got["leaf"] == r
        assert got["axes"] == ("host", "chip")
        assert got["shape"] == {"host": 2, "chip": 2}
        group = slice(2 * (r // 2), 2 * (r // 2) + 2)
        want = merged_top_k_lowrank(tv[group], K, mask=tm[group])
        assert got["cnt"] == float(mask[group].sum())
        assert _angle(got["tier"], want) <= TIER_DEG
        stacked = tp.tree_merge_stacked(tv, K, topo, mask=tm)
        assert _angle(got["tree"], stacked) <= TIER_DEG
        assert _angle(got["tree"], jtp.tree_merge_stacked(
            jnp.asarray(vs), K, jtp.MergeTopology(TIERS), mask=jnp.asarray(mask))) <= TIER_DEG
        # an all-fp32 wire policy takes the plain tier: the same bits, zero norms
        np.testing.assert_array_equal(got["tree_fp32"], got["tree"])
        assert not np.any(got["norms"])
        np.testing.assert_array_equal(got["tree"], out[0]["merges"]["tree"])


@pytest.mark.parametrize("name", ["fp32", "cold", "masked"])
def test_tree_fit_on_four_ranks_matches_the_reference(four_ranks, name):
    *_, out = four_ranks
    _, kw, xs, _, masks, _ = next(c for c in _fit_cases() if c[0] == name)
    jst, jvb = _jax_fit(kw, xs, masks, False)
    got = out[0]["fits"][name]
    np.testing.assert_allclose(got["sigma"], np.asarray(jst.sigma_tilde),
                               atol=SIGMA_ATOL, rtol=0)
    for t in range(T):
        if not np.any(np.asarray(jvb[t])):  # every worker masked: zeros
            assert not np.any(got["v_bars"][t]), t
        else:
            assert _angle(got["v_bars"][t], jvb[t]) <= FIT_DEG, t
    for r in range(1, 4):
        np.testing.assert_array_equal(out[r]["fits"][name]["v_bars"], got["v_bars"])
        np.testing.assert_array_equal(out[r]["fits"][name]["sigma"], got["sigma"])


@pytest.mark.parametrize("name", ["int8", "bf16", "int8_masked"])
def test_wire_fit_on_four_ranks_matches_the_reference(four_ranks, name):
    *_, out = four_ranks
    spec, _ = _data()
    _, kw, xs, _, masks, _ = next(c for c in _fit_cases() if c[0] == name)
    _, jvb, jnorms = _jax_fit(kw, xs, masks, True)
    got = out[0]["fits"][name]
    assert got["norms"].shape == (T, 2) == np.asarray(jnorms).shape
    assert np.all(np.isfinite(got["norms"]))
    assert _angle(got["v_bars"][-1], jvb[-1]) <= FIT_DEG
    ref = out[0]["fits"]["masked" if masks is not None else "fp32"]["v_bars"][-1]
    assert _angle(got["v_bars"][-1], ref) <= WIRE_DEG
    assert _angle(got["v_bars"][-1], spec.top_k(K)) <= _angle(ref, spec.top_k(K)) + WIRE_DEG
    for r in range(1, 4):
        np.testing.assert_array_equal(out[r]["fits"][name]["v_bars"], got["v_bars"])


def test_fp32_policy_is_the_plain_fit_bit_for_bit(four_ranks):
    *_, out = four_ranks
    fits = out[0]["fits"]
    np.testing.assert_array_equal(fits["fp32_policy"]["v_bars"], fits["fp32"]["v_bars"])
    assert not np.any(fits["fp32_policy"]["norms"])


def test_tree_fit_collectives_stay_within_the_tier_payload_bound(four_ranks):
    """The recorder's log: per step and tier one weight sum, one all-to-all
    of ``d k`` elements, one ``(f k)^2`` Gram sum and one all-gather of the
    ``d / f`` merged rows, every sum fp32, every data mover in its tier's
    wire dtype, no payload above ``max(d k, (f k)^2)`` (the flat route
    gathers ``m d k``)."""
    *_, out = four_ranks
    for name, wire in (("fp32", {}), ("int8", {"host": "int8"}),
                       ("bf16", {"chip": "bfloat16", "host": "bfloat16"})):
        log = out[0]["fits"][name]["log"]
        for tier, f in TIERS:
            mine = [r for r in log if r[1] == tier]
            want = wire.get(tier, "float32")
            movers = [r for r in mine if r[0] in ("all_to_all", "all_gather") and r[5] is None]
            assert [r[0] for r in movers] == ["all_to_all", "all_gather"] * T
            assert {r[2] for r in movers} == {want}, (name, tier)
            assert {r[2] for r in mine if r[0] == "psum"} == {"float32"}
            assert {r[3] for r in movers if r[0] == "all_to_all"} == {D * K}
            assert {r[3] for r in movers if r[0] == "all_gather"} == {D * K // f}
            assert max(r[3] for r in mine) <= max(D * K, (f * K) ** 2) < M * D * K
            assert {r[4] for r in mine} == {f}


def test_tree_fit_refusals_on_a_tiered_mesh(four_ranks):
    *_, out = four_ranks
    errors = out[0]["fits"]["errors"]
    assert "merge_interval > 1" in errors["interval"]
    assert "with_wire_stats" in errors["stats"]
    assert "gather staging" in errors["gather"]
    assert "do not match" in errors["mesh"]
