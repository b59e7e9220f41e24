"""The port's cohort merge (``parallel/clients.py``) against the reference's.

Every function of the module on the same numpy inputs as the JAX
package's: the gauntlet's reasons; clip, sign alignment and the trimmed
mean elementwise; the hardened merge (flat and over a merge topology), its
keep mask and its screen fallback; the naive arm; the topology's
resolution against the cohort; and the sharded reduce on two gloo ranks at
an fp32 and a bf16 wire. Merged bases are held within 0.05 degrees (the
port's float64 angles). The reference's cases are
``tests/test_population.py``'s clients-level and topology tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.parallel import clients as jcl
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import clients as cl
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

import torch_fleet_ranks as ranks

D, K = 24, 3
DEG = 0.05


def _kw(**kw):
    base = dict(dim=D, k=K, num_workers=4, rows_per_worker=8, num_steps=4,
                backend="local", cohort_size=48, max_poison_frac=0.1)
    base.update(kw)
    return base


def _cfgs(**kw):
    return PCAConfig(**_kw(**kw)), JaxConfig(**_kw(**kw))


def _orthonormal(rng, d=D, k=K):
    q, _ = np.linalg.qr(rng.standard_normal((d, k)))
    return np.asarray(q, np.float32)


def _honest_stack(rng, planted, n, noise=0.02):
    out = []
    for _ in range(n):
        w, r = np.linalg.qr(planted + noise * rng.standard_normal(planted.shape))
        out.append(w * np.sign(np.diag(r))[None, :])
    return np.asarray(out, np.float32)


def _poisoned(seed, honest=36, poison=4):
    """Honest summaries of a planted basis plus ``poison`` colluders that
    all submit the same sign-flipped orthonormal basis orthogonal to it."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((D, 2 * K)))
    planted, adv = q[:, :K], q[:, K: 2 * K]
    stack = np.concatenate([_honest_stack(rng, planted, honest),
                            np.repeat(-adv[None].astype(np.float32), poison, 0)])
    return planted.astype(np.float32), stack


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _angle(a, b):
    return float(principal_angles_degrees(_t(a), _t(b)).max())


# -- the validation gauntlet -------------------------------------------------------


def test_gauntlet_reasons_match_the_reference():
    rng = np.random.default_rng(0)
    good = _orthonormal(rng)
    nan = good.copy()
    nan[3, 1] = np.nan
    cases = [good, _orthonormal(rng, D, K + 1), np.zeros((D, K), np.int32), nan,
             3.0 * good, np.asarray(1.2 * good, np.float64), good[:, :2]]
    want = [None, "bad_shape", "bad_dtype", "nonfinite", "not_orthonormal",
            "not_orthonormal", "bad_shape"]
    got = [cl.validate_contribution(w, D, K) for w in cases]
    assert got == want == [jcl.validate_contribution(w, D, K) for w in cases]
    assert cl.validate_contribution(_t(good), D, K) is None  # a tensor too
    assert cl.REJECT_REASONS == jcl.REJECT_REASONS
    assert set(cl.REJECT_REASONS) == {"bad_shape", "bad_dtype", "nonfinite",
                                      "not_orthonormal"}


# -- clip / sign-align / trimmed mean ----------------------------------------------


def test_clip_bounds_frobenius_norms():
    rng = np.random.default_rng(1)
    stack = np.stack([_orthonormal(rng), np.asarray(10.0 * _orthonormal(rng), np.float32)])
    clipped = cl.clip_factor_norms(_t(stack), clip_mult=1.0).numpy()
    np.testing.assert_allclose(clipped, np.asarray(jcl.clip_factor_norms(jnp.asarray(stack))),
                               rtol=1e-6, atol=1e-7)
    norms = np.linalg.norm(clipped, axis=(1, 2))
    assert (norms <= np.sqrt(K) * (1.0 + 1e-4)).all()
    np.testing.assert_allclose(clipped[0], stack[0], atol=1e-6)
    half = cl.clip_factor_norms(_t(stack), clip_mult=0.5).numpy()
    np.testing.assert_allclose(
        half, np.asarray(jcl.clip_factor_norms(jnp.asarray(stack), clip_mult=0.5)),
        rtol=1e-6, atol=1e-7)


def test_align_signs_undoes_column_flips():
    rng = np.random.default_rng(2)
    base = _orthonormal(rng)
    flipped = base * np.asarray([-1.0, 1.0, -1.0], np.float32)
    stack = np.stack([base, base, flipped])
    for mask in (np.ones(3, np.float32), np.asarray([1.0, 0.0, 1.0], np.float32)):
        aligned = cl._align_signs(_t(stack), _t(mask)).numpy()
        np.testing.assert_array_equal(
            aligned, np.asarray(jcl._align_signs(jnp.asarray(stack), jnp.asarray(mask))))
    aligned = cl._align_signs(_t(stack), torch.ones(3)).numpy()
    assert np.abs(aligned - aligned.mean(axis=0)).max() < 1e-5


def test_trimmed_mean_inside_honest_envelope():
    """The steering bound: at most an alpha fraction of colluders land in
    the trimmed tails, so every trimmed coordinate is a convex combination
    of honest values; the plain mean has no such bound."""
    _, stack = _poisoned(3)
    honest = stack[:36]
    mask = np.ones(len(stack), np.float32)
    alpha = 4 / len(stack)
    trimmed = cl.trimmed_mean_factors(_t(stack), _t(mask), alpha).numpy()
    np.testing.assert_allclose(
        trimmed, np.asarray(jcl.trimmed_mean_factors(jnp.asarray(stack), jnp.asarray(mask),
                                                     alpha)), rtol=1e-6, atol=1e-7)
    lo, hi = honest.min(axis=0), honest.max(axis=0)
    assert ((trimmed >= lo - 1e-6) & (trimmed <= hi + 1e-6)).all()
    plain = stack.mean(axis=0)
    assert ((plain < lo - 1e-6) | (plain > hi + 1e-6)).any()


@pytest.mark.parametrize("mask", [[1.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
def test_trimmed_mean_ignores_masked_slots(mask):
    rng = np.random.default_rng(4)
    base = _orthonormal(rng)
    junk = np.full((D, K), 50.0, np.float32)
    stack = np.stack([base, base, junk])
    mask = np.asarray(mask, np.float32)
    out = cl.trimmed_mean_factors(_t(stack), _t(mask), 0.0).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(jcl.trimmed_mean_factors(jnp.asarray(stack), jnp.asarray(mask), 0.0)))
    np.testing.assert_allclose(out, base if mask.any() else 0.0, atol=1e-6)


# -- the hardened merge --------------------------------------------------------------


def test_hardened_merge_screens_orthonormal_colluders():
    planted, stack = _poisoned(5)
    mask = np.ones(len(stack), np.float32)
    v, keep, stats = cl.hardened_merge_body(_t(stack), _t(mask), k=K, alpha=0.1)
    jv, jkeep, jstats = jcl.hardened_merge_body(jnp.asarray(stack), jnp.asarray(mask),
                                                k=K, alpha=0.1)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert (keep.numpy()[36:] == 0).all() and (keep.numpy()[:36] == 1).all()
    assert _angle(v, np.asarray(jv)) < DEG
    for name in ("arrived", "kept", "trim_frac", "screen_fallback"):
        assert float(stats[name]) == pytest.approx(float(jstats[name]), abs=1e-6), name
    assert float(stats["min_kept_aff"]) == pytest.approx(float(jstats["min_kept_aff"]),
                                                         abs=1e-5)
    ang_h = _angle(v, planted)
    naive = cl.naive_mean_basis(_t(stack), _t(mask), K)
    assert _angle(naive, np.asarray(jcl.naive_mean_basis(jnp.asarray(stack),
                                                         jnp.asarray(mask), K))) < DEG
    ang_n = _angle(naive, planted)
    assert ang_h < 2.0 and ang_n > 2.0 * ang_h


def test_population_merge_matches_the_body():
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(6)
    stack = _honest_stack(rng, _orthonormal(rng), cfg.cohort_size)
    mask = np.ones(cfg.cohort_size, np.float32)
    mask[[3, 17]] = 0.0
    v1, keep1, _ = cl.make_population_merge(cfg, device="cpu")(stack, mask)
    v2, keep2, _ = cl.hardened_merge_body(_t(stack), _t(mask), k=cfg.k,
                                          alpha=cfg.max_poison_frac)
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    np.testing.assert_array_equal(keep1.numpy(), keep2.numpy())
    jv, jkeep, _ = jcl.make_population_merge(jcfg)(jnp.asarray(stack), jnp.asarray(mask))
    np.testing.assert_array_equal(keep1.numpy(), np.asarray(jkeep))
    assert _angle(v1, np.asarray(jv)) < DEG


def test_hardened_merge_over_a_topology():
    """The survivors through the tiered tree (``tree_merge_stacked``), with
    a screened colluder inside a tree group."""
    cfg, jcfg = _cfgs(cohort_size=8, merge_topology=(("chip", 4), ("host", 2)))
    topo, jtopo = cl.population_topology(cfg), jcl.population_topology(jcfg)
    assert topo.tiers == tuple(jtopo.tiers) == (("chip", 4), ("host", 2))
    planted, stack = _poisoned(7, honest=7, poison=1)
    stack = stack[[0, 1, 7, 2, 3, 4, 5, 6]]  # the colluder in the first chip group
    mask = np.ones(8, np.float32)
    mask[5] = 0.0
    v, keep, _ = cl.make_population_merge(cfg, device="cpu")(stack, mask)
    jv, jkeep, _ = jcl.make_population_merge(jcfg)(jnp.asarray(stack), jnp.asarray(mask))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert keep.numpy()[2] == 0 and keep.numpy()[5] == 0
    assert _angle(v, np.asarray(jv)) < DEG
    assert _angle(v, planted) < 5.0  # six honest summaries: the bench's budget
    flat, _, _ = cl.hardened_merge_body(_t(stack), _t(mask), k=K, alpha=0.1)
    assert _angle(v, flat) < 0.5


def test_screen_fallback_keeps_every_arrival():
    """A screen that would exclude everyone falls back to the arrival mask,
    and says so in its stats."""
    rng = np.random.default_rng(8)
    stack = np.stack([_orthonormal(rng) for _ in range(6)])
    mask = np.asarray([1, 1, 1, 0, 1, 1], np.float32)
    v, keep, stats = cl.hardened_merge_body(_t(stack), _t(mask), k=K, alpha=0.0,
                                            screen_tau=1.01)
    jv, jkeep, jstats = jcl.hardened_merge_body(jnp.asarray(stack), jnp.asarray(mask),
                                                k=K, alpha=0.0, screen_tau=1.01)
    np.testing.assert_array_equal(keep.numpy(), mask)
    np.testing.assert_array_equal(np.asarray(jkeep), mask)
    assert float(stats["screen_fallback"]) == float(jstats["screen_fallback"]) == 1.0
    assert float(stats["trim_frac"]) == pytest.approx(float(jstats["trim_frac"]))
    assert _angle(v, np.asarray(jv)) < DEG


# -- topology and config -----------------------------------------------------------


def test_population_topology_resolves_against_cohort():
    assert cl.population_topology(_cfgs()[0]) is None
    cfg, _ = _cfgs(cohort_size=8, merge_topology=(("chip", 4), ("host", 2)))
    assert tuple(f for _, f in cl.population_topology(cfg).tiers) == (4, 2)


@pytest.mark.parametrize("kw,match", [
    (dict(cohort_size=48, merge_topology=(("chip", 4), ("host", 2))), "cohort_size"),
    (dict(cohort_size=10, merge_topology=(("chip", 5), ("host", 2))), "must divide dim"),
])
def test_population_topology_must_cover_the_cohort(kw, match):
    cfg, jcfg = _cfgs(**kw)
    with pytest.raises(ValueError, match=match) as err:
        cl.population_topology(cfg)
    with pytest.raises(ValueError, match=match) as jerr:
        jcl.population_topology(jcfg)
    assert str(err.value) == str(jerr.value)


# -- the sharded reduce on two ranks ---------------------------------------------------


def test_sharded_cohort_reduce_on_two_gloo_ranks():
    """One stack gather in the wire dtype and one fp32 mask gather over
    ``workers``; every rank merges the same bits. At fp32 the result is the
    one-process merge; at a bf16 wire it is within 0.05 degrees of it."""
    cfg, jcfg = _cfgs(cohort_size=40)
    planted, stack = _poisoned(9)
    mask = np.ones(40, np.float32)
    mask[11] = 0.0
    out = pmesh.launch(ranks.cohort_rank, 2, _kw(cohort_size=40), stack, mask,
                       ("fp32", "bf16"), backend="gloo", timeout=240)
    one, _, _ = cl.make_population_merge(cfg, device="cpu")(stack, mask)
    jone, _, _ = jcl.make_population_merge(jcfg)(jnp.asarray(stack), jnp.asarray(mask))
    for wire, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        for o in out:
            assert o[wire]["log"] == [
                ("all_gather", "workers", dtype, 20 * D * K, 2, None),
                ("all_gather", "workers", "float32", 20, 2, None),
            ]
            np.testing.assert_array_equal(o[wire]["v"], out[0][wire]["v"])
            assert _angle(o[wire]["v"], np.asarray(jone)) < DEG
            assert _angle(o[wire]["v"], planted) < 2.0
    np.testing.assert_allclose(out[0]["fp32"]["v"], one.numpy(), rtol=1e-5, atol=1e-6)
