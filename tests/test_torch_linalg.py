"""The port's ops/linalg.py against the reference's ops/linalg.py.

The same numpy inputs go to both; random starts are the reference's own
``jax.random`` draw, handed to the port as ``v0``. Eigenvectors are
compared after both sides canonicalize signs, or as subspaces (principal
angles) where eigenvalues sit close together.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.ops import linalg as jl
from distributed_eigenspaces_tpu_torch.ops import linalg as tl


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _spd(rng, d, gap=True):
    """Symmetric PSD matrix with a clean spectrum (distinct eigenvalues)."""
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.linspace(10.0, 0.1, d) if gap else np.ones(d)
    return ((q * lam) @ q.T).astype(np.float32)


def _max_angle(u, v):
    u = torch.as_tensor(np.array(u, dtype=np.float32))
    v = torch.as_tensor(np.array(v, dtype=np.float32))
    return float(tl.principal_angles_degrees(u, v).max())


def test_guarded_inv_sqrt_matches():
    w = np.array([4.0, 1e-13, 0.0, 0.25, -1.0], np.float32)
    np.testing.assert_allclose(
        tl.guarded_inv_sqrt(T(w)).numpy(), np.asarray(jl.guarded_inv_sqrt(jnp.asarray(w))),
        rtol=1e-6,
    )


def test_initial_basis_is_seeded_and_device_independent():
    a = tl.initial_basis(32, 4, seed=3)
    b = tl.initial_basis(32, 4, seed=3)
    c = tl.initial_basis(32, 4, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (32, 4) and a.dtype == torch.float32


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_start_rows_shards_stack_into_the_one_device_start(shards):
    """Each row shard drawn alone is the whole start's rows, bit for bit,
    whatever the number of shards (a rank draws only its own)."""
    whole = tl.start_rows(0, 96, 5, seed=7)
    per = 96 // shards
    parts = [tl.start_rows(i * per, (i + 1) * per, 5, seed=7) for i in range(shards)]
    assert all(p.shape == (per, 5) and p.dtype == torch.float32 for p in parts)
    assert torch.equal(torch.cat(parts), whole)


def test_start_rows_is_seeded_and_standard_normal():
    """Seeded (the same seed the same bits, another seed others); over
    200,000 values the mean within 0.01 of 0 and the standard deviation
    within 0.01 of 1 (the mean's standard error is 0.0022)."""
    a = tl.start_rows(0, 40000, 5, seed=3)
    assert torch.equal(a, tl.start_rows(0, 40000, 5, seed=3))
    assert not torch.equal(a[:8], tl.start_rows(0, 8, 5, seed=4))
    x = a.double()
    assert abs(float(x.mean())) <= 0.01 and abs(float(x.std()) - 1.0) <= 0.01
    assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_xtxv_matches_with_reference_casts(rng, dtype):
    """bf16 inputs: both products come out fp32, with v and X v rounded to
    bf16 in between exactly where the reference rounds them."""
    x = rng.standard_normal((3, 64, 48)).astype(np.float32)
    v = rng.standard_normal((3, 48, 5)).astype(np.float32)
    want = np.asarray(jl.batched_xtxv(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(v)))
    got = tl.batched_xtxv(T(x).to(getattr(torch, dtype)), T(v))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= (1e-6 if dtype == "float32" else 1e-4)
    if dtype == "bfloat16":
        # skipping the intermediate cast, or rounding the output to bf16,
        # both miss the reference by far more than the tolerance
        xb = T(x).to(torch.bfloat16)
        no_cast = torch.matmul(xb.float().mT, torch.matmul(xb.float(), T(v).to(torch.bfloat16).float()))
        assert _rel(no_cast, want) > 1e-3
        rounded = torch.matmul(xb.mT, torch.matmul(xb, T(v).to(torch.bfloat16)))
        assert _rel(rounded.float(), want) > 1e-3


def test_canonicalize_signs_matches(rng):
    v = rng.standard_normal((20, 6)).astype(np.float32)
    v[3, 2] = 9.0
    v[3, 4] = -9.0
    np.testing.assert_array_equal(
        tl.canonicalize_signs(T(v)).numpy(), np.asarray(jl.canonicalize_signs(jnp.asarray(v)))
    )
    # batched over a leading worker axis
    vb = np.stack([v, -v])
    got = tl.canonicalize_signs(T(vb)).numpy()
    np.testing.assert_array_equal(got[0], got[1])


def test_top_k_eig_matches(rng):
    a = _spd(rng, 40)
    jw, jv = jl.top_k_eig(jnp.asarray(a), 5)
    tw, tv = tl.top_k_eig(T(a), 5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(
        tl.top_k_eigvecs(T(a), 5).numpy(), np.asarray(jl.top_k_eigvecs(jnp.asarray(a), 5)), atol=1e-4
    )
    # batched
    tvb = tl.top_k_eigvecs(T(np.stack([a, a])), 5)
    np.testing.assert_allclose(tvb[1].numpy(), tv.numpy(), atol=1e-6)


@pytest.mark.parametrize("method", ["cholqr2", "qr"])
def test_orthonormalize_matches(rng, method):
    v = rng.standard_normal((64, 6)).astype(np.float32)
    want = np.asarray(jl.orthonormalize(jnp.asarray(v), method))
    got = tl.orthonormalize(T(v), method).numpy()
    # QR's column signs follow LAPACK on both sides; compare the bases and
    # orthonormality
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got.T @ got, np.eye(6), atol=1e-5)
    if method == "cholqr2":
        np.testing.assert_allclose(tl._cholqr2(T(v)).numpy(), np.asarray(jl._cholqr2(jnp.asarray(v))), atol=1e-5)


def test_validate_orth_method():
    for method in ("cholqr2", "qr", "ns"):  # the reference's three
        tl.validate_orth_method(method)
        jl.validate_orth_method(method)
    assert tl.ORTH_METHODS == jl.ORTH_METHODS
    with pytest.raises(ValueError, match="unknown"):
        tl.validate_orth_method("householder")
    with pytest.raises(ValueError):
        jl.validate_orth_method("householder")


@pytest.mark.parametrize("shape", [(3, 64, 5), (64, 5), (2, 96, 8)])
def test_ns_orth_matches_the_reference(rng, shape):
    """Newton-Schulz in the reference's order of operations, fp32 without
    TF32: within 1e-5 of the reference elementwise, and orthonormal to 1e-3
    (4 iterations on a well-conditioned Gaussian block)."""
    v = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jnp.vectorize(jl.ns_orth, signature="(d,k)->(d,k)")(jnp.asarray(v)))
    got = tl.ns_orth(T(v))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    k = shape[-1]
    resid = (torch.matmul(got.mT, got) - torch.eye(k)).abs().max()
    assert float(resid) <= 1e-3
    torch.testing.assert_close(tl.orthonormalize(T(v), "ns"), got, rtol=0, atol=0)
    np.testing.assert_allclose(
        tl.orthonormalize(T(v), "ns").numpy(), np.asarray(
            jnp.vectorize(lambda a: jl.orthonormalize(a, "ns"), signature="(d,k)->(d,k)")(
                jnp.asarray(v))), atol=1e-5)


def test_ns_orth_in_the_warm_regime_spans_like_cholqr2(rng):
    """A warm round's input (one power step from an orthonormal basis of a
    clean spectrum): ns and CholeskyQR2 give the same span, and ns's
    columns are orthonormal to 1e-4."""
    a = _spd(rng, 48)
    v = np.linalg.qr(rng.standard_normal((48, 4)))[0].astype(np.float32)
    w = T(a @ v)
    ns, chol = tl.ns_orth(w), tl._cholqr2(w)
    assert _max_angle(ns.numpy(), chol.numpy()) <= 0.01
    assert float((ns.T @ ns - torch.eye(4)).abs().max()) <= 1e-4


@pytest.mark.parametrize("orth", ["cholqr2", "qr"])
def test_subspace_iteration_matches_with_shared_v0(rng, orth):
    a = _spd(rng, 48)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (48, 4), jnp.float32))
    want = jl.subspace_iteration(
        lambda v: jnp.matmul(jnp.asarray(a), v, precision=jax.lax.Precision.HIGHEST),
        48, 4, iters=12, orth=orth,
    )
    got = tl.subspace_iteration(lambda v: torch.matmul(T(a), v), T(v0), iters=12, orth=orth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_rayleigh_ritz_matches(rng):
    a = _spd(rng, 30)
    v = np.linalg.qr(rng.standard_normal((30, 4)))[0].astype(np.float32)
    av = a @ v
    np.testing.assert_allclose(
        tl.rayleigh_ritz(T(v), T(av)).numpy(),
        np.asarray(jl.rayleigh_ritz(jnp.asarray(v), jnp.asarray(av))),
        atol=1e-5,
    )


@pytest.mark.parametrize("solver", ["eigh", "subspace"])
def test_merged_top_k_matches(rng, solver):
    a = _spd(rng, 40)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (40, 3), jnp.float32))
    want = jl.merged_top_k(jnp.asarray(a), 3, solver, iters=16)
    got = tl.merged_top_k(T(a), 3, solver, iters=16, v0=T(v0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if solver == "subspace":
        with pytest.raises(ValueError, match="v0"):
            tl.merged_top_k(T(a), 3, solver)


def _factors(rng, m, d, k):
    return np.stack(
        [np.linalg.qr(rng.standard_normal((d, k)))[0] for _ in range(m)]
    ).astype(np.float32)


@pytest.mark.parametrize(
    "m,d,k,route",
    [(4, 64, 3, "factor_gram"), (4, 12, 4, "dense")],
)
@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0, 1.0]])
def test_merged_top_k_lowrank_both_routes(rng, m, d, k, route, mask):
    assert (m * k >= d) == (route == "dense")
    vs = _factors(rng, m, d, k)
    # a shared direction keeps the merged spectrum's top-k separated
    common = np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32)
    vs = np.stack([np.linalg.qr(0.3 * v + common)[0] for v in vs]).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask, jnp.float32)
    tm = None if mask is None else torch.tensor(mask)
    want = np.asarray(jl.merged_top_k_lowrank(jnp.asarray(vs), k, jm))
    got = tl.merged_top_k_lowrank(T(vs), k, tm)
    assert got.shape == (d, k)
    # the merged spectrum's top-k sit close together, so the vectors may
    # rotate within the span: compare subspaces
    assert _max_angle(got.numpy(), want) <= 0.01


@pytest.mark.parametrize("m,d,k", [(4, 64, 3), (4, 12, 4)])
def test_merged_top_k_lowrank_all_masked_is_zero(rng, m, d, k):
    vs = _factors(rng, m, d, k)
    zero = torch.zeros(m)
    got = tl.merged_top_k_lowrank(T(vs), k, zero)
    want = np.asarray(jl.merged_top_k_lowrank(jnp.asarray(vs), k, jnp.zeros(m)))
    assert torch.count_nonzero(got) == 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_merged_lowrank_routes_agree_across_boundary(rng):
    """Both routes compute the same exact top-k of the mean projector."""
    vs = T(_factors(rng, 4, 16, 4))  # m*k == d: dense route
    dense = tl._merged_top_k_dense(vs, 2, torch.ones(4), torch.tensor(4.0))
    fgram = tl._merged_top_k_factor_gram(vs, 2, torch.ones(4), torch.tensor(4.0))
    assert _max_angle(dense, fgram) <= 0.01


def test_projector_and_gram_match(rng):
    v = np.linalg.qr(rng.standard_normal((24, 3)))[0].astype(np.float32)
    np.testing.assert_allclose(
        tl.projector(T(v)).numpy(), np.asarray(jl.projector(jnp.asarray(v))), atol=1e-6
    )
    x = rng.standard_normal((50, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tl.gram(T(x)).numpy(), np.asarray(jl.gram(jnp.asarray(x))), rtol=1e-5, atol=1e-6
    )
    # int8: the reference's exact int32 sums, bit for bit
    xi = rng.integers(-127, 128, size=(50, 24)).astype(np.int8)
    np.testing.assert_array_equal(
        tl.gram(torch.from_numpy(xi)).numpy(), np.asarray(jl.gram(jnp.asarray(xi)))
    )


def test_principal_angles_match(rng):
    u = np.linalg.qr(rng.standard_normal((30, 4)))[0].astype(np.float32)
    v = np.linalg.qr(rng.standard_normal((30, 4)))[0].astype(np.float32)
    np.testing.assert_allclose(
        tl.principal_angles(T(u), T(v)).numpy(),
        np.asarray(jl.principal_angles(jnp.asarray(u), jnp.asarray(v))),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        tl.principal_angles_degrees(T(u), T(v)).numpy(),
        np.asarray(jl.principal_angles_degrees(jnp.asarray(u), jnp.asarray(v))),
        atol=1e-3,
    )
    # identical spans read zero, not the fp32 arccos floor
    assert float(tl.principal_angles_degrees(T(u), T(u @ np.diag([1, -1, 1, -1]).astype(np.float32))).max()) < 1e-5
