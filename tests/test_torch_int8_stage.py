"""The port's int8 stage against the reference's (``tests/test_int8_stage.py``).

Inputs are made with numpy from a seed and handed to both packages; random
starts are the reference's own ``jax.random`` draw, handed to the port as
``v0``. Tolerances, each with its reason:

- the int8 Gram: exactly equal (int32 sums of integer products are exact
  on both sides, converted once and divided by the same n);
- the Gram past the overflow guard: both widen to fp32 and sum 133,200
  products in their own order: the port within 1e-6 relative Frobenius of
  the float64 truth, the reference's XLA CPU contraction within 1e-3 of
  the port (it loses ~1.3e-4 relative on these sums of ~7e8);
- the quantizers: exactly equal (same fp32 scale, round half to even);
- ``batched_xtxv`` on int8: 1e-6 relative (exact products of bf16-rounded
  operands, fp32 sums in another order);
- worker eigenspaces and whole fits: principal angles, 0.01 degrees to the
  reference on the same blocks and start, 0.5 degrees between int8 and
  float staging (the quantization noise), 1 degree to the planted truth.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import stream as jstream
from distributed_eigenspaces_tpu.data.synthetic import planted_spectrum as jax_planted
from distributed_eigenspaces_tpu.ops import linalg as jl
from distributed_eigenspaces_tpu.parallel import worker_pool as jwp
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data import stream as tstream
from distributed_eigenspaces_tpu_torch.ops import gram as tgram
from distributed_eigenspaces_tpu_torch.ops import linalg as tl
from distributed_eigenspaces_tpu_torch.parallel import worker_pool as twp

XTXV_TOL = 1e-6
REF_DEG = 0.01
STAGE_DEG = 0.5
TRUTH_DEG = 1.0


def _quantized_dataset(d=96, k=4, n_rows=4096, seed=3):
    """The reference test's data: planted spectrum, gap 20, noise 0.01,
    sampled by the reference with its own key."""
    spec = jax_planted(d, k_planted=k, gap=20.0, noise=0.01, seed=seed)
    x = np.asarray(spec.sample(jax.random.PRNGKey(seed), n_rows))
    return spec, x


def _v0(d, k):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))


def _deg(u, v) -> float:
    u = torch.as_tensor(np.array(u, dtype=np.float32))
    v = torch.as_tensor(np.array(v, dtype=np.float32))
    return float(tl.principal_angles_degrees(u, v).max())


# -- the int8 Gram -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(512, 64), (3, 200, 24), (2, 1000, 40), (1, 7, 3)])
def test_gram_int8_native_exact(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    xi = jstream.quantize_block_i8(x)
    got = tl.gram(torch.from_numpy(xi)).numpy()
    want = np.asarray(jax.vmap(jl.gram)(jnp.asarray(xi.reshape((-1,) + shape[-2:]))))
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    # the reference pins native against widened; so does the port (n <= 1000
    # rows of +-127^2 keep fp32 sums exact, under 2^24)
    np.testing.assert_array_equal(got, tgram.gram_plain(torch.from_numpy(xi).float()).numpy())
    np.testing.assert_array_equal(tgram.gram_auto(torch.from_numpy(xi)).numpy(), got)
    assert tgram.gram_s8_plain(torch.from_numpy(xi)).dtype == torch.float32


def test_gram_s8_plain_is_exact_past_fp32_sums(rng):
    """At n = 2048 (synthetic1024's rows) a sum of +-127^2 products can pass
    2^24, where fp32 sums stop being exact; the plain version sums in
    float64 and equals the int64 truth rounded once to fp32, divided by n."""
    xi = np.full((2048, 4), 127, np.int8)
    xi[::3, 1] = -127
    xi[:, 2:] = rng.integers(-127, 128, size=(2048, 2))
    exact = xi.astype(np.int64).T @ xi.astype(np.int64)
    assert np.abs(exact).max() > 2**24
    want = exact.astype(np.float32) / np.float32(2048)
    np.testing.assert_array_equal(tgram.gram_s8_plain(torch.from_numpy(xi)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jl.gram(jnp.asarray(xi))), want)
    unnormalized = tgram.gram_s8_plain(torch.from_numpy(xi), normalize=False).numpy()
    np.testing.assert_array_equal(unnormalized, exact.astype(np.float32))


def test_gram_overflow_guard_widens(rng, monkeypatch):
    """Past n * 127^2 < 2^31 the int32 sums could wrap: both packages widen
    to fp32 there (the port's plain route and, on the card, the fp32 kernel)."""
    n_unsafe = 2**31 // (127 * 127) + 1
    assert n_unsafe * 127 * 127 >= 2**31 and not tgram.s8_exact(n_unsafe)
    assert tgram.s8_exact(n_unsafe - 1) and (n_unsafe - 1) * 127 * 127 < 2**31
    x = rng.integers(-127, 128, size=(133_200, 2)).astype(np.int8)
    assert not tgram.s8_exact(x.shape[0])
    calls = []
    monkeypatch.setattr(tgram, "gram_s8_plain", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(tl, "gram_s8_plain", lambda *a, **k: calls.append(a))
    got = tl.gram(torch.from_numpy(x)).numpy()
    auto = tgram.gram_auto(torch.from_numpy(x)).numpy()
    assert calls == [] and got.dtype == np.float32
    np.testing.assert_array_equal(auto, got)
    assert tgram.widen_int(torch.from_numpy(x)).dtype == torch.float32
    want = np.asarray(jl.gram(jnp.asarray(x)))
    exact = (x.astype(np.float64).T @ x.astype(np.float64)) / x.shape[0]
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) <= 1e-6
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.uint8])
def test_gram_other_integers_widen_to_fp32(rng, dtype):
    x = torch.from_numpy(rng.integers(0, 100, size=(64, 8)).astype(np.int64)).to(dtype)
    assert tgram.widen_int(x).dtype == torch.float32
    want = np.asarray(jl.gram(jnp.asarray(x.numpy())))
    assert np.linalg.norm(tl.gram(x).numpy() - want) / np.linalg.norm(want) <= 1e-6


# -- the quantizers ----------------------------------------------------------


def test_quantize_device_twin_matches_host(rng):
    b = rng.standard_normal((4, 64, 32)).astype(np.float32) * 3.7
    host = tstream.quantize_block_i8(b)
    dev = tstream.quantize_block_i8_device(torch.from_numpy(b))
    assert dev.dtype == torch.int8
    np.testing.assert_array_equal(host, dev.numpy())
    np.testing.assert_array_equal(host, jstream.quantize_block_i8(b))
    np.testing.assert_array_equal(
        host, np.asarray(jstream.quantize_block_i8_device(jnp.asarray(b))))
    z = tstream.quantize_block_i8_device(torch.zeros((3, 3)))
    assert z.dtype == torch.int8 and not z.any()
    bad = torch.from_numpy(b[0].copy())
    bad[0, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        tstream.quantize_block_i8_device(bad)
    # stage_blocks: tensors quantize where they lie, numpy on the host
    out = list(tstream.stage_blocks([torch.from_numpy(b), b], "int8"))
    assert isinstance(out[0], torch.Tensor) and isinstance(out[1], np.ndarray)
    np.testing.assert_array_equal(out[0].numpy(), out[1])
    f = list(tstream.stage_blocks([b], "bfloat16"))[0]
    assert torch.equal(f, torch.from_numpy(b).to(torch.bfloat16))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 250.0])
def test_quantize_matches_the_reference_across_scales(rng, scale):
    b = (rng.standard_normal((2, 128, 48)) * scale).astype(np.float32)
    np.testing.assert_array_equal(tstream.quantize_block_i8(b), jstream.quantize_block_i8(b))
    np.testing.assert_array_equal(
        tstream.quantize_block_i8_device(torch.from_numpy(b)).numpy(),
        jstream.quantize_block_i8(b))


def test_quantize_block_i8_contract():
    b = np.array([[0.5, -2.0], [1.0, 4.0]], np.float32)
    q = tstream.quantize_block_i8(b)
    assert q.dtype == np.int8
    assert q.max() == 127 or q.min() == -127  # absmax maps to full scale
    np.testing.assert_array_equal(q, jstream.quantize_block_i8(b))
    z = tstream.quantize_block_i8(np.zeros((3, 3), np.float32))
    assert z.dtype == np.int8 and not z.any()
    for bad in (np.inf, -np.inf, np.nan):
        with pytest.raises(ValueError, match="non-finite"):
            tstream.quantize_block_i8(np.array([[1.0, bad]], np.float32))
        with pytest.raises(ValueError, match="non-finite"):
            tstream.quantize_block_i8_device(torch.tensor([[1.0, bad]]))
    # round half to even: 127 / 127 puts 0.5, 1.5, 2.5 exactly on halves
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]], np.float32)
    want = np.array([[127, 0, 2, 2, 0, -2, -2]], np.int8)
    np.testing.assert_array_equal(tstream.quantize_block_i8(ties), want)
    np.testing.assert_array_equal(tstream.quantize_block_i8_device(torch.from_numpy(ties)).numpy(), want)
    assert tstream.quantize_block_i8(np.zeros((0, 4), np.float32)).shape == (0, 4)


# -- the streaming matvecs and the worker solve --------------------------------


def test_batched_xtxv_int8_matches_bf16(rng):
    x = rng.standard_normal((2, 128, 32)).astype(np.float32)
    xi = tstream.quantize_block_i8(x)
    v = rng.standard_normal((2, 32, 3)).astype(np.float32)
    got = tl.batched_xtxv(torch.from_numpy(xi), torch.from_numpy(v))
    # int8 -> bf16 is exact, so the in-loop widen equals pre-widened bf16
    pre = tl.batched_xtxv(torch.from_numpy(xi).to(torch.bfloat16), torch.from_numpy(v))
    torch.testing.assert_close(got, pre, rtol=0, atol=0)
    want = np.asarray(jl.batched_xtxv(jnp.asarray(xi), jnp.asarray(v)))
    assert got.dtype == torch.float32
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) <= XTXV_TOL
    # v and X V round to bf16 (the reference's widen dtype), not to int8
    wrong = torch.matmul(torch.from_numpy(xi).float().mT, torch.matmul(
        torch.from_numpy(xi).float(), torch.from_numpy(v)))
    assert np.linalg.norm(wrong.numpy() - want) / np.linalg.norm(want) > 10 * XTXV_TOL


def test_batched_xtxv_other_integers_widen_to_fp32(rng):
    x = rng.integers(-50, 50, size=(2, 64, 16)).astype(np.int16)
    v = rng.standard_normal((2, 16, 3)).astype(np.float32)
    got = tl.batched_xtxv(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    want = np.asarray(jl.batched_xtxv(jnp.asarray(x), jnp.asarray(v)))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= XTXV_TOL


@pytest.mark.parametrize("iters,streaming", [(3, True), (12, False)])
def test_local_eigenspaces_int8_streaming_subspace(iters, streaming):
    """Warm-route iterations (3) stream the int8 block; 12 take the Gram
    route through the s8 Gram. Both against the reference on the same
    int8 blocks and the same explicit ``v0``, and against float staging."""
    spec, x = _quantized_dataset(d=96, k=4, n_rows=8 * 256)
    blocks = x.reshape(8, 256, 96)
    xi = jstream.quantize_block_i8(blocks)
    v0 = np.asarray(spec.top_k(4))
    assert streaming == (2 * 4 * iters < 96 and iters <= 6)
    want = np.asarray(jwp._local_eigenspaces(
        jnp.asarray(xi), 4, "subspace", iters, "cholqr2", jnp.bfloat16, jnp.asarray(v0)))
    got = twp._local_eigenspaces(
        torch.from_numpy(xi), 4, "subspace", iters, "cholqr2", "bfloat16", torch.from_numpy(v0))
    got_f = twp._local_eigenspaces(
        torch.from_numpy(blocks), 4, "subspace", iters, "cholqr2", "bfloat16",
        torch.from_numpy(v0))
    for w in range(8):
        assert _deg(got[w], want[w]) <= REF_DEG
        assert _deg(got[w], got_f[w]) <= STAGE_DEG


@pytest.mark.parametrize("compute_dtype,kept", [("bfloat16", True), ("float32", False),
                                                (None, False)])
def test_int8_streams_as_int8_only_under_bf16(monkeypatch, compute_dtype, kept):
    """The streaming route keeps int8 blocks int8 (widened inside the loop)
    under bf16 compute only; the Gram route keeps them under any."""
    seen = []
    real = tl.batched_xtxv
    monkeypatch.setattr(twp, "batched_xtxv", lambda x, v: seen.append(x.dtype) or real(x, v))
    xi = torch.from_numpy(np.random.default_rng(1).integers(-127, 128, (2, 64, 48)).astype(np.int8))
    v0 = torch.from_numpy(_v0(48, 2))
    twp._local_eigenspaces(xi, 2, "subspace", 2, "ns", compute_dtype, v0)
    want = torch.int8 if kept else torch.float32
    assert seen and set(seen) == {want}
    grams = []
    monkeypatch.setattr(twp, "gram_auto", lambda x: grams.append(x.dtype) or tgram.gram_auto(x))
    twp._local_eigenspaces(xi, 2, "subspace", 12, "cholqr2", compute_dtype, v0)
    assert grams == [torch.int8]


# -- configuration -----------------------------------------------------------


def test_config_validation():
    with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
        PCAConfig(dim=8, k=2, stage_dtype="int8")
    with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
        PCAConfig(dim=8, k=2, stage_dtype="int8", compute_dtype="float32")
    with pytest.raises(ValueError, match="must be int8"):
        PCAConfig(dim=8, k=2, stage_dtype="int16", compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="must be int8"):
        PCAConfig(dim=8, k=2, stage_dtype=torch.int32, compute_dtype="bfloat16")
    for kw in (dict(stage_dtype="int8"), dict(stage_dtype="int16", compute_dtype="bfloat16")):
        with pytest.raises(ValueError) as ours:
            PCAConfig(dim=8, k=2, **kw)
        with pytest.raises(ValueError) as theirs:
            JaxConfig(dim=8, k=2, **kw)
        assert str(ours.value) == str(theirs.value)
    cfg = PCAConfig(dim=8, k=2, stage_dtype="int8", compute_dtype="bfloat16")
    assert cfg.resolved_stage_dtype() == "int8"
    assert PCAConfig(dim=8, k=2, stage_dtype=np.int8, compute_dtype="bfloat16").stage_dtype == "int8"
    assert PCAConfig(dim=8, k=2, compute_dtype="bfloat16").resolved_stage_dtype() == "bfloat16"
    assert PCAConfig(dim=8, k=2).resolved_stage_dtype() == "float32"
    # ns is for warm rounds only
    assert PCAConfig(dim=8, k=2, warm_orth_method="ns").resolved_warm_orth() == "ns"
    with pytest.raises(ValueError, match="warm_orth_method-only"):
        PCAConfig(dim=8, k=2, orth_method="ns")
    with pytest.raises(ValueError, match="int8"):  # int8 is a stage dtype only
        PCAConfig(dim=8, k=2, dtype="int8")


# -- the estimator -----------------------------------------------------------


@pytest.mark.parametrize("trainer", ["scan", "step"])
def test_estimator_int8_stage_matches_float(trainer):
    spec, x = _quantized_dataset(d=64, k=3, n_rows=4 * 64 * 6)
    kw = dict(dim=64, k=3, num_workers=4, rows_per_worker=64, num_steps=6,
              solver="subspace", subspace_iters=10, compute_dtype="bfloat16",
              backend="local")
    v0 = _v0(64, 3)
    ref = dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu", trainer=trainer, v0=v0).fit(x)
    est = dett.OnlineDistributedPCA(PCAConfig(**kw, stage_dtype="int8"), device="cpu",
                                    trainer=trainer, v0=v0).fit(x)
    assert est.trainer_used_ == trainer
    assert _deg(est.components_, ref.components_) <= STAGE_DEG
    assert _deg(est.components_, spec.top_k(3)) <= TRUTH_DEG
    # and against the reference's int8-staged fit of the same trainer, on
    # the same data and v0
    jest = JaxPCA(JaxConfig(**kw, stage_dtype="int8"), trainer=trainer).fit(x)
    assert _deg(est.components_, np.asarray(jest.components_)) <= REF_DEG
    if trainer == "step":
        # the per-step route stages nothing (the reference's feeds cfg.dtype
        # blocks): the int8-staged fit is the float fit, bit for bit
        assert torch.equal(est.state.sigma_tilde, ref.state.sigma_tilde)
        assert torch.equal(est.components_, ref.components_)


def test_estimator_stages_int8_in_one_allocation(monkeypatch):
    """The whole fit quantizes each fp32 block with its own scale straight
    into its slot of the int8 ``(T, m, n, d)`` schedule: the slots equal the
    stream's blocks quantized one by one."""
    _, x = _quantized_dataset(d=32, k=2, n_rows=2 * 16 * 3)
    x = x.copy()
    x[:32] *= 10.0  # step 1 has another scale than steps 2 and 3
    cfg = PCAConfig(dim=32, k=2, num_workers=2, rows_per_worker=16, num_steps=3,
                    solver="subspace", subspace_iters=8, compute_dtype="bfloat16",
                    stage_dtype="int8", backend="local")
    seen = {}
    real = dett.api.estimator.make_scan_fit

    def spy(cfg_, **kw):
        fit = real(cfg_, **kw)

        def wrapped(state, staged):
            seen["staged"] = staged
            return fit(state, staged)
        return wrapped

    monkeypatch.setattr(dett.api.estimator, "make_scan_fit", spy)
    dett.OnlineDistributedPCA(cfg, device="cpu").fit(x)
    staged = seen["staged"]
    assert staged.dtype == torch.int8 and staged.shape == (3, 2, 16, 32)
    for t in range(3):
        np.testing.assert_array_equal(
            staged[t].numpy(), jstream.quantize_block_i8(x[t * 32:(t + 1) * 32].reshape(2, 16, 32)))


def test_fit_stream_stages_int8_like_the_whole_fit():
    """``fit_stream`` under an int8 stage: as in the reference, only the
    whole fit stages, so the per-step loop fits the float blocks as they
    are: bit for bit the fit without the stage, within the stage's noise of
    the int8-staged whole fit, and within 0.01 degrees of the reference's
    ``fit_stream`` on the same blocks and start."""
    spec, x = _quantized_dataset(d=48, k=3, n_rows=4 * 32 * 4)
    kw = dict(dim=48, k=3, num_workers=4, rows_per_worker=32, num_steps=4,
              solver="subspace", subspace_iters=10, compute_dtype="bfloat16",
              stage_dtype="int8", warm_orth_method="ns", backend="local")
    cfg = PCAConfig(**kw)
    v0 = _v0(48, 3)
    whole = dett.OnlineDistributedPCA(cfg, device="cpu", v0=v0).fit(x)
    blocks = [x[t * 128:(t + 1) * 128].reshape(4, 32, 48) for t in range(4)]
    streamed = dett.OnlineDistributedPCA(cfg, device="cpu", v0=v0).fit_stream(blocks)
    tensors = dett.OnlineDistributedPCA(cfg, device="cpu", v0=v0).fit_stream(
        [torch.from_numpy(b.copy()) for b in blocks])
    float_stream = dett.OnlineDistributedPCA(
        dataclasses.replace(cfg, stage_dtype=None), device="cpu", v0=v0).fit_stream(blocks)
    assert torch.equal(streamed.state.sigma_tilde, float_stream.state.sigma_tilde)
    assert torch.equal(tensors.state.sigma_tilde, streamed.state.sigma_tilde)
    assert torch.equal(tensors.components_, streamed.components_)
    # the whole fit staged int8: another state, within the stage's noise
    assert not torch.equal(whole.state.sigma_tilde, streamed.state.sigma_tilde)
    assert _deg(streamed.components_, whole.components_) <= STAGE_DEG
    jest = JaxPCA(JaxConfig(**kw))
    jest.fit_stream([jnp.asarray(b) for b in blocks])
    assert _deg(streamed.components_, np.asarray(jest.components_)) <= REF_DEG


def test_eval_settings_slice_matches_the_reference():
    """The cifar10 eval's settings (int8 stage, ns warm rounds, bf16, the
    subspace solver at 12 cold / 2 warm) at d=64, k=4, m=4, n=128, T=4 on
    planted-subspace data: the port's fit against the JAX estimator's on
    the same data and start."""
    from distributed_eigenspaces_tpu.data.synthetic import planted_subspace as jax_subspace

    d, k, m, n, steps = 64, 4, 4, 128, 4
    spec = jax_subspace(d, k_planted=k, gap=20.0, decay=0.8, noise=0.01, seed=0)
    x = np.asarray(spec.sample(jax.random.PRNGKey(1), steps * m * n))
    kw = dict(dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=steps,
              solver="subspace", subspace_iters=12, warm_start_iters=2,
              compute_dtype="bfloat16", stage_dtype="int8", warm_orth_method="ns",
              backend="local")
    want = np.asarray(JaxPCA(JaxConfig(**kw)).fit(x).components_)
    est = dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu", v0=_v0(d, k)).fit(x)
    assert est.trainer_used_ == "scan"
    assert _deg(est.components_, want) <= REF_DEG
    assert _deg(est.components_, np.asarray(spec.top_k(k))) <= TRUTH_DEG


def test_synthetic1024_settings_slice_matches_the_reference():
    """The synthetic1024 eval's settings (``evals.py:91-95``: k=5, m=8,
    n=2048 rows a worker, int8 stage, ns warm rounds, bf16, subspace 12
    cold / 2 warm) on its planted-subspace data, decay by the eval's own
    formula, cut to d=64 and T=3: the port's fit against the JAX
    estimator's on the same data and start (0.01 degrees), and within 1
    degree of the planted top-5. n=2048 is where fp32 sums of int8 products
    stop being exact: the int8 Gram sums in int32 on both sides."""
    from distributed_eigenspaces_tpu.data.synthetic import planted_subspace as jax_subspace

    d, k, m, n, steps = 64, 5, 8, 2048, 3
    gap, noise = 20.0, 0.01
    decay = max(0.8, float((100.0 * noise / gap) ** (1.0 / max(k - 1, 1))))
    assert decay == 0.8
    spec = jax_subspace(d, k_planted=k, gap=gap, decay=decay, noise=noise, seed=0)
    x = np.asarray(spec.sample(jax.random.PRNGKey(1), steps * m * n))
    kw = dict(dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=steps,
              solver="subspace", subspace_iters=12, warm_start_iters=2,
              compute_dtype="bfloat16", stage_dtype="int8", warm_orth_method="ns",
              backend="local")
    # a sum can pass 2^24, where fp32 stops being exact, and stays in int32
    assert n * 127 * 127 > 2**24 and tgram.s8_exact(n)
    want = np.asarray(JaxPCA(JaxConfig(**kw)).fit(x).components_)
    est = dett.OnlineDistributedPCA(PCAConfig(**kw), device="cpu", v0=_v0(d, k)).fit(x)
    assert est.trainer_used_ == "scan"
    assert _deg(est.components_, want) <= REF_DEG
    assert _deg(est.components_, np.asarray(spec.top_k(k))) <= TRUTH_DEG


def test_ns_runs_on_warm_rounds_only(monkeypatch):
    """``resolved_warm_orth()`` reaches warm rounds only, through the scan
    and the per-step loop; cold rounds keep ``orth_method``."""
    _, x = _quantized_dataset(d=48, k=3, n_rows=4 * 32 * 4)
    cfg = PCAConfig(dim=48, k=3, num_workers=4, rows_per_worker=32, num_steps=4,
                    solver="subspace", subspace_iters=10, compute_dtype="bfloat16",
                    stage_dtype="int8", warm_orth_method="ns", backend="local")
    for trainer in ("scan", "step"):
        calls = []
        real = tl.orthonormalize
        monkeypatch.setattr(twp, "orthonormalize", lambda v, method="qr": calls.append(method)
                            or real(v, method))
        monkeypatch.setattr(tl, "orthonormalize", lambda v, method="qr": calls.append(method)
                            or real(v, method))
        dett.OnlineDistributedPCA(cfg, device="cpu", trainer=trainer).fit(x)
        monkeypatch.undo()
        # cold: the start + 10 iterations on the Gram route; warm: the start
        # + 2 per step, streamed, 3 warm steps; the scan's extract runs the
        # subspace solver at 16 iterations with orth_method
        assert calls.count("ns") == 3 * 3, (trainer, calls)
        extract = 1 + 16 if trainer == "scan" else 0
        assert calls.count("cholqr2") == 1 + 10 + extract, (trainer, calls)
        assert len(calls) == 9 + 11 + extract
    assert dataclasses.replace(cfg, warm_orth_method=None).resolved_warm_orth() == "cholqr2"
