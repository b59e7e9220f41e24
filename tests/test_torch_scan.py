"""The port's whole-fit trainers against the reference's.

The masked scan, the merge-interval and pipelined scans (dense and
gather), the fold-only step, the per-step loop's interval schedule and the
segmented trainer, each fed the same numpy inputs as its JAX counterpart.
The cold start is the reference's own ``jax.random.normal(PRNGKey(0), (d,
k))``, handed to the port as ``v0``. Tolerances: ``sigma_tilde`` within
1e-4 absolute, every ``v_bar`` within 0.05 degrees (the port's float64
angles). Kill/resume of the segmented trainer is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.algo import online as jon
from distributed_eigenspaces_tpu.algo import scan as jscan
from distributed_eigenspaces_tpu.algo.step import make_train_step as jax_train_step
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.parallel.worker_pool import WorkerPool as JaxPool
from distributed_eigenspaces_tpu_torch.algo import online as ton
from distributed_eigenspaces_tpu_torch.algo import scan as tscan
from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel.worker_pool import WorkerPool

SIGMA_ATOL = 1e-4
ANGLE_DEG = 0.05
D, K, M, N, T = 32, 3, 4, 64, 6
BASE = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
            solver="subspace", subspace_iters=12, warm_start_iters=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small CPU tensors: intra-op threads only contend with the other test
    # workers for the cores (a loaded run spent ten times its time alone)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _v0(d=D, k=K):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))


def _data(steps=T, seed=0):
    spec = jsyn.planted_spectrum(D, k_planted=K, seed=seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.standard_normal((steps, M, N, D)).astype(np.float32)
    x = (z * np.sqrt(np.asarray(spec.eigenvalues))) @ np.asarray(spec.basis).T
    return x.astype(np.float32)


def _cfgs(**kw):
    kw = {**BASE, **kw}
    return PCAConfig(**kw), JaxConfig(**kw, backend="local")


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _assert_state(st, jst):
    assert int(st.step) == int(jst.step)
    np.testing.assert_allclose(st.sigma_tilde.numpy(), np.asarray(jst.sigma_tilde),
                               atol=SIGMA_ATOL, rtol=0)


def _assert_bases(vb, jvb):
    jvb = np.asarray(jvb)
    assert tuple(vb.shape) == jvb.shape
    for t in range(jvb.shape[0]):
        if not np.any(jvb[t]):  # an all-masked round merges to zeros
            assert not torch.any(vb[t])
        else:
            assert _angle(vb[t], jvb[t]) <= ANGLE_DEG, t


def _state0(d=D):
    return ton.OnlineState.initial(d, device="cpu")


# -- masked scan -------------------------------------------------------------

MASK_CASES = {
    "all_ones": (np.ones((T, M), np.float32), None),
    "first_round_all_masked": (np.array([[0] * M] + [[1] * M] * (T - 1), np.float32), None),
    "mixed": (np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 0, 0],
                        [0, 0, 0, 0], [1, 1, 1, 0]], np.float32), None),
    "zero_block_on_live_round": (np.ones((T, M), np.float32), 2),
}


#: the reference's masked scan programs by config, built once a module: the
#: blocks and masks are arguments of the compiled program, so the mask cases
#: of one config share one compile
_JAX_MASKED: dict = {}


def _jax_masked_fit(jcfg):
    key = repr(jcfg)
    if key not in _JAX_MASKED:
        _JAX_MASKED[key] = jscan.make_scan_fit(jcfg, masked=True)
    return _JAX_MASKED[key]


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_masked_scan_matches(case, s):
    masks, zero_step = MASK_CASES[case]
    x = _data()
    if zero_step is not None:
        x[zero_step] = 0.0
    cfg, jcfg = _cfgs(merge_interval=s)
    jst, jvb = _jax_masked_fit(jcfg)(
        jon.OnlineState.initial(D), jnp.asarray(x), jnp.asarray(masks))
    st, vb = tscan.make_scan_fit(cfg, device="cpu", v0=_v0(), masked=True)(
        _state0(), torch.from_numpy(x), masks)
    _assert_state(st, jst)
    _assert_bases(vb, jvb)


def test_masked_scan_membership_masks_multiply():
    x, masks = _data(), MASK_CASES["mixed"][0]
    member = np.ones((T, M), np.float32)
    member[3:, 0] = 0.0
    fit = tscan.make_scan_fit(PCAConfig(**BASE), device="cpu", v0=_v0(), masked=True)
    st, vb = fit(_state0(), torch.from_numpy(x), masks, membership_masks=member)
    st2, vb2 = fit(_state0(), torch.from_numpy(x), masks * member)
    assert torch.equal(st.sigma_tilde, st2.sigma_tilde) and torch.equal(vb, vb2)


def test_masked_scan_without_warm_starts_matches():
    x, masks = _data(), MASK_CASES["mixed"][0]
    cfg, jcfg = _cfgs(warm_start_iters=None)
    jst, jvb = jscan.make_scan_fit(jcfg, masked=True)(
        jon.OnlineState.initial(D), jnp.asarray(x), jnp.asarray(masks))
    st, vb = tscan.make_scan_fit(cfg, device="cpu", v0=_v0(), masked=True)(
        _state0(), torch.from_numpy(x), masks)
    _assert_state(st, jst)
    _assert_bases(vb, jvb)


def test_masked_scan_rejects_gather_and_bad_masks():
    cfg = PCAConfig(**BASE)
    with pytest.raises(ValueError, match="masked"):
        tscan.make_scan_fit(cfg, device="cpu", gather=True, masked=True)
    fit = tscan.make_scan_fit(cfg, device="cpu", masked=True)
    with pytest.raises(ValueError, match="masks shape"):
        fit(_state0(), torch.from_numpy(_data()), np.ones((T - 1, M), np.float32))


# -- merge interval and pipeline --------------------------------------------

STEADY = [
    ("interval2", dict(merge_interval=2), T),
    ("interval3", dict(merge_interval=3), T),
    ("interval2_cold", dict(merge_interval=2, warm_start_iters=None), T),
    ("pipelined_T1", dict(pipeline_merge=True), 1),
    ("pipelined_T2", dict(pipeline_merge=True), 2),
    ("pipelined_T6", dict(pipeline_merge=True), 6),
    ("pipelined_interval2_T2", dict(pipeline_merge=True, merge_interval=2), 2),
    ("pipelined_interval2_T6", dict(pipeline_merge=True, merge_interval=2), 6),
]


@pytest.mark.parametrize("gather", [False, True], ids=["dense", "gather"])
@pytest.mark.parametrize("name,kw,steps", STEADY, ids=[c[0] for c in STEADY])
def test_steady_state_scan_matches(name, kw, steps, gather):
    x = _data(steps)
    cfg, jcfg = _cfgs(num_steps=steps, **kw)
    fit = tscan.make_scan_fit(cfg, device="cpu", v0=_v0(), gather=gather)
    if gather:  # two distinct blocks cycled over the schedule
        idx = np.arange(steps, dtype=np.int32) % 2
        jst, jvb = jscan.make_scan_fit(jcfg, gather=True)(
            jon.OnlineState.initial(D), jnp.asarray(x[:2]), jnp.asarray(idx))
        st, vb = fit(_state0(), torch.from_numpy(x[:2]), torch.from_numpy(idx))
    else:
        jst, jvb = jscan.make_scan_fit(jcfg)(jon.OnlineState.initial(D), jnp.asarray(x))
        st, vb = fit(_state0(), torch.from_numpy(x))
    _assert_state(st, jst)
    _assert_bases(vb, jvb)


@pytest.mark.parametrize("s", [2, 3])
def test_interval_merges_every_s_steps(s, monkeypatch):
    """The merged eigensolve runs on ceil(T/s) rounds, the first and every
    s-th after; the fold rounds carry the last merged basis."""
    from distributed_eigenspaces_tpu_torch.algo import step as tstep

    calls = []
    real = tstep.merge_core

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tscan, "merge_core", counted)
    cfg = PCAConfig(**{**BASE, "merge_interval": s})
    _, vb = tscan.make_scan_fit(cfg, device="cpu", v0=_v0())(_state0(),
                                                              torch.from_numpy(_data()))
    assert len(calls) == -(-T // s)
    for t in range(T):
        if t % s:
            assert torch.equal(vb[t], vb[t - 1])


def test_fold_only_step_matches():
    """``make_train_step(merge=False)``: the same solves, the mean projector
    folded, the carry returned unchanged; cold and warm."""
    x = _data(4)
    cfg, jcfg = _cfgs(merge_interval=2)
    jstep = jax_train_step(jcfg, mesh=None, donate=False)
    step = make_train_step(cfg, device="cpu", v0=_v0())
    js, jv = jstep(jon.OnlineState.initial(D), jnp.asarray(x[0]))
    ts, tv = step(_state0(), torch.from_numpy(x[0]))
    js, jv2 = jstep(js, jnp.asarray(x[1]), jv, merge=False)
    ts, tv2 = step(ts, torch.from_numpy(x[1]), tv, merge=False)
    assert tv2 is tv
    _assert_state(ts, js)
    js, _ = jstep(js, jnp.asarray(x[2]), None, merge=False)  # cold fold
    ts, none = step(ts, torch.from_numpy(x[2]), None, merge=False)
    assert none is None
    _assert_state(ts, js)
    with pytest.raises(ValueError, match="merge_interval"):
        make_train_step(PCAConfig(**BASE), device="cpu")(
            _state0(), torch.from_numpy(x[0]), merge=False)


@pytest.mark.parametrize("masked", [False, True])
def test_pool_round_without_merge_returns_the_mean_projector(masked):
    x = _data(1)[0]
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    pool = WorkerPool(M, solver="subspace", subspace_iters=12, device="cpu")
    sigma, v = pool.round(x, K, worker_mask=mask, v0=torch.from_numpy(_v0()))
    sigma2, none = pool.round(x, K, worker_mask=mask, v0=torch.from_numpy(_v0()),
                              merge=False)
    assert none is None and v.shape == (D, K)
    assert torch.equal(sigma, sigma2)
    jpool = JaxPool(M, backend="local", solver="subspace", subspace_iters=12)
    jsigma, jnone = jpool.round(jnp.asarray(x), K, worker_mask=mask, merge=False)
    assert jnone is None
    np.testing.assert_allclose(sigma2.numpy(), np.asarray(jsigma), atol=SIGMA_ATOL, rtol=0)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_per_step_loop_interval_schedule_matches(s, masked):
    x = _data()
    masks = MASK_CASES["mixed"][0] if masked else None
    cfg = PCAConfig(**{**BASE, "merge_interval": s})
    jcfg = JaxConfig(**{**BASE, "merge_interval": s}, backend="local", prefetch_depth=0)
    seen, jseen = [], []
    _, jst = jon.online_distributed_pca(
        iter(jnp.asarray(x)), jcfg, worker_masks=None if masks is None else iter(masks),
        on_step=lambda t, st, v: jseen.append(np.asarray(v)))
    _, st = ton.online_distributed_pca(
        iter(torch.from_numpy(x)), cfg, device="cpu", v0=_v0(),
        worker_masks=None if masks is None else iter(masks),
        on_step=lambda t, st, v: seen.append(v))
    _assert_state(st, jst)
    _assert_bases(torch.stack(seen), np.stack(jseen))


def test_steady_state_knobs_validate_like_the_reference():
    for kw in (dict(pipeline_merge=True), dict(pipeline_merge=True, solver="subspace",
                                               warm_start_iters=None)):
        with pytest.raises(ValueError, match="pipeline_merge"):
            JaxConfig(dim=D, k=K, **kw)
        with pytest.raises(ValueError, match="pipeline_merge"):
            PCAConfig(dim=D, k=K, **kw)
    for kw in (dict(merge_interval=4), dict(pipeline_merge=True, solver="subspace"),
               dict(pipeline_merge=True, solver="distributed", merge_interval=2)):
        j, t = JaxConfig(dim=D, k=K, **kw), PCAConfig(dim=D, k=K, **kw)
        assert (t.merge_interval, t.pipeline_merge) == (j.merge_interval, j.pipeline_merge)


# -- segmented ---------------------------------------------------------------

SEGMENTED = [("s1", dict()), ("s2", dict(merge_interval=2)),
             ("cold", dict(warm_start_iters=None))]


@pytest.mark.parametrize("segment", [1, 4, 6])
@pytest.mark.parametrize("name,kw", SEGMENTED, ids=[c[0] for c in SEGMENTED])
def test_segmented_matches_the_scan_and_the_reference(name, kw, segment):
    x = _data()
    cfg, jcfg = _cfgs(**kw)
    scan_st, _ = tscan.make_scan_fit(cfg, device="cpu", v0=_v0())(
        _state0(), torch.from_numpy(x))
    seen = []
    fit = tscan.make_segmented_fit(cfg, segment=segment, device="cpu", v0=_v0())
    st = fit(tscan.SegmentState.initial(D, K, device="cpu"), torch.from_numpy(x),
             on_segment=lambda t, s: seen.append(t))
    assert seen == sorted({*range(segment, T, segment), T})
    assert st.step == T and torch.equal(st.sigma_tilde, scan_st.sigma_tilde)
    jst = jscan.make_segmented_fit(jcfg, segment=segment)(
        jscan.SegmentState.initial(D, K), jnp.asarray(x))
    _assert_state(st, jst)
    if np.any(np.asarray(jst.v_prev)):
        assert _angle(st.v_prev, jst.v_prev) <= ANGLE_DEG


def _windows(x, sizes):
    out, t = [], 0
    for s in sizes:
        out.append(torch.from_numpy(x[t:t + s]))
        t += s
    return out


@pytest.mark.parametrize("kill_after", [1, 2])
@pytest.mark.parametrize("variant", ["unmasked", "masked", "interval2"])
def test_segmented_kill_resume_is_bit_equal(variant, kill_after, tmp_path):
    """A run stopped after ``kill_after`` windows, checkpointed, restored
    and continued equals the unkilled run bit for bit: ``sigma_tilde``,
    ``v_prev`` and the step."""
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import (
        Checkpointer,
        restore_checkpoint,
    )

    x = _data()
    sizes = [2, 2, 2]
    kw = {"merge_interval": 2} if variant == "interval2" else {}
    masks = MASK_CASES["mixed"][0] if variant == "masked" else None
    cfg = PCAConfig(**{**BASE, **kw})

    def mask_windows(start):
        if masks is None:
            return None
        return [masks[t:t + 2] for t in range(start, T, 2)]

    fit = tscan.make_segmented_fit(cfg, segment=2, device="cpu", v0=_v0())
    whole = fit.fit_windows(tscan.SegmentState.initial(D, K, device="cpu"),
                            _windows(x, sizes), worker_masks=mask_windows(0))
    ckpt = Checkpointer(str(tmp_path), rows_per_step=M * N, device="cpu")
    fit.fit_windows(tscan.SegmentState.initial(D, K, device="cpu"),
                    _windows(x, sizes[:kill_after]), on_segment=ckpt.on_step,
                    worker_masks=None if masks is None else mask_windows(0)[:kill_after])
    state, cursor = ckpt.latest()
    assert cursor == 2 * kill_after * M * N and state.step == 2 * kill_after
    again, _ = restore_checkpoint(str(tmp_path / f"step_{2 * kill_after:08d}"),
                                  device="cpu")
    assert torch.equal(again.sigma_tilde, state.sigma_tilde)
    fresh = tscan.make_segmented_fit(cfg, segment=2, device="cpu", v0=_v0())
    start = cursor // (M * N)
    resumed = fresh.fit_windows(state, _windows(x[start:], sizes[kill_after:]),
                                worker_masks=mask_windows(start))
    assert resumed.step == whole.step == T
    assert torch.equal(resumed.sigma_tilde, whole.sigma_tilde)
    assert torch.equal(resumed.v_prev, whole.v_prev)


def test_segmented_zero_carry_resume_runs_cold():
    """A state with steps folded but no warm carry (a per-step checkpoint)
    starts its first window cold, as the reference's."""
    x = _data()
    cfg, jcfg = _cfgs()
    st0 = ton.OnlineState.initial(D, device="cpu")
    st0, _ = tscan.make_scan_fit(cfg, device="cpu", v0=_v0())(st0, torch.from_numpy(x[:2]))
    jst0, _ = jscan.make_scan_fit(jcfg)(jon.OnlineState.initial(D), jnp.asarray(x[:2]))
    seg = tscan.SegmentState(st0.sigma_tilde, st0.step, torch.zeros((D, K)))
    jseg = jscan.SegmentState(jst0.sigma_tilde, jst0.step, jnp.zeros((D, K)))
    st = tscan.make_segmented_fit(cfg, segment=2, device="cpu", v0=_v0())(
        seg, torch.from_numpy(x[2:]))
    jst = jscan.make_segmented_fit(jcfg, segment=2)(jseg, jnp.asarray(x[2:]))
    _assert_state(st, jst)
    assert _angle(st.v_prev, jst.v_prev) <= ANGLE_DEG


@pytest.mark.parametrize("s", [1, 2])
def test_segmented_masked_windows_match_the_reference(s):
    x, masks = _data(), MASK_CASES["first_round_all_masked"][0]
    cfg, jcfg = _cfgs(merge_interval=s)
    fit = tscan.make_segmented_fit(cfg, segment=4, device="cpu", v0=_v0())
    st = fit.fit_windows(tscan.SegmentState.initial(D, K, device="cpu"),
                         _windows(x, [4, 2]), worker_masks=[masks[:4], masks[4:]])
    jfit = jscan.make_segmented_fit(jcfg, segment=4)
    jst = jfit.fit_windows(jscan.SegmentState.initial(D, K),
                           [jnp.asarray(x[:4]), jnp.asarray(x[4:])],
                           worker_masks=[masks[:4], masks[4:]])
    _assert_state(st, jst)
    assert _angle(st.v_prev, jst.v_prev) <= ANGLE_DEG
    # the same masks through the masked scan: the same bits
    scan_st, _ = tscan.make_scan_fit(cfg, device="cpu", v0=_v0(), masked=True)(
        _state0(), torch.from_numpy(x), masks)
    assert torch.equal(st.sigma_tilde, scan_st.sigma_tilde)


def test_segmented_windows_and_masks_zip_strictly():
    x = _data()
    fit = tscan.make_segmented_fit(PCAConfig(**BASE), segment=3, device="cpu", v0=_v0())
    with pytest.raises(ValueError):
        fit.fit_windows(tscan.SegmentState.initial(D, K, device="cpu"),
                        _windows(x, [3, 3]), worker_masks=[np.ones((3, M))])


def test_pipeline_merge_rejected_by_the_segmented_trainer():
    cfg, jcfg = _cfgs(pipeline_merge=True)
    with pytest.raises(ValueError, match="pipeline_merge"):
        jscan.make_segmented_fit(jcfg)
    with pytest.raises(ValueError, match="pipeline_merge"):
        tscan.make_segmented_fit(cfg, device="cpu")
    with pytest.raises(ValueError, match="segment"):
        tscan.make_segmented_fit(PCAConfig(**BASE), segment=0, device="cpu")


def test_masked_step_body_is_the_masked_scan():
    """The public masked body, looped, is the masked scan bit for bit."""
    x, masks = _data(), MASK_CASES["mixed"][0]
    cfg = PCAConfig(**BASE)
    body = tscan.make_masked_step_body(cfg, device="cpu", v0=_v0())
    carry = (_state0(), torch.zeros((D, K)))
    outs = []
    for xt, row in zip(torch.from_numpy(x), masks):
        carry, v = body(carry, xt, row)
        outs.append(v)
    st, vb = tscan.make_scan_fit(cfg, device="cpu", v0=_v0(), masked=True)(
        _state0(), torch.from_numpy(x), masks)
    assert torch.equal(carry[0].sigma_tilde, st.sigma_tilde)
    assert torch.equal(torch.stack(outs), vb)


def test_whole_fit_handle_kinds():
    from distributed_eigenspaces_tpu_torch.api.runner import make_whole_fit

    x, masks = _data(), MASK_CASES["mixed"][0]
    cfg = PCAConfig(**BASE)
    scan = make_whole_fit(cfg, "scan", device="cpu", v0=_v0())
    seg = make_whole_fit(cfg, "segmented", segment=4, device="cpu", v0=_v0())
    a = scan.fit(scan.init_state(), torch.from_numpy(x))
    b = seg.fit(seg.init_state(), torch.from_numpy(x))
    assert torch.equal(a.sigma_tilde, b.sigma_tilde)
    assert torch.equal(scan.extract(a), seg.extract(b))
    assert seg.info == {"segment": 4}
    masked = make_whole_fit(cfg, "scan", masked=True, device="cpu", v0=_v0())
    c = masked.fit(masked.init_state(), torch.from_numpy(x), worker_masks=masks)
    assert c.step == T
    with pytest.raises(ValueError, match="worker_masks"):
        scan.fit(scan.init_state(), torch.from_numpy(x), worker_masks=masks)
    with pytest.raises(ValueError, match="fit_windows"):
        seg.fit(seg.init_state(), torch.from_numpy(x), worker_masks=masks)
    # the feature-sharded kinds build on the one-process (1, 1) layout
    # (their parity: tests/test_torch_feature_sharded.py)
    for kind, info in (("fs_scan", "rank"), ("sketch", "sketch_width")):
        h = make_whole_fit(cfg, kind, device="cpu")
        assert h.kind == kind and info in h.info and h.fit_windows is not None
    with pytest.raises(ValueError, match="unknown"):
        make_whole_fit(cfg, "fleet", device="cpu")


def test_windows_iterate_lazily():
    """``fit_windows`` pulls one window at a time (an out-of-core source is
    never drained ahead of the fit)."""
    x = _data()
    pulled = []

    def source():
        for t in range(0, T, 2):
            pulled.append(t)
            yield torch.from_numpy(x[t:t + 2])

    seen = []
    fit = tscan.make_segmented_fit(PCAConfig(**BASE), segment=2, device="cpu", v0=_v0())
    fit.fit_windows(tscan.SegmentState.initial(D, K, device="cpu"), source(),
                    on_segment=lambda t, s: seen.append((t, list(pulled))))
    assert seen == [(2, [0]), (4, [0, 2]), (6, [0, 2, 4])]
