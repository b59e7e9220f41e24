"""The port's ``DriftMonitor`` (serving/drift.py) and ``QueryServer(drift=)``
against the reference's, on the CPU.

Inputs are made with numpy from a seed; both monitors see the same
observations and rows, and both refits fit the same rows. Tolerances:

- the residual drift after each observation: 1e-12 (the same float64 host
  arithmetic on the same inputs);
- the refit and the angle it confirms with: the configuration's eigh
  solver has no random start, so the two packages' bases differ only by
  fp32 rounding: 0.05 degrees between them, and the drift scores within
  0.05 / 90 of each other;
- the refreshed basis of the end-to-end loop: closer to the shifted truth
  than the stale version, and within 1 degree of it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.serving import EigenbasisRegistry as JaxRegistry
from distributed_eigenspaces_tpu.serving.drift import DriftMonitor as JaxDrift
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.serving import (
    DriftMonitor,
    EigenbasisRegistry,
    PublisherLease,
    QueryServer,
)

D, K, M, N, T = 32, 3, 2, 32, 4
TIMEOUT = 60
FIT_DEG = 0.05


def _kw(**kw):
    return dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
                serve_bucket_size=4, serve_flush_s=0.02, **kw)


def _angle(a, b) -> float:
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _basis(seed=0):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((D, K)))[0].astype(np.float32)


def _rows(spec, n, seed):
    return np.asarray(spec.sample(np.random.default_rng(seed), n), np.float32)


def _both(refit=None, **kw):
    """A port monitor and a reference monitor on registries holding the
    same basis (with the same explained-variance summary)."""
    regs = (EigenbasisRegistry(), JaxRegistry())
    for reg in regs:
        reg.publish(_basis(), explained_variance={"top_k_energy": 0.9})
    ours = DriftMonitor(regs[0], PCAConfig(**_kw()), refit=refit, device="cpu", **kw)
    theirs = JaxDrift(regs[1], JaxConfig(**_kw()), refit=refit, **kw)
    return regs, ours, theirs


# -- the always-on signal -----------------------------------------------------


def test_arming_threshold_and_cooldown_match_the_reference():
    """The same observations arm the same refreshes: the tripwire, the
    minimum buffer, and the cooldown between auto refreshes."""
    calls = {"ours": 0, "theirs": 0}

    def refit_for(side):
        def refit(rows):
            calls[side] += 1
            return _basis(), None  # the live basis: the score stays low
        return refit

    regs = (EigenbasisRegistry(), JaxRegistry())
    for reg in regs:
        reg.publish(_basis(), explained_variance={"top_k_energy": 0.9})
    # arms at 0.15, never publishes (the score is drift + angle / 90)
    kw = dict(threshold=10.0, arm_ratio=0.15, auto=True, cooldown_batches=3)
    ours = DriftMonitor(regs[0], PCAConfig(**_kw()), refit=refit_for("ours"), **kw)
    theirs = JaxDrift(regs[1], JaxConfig(**_kw()), refit=refit_for("theirs"), **kw)
    rng = np.random.default_rng(0)
    # in-distribution, then drifting: ratios from 0.1 up to 0.6
    ratios = [0.1] * 3 + list(np.linspace(0.1, 0.6, 12)) + [0.6] * 8
    for i, ratio in enumerate(ratios):
        rows = rng.standard_normal((16, D)).astype(np.float32)
        got = [mon.observe(ratio * 10.0, 10.0, rows=rows) for mon in (ours, theirs)]
        for mon in (ours, theirs):
            mon.join_refresh(TIMEOUT)
        assert abs(got[0] - got[1]) <= 1e-12, i
        assert abs(ours.residual_drift() - theirs.residual_drift()) <= 1e-12
        assert calls["ours"] == calls["theirs"], i
        assert ours.refreshes == theirs.refreshes
    # the buffer gate held the first refresh until M*N rows were in, the
    # cooldown spaced the rest; nothing cleared the publish threshold
    assert 1 < calls["ours"] < len(ratios) // 2
    assert regs[0].latest().version == regs[1].latest().version == 1
    assert ours.buffered_rows() == theirs._buffered
    assert ours.buffer_rows <= ours.buffered_rows() < ours.buffer_rows + 16


def test_buffer_is_a_ring_of_the_newest_rows():
    regs, ours, theirs = _both(refit=lambda rows: (_basis(), None), auto=False,
                               buffer_rows=40)
    for i in range(6):
        rows = np.full((16, D), float(i), np.float32)
        for mon in (ours, theirs):
            mon.observe(1.0, 10.0, rows=rows)
    assert ours.buffered_rows() == theirs._buffered == 48
    assert [int(b[0, 0]) for b in ours._buffer] == [int(b[0, 0]) for b in theirs._buffer]


# -- the refresh ---------------------------------------------------------------


def test_refit_hook_publishes_like_the_reference():
    far = _basis(seed=77)
    regs, ours, theirs = _both(refit=lambda rows: (far, None), threshold=0.01, auto=False)
    for mon in (ours, theirs):
        mon.observe(9.0, 10.0, rows=np.ones((M * N, D), np.float32))
    v_ours, v_theirs = ours.refresh_now(), theirs.refresh_now()
    assert v_ours.version == v_theirs.version == 2
    np.testing.assert_array_equal(v_ours.v, np.asarray(v_theirs.v))
    assert v_ours.lineage == v_theirs.lineage
    assert v_ours.lineage["supervised"] is False
    assert abs(ours.last_score - theirs.last_score) <= 1e-6
    # the tripwire re-anchors on the new version
    assert ours.residual_drift() == theirs.residual_drift() == 0.0


def test_unsupervised_refit_matches_the_reference():
    """``supervise=False`` refits through each package's own estimator on
    the buffered rows; the refreshed versions agree."""
    spec = dett.planted_spectrum(D, k_planted=K, gap=20.0, noise=0.01, seed=5)
    rows = _rows(spec, 3 * M * N + 7, seed=3)  # 3 steps; the tail is dropped
    regs, ours, theirs = _both(supervise=False, threshold=0.05, auto=False)
    for mon in (ours, theirs):
        mon.observe(5.0, 10.0, rows=rows)
    v_ours, v_theirs = ours.refresh_now(), theirs.refresh_now()
    assert v_ours is not None and v_theirs is not None
    assert _angle(v_ours.v, v_theirs.v) <= FIT_DEG
    assert _angle(v_ours.v, spec.top_k(K)) < 1.0
    assert abs(ours.last_score - theirs.last_score) <= FIT_DEG / 90 + 1e-9
    assert v_ours.step == v_theirs.step == 3
    assert v_ours.lineage == v_theirs.lineage
    np.testing.assert_allclose(v_ours.sigma_tilde, np.asarray(v_theirs.sigma_tilde),
                               atol=1e-4, rtol=0)


def test_lease_rejected_publish(tmp_path):
    class Clock:
        t = 1000.0

        def __call__(self):
            return self.t

    clock = Clock()
    a = PublisherLease(str(tmp_path), owner="a", lease_ms=1000.0, clock=clock)
    a.try_acquire()
    clock.t += 1.5
    PublisherLease(str(tmp_path), owner="b", lease_ms=1000.0, clock=clock).try_acquire()
    regs, ours, _ = _both(refit=lambda rows: (_basis(seed=77), None), threshold=0.01,
                          auto=False, lease=a)
    ours.observe(9.0, 10.0, rows=np.ones((M * N, D), np.float32))
    assert ours.refresh_now() is None
    assert ours.publishes_rejected == 1 and ours.refreshes == 1
    assert ours.last_score >= ours.threshold
    assert regs[0].latest().version == 1


def test_empty_buffer_or_registry_refreshes_nothing():
    regs, ours, _ = _both(refit=lambda rows: (_basis(seed=77), None), auto=False)
    assert ours.refresh_now() is None and ours.refreshes == 0
    empty = DriftMonitor(EigenbasisRegistry(), PCAConfig(**_kw()), supervise=False,
                         auto=False, device="cpu")
    empty.observe(5.0, 10.0, rows=np.ones((M * N, D), np.float32))
    assert empty.refresh_now() is None


def test_unported_modes_name_the_roadmap():
    # the supervised refit (the reference's default) and the logger sink
    # are ported: both construct as the reference's do
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    reg = EigenbasisRegistry()
    cfg = PCAConfig(**_kw())
    assert DriftMonitor(reg, cfg, device="cpu").supervise
    logger = MetricsLogger()
    assert DriftMonitor(reg, cfg, supervise=False, metrics=logger,
                        device="cpu").metrics is logger
    with pytest.raises(ValueError, match="threshold"):
        DriftMonitor(reg, cfg, supervise=False, threshold=0.0)
    # a refit hook makes the supervised flag harmless, as in the reference
    assert DriftMonitor(reg, cfg, refit=lambda rows: None).supervise is True


# -- the serve -> drift -> refit -> swap loop -----------------------------------


@pytest.fixture(scope="module")
def fitted():
    cfg = PCAConfig(**_kw(solver="subspace", subspace_iters=8, backend="local"))
    spec = dett.planted_spectrum(D, k_planted=K, gap=20.0, noise=0.01, seed=0)
    est = dett.OnlineDistributedPCA(cfg, device="cpu").fit(_rows(spec, T * M * N, seed=1))
    return cfg, spec, est


def test_in_distribution_traffic_does_not_republish(fitted):
    cfg, spec, est = fitted
    reg = EigenbasisRegistry()
    reg.publish_fit(est)
    mon = DriftMonitor(reg, cfg, threshold=0.25, supervise=False, auto=False, device="cpu")
    with QueryServer(reg, cfg, drift=mon, device="cpu") as srv:
        tickets = [srv.submit(_rows(spec, 8, seed=100 + i)) for i in range(12)]
        [t.result(timeout=TIMEOUT) for t in tickets]
    assert mon.buffered_rows() == 12 * 8
    assert mon.residual_drift() < 0.05
    assert mon.refresh_now() is None
    assert reg.latest().version == 1


def test_server_drift_loop_end_to_end(fitted):
    """Shifted traffic arms the monitor through the server's batches; the
    background refit publishes, and the server's next batch serves the new
    version, closer to the shifted truth."""
    cfg, _, est = fitted
    spec_b = dett.planted_spectrum(D, k_planted=K, gap=20.0, noise=0.01, seed=97)
    reg = EigenbasisRegistry()
    v1 = reg.publish_fit(est)
    # the refit's blocks: it arms once a (2, 256) block of rows is buffered
    mon = DriftMonitor(reg, dataclasses.replace(cfg, rows_per_worker=256, num_steps=2),
                       threshold=0.25, supervise=False, auto=True, buffer_rows=1024,
                       device="cpu")
    ratios = []
    with QueryServer(reg, cfg, drift=mon, device="cpu") as srv:
        for i in range(40):
            r = srv.submit(_rows(spec_b, 64, seed=700 + i)).result(timeout=TIMEOUT)
            ratios.append(float(r.residual_sq.sum() / r.input_sq.sum()))
            if mon.refreshing():
                mon.join_refresh(TIMEOUT)
            if reg.latest().version > v1.version:
                break
        mon.join_refresh(TIMEOUT)
        v2 = reg.latest()
        assert v2.version == v1.version + 1 and mon.refreshes >= 1
        assert v2.lineage["producer"] == "drift_refresh"
        assert v2.lineage["base_version"] == v1.version
        post = srv.submit(_rows(spec_b, 16, seed=900)).result(timeout=TIMEOUT)
        assert post.version == v2.version
    truth_b = spec_b.top_k(K)
    stale, fresh = _angle(v1.v, truth_b), _angle(v2.v, truth_b)
    assert fresh < stale and fresh < 1.0
    assert float(post.residual_sq.sum() / post.input_sq.sum()) < min(ratios)
    assert mon.last_score >= mon.threshold
