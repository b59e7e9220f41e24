"""Parity of ``runtime/population.py`` with the JAX package's: the ingest's
cohort rounds (stacks, masks, rejects, events) bit-equal under a chaos plan
with a participation collapse and a one-step-stale late fold, the bounded
participation wait on a fake clock, and ``population_fit``'s hardened and
naive arms within 0.01 degrees of the reference's bases, with equal
rounds, resumes, reject totals and ledgers."""

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.runtime import population as jp
from distributed_eigenspaces_tpu.runtime.supervisor import SupervisorError as JaxSupervisorError
from distributed_eigenspaces_tpu.utils.faults import ClientChaosPlan as JaxPlan
from distributed_eigenspaces_tpu.utils.metrics import MetricsLogger as JaxLogger
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.runtime import population as tp
from distributed_eigenspaces_tpu_torch.runtime.membership import QuorumLost
from distributed_eigenspaces_tpu_torch.runtime.supervisor import SupervisorError
from distributed_eigenspaces_tpu_torch.utils.faults import ClientChaosPlan
from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

STAMPS = ("t", "t_mono", "t_unix")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors and per-client QRs: torch's intra-op threads and numpy's
    # BLAS threads only contend with each other and the other test workers
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # numpy keeps its own thread count
        threadpool_limits = None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    limits = threadpool_limits(1) if threadpool_limits is not None else None
    yield
    if limits is not None:
        limits.restore_original_limits()
    torch.set_num_threads(n)
# the reference tests' shape (tests/test_population.py)
SMALL = dict(dim=24, k=3, num_workers=4, rows_per_worker=8, num_steps=4, backend="local",
             heartbeat_timeout_ms=100.0, population=2000, cohort_size=48,
             min_participation_frac=0.5, max_poison_frac=0.1)
# the bench's population A/B shape (bench.py --population)
BENCH = dict(dim=64, k=4, num_workers=8, rows_per_worker=16, num_steps=8, backend="local",
             heartbeat_timeout_ms=100.0, population=100_000, cohort_size=256,
             min_participation_frac=0.5, max_poison_frac=0.08)
CHAOS = dict(dropout_frac=0.3, dropout_waves={3: 0.9}, straggler_frac=0.05, nan_frac=0.02,
             poison_frac=0.05, poison_scale=3.0)
SCALED = dict(dropout_frac=0.30, dropout_waves={4: 0.9}, straggler_frac=0.03, nan_frac=0.01,
              poison_frac=0.05, poison_scale=3.0)
ORTH = dict(dropout_frac=0.30, straggler_frac=0.03, poison_frac=0.05, poison_scale=1.0)


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in STAMPS}
    if isinstance(obj, (list, tuple)):
        return [_strip(v) for v in obj]
    return obj


def _ingest_trail(mod, cfg_cls, plan_cls, logger_cls, *, gauntlet=True, rounds=6):
    now = [0.0]

    def sleep(s):
        now[0] += s

    logger = logger_cls()
    ingest = mod.PopulationIngest(cfg_cls(**SMALL), plan=plan_cls(**CHAOS), metrics=logger,
                                  gauntlet=gauntlet, clock=lambda: now[0], sleep=sleep, seed=3)
    trail = []
    while len(trail) < rounds:
        try:
            t, stack, mask, rejected = ingest.run_round()
        except mod.ParticipationLost as pl:
            trail.append(("lost", pl.step, pl.live, pl.frac, str(pl),
                          pl.table.state_counts(), ingest.late_pending))
            trail.append(("wait", pl.table.wait_for_quorum(0.05, poll_s=0.01), ingest.round,
                          now[0]))
            continue
        trail.append(("round", t, stack, mask, rejected, ingest.late_pending))
    summary = logger.summary()["population"]
    return trail, _strip(ingest.events), _strip(summary), ingest.planted, ingest.poison_basis


@pytest.mark.parametrize("gauntlet", [True, False], ids=["gauntlet", "raw"])
def test_ingest_rounds_bit_equal_the_reference(gauntlet):
    got = _ingest_trail(tp, PCAConfig, ClientChaosPlan, MetricsLogger, gauntlet=gauntlet)
    want = _ingest_trail(jp, JaxConfig, JaxPlan, JaxLogger, gauntlet=gauntlet)
    trail, jtrail = got[0], want[0]
    assert [r[0] for r in trail] == [r[0] for r in jtrail]
    for r, jr in zip(trail, jtrail):
        if r[0] == "round":
            assert r[1] == jr[1] and r[4] == jr[4] and r[5] == jr[5]
            assert r[2].dtype == np.float32 and r[3].dtype == np.float32
            assert np.array_equal(r[2], jr[2], equal_nan=True)
            assert np.array_equal(r[3], jr[3])
        else:
            assert r == jr
    assert got[1:3] == want[1:3]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    kinds = {e["kind"] for e in got[1]}
    # the chaos plan exercised the collapse, the wait and the late fold
    assert {"participation_lost", "participation_restored", "round_closed"} <= kinds
    assert any(e["kind"] == "round_closed" and e["stale"] > 0 for e in got[1])
    if gauntlet:
        assert {"quarantine_client"} <= kinds
        assert issubclass(tp.ParticipationLost, QuorumLost)


def test_ingest_needs_a_population_as_the_reference():
    msgs = []
    for mod, cfg_cls in ((tp, PCAConfig), (jp, JaxConfig)):
        with pytest.raises(ValueError, match="population") as ei:
            mod.PopulationIngest(cfg_cls(**{**SMALL, "population": None}))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _angle(a, b) -> float:
    return float(principal_angles_degrees(torch.tensor(np.asarray(a, np.float32)),
                                          torch.tensor(np.asarray(b, np.float32))).max())


def _fit(mod, cfg_cls, plan_cls, logger_cls, plan_kw, **kw):
    extra = {"device": "cpu"} if mod is tp else {}
    logger = logger_cls()
    w, info, sup = mod.population_fit(cfg_cls(**BENCH), plan=plan_cls(**plan_kw),
                                      metrics=logger, participation_wait_s=5.0, **kw, **extra)
    ledger = [_strip(e) for e in sup.ledger.events]
    return np.asarray(w), info, ledger, _strip(logger.summary()["population"])


ARMS = {
    "hardened_scaled_poison": (SCALED, {}),
    "naive_orthonormal_poison": (ORTH, {"hardened": False}),
    "hardened_orthonormal_poison": (ORTH, {}),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_population_fit_matches_the_reference(arm):
    plan_kw, kw = ARMS[arm]
    w, info, ledger, summ = _fit(tp, PCAConfig, ClientChaosPlan, MetricsLogger, plan_kw, **kw)
    jw, jinfo, jledger, jsumm = _fit(jp, JaxConfig, JaxPlan, JaxLogger, plan_kw, **kw)
    assert w.shape == (BENCH["dim"], BENCH["k"]) and np.isfinite(w).all()
    assert _angle(w, jw) <= 0.01
    for key in ("rounds", "resumes", "rejects", "participation"):
        assert info[key] == jinfo[key], key
    assert _strip(info["events"]) == _strip(jinfo["events"])
    assert ledger == jledger
    # the merge records carry the same kept counts and trim fractions
    assert summ == jsumm
    angle = _angle(w, info["planted"])
    if kw.get("hardened", True):
        assert angle <= 5.0  # the bench's budget
        if plan_kw is SCALED:
            assert info["resumes"] >= 1
            quarantines = [e for e in ledger if e["kind"] == "quarantine_client"]
            assert len(quarantines) == sum(info["rejects"].values()) > 0
    else:
        hardened = _fit(tp, PCAConfig, ClientChaosPlan, MetricsLogger, ORTH)[0]
        assert angle >= 2.0 * _angle(hardened, info["planted"])


def test_resume_budget_exhaustion_raises_as_the_reference():
    plan = dict(dropout_frac=0.0, dropout_waves={r: 0.95 for r in range(2, 100)})
    msgs = []
    for mod, cfg_cls, plan_cls, err in ((tp, PCAConfig, ClientChaosPlan, SupervisorError),
                                        (jp, JaxConfig, JaxPlan, JaxSupervisorError)):
        extra = {"device": "cpu"} if mod is tp else {}
        with pytest.raises(err) as ei:
            mod.population_fit(cfg_cls(**SMALL), plan=plan_cls(**plan), rounds=4,
                               max_resumes=1, participation_wait_s=0.05, **extra)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
