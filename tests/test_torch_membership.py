"""Parity of ``runtime/membership.py`` with the JAX package's: the lease
machine under a deterministic clock, the elastic stream's masks and blocks
under churn, quorum loss, and the masked whole fit with membership masks."""

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.runtime import membership as jm
from distributed_eigenspaces_tpu.utils.faults import ChurnPlan as JaxChurn
from distributed_eigenspaces_tpu.utils.metrics import MetricsLogger as JaxLogger
from distributed_eigenspaces_tpu_torch.algo import scan as tscan
from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.runtime import membership as tm
from distributed_eigenspaces_tpu_torch.utils.faults import ChurnPlan
from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

M, N, D, K, T = 10, 8, 32, 3, 14


def _script(mod):
    """The reference chaos harness's deterministic lease sequence
    (scripts/chaos.py, churn mode, part 1), recorded step by step."""
    t = [0.0]
    tab = mod.MembershipTable(4, heartbeat_timeout_ms=100, min_quorum_frac=0.5,
                              clock=lambda: t[0])
    trail = []

    def snap(label):
        trail.append((label, tab.snapshot(), [dict(e) for e in tab.events]))

    snap("start")
    t[0] = 0.15
    for s in (1, 2, 3):
        tab.heartbeat(s)
    tab.sweep()
    snap("suspect")
    t[0] = 0.30
    for s in (1, 2, 3):
        tab.heartbeat(s)
    tab.sweep()
    snap("dead")
    tab.heartbeat(0)  # a stale heartbeat from a dead incarnation
    snap("stale")
    slot = tab.join(0)
    snap(f"join {slot}")
    mask = tab.begin_round(9)
    snap(f"round {mask.tolist()}")
    t[0] = 0.45
    tab.leave(2)
    tab.heartbeat(1)
    tab.sweep()
    snap("leave")
    return trail


def test_lease_machine_steps_as_the_reference():
    got, want = _script(tm), _script(jm)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (label, snap, events), (_, jsnap, jevents) in zip(got, want):
        assert snap == jsnap, label
        assert events == jevents, label


def test_table_refuses_as_the_reference():
    for mod in (tm, jm):
        tab = mod.MembershipTable(3, clock=lambda: 0.0)
        with pytest.raises(ValueError, match="not dead"):
            tab.join(1)
        with pytest.raises(ValueError, match="no dead slot"):
            tab.join()
        with pytest.raises(ValueError, match="min_quorum_frac"):
            mod.MembershipTable(3, min_quorum_frac=0.0)
        with pytest.raises(ValueError, match="heartbeat_timeout_ms"):
            mod.MembershipTable(3, heartbeat_timeout_ms=0)


def test_quorum_loss_and_wait():
    t = [0.0]
    naps = []

    def sleep(s):
        naps.append(s)
        t[0] += s

    tab = tm.MembershipTable(4, heartbeat_timeout_ms=100, min_quorum_frac=0.75,
                             clock=lambda: t[0], sleep=sleep)
    t[0] = 0.25
    tab.heartbeat(0)
    tab.heartbeat(1)
    with pytest.raises(tm.QuorumLost, match="quorum lost at step 3") as err:
        tab.begin_round(3)
    assert err.value.live == 2 and err.value.required == 0.75
    # no rejoin: the bounded wait gives up on the injected clock
    assert not tab.wait_for_quorum(0.05, poll_s=0.01)
    assert naps and all(n == 0.01 for n in naps)
    t[0] += 0.2  # the suspects' grace runs out: dead, joinable
    tab.heartbeat(0)
    tab.heartbeat(1)
    tab.sweep()
    tab.join(2)
    assert tab.wait_for_quorum(0.05)
    assert tab.state(2) == "live" and tab.events[-1]["kind"] == "quorum_restored"


CHURNS = {
    "kill_rejoin_straggle": dict(kill_at={3: [0, 1, 2], 9: [3]},
                                 rejoin_at={9: [0, 1], 12: [3]}, slow={9: 0.08}),
    "leave_and_one_off": dict(leave_at={2: [4]}, rejoin_at={5: [4]},
                              straggle={3: {1: 0.06}, 4: {1: 0.01}}),
}


def _elastic(mod, churn_cls, cfg, churn, data, first_step, logger, **kw):
    t = [0.0]

    def sleep(s):
        t[0] += s

    tab = mod.MembershipTable(M, heartbeat_timeout_ms=cfg.heartbeat_timeout_ms,
                              min_quorum_frac=cfg.min_quorum_frac,
                              clock=lambda: t[0], sleep=sleep, metrics=logger)
    stream = mod.ElasticStream(iter(data[first_step - 1:]), tab, cfg,
                               churn=churn_cls(**churn), first_step=first_step,
                               metrics=logger, clock=lambda: t[0], sleep=sleep, **kw)
    feed = stream.membership_masks()
    blocks, masks = [], []
    for b in stream:
        blocks.append(np.asarray(b))
        masks.append(next(feed))
    return blocks, masks, tab


@pytest.mark.parametrize("first_step", [1, 5])
@pytest.mark.parametrize("name", sorted(CHURNS))
def test_elastic_stream_matches_the_reference(name, first_step):
    data = np.random.default_rng(2).standard_normal((T, M, N, D)).astype(np.float32)
    kw = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
              heartbeat_timeout_ms=100.0, round_deadline_ms=40.0, min_quorum_frac=0.5)
    logger, jlogger = MetricsLogger(), JaxLogger()
    got = _elastic(tm, ChurnPlan, PCAConfig(**kw), CHURNS[name], data, first_step,
                   logger, device="cpu")
    want = _elastic(jm, JaxChurn, JaxConfig(**kw, prefetch_depth=0), CHURNS[name], data,
                    first_step, jlogger)
    assert len(got[0]) == len(want[0]) == T - first_step + 1
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2].snapshot() == want[2].snapshot()
    strip = ("t_mono", "t_unix", "t")
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in logger.membership_records] == \
        [{k: v for k, v in r.items() if k not in strip} for r in jlogger.membership_records]


def test_mask_feed_out_of_lockstep_raises():
    feed = tm._MembershipMaskFeed(__import__("collections").deque())
    with pytest.raises(RuntimeError, match="lockstep"):
        next(feed)


def test_masked_scan_takes_membership_masks_by_and():
    cfg = PCAConfig(dim=D, k=K, num_workers=4, rows_per_worker=N, num_steps=4,
                    solver="subspace", subspace_iters=6)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 4, N, D)).astype(np.float32))
    rng = np.random.default_rng(4)
    q = (rng.random((4, 4)) > 0.3).astype(np.float32)
    mem = (rng.random((4, 4)) > 0.3).astype(np.float32)
    v0 = torch.from_numpy(rng.standard_normal((D, K)).astype(np.float32))
    fit = tscan.make_scan_fit(cfg, device="cpu", v0=v0, masked=True)
    assert fit.__name__ == "fit_masked_elastic"
    a, va = fit(OnlineState.initial(D, device="cpu"), x, q, membership_masks=mem)
    b, vb = fit(OnlineState.initial(D, device="cpu"), x, q * mem)
    assert torch.equal(a.sigma_tilde, b.sigma_tilde) and torch.equal(va, vb)
