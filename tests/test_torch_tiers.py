"""Parity of ``runtime/tiers.py`` with the JAX package's on the topology
``(("chip", 2), ("host", 2))``: ``TierSet.begin_round`` under host-tier
churn plans on one fake clock gives equal per-round info, tables, events,
sleeps and ``summary()["merge"]``; ``TierQuorumLost`` fires at the same
round with the same text; ``TieredStream`` yields the same spliced blocks
bit for bit and the same composed masks; and a supervised fit through it
matches the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data.stream import block_stream as jblock_stream
from distributed_eigenspaces_tpu.parallel.topology import resolve_topology as jresolve
from distributed_eigenspaces_tpu.runtime import membership as jm
from distributed_eigenspaces_tpu.runtime import tiers as jt
from distributed_eigenspaces_tpu.runtime.supervisor import supervised_fit as jsupervised_fit
from distributed_eigenspaces_tpu.utils.faults import ChurnPlan as JaxChurn
from distributed_eigenspaces_tpu.utils.metrics import MetricsLogger as JaxLogger
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data.stream import block_stream
from distributed_eigenspaces_tpu_torch.parallel.topology import resolve_topology
from distributed_eigenspaces_tpu_torch.runtime import membership as tm
from distributed_eigenspaces_tpu_torch.runtime import tiers as tt
from distributed_eigenspaces_tpu_torch.runtime.supervisor import supervised_fit
from distributed_eigenspaces_tpu_torch.utils.faults import ChurnPlan
from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

TOPO = (("chip", 2), ("host", 2))
D, K, M, N = 32, 3, 4, 4
STAMPS = ("t", "t_mono", "t_unix")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small CPU tensors: intra-op threads only contend with the other test
    # workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# host-tier plans (slot ids are HOST indices)
PLANS = {
    "straggle_once": dict(straggle={2: {1: 10.0}}),
    "straggle_twice": dict(straggle={2: {1: 10.0}, 3: {1: 10.0}}),
    "persistent_slow": dict(slow={0: 10.0}),
    "kill_rejoin": dict(kill_at={2: [1]}, rejoin_at={6: [1]}),
    "leave": dict(leave_at={3: [0]}),
    "on_time_delay": dict(straggle={2: {0: 0.01}}),
}
ROUNDS = 8
TICK_S = 0.06  # the fake clock's advance a round: a crash is dead by round 4


class _Runtime:
    """One package's pieces under test."""

    def __init__(self, tiers, membership, churn, logger, config, resolve):
        self.tiers, self.membership, self.churn = tiers, membership, churn
        self.logger, self.config, self.resolve = logger, config, resolve


PORT = _Runtime(tt, tm, ChurnPlan, MetricsLogger, PCAConfig, resolve_topology)
REF = _Runtime(jt, jm, JaxChurn, JaxLogger, JaxConfig, jresolve)


def _cfg(rt, **kw):
    return rt.config(**{**dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=ROUNDS,
                               backend="local", merge_topology=TOPO,
                               heartbeat_timeout_ms=100.0, round_deadline_ms=40.0,
                               prefetch_depth=0), **kw})


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in STAMPS}
    if isinstance(obj, (list, tuple)):
        return [_strip(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _tier_rounds(rt, plan_kw, rounds=ROUNDS):
    cfg = _cfg(rt)
    now, slept = [0.0], []
    logger = rt.logger()
    ts = rt.tiers.TierSet(rt.resolve(cfg), cfg, churn={"host": rt.churn(**plan_kw)},
                          metrics=logger, clock=lambda: now[0], sleep=slept.append)
    trail = []
    for step in range(1, rounds + 1):
        try:
            info = ts.begin_round(step)
        except rt.tiers.TierQuorumLost as ql:
            trail.append(("quorum_lost", step, ql.tier, str(ql)))
            break
        trail.append(("round", step, _strip(info)))
        now[0] += TICK_S
    table = ts.tables["host"]
    return (trail, slept, table.snapshot(), _strip(table.events),
            _strip(logger.summary().get("merge")), _strip(logger.summary().get("membership")))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_tier_rounds_equal_the_reference(plan):
    got = _tier_rounds(PORT, PLANS[plan])
    assert got == _tier_rounds(REF, PLANS[plan])
    trail = got[0]
    assert len(trail) == ROUNDS and all(r[0] == "round" for r in trail)


def test_tier_quorum_loss_equals_the_reference():
    kill = dict(kill_at={2: [0, 1]})
    got = _tier_rounds(PORT, kill)
    assert got == _tier_rounds(REF, kill)
    last = got[0][-1]
    assert last[0] == "quorum_lost" and last[2] == "host"
    assert "tier 'host'" in last[3]
    assert issubclass(tt.TierQuorumLost, tm.QuorumLost)


def test_a_stall_between_the_host_beats_and_the_sweep_loses_no_quorum():
    # kill_rejoin leaves one live host member for rounds 2-6; a stall of ten
    # heartbeat timeouts after each member's beat, before the sweep, must
    # not expire it (the per-call clock read lost the tier's quorum there)
    cfg = _cfg(PORT)
    now = [0.0]
    ts = tt.TierSet(resolve_topology(cfg), cfg, churn={"host": ChurnPlan(**PLANS["kill_rejoin"])},
                    clock=lambda: now[0], sleep=lambda s: None)
    table = ts.tables["host"]
    beat = table.heartbeat

    def stalled(*args, **kw):
        beat(*args, **kw)
        now[0] += 1.0

    table.heartbeat = stalled
    masks = [ts.begin_round(step)["host"]["member_mask"].tolist() for step in range(1, ROUNDS + 1)]
    assert masks[0] == [1.0, 1.0] and all(m[0] == 1.0 for m in masks)
    assert table.state(0) == "live"
    assert not [e for e in table.events if e["kind"] == "quorum_lost"]
    assert not [e for e in table.events if e["kind"] == "suspect" and e["slot"] == 0]


def test_churn_on_an_unknown_or_leaf_tier_is_refused_with_the_reference_text():
    for tier in ("pod", "chip"):
        msgs = []
        for rt in (PORT, REF):
            cfg = _cfg(rt)
            with pytest.raises(ValueError, match="non-leaf") as ei:
                rt.tiers.TierSet(rt.resolve(cfg), cfg,
                                 churn={tier: rt.churn(kill_at={2: [0]})})
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# -- the composed stream ---------------------------------------------------------

STREAM_PLANS = {
    "host_straggles": (dict(straggle={2: {1: 10.0}, 3: {1: 10.0}}), None),
    "host_and_leaf": (dict(straggle={3: {0: 10.0}}), dict(straggle={2: {3: 10.0}})),
    "host_killed": (dict(kill_at={2: [1]}, rejoin_at={6: [1]}), None),
}


def _blocks(steps):
    rng = np.random.default_rng(5)
    return [rng.standard_normal((M, N, D)).astype(np.float32) for _ in range(steps)]


def _tiered(rt, host_kw, leaf_kw, device=None):
    cfg = _cfg(rt)
    now = [0.0]

    def sleep(s):
        now[0] += s

    table = rt.membership.MembershipTable(M, heartbeat_timeout_ms=100.0, min_quorum_frac=0.5,
                                          clock=lambda: now[0])
    leaf = rt.churn(**leaf_kw) if leaf_kw else None
    kw = {} if device is None else {"device": device}
    es = rt.membership.ElasticStream(iter(_blocks(ROUNDS)), table, cfg, churn=leaf,
                                     clock=lambda: now[0], sleep=sleep, **kw)
    tiers = rt.tiers.TierSet(rt.resolve(cfg), cfg, churn={"host": rt.churn(**host_kw)},
                             clock=lambda: now[0], sleep=sleep)
    return rt.tiers.TieredStream(es, tiers), table


@pytest.mark.parametrize("plan", sorted(STREAM_PLANS))
def test_tiered_stream_blocks_and_masks_equal_the_reference(plan):
    host_kw, leaf_kw = STREAM_PLANS[plan]
    got, got_table = _tiered(PORT, host_kw, leaf_kw, device="cpu")
    want, _ = _tiered(REF, host_kw, leaf_kw)
    got_feed, want_feed = got.membership_masks(), want.membership_masks()
    spliced = 0
    for t in range(ROUNDS):
        b, wb = next(got), next(want)
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(wb))
        spliced += not np.array_equal(b.numpy(), _blocks(ROUNDS)[t])
        gm, wm = next(got_feed), next(want_feed)
        np.testing.assert_array_equal(gm, np.asarray(wm))
    assert got.table is got_table and not isinstance(got.table, tt.TierTable)
    if plan != "host_killed":
        assert spliced, "no held rows were spliced"


def test_supervised_fit_through_the_tiered_stream_matches_the_reference():
    """A host straggling twice and a leaf straggler, through
    ``supervised_fit`` of both packages: the same number of steps, and
    ``sigma_tilde`` within the supervised parity tolerance (the reference's
    cold start handed to the port)."""
    host_kw, leaf_kw = dict(straggle={3: {1: 10.0}, 4: {1: 10.0}}), dict(straggle={2: {0: 10.0}})
    rng = np.random.default_rng(3)
    scale = np.concatenate([[6.0, 4.5, 3.0], np.full(D - 3, 0.3)]).astype(np.float32)
    data = rng.standard_normal((ROUNDS * M * N, D)).astype(np.float32) * scale
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (D, K), jnp.float32))
    out = []
    for rt, fit, stream, kw in ((PORT, supervised_fit, block_stream, {"device": "cpu"}),
                                (REF, jsupervised_fit, jblock_stream, {"device": False})):
        cfg = _cfg(rt)
        logger = rt.logger()
        table = rt.membership.MembershipTable(M, heartbeat_timeout_ms=1e6, metrics=logger)

        def factory(start_row, rt=rt, cfg=cfg, stream=stream, kw=kw, table=table,
                    logger=logger):
            raw = stream(data, num_workers=M, rows_per_worker=N, start_row=start_row, **kw)
            es = rt.membership.ElasticStream(
                raw, table, cfg, churn=rt.churn(**leaf_kw), metrics=logger,
                first_step=start_row // (M * N) + 1, sleep=lambda s: None,
                **({"device": "cpu"} if rt is PORT else {}))
            tiers = rt.tiers.TierSet(rt.resolve(cfg), cfg, churn={"host": rt.churn(**host_kw)},
                                     metrics=logger, sleep=lambda s: None)
            return rt.tiers.TieredStream(es, tiers)

        extra = {"device": "cpu", "v0": v0} if rt is PORT else {}
        w, st, _ = fit(factory, cfg, metrics=logger, membership=table, **extra)
        merge = logger.summary()["merge"]["tiers"]["host"]
        out.append((int(st.step), np.asarray(st.sigma_tilde), merge["stale_folds"],
                    merge["deadline_closed"]))
    (step, sigma, stale, closed), (jstep, jsigma, jstale, jclosed) = out
    assert (step, stale, closed) == (jstep, jstale, jclosed) == (ROUNDS, 2, 2)
    np.testing.assert_allclose(sigma, jsigma, rtol=1e-4, atol=1e-5)
