"""Parity of ``runtime/controller.py`` and the slice's ``PCAConfig`` fields
with the JAX package's: the same bad values give the same ``ValueError``
text, and both packages' autoscalers, ticked on one scripted telemetry
sequence over a stub queue, give equal decision trails (``seq``,
``plan_id``, knobs, evidence) and leave the queue in the same state."""

import pytest

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.runtime import controller as jc
from distributed_eigenspaces_tpu.utils.metrics import MetricsLogger as JaxLogger
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.runtime import controller as tc
from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger


def _message(cls, **kw):
    with pytest.raises(ValueError) as ei:
        cls(dim=16, k=4, **kw)
    return str(ei.value)


# the reference's bad values (tests/test_controller.py and
# tests/test_population.py) and the replica / lease fields'
BAD = (
    [("controller_window_s", v) for v in (0, -1.0, True, "fast")]
    + [("controller_max_actions", v) for v in (0, -2, True, 1.5)]
    + [("plan_path", v) for v in ("", 7)]
    + [("replicas", v) for v in (0, True, 1.5)]
    + [("replica_staleness_ms", v) for v in (0, -1.0, True)]
    + [("publisher_lease_ms", v) for v in (0, "x")]
    + [("population", v) for v in (0, True, 2.5)]
    + [("min_participation_frac", v) for v in (0.0, 1.5, True)]
    + [("max_poison_frac", v) for v in (0.5, -0.1)]
    + [("cohort_size", v) for v in (0, True)]
)


@pytest.mark.parametrize("field,bad", BAD, ids=lambda v: repr(v))
def test_bad_value_message_equals_the_reference(field, bad):
    got = _message(PCAConfig, **{field: bad})
    assert field in got
    assert got == _message(JaxConfig, **{field: bad})


def test_cohort_above_population_message_equals_the_reference():
    kw = dict(population=10, cohort_size=11)
    got = _message(PCAConfig, **kw)
    assert "cohort_size must not exceed population" in got
    assert got == _message(JaxConfig, **kw)


FIELDS = ("population", "cohort_size", "min_participation_frac", "max_poison_frac",
          "replicas", "replica_staleness_ms", "publisher_lease_ms",
          "controller_window_s", "controller_max_actions", "plan_path")


def test_defaults_and_good_values_equal_the_reference():
    for kw in ({}, dict(population=100_000, cohort_size=256,
                        min_participation_frac=0.6,
                        replica_staleness_ms=250.0, publisher_lease_ms=150.0,
                        controller_window_s=0.5, controller_max_actions=3)):
        got, want = PCAConfig(dim=16, k=4, **kw), JaxConfig(dim=16, k=4, **kw)
        assert {f: getattr(got, f) for f in FIELDS} == {f: getattr(want, f) for f in FIELDS}


def test_compile_cache_dir_still_refused():
    # accepted since the compile cache is ported (utils/compile_cache.py);
    # a value that is not a path string is still refused, as the reference's
    assert PCAConfig(dim=16, k=4, compile_cache_dir="cache").compile_cache_dir == "cache"
    with pytest.raises(ValueError, match="compile_cache_dir"):
        PCAConfig(dim=16, k=4, compile_cache_dir=7)


@pytest.mark.parametrize("field,value", [("replicas", 2), ("plan_path", "plan.json")])
def test_fields_only_the_cli_reads_are_refused(field, value):
    # the reference accepts both (its CLI reads them); the port's CLI reads
    # both too since the planner is ported, so both are accepted as given
    JaxConfig(dim=16, k=4, **{field: value})
    assert getattr(PCAConfig(dim=16, k=4, **{field: value}), field) == value


# -- the autoscaler, tick by tick ---------------------------------------------


class _Queue:
    def __init__(self, continuous=False, bucket_size=8, flush_deadline=0.3):
        self.continuous = continuous
        self.bucket_size = bucket_size
        self.flush_deadline = flush_deadline
        self.flush_all_calls = 0

    def flush_all(self):
        self.flush_all_calls += 1

    def state(self):
        return (self.continuous, self.bucket_size, self.flush_deadline,
                self.flush_all_calls)


class _Server:
    def __init__(self, queue):
        self.queue = queue


class _Metrics:
    """Records decisions; ``summary()`` replays the last scripted SLO
    snapshot."""

    def __init__(self):
        self.events = []
        self.feed(requests=0, violations=0)

    def feed(self, *, requests, violations, burn_fast=0.0):
        self._slo = {
            "burn": {"fast": burn_fast, "slow": burn_fast},
            "attainment": 1.0 - violations / max(requests, 1),
            "requests": requests, "violations": violations, "p99_ms": 5.0,
        }

    def controller(self, event):
        self.events.append(dict(event))

    def summary(self):
        return {"slo": {"serve": dict(self._slo)},
                "serving": {"mean_occupancy": 0.5, "health": {"sheds": {"overload": 2}}}}


PLAN = {"plan_id": "plan-test-1234",
        "chosen": {"config_overrides": {"serve_continuous": True, "serve_flush_s": 0.05,
                                        "serve_bucket_size": 8}}}
BAD_PLAN = {"schema": "plan-v1", "plan_id": "plan-seeded-bad",
            "chosen": {"config_overrides": {"serve_flush_s": 2.0}}}

# (queue kwargs, cfg kwargs, plan, feeds: one (requests, violations, burn_fast)
# or None (tick on the last feed) a tick)
SCRIPTS = {
    "breach_commit": ({}, {}, None,
                      [(100, 5, 2.0), (150, 5, 0.0), (250, 5, 0.0), (260, 5, 0.0)]),
    "breach_rollback": ({}, {}, None,
                        [(100, 5, 1.5), (110, 6, 0.0), (120, 16, 0.0), (130, 16, 3.0)]),
    "judge_stretches": ({}, {}, None,
                        [(100, 5, 2.0), (130, 5, 0.0), None, None, (180, 5, 0.0)]),
    "plan_rollout": ({}, {}, PLAN,
                     [(10, 0, 0.0), (20, 0, 0.0), (30, 0, 0.0), (40, 0, 0.0),
                      (50, 0, 0.0), (60, 0, 0.0)]),
    "bad_plan_rolled_back": ({"flush_deadline": 0.3}, {}, BAD_PLAN,
                             [(10, 0, 0.0), (20, 0, 0.0), (30, 10, 5.0), (40, 10, 5.0)]),
    "flush_then_bucket": ({"continuous": True}, {}, None,
                          [(100, 50, 5.0), (150, 60, 5.0), (250, 60, 0.0),
                           (300, 100, 5.0), (310, 100, 5.0), (400, 100, 0.0)]),
    "floors_no_surface": ({"continuous": True, "bucket_size": 2, "flush_deadline": 0.005},
                          {}, None, [(100, 50, 5.0), (200, 100, 5.0), (300, 150, 5.0)]),
    "bucket_last_resort": ({"continuous": True, "bucket_size": 8, "flush_deadline": 0.005},
                           {}, None, [(100, 50, 5.0)]),
    "budget_frozen": ({}, {"controller_max_actions": 1}, None,
                      [(100, 50, 5.0), (150, 50, 0.0), (250, 50, 0.0), (400, 200, 9.0)]),
    "rollback_with_budget_spent": ({}, {"controller_max_actions": 1}, None,
                                   [(100, 5, 1.5), (110, 6, 0.0), (120, 16, 0.0)]),
}


def _trail(mod, cfg_cls, script):
    queue_kw, cfg_kw, plan, feeds = script
    q, m = _Queue(**queue_kw), _Metrics()
    cfg = cfg_cls(dim=16, k=4, controller_window_s=0.25, **cfg_kw)
    ctl = mod.Controller(_Server(q), m, cfg, plan=plan, clock=lambda: 0.0)
    states = []
    for feed in feeds:
        if feed is not None:
            requests, violations, burn = feed
            m.feed(requests=requests, violations=violations, burn_fast=burn)
        ctl.tick()
        states.append(q.state())
    return m.events, states


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tick_trail_equals_the_reference(name):
    got, got_states = _trail(tc, PCAConfig, SCRIPTS[name])
    want, want_states = _trail(jc, JaxConfig, SCRIPTS[name])
    assert got == want
    assert got_states == want_states
    assert got, "the script took no decision"
    for ev in got:  # every decision carries its lineage
        assert "seq" in ev and "plan_id" in ev


def test_scripts_cover_every_decision_kind():
    kinds = set()
    for script in SCRIPTS.values():
        kinds |= {e["kind"] for e in _trail(tc, PCAConfig, script)[0]}
    assert kinds == {"action", "commit", "rollback", "no_surface", "budget_exhausted"}


def test_lifecycle_and_summary_section_equal_the_reference():
    """start / close bracket the trail, and the logger's ``controller``
    section aggregates the decisions as the reference's does."""
    out = []
    for mod, cfg_cls, logger in ((tc, PCAConfig, MetricsLogger), (jc, JaxConfig, JaxLogger)):
        m = logger()
        q = _Queue()
        ctl = mod.Controller(_Server(q), m, cfg_cls(dim=16, k=4, controller_window_s=30.0),
                             plan=PLAN)
        with ctl:
            pass
        ctl._record("rollback", knob="serve_continuous", trigger="burn_worsened",
                    **{"from": True, "to": False}, evidence={})
        summ = m.summary()["controller"]
        out.append(({k: v for k, v in summ.items() if k != "events"},
                    [{k: v for k, v in e.items() if k not in ("t", "t_mono", "t_unix")}
                     for e in summ["events"]]))
    assert out[0] == out[1]
    assert out[0][1][0]["controller"] == "start"


def test_controller_requires_a_window():
    for mod, cfg_cls in ((tc, PCAConfig), (jc, JaxConfig)):
        with pytest.raises(ValueError, match="controller_window_s"):
            mod.Controller(_Server(_Queue()), _Metrics(), cfg_cls(dim=16, k=4))
    assert tc.SURFACE_KNOBS == jc.SURFACE_KNOBS
