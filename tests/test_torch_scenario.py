"""Parity of ``runtime/scenario.py`` with the JAX package's: every
malformed spec fails with the reference's message word for word, the
committed specs load to equal fields, ``build_schedule`` is identical
action for action, ``_verdict`` turns one synthetic ``summary()`` into
equal records, and the port replays ``ci_smoke`` on the CPU with every
hard gate true and the verdict keys the reference's ``_verdict`` builds.
No latency or attainment value is asserted: those depend on the
machine's load."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.runtime import scenario as js
from distributed_eigenspaces_tpu_torch.runtime import scenario as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ("ci_smoke", "controller_day", "production_day")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small CPU tensors: intra-op threads only contend with the other test
    # workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_path(name):
    return os.path.join(ROOT, "scenarios", f"{name}.json")


def _spec_dict(*episodes, **over):
    d = {"name": "unit", "seed": 5,
         "episodes": list(episodes) or [{"name": "calm", "kind": "steady", "start_s": 0.0,
                                          "duration_s": 1.0, "qps": 4}]}
    d.update(over)
    return d


def _churn(config=None, **over):
    ep = {"name": "c", "kind": "churn", "start_s": 0.0, "duration_s": 1.0, "workers": 4,
          "kill_slots": [1], "kill_step": 2}
    ep.update(over)
    d = _spec_dict(ep)
    if config is not None:
        d["config"] = config
    return d


TOPO = {"merge_topology": [["w", 2], ["host", 2]]}
STEADY = {"name": "a", "kind": "steady", "start_s": 0.0, "duration_s": 1.0, "qps": 4}
PUBLISH = {"name": "a", "kind": "publish", "start_s": 0.0, "duration_s": 0.0}
POP = {"name": "a", "kind": "population", "start_s": 0.0, "duration_s": 1.0,
       "population": 100, "cohort_size": 10}

# tests/test_scenario.py:71-145 and tests/test_topology.py:486-515, and
# cases the reference's tests leave out (config, episode type, population)
MALFORMED = {
    "missing_kind_field": _spec_dict({k: v for k, v in STEADY.items() if k != "qps"}),
    "unknown_field": _spec_dict({**STEADY, "qqps": 9}),
    "unknown_kind": _spec_dict({"name": "a", "kind": "meteor", "start_s": 0.0,
                                "duration_s": 1.0}),
    "negative_start": _spec_dict({**STEADY, "start_s": -1.0}),
    "zero_duration_load": _spec_dict({**STEADY, "duration_s": 0.0}),
    "inverted_diurnal": _spec_dict({"name": "a", "kind": "diurnal", "start_s": 0.0,
                                    "duration_s": 1.0, "qps_low": 9, "qps_high": 2,
                                    "period_s": 1.0}),
    "kill_slots_range": _spec_dict({"name": "a", "kind": "churn", "start_s": 0.0,
                                    "duration_s": 1.0, "workers": 2, "kill_slots": [5],
                                    "kill_step": 1}),
    "replicas_zero": _spec_dict({**PUBLISH, "replicas": 0}),
    "replicas_str": _spec_dict({**PUBLISH, "replicas": "two"}),
    "kill_publisher_int": _spec_dict({**PUBLISH, "replicas": 2, "kill_publisher": 1}),
    "kill_publisher_alone": _spec_dict({**PUBLISH, "kill_publisher": True}),
    "missing_common": _spec_dict({k: v for k, v in STEADY.items() if k != "duration_s"}),
    "duplicate_name": _spec_dict(STEADY, dict(STEADY)),
    "empty_name": _spec_dict(name=""),
    "no_episodes": _spec_dict(episodes=[]),
    "seed_str": _spec_dict(seed="7"),
    "slo_zero": _spec_dict(slo_p99_ms=0),
    "top_level_extra": _spec_dict(qps=3),
    "config_not_object": _spec_dict(config=[1]),
    "episode_not_object": _spec_dict(3),
    "cohort_above_population": _spec_dict({**POP, "cohort_size": 101}),
    "dropout_frac_range": _spec_dict({**POP, "dropout_frac": 1.0}),
    "rounds_zero": _spec_dict({**POP, "rounds": 0}),
    "tier_without_topology": _churn(tier="host"),
    "unknown_tier": _churn(config=TOPO, tier="pod"),
    "fan_in_product": _churn(config=TOPO, workers=8, tier="host"),
    "tier_member_slots": _churn(config=TOPO, tier="host", kill_slots=[2]),
    "malformed_topology": _churn(config={"merge_topology": "chip:4"}),
    "not_an_object": [1, 2],
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_spec_message_equals_the_reference(case):
    msgs = []
    for mod in (ts, js):
        with pytest.raises(ValueError) as ei:
            mod.load_spec(copy.deepcopy(MALFORMED[case]))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("scenario spec")


def _fields(spec):
    return (spec.name, spec.seed, spec.config, spec.slo_p99_ms, spec.horizon_s,
            [(e.name, e.kind, e.start_s, e.duration_s, e.params, e.fault, e.end_s)
             for e in spec.episodes])


@pytest.mark.parametrize("name", SPECS)
def test_committed_spec_loads_as_the_reference(name, tmp_path):
    spec = ts.load_spec(_spec_path(name))
    assert _fields(spec) == _fields(js.load_spec(_spec_path(name)))
    with open(_spec_path(name)) as f:
        assert ts.load_spec(json.load(f)) == spec  # file and dict forms agree
    # the overrides the card runs it with take the same path
    wide = dict(json.load(open(_spec_path(name))),
                config={**spec.config, "dim": 784, "num_workers": 8})
    assert _fields(ts.load_spec(wide)) == _fields(js.load_spec(wide))
    assert ts.EPISODE_KINDS == js.EPISODE_KINDS and ts.FAULT_KINDS == js.FAULT_KINDS


def _actions(sched):
    return [(a.t_s, a.kind, a.episode, a.index, a.tenant) for a in sched.actions]


@pytest.mark.parametrize("seed", [None, 1234])
@pytest.mark.parametrize("name", SPECS)
def test_schedule_is_identical_to_the_reference(name, seed):
    with open(_spec_path(name)) as f:
        raw = json.load(f)
    if seed is not None:
        raw["seed"] = seed
    got, want = ts.build_schedule(ts.load_spec(raw)), js.build_schedule(js.load_spec(raw))
    assert _actions(got) == _actions(want)
    assert got.describe() == want.describe()
    assert sum(a.kind == "query" for a in got.actions) > 0


def _synthetic_summary(spec):
    eps = {}
    for i, ep in enumerate(spec.episodes):
        eps[ep.name] = {"kind": ep.kind, "fault": ep.fault, "requests": 3 + i,
                        "fleet_requests": 2 if ep.kind == "tenant_skew" else 0,
                        "recovered": True if ep.fault else None,
                        "recovery_ms": 12.5 if ep.fault else None,
                        "slo": {"attainment": 0.9}}
    del eps[spec.episodes[-1].name]  # one episode unmeasured: its gate fails
    return {
        "episodes": eps,
        "serving": {"batches": 10, "queries": 40, "rejected": 1, "qps": 12.0,
                    "p50_latency_s": 0.01, "p99_latency_s": 0.2, "swaps": 2,
                    "versions_served": [1, 2], "health": {"sheds": {}},
                    "latency_decomposition": {"queue_wait_s": 0.1}, "unjudged": 7},
        "replication": {"installs": 4, "stale": 0, "fenced": 1, "failovers": 1,
                        "propagation_p50_ms": 3.0, "propagation_p99_ms": 9.0,
                        "failover_recovery_ms": 150.0},
        "fleet": {"buckets": 3, "tenants": 6, "p99_latency_s": 0.5, "mean_occupancy": 0.75},
        "membership": {"events": 20, "by_kind": {"dead": 2}, "rounds": 10,
                       "deadline_closed": 2, "stale_folds": 1},
        "population": {"rounds": 4, "stale_folds": 3, "participation_hist": {"0.8": 4},
                       "rejects_by_reason": {"not_orthonormal": 7}, "by_kind": {}},
        "slo": {"serve": {"attainment": 0.9, "p99_ms": 200.0,
                          "burn": {"fast": 0.5, "slow": 0.2}}},
        "controller": {"decisions": 2, "events": [{"controller": "action", "seq": 1}]},
    }


def test_verdict_of_one_summary_equals_the_reference():
    spec_t = ts.load_spec(_spec_path("production_day"))
    spec_j = js.load_spec(_spec_path("production_day"))
    summ = _synthetic_summary(spec_t)
    churn = {"rack_loss": {"w": np.zeros(2), "step": 10}}
    pop = {"crowd_ingest": {"angle_deg": 2.0, "rounds": 4, "rejects": {"not_orthonormal": 7}}}
    records = []
    for mod, spec, kw in ((ts, spec_t, {"device": "cpu"}), (js, spec_j, {})):
        runner = mod.ScenarioRunner(spec, **kw)
        runner.submitted, runner.resolved, runner.publishes = 40, 39, 2
        runner.replica_converged = {"hotfix_push": True}
        records.append(runner._verdict(copy.deepcopy(summ), churn, pop))
    assert records[0] == records[1]
    gates = records[0]["gates"]
    assert gates["world_moves_served"] is False and gates["all_episodes_measured"] is False
    assert gates["hotfix_push_replicas_converged"] and gates["rack_loss_fit_completed"]


def test_port_replays_ci_smoke_with_every_gate(tmp_path):
    trace = str(tmp_path / "trace.json")
    verdict, ok = ts.run_scenario(_spec_path("ci_smoke"), trace_out=trace, device="cpu")
    assert ok, verdict.get("scenario_fail")
    assert all(verdict["gates"].values())
    assert verdict["metric"] == "pca_scenario_slo_verdict" and verdict["scenario"] == "ci_smoke"
    json.dumps(verdict)
    # the key set, gate names included, the reference's _verdict builds from
    # this very summary
    spec = js.load_spec(_spec_path("ci_smoke"))
    runner = js.ScenarioRunner(spec)
    summ = {k: verdict[k] for k in ("episodes", "slo")}
    summ["serving"], summ["membership"] = verdict["serving"], verdict["membership"]
    ref = runner._verdict(summ, verdict["churn"], verdict["population_fits"])
    assert set(verdict) - {"trace_out"} == set(ref)
    assert set(verdict["gates"]) == set(ref["gates"])
    assert set(verdict["episodes"]) == {ep.name for ep in spec.episodes}
    assert verdict["replay"]["submitted"] == sum(
        a.kind == "query" for a in js.build_schedule(spec).actions)
    assert verdict["replay"]["publishes"] == 1 and verdict["replay"]["failed"] == 0
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert {e["name"] for e in events if e.get("cat") == "episode"} >= {"crowd", "shake", "swap"}
