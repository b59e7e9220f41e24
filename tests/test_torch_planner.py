"""The port's planner (``analysis/planner.py``) and the command line's
``--plan``, held against the JAX package's, on the CPU.

Both planners get the same calibration dict and the same declared link
speeds (the reference's 90 / 12.5 GB/s, written into each workload), and
must return the same plan dict — the same ``plan_id`` — or refuse with the
same ``PlanInfeasible`` message and rejection histogram. The plan checks
(``self_check``, ``check_plan``, ``drift_check``) must give the same rows on
seeded plans and records; the committed ``ANALYSIS_PLAN_TORCH.json`` must be
what the committed ``PLAN_CALIBRATION_H100.json`` plans, byte for byte; and
``--plan`` must apply a plan as the reference's CLI does. Every comparison is
exact (the plans' ms fields are the same floats, computed the same way).
"""

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

from distributed_eigenspaces_tpu import cli as jcli
from distributed_eigenspaces_tpu import config as jconfig
from distributed_eigenspaces_tpu.analysis import planner as jplanner
from distributed_eigenspaces_tpu_torch import cli, config
from distributed_eigenspaces_tpu_torch.analysis import costmodel, planner

ROOT = Path(__file__).resolve().parents[1]
REF_LINKS = {"ici_gb_per_sec": 90.0, "dcn_gb_per_sec": 12.5}
SMALL = {"name": "test-small", "d": 64, "k": 2, "m": 4, "n": 16, "qps": 20.0, "fleet": 2,
         "rows_per_query": 4, "slo_p99_ms": 500.0, "round_deadline_ms": 250.0, **REF_LINKS}
WORKLOADS = {
    "default": dict(jplanner.DEFAULT_WORKLOAD),
    "small": SMALL,
    "one_host": dict(SMALL, m=8, fleet=1),
    "mid": {"name": "mid", "d": 4096, "k": 16, "m": 32, "n": 256, "qps": 100.0,
            "fleet": 4, "rows_per_query": 16, "slo_p99_ms": 200.0,
            "round_deadline_ms": 50.0, **REF_LINKS},
    # the same at 4x the rate and half the SLO: every candidate over its
    # SLO or saturated
    "mid_saturated": {"name": "mid", "d": 4096, "k": 16, "m": 32, "n": 256,
                      "qps": 400.0, "fleet": 4, "rows_per_query": 16,
                      "slo_p99_ms": 100.0, "round_deadline_ms": 50.0, **REF_LINKS},
    # m % fleet != 0: no topology divides the mesh
    "ragged": dict(jplanner.DEFAULT_WORKLOAD, m=60),
    # an SLO no candidate meets, and a round deadline no tier meets
    "impossible_slo": dict(jplanner.DEFAULT_WORKLOAD, slo_p99_ms=0.01),
    "impossible_deadline": dict(SMALL, d=32768, k=64, m=64, fleet=8,
                                round_deadline_ms=1e-6),
}


def _plan_or_refusal(mod, spec, calib):
    try:
        return mod.make_plan(spec, calib)
    except mod.PlanInfeasible as e:
        return ("PlanInfeasible", str(e))


@pytest.fixture(scope="module")
def ref_calib():
    return jplanner.load_calibration()


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_make_plan_equals_the_reference_on_the_same_calibration(ref_calib, name):
    """The reference's own calibration (its committed records) and the
    reference's link speeds: the same dict, or the same refusal."""
    spec = WORKLOADS[name]
    got = _plan_or_refusal(planner, spec, ref_calib)
    want = _plan_or_refusal(jplanner, spec, ref_calib)
    assert got == want
    if name in ("ragged", "impossible_slo", "impossible_deadline", "mid_saturated"):
        assert got[0] == "PlanInfeasible"
    else:
        assert got["plan_id"] == want["plan_id"] and planner.self_check(got) == []


def test_make_plan_equals_the_reference_on_the_card_calibration():
    """The card's record, read by the port, planned by both packages."""
    calib = planner.load_calibration()
    assert set(calib["sources"]) == {planner.CALIBRATION_RECORD}
    for spec in (WORKLOADS["default"], WORKLOADS["mid"]):
        assert _plan_or_refusal(planner, spec, calib) == _plan_or_refusal(jplanner, spec, calib)


def test_infeasible_rejection_histogram_matches():
    calib = jplanner.load_calibration()
    msgs = []
    for mod in (planner, jplanner):
        with pytest.raises(mod.PlanInfeasible) as e:
            mod.make_plan(WORKLOADS["impossible_slo"], calib)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and '"p99_over_slo": ' in msgs[0]


@pytest.mark.parametrize("mutate", [{"d": 0}, {"k": 128}, {"qps": -1.0},
                                    {"slo_p99_ms": True}, {"bogus_field": 1},
                                    {"name": ""}, "not a dict"])
def test_validate_workload_refuses_word_for_word(mutate):
    spec = mutate if isinstance(mutate, str) else dict(SMALL, **mutate)
    errors = []
    for mod in (planner, jplanner):
        with pytest.raises(ValueError) as e:
            mod.validate_workload(spec)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _seeded_plans(ref_calib) -> dict:
    base = planner.make_plan(SMALL, ref_calib)
    over_slo = copy.deepcopy(base)
    over_slo["chosen"]["predicted"]["serve"]["predicted_p99_ms"] = 900.0
    over_deadline = copy.deepcopy(base)
    for tier in over_deadline["chosen"]["predicted"]["fit_tiers"].values():
        tier["modeled_ms_per_round"] = 300.0
    bad_schema = dict(base, schema="plan-v0")
    return {"ok": base, "over_slo": over_slo, "over_deadline": over_deadline,
            "bad_schema": bad_schema}


def test_self_check_agrees_on_seeded_plans(ref_calib):
    for name, plan in _seeded_plans(ref_calib).items():
        got = [v.format() for v in planner.self_check(plan)]
        want = [v.format() for v in jplanner.self_check(plan)]
        assert got == want, name
    # overrides that build no config: the same rule and location in both
    # (the message quotes each package's own PCAConfig error)
    bad = copy.deepcopy(_seeded_plans(ref_calib)["ok"])
    bad["chosen"]["config_overrides"]["merge_interval"] = 0
    got = [(v.rule, v.location) for v in planner.self_check(bad)]
    assert got == [(v.rule, v.location) for v in jplanner.self_check(bad)]
    assert got == [("plan-infeasible", "chosen.config_overrides")]


def test_check_plan_agrees_on_seeded_drift(ref_calib):
    plan = planner.make_plan(SMALL, ref_calib)
    moved = copy.deepcopy(plan)
    moved["plan_id"] = "plan-000000000000"
    moved["chosen"]["config_overrides"]["replicas"] = 2
    for current, committed in ((plan, plan), (moved, plan), (plan, None)):
        got = [v.format() for v in planner.check_plan(current, committed)]
        want = [v.format() for v in jplanner.check_plan(current, committed)]
        # the same words, naming each package's own artifact and script
        assert [g.replace(planner.PLAN_NAME, "PLAN").replace("torch_analyze", "analyze")
                for g in got] == [w.replace(jplanner.PLAN_NAME, "PLAN") for w in want]
    assert [v.location for v in planner.check_plan(moved, plan)] == ["chosen", "plan_id"]


def test_drift_check_rows_agree(tmp_path, ref_calib):
    """Records scaled 1x (ok), 3x (warn) and 10x (fail), one term dropped
    (missing): the reference reads its bench records, the port the card's
    record holding the same values — the same rows."""
    plan = planner.make_plan(SMALL, ref_calib)
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    ref_root.mkdir(), port_root.mkdir()
    for name in ("BENCH_WIRESPEED_SMOKE_CPU.json", "BENCH_SERVE_SMOKE_CPU.json",
                 "BENCH_COLDSTART_SMOKE_CPU.json", "EXP_PIPELINE_CPU.json"):
        shutil.copy(ROOT / name, ref_root / name)
    wire = json.loads((ref_root / "BENCH_WIRESPEED_SMOKE_CPU.json").read_text())
    wire["kernel_ms"] = {}
    (ref_root / "BENCH_WIRESPEED_SMOKE_CPU.json").write_text(json.dumps(wire))
    serve = json.loads((ref_root / "BENCH_SERVE_SMOKE_CPU.json").read_text())
    serve["p99_latency_s"] *= 3
    (ref_root / "BENCH_SERVE_SMOKE_CPU.json").write_text(json.dumps(serve))
    cold = json.loads((ref_root / "BENCH_COLDSTART_SMOKE_CPU.json").read_text())
    cold["warm_first_serve_s"] *= 10
    (ref_root / "BENCH_COLDSTART_SMOKE_CPU.json").write_text(json.dumps(cold))
    now = jplanner.load_calibration(str(ref_root))
    record = {name: {k: v for k, v in term.items() if k != "source"}
              for name, term in now["terms"].items()}
    (port_root / planner.CALIBRATION_RECORD).write_text(json.dumps(record))
    got = planner.drift_check(plan, str(port_root))
    want = jplanner.drift_check(plan, str(ref_root))
    assert got == want
    assert sorted(r["status"] for r in got) == ["fail", "missing", "ok", "warn"]
    # a root without the card's record drops every term: no CPU record is read
    assert planner.load_calibration(str(ref_root)) == {"sources": {}, "terms": {}}


def test_committed_plan_regenerates_byte_equal_from_the_card_record():
    """``ANALYSIS_PLAN_TORCH.json`` is what the committed calibration plans,
    byte for byte; every term it used is the card's record's."""
    plan = planner.make_plan()
    committed = (ROOT / planner.PLAN_NAME).read_text(encoding="utf-8")
    assert costmodel.dumps_snapshot(plan) == committed
    assert planner.check_plan(plan, planner.load_plan()) == []
    terms = plan["calibration"]["terms"]
    assert set(terms) == {"serve_admit_p99_ms", "serve_kernel_ms", "serve_deadline_p99_ms",
                          "warm_first_serve_ms", "fit_schedule_arms"}
    assert all(t["source"].startswith(planner.CALIBRATION_RECORD + ":") for t in terms.values())
    record = json.loads((ROOT / planner.CALIBRATION_RECORD).read_text())
    assert "H100" in record["card"] and record["card"].endswith(" W")
    assert plan["workload"]["ici_gb_per_sec"] == costmodel.ICI_GB_PER_SEC == 450.0
    assert plan["workload"]["dcn_gb_per_sec"] == costmodel.DCN_GB_PER_SEC == 50.0
    assert planner.self_check(plan) == []


# -- the command line's --plan ----------------------------------------------------


def _configs(monkeypatch, cls) -> list:
    """Every ``cls`` the run builds, recorded as it is validated."""
    built = []
    orig = cls.__post_init__

    def post_init(self):
        built.append(self)
        orig(self)

    monkeypatch.setattr(cls, "__post_init__", post_init)
    return built


@pytest.mark.parametrize("mode", ["fit", "serve"])
def test_cli_plan_applies_like_the_reference(tmp_path, monkeypatch, capsys, ref_calib, mode):
    """One plan through both command lines: the same note line, and the
    configs they build take the plan's workload and knobs alike."""
    plan = planner.make_plan(SMALL, ref_calib)
    path = tmp_path / "plan.json"
    path.write_text(costmodel.dumps_snapshot(plan))
    argv = ["--plan", str(path), "--mode", mode, "--data", "synthetic", "--steps", "2"]
    torch.set_num_threads(1)
    port_cfgs = _configs(monkeypatch, config.PCAConfig)
    ref_cfgs = _configs(monkeypatch, jconfig.PCAConfig)
    rc = cli.main(argv + ["--device", "cpu"])
    _, err = capsys.readouterr()
    jrc = jcli.main(argv)
    _, jerr = capsys.readouterr()
    assert (rc, jrc) == (0, 0)
    note = [ln for ln in err.splitlines() if ln.startswith("note:")]
    assert note == [ln for ln in jerr.splitlines() if ln.startswith("note:")]
    assert note == [f"note: --plan {path}: applied {plan['plan_id']} "
                    f"({', '.join(sorted(plan['chosen']['config_overrides']))})"]
    over = plan["chosen"]["config_overrides"]
    fields = ["dim", "k", "num_workers", "rows_per_worker", "merge_interval",
              "pipeline_merge", "merge_topology", "serve_slo_p99_ms", "plan_path"]
    if mode == "serve":
        fields += ["serve_bucket_size", "serve_flush_s", "serve_continuous", "replicas"]
    # the CLI's own config (the first that carries the plan's path); in serve
    # mode the serve knobs land on its replace, the next one
    at = 1 if mode == "serve" else 0
    got = [c for c in port_cfgs if c.plan_path][at]
    want = [c for c in ref_cfgs if c.plan_path][at]
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert (got.dim, got.k, got.num_workers, got.rows_per_worker) == (
        SMALL["d"], SMALL["k"], SMALL["m"], SMALL["n"])
    assert got.merge_topology == tuple(tuple(t) for t in over["merge_topology"])
    assert got.plan_path == str(path)
    if mode == "serve":
        assert (got.serve_bucket_size, got.serve_continuous) == (
            over["serve_bucket_size"], over["serve_continuous"])


def test_cli_plan_refuses_a_hand_edited_infeasible_plan(tmp_path, capsys, ref_calib):
    plan = planner.make_plan(SMALL, ref_calib)
    plan["chosen"]["predicted"]["serve"]["predicted_p99_ms"] = 9e9
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    argv = ["--plan", str(path), "--mode", "fit", "--data", "synthetic", "--steps", "2"]
    rc = cli.main(argv + ["--device", "cpu"])
    out, err = capsys.readouterr()
    jrc = jcli.main(argv)
    jout, jerr = capsys.readouterr()
    assert (rc, jrc) == (2, 2) and out == jout == ""
    assert err == jerr and "plan-infeasible" in err and "exceeds the declared SLO" in err
    assert list(tmp_path.iterdir()) == [path]
