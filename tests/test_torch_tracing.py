"""The port's telemetry aggregates and profiler hooks against the
reference's.

- ``utils/telemetry.py``'s :class:`Histogram`, :class:`RingLog` and
  :func:`slo_summary` (copied from the reference): the same outputs on the
  same inputs, record for record.
- ``utils/tracing.py`` on ``torch.profiler``: ``profile_to(None)`` is a
  no-op, ``profile_to(dir)`` writes one Chrome trace holding the
  ``named_scope`` and ``annotate_step`` regions, and the per-step loop
  names each step ``pca_step``, as the reference's ``algo/online.py``.
- The estimator's ``fit(tracer=)``: one root ``estimator_fit`` span on a
  fresh ``fit`` trace, with the trainer that ran, as the reference's.
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.utils import telemetry as jtel
from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.utils import telemetry as tel
from distributed_eigenspaces_tpu_torch.utils import tracing

CPU = "cpu"


def _draws(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(-4.0, 1.5, n)
    if kind == "uniform":
        return rng.uniform(1e-5, 10.0, n)
    return np.concatenate([rng.exponential(1e-3, n // 2), rng.exponential(5.0, n - n // 2)])


@pytest.mark.parametrize("kind", ["lognormal", "uniform", "bimodal"])
@pytest.mark.parametrize("layout", [{}, dict(lo=1e-3, hi=1.0, growth=2.0)])
def test_histogram_is_the_references(kind, layout):
    values = _draws(kind, 2000, seed=len(kind))
    h, jh = tel.Histogram(**layout), jtel.Histogram(**layout)
    h.record_many(values)
    jh.record_many(values)
    assert h.bounds == jh.bounds and h.counts == jh.counts
    assert h.as_dict() == jh.as_dict()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    a, b = tel.Histogram(**layout), tel.Histogram(**layout)
    a.record_many(values[:700])
    b.record_many(values[700:])
    assert a.copy().merge(b).as_dict() == h.as_dict()


def test_histogram_refusals_are_the_references():
    for mod in (tel, jtel):
        with pytest.raises(ValueError, match="different bucket layouts"):
            mod.Histogram().merge(mod.Histogram(growth=2.0))
        with pytest.raises(ValueError, match="0 < lo < hi"):
            mod.Histogram(lo=-1.0)
        with pytest.raises(ValueError, match="q must be"):
            h = mod.Histogram()
            h.record(1.0)
            h.quantile(1.5)
        assert mod.Histogram().quantile(0.5) is None
        assert mod.Histogram().as_dict() == {"count": 0, "sum": 0.0}


def test_ring_log_is_the_references():
    got, want = [], []
    r = tel.RingLog(retention=3, on_evict=got.append)
    jr = jtel.RingLog(retention=3, on_evict=want.append)
    for i in range(8):
        r.append({"i": i})
        jr.append({"i": i})
    assert list(r) == list(jr) and got == want == [{"i": i} for i in range(5)]
    assert (len(r), r.evicted, r[0], bool(r)) == (len(jr), jr.evicted, jr[0], bool(jr))
    r.clear()
    assert not r and r.evicted == 5
    for mod in (tel, jtel):
        with pytest.raises(ValueError, match="retention"):
            mod.RingLog(retention=0)


@pytest.mark.parametrize("kw", [
    dict(target_p99_ms=50.0, latencies_ms=list(np.linspace(1, 80, 200))),
    dict(target_p99_ms=5.0, latencies_ms=[1.0, 2.0, 3.0], evicted_requests=1000,
         evicted_violations=20),
    dict(target_p99_ms=5.0, latencies_ms=[], evicted_requests=10, evicted_violations=1),
    dict(target_p99_ms=5.0, latencies_ms=[], p99_ms=4.0),
    dict(target_p99_ms=10.0, latencies_ms=[9.0, 11.0], objective=0.9),
])
def test_slo_summary_is_the_references(kw):
    assert tel.slo_summary(**kw) == jtel.slo_summary(**kw)


def test_profile_to_none_is_a_no_op(tmp_path):
    before = set(os.listdir(tmp_path))
    with tracing.profile_to(None):
        torch.ones(4).sum()
    assert set(os.listdir(tmp_path)) == before


def test_profile_to_writes_a_chrome_trace_with_the_regions(tmp_path):
    log_dir = tmp_path / "trace"
    with tracing.profile_to(str(log_dir)):
        with tracing.annotate_step(3), tracing.named_scope("det_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pca_step", "det_region"} <= names


def test_per_step_loop_names_each_step(monkeypatch):
    """The per-step trainer enters ``annotate_step(t)`` once a step, t from
    1, as the reference's loop does."""
    from distributed_eigenspaces_tpu_torch.algo import online

    seen = []
    real = online.annotate_step

    def spy(t):
        seen.append(t)
        return real(t)

    monkeypatch.setattr(online, "annotate_step", spy)
    cfg = PCAConfig(dim=16, k=2, num_workers=2, rows_per_worker=16, num_steps=3,
                    solver="subspace")
    x = np.random.default_rng(0).standard_normal((3 * 32, 16)).astype(np.float32)
    OnlineDistributedPCA(cfg, device=CPU, trainer="step").fit(x)
    assert seen == [1, 2, 3]


def test_fit_tracer_records_one_root_span():
    base = dict(dim=16, k=2, num_workers=2, rows_per_worker=16, num_steps=3,
                solver="subspace")
    x = np.random.default_rng(1).standard_normal((3 * 32, 16)).astype(np.float32)
    out = {}
    for name, est, tr in (
        ("port", OnlineDistributedPCA(PCAConfig(**base), device=CPU), tel.Tracer()),
        ("ref", JaxPCA(JaxConfig(**base)), jtel.Tracer()),
    ):
        assert est.fit(x, tracer=tr) is est
        spans = tr.snapshot()
        assert [s.name for s in spans] == ["estimator_fit"]
        sp = spans[0]
        out[name] = (sp.category, sp.trace_id.split("-")[0], sp.parent_id,
                     {k: v for k, v in sp.attrs.items() if k != "trainer"},
                     sp.attrs["trainer"] == est.trainer_used_)
    assert out["port"] == out["ref"]
    assert out["port"][1] == "fit" and out["port"][4]
    # no tracer: nothing recorded, the fit unchanged
    est = OnlineDistributedPCA(PCAConfig(**base), device=CPU)
    est.fit(x)
    assert est.components_.shape == (16, 2)
