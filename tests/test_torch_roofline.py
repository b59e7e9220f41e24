"""The port's roofline (``utils/roofline.py``) and collective byte model
(``analysis/hlo.py``) against the reference's.

The FLOP and byte models equal the reference's integer for integer over a
grid of shapes that covers both solver routes (the streaming matvec and the
Gram) and both states (dense and rank-r); the consistency check of a
differenced timing, ``roofline_fields`` (its ``bound`` tri-state and the
failed-probe record) and the ICI block equal the reference's on fixed
inputs. The anchors run on the CPU here (``device="cpu"``) and raise
without a card otherwise; their rates are measured on the card only.
"""

import itertools

import pytest
import torch

from distributed_eigenspaces_tpu.analysis import hlo as jhlo
from distributed_eigenspaces_tpu.utils import roofline as jroof
from distributed_eigenspaces_tpu_torch.analysis import hlo
from distributed_eigenspaces_tpu_torch.utils import roofline as roof

#: (m, n, d, k, cold iters, warm iters): the eval configs at full size and
#: shapes on either side of the route rule (d >= 4096, 2 k iters < d,
#: iters <= 6)
SHAPES = [
    (8, 1024, 3072, 10, 12, 2), (8, 2048, 1024, 5, 12, 2), (8, 1024, 784, 20, 16, 2),
    (4, 2048, 12288, 50, 12, 1), (8, 2048, 768, 256, 8, 2), (8, 2048, 768, 256, 8, None),
    (4, 128, 256, 8, 12, None), (2, 64, 4096, 3, 40, 7), (3, 100, 100, 10, 6, 6),
    (3, 100, 121, 10, 6, 6), (1, 1, 1, 1, 1, 1), (16, 512, 4095, 64, 7, 3),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flop_and_byte_models_are_the_references(shape):
    m, n, d, k, cold, warm = shape
    assert roof.step_flop_model(m, n, d, k, cold, warm) == \
        jroof.step_flop_model(m, n, d, k, cold, warm)
    for itemsize, state in itertools.product((1, 2, 4), ("dense", "lowrank")):
        assert roof.step_byte_model(m, n, d, k, cold, warm, itemsize=itemsize, state=state) \
            == jroof.step_byte_model(m, n, d, k, cold, warm, itemsize=itemsize, state=state)
    model = roof.step_flop_model(m, n, d, k, cold, warm)
    for steps in (0, 1, 20, 240):
        assert roof.fit_total_flops(model, steps) == jroof.fit_total_flops(model, steps)


def test_the_grid_covers_both_routes():
    """Some shapes stream and some take the Gram, cold and warm."""
    routes = set()
    for m, n, d, k, cold, warm in SHAPES:
        for iters in (cold, warm):
            if iters is not None:
                routes.add(roof.step_flop_model(m, n, d, k, iters, None)["cold_flops_per_step"]
                           == m * iters * 4 * n * d * k)
    assert routes == {True, False}


#: roofline_fields inputs: each bound verdict, a failed probe with and
#: without its record, a suspect anchor, the warm / cold extras
FIELDS = [
    dict(steps=20, fit_seconds=0.5, anchor_tflops=500.0,
         byte_model={"cold_bytes_per_step": 4e9, "warm_bytes_per_step": 6e10},
         hbm_anchor_gbps=3000.0),  # hbm
    dict(steps=240, fit_seconds=0.01, anchor_tflops=50.0,
         byte_model={"cold_bytes_per_step": 10, "warm_bytes_per_step": 10},
         hbm_anchor_gbps=3000.0),  # mxu
    dict(steps=240, fit_seconds=3.0, anchor_tflops=800.0,
         byte_model={"cold_bytes_per_step": 1e6, "warm_bytes_per_step": 1e6},
         hbm_anchor_gbps=3000.0),  # latency
    dict(steps=20, fit_seconds=0.5, anchor_tflops=500.0,
         byte_model={"cold_bytes_per_step": 1e9, "warm_bytes_per_step": 1e9},
         hbm_anchor_gbps=float("nan"),
         hbm_probe_record={"failed_check": "estimates_disagree_2x",
                           "attempts": [{"mb": 256, "seconds": [1, 2, 3]}]}),
    dict(steps=20, fit_seconds=0.5, byte_model={"cold_bytes_per_step": 1,
                                                "warm_bytes_per_step": 1},
         hbm_anchor_gbps=float("nan")),  # failed, no record, no flop anchor
    dict(steps=20, fit_seconds=0.001, anchor_tflops=500.0,
         byte_model={"cold_bytes_per_step": 1e10, "warm_bytes_per_step": 1e10},
         hbm_anchor_gbps=100.0),  # suspect
    dict(steps=10, fit_seconds=1.0, warm_seconds_per_step=0.01, cold_seconds=0.2,
         anchor_tflops=100.0),
    dict(steps=1, fit_seconds=1.0),
]


@pytest.mark.parametrize("kw", FIELDS, ids=lambda kw: str(sorted(kw)))
def test_roofline_fields_are_the_references(kw):
    model = roof.step_flop_model(8, 1024, 3072, 10, 12, 2)
    got = roof.roofline_fields(model, **kw)
    assert got == jroof.roofline_fields(model, **kw)


def test_bound_tri_state_and_failed_probe():
    model = roof.step_flop_model(8, 1024, 3072, 10, 12, 2)
    bounds = [roof.roofline_fields(model, **kw).get("bound") for kw in FIELDS[:3]]
    assert bounds == ["hbm", "mxu", "latency"]
    failed = roof.roofline_fields(model, **FIELDS[3])
    assert failed["hbm_probe_failed"] is True and "bound" not in failed
    assert failed["hbm_probe"]["failed_check"] == "estimates_disagree_2x"
    assert roof.roofline_fields(model, **FIELDS[5])["hbm_anchor_suspect"] is True


@pytest.mark.parametrize("times,want", [
    ((1.0, 2.0, 3.0), "ok"), ((1.0, 0.9, 2.0), "nonpositive_marginal"),
    ((1.0, 2.0, 5.0), "estimates_disagree_2x"), ((0.01, 0.0150, 0.0201), "ok"),
])
def test_consistent_marginal_is_the_references(times, want):
    def timed(count, lengths=(24, 48, 72)):
        return times[lengths.index(count)]

    got = roof._consistent_marginal_diag(timed, 24, 2)
    ref = jroof._consistent_marginal_diag(timed, 24, 2)
    assert got[1] == ref[1] and (got[0] == ref[0] or (got[0] != got[0] and ref[0] != ref[0]))
    assert got[1].get("failed_check", "ok") == want
    assert roof._consistent_marginal(timed, 24, 2) == got[0] or got[0] != got[0]


def test_hbm_probe_retries_and_records(monkeypatch):
    """Every size failing its check: no rate, the attempts of each size and
    the last failed check (the reference's record), whatever the device."""
    def factory(mb, device="cuda"):
        return lambda count: {6: 1.0, 12: 0.5, 18: 2.0}[count]

    monkeypatch.setattr(roof, "_hbm_timed_factory", factory)
    out = roof.measure_hbm_anchor_probe(small=True, device="cpu")
    assert out["gb_per_sec"] is None and out["failed_check"] == "nonpositive_marginal"
    assert [a["mb"] for a in out["attempts"]] == [32, 16, 8]
    assert roof.measure_hbm_anchor(small=True, device="cpu") != \
        roof.measure_hbm_anchor(small=True, device="cpu")  # NaN


def test_anchors_measure_on_the_cpu_when_asked():
    assert roof.measure_matmul_anchor(size=128, chain=12, device="cpu") > 0
    out = roof.measure_hbm_anchor_probe(sizes_mb=[4], base=2, device="cpu")
    assert [a["mb"] for a in out["attempts"]] == [4]
    assert out["attempts"][0]["chain_lengths"] == [2, 4, 6]
    assert out["gb_per_sec"] is None or out["gb_per_sec"] > 0


def test_anchors_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        roof.measure_matmul_anchor()
    with pytest.raises(RuntimeError, match="cuda"):
        roof.measure_hbm_anchor_probe(small=True)


@pytest.mark.parametrize("m,d,k,w,f", [(8, 784, 20, 2, 1), (8, 784, 20, 8, 1),
                                      (4, 12288, 50, 4, 2), (8, 768, 256, 1, 1),
                                      (4, 12288, 50, 1, 4)])
def test_ici_model_is_the_references(m, d, k, w, f):
    got = hlo.ici_step_model(m, d, k, n_workers_mesh=w, n_feature_shards=f)
    assert got == jhlo.ici_step_model(m, d, k, n_workers_mesh=w, n_feature_shards=f)
    proj = hlo.scaling_projection(m, d, k, step_seconds=0.004, n_workers_mesh=w,
                                  n_feature_shards=f)
    assert proj["assumed_ici_gb_per_sec"] == hlo.NVLINK_GB_PER_SEC == 450.0
    # at the same assumed rate the projection is the reference's
    assert proj == jhlo.scaling_projection(m, d, k, step_seconds=0.004, n_workers_mesh=w,
                                           n_feature_shards=f, ici_gbps=450.0)
    assert hlo.scaling_projection(m, d, k, step_seconds=0.0, n_workers_mesh=w) \
        ["collective_fraction_of_step"] is None
