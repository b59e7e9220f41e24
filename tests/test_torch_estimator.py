"""The port's trainer choice and whole-fit routes against the reference's.

``choose_trainer`` of both packages (with and without checkpointing) over a
grid of (T, m, n, d, stage dtype, backend) that straddles the 2 GiB staging
budget; ``fit`` routing every schedule the reference runs segmented as the
reference does, before it touches the data; the whole fit, staged into one
preallocated ``(T, m, n, d)`` tensor, equal bit for bit to the same fit on
a stack of the streamed blocks; and the routes of the segmented trainer,
checkpoints, mask sequences and the steady-state knobs through the
estimator, each against the JAX estimator on the same data (``sigma_tilde``
within 1e-4, components within 0.05 degrees), with the reference's
``ValueError``s word for word.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.api import estimator as jest
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.scan import make_scan_fit
from distributed_eigenspaces_tpu_torch.api import estimator as pest
from distributed_eigenspaces_tpu_torch.api.runner import extract_dense
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data import stream as tstream
from distributed_eigenspaces_tpu_torch.data import synthetic as tsyn

GIB2 = 1 << 31

# (T, m, n, d, k, stage dtype, backend): per-step bytes x T on both sides of
# 2 GiB; None stages in the compute dtype (bf16 here); int8 counts 1 byte
# an element
GRID = [
    (128, 8, 1024, 1024, 8, "bfloat16", "local"),   # exactly 2 GiB: scan
    (129, 8, 1024, 1024, 8, "bfloat16", "local"),   # one step over
    (64, 8, 1024, 1024, 8, "float32", "local"),     # exactly 2 GiB at fp32
    (65, 8, 1024, 1024, 8, "float32", "local"),
    (128, 8, 1024, 1024, 8, "float32", "local"),    # bf16's budget, fp32's double
    (42, 8, 1024, 3072, 10, None, "auto"),          # CIFAR shape, 2016 MiB
    (43, 8, 1024, 3072, 10, None, "auto"),          # 2064 MiB
    (20, 8, 1024, 3072, 10, "float32", "auto"),     # the smoke fit at fp32
    (10, 4, 2048, 12288, 50, "bfloat16", "local"),  # the large-d cell, 1.875 GiB
    (10, 4, 2048, 12288, 50, "float32", "local"),   # 3.75 GiB
    (10, 4, 2048, 12288, 50, "bfloat16", "auto"),   # feature-sharded, sketch
    (40, 4, 2048, 8192, 4, "float32", "auto"),      # feature-sharded scan, any size
    (1, 1, 1 << 20, 1024, 8, "float32", "local"),   # 4 GiB in one step
    (3, 2, 64, 96, 4, None, "local"),
    (256, 8, 1024, 1024, 8, "int8", "local"),       # exactly 2 GiB at int8
    (257, 8, 1024, 1024, 8, "int8", "local"),       # one step over
    (85, 8, 1024, 3072, 10, "int8", "auto"),        # the cifar10 eval's stage, 2040 MiB
    (86, 8, 1024, 3072, 10, "int8", "auto"),        # 2064 MiB
    (20, 8, 1024, 3072, 10, "int8", "auto"),        # the eval's own T
    (10, 4, 2048, 12288, 50, "int8", "local"),      # imagenet12288's stage, 0.94 GiB
]


def _cfgs(T, m, n, d, k, stage, backend):
    kw = dict(dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=T,
              compute_dtype="bfloat16", stage_dtype=stage, backend=backend)
    return PCAConfig(**kw), JaxConfig(**kw)


@pytest.mark.parametrize("hooks", [False, True])
@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(map(str, c)))
def test_choose_trainer_matches_the_reference(case, hooks):
    cfg, jcfg = _cfgs(*case)
    want = jest.choose_trainer(jcfg, per_step_hooks=hooks)
    assert pest.choose_trainer(cfg, per_step_hooks=hooks) == want
    if not hooks and not pest.resolves_feature_sharded(cfg):
        assert (want == "segmented") == (pest.staged_bytes(cfg) > GIB2)
    assert pest.SCAN_STAGE_BYTES_MAX == jest.SCAN_STAGE_BYTES_MAX == GIB2


class _Untouchable:
    """Data that fails the test if the fit reads it at all."""

    def __len__(self):
        raise AssertionError("the fit read the data before routing")

    def __getitem__(self, item):
        raise AssertionError("the fit read the data before routing")

    def __array__(self, *a, **kw):
        raise AssertionError("the fit read the data before routing")


@pytest.mark.parametrize("trainer", ["auto", "scan"])
@pytest.mark.parametrize("case", [c for c in GRID if c[-1] == "local"
                                  and (c[0] * c[1] * c[2] * c[3]
                                       * {"bfloat16": 2, "int8": 1}.get(c[5], 4)) > GIB2],
                         ids=lambda c: "-".join(map(str, c)))
def test_fit_refuses_where_the_reference_goes_segmented(case, trainer, monkeypatch):
    """Where the reference goes segmented (a staged schedule over 2 GiB),
    the port's fit routes as the reference's does, before it reads the
    data: ``"auto"`` to the segmented trainer, an explicit ``"scan"`` to
    the scan. (Until the segmented trainer was ported, the port refused
    these fits.)"""
    cfg, jcfg = _cfgs(*case)
    assert jest.choose_trainer(jcfg) == "segmented"
    routed = {}
    monkeypatch.setattr(jest.OnlineDistributedPCA, "_fit_whole",
                        lambda self, data, tr, worker_masks=None: routed.setdefault("jax", tr))
    jest.OnlineDistributedPCA(jcfg, trainer=trainer).fit(_Untouchable())
    for route in ("_fit_segmented", "_fit_scan"):
        monkeypatch.setattr(pest.OnlineDistributedPCA, route,
                            lambda self, data, masks, route=route:
                            routed.setdefault("port", route))
    est = pest.OnlineDistributedPCA(cfg, device="cpu", trainer=trainer)
    est.fit(_Untouchable())
    want = "segmented" if trainer == "auto" else "scan"
    assert routed == {"jax": want, "port": f"_fit_{want}"}
    assert est.trainer_used_ == want and est.state is None


@pytest.mark.parametrize(
    "n_rows,num_steps,remainder",
    [(4 * 64 * 3, 3, "drop"), (4 * 64 * 3 + 100, 5, "pad"), (4 * 64 * 5, 3, "drop"),
     (4 * 64 * 2 + 7, 6, "drop"), (4 * 64 * 2 + 7, 6, "pad")],
)
def test_staged_fit_equals_a_stack_of_the_stream(n_rows, num_steps, remainder):
    """The fit stages into one preallocated tensor; the result equals, bit
    for bit, the scan over ``torch.stack`` of the streamed blocks."""
    d, k, m, n = 48, 3, 4, 64
    cfg = PCAConfig(dim=d, k=k, num_workers=m, rows_per_worker=n,
                    num_steps=num_steps,
                    remainder=remainder, solver="subspace", subspace_iters=8)
    data = tsyn.planted_spectrum(d, k_planted=k, seed=3).sample(
        np.random.default_rng(4), n_rows).astype(np.float32)
    est = pest.OnlineDistributedPCA(cfg, device="cpu").fit(data)
    blocks = list(tstream.block_stream(
        data, num_workers=m, rows_per_worker=n, num_steps=cfg.num_steps,
        remainder=remainder, dtype=cfg.resolved_stage_dtype(), device="cpu"))
    assert len(blocks) == tstream.count_steps(n_rows, m * n, num_steps=cfg.num_steps,
                                              remainder=remainder)
    state, _ = make_scan_fit(cfg, device="cpu", v0=est.v0)(
        OnlineState.initial(d, cfg.state_dtype, device="cpu"), torch.stack(blocks))
    assert est.trainer_used_ == "scan" and est.state.step == len(blocks)
    assert torch.equal(est.state.sigma_tilde, state.sigma_tilde)
    assert torch.equal(est.components_, extract_dense(cfg, state.sigma_tilde, v0=est.v0))


@pytest.mark.parametrize("remainder", ["drop", "pad", "error"])
@pytest.mark.parametrize("n_total,num_steps", [(40, None), (40, 2), (40, 9), (32, None),
                                               (8, 4), (47, 5)])
def test_count_steps_counts_the_stream(n_total, num_steps, remainder):
    data = np.arange(n_total * 3, dtype=np.float32).reshape(n_total, 3)
    kw = dict(num_workers=2, rows_per_worker=4, num_steps=num_steps, remainder=remainder)
    got = tstream.count_steps(n_total, 8, num_steps=num_steps, remainder=remainder)
    try:
        want = len(list(tstream.block_stream(data, device="cpu", **kw)))
    except ValueError:  # "error" on a partial step: the stream raises there
        assert remainder == "error" and n_total % 8
        want = n_total // 8
    assert got == want


def test_fit_with_too_few_rows_names_both_counts():
    cfg = PCAConfig(dim=8, k=2, num_workers=2, rows_per_worker=16, num_steps=2)
    with pytest.raises(ValueError, match="one step needs 32"):
        pest.OnlineDistributedPCA(cfg, device="cpu").fit(np.zeros((20, 8), np.float32))


# -- the whole-fit routes of this slice: segmented, checkpointed, masked ----

SMALL = dict(dim=32, k=3, num_workers=4, rows_per_worker=64, num_steps=6,
             solver="subspace", subspace_iters=12, warm_start_iters=2, backend="local")
SIGMA_ATOL = 1e-4
ANGLE_DEG = 0.05


def _jv0(d=32, k=3):
    import jax
    import jax.numpy as jnp

    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))


def _small_data(n_rows=4 * 64 * 6, seed=0):
    return tsyn.planted_spectrum(32, k_planted=3, seed=seed).sample(
        np.random.default_rng(seed + 1), n_rows).astype(np.float32)


def _angle(a, b):
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    return float(principal_angles_degrees(torch.as_tensor(np.array(a, np.float32)),
                                          torch.as_tensor(np.array(b, np.float32))).max())


def _same_fit(est, jest_):
    assert est.trainer_used_ == jest_.trainer_used_
    assert int(est.state.step) == int(jest_.state.step)
    np.testing.assert_allclose(est.state.sigma_tilde.numpy(),
                               np.asarray(jest_.state.sigma_tilde), atol=SIGMA_ATOL, rtol=0)
    assert _angle(est.components_, np.asarray(jest_.components_)) <= ANGLE_DEG


@pytest.mark.parametrize("checkpointing", [False, True])
@pytest.mark.parametrize("hooks", [False, True])
@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(map(str, c)))
def test_choose_trainer_with_checkpointing_matches_the_reference(case, hooks, checkpointing):
    cfg, jcfg = _cfgs(*case)
    want = jest.choose_trainer(jcfg, per_step_hooks=hooks, checkpointing=checkpointing)
    assert pest.choose_trainer(cfg, per_step_hooks=hooks, checkpointing=checkpointing) == want
    assert pest._budget_steps(cfg) == jest._budget_steps(jcfg)


@pytest.mark.parametrize("budget_steps", [1, 2, 4])
def test_oversized_schedule_runs_segmented_in_both_packages(budget_steps, monkeypatch):
    """With the staging budget patched down to ``budget_steps`` steps, the
    6-step schedule is "oversized": both packages take the segmented
    trainer, in windows of at most ``budget_steps``, and agree."""
    cfg = PCAConfig(**SMALL)
    budget = budget_steps * pest._step_bytes(cfg)
    monkeypatch.setattr(pest, "SCAN_STAGE_BYTES_MAX", budget)
    monkeypatch.setattr(jest, "SCAN_STAGE_BYTES_MAX", budget)
    data = _small_data()
    jfit = jest.OnlineDistributedPCA(JaxConfig(**SMALL)).fit(data)
    windows = []
    real = pest.make_whole_fit

    def spy(cfg_, kind, **kw):
        h = real(cfg_, kind, **kw)
        inner = h.fit_windows

        def fit_windows(state, ws, **kw2):
            return inner(state, (windows.append(int(w.shape[0])) or w for w in ws), **kw2)

        return dataclasses.replace(h, fit_windows=fit_windows)

    monkeypatch.setattr(pest, "make_whole_fit", spy)
    est = pest.OnlineDistributedPCA(cfg, device="cpu", v0=_jv0()).fit(data)
    assert est.trainer_used_ == jfit.trainer_used_ == "segmented"
    assert max(windows) == budget_steps and sum(windows) == 6
    _same_fit(est, jfit)


@pytest.mark.parametrize("segment", [2, 4])
def test_checkpointed_fit_is_segmented_and_equals_the_scan(segment, tmp_path):
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer

    cfg = PCAConfig(**SMALL)
    data = _small_data()
    est = pest.OnlineDistributedPCA(cfg, device="cpu", v0=_jv0(),
                                    checkpoint_dir=str(tmp_path), segment=segment).fit(data)
    scan = pest.OnlineDistributedPCA(cfg, device="cpu", v0=_jv0()).fit(data)
    assert (est.trainer_used_, scan.trainer_used_) == ("segmented", "scan")
    assert torch.equal(est.state.sigma_tilde, scan.state.sigma_tilde)
    ends = sorted({*range(segment, 6, segment), 6})
    ck = Checkpointer(str(tmp_path), device="cpu")
    assert ck._steps() == ends[-2:]
    state, cursor = ck.latest()
    assert state.step == 6 and cursor == 6 * 4 * 64
    assert torch.equal(state.sigma_tilde, est.state.sigma_tilde)
    jfit = jest.OnlineDistributedPCA(JaxConfig(**SMALL), checkpoint_dir=str(tmp_path / "j"),
                                     segment=segment).fit(data)
    _same_fit(est, jfit)


MASKS = np.array([[1, 1, 1, 1], [0, 0, 0, 0], [1, 0, 1, 1], [1, 1, 1, 1],
                  [0, 1, 1, 0], [1, 1, 1, 1], [1, 1, 1, 1]], np.float32)


@pytest.mark.parametrize("spelling", ["ndarray", "list", "tuple", "tensor"])
@pytest.mark.parametrize("checkpointing", [False, True])
def test_mask_sequence_runs_the_masked_whole_fit(checkpointing, spelling, tmp_path):
    """A ``(T, m)`` mask sequence (surplus rows ignored) takes the masked
    whole fit, scan or segmented as checkpointing says, in both packages."""
    masks = {"ndarray": MASKS, "list": MASKS.tolist(), "tuple": tuple(map(tuple, MASKS)),
             "tensor": torch.from_numpy(MASKS)}[spelling]
    kw = dict(checkpoint_dir=str(tmp_path / "p"), segment=4) if checkpointing else {}
    data = _small_data()
    est = pest.OnlineDistributedPCA(PCAConfig(**SMALL), device="cpu", v0=_jv0(), **kw)
    est.fit(data, worker_masks=masks)
    jkw = dict(checkpoint_dir=str(tmp_path / "j"), segment=4) if checkpointing else {}
    jfit = jest.OnlineDistributedPCA(JaxConfig(**SMALL), **jkw).fit(data, worker_masks=MASKS)
    assert est.trainer_used_ == ("segmented" if checkpointing else "scan")
    _same_fit(est, jfit)
    step = pest.OnlineDistributedPCA(PCAConfig(**SMALL), device="cpu", v0=_jv0(),
                                     trainer="step").fit(data, worker_masks=MASKS)
    np.testing.assert_allclose(est.state.sigma_tilde.numpy(), step.state.sigma_tilde.numpy(),
                               atol=SIGMA_ATOL, rtol=0)


def test_mask_generator_keeps_the_per_step_loop():
    data = _small_data()
    est = pest.OnlineDistributedPCA(PCAConfig(**SMALL), device="cpu", v0=_jv0())
    est.fit(data, worker_masks=iter(MASKS))
    jfit = jest.OnlineDistributedPCA(JaxConfig(**SMALL, prefetch_depth=0)).fit(
        data, worker_masks=iter(MASKS))
    assert est.trainer_used_ == "step"
    _same_fit(est, jfit)


@pytest.mark.parametrize("name", ["short", "wrong_width"])
def test_bad_mask_sequences_raise_like_the_reference(name):
    masks = MASKS[:3] if name == "short" else np.ones((6, 3), np.float32)
    data = _small_data()
    with pytest.raises(ValueError, match="worker_masks") as jerr:
        jest.OnlineDistributedPCA(JaxConfig(**SMALL)).fit(data, worker_masks=masks)
    with pytest.raises(ValueError, match="worker_masks") as err:
        pest.OnlineDistributedPCA(PCAConfig(**SMALL), device="cpu").fit(
            data, worker_masks=masks)
    assert str(err.value) == str(jerr.value)


def _refusals():
    """(name, config kwargs, estimator kwargs, fit kwargs) of every fit the
    reference refuses with a ValueError before it runs."""
    gen = lambda: iter(MASKS)  # noqa: E731
    hook = lambda t, s, v: None  # noqa: E731
    return [
        ("pipeline_with_checkpoint", dict(pipeline_merge=True),
         dict(checkpoint_dir="CKPT"), {}),
        ("checkpoint_on_explicit_step", {}, dict(checkpoint_dir="CKPT", trainer="step"), {}),
        ("checkpoint_on_hooks", {}, dict(checkpoint_dir="CKPT"), dict(on_step=hook)),
        ("checkpoint_on_mask_generator", {}, dict(checkpoint_dir="CKPT"),
         dict(worker_masks=gen)),
        ("checkpoint_on_explicit_scan", {}, dict(checkpoint_dir="CKPT", trainer="scan"), {}),
        ("hooks_on_whole_fit", {}, dict(trainer="scan"), dict(on_step=hook)),
        ("hooks_on_segmented", {}, dict(trainer="segmented"), dict(on_step=hook)),
        ("mask_generator_on_scan", {}, dict(trainer="scan"), dict(worker_masks=gen)),
        ("mask_generator_on_segmented", {}, dict(trainer="segmented"),
         dict(worker_masks=gen)),
    ]


@pytest.mark.parametrize("name,cfg_kw,est_kw,fit_kw", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_fit_refusals_match_the_reference(name, cfg_kw, est_kw, fit_kw, tmp_path):
    est_kw = {k: (str(tmp_path) if v == "CKPT" else v) for k, v in est_kw.items()}
    fit_kw = {k: (v() if k == "worker_masks" else v) for k, v in fit_kw.items()}
    jfit_kw = {k: (iter(MASKS) if k == "worker_masks" else v) for k, v in fit_kw.items()}
    with pytest.raises(ValueError) as jerr:
        jest.OnlineDistributedPCA(JaxConfig(**SMALL, **cfg_kw), **est_kw).fit(
            _Untouchable(), **jfit_kw)
    with pytest.raises(ValueError) as err:
        pest.OnlineDistributedPCA(PCAConfig(**SMALL, **cfg_kw), device="cpu", **est_kw).fit(
            _Untouchable(), **fit_kw)
    assert str(err.value) == str(jerr.value)
    assert not any(tmp_path.iterdir())


def test_interval_and_pipelined_fits_through_the_estimator():
    data = _small_data()
    for kw in (dict(merge_interval=2), dict(merge_interval=2, pipeline_merge=True),
               dict(pipeline_merge=True)):
        est = pest.OnlineDistributedPCA(PCAConfig(**SMALL, **kw), device="cpu",
                                        v0=_jv0()).fit(data)
        jfit = jest.OnlineDistributedPCA(JaxConfig(**SMALL, **kw)).fit(data)
        _same_fit(est, jfit)
