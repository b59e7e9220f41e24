"""The port's trainer choice and whole-fit staging against the reference's.

``choose_trainer`` of both packages over a grid of (T, m, n, d, stage dtype,
backend) that straddles the 2 GiB staging budget; ``fit`` refusing, before
it touches the data, every schedule the reference would run segmented; and
the whole fit, staged into one preallocated ``(T, m, n, d)`` tensor, equal
bit for bit to the same fit on a stack of the streamed blocks.
"""

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
        raise AssertionError("the fit read the data before refusing")

    def __getitem__(self, item):
        raise AssertionError("the fit read the data before refusing")

    def __array__(self, *a, **kw):
        raise AssertionError("the fit read the data before refusing")


@pytest.mark.parametrize("trainer", ["auto", "scan"])
@pytest.mark.parametrize("case", [c for c in GRID if c[-1] == "local"
                                  and (c[0] * c[1] * c[2] * c[3]
                                       * {"bfloat16": 2, "int8": 1}.get(c[5], 4)) > GIB2],
                         ids=lambda c: "-".join(map(str, c)))
def test_fit_refuses_where_the_reference_goes_segmented(case, trainer):
    cfg, jcfg = _cfgs(*case)
    assert jest.choose_trainer(jcfg) == "segmented"
    est = pest.OnlineDistributedPCA(cfg, device="cpu", trainer=trainer)
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 9e"):
        est.fit(_Untouchable())
    assert est.state is None and est.trainer_used_ is None


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
