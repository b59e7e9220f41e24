"""The profiling scripts' copies of the kernel sources, checked as text on the
CPU: every variant's edits apply to the source as it stands (each anchor
found exactly once), so a script whose anchor moved with the kernel fails
here and not first on the card, where its copies are compiled. The fused
sweep's phase copies return before lines of the kernel found the same way."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_kernel_copies as kc  # noqa: E402
import torch_profile_gram  # noqa: E402
import torch_profile_gram_s8  # noqa: E402
import torch_profile_matvec_gram  # noqa: E402
import torch_profile_serve_f32  # noqa: E402
import torch_profile_serve_staging  # noqa: E402

CSRC = ROOT / "distributed_eigenspaces_tpu_torch" / "csrc"
UNCHANGED = {"kernel", "own_budget"}  # each script's baseline build

CASES = (
    [("gram", name, fn) for name, fn in torch_profile_gram.VARIANTS.items()]
    + [("gram_s8", name, fn) for name, fn in torch_profile_gram_s8.VARIANTS.items()]
    + [("matvec_gram", name, fn) for name, fn in torch_profile_matvec_gram.VARIANTS.items()]
    + [("serve_project", name, fn) for name, fn in torch_profile_serve_f32.VARIANTS.items()]
    + [("serve_project", "stage_tile", torch_profile_serve_staging.with_stage_tile)]
)


@pytest.mark.parametrize("source, name, variant", CASES,
                         ids=[f"{s}-{n}" for s, n, _ in CASES])
def test_variant_applies_to_the_source(source, name, variant):
    src = (CSRC / f"{source}.cu").read_text()
    out = variant(src)
    assert (out == src) == (name in UNCHANGED)


@pytest.mark.parametrize("mark", torch_profile_matvec_gram.MARKS)
def test_matvec_gram_phase_marks_are_in_the_source(mark):
    """The phase copies return before each of these lines of the kernel,
    so each must be there once, at the kernel's top level (two spaces in)."""
    src = (CSRC / "matvec_gram.cu").read_text()
    assert src.count(mark) == 1
    body = src[src.index("__global__ void __launch_bounds__(THREADS, 1) matvec_gram_kernel"):]
    assert mark in body and f"\n{mark}" in body


def test_edit_takes_exactly_one_occurrence():
    assert kc.edit("a b", "a", "c", "x.cu") == "c b"
    with pytest.raises(RuntimeError, match="no single text"):
        kc.edit("a a", "a", "c", "x.cu")
    with pytest.raises(RuntimeError, match="no single text"):
        kc.edit("a b", "d", "c", "x.cu")


def test_stage_tile_copy_keeps_the_fp32_basis_on_stage_cols():
    """The vector staging rounds to bf16 and has no fp32 ``BasisVec``; the
    source instantiates ``serve_split_kernel`` for the fp32 basis too, so
    the copy's dispatch must keep ``stage_tile`` out of those."""
    src = (CSRC / "serve_project.cu").read_text()
    assert "serve_split_kernel<float, kF32" in src or "split_by_dtype<kF32>" in src
    out = torch_profile_serve_staging.with_stage_tile(src)
    assert "struct BasisVec<kF32>" not in out
    stage = out[out.index("void stage(uint32_t* vs"):]
    stage = stage[:stage.index("\n}\n")]
    gate = stage.index("if constexpr (B != kF32)")
    assert stage.index("stage_tile<B, NP, VEC>") > gate
    assert out.count("stage_tile<B, NP, VEC>(") == 1  # the dispatch's call only


def test_smoke_ab_alternates_the_sides():
    import torch_smoke_ab as ab

    assert ab.order(5) == ["parent", "change", "change", "parent", "parent",
                           "change", "change", "parent", "parent", "change"]
    assert ab.order(1) == ["parent", "change"]


def test_smoke_ab_reads_each_fit_from_its_phase_line():
    import json

    import torch_smoke_ab as ab

    lines = [
        "NVIDIA H100 80GB HBM3, 700.00 W",
        json.dumps({"phase": "slice_fit", "fit_s": 0.2, "second_fit_s": 0.13}),
        json.dumps({"phase": "slice_fit_eval", "eval": "cifar10", "second_fit_s": 0.12}),
        json.dumps({"phase": "slice_fit_eval", "eval": "synthetic1024", "second_fit_s": 0.1}),
        json.dumps({"phase": "slice_dsolve", "part": "extract", "extract_s": 0.02}),
        json.dumps({"phase": "slice_dsolve", "part": "fit", "second_fit_s": 0.24}),
        json.dumps({"phase": "slice_fit_interval", "knobs": {"merge_interval": 2},
                    "fit_s": 0.11}),
        json.dumps({"phase": "slice_fit_interval",
                    "knobs": {"merge_interval": 2, "pipeline_merge": True}, "fit_s": 0.12}),
        '{"ok": true}',
    ]
    got = ab.fit_seconds(lines)
    assert got == {"slice_fit": 0.13, "cifar10": 0.12, "synthetic1024": 0.1,
                   "large_d": 0.24, "interval": 0.11, "pipelined": 0.12}
    rows = ab.summary({"parent": [got, {**got, "cifar10": 0.2}, {**got, "cifar10": 0.1}],
                       "change": [got]})
    cifar = [r for r in rows if r["fit"] == "cifar10"]
    assert [(r["side"], r["median_s"], r["min_s"], r["max_s"]) for r in cifar] == [
        ("parent", 0.12, 0.1, 0.2), ("change", 0.12, 0.12, 0.12)]
