"""FLOP and byte accounting plus measured anchors: the roofline block of an
eval report.

Counterpart of ``distributed_eigenspaces_tpu/utils/roofline.py``. The
models (:func:`step_flop_model`, :func:`fit_total_flops`,
:func:`step_byte_model`), the consistency check of a differenced timing
(:func:`_consistent_marginal_diag`) and the report block
(:func:`roofline_fields`, with its ``bound`` verdict) are the reference's,
integer for integer. The two anchors are measured again, on the card:

- :func:`measure_matmul_anchor`: a dependent chain of bf16 ``torch.matmul``
  (fp32 accumulation) with the max-abs renormalisation, the achievable
  matmul rate in TF/s;
- :func:`measure_hbm_anchor_probe` / :func:`measure_hbm_anchor`: a chain of
  whole-buffer fp32 adds at three lengths, differenced, the achievable HBM
  rate in GB/s (read and write counted).

Both are fenced with ``torch.cuda.synchronize()``. The reference's two
corrections for its tunnelled development backend are dropped: it
subtracted a measured dispatch round trip (~100 ms there; a launch on the
card is microseconds and the differenced HBM probe cancels it anyway) and
salted every operand (that backend served a repeated (program, operands)
pair from a result cache without running it; the card runs every launch).
Both anchors run on the card and raise without one unless the caller passes
``device="cpu"``, as the tests do. For the card's datasheet peaks beside
them: 989 TFLOP/s dense bf16 and 3.35 TB/s HBM3 on an H100 SXM.
"""

from __future__ import annotations

import time

import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device

#: links between two max-abs renormalisations of the matmul chain: the
#: entries of its fixed operand are N(0, 1/size), so a link keeps a
#: column's norm on average, and ten links cannot leave bf16's range
_RENORM_EVERY = 10


def step_flop_model(
    m: int,
    n: int,
    d: int,
    k: int,
    cold_iters: int,
    warm_iters: int | None,
) -> dict:
    """Dominant-term FLOPs per online step for the subspace trainers.

    Both phases follow ``_local_eigenspaces``'s ACTUAL route dispatch
    (``worker_pool.py``): a solve streams (``iters * 4 n d k`` — two
    tall-skinny passes per iteration) when ``d >= 4096`` or
    ``2 k iters < d and iters <= 6``; otherwise it takes the Gram route
    (``2 n d^2`` + ``iters`` matvecs ``2 d^2 k``). Warm steps use the
    same rule at ``warm_iters`` — small-d/large-k configs (e.g. 768-d
    top-256) Gram even when warm, and a streaming-only warm formula
    would overcount their rate by ~``d / (2 k iters)``.

    Returns ``{"cold_flops_per_step", "warm_flops_per_step"}``; the warm
    entry equals the cold one when warm starts are off (every step runs
    the full count).
    """

    def per_step(iters: int) -> int:
        streams = d >= 4096 or (2 * k * iters < d and iters <= 6)
        if streams:
            return m * iters * 4 * n * d * k
        return m * (2 * n * d * d + iters * 2 * d * d * k)

    cold = per_step(cold_iters)
    warm = cold if warm_iters is None else per_step(warm_iters)
    return {"cold_flops_per_step": cold, "warm_flops_per_step": warm}


def fit_total_flops(model: dict, steps: int) -> int:
    """Model FLOPs of a whole fit: one cold step + (steps-1) warm steps."""
    return model["cold_flops_per_step"] + max(steps - 1, 0) * model[
        "warm_flops_per_step"
    ]


def _fence(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_matmul_anchor(size: int = 2048, chain: int = 100, *,
                          device="cuda") -> float:
    """Measured achievable bf16 matmul rate (TF/s) on ``device``: ``chain``
    dependent ``size^3`` bf16 matmuls (fp32 accumulation), fenced, the
    fastest of three runs after a warm-up.

    The chain is dependent (each matmul consumes the previous result), so
    nothing can be skipped or batched; a max-abs renormalisation every
    ten links keeps bf16 from overflowing over hundreds of links. Its
    passes run inside the timed region and its operations are not counted,
    so the anchor errs low."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    a = (torch.randn((size, size), generator=gen.manual_seed(0), device=dev)
         / size ** 0.5).to(torch.bfloat16)
    b = torch.randn((size, size), generator=gen.manual_seed(1),
                    device=dev).to(torch.bfloat16)

    def chained():
        x = b
        for i in range(chain):
            x = torch.matmul(a, x)
            if (i + 1) % _RENORM_EVERY == 0:
                x = x / x.abs().amax().clamp_min(1e-30)
        return x

    chained()
    _fence(dev)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        chained()
        _fence(dev)
        best = min(best, time.perf_counter() - t0)
    return (chain * 2 * size**3) / best / 1e12


def step_byte_model(
    m: int,
    n: int,
    d: int,
    k: int,
    cold_iters: int,
    warm_iters: int | None,
    itemsize: int = 2,
    state: str = "dense",
) -> dict:
    """Dominant-term HBM bytes per online step for the subspace trainers,
    following the SAME route dispatch as :func:`step_flop_model` (and the
    actual solver, ``worker_pool.py``); counting the X reads alone would
    undercount and leave ``pct_of_hbm_anchor`` quietly low:

    streaming route, per solver iteration:
      - X passes: the (m, n, d) block read TWICE (``X^T (X v)``),
        ``itemsize`` = the STAGED dtype (int8 staging halves this, the
        binding term);
      - the (m, n, k) ``Xv`` intermediate: one fp32 write + one read;
      - basis traffic: ~4 fp32 passes over (m, d, k) (matvec read +
        result write, orthonormalization read + write; the k x k
        Grams/Cholesky are O(k^2) — excluded).
    per step: the factor merge (~2 fp32 passes over (m, d, k)) and the
    state fold — ``state="dense"``: sigma_tilde read + write (2 d^2
    fp32, the dense scan/segmented trainers); ``state="lowrank"``: ~2
    passes over the rank-r carry (~(k+16)-wide — the feature-sharded /
    sketch trainers, where no d x d exists by design).

    Gram route: block read once + d x d Gram write (fp32, per worker) +
    one Gram read per matvec iteration + the same merge/fold terms.

    The byte twin of :func:`step_flop_model`, and the machine-readable
    reason an HBM-bound config cannot approach the FLOP anchor: its
    ceiling is the measured HBM rate instead.
    """
    block = m * n * d * itemsize
    merge = 2 * m * d * k * 4
    if state == "lowrank":
        fold = 2 * d * (k + 16) * 4
    else:
        fold = 2 * d * d * 4

    def per_step(iters: int) -> int:
        streams = d >= 4096 or (2 * k * iters < d and iters <= 6)
        if streams:
            per_iter = (
                block * 2          # the two tall-skinny X passes
                + 2 * m * n * k * 4  # Xv intermediate write + read
                + 4 * m * d * k * 4  # basis passes (matvec + orth)
            )
            return per_iter * iters + merge + fold
        return (
            block
            + m * (1 + iters) * d * d * 4  # Gram write + per-iter reads
            + merge + fold
        )

    return {
        "cold_bytes_per_step": per_step(cold_iters),
        "warm_bytes_per_step": (
            per_step(warm_iters) if warm_iters is not None
            else per_step(cold_iters)
        ),
    }


def _hbm_timed_factory(mb: int, device="cuda"):
    """One ``timed(count)`` closure for an ``mb``-MB add-chain probe:
    best of 3 fenced runs of ``count`` dependent whole-buffer fp32 adds,
    each reading one buffer and writing the other."""
    dev = resolve_device(device)
    n = mb * (1 << 20) // 4
    bufs = (torch.zeros((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev))

    def run(count):
        for i in range(count):
            torch.add(bufs[i % 2], 1.0, out=bufs[(i + 1) % 2])

    def timed(count):
        run(count)  # warm
        _fence(dev)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run(count)
            _fence(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    return timed


def measure_hbm_anchor_probe(
    sizes_mb: list[int] | None = None, base: int | None = None,
    ratio: int = 2, small: bool = False, *, device="cuda",
) -> dict:
    """The HBM-anchor probe with RETRY and a structured record (a bare
    ``hbm_probe_failed: true`` would leave a missing bandwidth verdict
    undiagnosable).

    Tries the consistency-checked differenced measurement at 2-3 buffer
    sizes (a jittery session often fails at one size and passes at
    another — smaller buffers run shorter programs with less exposure
    to the jitter window) and returns::

        {"gb_per_sec": float | None,      # None = every size failed
         "attempts": [{"mb", "chain_lengths", "seconds",
                       "est1_per_link_s", "est2_per_link_s",
                       "failed_check"?}, ...],
         "failed_check": str}             # only when gb_per_sec is None

    ``attempts`` carries the raw timings of every size tried, so a
    persistent failure in a recorded report is diagnosable (WHICH
    consistency check failed, against WHAT numbers) instead of a bare
    boolean. ``small=True`` is the ONE definition of the CI-shrunk
    preset (shared by bench.py and evals.py so their anchors stay
    comparable)."""
    if sizes_mb is None:
        sizes_mb = [32, 16, 8] if small else [256, 128, 64]
    if base is None:
        base = 6 if small else 24
    attempts: list[dict] = []
    for mb in sizes_mb:
        dt, diag = _consistent_marginal_diag(
            _hbm_timed_factory(mb, device), base, ratio
        )
        attempts.append({"mb": mb, **diag})
        if dt == dt and dt > 0:
            return {
                "gb_per_sec": 2 * mb * (1 << 20) / dt / 1e9,
                "attempts": attempts,
            }
    return {
        "gb_per_sec": None,
        "attempts": attempts,
        "failed_check": attempts[-1].get("failed_check", "unknown"),
    }


def measure_hbm_anchor(
    mb: int | None = None, base: int | None = None, ratio: int = 2,
    small: bool = False, *, device="cuda",
) -> float:
    """Measured achievable HBM streaming rate (GB/s, read+write counted):
    a dependent chain of whole-array adds over an fp32 buffer, two chain
    lengths differenced so dispatch/launch/fence cancel — the bandwidth
    twin of :func:`measure_matmul_anchor`. Each link reads and writes
    the buffer once: 2 * mb MB of traffic per link. Retries 2-3 buffer
    sizes before giving up (see :func:`measure_hbm_anchor_probe`, which
    also returns the structured attempt record); NaN = every size
    failed this session."""
    out = measure_hbm_anchor_probe(
        sizes_mb=None if mb is None else [mb], base=base, ratio=ratio,
        small=small, device=device,
    )
    return float("nan") if out["gb_per_sec"] is None else out["gb_per_sec"]


def _consistent_marginal_diag(timed, base: int, ratio: int):
    """Differenced per-unit time from THREE chain lengths, accepted only
    when the two independent estimates agree within 2x — a single
    differenced pair on a jittery host can silently produce a
    wildly-wrong number, and a wrong denominator poisons every percentage
    derived from it. Returns ``(value_or_nan, diag)`` — the diag dict
    records the chain lengths, raw seconds and both estimates, plus
    ``failed_check`` naming the rejection, so callers can report a FAILURE
    as evidence instead of a bare boolean."""
    t1 = timed(base)
    t2 = timed(base * ratio)
    t3 = timed(base * (2 * ratio - 1))
    per = base * (ratio - 1)
    est1 = (t2 - t1) / per
    est2 = (t3 - t2) / per
    diag = {
        "chain_lengths": [base, base * ratio, base * (2 * ratio - 1)],
        "seconds": [round(t1, 6), round(t2, 6), round(t3, 6)],
        "est1_per_link_s": round(est1, 9),
        "est2_per_link_s": round(est2, 9),
    }
    if est1 <= 0 or est2 <= 0:
        diag["failed_check"] = "nonpositive_marginal"
        return float("nan"), diag
    if max(est1, est2) > 2.0 * min(est1, est2):
        diag["failed_check"] = "estimates_disagree_2x"
        return float("nan"), diag
    return 0.5 * (est1 + est2), diag


def _consistent_marginal(timed, base: int, ratio: int) -> float:
    """Value-only wrapper of :func:`_consistent_marginal_diag` (kept for
    callers that don't report diagnostics)."""
    return _consistent_marginal_diag(timed, base, ratio)[0]


def roofline_fields(
    model: dict,
    *,
    steps: int,
    fit_seconds: float,
    warm_seconds_per_step: float | None = None,
    cold_seconds: float | None = None,
    anchor_tflops: float | None = None,
    byte_model: dict | None = None,
    hbm_anchor_gbps: float | None = None,
    hbm_probe_record: dict | None = None,
) -> dict:
    """Assemble the JSON roofline block from a flop model + measured times.

    ``warm_seconds_per_step`` should be a *marginal* time (two fit lengths
    differenced) so dispatch and the cold step cancel; when given, the
    warm-phase achieved TF/s and percent-of-anchor are emitted. All rates
    derive from MODEL flops — stated dominant-term counts, not hardware
    counters.

    ``byte_model`` + ``hbm_anchor_gbps`` (:func:`step_byte_model` /
    :func:`measure_hbm_anchor`) add the BANDWIDTH roofline: achieved
    GB/s against the measured HBM rate, plus ``bound`` — the
    machine-reported reason a config sits where it does: "hbm" / "mxu" when the achieved fraction of that anchor
    exceeds half the roof, else "latency" (neither resource near its
    roof: the time goes to sequential small-op chains / dispatch — the
    regime the warm-start and sketch designs attack)."""
    total = fit_total_flops(model, steps)
    out = {
        "cold_flops_per_step": int(model["cold_flops_per_step"]),
        "warm_flops_per_step": int(model["warm_flops_per_step"]),
        "model_flops_total": int(total),
        "achieved_tflops": round(total / fit_seconds / 1e12, 4),
    }
    if anchor_tflops is not None:
        out["anchor_tflops"] = round(anchor_tflops, 4)
        out["pct_of_anchor"] = round(
            100.0 * (total / fit_seconds / 1e12) / anchor_tflops, 2
        )
    if byte_model is not None:
        bytes_total = byte_model["cold_bytes_per_step"] + max(
            steps - 1, 0
        ) * byte_model["warm_bytes_per_step"]
        gbps = bytes_total / fit_seconds / 1e9
        out["model_bytes_total"] = int(bytes_total)
        out["achieved_gb_per_sec"] = round(gbps, 1)
        if hbm_anchor_gbps is not None and hbm_anchor_gbps != hbm_anchor_gbps:
            # NaN = the probe's consistency check rejected this session's
            # estimates at EVERY retried buffer size — say so instead of
            # silently omitting the block (consumers must be able to tell
            # "not HBM-bound" from "anchor never measured"), and attach
            # the structured attempt record so the failure is diagnosable
            # (which check failed, against what raw timings) rather than
            # a bare boolean
            out["hbm_probe_failed"] = True
            if hbm_probe_record is not None:
                out["hbm_probe"] = {
                    "failed_check": hbm_probe_record.get(
                        "failed_check", "unknown"
                    ),
                    "attempts": hbm_probe_record.get("attempts", []),
                }
        if hbm_anchor_gbps is not None and hbm_anchor_gbps == hbm_anchor_gbps:
            out["hbm_anchor_gb_per_sec"] = round(hbm_anchor_gbps, 1)
            out["pct_of_hbm_anchor"] = round(
                100.0 * gbps / hbm_anchor_gbps, 2
            )
            if out["pct_of_hbm_anchor"] > 110:
                # modeled traffic cannot exceed the physical rate: the
                # anchor under-measured this session (or the byte model
                # overcounts) — say so next to the number
                out["hbm_anchor_suspect"] = True
            if "pct_of_anchor" in out:
                hbm_pct, flop_pct = (
                    out["pct_of_hbm_anchor"], out["pct_of_anchor"],
                )
                if hbm_pct >= 50 and hbm_pct >= flop_pct:
                    out["bound"] = "hbm"
                elif flop_pct >= 50:
                    out["bound"] = "mxu"
                else:
                    out["bound"] = "latency"
    if warm_seconds_per_step is not None and warm_seconds_per_step > 0:
        warm_tf = model["warm_flops_per_step"] / warm_seconds_per_step / 1e12
        out["warm_ms_per_step"] = round(warm_seconds_per_step * 1e3, 4)
        out["warm_tflops"] = round(warm_tf, 3)
        if anchor_tflops is not None:
            out["warm_pct_of_anchor"] = round(100.0 * warm_tf / anchor_tflops, 2)
    if cold_seconds is not None and cold_seconds > 0:
        cold_tf = model["cold_flops_per_step"] / cold_seconds / 1e12
        out["cold_ms"] = round(cold_seconds * 1e3, 2)
        out["cold_tflops"] = round(cold_tf, 3)
        if anchor_tflops is not None:
            out["cold_pct_of_anchor"] = round(100.0 * cold_tf / anchor_tflops, 2)
    return out
