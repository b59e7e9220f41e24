"""Command line: ``python -m distributed_eigenspaces_tpu_torch.cli ...``.

Counterpart of ``distributed_eigenspaces_tpu/cli.py``, flag for flag (the
one flag of the port's own is ``--device``, default ``cuda``: the run
raises when no card is present, and ``--device cpu`` runs the plain
PyTorch path). Modes, as the reference's: ``fit`` (the online loop: the
per-step trainer, the whole-fit scan and its segmented, checkpointable
twin, the feature-sharded whole fits, the supervised fit, the population
ingest), ``fleet`` (B tenants in one batched program), ``serve`` (fit,
publish to the versioned registry, serve a micro-batched burst through
``serving.QueryServer``; exit 1 unless every served row equals the direct
projection bit for bit), ``oneshot`` / ``master`` (one merge round) and
``slave`` (explains itself and exits 2). Every validation exit of the
reference exits 2 here with the same flag named. ``--plan PATH`` applies a
``plan-v1`` artifact as the reference's does: its self-check runs first
(any violation exits 2), then its workload fields and chosen
``config_overrides`` become the flags, with one ``note:`` line on stderr.

The port runs one process on one card; ranks of a mesh meet over
``torch.distributed``. ``--data synthetic`` draws its rows on the device
with ``data.synthetic.sample_prefix_stable``, so a resumed run with a
larger ``--steps`` sees the same leading rows. ``--compile-cache DIR``
points the kernel builds at ``DIR/kernels`` (``utils/compile_cache.py``);
the run then writes one line to stderr, ``{"compile_lifecycle": ...}``:
the ``nvcc`` compiles this process ran and their seconds, and the wall
clock (``time.time()``) of its first result, so a second process can be
shown to start warm.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_eigenspaces_tpu_torch",
        description="Online distributed PCA on one NVIDIA H100 (PyTorch and "
        "hand-written CUDA kernels)",
    )
    p.add_argument(
        "--mode",
        choices=["fit", "fleet", "serve", "oneshot", "master", "slave"],
        default="fit",
        help="fit: full online algorithm; fleet: B independent fits as "
        "ONE batched multi-tenant program (parallel/fleet.py — the "
        "serving path; --fleet-size tenants, the dataset split into "
        "per-tenant shards); serve: fit, publish the basis to a "
        "versioned registry, and serve a micro-batched query burst "
        "through serving/QueryServer (qps + latency percentiles "
        "reported); oneshot: single merge round (reference master "
        "parity); master is an alias of oneshot; slave exists only to "
        "explain itself",
    )
    p.add_argument("--fleet-size", type=int, default=8,
                   help="B, tenants per fleet program for --mode fleet "
                   "(the dataset is split into B tenant shards; the "
                   "fleet axis shards over available devices as pure "
                   "data parallelism)")
    p.add_argument("--serve-queries", type=int, default=64,
                   help="--mode serve: queries in the served burst")
    p.add_argument("--serve-rows", type=int, default=8,
                   help="--mode serve: rows per query")
    p.add_argument("--serve-bucket", type=int, default=8,
                   help="--mode serve: micro-batch capacity (queries "
                   "per dispatch; PCAConfig.serve_bucket_size)")
    p.add_argument("--serve-flush-s", type=float, default=0.02,
                   help="--mode serve: admission deadline for partial "
                   "micro-batches (PCAConfig.serve_flush_s; 0 = one "
                   "query per dispatch)")
    p.add_argument("--registry-dir", default=None, metavar="DIR",
                   help="durable eigenbasis registry root "
                   "(PCAConfig.registry_dir): publishes commit to disk "
                   "(tmp-file + atomic rename + checksummed meta.json "
                   "marker) BEFORE becoming visible, and a restarted "
                   "--mode serve recovers the committed latest and "
                   "warm-serves it bit-exact with ZERO refit; torn "
                   "snapshots are skipped loudly, checksum mismatches "
                   "quarantined (docs/ROBUSTNESS.md 'Read-path "
                   "resilience')")
    p.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="--mode serve with --registry-dir: serve "
                   "through N read-only ReplicaRegistry tailers of the "
                   "durable store instead of the publisher's in-memory "
                   "view (PCAConfig.replicas; 1 = no replication) — "
                   "each replica installs committed versions with the "
                   "lock-free swap and reports its lag "
                   "(docs/ROBUSTNESS.md 'Replicated registry')")
    p.add_argument("--replica-staleness-ms", type=float, default=500.0,
                   help="declared replica staleness bound "
                   "(PCAConfig.replica_staleness_ms): a replica "
                   "installing a version more than this many ms after "
                   "its commit marker counts a stale install in "
                   "summary()['replication']; GC retire grace is keyed "
                   "off the same bound so a lagging replica's reader "
                   "still gets VersionRetired, never a torn read")
    p.add_argument("--publisher-lease-ms", type=float, default=1000.0,
                   help="publisher lease TTL "
                   "(PCAConfig.publisher_lease_ms): the exclusive "
                   "write lease on the durable registry renews at "
                   "TTL/3; a kill -9'd publisher fails over to a "
                   "standby within ~one TTL, the takeover bumps the "
                   "fencing epoch, and the zombie's commits are "
                   "rejected by the store AND by every replica")
    p.add_argument("--serve-queue-depth", type=int, default=None,
                   help="bounded admission for --mode serve "
                   "(PCAConfig.serve_queue_depth): max un-resolved "
                   "requests before reject-newest load shedding with a "
                   "clean ServerOverloaded (unset = unbounded); with "
                   "--slo-p99-ms also drops requests that blew the SLO "
                   "before compute")
    p.add_argument("--serve-continuous", action="store_true",
                   help="continuous batching for --mode serve "
                   "(PCAConfig.serve_continuous): admit requests into "
                   "the NEXT in-flight batch — a dispatch lane never "
                   "idles while work is queued, batch assembly is "
                   "round-robin-fair over tenant ids, and the "
                   "admit-to-dispatch tail collapses at sub-saturation "
                   "rates (bench.py --wirespeed measures the win); "
                   "unset keeps bucket-full-or-deadline dispatch "
                   "byte-identical to the previous path")
    p.add_argument("--serve-dtype", default="float32",
                   choices=("float32", "bfloat16", "int8"),
                   help="serve-kernel precision family for --mode "
                   "serve (PCAConfig.serve_dtype): float32 is the "
                   "exact bit-for-bit path; bfloat16/int8 run the "
                   "quantized serve kernels (csrc/serve_project.cu on "
                   "the card, their plain PyTorch versions on the CPU; "
                   "the basis stays an operand so hot swaps rebuild "
                   "nothing), "
                   "angle-gated <= 0.2 deg vs fp32 at construction")
    p.add_argument("--breaker-threshold", type=int, default=None,
                   help="per-signature circuit breaker "
                   "(PCAConfig.serve_breaker_threshold): consecutive "
                   "dispatch failures before a signature fast-fails "
                   "with BreakerOpen while other signatures keep "
                   "serving; a half-open probe recovers it (unset = "
                   "disabled)")
    p.add_argument("--broker", default=None,
                   help="ignored — no broker: ranks meet over torch.distributed (kept for "
                   "reference CLI compatibility)")
    p.add_argument("--rank", type=int, default=2,
                   help="k, subspace rank (reference --rank)")
    p.add_argument("--batches", type=int, default=None,
                   help="number of worker batches for oneshot mode "
                   "(reference --batches); default = --workers")
    p.add_argument("--data", default="cifar-10-batches-py",
                   help="CIFAR-10 pickle dir, or 'synthetic'")
    p.add_argument("--rgb", action="store_true",
                   help="keep RGB channels (3072-d) instead of the "
                   "reference's grayscale 1024-d")
    p.add_argument("--workers", type=int, default=8, help="m")
    p.add_argument("--steps", type=int, default=10, help="T")
    p.add_argument("--rows-per-worker", type=int, default=None,
                   help="n per worker per step (default: fill the dataset)")
    p.add_argument("--discount", choices=["1/T", "1/t", "notebook"],
                   default="1/T")
    p.add_argument("--backend",
                   choices=["auto", "local", "shard_map", "feature_sharded"],
                   default="auto",
                   help="feature_sharded = large-d path: d sharded over a "
                   "second mesh axis, no d x d matrix anywhere")
    p.add_argument("--solver",
                   choices=["eigh", "subspace", "distributed", "deflation"],
                   default="eigh",
                   help="distributed = subspace machinery for worker "
                   "solves, plus the sharded factor-operator eigensolve "
                   "(solvers/) for the merge and serving extract whenever "
                   "--dim exceeds --eigh-crossover-d — the path that "
                   "breaks the d ceiling; deflation = the model-parallel-"
                   "over-k twin: above the crossover the merge/"
                   "extract run --components concurrent eigenvector lanes, "
                   "each deflating the lower lanes via k x k correction "
                   "panels (never a d x d) — the path that breaks the k "
                   "ceiling")
    p.add_argument("--components", type=int, default=1,
                   help="deflation lane parallelism "
                   "(PCAConfig.components_axis_size): how many ways the "
                   "k eigenvector lanes split over the 'components' mesh "
                   "axis (requires --solver deflation; k must divide "
                   "evenly; 1 = lanes run batched on one device, same "
                   "schedule, no extra mesh axis)")
    p.add_argument("--grow-k", type=int, default=None, metavar="K2",
                   help="elastic k (--mode serve): after publishing the "
                   "--rank-wide basis, grow it to K2 columns with "
                   "solvers.grow_basis — the parent lanes are FROZEN "
                   "(deflated, bit-identical prefix) and only the K2 - "
                   "rank new directions are fit — and publish the "
                   "widened basis as a lineage-linked version "
                   "(grew_from) through the same registry; the burst "
                   "then serves the grown version")
    p.add_argument("--subspace-iters", type=int, default=16,
                   help="power-iteration count for --solver "
                   "subspace/distributed/deflation")
    p.add_argument("--solver-tol", type=float, default=None,
                   help="gap-adaptive stopping for the distributed/"
                   "deflation eigensolves (PCAConfig.solver_tol): stop "
                   "as soon as the measured subspace residual drops "
                   "below this tolerance instead of always running "
                   "--subspace-iters (per-lane convergence counters "
                   "surface in summary()['solver']); unset keeps the "
                   "fixed schedule byte-identical")
    p.add_argument("--eigh-crossover-d", type=int, default=4096,
                   help="with --solver distributed: dims ABOVE this run "
                   "the distributed merge/extract eigensolve, dims at or "
                   "below keep the exact eigh-family path (measure the "
                   "crossover with bench.py --dsolve)")
    p.add_argument("--warm-orth-method", choices=["cholqr2", "qr", "ns"],
                   default=None,
                   help="orthonormalization for WARM solver rounds only "
                        "(default: same as --orth-method). 'ns' = "
                        "Newton-Schulz, pure matmuls — the measured "
                        "latency win for warm steady states; warm-only "
                        "because cold power steps feed it "
                        "nearly-dependent columns (see PCAConfig docs)")
    p.add_argument("--orth-method", choices=["cholqr2", "qr"],
                   default="cholqr2",
                   help="orthonormalization inside the subspace solver "
                   "(cholqr2 = the matmul-friendly default)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16 runs the Gram contraction on the tensor "
                   "cores at bf16 rate (fp32 accumulation)")
    p.add_argument("--trainer", choices=["step", "scan", "sketch"],
                   default="step",
                   help="step: one dispatch per online step (streams); "
                   "scan: the T-step loop as one program per "
                   "--checkpoint-every-step segment (fastest; in-memory "
                   "data; checkpoints at segment boundaries; with "
                   "--backend feature_sharded it runs the exact rank-r "
                   "whole-fit — no d x d state); "
                   "sketch: the Nystrom whole-fit on the feature-sharded "
                   "mesh (requires --backend feature_sharded; the "
                   "large-d*k throughput path, BASELINE.md)")
    p.add_argument("--warm-start-iters", type=int, default=None,
                   help="after a cold first step, run this many solver "
                   "iterations warm-started from the previous merged "
                   "estimate (requires --solver subspace; honored by all "
                   "trainers). Unset = the measured-fastest default (2) "
                   "with --solver subspace; 0 disables (every step cold)")
    p.add_argument("--merge-interval", type=int, default=1,
                   help="steady-state merge schedule s: run the merged "
                   "eigensolve every s steps and fold the mean worker "
                   "projector between merges (1 = every step, the exact "
                   "pre-knob path; worker-mask drops still take effect "
                   "in-round and at the next merge — see "
                   "docs/ARCHITECTURE.md 'Steady-state pipeline')")
    p.add_argument("--pipeline-merge", action="store_true",
                   help="software-pipelined scan steady state: overlap "
                   "step t-1's merge/fold with step t's warm solves from "
                   "a one-step-stale basis (requires --solver subspace "
                   "with warm starts; --trainer scan; incompatible with "
                   "--checkpoint-dir/--resume — the pipelined carry is "
                   "not checkpointable)")
    p.add_argument("--merge-topology", default=None, metavar="SPEC",
                   help="hierarchical merge tree, leaf->root, as "
                   "'name:fan_in,name:fan_in' (e.g. 'chip:4,host:2'): "
                   "turn the flat merge into a tiered tree reduce "
                   "with per-tier sharded updates — each tier moves "
                   "only the (d, k) basis and an (f*k)^2 Gram, never "
                   "the m-wide factor stack. Fan-ins must multiply to "
                   "--workers and each must divide --dim; unset = the "
                   "exact flat merge (docs/ARCHITECTURE.md "
                   "'Hierarchical merge')")
    p.add_argument("--dim", type=int, default=1024,
                   help="feature dim for --data synthetic")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="persistent compile cache root "
                   "(PCAConfig.compile_cache_dir): the hand kernels' "
                   "libraries are built into DIR/kernels and the "
                   "acquired programs' entries written under "
                   "DIR/programs, so a SECOND process with the same "
                   "shape signature starts warm — it loads the "
                   "libraries and runs no nvcc, with bit-identical "
                   "results (utils/compile_cache.py)")
    p.add_argument("--prewarm", action="store_true",
                   help="acquire expected signatures off the serving "
                   "thread before traffic (runtime/prewarm.py): with "
                   "--mode serve the query server's row buckets are "
                   "acquired and launched once on the card, and the "
                   "burst waits for readiness (first request: 0 "
                   "compile misses); with --mode fleet the "
                   "padded-bucket fleet programs are acquired before "
                   "the timed fit. Other modes reject the flag.")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in "
                   "--checkpoint-dir")
    p.add_argument("--metrics", action="store_true",
                   help="print per-step JSON metrics to stderr")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="export the run's telemetry timeline "
                   "(utils/telemetry.py: request-scoped spans with "
                   "correlation ids across fit / fleet / serve / "
                   "drift / compile) as Chrome trace-event JSON — "
                   "open at ui.perfetto.dev or chrome://tracing "
                   "(docs/OBSERVABILITY.md)")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="declared p99 request-latency SLO in ms "
                   "(PCAConfig.serve_slo_p99_ms / fleet_slo_p99_ms): "
                   "summary()['slo'] reports rolling-window attainment "
                   "and error-budget burn against it — --mode serve "
                   "gates warn-only (an SLO miss is reported, never a "
                   "hard failure)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the fit into "
                   "this dir (Chrome-trace JSON; the det_* named regions "
                   "mark worker solve / gather / merge / state update)")
    p.add_argument("--save", default=None,
                   help="write the final (d, k) subspace to this .npy")
    p.add_argument("--device", default="cuda",
                   help="where the fit and the serving run: the card "
                   "unless asked (the run raises when no card is "
                   "present); 'cpu' runs the plain PyTorch path")
    p.add_argument("--plan", default=None, metavar="PATH",
                   help="apply a plan-v1 artifact (analysis/planner.py, "
                   "not ported yet: the flag exits 2; "
                   "generated by scripts/analyze.py --plan "
                   "--write-plan): the plan's self-check runs first — "
                   "any violation (tier budget over deadline, "
                   "predicted p99 over SLO, invalid overrides) rejects "
                   "the run loudly — then its declared workload shape "
                   "(--workers/--rank/--dim/--rows-per-worker/"
                   "--slo-p99-ms) and chosen config_overrides (merge "
                   "topology/interval/pipeline, replicas, serve "
                   "bucket/flush/continuous) are applied before the "
                   "run; PCAConfig.plan_path records the provenance")
    sup = p.add_argument_group(
        "supervision",
        "self-healing runs (runtime/supervisor.py): corrupt input "
        "blocks are quarantined to worker-mask drops, transient "
        "failures retry with backoff, and with --checkpoint-dir the "
        "run auto-resumes from the newest committed checkpoint "
        "(docs/ROBUSTNESS.md)",
    )
    sup.add_argument("--supervise", action="store_true",
                     help="run the fit under the fault-detecting "
                     "supervisor (--trainer step for any backend, or "
                     "--trainer scan for the dense segmented whole-fit)")
    sup.add_argument("--fault-budget", type=int, default=None,
                     help="max quarantined worker-rounds + dropped "
                     "rounds before the run fails loudly with the fault "
                     "ledger (default: unlimited, every fault ledgered)")
    sup.add_argument("--max-retries", type=int, default=3,
                     help="transient-failure retries per stream pull / "
                     "step before escalating to a resume")
    sup.add_argument("--max-resumes", type=int, default=2,
                     help="in-process auto-resumes before an "
                     "escalation is terminal")
    sup.add_argument("--backoff-base", type=float, default=0.05,
                     help="first retry delay in seconds (doubles per "
                     "attempt)")
    sup.add_argument("--backoff-max", type=float, default=2.0,
                     help="retry delay cap in seconds")
    sup.add_argument("--heartbeat-timeout-ms", type=float, default=1000.0,
                     help="elastic-membership lease duration "
                     "(runtime/membership.py): a worker missing this "
                     "many ms of heartbeats goes suspect (excluded "
                     "from merges), then dead one timeout later (slot "
                     "joinable; a rejoin re-enters at the next round)")
    sup.add_argument("--round-deadline-ms", type=float, default=250.0,
                     help="elastic merge-round deadline: each round "
                     "closes after this many ms with whatever quorum "
                     "arrived; a late straggler's contribution folds "
                     "into the NEXT merge (one-step-stale). 0 disables "
                     "the deadline (rounds wait for every live member)")
    sup.add_argument("--min-quorum-frac", type=float, default=0.5,
                     help="quorum floor: live membership below this "
                     "fraction raises a loud QuorumLost (within ~2x "
                     "the heartbeat timeout); supervised runs wait "
                     "bounded for quorum and auto-resume from the "
                     "latest checkpoint")
    pop = p.add_argument_group(
        "population ingest (runtime/population.py)"
    )
    pop.add_argument("--population", type=int, default=None,
                     help="simulated transient-client population size: "
                     "enables the sampled-cohort ingest tier (each "
                     "round draws a cohort, clients submit (d, k) "
                     "factor summaries through the validation "
                     "gauntlet + Byzantine-tolerant merge); default "
                     "off (the stable-slot fit tier)")
    pop.add_argument("--cohort-size", type=int, default=256,
                     help="clients sampled per round; per-round merge "
                     "cost and collective payloads scale with THIS, "
                     "never with --population (the population_merge "
                     "contract enforces it)")
    pop.add_argument("--min-participation-frac", type=float,
                     default=0.5,
                     help="participation deadline floor: a round "
                     "whose arrivals fall below this fraction of the "
                     "cohort raises ParticipationLost (the population "
                     "generalization of --min-quorum-frac); the run "
                     "waits bounded and auto-resumes under "
                     "--max-resumes")
    pop.add_argument("--max-poison-frac", type=float, default=0.05,
                     help="declared Byzantine tolerance: the trimmed "
                     "merge drops this alpha-fraction from both tails "
                     "of every coordinate, so up to this fraction of "
                     "colluding poisoned clients cannot steer the "
                     "basis (must be in [0, 0.5))")
    return p



def _device(args):
    from distributed_eigenspaces_tpu_torch.device import resolve_device

    return resolve_device(args.device)


def _host(a) -> np.ndarray:
    """``a`` (a tensor on any device, or an array) as host float32."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.array(a, np.float32)  # a writable copy (registry arrays are not)


def _angle(w, truth) -> float:
    """The worst principal angle in degrees between ``w`` and ``truth``."""
    import torch

    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    return float(principal_angles_degrees(
        torch.as_tensor(_host(w)), torch.as_tensor(_host(truth))).max())


def _rows(data, lo: int, hi: int, dev, dtype=None):
    """Rows ``[lo, hi)`` of numpy or torch data as a tensor on ``dev``."""
    import torch

    out = torch.as_tensor(data[lo:hi]).to(dev)
    return out if dtype is None else out.to(dtype)


def _load(args, dev):
    if args.data == "synthetic":
        from distributed_eigenspaces_tpu_torch.data.synthetic import (
            planted_spectrum,
            sample_prefix_stable,
        )

        # plant exactly k directions: the k-th eigengap is then
        # planted-vs-noise-floor (clean), not a point inside the decay
        spec = planted_spectrum(
            args.dim, k_planted=args.rank, gap=20.0, noise=0.01, seed=0,
        )
        n = args.workers * (args.rows_per_worker or 256) * args.steps
        if args.mode == "fleet":
            # every tenant shard must fill its own step schedule
            n *= args.fleet_size
        # drawn on the device, prefix-stable: a resume with a larger
        # --steps sees the same leading rows
        return sample_prefix_stable(spec, n, seed=1, device=dev), spec.top_k(args.rank)
    from distributed_eigenspaces_tpu_torch.data.cifar import load_cifar10

    data, _labels = load_cifar10(args.data, grayscale=not args.rgb)
    return data, None


def _coerce_resumed_state(state, want: str, k: int):
    """Cross-trainer checkpoint compatibility: a scan checkpoint carries the
    warm carry (SegmentState), a per-step one does not (OnlineState), and
    the feature-sharded backend uses the low-rank kind. Dense kinds convert
    between each other losslessly (an upgraded per-step checkpoint has no
    ``v_prev``, so the next step runs cold, noted); the low-rank kind is
    incompatible with dense paths and vice versa. Returns ``(state,
    note)``; ``state=None`` means incompatible."""
    import torch

    from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
    from distributed_eigenspaces_tpu_torch.algo.scan import SegmentState
    from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
        LowRankState,
        SketchState,
    )

    if want == "sketch":  # sketch whole-fit resume
        return (state, None) if isinstance(state, SketchState) else (None, None)
    if want == "lowrank":  # feature-sharded per-step resume
        return (state, None) if isinstance(state, LowRankState) else (None, None)
    if want == "segment":
        if isinstance(state, SegmentState):
            return state, None
        if isinstance(state, OnlineState):
            return (
                SegmentState(
                    sigma_tilde=state.sigma_tilde,
                    step=state.step,
                    v_prev=torch.zeros((state.sigma_tilde.shape[0], k),
                                       dtype=torch.float32,
                                       device=state.sigma_tilde.device),
                ),
                "resumed from a per-step checkpoint: no warm carry saved, "
                "the first post-resume step runs cold",
            )
        return None, None
    # want == "online" (dense per-step)
    if isinstance(state, OnlineState):
        return state, None
    if isinstance(state, SegmentState):
        return (
            OnlineState(sigma_tilde=state.sigma_tilde, step=state.step),
            "resumed from a scan checkpoint (warm carry dropped: the "
            "per-step loop re-threads it from the next round)",
        )
    return None, None


def _resume_from(ckpt, want: str, k: int):
    """Shared resume path: newest checkpoint, cross-trainer coercion and the
    stderr diagnostics. Returns ``(state, cursor, exit_code)``: state is
    None when there is nothing to restore (exit_code 0) or the checkpoint is
    incompatible (exit_code 2)."""
    restored = ckpt.latest()
    if restored is None:
        return None, 0, 0
    state, cursor = restored
    kind = type(state).__name__
    state, note = _coerce_resumed_state(state, want, k)
    if state is None:
        print(
            f"error: checkpoint holds a {kind}, incompatible with this "
            "trainer/backend (dense trainers resume OnlineState/"
            "SegmentState; --backend feature_sharded resumes "
            "LowRankState; --trainer sketch resumes SketchState)",
            file=sys.stderr,
        )
        return None, 0, 2
    if note:
        print(f"note: {note}", file=sys.stderr)
    print(json.dumps({"resumed_step": int(state.step), "cursor": cursor}),
          file=sys.stderr)
    return state, cursor, 0


def _make_tracer(args):
    """One ``utils.telemetry.Tracer`` a run when ``--trace-out`` is set, else
    None: made before the instrumented components, so every span lands on
    one timeline."""
    if not getattr(args, "trace_out", None):
        return None
    from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer

    return Tracer()


def _export_trace(args, tracer) -> None:
    """Write the Chrome trace-event timeline to ``--trace-out`` (and a
    one-line stderr receipt); nothing without a tracer."""
    if tracer is None:
        return
    path = tracer.export_chrome_trace(args.trace_out)
    print(json.dumps({"trace_out": path, "spans": len(tracer.spans),
                      "dropped_spans": tracer.dropped}), file=sys.stderr)


def _report_lifecycle(args) -> None:
    """With ``--compile-cache``: one stderr line on the process's kernel
    builds (module docstring), written when its first result exists."""
    if not args.compile_cache:
        return
    from distributed_eigenspaces_tpu_torch.ops import _build

    print(json.dumps({"compile_lifecycle": {
        "nvcc_runs": _build.nvcc_runs,
        "nvcc_seconds": round(sum(i["seconds"] for i in _build.build_info.values()), 3),
        "libraries_loaded": sorted(_build._libs),
        "kernel_dir": str(_build.BUILD_DIR),
        "first_result_unix": time.time(),
    }}), file=sys.stderr, flush=True)


def _results(args, tickets) -> list:
    """Each ticket's ``ServedProjection``, in order; the lifecycle line is
    written when the first one exists."""
    out = []
    for t in tickets:
        out.append(t.result(timeout=600))
        if len(out) == 1:
            _report_lifecycle(args)
    return out


def _scan_result(args, cfg, state, truth, elapsed, extra):
    """Final extraction and the summary JSON shared by both scan paths."""
    from distributed_eigenspaces_tpu_torch.api.runner import extract_dense

    w = extract_dense(cfg, state.sigma_tilde)
    w_host = _host(w)  # materialization fence + result
    _report_lifecycle(args)
    out = {
        "mode": "fit",
        "trainer": "scan",
        **extra,
        # authoritative fields AFTER extra: metrics.summary() also carries
        # a "steps" (its record count: segments, not online steps)
        "steps": int(state.step),
        "seconds": round(elapsed, 3),
        "dim": cfg.dim,
        "k": cfg.k,
    }
    if truth is not None:
        out["principal_angle_deg"] = round(_angle(w_host, truth), 4)
    print(json.dumps(out))
    if args.save:
        np.save(args.save, w_host)
    return 0


def _fit_scan(args, cfg, data, truth, dev) -> int:
    """``--trainer scan``: the whole T-step loop as one program
    (``algo/scan.py``), the fastest path when the data fits in memory.

    With ``--checkpoint-dir`` / ``--resume`` / ``--metrics`` the loop runs
    as ``--checkpoint-every``-step segments with the checkpoint and metrics
    hook between segments: the same semantics, resumable
    (``algo.scan.make_segmented_fit``)."""
    import torch

    from distributed_eigenspaces_tpu_torch.api.estimator import _scan_mesh
    from distributed_eigenspaces_tpu_torch.api.runner import make_whole_fit

    if args.checkpoint_dir or args.resume or args.metrics:
        return _fit_scan_segmented(args, cfg, data, truth, dev)

    m, n, T, dim = cfg.num_workers, cfg.rows_per_worker, cfg.num_steps, cfg.dim
    need = T * m * n
    if len(data) < need:
        print(
            f"error: --trainer scan needs {need} rows "
            f"({T} steps x {m} x {n}), have {len(data)}",
            file=sys.stderr,
        )
        return 2
    x_steps = _rows(data, 0, need, dev).reshape(T, m, n, dim)

    from distributed_eigenspaces_tpu_torch.utils.telemetry import NULL_TRACER
    from distributed_eigenspaces_tpu_torch.utils.tracing import profile_to

    tracer = _make_tracer(args)
    tr = tracer if tracer is not None else NULL_TRACER
    handle = make_whole_fit(cfg, "scan", _scan_mesh(cfg, dev), device=dev)
    t0 = time.time()
    with profile_to(args.profile_dir), tr.span(
        "scan_fit", trace_id=tr.new_trace("fit"), category="fit", device=True,
        attrs={"dim": cfg.dim, "k": cfg.k, "steps": cfg.num_steps},
    ):
        state = handle.fit(handle.init_state(), x_steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # fence inside the capture
    elapsed = time.time() - t0
    rc = _scan_result(
        args, cfg, state, truth, elapsed,
        {
            # one fit call: first-use costs (the kernels' build or load,
            # the libraries' start-up) are included
            "includes_compile": True,
            "samples_per_sec": round(need / elapsed, 1),
        },
    )
    _export_trace(args, tracer)
    return rc


def _fit_scan_segmented(args, cfg, data, truth, dev) -> int:
    """Segmented scan: checkpoint / resume / metrics between S-step
    programs."""
    from distributed_eigenspaces_tpu_torch.api.estimator import _scan_mesh
    from distributed_eigenspaces_tpu_torch.api.runner import make_whole_fit
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    m, n, T, dim = cfg.num_workers, cfg.rows_per_worker, cfg.num_steps, cfg.dim
    rows_per_step = m * n
    handle = make_whole_fit(cfg, "segmented", _scan_mesh(cfg, dev),
                            segment=args.checkpoint_every, device=dev)
    state = handle.init_state()
    cursor = 0
    ckpt = None
    if args.checkpoint_dir:
        # every=1 in SEGMENT units: each boundary (already spaced
        # --checkpoint-every steps apart) commits a checkpoint
        ckpt = Checkpointer(args.checkpoint_dir, every=1,
                            rows_per_step=rows_per_step, device=dev)
        if args.resume:
            restored, cursor, err = _resume_from(ckpt, "segment", cfg.k)
            if err:
                return err
            if restored is not None:
                state = restored

    done = int(state.step)
    remaining = max(0, T - done)
    need = remaining * rows_per_step
    if len(data) - cursor < need:
        print(
            f"error: --trainer scan needs {need} unseen rows "
            f"({remaining} steps x {m} x {n}), have {len(data) - cursor}",
            file=sys.stderr,
        )
        return 2
    x_steps = _rows(data, cursor, cursor + need, dev).reshape(remaining, m, n, dim)

    tracer = _make_tracer(args)
    metrics = MetricsLogger(
        samples_per_step=rows_per_step,
        stream=sys.stderr if args.metrics else None,
        reference_subspace=truth,
        retention=cfg.metrics_retention,
    ).start()
    if tracer is not None:
        metrics.attach_tracer(tracer)
    last_t = {"t": done}

    def on_segment(t, st):
        # one metrics record a segment (t advances by the segment size)
        metrics.samples_per_step = rows_per_step * (t - last_t["t"])
        last_t["t"] = t
        metrics.on_step(t, st, st.v_prev)
        if ckpt is not None:
            ckpt.on_step(t, st)

    from distributed_eigenspaces_tpu_torch.utils.tracing import profile_to

    t0 = time.time()
    with profile_to(args.profile_dir):
        state = handle.fit(state, x_steps, on_segment=on_segment)
    elapsed = time.time() - t0
    rc = _scan_result(
        args, cfg, state, truth, elapsed,
        {
            "includes_compile": True,
            "segment": handle.info["segment"],
            "resumed_step": done,
            **metrics.summary(),
        },
    )
    _export_trace(args, tracer)
    return rc


def _fit_feature_whole(args, cfg, data, truth, dev) -> int:
    """The feature-sharded WHOLE-FIT trainers: ``--trainer sketch`` (the
    Nystrom carry) or ``--trainer scan`` with ``--backend feature_sharded``
    (the exact rank-r carry, never a d x d matrix). ``--checkpoint-dir``
    runs the fit windowed (``fit_windows``, one committed checkpoint every
    ``--checkpoint-every`` steps); ``--resume`` continues bit for bit from
    the newest one. Extraction runs once at the end."""
    from distributed_eigenspaces_tpu_torch.api.estimator import _feature_mesh
    from distributed_eigenspaces_tpu_torch.api.runner import make_whole_fit
    from distributed_eigenspaces_tpu_torch.device import torch_dtype
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer

    sketch = args.trainer == "sketch"
    m, n, T, dim = cfg.num_workers, cfg.rows_per_worker, cfg.num_steps, cfg.dim
    rows_per_step = m * n
    mesh = _feature_mesh(cfg, dev)
    fit = make_whole_fit(cfg, "sketch" if sketch else "fs_scan", mesh, device=dev)
    state = fit.init_state()
    cursor = 0
    ckpt = None
    if args.checkpoint_dir:
        ckpt = Checkpointer(args.checkpoint_dir, every=1,
                            rows_per_step=rows_per_step, device=dev, mesh=mesh)
        if args.resume:
            restored, cursor, err = _resume_from(
                ckpt, "sketch" if sketch else "lowrank", cfg.k)
            if err:
                return err
            if restored is not None:
                want_shapes = (
                    {"y": (dim, fit.info["sketch_width"]), "v": (dim, cfg.k)}
                    if sketch else {"u": (dim, fit.info["rank"])}
                )
                bad = {
                    f: tuple(getattr(restored, f).shape)
                    for f, s in want_shapes.items()
                    if tuple(getattr(restored, f).shape) != s
                }
                if bad:
                    print(
                        f"error: checkpoint shapes {bad} do not match "
                        f"this run (want {want_shapes})",
                        file=sys.stderr,
                    )
                    return 2
                state = restored

    done = int(state.step)
    remaining = max(0, T - done)
    need = remaining * rows_per_step
    if len(data) - cursor < need:
        print(
            f"error: --trainer {args.trainer} needs {need} unseen rows "
            f"({remaining} steps x {m} x {n}), have {len(data) - cursor}",
            file=sys.stderr,
        )
        return 2

    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger
    from distributed_eigenspaces_tpu_torch.utils.tracing import profile_to

    metrics = None
    if args.metrics:
        metrics = MetricsLogger(
            samples_per_step=rows_per_step, stream=sys.stderr,
            reference_subspace=truth,
        ).start()

    t0 = time.time()
    windowed = False
    with profile_to(args.profile_dir):
        if remaining:
            stage_dtype = torch_dtype(cfg.compute_dtype or "float32")
            windowed = ckpt is not None or metrics is not None
            if windowed:
                # one program and a committed checkpoint and/or a metrics
                # record every --checkpoint-every steps, fed step by step
                from distributed_eigenspaces_tpu_torch.data.bin_stream import (
                    window_stream,
                )

                def step_blocks():
                    for t in range(remaining):
                        lo = cursor + t * rows_per_step
                        yield _rows(data, lo, lo + rows_per_step, dev,
                                    stage_dtype).reshape(m, n, dim)

                last_t = {"t": done}

                def on_segment(t, st):
                    if metrics is not None:
                        # one record a window (t advances window-size)
                        metrics.samples_per_step = rows_per_step * (t - last_t["t"])
                        last_t["t"] = t
                        metrics.on_step(t, st, st.v if sketch else st.u[:, : cfg.k])
                    if ckpt is not None:
                        ckpt.on_step(t, st)

                state = fit.fit_windows(
                    state, window_stream(step_blocks(), args.checkpoint_every),
                    on_segment=on_segment,
                )
            else:
                state = fit.fit(state, _rows(data, cursor, cursor + need, dev,
                                             stage_dtype).reshape(remaining, m, n, dim))
        rows = fit.extract(state)
        with pmesh.mesh_scope(mesh):
            w = pmesh.all_gather(rows.contiguous(), pmesh.FEATURE_AXIS)
        w_host = _host(w)  # materialization fence + result
    elapsed = time.time() - t0
    _report_lifecycle(args)

    out = {
        "mode": "fit",
        "trainer": args.trainer,
        "includes_compile": True,
        "backend": "feature_sharded",
        "mesh": list(mesh.shape.values()),
        **(
            {"sketch_width": fit.info["sketch_width"]} if sketch
            else {"rank": fit.info["rank"]}
        ),
        # checkpoint / metrics runs execute as --checkpoint-every-step
        # windows; the report says so because the per-window dispatch makes
        # samples_per_sec here not comparable to the one-program rate
        **(
            {"windowed": True, "window_steps": args.checkpoint_every}
            if windowed else {}
        ),
        "resumed_step": done,
        "steps": int(state.step),
        "samples_per_sec": round(need / elapsed, 1) if remaining else 0.0,
        "seconds": round(elapsed, 3),
        "dim": dim,
        "k": cfg.k,
    }
    if metrics is not None:
        out.update({k: v for k, v in metrics.summary().items() if k not in out})
    if truth is not None:
        out["principal_angle_deg"] = round(_angle(w_host, truth), 4)
    print(json.dumps(out))
    if args.save:
        np.save(args.save, w_host)
    return 0


def _fit_population(args, cfg, dev) -> int:
    """``--population N``: the sampled-cohort ingest tier
    (``runtime/population.py``): each of ``--steps`` rounds draws a
    ``--cohort-size`` cohort, every contribution crosses the validation
    gauntlet, and the survivors reduce through the hardened merge. Prints
    the run summary and the planted-basis recovery angle."""
    from distributed_eigenspaces_tpu_torch.runtime.population import population_fit
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    metrics = MetricsLogger(
        stream=sys.stderr if args.metrics else None,
        retention=cfg.metrics_retention,
    ).start()
    w, info, _sup = population_fit(
        cfg, rounds=args.steps, metrics=metrics, max_resumes=args.max_resumes,
        device=dev,
    )
    _report_lifecycle(args)
    out = {
        "mode": "population",
        # summary()["population"] is the telemetry section; the sizes ride
        # under their own keys so the section is never clobbered
        **metrics.summary(),
        "dim": cfg.dim,
        "k": cfg.k,
        "population_size": cfg.population,
        "cohort_size": cfg.cohort_size,
        "rounds": info["rounds"],
        "resumes": info["resumes"],
        "rejects": info["rejects"],
        "planted_recovery_angle_deg": round(_angle(w, info["planted"]), 3),
    }
    print(json.dumps(out))
    if args.save:
        np.save(args.save, _host(w))
    return 0


def _fit_supervised(args, cfg, data, truth, dev) -> int:
    """``--supervise``: the fit under the self-healing layer
    (``runtime/supervisor.py``): block quarantine with a fault budget, retry
    and backoff on transient failures, auto-resume from the newest committed
    checkpoint with the stream cursor seeked. With ``--checkpoint-dir`` a
    restarted process resumes by itself (no ``--resume`` needed)."""
    from distributed_eigenspaces_tpu_torch.data.stream import block_stream
    from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
        SupervisorError,
        supervised_fit,
    )
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    trainer = "segmented" if args.trainer == "scan" else "step"
    rows_per_step = cfg.num_workers * cfg.rows_per_worker
    tracer = _make_tracer(args)
    metrics = MetricsLogger(
        samples_per_step=rows_per_step,
        stream=sys.stderr if args.metrics else None,
        reference_subspace=truth,
        retention=cfg.metrics_retention,
    ).start()
    if tracer is not None:
        metrics.attach_tracer(tracer)

    def factory(start_row):
        return block_stream(
            data,
            num_workers=cfg.num_workers,
            rows_per_worker=cfg.rows_per_worker,
            start_row=start_row,
            remainder=cfg.remainder,
            device=dev,
        )

    t0 = time.time()
    try:
        w, state, sup = supervised_fit(
            factory,
            cfg,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            trainer=trainer,
            metrics=metrics,
            fault_budget=args.fault_budget,
            max_retries=args.max_retries,
            max_resumes=args.max_resumes,
            backoff_base=args.backoff_base,
            backoff_max=args.backoff_max,
            device=dev,
        )
    except SupervisorError as e:
        print(
            json.dumps({"mode": "fit", "supervised": True, "error": str(e),
                        "faults": e.ledger.as_dict()}),
            file=sys.stderr,
        )
        # the trace is most valuable on the failure path: the fault events
        # and retry arcs are on it
        _export_trace(args, tracer)
        return 3
    elapsed = time.time() - t0

    w_host = _host(w)
    _report_lifecycle(args)
    out = {
        "mode": "fit",
        "supervised": True,
        "trainer": trainer,
        **metrics.summary(),
        "steps": int(state.step),
        "seconds": round(elapsed, 3),
        "dim": cfg.dim,
        "k": cfg.k,
    }
    if sup.ledger.events:
        out["faults"] = sup.ledger.as_dict()
    if truth is not None:
        out["principal_angle_deg"] = round(_angle(w_host, truth), 4)
    print(json.dumps(out))
    _export_trace(args, tracer)
    if args.save:
        np.save(args.save, w_host)
    return 0


def _fit_fleet_cli(args, data, truth, dev) -> int:
    """``--mode fleet``: the dataset split into ``--fleet-size`` tenant
    shards, fit as ONE batched multi-tenant program (each shard an
    independent tenant; per-tenant angles against the synthetic truth when
    there is one)."""
    from distributed_eigenspaces_tpu_torch.config import PCAConfig
    from distributed_eigenspaces_tpu_torch.parallel.fleet import FleetPCA

    b = args.fleet_size
    if b < 1:
        print("error: --fleet-size must be >= 1", file=sys.stderr)
        return 2
    n_total, dim = data.shape
    per_tenant = n_total // b
    step_rows_min = args.workers  # at least 1 row per worker per step
    if per_tenant < step_rows_min * args.steps:
        print(
            f"error: --fleet-size {b} leaves {per_tenant} rows per "
            f"tenant; {args.workers} workers x {args.steps} steps need "
            f"at least {step_rows_min * args.steps}",
            file=sys.stderr,
        )
        return 2
    rows = args.rows_per_worker or max(1, per_tenant // (args.workers * args.steps))
    cfg = PCAConfig(
        dim=dim,
        k=args.rank,
        num_workers=args.workers,
        rows_per_worker=rows,
        num_steps=args.steps,
        discount=args.discount,
        solver=args.solver,
        eigh_crossover_d=args.eigh_crossover_d,
        subspace_iters=args.subspace_iters,
        orth_method=args.orth_method,
        warm_orth_method=args.warm_orth_method,
        compute_dtype=None if args.compute_dtype == "float32" else args.compute_dtype,
        warm_start_iters=(
            "auto" if args.warm_start_iters is None
            else (None if args.warm_start_iters == 0 else args.warm_start_iters)
        ),
        fleet_bucket_size=b,
        fleet_slo_p99_ms=args.slo_p99_ms,
        compile_cache_dir=args.compile_cache,
    )
    tracer = _make_tracer(args)
    problems = [data[t * per_tenant : (t + 1) * per_tenant] for t in range(b)]
    fleet = FleetPCA(cfg, device=dev)
    prewarmed = False
    if args.prewarm:
        # acquire the B-padded fleet programs off-thread BEFORE the timed fit
        # (runtime/prewarm.py): the timed region then runs ready programs,
        # which is what a serving deployment sees
        from distributed_eigenspaces_tpu_torch.parallel.fleet import (
            acquire_fleet_programs,
            fleet_mesh,
        )
        from distributed_eigenspaces_tpu_torch.runtime.prewarm import Prewarmer
        from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
            compile_cache_for,
        )

        with Prewarmer() as pw:
            pw.submit(
                ("fleet", repr(cfg)),
                lambda: acquire_fleet_programs(
                    cfg, fleet_mesh(b, dev), masked=False, b_pad=b,
                    fit_cache=fleet._fit_cache,
                    compile_cache=compile_cache_for(cfg), device=dev,
                ),
            )
            prewarmed = pw.wait(timeout=600)
    from distributed_eigenspaces_tpu_torch.utils.telemetry import (
        NULL_TRACER,
        slo_summary,
    )

    tr = tracer if tracer is not None else NULL_TRACER
    t0 = time.time()
    with tr.span(
        "fleet_fit", trace_id=tr.new_trace("fleet"), category="fleet",
        device=True, attrs={"tenants": b, "dim": dim, "k": args.rank},
    ):
        fleet.fit(problems)
    elapsed = time.time() - t0
    _report_lifecycle(args)
    out = {
        "mode": "fleet",
        "tenants": b,
        "includes_compile": True,
        **({"prewarmed": True} if prewarmed else {}),
        "fits_per_sec": round(b / elapsed, 2),
        "seconds": round(elapsed, 3),
        "steps_per_tenant": args.steps,
        "dim": dim,
        "k": args.rank,
    }
    if args.slo_p99_ms is not None:
        # one bucket dispatch: every tenant's fit latency is the dispatch
        # wall time, reported against the declared target
        out["slo"] = {"fleet": slo_summary(args.slo_p99_ms, [elapsed * 1e3] * b)}
    if truth is not None:
        angles = [round(_angle(fleet.components_[t], truth), 4) for t in range(b)]
        out["principal_angle_deg_max"] = max(angles)
        out["principal_angle_deg"] = angles
    print(json.dumps(out))
    _export_trace(args, tracer)
    if args.save:
        np.save(args.save, fleet.components_)
    return 0


def _serve_cli(args, cfg, data, truth, dev) -> int:
    """``--mode serve``: fit, publish to the versioned registry, serve a
    micro-batched query burst through ``serving.QueryServer``, and report
    qps, latency percentiles, occupancy and the served version: the
    end-to-end read path."""
    import torch

    from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
    from distributed_eigenspaces_tpu_torch.serving import EigenbasisRegistry, QueryServer
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    tracer = _make_tracer(args)
    # --replicas N with --registry-dir: publish under the exclusive lease and
    # serve through N read-only replica tailers of the committed store
    replicated = cfg.registry_dir is not None and cfg.replicas > 1
    lease = None
    if replicated:
        from distributed_eigenspaces_tpu_torch.serving import PublisherLease

        lease = PublisherLease(
            cfg.registry_dir, owner="cli-serve", lease_ms=cfg.publisher_lease_ms,
        ).acquire(timeout_s=30.0)
        lease.start_heartbeat()
    registry = EigenbasisRegistry(
        keep=cfg.serve_keep_versions, registry_dir=cfg.registry_dir, lease=lease,
    )
    live = registry.latest()
    warm_restart = live is not None and live.signature == (cfg.dim, cfg.k)
    est = None
    fit_s = 0.0
    if warm_restart:
        # durable-registry restart: the committed latest serves bit-exact
        # with ZERO refit (the crash-recovery contract)
        version = live
    else:
        est = OnlineDistributedPCA(cfg, device=dev)
        t0 = time.time()
        est.fit(data, tracer=tracer)
        fit_s = time.time() - t0
        version = registry.publish_fit(est, lineage={"producer": "cli"})

    grown = None
    if args.grow_k is not None:
        if est is None:
            # a warm restart recovered a committed basis but no fitted state:
            # there is no covariance operand to deflate against
            print(
                "error: --grow-k needs a fresh fit in this process (the "
                "grow fit deflates the parent lanes against the fitted "
                "covariance operand; the warm-restarted registry holds "
                "only the basis) — point --registry-dir elsewhere or "
                "drop the flag",
                file=sys.stderr,
            )
            return 2
        from distributed_eigenspaces_tpu_torch.solvers.deflation import grow_basis

        if hasattr(est.state, "sigma_tilde"):
            sig = est.state.sigma_tilde.float()

            def matvec(v):
                return torch.matmul(sig, v)
        else:
            # low-rank carry (feature-sharded backend): sigma ~= U S U^T
            u_f, s_f = est.state.u.float(), est.state.s.float()

            def matvec(v):
                return torch.matmul(u_f * s_f, torch.matmul(u_f.mT, v))
        # the new directions' start, drawn on the host from a fixed seed
        v_init = torch.randn((cfg.dim, args.grow_k - cfg.k),
                             generator=torch.Generator().manual_seed(7)).to(dev)
        t0 = time.time()
        v_g, grow_info = grow_basis(
            matvec, torch.as_tensor(_host(version.v), device=dev),
            args.grow_k, iters=cfg.subspace_iters, tol=cfg.solver_tol,
            v_init=v_init, with_info=True,
        )
        grow_s = time.time() - t0
        version = registry.publish_grown(version, _host(v_g), lineage={"producer": "cli"})
        grown = {
            "grown_version": version.version,
            "grew_from": version.lineage["grew_from"],
            "k_from": version.lineage["k_from"],
            "k_to": version.lineage["k_to"],
            "grow_seconds": round(grow_s, 3),
        }
        # the burst serves the GROWN version: the server's signature follows
        # k', and the bit-exactness check compares against the grown basis
        cfg = dataclasses.replace(cfg, k=args.grow_k)
        est = None

    r = max(1, args.serve_rows)
    n_q = max(1, args.serve_queries)
    n_total = len(data)
    queries = [
        _host(data[(i * r) % max(1, n_total - r):][:r]) for i in range(n_q)
    ]
    metrics = MetricsLogger(
        stream=sys.stderr if args.metrics else None,
        retention=cfg.metrics_retention,
    )
    if grown is not None:
        # the grow fit's convergence counters ride the solver channel
        metrics.solver({
            "kind": "grow",
            "iters_used": int(grow_info["iters_used"]),
            "residual": float(grow_info["residual"]),
            "max_iters": cfg.subspace_iters,
            **({"tol": cfg.solver_tol} if cfg.solver_tol is not None else {}),
        })
    if tracer is not None:
        metrics.attach_tracer(tracer)
    from distributed_eigenspaces_tpu_torch.utils.compile_cache import compile_cache_for

    cc = compile_cache_for(cfg)
    if cc is not None:
        metrics.attach_compile(cc)
    prewarm_stats = None
    # expected dispatch sizes: every micro-batch of 1 to serve_bucket_size
    # queries (the flush timer can cut a batch short, and a short batch
    # pads to its own power-of-two bucket)
    prewarm = (
        tuple(r * q for q in range(1, cfg.serve_bucket_size + 1))
        if args.prewarm else False
    )
    replica_regs = []
    if replicated:
        from distributed_eigenspaces_tpu_torch.serving import ReplicaRegistry

        replica_regs = [
            ReplicaRegistry(
                cfg.registry_dir, name=f"replica-{i}",
                keep=cfg.serve_keep_versions,
                staleness_ms=cfg.replica_staleness_ms,
                poll_s=0.005, metrics=metrics,
            )
            for i in range(cfg.replicas)
        ]
    t0 = time.time()
    try:
        if replica_regs:
            # one QueryServer a replica, the burst round-robined across
            # them: every replica serves the committed latest it tailed off
            # disk, bit-exact against the publisher
            servers = [
                QueryServer(rr, cfg, metrics=metrics, prewarm=prewarm, device=dev)
                for rr in replica_regs
            ]
            try:
                if args.prewarm:
                    for srv in servers:
                        srv.wait_warm(timeout=600)
                    prewarm_stats = servers[0].prewarmer.stats()
                results = _results(args, [servers[i % len(servers)].submit(q)
                                           for i, q in enumerate(queries)])
            finally:
                for srv in servers:
                    srv.close()
        else:
            with QueryServer(registry, cfg, metrics=metrics, prewarm=prewarm,
                             device=dev) as srv:
                if args.prewarm:
                    # the zero-stall guarantee needs the fence: wait, THEN
                    # serve (the first request acquires nothing)
                    srv.wait_warm(timeout=600)
                    prewarm_stats = srv.prewarmer.stats()
                results = _results(args, [srv.submit(q) for q in queries])
    finally:
        for rr in replica_regs:
            rr.close()
        if lease is not None:
            lease.stop_heartbeat()
    elapsed = time.time() - t0

    # served projections must equal the direct projection exactly: for
    # float32 the estimator's transform (the warm-restart path has no
    # estimator: the recovered basis through the same fp32 projection); for
    # bfloat16 / int8 the same serve kernel on the query alone, so the check
    # holds the bucket's padding and batching to bit-exactness (the
    # reference compares those with the fp32 transform, which its quantized
    # kernels cannot equal: its quantized serve runs exit 1)
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    basis = torch.as_tensor(_host(version.v)).to(dev).contiguous()

    def direct(q):
        x = torch.as_tensor(q).to(dev).contiguous()
        if cfg.serve_dtype == "int8":
            return _host(sp.serve_project_i8_auto(x, *sp.quantize_basis_i8(basis)))
        if cfg.serve_dtype == "bfloat16":
            return _host(sp.serve_project_auto(x, basis))
        if est is not None:
            return _host(est.transform(q))
        return _host(sp.project_exact(x, basis))

    max_err = max(
        float(np.abs(np.asarray(res.z) - direct(q)).max())
        for q, res in zip(queries, results)
    )
    summary = metrics.summary()
    out = {
        "mode": "serve",
        "version": version.version,
        "signature": list(version.signature),
        **(
            {
                "warm_restart": True,
                "recovered_versions": registry.recovered_versions,
                "refits": 0,
            }
            if warm_restart else {}
        ),
        **(
            {"registry_torn_skipped": registry.torn_skipped}
            if registry.torn_skipped else {}
        ),
        **(
            {"registry_quarantined": registry.quarantined}
            if registry.quarantined else {}
        ),
        **(grown or {}),
        "queries": n_q,
        "rows_per_query": r,
        "includes_compile": True,
        "fit_seconds": round(fit_s, 3),
        "serve_seconds": round(elapsed, 3),
        "max_abs_err_vs_direct": max_err,
        **summary.get("serving", {}),
        **(
            {"replicas": cfg.replicas, "replication": summary.get("replication", {})}
            if replicated else {}
        ),
        **({"slo": summary["slo"]} if "slo" in summary else {}),
        **({"solver": summary["solver"]} if "solver" in summary else {}),
        **({"prewarm": prewarm_stats} if prewarm_stats else {}),
        **({"compile_cache": cc.stats()} if cc is not None else {}),
        "dim": cfg.dim,
        "k": cfg.k,
    }
    if truth is not None:
        out["principal_angle_deg"] = round(_angle(np.asarray(version.v), truth), 4)
    print(json.dumps(out))
    _export_trace(args, tracer)
    if args.save:
        np.save(args.save, np.asarray(version.v))
    return 0 if max_err == 0.0 else 1


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _validate(args) -> int:
    """The reference's validation exits, in its order: 2 with the offending
    flag named, else 0."""
    if args.mode == "slave":
        print(
            "No slave processes here: every 'worker' is a slice of the "
            "batch on the card (or of a torch.distributed rank's share) and "
            "the merge is a reduction there. Run --mode oneshot or --mode "
            "fit in the process that owns the card.",
            file=sys.stderr,
        )
        return 2
    if args.broker is not None:
        print(
            f"note: --broker {args.broker} ignored (no message broker; "
            "ranks meet over torch.distributed)",
            file=sys.stderr,
        )
    if args.trace_out and args.mode in ("oneshot", "master"):
        print(
            "note: --trace-out covers the fit/fleet/serve modes; the "
            "one-shot round is a single dispatch with nothing to "
            "decompose — flag ignored",
            file=sys.stderr,
        )
    if args.components > 1 and args.solver != "deflation":
        return _error(
            f"--components {args.components} requires --solver deflation "
            "(only the parallel-deflation eigensolve shards eigenvector "
            "lanes over the 'components' mesh axis)"
        )
    if args.grow_k is not None:
        if args.mode != "serve":
            return _error(
                "--grow-k widens a PUBLISHED basis and serves the grown "
                "version — it only applies to --mode serve"
            )
        if args.grow_k <= args.rank:
            return _error(
                f"--grow-k {args.grow_k} must exceed --rank {args.rank} "
                "(shrinking is a slice of the parent, not a grow)"
            )
    if (
        args.warm_start_iters
        and args.solver not in ("subspace", "distributed", "deflation")
        and args.trainer != "sketch"
    ):
        # an explicit 0 ("disable") is solver-independent; a positive count
        # needs the iterative solver, except on the sketch trainer, which
        # honors warm_start_iters with any solver
        return _error(
            "--warm-start-iters requires --solver subspace (warm start "
            "initializes the iterative solver; eigh has nothing to "
            "warm-start). The sketch trainer is exempt (--trainer sketch): "
            "it honors warm-start-iters with any solver."
        )
    if args.resume and not args.checkpoint_dir:
        return _error("--resume needs --checkpoint-dir (nowhere to restore from)")
    if args.prewarm and args.mode not in ("serve", "fleet"):
        return _error(
            "--prewarm applies to the serving modes (--mode serve / fleet), "
            "where a background lane keeps the kernels' build and the "
            "libraries' start-up off the dispatch thread; a plain --mode fit "
            "pays them inline either way (use --compile-cache to make the "
            "NEXT process start warm)"
        )
    if args.pipeline_merge:
        # clean CLI errors for the combinations PCAConfig / the trainers
        # would reject three layers down
        if args.solver not in ("subspace", "distributed") or args.warm_start_iters == 0:
            return _error(
                "--pipeline-merge requires --solver subspace with warm starts "
                "enabled (the pipeline overlaps the merge with the NEXT "
                "step's warm solves from a one-step-stale basis; eigh / "
                "all-cold runs have nothing to pipeline)"
            )
        if args.checkpoint_dir or args.supervise:
            return _error(
                "--pipeline-merge fits cannot checkpoint or run supervised "
                "(the pipelined carry is not checkpointable state); use "
                "--merge-interval alone for a resume-safe steady-state win"
            )
    return 0


def _merge_topology(args):
    """``(topology, exit_code)``: the parsed ``--merge-topology``, or the
    exit code of a malformed one."""
    if not args.merge_topology:
        return None, 0
    try:
        parsed = []
        for part in (p.strip() for p in args.merge_topology.split(",")):
            if not part:
                continue
            tier_name, _, fan = part.partition(":")
            if not tier_name.strip() or not fan:
                raise ValueError(part)
            parsed.append((tier_name.strip(), int(fan)))
        if not parsed:
            raise ValueError(args.merge_topology)
    except ValueError:
        return None, _error(
            "--merge-topology must be 'name:fan_in,name:fan_in' leaf->root "
            f"(e.g. 'chip:4,host:2'), got {args.merge_topology!r}"
        )
    if args.pipeline_merge:
        return None, _error(
            "--merge-topology is incompatible with --pipeline-merge (the "
            "pipelined body overlaps the FLAT merge schedule; pick one)"
        )
    return tuple(parsed), 0


def _apply_plan(args) -> int:
    """``--plan PATH``: load the ``plan-v1`` artifact, run its self-check
    (exit 2 on any violation: a plan that fails its own audit is stale or
    hand-edited), then copy its workload fields and chosen
    ``config_overrides`` onto the flags and print the ``note:`` line, as
    the reference's CLI does. Returns 0 or the exit code."""
    from distributed_eigenspaces_tpu_torch.analysis import planner

    plan = planner.load_plan(args.plan)
    if plan is None:
        print(f"error: --plan {args.plan}: no such plan artifact", file=sys.stderr)
        return 2
    viols = planner.self_check(plan)
    if viols:
        for v in viols:
            print(f"error: --plan {args.plan}: {v.format()}", file=sys.stderr)
        return 2
    workload = plan.get("workload") or {}
    for field, attr in (
        ("m", "workers"), ("k", "rank"), ("d", "dim"),
        ("n", "rows_per_worker"), ("slo_p99_ms", "slo_p99_ms"),
    ):
        if workload.get(field) is not None:
            setattr(args, attr, workload[field])
    over = (plan.get("chosen") or {}).get("config_overrides") or {}
    for knob, attr in (
        ("merge_interval", "merge_interval"),
        ("pipeline_merge", "pipeline_merge"),
        ("replicas", "replicas"),
        ("serve_bucket_size", "serve_bucket"),
        ("serve_continuous", "serve_continuous"),
        ("serve_flush_s", "serve_flush_s"),
    ):
        if knob in over:
            setattr(args, attr, over[knob])
    if over.get("merge_topology"):
        args.merge_topology = ",".join(
            f"{name}:{fan}" for name, fan in over["merge_topology"]
        )
    print(
        f"note: --plan {args.plan}: applied {plan['plan_id']} "
        f"({', '.join(sorted(over))})",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.plan:
        err = _apply_plan(args)
        if err:
            return err
    err = _validate(args)
    if err:
        return err
    merge_topology, err = _merge_topology(args)
    if err:
        return err

    from distributed_eigenspaces_tpu_torch.config import PCAConfig

    if args.population is not None:
        if args.mode != "fit":
            return _error(
                "--population runs the sampled-cohort ingest tier (mode fit "
                "only); serve/fleet tiers consume the published basis, they "
                "do not ingest"
            )
        dev = _device(args)
        # the population tier SIMULATES its clients: no data file
        cfg = PCAConfig(
            dim=args.dim,
            k=args.rank,
            num_workers=args.workers,
            rows_per_worker=args.rows_per_worker or 16,
            num_steps=args.steps,
            heartbeat_timeout_ms=args.heartbeat_timeout_ms,
            min_quorum_frac=args.min_quorum_frac,
            merge_topology=merge_topology,
            population=args.population,
            cohort_size=args.cohort_size,
            min_participation_frac=args.min_participation_frac,
            max_poison_frac=args.max_poison_frac,
        )
        return _fit_population(args, cfg, dev)

    dev = _device(args)
    if args.compile_cache:
        from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
            configure_persistent_cache,
        )

        # layer 1 before anything is built: the kernels land in DIR/kernels
        configure_persistent_cache(args.compile_cache)
    data, truth = _load(args, dev)
    n_total, dim = data.shape

    if args.mode in ("oneshot", "master"):
        if args.backend == "feature_sharded":
            return _error(
                "--mode oneshot runs a single WorkerPool round; --backend "
                "feature_sharded is only available with --mode fit (use "
                "--backend shard_map here)"
            )
        from distributed_eigenspaces_tpu_torch.algo.online import one_shot_round

        # the reference master's semantics (one round), the result produced
        m = args.batches or args.workers
        rows = n_total // m
        x = _rows(data, 0, m * rows, dev).reshape(m, rows, dim)
        t0 = time.time()
        _sigma_bar, v_bar = one_shot_round(x, args.rank, backend=args.backend,
                                           device=dev)
        v_host = _host(v_bar)
        elapsed = time.time() - t0
        _report_lifecycle(args)
        print(json.dumps({
            "mode": "oneshot",
            "workers": m,
            "rows_per_worker": rows,
            "dim": dim,
            "k": args.rank,
            "seconds": round(elapsed, 3),
        }))
        if args.save:
            np.save(args.save, v_host)
        return 0

    if args.mode == "fleet":
        return _fit_fleet_cli(args, data, truth, dev)

    rows = args.rows_per_worker or max(1, n_total // (args.workers * args.steps))
    cfg = PCAConfig(
        dim=dim,
        k=args.rank,
        num_workers=args.workers,
        rows_per_worker=rows,
        num_steps=args.steps,
        discount=args.discount,
        backend=args.backend,
        solver=args.solver,
        eigh_crossover_d=args.eigh_crossover_d,
        subspace_iters=args.subspace_iters,
        solver_tol=args.solver_tol,
        components_axis_size=args.components,
        orth_method=args.orth_method,
        warm_orth_method=args.warm_orth_method,
        compute_dtype=None if args.compute_dtype == "float32" else args.compute_dtype,
        warm_start_iters=(
            "auto" if args.warm_start_iters is None
            else (None if args.warm_start_iters == 0 else args.warm_start_iters)
        ),
        merge_interval=args.merge_interval,
        pipeline_merge=args.pipeline_merge,
        merge_topology=merge_topology,
        serve_slo_p99_ms=args.slo_p99_ms,
        fleet_slo_p99_ms=args.slo_p99_ms,
        compile_cache_dir=args.compile_cache,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
        round_deadline_ms=None if args.round_deadline_ms == 0 else args.round_deadline_ms,
        min_quorum_frac=args.min_quorum_frac,
        population=args.population,
        cohort_size=args.cohort_size,
        min_participation_frac=args.min_participation_frac,
        max_poison_frac=args.max_poison_frac,
        plan_path=args.plan,
    )

    if args.mode == "serve":
        cfg = dataclasses.replace(
            cfg,
            serve_bucket_size=args.serve_bucket,
            serve_flush_s=args.serve_flush_s,
            registry_dir=args.registry_dir,
            replicas=args.replicas,
            replica_staleness_ms=args.replica_staleness_ms,
            publisher_lease_ms=args.publisher_lease_ms,
            serve_queue_depth=args.serve_queue_depth,
            serve_breaker_threshold=args.breaker_threshold,
            serve_continuous=args.serve_continuous,
            serve_dtype=args.serve_dtype,
        )
        return _serve_cli(args, cfg, data, truth, dev)

    if args.supervise:
        if args.trainer == "sketch" or (
            args.trainer == "scan" and args.backend == "feature_sharded"
        ):
            return _error(
                "--supervise covers the per-step loop (--trainer step, any "
                "backend — feature_sharded included) and the dense "
                "segmented whole-fit (--trainer scan); the feature-sharded "
                "whole-fit trainers checkpoint/resume via --checkpoint-dir/"
                "--resume without supervision"
            )
        return _fit_supervised(args, cfg, data, truth, dev)

    if args.trainer == "sketch":
        if args.backend != "feature_sharded":
            return _error(
                "--trainer sketch runs on the feature-sharded mesh (its "
                "whole point is the rank-r sharded carry); add --backend "
                "feature_sharded"
            )
        return _fit_feature_whole(args, cfg, data, truth, dev)

    if args.trainer == "scan":
        if args.backend == "feature_sharded":
            # the feature-sharded scan whole-fit: exact rank-r carry, never
            # a d x d matrix (the dense scan trainer's state)
            return _fit_feature_whole(args, cfg, data, truth, dev)
        return _fit_scan(args, cfg, data, truth, dev)

    return _fit_step(args, cfg, data, truth, dev)


def _fit_step(args, cfg, data, truth, dev) -> int:
    """The per-step online loop (``--trainer step``): metrics, checkpoints
    and ``--resume`` through the per-step hooks."""
    from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
    from distributed_eigenspaces_tpu_torch.data.stream import block_stream
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger
    from distributed_eigenspaces_tpu_torch.utils.telemetry import NULL_TRACER
    from distributed_eigenspaces_tpu_torch.utils.tracing import profile_to

    est = OnlineDistributedPCA(cfg, device=dev)
    n_total, dim = data.shape
    rows_per_step = cfg.num_workers * cfg.rows_per_worker
    callbacks = []
    tracer = _make_tracer(args)
    metrics = MetricsLogger(
        samples_per_step=rows_per_step,
        stream=sys.stderr if args.metrics else None,
        reference_subspace=truth,
        retention=cfg.metrics_retention,
    ).start()
    if tracer is not None:
        metrics.attach_tracer(tracer)
    callbacks.append(metrics.on_step)
    cursor = 0
    if args.checkpoint_dir:
        ckpt = Checkpointer(args.checkpoint_dir, every=args.checkpoint_every,
                            rows_per_step=rows_per_step, device=dev)
        callbacks.append(ckpt.on_step)
        if args.resume:
            want = "lowrank" if cfg.backend == "feature_sharded" else "online"
            restored, cursor, err = _resume_from(ckpt, want, cfg.k)
            if err:
                return err
            if restored is not None:
                est.state = restored

    def on_step(t, state, v_bar):
        for cb in callbacks:
            cb(t, state, v_bar)

    # continue the stream where the checkpoint left off (never replay folded
    # rows) and bound it to the remaining step budget: the online loop's own
    # cap is open-ended for 1/t
    done = int(est.state.step) if est.state is not None else 0
    remaining = max(0, args.steps - done)
    if remaining and (n_total - cursor) >= rows_per_step:
        stream = block_stream(
            data[cursor:],
            num_workers=cfg.num_workers,
            rows_per_worker=cfg.rows_per_worker,
            num_steps=remaining,
            remainder=cfg.remainder,
            device=dev,
        )
    else:
        stream = iter(())  # budget spent or no unseen data left

    tr = tracer if tracer is not None else NULL_TRACER
    fit_tid = tr.new_trace("fit")
    if tracer is not None:
        # per-step spans (metrics.on_step) join the run's trace
        metrics._fit_trace = fit_tid
    with profile_to(args.profile_dir), tr.span(
        "fit_stream", trace_id=fit_tid, category="fit", device=True,
        attrs={"dim": dim, "k": args.rank},
    ):
        est.fit_stream(stream, on_step=on_step, max_steps=None)

    w_host = _host(est.components_)
    _report_lifecycle(args)
    out = {"mode": "fit", **metrics.summary(), "dim": dim, "k": args.rank}
    print(json.dumps(out))
    _export_trace(args, tracer)
    if args.save:
        np.save(args.save, w_host)
    return 0


if __name__ == "__main__":
    sys.exit(main())
