#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

1. env: versions, the card (``nvidia-smi``), and the fp32 matmul
   precision (no TF32), which the port relies on but never sets.
2. build, build_serve, build_matvec_gram, build_mutant, build_s8:
   ``csrc/gram.cu``, ``csrc/serve_project.cu``, ``csrc/matvec_gram.cu``,
   ``csrc/mutant_full_block.cu`` and ``csrc/gram_s8.cu`` compiled with nvcc
   for sm_90a, one process each, started together (seconds; per kernel
   instantiation its ptxas registers, spill stores and shared memory).
3. parity: the Gram kernels against their plain PyTorch version on the
   card, fp32 and bf16, at the entry shape (4, 128, 256), the CIFAR-10
   shape (8, 1024, 3072) and a ragged (3, 1000, 3000): relative Frobenius
   error <= 1e-5 (fp32) / 1e-4 (bf16), exactly symmetric; bf16 at these
   shapes takes the TMA + wgmma kernel (``launches_tma``). Then bf16 that
   TMA cannot read, on the ``mma.sync`` kernel (``launches`` moves,
   ``launches_tma`` does not), to the same tolerance: (3, 1000, 3001) and
   the ragged shape on a base 2 bytes off a 16-byte boundary; and bf16 at a
   mesh rank's share of mnist784's block, (4, 1024, 784), and a tiered
   rank's leaf worker, (1, 1024, 3072), on the TMA kernel. Then fp32 on
   every tile edge and copy width of its shape rule (``F32_CASES``: d = 3001,
   n = 1, a base 4 bytes off a 16-byte boundary) and at the scenario
   replays' blocks (``SCENARIO_GRAMS``), each launch recorded as
   ``gram_launch`` says.
4. timing: kernel, plain version, ``torch.bmm`` yardstick and the bound,
   with CUDA events (median of 25 after warm-up), and the device time of
   the kernel and of the yardstick under ``torch.profiler``; for bf16 x
   the yardstick is ``torch.bmm(..., out_dtype=float32)``, which writes the
   kernel's fp32 output, where this torch has it (the bf16-output ``bmm``
   beside it). Then one CIFAR-shape bf16 launch and one fp32 launch at the
   entry and the CIFAR shape, each under the launch recorder and the
   profiler: its profiled grid, block and shared memory must equal its
   ``gram_launch`` record.
4b. parity_gram_s8, gram_s8_geometry, timing_gram_s8: the s8 Gram (int8
   blocks: a transpose into x^T, then the TMA + wgmma kernel) against its
   plain version (float64 sums, one rounding, a true division) at the
   CIFAR-10 block (8, 1024, 3072), synthetic1024's (8, 2048, 1024),
   mnist784's (8, 1024, 784), clip768's (8, 2048, 768), (3, 1000, 1000),
   (1, 1000, 9), a mesh rank's (4, 1024, 784) and the real-data check's
   clip768 block (4, 256, 768), each on an
   aligned base and one byte off it: the transpose equal to its plain
   version (pad rows included), the Gram equal bit for bit and exactly
   symmetric, every instance of both kernels taken; both profiled launches
   equal to ``gram_s8_launch``'s record at CIFAR and (1, 1000, 9); at the
   four eval blocks the pair's one-call time, the device time of both
   launches and of the transpose, the bound, the plain version,
   ``torch._int_mm`` over the workers with the transpose copy, and the bf16
   TMA kernel on the block widened beforehand.
5. slice: ``entry()``'s step 10 times (10 Gram launches), checked against
   the same step on the CPU; then ``OnlineDistributedPCA`` at the
   CIFAR-10 shape (d=3072, k=10, m=8, n=1024, T=20, subspace 12 / warm 2,
   bf16) on planted-spectrum data, which must recover the planted top-10
   within 1 degree with exactly one Gram launch (the cold step), on the
   TMA kernel. 5c. slice_fit_eval: the cifar10 and the synthetic1024
   evals' own settings (int8 stage, ``warm_orth_method="ns"``) on their
   ``planted_subspace`` data: each exactly one s8 call (a transpose and a
   TMA launch) and no other Gram kernel, ns on all 19 warm rounds, within 1
   degree of the planted top-k, both fits' wall seconds.
5d. slice_clip768: the clip768 eval's own route (d=768, k=256, m=8,
   n=2048, T=10, subspace 8 / 2 warm, bf16): 4 blocks of its
   ``planted_subspace`` quantized with one global int8 scale by the native
   ``absmax_f32`` / ``quantize_i8`` and written cyclically to a 126 MB row
   file under ``build/``, then ``bin_block_stream`` (int8 passed through)
   -> ``window_stream`` of 5 -> ``prefetch_stream`` (depth 1) ->
   ``make_segmented_fit(segment=5).fit_windows`` -> ``extract_dense``:
   within 1 degree of the planted top-256, exactly 10 s8 calls and no float
   Gram launch, two windows, the native reader built; run twice (the same
   bits), with fit seconds, samples/s and the prefetch counters.
5e. slice_clip768_resume: the same fit checkpointed on ``on_segment`` and
   stopped after window 1, restored by ``Checkpointer.latest()`` and
   continued from ``bin_block_stream(start_row=cursor)``: ``sigma_tilde``
   and ``v_prev`` bit-equal to the unkilled run's; then the newest
   checkpoint's ``state.npz`` torn: quarantined, the ladder steps back.
5f. slice_fit_eval_segmented: the cifar10 eval's settings through
   ``OnlineDistributedPCA(cfg, checkpoint_dir=..., segment=5)``: the
   segmented trainer, 4 commits (steps 5, 10, 15, 20; the two newest kept),
   ``sigma_tilde`` within 1e-6 relative of the scan fit's (bit-equal
   expected) and equal to the same trainer's without checkpoints (whose
   time shows what the commits cost), one s8 call, within 1 degree.
5g. slice_fit_masked: the same settings with a (20, 8) mask sequence
   (worker 3 off on steps 4-9, every worker off on step 12): the masked
   whole fit (``trainer_used_ == "scan"``) against ``trainer="step"`` on
   the same masks, ``sigma_tilde`` within 1e-4 and components within 0.05
   degrees, within 1 degree of the planted top-10.
5h. slice_fit_interval: the same settings with ``merge_interval=2``, then
   with ``pipeline_merge=True`` too: within 1 degree each, the merged
   eigensolve on exactly 10 of the 20 rounds.
5i. slice_grow: the CLI's ``--grow-k`` path at the same settings: the fit
   published to an on-disk ``EigenbasisRegistry`` under a
   ``PublisherLease``, grown to k' = 20 by ``grow_basis`` on
   ``sigma_tilde``'s matvec and published with ``publish_grown`` (prefix bit
   for bit the parent, lineage ``grew_from`` / ``k_from`` / ``k_to``,
   ||V^T V - I|| <= 1e-5); a ``ReplicaRegistry`` tailing the directory
   installs it (one grown install, payload bit-equal, no version lag,
   propagation within its 500 ms bound); a ``QueryServer`` on the replica
   serves 32 queries of 64 rows at bfloat16 and at int8, every row within 0.2
   degrees of the fp32 projection on the grown basis, the serve kernel
   launched once per dispatch.
5j. slice_drift: the serve -> drift -> refit -> swap loop at the same
   settings: the fit's basis served (float32) with a ``DriftMonitor(
   supervise=True, buffer_rows=32768, auto=True, metrics=MetricsLogger())``
   attached; 64 queries of 512 rows of the fit's own data, then rows of
   ``planted_subspace(3072, seed=1)`` one query a batch until the monitor
   arms (its EWMA weight set so that this happens after its ring holds
   shifted rows only); exactly one refresh published, within 1 degree of the
   seed-1 top-10, the server's next batches on the new version with a lower
   residual ratio, the supervised refit's one bf16 TMA Gram launch, its
   drift event and steps in the logger, the refit seconds and the swap
   latency. Then a second ``DriftMonitor(supervise=False, auto=False)`` on
   the same buffered rows refreshes once through the estimator: one s8
   call, within 1 degree of the seed-1 top-10.
5k. slice_mesh_eval: the mnist784 eval field for field (d=784, k=20, m=8,
   n=1024, T=20, subspace 16 / 2 warm, bf16, int8 stage, ns warm,
   ``backend="shard_map"``) on its ``planted_subspace`` data: through
   ``OnlineDistributedPCA`` in one process (no process group, so no mesh:
   one s8 call, within 1 degree), its bf16 variant (no int8 stage: one bf16
   TMA Gram launch), then the same 20 steps through ``make_train_step(cfg,
   mesh=make_mesh(1))`` on a one-rank NCCL group: ``sigma_tilde`` bit-equal
   to the same step loop without a mesh, 20 factor gathers of 8 x 784 x 20
   floats, one s8 call, the NCCL init seconds.
5l. slice_mesh_ranks2: two ranks sharing the card in one gloo group
   (``parallel.mesh.launch``; NCCL refuses two ranks on one device): the
   eval and its bf16 variant through the estimator's scan on a (2, 1) mesh
   (one s8 call and one bf16 TMA launch a rank, on (4, 1024, 784)), each
   within 0.01 degrees and 1e-5 relative ``sigma_tilde`` of the one-device
   fit, every rank's state bit-equal to rank 0's; ``dist_merged_top_k`` on
   the last step's factors within 0.05 degrees of the exact merge, which
   the parent makes over the whole block without a collective; the
   deflation lanes on a (2, 1) components mesh over bench.py --deflate's
   operand (2 lanes of 4), each lane within 0.1 degrees of the dense eigh.
5m. slice_tree_eval: the cifar10 eval field for field with
   ``merge_topology=(("chip", 4), ("host", 2))`` through the estimator in
   one process (the stacked tree at every merge): within 1 degree of the
   planted top-10 and 0.5 degrees of the flat fit on the same data and
   starts, the one-tier ``(("all", 8),)`` fit bit-equal to the flat fit, one
   s8 call; the fit's wall seconds.
5n. slice_tree_ranks4: four gloo ranks sharing the card (one
   ``parallel.mesh.launch``), rank r leaf worker r of a (host 2, chip 2)
   tiered mesh. (a) ``make_tree_scan_fit`` on the cifar10 shape under 5b's
   bf16 settings with m=4 (bf16-rounded ``planted_spectrum`` rows): the fp32
   arm within 0.2 degrees of the stacked route the parent runs on the same
   blocks and starts, the bf16 and int8 wire arms within 0.2 degrees of it
   and at most 0.2 degrees further from the truth, finite (T, 2) residual
   norms, every rank's bases bit-equal, one bf16 TMA Gram launch a rank a
   fit; from the collective recorder, per tier and arm: movers in the
   tier's wire dtype, every sum fp32, no payload above max(d k, (f k)^2)
   elements, the bytes leaving a rank a round equal to ``tier_wire_records``'
   2 (f - 1) / f d k itemsize (scale sidecars reported, compression ratios
   printed). (c) each rank's worker read back from the parent's bf16 row
   file with ``bin_block_stream(worker_range=host_worker_range(...))``:
   the fit bit-equal to the fit from memory. (b) imagenet12288 on a (1, 4)
   features mesh (3,072 columns a rank) through the estimator, the sketch
   and the rank-r scan with ``collectives="ring"`` and ``"xla"``: ring
   within atol 5e-4 and 0.01 degrees of xla, its replicated values
   bit-equal across ranks, ppermute hops and bytes printed. Cuts: m=4 (one
   worker a rank), gloo through host memory instead of NVLink, four ranks
   standing in for cards.
5o. slice_fleet_eval: the multi-tenant fleet, 8 tenants (one full bucket),
   each the mnist784 eval's settings field for field on its own
   ``planted_subspace(784, seed=b)``, ``backend="local"`` and fp32 staging
   (the reference fleet's own): ``parallel.fleet.fit_fleet`` from host
   arrays makes exactly one Gram launch (the bf16 TMA kernel at (64, 1024,
   784)); each tenant within 1 degree of its planted top-20 and 0.2 degrees
   of the port's solo scan fit on the same blocks and start; the fleet
   program's kernels (``torch.profiler``) at most 1.5 times one solo fit's;
   fits/s of the fleet program and of the 8 solo fits one after another
   (both on stacks on the card, median of 3; bench.py --fleet's A/B) and of
   ``fit_fleet`` from host arrays; syncs of each. Both sides solve their
   33- to 256-wide eigenproblems by one batched cuSOLVER call
   (``ops.cusolver.eigh``); the same programs again with torch's
   per-matrix ``eigh`` (times, angles; kernels in
   ``scripts/torch_profile_eigh.py``) give the eigensolver's share apart
   from the batching's. Then the Gram kernel at
   (64, 1024, 784) bf16 against its plain version (<= 1e-4 relative), its
   one-call and device time beside the bound and ``torch.bmm(...,
   out_dtype=float32)``.
5p. slice_fleet_solo: ``OnlineDistributedPCA(trainer="fleet")`` on the
   cifar10 eval's settings and data (a one-tenant fleet, fp32 staging):
   within 1 degree of the planted top-10 and 0.2 degrees of
   ``trainer="scan"`` on the same blocks (its bf16 stage) and start, one
   bf16 TMA Gram launch at (8, 1024, 3072); the eval's int8-stage scan
   beside it.
5q. slice_fleet_server: ``FleetServer`` at the fleet's settings,
   ``prewarm()`` and ``wait_warm()``, then 11 submits: a full bucket of 8
   and 3 flushed after ``fleet_flush_s`` and padded to 8; both buckets
   resolve, one Gram launch each, every served result equal to
   ``fit_fleet`` called directly (rtol 1e-5, atol 1e-6), the first
   bucket's ``compile_ms`` 0.0; each bucket's ``compile_ms``, queue waits
   and seconds printed. Tenant 0 of the direct result ``publish_fleet``-ed
   (lineage ``fit_fleet`` / tenant / signature) and served through
   ``QueryServer`` at bf16: a 64-query burst, every row within 0.2 degrees
   of the direct fp32 projection, one serve launch a dispatch.
5r. slice_clients: ``make_population_merge`` at the reference bench's
   population shape (d=64, k=4, cohort 256, ``max_poison_frac=0.08``), 12
   cohorts of honest summaries (noise 0.1) with 13 colluders submitting one
   orthonormal basis orthogonal to the planted one, folded: hardened within
   5 degrees of the planted basis, the naive mean at least twice as far,
   every colluder screened; merge ms.
5s. slice_fleet_ranks2: two gloo ranks sharing the card: 5o's fleet on a
   fleet mesh of 2 (four tenants a rank), the recorder showing no
   collective inside the fit and one all-gather of the results after it,
   each tenant within 0.01 degrees of the one-process fleet, one Gram
   launch a rank; ``make_sharded_cohort_reduce`` on 5r's first cohort at
   fp32 and at a bf16 wire: one stack gather in the wire dtype and one fp32
   mask gather, bit-equal across ranks, fp32 within 1e-3 degrees of the
   one-process merge. Cut: 2 ranks stand in for a fleet axis of cards; the
   gathers cross host memory.
6. parity_serve: the serve kernels (bf16, int8 and the fixed-order fp32
   one) against their plain versions at (64, 256, 8), the CIFAR-10 serve
   shape (512, 3072, 10), a ragged (1000, 3000, 10) and the bulk (65536,
   3072, 10), fp32 and bf16 x (but for the fp32 kernel, which takes fp32 x
   only); relative Frobenius error <= 1e-5, and the first 300 rows of a
   512-row launch, and the first 512 of a 65,536-row launch (one-pair
   column tiles against whole-k ones), equal, bit for bit, a launch of
   those rows alone.
7. timing_serve: kernels, plain versions, ``torch.matmul`` on the fp32
   operands (and ``torch.mm(..., out_dtype=float32)`` on bf16 ones where
   this torch has it) and the bound at the engine's 8-, 64- and 512-row
   buckets and the bulk 65,536 rows, d=3072, k=10: one call with CUDA
   events, and the device time of the kernel and of ``torch.matmul``
   under ``torch.profiler`` (20 calls; every kernel event of the 20 calls
   must be there, one per kernel call).
8. slice_serve: the read path on the fit of 5b. The basis is published
   to an ``EigenbasisRegistry``; for serve_dtype bfloat16 and int8 a
   ``QueryServer`` (its self-check passes at construction) answers 64
   queries of 1, 8 or 64 planted-spectrum rows at the default bucket of
   8 and flush of 0.02 s, with the same basis republished halfway (a hot
   swap). Every served row must lie within 0.2 degrees of
   ``est.transform`` (fp32), both versions must be served, the swap must
   acquire no bucket, and each serve kernel must launch once per
   ``project`` dispatch. Then one bulk ``project`` of 50,000 rows per
   quantized dtype, and a float32 server on the same burst, whose
   served rows must equal ``est.transform``'s bit for bit (both take the
   fixed-order fp32 kernel, once per dispatch).
9. parity_matvec_gram: the fused matvec + Gram kernel of the large-d
   solver against its plain version at (256, 64, 16), the slice shape
   (12288, 200, 58) and a ragged (3000, 80, 13) (the resident plan) and at
   (12288, 400, 58), (4000, 37, 200), (12288, 800, 58) and (2048, 96, 840)
   (the streamed plan, whose shared memory does not depend on f): relative
   Frobenius error <= 1e-5 on ``w`` and ``g``, ``g`` exactly symmetric, two
   launches bit for bit the same, each launch on its plan's kernel.
10. timing_matvec_gram: kernel, plain version, the ``torch.matmul``
   yardstick (cuBLAS's three calls) and the bound at the slice shape, one
   call with CUDA events and the device time of the kernel and of the
   three calls under ``torch.profiler``: seven windows of each, in turn,
   all printed, and their medians in the ``kernels`` line.
11. slice_dsolve: ``OnlineDistributedPCA`` with ``solver="distributed"``
   above the crossover at the ImageNet-patch shape (d=12288, k=50, m=4,
   n=2048, T=10, 16 cold / 1 warm iterations, bf16, int8 stage) on the
   imagenet12288 eval's ``planted_subspace`` data, which must recover the
   planted top-50 within 1 degree; then the fused solve on the fit's own
   operator (the last block's worker factors, from the block quantized as
   the fit staged it), which must agree with
   ``merged_top_k_distributed`` within 0.05 degrees in exactly 16 kernel
   launches (and, with ``tol=1e-6``, in as many launches as iterations);
   then ``dist_extract_top_k`` against a dense ``eigh`` at d=12288, r=100
   within 0.5 degrees.
11b. slice_deflate: the same fit with ``solver="deflation",
   components_axis_size=5`` (5 lanes of 10): within 1 degree of the planted
   top-50 (and its angle to slice_dsolve's fit), every one of the 10 merges
   on the lanes, their device syncs counted, no Gram launch (d >= 4096
   streams); one ``merged_top_k_deflation(tol=1e-3, iters=64,
   with_info=True)`` on the last block's factors, its per-lane sweeps and
   residuals, its span within 0.5 degrees of the exact merge; then on
   ``bench.py --deflate``'s operand (d=2048, rank 16, spectrum 8 * 0.5^i, k=8
   on 4 lanes) every lane of the cold, warm and grown (4 -> 8) solves within
   0.5 degrees of the dense ``eigh``, the grown prefix bit for bit the
   parent's.
11c. parity_serve_shards, timing_serve_shards: the three serve routes at
   the features path's shard shapes, k=50 and d/f = 6144 or 12288, at 8,
   64, 512 and 4,096 rows, against their plain versions (<= 1e-5 relative)
   and timed as timing_serve times them.
11d. slice_fs_eval: the imagenet12288 eval field for field (``backend=
   "feature_sharded"``, ``trainer="sketch"``, 12 cold / 1 warm, bf16, int8
   stage) on slice_dsolve's data in one process (the (1, 1) layout): within
   1 degree of the planted top-50, seconds and samples/s, beside the exact
   rank-r scan (``trainer="scan"``, its angle to the sketch) and the dense
   scan of slice_dsolve; ``backend="auto"`` picks the sketch (one warning);
   a windowed sketch fit (windows of 4) checkpointed, stopped after its
   first window, restored and resumed: bit-equal to the unkilled one.
11e. slice_fs_ranks2: two gloo ranks sharing the card (one
   ``parallel.mesh.launch``), a (1, 2) features mesh of 6,144 columns a
   rank: both fits, every replicated value (``s``, the sketch's ``omega^T
   y``, ``step``) bit-equal to rank 0's, each basis within 0.01 degrees of
   the one-process fit; rank 0 publishes the sketch basis in two shards and
   a ``ReplicaRegistry`` on each rank installs it (spec, shard sizes); each
   rank serves a 64-query burst of 1, 8 and 64 rows through
   ``QueryServer(mesh=)`` on ``TransformEngine(basis_spec=("features",
   None))`` at bf16, int8 and fp32: rows within 0.2 degrees of the direct
   fp32 projection, one psum and one serve-kernel launch (on the (rows,
   6144, 50) shard) a lockstep round.
12. parity_mutant: the analyzer's one-CTA mutant kernel against its plain
   version (``torch.matmul``) at the audit shape (256, 1024, 8) and a
   ragged (100, 1000, 5): relative Frobenius error <= 1e-5 (FFMA in index
   order against cuBLAS fp32).
13. timing_mutant: kernel, plain version, ``torch.matmul`` and the byte
   bound at (256, 1024, 8), one call with CUDA events and the device time
   of the kernel and of ``torch.matmul``.
14. analysis: the port's analyzer on the card (``run_analysis`` and
   ``run_mutation_report``, device cuda) under the launch recorder and
   ``torch.profiler``: the 27 programs honour their contracts — the 4
   single-device ones with their kernels launched, the 23 mesh programs
   (one launch of 4 gloo ranks sharing the card, every rank recording the
   same collective schedule and every rank's held shapes passing the
   declared layouts) with their collectives and byte budgets equal to the
   committed ``ANALYSIS_COSTS_TORCH.json``'s, each of the six serve mesh
   programs (row-sharded and sharded-basis) with at least one fp32 serve
   kernel launch of a resolved grid on rank 0 (in its audited bucket, or,
   for a reconstruct or residual, in the projection its build made before
   it) — every profiled kernel
   event has the grid, block and shared memory of its recorded
   ``KernelLaunch`` (one event per launch; the programs run once before
   the windows, each window opens with 64 pairs of untimed kernels, and a
   window the profiler left an event out of is run again, five windows at
   most), and 14 of 14 seeded mutations are caught, the mutant's launch
   with grid [1, 1, 1]. Rank 0's launches in the mesh programs are counted
   by kernel into the kernels line.
15. slice_evals: the port's eval harness (``distributed_eigenspaces_tpu_torch.
   evals.run_eval``) on each of the six eval specs at full size, as
   published, with the default repeats (3), one report line each: within 1
   degree of the planted top-k; the backend and trainer the reference picks
   on one device (``local`` / ``scan`` for cifar10, synthetic1024 and
   mnist784, ``feature_sharded`` / ``sketch`` for imagenet12288 and
   clip768_chip, ``local`` / ``segmented`` from an int8 ``bin`` file for
   clip768); the s8 Gram's calls, one a fit for the in-memory dense evals
   (the accuracy fit, the warm-up, three timed 240-step fits) and one a step
   for clip768's (k=256: every step takes the Gram), none for the sketch,
   and no float Gram; the matmul anchor measured (``anchor_tflops`` > 0),
   the HBM anchor measured or its failed probe recorded, ``pct_of_anchor``
   at most 105; the ``device`` block naming this card and its power limit.
16. slice_scenario (19 and 18 run before it): ``runtime.scenario.
   run_scenario`` on the card with ``scenarios/ci_smoke.json`` and
   ``production_day.json`` at mnist784's feature width (d=784, m=8, n=1024, T=20 added to each spec's ``config``
   block in memory; episodes, rates, SLOs, seeds and k=3 the spec's), then an
   in-memory spec whose churn episode kills host 1 of a (chip 2, host 2)
   tree (m=4; ``TierSet`` / ``TieredStream``): every hard gate true; per
   episode its attainment, p99 and recovery; the p99 decomposition; the
   publisher failover and the replicas' convergence, the population rounds
   and the churn fits; each replay launching the fp32 serve kernel and a
   Gram kernel and calling no plain version (each is wrapped to count).
17. slice_controller: ``bench.py --controller``'s A/B on ``controller_day``
   at the same width: the autoscaler off, on, and on with the seeded bad
   plan (``serve_flush_s=2.0``); every arm's own gates, every decision
   lineage-stamped, the bad plan rolled back; the on-over-off attainment
   comparison printed, not gated (one card, one timing).
18. slice_population: ``bench.py --population``'s four gates on the card
   (100,000 clients, cohorts of 256, d=64 k=4, 12 rounds): hardened within
   5 degrees and naive not under scaled poison; naive at least twice the
   hardened angle under orthonormal colluders; every reject ledgered, counts
   equal; the 90% outage wave collapsing, waiting and resuming; each arm's
   wall seconds.
19. slice_real_data: ``scripts/torch_real_data_check.py --offline`` on the
   clip768 and imagenet12288 row corpora synthesized to disk: ``"data":
   "real"``, ``"source": "synthesized-on-disk"`` and the loader's
   ``data_source``; each synthesized corpus's planted leading 10
   directions within 5 degrees of the fitted span (its full top-k sinks
   below the noise floor, so the angle to it is near 90 and only bounded
   by [0, 90]). Then parity_serve_scenario: the serve kernels at the
   replays' buckets, (8, 16 and 32 rows, 784, 3).
20. slice_cli: the command line, every mode, and a cold/warm pair of
   processes over one compile cache.
21. slice_plan: the committed ``ANALYSIS_PLAN_TORCH.json`` self-checked
   and equal to a replan from ``PLAN_CALIBRATION_H100.json``; ``cli.main``
   with ``--plan`` on a fit and on an fp32 serve at the plan's k=8, m=64,
   n=128 and its topology, interval and serve knobs (cut: 2 steps, and
   d=3072 for the plan's 32768, ``PLAN_CUT_D`` says why), each run's
   kernel calls held against their plain versions; the serve kernel and the two p99 terms re-measured and the
   plan's drift rows printed, a ``fail`` or ``missing`` row failing.

Then the kernel table as one JSON line and, last, the result line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet), used for bound_ms
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
TOL = {"float32": 1e-5, "bfloat16": 1e-4}
CIFAR = (8, 1024, 3072)
ENTRY = (4, 128, 256)
RAGGED = (3, 1000, 3000)
GRAM_UNALIGNED_D = (3, 1000, 3001)  # d % 8 != 0: bf16 rows TMA cannot read
# fp32 on each tile edge and copy width of the shape rule (f32_tile,
# f32_vec), as (shape, base offset in elements): edge 64 with 16-byte and
# 4-byte copies (d % 4 != 0, ragged n); edge 128 with d % 4 != 0 and on an
# unaligned base; edge 32 with n = 1; edge 32, 4-byte copies; one entry
F32_CASES = (((8, 256, 512), 0), ((8, 100, 510), 0), (GRAM_UNALIGNED_D, 0), (RAGGED, 1),
             ((2, 1, 300), 0), ((5, 37, 130), 0), ((1, 1, 1), 0))
GRAM_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/gram.cu"
GRAM_REPLACES = "distributed_eigenspaces_tpu/ops/pallas_gram.py:57"
S8_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/gram_s8.cu"
# no Pallas kernel: the JAX package's int8 Gram is an XLA einsum with int32 sums
S8_REPLACES = "distributed_eigenspaces_tpu/ops/linalg.py:64"
S8_SYNTH = (8, 2048, 1024)  # synthetic1024's block: fp32 sums would not be exact
S8_MNIST = (8, 1024, 784)  # mnist784's block: a 16-column last tile
S8_CLIP = (8, 2048, 768)  # clip768's block, every step of its segmented fit
# CIFAR-10's block, synthetic1024's, mnist784's, n = 1000 (n_pad 1008, the
# division by n) and one worker with d below one tile (d % 4 != 0: the
# register epilogue), each on an aligned base and one byte off it (byte
# loads in the transpose)
S8_PARITY = (CIFAR, S8_SYNTH, S8_MNIST, S8_CLIP, (3, 1000, 1000), (1, 1000, 9),
             (4, 1024, 784),  # a mesh rank's share of mnist784's block
             (4, 256, 768))  # the real-data check's clip768 block (slice_real_data)
S8_OFFSETS = (0, 1)
SERVE_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/serve_project.cu"
SERVE_REPLACES = {
    "bf16": "distributed_eigenspaces_tpu/ops/pallas_gram.py:184",
    "i8": "distributed_eigenspaces_tpu/ops/pallas_gram.py:232",
}
SERVE_TOL = 1e-5
SERVE_K = 10
SERVE_SLO_MS = 100.0  # the bf16 burst's declared p99 target (its logger's SLO section)
SERVE_BURST = (512, 3072, SERVE_K)  # a full bucket: 8 queries x 64 rows
SERVE_BULK = (65536, 3072, SERVE_K)  # 50,000 rows padded to their bucket
# ... and the grown basis's k' = 20 (slice_grow's burst buckets)
SERVE_PARITY = ((64, 256, 8), SERVE_BURST, (1000, 3000, SERVE_K), SERVE_BULK, (512, 3072, 20),
                (64, 3072, 20))
# rows of a launch held bit for bit against a launch of those rows alone:
# the burst's 512 rows and 300 of them take one-pair column tiles, the bulk
# launch whole-k tiles, so its first 512 rows cross the tile-width boundary
SERVE_PREFIX = {SERVE_BURST: 300, SERVE_BULK: 512}
# the engine's smallest buckets, a full one and the bulk project
SERVE_SHAPES = ((8, 3072, SERVE_K), (64, 3072, SERVE_K), SERVE_BURST, SERVE_BULK)
SERVE_F32_NOTE = ("no TPU kernel: the JAX package's fp32 projection is XLA at "
                  "Precision.HIGHEST (distributed_eigenspaces_tpu/serving/"
                  "transform.py:157-158); the port's fixed-order fp32 route, "
                  "on the split kernel with an fp32 basis")
MG_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/matvec_gram.cu"
MG_REPLACES = "distributed_eigenspaces_tpu/ops/pallas_gram.py:337"
MG_TOL = 1e-5
MG_WINDOWS = 7  # device-time windows of the kernel and of cuBLAS's three calls, in turn
MG_SLICE = (12288, 200, 58)  # C (d, m*k) and the oversampled iterate at k=50
MG_STREAMED = (12288, 400, 58)  # eight workers' factors: the slab streams
# sixteen workers' factors at k = 50, and the widest iterate the port has
# always taken (k' = 840): the streamed plan takes any f
MG_PARITY = ((256, 64, 16), MG_SLICE, (3000, 80, 13), MG_STREAMED, (4000, 37, 200),
             (12288, 800, 58), (2048, 96, 840))
def spec_fit(name: str) -> dict:
    """The ``PCAConfig`` fields of one of the port's eval specs
    (``distributed_eigenspaces_tpu_torch/evals.py``: ``EVAL_SPECS`` and
    ``eval_config``, the reference's ``evals.py:77-145`` field for field)."""
    from distributed_eigenspaces_tpu_torch.evals import EVAL_SPECS, eval_config

    cfg = eval_config(EVAL_SPECS[name])
    return {f: getattr(cfg, f) for f in SPEC_FIELDS}


def spec_data(name: str) -> dict:
    """The ``planted_subspace`` arguments of an eval's synthetic data
    (``evals.synthetic_model``: the reference's decay rule, seed 0)."""
    from distributed_eigenspaces_tpu_torch.evals import EVAL_SPECS, synthetic_model

    return synthetic_model(EVAL_SPECS[name])


SPEC_FIELDS = ("dim", "k", "num_workers", "rows_per_worker", "num_steps", "solver",
               "subspace_iters", "warm_start_iters", "warm_orth_method", "compute_dtype",
               "stage_dtype", "backend")
# the imagenet12288 eval's shape and data; slice_dsolve and slice_deflate
# run it on their own solvers
DSOLVE = {f: spec_fit("imagenet12288")[f]
          for f in ("dim", "k", "num_workers", "rows_per_worker", "num_steps")}
DSOLVE_DATA = spec_data("imagenet12288")
# the cifar10 and synthetic1024 evals
EVAL_FIT, EVAL_DATA = spec_fit("cifar10"), spec_data("cifar10")
SYNTH_FIT, SYNTH_DATA = spec_fit("synthetic1024"), spec_data("synthetic1024")
EVALS = (("cifar10", "evals.py:86-90", EVAL_FIT, EVAL_DATA),
         ("synthetic1024", "evals.py:91-95", SYNTH_FIT, SYNTH_DATA))
# the clip768 eval (distributed_eigenspaces_tpu/evals.py:121-126, 431-462,
# 625-690): int8 rows streamed from a file, the segmented trainer in windows of
# min(5, T), one global quantization scale, min(T, 4) distinct blocks
CLIP_FIT, CLIP_DATA = spec_fit("clip768"), spec_data("clip768")
CLIP_DISTINCT = min(CLIP_FIT["num_steps"], 4)
CLIP_SEGMENT = max(1, min(5, CLIP_FIT["num_steps"]))
# the masked cifar10-settings fit: worker 3 dropped on steps 4-9, every
# worker on step 12 (1-based steps)
MASK_DROPS = ((range(3, 9), 3), ((11,), slice(None)))
FIT_SIGMA_ATOL = 1e-4  # the port's parity tolerances (tests/test_torch_step.py)
FIT_ANGLE_DEG = 0.05
MUTANT_SOURCE = "distributed_eigenspaces_tpu_torch/csrc/mutant_full_block.cu"
MUTANT_REPLACES = "distributed_eigenspaces_tpu/analysis/mutations.py:352"
MUTANT_TOL = 1e-5
MUTANT_AUDIT = (256, 1024, 8)  # the JAX mutant's (rows, d, k)
MUTANT_PARITY = (MUTANT_AUDIT, (100, 1000, 5))
ANALYSIS_PROGRAMS = 27  # 4 in this process, 23 on 4 gloo ranks sharing the card
ANALYSIS_MUTATIONS = 14
#: the mesh programs that serve through the engine: each launches the fp32
#: serve kernel on every rank (rank 0's launches are recorded)
ANALYSIS_SERVE_MESH = ("serve_project", "serve_reconstruct", "serve_residual",
                       "dist_serve_project", "dist_serve_reconstruct",
                       "dist_serve_residual")
#: what the card's run of the mesh programs is held to in the committed cost
#: snapshot (the FLOP and byte fields are the CPU's: costmodel.py)
ANALYSIS_SNAPSHOT_KEYS = ("collectives_per_axis", "budget_bytes_per_op")
ANALYSIS_WINDOWS = 5  # profiled windows of the analysis phase at most
# profiler_warm's kernel pairs opening each profiled window (the analysis
# phase's and every device_ms window): a window after many earlier ones lost
# its first 19 kernel events (a timed call's included)
ANALYSIS_WARM_ROUNDS = 64
# the deflation route at the imagenet12288 shape: slice_dsolve's config with
# the merge on 5 parallel-deflation lanes of 10
DEFLATE_LANES = 5
# bench.py --deflate's operand at its timing shape (bench.py:2966-3062): U
# diag(s) U^T of rank 16, geometric spectrum 8 * 0.5^i (a 2x gap at every lane
# boundary, so each lane's block is defined), k = 8 on 4 lanes, grown 4 -> 8
DEFLATE_OPERAND = dict(d=2048, k=8, lanes=4, r=16)
DEFLATE_LANE_DEG = 0.5
# the cifar10 eval's basis grown to k' = 20 (the CLI's --grow-k path), served
# by a replica at bf16 and int8
GROW_K = 20
GROW_QUERIES = 32  # queries of 64 rows
REPLICA_STALENESS_MS = 500.0
# the serve -> drift -> refit -> swap loop: 64 queries of 512 rows of the
# fit's own data, then rows of the seed-1 model until the monitor's 32,768-row
# ring holds only shifted rows (64 queries; the refit's 4 steps of 8 x 1024)
DRIFT_QUERY_ROWS = 512
DRIFT_BUFFER_ROWS = 32768
DRIFT_SHIFT = dict(k_planted=10, gap=20.0, decay=0.8, noise=0.01, seed=1)
# the residual EWMA's weight: one query a batch, it crosses the default arm
# ratio (threshold / 2 = 0.125) ~89 shifted batches in, after the ring has
# turned over (64 batches), so the refit fits shifted rows only
DRIFT_EMA_ALPHA = 0.0015
DRIFT_MAX_SHIFTED = 160
# the mnist784 eval field for field (evals.py:96-102; its data evals.py:307-322):
# 8 workers sharded over the worker mesh
MNIST_FIT, MNIST_DATA = spec_fit("mnist784"), spec_data("mnist784")
# its bf16 variant (no int8 stage), whose cold step is the bf16 TMA Gram
MNIST_VARIANTS = (("int8", MNIST_FIT), ("bf16", dict(MNIST_FIT, stage_dtype=None)))
MESH_RANKS = 2  # two ranks sharing the one card over gloo
MESH_DEVICE = "cuda:0"  # the card both ranks compute on
MESH_RANK_BLOCK = (4, 1024, 784)  # each rank's workers of mnist784's block
MESH_FIT_DEG = 0.01  # a mesh fit against the same fit on one device
MESH_SIGMA_REL = 1e-5
MESH_MERGE_DEG = 0.05  # dist_merged_top_k against the exact merge
MESH_LANE_DEG = 0.1  # each deflation lane against the dense eigh
MESH_LANES = 2
MESH_TIMEOUT_S = 600.0
# the feature-sharded slice: imagenet12288 field for field (evals.py:103-120)
FS_EVAL_SOURCE = "distributed_eigenspaces_tpu/evals.py:103-120"
FS_SEGMENT = 4  # the windowed sketch fit's window: steps 4, 8, 10
FS_RANK_DEG = 0.01  # a two-rank fit against the same fit in one process
FS_SERVE_DEG = 0.2
FS_QUERIES = 64  # the burst each rank serves, 1, 8 and 64 rows in turn
FS_SERVE_DTYPES = ("bfloat16", "int8", "float32")
# the serve kernels at the features path's shard shapes: k = 50 and d / f
# = 6144 (two feature shards) or 12288 (one), at the engine's buckets
FS_SHARD_SHAPES = tuple((rows, dl, 50) for dl in (6144, 12288)
                        for rows in (8, 64, 512, 4096))
# the hierarchical merge: the cifar10 eval on the stacked tree in one process
TREE_EVAL_TOPOLOGY = (("chip", 4), ("host", 2))
TREE_FLAT_DEG = 0.5  # the tree against the flat fit (tests/test_topology.py:156-170)
# ... and the tier-local tree on four gloo ranks sharing the card, one leaf
# worker a rank: the cifar10 shape under slice_fit's bf16 settings, m=4
TREE_RANKS = 4
TREE_TIERS = (("chip", 2), ("host", 2))
TREE_FIT = dict(dim=3072, k=10, num_workers=4, rows_per_worker=1024, num_steps=20,
                solver="subspace", subspace_iters=12, warm_start_iters=2,
                compute_dtype="bfloat16", merge_topology=TREE_TIERS)
TREE_RANK_BLOCK = (1, 1024, 3072)  # a rank's one leaf worker: its bf16 Gram
TREE_ARMS = (("fp32", None), ("bf16", {"chip": "bf16", "host": "bf16"}),
             ("int8", {"host": "int8"}))
TREE_ARM_DEG = 0.2  # tests/test_topology.py:220-231, tests/test_wire.py:305-331
# the ring: imagenet12288 on a (1, 4) features mesh, 3,072 columns a rank
RING_MESH = {"workers": 1, "features": 4}
RING_ATOL = 5e-4  # tests/test_ring.py:101-137
RING_DEG = 0.01
# the multi-tenant fleet: fleet_bucket_size's default (one full bucket) of
# tenants, each the mnist784 eval's settings field for field
# (distributed_eigenspaces_tpu/evals.py:96-102), backend "local" (the fleet
# axis is the data-parallel axis, as the reference bench's _fleet_cfg has it)
FLEET_B = 8
FLEET_FIT = dict(MNIST_FIT, backend="local")
FLEET_GRAM = (FLEET_B * MNIST_FIT["num_workers"], MNIST_FIT["rows_per_worker"],
              MNIST_FIT["dim"])  # one cold step's worker batch: (64, 1024, 784)
FLEET_SOLO_DEG = 0.2  # a tenant against its solo fit (tests/test_fleet.py:87)
FLEET_REPS = 3  # timed reps a side of the fleet / sequential A/B (bench.py --fleet)
FLEET_LAUNCH_RATIO = 1.5  # a fleet fit's kernels against one solo fit's, at most
FLEET_SERVER_EXTRA = 3  # requests after the full bucket: flushed on the deadline
FLEET_QUERIES = 64  # the published tenant's burst, of 1, 8 or 64 rows
FLEET_RANK_DEG = 0.01  # a two-rank fleet's tenant against the one-process fleet's
FLEET_SKEW_AFTER = 2  # rank 1 submits this many, then sleeps past the flush
FLEET_POISON = dict(tenant=FLEET_B - 1, step=3, worker=2)  # in rank 1's half
# the guards (utils/guards.py, DET_CHECKIFY=1) at the mnist784 eval's widths
# on bf16 blocks (a cold step is one TMA Gram), its depth cut to 4 steps
GUARD_FIT = dict(FLEET_FIT, stage_dtype=None, num_steps=4)
GUARD_SEGMENT = 2
GUARD_POISON = dict(step=1, worker=2)
# fit_fleet(supervisor=): one NaN worker block in one tenant (1-based step)
FLEET_BAD = dict(tenant=3, step=5, worker=2)
# the reference bench's population shape (bench.py:2241-2256) and its
# orthonormal colluders (gate 2): 5% of a cohort of 256, honest clients at
# runtime/population.py's noise, 12 rounds folded
POP_FIT = dict(dim=64, k=4, num_workers=8, rows_per_worker=16, num_steps=12,
               backend="local", cohort_size=256, max_poison_frac=0.08)
POP_POISON = round(0.05 * POP_FIT["cohort_size"])
POP_NOISE = 0.1
POP_BUDGET_DEG = 5.0  # the bench's angle budget
COHORT_RANK_DEG = 1e-3  # the two-rank fp32 reduce against the one-process merge
# the eval harness: the (backend, trainer) each eval takes on one device, as
# the reference picks them (distributed_eigenspaces_tpu/evals.py:352-395)
EVAL_ROUTES = {"cifar10": ("local", "scan"), "synthetic1024": ("local", "scan"),
               "mnist784": ("local", "scan"), "imagenet12288": ("feature_sharded", "sketch"),
               "clip768": ("local", "segmented"), "clip768_chip": ("feature_sharded", "sketch")}
EVAL_PCT_MAX = 105.0  # pct_of_anchor above this: the matmul anchor under-measured


def ptxas_lines(log: str) -> list[str]:
    """The lines of an ``nvcc -Xptxas=-v`` log that give, per kernel (its
    ``Compiling entry function`` line), registers, spills and shared memory."""
    keys = ("Compiling entry function", "spill stores", "Used ")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]


_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line; ``t_s`` is the seconds since the script
    started, so the lines show where its time goes."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": round(time.perf_counter() - _START, 3)}), flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


@contextlib.contextmanager
def checkify_env(value: str):
    """``DET_CHECKIFY`` set to ``value`` inside, restored after: the guards
    (``utils/guards.py``) are resolved when a trainer is built."""
    prev = os.environ.get("DET_CHECKIFY")
    os.environ["DET_CHECKIFY"] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("DET_CHECKIFY", None)
        else:
            os.environ["DET_CHECKIFY"] = prev


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    return float(((got - want).norm() / want.norm()).item())


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gram_bound(shape, dtype: str) -> tuple[float, str]:
    """Least time for the Gram of ``shape``: the input read once, the fp32
    output written once, and the m*n*d*(d+1) FLOP of the distinct output
    entries (the kernel computes the upper triangle and mirrors it)."""
    m, n, d = shape
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    bytes_s = (m * n * d * item + m * d * d * 4) / PEAK_BYTES_S
    ops_s = m * n * d * (d + 1) / PEAK_FLOPS[dtype]
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def serve_bound(shape, route: str) -> tuple[float, str]:
    """Least time for one serve projection of ``shape``: fp32 x read once,
    the basis read once (fp32, or int8 plus its k fp32 scales) and the
    fp32 z written once, against 2*rows*d*k bf16 products (fp32 ones for
    the fp32 route)."""
    rows, d, k = shape
    basis = d * k + 4 * k if route == "i8" else d * k * 4
    bytes_s = (rows * d * 4 + basis + rows * k * 4) / PEAK_BYTES_S
    ops_s = 2 * rows * d * k / PEAK_FLOPS["float32" if route == "f32" else "bfloat16"]
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def serve_operands(shape, dev, seed: int):
    """fp32 x (rows, d) and an orthonormal fp32 basis (d, k) on the card."""
    import torch

    rows, d, k = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, d), generator=gen, device=dev)
    v = torch.linalg.qr(torch.randn((d, k), generator=gen, device=dev))[0]
    return x, v.contiguous()


def serve_routes(sp, v, x_dtype="float32"):
    """Per serve kernel: its wrapper and its plain version on basis ``v``
    (the fp32 kernel only for fp32 x, the only x it takes)."""
    q, s = sp.quantize_basis_i8(v)
    routes = (
        ("bf16", lambda a: sp.serve_project_cuda(a, v),
         lambda a: sp.serve_project_plain(a, v), "launches"),
        ("i8", lambda a: sp.serve_project_i8_cuda(a, q, s),
         lambda a: sp.serve_project_i8_plain(a, q, s), "launches_i8"),
        ("f32", lambda a: sp.serve_project_f32_cuda(a, v),
         lambda a: sp.serve_project_f32_plain(a, v), "launches_f32"),
    )
    return routes if x_dtype == "float32" else routes[:2]


def int8_block(shape, gen, dev):
    """int8 values in [-127, 127] of ``shape`` on the card."""
    import torch

    return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)


def events_dropped_only(events, launches) -> bool:
    """Whether a profiled window lacks events of ``launches`` and holds no
    event that is not one of them (the same symbol, grid, block and shared
    memory): what the profiler's dropped events look like, as against a
    launch of another geometry."""
    want = collections.Counter((la.kernel, la.grid, la.block, la.smem) for la in launches)
    got = collections.Counter((ev["symbol"], ev["grid"], ev["block"], ev["smem"])
                              for ev in events)
    return len(events) < len(launches) and not got - want


def gram_geometry(dev, gen, shape, dtype: str, phase: str, kernels: tuple) -> None:
    """One Gram call of ``shape`` and ``dtype`` under the launch recorder
    and the profiler: its launches must take ``kernels``, in order, and each
    profiled event must have the grid, block and shared memory of its
    launch's record (``gram_launch``, the TMA kernels' grids sized on the
    card; for int8 the two launches of ``gram_s8_launch``)."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import geometry
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from torch.profiler import ProfilerActivity, profile

    if dtype == "int8":
        x, run = int8_block(shape, gen, dev), gram_mod.gram_s8_cuda
        want = gram_mod.gram_s8_launch(*shape)
    else:
        x = torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
        run, want = gram_mod.gram_cuda, (gram_mod.gram_launch(*shape, x.dtype),)
    run(x)
    torch.cuda.synchronize()
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(trace_dir, exist_ok=True)
    # the profiler can leave a window's first kernel events out (the
    # analysis phase's note at ANALYSIS_WARM_ROUNDS): each window opens with
    # that many warm pairs and a pause, and a window that lacks an event of
    # the recorded launches, with no event of another geometry, is run
    # again, up to ANALYSIS_WINDOWS times, each attempt printed; the checks
    # below hold the last one
    for attempt in range(1, ANALYSIS_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_warm(dev, ANALYSIS_WARM_ROUNDS)
            time.sleep(PAUSE_S)
            with geometry.recording() as launches:
                run(x)
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)
        events = geometry.profiled_kernels(
            prof, geometry.RECORDED_KERNELS,
            os.path.join(trace_dir, f"chip_smoke_{phase}_trace.json"))
        mismatches = geometry.geometry_mismatches(events, launches)
        if not events_dropped_only(events, launches):
            break
        emit(phase, incomplete_window=attempt, recorded_launches=len(launches),
             profiled_events=len(events), geometry_mismatches=mismatches)
    emit(phase, shape=list(shape), dtype=dtype, recorded=[la.to_json() for la in launches],
         profiled=[{k: ev[k] for k in ("symbol", "grid", "block", "smem", "dur_us")}
                   for ev in events], geometry_mismatches=mismatches)
    check([la.kernel for la in launches] == list(kernels),
          f"{phase}: recorded {[la.kernel for la in launches]}, want {list(kernels)}")
    check(launches == [w if w.grid else w.resolved(la.grid) for w, la in zip(want, launches)],
          f"{phase}: the records are not the launch functions'")
    check(not mismatches, f"{phase}: profiled launch differs: {mismatches}")


def parity_gram_s8(dev, gen) -> float:
    """The s8 pair (the transpose, then the TMA + wgmma kernel) against its
    plain version at ``S8_PARITY``, each on an aligned base and one byte off
    it: the transpose alone equal to ``gram_s8_transpose_plain`` bit for bit
    (pad rows included), the Gram equal bit for bit and exactly symmetric,
    each call recorded as ``gram_s8_launch``'s two launches and counted
    once; every instance of both kernels taken. Returns the largest
    absolute error (0.0)."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import geometry
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod

    worst = 0.0
    kernels = set()
    for shape in S8_PARITY:
        for offset in S8_OFFSETS:
            numel = shape[0] * shape[1] * shape[2]
            x = int8_block((numel + offset,), gen, dev)[offset:].view(shape)
            aligned = x.data_ptr() % 16 == 0
            transpose = gram_mod.gram_s8_transpose_cuda(x)
            torch.cuda.synchronize()
            transpose_equal = bool(torch.equal(transpose, gram_mod.gram_s8_transpose_plain(x)))
            del transpose
            before = (gram_mod.launches, gram_mod.launches_s8)
            with geometry.recording() as rec:
                got = gram_mod.gram_s8_cuda(x)
            torch.cuda.synchronize()
            check((gram_mod.launches, gram_mod.launches_s8) == (before[0], before[1] + 1),
                  f"gram_s8 {shape}: launch counters {before} did not move as one s8 call")
            want_t, want_g = gram_mod.gram_s8_launch(*shape, aligned)
            check(len(rec) == 2 and rec == [want_t, want_g.resolved(rec[1].grid)],
                  f"gram_s8 {shape} offset {offset}: recorded {rec}, not gram_s8_launch's")
            kernels.update(la.kernel for la in rec)
            want = gram_mod.gram_s8_plain(x)
            err = float((got - want).abs().max().item())
            worst = max(worst, err)
            equal, symmetric = bool(torch.equal(got, want)), bool(torch.equal(got, got.mT))
            emit("parity_gram_s8", shape=list(shape), base_offset_bytes=offset,
                 kernels=[la.kernel for la in rec], grids=[list(la.grid) for la in rec],
                 n_pad=gram_mod.s8_pad(shape[1]), transpose_bit_equal=transpose_equal,
                 max_abs_err=err, bit_equal=equal, symmetric=symmetric,
                 sum_limit_ok=gram_mod.s8_exact(shape[1]))
            check(transpose_equal, f"gram_s8 transpose {shape} offset {offset} differs")
            check(equal, f"gram_s8 {shape} offset {offset}: differs from its plain version "
                         f"by {err}")
            check(symmetric, f"gram_s8 {shape} offset {offset} is not symmetric")
            del x, got, want
    want_kernels = {"gram_s8_transpose_kernel<16>", "gram_s8_transpose_kernel<1>",
                    "gram_s8_tma_kernel<true>", "gram_s8_tma_kernel<false>"}
    check(kernels == want_kernels,
          f"gram_s8 parity took {sorted(kernels)}, want {sorted(want_kernels)}")
    return worst


def timing_gram_s8(dev, gen, card: str) -> dict:
    """The s8 pair at the CIFAR-10, synthetic1024, mnist784 and clip768
    blocks and a mesh rank's share of mnist784's: one
    call (CUDA events, median of 25 after warm-up) and the device time of
    both launches of each call, and of the transpose among them, beside the
    bound, the plain version, ``torch._int_mm`` looped over the workers with
    the transpose copy it needs (int32 out, the library's nearest call; a
    yardstick only), and the bf16 TMA kernel on the block widened
    beforehand (context: what bf16 staging would cost)."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod

    out = {}
    for shape in (CIFAR, S8_SYNTH, S8_MNIST, S8_CLIP, MESH_RANK_BLOCK):
        x = int8_block(shape, gen, dev)
        kernels = [la.kernel for la in gram_mod.gram_s8_launch(*shape)]
        ms = time_ms(lambda: gram_mod.gram_s8_cuda(x))
        reps = 20
        events = device_events(lambda: gram_mod.gram_s8_cuda(x), reps=reps, launches=2)
        kernel_device_ms = events_ms(events, reps)
        transpose_device_ms = events_ms(
            [e for e in events if "gram_s8_transpose_kernel" in e.name], reps)
        check(sum("gram_s8_transpose_kernel" in e.name for e in events) == reps
              and sum("gram_s8_tma_kernel" in e.name for e in events) == reps,
              f"timing_gram_s8 {shape}: the timed calls are not one transpose and one TMA "
              "launch each")
        plain_ms = time_ms(lambda: gram_mod.gram_s8_plain(x))

        def loop_t():
            return [torch._int_mm(x[w].mT.contiguous(), x[w]) for w in range(shape[0])]

        library_ms = time_ms(loop_t)
        library_device_ms = device_ms(loop_t, launches=None)
        xb = x.to(torch.bfloat16)
        bf16_ms = time_ms(lambda: gram_mod.gram_cuda(xb))
        bf16_device_ms = device_ms(lambda: gram_mod.gram_cuda(xb))
        bound_ms, bound_by = gram_bound(shape, "int8")
        out[shape] = dict(ms=ms, device_ms=kernel_device_ms,
                          transpose_device_ms=transpose_device_ms,
                          tma_device_ms=kernel_device_ms - transpose_device_ms,
                          plain_ms=plain_ms,
                          library_ms=library_ms, library_device_ms=library_device_ms,
                          bf16_tma_widened_ms=bf16_ms,
                          bf16_tma_widened_device_ms=bf16_device_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library="torch._int_mm(x[w].mT.contiguous(), x[w]) over the m "
                                  "workers, int32 out, the transpose copy timed")
        emit("timing_gram_s8", shape=list(shape), kernels=kernels,
             kernel_ms=ms, kernel_device_ms=kernel_device_ms,
             roofline_share=bound_ms / ms, device_roofline_share=bound_ms / kernel_device_ms,
             card=card, **{k: v for k, v in out[shape].items()
                           if k not in ("ms", "device_ms")})
        del x, xb
    return out


def slice_fit_eval(dev, card: str, name: str, source: str, fit: dict, data_kw: dict) -> int:
    """An eval's own settings (``fit``: int8 stage, ns warm rounds) through
    ``OnlineDistributedPCA.fit`` on its planted-subspace data (``data_kw``):
    one s8 Gram call (the cold step: one transpose and one TMA launch), no
    other Gram kernel, every warm round on ``ns_orth``, within 1 degree of
    the planted top-k; returns the s8 calls of the fit."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops import linalg
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    cfg = dett.PCAConfig(**fit)
    d, k, m, n, T = (fit[f] for f in ("dim", "k", "num_workers", "rows_per_worker",
                                      "num_steps"))
    t0 = time.perf_counter()
    spec = dett.planted_subspace(d, **data_kw)
    data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    ns_calls = [0]
    real_ns = linalg.ns_orth

    def counted_ns(v, *a, **kw):
        ns_calls[0] += 1
        return real_ns(v, *a, **kw)

    linalg.ns_orth = counted_ns
    try:
        est = dett.OnlineDistributedPCA(cfg)
        gram_mod.launches = gram_mod.launches_tma = gram_mod.launches_s8 = 0
        _, fit_s = synced_s(lambda: est.fit(data))
        launched = (gram_mod.launches, gram_mod.launches_tma, gram_mod.launches_s8)
    finally:
        linalg.ns_orth = real_ns
    w = est.components_
    check(w.shape == (d, k) and bool(torch.isfinite(w).all()), f"fit_eval {name}: components_")
    angle = float(principal_angles_degrees(w.cpu(), torch.as_tensor(spec.top_k(k))).max())
    _, fit2_s = synced_s(lambda: dett.OnlineDistributedPCA(cfg).fit(data))
    samples = T * m * n
    per_round = cfg.resolved_warm_start() + 1  # the start and each iteration
    emit("slice_fit_eval", eval=name,
         config=f"{name} eval ({source}): d={d} k={k} m={m} n={n} T={T} subspace "
                f"{fit['subspace_iters']} cold / {fit['warm_start_iters']} warm bf16, "
                "stage int8, warm ns",
         data=f"planted_subspace({d}, " + ", ".join(f"{a}={v}" for a, v in data_kw.items())
              + ")",
         trainer=est.trainer_used_, s8_calls=launched[2], gram_launches=launched[0],
         tma_launches=launched[1], ns_calls=ns_calls[0],
         ns_warm_rounds=ns_calls[0] / per_round, max_angle_deg=angle, data_s=data_s,
         fit_s=fit_s, samples_per_s=samples / fit_s, second_fit_s=fit2_s,
         second_samples_per_s=samples / fit2_s, card=card)
    check(launched == (0, 0, 1), f"fit_eval {name}: Gram launches (float, TMA, s8) "
                                 f"{launched}, want (0, 0, 1)")
    check(ns_calls[0] == (T - 1) * per_round,
          f"fit_eval {name}: {ns_calls[0]} ns_orth calls, want {(T - 1) * per_round}")
    check(angle <= 1.0, f"fit_eval {name} angle {angle} > 1 degree")
    del data, est
    return launched[2]


def clip768_file(dev, work_dir: str):
    """The clip768 eval's row file: ``CLIP_DISTINCT`` blocks of its planted
    subspace, quantized with one global int8 scale (``127 / absmax``, the
    port's native ``absmax_f32`` and ``quantize_i8``), written cyclically
    over the 10 steps. Returns ``(path, spec, seconds)``."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.runtime.native import absmax_f32, quantize_i8

    d, m, n, T = (CLIP_FIT[f] for f in ("dim", "num_workers", "rows_per_worker",
                                          "num_steps"))
    t0 = time.perf_counter()
    spec = dett.planted_subspace(d, **CLIP_DATA)
    gen = torch.Generator(device=dev).manual_seed(1)
    host = [spec.sample(gen, m * n).cpu().numpy() for _ in range(CLIP_DISTINCT)]
    scale = 127.0 / max(max(absmax_f32(b) for b in host), 1e-30)
    steps = [quantize_i8(b, scale).tobytes() for b in host]
    path = os.path.join(work_dir, "clip768.i8")
    with open(path, "wb") as f:
        for t in range(T):
            f.write(steps[t % CLIP_DISTINCT])
    check(os.path.getsize(path) == T * m * n * d, "clip768: row file size")
    return path, spec, time.perf_counter() - t0


def clip768_windows(path: str, stats=None, start_row: int = 0):
    """The eval's out-of-core route: ``bin_block_stream`` (int8 passed
    through) -> ``window_stream`` of 5 -> ``prefetch_stream`` (depth 1, the
    pinned side-stream copy to the card)."""
    import numpy as np
    import torch
    from distributed_eigenspaces_tpu_torch.data.bin_stream import (
        bin_block_stream,
        window_stream,
    )
    from distributed_eigenspaces_tpu_torch.runtime.prefetch import prefetch_stream

    blocks = bin_block_stream(
        path, dim=CLIP_FIT["dim"], num_workers=CLIP_FIT["num_workers"],
        rows_per_worker=CLIP_FIT["rows_per_worker"], num_steps=CLIP_FIT["num_steps"],
        dtype=np.int8, out_dtype=torch.int8, start_row=start_row)
    return prefetch_stream(window_stream(blocks, CLIP_SEGMENT), depth=1, stats=stats)


def clip768_fit(cfg, state, windows, on_segment=None):
    """``make_segmented_fit(cfg, segment=5).fit_windows`` over ``windows``,
    the prefetch generator closed however the fit ends."""
    import distributed_eigenspaces_tpu_torch as dett

    try:
        return dett.make_segmented_fit(cfg, segment=CLIP_SEGMENT).fit_windows(
            state, windows, on_segment=on_segment)
    finally:
        windows.close()


def slice_clip768(dev, card: str, work_dir: str) -> dict:
    """The clip768 eval's own route on the card (d=768, k=256, m=8, n=2048,
    T=10, subspace 8 / 2 warm, bf16, int8 rows from a file, segmented in
    windows of 5): one s8 call a step and no float Gram, two windows, the
    native reader, within 1 degree of the planted top-256. Run twice, the
    second after the first has paid every library's start-up; returns the
    first run's final state and counts."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.api.runner import extract_dense
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.runtime.native import native_available
    from distributed_eigenspaces_tpu_torch.runtime.prefetch import PrefetchStats

    cfg = dett.PCAConfig(**CLIP_FIT)
    d, k, m, n, T = (CLIP_FIT[f] for f in ("dim", "k", "num_workers", "rows_per_worker",
                                             "num_steps"))
    path, spec, data_s = clip768_file(dev, work_dir)
    native = native_available()
    runs = []
    for _ in range(2):
        stats, segments = PrefetchStats(), []
        windows = clip768_windows(path, stats)
        gram_mod.launches = gram_mod.launches_tma = gram_mod.launches_s8 = 0
        state, fit_s = synced_s(lambda: clip768_fit(
            cfg, dett.SegmentState.initial(d, k), windows,
            on_segment=lambda t, st: segments.append(t)))
        runs.append(dict(state=state, fit_s=fit_s, stats=stats.as_dict(), segments=segments,
                         launched=(gram_mod.launches, gram_mod.launches_tma,
                                   gram_mod.launches_s8)))
    first = runs[0]
    w, extract_s = synced_s(lambda: extract_dense(cfg, first["state"].sigma_tilde))
    check(w.shape == (d, k) and bool(torch.isfinite(w).all()), "clip768: components")
    angle = float(principal_angles_degrees(w.cpu(), torch.as_tensor(spec.top_k(k))).max())
    samples = T * m * n
    emit("slice_clip768",
         config="clip768 eval (evals.py:121-126): d=768 k=256 m=8 n=2048 T=10 subspace 8 "
                "cold / 2 warm bf16, int8 bin stream, trainer segmented, windows of 5",
         data="planted_subspace(768, " + ", ".join(f"{a}={v}" for a, v in CLIP_DATA.items())
              + f"), {CLIP_DISTINCT} distinct blocks, one global int8 scale",
         file_bytes=os.path.getsize(path), data_s=data_s, native_reader=native,
         s8_calls=first["launched"][2], gram_launches=first["launched"][0],
         tma_launches=first["launched"][1], windows=first["segments"],
         fit_s=first["fit_s"], samples_per_s=samples / first["fit_s"],
         prefetch=first["stats"], second_fit_s=runs[1]["fit_s"],
         second_samples_per_s=samples / runs[1]["fit_s"], second_prefetch=runs[1]["stats"],
         second_s8_calls=runs[1]["launched"][2], extract_s=extract_s, max_angle_deg=angle,
         card=card)
    check(native, "clip768: the native reader did not build")
    for run in runs:
        check(run["launched"] == (0, 0, T), f"clip768: Gram launches (float, TMA, s8) "
                                            f"{run['launched']}, want (0, 0, {T})")
        check(run["segments"] == [CLIP_SEGMENT, T], f"clip768: windows {run['segments']}")
        check(run["state"].step == T, f"clip768: {run['state'].step} steps")
    check(torch.equal(runs[0]["state"].sigma_tilde, runs[1]["state"].sigma_tilde),
          "clip768: two runs of the same fit differ")
    check(angle <= 1.0, f"clip768 angle {angle} > 1 degree")
    return dict(path=path, state=first["state"], s8_calls=first["launched"][2])


def slice_clip768_resume(dev, card: str, work_dir: str, clip: dict) -> None:
    """Kill and resume at the clip768 width: a run checkpointed on
    ``on_segment`` is stopped after window 1, restored by
    ``Checkpointer.latest()`` and continued from ``bin_block_stream(
    start_row=cursor)``; its ``sigma_tilde`` and ``v_prev`` must equal the
    unkilled run's bit for bit. Then a torn ``state.npz`` of the newest
    checkpoint is quarantined and the ladder steps back."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import (
        Checkpointer,
        restore_checkpoint,
    )
    from distributed_eigenspaces_tpu_torch.utils.faults import KillSwitch

    cfg = dett.PCAConfig(**CLIP_FIT)
    d, k, m, n = (CLIP_FIT[f] for f in ("dim", "k", "num_workers", "rows_per_worker"))
    ckpt_dir = os.path.join(work_dir, "clip768_ckpt")
    ckpt = Checkpointer(ckpt_dir, rows_per_step=m * n)

    def kill_after_first(t, st):
        ckpt.on_step(t, st)
        raise KillSwitch(f"stopped after step {t}")

    t0 = time.perf_counter()
    killed = False
    try:
        clip768_fit(cfg, dett.SegmentState.initial(d, k), clip768_windows(clip["path"]),
                    on_segment=kill_after_first)
    except KillSwitch:
        killed = True
    state, cursor = ckpt.latest()
    at_kill = state
    resumed, resume_s = synced_s(lambda: clip768_fit(
        cfg, state, clip768_windows(clip["path"], start_row=cursor),
        on_segment=ckpt.on_step))
    whole = clip["state"]
    sigma_equal = bool(torch.equal(resumed.sigma_tilde, whole.sigma_tilde))
    v_equal = bool(torch.equal(resumed.v_prev, whole.v_prev))
    sigma_diff = float((resumed.sigma_tilde - whole.sigma_tilde).abs().max())
    # a torn payload of the newest checkpoint: quarantined, the ladder steps back
    newest = os.path.join(ckpt_dir, f"step_{CLIP_FIT['num_steps']:08d}", "state.npz")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    back, back_cursor = ckpt.latest()
    quarantined = os.path.isdir(newest.rsplit(os.sep, 1)[0] + ".quarantined")
    again, _ = restore_checkpoint(os.path.join(ckpt_dir, f"step_{CLIP_SEGMENT:08d}"))
    emit("slice_clip768_resume", killed_after_window_1=killed, cursor=cursor,
         resumed_steps=resumed.step, sigma_bit_equal=sigma_equal, v_prev_bit_equal=v_equal,
         sigma_max_abs_diff=sigma_diff, resume_s=resume_s,
         torn_newest_quarantined=quarantined, ladder_step=back.step,
         ladder_cursor=back_cursor, seconds=time.perf_counter() - t0, card=card)
    check(killed and at_kill.step == CLIP_SEGMENT and cursor == CLIP_SEGMENT * m * n,
          f"clip768 resume: checkpoint at step {at_kill.step}, cursor {cursor}")
    check(resumed.step == CLIP_FIT["num_steps"], f"clip768 resume: {resumed.step} steps")
    check(sigma_equal and v_equal, f"clip768 resume: resumed run differs from the unkilled "
                                   f"one (sigma {sigma_equal}, v_prev {v_equal})")
    check(quarantined and back.step == CLIP_SEGMENT and back_cursor == cursor,
          "clip768 resume: the torn checkpoint was not quarantined")
    check(torch.equal(back.sigma_tilde, again.sigma_tilde)
          and torch.equal(back.v_prev, again.v_prev), "clip768 resume: ladder restore")


def eval_data(dev):
    """The cifar10 eval's planted data on the card: ``(spec, data (T m n,
    d))``."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett

    m, n, T = (EVAL_FIT[f] for f in ("num_workers", "rows_per_worker", "num_steps"))
    spec = dett.planted_subspace(EVAL_FIT["dim"], **EVAL_DATA)
    return spec, spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)


def basis_angle(v, spec) -> float:
    """The largest principal angle in degrees between a ``(d, k)`` basis
    (tensor or array) and the planted top-k."""
    import numpy as np
    import torch
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    if not isinstance(v, torch.Tensor):  # a registry's arrays are read-only
        v = torch.from_numpy(np.array(v, np.float32))
    return float(principal_angles_degrees(v.cpu(), torch.as_tensor(
        spec.top_k(v.shape[1]))).max())


def components_angle(est, spec) -> float:
    import torch

    w = est.components_
    check(bool(torch.isfinite(w).all()), "components_ not finite")
    return basis_angle(w, spec)


def slice_fit_eval_segmented(dev, card: str, work_dir: str, spec, data) -> int:
    """The cifar10 eval's settings through ``OnlineDistributedPCA(cfg,
    checkpoint_dir=..., segment=5).fit``: the segmented trainer, four
    checkpoint commits as they land (the two newest kept), ``sigma_tilde``
    equal to the scan fit's on the same data, within 1 degree; returns the
    s8 calls of the segmented fit."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.utils import checkpoint as ckpt_mod

    cfg = dett.PCAConfig(**EVAL_FIT)
    T = EVAL_FIT["num_steps"]
    ckpt_dir = os.path.join(work_dir, "eval_ckpt")
    commits = []
    real_save = ckpt_mod.save_checkpoint

    def counted(path, state, **kw):
        real_save(path, state, **kw)
        commits.append((os.path.basename(path), os.path.exists(
            os.path.join(path, "meta.json"))))

    ckpt_mod.save_checkpoint = counted
    try:
        est = dett.OnlineDistributedPCA(cfg, checkpoint_dir=ckpt_dir, segment=5)
        gram_mod.launches = gram_mod.launches_tma = gram_mod.launches_s8 = 0
        _, fit_s = synced_s(lambda: est.fit(data))
        launched = (gram_mod.launches, gram_mod.launches_tma, gram_mod.launches_s8)
    finally:
        ckpt_mod.save_checkpoint = real_save
    scan = dett.OnlineDistributedPCA(cfg)
    _, scan_s = synced_s(lambda: scan.fit(data))
    # the same trainer without checkpoints: what the four commits cost
    plain_seg = dett.OnlineDistributedPCA(cfg, trainer="segmented", segment=5)
    _, plain_seg_s = synced_s(lambda: plain_seg.fit(data))
    diff = float((est.state.sigma_tilde - scan.state.sigma_tilde).abs().max())
    rel = diff / float(scan.state.sigma_tilde.abs().max())
    kept = sorted(os.listdir(ckpt_dir))
    angle = components_angle(est, spec)
    emit("slice_fit_eval_segmented",
         config="cifar10 eval settings (evals.py:86-90) through OnlineDistributedPCA("
                "checkpoint_dir=..., segment=5)", trainer=est.trainer_used_,
         commits=commits, kept=kept, s8_calls=launched[2], gram_launches=launched[0],
         sigma_vs_scan_bit_equal=bool(torch.equal(est.state.sigma_tilde,
                                                  scan.state.sigma_tilde)),
         sigma_vs_scan_max_abs_diff=diff, sigma_vs_scan_rel=rel, fit_s=fit_s, scan_fit_s=scan_s,
         segmented_without_checkpoints_fit_s=plain_seg_s,
         max_angle_deg=angle, card=card)
    check(est.trainer_used_ == "segmented", f"eval segmented: trainer {est.trainer_used_}")
    check([c for c, committed in commits if committed] == [f"step_{t:08d}" for t in
                                                            (5, 10, 15, 20)],
          f"eval segmented: commits {commits}")
    check(kept == ["step_00000015", "step_00000020"], f"eval segmented: kept {kept}")
    check(rel <= 1e-6, f"eval segmented: sigma_tilde {rel} relative from the scan fit")
    check(torch.equal(plain_seg.state.sigma_tilde, est.state.sigma_tilde),
          "eval segmented: the fit without checkpoints differs")
    check(launched == (0, 0, 1), f"eval segmented: Gram launches {launched}")
    check(angle <= 1.0, f"eval segmented angle {angle} > 1 degree")
    check(est.state.step == T, f"eval segmented: {est.state.step} steps")
    return launched[2]


def slice_fit_masked(dev, card: str, spec, data) -> int:
    """The cifar10 eval's settings with a (20, 8) mask sequence: the masked
    whole fit (``trainer_used_ == "scan"``), equal to ``trainer="step"`` on
    the same masks within the port's tolerances, within 1 degree; returns
    its s8 calls."""
    import numpy as np
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    cfg = dett.PCAConfig(**EVAL_FIT)
    masks = np.ones((EVAL_FIT["num_steps"], EVAL_FIT["num_workers"]), np.float32)
    for steps, worker in MASK_DROPS:
        masks[list(steps), worker] = 0.0
    est = dett.OnlineDistributedPCA(cfg)
    gram_mod.launches = gram_mod.launches_tma = gram_mod.launches_s8 = 0
    _, fit_s = synced_s(lambda: est.fit(data, worker_masks=masks))
    launched = (gram_mod.launches, gram_mod.launches_tma, gram_mod.launches_s8)
    step = dett.OnlineDistributedPCA(cfg, trainer="step")
    _, step_s = synced_s(lambda: step.fit(data, worker_masks=masks))
    sigma_diff = float((est.state.sigma_tilde - step.state.sigma_tilde).abs().max())
    agree = float(principal_angles_degrees(est.components_.cpu(),
                                           step.components_.cpu()).max())
    angle = components_angle(est, spec)
    emit("slice_fit_masked", config="cifar10 eval settings, (20, 8) masks: worker 3 off "
         "on steps 4-9, every worker off on step 12", trainer=est.trainer_used_,
         step_trainer=step.trainer_used_, live_rounds=int(np.sum(masks.any(axis=1))),
         s8_calls=launched[2], gram_launches=launched[0],
         sigma_vs_step_max_abs=sigma_diff, components_vs_step_deg=agree, fit_s=fit_s,
         step_fit_s=step_s, max_angle_deg=angle, card=card)
    check(est.trainer_used_ == "scan" and step.trainer_used_ == "step",
          f"masked: trainers {est.trainer_used_}, {step.trainer_used_}")
    check(sigma_diff <= FIT_SIGMA_ATOL and agree <= FIT_ANGLE_DEG,
          f"masked: scan and step differ ({sigma_diff}, {agree} deg)")
    check(launched == (0, 0, 1), f"masked: Gram launches {launched}, want one s8 call")
    check(angle <= 1.0, f"masked angle {angle} > 1 degree")
    return launched[2]


def slice_fit_interval(dev, card: str, spec, data) -> None:
    """The cifar10 eval's settings with ``merge_interval=2``, then with
    ``merge_interval=2, pipeline_merge=True``: within 1 degree each, the
    merged eigensolve on exactly ceil(T / 2) rounds (a wrapper around
    ``merge_core`` counts them)."""
    import dataclasses

    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.algo import scan as scan_mod

    T = EVAL_FIT["num_steps"]
    real = scan_mod.merge_core
    for kw in (dict(merge_interval=2), dict(merge_interval=2, pipeline_merge=True)):
        cfg = dataclasses.replace(dett.PCAConfig(**EVAL_FIT), **kw)
        merges = [0]

        def counted(*a, **k):
            merges[0] += 1
            return real(*a, **k)

        scan_mod.merge_core = counted
        try:
            est = dett.OnlineDistributedPCA(cfg)
            _, fit_s = synced_s(lambda: est.fit(data))
        finally:
            scan_mod.merge_core = real
        angle = components_angle(est, spec)
        emit("slice_fit_interval", knobs=kw, trainer=est.trainer_used_, merges=merges[0],
             want_merges=-(-T // 2), fit_s=fit_s,
             samples_per_s=T * EVAL_FIT["num_workers"] * EVAL_FIT["rows_per_worker"] / fit_s,
             max_angle_deg=angle, card=card)
        check(merges[0] == -(-T // 2), f"interval {kw}: {merges[0]} merges")
        check(angle <= 1.0, f"interval {kw}: angle {angle} > 1 degree")


def parity_serve(dev, shapes=SERVE_PARITY, phase: str = "parity_serve") -> dict:
    """Both serve kernels against their plain versions at ``shapes``;
    returns each kernel's largest absolute error over the cases."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    worst = {"bf16": 0.0, "i8": 0.0, "f32": 0.0}
    cases = [(shape, x_dtype) for shape in shapes for x_dtype in ("float32", "bfloat16")]
    for seed, (shape, x_dtype) in enumerate(cases):
        x, v = serve_operands(shape, dev, seed)
        x = x.to(getattr(torch, x_dtype))
        for route, run, plain, counter in serve_routes(sp, v, x_dtype):
            before = getattr(sp, counter)
            got = run(x)
            torch.cuda.synchronize()
            check(getattr(sp, counter) == before + 1, f"{route}: launch counter did not move")
            want = plain(x)
            rel = rel_err(got, want)
            err = float((got - want).abs().max().item())
            worst[route] = max(worst[route], err)
            prefix = {}
            if shape in SERVE_PREFIX:
                n = SERVE_PREFIX[shape]
                prefix[f"first_{n}_rows_bit_equal"] = bool(torch.equal(run(x[:n]), got[:n]))
            emit(phase, kernel=route, shape=list(shape), x_dtype=x_dtype,
                 rel_frobenius=rel, max_abs_err=err, tol=SERVE_TOL, **prefix)
            check(rel <= SERVE_TOL, f"serve {route} {shape} {x_dtype}: {rel} > {SERVE_TOL}")
            check(all(prefix.values()),
                  f"serve {route} {x_dtype}: {prefix}: rows alone differ from the "
                  f"{shape[0]}-row launch")
            del got, want
        del x, v
    return worst


def bf16_out_fp32(op, a, b):
    """``op(a, b, out_dtype=torch.float32)`` (``torch.mm`` or ``torch.bmm``
    on bf16 operands), or the reason this torch cannot run it (a yardstick
    only: the port never calls it)."""
    import torch

    try:
        return op(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        return repr(e)[:200]


def profiler_warm(dev, rounds: int = 4) -> None:
    """A few small kernels (``rounds`` pairs) at the start of a
    ``torch.profiler`` window: the card's first launches in a window after
    earlier windows can go unrecorded, so what is measured comes after
    these."""
    import torch

    for _ in range(rounds):
        torch.ones(256, device=dev).sum()
        torch.cuda.synchronize()


PAUSE_S = 0.05  # the host's pause between the parts of a device_ms window


def profiled_window(fn, reps: int, warm: int) -> list:
    """The kernel events of one ``device_ms`` window, in order of their
    start on the card's clock: ``profiler_warm``'s kernels, a pause, ``warm``
    calls of ``fn``, a pause, ``reps`` calls, and a pause before the window
    closes, so that no record of the timed calls is still in flight. The
    profiler can leave out the first kernels of a window, at times every
    warm call (``scripts/torch_profiler_windows.py`` counts what a window
    records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_warm("cuda", ANALYSIS_WARM_ROUNDS)
        time.sleep(PAUSE_S)
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def timed_events(events: list, reps: int, launches: int | None) -> tuple[list | None, int]:
    """The events of a window's ``reps`` timed calls and the index where
    they start: those after the last gap of at least the pause (the card
    idles through it; ``time_range`` is in microseconds), or every event
    where the profiler left out all that came before. None where the
    window lacks one: ``reps * launches`` events are wanted (where
    ``launches`` is None, for a library call, each kernel's count a
    multiple of ``reps``)."""
    pauses = [i for i in range(1, len(events))
              if events[i].time_range.start - events[i - 1].time_range.end >= 0.9e6 * PAUSE_S]
    cut = pauses[-1] if pauses else 0
    measured = events[cut:]
    per_name = collections.Counter(e.name for e in measured)
    if measured and all(n % reps == 0 for n in per_name.values()) and (
            launches is None or len(measured) == reps * launches):
        return measured, cut
    return None, cut


def device_events(fn, reps: int = 20, launches: int | None = 1, warm: int = 5,
                  windows: int = 5) -> list:
    """The kernel events of ``reps`` timed calls of ``fn`` under
    ``torch.profiler``, ``launches`` kernels a call, from a
    ``profiled_window``. Events are told apart on the card's own clock,
    since the profiler's host and device clocks can disagree by more than a
    launch. A window that lacks an event of the timed calls
    (``timed_events``) would read low, so it is measured again, up to
    ``windows`` times, and the run fails after that."""
    import torch

    fn()
    torch.cuda.synchronize()
    for window in range(1, windows + 1):
        events = profiled_window(fn, reps, warm)
        measured, cut = timed_events(events, reps, launches)
        if measured:
            return measured
        emit("device_ms", incomplete_window=window, reps=reps, launches=launches,
             events_before_pause=cut,
             events_after_pause=dict(collections.Counter(e.name for e in events[cut:])))
    check(False, f"device_ms: {windows} windows without every kernel event of {reps} calls")
    return []


def events_ms(events: list, reps: int) -> float:
    """The device time of ``events`` per call of ``reps`` calls, in ms."""
    return sum(e.time_range.end - e.time_range.start for e in events) / reps * 1e-3


def device_ms(fn, reps: int = 20, launches: int | None = 1, warm: int = 5,
              windows: int = 5) -> float:
    """Device time of one call of ``fn``: the kernels of ``reps`` calls
    (``device_events``), summed, over ``reps``."""
    return events_ms(device_events(fn, reps, launches, warm, windows), reps)


def timing_serve(dev, card: str, shapes=SERVE_SHAPES, phase: str = "timing_serve") -> dict:
    """Kernel, plain, library times and the bound at each of ``shapes``
    (CUDA events around one call, median of 25 after warm-up), and the
    device time of the kernel and of the library call."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    out = {}
    for shape in shapes:
        x, v = serve_operands(shape, dev, seed=7)
        library_ms = time_ms(lambda: torch.matmul(x, v))
        library_device_ms = device_ms(lambda: torch.matmul(x, v), launches=None)
        xb, vb = x.to(torch.bfloat16), v.to(torch.bfloat16)
        probe = bf16_out_fp32(torch.mm, xb, vb)
        if isinstance(probe, str):
            mm_ms, mm_note = None, probe
        else:
            mm_ms, mm_note = time_ms(lambda: bf16_out_fp32(torch.mm, xb, vb)), None
        del xb, vb, probe
        for route, run, plain, _ in serve_routes(sp, v):
            ms = time_ms(lambda: run(x))
            kernel_device_ms = device_ms(lambda: run(x))
            plain_ms = time_ms(lambda: plain(x))
            bound_ms, bound_by = serve_bound(shape, route)
            out[(shape, route)] = dict(ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
                                       library_ms=library_ms,
                                       library_device_ms=library_device_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
            emit(phase, kernel=route, shape=list(shape), kernel_ms=ms,
                 kernel_device_ms=kernel_device_ms, plain_ms=plain_ms,
                 library_ms=library_ms, library_device_ms=library_device_ms,
                 library="torch.matmul(x, v), fp32 operands",
                 mm_bf16_out_fp32_ms=mm_ms, mm_bf16_note=mm_note,
                 bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
                 device_roofline_share=bound_ms / kernel_device_ms, card=card)
        del x, v
    return out


def row_angles_deg(z, ref):
    """Per-row angle in degrees between two (rows, k) projections (float64)."""
    import torch

    z, ref = torch.as_tensor(z).double(), torch.as_tensor(ref).double()
    cos = (z * ref).sum(1) / (z.norm(dim=1) * ref.norm(dim=1))
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def request_latencies_ms(tracer) -> list[float]:
    """Per request: admit start to dispatch end, from the engine's spans."""
    start, end = {}, {}
    for sp in tracer.snapshot():
        if sp.name == "admit":
            start[sp.trace_id] = sp.t_start_mono
        elif sp.name == "dispatch":
            end[sp.trace_id] = sp.t_end_mono
    return sorted((end[t] - start[t]) * 1e3 for t in start if t in end)


def slice_serve(est, spec, cfg, card: str) -> dict:
    """The read path end to end on the fit ``est``; returns each serve
    kernel's launches in its server's run (burst, and bulk for the
    quantized kernels). The bf16 server runs under a ``MetricsLogger``
    (``QueryServer(metrics=)``) whose serving section must count the burst
    as the burst counts itself: 64 requests, its batches, no sheds."""
    import dataclasses

    import numpy as np
    import torch
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from distributed_eigenspaces_tpu_torch.serving import (
        EigenbasisRegistry,
        QueryServer,
    )
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger
    from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer

    rng = np.random.default_rng(1)
    queries = [spec.sample(rng, int(r)) for r in rng.choice([1, 8, 64], size=64)]
    direct = [est.transform(q).cpu() for q in queries]
    rows_total = sum(q.shape[0] for q in queries)
    reg = EigenbasisRegistry(keep=4)
    v1 = reg.publish_fit(est)
    bulk = spec.sample(torch.Generator(device=est.device).manual_seed(2), 50_000)
    bulk_direct = est.transform(bulk)
    launched = {}
    for serve_dtype, route in (("bfloat16", "bf16"), ("int8", "i8"), ("float32", "f32")):
        logger = MetricsLogger(slo_p99_ms=SERVE_SLO_MS) if route == "bf16" else None
        t0 = time.perf_counter()
        with QueryServer(reg, dataclasses.replace(cfg, serve_dtype=serve_dtype),
                         metrics=logger) as srv:
            construct_s = time.perf_counter() - t0
            eng = srv.engine
            self_check_deg = eng.self_check()
            # every bucket a burst can pad to, both operations
            v_dev = eng.place_basis(reg.latest())
            for b in (8, 16, 32, 64, 128, 256, 512):
                xz = torch.zeros((b, eng.d), device=eng.device)
                eng.residual_energy(xz, eng.project(xz, v_dev))
            torch.cuda.synchronize()
            acquired = eng.compile_misses
            dispatches = [0]
            project = eng.project

            def counted(x, v, project=project, dispatches=dispatches):
                dispatches[0] += 1
                return project(x, v)

            eng.project = counted
            eng.tracer = Tracer()
            sp.launches = sp.launches_i8 = sp.launches_f32 = 0
            t_burst = time.perf_counter()
            served = []
            for half in (queries[:32], queries[32:]):
                if served:  # halfway: the same basis as a new version
                    reg.publish(v1.v, sigma_tilde=v1.sigma_tilde, step=v1.step,
                                lineage={**v1.lineage, "republished": True})
                tickets = [srv.submit(q) for q in half]
                served += [t.result(timeout=300) for t in tickets]
            burst_s = time.perf_counter() - t_burst
            swap_acquired = eng.compile_misses - acquired
            versions = sorted({r.version for r in served})
            angles = torch.cat([row_angles_deg(r.z, ref) for r, ref in zip(served, direct)])
            lat = request_latencies_ms(eng.tracer)
            stats = dict(
                serve_dtype=serve_dtype, construct_s=construct_s,
                self_check_deg=self_check_deg, queries=len(served), rows=rows_total,
                versions=versions, swaps=srv.swap_count,
                swap_acquisitions=swap_acquired, batches=dispatches[0],
                latency_p50_ms=statistics.median(lat),
                latency_p99_ms=float(np.percentile(lat, 99)),
                rows_per_s=rows_total / burst_s, burst_s=burst_s,
                max_angle_deg=float(angles.max()), card=card,
            )
            if route == "f32":
                exact = all(np.array_equal(r.z, ref.numpy()) for r, ref in zip(served, direct))
                diff = max(float(np.abs(r.z - ref.numpy()).max()) for r, ref in zip(served, direct))
                launched[route] = sp.launches_f32
                emit("slice_serve", served_vs_direct_bit_exact=exact,
                     served_vs_direct_max_abs_err=diff, launches=launched[route],
                     project_dispatches=dispatches[0], **stats)
                check(exact, f"float32 served z differs from est.transform by {diff}")
                check(launched[route] == dispatches[0],
                      f"float32: {launched[route]} launches for {dispatches[0]} dispatches")
            else:
                t0 = time.perf_counter()
                z_bulk = eng.project(bulk, v_dev)
                torch.cuda.synchronize()
                bulk_s = time.perf_counter() - t0
                bulk_angle = float(row_angles_deg(z_bulk, bulk_direct).max())
                launched[route] = getattr(sp, "launches" if route == "bf16" else "launches_i8")
                emit("slice_serve", launches=launched[route], project_dispatches=dispatches[0],
                     bulk_rows=bulk.shape[0], bulk_s=bulk_s, bulk_max_angle_deg=bulk_angle,
                     **stats)
                check(bulk_angle <= 0.2, f"{serve_dtype}: bulk row at {bulk_angle} deg > 0.2")
                check(launched[route] == dispatches[0],
                      f"{serve_dtype}: {launched[route]} launches for {dispatches[0]} dispatches")
            if logger is not None:
                summary = logger.summary()
                serving = summary["serving"]
                # the health section lists sheds only once one happened
                sheds = serving.get("health", {}).get("shed_count", 0)
                emit("slice_serve", part="metrics", serve_dtype=serve_dtype,
                     serving={key: serving.get(key) for key in (
                         "batches", "queries", "rejected", "qps", "mean_occupancy",
                         "swaps", "versions_served", "padded_rows", "mean_fill_fraction",
                         "p50_latency_s", "p99_latency_s", "latency_decomposition",
                         "compile_misses", "health")},
                     slo=summary.get("slo"), card=card)
                check(serving["queries"] == len(served) == len(queries),
                      f"{serve_dtype}: the logger counted {serving['queries']} requests")
                check(serving["batches"] == stats["batches"],
                      f"{serve_dtype}: the logger counted {serving['batches']} batches for "
                      f"the burst's {stats['batches']} dispatches")
                check(sheds == 0 and serving["rejected"] == 0,
                      f"{serve_dtype}: the logger counted {sheds} sheds")
                check(serving["swaps"] == srv.swap_count,
                      f"{serve_dtype}: the logger counted {serving['swaps']} swaps")
            check(stats["max_angle_deg"] <= 0.2,
                  f"{serve_dtype}: served row at {stats['max_angle_deg']} deg > 0.2")
            check(len(versions) == 2, f"{serve_dtype}: versions served {versions}")
            check(swap_acquired == 0, f"{serve_dtype}: the swap acquired {swap_acquired} buckets")
    return launched


def matvec_gram_bound(shape) -> tuple[float, str]:
    """Least time for one fused sweep: C and v read once, w and g written
    once; 4*d*f*k + 2*d*k*k fp32 FLOP (the two products and the Gram)."""
    d, f, k = shape
    bytes_s = (d * f + 2 * d * k + k * k) * 4 / PEAK_BYTES_S
    ops_s = (4 * d * f * k + 2 * d * k * k) / PEAK_FLOPS["float32"]
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def mg_operands(shape, dev, seed: int):
    """``C (d, f)`` and ``v (d, k)`` at the merge's scale: C's columns
    orthonormal times 0.5 (four workers' factors at weight 1/4), v an
    orthonormal block."""
    import torch

    d, f, k = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = torch.linalg.qr(torch.randn((d, f), generator=gen, device=dev))[0]
    v = torch.linalg.qr(torch.randn((d, k), generator=gen, device=dev))[0]
    return (0.5 * c).contiguous(), v.contiguous()


def parity_matvec_gram(dev) -> float:
    """The fused kernel against its plain version; returns the largest
    absolute error on ``w`` or ``g`` over the cases."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg

    from distributed_eigenspaces_tpu_torch.ops.geometry import recording

    worst = 0.0
    plans = set()
    for seed, shape in enumerate(MG_PARITY):
        c, v = mg_operands(shape, dev, seed)
        before = mg.launches
        with recording() as rec:
            w, g = mg.matvec_gram_cuda(c, v)
        torch.cuda.synchronize()
        check(mg.launches == before + 1, "matvec_gram: launch counter did not move")
        plan = mg.matvec_gram_plan(*shape)
        plans.add(plan["resident"])
        check([r.kernel for r in rec] == [mg.matvec_gram_launch(*shape).kernel],
              f"matvec_gram {shape}: recorded {[r.kernel for r in rec]}")
        pw, pg = mg.matvec_gram_plain(c, v)
        rel_w, rel_g = rel_err(w, pw), rel_err(g, pg)
        err = max(float((w - pw).abs().max()), float((g - pg).abs().max()))
        w2, g2 = mg.matvec_gram_cuda(c, v)
        repeat = bool(torch.equal(w, w2) and torch.equal(g, g2))
        symmetric = bool(torch.equal(g, g.mT))
        worst = max(worst, err)
        emit("parity_matvec_gram", shape=list(shape), kernel=rec[0].kernel,
             resident=plan["resident"], grid=list(rec[0].grid),
             dynamic_smem=rec[0].dynamic_smem, rel_frobenius_w=rel_w,
             rel_frobenius_g=rel_g, max_abs_err=err, tol=MG_TOL,
             g_symmetric=symmetric, repeat_bit_identical=repeat)
        check(rel_w <= MG_TOL and rel_g <= MG_TOL,
              f"matvec_gram {shape}: w {rel_w}, g {rel_g} > {MG_TOL}")
        check(symmetric, f"matvec_gram {shape}: g is not symmetric")
        check(repeat, f"matvec_gram {shape}: two launches differ")
        del c, v, w, g, w2, g2, pw, pg
    check(plans == {True, False}, f"matvec_gram parity ran plans {plans}, want both")
    return worst


def timing_matvec_gram(dev, card: str) -> dict:
    """Kernel, plain, library and bound at the slice shape (CUDA events,
    median of 25 after warm-up)."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg

    c, v = mg_operands(MG_SLICE, dev, seed=11)

    def library():
        w = torch.matmul(c, torch.matmul(c.T, v))
        return w, w.T @ w

    ms = time_ms(lambda: mg.matvec_gram_cuda(c, v))
    plain_ms = time_ms(lambda: mg.matvec_gram_plain(c, v))
    library_ms = time_ms(library)
    # the two differ by less than one window's spread: MG_WINDOWS of each, in
    # turn, and their medians
    kernel_windows, library_windows = [], []
    for _ in range(MG_WINDOWS):
        kernel_windows.append(device_ms(lambda: mg.matvec_gram_cuda(c, v)))
        library_windows.append(device_ms(library, launches=None))
    kernel_device_ms = statistics.median(kernel_windows)
    library_device_ms = statistics.median(library_windows)
    bound_ms, bound_by = matvec_gram_bound(MG_SLICE)
    emit("timing_matvec_gram", shape=list(MG_SLICE),
         kernel=mg.matvec_gram_launch(*MG_SLICE).kernel, kernel_ms=ms,
         kernel_device_ms=kernel_device_ms, kernel_device_ms_windows=kernel_windows,
         plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_device_ms,
         library_device_ms_windows=library_windows,
         library="torch.matmul(C, torch.matmul(C.T, v)) + w.T @ w",
         bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
         device_roofline_share=bound_ms / kernel_device_ms, card=card)
    return dict(ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms, bound_ms=bound_ms, bound_by=bound_by)


def synced_s(fn):
    """``(result, seconds)`` of ``fn()`` on the host clock, ending in a
    device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def slice_dsolve(dev, card: str):
    """The large-d solver path: the crossover fit, the fused solve on its
    own operator, and the factor extract against a dense eigh; returns
    the kernel's launches in the fused solve and the fit's components (on
    the host)."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.algo.step import make_solve_core, merge_start
    from distributed_eigenspaces_tpu_torch.data.stream import quantize_block_i8_device
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.solvers import distributed as sd

    d, k, m, n, T = (DSOLVE[f] for f in ("dim", "k", "num_workers",
                                          "rows_per_worker", "num_steps"))
    cfg = dett.PCAConfig(**DSOLVE, solver="distributed", subspace_iters=16,
                         warm_start_iters=1, compute_dtype="bfloat16", stage_dtype="int8",
                         backend="local")
    check(cfg.uses_distributed_solve(), "dsolve: the crossover merge is off")
    # the planted model keeps a (d, 50) basis: no d x d QR on the host
    t0 = time.perf_counter()
    spec = dett.planted_subspace(d, **DSOLVE_DATA)
    data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    truth = torch.as_tensor(spec.top_k(k))

    # 1. the fit (int8 stage); its merges take the unfused factor operator,
    # as the reference's
    est = dett.OnlineDistributedPCA(cfg, device=dev)
    gram_mod.launches = gram_mod.launches_s8 = mg.launches = 0
    _, fit_s = synced_s(lambda: est.fit(data))
    fit_launches = (gram_mod.launches + gram_mod.launches_s8, mg.launches)
    w = est.components_
    check(w.shape == (d, k) and bool(torch.isfinite(w).all()), "dsolve fit: components_")
    angle = float(principal_angles_degrees(w.cpu(), truth).max())
    _, fit2_s = synced_s(lambda: dett.OnlineDistributedPCA(cfg, device=dev).fit(data))
    samples = T * m * n
    emit("slice_dsolve", part="fit",
         config="imagenet12288 shape, d=12288 k=50 m=4 n=2048 T=10 solver=distributed "
                "16 cold / 1 warm bf16, stage int8",
         data="planted_subspace(12288, k_planted=50, gap=20, decay=0.05**(1/49), "
              "noise=0.01, seed=0)",
         trainer=est.trainer_used_, max_angle_deg=angle, data_s=data_s, fit_s=fit_s,
         samples_per_s=samples / fit_s, second_fit_s=fit2_s,
         second_samples_per_s=samples / fit2_s,
         gram_launches=fit_launches[0], matvec_gram_launches=fit_launches[1], card=card)
    check(angle <= 1.0, f"dsolve fit angle {angle} > 1 degree")
    w_host = w.cpu()

    # 2. the fused solve on the fit's own operator: the last block's factors,
    # from that block as the fit staged it
    x_last = quantize_block_i8_device(data[-m * n:].reshape(m, n, d))
    vs = make_solve_core(cfg)(x_last, est.v0)
    cc = sd._scaled_factor_concat(vs, torch.ones((m,), device=dev))
    kk = k + sd._default_oversample(k, cc.shape[1])
    v_init = merge_start(cfg, device=dev)
    check(tuple(v_init.shape) == (d, kk), f"dsolve: merge start {tuple(v_init.shape)}")
    ref, unfused_s = synced_s(lambda: sd.merged_top_k_distributed(
        vs, k, iters=16, v_init=v_init))

    def fused(**kw):
        return sd.dist_subspace_eig(
            sd.factor_matvec(cc), d, k, iters=16, oversample=kk - k, v_init=v_init,
            matvec_gram=sd.fused_factor_matvec(cc), **kw)

    fused()  # warm-up (cuSOLVER handles)
    mg.launches = 0
    v_fused, fused_s = synced_s(fused)
    launches = mg.launches
    agree = float(principal_angles_degrees(v_fused.cpu(), ref.cpu()).max())
    mg.launches = 0
    (v_tol, info), _ = synced_s(lambda: fused(tol=1e-6, with_info=True))
    tol_launches = mg.launches
    emit("slice_dsolve", part="fused_solve", operator=[d, cc.shape[1]], block=kk,
         launches=launches, fused_vs_merged_deg=agree, fused_solve_s=fused_s,
         unfused_merge_s=unfused_s, tol_iters_used=info["iters_used"],
         tol_residual=info["residual"], tol_launches=tol_launches,
         fused_vs_truth_deg=float(principal_angles_degrees(v_fused.cpu(), truth).max()),
         card=card)
    check(launches == 16, f"dsolve: {launches} matvec_gram launches, want 16")
    check(agree <= 0.05, f"dsolve: fused solve {agree} deg from merged_top_k_distributed")
    check(tol_launches == info["iters_used"],
          f"dsolve: {tol_launches} launches for {info['iters_used']} iterations")
    del x_last, vs, cc, est

    # 3. the factor extract against a dense eigh of U diag(s) U^T
    r = 100
    gen = torch.Generator(device=dev).manual_seed(3)
    u = torch.linalg.qr(torch.randn((d, r), generator=gen, device=dev,
                                    dtype=torch.float64))[0].float()
    s_vec = torch.linspace(8.0, 1.0, r, device=dev)
    v_ex, extract_s = synced_s(lambda: sd.dist_extract_top_k(u, s_vec, k, iters=16))

    def dense():
        return torch.linalg.eigh((u * s_vec) @ u.T)[1][:, -k:].flip(-1)

    v_dense, eigh_s = synced_s(dense)
    extract_deg = float(principal_angles_degrees(v_ex.cpu(), v_dense.cpu()).max())
    emit("slice_dsolve", part="extract", d=d, r=r, k=k, extract_vs_eigh_deg=extract_deg,
         extract_s=extract_s, dense_eigh_s=eigh_s, card=card)
    check(extract_deg <= 0.5, f"dsolve extract {extract_deg} deg from the dense eigh")
    dense = dict(data=data, spec=spec, fit_s=fit_s, second_fit_s=fit2_s,
                 second_samples_per_s=samples / fit2_s, max_angle_deg=angle)
    return launches, w_host, dense


def fs_eval_config(**kw):
    """imagenet12288's settings (``evals.py:103-120``) field for field:
    d=12288, k=50, m=4, n=2048, T=10, 12 cold / 1 warm, bf16, int8 stage,
    ``backend="feature_sharded"``."""
    import distributed_eigenspaces_tpu_torch as dett

    return dett.PCAConfig(**{**spec_fit("imagenet12288"), **kw})


def fs_windows(cfg, mesh, data, dev, start_row: int = 0):
    """The fit's blocks from ``start_row`` on, staged as the estimator stages
    them (int8, one scale a block, this rank's columns), in windows of
    ``FS_SEGMENT`` steps."""
    import torch
    from distributed_eigenspaces_tpu_torch.data.bin_stream import window_stream
    from distributed_eigenspaces_tpu_torch.data.stream import block_stream, stage_feature_blocks

    step_rows = cfg.num_workers * cfg.rows_per_worker
    blocks = block_stream(data[start_row:], num_workers=cfg.num_workers,
                          rows_per_worker=cfg.rows_per_worker,
                          num_steps=cfg.num_steps - start_row // step_rows,
                          dtype=torch.float32, device=dev)
    return window_stream(stage_feature_blocks(blocks, "int8", mesh, num_workers=cfg.num_workers,
                                              dim=cfg.dim), FS_SEGMENT)


class FsKilled(Exception):
    """The deliberate stop of the windowed sketch fit after its first window."""


def slice_fs_eval(dev, card: str, work_dir: str, dense: dict) -> dict:
    """imagenet12288 field for field in one process (the (1, 1) layout): the
    sketch fit on slice_dsolve's data, the exact rank-r scan beside it and
    the dense scan of slice_dsolve beside both; ``backend="auto"`` picks the
    sketch; a windowed sketch fit with checkpoints, stopped after its first
    window and resumed from the checkpoint, bit-equal to the unkilled
    windowed fit. Returns the sketch fit's basis and state for the two-rank
    phase."""
    import dataclasses
    import warnings

    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.api.runner import make_whole_fit
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
        LowRankState,
        SketchState,
    )
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer

    data, spec = dense["data"], dense["spec"]
    cfg = fs_eval_config()
    d, k, m, n, T = cfg.dim, cfg.k, cfg.num_workers, cfg.rows_per_worker, cfg.num_steps
    samples = T * m * n
    out = {}
    for trainer in ("sketch", "scan"):
        est = dett.OnlineDistributedPCA(cfg, device=dev, trainer=trainer)
        _, first_s = synced_s(lambda: est.fit(data))  # pays the libraries' start-up
        est = dett.OnlineDistributedPCA(cfg, device=dev, trainer=trainer)
        _, fit_s = synced_s(lambda: est.fit(data))
        w = est.components_
        check(w.shape == (d, k) and bool(torch.isfinite(w).all()), f"fs_eval {trainer}")
        check(isinstance(est.state, SketchState if trainer == "sketch" else LowRankState),
              f"fs_eval {trainer}: state {type(est.state).__name__}")
        out[trainer] = dict(est=est, first_fit_s=first_s, fit_s=fit_s,
                            samples_per_s=samples / fit_s, angle=basis_angle(w, spec))
    sk, ex = out["sketch"], out["scan"]
    sketch_vs_exact = float(principal_angles_degrees(
        sk["est"].components_.cpu(), ex["est"].components_.cpu()).max())
    emit("slice_fs_eval", part="fit", source=FS_EVAL_SOURCE,
         config="imagenet12288 field for field: d=12288 k=50 m=4 n=2048 T=10, 12 cold / "
                "1 warm, bf16, int8 stage, backend=feature_sharded, trainer=sketch; "
                "one process, the (1, 1) layout",
         data="slice_dsolve's planted_subspace(12288, k_planted=50, ...) rows",
         trainer=sk["est"].trainer_used_, max_angle_deg=sk["angle"],
         first_fit_s=sk["first_fit_s"], fit_s=sk["fit_s"],
         samples_per_s=sk["samples_per_s"],
         exact_fs_scan=dict(trainer=ex["est"].trainer_used_, max_angle_deg=ex["angle"],
                            fit_s=ex["fit_s"], samples_per_s=ex["samples_per_s"],
                            angle_to_sketch_deg=sketch_vs_exact),
         dense_scan_of_slice_dsolve=dict(fit_s=dense["second_fit_s"],
                                         samples_per_s=dense["second_samples_per_s"],
                                         max_angle_deg=dense["max_angle_deg"]),
         card=card)
    check(sk["angle"] <= 1.0, f"fs_eval sketch: {sk['angle']} deg from the planted top-50")
    check(ex["angle"] <= 1.0, f"fs_eval fs_scan: {ex['angle']} deg from the planted top-50")

    # backend="auto" at d >= 4096 and d k >= 65536: the feature-sharded sketch
    auto = dett.OnlineDistributedPCA(dataclasses.replace(cfg, backend="auto"), device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, auto_s = synced_s(lambda: auto.fit(data))
    warned = sum("Nystrom" in str(w.message) for w in caught)
    auto_same = bool(torch.equal(auto.components_, sk["est"].components_))
    emit("slice_fs_eval", part="auto", backend="auto", trainer_used_=auto.trainer_used_,
         state=type(auto.state).__name__, warnings=warned, fit_s=auto_s,
         bit_equal_to_explicit_sketch=auto_same, card=card)
    check(auto.trainer_used_ == "sketch" and isinstance(auto.state, SketchState),
          f"fs_eval auto: picked {auto.trainer_used_}")
    check(warned == 1, f"fs_eval auto: {warned} sketch warnings, want 1")
    del auto

    # the windowed sketch fit, stopped after window 1 and resumed
    h = make_whole_fit(cfg, "sketch", device=dev)
    mesh = h.raw.mesh
    unkilled, windowed_s = synced_s(lambda: h.fit_windows(
        h.init_state(), fs_windows(cfg, mesh, data, dev)))
    ckdir = os.path.join(work_dir, "fs_ckpt")
    ck = Checkpointer(ckdir, rows_per_step=m * n, device=dev)

    def stop_after_first(t, st):
        ck.on_step(t, st)
        if t == FS_SEGMENT:
            raise FsKilled

    try:
        h.fit_windows(h.init_state(), fs_windows(cfg, mesh, data, dev),
                      on_segment=stop_after_first)
        check(False, "fs_eval resume: the stopped fit ran to its end")
    except FsKilled:
        pass
    restored, cursor = ck.latest()
    resumed, resume_s = synced_s(lambda: h.fit_windows(
        restored, fs_windows(cfg, mesh, data, dev, cursor), on_segment=ck.on_step))
    bit_equal = (resumed.step == unkilled.step == T
                 and bool(torch.equal(resumed.y, unkilled.y))
                 and bool(torch.equal(resumed.v, unkilled.v)))
    staged_equal = bool(torch.equal(unkilled.y, sk["est"].state.y))
    emit("slice_fs_eval", part="windowed_resume", segment=FS_SEGMENT,
         restored_step=restored.step, cursor=cursor, resumed_step=resumed.step,
         bit_equal_to_unkilled=bit_equal, windowed_equal_to_staged=staged_equal,
         windowed_fit_s=windowed_s, resumed_s=resume_s,
         checkpoints=sorted(os.listdir(ckdir)), card=card)
    check(restored.step == FS_SEGMENT and cursor == FS_SEGMENT * m * n,
          f"fs_eval resume: restored step {restored.step}, cursor {cursor}")
    check(bit_equal, "fs_eval resume: the resumed windowed fit differs from the unkilled one")
    return {"sketch_w": sk["est"].components_.cpu().numpy(),
            "scan_w": ex["est"].components_.cpu().numpy()}


def fs_rank_phase(rank: int, world: int, one: dict, reg_dir: str) -> dict:
    """One rank of ``slice_fs_ranks2`` (both ranks on ``cuda:0``, over gloo,
    a (1, 2) features mesh of 6,144 columns a rank): the sketch and the
    exact rank-r fit of imagenet12288 through the estimator; rank 0
    publishes the sketch basis in two shards and a replica on each rank
    installs it; each rank serves a 64-query burst of 1, 8 and 64 rows
    through ``QueryServer(mesh=)`` on a row-sharded engine at bf16, int8
    and fp32. Fails (and so fails the script) on any gate."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
    from distributed_eigenspaces_tpu_torch.serving.registry import EigenbasisRegistry
    from distributed_eigenspaces_tpu_torch.serving.replication import ReplicaRegistry
    from distributed_eigenspaces_tpu_torch.serving.server import QueryServer
    from distributed_eigenspaces_tpu_torch.serving.transform import TransformEngine

    dev = torch.device(MESH_DEVICE)
    torch.cuda.set_device(dev)
    cfg = fs_eval_config()
    d, k, m, n, T = cfg.dim, cfg.k, cfg.num_workers, cfg.rows_per_worker, cfg.num_steps
    spec = dett.planted_subspace(d, **DSOLVE_DATA)
    data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    mesh = pmesh.auto_feature_mesh(cfg, dev)
    out = {"backend": torch.distributed.get_backend(), "device": str(dev),
           "mesh": mesh.shape}
    fits = {}
    for trainer in ("sketch", "scan"):
        est = dett.OnlineDistributedPCA(cfg, device=dev, trainer=trainer)
        _, fit_s = synced_s(lambda: est.fit(data))
        st = est.state
        with pmesh.mesh_scope(mesh):
            if trainer == "sketch":  # the k+16 square Gram every rank holds
                replicated = pmesh.psum(torch.matmul(est._sketch_fit.raw.omega.mT, st.y),
                                        pmesh.FEATURE_AXIS)
            else:
                replicated = st.s
        w = est.components_
        one_w = torch.from_numpy(one["sketch_w" if trainer == "sketch" else "scan_w"])
        fits[trainer] = est
        out[trainer] = dict(
            trainer=est.trainer_used_, fit_s=fit_s, step=st.step,
            replicated=replicated.cpu().numpy(), rows=tuple(st[0].shape),
            angle_to_one_process=float(principal_angles_degrees(w.cpu(), one_w).max()),
            angle_to_truth=basis_angle(w, spec))
        check(out[trainer]["angle_to_one_process"] <= FS_RANK_DEG,
              f"fs_ranks2 {trainer} rank {rank}: "
              f"{out[trainer]['angle_to_one_process']} deg from the one-process fit")
        check(out[trainer]["angle_to_truth"] <= 1.0, f"fs_ranks2 {trainer}: > 1 degree")
    del data
    # publish in two shards (rank 0), install on a replica (every rank)
    est = fits["sketch"]
    rows = est._sketch_fit.extract(est.state)
    with pmesh.mesh_scope(mesh):
        parts = pmesh.all_gather(rows.contiguous(), pmesh.FEATURE_AXIS, tiled=False)
    if pmesh.is_writer():
        EigenbasisRegistry(registry_dir=reg_dir).publish(
            [p.cpu().numpy() for p in parts], step=est.state.step,
            lineage={"trainer": "sketch", "ranks": world})
    pmesh.barrier()
    replica = ReplicaRegistry(reg_dir, name=f"fs-replica-{rank}", start=False)
    live = replica.latest()
    out["installed"] = dict(version=live.version, spec=live.spec,
                            shard_sizes=live.shard_sizes)
    check(live.spec == ("features", None) and live.shard_sizes == (d // 2, d // 2),
          f"fs_ranks2 replica: installed {out['installed']}")
    # the burst: rows dominant in the served subspace plus moderate noise
    w = torch.from_numpy(np.array(live.v)).to(dev)
    rng = np.random.default_rng(11)
    queries = []
    for i in range(FS_QUERIES):
        r_ = (1, 8, 64)[i % 3]
        c = rng.standard_normal((r_, k))
        noise = rng.standard_normal((r_, d))
        noise *= 0.3 * np.linalg.norm(c, axis=1, keepdims=True) / np.linalg.norm(
            noise, axis=1, keepdims=True)
        queries.append((c @ np.array(live.v).T + noise).astype(np.float32))
    counters = {"bfloat16": "launches", "int8": "launches_i8", "float32": "launches_f32"}
    for dt in FS_SERVE_DTYPES:
        eng = TransformEngine(d, k, mesh=mesh, basis_spec=("features", None),
                              serve_dtype=dt)
        with QueryServer(replica, d=d, k=k, mesh=mesh, engine=eng, serve_dtype=dt) as srv:
            check(srv.lockstep, "fs_ranks2: the server is not in lockstep")
            setattr(sp, counters[dt], 0)
            p0, r0 = eng.psums, srv.lockstep_rounds
            t0 = time.perf_counter()
            tickets = [srv.submit(q) for q in queries]
            zs = [t.result(timeout=300).z for t in tickets]
            burst_s = time.perf_counter() - t0
            launches = getattr(sp, counters[dt])
            psums, rounds = eng.psums - p0, srv.lockstep_rounds - r0
        worst = max(float(row_angles_deg(torch.from_numpy(z),
                                         torch.matmul(torch.from_numpy(q).to(dev), w).cpu()
                                         ).max()) for z, q in zip(zs, queries))
        out[dt] = dict(launches=launches, psums=psums, rounds=rounds, burst_s=burst_s,
                       worst_row_deg=worst, shard=[eng.d_local, k], z=np.concatenate(zs))
        check(eng.d_local == d // 2, f"fs_ranks2 {dt}: shard of {eng.d_local} columns")
        check(worst <= FS_SERVE_DEG, f"fs_ranks2 {dt}: a served row {worst} deg off")
        check(psums == rounds and launches == rounds and rounds >= FS_QUERIES // 8,
              f"fs_ranks2 {dt}: {launches} launches, {psums} psums, {rounds} rounds")
    replica.close()
    return out


def slice_fs_ranks2(dev, card: str, one: dict, work_dir: str) -> dict:
    """Two ranks sharing the card in one gloo group, a (1, 2) features mesh
    (``fs_rank_phase``, one ``parallel.mesh.launch``): every rank's
    replicated values and served rows equal rank 0's bit for bit, each fit
    within 0.01 degrees of the one-process fit; returns the serve kernels' launches per route,
    summed over the ranks."""
    import numpy as np
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    reg_dir = os.path.join(work_dir, "fs_registry")
    (out, ranks_s) = synced_s(lambda: pmesh.launch(
        fs_rank_phase, MESH_RANKS, one, reg_dir, backend="gloo",
        timeout=MESH_TIMEOUT_S, workdir=work_dir))
    r0 = out[0]
    same = {t: all(o[t]["step"] == r0[t]["step"]
                   and np.array_equal(o[t]["replicated"], r0[t]["replicated"])
                   for o in out) for t in ("sketch", "scan")}
    served_same = {dt: all(np.array_equal(o[dt]["z"], r0[dt]["z"]) for o in out)
                   for dt in FS_SERVE_DTYPES}
    emit("slice_fs_ranks2", ranks=MESH_RANKS, backend=r0["backend"], device=r0["device"],
         mesh=r0["mesh"], launch_s=ranks_s,
         fits={t: {f: v for f, v in r0[t].items() if f != "replicated"}
               for t in ("sketch", "scan")},
         replicated_bit_equal=same, installed=r0["installed"],
         serve={dt: [{f: v for f, v in o[dt].items() if f != "z"} for o in out]
                for dt in FS_SERVE_DTYPES},
         served_rows_equal_on_every_rank=served_same, card=card)
    check(all(o["backend"] == "gloo" for o in out), "fs_ranks2: not a gloo group")
    check(all(o["mesh"] == {"workers": 1, "features": MESH_RANKS} for o in out),
          f"fs_ranks2: mesh {[o['mesh'] for o in out]}")
    check(all(same.values()), f"fs_ranks2: replicated values differ from rank 0's: {same}")
    check(all(served_same.values()),
          f"fs_ranks2: served rows differ from rank 0's: {served_same}")
    return {dt: sum(o[dt]["launches"] for o in out) for dt in FS_SERVE_DTYPES}


def slice_tree_eval(dev, card: str, spec, data) -> int:
    """The cifar10 eval field for field through the estimator with
    ``merge_topology=(("chip", 4), ("host", 2))``, in one process: the
    stacked tree (``algo.step.merge_core``) at every merge. Within 1 degree
    of the planted top-10 and 0.5 degrees of the flat fit on the same data
    and starts; the one-tier ``(("all", 8),)`` fit bit-equal to the flat
    fit; one s8 call. Returns the tree fit's s8 calls."""
    import dataclasses

    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    flat_cfg = dett.PCAConfig(**EVAL_FIT)
    flat = dett.OnlineDistributedPCA(flat_cfg).fit(data)
    tree = dett.OnlineDistributedPCA(dataclasses.replace(
        flat_cfg, merge_topology=TREE_EVAL_TOPOLOGY))
    zero_counts()
    _, fit_s = synced_s(lambda: tree.fit(data))
    counts = read_counts()
    one = dett.OnlineDistributedPCA(dataclasses.replace(
        flat_cfg, merge_topology=(("all", flat_cfg.num_workers),))).fit(data)
    angle = components_angle(tree, spec)
    to_flat = float(principal_angles_degrees(tree.components_.cpu(),
                                             flat.components_.cpu()).max())
    one_equal = bool(torch.equal(one.state.sigma_tilde, flat.state.sigma_tilde)
                     and torch.equal(one.components_, flat.components_))
    emit("slice_tree_eval",
         config=f"cifar10 eval (evals.py:86-90) field for field, merge_topology="
                f"{TREE_EVAL_TOPOLOGY} (the stacked tree, one process)",
         trainer=tree.trainer_used_, max_angle_deg=angle, angle_to_flat_deg=to_flat,
         flat_angle_deg=components_angle(flat, spec), one_tier_bit_equal_flat=one_equal,
         counts=counts, fit_s=fit_s, card=card)
    check(angle <= 1.0, f"tree_eval: {angle} deg from the planted top-10")
    check(to_flat <= TREE_FLAT_DEG, f"tree_eval: {to_flat} deg from the flat fit")
    check(one_equal, "tree_eval: the one-tier fit is not the flat fit bit for bit")
    check(counts["s8"] == 1 and counts["gram"] == 0,
          f"tree_eval: Gram launches {counts}, want one s8 call")
    return counts["s8"]


def tree_data(dev):
    """slice_tree_ranks4's planted data (slice_fit's ``planted_spectrum(3072,
    k_planted=10, seed=0)``) rounded to bf16, the values its row file holds:
    ``(spec, x (T, m, n, d) fp32)``, the same bits in every process on the
    same card."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett

    d, k, m, n, T = (TREE_FIT[f] for f in ("dim", "k", "num_workers", "rows_per_worker",
                                           "num_steps"))
    spec = dett.planted_spectrum(d, k_planted=k, seed=0)
    x = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    return spec, x.to(torch.bfloat16).float().reshape(T, m, n, d)


def _tier_traffic(log, topo, T: int) -> dict:
    """Per tier, from the recorder's log of one fit: the data movers'
    dtypes, every sum's dtype, the largest payload in elements, the bytes
    that leave a rank in one round (an all-to-all sends all but its own
    slot, an all-gather its shard to f - 1 peers) and the int8 scale
    sidecars' bytes beside them."""
    from distributed_eigenspaces_tpu_torch.parallel.wire import SCALE_TAG

    out = {}
    for name, f in topo.tiers:
        mine = [r for r in log if r["axis"] == name]
        movers = [r for r in mine if r["op"] in ("all_to_all", "all_gather")
                  and r["tag"] is None]

        def sent(r):
            return r["bytes"] * (f - 1) / f if r["op"] == "all_to_all" else r["bytes"] * (f - 1)

        out[name] = dict(
            mover_dtypes=sorted({r["dtype"] for r in movers}),
            mover_ops=len(movers),
            psum_dtypes=sorted({r["dtype"] for r in mine if r["op"] == "psum"}),
            max_elements=max(r["elements"] for r in mine if r["tag"] is None),
            bytes_per_round=sum(sent(r) for r in movers) / T,
            sidecar_bytes_per_round=sum(sent(r) for r in mine if r["tag"] == SCALE_TAG) / T)
    return out


def tree_rank_phase(rank: int, world: int, path: str) -> dict:
    """One rank of ``slice_tree_ranks4`` (four ranks on ``cuda:0`` over gloo,
    rank ``r`` leaf worker ``r`` of a ``(host, chip)`` tiered mesh).

    (a) The tier-local fit (``make_tree_scan_fit``) of the cifar10 shape
    under slice_fit's bf16 settings, fp32 and the two wire arms with their
    residual norms, each under the collective recorder and the launch
    counters. (c) The fp32 arm again on this rank's worker read from the
    shared bf16 row file with ``bin_block_stream(worker_range=
    host_worker_range(...))``. (b) imagenet12288 on a ``(1, 4)`` features
    mesh through the estimator, the sketch and the rank-r scan, each with
    ``collectives="xla"`` and ``"ring"``, the ring's permutes counted."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
    from distributed_eigenspaces_tpu_torch.data.bin_stream import bin_block_stream
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
    from distributed_eigenspaces_tpu_torch.parallel import multihost, ring
    from distributed_eigenspaces_tpu_torch.parallel import topology as tp
    from distributed_eigenspaces_tpu_torch.parallel.wire import (
        resolve_wire_policy,
        tier_wire_records,
    )

    dev = torch.device(MESH_DEVICE)
    torch.cuda.set_device(dev)
    d, k, m, n, T = (TREE_FIT[f] for f in ("dim", "k", "num_workers", "rows_per_worker",
                                           "num_steps"))
    out = {"backend": torch.distributed.get_backend(), "device": str(dev)}
    spec, x = tree_data(dev)
    arms = {}
    for name, policy in TREE_ARMS:
        cfg = dett.PCAConfig(**TREE_FIT, merge_wire_dtype=policy)
        topo = tp.resolve_topology(cfg)
        mesh = tp.make_tiered_mesh(topo, device=dev)
        fit = tp.make_tree_scan_fit(cfg, mesh, with_wire_stats=policy is not None)
        zero_counts()
        with pmesh.recording_collectives() as log:
            res, fit_s = synced_s(lambda: fit(OnlineState.initial(d, device=dev), x))
        wire = resolve_wire_policy(cfg, topo) or ("fp32",) * len(topo.tiers)
        arms[name] = dict(
            v_bars=res[1].cpu().numpy(), counts=read_counts(), fit_s=fit_s,
            norms=None if policy is None else res[2].cpu().numpy(),
            traffic=_tier_traffic(log, topo, T),
            records=tier_wire_records(topo, wire, d, k),
            truth_deg=basis_angle(res[1][-1], spec))
    out["leaf"] = tp.flat_worker_index(topo, mesh)
    out["mesh"] = mesh.shape
    out["arms"] = arms
    del x
    # (c) this rank's worker from the shared row file
    shard = multihost.host_worker_range(m)
    t0 = time.perf_counter()
    blocks = torch.stack(list(bin_block_stream(
        path, dim=d, num_workers=m, rows_per_worker=n, dtype="bfloat16",
        out_dtype=torch.float32, worker_range=(shard.lo, shard.hi))))
    read_s = time.perf_counter() - t0
    cfg = dett.PCAConfig(**TREE_FIT)
    fit = tp.make_tree_scan_fit(cfg, tp.make_tiered_mesh(tp.resolve_topology(cfg), device=dev))
    _, from_file = fit(OnlineState.initial(d, device=dev), blocks)
    out["file"] = dict(shard=(shard.lo, shard.hi), steps=blocks.shape[0],
                       block=list(blocks.shape[1:]), read_s=read_s,
                       bit_equal_memory=bool(np.array_equal(from_file.cpu().numpy(),
                                                            arms["fp32"]["v_bars"])))
    del blocks
    # (b) the ring on the features axis
    torch.cuda.empty_cache()
    cfg0 = fs_eval_config()
    fspec = dett.planted_subspace(cfg0.dim, **DSOLVE_DATA)
    # drawn a step at a time (four ranks share the card: one 4 GB draw
    # each peaks at three times that), the same rows on every rank
    step_rows = cfg0.num_workers * cfg0.rows_per_worker
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.empty((cfg0.num_steps * step_rows, cfg0.dim), device=dev)
    for t in range(cfg0.num_steps):
        data[t * step_rows:(t + 1) * step_rows] = fspec.sample(gen, step_rows)
    ring_out = {}
    for trainer in ("sketch", "scan"):
        for coll in ("xla", "ring"):
            est = dett.OnlineDistributedPCA(
                fs_eval_config(collectives=coll, mesh_shape=RING_MESH), device=dev,
                trainer=trainer)
            with pmesh.recording_collectives() as log:
                _, fit_s = synced_s(lambda: est.fit(data))
            st, fmesh = est.state, pmesh.auto_feature_mesh(est.cfg, dev)
            with pmesh.mesh_scope(fmesh):  # a replicated value through the ring
                rows = st.y if trainer == "sketch" else st.u
                left = est._sketch_fit.raw.omega if trainer == "sketch" else st.u
                replicated = ring.ring_psum(torch.matmul(left.mT, rows), pmesh.FEATURE_AXIS)
            hops = [r for r in log if r["op"] == "ppermute"]
            ring_out[(trainer, coll)] = dict(
                w=est.components_.cpu().numpy(), fit_s=fit_s, step=st.step,
                state=(st.y if trainer == "sketch" else st.s).cpu().numpy(),
                replicated=replicated.cpu().numpy(), mesh=fmesh.shape,
                hops=len(hops), hop_bytes=sum(r["bytes"] for r in hops),
                truth_deg=basis_angle(est.components_, fspec))
            del est, st
            torch.cuda.empty_cache()
    out["ring"] = ring_out
    return out


def slice_tree_ranks4(dev, card: str, work_dir: str) -> dict:
    """Four ranks sharing the card in one gloo group (one
    ``parallel.mesh.launch`` of ``tree_rank_phase``). The parent writes the
    tiered fit's blocks once as bf16 rows and runs the stacked route on the
    same blocks and starts. Gates: the fp32 arm within 0.2 degrees of the
    stacked route, each wire arm within 0.2 degrees of the fp32 arm and at
    most 0.2 degrees further from the truth, finite ``(T, 2)`` norms, every
    rank's bases bit-equal to rank 0's, one bf16 Gram launch a rank a fit;
    from the recorder, each tier's movers in its wire dtype, every sum fp32,
    no payload above ``max(d k, (f k)^2)`` elements (below the flat route's
    ``m d k`` gather), the bytes leaving a rank a round as
    ``tier_wire_records`` defines them; the fit from the file bit-equal to
    the fit from memory; the ring within ``atol=5e-4`` and 0.01 degrees of
    xla, its replicated values bit-equal across ranks. Returns the bf16
    Gram launches of the ranks' fits."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
    from distributed_eigenspaces_tpu_torch.data.bin_stream import write_rows
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
    from distributed_eigenspaces_tpu_torch.parallel.wire import WIRE_ITEMSIZE

    d, k, m, n, T = (TREE_FIT[f] for f in ("dim", "k", "num_workers", "rows_per_worker",
                                           "num_steps"))
    spec, x = tree_data(dev)
    path = os.path.join(work_dir, "tree_rows.bf16.bin")
    _, write_s = synced_s(lambda: write_rows(path, x.reshape(-1, d).to(torch.bfloat16)))
    stacked = dett.make_scan_fit(dett.PCAConfig(**TREE_FIT), device=dev)(
        OnlineState.initial(d, device=dev), x)[1][-1].cpu()
    del x
    (out, ranks_s) = synced_s(lambda: pmesh.launch(
        tree_rank_phase, TREE_RANKS, path, backend="gloo", timeout=MESH_TIMEOUT_S,
        workdir=work_dir))
    r0 = out[0]

    def deg(a, b):
        return float(principal_angles_degrees(torch.as_tensor(a), torch.as_tensor(b)).max())

    arms = {}
    for name, policy in TREE_ARMS:
        a = r0["arms"][name]
        arms[name] = dict(
            fit_s=[o["arms"][name]["fit_s"] for o in out], counts=a["counts"],
            truth_deg=a["truth_deg"],
            to_stacked_deg=deg(a["v_bars"][-1], stacked),
            to_fp32_deg=deg(a["v_bars"][-1], r0["arms"]["fp32"]["v_bars"][-1]),
            norms_last=None if a["norms"] is None else a["norms"][-1].tolist(),
            ranks_bit_equal=all(np.array_equal(o["arms"][name]["v_bars"], a["v_bars"])
                                for o in out),
            traffic=a["traffic"], compression={})
        for rec in a["records"]:  # the recorder's bytes beside tier_wire_records'
            t = a["traffic"][rec["tier"]]
            fp32_bytes = t["bytes_per_round"] * 4 / WIRE_ITEMSIZE[rec["wire_dtype"]]
            arms[name]["compression"][rec["tier"]] = dict(
                rec, measured_ratio=fp32_bytes / (t["bytes_per_round"]
                                                  + t["sidecar_bytes_per_round"]))
    ring = {}
    for trainer in ("sketch", "scan"):
        xl, rg = r0["ring"][(trainer, "xla")], r0["ring"][(trainer, "ring")]
        ring[trainer] = dict(
            xla_fit_s=xl["fit_s"], ring_fit_s=rg["fit_s"], step=rg["step"],
            ring_to_xla_deg=deg(rg["w"], xl["w"]),
            state_max_abs=float(np.abs(rg["state"] - xl["state"]).max()),
            truth_deg=rg["truth_deg"], xla_truth_deg=xl["truth_deg"], mesh=rg["mesh"],
            ppermute_hops=rg["hops"], ppermute_bytes=rg["hop_bytes"],
            xla_hops=xl["hops"],
            replicated_bit_equal=all(np.array_equal(o["ring"][(trainer, "ring")]["replicated"],
                                                    rg["replicated"]) for o in out))
    emit("slice_tree_ranks4", ranks=TREE_RANKS, backend=r0["backend"], device=r0["device"],
         mesh=r0["mesh"], config="cifar10 shape under slice_fit's bf16 settings (d=3072 k=10 "
         "n=1024 T=20, subspace 12 / warm 2, cholqr2, no stage), m=4 on merge_topology="
         f"{TREE_TIERS}", cuts="m=4 (one leaf worker a rank, 4 ranks share one card); "
         "tiers named chip and host, every collective through host memory over gloo, "
         "not NVLink; 4 ranks stand in for a features axis of cards",
         launch_s=ranks_s, file_write_s=write_s, arms=arms,
         file=[o["file"] for o in out], ring=ring, card=card)
    check(all(o["backend"] == "gloo" for o in out), "tree_ranks4: not a gloo group")
    check([o["leaf"] for o in out] == list(range(TREE_RANKS)),
          f"tree_ranks4: leaves {[o['leaf'] for o in out]}")
    check(arms["fp32"]["to_stacked_deg"] <= TREE_ARM_DEG,
          f"tree_ranks4: fp32 arm {arms['fp32']['to_stacked_deg']} deg from the stacked route")
    for name, policy in TREE_ARMS:
        a = arms[name]
        check(a["ranks_bit_equal"], f"tree_ranks4 {name}: a rank's bases differ from rank 0's")
        for o in out:
            c = o["arms"][name]["counts"]
            check(c["gram"] == 1 and c["tma"] == 1 and c["s8"] == 0,
                  f"tree_ranks4 {name}: Gram launches {c}, want one bf16 TMA launch")
        if policy is not None:
            check(a["to_fp32_deg"] <= TREE_ARM_DEG,
                  f"tree_ranks4 {name}: {a['to_fp32_deg']} deg from the fp32 arm")
            check(a["truth_deg"] <= arms["fp32"]["truth_deg"] + TREE_ARM_DEG,
                  f"tree_ranks4 {name}: {a['truth_deg']} deg from the truth")
            norms = r0["arms"][name]["norms"]
            check(norms.shape == (T, len(TREE_TIERS)) and bool(np.isfinite(norms).all()),
                  f"tree_ranks4 {name}: residual norms {norms.shape}")
        for tier, f in TREE_TIERS:
            t = a["traffic"][tier]
            want = {"fp32": "float32", "bf16": "bfloat16", "int8": "int8"}[
                (policy or {}).get(tier, "fp32")]
            check(t["mover_dtypes"] == [want], f"tree_ranks4 {name} {tier}: movers carry "
                                               f"{t['mover_dtypes']}, want {want}")
            check(t["psum_dtypes"] == ["float32"], f"tree_ranks4 {name} {tier}: sums carry "
                                                   f"{t['psum_dtypes']}")
            check(t["max_elements"] <= max(d * k, (f * k) ** 2) < m * d * k,
                  f"tree_ranks4 {name} {tier}: a payload of {t['max_elements']} elements")
            item = WIRE_ITEMSIZE[(policy or {}).get(tier, "fp32")]
            check(t["bytes_per_round"] == 2 * (f - 1) / f * d * k * item,
                  f"tree_ranks4 {name} {tier}: {t['bytes_per_round']} bytes a round")
    for o in out:
        check(o["file"]["bit_equal_memory"] and o["file"]["steps"] == T,
              f"tree_ranks4: the fit from the file differs on rank {o['file']['shard']}")
    for trainer, r in ring.items():
        check(r["ring_to_xla_deg"] <= RING_DEG and r["state_max_abs"] <= RING_ATOL,
              f"ring {trainer}: {r['ring_to_xla_deg']} deg, {r['state_max_abs']} from xla")
        check(r["replicated_bit_equal"], f"ring {trainer}: replicated values differ by rank")
        check(r["ppermute_hops"] > 0 and r["xla_hops"] == 0,
              f"ring {trainer}: {r['ppermute_hops']} ring hops, xla {r['xla_hops']}")
        check(r["truth_deg"] <= 1.0, f"ring {trainer}: {r['truth_deg']} deg from the truth")
    return {"bf16": sum(o["arms"][name]["counts"]["tma"] for o in out
                        for name, _ in TREE_ARMS)}


def mutant_bound(shape) -> tuple[float, str]:
    """Least time for ``x @ v`` of ``shape``: x and v read once, o written
    once, in fp32, against 2*rows*d*k fp32 FLOP."""
    rows, d, k = shape
    bytes_s = (rows * d + d * k + rows * k) * 4 / PEAK_BYTES_S
    ops_s = 2 * rows * d * k / PEAK_FLOPS["float32"]
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s >= ops_s else "operations")


def parity_mutant(dev) -> float:
    """The one-CTA mutant against its plain version; returns the largest
    absolute error over the cases."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb
    from distributed_eigenspaces_tpu_torch.ops.geometry import recording

    worst = 0.0
    for seed, shape in enumerate(MUTANT_PARITY):
        x, v = serve_operands(shape, dev, seed=20 + seed)
        before = mfb.launches
        with recording() as rec:
            got = mfb.mutant_full_block_cuda(x, v)
        torch.cuda.synchronize()
        check(mfb.launches == before + 1, "mutant: launch counter did not move")
        check(rec == [mfb.mutant_full_block_launch(*shape)],
              f"mutant: recorded {rec}, not the declared launch")
        want = mfb.mutant_full_block_plain(x, v)
        rel = rel_err(got, want)
        err = float((got - want).abs().max().item())
        worst = max(worst, err)
        emit("parity_mutant", shape=list(shape), rel_frobenius=rel, max_abs_err=err,
             tol=MUTANT_TOL, grid=list(rec[0].grid), threads=rec[0].threads,
             dynamic_smem=rec[0].dynamic_smem)
        check(rel <= MUTANT_TOL, f"mutant {shape}: {rel} > {MUTANT_TOL}")
    return worst


def timing_mutant(dev, card: str) -> dict:
    """Kernel, plain, library and bound at the audit shape (CUDA events,
    median of 25 after warm-up). The kernel is slow by design."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb

    x, v = serve_operands(MUTANT_AUDIT, dev, seed=22)
    ms = time_ms(lambda: mfb.mutant_full_block_cuda(x, v))
    kernel_device_ms = device_ms(lambda: mfb.mutant_full_block_cuda(x, v))
    plain_ms = time_ms(lambda: mfb.mutant_full_block_plain(x, v))
    library_ms = time_ms(lambda: torch.matmul(x, v))
    library_device_ms = device_ms(lambda: torch.matmul(x, v), launches=None)
    bound_ms, bound_by = mutant_bound(MUTANT_AUDIT)
    emit("timing_mutant", shape=list(MUTANT_AUDIT), kernel_ms=ms,
         kernel_device_ms=kernel_device_ms, plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms, library="torch.matmul(x, v), fp32",
         bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms, card=card)
    return dict(ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms, bound_ms=bound_ms, bound_by=bound_by)


def eval_s8_calls(spec, repeats: int) -> int:
    """The s8 Gram calls one ``run_eval`` of ``spec`` makes on the card: a
    whole fit (the accuracy fit, the warm-up, ``repeats`` timed fits) takes
    the Gram on its cold step and streams its warm ones; clip768 (k=256)
    takes the Gram on every step of its warm-up pass and of each timed run,
    and of the one window timed alone; the sketch takes none."""
    if spec.trainer == "sketch":
        return 0
    if spec.streaming == "bin":
        return (1 + repeats) * spec.steps + min(5, spec.steps)
    return 2 + repeats


def slice_evals(dev, card: str) -> dict:
    """The eval harness on the six specs at full size: one report line
    each, their gates (``accuracy_ok``, the reference's route, the s8 calls,
    the anchors, the device block). Returns the s8 calls by eval."""
    import torch
    from distributed_eigenspaces_tpu_torch.evals import EVAL_SPECS, run_eval
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod

    s8 = {}
    for name, spec in EVAL_SPECS.items():
        gram_mod.launches = gram_mod.launches_tma = gram_mod.launches_s8 = 0
        t0 = time.perf_counter()
        rep = run_eval(name, device=dev)
        torch.cuda.synchronize()
        launched = (gram_mod.launches, gram_mod.launches_tma, gram_mod.launches_s8)
        emit("slice_evals", eval_s=time.perf_counter() - t0, gram_launches=launched[0],
             tma_launches=launched[1], s8_calls=launched[2], report=rep, card=card)
        roof = rep["roofline"]
        want_s8 = eval_s8_calls(spec, rep["timing"]["n_repeats"])
        check(rep["accuracy_ok"], f"evals {name}: {rep['principal_angle_deg']} deg")
        check((rep["backend"], rep["trainer"]) == EVAL_ROUTES[name],
              f"evals {name}: backend / trainer {rep['backend']} / {rep['trainer']}")
        check(name != "clip768" or (rep["streaming"], rep["bin_dtype"]) == ("bin", "int8"),
              f"evals {name}: streaming {rep['streaming']}")
        check(rep["timing"]["n_repeats"] == 3, f"evals {name}: {rep['timing']['n_repeats']} "
                                               "repeats, want the default 3")
        check(launched == (0, 0, want_s8), f"evals {name}: Gram launches (float, TMA, s8) "
                                           f"{launched}, want (0, 0, {want_s8})")
        check(roof.get("anchor_tflops", 0) > 0, f"evals {name}: no matmul anchor")
        check("hbm_anchor_gb_per_sec" in roof or (
            roof.get("hbm_probe_failed") and roof.get("hbm_probe", {}).get("attempts")),
            f"evals {name}: no HBM anchor and no failed-probe record")
        check(roof["pct_of_anchor"] <= EVAL_PCT_MAX,
              f"evals {name}: {roof['pct_of_anchor']}% of the matmul anchor")
        devb = rep["device"]
        check(devb["platform"] == "gpu" and devb["kind"] == torch.cuda.get_device_name(0)
              and devb["count"] == torch.cuda.device_count() and devb["power_limit"],
              f"evals {name}: device block {devb}")
        s8[name] = launched[2]
        torch.cuda.empty_cache()
    return s8


def is_f32_serve(kernel: str) -> bool:
    """Whether a launch record's kernel is the fp32 serve kernel
    (``serve_split_kernel<float, 2, NP>``: basis code 2)."""
    return kernel.startswith("serve_split_kernel<") and kernel.split(",")[1].strip() == "2"


def analysis(dev, card: str) -> dict:
    """The port's analyzer on the card, under the launch recorder and the
    profiler; returns each kernel's launches in that run, and the launches
    rank 0 recorded in the mesh programs, by kernel (``mesh_kernels``)."""
    import torch
    from distributed_eigenspaces_tpu_torch.analysis import costmodel, programs, report
    from distributed_eigenspaces_tpu_torch.ops import geometry
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(trace_dir, exist_ok=True)
    # the profiler can leave the first kernel events of a window out (as
    # device_ms finds; here, late in the script, the first window lost its
    # first two serve launches in 5 of 6 runs, later windows in 3 of 8): the
    # programs run once before any window, each window opens with
    # ANALYSIS_WARM_ROUNDS pairs of untimed kernels and a pause, and a
    # window with fewer events than recorded launches (never one with an
    # event of another geometry) is run again, up to ANALYSIS_WINDOWS
    # times, each attempt printed; the checks below hold the last one. The
    # first run_analysis builds the mesh programs and mutants on 4 gloo
    # ranks sharing the card, in one launch a process: the windows reuse
    # them, so their launches are this process's programs'
    t0 = time.perf_counter()
    report.run_analysis(device=dev)
    mesh_s = time.perf_counter() - t0
    report.run_mutation_report(device=dev)
    torch.cuda.synchronize()
    for attempt in range(1, ANALYSIS_WINDOWS + 1):
        sp.launches = sp.launches_i8 = sp.launches_f32 = mg.launches = mfb.launches = 0
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiler_warm(dev, ANALYSIS_WARM_ROUNDS)
            time.sleep(PAUSE_S)
            with geometry.recording() as launches:
                rep = report.run_analysis(device=dev)
                mut = report.run_mutation_report(device=dev)
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)
        seconds = time.perf_counter() - t0
        counts = {"serve_project_bf16": sp.launches, "serve_project_i8": sp.launches_i8,
                  "serve_project_f32": sp.launches_f32, "matvec_gram": mg.launches,
                  "mutant_full_block": mfb.launches}
        events = geometry.profiled_kernels(
            prof, geometry.RECORDED_KERNELS,
            os.path.join(trace_dir, "chip_smoke_analysis_trace.json"))
        mismatches = geometry.geometry_mismatches(events, launches)
        emit("analysis", part="window", attempt=attempt, recorded_launches=len(launches),
             profiled_events=len(events), geometry_mismatches=mismatches)
        if len(events) == len(launches):
            break
    for ev in events:
        emit("analysis", part="profiled_kernel", name=ev["name"], symbol=ev["symbol"],
             grid=ev["grid"], block=ev["block"], smem=ev["smem"], device_us=ev["dur_us"],
             args=ev["args"])
    # rank 0's launches in the mesh programs, by kernel (the audited calls'
    # and their builds'), and the fp32 serve launches with a resolved grid
    # of each serve mesh program (a reconstruct or residual program's come
    # from the projection its build makes before the audited bucket)
    mesh_kernels: dict = {}
    serve_mesh = {name: 0 for name in ANALYSIS_SERVE_MESH}
    for name, entry in rep["programs"].items():
        emit("analysis", part="program", program=name, ok=entry["ok"],
             contract=entry["contract"], collectives=entry["collectives"],
             costs={k: entry["costs"][k] for k in ("collectives_per_axis",
                                                   "budget_bytes_per_op")},
             pallas=entry["pallas"], memory=entry["memory"],
             shardings=entry["shardings"], launches=entry["launches"],
             setup_launches=entry["setup_launches"], violations=entry["violations"])
        if name in programs.MESH_PROGRAMS:
            for la in entry["launches"] + entry["setup_launches"]:
                mesh_kernels[la["kernel"]] = mesh_kernels.get(la["kernel"], 0) + 1
                if name in serve_mesh and is_f32_serve(la["kernel"]) and la["grid"]:
                    serve_mesh[name] += 1
    # the mesh programs' collectives against the committed snapshot (made on
    # the CPU): gloo moves the same tensors on both routes
    current = {"schema": costmodel.SNAPSHOT_SCHEMA, "programs": {
        name: {k: entry["costs"][k] for k in ANALYSIS_SNAPSHOT_KEYS}
        for name, entry in rep["programs"].items()}}
    drift = costmodel.check_snapshot(current, costmodel.load_snapshot(),
                                     keys=ANALYSIS_SNAPSHOT_KEYS, projections_too=False)
    emit("analysis", part="summary", device=rep["device"], ok=rep["ok"],
         n_violations=rep["n_violations"], lints=rep["lints"],
         mutations={r["mutation"]: r["caught"] for r in mut["mutations"]},
         recorded_launches=len(launches), profiled_events=len(events),
         kernels_device_us=sum(ev["dur_us"] or 0.0 for ev in events),
         geometry_mismatches=mismatches, launches=counts, seconds=seconds,
         mesh_programs_s=mesh_s, mesh_launches_rank0=mesh_kernels,
         serve_mesh_f32_launches_rank0=serve_mesh,
         snapshot_drift=[v.format() for v in drift], card=card)
    # (a) every program honours its contract, the single-device ones with
    # their kernels launched, the mesh ones' collectives as the snapshot's
    check(rep["ok"] and len(rep["programs"]) == ANALYSIS_PROGRAMS,
          f"analysis: {rep['n_violations']} violations over {list(rep['programs'])}")
    check(all(e["launches"] and all(la["grid"] for la in e["launches"])
              for name, e in rep["programs"].items() if name in programs.PROGRAMS),
          "analysis: a program recorded no resolved kernel launch on the card")
    check(all(n >= 1 for n in serve_mesh.values()),
          f"analysis: fp32 serve launches on rank 0 of the serve mesh programs {serve_mesh}")
    check(all(e["shardings"]["checked"] for name, e in rep["programs"].items()
              if name in programs.MESH_PROGRAMS),
          "analysis: a mesh program's layouts were not checked")
    check(not drift, f"analysis: collectives drifted from the snapshot: "
                     f"{[v.format() for v in drift]}")
    # (b) the declarations equal the card's launches, one event per launch
    check(not mismatches, f"analysis: profiled geometry differs: {mismatches}")
    check(len(events) == len(launches) > 0,
          f"analysis: {len(events)} profiled events for {len(launches)} launches")
    mutant = [e for e in events if e["symbol"] == "mutant_full_block_kernel"]
    check([e["grid"] for e in mutant] == [(1, 1, 1)],
          f"analysis: mutant grids {[e['grid'] for e in mutant]}")
    # (c) every ported mutation is caught
    caught = sum(r["caught"] for r in mut["mutations"])
    check(mut["ok"] and caught == ANALYSIS_MUTATIONS == len(mut["mutations"]),
          f"analysis: {caught} of {len(mut['mutations'])} mutations caught")
    check(all(n >= 1 for n in counts.values()), f"analysis: launches {counts}")
    return dict(counts, mesh_kernels=mesh_kernels)


def lane_angles_deg(v, truth, lanes: int) -> list[float]:
    """Per lane: the largest principal angle between a lane's columns of
    ``v`` and the same columns of ``truth`` (float64)."""
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    kb = v.shape[1] // lanes
    return [float(principal_angles_degrees(v[:, i * kb:(i + 1) * kb].cpu(),
                                           truth[:, i * kb:(i + 1) * kb].cpu()).max())
            for i in range(lanes)]


def counted_syncs(fn):
    """``(fn(), syncs)``: the device synchronizations ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (one warning
    each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def slice_deflate(dev, card: str, dsolve_w) -> int:
    """The deflation route at the imagenet12288 shape (slice_dsolve's fit with
    the merge on parallel-deflation lanes), one tol-stopped merge with its
    per-lane counters, and every lane of the cold, warm and grown solves on
    bench.py --deflate's operand against the dense eigh; returns the s8 calls
    of the fit."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.algo import step as step_mod
    from distributed_eigenspaces_tpu_torch.algo.step import make_solve_core, merge_start
    from distributed_eigenspaces_tpu_torch.data.stream import quantize_block_i8_device
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops.linalg import (
        merged_top_k_lowrank,
        principal_angles_degrees,
    )
    from distributed_eigenspaces_tpu_torch.solvers import deflation as sdefl
    from distributed_eigenspaces_tpu_torch.solvers import distributed as sd

    d, k, m, n, T = (DSOLVE[f] for f in ("dim", "k", "num_workers",
                                          "rows_per_worker", "num_steps"))
    cfg = dett.PCAConfig(**DSOLVE, solver="deflation", components_axis_size=DEFLATE_LANES,
                         subspace_iters=16, warm_start_iters=1, compute_dtype="bfloat16",
                         stage_dtype="int8", backend="local")
    check(cfg.uses_deflation_solve(), "deflate: the deflation merge is off")
    check(tuple(merge_start(cfg, device=dev).shape) == (d, k),
          "deflate: the lanes' start is not (d, k)")
    t0 = time.perf_counter()
    spec = dett.planted_subspace(d, **DSOLVE_DATA)
    data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    truth = torch.as_tensor(spec.top_k(k))

    # 1. the fit; every merge on the lanes, counted with its device syncs
    merges = {"calls": 0, "syncs": 0, "lanes": set()}
    real_merge = step_mod.merged_top_k_deflation

    def counted_merge(*a, **kw):
        merges["calls"] += 1
        merges["lanes"].add(kw["lanes"])
        out, syncs = counted_syncs(lambda: real_merge(*a, **kw))
        merges["syncs"] += syncs
        return out

    est = dett.OnlineDistributedPCA(cfg, device=dev)
    gram_mod.launches = gram_mod.launches_s8 = 0
    _, fit_s = synced_s(lambda: est.fit(data))
    fit_launches = (gram_mod.launches, gram_mod.launches_s8)
    w = est.components_
    check(w.shape == (d, k) and bool(torch.isfinite(w).all()), "deflate fit: components_")
    angle = float(principal_angles_degrees(w.cpu(), truth).max())
    vs_dsolve = float(principal_angles_degrees(w.cpu(), dsolve_w).max())
    _, fit2_s = synced_s(lambda: dett.OnlineDistributedPCA(cfg, device=dev).fit(data))
    step_mod.merged_top_k_deflation = counted_merge
    residual_syncs0 = sdefl.syncs
    try:
        dett.OnlineDistributedPCA(cfg, device=dev).fit(data)
    finally:
        step_mod.merged_top_k_deflation = real_merge
    samples = T * m * n
    emit("slice_deflate", part="fit",
         config=f"imagenet12288 shape, d=12288 k=50 m=4 n=2048 T=10 solver=deflation "
                f"components_axis_size={DEFLATE_LANES} 16 cold / 1 warm bf16, stage int8",
         data="planted_subspace(12288, k_planted=50, gap=20, decay=0.05**(1/49), "
              "noise=0.01, seed=0)",
         trainer=est.trainer_used_, max_angle_deg=angle, vs_dsolve_fit_deg=vs_dsolve,
         data_s=data_s, fit_s=fit_s, samples_per_s=samples / fit_s, second_fit_s=fit2_s,
         second_samples_per_s=samples / fit2_s, gram_launches=fit_launches[0],
         s8_calls=fit_launches[1], merges=merges["calls"], merge_lanes=sorted(merges["lanes"]),
         merge_syncs=merges["syncs"], merge_residual_syncs=sdefl.syncs - residual_syncs0,
         card=card)
    check(angle <= 1.0, f"deflate fit angle {angle} > 1 degree")
    check(merges["calls"] == T and merges["lanes"] == {DEFLATE_LANES},
          f"deflate: {merges['calls']} lane merges ({merges['lanes']}), want {T} of "
          f"{DEFLATE_LANES}")
    # d >= 4096: every worker streams X^T (X V) (the reference's route rule), so
    # the int8 stage reaches no Gram kernel
    check(fit_launches == (0, 0), f"deflate fit: Gram launches {fit_launches}, want none")

    # 2. one tol-stopped merge on the last round's factors, with its counters
    x_last = quantize_block_i8_device(data[-m * n:].reshape(m, n, d))
    vs = make_solve_core(cfg)(x_last, est.v0)
    v_init = merge_start(cfg, device=dev)
    exact = merged_top_k_lowrank(vs, k)
    sdefl.merged_top_k_deflation(vs, k, lanes=DEFLATE_LANES, iters=4, v_init=v_init)  # warm-up
    (v_tol, info), solve_s = synced_s(lambda: sdefl.merged_top_k_deflation(
        vs, k, lanes=DEFLATE_LANES, tol=1e-3, iters=64, v_init=v_init, with_info=True))
    _, all_syncs = counted_syncs(lambda: sdefl.merged_top_k_deflation(
        vs, k, lanes=DEFLATE_LANES, tol=1e-3, iters=64, v_init=v_init))
    fixed, fixed_s = synced_s(lambda: sdefl.merged_top_k_deflation(
        vs, k, lanes=DEFLATE_LANES, iters=16, v_init=v_init))
    span = float(principal_angles_degrees(v_tol.cpu(), exact.cpu()).max())
    span_fixed = float(principal_angles_degrees(fixed.cpu(), exact.cpu()).max())
    emit("slice_deflate", part="merge_with_info", operator=[d, m * k], lanes=DEFLATE_LANES,
         tol=1e-3, iters=64, iters_used=info["iters_used"], residual=info["residual"],
         residual_syncs=info["syncs"], device_syncs=all_syncs, solve_s=solve_s,
         span_vs_exact_merge_deg=span, fixed16_s=fixed_s, fixed16_vs_exact_merge_deg=span_fixed,
         card=card)
    check(max(info["residual"]) <= 1e-3 and max(info["iters_used"]) < 64,
          f"deflate merge: lanes did not converge {info}")
    check(info["syncs"] == max(info["iters_used"]), "deflate merge: syncs != sweeps")
    check(span <= DEFLATE_LANE_DEG and span_fixed <= DEFLATE_LANE_DEG,
          f"deflate merge span {span} / {span_fixed} deg from the exact merge")
    del data, x_last, vs, est

    # 3. every lane against the dense eigh on the geometric operand
    od, ok_, lanes, r = (DEFLATE_OPERAND[f] for f in ("d", "k", "lanes", "r"))
    rng = np.random.default_rng(0)
    u = np.linalg.qr(rng.standard_normal((od, r)))[0].astype(np.float32)
    s = (8.0 * 0.5 ** np.arange(r)).astype(np.float32)
    v_warm = np.linalg.qr(u[:, :ok_].astype(np.float64)
                          + 0.02 * rng.standard_normal((od, ok_)))[0].astype(np.float32)
    c = torch.as_tensor(u * np.sqrt(s)[None, :], device=dev)
    mv = sd.factor_matvec(c)
    eigh_v = torch.linalg.eigh(c @ c.T)[1][:, -ok_:].flip(-1)
    gen = torch.Generator(device=dev).manual_seed(7)
    start = torch.randn((od, ok_), generator=gen, device=dev)
    sdefl.deflation_eig(mv, od, ok_, lanes=lanes, iters=2, v_init=start)  # warm-up
    (cold, cold_info), cold_s = synced_s(lambda: sdefl.deflation_eig(
        mv, od, ok_, lanes=lanes, iters=64, tol=1e-3, v_init=start, with_info=True))
    warm, warm_s = synced_s(lambda: sdefl.deflation_eig(
        mv, od, ok_, lanes=lanes, iters=12, v_init=start,
        v0=torch.as_tensor(v_warm, device=dev)))
    k0 = ok_ // 2
    parent = sd.dist_subspace_eig(mv, od, k0, iters=12, v_init=start[:, :k0])
    grown, grow_s = synced_s(lambda: sdefl.grow_basis(mv, parent, ok_, iters=12,
                                                     v_init=start[:, k0:]))
    angles = {"cold": lane_angles_deg(cold, eigh_v, lanes),
              "warm": lane_angles_deg(warm, eigh_v, lanes),
              "grown": lane_angles_deg(grown, eigh_v, lanes)}
    prefix = bool(torch.equal(grown[:, :k0], parent))
    emit("slice_deflate", part="lanes",
         operand="bench.py --deflate: U diag(8 * 0.5^i) U^T, d=2048 rank 16, k=8, 4 lanes",
         lane_angles_deg=angles, cold_iters_used=cold_info["iters_used"],
         cold_residual=cold_info["residual"], cold_s=cold_s, warm_s=warm_s, grow_s=grow_s,
         grown_prefix_bit_equal=prefix, budget_deg=DEFLATE_LANE_DEG, card=card)
    for name, a in angles.items():
        check(max(a) <= DEFLATE_LANE_DEG, f"deflate {name}: lanes {a} deg from the eigh")
    check(prefix, "deflate: the grown prefix is not the parent bit for bit")
    return fit_launches[1]


def slice_grow(dev, card: str, work_dir: str, spec, data) -> dict:
    """The CLI's --grow-k path at the cifar10 settings: fit, publish under a
    publisher lease, grow to k' = 20 on the fit's state, publish the grown
    version, tail it from a replica and serve it at bf16 and int8. Returns
    the fit (for slice_drift), its s8 calls and the serve launches."""
    import dataclasses

    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from distributed_eigenspaces_tpu_torch.serving import (
        EigenbasisRegistry,
        PublisherLease,
        QueryServer,
        ReplicaRegistry,
    )
    from distributed_eigenspaces_tpu_torch.solvers import grow_basis
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    cfg = dett.PCAConfig(**EVAL_FIT)
    est = dett.OnlineDistributedPCA(cfg)
    gram_mod.launches_s8 = 0
    _, fit_s = synced_s(lambda: est.fit(data))
    s8_calls = gram_mod.launches_s8
    fit_angle = components_angle(est, spec)
    reg_dir = os.path.join(work_dir, "registry_grow")
    lease = PublisherLease(reg_dir, owner="chip-smoke", lease_ms=5000.0).acquire(10.0)
    lease.start_heartbeat()
    rep = None
    try:
        reg = EigenbasisRegistry(registry_dir=reg_dir, lease=lease)
        parent = reg.publish_fit(est)
        rep_logger = MetricsLogger()
        rep = ReplicaRegistry(reg_dir, name="replica-0", staleness_ms=REPLICA_STALENESS_MS,
                              poll_s=0.005, metrics=rep_logger)
        sigma = est.state.sigma_tilde.float()
        v_parent = torch.as_tensor(np.array(parent.v), device=dev)
        v_init = torch.randn((cfg.dim, GROW_K - cfg.k), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(11))
        (v_grown, info), grow_s = synced_s(lambda: grow_basis(
            lambda v: sigma @ v, v_parent, GROW_K, iters=cfg.subspace_iters,
            tol=cfg.solver_tol, v_init=v_init, with_info=True))
        grown_host = v_grown.cpu().numpy()
        t_pub = time.perf_counter()
        grown = reg.publish_grown(parent, v_grown)
        publish_s = time.perf_counter() - t_pub
        deadline = time.perf_counter() + 10.0
        while rep.latest() is None or rep.latest().version < grown.version:
            check(time.perf_counter() < deadline, "grow: the replica never installed the "
                                                  "grown version")
            time.sleep(0.002)
        install_s = time.perf_counter() - t_pub
        installed = rep.get(grown.version)
        gram = grown_host.T @ grown_host
        orth_err = float(np.abs(gram - np.eye(GROW_K)).max())
        lineage_ok = ({f: grown.lineage.get(f) for f in ("producer", "grew_from", "k_from",
                                                       "k_to")}
                      == {"producer": "grow_basis", "grew_from": parent.version,
                          "k_from": cfg.k, "k_to": GROW_K})
        health = rep.health()
        stats = dict(
            fit_s=fit_s, fit_angle_deg=fit_angle, s8_calls=s8_calls, grow_s=grow_s,
            grow_iters=info["iters_used"], publish_s=publish_s, install_s=install_s,
            parent_version=parent.version, grown_version=grown.version,
            lineage=grown.lineage, lease_epoch=lease.epoch,
            prefix_bit_equal=bool(np.array_equal(grown.v[:, :cfg.k], parent.v)),
            orthonormality_max_abs=orth_err,
            grown_vs_planted_top10_deg=float(basis_angle(grown_host[:, :cfg.k], spec)),
            replica_grown_installs=rep.grown_installs,
            replica_payload_bit_equal=bool(np.array_equal(installed.v, grown_host)),
            replica_lineage_grew_from=installed.lineage.get("grew_from"),
            replica_version_lag=rep.version_lag(), replica_last_lag_ms=health["last_lag_ms"],
            replica_stale_installs=health["stale_installs"],
            staleness_ms=REPLICA_STALENESS_MS)
        emit("slice_grow", part="grow_and_replicate",
             config=f"cifar10 eval settings ({EVAL_FIT['dim']}, k={cfg.k}) grown to "
                    f"k'={GROW_K}, iters {cfg.subspace_iters}, tol {cfg.solver_tol}",
             card=card, **stats)
        check(stats["prefix_bit_equal"], "grow: the prefix is not the parent bit for bit")
        check(lineage_ok, f"grow: lineage {grown.lineage}")
        check(orth_err <= 1e-5, f"grow: ||V^T V - I|| = {orth_err}")
        check(rep.grown_installs == 1, f"grow: {rep.grown_installs} grown installs")
        check(stats["replica_payload_bit_equal"], "grow: the replica's payload differs")
        check(stats["replica_version_lag"] == 0, "grow: the replica lags the store")
        check(health["last_lag_ms"] is not None
              and health["last_lag_ms"] <= REPLICA_STALENESS_MS,
              f"grow: propagation {health['last_lag_ms']} ms > {REPLICA_STALENESS_MS}")
        replication = rep_logger.summary()["replication"]
        installs = [r for r in rep_logger.replication_records
                    if r["replication"] == "install"]
        emit("slice_grow", part="metrics", replication={
            key: v for key, v in replication.items() if key != "recent"}, card=card)
        check(replication["installs"] == rep.installs == len(installs) >= 2,
              f"grow: the logger counted {replication['installs']} installs, the replica "
              f"{rep.installs}")
        check(installs[-1].get("grew_from") == parent.version,
              f"grow: the grown install event names {installs[-1].get('grew_from')}")

        # the replica serves the grown basis through the serve kernel
        rng = np.random.default_rng(5)
        queries = [spec.sample(rng, 64) for _ in range(GROW_QUERIES)]
        v32 = torch.as_tensor(grown_host, device=dev)
        direct = [torch.matmul(torch.as_tensor(q, device=dev), v32).cpu() for q in queries]
        launched = {}
        for serve_dtype, route, counter in (("bfloat16", "bf16", "launches"),
                                            ("int8", "i8", "launches_i8")):
            scfg = dataclasses.replace(cfg, k=GROW_K, serve_dtype=serve_dtype)
            with QueryServer(rep, scfg) as srv:
                eng = srv.engine
                dispatches = [0]
                project = eng.project

                def counted(x, v, project=project, dispatches=dispatches):
                    dispatches[0] += 1
                    return project(x, v)

                eng.project = counted
                setattr(sp, counter, 0)
                t0 = time.perf_counter()
                tickets = [srv.submit(q) for q in queries]
                served = [t.result(timeout=300) for t in tickets]
                burst_s = time.perf_counter() - t0
                launched[route] = getattr(sp, counter)
            angles = torch.cat([row_angles_deg(r.z, ref) for r, ref in zip(served, direct)])
            versions = sorted({r.version for r in served})
            emit("slice_grow", part="serve", serve_dtype=serve_dtype, k=GROW_K,
                 queries=len(served), rows=64 * len(served), versions=versions,
                 launches=launched[route], project_dispatches=dispatches[0],
                 max_angle_deg=float(angles.max()), burst_s=burst_s, card=card)
            check(versions == [grown.version], f"grow {serve_dtype}: served {versions}")
            check(launched[route] == dispatches[0] and launched[route] > 0,
                  f"grow {serve_dtype}: {launched[route]} launches for {dispatches[0]} "
                  "dispatches")
            check(float(angles.max()) <= 0.2,
                  f"grow {serve_dtype}: served row at {float(angles.max())} deg > 0.2")
    finally:
        if rep is not None:
            rep.close()
        lease.release()
    return {"est": est, "s8": s8_calls, "serve": launched}


def slice_drift(dev, card: str, est, spec) -> dict:
    """The serve -> drift -> refit -> swap loop at the cifar10 settings: the
    fit's basis served with a DriftMonitor attached, in-distribution traffic,
    then the seed-1 model's rows until the monitor refits and publishes, and
    the server's next batches carry the new version. The refit runs under
    ``supervised_fit`` (the monitor's default, ``supervise=True``) on the
    per-step loop, which feeds its blocks as they come: one cold round, one
    bf16 TMA Gram launch, no s8 call. The monitor reports to a
    ``MetricsLogger``: its drift event and the refit's steps land there.
    Then the unsupervised refit (``supervise=False``: the estimator, whose
    int8 stage makes one s8 call) on the same buffered rows, through a
    second monitor's ``refresh_now``."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from distributed_eigenspaces_tpu_torch.serving import (
        DriftMonitor,
        EigenbasisRegistry,
        QueryServer,
    )
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    cfg = dett.PCAConfig(**EVAL_FIT)
    shifted = dett.planted_subspace(EVAL_FIT["dim"], **DRIFT_SHIFT)
    reg = EigenbasisRegistry(keep=4)
    v1 = reg.publish_fit(est)
    published_at = []
    publish = reg.publish

    def stamped(*a, **kw):
        out = publish(*a, **kw)
        published_at.append(time.perf_counter())
        return out

    reg.publish = stamped
    logger = MetricsLogger()
    mon = DriftMonitor(reg, cfg, supervise=True, buffer_rows=DRIFT_BUFFER_ROWS, auto=True,
                       ema_alpha=DRIFT_EMA_ALPHA, metrics=logger, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)

    def query(model):  # rows drawn on the card, submitted as host numpy
        return model.sample(gen, DRIFT_QUERY_ROWS).cpu().numpy()

    before_ratio, after_ratio = [], []
    fed = []  # the shifted queries with their served energies
    requests = 0
    sp.launches_f32 = 0
    zero_counts()
    with QueryServer(reg, cfg, drift=mon) as srv:
        t0 = time.perf_counter()
        for _ in range(64):  # the fit's own data
            r = srv.submit(query(spec)).result(timeout=300)
            requests += 1
            check(r.version == v1.version, "drift: a version moved on in-distribution rows")
        in_dist_drift = mon.residual_drift()
        shifted_queries = 0
        while not (mon.refreshes or mon.refreshing()):
            check(shifted_queries < DRIFT_MAX_SHIFTED,
                  f"drift: no refresh after {shifted_queries} shifted queries "
                  f"(drift {mon.residual_drift()})")
            q = query(shifted)
            r = srv.submit(q).result(timeout=300)
            requests += 1
            before_ratio.append(float(r.residual_sq.sum() / r.input_sq.sum()))
            fed.append((q, float(r.residual_sq.sum()), float(r.input_sq.sum())))
            shifted_queries += 1
        buffered = mon.buffered_rows()
        mon.join_refresh(timeout=300)
        check(not mon.refreshing(), "drift: the refresh did not finish in 300 s")
        refit = read_counts()
        v2 = reg.latest()
        served_new = None
        for _ in range(8):
            r = srv.submit(query(shifted)).result(timeout=300)
            requests += 1
            if served_new is None and r.version == v2.version:
                served_new = time.perf_counter()
            after_ratio.append(float(r.residual_sq.sum() / r.input_sq.sum()))
        loop_s = time.perf_counter() - t0
    f32_launches = sp.launches_f32
    # the unsupervised refit on the rows the supervised one buffered: a
    # second monitor fed the same shifted queries, refreshed inline
    reg_u = EigenbasisRegistry(keep=4)
    reg_u.publish_fit(est)
    mon_u = DriftMonitor(reg_u, cfg, supervise=False, buffer_rows=DRIFT_BUFFER_ROWS,
                         auto=False, ema_alpha=DRIFT_EMA_ALPHA, device=dev)
    for q, res_sq, in_sq in fed:
        mon_u.observe(res_sq, in_sq, rows=q)
    check(mon_u.buffered_rows() == buffered,
          f"drift: the unsupervised monitor buffered {mon_u.buffered_rows()} rows, "
          f"the supervised one {buffered}")
    zero_counts()
    v2_u = mon_u.refresh_now()
    refit_u = read_counts()
    fresh_u = basis_angle(v2_u.v, shifted) if v2_u is not None else None
    stale = basis_angle(v1.v, shifted)
    fresh = basis_angle(v2.v, shifted)
    swap_ms = (served_new - published_at[0]) * 1e3 if served_new and published_at else None
    summary = logger.summary()
    drift_events = [r for r in logger.serve_records if r["serve"] == "drift"]
    emit("slice_drift",
         config="cifar10 eval settings, DriftMonitor(supervise=True, "
                f"buffer_rows={DRIFT_BUFFER_ROWS}, auto=True, ema_alpha={DRIFT_EMA_ALPHA}, "
                "metrics=MetricsLogger())",
         traffic=f"64 x {DRIFT_QUERY_ROWS} rows of planted_subspace(3072, seed=0), then "
                 f"{shifted_queries} x {DRIFT_QUERY_ROWS} of planted_subspace(3072, seed=1)",
         in_distribution_drift=in_dist_drift, shifted_queries=shifted_queries,
         buffered_rows_at_arm=buffered, refreshes=mon.refreshes,
         published=[v.version for v in (v1, v2)], last_score=mon.last_score,
         refit_s=mon.last_refit_s, refit_gram_calls=refit, swap_ms=swap_ms,
         unsupervised_refit=dict(refit_s=mon_u.last_refit_s, gram_calls=refit_u,
                                 published=v2_u.version if v2_u is not None else None,
                                 refreshed_vs_shift_deg=fresh_u,
                                 lineage=v2_u.lineage if v2_u is not None else None),
         logger=dict(steps=summary["steps"],
                     drift_refreshes=summary["serving"].get("drift_refreshes"),
                     drift_published=summary["serving"].get("drift_published"),
                     drift_score=summary["serving"].get("drift_score"),
                     faults=summary.get("faults", {}).get("by_kind")),
         stale_vs_shift_deg=stale, refreshed_vs_shift_deg=fresh,
         residual_ratio_before=float(np.median(before_ratio[-8:])),
         residual_ratio_after=float(np.median(after_ratio)), serve_f32_launches=f32_launches,
         requests=requests, failed_requests=0, loop_s=loop_s, lineage=v2.lineage,
         card=card)
    check(mon.refreshes == 1 and v2.version == v1.version + 1 and len(published_at) == 1,
          f"drift: {mon.refreshes} refreshes, {len(published_at)} publishes, want one")
    check(buffered == DRIFT_BUFFER_ROWS and shifted_queries >= DRIFT_BUFFER_ROWS // DRIFT_QUERY_ROWS,
          "drift: the refit's ring still held in-distribution rows")
    check(fresh <= 1.0, f"drift: the refreshed basis is {fresh} deg from the shifted truth")
    check(served_new is not None, "drift: the server never served the new version")
    check(max(after_ratio) < min(before_ratio[-8:]),
          "drift: the residual ratio did not fall after the swap")
    check((refit["gram"], refit["tma"], refit["s8"]) == (1, 1, 0),
          f"drift: the supervised refit's Gram launches {refit}, want its one cold round "
          "on the bf16 TMA kernel")
    check(v2.lineage.get("supervised") is True, f"drift: lineage {v2.lineage}")
    check(len(drift_events) == 1 and drift_events[0].get("published") == v2.version,
          f"drift: the logger holds {len(drift_events)} drift events")
    check(summary["steps"] == DRIFT_BUFFER_ROWS // (cfg.num_workers * cfg.rows_per_worker),
          f"drift: the logger saw {summary['steps']} refit steps")
    check(f32_launches > 0, "drift: the fp32 serve kernel never launched")
    check(v2_u is not None and mon_u.refreshes == 1,
          f"drift: the unsupervised refresh published {v2_u}")
    check(v2_u.lineage.get("supervised") is False, f"drift: lineage {v2_u.lineage}")
    check(fresh_u <= 1.0,
          f"drift: the unsupervised refit is {fresh_u} deg from the shifted truth")
    check(refit_u["s8"] == 1, f"drift: the unsupervised refit made {refit_u['s8']} s8 "
          "calls, want 1")
    return {"tma": refit["tma"], "s8": refit_u["s8"], "serve_f32": f32_launches}


def mnist_data(dev):
    """mnist784's planted data on ``dev``: ``(spec, data (T m n, 784))``, the
    same bits in every process on the same card."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett

    m, n, T = (MNIST_FIT[f] for f in ("num_workers", "rows_per_worker", "num_steps"))
    spec = dett.planted_subspace(MNIST_FIT["dim"], **MNIST_DATA)
    return spec, spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)


def zero_counts() -> None:
    """Every launch counter of the Gram kernels and the mesh's gather counts
    to 0, just before a path is driven."""
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    gram_mod.launches = gram_mod.launches_tma = gram_mod.launches_s8 = 0
    pmesh.gathers = pmesh.gather_bytes = 0


def read_counts() -> dict:
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    return {"gram": gram_mod.launches, "tma": gram_mod.launches_tma,
            "s8": gram_mod.launches_s8, "gathers": pmesh.gathers,
            "gather_bytes": pmesh.gather_bytes}


def slice_mesh_eval(dev, card: str, work_dir: str) -> dict:
    """The mnist784 eval field for field (``backend="shard_map"``) on one
    rank: through the estimator in one process (no process group, so its
    scan mesh is None, as the reference's with one device), then the same T
    steps through ``make_train_step(cfg, mesh=make_mesh(1))`` on a one-rank
    NCCL group, against the same step loop without a mesh (bit-equal: the
    gather of one rank is a copy). Both within 1 degree of the planted
    top-20. Also the bf16 variant's local fit and the exact merge of the
    last step's factors, both over the whole block in this one process, for
    the two-rank phase to be held against."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.api.estimator import _scan_mesh
    from distributed_eigenspaces_tpu_torch.api.runner import extract_dense
    from distributed_eigenspaces_tpu_torch.ops.linalg import initial_basis, merged_top_k_lowrank
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
    from distributed_eigenspaces_tpu_torch.parallel.worker_pool import _local_eigenspaces

    spec, data = mnist_data(dev)
    k, T = MNIST_FIT["k"], MNIST_FIT["num_steps"]
    cfg = dett.PCAConfig(**MNIST_FIT)
    check(_scan_mesh(cfg, dev) is None, "mesh_eval: a scan mesh without a process group")
    local = {}
    for name, fit_kw in MNIST_VARIANTS:
        vcfg = dett.PCAConfig(**fit_kw)
        est = dett.OnlineDistributedPCA(vcfg)
        zero_counts()
        _, fit_s = synced_s(lambda: est.fit(data))
        counts = read_counts()
        _, fit2_s = synced_s(lambda: dett.OnlineDistributedPCA(vcfg).fit(data))
        local[name] = dict(est=est, counts=counts, fit_s=fit_s, second_fit_s=fit2_s,
                           angle=components_angle(est, spec))
    est = local["int8"]["est"]
    blocks = list(est._blocks(data, torch.int8))
    check(len(blocks) == T, f"mesh_eval: {len(blocks)} staged blocks, want {T}")
    # the last step's factors over all m workers, merged exactly: what the
    # two ranks' dist_merged_top_k is held against, made with no collective
    vs_all = _local_eigenspaces(blocks[-1], k, "subspace", MNIST_FIT["subspace_iters"],
                                "cholqr2", MNIST_FIT["compute_dtype"],
                                v0=initial_basis(MNIST_FIT["dim"], k, device=dev))
    exact_merge = merged_top_k_lowrank(vs_all, k).cpu().numpy()

    def step_loop(step):
        st, vp = dett.OnlineState.initial(cfg.dim, device=dev), None
        for x in blocks:
            st, vp = step(st, x, v_prev=vp)
        return st

    plain = step_loop(dett.make_train_step(cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pmesh.initialize("nccl", rank=0, world_size=1,
                     init_method=f"file://{os.path.join(work_dir, 'nccl_rendezvous')}",
                     timeout=300, device=dev)
    try:
        mesh = pmesh.make_mesh(1, device=dev)
        with pmesh.mesh_scope(mesh):  # NCCL's communicator comes up on first use
            pmesh.all_gather(torch.zeros(1, device=dev), pmesh.WORKER_AXIS)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step = dett.make_train_step(cfg, mesh=mesh)
        zero_counts()
        st, mesh_s = synced_s(lambda: step_loop(step))
        counts = read_counts()
        backend = torch.distributed.get_backend()
    finally:
        pmesh.shutdown()
    equal = bool(torch.equal(st.sigma_tilde, plain.sigma_tilde))
    sigma_rel = rel_err(st.sigma_tilde, est.state.sigma_tilde)
    w = extract_dense(cfg, st.sigma_tilde, v0=est.v0)
    mesh_angle = basis_angle(w, spec)
    m, d = MNIST_FIT["num_workers"], MNIST_FIT["dim"]
    emit("slice_mesh_eval",
         config="mnist784 eval (evals.py:96-102): d=784 k=20 m=8 n=1024 T=20 subspace 16 "
                "cold / 2 warm bf16, stage int8, warm ns, backend shard_map",
         data=f"planted_subspace({MNIST_FIT['dim']}, "
              + ", ".join(f"{a}={v}" for a, v in MNIST_DATA.items()) + ")",
         trainer=est.trainer_used_, scan_mesh=None,
         fit_s=local["int8"]["fit_s"], second_fit_s=local["int8"]["second_fit_s"],
         samples_per_s=T * m * MNIST_FIT["rows_per_worker"] / local["int8"]["second_fit_s"],
         s8_calls=local["int8"]["counts"]["s8"], max_angle_deg=local["int8"]["angle"],
         bf16_variant=dict(fit_s=local["bf16"]["fit_s"],
                           second_fit_s=local["bf16"]["second_fit_s"],
                           tma_launches=local["bf16"]["counts"]["tma"],
                           s8_calls=local["bf16"]["counts"]["s8"],
                           max_angle_deg=local["bf16"]["angle"]),
         mesh=dict(backend=backend, shape=mesh.shape, nccl_init_s=init_s,
                   step_loop_s=mesh_s, s8_calls=counts["s8"], gathers=counts["gathers"],
                   gather_bytes=counts["gather_bytes"],
                   gather_bytes_each=counts["gather_bytes"] / max(counts["gathers"], 1),
                   sigma_bit_equal_to_plain_steps=equal,
                   sigma_rel_to_estimator=sigma_rel, max_angle_deg=mesh_angle),
         card=card)
    check(local["int8"]["counts"]["s8"] == 1 and local["int8"]["counts"]["gram"] == 0,
          f"mesh_eval: the local fit's Gram launches {local['int8']['counts']}")
    check(local["bf16"]["counts"]["tma"] == 1 and local["bf16"]["counts"]["s8"] == 0,
          f"mesh_eval: the bf16 fit's Gram launches {local['bf16']['counts']}")
    check(max(local[n]["angle"] for n in local) <= 1.0, "mesh_eval: a local fit > 1 degree")
    check(backend == "nccl" and mesh.shape == {"workers": 1, "features": 1},
          f"mesh_eval: mesh {mesh.shape} on {backend}")
    check(counts["s8"] == 1 and counts["gathers"] == T
          and counts["gather_bytes"] == T * m * d * k * 4,
          f"mesh_eval: one-rank mesh counts {counts}")
    check(equal, "mesh_eval: the one-rank mesh's sigma_tilde is not the plain steps' bits")
    check(sigma_rel <= MESH_SIGMA_REL, f"mesh_eval: mesh vs estimator sigma {sigma_rel}")
    check(mesh_angle <= 1.0, f"mesh_eval: mesh fit {mesh_angle} > 1 degree")
    return {"s8": {"mesh eval (estimator, one process)": local["int8"]["counts"]["s8"],
                   "mesh eval (one-rank NCCL mesh)": counts["s8"]},
            "bf16": {"mesh eval bf16 (estimator, one process)": local["bf16"]["counts"]["tma"]},
            "local": {n: (v["est"].components_.cpu().numpy(),
                          v["est"].state.sigma_tilde.cpu().numpy()) for n, v in local.items()},
            "exact_merge": exact_merge}


def mesh_rank_phase(rank: int, world: int, local: dict, exact_merge) -> dict:
    """One rank of ``slice_mesh_ranks2`` (both ranks on ``cuda:0``, over
    gloo): the mnist784 eval and its bf16 variant through the estimator's
    scan on a (2, 1) mesh, ``dist_merged_top_k`` over the last step's
    factors against the exact merge (``exact_merge``, made by the parent
    over the whole block), and the deflation lanes on a (2, 1)
    components mesh over bench.py --deflate's operand against the dense
    eigh. Fails (and so fails the script) on any gate."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.api.estimator import _scan_mesh
    from distributed_eigenspaces_tpu_torch.ops.linalg import (
        initial_basis,
        principal_angles_degrees,
    )
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
    from distributed_eigenspaces_tpu_torch.parallel.worker_pool import _local_eigenspaces
    from distributed_eigenspaces_tpu_torch.solvers import deflation as sdefl
    from distributed_eigenspaces_tpu_torch.solvers import distributed as sd

    dev = torch.device(MESH_DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    spec, data = mnist_data(dev)
    k = MNIST_FIT["k"]
    out = {"backend": torch.distributed.get_backend(), "device": str(dev)}
    for name, fit_kw in MNIST_VARIANTS:
        cfg = dett.PCAConfig(**fit_kw)
        mesh = _scan_mesh(cfg, dev)
        est = dett.OnlineDistributedPCA(cfg, device=dev)
        est.fit(data)  # warm-up: the libraries' first calls
        est = dett.OnlineDistributedPCA(cfg, device=dev)
        zero_counts()
        _, fit_s = synced_s(lambda: est.fit(data))
        counts = read_counts()
        comps, sigma = local[name]
        w = est.components_
        sig = est.state.sigma_tilde
        out[name] = dict(
            mesh=mesh.shape, trainer=est.trainer_used_, fit_s=fit_s, counts=counts,
            angle_to_one_device=float(principal_angles_degrees(
                w.cpu(), torch.from_numpy(comps)).max()),
            sigma_rel_to_one_device=float(np.linalg.norm(sig.cpu().numpy() - sigma)
                                          / np.linalg.norm(sigma)),
            angle_to_truth=basis_angle(w, spec), sigma=sig.cpu().numpy())
        check(out[name]["angle_to_one_device"] <= MESH_FIT_DEG
              and out[name]["sigma_rel_to_one_device"] <= MESH_SIGMA_REL,
              f"mesh_ranks2 {name} rank {rank}: {out[name]['angle_to_one_device']} deg, "
              f"sigma {out[name]['sigma_rel_to_one_device']} from the one-device fit")
        check(out[name]["angle_to_truth"] <= 1.0, f"mesh_ranks2 {name}: > 1 degree")
    # the merge over the last step's factors
    cfg = dett.PCAConfig(**MNIST_FIT)
    mesh = _scan_mesh(cfg, dev)
    est = dett.OnlineDistributedPCA(cfg, device=dev)
    x_last = list(est._blocks(data, torch.int8, mesh))[-1]
    vs = _local_eigenspaces(x_last, k, "subspace", MNIST_FIT["subspace_iters"], "cholqr2",
                            MNIST_FIT["compute_dtype"],
                            v0=initial_basis(MNIST_FIT["dim"], k, device=dev))
    with pmesh.mesh_scope(mesh):
        (merged, merge_s) = synced_s(lambda: sd.dist_merged_top_k(vs, k, iters=16))
    exact = torch.from_numpy(exact_merge)
    out["merge"] = dict(angle=float(principal_angles_degrees(merged.cpu(), exact).max()),
                        s=merge_s, mesh=mesh.shape)
    check(out["merge"]["angle"] <= MESH_MERGE_DEG,
          f"mesh_ranks2 merge: {out['merge']['angle']} deg from the exact merge")
    # the deflation lanes, one a rank
    od, ok_, r = (DEFLATE_OPERAND[f] for f in ("d", "k", "r"))
    rng = np.random.default_rng(0)
    u = np.linalg.qr(rng.standard_normal((od, r)))[0].astype(np.float32)
    s = (8.0 * 0.5 ** np.arange(r)).astype(np.float32)
    c = torch.as_tensor(u * np.sqrt(s)[None, :], device=dev)
    eigh_v = torch.linalg.eigh(c @ c.T)[1][:, -ok_:].flip(-1)
    cm = pmesh.make_component_mesh(MESH_LANES, 1, device=dev)
    with pmesh.mesh_scope(cm):
        mv = sd.factor_matvec(c, pmesh.FEATURE_AXIS)
        (v, info), lanes_s = synced_s(lambda: sdefl.dist_deflation_eig(
            mv, od, ok_, lanes=MESH_LANES, iters=64, tol=1e-5, device=dev,
            with_info=True))
        staircase = pmesh.all_gather(torch.tensor([float(info["iters_used"])]),
                                     pmesh.COMPONENT_AXIS).tolist()
    out["lanes"] = dict(angles=lane_angles_deg(v, eigh_v, MESH_LANES), iters_used=staircase,
                        s=lanes_s, mesh=cm.shape)
    check(max(out["lanes"]["angles"]) <= MESH_LANE_DEG,
          f"mesh_ranks2 lanes: {out['lanes']['angles']} deg from the eigh")
    return out


def slice_mesh_ranks2(dev, card: str, mesh_eval: dict, work_dir: str) -> dict:
    """Two ranks sharing the one card in one gloo group (NCCL refuses two
    ranks on one device), started by ``parallel.mesh.launch``: each rank runs
    ``mesh_rank_phase``; rank 0's numbers are printed, every rank's state must
    equal rank 0's bit for bit, and a failing rank fails the script."""
    import numpy as np
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    (out, ranks_s) = synced_s(lambda: pmesh.launch(
        mesh_rank_phase, MESH_RANKS, mesh_eval["local"], mesh_eval["exact_merge"],
        backend="gloo",
        timeout=MESH_TIMEOUT_S, workdir=work_dir))
    r0 = out[0]
    same = {name: all(np.array_equal(o[name]["sigma"], r0[name]["sigma"]) for o in out)
            for name, _ in MNIST_VARIANTS}
    emit("slice_mesh_ranks2", ranks=MESH_RANKS, backend=r0["backend"], device=r0["device"],
         launch_s=ranks_s,
         fits={name: {f: v for f, v in r0[name].items() if f != "sigma"}
               for name, _ in MNIST_VARIANTS},
         every_rank_bit_equal=same, merge=r0["merge"], lanes=r0["lanes"],
         s8_calls_by_rank=[o["int8"]["counts"]["s8"] for o in out],
         tma_launches_by_rank=[o["bf16"]["counts"]["tma"] for o in out],
         card=card)
    check(all(o["backend"] == "gloo" for o in out), "mesh_ranks2: not a gloo group")
    check(all(same.values()), f"mesh_ranks2: rank states differ from rank 0's: {same}")
    for o in out:
        check(o["int8"]["mesh"] == {"workers": MESH_RANKS, "features": 1},
              f"mesh_ranks2: mesh {o['int8']['mesh']}")
        check(o["int8"]["counts"]["s8"] == 1 and o["int8"]["counts"]["gram"] == 0,
              f"mesh_ranks2 int8: Gram launches {o['int8']['counts']}")
        check(o["bf16"]["counts"]["tma"] == 1 and o["bf16"]["counts"]["s8"] == 0,
              f"mesh_ranks2 bf16: Gram launches {o['bf16']['counts']}")
        check(o["int8"]["counts"]["gathers"] == MNIST_FIT["num_steps"],
              f"mesh_ranks2: {o['int8']['counts']['gathers']} gathers")
    return {"s8": sum(o["int8"]["counts"]["s8"] for o in out),
            "bf16": sum(o["bf16"]["counts"]["tma"] for o in out)}


def fleet_problems(dev, seeds) -> list:
    """Per seed b, ``(spec, (T, m, n, d) host float32)``: a tenant of the
    fleet phases on its own ``planted_subspace(784, seed=b)`` of mnist784's
    data settings, drawn on ``dev`` from a generator seeded b."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett

    m, n, d, T = (MNIST_FIT[f] for f in ("num_workers", "rows_per_worker", "dim",
                                         "num_steps"))
    out = []
    for b in seeds:
        spec = dett.planted_subspace(d, **dict(MNIST_DATA, seed=b))
        x = spec.sample(torch.Generator(device=dev).manual_seed(b), T * m * n)
        out.append((spec, x.reshape(T, m, n, d).cpu().numpy()))
        del x
    return out


def profiled_launches(fn) -> dict:
    """What one call of ``fn`` runs on the card, from ``torch.profiler``:
    its kernel events (copies, memsets and the ``det_*`` regions apart; the
    window opens with ``profiler_warm``'s 8 kernels, counted in every
    window alike) and the runtime's launch calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_warm("cuda")
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "det_"))]
    runtime = sum(1 for e in events if e.name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
    return {"kernels": len(kernels), "runtime_launch_calls": runtime,
            "copies": sum(1 for e in events if e.device_type == DeviceType.CUDA
                          and e.name.startswith("Memcpy"))}


def slice_fleet_eval(dev, card: str) -> dict:
    """The multi-tenant fleet on the card: 8 tenants, each the mnist784 eval
    field for field on its own planted data, through ``fit_fleet`` (fp32
    staging, one copy of the stack). Each tenant within 1 degree of its
    planted top-20 and 0.2 degrees of the port's solo scan fit on the same
    blocks and start; one Gram launch (the bf16 TMA kernel at (64, 1024,
    784)) for the whole fit; the fleet program's kernels at most 1.5 times
    one solo fit's. Fits/s of the fleet program and of the 8 solo fits one
    after another, both on stacks already on the card (bench.py --fleet's
    A/B), and of ``fit_fleet`` from host arrays. Then the Gram kernel at the
    fleet's shape against its plain version, timed beside ``torch.bmm``.
    Both sides solve every eigenproblem from 33 to 256 wide by the batched
    cuSOLVER call (``ops.cusolver.eigh``), so the A/B measures the
    batching; the same programs are then run and timed with torch's
    per-matrix ``eigh`` to measure the eigensolver's share apart."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.api.runner import extract_dense
    from distributed_eigenspaces_tpu_torch.ops import cusolver
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops.linalg import (
        initial_basis,
        principal_angles_degrees,
    )
    from distributed_eigenspaces_tpu_torch.parallel import fleet

    cfg = dett.PCAConfig(**FLEET_FIT)
    d, k, m, n, T = fleet.fleet_signature(cfg)
    tenants, data_s = synced_s(lambda: fleet_problems(dev, range(FLEET_B)))
    probs = [p for _, p in tenants]
    cache: dict = {}
    zero_counts()
    res, first_s = synced_s(lambda: fleet.fit_fleet(cfg, probs, mesh=None, fit_cache=cache))
    counts = read_counts()
    # the fleet program and the solo scan, on the stack already on the card
    batch = res.batch
    xs = torch.from_numpy(batch.xs).to(dev)
    fit, extract, _ = fleet.acquire_fleet_programs(cfg, None, masked=False, b_pad=FLEET_B,
                                                   fit_cache=cache, device=dev)
    v_cold = initial_basis(d, k, seed=cfg.seed, device=dev)
    solo = dett.make_scan_fit(cfg, device=dev, v0=v_cold)

    def fleet_program():
        st, _ = fit(fleet.init_fleet_states(cfg, FLEET_B, device=dev), xs, batch.actives)
        return st, extract(st.sigma_tilde)

    def solo_fit(b):
        st, _ = solo(dett.OnlineState.initial(d, device=dev), xs[b])
        return st, extract_dense(cfg, st.sigma_tilde, v0=v_cold)

    def sequential():
        return [solo_fit(b) for b in range(FLEET_B)]

    fleet_program()
    seq = sequential()
    zero_counts()
    (st_f, w_f), _ = synced_s(fleet_program)
    program_counts = read_counts()
    times = {"fit_fleet": [], "fleet_program": [], "sequential": []}
    for _ in range(FLEET_REPS):
        times["fit_fleet"].append(synced_s(
            lambda: fleet.fit_fleet(cfg, probs, mesh=None, fit_cache=cache))[1])
        times["fleet_program"].append(synced_s(fleet_program)[1])
        times["sequential"].append(synced_s(sequential)[1])
    med = {key: statistics.median(v) for key, v in times.items()}
    fleet_launch = profiled_launches(fleet_program)
    solo_launch = profiled_launches(lambda: solo_fit(0))
    _, fleet_syncs = counted_syncs(fleet_program)
    _, solo_syncs = counted_syncs(lambda: solo_fit(0))
    # the eigensolver's share: the same programs with torch's eigh, which
    # loops one syevj a matrix above 32 wide, in place of the batched call
    saved_eigh = cusolver.eigh
    cusolver.eigh = torch.linalg.eigh
    try:
        (_, w_te), _ = synced_s(fleet_program)
        seq_te = sequential()
        te_times = {"fleet_program": [], "sequential": []}
        for _ in range(FLEET_REPS):
            te_times["fleet_program"].append(synced_s(fleet_program)[1])
            te_times["sequential"].append(synced_s(sequential)[1])
    finally:
        cusolver.eigh = saved_eigh
    te_med = {key: statistics.median(v) for key, v in te_times.items()}
    torch_eigh = dict(
        times=te_times, fleet_program_s=te_med["fleet_program"],
        sequential_s=te_med["sequential"],
        fleet_deg=[float(principal_angles_degrees(w_f[b].cpu(), w_te[b].cpu()).max())
                   for b in range(FLEET_B)],
        solo_deg=[float(principal_angles_degrees(seq[b][1].cpu(), seq_te[b][1].cpu()).max())
                  for b in range(FLEET_B)],
        tenant_to_solo_deg=[float(principal_angles_degrees(w_te[b].cpu(),
                                                           seq_te[b][1].cpu()).max())
                            for b in range(FLEET_B)])
    del xs, seq_te
    truth_deg, solo_deg, sigma_rel, program_deg = [], [], [], []
    for b, (spec, _) in enumerate(tenants):
        w = torch.from_numpy(res.components[b])
        truth_deg.append(basis_angle(w, spec))
        solo_deg.append(float(principal_angles_degrees(w, seq[b][1].cpu()).max()))
        sigma_rel.append(rel_err(res.states.sigma_tilde[b], seq[b][0].sigma_tilde))
        program_deg.append(float(principal_angles_degrees(w, w_f[b].cpu()).max()))
    del seq
    # the Gram kernel at the fleet's cold-step shape
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(FLEET_GRAM, generator=gen, device=dev).to(torch.bfloat16)
    got, want = gram_mod.gram_cuda(x), gram_mod.gram_plain(x)
    rel = rel_err(got, want)
    gram = dict(ms=time_ms(lambda: gram_mod.gram_cuda(x)),
                device_ms=device_ms(lambda: gram_mod.gram_cuda(x)),
                plain_ms=time_ms(lambda: gram_mod.gram_plain(x)),
                bmm_ms=time_ms(lambda: torch.bmm(x.mT, x)),
                kernel=gram_mod.gram_launch(*FLEET_GRAM, torch.bfloat16).kernel)
    gram["bound_ms"], gram["bound_by"] = gram_bound(FLEET_GRAM, "bfloat16")
    probe = bf16_out_fp32(torch.bmm, x.mT, x)
    if isinstance(probe, str):
        gram.update(library_ms=None, library_device_ms=None, library_note=probe)
    else:
        yard = lambda: bf16_out_fp32(torch.bmm, x.mT, x)  # noqa: E731
        gram.update(library_ms=time_ms(yard), library_device_ms=device_ms(yard, launches=None),
                    library="torch.bmm(x.mT, x, out_dtype=torch.float32)")
    max_abs = float((got - want).abs().max().item())
    del x, got, want, probe
    samples = FLEET_B * T * m * n
    emit("slice_fleet_eval",
         config=f"{FLEET_B} tenants, each the mnist784 eval (evals.py:96-102) field for "
                "field: d=784 k=20 m=8 n=1024 T=20 subspace 16 cold / 2 warm bf16, warm "
                "ns; backend local, fp32 staging (the reference fleet's own)",
         data="per tenant b: planted_subspace(784, "
              + ", ".join(f"{a}={v}" for a, v in MNIST_DATA.items() if a != "seed")
              + ", seed=b)",
         data_s=data_s, gram_calls=counts, program_gram_calls=program_counts,
         first_fit_fleet_s=first_s, first_compile_ms=res.compile_ms,
         fit_fleet_s=med["fit_fleet"], fleet_program_s=med["fleet_program"],
         sequential_s=med["sequential"], times=times,
         fleet_fits_per_s=FLEET_B / med["fleet_program"],
         sequential_fits_per_s=FLEET_B / med["sequential"],
         fit_fleet_fits_per_s=FLEET_B / med["fit_fleet"],
         fleet_speedup=med["sequential"] / med["fleet_program"],
         fleet_samples_per_s=samples / med["fleet_program"],
         launches=dict(fleet_program=fleet_launch, solo_fit=solo_launch,
                       ratio=fleet_launch["kernels"] / solo_launch["kernels"]),
         syncs=dict(fleet_program=fleet_syncs, solo_fit=solo_syncs),
         torch_eigh=torch_eigh,
         angle_to_truth_deg=truth_deg, angle_to_solo_deg=solo_deg,
         sigma_rel_to_solo=sigma_rel, fit_fleet_vs_program_deg=program_deg,
         gram=dict(gram, shape=list(FLEET_GRAM), rel_frobenius=rel, max_abs_err=max_abs,
                   tol=TOL["bfloat16"]),
         card=card)
    check(counts["gram"] == 1 and counts["tma"] == 1 and counts["s8"] == 0,
          f"fleet_eval: Gram launches {counts}, want one bf16 TMA launch for the fleet")
    check(program_counts["tma"] == 1, f"fleet_eval: the program's Gram {program_counts}")
    check(max(truth_deg) <= 1.0, f"fleet_eval: a tenant {max(truth_deg)} deg from its truth")
    check(max(solo_deg) <= FLEET_SOLO_DEG, f"fleet_eval: {max(solo_deg)} deg from solo")
    check(fleet_launch["kernels"] <= FLEET_LAUNCH_RATIO * solo_launch["kernels"],
          f"fleet_eval: {fleet_launch['kernels']} kernels for the fleet against "
          f"{solo_launch['kernels']} for one solo fit")
    check(rel <= TOL["bfloat16"], f"fleet_eval: Gram at {FLEET_GRAM} {rel} > 1e-4")
    check(bool(np.isfinite(res.components).all()), "fleet_eval: components not finite")
    sup_tma = fleet_supervised(dev, card, cfg, tenants, cache)
    return {"tma": counts["tma"] + sup_tma, "result": res, "tenants": tenants,
            "gram": dict(gram, max_abs_err=max_abs)}


def fleet_supervised(dev, card: str, cfg, tenants, cache) -> int:
    """``fit_fleet(supervisor=)`` on the same 8 tenants with one NaN worker
    block in tenant 3: the screen quarantines that worker of that tenant for
    that step (ledgered with its tenant index), the 7 other tenants equal
    the same fleet fit without a supervisor bit for bit (both on the masked
    fleet program, the unsupervised one given all-live masks), and tenant 3
    stays within 1 degree of its truth. Returns its Gram launches."""
    import numpy as np
    import torch
    from distributed_eigenspaces_tpu_torch.parallel import fleet
    from distributed_eigenspaces_tpu_torch.runtime.supervisor import Supervisor
    from distributed_eigenspaces_tpu_torch.utils.faults import ChaosPlan, ChaosStream

    bad = FLEET_BAD["tenant"]
    probs = [p for _, p in tenants]
    chaotic = list(probs)
    chaotic[bad] = ChaosStream(iter(probs[bad]), ChaosPlan(
        nan_blocks={FLEET_BAD["step"]: [FLEET_BAD["worker"]]}))
    sup = Supervisor(cfg)
    zero_counts()
    got, sup_s = synced_s(lambda: fleet.fit_fleet(cfg, chaotic, mesh=None, supervisor=sup,
                                                  fit_cache=cache))
    counts = read_counts()
    live = [np.ones((cfg.num_steps, cfg.num_workers), np.float32)] * len(probs)
    want, _ = synced_s(lambda: fleet.fit_fleet(cfg, probs, mesh=None, worker_masks=live,
                                               fit_cache=cache))
    others = [b for b in range(len(probs)) if b != bad]
    equal = all(np.array_equal(got.components[b], want.components[b])
                and torch.equal(got.states.sigma_tilde[b], want.states.sigma_tilde[b])
                for b in others)
    bad_deg = basis_angle(torch.from_numpy(got.components[bad]), tenants[bad][0])
    events = [dict(e) for e in sup.ledger.events]
    emit("slice_fleet_eval", part="supervised",
         corruption=f"NaN rows: tenant {bad}, step {FLEET_BAD['step']}, worker "
                    f"{FLEET_BAD['worker']}",
         ledger=events, others_bit_equal=equal, bad_tenant_vs_truth_deg=bad_deg,
         fit_fleet_s=sup_s, gram_calls=counts, card=card)
    check(equal, "fleet supervised: a healthy tenant differs from the unsupervised fleet")
    check([(e["kind"], e["tenant"], e["step"], e["workers"]) for e in events]
          == [("quarantine_nonfinite", bad, FLEET_BAD["step"], [FLEET_BAD["worker"]])],
          f"fleet supervised: ledger {events}")
    check(bad_deg <= 1.0, f"fleet supervised: tenant {bad} {bad_deg} deg from its truth")
    check(bool(np.isfinite(got.components).all()), "fleet supervised: not finite")
    check((counts["gram"], counts["tma"]) == (1, 1), f"fleet supervised: Gram {counts}")
    return counts["tma"]


def slice_fleet_server(dev, card: str, ev: dict) -> dict:
    """``FleetServer`` on the same per-tenant config: ``prewarm()`` then
    ``wait_warm()``, then 11 submits, one full bucket and 3 flushed on the
    deadline and padded to 8. Every served result equals ``fit_fleet``
    called directly; the first bucket acquired nothing. Then tenant 0 of the
    direct result is ``publish_fleet``-ed and served through ``QueryServer``
    at bf16, a 64-query burst whose rows lie within 0.2 degrees of the direct
    fp32 projection. Returns the Gram and serve-kernel launches."""
    import dataclasses

    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from distributed_eigenspaces_tpu_torch.parallel import fleet
    from distributed_eigenspaces_tpu_torch.serving import EigenbasisRegistry, QueryServer
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger
    from distributed_eigenspaces_tpu_torch.utils.telemetry import Tracer

    cfg = dett.PCAConfig(**FLEET_FIT)
    extra = fleet_problems(dev, range(FLEET_B, FLEET_B + FLEET_SERVER_EXTRA))
    logger = MetricsLogger()
    tracer = Tracer()
    logger.attach_tracer(tracer)
    probs = [p for _, p in ev["tenants"]] + [p for _, p in extra]
    zero_counts()
    t0 = time.perf_counter()
    with fleet.FleetServer(cfg, device=dev, metrics=logger) as srv:
        construct_s = time.perf_counter() - t0
        pw = srv.prewarm()
        warm_ok, warm_s = synced_s(lambda: srv.wait_warm(timeout=600))
        t0 = time.perf_counter()
        tickets = [srv.submit(p) for p in probs]
        served = [t.result(timeout=600) for t in tickets]
        burst_s = time.perf_counter() - t0
        log = [dict(b) for b in logger.fleet_records if b["fleet"] == "bucket"]
        warm_stats = pw.stats()
    counts = read_counts()
    direct_full = ev["result"].components
    direct_pad = fleet.fit_fleet(cfg, probs[FLEET_B:], mesh=None, pad_to=FLEET_B).components
    direct = list(direct_full) + list(direct_pad)
    diffs = [float(np.abs(s - w).max()) for s, w in zip(served, direct)]
    close = all(np.allclose(s, w, rtol=1e-5, atol=1e-6) for s, w in zip(served, direct))
    # tenant 0 of the direct result published and served at bf16
    reg = EigenbasisRegistry(keep=4)
    bv = reg.publish_fleet(ev["result"], 0)
    spec0 = ev["tenants"][0][0]
    rng = np.random.default_rng(5)
    queries = [spec0.sample(rng, int(r)) for r in rng.choice([1, 8, 64], size=FLEET_QUERIES)]
    w0 = torch.from_numpy(ev["result"].components[0]).to(dev)
    ref = [torch.matmul(torch.from_numpy(q).to(dev), w0).cpu() for q in queries]
    with QueryServer(reg, dataclasses.replace(cfg, serve_dtype="bfloat16")) as qs:
        dispatches = [0]
        project = qs.engine.project

        def counted(x, v, project=project, dispatches=dispatches):
            dispatches[0] += 1
            return project(x, v)

        qs.engine.project = counted
        sp.launches = 0
        t_q = time.perf_counter()
        replies = [t.result(timeout=300) for t in [qs.submit(q) for q in queries]]
        query_s = time.perf_counter() - t_q
        serve_launches = sp.launches
    angles = torch.cat([row_angles_deg(r.z, z) for r, z in zip(replies, ref)])
    fleet_summary = logger.summary()["fleet"]
    chains: dict = {}
    for span in tracer.snapshot():
        if (span.trace_id or "").startswith("fleet"):
            chains.setdefault(span.trace_id, set()).add(span.name)
    chain_ok = len(chains) == len(probs) and all(
        {"admit", "queue_wait", "dispatch", "compute"} <= names for names in chains.values())
    emit("slice_fleet_server", part="metrics", fleet=fleet_summary,
         span_chains=len(chains), span_chains_complete=chain_ok, card=card)
    check(fleet_summary["buckets"] == 2 and fleet_summary["tenants"] == len(probs),
          f"fleet_server: the logger counted {fleet_summary['buckets']} buckets, "
          f"{fleet_summary['tenants']} tenants")
    check(fleet_summary["compile_misses"] == 0 and fleet_summary["compile_stall_ms"] == 0.0,
          f"fleet_server: the logger saw a compile stall on a prewarmed server: "
          f"{fleet_summary}")
    check(chain_ok, f"fleet_server: span chains {chains}")
    emit("slice_fleet_server",
         config=f"FleetServer, bucket {cfg.fleet_bucket_size}, flush {cfg.fleet_flush_s} s; "
                "per tenant the mnist784 eval's settings",
         construct_s=construct_s, prewarm=dict(ok=warm_ok, wait_s=warm_s, **warm_stats),
         submits=len(probs), burst_s=burst_s,
         buckets=[{key: b[key] for key in ("tenants", "occupancy", "compile_stall_ms",
                                           "bucket_seconds", "queue_wait_s")}
                  for b in log],
         gram_calls=counts, served_vs_direct_max_abs=max(diffs), served_equal_direct=close,
         published=dict(version=bv.version, lineage=dict(bv.lineage), step=bv.step),
         query_burst=dict(queries=len(replies), rows=int(sum(q.shape[0] for q in queries)),
                          s=query_s, batches=dispatches[0], serve_launches=serve_launches,
                          versions=sorted({r.version for r in replies}),
                          max_angle_deg=float(angles.max())),
         card=card)
    check(warm_ok and warm_stats["compiled"] == 1, f"fleet_server: prewarm {warm_stats}")
    check([b["tenants"] for b in log] == [FLEET_B, FLEET_SERVER_EXTRA],
          f"fleet_server: buckets {[b['tenants'] for b in log]}")
    check(log[0]["compile_stall_ms"] == 0.0,
          f"fleet_server: first bucket {log[0]['compile_stall_ms']} ms")
    check(close, f"fleet_server: served vs direct {max(diffs)}")
    check(counts["tma"] == 2 and counts["gram"] == 2 and counts["s8"] == 0,
          f"fleet_server: Gram launches {counts}, want one a bucket")
    check(bv.lineage["producer"] == "fit_fleet" and bv.lineage["tenant"] == 0
          and tuple(bv.lineage["fleet_signature"]) == fleet.fleet_signature(cfg),
          f"fleet_server: lineage {dict(bv.lineage)}")
    check(float(angles.max()) <= 0.2, f"fleet_server: served row {float(angles.max())} deg")
    check(serve_launches == dispatches[0] and serve_launches > 0,
          f"fleet_server: {serve_launches} serve launches, {dispatches[0]} dispatches")
    return {"tma": counts["tma"], "serve_bf16": serve_launches, "served": served}


def guard_trainers(cfg, dev, b: int):
    """The four guarded builders of ``slice_guards``, built under whatever
    ``DET_CHECKIFY`` says now: name -> ``run(x)``, ``x`` the trainer's input
    (a ``(T, m, n, d)`` stack, the fleet's ``(B, T, m, n, d)``)."""
    import numpy as np
    from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
    from distributed_eigenspaces_tpu_torch.algo.scan import (
        SegmentState,
        make_scan_fit,
        make_segmented_fit,
    )
    from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
    from distributed_eigenspaces_tpu_torch.parallel import fleet

    d, k, T = cfg.dim, cfg.k, cfg.num_steps
    st = lambda: OnlineState.initial(d, device=dev)  # noqa: E731
    step = make_train_step(cfg, device=dev)
    scan = make_scan_fit(cfg, device=dev)
    seg = make_segmented_fit(cfg, segment=GUARD_SEGMENT, device=dev)
    ffit = fleet.make_fleet_fit(cfg, device=dev)
    actives = np.ones((b, T), np.float32)
    return {
        "make_train_step": lambda x: step(st(), x[0]),
        "make_scan_fit": lambda x: scan(st(), x),
        "make_segmented_fit": lambda x: (lambda s: (s.sigma_tilde, s.v_prev))(
            seg(SegmentState.initial(d, k, device=dev), x)),
        "make_fleet_fit": lambda x: ffit(fleet.init_fleet_states(cfg, b, device=dev), x,
                                         actives),
    }


def slice_guards(dev, card: str) -> dict:
    """The NaN guards on the card (``DET_CHECKIFY=1`` set for the builds,
    restored after): ``make_train_step``, ``make_scan_fit``,
    ``make_segmented_fit`` and ``make_fleet_fit`` (8 tenants) at the
    mnist784 eval's widths, 4 steps, bf16 blocks. Each guarded build's clean
    run is bit-equal to the guards-off build's; one inf in one worker's
    block (the fleet's: one tenant's) raises ``CheckError``; after it a
    clean run in the same process is bit-equal again (the card stays
    usable). Prints what the armed guards add a call: kernels and host
    syncs (profiled), and the guards' own read-backs. Returns the Gram
    launches (each cold step one bf16 TMA launch)."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.utils import guards

    t_phase = time.perf_counter()
    cfg = dett.PCAConfig(**GUARD_FIT)
    T, m, n, d = cfg.num_steps, cfg.num_workers, cfg.rows_per_worker, cfg.dim
    spec = dett.planted_subspace(d, **MNIST_DATA)
    xs = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n).reshape(T, m, n, d)
    stack = torch.stack([
        dett.planted_subspace(d, **dict(MNIST_DATA, seed=b)).sample(
            torch.Generator(device=dev).manual_seed(b), T * m * n).reshape(T, m, n, d)
        for b in range(FLEET_B)])
    with checkify_env("0"):
        plain = guard_trainers(cfg, dev, FLEET_B)
    with checkify_env("1"):
        armed = guard_trainers(cfg, dev, FLEET_B)

    def leaves(out):
        return [getattr(out[0], "sigma_tilde", out[0]), out[1]]

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    rows, tma = {}, 0
    for name in plain:
        x = stack if name == "make_fleet_fit" else xs
        bad = x.clone()
        at = (FLEET_POISON["tenant"],) if name == "make_fleet_fit" else ()
        step = 0 if name == "make_train_step" else GUARD_POISON["step"]  # its one block
        bad[at + (step, GUARD_POISON["worker"], 0, 0)] = float("inf")
        zero_counts()
        want, plain_s = synced_s(lambda: plain[name](x))
        plain_tma = read_counts()["tma"]
        zero_counts()
        s0 = guards.syncs
        got, armed_s = synced_s(lambda: armed[name](x))
        armed_tma, own_syncs = read_counts()["tma"], guards.syncs - s0
        t0 = time.perf_counter()
        try:
            armed[name](bad)
            raised = None
        except guards.CheckError as e:
            raised = str(e)
        raise_s = time.perf_counter() - t0
        zero_counts()
        after = armed[name](x)
        after_tma = read_counts()["tma"]
        tma += plain_tma + armed_tma + after_tma
        rows[name] = dict(plain_s=plain_s, armed_s=armed_s, raise_s=raise_s, raised=raised,
                          clean_bit_equal=equal(got, want), after_bit_equal=equal(after, want),
                          guard_read_backs=own_syncs, tma=[plain_tma, armed_tma, after_tma])
        check(raised is not None, f"guards {name}: an inf in step {step + 1} raised nothing")
        check(rows[name]["clean_bit_equal"] and rows[name]["after_bit_equal"],
              f"guards {name}: guarded runs differ from the guards-off run: {rows[name]}")
        check(plain_tma >= 1 and armed_tma == plain_tma == after_tma,
              f"guards {name}: TMA Gram launches {rows[name]['tma']}")
        calls = T // GUARD_SEGMENT if name == "make_segmented_fit" else 1
        check(own_syncs == 2 * calls,
              f"guards {name}: {own_syncs} guard read-backs, want 2 a guarded call")
        del want, got, after, bad
    # what arming adds to one call, profiled (the scan and the fleet)
    added = {}
    for name in ("make_scan_fit", "make_fleet_fit"):
        x = stack if name == "make_fleet_fit" else xs
        p = profiled_launches(lambda: plain[name](x))
        a = profiled_launches(lambda: armed[name](x))
        _, p_syncs = counted_syncs(lambda: plain[name](x))
        _, a_syncs = counted_syncs(lambda: armed[name](x))
        added[name] = dict(kernels=a["kernels"] - p["kernels"],
                           runtime_launch_calls=a["runtime_launch_calls"]
                           - p["runtime_launch_calls"], syncs=a_syncs - p_syncs)
    phase_s = time.perf_counter() - t_phase
    emit("slice_guards", config=f"DET_CHECKIFY=1, mnist784 widths (d={d}, k={cfg.k}, m={m}, "
                                f"n={n}), {T} steps, bf16 blocks, fleet of {FLEET_B}",
         trainers=rows, added_per_call=added, phase_s=phase_s, card=card)
    del xs, stack
    return {"tma": tma, "s": phase_s, "added": added}


def slice_fleet_solo(dev, card: str, spec, data) -> int:
    """``OnlineDistributedPCA(trainer="fleet")`` on the cifar10 eval's
    settings and data: a one-tenant fleet with the fleet's fp32 staging,
    within 1 degree of the planted top-10 and 0.2 degrees of
    ``trainer="scan"`` on the same blocks (its bf16 stage, which casts the
    blocks the fleet casts in-loop) and start, with one Gram launch (the
    bf16 TMA kernel at (8, 1024, 3072)); beside it the eval's own int8-stage
    scan. Returns the fleet fit's TMA launches."""
    import dataclasses

    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    cfg = dett.PCAConfig(**EVAL_FIT)
    est = dett.OnlineDistributedPCA(cfg, trainer="fleet")
    zero_counts()
    _, fit_s = synced_s(lambda: est.fit(data))
    counts = read_counts()
    _, second_s = synced_s(lambda: dett.OnlineDistributedPCA(cfg, trainer="fleet").fit(data))
    scan = dett.OnlineDistributedPCA(dataclasses.replace(cfg, stage_dtype=None),
                                     trainer="scan").fit(data)
    scan_i8 = dett.OnlineDistributedPCA(cfg, trainer="scan").fit(data)

    def deg(a, b):
        return float(principal_angles_degrees(a.components_.cpu(), b.components_.cpu()).max())

    angle = components_angle(est, spec)
    to_scan, to_i8 = deg(est, scan), deg(est, scan_i8)
    emit("slice_fleet_solo",
         config="cifar10 eval (evals.py:86-90) field for field through "
                "OnlineDistributedPCA(trainer='fleet'): a one-tenant fleet, fp32 staging",
         trainer=est.trainer_used_, step=est.state.step, counts=counts, fit_s=fit_s,
         second_fit_s=second_s, max_angle_deg=angle, angle_to_scan_bf16_stage_deg=to_scan,
         angle_to_scan_int8_stage_deg=to_i8, scan_angle_deg=components_angle(scan, spec),
         card=card)
    check(est.trainer_used_ == "fleet" and est.state.step == cfg.num_steps,
          f"fleet_solo: trainer {est.trainer_used_}, step {est.state.step}")
    check(angle <= 1.0, f"fleet_solo: {angle} deg from the planted top-10")
    check(to_scan <= FLEET_SOLO_DEG, f"fleet_solo: {to_scan} deg from trainer='scan'")
    check(counts["gram"] == 1 and counts["tma"] == 1 and counts["s8"] == 0,
          f"fleet_solo: Gram launches {counts}, want one bf16 TMA launch")
    return counts["tma"]


def pop_rounds():
    """The population phase's cohorts, as ``runtime/population.py`` draws
    them: per round ``(stack (256, 64, 4) float32, mask)``, the first
    ``POP_POISON`` clients colluders submitting the same sign-flipped basis
    orthogonal to the planted one (orthonormal, so it slips the gauntlet),
    the rest ``QR(planted + noise * eps)`` with deterministic column signs;
    and the planted basis."""
    import numpy as np

    d, k, seed = POP_FIT["dim"], POP_FIT["k"], 0
    rng = np.random.default_rng([seed, 0xBA515])
    q, _ = np.linalg.qr(rng.standard_normal((d, 2 * k)))
    planted = np.ascontiguousarray(q[:, :k], np.float32)
    poison = -np.ascontiguousarray(q[:, k:2 * k], np.float32)
    rounds = []
    for rnd in range(POP_FIT["num_steps"]):
        stack = np.empty((POP_FIT["cohort_size"], d, k), np.float32)
        stack[:POP_POISON] = poison
        for c in range(POP_POISON, POP_FIT["cohort_size"]):
            w = planted + POP_NOISE * np.random.default_rng([seed, rnd, c]).standard_normal(
                (d, k)).astype(np.float32)
            qq, r = np.linalg.qr(w)
            stack[c] = qq * np.sign(np.diag(r))[None, :]
        rounds.append((stack, np.ones(POP_FIT["cohort_size"], np.float32)))
    return rounds, planted


def slice_clients(dev, card: str) -> dict:
    """``make_population_merge`` at the reference bench's population shape
    (d=64, k=4, cohort 256, ``max_poison_frac=0.08``) on cohorts with 5%
    colluding orthonormal poison (bench gate 2: only the trim and the screen
    stand against it), 12 rounds folded as ``population_fit`` folds them:
    the hardened basis within the bench's 5 degrees of the planted one, the
    naive mean at least twice as far. No hand kernel on this path."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.algo.online import update_state
    from distributed_eigenspaces_tpu_torch.ops.linalg import (
        principal_angles_degrees,
        top_k_eigvecs,
    )
    from distributed_eigenspaces_tpu_torch.parallel import clients

    cfg = dett.PCAConfig(**POP_FIT)
    rounds, planted = pop_rounds()
    merge = clients.make_population_merge(cfg, device=dev)
    st_h = dett.OnlineState.initial(cfg.dim, device=dev)
    st_n = dett.OnlineState.initial(cfg.dim, device=dev)
    kept, screened_poison, merge_ms, first = [], [], [], None
    for stack, mask in rounds:
        s_dev, m_dev = torch.from_numpy(stack).to(dev), torch.from_numpy(mask).to(dev)
        (v, keep, stats), sec = synced_s(lambda: merge(s_dev, m_dev))
        merge_ms.append(sec * 1e3)
        keep = keep.cpu().numpy()
        kept.append(int(keep.sum()))
        screened_poison.append(int((keep[:POP_POISON] == 0).sum()))
        first = v.cpu().numpy() if first is None else first
        st_h = update_state(st_h, v, discount=cfg.discount, num_steps=cfg.num_steps)
        st_n = update_state(st_n, clients.naive_mean_basis(s_dev, m_dev, cfg.k),
                            discount=cfg.discount, num_steps=cfg.num_steps)
    truth = torch.from_numpy(planted)

    def deg(st):
        return float(principal_angles_degrees(top_k_eigvecs(st.sigma_tilde, cfg.k).cpu(),
                                              truth).max())

    hardened, naive = deg(st_h), deg(st_n)
    emit("slice_clients",
         config="population merge (bench.py:2241-2256): d=64 k=4 cohort 256, "
                f"max_poison_frac 0.08, {POP_POISON} orthonormal colluders a cohort, honest "
                f"noise {POP_NOISE}, {len(rounds)} rounds folded",
         hardened_angle_deg=hardened, naive_angle_deg=naive,
         naive_over_hardened=naive / hardened, kept_by_round=kept,
         screened_by_round=[cfg.cohort_size - n for n in kept],
         poison_screened_by_round=screened_poison,
         merge_ms_median=statistics.median(merge_ms), merge_ms=merge_ms, card=card)
    check(hardened <= POP_BUDGET_DEG, f"clients: hardened {hardened} deg > {POP_BUDGET_DEG}")
    check(naive >= 2.0 * hardened, f"clients: naive {naive} deg < 2 x hardened {hardened}")
    check(min(screened_poison) == POP_POISON, f"clients: colluders kept {screened_poison}")
    stack0, mask0 = rounds[0]
    return {"stack": stack0, "mask": mask0, "v": first}


def fleet_rank_phase(rank: int, world: int, one: dict) -> dict:
    """One rank of ``slice_fleet_ranks2`` (both on ``cuda:0``, over gloo):
    ``slice_fleet_eval``'s fleet on a fleet mesh of 2, its tenants 4 a rank,
    under the collective recorder (none inside the fit; one gather of the
    results after it), each tenant against the one-process fleet
    (``one["components"]``); then ``make_sharded_cohort_reduce`` on the
    population phase's first cohort at fp32 and at a bf16 wire."""
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.parallel import clients, fleet
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(MESH_DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = dett.PCAConfig(**FLEET_FIT)
    probs = [p for _, p in fleet_problems(dev, range(FLEET_B))]
    mesh = fleet.fleet_mesh(FLEET_B, dev)
    cache: dict = {}
    fleet.fit_fleet(cfg, probs[:2 * world], mesh=mesh, fit_cache=cache)  # start-up
    zero_counts()
    with pmesh.recording_collectives() as log:
        res, fit_s = synced_s(lambda: fleet.fit_fleet(cfg, probs, mesh=mesh, fit_cache=cache))
    counts = read_counts()
    rows = pmesh.worker_rows(mesh, FLEET_B)
    fit = fleet.make_fleet_fit(cfg, mesh)
    xs = torch.from_numpy(res.batch.xs[rows]).to(dev)
    with pmesh.recording_collectives() as inner:
        fit(fleet.init_fleet_states(cfg, rows.stop - rows.start, device=dev), xs,
            res.batch.actives[rows])
    del xs
    angles = [float(principal_angles_degrees(torch.from_numpy(res.components[b]),
                                             torch.from_numpy(one["components"][b])).max())
              for b in range(FLEET_B)]
    out = {"backend": torch.distributed.get_backend(), "mesh": mesh.shape, "fit_s": fit_s,
           "counts": counts, "log": [dict(r) for r in log], "fit_log": [dict(r) for r in inner],
           "angles": angles, "components": res.components,
           "steps": res.states.step.tolist()}
    del res
    out["server"] = fleet_server_rank(rank, cfg, mesh, probs, one["served"])
    out["guards"] = fleet_guards_rank(cfg, mesh, probs, out["components"])
    del probs
    pcfg = dett.PCAConfig(**POP_FIT)
    cmesh = pmesh.make_mesh(world, device=dev)
    crows = pmesh.worker_rows(cmesh, pcfg.cohort_size)
    for wire in ("fp32", "bf16"):
        reduce = clients.make_sharded_cohort_reduce(pcfg, cmesh, wire_dtype=wire)
        with pmesh.recording_collectives() as clog:
            v, sec = synced_s(lambda: reduce(one["stack"][crows], one["mask"][crows]))
        out[f"cohort_{wire}"] = {
            "v": v.cpu().numpy(), "s": sec, "log": [dict(r) for r in clog],
            "deg_to_one_process": float(principal_angles_degrees(
                v.cpu(), torch.from_numpy(one["v"])).max())}
    check(max(angles) <= FLEET_RANK_DEG,
          f"fleet_ranks2 rank {rank}: a tenant {max(angles)} deg from the one-process fleet")
    return out


def fleet_server_rank(rank: int, cfg, mesh, probs: list, served_one: list) -> dict:
    """One rank's ``FleetServer(mesh=fleet_mesh(8))``, prewarmed, given
    ``slice_fleet_server``'s 11 requests in its order; rank 1 submits 2,
    sleeps three flush windows, then the other 9. Each result within
    ``FLEET_RANK_DEG`` of the one-process server's (``served_one``)."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.parallel import fleet
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    dev = mesh.device
    reqs = list(probs) + [p for _, p in fleet_problems(
        dev, range(FLEET_B, FLEET_B + FLEET_SERVER_EXTRA))]
    logger = MetricsLogger()
    t_part = time.perf_counter()
    zero_counts()
    with pmesh.recording_collectives() as log:
        srv = fleet.FleetServer(cfg, mesh=mesh, device=dev, metrics=logger)
        srv.prewarm()
        warm = srv.wait_warm(timeout=600)
        t0 = time.perf_counter()
        tickets = []
        for i, p in enumerate(reqs):
            tickets.append(srv.submit(p))
            if rank == 1 and i == FLEET_SKEW_AFTER - 1:
                time.sleep(3 * cfg.fleet_flush_s)
        served = [t.result(timeout=600) for t in tickets]
        burst_s = time.perf_counter() - t0
        srv.close()
    counts = read_counts()
    del reqs
    buckets = [dict(b) for b in logger.fleet_records if b["fleet"] == "bucket"]
    angles = [float(principal_angles_degrees(torch.from_numpy(s), torch.from_numpy(w)).max())
              for s, w in zip(served, served_one)]
    rounds, cur = [], []
    for r in log:  # a fit round ends at its results gather
        cur.append((r["op"], r["axis"], r["dtype"], r["elements"]))
        if r["axis"] == pmesh.WORKER_AXIS:
            rounds.append(cur)
            cur = []
    check(max(angles) <= FLEET_RANK_DEG,
          f"fleet server rank {rank}: a request {max(angles)} deg from the one-process server")
    check(warm and buckets[0]["compile_stall_ms"] == 0.0,
          f"fleet server rank {rank}: first round stalled {buckets[0]['compile_stall_ms']} ms")
    check(counts["tma"] == len(buckets) == srv.lockstep_rounds,
          f"fleet server rank {rank}: {counts['tma']} TMA launches for {len(buckets)} rounds")
    return {"served": served, "angles": angles, "rounds": srv.lockstep_rounds,
            "tenants": [b["tenants"] for b in buckets],
            "compile_stall_ms": [b["compile_stall_ms"] for b in buckets],
            "round_s": [b["bucket_seconds"] for b in buckets],
            "queue_wait_s": [b["queue_wait_s"] for b in buckets],
            "collectives": rounds, "tail": cur, "counts": counts, "burst_s": burst_s,
            "part_s": time.perf_counter() - t_part}


def fleet_guards_rank(cfg, mesh, probs: list, components) -> dict:
    """The fleet fit on the mesh with the guards armed (its programs
    acquired into a fresh cache with ``DET_CHECKIFY=1`` set, then restored,
    as ``slice_guards`` builds): one poisoned tenant in rank 1's half raises
    ``CheckError`` on both ranks, then a clean fit runs bit-equal to the
    guards-off one (``components``)."""
    import numpy as np
    from distributed_eigenspaces_tpu_torch.parallel import fleet
    from distributed_eigenspaces_tpu_torch.utils.guards import CheckError

    t_part = time.perf_counter()
    poisoned = list(probs)
    b, t, w = (FLEET_POISON[f] for f in ("tenant", "step", "worker"))
    poisoned[b] = probs[b].copy()
    poisoned[b][t, w, 0, 0] = np.nan
    cache: dict = {}
    with checkify_env("1"):
        fleet.acquire_fleet_programs(cfg, mesh, masked=False, b_pad=FLEET_B,
                                     fit_cache=cache, device=mesh.device)
    t0 = time.perf_counter()
    try:
        fleet.fit_fleet(cfg, poisoned, mesh=mesh, fit_cache=cache)
        raised = None
    except CheckError as e:
        raised = str(e)
    raise_s = time.perf_counter() - t0
    del poisoned
    zero_counts()
    clean, clean_s = synced_s(lambda: fleet.fit_fleet(cfg, probs, mesh=mesh, fit_cache=cache))
    counts = read_counts()
    equal = bool(np.array_equal(clean.components, components))
    check(raised is not None and raise_s < MESH_TIMEOUT_S / 4,
          f"fleet guards: the poisoned fleet raised {raised!r} after {raise_s} s")
    check(equal, "fleet guards: the guarded clean fit differs from the unguarded one")
    return {"raised": raised, "raise_s": raise_s, "clean_s": clean_s, "counts": counts,
            "clean_bit_equal": equal, "part_s": time.perf_counter() - t_part}


def slice_fleet_ranks2(dev, card: str, ev: dict, cohort: dict, served: list,
                       work_dir: str) -> dict:
    """Two ranks sharing the card in one gloo group (``parallel.mesh.launch``):
    each runs ``fleet_rank_phase``. The fleet's fit makes no collective and
    its results come by one all-gather; each tenant within 0.01 degrees of
    the one-process fleet. The mesh ``FleetServer`` serves
    ``slice_fleet_server``'s 11 requests on both ranks (rank 1's submissions
    skewed past the flush): every request resolves on both, bit-equal
    across ranks and within 0.01 degrees of the one-process server
    (``served``), the prewarmed first round stalls 0.0 ms, one bf16 TMA
    Gram a rank a round. The guarded fleet fit with one poisoned tenant in
    rank 1's half raises ``CheckError`` on both ranks, then a clean fit
    runs. The sharded cohort reduce makes one stack gather in the wire
    dtype and one fp32 mask gather, is bit-equal across ranks, and at fp32
    within 1e-3 degrees of the one-process merge. Returns the ranks' TMA
    launches by part."""
    import numpy as np
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    one = {"components": ev["result"].components, "served": served, **cohort}
    out, launch_s = synced_s(lambda: pmesh.launch(
        fleet_rank_phase, MESH_RANKS, one, backend="gloo", timeout=MESH_TIMEOUT_S,
        workdir=work_dir))
    r0 = out[0]

    def ops(log):
        return [(r["op"], r["axis"], r["dtype"], r["elements"]) for r in log]

    emit("slice_fleet_ranks2", ranks=MESH_RANKS, backend=r0["backend"], launch_s=launch_s,
         mesh=r0["mesh"], fit_s_by_rank=[o["fit_s"] for o in out],
         gram_by_rank=[o["counts"] for o in out],
         collectives_in_fit_by_rank=[len(o["fit_log"]) for o in out],
         fit_fleet_collectives=ops(r0["log"]), max_angle_to_one_process_deg=max(
             max(o["angles"]) for o in out),
         server=dict(rounds=r0["server"]["rounds"], tenants=r0["server"]["tenants"],
                     compile_stall_ms_by_rank=[o["server"]["compile_stall_ms"] for o in out],
                     round_s_by_rank=[o["server"]["round_s"] for o in out],
                     queue_wait_s_by_rank=[o["server"]["queue_wait_s"] for o in out],
                     collectives_by_round=r0["server"]["collectives"],
                     collectives_after=r0["server"]["tail"],
                     tma_by_rank=[o["server"]["counts"]["tma"] for o in out],
                     burst_s_by_rank=[o["server"]["burst_s"] for o in out],
                     part_s_by_rank=[o["server"]["part_s"] for o in out],
                     max_angle_to_one_process_deg=max(max(o["server"]["angles"]) for o in out),
                     ranks_bit_equal=all(np.array_equal(np.stack(o["server"]["served"]),
                                                        np.stack(r0["server"]["served"]))
                                         for o in out)),
         guards=dict(raised_by_rank=[o["guards"]["raised"] for o in out],
                     raise_s_by_rank=[o["guards"]["raise_s"] for o in out],
                     clean_s_by_rank=[o["guards"]["clean_s"] for o in out],
                     clean_bit_equal=[o["guards"]["clean_bit_equal"] for o in out],
                     part_s_by_rank=[o["guards"]["part_s"] for o in out]),
         cohort={wire: dict(s_by_rank=[o[f"cohort_{wire}"]["s"] for o in out],
                            collectives=ops(r0[f"cohort_{wire}"]["log"]),
                            deg_to_one_process=r0[f"cohort_{wire}"]["deg_to_one_process"],
                            ranks_bit_equal=all(np.array_equal(
                                o[f"cohort_{wire}"]["v"], r0[f"cohort_{wire}"]["v"])
                                for o in out))
                 for wire in ("fp32", "bf16")},
         card=card)
    k, d, c = POP_FIT["k"], POP_FIT["dim"], POP_FIT["cohort_size"]
    for o in out:
        check(o["backend"] == "gloo" and o["mesh"] == {"workers": MESH_RANKS, "features": 1},
              f"fleet_ranks2: {o['backend']} mesh {o['mesh']}")
        check(o["fit_log"] == [], f"fleet_ranks2: collectives inside the fit {o['fit_log']}")
        check([r["op"] for r in o["log"]] == ["all_gather"]
              and o["log"][0]["axis"] == pmesh.WORKER_AXIS,
              f"fleet_ranks2: fit_fleet's collectives {ops(o['log'])}")
        check(o["counts"]["tma"] == 1 and o["counts"]["gram"] == 1,
              f"fleet_ranks2: a rank's Gram launches {o['counts']}")
        check(o["steps"] == [MNIST_FIT["num_steps"]] * FLEET_B, f"fleet_ranks2: {o['steps']}")
        np.testing.assert_array_equal(o["components"], r0["components"])
        for wire, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
            got = ops(o[f"cohort_{wire}"]["log"])
            check(got == [("all_gather", pmesh.WORKER_AXIS, dtype, c // MESH_RANKS * d * k),
                          ("all_gather", pmesh.WORKER_AXIS, "float32", c // MESH_RANKS)],
                  f"fleet_ranks2 cohort {wire}: collectives {got}")
            check(np.array_equal(o[f"cohort_{wire}"]["v"], r0[f"cohort_{wire}"]["v"]),
                  f"fleet_ranks2 cohort {wire}: ranks differ")
        check(o["cohort_fp32"]["deg_to_one_process"] <= COHORT_RANK_DEG,
              f"fleet_ranks2: fp32 cohort {o['cohort_fp32']['deg_to_one_process']} deg")
        srv = o["server"]
        check(len(srv["served"]) == FLEET_B + FLEET_SERVER_EXTRA
              and srv["tenants"] == r0["server"]["tenants"] == [FLEET_B, FLEET_SERVER_EXTRA],
              f"fleet_ranks2 server: rounds of {srv['tenants']} tenants")
        check(np.array_equal(np.stack(srv["served"]), np.stack(r0["server"]["served"])),
              "fleet_ranks2 server: the ranks' results differ")
        check(o["guards"]["counts"]["tma"] == 1,
              f"fleet_ranks2 guards: the clean fit's Gram launches {o['guards']['counts']}")
    return {"fit": sum(o["counts"]["tma"] for o in out),
            "server": sum(o["server"]["counts"]["tma"] for o in out),
            "guards": sum(o["guards"]["counts"]["tma"] for o in out)}


# the supervised and elastic fits (runtime/supervisor.py, runtime/membership.py):
# the reference chaos harness's fit mode (scripts/chaos.py:1054-1200) on the
# cifar10 eval's settings, its churn bench (bench.py:2002-2160) at mnist784's
# widths, and the master's dynamic round (runtime/scheduler.py:949-1040)
SUP_CHAOS = dict(nan_blocks={3: [2]}, zero_blocks={5: [4]},
                 raise_at={7: "chaos: flaky read"}, kill_at=11)
SUP_SEGMENT = 4  # the segmented trainer's window: a commit every window
SUP_CLEAN_DEG = 1.0  # the corrupted run against the clean supervised run
# the bench's contract; prefetch at the port's default depth, so each round's
# assembly (its deadline wait) runs on the producer thread while the card
# computes the last one, and a round takes the deadline, as the bench's tiny
# rounds do (its flap gate needs rounds under half the heartbeat timeout)
CHURN_FIT = dict(MNIST_FIT, num_workers=10, num_steps=14, backend="local",
                 prefetch_depth=2, heartbeat_timeout_ms=100.0, round_deadline_ms=40.0,
                 min_quorum_frac=0.5)
CHURN_GRAM = (CHURN_FIT["num_workers"], CHURN_FIT["rows_per_worker"], CHURN_FIT["dim"])
CHURN_PLAN = dict(kill_at={3: [0, 1, 2], 9: [3]}, rejoin_at={9: [0, 1], 12: [3]},
                  slow={9: 0.08})  # bench.py:2073-2079
CHURN_QUORUM_KILLED = [0, 1, 2, 3, 4, 5]  # 60%: live 40% < the 50% floor
DYN_ROWS = 16_384  # the cifar10 eval's first rows
DYN_BATCHES = 16
DYN_LANES = 2
DYN_FAULT_TASKS = (3, 11)
DYN_GRAM = (1, DYN_ROWS // DYN_BATCHES, EVAL_FIT["dim"])  # one batch's fp32 Gram
DYN_SIGMA_REL = 1e-5
DYN_LANE_DEG = 0.01


def step_percentiles_ms(logger) -> dict:
    """p50 / p99 of a MetricsLogger's retained step times, in ms."""
    import numpy as np

    secs = [r["step_seconds"] for r in logger.records if "step_seconds" in r]
    if not secs:
        return {"p50_ms": None, "p99_ms": None, "steps": 0}
    return {"p50_ms": float(np.percentile(secs, 50) * 1e3),
            "p99_ms": float(np.percentile(secs, 99) * 1e3), "steps": len(secs)}


def chaos_fit(cfg, data, ckpt_dir: str, trainer: str, plan_kw: dict, sup, logger,
              dev) -> tuple:
    """``supervised_fit`` under the chaos harness's restart loop: a
    ``KillSwitch`` is the process dying, caught outside, and the next call
    resumes from the checkpoint directory, the kill fired once; one
    ``Supervisor`` across the loop. Returns ``(w, state, restarts,
    seconds)``."""
    from distributed_eigenspaces_tpu_torch.data.stream import block_stream
    from distributed_eigenspaces_tpu_torch.runtime.supervisor import supervised_fit
    from distributed_eigenspaces_tpu_torch.utils.faults import (
        ChaosPlan,
        ChaosStream,
        KillSwitch,
    )

    m, n = cfg.num_workers, cfg.rows_per_worker
    fired = [False]

    def factory(start_row):
        plan = dict(plan_kw)
        if fired[0]:
            plan["kill_at"] = None
        return ChaosStream(block_stream(data, num_workers=m, rows_per_worker=n,
                                        start_row=start_row, device=dev),
                           ChaosPlan(**plan), first_step=start_row // (m * n) + 1)

    restarts = 0
    t0 = time.perf_counter()
    while True:
        try:
            w, st, _ = supervised_fit(
                factory, cfg, checkpoint_dir=ckpt_dir, trainer=trainer,
                checkpoint_every=SUP_SEGMENT if trainer == "segmented" else 1,
                supervisor=sup, metrics=logger, device=dev)
            break
        except KillSwitch:
            restarts += 1
            fired[0] = True
    import torch

    torch.cuda.synchronize()
    return w, st, restarts, time.perf_counter() - t0


def slice_supervised(dev, card: str, work_dir: str, spec, data) -> dict:
    """The chaos harness's fit mode on the cifar10 eval's settings field for
    field (d=3072 k=10 m=8 n=1024 T=20, bf16, ns warm rounds) and data, on
    the per-step trainer (prefetch depth 2) and the segmented one (a commit
    a window of 4): a clean supervised run, then the chaotic stream (a NaN
    block at step 3, a zeroed one at 5, a flaky read at 7, a kill at 11)
    restarted on the same checkpoint directory under one Supervisor with a
    MetricsLogger; on the segmented trainer also a kill-only run, equal to
    the clean one bit for bit. The supervised routes feed the blocks as
    they come (the reference's), so the int8 stage is not taken: each run's
    cold rounds are bf16 TMA Gram launches, one a process start on the
    per-step loop (its warm carry is no checkpoint state), one a run on the
    segmented trainer (``SegmentState`` carries it). Returns the Gram
    launches."""
    import dataclasses

    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.runtime.supervisor import Supervisor
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    base = dett.PCAConfig(**EVAL_FIT)
    m, n, T = base.num_workers, base.rows_per_worker, base.num_steps
    bf16 = {}
    for trainer in ("step", "segmented"):
        cfg = dataclasses.replace(base, prefetch_depth=2) if trainer == "step" else base
        runs = {}
        plans = {"clean": {}, "chaos": SUP_CHAOS}
        if trainer == "segmented":
            plans["kill_only"] = {"kill_at": SUP_CHAOS["kill_at"]}
        for name, plan in plans.items():
            logger = MetricsLogger(samples_per_step=m * n)
            sup = Supervisor(cfg, metrics=logger)
            zero_counts()
            w, st, restarts, secs = chaos_fit(
                cfg, data, os.path.join(work_dir, f"sup_{trainer}_{name}"), trainer, plan,
                sup, logger, dev)
            counts = read_counts()
            runs[name] = dict(w=w, st=st, restarts=restarts, s=secs, counts=counts,
                              ledger=sup.ledger.by_kind, summary=logger.summary(),
                              steps=step_percentiles_ms(logger))
        chaos, clean = runs["chaos"], runs["clean"]
        summary = chaos["summary"]
        cold = {"step": {"clean": 1, "chaos": 2, "kill_only": 2},
                "segmented": {"clean": 1, "chaos": 1, "kill_only": 1}}[trainer]
        angles = dict(
            chaos_vs_clean_deg=float(principal_angles_degrees(
                chaos["w"].cpu(), clean["w"].cpu()).max()),
            chaos_vs_truth_deg=basis_angle(chaos["w"], spec),
            clean_vs_truth_deg=basis_angle(clean["w"], spec))
        kill_equal = None
        if "kill_only" in runs:
            kill_equal = bool(torch.equal(runs["kill_only"]["st"].sigma_tilde,
                                          clean["st"].sigma_tilde)
                              and torch.equal(runs["kill_only"]["w"], clean["w"]))
        emit("slice_supervised", trainer=trainer,
             config="cifar10 eval settings (evals.py:86-90) field for field"
                    + (", prefetch_depth 2" if trainer == "step"
                       else f", segment {SUP_SEGMENT} (a commit a window)"),
             chaos_plan={k: v for k, v in SUP_CHAOS.items()},
             restarts=chaos["restarts"], ledger_by_kind=chaos["ledger"],
             faults=summary.get("faults", {}).get("by_kind"),
             steps_completed=int(chaos["st"].step),
             logger_step_ms=chaos["steps"], ingest=summary.get("ingest"),
             gram_launches={name: r["counts"] for name, r in runs.items()},
             gram_launches_predicted={name: {"gram": c, "tma": c, "s8": 0}
                                      for name, c in cold.items()},
             wall_s={name: r["s"] for name, r in runs.items()},
             kill_only_equals_clean=kill_equal, card=card, **angles)
        for name, r in runs.items():
            check(int(r["st"].step) == T, f"supervised {trainer} {name}: {r['st'].step} steps")
            check(bool(torch.isfinite(r["st"].sigma_tilde).all()),
                  f"supervised {trainer} {name}: sigma_tilde not finite")
            c = cold[name]
            check((r["counts"]["gram"], r["counts"]["tma"], r["counts"]["s8"]) == (c, c, 0),
                  f"supervised {trainer} {name}: Gram launches {r['counts']}, the route "
                  f"predicts {c} bf16 TMA launches")
        check(chaos["restarts"] == 1, f"supervised {trainer}: {chaos['restarts']} restarts")
        check(set(chaos["ledger"]) == {"quarantine_nonfinite", "stream_retry", "resume"},
              f"supervised {trainer}: ledger {chaos['ledger']}")
        check("faults" in summary, f"supervised {trainer}: no faults section")
        check(angles["chaos_vs_clean_deg"] <= SUP_CLEAN_DEG,
              f"supervised {trainer}: {angles['chaos_vs_clean_deg']} deg from the clean run")
        check(angles["chaos_vs_truth_deg"] <= 1.0,
              f"supervised {trainer}: {angles['chaos_vs_truth_deg']} deg from the truth")
        if kill_equal is not None:
            check(kill_equal, "supervised segmented: the kill-only run differs from the "
                              "unkilled run")
        bf16[trainer] = sum(r["counts"]["tma"] for r in runs.values())
        del runs
    return bf16


def slice_churn(dev, card: str, work_dir: str) -> dict:
    """``bench.py --chaos-churn``'s two scenarios at mnist784's widths (d=784
    k=20 n=1024, bf16, 16 subspace iterations, on its planted data), m=10
    T=14, heartbeat 100 ms, round deadline 40 ms, quorum floor 0.5: a churn
    fit (30% crash-killed at step 3, two rejoin, one flaps, one persistent
    straggler past the deadline) and a quorum loss (60% killed at step 4, a
    rejoiner thread, a checkpoint directory), each gated as the bench gates
    them, and each within 1 degree of the planted truth. Returns the Gram
    launches."""
    import tempfile
    import threading

    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.data.stream import block_stream
    from distributed_eigenspaces_tpu_torch.runtime.membership import (
        ElasticStream,
        MembershipTable,
    )
    from distributed_eigenspaces_tpu_torch.runtime.supervisor import supervised_fit
    from distributed_eigenspaces_tpu_torch.utils.faults import ChurnPlan
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    cfg = dett.PCAConfig(**CHURN_FIT)
    m, n, T = cfg.num_workers, cfg.rows_per_worker, cfg.num_steps
    spec = dett.planted_subspace(cfg.dim, **MNIST_DATA)
    data = spec.sample(torch.Generator(device=dev).manual_seed(1), m * n * T)
    gates: dict = {}

    def factory(table, churn, metrics):
        def make(start_row):
            raw = block_stream(data, num_workers=m, rows_per_worker=n,
                               start_row=start_row, device=dev)
            return ElasticStream(raw, table, cfg, churn=churn,
                                 first_step=start_row // (m * n) + 1, metrics=metrics,
                                 device=dev)

        return make

    # 1. churn fit: 30% loss, dead -> join rejoin, a flap, a straggler
    metrics1 = MetricsLogger()
    table1 = MembershipTable(m, heartbeat_timeout_ms=cfg.heartbeat_timeout_ms,
                             min_quorum_frac=cfg.min_quorum_frac, metrics=metrics1)
    metrics1.attach_membership(table1)
    zero_counts()
    t0 = time.perf_counter()
    w1, st1, _ = supervised_fit(factory(table1, ChurnPlan(**CHURN_PLAN), metrics1), cfg,
                                metrics=metrics1, membership=table1, device=dev)
    torch.cuda.synchronize()
    churn_fit_s = time.perf_counter() - t0
    counts1 = read_counts()
    angle1 = basis_angle(w1, spec)
    ms = metrics1.summary()["membership"]
    rounds_closed = [r for r in metrics1.membership_records
                     if r["membership"] == "round_closed"]
    admit_t = {r["slot"]: r["t_mono"] for r in metrics1.membership_records
               if r["membership"] == "admit"}
    rejoined_contributes = 0 in admit_t and any(
        0 in r.get("arrived_slots", ()) and r["t_mono"] > admit_t[0] for r in rounds_closed)
    gates["churn_completed_all_steps"] = int(st1.step) == T
    gates["churn_angle_within_budget"] = angle1 <= 1.0
    gates["churn_no_deadlock"] = ms["rounds"] == T and churn_fit_s < 60.0
    gates["churn_straggler_folds_stale"] = ms["stale_folds"] >= 3
    gates["churn_deadline_closes_rounds"] = ms["deadline_closed"] >= 3
    gates["churn_deaths_detected"] = ms["by_kind"].get("dead", 0) >= 3
    gates["churn_rejoin_admitted"] = ms["by_kind"].get("admit", 0) >= 2
    gates["churn_rejoin_contributes_next_merge"] = rejoined_contributes
    gates["churn_flap_recovers"] = ms["by_kind"].get("recovered", 0) >= 1

    # 2. quorum loss: loud within 2x the heartbeat, resumed once they rejoin
    metrics2 = MetricsLogger()
    table2 = MembershipTable(m, heartbeat_timeout_ms=cfg.heartbeat_timeout_ms,
                             min_quorum_frac=cfg.min_quorum_frac, metrics=metrics2)
    metrics2.attach_membership(table2)
    killed = CHURN_QUORUM_KILLED

    def rejoiner():
        # an operator bringing capacity back: wait for the loud quorum loss,
        # then rejoin slots as their leases run out (bench.py:2132-2147)
        deadline = time.monotonic() + 30.0
        while table2.quorum_ok() and time.monotonic() < deadline:
            time.sleep(0.005)
        joined: set = set()
        while len(joined) < 4 and time.monotonic() < deadline:
            table2.sweep()
            for s in killed:
                if s not in joined and table2.state(s) == "dead":
                    table2.join(s)
                    joined.add(s)
            time.sleep(0.01)

    thread = threading.Thread(target=rejoiner, daemon=True)
    thread.start()
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="churn_ck_", dir=work_dir) as ck:
        w2, st2, sup2 = supervised_fit(
            factory(table2, ChurnPlan(kill_at={4: killed}), metrics2), cfg,
            metrics=metrics2, membership=table2, checkpoint_dir=ck, device=dev)
    torch.cuda.synchronize()
    quorum_fit_s = time.perf_counter() - t0
    counts2 = read_counts()
    thread.join(timeout=30.0)
    kinds2 = sup2.ledger.by_kind
    mrecs, frecs = list(metrics2.membership_records), list(metrics2.fault_records)

    def first_t(records, key, kind):
        return next((r["t_mono"] for r in records if r.get(key) == kind), None)

    t_kill = first_t(mrecs, "membership", "churn_kill")
    t_lost = first_t(mrecs, "membership", "quorum_lost")
    t_resume = next((r["t_mono"] for r in frecs if r.get("fault") == "resume"
                     and r.get("reason") == "quorum_restored"), None)
    quorum_detect_ms = (t_lost - t_kill) * 1e3 if None not in (t_kill, t_lost) else None
    churn_recovery_ms = (t_resume - t_lost) * 1e3 if None not in (t_lost, t_resume) else None
    angle2 = basis_angle(w2, spec)
    gates["quorum_lost_raised"] = kinds2.get("quorum_lost", 0) >= 1
    gates["quorum_detected_within_2x_heartbeat"] = (
        quorum_detect_ms is not None and quorum_detect_ms <= 2.0 * cfg.heartbeat_timeout_ms)
    gates["quorum_resumed_and_completed"] = (
        kinds2.get("quorum_restored", 0) >= 1 and int(st2.step) == T)
    gates["quorum_run_angle_within_budget"] = angle2 <= 1.0
    ms2 = metrics2.summary()["membership"]
    emit("slice_churn",
         config=f"bench.py --chaos-churn contract (heartbeat {cfg.heartbeat_timeout_ms} ms, "
                f"deadline {cfg.round_deadline_ms} ms, quorum {cfg.min_quorum_frac}, m={m}, "
                f"T={T}) at the mnist784 eval's widths (d={cfg.dim} k={cfg.k} n={n}, bf16, "
                f"{cfg.subspace_iters} subspace iterations, ns warm)",
         churn_plan=CHURN_PLAN, quorum_killed=killed, gates=gates,
         churn_recovery_ms=churn_recovery_ms, quorum_detect_ms=quorum_detect_ms,
         stale_folds=ms["stale_folds"], deadline_closed=ms["deadline_closed"],
         membership_by_kind=ms["by_kind"], arrival_hist=ms.get("arrival_hist"),
         quorum_membership_by_kind=ms2["by_kind"], quorum_ledger=kinds2,
         churn_angle_deg=angle1, quorum_angle_deg=angle2, churn_fit_s=churn_fit_s,
         quorum_fit_s=quorum_fit_s, gram_launches={"churn": counts1, "quorum": counts2},
         gram_launches_predicted={"churn": 1, "quorum": 2}, card=card)
    for name, ok in gates.items():
        check(ok, f"churn: gate {name} failed")
    check((counts1["tma"], counts1["s8"]) == (1, 0) and counts1["gram"] == 1,
          f"churn: Gram launches {counts1}, the route predicts one bf16 TMA launch")
    check((counts2["tma"], counts2["s8"]) == (2, 0) and counts2["gram"] == 2,
          f"churn: Gram launches {counts2}, the route predicts two (a cold round a "
          "process start)")
    return {"churn": counts1["tma"], "quorum": counts2["tma"]}


def slice_dynamic_round(dev, card: str, spec, data) -> int:
    """``run_dynamic_round`` on the cifar10 eval's first 16,384 rows (fp32,
    d=3072): 16 batches, k=10 by the spec's solver and cold iterations, two
    lanes, a fault hook raising ``OSError`` once at tasks 3 and 11, against
    one lane with no faults. Each batch's Gram is the fp32 kernel at (1,
    1024, 3072); the retried tasks fail before it. Returns its launches."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.runtime.scheduler import run_dynamic_round

    rows = data[:DYN_ROWS].float().cpu().numpy()
    kw = dict(num_batches=DYN_BATCHES, k=EVAL_FIT["k"], solver=EVAL_FIT["solver"],
              subspace_iters=EVAL_FIT["subspace_iters"], device=dev)
    fired: list = []

    def hook(task):
        if task in DYN_FAULT_TASKS and task not in fired:
            fired.append(task)
            raise OSError(f"chaos: lane crash at task {task}")

    zero_counts()
    (sigma, v), secs = synced_s(lambda: run_dynamic_round(
        rows, num_lanes=DYN_LANES, fault_hook=hook, **kw))
    counts = read_counts()
    (sigma1, v1), secs1 = synced_s(lambda: run_dynamic_round(rows, num_lanes=1, **kw))
    rel = rel_err(sigma, sigma1)
    lane_deg = float(principal_angles_degrees(v.cpu(), v1.cpu()).max())
    truth_deg = basis_angle(v, spec)
    emit("slice_dynamic_round",
         config=f"the cifar10 eval's first {DYN_ROWS} rows (d={rows.shape[1]}, fp32), "
                f"{DYN_BATCHES} batches, k={kw['k']}, solver {kw['solver']} at "
                f"{kw['subspace_iters']} iterations, {DYN_LANES} lanes",
         fault_tasks=list(DYN_FAULT_TASKS), retries=len(fired),
         sigma_rel_frobenius_vs_one_lane=rel, basis_vs_one_lane_deg=lane_deg,
         basis_vs_truth_deg=truth_deg, seconds=secs, one_lane_seconds=secs1,
         gram_launches=counts, gram_launches_predicted=DYN_BATCHES,
         gram_kernel=gram_mod.gram_launch(*DYN_GRAM, torch.float32).kernel,
         finite=bool(torch.isfinite(sigma).all() and torch.isfinite(v).all()), card=card)
    check(bool(torch.isfinite(sigma).all() and torch.isfinite(v).all()),
          "dynamic round: not finite")
    check(sorted(fired) == list(DYN_FAULT_TASKS), f"dynamic round: {len(fired)} retries")
    check(rel <= DYN_SIGMA_REL, f"dynamic round: sigma_bar {rel} from one lane")
    check(lane_deg <= DYN_LANE_DEG, f"dynamic round: basis {lane_deg} deg from one lane")
    check(truth_deg <= 1.0, f"dynamic round: basis {truth_deg} deg from the truth")
    check((counts["gram"], counts["tma"], counts["s8"]) == (DYN_BATCHES, 0, 0),
          f"dynamic round: Gram launches {counts}, want {DYN_BATCHES} fp32 launches")
    return counts["gram"]


# the scenario layer (runtime/scenario.py, tiers.py, population.py,
# controller.py): the committed specs replayed at mnist784's feature width,
# the widths added to each spec's own config block in memory (load_spec's
# override path); everything else (episodes, rates, SLOs, seeds) the spec's
SCENARIO_WIDTHS = dict(dim=MNIST_FIT["dim"], num_workers=8, rows_per_worker=1024,
                       num_steps=20)
SCENARIO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios")
# one churn episode on the host tier of a (chip 2, host 2) tree, m=4 workers
TIER_SPEC = {
    "name": "tier_churn", "seed": 13, "slo_p99_ms": 500.0,
    "config": {"merge_topology": [["chip", 2], ["host", 2]], **SCENARIO_WIDTHS,
               "num_workers": 4},
    "episodes": [
        {"name": "steady_load", "kind": "steady", "start_s": 0.0, "duration_s": 1.5,
         "qps": 10},
        {"name": "host_loss", "kind": "churn", "start_s": 0.1, "duration_s": 1.0,
         "workers": 4, "kill_slots": [1], "kill_step": 2, "rejoin_step": 6, "steps": 10,
         "tier": "host", "publish": True},
    ],
}
# the replays' fp32 Gram and fp32 serve shapes at those widths: the fit's
# (8, 1024, 784), tier_churn's fit (4, 1024, 784) and a churn fit's or a
# two-tenant bucket's (4, 8, 784); buckets of 8, 16 and 32 query rows
# against k=3
SCENARIO_GRAMS = tuple((m, n, SCENARIO_WIDTHS["dim"])
                       for m, n in ((8, 1024), (4, 1024), (4, 8)))
SCENARIO_SERVE = tuple((rows, SCENARIO_WIDTHS["dim"], 3) for rows in (8, 16, 32))
# bench.py --controller's seeded bad plan (bench.py:3277-3281) and lineage
CONTROLLER_BAD_PLAN = {"schema": "plan-v1", "plan_id": "plan-seeded-bad",
                       "chosen": {"config_overrides": {"serve_flush_s": 2.0}}}
CONTROLLER_LINEAGE = {"action": ("knob", "trigger", "from", "to"),
                      "rollback": ("knob", "trigger", "from", "to"),
                      "commit": ("knob", "trigger", "to")}
# bench.py --population (bench.py:2241-2256, 2299-2310): the acceptance shape
POP_BENCH = dict(dim=64, k=4, num_workers=8, rows_per_worker=16, num_steps=12,
                 backend="local", heartbeat_timeout_ms=100.0, population=100_000,
                 cohort_size=256, min_participation_frac=0.5, max_poison_frac=0.08)
POP_SCALED = dict(dropout_frac=0.30, dropout_waves={4: 0.9}, straggler_frac=0.03,
                  nan_frac=0.01, poison_frac=0.05, poison_scale=3.0)
POP_ORTH = dict(dropout_frac=0.30, straggler_frac=0.03, poison_frac=0.05, poison_scale=1.0)
# the real-data check's rows corpora, synthesized to disk
REAL_DATA_CONFIGS = ("clip768", "imagenet12288")
PLAIN_FNS = (("gram", "gram_plain"), ("gram", "gram_s8_plain"),
             ("serve_project", "serve_project_plain"),
             ("serve_project", "serve_project_i8_plain"),
             ("serve_project", "serve_project_f32_plain"))


def widened_spec(name: str, extra: dict | None = None) -> dict:
    """A committed spec with the card's widths added to its ``config``
    block (an in-memory copy; the file is not touched)."""
    with open(os.path.join(SCENARIO_DIR, f"{name}.json")) as f:
        raw = json.load(f)
    raw["config"] = {**raw.get("config", {}), **SCENARIO_WIDTHS, **(extra or {})}
    return raw


def zero_serve_counts() -> None:
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    sp.launches = sp.launches_i8 = sp.launches_f32 = 0


def kernel_counts() -> dict:
    """The Gram counters by variant (fp32 is every ``gram_cuda`` launch that
    is not bf16) and the serve counters."""
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

    return {"gram": gram_mod.launches, "gram_bf16_tma": gram_mod.launches_tma,
            "gram_s8": gram_mod.launches_s8, "serve_f32": sp.launches_f32,
            "serve_bf16": sp.launches, "serve_i8": sp.launches_i8}


def counted_plain(calls: list):
    """Wrap every plain version of the serve and Gram kernels so that a call
    lands in ``calls``; returns the undo. On the card a plain call means a
    tensor reached the CPU."""
    import importlib

    saved = []
    for mod_name, fn_name in PLAIN_FNS:
        mod = importlib.import_module(f"distributed_eigenspaces_tpu_torch.ops.{mod_name}")
        fn = getattr(mod, fn_name)

        def wrapped(*a, _fn=fn, _name=fn_name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        setattr(mod, fn_name, wrapped)
        saved.append((mod, fn_name, fn))

    def undo():
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)

    return undo


def counted_replay(dev, raw: dict, **kw) -> dict:
    """One ``run_scenario`` on the card with every launch counter set to 0
    just before and read just after, and every plain-version call counted."""
    from distributed_eigenspaces_tpu_torch.runtime.scenario import load_spec, run_scenario

    spec = load_spec(raw)
    plain: list = []
    undo = counted_plain(plain)
    zero_counts()
    zero_serve_counts()
    t0 = time.perf_counter()
    try:
        verdict, ok = run_scenario(spec, device=dev, **kw)
    finally:
        undo()
    seconds = time.perf_counter() - t0
    counts = kernel_counts()
    return {"verdict": verdict, "ok": ok, "counts": counts, "plain": plain,
            "seconds": seconds, "spec": spec}


def replay_record(run: dict) -> dict:
    """What a phase line prints of one replay: the gates, per-episode
    attainment and recovery, p99 with its decomposition, the launches."""
    v = run["verdict"]
    serve_slo = (v.get("slo") or {}).get("serve") or {}
    return {
        "scenario": v["scenario"], "ok": run["ok"], "gates": v["gates"],
        "attainment": v.get("value"), "p99_ms": serve_slo.get("p99_ms"),
        "burn": serve_slo.get("burn"),
        "latency_decomposition": v["serving"].get("latency_decomposition"),
        "episodes": {name: {"attainment": (ep.get("slo") or {}).get("attainment"),
                            "requests": ep.get("requests"), "p99_ms": ep.get("p99_ms"),
                            "recovered": ep.get("recovered"),
                            "recovery_ms": ep.get("recovery_ms")}
                     for name, ep in v["episodes"].items()},
        "replay": v["replay"], "drift_refreshes": v["serving"].get("drift_refreshes"),
        "launches": run["counts"], "plain_calls": len(run["plain"]),
        "seconds": run["seconds"],
    }


def check_replay(run: dict, what: str) -> None:
    """A replay's hard gates, and the hand kernels on its path: one fp32
    serve launch and one Gram launch at least, no plain version."""
    c, v = run["counts"], run["verdict"]
    check(run["ok"] and all(v["gates"].values()),
          f"{what}: gates failed {v.get('scenario_fail')}; churn {v.get('churn')}, "
          f"membership {v.get('membership')}")
    check(c["serve_f32"] >= 1, f"{what}: no fp32 serve kernel launch ({c})")
    check(c["gram"] + c["gram_s8"] >= 1, f"{what}: no Gram kernel launch ({c})")
    check(not run["plain"], f"{what}: plain versions called on the card: "
                            f"{sorted(set(run['plain']))}")


def slice_scenario(dev, card: str) -> dict:
    """``ci_smoke`` and ``production_day`` at mnist784's feature width (d=784,
    m=8, n=1024, T=20, the specs' k=3), then an in-memory spec whose churn
    episode kills a host of a (chip 2, host 2) tree (m=4): each replay's
    gates, per-episode attainment, p99 and its decomposition, the publisher
    failover and replica convergence, the population rounds and the churn
    fits; each replay launching the fp32 serve kernel and a Gram kernel and
    no plain version. Returns the launches by replay."""
    from distributed_eigenspaces_tpu_torch.runtime import tiers

    out = {}
    for name in ("ci_smoke", "production_day"):
        run = counted_replay(dev, widened_spec(name))
        v = run["verdict"]
        extra = {}
        if name == "production_day":
            extra = {"replication": v["replication"],
                     "publisher_failovers": v["replay"]["publisher_failovers"],
                     "replicas_converged": v["gates"].get("hotfix_push_replicas_converged"),
                     "population": v["population"], "population_fits": v["population_fits"],
                     "fleet": v["fleet"]}
        emit("slice_scenario", spec=name, widths=SCENARIO_WIDTHS, **replay_record(run),
             churn=v["churn"], membership=v["membership"], **extra, card=card)
        check_replay(run, f"scenario {name}")
        if name == "production_day":
            check(v["replay"]["publisher_failovers"] == 1,
                  f"scenario {name}: {v['replay']['publisher_failovers']} failovers")
        out[name] = run["counts"]
    # the host tier: TierSet / TieredStream under the churn fit
    rounds: list = []
    begin = tiers.TierSet.begin_round

    def recorded(self, step):
        info = begin(self, step)
        rounds.append({"step": step, **{t: i["effective"].tolist() for t, i in info.items()}})
        return info

    tiers.TierSet.begin_round = recorded
    try:
        run = counted_replay(dev, json.loads(json.dumps(TIER_SPEC)))
    finally:
        tiers.TierSet.begin_round = begin
    masked = [r["step"] for r in rounds if 0.0 in r["host"]]
    emit("slice_scenario", spec=TIER_SPEC["name"], widths=TIER_SPEC["config"],
         **replay_record(run), churn=run["verdict"]["churn"],
         membership=run["verdict"]["membership"], tier_rounds=len(rounds),
         host_masked_steps=masked, card=card)
    check_replay(run, "scenario tier_churn")
    check(len(rounds) >= 10 and masked, f"scenario tier_churn: tier rounds {rounds}")
    out[TIER_SPEC["name"]] = run["counts"]
    return out


def controller_lineage_ok(trail: list) -> bool:
    """Every knob decision carries its lineage: the fields of its kind plus
    ``plan_id`` and ``seq`` (bench.py:3296-3309)."""
    for ev in trail:
        fields = CONTROLLER_LINEAGE.get(ev.get("kind"))
        if fields is None:
            continue
        if "plan_id" not in ev or "seq" not in ev or any(f not in ev for f in fields):
            return False
    return True


def slice_controller(dev, card: str) -> dict:
    """``bench.py --controller`` (bench.py:3311-3390) on ``controller_day`` at
    mnist784's feature width: the replay with the autoscaler off, on, and on
    with the seeded bad plan (``serve_flush_s=2.0`` against a 150 ms SLO).
    Fails on the structural gates only: every arm's own hard gates, every
    decision lineage-stamped, the bad plan rolled back; the on-over-off
    attainment comparison is printed. Returns the launches by arm."""
    arms = {}
    for arm, kw in (("off", {}), ("on", {"controller": True}),
                    ("bad_plan", {"controller": True, "plan": CONTROLLER_BAD_PLAN})):
        arms[arm] = counted_replay(dev, widened_spec("controller_day"), **kw)
        emit("slice_controller", arm=arm, **replay_record(arms[arm]),
             controller=arms[arm]["verdict"].get("controller"), card=card)
    off, on, bad = (arms[a]["verdict"] for a in ("off", "on", "bad_plan"))
    on_trail = list((on.get("controller") or {}).get("events") or [])
    bad_trail = list((bad.get("controller") or {}).get("events") or [])
    rollbacks = [ev for ev in bad_trail if ev.get("kind") == "rollback"
                 and ev.get("plan_id") == CONTROLLER_BAD_PLAN["plan_id"]]
    att_off, att_on = off.get("value"), on.get("value")
    gates = {"off_arm_ok": arms["off"]["ok"], "on_arm_ok": arms["on"]["ok"],
             "bad_plan_arm_ok": arms["bad_plan"]["ok"],
             "actions_lineage_stamped": controller_lineage_ok(on_trail)
             and controller_lineage_ok(bad_trail),
             "bad_plan_rolled_back": bool(rollbacks)}
    on_ge_off = att_off is not None and att_on is not None and att_on >= att_off

    def episodes(v):
        return {name: (ep.get("slo") or {}).get("attainment")
                for name, ep in (v.get("episodes") or {}).items()}

    emit("slice_controller", arm="ab", metric="pca_controller_ab", scenario=off["scenario"],
         seed=off["seed"],
         value=att_on / max(att_off, 1e-9) if None not in (att_off, att_on) else None,
         unit="slo_attainment_ratio", attainment_off=att_off, attainment_on=att_on,
         on_attainment_ge_off=on_ge_off,
         p99_ms_off=((off.get("slo") or {}).get("serve") or {}).get("p99_ms"),
         p99_ms_on=((on.get("slo") or {}).get("serve") or {}).get("p99_ms"),
         episodes_off=episodes(off), episodes_on=episodes(on),
         bad_plan=CONTROLLER_BAD_PLAN, bad_plan_rollbacks=rollbacks,
         decisions_on=[(ev.get("kind"), ev.get("knob"), ev.get("trigger")) for ev in on_trail],
         decisions_bad_plan=[(ev.get("kind"), ev.get("knob"), ev.get("trigger"))
                             for ev in bad_trail],
         gates=gates, card=card)
    for arm, run in arms.items():
        check_replay(run, f"controller {arm}")
    for name, ok in gates.items():
        check(ok, f"controller: gate {name} failed")
    return {arm: run["counts"] for arm, run in arms.items()}


def slice_population(dev, card: str) -> dict:
    """``bench.py --population`` (bench.py:2259-2420) on the card: 100,000
    transient clients, cohorts of 256, d=64 k=4, 12 rounds. The hardened arm
    under scaled (x3) colluding poison, NaN submitters, 3% stragglers and a
    90% outage wave at round 4, the naive arm under the same plan, then both
    under orthonormal colluders (scale 1). Gates: hardened within 5 degrees
    and naive not; naive at least twice the hardened angle under orthonormal
    poison; every reject in the ledger with its client and reason, counts
    equal; the wave collapsing a round, waiting, resuming and every round
    completed. Prints each arm's wall seconds and the launch counters (no
    hand kernel is on this path)."""
    import numpy as np
    import torch
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.runtime.population import population_fit
    from distributed_eigenspaces_tpu_torch.utils.faults import ClientChaosPlan
    from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

    cfg = dett.PCAConfig(**POP_BENCH)
    rounds, budget = cfg.num_steps, POP_BUDGET_DEG

    def angle(w, planted):
        w = torch.from_numpy(np.ascontiguousarray(w))
        if not bool(torch.isfinite(w).all()):
            return float("nan")
        return float(principal_angles_degrees(w, torch.from_numpy(planted)).max())

    arms = {}
    zero_counts()
    zero_serve_counts()
    for arm, plan_kw, kw in (("hardened_scaled", POP_SCALED, {}),
                             ("naive_scaled", POP_SCALED, {"hardened": False}),
                             ("hardened_orth", POP_ORTH, {}),
                             ("naive_orth", POP_ORTH, {"hardened": False})):
        metrics = MetricsLogger()
        t0 = time.perf_counter()
        w, info, sup = population_fit(cfg, plan=ClientChaosPlan(**plan_kw), rounds=rounds,
                                      metrics=metrics, participation_wait_s=5.0, device=dev,
                                      **kw)
        torch.cuda.synchronize()
        arms[arm] = {"w": w, "info": info, "sup": sup, "seconds": time.perf_counter() - t0,
                     "summary": metrics.summary().get("population") or {},
                     "angle": angle(w, info["planted"])}
    counts = kernel_counts()
    h = arms["hardened_scaled"]
    quarantines = [e for e in h["sup"].ledger.events if e["kind"] == "quarantine_client"]
    reject_total = sum(h["info"]["rejects"].values())
    gates = {
        "hardened_within_budget": h["angle"] <= budget,
        "naive_exceeds_budget": not (arms["naive_scaled"]["angle"] <= budget),
        "orth_poison_hardened_within_budget": arms["hardened_orth"]["angle"] <= budget,
        "orth_poison_steers_naive_2x":
            arms["naive_orth"]["angle"] >= 2.0 * arms["hardened_orth"]["angle"],
        "every_reject_in_ledger_with_attribution":
            len(quarantines) == reject_total > 0
            and all("client" in e and "reason" in e for e in quarantines),
        "participation_lost_then_resumed":
            h["sup"].ledger.by_kind.get("participation_lost", 0) >= 1
            and h["info"]["resumes"] >= 1,
        "hardened_completed_all_rounds": h["info"]["rounds"] == rounds,
        "telemetry_covers_run": h["summary"].get("rounds") == rounds
        and bool(h["summary"].get("participation_hist"))
        and bool(h["summary"].get("rejects_by_reason")),
        "no_deadlock": all(a["seconds"] < 120.0 for a in arms.values()),
    }
    emit("slice_population",
         config="bench.py --population: population 100,000, cohort 256, d=64 k=4, "
                f"{rounds} rounds, max_poison_frac 0.08, min_participation_frac 0.5",
         angles_deg={a: r["angle"] for a, r in arms.items()},
         seconds={a: r["seconds"] for a, r in arms.items()},
         resumes=h["info"]["resumes"], rejects_by_reason=h["info"]["rejects"],
         ledger_quarantines=len(quarantines),
         participation_hist=h["summary"].get("participation_hist"),
         stale_folds=h["summary"].get("stale_folds"),
         ledger_by_kind=h["sup"].ledger.by_kind, gates=gates, launches=counts, card=card)
    for name, ok in gates.items():
        check(ok, f"population: gate {name} failed")
    return {a: r["seconds"] for a, r in arms.items()}


def slice_real_data(dev, card: str, work_dir: str) -> dict:
    """``scripts/torch_real_data_check.py --offline`` on the rows corpora
    (clip768, imagenet12288) synthesized to disk under ``work_dir``: exit 0,
    each report ``"data": "real"`` with ``"source": "synthesized-on-disk"``
    and the loader's ``data_source``, its angle within [0, 90], and the
    corpus's planted leading directions within the script's gate of the
    fitted span. Nothing is fetched. Returns its kernel launches."""
    import contextlib
    import importlib.util
    import io

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_real_data_check.py")
    spec = importlib.util.spec_from_file_location("torch_real_data_check", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    data_dir = os.path.join(work_dir, "real_data")
    out = io.StringIO()
    rcs, seconds = [], {}
    zero_counts()
    zero_serve_counts()
    for name in REAL_DATA_CONFIGS:  # one call a config: each one's wall seconds
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rcs.append(script.main([name, "--data-dir", data_dir, "--offline"]))
        seconds[name] = time.perf_counter() - t0
    counts = kernel_counts()
    reports = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    emit("slice_real_data", configs=list(REAL_DATA_CONFIGS), rcs=rcs, seconds=seconds,
         reports=[{k: r.get(k) for k in ("config", "dim", "k", "num_workers",
                                          "rows_per_worker", "steps", "backend", "trainer",
                                          "data", "source", "data_source",
                                          "principal_angle_deg", "reference_angles_deg",
                                          "samples_per_sec", "device")} for r in reports],
         launches=counts, card=card)
    check(rcs == [0] * len(REAL_DATA_CONFIGS), f"real_data: exit codes {rcs}")
    check([r["config"] for r in reports] == list(REAL_DATA_CONFIGS),
          f"real_data: reports {[r.get('config') for r in reports]}")
    for r in reports:
        check(r["data"] == "real" and r.get("source") == "synthesized-on-disk"
              and "data_source" in r, f"real_data: {r['config']} provenance {r}")
        check(0.0 <= r["principal_angle_deg"] <= 90.0,
              f"real_data: {r['config']} angle {r['principal_angle_deg']}")
        planted = r.get("reference_angles_deg", {}).get("planted_leading")
        check(planted is not None and planted <= script.PLANTED_GATE_DEG,
              f"real_data: {r['config']}'s planted leading {script.PLANTED_LEADING} "
              f"directions {planted} deg outside the fit")
    return counts


# -- the command line (distributed_eigenspaces_tpu_torch/cli.py) -------------------
# CIFAR-10's own size: five batches of 10,000 rows of 3072 bytes, written here
# in CIFAR's pickle format with two planted pixel patterns (a clean top-2)
CLI_CIFAR_BATCHES, CLI_CIFAR_ROWS = 5, 10_000
# the README's first command (README.md:117-118), --rgb (3072 wide)
CLI_README = ["--mode", "fit", "--rank", "2", "--workers", "10", "--steps", "10",
              "--metrics", "--rgb"]
CLI_README_DEG = 0.01  # its --save against the estimator's fit of the same rows


def _cli_spec_args(name: str) -> list:
    """An eval spec's widths and solver settings as CLI flags (the CLI has no
    --stage-dtype: its fits stage in the compute dtype)."""
    fit = spec_fit(name)
    return ["--dim", str(fit["dim"]), "--rank", str(fit["k"]),
            "--workers", str(fit["num_workers"]),
            "--rows-per-worker", str(fit["rows_per_worker"]),
            "--solver", fit["solver"], "--subspace-iters", str(fit["subspace_iters"]),
            "--warm-start-iters", str(fit["warm_start_iters"]),
            "--warm-orth-method", fit["warm_orth_method"],
            "--compute-dtype", fit["compute_dtype"]]


# --mode serve at the cifar10 eval's widths (d=3072, k=10, m=8, n=1024, T=20)
CLI_SERVE = (["--mode", "serve", "--data", "synthetic", "--steps", "20"]
             + _cli_spec_args("cifar10"))
# --mode fleet at mnist784's widths, 8 tenants; depth cut to 10 steps (the
# host staging of 8 tenants' rows is most of the run)
CLI_FLEET = (["--mode", "fleet", "--data", "synthetic", "--steps", "10", "--fleet-size", "8",
              "--prewarm"] + _cli_spec_args("mnist784"))
CLI_ONESHOT = ["--mode", "oneshot", "--data", "synthetic", "--dim", "3072", "--rank", "10",
               "--workers", "8", "--rows-per-worker", "1024", "--steps", "1"]
CLI_SERVE_DEG = 0.2  # bf16 / int8 served rows against fp32 (the serve budget)
#: the kernel wrappers slice_cli records the calls of, by module
CLI_WRAPPERS = (("gram", "gram_cuda"), ("gram", "gram_s8_cuda"),
                ("serve_project", "serve_project_cuda"),
                ("serve_project", "serve_project_i8_cuda"),
                ("serve_project", "serve_project_f32_cuda"),
                ("matvec_gram", "matvec_gram_cuda"))


def cli_cifar_dir(path: str) -> None:
    """CIFAR-10's five training batches at their own size, as pickles of
    uint8 rows: 128 plus two sign patterns (standard deviations 40 and 20
    grey levels) plus noise of 4, from numpy seed 11."""
    import pickle

    import numpy as np

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(11)
    signs = rng.choice(np.float32([-1.0, 1.0]), size=(2, 3072))
    for b in range(CLI_CIFAR_BATCHES):
        z = rng.standard_normal((CLI_CIFAR_ROWS, 2), dtype=np.float32) * np.float32([40, 20])
        x = 128.0 + z @ signs + 4.0 * rng.standard_normal((CLI_CIFAR_ROWS, 3072),
                                                         dtype=np.float32)
        batch = {b"data": np.clip(np.rint(x), 0, 255).astype(np.uint8),
                 b"filenames": [b"img_%d_%d.png" % (b, i) for i in range(CLI_CIFAR_ROWS)],
                 b"labels": [i % 10 for i in range(CLI_CIFAR_ROWS)]}
        with open(os.path.join(path, f"data_batch_{b + 1}"), "wb") as f:
            pickle.dump(batch, f)


def recorded_wrappers(calls: list):
    """Wrap every kernel wrapper of ``CLI_WRAPPERS`` so that each call lands
    in ``calls`` as ``(name, ((shape, dtype), ...))``; returns the undo."""
    import importlib

    import torch

    saved = []
    for mod_name, fn_name in CLI_WRAPPERS:
        mod = importlib.import_module(f"distributed_eigenspaces_tpu_torch.ops.{mod_name}")
        fn = getattr(mod, fn_name)

        def wrapped(*a, _fn=fn, _name=fn_name, **kw):
            calls.append((_name, tuple((tuple(t.shape), str(t.dtype)) for t in a
                                       if isinstance(t, torch.Tensor))))
            return _fn(*a, **kw)

        setattr(mod, fn_name, wrapped)
        saved.append((mod, fn_name, fn))

    def undo():
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)

    return undo


def cli_run(argv: list, what: str) -> tuple[int, dict | None, str]:
    """``cli.main(argv)`` in this process, its stdout and stderr captured:
    ``(exit code, the last JSON line of stdout, stderr)``."""
    import contextlib
    import io

    from distributed_eigenspaces_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    emit("slice_cli_run", run=what, argv=" ".join(argv), exit=rc,
         seconds=time.perf_counter() - t0)
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def cli_parity(dev, calls: list) -> dict:
    """Every distinct call the CLI runs made, held against the kernel's plain
    version on fresh operands of its shapes: the Gram calls here, the serve
    calls through ``parity_serve``. Returns the worst errors by route."""
    import torch
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod

    worst = {"gram_fp32": 0.0, "gram_bf16": 0.0, "gram_s8": 0.0}
    gen = torch.Generator(device=dev).manual_seed(19)
    for name, args in sorted(set(c for c in calls if c[0].startswith("gram"))):
        (shape, dtype), = args[:1]
        if name == "gram_s8_cuda":
            x = int8_block(shape, gen, dev)
            got, want = gram_mod.gram_s8_cuda(x), gram_mod.gram_s8_plain(x)
            route, tol = "gram_s8", 0.0  # exact int32 sums, as parity_gram_s8 holds
        else:
            x = torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype[6:]))
            got, want = gram_mod.gram_cuda(x), gram_mod.gram_plain(x)
            route = "gram_bf16" if x.dtype == torch.bfloat16 else "gram_fp32"
            tol = TOL[dtype[6:]]
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        err = float((got - want).abs().max().item())
        worst[route] = max(worst[route], err)
        emit("parity_cli_gram", kernel=name, shape=list(shape), dtype=dtype,
             rel_frobenius=rel, max_abs_err=err, tol=tol)
        check(rel <= tol, f"slice_cli: {name} {shape} {dtype}: {rel} > {tol}")
        del x, got, want
    # (rows, d, k) of each serve call: x is (rows, d), the basis (d, k)
    shapes = sorted({(*args[0][0], args[1][0][1]) for name, args in calls
                     if name.startswith("serve")})
    worst.update(parity_serve(dev, tuple(shapes), "parity_serve_cli"))
    check(not any(n == "matvec_gram_cuda" for n, _ in calls),
          "slice_cli: a fused sweep launched (no run here takes the distributed solve)")
    return worst


def slice_cli(dev, card: str, work_dir: str) -> dict:
    """The port's command line on the card at full width, ``cli.main`` in this
    process with the launch counters set to 0 just before each run and read
    just after: the README's first command on a CIFAR-10-size directory
    against the estimator's fit of the same rows; --mode serve at the
    cifar10 eval's widths in fp32, bf16 (through --registry-dir and
    --replicas 2) and int8; --mode fleet at mnist784's widths; --mode oneshot
    at d=3072; the refusals; then the cold/warm pair of processes over one
    fresh --compile-cache directory. Every kernel call of the in-process runs
    is held against its plain version at its shapes. Returns the launches by
    route and run."""
    import numpy as np
    import torch

    from distributed_eigenspaces_tpu_torch.api.estimator import OnlineDistributedPCA
    from distributed_eigenspaces_tpu_torch.config import PCAConfig
    from distributed_eigenspaces_tpu_torch.data.cifar import load_cifar10
    from distributed_eigenspaces_tpu_torch.data.synthetic import (
        planted_spectrum,
        sample_prefix_stable,
    )
    from distributed_eigenspaces_tpu_torch.ops import serve_project as sp
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    def deg(a, b) -> float:
        return float(principal_angles_degrees(torch.as_tensor(a).float().cpu(),
                                              torch.as_tensor(b).float().cpu()).max())

    launches: dict = {}
    calls: list = []

    def counted(argv, what):
        plain: list = []
        undo_plain, undo_rec = counted_plain(plain), recorded_wrappers(calls)
        zero_counts()
        zero_serve_counts()
        try:
            rc, out, err = cli_run(argv, what)
        finally:
            undo_rec()
            undo_plain()
        launches[what] = kernel_counts()
        check(not plain, f"slice_cli {what}: plain versions ran on the card: {plain}")
        return rc, out, err

    # 1. the README's first command on CIFAR-10-size batches
    cifar = os.path.join(work_dir, "cifar-10-batches-py")
    t0 = time.perf_counter()
    cli_cifar_dir(cifar)
    write_s = time.perf_counter() - t0
    readme_w = os.path.join(work_dir, "readme_w.npy")
    rc, out, _ = counted(CLI_README + ["--data", cifar, "--checkpoint-dir",
                                       os.path.join(work_dir, "ckpt"), "--save", readme_w],
                         "readme fit")
    check(rc == 0 and out["steps"] == 10, f"slice_cli readme fit: exit {rc}, {out}")
    rows, _ = load_cifar10(cifar, grayscale=False)
    cfg = PCAConfig(dim=3072, k=2, num_workers=10, rows_per_worker=len(rows) // 100,
                    num_steps=10)
    api_w = OnlineDistributedPCA(cfg, device=dev).fit(rows).components_
    readme_deg = deg(np.load(readme_w), api_w)
    emit("slice_cli", part="readme", rows=int(len(rows)), write_s=write_s,
         cli_vs_api_deg=readme_deg, tol=CLI_README_DEG, launches=launches["readme fit"],
         card=card)
    check(readme_deg <= CLI_README_DEG,
          f"slice_cli readme: {readme_deg} deg from the API fit > {CLI_README_DEG}")
    del rows, api_w

    # 2. --mode serve at the cifar10 eval's widths, one run a serve dtype
    spec_args = CLI_SERVE[CLI_SERVE.index("--dim"):]
    served = {}
    for dt in ("float32", "bfloat16", "int8"):
        argv = CLI_SERVE + ["--serve-dtype", dt,
                            "--save", os.path.join(work_dir, f"serve_{dt}.npy")]
        if dt == "bfloat16":
            argv += ["--registry-dir", os.path.join(work_dir, "registry"), "--replicas", "2"]
        if dt != "float32":  # a quantized engine's buckets launched before the burst
            argv += ["--prewarm"]
        rc, out, _ = counted(argv, f"serve {dt}")
        check(rc == 0 and out["max_abs_err_vs_direct"] == 0.0,
              f"slice_cli serve {dt}: exit {rc}, served vs direct "
              f"{out and out['max_abs_err_vs_direct']}")
        check(dt == "float32" or (out["compile_misses"] == 0
                                  and out["compile_stall_ms"] == 0.0),
              f"slice_cli serve {dt}: the prewarmed burst acquired {out['compile_misses']}")
        served[dt] = out
    v = torch.as_tensor(np.load(os.path.join(work_dir, "serve_float32.npy"))).to(dev)
    # the burst's rows (cli._serve_cli's queries), each dtype's direct
    # projection: the CLI's exit 0 says its served rows equal these bit for bit
    dim, steps = 3072, 20
    spec = planted_spectrum(dim, k_planted=10, gap=20.0, noise=0.01, seed=0)
    data = sample_prefix_stable(spec, 8 * 1024 * steps, seed=1, device=dev)
    q = torch.cat([data[(i * 8) % (len(data) - 8):][:8] for i in range(64)]).contiguous()
    del data
    z32 = sp.project_exact(q, v)
    angles = {}
    for dt in ("bfloat16", "int8"):
        vq = torch.as_tensor(np.load(os.path.join(work_dir, f"serve_{dt}.npy"))).to(dev)
        z = (sp.serve_project_auto(q, vq.contiguous()) if dt == "bfloat16"
             else sp.serve_project_i8_auto(q, *sp.quantize_basis_i8(vq.contiguous())))
        angles[dt] = float(row_angles_deg(z, z32).max())
    emit("slice_cli", part="serve", widths=" ".join(spec_args),
         runs={dt: {key: served[dt].get(key) for key in (
             "fit_seconds", "serve_seconds", "qps", "p50_latency_s", "p99_latency_s",
             "compile_misses", "compile_stall_ms", "principal_angle_deg", "replicas")}
             for dt in served},
         served_rows_vs_fp32_deg=angles, tol=CLI_SERVE_DEG,
         launches={dt: launches[f"serve {dt}"] for dt in served}, card=card)
    for dt, a in angles.items():
        check(a <= CLI_SERVE_DEG, f"slice_cli serve {dt}: rows {a} deg from fp32")
    check(served["bfloat16"]["replicas"] == 2, "slice_cli: the replicated run")
    check(launches["serve float32"]["serve_f32"] >= 8
          and launches["serve bfloat16"]["serve_bf16"] >= 8
          and launches["serve int8"]["serve_i8"] >= 8,
          f"slice_cli serve launches: {[launches[f'serve {d}'] for d in served]}")
    del q, z32, v

    # 3. --mode fleet at mnist784's widths and --mode oneshot at d=3072
    rc, out, _ = counted(CLI_FLEET, "fleet")
    check(rc == 0 and out["prewarmed"] is True and out["principal_angle_deg_max"] <= 1.0,
          f"slice_cli fleet: exit {rc}, {out}")
    emit("slice_cli", part="fleet", out=out, launches=launches["fleet"], card=card)
    rc, out, _ = counted(CLI_ONESHOT + ["--save", os.path.join(work_dir, "oneshot.npy")],
                         "oneshot")
    one_deg = deg(np.load(os.path.join(work_dir, "oneshot.npy")),
                  planted_spectrum(3072, k_planted=10, gap=20.0, noise=0.01,
                                   seed=0).top_k(10))
    emit("slice_cli", part="oneshot", out=out, planted_deg=one_deg,
         launches=launches["oneshot"], card=card)
    check(rc == 0 and one_deg <= 1.0, f"slice_cli oneshot: exit {rc}, {one_deg} deg")
    for what, c in launches.items():
        check(c["gram"] + c["gram_s8"] >= 1, f"slice_cli {what}: no Gram launch")

    # 4. the refusals
    for argv in (["--plan", "x"], ["--mode", "slave"]):
        rc, out, err = cli_run(argv, "refusal")
        check(rc == 2 and out is None, f"slice_cli {argv}: exit {rc}")

    # 5. every kernel call above against its plain version
    worst = cli_parity(dev, calls)

    # 6. the cold/warm pair: two processes, one fresh --compile-cache dir
    cache = os.path.join(work_dir, "compile_cache")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    pair = []
    for i in (1, 2):
        save = os.path.join(work_dir, f"cold_warm_{i}.npy")
        argv = [sys.executable, "-m", "distributed_eigenspaces_tpu_torch.cli", *CLI_SERVE,
                "--compile-cache", cache, "--prewarm", "--save", save]
        t_launch = time.time()
        proc = subprocess.run(argv, capture_output=True, text=True, cwd=root, env=env,
                              timeout=600)
        wall = time.time() - t_launch
        check(proc.returncode == 0, f"slice_cli process {i}: exit {proc.returncode}\n"
                                    f"{proc.stderr[-3000:]}")
        out = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
        [life] = [json.loads(ln)["compile_lifecycle"] for ln in proc.stderr.splitlines()
                  if ln.startswith('{"compile_lifecycle"')]
        pair.append({"out": out, "life": life, "wall_s": wall, "save": save,
                     "first_result_s": life["first_result_unix"] - t_launch})
    cold, warm = pair
    bit_equal = bool(np.array_equal(np.load(cold["save"]), np.load(warm["save"])))
    record = {
        name: {"first_result_s": p["first_result_s"], "process_wall_s": p["wall_s"],
               "nvcc_runs": p["life"]["nvcc_runs"], "nvcc_seconds": p["life"]["nvcc_seconds"],
               "fit_seconds": p["out"]["fit_seconds"],
               "compile_stall_ms": p["out"]["compile_stall_ms"],
               "compile_cache": p["out"]["compile_cache"], "prewarm": p["out"]["prewarm"]}
        for name, p in (("cold", cold), ("warm", warm))}
    print(f"slice_cli cold/warm pair: first served result {cold['first_result_s']:.3f} s "
          f"cold, {warm['first_result_s']:.3f} s warm ({card})", flush=True)
    emit("slice_cli", part="cold_warm", **record, components_bit_equal=bit_equal, card=card)
    check(cold["life"]["nvcc_runs"] >= 1, "slice_cli: the cold process built nothing")
    check(warm["life"]["nvcc_runs"] == 0, f"slice_cli: the warm process ran nvcc {warm['life']}")
    wcc = warm["out"]["compile_cache"]
    check(wcc["disk_hits"] >= 1 and wcc["misses"] == 0 and wcc["fallbacks"] == 0,
          f"slice_cli: the warm process's cache {wcc}")
    check(warm["out"]["compile_stall_ms"] == 0.0 and warm["out"]["compile_misses"] == 0,
          "slice_cli: the warm process's first request stalled")
    check(bit_equal, "slice_cli: the warm process's components differ from the cold one's")
    return {"launches": launches, "worst": worst}


#: slice_plan's cuts: the plan's workload (k, m, n) and knobs, for the fit
#: and for the serve run's fit, at the cifar10 eval's solver flags (the plan
#: names no solver; the CLI's default eigh route solves a d x d Gram a
#: worker) and one merge interval of steps (at least PLAN_STEPS), at d=3072
#: (the cifar10 eval's width) instead of the plan's 32768: the CLI's
#: synthetic source draws a d x d Haar basis on the host (numpy QR,
#: O(d^3): 29 s at d=8192 on one CPU core, ~30 min extrapolated at
#: 32768), the per-step route ends on a dense d x d eigh, and at d >= 4096
#: the auto backend (feature_sharded) refuses the plan's merge_topology
PLAN_STEPS = 2
PLAN_CUT_D = 3072
PLAN_DRIFT_FAIL = ("fail", "missing")  # the reference gate's failing rows


def plan_calibrate_module():
    """``scripts/torch_plan_calibrate.py`` as a module (its cheap terms)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_plan_calibrate.py")
    spec = importlib.util.spec_from_file_location("torch_plan_calibrate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def slice_plan(dev, card: str, work_dir: str) -> dict:
    """The planner on the card: the committed ``ANALYSIS_PLAN_TORCH.json``
    re-checked (``self_check``, and a replan from the committed calibration
    equal to it), then the command line with ``--plan`` on a fit and on a
    short fp32 serve at the plan's k, m, n and knobs (cut to PLAN_STEPS
    steps and d=PLAN_CUT_D; no --registry-dir, so the plan's replica count
    is not exercised), each
    with the launch counters set to 0 just before and read just after and
    every kernel call held against its plain version; then the cheap
    calibration terms re-measured (the serve kernel and the two p99s; the
    cold processes and the fit grid are the committed record's) and the
    plan's drift rows printed: a ``fail`` or ``missing`` row fails the
    phase. Returns the launches by run."""
    import torch

    from distributed_eigenspaces_tpu_torch.analysis import planner
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg

    t_phase = time.perf_counter()
    path = planner.plan_file_path()
    plan = planner.load_plan(path)
    check(plan is not None, f"slice_plan: no plan at {path}")
    viols = planner.self_check(plan)
    replan_drift = planner.check_plan(planner.make_plan(), plan)
    w = plan["workload"]
    over = plan["chosen"]["config_overrides"]
    # the run's copy of the plan: the same knobs and plan_id at PLAN_CUT_D
    cut = json.loads(json.dumps(plan))
    cut["workload"]["d"] = PLAN_CUT_D
    cut_viols = planner.self_check(cut)
    cut_path = os.path.join(work_dir, "plan_cut.json")
    with open(cut_path, "w", encoding="utf-8") as f:
        json.dump(cut, f)
    emit("slice_plan", part="plan", plan_id=plan["plan_id"], workload=w, overrides=over,
         predicted=plan["chosen"]["predicted"],
         self_check=[v.format() for v in viols],
         replan_drift=[v.format() for v in replan_drift],
         run_at={"d": PLAN_CUT_D, "steps": max(PLAN_STEPS, over.get("merge_interval") or 1)},
         card=card)
    check(not viols and not replan_drift and not cut_viols,
          "slice_plan: the committed plan fails its checks")

    launches: dict = {}
    calls: list = []

    def counted(argv, what):
        plain: list = []
        undo_plain, undo_rec = counted_plain(plain), recorded_wrappers(calls)
        zero_counts()
        zero_serve_counts()
        mg.launches = 0
        try:
            rc, out, err = cli_run(argv, what)
        finally:
            undo_rec()
            undo_plain()
        launches[what] = dict(kernel_counts(), matvec_gram=mg.launches)
        check(not plain, f"slice_plan {what}: plain versions ran on the card: {plain}")
        check(f"applied {plan['plan_id']}" in err,
              f"slice_plan {what}: no note line: {err[-400:]}")
        return rc, out

    steps = max(PLAN_STEPS, over.get("merge_interval") or 1)
    base = (["--plan", cut_path, "--data", "synthetic", "--steps", str(steps),
             "--device", "cuda"] + _cli_spec_args("cifar10")[8:])
    rc, fit = counted(["--mode", "fit"] + base, "fit")
    check(rc == 0 and fit is not None, f"slice_plan fit: exit {rc}")
    check((fit["dim"], fit["k"], fit["steps"]) == (PLAN_CUT_D, w["k"], steps)
          and fit["final_principal_angle_deg"] <= 1.0, f"slice_plan fit: {fit}")
    rc, served = counted(["--mode", "serve"] + base, "serve float32")
    check(rc == 0 and served is not None and served["max_abs_err_vs_direct"] == 0.0,
          f"slice_plan serve: exit {rc}, {served}")
    check(launches["serve float32"]["serve_f32"] >= 1,
          f"slice_plan serve: no fp32 serve launch {launches}")
    emit("slice_plan", part="cli", fit=fit, serve=served, launches=launches, card=card)

    # every recorded kernel call against its plain version at its shapes
    worst = cli_parity(dev, [c for c in calls if c[0] != "matvec_gram_cuda"])
    gen = torch.Generator(device=dev).manual_seed(20)
    for (c_shape, _), (v_shape, _) in sorted({c[1][:2] for c in calls
                                              if c[0] == "matvec_gram_cuda"}):
        c_op = torch.randn(c_shape, generator=gen, device=dev)
        v_op = torch.randn(v_shape, generator=gen, device=dev)
        got, want = mg.matvec_gram_cuda(c_op, v_op), mg.matvec_gram_plain(c_op, v_op)
        torch.cuda.synchronize()
        rel = max(rel_err(g, h) for g, h in zip(got, want))
        err = max(float((g - h).abs().max()) for g, h in zip(got, want))
        emit("parity_plan_matvec_gram", shape=[list(c_shape), list(v_shape)],
             rel_frobenius=rel, max_abs_err=err, tol=MG_TOL)
        check(rel <= MG_TOL, f"slice_plan: matvec_gram {c_shape} {v_shape}: {rel}")
        worst["matvec_gram"] = max(worst.get("matvec_gram", 0.0), err)

    # the cheap calibration terms again, and the plan's drift rows
    cal = plan_calibrate_module()
    with open(os.path.join(os.path.dirname(path), planner.CALIBRATION_RECORD),
              encoding="utf-8") as f:
        record = json.load(f)
    fresh = cal.measure_cheap(dev)
    record.update(fresh)
    with open(os.path.join(work_dir, planner.CALIBRATION_RECORD), "w", encoding="utf-8") as f:
        json.dump(record, f)
    rows = planner.drift_check(plan, root=work_dir)
    for row in rows:
        emit("slice_plan", part="drift", **row, card=card)
    bad = [r for r in rows if r["status"] in PLAN_DRIFT_FAIL]
    emit("slice_plan", part="summary", remeasured={k: v["value"] for k, v in fresh.items()},
         drift={r["anchor"]: r["status"] for r in rows}, worst_parity=worst,
         seconds=time.perf_counter() - t_phase, card=card)
    check(all(v["bit_exact_vs_direct"] for k, v in fresh.items() if k != "serve_kernel_ms"),
          "slice_plan: a calibration burst's answers differ from transform")
    check(rows and not bad, f"slice_plan: drift rows {bad or rows}")
    return {"launches": launches, "worst": worst}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributed_eigenspaces_tpu_torch as dett
    from distributed_eigenspaces_tpu_torch.ops import _build, geometry
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees

    dev = torch.device("cuda")

    # 1. env
    card = card_line()
    print(card, flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    check(torch.get_float32_matmul_precision() == "highest",
          "fp32 matmul precision is not 'highest'")
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], card=card,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # 2. build, every source at once
    t0 = time.perf_counter()
    sources = ("gram", "serve_project", "matvec_gram", "mutant_full_block", "gram_s8")
    _build.build_all(sources)
    for name in sources:
        _build.load(name)
    seconds = time.perf_counter() - t0
    for phase, name, source in (("build", "gram", GRAM_SOURCE),
                                ("build_serve", "serve_project", SERVE_SOURCE),
                                ("build_matvec_gram", "matvec_gram", MG_SOURCE),
                                ("build_mutant", "mutant_full_block", MUTANT_SOURCE),
                                ("build_s8", "gram_s8", S8_SOURCE)):
        info = _build.build_info[name]
        emit(phase, source=source, seconds=seconds, nvcc_seconds=info["seconds"],
             ptxas=ptxas_lines(info["log"]))

    # 3. parity on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = {}
    cases = [(shape, dtype, 0) for shape in (ENTRY, CIFAR, RAGGED)
             for dtype in ("float32", "bfloat16")]
    # bf16 that TMA cannot read takes the mma.sync kernel: d % 8 != 0, and
    # a base 2 bytes off a 16-byte boundary
    cases += [(GRAM_UNALIGNED_D, "bfloat16", 0), (RAGGED, "bfloat16", 1)]
    # a mesh rank's share of mnist784's block, the mesh path's bf16 Gram,
    # and a tiered-mesh rank's one leaf worker of the cifar10 shape
    cases += [(MESH_RANK_BLOCK, "bfloat16", 0), (TREE_RANK_BLOCK, "bfloat16", 0)]
    # the churn fit's cold round (10 workers of mnist784's block) and one
    # batch of the dynamic round (fp32)
    cases += [(CHURN_GRAM, "bfloat16", 0), (DYN_GRAM, "float32", 0)]
    # the scenario replays' fp32 Grams: the fit's block and a churn fit's or a
    # two-tenant bucket's
    cases += [(shape, "float32", 0) for shape in SCENARIO_GRAMS]
    cases += [(shape, "float32", offset) for shape, offset in F32_CASES]
    f32_kernels = set()
    for shape, dtype, offset in cases:
        numel = shape[0] * shape[1] * shape[2]
        flat = torch.randn(numel + offset, generator=gen, device=dev)
        x = flat.to(getattr(torch, dtype))[offset:].view(shape)
        del flat
        before = (gram_mod.launches, gram_mod.launches_tma)
        with geometry.recording() as rec:
            got = gram_mod.gram_cuda(x)
        torch.cuda.synchronize()
        aligned = x.data_ptr() % 16 == 0
        tma = gram_mod.takes_tma(shape[2], x.dtype, aligned)
        want_launch = gram_mod.gram_launch(*shape, x.dtype, aligned)
        check([r.kernel for r in rec] == [want_launch.kernel],
              f"gram {shape} {dtype} offset {offset}: recorded {[r.kernel for r in rec]}, "
              f"gram_launch says {want_launch.kernel}")
        if dtype == "float32":
            f32_kernels.add(want_launch.kernel)
        check(tma == (dtype == "bfloat16" and shape[2] % 8 == 0 and not offset),
              f"gram {shape} {dtype} offset {offset}: the shape rule says TMA: {tma}")
        check((gram_mod.launches, gram_mod.launches_tma) == (before[0] + 1, before[1] + tma),
              f"gram {shape} {dtype}: launch counters {before} did not move as the "
              f"shape rule says (TMA: {tma})")
        want = gram_mod.gram_plain(x)
        rel = rel_err(got, want)
        err = float((got - want).abs().max().item())
        max_abs[(shape, dtype, offset)] = err
        emit("parity", shape=list(shape), dtype=dtype, base_offset_elements=offset,
             kernel=rec[0].kernel, grid=list(rec[0].grid), rel_frobenius=rel,
             max_abs_err=err, tol=TOL[dtype], tma_kernel=tma,
             symmetric=bool(torch.equal(got, got.mT)))
        check(rel <= TOL[dtype], f"gram {shape} {dtype}: {rel} > {TOL[dtype]}")
        check(torch.equal(got, got.mT), f"gram {shape} {dtype} is not symmetric")
        del x, got, want
    want_f32 = {f"gram_f32_kernel<{t}, {v}>" for t in gram_mod.F_TILES for v in (4, 1)}
    check(f32_kernels == want_f32, f"fp32 parity took {sorted(f32_kernels)}, "
                                   f"want every instance {sorted(want_f32)}")

    # 4. timing
    timing = {}
    for shape, dtype in ((CIFAR, "bfloat16"), (CIFAR, "float32"), (ENTRY, "float32"),
                         (MESH_RANK_BLOCK, "bfloat16"), (TREE_RANK_BLOCK, "bfloat16")):
        x = torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
        ms = time_ms(lambda: gram_mod.gram_cuda(x))
        kernel_device_ms = device_ms(lambda: gram_mod.gram_cuda(x))
        plain_ms = time_ms(lambda: gram_mod.gram_plain(x))
        same_out_ms = library_ms = time_ms(lambda: torch.bmm(x.mT, x))
        library, same_out_note = "torch.bmm(x.mT, x)", None
        yardstick = lambda: torch.bmm(x.mT, x)  # noqa: E731
        if dtype == "bfloat16":  # bmm writes bf16 for bf16 x; the kernel fp32
            probe = bf16_out_fp32(torch.bmm, x.mT, x)
            if isinstance(probe, str):
                same_out_ms, same_out_note = None, probe
            else:
                yardstick = lambda: bf16_out_fp32(torch.bmm, x.mT, x)  # noqa: E731
                same_out_ms = time_ms(yardstick)
                library = "torch.bmm(x.mT, x, out_dtype=torch.float32)"
            del probe
        library_device_ms = device_ms(yardstick, launches=None)
        bound_ms, bound_by = gram_bound(shape, dtype)
        timing[(shape, dtype)] = dict(
            ms=ms, device_ms=kernel_device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=same_out_ms if same_out_ms is not None else library_ms,
            library_device_ms=library_device_ms, library=library, bmm_ms=library_ms)
        emit("timing", shape=list(shape), dtype=dtype, kernel_ms=ms,
             kernel_device_ms=kernel_device_ms, plain_ms=plain_ms,
             library_ms=timing[(shape, dtype)]["library_ms"],
             library_device_ms=library_device_ms, library=library, bmm_ms=library_ms,
             bmm_fp32_out_ms=same_out_ms, bmm_fp32_out_note=same_out_note,
             bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
             device_roofline_share=bound_ms / kernel_device_ms, card=card)
        del x
    gram_geometry(dev, gen, CIFAR, "bfloat16", "gram_geometry", ("gram_bf16_tma_kernel",))
    for shape in (ENTRY, CIFAR):
        gram_geometry(dev, gen, shape, "float32", "gram_f32_geometry",
                      (gram_mod.gram_launch(*shape, torch.float32).kernel,))

    # 4b. the s8 Gram: parity, geometry, timing
    s8_err = parity_gram_s8(dev, gen)
    for shape in (CIFAR, (1, 1000, 9)):  # every instance of both kernels
        gram_geometry(dev, gen, shape, "int8", "gram_s8_geometry",
                      tuple(la.kernel for la in gram_mod.gram_s8_launch(*shape)))
    s8_timing = timing_gram_s8(dev, gen, card)

    # 5a. the flagship step, 10 rounds, against the same step on the CPU
    step, (state, x) = dett.entry()
    gram_mod.launches = 0
    for _ in range(10):
        state, v_bar = step(state, x)
    torch.cuda.synchronize()
    entry_launches = gram_mod.launches
    check(entry_launches == 10, f"entry: {entry_launches} Gram launches, want 10")
    check(state.step == 10 and bool(torch.isfinite(state.sigma_tilde).all()),
          "entry: state after 10 steps")
    cpu_step, (cpu_state, cpu_x) = dett.entry(device="cpu")
    cpu_state, cpu_v = cpu_step(cpu_state, cpu_x)
    gpu_state, gpu_v = step(dett.OnlineState.initial(256), x)
    sigma_err = float((gpu_state.sigma_tilde.cpu() - cpu_state.sigma_tilde).abs().max())
    v_angle = float(principal_angles_degrees(gpu_v.cpu(), cpu_v).max())
    emit("slice_entry", steps=10, gram_launches=entry_launches,
         sigma_vs_cpu_max_abs=sigma_err, v_bar_vs_cpu_deg=v_angle)
    check(sigma_err <= 1e-4 and v_angle <= 0.05, "entry: card and CPU steps disagree")

    # 5b. the CIFAR-10-shape fit on planted-spectrum data
    m, n, d = CIFAR
    k, T = 10, 20
    cfg = dett.PCAConfig(dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=T,
                         solver="subspace", subspace_iters=12, warm_start_iters=2,
                         compute_dtype="bfloat16")
    t0 = time.perf_counter()
    spec = dett.planted_spectrum(d, k_planted=k, seed=0)
    data = spec.sample(torch.Generator(device=dev).manual_seed(0), T * m * n)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    est = dett.OnlineDistributedPCA(cfg)
    gram_mod.launches = gram_mod.launches_tma = 0
    t0 = time.perf_counter()
    est.fit(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = gram_mod.launches
    check(fit_launches == 1, f"fit: {fit_launches} Gram launches, want 1")
    check(gram_mod.launches_tma == 1, "fit: the Gram launch did not take the TMA kernel")
    w = est.components_
    truth = torch.as_tensor(spec.top_k(k))
    angle = float(principal_angles_degrees(w.cpu(), truth).max())
    check(w.shape == (d, k) and bool(torch.isfinite(w).all()), "fit: components_")
    # a second fit, after the first has paid every library's start-up
    t0 = time.perf_counter()
    dett.OnlineDistributedPCA(cfg).fit(data)
    torch.cuda.synchronize()
    fit2_s = time.perf_counter() - t0
    samples = T * m * n
    emit("slice_fit", config="cifar10-shape planted, d=3072 k=10 m=8 n=1024 T=20 bf16",
         trainer=est.trainer_used_, gram_launches=fit_launches,
         max_angle_deg=angle, data_s=data_s, fit_s=fit_s,
         samples_per_s=samples / fit_s, second_fit_s=fit2_s,
         second_samples_per_s=samples / fit2_s, card=card)
    check(angle <= 1.0, f"fit angle {angle} > 1 degree")

    # 5c. the cifar10 and synthetic1024 evals' own settings: int8 stage, ns
    # warm rounds, one s8 call each
    s8_launches = sum(slice_fit_eval(dev, card, *ev) for ev in EVALS)

    # 5d.-5h. the whole-fit trainers: clip768's out-of-core segmented fit,
    # its kill and resume, and the cifar10 settings segmented, masked and on
    # the two steady-state knobs
    import tempfile

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build_dir) as work_dir:
        clip = slice_clip768(dev, card, work_dir)
        slice_clip768_resume(dev, card, work_dir, clip)
        eval_spec, eval_rows = eval_data(dev)
        s8_by_path = {"eval fits": s8_launches, "clip768": clip["s8_calls"],
                      "eval segmented": slice_fit_eval_segmented(dev, card, work_dir,
                                                                 eval_spec, eval_rows),
                      "eval masked": slice_fit_masked(dev, card, eval_spec, eval_rows)}
        slice_fit_interval(dev, card, eval_spec, eval_rows)
        # 5m. the hierarchical merge: the stacked tree in one process
        s8_by_path["tree eval (stacked tree)"] = slice_tree_eval(dev, card, eval_spec,
                                                                 eval_rows)
        # 5p. the solo fit as a one-tenant fleet program
        fleet_solo_tma = slice_fleet_solo(dev, card, eval_spec, eval_rows)
        # 5i.-5j. elastic k through a replica, and the drift loop
        grow = slice_grow(dev, card, work_dir, eval_spec, eval_rows)
        s8_by_path["grow fit"] = grow["s8"]
        drift = slice_drift(dev, card, grow.pop("est"), eval_spec)
        s8_by_path["drift refit (supervise=False)"] = drift["s8"]
        # 5t.-5v. supervised and elastic fits, and the master's dynamic round
        supervised = slice_supervised(dev, card, work_dir, eval_spec, eval_rows)
        dyn_launches = slice_dynamic_round(dev, card, eval_spec, eval_rows)
        churn = slice_churn(dev, card, work_dir)
        del clip, eval_rows
        # 5k.-5l. the worker mesh: mnist784 on one rank (the estimator in one
        # process, then a one-rank NCCL mesh), then on two ranks sharing the
        # card over gloo
        mesh_eval = slice_mesh_eval(dev, card, work_dir)
        s8_by_path.update(mesh_eval["s8"])
        ranks2 = slice_mesh_ranks2(dev, card, mesh_eval, work_dir)
        s8_by_path["mesh ranks2 (2 ranks, gloo)"] = ranks2["s8"]
        # 5n. the tier-local tree, the wire codecs, the ring and the
        # multi-host read on four ranks sharing the card
        tree4 = slice_tree_ranks4(dev, card, work_dir)
        # 5o.-5s. the multi-tenant fleet: 8 mnist784 tenants in one program,
        # the bucketed server and a published tenant, the cohort merge, and
        # the fleet and the cohort reduce on two gloo ranks
        fleet_eval = slice_fleet_eval(dev, card)
        fleet_server = slice_fleet_server(dev, card, fleet_eval)
        cohort = slice_clients(dev, card)
        fleet_ranks = slice_fleet_ranks2(dev, card, fleet_eval, cohort,
                                         fleet_server.pop("served"), work_dir)
        # 5w. the NaN guards (DET_CHECKIFY=1) on one device
        guards_phase = slice_guards(dev, card)
        bf16_by_path = {"slice_fit (cifar10 shape)": fit_launches, **mesh_eval["bf16"],
                        "mesh ranks2 bf16 (2 ranks, gloo)": ranks2["bf16"],
                        "tree ranks4 (4 ranks, gloo, 3 arms)": tree4["bf16"],
                        "fleet eval (8 tenants, one (64,1024,784) launch; then supervised)":
                            fleet_eval["tma"],
                        "slice_drift supervised refit (one cold round)": drift["tma"],
                        "slice_supervised step (clean, chaos: 2 process starts)":
                            supervised["step"],
                        "slice_supervised segmented (clean, chaos, kill-only)":
                            supervised["segmented"],
                        "slice_churn churn fit ((10,1024,784))": churn["churn"],
                        "slice_churn quorum loss (2 process starts)": churn["quorum"],
                        "fleet server (2 buckets of 8)": fleet_server["tma"],
                        "fleet solo (cifar10, trainer='fleet')": fleet_solo_tma,
                        "fleet ranks2 (2 ranks, gloo, (32,1024,784))": fleet_ranks["fit"],
                        "fleet ranks2 mesh server (2 ranks, one a rank a round)":
                            fleet_ranks["server"],
                        "fleet ranks2 guarded clean fit (2 ranks)": fleet_ranks["guards"],
                        "slice_guards (4 trainers: guards off, armed, after a CheckError)":
                            guards_phase["tma"]}
        fleet_gram = fleet_eval.pop("gram")
        timing[(FLEET_GRAM, "bfloat16")] = {key: fleet_gram[key] for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "bmm_ms")}
        max_abs[(FLEET_GRAM, "bfloat16", 0)] = fleet_gram["max_abs_err"]
        del mesh_eval, fleet_eval, cohort

    # 6.-8. the read path
    serve_err = parity_serve(dev)
    serve_timing = timing_serve(dev, card)
    serve_launches = slice_serve(est, spec, cfg, card)
    del est, spec, data
    serve_by_path = {route: {"slice_serve": n} for route, n in serve_launches.items()}
    for route, n in grow["serve"].items():
        serve_by_path[route]["slice_grow (k'=20, replica)"] = n
    serve_by_path["f32"]["slice_drift"] = drift["serve_f32"]
    serve_by_path["bf16"]["slice_fleet_server (tenant 0 published, k=20)"] = \
        fleet_server["serve_bf16"]

    # 9.-11. the large-d solver path
    mg_err = parity_matvec_gram(dev)
    mg_timing = timing_matvec_gram(dev, card)
    mg_launches, dsolve_w, dense = slice_dsolve(dev, card)
    # 11b. the same shape on the parallel-deflation lanes
    s8_by_path["deflation fit"] = slice_deflate(dev, card, dsolve_w)
    # 11c.-11e. the features axis: the serve kernels at its shard shapes,
    # imagenet12288 field for field in one process, then on two gloo ranks
    fs_serve_err = parity_serve(dev, FS_SHARD_SHAPES, "parity_serve_shards")
    fs_serve_timing = timing_serve(dev, card, FS_SHARD_SHAPES, "timing_serve_shards")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fs_", dir=build_dir) as work_dir:
        fs_one = slice_fs_eval(dev, card, work_dir, dense)
        del dense
        fs_serve = slice_fs_ranks2(dev, card, fs_one, work_dir)
    for route, dt in (("bf16", "bfloat16"), ("i8", "int8"), ("f32", "float32")):
        serve_by_path[route]["slice_fs_ranks2 (2 ranks, (rows, 6144, 50))"] = fs_serve[dt]
        serve_err[route] = max(serve_err[route], fs_serve_err[route])

    # 12.-14. the analyzer's kernel gate and its mutant
    mutant_err = parity_mutant(dev)
    mutant_timing = timing_mutant(dev, card)
    analysis_launches = analysis(dev, card)

    # 15. the eval harness on the six specs at full size
    for name, n in slice_evals(dev, card).items():
        s8_by_path[f"slice_evals {name} (run_eval, 3 repeats)"] = n

    # 16.-19. the scenario layer: the real-data check and the population A/B
    # (host numpy first, before the replays' threads), the replays at
    # mnist784's width and the autoscaler A/B; then the serve kernels at the
    # replays' buckets
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rd_", dir=build_dir) as work_dir:
        s8_by_path["slice_real_data (clip768, synthesized on disk)"] = \
            slice_real_data(dev, card, work_dir)["gram_s8"]
    slice_population(dev, card)
    f32_by_path = {"slice_entry (10 steps)": entry_launches,
                   "slice_dynamic_round (16 batches at (1,1024,3072))": dyn_launches}
    replays = {f"slice_scenario {name}": c for name, c in slice_scenario(dev, card).items()}
    replays.update({f"slice_controller controller_day {arm}": c
                    for arm, c in slice_controller(dev, card).items()})
    for path, c in replays.items():
        f32_by_path[path] = c["gram"] - c["gram_bf16_tma"]
        serve_by_path["f32"][path] = c["serve_f32"]
        if c["gram_bf16_tma"]:
            bf16_by_path[path] = c["gram_bf16_tma"]
    scenario_serve_err = parity_serve(dev, SCENARIO_SERVE, "parity_serve_scenario")
    for route, err in scenario_serve_err.items():
        serve_err[route] = max(serve_err[route], err)

    # 20. the command line: the README's command, the serve dtypes, the fleet,
    # the one-shot round and the cold/warm pair over one compile cache
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_", dir=build_dir) as work_dir:
        cli_phase = slice_cli(dev, card, work_dir)
    for what, c in cli_phase["launches"].items():
        path = f"slice_cli {what}"
        for by_path, n in ((f32_by_path, c["gram"] - c["gram_bf16_tma"]),
                           (bf16_by_path, c["gram_bf16_tma"]), (s8_by_path, c["gram_s8"])):
            if n:
                by_path[path] = n
        for route, key in (("f32", "serve_f32"), ("bf16", "serve_bf16"), ("i8", "serve_i8")):
            if c[key]:
                serve_by_path[route][path] = c[key]
    for route in ("bf16", "i8", "f32"):
        serve_err[route] = max(serve_err[route], cli_phase["worst"][route])

    # 21. the planner: the committed plan through the command line at its
    # widths, and the cheap calibration terms against its drift anchors
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_", dir=build_dir) as work_dir:
        plan_phase = slice_plan(dev, card, work_dir)
    for what, c in plan_phase["launches"].items():
        path = f"slice_plan {what}"
        for by_path, n in ((f32_by_path, c["gram"] - c["gram_bf16_tma"]),
                           (bf16_by_path, c["gram_bf16_tma"]), (s8_by_path, c["gram_s8"])):
            if n:
                by_path[path] = n
        if c["serve_f32"]:
            serve_by_path["f32"][path] = c["serve_f32"]
        mg_launches += c["matvec_gram"]
    for route in ("bf16", "i8", "f32"):
        serve_err[route] = max(serve_err[route], plan_phase["worst"][route])
    mg_err = max(mg_err, plan_phase["worst"].get("matvec_gram", 0.0))
    mesh_path = "analysis mesh programs (rank 0 of 4 gloo ranks)"
    for kernel, n in analysis_launches["mesh_kernels"].items():
        if kernel.startswith("gram_"):
            by_path = bf16_by_path if "tma" in kernel else f32_by_path
            by_path[mesh_path] = by_path.get(mesh_path, 0) + n
        elif is_f32_serve(kernel):
            serve_by_path["f32"][mesh_path] = serve_by_path["f32"].get(mesh_path, 0) + n

    def row(name, shape, dtype, launches, also=()):
        t = timing[(shape, dtype)]
        return {"name": name, "route": "cuda", "source": GRAM_SOURCE,
                "replaces": GRAM_REPLACES, "launches": launches,
                "max_abs_err": max_abs[(shape, dtype, 0)], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"],
                "library": t["library"], "bmm_ms": t["bmm_ms"], "shape": list(shape),
                "kernel": gram_mod.gram_launch(*shape, getattr(torch, dtype)).kernel,
                "at_shapes": [dict(timing[(other, dtype)], shape=list(other),
                                   max_abs_err=max_abs[(other, dtype, 0)]) for other in also]}

    def serve_row(name, route):
        t = serve_timing[(SERVE_BULK, route)]
        b = serve_timing[(SERVE_BURST, route)]
        return {"name": name, "route": "cuda", "source": SERVE_SOURCE,
                "replaces": SERVE_REPLACES.get(route, SERVE_F32_NOTE),
                "launches": sum(serve_by_path[route].values()),
                "launches_by_path": serve_by_path[route],
                "max_abs_err": serve_err[route], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": list(SERVE_BULK),
                "burst_shape": list(SERVE_BURST), "burst_ms": b["ms"],
                "burst_plain_ms": b["plain_ms"], "burst_bound_ms": b["bound_ms"],
                "burst_library_ms": b["library_ms"],
                "at_shapes": [dict(serve_timing[(shape, route)], shape=list(shape))
                              for shape in SERVE_SHAPES],
                "at_shard_shapes": [dict(fs_serve_timing[(shape, route)], shape=list(shape))
                                    for shape in FS_SHARD_SHAPES]}

    print(json.dumps({"kernels": [
        dict(row("gram_bf16", CIFAR, "bfloat16", sum(bf16_by_path.values()),
                 also=(MESH_RANK_BLOCK, TREE_RANK_BLOCK, FLEET_GRAM)),
             launches_by_path=bf16_by_path),
        dict(row("gram_fp32", ENTRY, "float32", sum(f32_by_path.values()),
                 also=(CIFAR,)),
             launches_by_path=f32_by_path),
        dict(s8_timing[CIFAR], name="gram_s8", route="cuda", source=S8_SOURCE,
             replaces=S8_REPLACES, replaces_note="no Pallas kernel: the XLA int32 einsum "
             "(ops/linalg.py:64-72), which gram_auto sends integer blocks to "
             "(ops/pallas_gram.py:427-431)",
             launches=sum(s8_by_path.values()), launches_by_path=s8_by_path,
             launches_note="s8 calls (each one transpose and one TMA launch): the two "
                           "eval fits, clip768's 10 steps, the eval settings segmented "
                           "and masked, the grow fit, the unsupervised drift refit "
                           "(the deflation fit streams at d=12288: none; the "
                           "supervised drift refit and the supervised and elastic "
                           "fits take float blocks: none), mnist784 on one "
                           "device and on a "
                           "one-rank NCCL mesh, and on two gloo ranks (one call each), "
                           "the eval harness's runs (slice_evals), and the real-data "
                           "check's clip768 run (slice_real_data)",
             max_abs_err=s8_err, shape=list(CIFAR),
             kernel=" + ".join(la.kernel for la in gram_mod.gram_s8_launch(*CIFAR)),
             kernels=[la.kernel for la in gram_mod.gram_s8_launch(*CIFAR)],
             at_shapes=[dict(s8_timing[shape], shape=list(shape))
                        for shape in (S8_SYNTH, S8_MNIST, S8_CLIP, MESH_RANK_BLOCK)]),
        serve_row("serve_project_bf16", "bf16"),
        serve_row("serve_project_i8", "i8"),
        serve_row("serve_project_f32", "f32"),
        {"name": "matvec_gram", "route": "cuda", "source": MG_SOURCE,
         "replaces": MG_REPLACES, "launches": mg_launches, "max_abs_err": mg_err,
         "ms": mg_timing["ms"], "plain_ms": mg_timing["plain_ms"],
         "bound_ms": mg_timing["bound_ms"], "bound_by": mg_timing["bound_by"],
         "library_ms": mg_timing["library_ms"], "device_ms": mg_timing["device_ms"],
         "library_device_ms": mg_timing["library_device_ms"], "shape": list(MG_SLICE)},
        {"name": "mutant_full_block", "route": "cuda", "source": MUTANT_SOURCE,
         "replaces": MUTANT_REPLACES,
         "launches": analysis_launches["mutant_full_block"],
         "max_abs_err": mutant_err, "ms": mutant_timing["ms"],
         "plain_ms": mutant_timing["plain_ms"], "bound_ms": mutant_timing["bound_ms"],
         "bound_by": mutant_timing["bound_by"],
         "library_ms": mutant_timing["library_ms"], "device_ms": mutant_timing["device_ms"],
         "library_device_ms": mutant_timing["library_device_ms"],
         "shape": list(MUTANT_AUDIT)},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
