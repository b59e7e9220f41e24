"""Evaluation harness for the six eval configs, on the card.

Counterpart of ``distributed_eigenspaces_tpu/evals.py``: the same
:class:`EvalSpec` fields and :data:`EVAL_SPECS` (field for field), the same
:func:`run_eval` report keys, plus a ``device`` block naming the card and
its power limit. Each eval runs end to end through the port's routes:

1. ``cifar10``        — CIFAR-10 RGB (3072-d), top-10 PCs
2. ``synthetic1024``  — planted-spectrum Gaussian, 1024-d, top-5
3. ``mnist784``       — MNIST-784 streaming, top-20, sharded over the
                        worker ranks of a ``torch.distributed`` group
4. ``imagenet12288``  — ImageNet 64x64 patches (12288-d), top-50,
                        feature-sharded (no d x d matrix materialized)
5. ``clip768``        — CLIP ViT-L embeddings (768-d), top-256, out-of-core
                        int8 row file, segmented whole fit
6. ``clip768_chip``   — config 5's shapes fed from the device (sketch)

Real datasets are used when found under ``data_dir`` (CIFAR pickles, MNIST
IDX, or a directory of ``.npy`` / ``.bin`` rows for configs 4 and 5);
otherwise a planted-subspace stand-in of identical shape is drawn on the
device and the report says so (``"data": "synthetic"``).

Every report carries throughput (samples/s folded into the online
estimate, the median of ``repeats`` fenced runs, with its IQR), accuracy
(the max principal angle in degrees to the planted or exact top-k) and a
roofline block (``utils/roofline.py``) against anchors measured on the
same card in the same process. Run it as::

    python -m distributed_eigenspaces_tpu_torch.evals [configs] [--steps N]

which prints one JSON line per config.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
import time
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    name: str
    dim: int
    k: int
    num_workers: int
    rows_per_worker: int
    steps: int
    solver: str = "subspace"
    subspace_iters: int = 12
    warm_start_iters: int | None = None
    #: orthonormalization for WARM solver rounds (None = orth default;
    #: "ns" = the latency-free Newton-Schulz steady state, warm-only)
    warm_orth_method: str | None = None
    compute_dtype: str | None = None
    backend: str = "local"  # "local" | "shard_map" | "feature_sharded"
    #: staging dtype for the in-memory configs (None = compute dtype;
    #: "int8" = the quantized steady state, PCAConfig.stage_dtype)
    stage_dtype: str | None = None
    streaming: str = "memory"  # "memory" | "bin" (out-of-core file)
    # on-disk dtype for "bin" streaming: "float32", or "int8" (symmetric
    # quantization with one global scale, shipped to the device unconverted:
    # the scale cancels in eigenvectors)
    bin_dtype: str = "float32"
    # "scan" (whole fit) | "step" (per-step loop) | "sketch" (the
    # feature-sharded whole fit with the Nystrom-sketch state) |
    # "segmented" (windowed whole fit, the out-of-core route)
    trainer: str = "scan"
    #: steady-state restructure knobs (PCAConfig.merge_interval /
    #: .pipeline_merge); the defaults keep every config on the plain fit
    merge_interval: int = 1
    pipeline_merge: bool = False
    description: str = ""

    def replace(self, **kw) -> "EvalSpec":
        return dataclasses.replace(self, **kw)


EVAL_SPECS: dict[str, EvalSpec] = {
    s.name: s
    for s in [
        EvalSpec("cifar10", dim=3072, k=10, num_workers=8,
                 rows_per_worker=1024, steps=20,
                 warm_start_iters=2, compute_dtype="bfloat16",
                 stage_dtype="int8", warm_orth_method="ns",
                 description="CIFAR-10 RGB, top-10 PCs (BASELINE config 1)"),
        EvalSpec("synthetic1024", dim=1024, k=5, num_workers=8,
                 rows_per_worker=2048, steps=20,
                 warm_start_iters=2, compute_dtype="bfloat16",
                 stage_dtype="int8", warm_orth_method="ns",
                 description="planted-spectrum 1024-d, top-5 (config 2)"),
        EvalSpec("mnist784", dim=784, k=20, num_workers=8,
                 rows_per_worker=1024, steps=20, subspace_iters=16,
                 warm_start_iters=2, compute_dtype="bfloat16",
                 stage_dtype="int8", warm_orth_method="ns",
                 backend="shard_map",
                 description="MNIST-784 streaming, top-20, 8-way shard "
                             "(config 3)"),
        EvalSpec("imagenet12288", dim=12288, k=50, num_workers=4,
                 rows_per_worker=2048, steps=10,
                 warm_start_iters=1, compute_dtype="bfloat16",
                 stage_dtype="int8",
                 backend="feature_sharded", trainer="sketch",
                 description="ImageNet 64x64 patches 12288-d, top-50, "
                             "feature-sharded (config 4)"),
        EvalSpec("clip768", dim=768, k=256, num_workers=8,
                 rows_per_worker=2048, steps=10, subspace_iters=8,
                 warm_start_iters=2, compute_dtype="bfloat16",
                 streaming="bin", bin_dtype="int8", trainer="segmented",
                 description="CLIP ViT-L 768-d embeddings, top-256, "
                             "out-of-core streaming (config 5)"),
        EvalSpec("clip768_chip", dim=768, k=256, num_workers=8,
                 rows_per_worker=2048, steps=10, subspace_iters=8,
                 warm_start_iters=2, compute_dtype="bfloat16",
                 backend="feature_sharded", trainer="sketch",
                 description="config 5 shapes device-fed (sketch): "
                             "chip-rate companion to clip768's "
                             "link-bound row"),
    ]
}


def eval_config(spec: EvalSpec, seed: int = 0):
    """The ``PCAConfig`` an eval fits with (the reference's ``run_eval``
    builds it field by field from the spec)."""
    from distributed_eigenspaces_tpu_torch.config import PCAConfig

    return PCAConfig(
        dim=spec.dim, k=spec.k, num_workers=spec.num_workers,
        rows_per_worker=spec.rows_per_worker, num_steps=spec.steps,
        solver=spec.solver, subspace_iters=spec.subspace_iters,
        warm_start_iters=spec.warm_start_iters,
        warm_orth_method=spec.warm_orth_method,
        compute_dtype=spec.compute_dtype,
        stage_dtype=spec.stage_dtype,
        backend=spec.backend,
        merge_interval=spec.merge_interval,
        pipeline_merge=spec.pipeline_merge,
        seed=seed,
    )


def synthetic_model(spec: EvalSpec, seed: int = 0) -> dict:
    """``planted_subspace`` arguments of an eval's synthetic stand-in: gap
    20 over a noise floor of 0.01, the decay chosen so the weakest planted
    direction still sits 100x above the noise (with the default 0.8 a
    top-256 config's tail would fall below it and the true subspace would
    be ill-defined)."""
    gap, noise = 20.0, 0.01
    decay = max(0.8, float((100.0 * noise / gap) ** (1.0 / max(spec.k - 1, 1))))
    return dict(k_planted=spec.k, gap=gap, decay=decay, noise=noise, seed=seed)


_ANCHOR_CACHE: dict[tuple, float] = {}
_HBM_CACHE: dict[tuple, tuple] = {}


def _device_key(device) -> str:
    """One name a device: ``"cuda"`` is the current card's ``"cuda:i"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _matmul_anchor(small: bool, device="cuda") -> float:
    """Per-process cache of the measured matmul anchor (one chain per size
    and device). ``small=True`` uses a tiny chain (shrunk runs: the number
    is reported, never asserted on)."""
    key = (small, _device_key(device))
    if key not in _ANCHOR_CACHE:
        from distributed_eigenspaces_tpu_torch.utils.roofline import (
            measure_matmul_anchor,
        )

        _ANCHOR_CACHE[key] = measure_matmul_anchor(
            size=256 if small else 4096, chain=10 if small else 100,
            device=device,
        )
    return _ANCHOR_CACHE[key]


def _hbm_anchor(small: bool, device="cuda"):
    """Per-process cache of the measured HBM streaming rate, the
    denominator of the bandwidth roofline. Returns ``(gbps_or_nan,
    probe_record)``; a probe whose every size failed its consistency check
    is not cached (the next eval measures again) and its record rides into
    the report."""
    key = (small, _device_key(device))
    if key not in _HBM_CACHE:
        from distributed_eigenspaces_tpu_torch.utils.roofline import (
            measure_hbm_anchor_probe,
        )

        out = measure_hbm_anchor_probe(small=small, device=device)
        if out["gb_per_sec"] is None:
            return float("nan"), out
        _HBM_CACHE[key] = (out["gb_per_sec"], out)
    return _HBM_CACHE[key]


def _real_data(spec: EvalSpec, data_dir: str | None):
    """Try to load the real dataset for this config; ``(None, None)`` ->
    synthetic stand-in. Returns ``(rows, provenance)``; the provenance
    lands in the report as ``data_source``.

    Configs 1 and 3 load their canonical formats (CIFAR pickles, MNIST
    IDX). Configs 4 and 5 ingest a user-supplied directory of ``.npy`` /
    flat ``.bin`` row files at ``{data_dir}/{config_name}/``
    (:func:`..data.npy_dir.load_rows_dir`), only the eval's worth of rows.
    A present corpus that fails to load raises: the report must never
    claim synthetic numbers came from the user's files."""
    if data_dir is None:
        return None, None
    try:
        if spec.name == "cifar10":
            from distributed_eigenspaces_tpu_torch.data.cifar import load_cifar10

            data, _ = load_cifar10(data_dir, grayscale=False)
            rows = np.asarray(data, np.float32).reshape(len(data), -1)
            return rows, {
                "dir": os.path.abspath(data_dir), "kind": "cifar10",
                "rows": int(len(rows)),
            }
        if spec.name == "mnist784":
            from distributed_eigenspaces_tpu_torch.data.mnist import load_mnist

            data, _ = load_mnist(data_dir)
            return data, {
                "dir": os.path.abspath(data_dir), "kind": "mnist",
                "rows": int(len(data)),
            }
    except (FileNotFoundError, ValueError, OSError):
        return None, None
    if spec.name in ("imagenet12288", "clip768"):
        from distributed_eigenspaces_tpu_torch.data.npy_dir import load_rows_dir

        sub = os.path.join(data_dir, spec.name)
        if not os.path.isdir(sub):
            return None, None
        needed = (
            spec.num_workers * spec.rows_per_worker * spec.steps
            + spec.num_workers * spec.rows_per_worker
        )
        return load_rows_dir(sub, spec.dim, max_rows=needed)
    return None, None


def exact_top_k(data: np.ndarray, k: int) -> np.ndarray:
    """Exact top-k eigenspace of the (uncentered) covariance in float64:
    the ground truth of evals on real data."""
    g = (data.T @ data) / len(data)
    _, v = np.linalg.eigh(g.astype(np.float64))
    return v[:, -k:][:, ::-1].astype(np.float32)


def device_block(device) -> dict:
    """The report's ``device`` block: the card's name, power limit and
    count (``nvidia-smi --query-gpu=name,power.limit``), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        smi = None
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(index),
        "power_limit": smi.rsplit(",", 1)[-1].strip() if smi else None,
        "nvidia_smi": smi,
        "count": torch.cuda.device_count(),
    }


def run_eval(
    name: str,
    *,
    data_dir: str | None = None,
    seed: int = 0,
    repeats: int | None = None,
    device="cuda",
    blocks=None,
    v0=None,
    **overrides: Any,
) -> dict:
    """Run one eval config end to end on ``device``; returns the JSON-able
    report.

    ``overrides`` patch any EvalSpec field (tests shrink ``dim`` /
    ``steps``; the card runs the specs as published).

    ``repeats``: timed-run repetitions; the report quotes the MEDIAN with
    the IQR. ``None`` = 3 on full-size runs, 1 on shrunk ones (steps < 10),
    whose throughput is never asserted on.

    ``blocks`` (the ``min(steps, 4)`` distinct ``(m, n, d)`` host blocks)
    and ``v0`` (the dense routes' ``(d, k)`` cold start) replace the draws
    the port makes itself, so a test can hand it the reference's own (torch
    cannot reproduce ``jax.random``); omitted, they change nothing. The
    feature-sharded routes draw their starts from ``seed``.
    """
    from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
    from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
    from distributed_eigenspaces_tpu_torch.data.synthetic import planted_subspace
    from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
    from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    dev = resolve_device(device)
    spec = EVAL_SPECS[name].replace(**overrides)
    m, n, d, k = spec.num_workers, spec.rows_per_worker, spec.dim, spec.k
    step_rows = m * n
    if repeats is None:
        repeats = 3 if spec.steps >= 10 else 1
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    n_distinct = min(spec.steps, 4)
    if blocks is not None and len(blocks) != n_distinct:
        raise ValueError(
            f"blocks: {len(blocks)} given, the eval cycles {n_distinct}"
        )

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    real, data_source = _real_data(spec, data_dir)
    if real is not None and (real.shape[1] != d or len(real) < step_rows):
        # wrong dimensionality (a grayscale CIFAR dir for the RGB config)
        # or fewer rows than one step needs: synthetic, not a crash
        real, data_source = None, None
    if real is not None:
        truth = exact_top_k(real, k)

        def sample_step():
            # a random window of the dataset
            hi = max(len(real) - step_rows, 1)
            i = int(torch.randint(0, hi, (1,), generator=gen, device=dev))
            return torch.from_numpy(np.array(real[i: i + step_rows], np.float32))

        data_kind = "real"
    else:
        # the low-rank planted model: O(d k) set-up, rows drawn on the device
        spectrum = planted_subspace(d, **synthetic_model(spec, seed))
        truth = np.asarray(spectrum.top_k(k))

        def sample_step():
            return spectrum.sample(gen, step_rows)

        data_kind = "synthetic"

    cfg = eval_config(spec, seed)

    # --- the mesh the chosen backend runs on ------------------------------
    mesh = None
    if spec.backend == "feature_sharded":
        # one process is the (1, 1) layout: the same code path, the rank-r
        # state instead of the d x d one
        mesh = pmesh.auto_feature_mesh(cfg, dev) or pmesh.local_mesh(dev)
    elif spec.backend == "shard_map" and pmesh.world_size() >= 2:
        workers = m
        while workers > 1 and (m % workers or workers > pmesh.world_size()):
            workers -= 1
        mesh = pmesh.make_mesh(num_workers=workers, device=dev)
    backend_used = spec.backend if mesh is not None else "local"
    if mesh is not None:
        dev = mesh.device

    # whole-fit trainers for the in-memory configs; the windowed whole fit
    # for the out-of-core one; the per-step loop otherwise
    use_whole_fit = spec.streaming == "memory" and (
        (spec.trainer == "scan"
         and backend_used in ("local", "shard_map", "feature_sharded"))
        or (spec.trainer == "sketch" and backend_used == "feature_sharded")
    )
    use_seg_bin = (
        spec.streaming == "bin"
        and spec.trainer == "segmented"
        and backend_used == "local"
    )
    trainer_used = spec.trainer if (use_whole_fit or use_seg_bin) else "step"

    def whole_rows(w):
        """The whole ``(d, k)`` basis from this rank's rows of it."""
        if mesh is None or mesh.shape.get(pmesh.FEATURE_AXIS, 1) == 1:
            return w
        with pmesh.mesh_scope(mesh):
            return pmesh.all_gather(w.contiguous(), pmesh.FEATURE_AXIS)

    from distributed_eigenspaces_tpu_torch.api.runner import extract_dense

    if backend_used == "feature_sharded":
        final_w = lambda st: whole_rows(st.u[:, :k])  # noqa: E731
        if not use_whole_fit:
            from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
                make_feature_sharded_step,
            )

            fstep = make_feature_sharded_step(cfg, mesh, device=dev,
                                              collectives=cfg.collectives)
            state = fstep.init_state()
            step_fn = fstep
    else:
        step_fn = make_train_step(
            cfg, mesh=mesh if backend_used == "shard_map" else None,
            device=dev, v0=v0,
        )
        state = OnlineState.initial(d, device=dev)
        final_w = lambda st: extract_dense(cfg, st.sigma_tilde, v0=v0)  # noqa: E731

    # --- stage data ------------------------------------------------------------
    if blocks is not None:
        host_blocks = [
            torch.from_numpy(np.array(b, np.float32)).reshape(m, n, d).to(dev)
            for b in blocks
        ]
    else:
        host_blocks = [
            sample_step().reshape(m, n, d).to(device=dev, dtype=torch.float32)
            for _ in range(n_distinct)
        ]

    bin_path = None
    if spec.streaming == "bin":
        fd, bin_path = tempfile.mkstemp(suffix=".bin")
        os.close(fd)
        host_np = [b.reshape(step_rows, d).cpu().numpy() for b in host_blocks]
        if spec.bin_dtype == "int8":
            # one global scale for the file (it cancels in eigenvectors);
            # the quantization noise is charged to the reported angle
            from distributed_eigenspaces_tpu_torch.runtime.native import (
                absmax_f32,
                quantize_i8,
            )

            qscale = 127.0 / max(max(absmax_f32(b) for b in host_np), 1e-30)
            host_np = [quantize_i8(b, qscale) for b in host_np]
        elif spec.bin_dtype != "float32":
            raise ValueError(f"unknown bin_dtype: {spec.bin_dtype!r}")
        host_bytes = [b.tobytes() for b in host_np]
        with open(bin_path, "wb") as f:
            for s in range(spec.steps):
                f.write(host_bytes[s % n_distinct])

    # one staging contract (data.stream.stage_blocks): int8 quantizes each
    # block with its own scale, on its device; a float stage casts
    from distributed_eigenspaces_tpu_torch.data.stream import stage_blocks

    stage_dtype = cfg.resolved_stage_dtype()

    def staged(blocks_):
        return [torch.as_tensor(b).to(dev) for b in stage_blocks(blocks_, stage_dtype)]

    if spec.streaming == "memory" and not (
        use_whole_fit and backend_used == "feature_sharded"
    ):
        # the distinct blocks staged on the device (cycled in the timed
        # runs): the number measures the device, not the host link; the
        # "bin" configs measure the whole out-of-core pipeline instead
        device_blocks = staged(host_blocks)

    # the throughput schedule: full-size whole fits run at least 240 steps,
    # so the fixed costs of a fit amortize; shrunk runs keep their steps
    timed_T = spec.steps if spec.steps < 10 else max(240, spec.steps)
    stage_ms = None  # per-stage pipeline breakdown (bin configs)
    pipeline_rps = None  # host-side (disk + convert) rows/s, bin configs
    bin_dt, bin_out = (
        (np.int8, torch.int8) if spec.bin_dtype == "int8"
        else (np.float32, torch.float32)
    )

    def timed_whole_fit(make_fit_at, init_state, call):
        """The whole-fit throughput method: build the fit at ``timed_T``,
        run it once outside the timed region (the libraries' start-up and
        any kernel build), then time ``repeats`` fenced runs and return
        their seconds. The reference's salted operands and rolled warm-up
        schedule defeated a result cache of its tunnelled backend; the card
        runs every launch, so the runs here are plain."""
        fit_t = make_fit_at(dataclasses.replace(cfg, num_steps=timed_T))
        idx_t = [t % n_distinct for t in range(timed_T)]
        call(fit_t, init_state(), idx_t)
        fence()
        out = []
        for _ in range(repeats):
            st = init_state()
            fence()
            t0 = time.perf_counter()
            call(fit_t, st, idx_t)
            fence()
            out.append(time.perf_counter() - t0)
        return out

    def stream():
        if spec.streaming == "bin":
            from distributed_eigenspaces_tpu_torch.data.bin_stream import (
                bin_block_stream,
            )
            from distributed_eigenspaces_tpu_torch.runtime.prefetch import (
                prefetch_stream,
            )

            yield from prefetch_stream(
                bin_block_stream(
                    bin_path, dim=d, num_workers=m, rows_per_worker=n,
                    num_steps=spec.steps, dtype=bin_dt, out_dtype=bin_out,
                ),
                device=dev,
            )
        else:
            for s in range(spec.steps):
                yield device_blocks[s % n_distinct]

    def disk_ms_a_step() -> float:
        """One pass over the row file by the native chunk reader, each
        chunk viewed in its dtype (the host's whole convert): ms a step."""
        from distributed_eigenspaces_tpu_torch.runtime.native import ChunkReader

        t0 = time.perf_counter()
        with ChunkReader(bin_path, step_rows * d * np.dtype(bin_dt).itemsize) as rd:
            for chunk in rd:
                np.frombuffer(chunk, dtype=bin_dt)
        return (time.perf_counter() - t0) / spec.steps * 1e3

    def h2d_ms_of(hb) -> float:
        """Host-to-device time of one step's block: two transfers, the
        faster (the first can pay one-off allocation). On the CPU the
        "transfer" is a copy in host memory."""
        hb = np.array(hb)  # writable, and outside the timed region
        best = float("inf")
        for _ in range(2):
            fence()
            t0 = time.perf_counter()
            torch.from_numpy(hb).to(dev, copy=True)
            fence()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    try:
        if use_whole_fit:
            # one whole-fit wiring for the three in-memory kinds: the dense
            # scan (staged gather), the feature-sharded rank-r scan and the
            # Nystrom sketch; the same handle fits the accuracy and the
            # timed runs
            from distributed_eigenspaces_tpu_torch.api.runner import make_whole_fit

            if backend_used == "feature_sharded":
                kind = "sketch" if trainer_used == "sketch" else "fs_scan"
                handle_mesh = mesh
            else:
                kind = "scan"
                handle_mesh = mesh if backend_used == "shard_map" else None

            def make_handle(c):
                if kind == "scan":
                    return make_whole_fit(c, kind, handle_mesh, gather=True,
                                          device=dev, v0=v0)
                return make_whole_fit(c, kind, handle_mesh, device=dev)

            handle = make_handle(cfg)
            if kind == "scan":
                stacked = torch.stack(device_blocks)
                del device_blocks  # the stack is the only staged copy
            else:
                # each rank keeps its share of the whole staged stack
                stacked = torch.stack(staged(host_blocks))
            final_w = lambda st: whole_rows(handle.extract(st))  # noqa: E731

            # accuracy run: exactly the spec's T-step workload
            idx = [t % n_distinct for t in range(spec.steps)]
            state = handle.fit(handle.init_state(), stacked, idx)
            fence()

            # throughput run: the same per-step workload, longer schedule
            dts = timed_whole_fit(
                make_handle,
                handle.init_state,
                lambda h, st, ix: h.fit(st, stacked, ix),
            )
            steps_run = spec.steps
            timed_steps = timed_T
        elif use_seg_bin:
            from distributed_eigenspaces_tpu_torch.api.runner import make_whole_fit
            from distributed_eigenspaces_tpu_torch.data.bin_stream import (
                bin_block_stream,
                window_stream,
            )
            from distributed_eigenspaces_tpu_torch.runtime.prefetch import (
                prefetch_stream,
            )

            seg = max(1, min(5, spec.steps))
            handle = make_whole_fit(cfg, "segmented", mesh=None, segment=seg,
                                    device=dev, v0=v0)
            fit_windows = handle.fit_windows
            init_state = handle.init_state

            # a pass outside the timed region: the libraries' start-up, the
            # kernels' build, the window shapes of the schedule
            dummy = torch.from_numpy(
                np.roll(host_np[0], 1, axis=0).reshape(m, n, d)).to(dev)
            full_w = torch.stack([dummy] * seg)
            shapes = [full_w] if spec.steps <= seg else [full_w, full_w]
            if spec.steps % seg and spec.steps > seg:
                shapes.append(full_w[: spec.steps % seg])
            fit_windows(init_state(), iter(shapes))
            fence()

            def bin_windows():
                yield from window_stream(
                    bin_block_stream(
                        bin_path, dim=d, num_workers=m, rows_per_worker=n,
                        num_steps=spec.steps, dtype=bin_dt, out_dtype=bin_out,
                    ),
                    seg,
                )

            # timed runs = the whole out-of-core pipeline: window t's steps
            # run while the prefetch thread reads, converts and ships
            # window t + 1; each repeat reads the file end to end
            dts = []
            for _ in range(repeats):
                st0 = init_state()
                fence()
                t0 = time.perf_counter()
                windows = prefetch_stream(bin_windows(), depth=1, device=dev)
                try:
                    state = fit_windows(st0, windows)
                finally:
                    windows.close()
                fence()
                dts.append(time.perf_counter() - t0)
            steps_run = int(state.step)
            timed_steps = steps_run

            # --- stage breakdown + link-saturation evidence -------------
            disk_ms = disk_ms_a_step()
            pipeline_rps = step_rows / (disk_ms / 1e3)
            h2d_ms = h2d_ms_of(np.frombuffer(
                host_bytes[1 % n_distinct], dtype=bin_dt).reshape(m, n, d))

            # one full-window program in isolation, on a fresh state
            dummy2 = torch.stack([torch.from_numpy(
                np.roll(host_np[0], 2, axis=0).reshape(m, n, d)).to(dev)] * seg)
            st2 = init_state()
            fence()
            t0 = time.perf_counter()
            fit_windows(st2, iter([dummy2]))
            fence()
            compute_ms = (time.perf_counter() - t0) * 1e3
            stage_ms = {
                "disk_read": round(disk_ms, 1),
                "host_to_device": round(h2d_ms, 1),
                "compute_dispatch_per_window": round(compute_ms, 1),
                "window_steps": seg,
            }
        else:
            # per-step warm start: thread the previous merged estimate back
            # into the solver (the feature-sharded step warm-starts from
            # its own carry)
            thread_v = (
                backend_used != "feature_sharded"
                and cfg.resolved_warm_start() is not None
            )
            # --- warm-up, outside the timed region ----------------------
            if spec.streaming == "bin":
                warm_blk = torch.from_numpy(np.array(
                    np.frombuffer(host_bytes[0], dtype=bin_dt).reshape(m, n, d)
                )).to(dev)
            else:
                warm_blk = staged(host_blocks[:1])[0]
            out = step_fn(state, warm_blk)
            if thread_v:
                step_fn(out[0], warm_blk, v_prev=out[1])
            fence()

            # --- timed runs -----------------------------------------------
            dts = []
            for _ in range(repeats):
                if backend_used == "feature_sharded":
                    state = fstep.init_state()
                else:
                    state = OnlineState.initial(d, device=dev)
                v_prev = None
                fence()
                t0 = time.perf_counter()
                steps_run = 0
                for x in stream():
                    state, v_bar = (
                        step_fn(state, x, v_prev=v_prev) if thread_v
                        else step_fn(state, x)
                    )
                    v_prev = v_bar if thread_v else None
                    steps_run += 1
                fence()
                dts.append(time.perf_counter() - t0)
            timed_steps = steps_run

            if spec.streaming == "bin":
                # per-stage breakdown of the out-of-core pipeline (each
                # stage alone; the pipelined run overlaps them)
                disk_ms = disk_ms_a_step()
                hb = np.array(np.frombuffer(
                    host_bytes[1 % n_distinct], dtype=bin_dt
                ).reshape(m, n, d))
                h2d_ms = h2d_ms_of(hb)
                xb = torch.from_numpy(hb).to(dev)
                # one step on a throwaway state
                st0 = (
                    fstep.init_state()
                    if backend_used == "feature_sharded"
                    else OnlineState.initial(d, device=dev)
                )
                fence()
                t0 = time.perf_counter()
                if thread_v and v_prev is not None:
                    step_fn(st0, xb, v_prev=v_prev)
                else:
                    step_fn(st0, xb)
                fence()
                compute_ms = (time.perf_counter() - t0) * 1e3
                stage_ms = {
                    "disk_read": round(disk_ms, 1),
                    "host_to_device": round(h2d_ms, 1),
                    "compute_dispatch": round(compute_ms, 1),
                }
                # the converts are views, so the disk pass is the host
                # pipeline's rate
                pipeline_rps = step_rows / (disk_ms / 1e3)
    finally:
        if bin_path is not None:
            os.unlink(bin_path)

    w = final_w(state)
    angle = float(principal_angles_degrees(
        w.detach().float().cpu(), torch.as_tensor(truth)).max())
    report_extra = {}
    # the headline samples/s is the median over the repeats, with the IQR
    # and the spread beside it
    dt = float(np.median(dts))
    samples_per_sec = timed_steps * step_rows / dt
    sps_all = sorted(timed_steps * step_rows / t for t in dts)
    report_extra["timing"] = {
        "n_repeats": len(dts),
        "seconds_median": round(dt, 4),
        "seconds_iqr": [
            round(float(q), 4) for q in np.percentile(dts, [25, 75])
        ],
        "samples_per_sec_iqr": [
            round(float(q), 1) for q in np.percentile(sps_all, [25, 75])
        ],
        "samples_per_sec_spread_pct": round(
            100.0 * (sps_all[-1] - sps_all[0]) / sps_all[-1], 2
        ) if len(sps_all) > 1 else 0.0,
    }
    if spec.streaming == "bin":
        report_extra["bin_dtype"] = spec.bin_dtype
        if stage_ms is not None:
            report_extra["stage_ms"] = stage_ms
        if stage_ms is not None and pipeline_rps is not None:
            # the throughput ceiling the measured host-to-device link
            # imposes (bytes a step over the link's rate), the achieved
            # share of it, and the host pipeline's own rate
            bytes_per_step = step_rows * d * (
                1 if spec.bin_dtype == "int8" else 4
            )
            h2d_s = stage_ms["host_to_device"] / 1e3
            link_bound_sps = step_rows / h2d_s if h2d_s > 0 else float("inf")
            report_extra.update({
                "bytes_per_step": bytes_per_step,
                "link_mb_per_sec": round(bytes_per_step / 1e6 / h2d_s, 1)
                if h2d_s > 0 else None,
                "link_bound_samples_per_sec": round(link_bound_sps, 1),
                "link_bound_fraction": round(
                    samples_per_sec / link_bound_sps, 3
                ),
                "pipeline_rows_per_sec": round(pipeline_rps, 1),
                "pipeline_ok": bool(pipeline_rps >= 1e5),
            })

    # roofline: model FLOPs and bytes (utils/roofline.py documents the
    # models) against the anchors measured on this device in this process
    from distributed_eigenspaces_tpu_torch.utils.roofline import (
        roofline_fields,
        step_byte_model,
        step_flop_model,
    )

    model = step_flop_model(
        m, n, d, k, spec.subspace_iters, spec.warm_start_iters
    )
    small_anchor = spec.steps < 10 or d <= 256
    hbm_gbps, hbm_record = _hbm_anchor(small_anchor, dev)
    report_extra["roofline"] = roofline_fields(
        model,
        steps=timed_steps,
        fit_seconds=dt,
        anchor_tflops=_matmul_anchor(small_anchor, dev),
        byte_model=step_byte_model(
            m, n, d, k, spec.subspace_iters, spec.warm_start_iters,
            # the X passes read the STAGED dtype: the quantized bin wire or
            # the memory configs' resolved stage dtype
            itemsize=(
                1 if (spec.streaming == "bin" and spec.bin_dtype == "int8")
                else torch.tensor([], dtype=torch_dtype(stage_dtype)).element_size()
            ),
            # rank-r carries (feature-sharded / sketch) have no d x d state
            state=(
                "lowrank" if backend_used == "feature_sharded"
                else "dense"
            ),
        ),
        hbm_anchor_gbps=hbm_gbps,
        hbm_probe_record=hbm_record,
    )
    _anchor = report_extra["roofline"].get("anchor_tflops")
    if _anchor:
        report_extra["value_per_anchor"] = round(
            samples_per_sec / _anchor, 1
        )
    mesh_shape = mesh.shape if mesh is not None else {}
    if int(np.prod(list(mesh_shape.values()) or [1])) > 1:
        # the collective byte model and its projection at the assumed
        # link rate, next to the compute rooflines; omitted on one rank
        from distributed_eigenspaces_tpu_torch.analysis.hlo import (
            scaling_projection,
        )

        report_extra["ici_model"] = scaling_projection(
            m, d, k,
            step_seconds=dt / max(timed_steps, 1),
            n_workers_mesh=mesh_shape.get(pmesh.WORKER_AXIS, 1),
            n_feature_shards=mesh_shape.get(pmesh.FEATURE_AXIS, 1),
        )
    return {
        "config": spec.name,
        "description": spec.description,
        "dim": d,
        "k": k,
        "num_workers": m,
        "rows_per_worker": n,
        "steps": steps_run,  # the accuracy workload's step count
        "timed_steps": timed_steps,  # throughput schedule (scan: >= 240)
        "backend": backend_used,
        "trainer": trainer_used,
        "solver": spec.solver,
        "data": data_kind,
        "streaming": spec.streaming,
        "samples_per_sec": round(samples_per_sec, 1),
        "principal_angle_deg": round(angle, 4),
        "accuracy_ok": bool(angle <= 1.0),
        **(
            {"merge_interval": spec.merge_interval}
            if spec.merge_interval != 1 else {}
        ),
        **({"pipeline_merge": True} if spec.pipeline_merge else {}),
        **({"data_source": data_source} if data_source else {}),
        **report_extra,
        "device": device_block(dev),
    }


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Run the eval configs on the card (one JSON line each)"
    )
    p.add_argument("configs", nargs="*", default=[],
                   help=f"names from {sorted(EVAL_SPECS)} (default: all)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=None,
                   help="timed-run repetitions (report = median + IQR); "
                   "default 3 on full-size runs, 1 on shrunk ones")
    p.add_argument("--device", default="cuda",
                   help="the device to run on (default: the card)")
    args = p.parse_args(argv)

    names = args.configs or sorted(EVAL_SPECS)
    ok = True
    for name in names:
        over = {} if args.steps is None else {"steps": args.steps}
        rep = run_eval(name, data_dir=args.data_dir, seed=args.seed,
                       repeats=args.repeats, device=args.device, **over)
        print(json.dumps(rep), flush=True)
        ok = ok and rep["accuracy_ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
