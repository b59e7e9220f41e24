"""Streaming batcher: ``(N, d)`` rows -> per-step ``(m, n, d)`` worker blocks,
and the staging contract of those blocks.

Counterpart of ``make_batches``, ``block_stream``, ``synthetic_stream``,
``quantize_block_i8``, ``quantize_block_i8_device`` and ``stage_blocks`` in
``distributed_eigenspaces_tpu/data/stream.py``, and the feature-sharded
staging of a block (:func:`stage_feature_blocks`): the cursor advances every
step, the remainder policy for a final partial step is explicit, and an
int8 stage quantizes each block with one global symmetric scale.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype


def make_batches(n_rows: int, batch_size: int, *, keep_tail: bool = True):
    """Contiguous index ranges ``[(lo, hi), ...]`` over ``n_rows`` rows:
    the ragged tail kept (``keep_tail=True``) or dropped."""
    ranges = [(lo, min(lo + batch_size, n_rows)) for lo in range(0, n_rows, batch_size)]
    if not keep_tail and ranges and ranges[-1][1] - ranges[-1][0] < batch_size:
        ranges.pop()
    return ranges


def synthetic_stream(spectrum, *, num_workers: int, rows_per_worker: int,
                     num_steps: int, seed: int = 0, generator=None,
                     dtype="float32") -> Iterator[torch.Tensor]:
    """Fresh planted-spectrum draws every step: ``num_steps`` tensors of
    ``(num_workers, rows_per_worker, d)`` in ``dtype``. The rows come from
    ``generator`` (a ``torch.Generator``: drawn on its device) or, by
    default, from ``numpy.random.default_rng(seed)`` (CPU tensors); the
    reference splits ``jax.random.PRNGKey(seed)`` every step, bits torch
    cannot draw."""
    rng = np.random.default_rng(seed) if generator is None else generator
    tdt = torch_dtype(dtype)
    for _ in range(num_steps):
        x = torch.as_tensor(spectrum.sample(rng, num_workers * rows_per_worker))
        yield x.to(tdt).reshape(num_workers, rows_per_worker, -1)


def _i8_scale(amax: float) -> float:
    """``127 / absmax`` as the fp32 value the quantizers multiply by (the
    reference computes it in float64 and its fp32 block product rounds it
    to fp32)."""
    return float(np.float32(127.0 / amax))


def quantize_block_i8(block) -> np.ndarray:
    """Symmetric global int8 quantization of one staged block, on the host:
    ``round_half_even(b * 127 / absmax)`` clipped to +-127. The scale is not
    returned: a symmetric scale cancels in eigenvectors, so PCA consumers
    never dequantize. One scale per block, shared by its workers. An
    all-zero block gives zeros; a non-finite block raises (an inf would
    zero the scale, a NaN make the cast undefined)."""
    b = np.asarray(block, np.float32)
    amax = float(np.max(np.abs(b))) if b.size else 0.0
    if not np.isfinite(amax):
        raise ValueError("quantize_block_i8: block contains non-finite values")
    if amax == 0.0:
        return np.zeros(b.shape, np.int8)
    scale = np.float32(_i8_scale(amax))
    return np.clip(np.round(b * scale), -127, 127).astype(np.int8)


def quantize_block_i8_device(block: torch.Tensor) -> torch.Tensor:
    """:func:`quantize_block_i8` on the block's own device (same math, the
    same bits): quantizing a device-resident block where it lies saves
    moving the fp32 block. The scalar absmax is fetched to the host and
    checked, the one sync per block, so a non-finite block raises here as
    in the host twin instead of becoming finite int8."""
    b = block.float()
    amax = float(b.abs().max()) if b.numel() else 0.0
    if not np.isfinite(amax):
        raise ValueError(
            "quantize_block_i8_device: block contains non-finite values"
        )
    if amax == 0.0:
        return torch.zeros(block.shape, dtype=torch.int8, device=block.device)
    # torch.round rounds half to even, as numpy's
    return torch.round(b * _i8_scale(amax)).clamp_(-127, 127).to(torch.int8)


def stage_blocks(blocks, stage):
    """Stage an iterable of ``(m, n, d)`` blocks in ``stage`` dtype: the one
    definition of the staging contract (the whole fit, ``fit_stream``).
    int8 quantizes each block with its own scale, a tensor on its own
    device (:func:`quantize_block_i8_device`), numpy on the host
    (:func:`quantize_block_i8`); a float stage casts (no copy when the
    block already matches), keeping the block's device."""
    tdt = torch_dtype(stage)
    if tdt == torch.int8:
        return (
            quantize_block_i8_device(b) if isinstance(b, torch.Tensor)
            else quantize_block_i8(b)
            for b in blocks
        )
    return (torch.as_tensor(b).to(tdt) for b in blocks)


def stage_feature_blocks(blocks, stage, mesh, *, num_workers: int, dim: int):
    """Stage ``(m, n, d)`` blocks for a ``(workers, features)`` mesh: each
    block staged whole (:func:`stage_blocks`: an int8 stage takes ONE scale
    over the whole block, the same on every rank, as the reference
    quantizes before it shards), then this rank's workers and feature
    columns kept on the mesh's device (``parallel.feature_sharded.
    place_block``)."""
    from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import place_block

    return (place_block(mesh, b, num_workers, dim) for b in stage_blocks(blocks, stage))


def count_steps(n_total: int, step_rows: int, *, num_steps: int | None = None,
                remainder: str = "drop") -> int:
    """How many blocks :func:`block_stream` yields from ``n_total`` rows at
    ``step_rows`` rows a step: the full steps (at most ``num_steps``), plus
    the zero-padded partial one under ``remainder="pad"``. Under
    ``"error"`` a partial step is counted as none (the stream raises on
    it)."""
    full = n_total // step_rows
    if num_steps is not None and full >= num_steps:
        return num_steps
    return full + (remainder == "pad" and n_total % step_rows != 0)


def block_stream(
    data,
    *,
    num_workers: int,
    rows_per_worker: int,
    num_steps: int | None = None,
    remainder: str = "drop",
    dtype="float32",
    device="cuda",
    start_row: int = 0,
) -> Iterator[torch.Tensor]:
    """Yield ``(num_workers, rows_per_worker, d)`` tensors on ``device``
    from ``(N, d)`` numpy or torch data. Each step consumes
    ``num_workers * rows_per_worker`` fresh rows. A final partial step is
    dropped (``"drop"``), zero-padded (``"pad"``) or refused
    (``"error"``). ``start_row`` seeks the cursor before the first step:
    the resume point a checkpoint saved (``num_steps`` then counts steps
    from there).
    """
    dev = resolve_device(device)
    tdt = torch_dtype(dtype)
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    n_total, d = data.shape
    step_rows = num_workers * rows_per_worker
    if step_rows > n_total:
        raise ValueError(f"one step needs {step_rows} rows, dataset has {n_total}")
    if not 0 <= start_row <= n_total:
        raise ValueError(
            f"start_row={start_row} outside the dataset's {n_total} rows"
        )

    def place(block):
        t = torch.as_tensor(block).to(device=dev, dtype=tdt)
        return t.reshape(num_workers, rows_per_worker, d)

    cursor, steps = start_row, 0
    while num_steps is None or steps < num_steps:
        if cursor + step_rows > n_total:
            tail = n_total - cursor
            if tail and remainder == "error":
                raise ValueError(
                    f"{tail} remainder rows (step={step_rows}); set "
                    "remainder='drop'/'pad' or adjust sizes"
                )
            if tail and remainder == "pad":
                block = torch.zeros((step_rows, d), dtype=tdt, device=dev)
                block[:tail] = torch.as_tensor(data[cursor:]).to(
                    device=dev, dtype=tdt
                )
                yield place(block)
            break
        block = data[cursor:cursor + step_rows]
        cursor += step_rows
        steps += 1
        yield place(block)
