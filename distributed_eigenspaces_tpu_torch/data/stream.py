"""Streaming batcher: ``(N, d)`` rows -> per-step ``(m, n, d)`` worker blocks.

Counterpart of ``block_stream`` in ``distributed_eigenspaces_tpu/data/
stream.py``: the cursor advances every step, and the remainder policy for
a final partial step is explicit.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype


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
) -> Iterator[torch.Tensor]:
    """Yield ``(num_workers, rows_per_worker, d)`` tensors on ``device``
    from ``(N, d)`` numpy or torch data. Each step consumes
    ``num_workers * rows_per_worker`` fresh rows. A final partial step is
    dropped (``"drop"``), zero-padded (``"pad"``) or refused
    (``"error"``).
    """
    dev = resolve_device(device)
    tdt = torch_dtype(dtype)
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    n_total, d = data.shape
    step_rows = num_workers * rows_per_worker
    if step_rows > n_total:
        raise ValueError(f"one step needs {step_rows} rows, dataset has {n_total}")

    def place(block):
        t = torch.as_tensor(block).to(device=dev, dtype=tdt)
        return t.reshape(num_workers, rows_per_worker, d)

    cursor, steps = 0, 0
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
