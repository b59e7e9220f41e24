"""Out-of-core block streaming from raw binary row files.

Counterpart of ``distributed_eigenspaces_tpu/data/bin_stream.py`` on one
host: ``(m, n, d)`` worker blocks are read straight from disk through the
native double-buffered :class:`..runtime.native.ChunkReader` (a C++
read-ahead thread), so host memory holds about two steps whatever the
dataset's size. The clip768 eval's out-of-core fit streams from here.

File format: flat rows of ``dtype`` (float32 / bfloat16 / uint8 / int8),
row length ``dim``, i.e. exactly ``array.tobytes()`` of an ``(N, dim)``
matrix; :func:`write_rows` produces it. uint8 rows are widened to float32
by the native kernel; bfloat16 rows are bit-extended (each uint16 the high
half of a float32 word). With an integer ``out_dtype`` (int8 over an int8
file) blocks pass through unconverted: a quarter of fp32's bytes cross to
the card, and a symmetric global scale cancels in eigenvectors, so the
subspace needs no dequantization.

Blocks are yielded as host (CPU) tensors: the consumer, or a
:func:`~..runtime.prefetch.prefetch_stream` placement, makes the one
host-to-device copy.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.runtime.native import (
    ChunkReader,
    absmax_f32,
    quantize_i8,
    to_f32,
)

#: numpy dtypes of the file formats by name (bfloat16 has none: its rows
#: are read as uint16 words)
_FILE_DTYPES = {"float32": np.float32, "uint8": np.uint8, "int8": np.int8,
                "bfloat16": np.uint16}


#: what a block can be yielded as: floats convert, integers pass through
_OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8, "uint8": torch.uint8}


def _dtype_name(dtype) -> str:
    """A dtype's name, given as a name, a numpy dtype or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _file_dtype(dtype) -> tuple[str, np.dtype]:
    """``(name, numpy dtype of one stored element)`` of a file dtype."""
    name = _dtype_name(dtype)
    if name not in _FILE_DTYPES:
        raise ValueError(f"unsupported row-file dtype {dtype!r}; one of "
                         f"{sorted(_FILE_DTYPES)}")
    return name, np.dtype(_FILE_DTYPES[name])


def write_rows(path: str, data) -> None:
    """Write ``(N, d)`` rows as the flat binary format (fixtures, prep)."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu()
        if data.dtype == torch.bfloat16:
            data = data.view(torch.int16)
        data = data.numpy()
    np.ascontiguousarray(data).tofile(path)


def num_rows(path: str, dim: int, dtype=np.float32) -> int:
    name, dt = _file_dtype(dtype)
    size = os.path.getsize(path)
    if size % (dim * dt.itemsize):
        raise ValueError(
            f"{path}: {size} bytes is not a whole number of {dim}x{name} rows"
        )
    return size // (dim * dt.itemsize)


def quantize_file_i8(src: str, dst: str, *, dim: int, chunk_rows: int = 65536,
                     scale: float | None = None) -> tuple[float, int]:
    """Quantize a flat float32 row file into the int8 wire format, out of
    core: two streaming passes through the native reader (pass 1 the
    global absmax unless ``scale`` is given, pass 2 quantize and write),
    O(chunk) host memory. Returns ``(scale, rows)``; the symmetric global
    scale cancels in eigenvectors, so consumers never dequantize."""
    total = num_rows(src, dim, np.float32)
    chunk_bytes = chunk_rows * dim * 4
    if scale is None:
        m = 0.0
        with ChunkReader(src, chunk_bytes) as rd:
            for chunk in rd:
                m = max(m, absmax_f32(np.frombuffer(chunk, np.float32)))
        scale = 127.0 / max(m, 1e-30)
    with ChunkReader(src, chunk_bytes) as rd, open(dst, "wb") as f:
        for chunk in rd:
            f.write(quantize_i8(np.frombuffer(chunk, np.float32), scale).tobytes())
    return float(scale), total


def window_stream(blocks, window: int):
    """Stack a block iterator into ``(S, m, n, d)`` windows of up to
    ``window`` steps (the last may be ragged): the staging unit of the
    segmented trainer's ``fit_windows``. Blocks stack where they lie, so
    host blocks stay on the host and the consumer (or a prefetch
    placement) makes the one copy to the card."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    buf = []
    for b in blocks:
        buf.append(torch.as_tensor(b))
        if len(buf) == window:
            yield torch.stack(buf)
            buf = []
    if buf:
        yield torch.stack(buf)


def bin_block_stream(
    path: str,
    *,
    dim: int,
    num_workers: int,
    rows_per_worker: int,
    num_steps: int | None = None,
    dtype=np.float32,
    out_dtype=torch.float32,
    remainder: str = "drop",
    worker_range: tuple[int, int] | None = None,
    start_row: int = 0,
) -> Iterator[torch.Tensor]:
    """Yield ``(num_workers, rows_per_worker, dim)`` host tensors from a
    binary row file without materializing the dataset: the contract of
    :func:`.stream.block_stream` (advancing cursor, explicit remainder
    policy) in O(step) memory, one step's bytes read per chunk with the
    next chunk read ahead by the native reader's thread.

    ``out_dtype`` float32 (or bfloat16) converts; an integer ``out_dtype``
    needs the same on-disk dtype and passes the stored bytes through.
    ``start_row`` seeks past already-consumed rows before the first read:
    the resume argument for the cursor a checkpoint saves (``steps_done *
    num_workers * rows_per_worker``); it must land on a step boundary.

    ``worker_range=(lo, hi)``: the multi-host read. Each step yields only
    workers ``[lo, hi)`` of the ``num_workers``, ``(hi - lo,
    rows_per_worker, dim)``; the strided reader seeks past the other ranks'
    rows of every step, so each rank reads only the bytes of its workers
    from one shared file (``parallel.multihost.host_worker_range`` gives
    the range). Only ``remainder="drop"`` (a partial final step may cut
    mid-stride), and every rank stops after the same number of whole steps.
    """
    if remainder not in ("drop", "pad", "error"):
        raise ValueError(f"unknown remainder policy: {remainder!r}")
    in_name, in_dt = _file_dtype(dtype)
    is_bf16 = in_name == "bfloat16"
    out_name = _dtype_name(out_dtype)
    if out_name not in _OUT_DTYPES:
        raise ValueError(f"unsupported out_dtype {out_dtype!r}; one of "
                         f"{sorted(_OUT_DTYPES)}")
    out_t = _OUT_DTYPES[out_name]
    out_is_int = not out_t.is_floating_point
    if out_is_int and out_name != in_name:
        raise ValueError(
            f"integer out_dtype={out_t} requires the same on-disk dtype (got "
            f"{in_name}): the passthrough path ships the stored bytes to the "
            "device unconverted"
        )
    step_rows = num_workers * rows_per_worker
    total = num_rows(path, dim, dtype)
    if step_rows > total:
        raise ValueError(f"one step needs {step_rows} rows, file has {total}")
    row_bytes = dim * in_dt.itemsize
    if start_row:
        if start_row % step_rows:
            raise ValueError(
                f"start_row={start_row} is not a step boundary "
                f"(step_rows={step_rows}) — checkpoint cursors are "
                "whole-step row offsets"
            )
        if start_row > total:
            raise ValueError(f"start_row={start_row} beyond the file's {total} rows")
    offset, skip, out_workers = start_row * row_bytes, 0, num_workers
    if worker_range is not None:
        lo, hi = worker_range
        if not (0 <= lo < hi <= num_workers):
            raise ValueError(
                f"worker_range {worker_range} invalid: need "
                f"0 <= lo < hi <= num_workers (= {num_workers})"
            )
        if remainder != "drop":
            raise ValueError(
                "worker_range supports remainder='drop' only (a partial "
                "final step may cut mid-stride)"
            )
        out_workers = hi - lo
        skipped = start_row // step_rows
        # past the other ranks' leading workers and any resumed whole steps
        offset = (lo * rows_per_worker + skipped * step_rows) * row_bytes
        skip = (num_workers - out_workers) * rows_per_worker * row_bytes
        # every rank stops after the same count of whole steps: a ragged
        # last step may hold low ranks' workers and not high ones'
        full = total // step_rows - skipped
        num_steps = full if num_steps is None else min(num_steps, full)
        step_rows = out_workers * rows_per_worker
    chunk_bytes = step_rows * row_bytes

    def convert(buf: bytes, rows: int) -> torch.Tensor:
        if is_bf16:
            # bit-reinterpret: each bf16 word is the high half of an f32
            bits = np.frombuffer(buf, dtype=np.uint16)
            arr = (bits.astype(np.uint32) << 16).view(np.float32)
        elif out_is_int:
            arr = np.frombuffer(buf, dtype=in_dt).copy()  # passthrough
        elif in_dt == np.uint8:
            arr = to_f32(np.frombuffer(buf, dtype=in_dt))  # native widen
        else:
            arr = np.array(np.frombuffer(buf, dtype=in_dt), np.float32)
        return torch.from_numpy(arr.reshape(rows, dim)).to(out_t)

    steps = 0
    with ChunkReader(path, chunk_bytes, offset=offset, skip=skip) as reader:
        it = iter(reader)
        while True:
            # the cap is checked before pulling: past it a chunk would be
            # read only to be discarded
            if num_steps is not None and steps >= num_steps:
                return
            chunk = next(it, None)
            if chunk is None:
                return
            if len(chunk) < chunk_bytes:  # ragged tail
                tail_rows = len(chunk) // row_bytes
                if tail_rows == 0 or remainder == "drop":
                    return
                if remainder == "error":
                    raise ValueError(
                        f"{tail_rows} remainder rows (step={step_rows}); "
                        "set remainder='drop'/'pad' or adjust sizes"
                    )
                block = torch.zeros((step_rows, dim), dtype=out_t)
                block[:tail_rows] = convert(chunk[: tail_rows * row_bytes], tail_rows)
                yield block.reshape(out_workers, rows_per_worker, dim)
                return
            steps += 1
            yield convert(chunk, step_rows).reshape(out_workers, rows_per_worker, dim)
