"""User-supplied row ingestion: a directory of ``.npy`` / flat ``.bin``
files -> an ``(N, dim)`` float32 row matrix (round-5 verdict item 7).

The port's copy of ``distributed_eigenspaces_tpu/data/npy_dir.py`` (which
imports no JAX), unchanged.

The scale-out configs (BASELINE 4: ImageNet 64x64 patches, 12288-d;
BASELINE 5: CLIP ViT-L embeddings, 768-d) have no downloadable dataset
on a zero-egress rig, but users HAVE these datasets — this module is the
ingestion path from "a directory of arrays I exported" to the eval
harness / estimator:

- ``*.npy``: either ``(N, dim)`` row matrices, or ``(N, ...)`` stacks
  whose trailing dimensions flatten to ``dim`` — e.g. ``(N, 64, 64, 3)``
  image patches for the 12288-d config (the patch-extraction contract:
  row-major flatten, exactly ``arr.reshape(N, -1)``).
- ``*.bin``: flat float32 rows, ``array.tobytes()`` of an ``(N, dim)``
  matrix — the same wire format ``data.bin_stream`` consumes/produces
  (so a corpus prepared with ``det-pca-quantize``'s float source file
  loads here too).

Files load in sorted-name order (deterministic row order), memory-mapped
and copied only up to ``max_rows`` — pointing this at a 1.2 TB corpus
and asking for one eval's worth of rows reads one eval's worth of bytes.

The reference's data story is "every process loads the full dataset from
a local directory" (``distributed.py:169``, ``load_data.py:36-50``);
this is that arrangement for arbitrary row data, bounded and checked.
"""

from __future__ import annotations

import os

import numpy as np


def load_rows_dir(
    directory: str,
    dim: int,
    *,
    max_rows: int | None = None,
) -> tuple[np.ndarray, dict]:
    """Load ``(N, dim)`` float32 rows from every ``.npy``/``.bin`` file
    under ``directory`` (sorted order). Returns ``(rows, provenance)``
    where provenance records the directory, per-file row counts, and
    total rows — the report-JSON evidence of what was actually read.

    Raises ``FileNotFoundError`` for a missing/empty directory and
    ``ValueError`` for files whose shape cannot yield ``dim``-wide rows
    (loud beats a silent reshape of the wrong data).
    """
    # listdir + suffix filter, NOT glob: a user path containing glob
    # metacharacters (~/data[v2]/...) would silently match nothing and
    # read as "no files" — triggering the check script's synthesize
    # fallback over the user's real corpus
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"{directory!r} is not a directory")
    paths = sorted(
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.endswith((".npy", ".bin"))
    )
    if not paths:
        raise FileNotFoundError(
            f"no .npy or .bin row files under {directory!r}"
        )
    chunks: list[np.ndarray] = []
    files: list[dict] = []
    total = 0
    for path in paths:
        if max_rows is not None and total >= max_rows:
            break
        if path.endswith(".npy"):
            arr = np.load(path, mmap_mode="r")
            if arr.ndim < 2:
                raise ValueError(
                    f"{path}: need (N, ...) stacks, got shape {arr.shape}"
                )
            width = int(np.prod(arr.shape[1:]))
            if width != dim:
                raise ValueError(
                    f"{path}: rows flatten to {width} values, config "
                    f"needs dim={dim} (shape {arr.shape})"
                )
            n_file = arr.shape[0]
            take = (
                n_file if max_rows is None
                else min(n_file, max_rows - total)
            )
            # mmap -> copy of exactly the consumed slice, flattened to rows
            chunk = np.asarray(
                arr[:take], dtype=np.float32
            ).reshape(take, dim)
        else:  # .bin: flat float32 rows
            size = os.path.getsize(path)
            row_bytes = dim * 4
            if size == 0 or size % row_bytes:
                raise ValueError(
                    f"{path}: {size} bytes is not a whole number of "
                    f"float32 rows of dim={dim}"
                )
            n_file = size // row_bytes
            take = (
                n_file if max_rows is None
                else min(n_file, max_rows - total)
            )
            chunk = np.fromfile(
                path, dtype=np.float32, count=take * dim
            ).reshape(take, dim)
        chunks.append(chunk)
        files.append({"file": os.path.basename(path), "rows": int(take)})
        total += take
    rows = np.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]
    provenance = {
        "dir": os.path.abspath(directory),
        "files": files,
        "rows": int(total),
        "dim": int(dim),
    }
    return rows, provenance
