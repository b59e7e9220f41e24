"""Checkpoint / resume of the online state.

Counterpart of ``distributed_eigenspaces_tpu/utils/checkpoint.py``, on the
same on-disk format, so a checkpoint crosses both ways between the
packages:

  - ``OnlineState``  = sigma_tilde (d, d) + step          (kind "online")
  - ``SegmentState`` = OnlineState + the warm carry v_prev (d, k)
    (kind "scan_segment"), so a resumed segmented run is bit for bit the
    unkilled one
  - ``LowRankState`` = U (d, r) + S (r,) + step            (kind "lowrank")
  - ``SketchState``  = y (d, p) + v (d, k) + step          (kind "sketch")
  - plus the data-stream cursor (an integer row offset)

The feature-sharded kinds record each leaf's layout in the commit marker
as the reference does (``leaf_specs``: ``["features", None]`` for the
row-sharded leaves, ``[]`` for the replicated ones), and
:func:`restore_checkpoint` with a ``mesh`` gives each rank its rows of the
row-sharded leaves. A state is saved whole: the feature-sharded trainers
gather it over ``features`` before their hooks run.

A checkpoint directory holds ``state.npz`` (``step`` as an int32 scalar,
the tensors as float32 arrays) and a ``meta.json`` commit marker, renamed
into place last and carrying the payload's sha256. A crash mid-write
leaves no marker, so the checkpoint is simply not found; a committed
checkpoint whose payload is torn or fails its checksum raises
:class:`CheckpointCorrupt`, and :meth:`Checkpointer.latest` quarantines it
(renamed ``*.quarantined``) and steps back to the next newest.

On a mesh the state is the same on every rank, so rank 0 alone writes
(and collects old steps), and every rank restores. The segmented
trainer runs its ``on_segment`` hook on rank 0 and then holds every rank at
a barrier, so a commit is on disk before any rank reads it; a caller that
saves from every rank itself follows the call with
``parallel.mesh.barrier()``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.scan import SegmentState
from distributed_eigenspaces_tpu_torch.device import resolve_device
from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
    ROW_FIELDS,
    LowRankState,
    SketchState,
    shard_state,
)
from distributed_eigenspaces_tpu_torch.parallel.mesh import is_writer
from distributed_eigenspaces_tpu_torch.utils.metrics import log_line


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint whose payload does not restore: torn or
    truncated npz, checksum mismatch, or missing fields. Distinct from "no
    committed checkpoint" (FileNotFoundError): the marker landed but the
    bytes are damaged."""


_STATE_TYPES = {
    "online": OnlineState,
    "lowrank": LowRankState,
    "scan_segment": SegmentState,
    "sketch": SketchState,
}


def _leaf_specs(cls) -> dict | None:
    """The reference's per-leaf layout record of a feature-sharded state:
    rows over ``features`` for the row-sharded leaves, replicated for the
    rest; None for the dense kinds."""
    rows = ROW_FIELDS.get(cls)
    if rows is None:
        return None
    return {f: (["features", None] if f in rows else []) for f in cls._fields}


def _to_host(state) -> dict:
    """Each field as the numpy array the reference's payload holds: the
    step an int32 scalar, every tensor float32."""
    out = {}
    for name in state._fields:
        value = getattr(state, name)
        if name == "step":
            out[name] = np.asarray(int(value), np.int32)
        elif value.dtype != torch.float32:
            raise ValueError(
                f"checkpoints hold float32 states; field {name!r} is "
                f"{value.dtype}"
            )
        else:
            out[name] = value.detach().cpu().numpy()
    return out


def save_checkpoint(path: str, state, *, cursor: int = 0,
                    extra: dict[str, Any] | None = None) -> None:
    """Write a self-describing checkpoint directory at ``path`` (on rank 0
    of a process group only: the other ranks hold the same state)."""
    kind = next((n for n, cls in _STATE_TYPES.items()
                 if type(state) is cls), None)
    if kind is None:
        raise ValueError(
            f"unsupported checkpoint state type {type(state).__name__}; "
            f"known: {sorted(_STATE_TYPES)}"
        )
    if is_writer():
        _write_checkpoint(path, _to_host(state), kind, cursor, extra,
                          _leaf_specs(type(state)))


def _write_checkpoint(path, host: dict, kind: str, cursor, extra,
                      leaf_specs=None) -> None:
    os.makedirs(path, exist_ok=True)
    # invalidate any previous commit marker before touching state.npz, and
    # write the payload via tmp + rename: a crash at any point leaves the
    # old complete checkpoint or no committed one, never a committed but
    # corrupt one
    meta_final = os.path.join(path, "meta.json")
    if os.path.exists(meta_final):
        os.remove(meta_final)
    state_tmp = os.path.join(path, "state.tmp.npz")  # np.savez keeps .npz
    np.savez(state_tmp, **host)
    with open(state_tmp, "rb") as f:
        checksum = hashlib.sha256(f.read()).hexdigest()
    os.replace(state_tmp, os.path.join(path, "state.npz"))
    meta = {
        "state_type": kind,
        "cursor": int(cursor),
        "step": int(host["step"]),
        "format_version": 1,
        "checksum": checksum,
    }
    if leaf_specs:
        meta["leaf_specs"] = leaf_specs
    if extra:
        meta["extra"] = extra
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, meta_final)  # the atomic commit marker


def restore_checkpoint(path: str, *, device="cuda", mesh=None):
    """Load ``(state, cursor)`` from a checkpoint directory, the tensors on
    ``device``. Raises FileNotFoundError on a missing or uncommitted
    checkpoint and :class:`CheckpointCorrupt` on a committed one whose
    payload does not restore. A marker without a checksum (older
    checkpoints) restores unverified. With a ``(workers, features)``
    ``mesh`` a feature-sharded state comes back as this rank's rows, on
    the mesh's device."""
    dev = resolve_device(device) if mesh is None else mesh.device
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no committed checkpoint at {path!r}")
    with open(meta_path) as f:
        meta = json.load(f)
    cls = _STATE_TYPES[meta["state_type"]]
    payload = os.path.join(path, "state.npz")
    want = meta.get("checksum")
    if want is not None:
        try:
            with open(payload, "rb") as f:
                got = hashlib.sha256(f.read()).hexdigest()
        except OSError as e:
            raise CheckpointCorrupt(
                f"committed checkpoint at {path!r} has an unreadable "
                f"payload: {e!r}"
            ) from e
        if got != want:
            raise CheckpointCorrupt(
                f"committed checkpoint at {path!r} failed its payload "
                f"checksum (sha256 {got[:12]}... != recorded "
                f"{want[:12]}...): torn or rotted bytes"
            )

    def field(name, arr):
        if name == "step":
            return int(arr)
        return torch.from_numpy(np.array(arr, np.float32)).to(dev)

    try:
        with np.load(payload) as z:
            state = cls(**{f: field(f, z[f]) for f in cls._fields})
    except FileNotFoundError:
        raise
    except Exception as e:  # torn zip, missing field, bad dtype...
        raise CheckpointCorrupt(
            f"committed checkpoint at {path!r} does not restore: {e!r}"
        ) from e
    if mesh is not None and cls in ROW_FIELDS:
        state = shard_state(mesh, state)
    return state, meta["cursor"]


@dataclasses.dataclass
class Checkpointer:
    """Periodic checkpoint hook for the online loop and the segmented
    trainer: ``on_step(t, state)`` (an ``on_step`` or ``on_segment``
    callback) saves ``step_{t:08d}`` every ``every`` steps and keeps the
    newest ``keep``; :meth:`latest` restores onto ``device`` (with ``mesh``,
    a feature-sharded state as this rank's rows)."""

    directory: str
    every: int = 1
    keep: int = 2
    rows_per_step: int = 0  # rows consumed per step -> saved stream cursor
    device: Any = "cuda"
    mesh: Any = None

    def on_step(self, t: int, state, v_bar=None) -> None:
        if t % self.every:
            return
        path = os.path.join(self.directory, f"step_{t:08d}")
        save_checkpoint(path, state, cursor=t * self.rows_per_step)
        self._gc()

    def latest(self):
        """Restore the newest committed checkpoint that restores, or None:
        the resume ladder. A committed step whose payload is torn or fails
        its checksum is quarantined (directory renamed ``*.quarantined``,
        kept as evidence) and the ladder steps back to the next newest."""
        for step in reversed(self._steps()):
            path = os.path.join(self.directory, f"step_{step:08d}")
            try:
                return restore_checkpoint(path, device=self.device, mesh=self.mesh)
            except CheckpointCorrupt as e:
                quarantined = path + ".quarantined"
                try:
                    os.replace(path, quarantined)
                except OSError:
                    quarantined = None
                log_line(
                    "checkpoint quarantined: stepping the resume ladder back",
                    step=step, error=str(e), quarantined=quarantined,
                )
            except FileNotFoundError:
                continue  # lost a GC race: older steps still stand
        return None

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            # "step_NNNNNNNN" only: quarantined dirs keep the prefix but
            # grow a suffix, and never re-enter the ladder
            if name.startswith("step_") and name[5:].isdigit():
                if os.path.exists(os.path.join(self.directory, name, "meta.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def _gc(self) -> None:
        if not is_writer():  # one collector: the writer
            return
        steps = self._steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True
            )
