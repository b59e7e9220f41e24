"""NaN / inf guards: the port's counterpart of the reference's checkify mode.

The port's copy of ``distributed_eigenspaces_tpu/utils/guards.py``. Silent
numerical corruption (a bf16 overflow, a degenerate Cholesky, a zero-norm
basis) would otherwise ride NaN through the online state with no error
anywhere. ``DET_CHECKIFY=1`` arms the guards:

- :func:`checked` wraps a trainer (the reference's ``checked_jit``): the
  call raises :class:`CheckError` when a floating-point tensor it is given
  or returns holds a NaN or an inf, instead of handing it on.
- :func:`check` is an explicit assertion site (the reference's
  ``checkify.check``), such as ``ops.linalg.ns_orth``'s orthonormality
  residual, which float checks cannot see.

The reference's float checks flag a NaN that any primitive inside the step
produces. The port checks the step's floating inputs before it runs and
its outputs after: a non-finite input reaches the first product, so the
reference flags it there, whether or not a worker mask drops the worker
later, and a NaN made inside a step from finite inputs reaches the outputs
on every input the tests hold against the reference
(``tests/test_torch_guards.py``; ROADMAP Queue 3 keeps the case this cannot
see, a NaN made and dropped inside one step).

On a mesh (``checked(fn, mesh=)``) every rank raises together: the ranks
agree on one non-finite flag by one small MAX all-reduce over the mesh's
ranks before the step and one after it, so a poisoned shard on one rank
fails every rank alike and no rank is left waiting in a collective that
another has abandoned. An exception the step raises on one rank is held
until the agreement after it, then raised there, and the other ranks raise
:class:`CheckError` naming it.

Off by default, and resolved when a trainer is built (the reference's
contract is build-time). With the guards off, :func:`checked` returns the
step itself: no launch, no sync, no collective is added.

On the card a check reads its condition back to the host (one sync) rather
than asserting on the device with ``torch._assert_async``: a failed device
assertion leaves the CUDA context unusable, so nothing after it, the
supervisor's retry included, could launch again. The guards are a debug
mode; the syncs are their price: two a call (the inputs' flag, then the
outputs'), each one read back of one flag a device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["CheckError", "check", "checked", "checks_enabled"]

#: host read-backs of a CUDA flag the armed guards made in this process
syncs = 0


class CheckError(RuntimeError):
    """A guard fired: a NaN / inf entered or left a checked step, or an
    explicit :func:`check` failed. The supervisor retries it as it retries
    the reference's ``checkify.JaxRuntimeError``."""


def checks_enabled(explicit: bool | None = None) -> bool:
    """Build-time resolution of the guard switch: an explicit value wins,
    else the ``DET_CHECKIFY`` env var."""
    if explicit is not None:
        return explicit
    return os.environ.get("DET_CHECKIFY", "0") == "1"


def check(ok, message: str) -> None:
    """Raise :class:`CheckError` with ``message`` unless ``ok`` (a bool or
    a one-element tensor, read on the host)."""
    global syncs
    if isinstance(ok, torch.Tensor):
        syncs += ok.is_cuda
        ok = bool(ok.item())
    if not ok:
        raise CheckError(message)


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for o in tree:
            yield from _leaves(o)
    elif isinstance(tree, dict):
        for o in tree.values():
            yield from _leaves(o)


def non_finite(tree) -> str | None:
    """A description of the first floating-point leaf of ``tree`` (tensors
    and numpy arrays, in nested tuples, named tuples, lists and dicts) that
    holds a NaN or an inf, or None. The device leaves are read back as one
    flag a device: one sync each."""
    global syncs
    flags: dict = {}
    for t in _leaves(tree):
        if isinstance(t, np.ndarray):
            if np.issubdtype(t.dtype, np.floating) and not np.isfinite(t).all():
                return f"a {t.shape} {t.dtype} array"
        elif t.is_floating_point():
            flags.setdefault(t.device, []).append(
                (torch.isfinite(t).all(), f"a {tuple(t.shape)} {t.dtype} tensor"))
    for dev, fl in flags.items():
        ok = torch.stack([f for f, _ in fl])
        syncs += dev.type == "cuda"
        ok = ok.cpu().numpy()
        if not ok.all():
            return fl[int(np.flatnonzero(~ok)[0])][1]
    return None


def _any_rank(bad: bool, mesh) -> bool:
    """``bad`` on any rank of ``mesh`` (one MAX all-reduce; ``bad`` itself
    without a mesh)."""
    if mesh is None:
        return bad
    from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

    return pmesh.any_rank(bad, mesh)


def checked(fn, *, enabled: bool | None = None, mesh=None):
    """``fn`` itself with the guards off; with them on, ``fn`` between two
    finiteness checks: of every floating-point tensor or array it is given
    (positional and keyword, nested), then of every one it returns. Either
    raises :class:`CheckError` naming the step. ``mesh``: the ranks that
    run ``fn`` together, which agree on each check (module docstring)."""
    if not checks_enabled(enabled):
        return fn
    name = getattr(fn, "__qualname__", repr(fn))

    def wrapped(*args, **kw):
        what = non_finite((args, kw))
        if _any_rank(what is not None, mesh):
            where = what or "another rank's share of its input"
            raise CheckError(
                f"{name} was given a non-finite value (NaN / inf) in {where}")
        err = None
        try:
            out = fn(*args, **kw)
        except Exception as e:  # held for the agreement on a mesh
            if mesh is None or mesh.device_mesh is None:
                raise
            err, out = e, None
        what = None if err is not None else non_finite(out)
        if _any_rank(err is not None or what is not None, mesh):
            if err is not None:
                raise err
            where = what or "another rank's share of its output, or another rank raised"
            raise CheckError(
                f"{name} produced a non-finite value (NaN / inf) in {where}")
        return out

    wrapped.__wrapped__ = fn
    return wrapped
