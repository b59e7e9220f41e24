"""NaN / inf guards: the port's counterpart of the reference's checkify mode.

The port's copy of ``distributed_eigenspaces_tpu/utils/guards.py``. Silent
numerical corruption (a bf16 overflow, a degenerate Cholesky, a zero-norm
basis) would otherwise ride NaN through the online state with no error
anywhere. ``DET_CHECKIFY=1`` arms the guards:

- :func:`checked` wraps a step (the reference's ``checked_jit``): the step
  raises :class:`CheckError` when an output tensor holds a NaN or an inf,
  instead of handing it on.
- :func:`check` is an explicit assertion site (the reference's
  ``checkify.check``), such as ``ops.linalg.ns_orth``'s orthonormality
  residual, which float checks cannot see.

Off by default, and resolved when a trainer is built (an env read per step
would cost nothing on the device, but the reference's contract is
build-time). With the guards off, :func:`checked` returns the step itself
and nothing extra is launched.

On the card a check reads its condition back to the host (one sync) rather
than asserting on the device with ``torch._assert_async``: a failed device
assertion leaves the CUDA context unusable, so nothing after it, the
supervisor's retry included, could launch again. The guards are a debug
mode; the sync is their price.
"""

from __future__ import annotations

import os

import torch

__all__ = ["CheckError", "check", "checked", "checks_enabled"]


class CheckError(RuntimeError):
    """A guard fired: a NaN / inf left a checked step, or an explicit
    :func:`check` failed. The supervisor retries it as it retries the
    reference's ``checkify.JaxRuntimeError``."""


def checks_enabled(explicit: bool | None = None) -> bool:
    """Build-time resolution of the guard switch: an explicit value wins,
    else the ``DET_CHECKIFY`` env var."""
    if explicit is not None:
        return explicit
    return os.environ.get("DET_CHECKIFY", "0") == "1"


def check(ok, message: str) -> None:
    """Raise :class:`CheckError` with ``message`` unless ``ok`` (a bool or
    a one-element tensor, read on the host)."""
    if isinstance(ok, torch.Tensor):
        ok = bool(ok.item())
    if not ok:
        raise CheckError(message)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def checked(fn, *, enabled: bool | None = None):
    """``fn`` itself with the guards off; with them on, ``fn`` followed by
    a finiteness check of every floating-point tensor it returns (nested
    tuples, named tuples and lists included), raising :class:`CheckError`
    naming the step."""
    if not checks_enabled(enabled):
        return fn
    name = getattr(fn, "__qualname__", repr(fn))

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        for t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise CheckError(
                    f"{name} produced a non-finite value (NaN / inf) "
                    f"in a {tuple(t.shape)} {t.dtype} output"
                )
        return out

    return wrapped
