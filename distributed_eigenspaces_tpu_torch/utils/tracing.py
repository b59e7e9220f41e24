"""Profiler annotations and trace capture on ``torch.profiler``.

Counterpart of ``distributed_eigenspaces_tpu/utils/tracing.py``. Every
annotation here is a ``torch.profiler.record_function`` region: it shows
under its name on a ``torch.profiler`` trace, beside the kernels launched
inside it, and costs a few microseconds when no profiler runs.

- :func:`named_scope`: a named region of computation (the reference's
  ``jax.named_scope``);
- :func:`trace_annotation`: the device half of ``utils/telemetry.Tracer``'s
  spans opened with ``device=True``;
- :func:`annotate_step`: one online step, ``pca_step`` with its number;
- :func:`profile_to`: capture a ``torch.profiler`` trace of the region into
  a directory, as a Chrome trace-event JSON that Perfetto loads.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def named_scope(name: str):
    """Annotate a region of computation (visible in profiles)."""
    return torch.profiler.record_function(name)


def trace_annotation(name: str):
    """A ``torch.profiler.record_function`` context for ``name``."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_to(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the region into ``log_dir``
    (no-op when None)::

        with profile_to("/tmp/trace"):
            state, _ = step(state, x)

    The host's activity is always recorded, the card's where one is there;
    the trace is written on exit as ``log_dir/trace_<pid>_<ns>.json``."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate_step(t: int):
    """Name one online step in the profile timeline."""
    with torch.profiler.record_function("pca_step", args=f"step_num={t}"):
        yield
