"""Profiler annotations for the port's host spans.

Counterpart of ``distributed_eigenspaces_tpu/utils/tracing.py``'s
``trace_annotation``: a region opened here shows under its name on a
``torch.profiler`` trace, beside the kernels launched inside it.
"""

from __future__ import annotations

import torch


def trace_annotation(name: str):
    """A ``torch.profiler.record_function`` context for ``name``."""
    return torch.profiler.record_function(name)
