"""Device and dtype resolution shared by every entry point of the port.

Entry points default to ``device="cuda"``. When no card is present they
raise instead of running on the CPU: the CPU is reached only when a
caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,  # named only so that int8 staging can be refused
}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    is not available (no silent drop to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run the plain "
            "PyTorch path"
        )
    return dev


def dtype_name(dtype) -> str | None:
    """Canonical name (``"float32"``, ``"bfloat16"``, ...) of a dtype given
    as a string, a ``torch.dtype``, or anything ``numpy.dtype`` accepts
    (including numpy-registered scalar types such as ml_dtypes' bfloat16)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        for name, td in _DTYPES.items():
            if td == dtype:
                return name
        raise ValueError(f"unsupported dtype: {dtype!r}")
    if isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    """``torch.dtype`` for any spelling :func:`dtype_name` accepts."""
    return _DTYPES[dtype_name(dtype)]
