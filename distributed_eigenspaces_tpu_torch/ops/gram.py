"""The Gram ``X^T X / n`` of a batch of worker blocks: the Hopper kernel and
its plain PyTorch version.

Counterpart of ``distributed_eigenspaces_tpu/ops/pallas_gram.py``
(``gram_pallas`` / ``gram_auto``). :func:`gram_cuda` launches the kernel
of ``csrc/gram.cu`` on CUDA tensors; :func:`gram_plain` computes the same
function with ``torch.matmul`` and is what CPU tensors get. :func:`gram_auto`
dispatches on the tensor's device only: a CUDA tensor always goes to the
kernel, which raises on anything it does not take.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from distributed_eigenspaces_tpu_torch.ops import _build

#: kernel launches made by :func:`gram_cuda` (one per call, counted under a
#: lock so that launches from several threads all count); callers reset it
#: to 0 before a run whose launches they want to count
launches = 0
_count_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gram_plain(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """``(..., n, d) -> (..., d, d)`` fp32 ``X^T X`` (divided by n when
    ``normalize``). bf16 inputs are widened first: a product of two bf16
    values is exact in fp32, so this is the reference's bf16 x bf16 -> fp32
    contraction (``preferred_element_type=float32``), and the result is
    never rounded to bf16."""
    n = x.shape[-2]
    xf = x.float()
    g = torch.matmul(xf.mT, xf)
    if normalize:
        g = g / n
    return g


def _lib():
    lib = _build.load("gram")
    fn = lib.det_gram
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def gram_cuda(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """``(m, n, d)`` (or ``(n, d)``) CUDA fp32/bf16 -> ``(m, d, d)`` fp32
    Gram by the hand-written kernel (``csrc/gram.cu``)."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"gram_cuda takes a CUDA tensor, got device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"gram_cuda takes float32 or bfloat16, got {x.dtype}"
        )
    squeeze = x.dim() == 2
    if squeeze:
        x = x.unsqueeze(0)
    if x.dim() != 3:
        raise ValueError(f"gram_cuda takes (m, n, d) or (n, d), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("gram_cuda takes a contiguous tensor")
    m, n, d = x.shape
    if min(m, n, d) < 1:
        raise ValueError(f"gram_cuda needs a non-empty input, got {tuple(x.shape)}")
    if m > 65535:  # grid.z, one block row per worker
        raise ValueError(f"gram_cuda takes at most 65535 workers, got {m}")
    out = torch.empty((m, d, d), dtype=torch.float32, device=x.device)
    vec_ok = int(d % 8 == 0 and x.data_ptr() % 16 == 0)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), out.data_ptr(), m, n, d, _DTYPE_CODES[x.dtype],
            float(n) if normalize else 1.0, vec_ok, stream,
        )
    if rc != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
    return out[0] if squeeze else out


def gram_auto(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """The Gram of a worker batch on the tensor's own device: the kernel
    for a CUDA tensor (always; no fallback), the plain version for a CPU
    tensor."""
    if x.device.type == "cuda":
        return gram_cuda(x, normalize=normalize)
    if x.device.type == "cpu":
        return gram_plain(x, normalize=normalize)
    raise ValueError(f"gram_auto: unsupported device {x.device}")
