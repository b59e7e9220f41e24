"""The analyzer's seeded tiling mutant ``o = x @ v``: a Hopper kernel that
gives the whole operand to one CTA, and its plain PyTorch version.

Counterpart of ``_mutant_pallas_full_block`` in ``distributed_eigenspaces_tpu/
analysis/mutations.py`` (its ``project``, a Pallas call with grid ``(1,)``
whose blocks are the whole operands). :func:`mutant_full_block_cuda`
launches ``csrc/mutant_full_block.cu``: exact, deliberately slow, and run
only by the analyzer's mutation self-test (``analysis/mutations.py``) and
the checks beside it. Its :func:`mutant_full_block_launch` declares ``x``
owned whole by one CTA, which the tile budget of ``analysis/contracts.py``
must flag. The wrapper raises on anything but CUDA tensors it takes; there
is no CPU route to the kernel and no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from distributed_eigenspaces_tpu_torch.ops import _build
from distributed_eigenspaces_tpu_torch.ops.geometry import KernelLaunch, note

#: calls of :func:`mutant_full_block_cuda` that launched the kernel (one per
#: call, counted under a lock); callers reset it to 0 before a run they count
launches = 0
_count_lock = threading.Lock()

# the kernel's launch constants (csrc/mutant_full_block.cu, namespace scope;
# tests/test_torch_analysis.py reads them from the source)
THREADS = 256
KC = 8  # columns per register chunk: v's columns pad to a multiple of it
SMEM_MAX = 232448  # bytes a block may use on Hopper


def mutant_full_block_plain(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x @ v`` in fp32 (``torch.matmul``)."""
    return torch.matmul(x, v)


@functools.lru_cache(maxsize=256)  # pure, and the record is frozen
def mutant_full_block_launch(rows: int, d: int, k: int) -> KernelLaunch:
    """The launch ``det_mutant_full_block`` makes for x ``(rows, d)`` and v
    ``(d, k)``: one CTA of 256 threads that owns all of x, v staged whole in
    dynamic shared memory with its columns padded to a multiple of 8."""
    kp = -(-k // KC) * KC
    return KernelLaunch(
        kernel="mutant_full_block_kernel",
        source="csrc/mutant_full_block.cu",
        grid=(1, 1, 1),
        threads=THREADS,
        dynamic_smem=4 * d * kp,
        static_smem=0,
        operands=(("x", (rows, d)), ("v", (d, k)), ("v staged", (d, kp)),
                  ("o", (rows, k))),
    )


def _lib():
    lib = _build.load("mutant_full_block")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.det_mutant_full_block.argtypes = [ptr, ptr, ptr, i, i, i, ptr]
    lib.det_mutant_full_block.restype = i
    return lib


def mutant_full_block_cuda(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x @ v`` by the one-CTA kernel: x ``(rows, d)`` and v ``(d, k)``
    fp32, contiguous on one card, with v fitting one CTA's shared memory."""
    global launches
    if not (x.is_cuda and v.is_cuda):
        raise ValueError(
            f"mutant_full_block_cuda takes CUDA tensors, got x on {x.device} "
            f"and v on {v.device}"
        )
    if x.device != v.device:
        raise ValueError(f"mutant_full_block_cuda: x on {x.device}, v on {v.device}")
    if x.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(
            f"mutant_full_block_cuda takes float32 x and v, got {x.dtype} and {v.dtype}"
        )
    if x.dim() != 2 or v.dim() != 2 or x.shape[1] != v.shape[0]:
        raise ValueError(
            f"mutant_full_block_cuda takes x (rows, d) and v (d, k), got "
            f"{tuple(x.shape)} and {tuple(v.shape)}"
        )
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("mutant_full_block_cuda takes contiguous tensors")
    rows, d = x.shape
    k = v.shape[1]
    if min(rows, d, k) < 1:
        raise ValueError(f"mutant_full_block_cuda needs non-empty operands, got {(rows, d, k)}")
    if rows >= 2**31:
        raise ValueError(f"mutant_full_block_cuda takes rows < 2**31, got {rows}")
    launch = mutant_full_block_launch(rows, d, k)
    if launch.dynamic_smem > SMEM_MAX:
        raise ValueError(
            f"mutant_full_block_cuda stages v in one CTA's shared memory: "
            f"(d, k) = {(d, k)} needs {launch.dynamic_smem} bytes > {SMEM_MAX}"
        )
    o = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().det_mutant_full_block(
            x.data_ptr(), v.data_ptr(), o.data_ptr(), rows, d, k, stream
        )
    if rc != 0:
        raise RuntimeError(f"mutant_full_block kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
    note(launch)
    return o
