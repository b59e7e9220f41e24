"""The Gram ``X^T X / n`` of a batch of worker blocks: the Hopper kernel and
its plain PyTorch version.

Counterpart of ``distributed_eigenspaces_tpu/ops/pallas_gram.py``
(``gram_pallas`` / ``gram_auto``). :func:`gram_cuda` launches the kernel
of ``csrc/gram.cu`` on CUDA tensors; :func:`gram_plain` computes the same
function with ``torch.matmul`` and is what CPU tensors get. :func:`gram_auto`
dispatches on the tensor's device only: a CUDA tensor always goes to the
kernel, which raises on anything it does not take.

Which of the source's three kernels a launch takes is a shape rule decided
before the launch: bf16 x with ``d % 8 == 0`` on a 16-byte aligned base
takes the TMA + ``wgmma`` kernel (TMA needs 16-byte global strides), other
bf16 x the ``mma.sync`` kernel, fp32 x the FFMA kernel, whose tile edge
(:func:`f32_tile`) and copy width (:func:`f32_vec`) are shape rules too.
:func:`gram_launch` is that launch's record (``ops/geometry.py``), which
:func:`gram_cuda` notes after every launch.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from distributed_eigenspaces_tpu_torch.ops import _build
from distributed_eigenspaces_tpu_torch.ops.geometry import KernelLaunch, note

#: kernel launches made by :func:`gram_cuda` (one per call, counted under a
#: lock so that launches from several threads all count), and those of them
#: that took the TMA kernel; callers reset them to 0 before a run whose
#: launches they want to count
launches = 0
launches_tma = 0
_count_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernels' launch constants (csrc/gram.cu, namespace scope;
# tests/test_torch_analysis.py reads them from the source)
TILE = 128  # gram_bf16_kernel's output tile edge
THREADS = 256  # gram_bf16_kernel
SMEM_BYTES = TILE * 132 * 4  # its epilogue tile, rows padded to 132 floats
F_THREADS = 256  # gram_f32_kernel: a 16 x 16 grid of threads over its tile
F_BK = 16  # rows of x per stage of its cp.async ring
F_STAGES = 2  # stages in the ring
F_FILL = 132  # CTAs that fill the card: the SMs of an H100
F_TILES = (128, 64, 32)  # its tile edges (template instances), largest first
T_BK = 64  # gram_bf16_tma_kernel: rows of x per stage
T_STAGES = 4  # stages in its ring
T_THREADS = 3 * 128  # two consumer warpgroups and a producer warpgroup
# the ring (per stage 128 columns of x for the item's rows, 256 for its
# columns), the barriers, alignment
T_SMEM_BYTES = T_STAGES * 6 * T_BK * 64 * 2 + 2 * T_STAGES * 8 + 1024


def takes_tma(d: int, dtype, aligned: bool = True) -> bool:
    """The shape rule: bf16 x whose rows TMA can read (``d % 8 == 0``, a
    16-byte aligned base) takes ``gram_bf16_tma_kernel``."""
    return dtype == torch.bfloat16 and aligned and d % 8 == 0


def f32_tile(m: int, d: int) -> int:
    """The fp32 kernel's tile edge: the largest of :data:`F_TILES` whose
    ``m * tiles (tiles + 1) / 2`` CTAs fill the card (``F_FILL``), else
    the smallest (``f32_tile`` in the source)."""
    for t in F_TILES[:-1]:
        tiles = -(-d // t)
        if m * (tiles * (tiles + 1) // 2) >= F_FILL:
            return t
    return F_TILES[-1]


def f32_vec(d: int, aligned: bool = True) -> int:
    """The fp32 kernel's copy width in floats: 4 (16-byte ``cp.async`` and
    vector stores) where rows of x and of the output are 16-byte aligned,
    else 1."""
    return 4 if aligned and d % 4 == 0 else 1


@functools.lru_cache(maxsize=256)  # pure, and the record is frozen
def gram_launch(m: int, n: int, d: int, dtype=torch.bfloat16,
                aligned: bool = True) -> KernelLaunch:
    """The launch ``det_gram`` makes for x ``(m, n, d)`` of ``dtype``
    (``aligned``: the base is 16-byte aligned).

    TMA kernel: a persistent grid sized on the card (``grid_rule=
    "occupancy"``: resident CTAs, at most one per item) of 384 threads, the
    stage ring and the barriers as dynamic shared memory; per item (two
    neighbouring upper-triangle tiles of one worker, 128 x 256 entries) a
    CTA reads the item's 128 + 256 columns of x over all of n through its
    ring and writes the entries and their mirror. The other two kernels:
    one CTA per upper-triangle tile, grid ``(tiles (tiles + 1) / 2, 1, m)``
    of 256 threads; 128 x 128 tiles for bf16, :func:`f32_tile` for fp32,
    whose CTA reads the tile's two column slabs of x over all of n through
    a ring of ``F_STAGES`` stages of ``F_BK`` rows (dynamic shared memory)
    and writes the tile and its mirror from registers."""
    w = min(TILE, d)
    if takes_tma(d, dtype, aligned):
        w2 = min(2 * TILE, d)  # an item's columns
        return KernelLaunch(
            kernel="gram_bf16_tma_kernel",
            source="csrc/gram.cu",
            grid=None,
            threads=T_THREADS,
            dynamic_smem=T_SMEM_BYTES,
            static_smem=0,
            operands=(("x cols i (item)", (n, w)), ("x cols j (item)", (n, w2)),
                      ("x staged", (T_STAGES * T_BK, 3 * TILE)),
                      ("G block (item)", (w, w2)), ("G mirrored (item)", (w2, w))),
            grid_rule="occupancy",
        )
    if dtype == torch.float32:
        edge = f32_tile(m, d)
        w = min(edge, d)
        kernel = f"gram_f32_kernel<{edge}, {f32_vec(d, aligned)}>"
        threads, smem = F_THREADS, F_STAGES * 2 * F_BK * edge * 4
        staged = (("x staged", (F_STAGES * F_BK, 2 * edge)),)
    else:
        edge, kernel, threads, smem, staged = TILE, "gram_bf16_kernel", THREADS, SMEM_BYTES, ()
    tiles = -(-d // edge)
    slabs = (("x cols i (item)", (n, w)), ("x cols j (item)", (n, w)))
    tiles_out = (("G tile (item)", (w, w)), ("G mirrored (item)", (w, w)))
    return KernelLaunch(
        kernel=kernel,
        source="csrc/gram.cu",
        grid=(tiles * (tiles + 1) // 2, 1, m),
        threads=threads,
        dynamic_smem=smem,
        static_smem=0,
        operands=slabs + staged + tiles_out,
    )


@functools.lru_cache(maxsize=1024)
def _launch_on(device_index: int, m: int, n: int, d: int, dtype,
               aligned: bool) -> KernelLaunch:
    """:func:`gram_launch` with the grid the card sizes for it
    (``det_gram_grid`` on ``device_index``) where that grid is persistent."""
    launch = gram_launch(m, n, d, dtype, aligned)
    if launch.grid is not None:
        return launch
    with torch.cuda.device(device_index):
        gx = _lib().det_gram_grid(m, n, d, _DTYPE_CODES[dtype], int(aligned))
    if gx < 1:
        raise RuntimeError(f"gram grid query failed: CUDA error {-gx}")
    return launch.resolved((gx, 1, 1))


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


@functools.lru_cache(maxsize=1)  # argtypes set once, not per launch
def _lib():
    lib = _build.load("gram")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.det_gram.argtypes = [ptr, ptr, i, i, i, i, ctypes.c_float, i, ptr]
    lib.det_gram.restype = i
    lib.det_gram_grid.argtypes = [i, i, i, i, i]
    lib.det_gram_grid.restype = i
    return lib


def gram_cuda(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """``(m, n, d)`` (or ``(n, d)``) CUDA fp32/bf16 -> ``(m, d, d)`` fp32
    Gram by the hand-written kernels (``csrc/gram.cu``; which one is
    :func:`takes_tma`'s rule)."""
    global launches, launches_tma
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
    aligned = x.data_ptr() % 16 == 0
    tma = takes_tma(d, x.dtype, aligned)
    if m > 65535 and not tma:  # grid.z, one block row per worker
        raise ValueError(f"gram_cuda takes at most 65535 workers, got {m}")
    launch = _launch_on(x.device.index, m, n, d, x.dtype, aligned)
    out = torch.empty((m, d, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().det_gram(
            x.data_ptr(), out.data_ptr(), m, n, d, _DTYPE_CODES[x.dtype],
            float(n) if normalize else 1.0, int(aligned), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
        launches_tma += tma
    note(launch)
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
