"""The large-d solver's fused inner sweep ``(w, g) = (C (C^T v), w^T w)``: the
Hopper kernel and its plain PyTorch version.

Counterpart of ``matvec_gram_pallas`` in ``distributed_eigenspaces_tpu/ops/
pallas_gram.py`` and of the XLA pair ``fused_factor_matvec`` falls back to.
:func:`matvec_gram_cuda` launches the kernel of ``csrc/matvec_gram.cu`` on
CUDA tensors (one cooperative launch: block partials of ``C^T v``, their
sum, ``w`` with partials of its Gram, their sum, each sum in a fixed order,
so the result is bit-identical from run to run and ``g`` exactly
symmetric); :func:`matvec_gram_plain`
computes the same function with ``torch.matmul`` and is what CPU tensors
get. :func:`matvec_gram_auto` dispatches on the device alone: a CUDA tensor
always goes to the kernel, which masks ragged d, f and k' (no block-legality
fallback) and raises on anything it does not take.
:func:`matvec_gram_launch` is its launch geometry; the wrapper fills in the
cooperative grid the card sizes (``det_matvec_gram_grid``), launches that
grid and records the launch (``ops/geometry.py``) for the analyzer.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from distributed_eigenspaces_tpu_torch.ops import _build
from distributed_eigenspaces_tpu_torch.ops.geometry import KernelLaunch, note

#: calls of :func:`matvec_gram_cuda` that launched the kernel (one per call,
#: counted under a lock); callers reset it to 0 before a run they count
launches = 0
_count_lock = threading.Lock()

#: widest iterate the kernel takes: each block keeps 64 rows of w (64, k')
#: in shared memory (rows padded to a multiple of 4) beside its staging
#: tiles, within Hopper's 227 KB
MAX_K = 840
_INT_MAX = 2**31 - 1

# the kernel's launch constants (csrc/matvec_gram.cu, namespace scope;
# tests/test_torch_analysis.py reads them from the source)
THREADS = 256
A_FT = 64  # phase A: f indices per tile
A_KC = 64  # phase A: columns of v per chunk
A_RC = 32  # phase A: rows per staged chunk
A_TARGET_ITEMS = 264  # phase A: two items per SM on 132 SMs
C_R = 64  # phase C: rows of w per item
C_KC = 64  # phase C: columns per chunk
C_FC = 32  # phase C: f indices per staged chunk
C_CST = C_R + 4  # phase C: row stride of the transposed C tile
SMEM_MAX = 232448  # bytes a block may use on Hopper


def _plan(d: int, f: int, k: int) -> dict:
    """``make_plan`` of the C host code: phase A's tiles and slabs, phase
    C's row items, and the dynamic shared memory (bytes)."""
    ntile = -(-f // A_FT)
    max_slabs = -(-d // A_RC)
    nslab = min(max(-(-A_TARGET_ITEMS // ntile), 1), max_slabs)
    per = -(-d // nslab)
    slab_rows = -(-per // A_RC) * A_RC
    pad4 = (k + 3) & ~3
    smem_a = A_RC * (A_FT + A_KC)
    smem_c = C_R * pad4 + C_FC * (C_CST + C_KC)
    return dict(ntile=ntile, nslab=-(-d // slab_rows), slab_rows=slab_rows,
                nblk=-(-d // C_R), smem=4 * max(smem_a, smem_c))


@functools.lru_cache(maxsize=256)  # pure, and the record is frozen
def matvec_gram_launch(d: int, f: int, k: int) -> KernelLaunch:
    """The cooperative launch ``det_matvec_gram`` makes for C ``(d, f)`` and
    v ``(d, k)`` fp32: 256 threads, dynamic shared memory from the plan, a
    grid sized on the card (``grid_rule="occupancy"``, at most one block per
    item). A CTA's extents are per item of each phase: phase A reads one slab
    of C's rows in one 64-wide f tile with the slab of v and writes that
    tile's partial; phase C reads 64 rows of C across f and all of y, and
    writes its 64 rows of w and a k x k Gram partial."""
    p = _plan(d, f, k)
    rows_a, tile_a, rows_c = min(p["slab_rows"], d), min(A_FT, f), min(C_R, d)
    return KernelLaunch(
        kernel="matvec_gram_kernel",
        source="csrc/matvec_gram.cu",
        grid=None,
        threads=THREADS,
        dynamic_smem=p["smem"],
        static_smem=0,
        operands=(
            ("C (phase A item)", (rows_a, tile_a)),
            ("v (phase A item)", (rows_a, k)),
            ("C^T v partial (phase A item)", (tile_a, k)),
            ("y = C^T v (phase C item)", (f, k)),
            ("C (phase C item)", (rows_c, f)),
            ("w (phase C item)", (rows_c, k)),
            ("w^T w partial (phase C item)", (k, k)),
        ),
        grid_rule="occupancy",
    )


def matvec_gram_plain(c: torch.Tensor, v: torch.Tensor):
    """``(w, g)`` with ``w = C (C^T v)`` and ``g = w^T w`` in fp32 for
    ``C (d, f)`` and ``v (d, k')``: the reference's unfused XLA pair."""
    y = torch.matmul(c.mT, v)
    w = torch.matmul(c, y)
    return w, torch.matmul(w.mT, w)


@functools.lru_cache(maxsize=256)
def _launch_on(d: int, f: int, k: int, blocks: int) -> KernelLaunch:
    """:func:`matvec_gram_launch` with the grid the card sized for it."""
    return matvec_gram_launch(d, f, k).resolved((blocks, 1, 1))


def _lib():
    lib = _build.load("matvec_gram")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.det_matvec_gram_workspace.argtypes = [i, i, i]
    lib.det_matvec_gram_workspace.restype = ctypes.c_size_t
    lib.det_matvec_gram_grid.argtypes = [i, i, i]
    lib.det_matvec_gram_grid.restype = i
    lib.det_matvec_gram.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, i, ptr]
    lib.det_matvec_gram.restype = i
    return lib


def matvec_gram_cuda(c: torch.Tensor, v: torch.Tensor):
    """``(w, g)`` by the hand-written kernel: ``C (d, f)`` and ``v (d, k')``
    fp32, contiguous on one card; ``w (d, k')`` and ``g (k', k')`` fp32."""
    global launches
    if not (c.is_cuda and v.is_cuda):
        raise ValueError(
            f"matvec_gram_cuda takes CUDA tensors, got C on {c.device} and v "
            f"on {v.device}"
        )
    if c.device != v.device:
        raise ValueError(f"matvec_gram_cuda: C on {c.device}, v on {v.device}")
    if c.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(
            f"matvec_gram_cuda takes float32 C and v, got {c.dtype} and {v.dtype}"
        )
    if c.dim() != 2 or v.dim() != 2 or c.shape[0] != v.shape[0]:
        raise ValueError(
            f"matvec_gram_cuda takes C (d, f) and v (d, k), got "
            f"{tuple(c.shape)} and {tuple(v.shape)}"
        )
    if not (c.is_contiguous() and v.is_contiguous()):
        raise ValueError("matvec_gram_cuda takes contiguous tensors")
    d, f = c.shape
    k = v.shape[1]
    if min(d, f, k) < 1:
        raise ValueError(f"matvec_gram_cuda needs non-empty operands, got {(d, f, k)}")
    if k > MAX_K or d > _INT_MAX or f > _INT_MAX:
        raise ValueError(
            f"matvec_gram_cuda takes k <= {MAX_K} and d, f < 2**31, got {(d, f, k)}"
        )
    lib = _lib()
    w = torch.empty((d, k), dtype=torch.float32, device=c.device)
    g = torch.empty((k, k), dtype=torch.float32, device=c.device)
    ws = torch.empty(
        (lib.det_matvec_gram_workspace(d, f, k),), dtype=torch.uint8, device=c.device
    )
    with torch.cuda.device(c.device):
        blocks = lib.det_matvec_gram_grid(d, f, k)
        if blocks < 1:
            raise RuntimeError(f"matvec_gram grid query failed: CUDA error {-blocks}")
        launch = _launch_on(d, f, k, blocks)
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.det_matvec_gram(
            c.data_ptr(), v.data_ptr(), w.data_ptr(), g.data_ptr(), ws.data_ptr(),
            d, f, k, launch.grid[0], stream,
        )
    if rc != 0:
        raise RuntimeError(f"matvec_gram kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
    note(launch)
    return w, g


def matvec_gram_auto(c: torch.Tensor, v: torch.Tensor):
    """The fused sweep on the tensors' own device: the kernel for CUDA
    tensors (always; no fallback), the plain version for CPU ones."""
    if c.device.type == "cuda":
        return matvec_gram_cuda(c, v)
    if c.device.type == "cpu":
        return matvec_gram_plain(c, v)
    raise ValueError(f"matvec_gram_auto: unsupported device {c.device}")
