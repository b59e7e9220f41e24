"""The large-d solver's fused inner sweep ``(w, g) = (C (C^T v), w^T w)``: the
Hopper kernel and its plain PyTorch version.

Counterpart of ``matvec_gram_pallas`` in ``distributed_eigenspaces_tpu/ops/
pallas_gram.py`` and of the XLA pair ``fused_factor_matvec`` falls back to.
:func:`matvec_gram_cuda` launches the kernel of ``csrc/matvec_gram.cu`` on
CUDA tensors (one cooperative launch in clusters of two blocks: per slab of
d rows the partial ``C^T v``, added pairwise on chip, their sum ``y``, the
slab's rows of ``w`` and the partial of their Gram, added the same way,
their sum, each sum in a fixed order, so the result is bit-identical from
run to run and ``g`` exactly symmetric); :func:`matvec_gram_plain`
computes the same function with ``torch.matmul`` and is what CPU tensors
get. :func:`matvec_gram_auto` dispatches on the device alone: a CUDA tensor
always goes to the kernel, which masks ragged d, f and k' (no block-legality
fallback) and raises on anything it does not take.
:func:`matvec_gram_launch` is its launch geometry, with the plan
(:func:`matvec_gram_plan`: the slab stays in shared memory, or is streamed
where it does not fit beside ``y``, in shared memory that no f enters, so
any f and k' up to :data:`MAX_K` fit); the wrapper fills in the cooperative
grid the card sizes (``det_matvec_gram_grid``), launches that grid and
records the launch (``ops/geometry.py``) for the analyzer.
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

_INT_MAX = 2**31 - 1

# the kernel's launch constants (csrc/matvec_gram.cu, namespace scope;
# tests/test_torch_analysis.py reads them from the source)
THREADS = 256
WARPS = THREADS // 32
SLABS = 132  # slabs of d: one per SM of an H100
PAIR = 2  # blocks of a cluster: their partials are added on chip
RC = 32  # rows of a staged chunk
AQ = 2  # phase A: a lane's f quads (4 indices each)
AC = 3  # phase A: a lane's groups of 4 columns
PASS_QP = 32  # phase A: pairs of f quads a pass covers at most
PASS_CG = 16  # phase A: groups of AC column quads a pass covers at most
TR_RESIDENT = 12  # phase C rows per warp per pass, resident plan
TR_STREAMED = 4  # phase C rows per warp per pass, streamed plan
ST_STREAMED = 3  # streamed plan: chunks in a ring
FC = 64  # streamed phase C: f indices of a staged chunk
KC = 64  # phase C: columns of a column pass
SUM_MIN = 4 * SLABS  # phases B, D stage 4 entries of every slab at least
SMEM_MAX = 232448  # bytes a block may use on Hopper


def _wstride(kp: int) -> int:
    """``wstride``: a row of w in shared memory, ``kp`` padded to 16
    modulo 32 floats."""
    return kp + (16 - kp) % 32


def _pass(kp: int) -> tuple[int, int]:
    """Phase A's rectangle: ``(pq, pc)`` pairs of f quads by groups of
    ``AC`` column quads, at most one block per lane pair."""
    pc = min(-(-(kp // 4) // AC), PASS_CG)
    return min(THREADS // 2 // pc, PASS_QP), pc


def _rect(kp: int) -> tuple[int, int, int]:
    """``(kp, fw, kw)``: phase A's rectangle in f indices and columns."""
    pq, pc = _pass(kp)
    return kp, 4 * AQ * pq, 4 * AC * pc


def _resident_floats(fp: int, kp: int, nchunk: int, fw: int, kw: int) -> int:
    """``resident_floats``: the whole slab of C, then a region for the
    largest of the slab of v with a pass's partial (phase A), the staged
    partials (phases B, D) and y, a pass's rows of w and the Gram tile
    (phase C)."""
    return nchunk * RC * fp + max(nchunk * RC * kp + fw * kw, SUM_MIN,
                                  fp * kp + WARPS * TR_RESIDENT * _wstride(kp) + kp * kp)


def _streamed_floats(kp: int, fw: int, kw: int) -> int:
    """``streamed_floats``, which no f enters: phase A's ring of a pass's
    columns with its partial, the staged partials, phase C's ring of
    ``(rows, FC)`` of C and ``(FC, KC)`` of y with a pass's rows of w."""
    pr = WARPS * TR_STREAMED
    return max(ST_STREAMED * RC * (fw + kw) + fw * kw, SUM_MIN,
               ST_STREAMED * (pr * FC + FC * KC) + pr * _wstride(kp))


@functools.lru_cache(maxsize=256)
def matvec_gram_plan(d: int, f: int, k: int) -> dict:
    """``make_plan`` of the C host code: slabs of d (``rows`` each, in
    ``nchunk`` chunks of ``RC`` rows), phase A's rectangle (``pq`` by
    ``pc``), whether a slab stays in shared memory (``resident``, the ring
    holding every chunk) or streams through ``ST_STREAMED`` stages, and
    the dynamic shared memory in bytes (``fits``: within ``SMEM_MAX``)."""
    fp, kp = -(-f // 4) * 4, -(-k // 4) * 4
    rows = -(-d // SLABS)
    nchunk = -(-rows // RC)
    pq, pc = _pass(kp)
    _, fw, kw = _rect(kp)
    smem = 4 * _resident_floats(fp, kp, nchunk, fw, kw)
    resident = smem <= SMEM_MAX
    if not resident:
        smem = 4 * _streamed_floats(kp, fw, kw)
    return dict(fp=fp, kp=kp, rows=rows, nslab=-(-d // rows), nchunk=nchunk, pq=pq, pc=pc,
                resident=resident, stages=nchunk if resident else ST_STREAMED,
                tr=TR_RESIDENT if resident else TR_STREAMED, smem=smem,
                fits=smem <= SMEM_MAX)


def _max_k() -> int:
    """The widest iterate the streamed plan fits: its shared memory grows
    with k' alone (a pass's rows of w), so every d and f up to it fit."""
    k = 1
    while 4 * _streamed_floats(*_rect(-(-(k + 1) // 4) * 4)) <= SMEM_MAX:
        k += 1
    return k


#: widest iterate the kernel takes, from the streamed plan's rule
MAX_K = _max_k()


@functools.lru_cache(maxsize=256)  # pure, and the record is frozen
def matvec_gram_launch(d: int, f: int, k: int) -> KernelLaunch:
    """The cooperative launch ``det_matvec_gram`` makes for C ``(d, f)`` and
    v ``(d, k)`` fp32: ``matvec_gram_kernel<TR>`` of the plan (``TR_RESIDENT``
    or ``TR_STREAMED``), 256 threads, dynamic shared memory from the plan, a
    grid sized on the card (``grid_rule="occupancy"``: as many clusters of
    ``PAIR`` blocks as stay resident, at most one block per slab, rounded up
    to a whole pair). A CTA's extents are per slab: it reads the slab of C
    and of v, stages chunks of C (resident: the whole slab), writes the
    slab's ``C^T v`` partial, reads all of y, writes the slab's rows of w
    and their Gram partial."""
    p = matvec_gram_plan(d, f, k)
    rows = min(p["rows"], d)
    staged = (p["stages"] * RC, p["fp"]) if p["resident"] else (ST_STREAMED * RC, 4 * AQ * p["pq"])
    return KernelLaunch(
        kernel=f"matvec_gram_kernel<{p['tr']}>",
        source="csrc/matvec_gram.cu",
        grid=None,
        threads=THREADS,
        dynamic_smem=p["smem"],
        static_smem=0,
        operands=(
            ("C (slab)", (rows, f)),
            ("v (slab)", (rows, k)),
            ("C staged", staged),
            ("C^T v partial (slab)", (f, k)),
            ("y = C^T v", (f, k)),
            ("w (slab)", (rows, k)),
            ("w^T w partial (slab)", (k, k)),
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
    if k > MAX_K or d > _INT_MAX or f * k > _INT_MAX:
        raise ValueError(
            f"matvec_gram_cuda takes k <= {MAX_K}, d < 2**31 and f * k < 2**31, got "
            f"{(d, f, k)}"
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
