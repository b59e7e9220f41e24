"""The Gram ``X^T X / n`` of a batch of worker blocks: the Hopper kernels and
their plain PyTorch versions.

Counterpart of ``distributed_eigenspaces_tpu/ops/pallas_gram.py``
(``gram_pallas`` / ``gram_auto``). :func:`gram_cuda` launches the kernels
of ``csrc/gram.cu`` on CUDA tensors; :func:`gram_plain` computes the same
function with ``torch.matmul`` and is what CPU tensors get. :func:`gram_auto`
dispatches on the tensor's device only: a CUDA tensor always goes to a
kernel, which raises on anything it does not take.

int8 blocks (the int8 stage) follow the reference's integer rule
(:func:`widen_int`): while ``n * 127^2 < 2^31`` their int32 sums are exact
and they take :func:`gram_s8_cuda` (``csrc/gram_s8.cu``, the port's
kernels for the reference's XLA int32 einsum: a transpose into a scratch,
then a TMA + ``wgmma`` s8 kernel) or its plain version
:func:`gram_s8_plain`; past that guard, and for any other integer dtype,
the block is widened to fp32 and takes the fp32 route. Nothing widens int8
to bf16 to reach the bf16 kernel.

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
#: calls of :func:`gram_s8_cuda`, each one transpose and one TMA launch,
#: counted the same way
launches_s8 = 0
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
# the int8 route's launch constants (csrc/gram_s8.cu)
X_TILE = 128  # gram_s8_transpose_kernel: n rows x d columns of x per CTA
X_THREADS = 256
X_SMEM_BYTES = X_TILE * X_TILE  # static: the tile, one byte an element
S_PAD = 16  # x^T's rows (n) are padded to a multiple of 16 bytes: TMA strides
S_TILE = 128  # gram_s8_tma_kernel: output tile edge (an item is 128 x 256)
S_BK = 128  # bytes of n per stage: four k32 steps
S_STAGES = 3  # stages in its ring
S_THREADS = 3 * 128  # two consumer warpgroups and a producer warpgroup
S_EPI_BOX = 32  # its epilogue's TMA store box edge (fp32)
S_EPI_BUFS = 2  # staging buffers per consumer warpgroup
# the ring (per stage 128 rows of x^T for the item's rows, 256 for its
# columns), the epilogue's staging (per buffer a 64 x 32 chunk and its
# mirror), the barriers, alignment
S_SMEM_BYTES = (S_STAGES * 3 * S_TILE * S_BK + 2 * S_EPI_BUFS * 4 * S_EPI_BOX**2 * 4
                + 2 * S_STAGES * 8 + 1024)
#: int8 sums of n rows stay exact in int32 while n * 127^2 < 2^31 (the
#: reference's guard, ``ops/linalg.py:64``)
S8_SUM_LIMIT = 2**31


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


def s8_exact(n: int) -> bool:
    """The reference's guard: the int32 sums of ``n`` rows of int8 are
    exact (``n * 127^2 < 2^31``, n < 133,144)."""
    return n * 127 * 127 < S8_SUM_LIMIT


def widen_int(x: torch.Tensor) -> torch.Tensor:
    """The reference's integer rule for a Gram: int8 whose sums stay exact
    in int32 (:func:`s8_exact`) is returned as it is; int8 past the guard
    and every other integer dtype are widened to fp32 (the reference's
    fp32 contraction at ``Precision.HIGHEST``: integer sums in the input
    dtype would wrap); floats are returned as they are."""
    if x.dtype == torch.int8 and s8_exact(x.shape[-2]):
        return x
    if not x.is_floating_point():
        return x.float()
    return x


def s8_pad(n: int) -> int:
    """``n_pad``, the row length of x^T: n rounded up to a multiple of
    :data:`S_PAD` (16 bytes), so that TMA can read x^T for every n."""
    return -(-n // S_PAD) * S_PAD


def transpose_vec(d: int, aligned: bool = True) -> int:
    """``gram_s8_transpose_kernel``'s load width in bytes: 16 where every
    row of x is 16-byte aligned (``d % 16 == 0`` on an aligned base), else
    1."""
    return 16 if aligned and d % 16 == 0 else 1


def tma_store_rows(d: int) -> bool:
    """Whether ``gram_s8_tma_kernel`` writes G with TMA stores: its rows of
    ``4 d`` bytes are 16-byte strides (``d % 4 == 0``); else it stores from
    registers."""
    return d % 4 == 0


@functools.lru_cache(maxsize=256)  # pure, and the records are frozen
def gram_s8_launch(m: int, n: int, d: int,
                   aligned: bool = True) -> tuple[KernelLaunch, KernelLaunch]:
    """The two launches ``det_gram_s8`` makes for int8 x ``(m, n, d)``, in
    order.

    ``gram_s8_transpose_kernel<VEC>``: one CTA per 128 x 128 tile of one
    worker's block, grid ``(ceil(n_pad / 128), ceil(d / 128), m)`` of 256
    threads, the tile as static shared memory; it writes the tile's
    transpose into x^T ``(m, d, n_pad)`` (:func:`s8_pad`), the pad rows as
    zeros. ``gram_s8_tma_kernel<TMA_STORE>``: a persistent grid sized on
    the card (``grid_rule="occupancy"``: resident CTAs, at most one per
    item) of 384 threads, the stage ring, the epilogue's staging and the
    barriers as dynamic shared memory; per item (two neighbouring
    upper-triangle tiles of one worker, 128 x 256 entries) a CTA reads the
    item's 128 + 256 rows of x^T over all of n_pad through its ring and
    writes the entries and their mirror, with TMA stores of 32 x 32 boxes
    where :func:`tma_store_rows` holds, else from registers."""
    n_pad = s8_pad(n)
    w, w2 = min(S_TILE, d), min(2 * S_TILE, d)  # an item's rows and columns
    transpose = KernelLaunch(
        kernel=f"gram_s8_transpose_kernel<{transpose_vec(d, aligned)}>",
        source="csrc/gram_s8.cu",
        grid=(-(-n_pad // X_TILE), -(-d // X_TILE), m),
        threads=X_THREADS,
        dynamic_smem=0,
        static_smem=X_SMEM_BYTES,
        operands=(("x tile (item)", (min(X_TILE, n), min(X_TILE, d))),
                  ("x staged", (X_TILE, X_TILE)),
                  ("x^T tile (item)", (min(X_TILE, d), min(X_TILE, n_pad)))),
    )
    tma = KernelLaunch(
        kernel=f"gram_s8_tma_kernel<{str(tma_store_rows(d)).lower()}>",
        source="csrc/gram_s8.cu",
        grid=None,
        threads=S_THREADS,
        dynamic_smem=S_SMEM_BYTES,
        static_smem=0,
        operands=(("x^T rows i (item)", (w, n_pad)), ("x^T rows j (item)", (w2, n_pad)),
                  ("x^T staged", (S_STAGES * 3 * S_TILE, S_BK)),
                  ("G staged", (2 * S_EPI_BUFS * 2 * S_EPI_BOX, 2 * S_EPI_BOX)),
                  ("G block (item)", (w, w2)), ("G mirrored (item)", (w2, w))),
        grid_rule="occupancy",
    )
    return transpose, tma


@functools.lru_cache(maxsize=1024)
def _s8_launch_on(device_index: int, m: int, n: int, d: int,
                  aligned: bool) -> tuple[KernelLaunch, KernelLaunch]:
    """:func:`gram_s8_launch` with the TMA kernel's grid the card sizes for
    it (``det_gram_s8_grid`` on ``device_index``)."""
    transpose, tma = gram_s8_launch(m, n, d, aligned)
    with torch.cuda.device(device_index):
        gx = _lib_s8().det_gram_s8_grid(m, d)
    if gx < 1:
        raise RuntimeError(f"gram_s8 grid query failed: CUDA error {-gx}")
    return transpose, tma.resolved((gx, 1, 1))


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


def gram_s8_plain(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """``(..., n, d)`` int8 -> ``(..., d, d)`` fp32 ``f32(X^T X)`` (divided
    by n when ``normalize``): the products summed in float64, which is
    exact while the sums stay under 2^53, then rounded once to fp32 and
    divided by n with a true division (by an fp32 tensor on x's device:
    PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal). Bit for bit the reference's int32 einsum,
    ``.astype(float32)`` and ``/ n``."""
    n = x.shape[-2]
    xd = x.double()
    g = torch.matmul(xd.mT, xd).float()
    if normalize:
        g = g / torch.tensor(float(n), dtype=torch.float32, device=g.device)
    return g


def gram_s8_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """``(..., n, d)`` int8 -> ``(..., d, n_pad)`` int8: ``x.mT`` with zero
    columns from n to ``n_pad`` (:func:`s8_pad`), what
    ``gram_s8_transpose_kernel`` writes into its scratch."""
    n, d = x.shape[-2:]
    xt = x.new_zeros(x.shape[:-2] + (d, s8_pad(n)))
    xt[..., :n] = x.mT
    return xt


@functools.lru_cache(maxsize=1)  # argtypes set once, not per launch
def _lib_s8():
    lib = _build.load("gram_s8")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.det_gram_s8.argtypes = [ptr, ptr, ptr, i, i, i, ctypes.c_float, i, ptr]
    lib.det_gram_s8.restype = i
    lib.det_gram_s8_transpose.argtypes = [ptr, ptr, i, i, i, i, ptr]
    lib.det_gram_s8_transpose.restype = i
    lib.det_gram_s8_grid.argtypes = [i, i]
    lib.det_gram_s8_grid.restype = i
    return lib


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


def _s8_operand(x: torch.Tensor, who: str) -> torch.Tensor:
    """x as ``(m, n, d)``, checked for what the s8 kernels take."""
    if not x.is_cuda:
        raise ValueError(f"{who} takes a CUDA tensor, got device {x.device}")
    if x.dtype != torch.int8:
        raise ValueError(f"{who} takes int8, got {x.dtype}")
    if x.dim() == 2:
        x = x.unsqueeze(0)
    if x.dim() != 3:
        raise ValueError(f"{who} takes (m, n, d) or (n, d), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{who} takes a contiguous tensor")
    m, n, d = x.shape
    if min(m, n, d) < 1:
        raise ValueError(f"{who} needs a non-empty input, got {tuple(x.shape)}")
    if m > 65535:  # grid.z of the transpose, one block row per worker
        raise ValueError(f"{who} takes at most 65535 workers, got {m}")
    return x


def gram_s8_transpose_cuda(x: torch.Tensor) -> torch.Tensor:
    """``(m, n, d)`` (or ``(n, d)``) CUDA int8 -> ``(m, d, n_pad)`` int8:
    ``gram_s8_transpose_kernel`` alone, the first launch of
    :func:`gram_s8_cuda`, for holding it against
    :func:`gram_s8_transpose_plain`."""
    squeeze = x.dim() == 2
    x = _s8_operand(x, "gram_s8_transpose_cuda")
    m, n, d = x.shape
    aligned = x.data_ptr() % 16 == 0
    xt = torch.empty((m, d, s8_pad(n)), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib_s8().det_gram_s8_transpose(
            x.data_ptr(), xt.data_ptr(), m, n, d, int(aligned), stream)
    if rc != 0:
        raise RuntimeError(f"gram_s8 transpose launch failed: CUDA error {rc}")
    note(gram_s8_launch(m, n, d, aligned)[0])
    return xt[0] if squeeze else xt


def gram_s8_cuda(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """``(m, n, d)`` (or ``(n, d)``) CUDA int8 -> ``(m, d, d)`` fp32 Gram by
    the hand-written s8 kernels (``csrc/gram_s8.cu``): x transposed into a
    scratch of ``m * d * n_pad`` bytes, then exact int32 sums on the tensor
    cores, converted once and divided by n. Raises past :func:`s8_exact`'s
    guard, where the sums would wrap (:func:`gram_auto` widens there)."""
    global launches_s8
    squeeze = x.dim() == 2
    x = _s8_operand(x, "gram_s8_cuda")
    m, n, d = x.shape
    if not s8_exact(n):
        raise ValueError(
            f"gram_s8_cuda: n={n} rows of int8 can sum past 2^31 in int32 "
            "(n * 127^2 >= 2^31); widen to fp32"
        )
    aligned = x.data_ptr() % 16 == 0
    pair = _s8_launch_on(x.device.index, m, n, d, aligned)
    xt = torch.empty((m, d, s8_pad(n)), dtype=torch.int8, device=x.device)
    out = torch.empty((m, d, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib_s8().det_gram_s8(
            x.data_ptr(), xt.data_ptr(), out.data_ptr(), m, n, d,
            float(n) if normalize else 1.0, int(aligned), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gram_s8 kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches_s8 += 1
    for launch in pair:
        note(launch)
    return out[0] if squeeze else out


def gram_auto(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """The Gram of a worker batch on the tensor's own device: a kernel for
    a CUDA tensor (always; no fallback), the plain version for a CPU
    tensor. Integer blocks first take :func:`widen_int`'s rule: int8 within
    the guard goes to the s8 kernel (or its plain version), the rest is
    fp32."""
    x = widen_int(x)
    s8 = x.dtype == torch.int8
    if x.device.type == "cuda":
        return (gram_s8_cuda if s8 else gram_cuda)(x, normalize=normalize)
    if x.device.type == "cpu":
        return (gram_s8_plain if s8 else gram_plain)(x, normalize=normalize)
    raise ValueError(f"gram_auto: unsupported device {x.device}")
