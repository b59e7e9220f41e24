"""The read path's projections ``z = x @ v``: the Hopper serve kernels, their
plain PyTorch versions, and the int8 basis codec.

Counterpart of the serve family of ``distributed_eigenspaces_tpu/ops/
pallas_gram.py`` (``serve_project_pallas``, ``serve_project_i8_pallas``,
``quantize_basis_i8``). Both routes round x and the basis to bf16
(round-to-nearest-even) and sum the exact products in fp32; the int8 route
multiplies each of the k sums by its column's scale once, after the whole
d reduction.

:func:`serve_project_cuda` / :func:`serve_project_i8_cuda` launch the
kernels of ``csrc/serve_project.cu`` on CUDA tensors; the ``*_plain``
versions compute the same functions with ``torch.matmul`` and are what CPU
tensors get. The ``*_auto`` functions dispatch on the device alone: a CUDA
tensor always goes to the kernel, which takes every shape (ragged rows, d
and k are masked in the kernel) and raises on anything else.

:func:`serve_project_f32_cuda` is the port's fixed-order fp32 projection
(``det_serve_project_f32``, no TPU kernel's port: the JAX package computes
fp32 with XLA at ``Precision.HIGHEST``): the same split kernel with the
basis staged unrounded, fp32 x and fp32 sums. Each row is summed in an
order that depends on (d, k) alone, so a row served in a padded bucket
equals its direct projection bit for bit; :func:`project_exact` routes
both the engine's ``"float32"`` projection and
``OnlineDistributedPCA.transform`` through it.

:func:`serve_project_launch` is the launch geometry all three make (grid,
threads, shared memory, what one CTA owns, and the order in which each row
is summed); each ``*_cuda`` wrapper records it (``ops/geometry.py``) for
the analyzer. The kernel runs on a persistent grid that the card sizes
from its occupancy (``det_serve_project_grid``); the wrapper resolves the
record with it.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from distributed_eigenspaces_tpu_torch.ops import _build
from distributed_eigenspaces_tpu_torch.ops.geometry import KernelLaunch, note

#: launches made by :func:`serve_project_cuda`, :func:`serve_project_i8_cuda`
#: and :func:`serve_project_f32_cuda`
#: (one per call, counted under a lock: serve lanes launch from their own
#: threads); callers reset them to 0 before a run whose launches they count
launches = 0
launches_i8 = 0
launches_f32 = 0
_count_lock = threading.Lock()

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1

# the kernels' launch constants (csrc/serve_project.cu, namespace scope;
# tests/test_torch_analysis.py reads them from the source)
WARPS = 8
THREADS = 256  # 8 warps
MAX_PAIRS = 8  # column pairs per CTA: 16 columns of the basis
#: the kernels tile k in grid.y blocks of 16 columns
MAX_K = 65535 * 2 * MAX_PAIRS
S_ROWS = 4  # rows per item
S_GB = 2  # d groups per warp per load batch
S_BASIS_WORDS = 24576  # staged basis words per CTA at most (bf16, int8)
S_F32_BASIS_WORDS = 49152  # the same for the fp32 basis
S_MIN_CTAS = 2  # the kernel's __launch_bounds__ minimum of resident CTAs
S_SPREAD_ITEMS = 264  # items (4-row groups) from which a column tile takes all of k

#: template argument B of the kernels per basis route
_BASIS = {"bf16": 0, "i8": 1, "f32": 2}
_XT = {torch.float32: "float", torch.bfloat16: "unsigned short"}
#: x values per 16-byte load
_VEC = {torch.float32: 4, torch.bfloat16: 8}


def split_plan(rows: int, d: int, k: int, x_dtype=torch.float32,
               basis: str = "bf16") -> dict:
    """The split kernel's plan for x ``(rows, d)`` of ``x_dtype`` and a
    ``(d, k)`` basis (``basis`` "bf16", "i8" or "f32"), as its host code
    makes it (``split_np``, ``slot_words``, ``split_slots``,
    ``split_smem``): column pairs per tile (all of k, up to 16 columns,
    from ``S_SPREAD_ITEMS`` 4-row items on; one pair below, so that a small
    launch spreads over more SMs), the column tiles, the d group (one
    16-byte load per lane), the words a staged basis row takes (``np | 1``
    bf16 pairs, or ``2 np + 1`` fp32 values), the d slots (rows) staged at
    once within the route's budget, and the dynamic shared memory in
    bytes."""
    items = -(-rows // S_ROWS)
    np_ = 1 if items < S_SPREAD_ITEMS else min(MAX_PAIRS, (k + 1) // 2)
    group = 32 * _VEC[x_dtype]
    words = 2 * np_ + 1 if basis == "f32" else np_ | 1
    budget = S_F32_BASIS_WORDS if basis == "f32" else S_BASIS_WORDS
    cap = budget // words // group * group
    ds = min(-(-d // group) * group, cap)
    return dict(np=np_, tiles=-(-k // (2 * np_)), group=group, words=words, ds=ds,
                smem=4 * (words * ds + 2 * WARPS * S_ROWS * 2 * np_))


def split_order(rows: int, d: int, k: int, x_dtype=torch.float32,
                basis: str = "bf16") -> tuple:
    """The order in which the split kernel sums every output of a row, as
    data, walked as the kernel walks it for this launch: over the staged d
    chunks of :func:`split_plan` (whose size varies with the row count),
    warp ``w`` takes the chunk's d groups ``g = w (mod 8)`` in ascending
    order (a lane ``vec`` values of each, ``32 * vec`` indices per group);
    the lanes finish with the tree over lane offsets 16, 8, 4 (halving)
    then 2, 1 (butterfly), and the warps' partials are added in warp order.
    The row-order contract is that this is the same at every row count."""
    p = split_plan(rows, d, k, x_dtype, basis)
    group, ds = p["group"], p["ds"]
    groups = -(-d // group)
    walks = [[] for _ in range(WARPS)]
    for c0 in range(0, d, ds):  # the kernel's d loop, chunk by chunk
        g0, g1 = c0 // group, min(groups, (c0 + ds) // group)
        for w in range(WARPS):
            walks[w].extend(range(g0 + (w - g0 % WARPS + WARPS) % WARPS, g1, WARPS))
    return (
        ("vec", _VEC[x_dtype]),
        ("group", group),
        ("warp_groups", tuple(tuple(w) for w in walks)),
        ("lane_tree", (16, 8, 4, 2, 1)),
        ("warp_combine", tuple(range(WARPS))),
    )


@functools.lru_cache(maxsize=256)  # pure, and the record is frozen
def serve_project_launch(rows: int, d: int, k: int, x_dtype=torch.float32,
                         basis: str = "bf16") -> KernelLaunch:
    """The launch ``det_serve_project*`` makes for x ``(rows, d)`` of
    ``x_dtype`` and a ``(d, k)`` basis (``basis`` "bf16", "i8" or "f32";
    "f32" takes fp32 x only): a persistent grid sized on the card
    (``grid_rule="occupancy"``: resident CTAs, at most one per item, by the
    column tiles of :func:`split_plan`) of 256 threads, the staged basis
    and the warps' partials as dynamic shared memory. A CTA declares per
    item: 4 rows of x over all of d (split across its 8 warps), the basis
    columns it stages once (or per d chunk where they do not fit) and the
    item's 4 rows of z; ``order`` is :func:`split_order`."""
    p = split_plan(rows, d, k, x_dtype, basis)
    np_ = p["np"]
    cols_cta = min(2 * np_, k)
    rows_item = min(S_ROWS, rows)
    operands = [("x (item)", (rows_item, d)), ("v", (d, cols_cta)),
                ("v staged", (min(p["ds"], d), cols_cta)), ("z (item)", (rows_item, cols_cta))]
    if basis == "i8":
        operands.insert(2, ("scale", (cols_cta,)))
    return KernelLaunch(
        kernel=f"serve_split_kernel<{_XT[x_dtype]}, {_BASIS[basis]}, {np_}>",
        source="csrc/serve_project.cu",
        grid=None,
        threads=THREADS,
        dynamic_smem=p["smem"],
        static_smem=0,
        operands=tuple(operands),
        grid_rule="occupancy",
        order=split_order(rows, d, k, x_dtype, basis),
    )


@functools.lru_cache(maxsize=1024)
def _launch_on(device_index: int, rows: int, d: int, k: int, x_dtype,
               basis: str) -> KernelLaunch:
    """:func:`serve_project_launch` with the grid the card sizes for it
    (``det_serve_project_grid`` on ``device_index``)."""
    with torch.cuda.device(device_index):
        gx = _lib().det_serve_project_grid(rows, d, k, _X_CODES[x_dtype], _BASIS[basis])
    if gx < 1:
        raise RuntimeError(f"serve projection grid query failed: CUDA error {-gx}")
    launch = serve_project_launch(rows, d, k, x_dtype, basis)
    return launch.resolved((gx, split_plan(rows, d, k, x_dtype, basis)["tiles"], 1))


def quantize_basis_i8(v: torch.Tensor, *, eps: float = 1e-12):
    """Per-column symmetric int8 quantization of a ``(d, k)`` basis:
    ``(q, scale)``, ``q`` int8 and ``scale`` ``(1, k)`` fp32, with
    ``v ~= q * scale``; an all-zero column quantizes to zeros with zero
    scale. Bit-equal to the reference's (``torch.round`` and ``jnp.round``
    both round half to even)."""
    v = v.float()
    scale = v.abs().amax(dim=0, keepdim=True) / 127.0
    q = torch.clamp(torch.round(v / torch.clamp_min(scale, eps)), -127, 127)
    return q.to(torch.int8), scale


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def serve_project_plain(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(rows, d) @ (d, k) -> (rows, k)`` fp32 of the bf16-rounded
    operands (exact products, fp32 sums)."""
    return torch.matmul(_bf16(x), _bf16(v))


def serve_project_i8_plain(x: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """``(bf16(x) @ q) * scale`` in fp32: x is rounded to bf16 as the
    kernel's input is, the int8 basis widens exactly."""
    return torch.matmul(_bf16(x), q.float()) * scale.reshape(1, -1).float()


def serve_project_f32_plain(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x @ v`` in fp32, unrounded (``torch.matmul``)."""
    return torch.matmul(x, v)


@functools.lru_cache(maxsize=1)  # argtypes set once, not per launch
def _lib():
    lib = _build.load("serve_project")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.det_serve_project.argtypes = [ptr, ptr, ptr, i, i, i, i, i, ptr]
    lib.det_serve_project.restype = i
    lib.det_serve_project_i8.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i, ptr]
    lib.det_serve_project_i8.restype = i
    lib.det_serve_project_f32.argtypes = [ptr, ptr, ptr, i, i, i, i, ptr]
    lib.det_serve_project_f32.restype = i
    lib.det_serve_project_grid.argtypes = [i, i, i, i, i]
    lib.det_serve_project_grid.restype = i
    return lib


def _check(name: str, x: torch.Tensor, basis: torch.Tensor, basis_dtype):
    if not (x.is_cuda and basis.is_cuda):
        raise ValueError(
            f"{name} takes CUDA tensors, got x on {x.device} and the basis "
            f"on {basis.device}"
        )
    if x.device != basis.device:
        raise ValueError(f"{name}: x on {x.device}, basis on {basis.device}")
    if x.dtype not in _X_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16 x, got {x.dtype}")
    if basis.dtype != basis_dtype:
        raise ValueError(f"{name} takes a {basis_dtype} basis, got {basis.dtype}")
    if x.dim() != 2 or basis.dim() != 2 or x.shape[1] != basis.shape[0]:
        raise ValueError(
            f"{name} takes x (rows, d) and a (d, k) basis, got "
            f"{tuple(x.shape)} and {tuple(basis.shape)}"
        )
    if not (x.is_contiguous() and basis.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    rows, d = x.shape
    k = basis.shape[1]
    if min(rows, d, k) < 1:
        raise ValueError(f"{name} needs non-empty operands, got {(rows, d, k)}")
    if k > MAX_K or rows > _INT_MAX or d > _INT_MAX:
        raise ValueError(
            f"{name} takes k <= {MAX_K} and rows, d < 2**31, got {(rows, d, k)}"
        )
    vec = 4 if x.dtype == torch.float32 else 8
    vec_ok = int(d % vec == 0 and x.data_ptr() % 16 == 0)
    return rows, d, k, vec_ok


def _launch(fn, x: torch.Tensor, *ptrs_and_dims) -> None:
    if torch.cuda.current_device() == x.device.index:  # no device switch to pay for
        rc = fn(*ptrs_and_dims, torch.cuda.current_stream(x.device).cuda_stream)
    else:
        with torch.cuda.device(x.device):
            rc = fn(*ptrs_and_dims, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"serve projection kernel launch failed: CUDA error {rc}")


def serve_project_cuda(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``bf16(x) @ bf16(v)`` fp32 by the hand-written kernel
    (``csrc/serve_project.cu``): x ``(rows, d)`` fp32 or bf16, v ``(d, k)``
    fp32, both contiguous on one card."""
    global launches
    rows, d, k, vec_ok = _check("serve_project_cuda", x, v, torch.float32)
    launch = _launch_on(x.device.index, rows, d, k, x.dtype, "bf16")
    z = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    _launch(_lib().det_serve_project, x, x.data_ptr(), v.data_ptr(),
            z.data_ptr(), rows, d, k, _X_CODES[x.dtype], vec_ok)
    with _count_lock:
        launches += 1
    note(launch)
    return z


def serve_project_i8_cuda(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``(bf16(x) @ q) * scale`` fp32 by the hand-written kernel: q ``(d, k)``
    int8, scale ``(1, k)`` (or ``(k,)``) fp32 from :func:`quantize_basis_i8`."""
    global launches_i8
    rows, d, k, vec_ok = _check("serve_project_i8_cuda", x, q, torch.int8)
    if (scale.device != x.device or scale.dtype != torch.float32
            or scale.numel() != k or not scale.is_contiguous()):
        raise ValueError(
            f"serve_project_i8_cuda takes a contiguous float32 scale of {k} "
            f"values on {x.device}, got {scale.dtype} {tuple(scale.shape)} "
            f"on {scale.device}"
        )
    launch = _launch_on(x.device.index, rows, d, k, x.dtype, "i8")
    z = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    _launch(_lib().det_serve_project_i8, x, x.data_ptr(), q.data_ptr(),
            scale.data_ptr(), z.data_ptr(), rows, d, k, _X_CODES[x.dtype], vec_ok)
    with _count_lock:
        launches_i8 += 1
    note(launch)
    return z


def serve_project_f32_cuda(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x @ v`` fp32 by the split kernel with an unrounded fp32 basis: x
    ``(rows, d)`` and v ``(d, k)`` fp32, contiguous on one card; every
    row's bits depend on (d, k) alone, never on how many rows share the
    launch."""
    global launches_f32
    if x.dtype != torch.float32:
        raise ValueError(f"serve_project_f32_cuda takes float32 x, got {x.dtype}")
    rows, d, k, vec_ok = _check("serve_project_f32_cuda", x, v, torch.float32)
    launch = _launch_on(x.device.index, rows, d, k, x.dtype, "f32")
    z = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    _launch(_lib().det_serve_project_f32, x, x.data_ptr(), v.data_ptr(),
            z.data_ptr(), rows, d, k, vec_ok)
    with _count_lock:
        launches_f32 += 1
    note(launch)
    return z


def _route(name: str, x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"{name}: unsupported device {x.device}")


def serve_project_auto(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bf16 serve projection on the tensor's own device: the kernel for
    a CUDA tensor (always; no fallback), the plain version for a CPU one."""
    if _route("serve_project_auto", x) == "cuda":
        return serve_project_cuda(x, v)
    return serve_project_plain(x, v)


def serve_project_i8_auto(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The int8 serve projection on the tensor's own device, as
    :func:`serve_project_auto`."""
    if _route("serve_project_i8_auto", x) == "cuda":
        return serve_project_i8_cuda(x, q, scale)
    return serve_project_i8_plain(x, q, scale)


def serve_project_f32_auto(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fp32 projection on the tensor's own device: the fixed-order
    kernel for a CUDA tensor (always; no fallback), ``torch.matmul`` for a
    CPU one (whose rows are independent of the batch there)."""
    if _route("serve_project_f32_auto", x) == "cuda":
        return serve_project_f32_cuda(x, v)
    return serve_project_f32_plain(x, v)


def project_exact(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The direct projection ``x @ v`` in ``x``'s dtype: fp32 rows take
    :func:`serve_project_f32_auto`, so that the served and the direct
    projections of one row agree bit for bit; bf16 rows a bf16
    ``torch.matmul``."""
    if x.dtype != torch.float32:
        return torch.matmul(x, v.to(x.dtype))
    if x.dim() == 1:  # one row, projected as a batch of one
        return project_exact(x.reshape(1, -1), v)[0]
    return serve_project_f32_auto(x.contiguous(), v.float().contiguous())
