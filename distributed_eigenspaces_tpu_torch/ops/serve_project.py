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
fp32 with XLA at ``Precision.HIGHEST``). Each row is summed in an order that
depends on d alone, so a row served in a padded bucket equals its direct
projection bit for bit; :func:`project_exact` routes both the engine's
``"float32"`` projection and ``OnlineDistributedPCA.transform`` through it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from distributed_eigenspaces_tpu_torch.ops import _build

#: launches made by :func:`serve_project_cuda`, :func:`serve_project_i8_cuda`
#: and :func:`serve_project_f32_cuda`
#: (one per call, counted under a lock: serve lanes launch from their own
#: threads); callers reset them to 0 before a run whose launches they count
launches = 0
launches_i8 = 0
launches_f32 = 0
_count_lock = threading.Lock()

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel tiles k in grid.y blocks of 16 columns
MAX_K = 65535 * 16
_INT_MAX = 2**31 - 1


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


def _lib():
    lib = _build.load("serve_project")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.det_serve_project.argtypes = [ptr, ptr, ptr, i, i, i, i, i, ptr]
    lib.det_serve_project.restype = i
    lib.det_serve_project_i8.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i, ptr]
    lib.det_serve_project_i8.restype = i
    lib.det_serve_project_f32.argtypes = [ptr, ptr, ptr, i, i, i, i, ptr]
    lib.det_serve_project_f32.restype = i
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*ptrs_and_dims, stream)
    if rc != 0:
        raise RuntimeError(f"serve projection kernel launch failed: CUDA error {rc}")


def serve_project_cuda(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``bf16(x) @ bf16(v)`` fp32 by the hand-written kernel
    (``csrc/serve_project.cu``): x ``(rows, d)`` fp32 or bf16, v ``(d, k)``
    fp32, both contiguous on one card."""
    global launches
    rows, d, k, vec_ok = _check("serve_project_cuda", x, v, torch.float32)
    z = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    _launch(_lib().det_serve_project, x, x.data_ptr(), v.data_ptr(),
            z.data_ptr(), rows, d, k, _X_CODES[x.dtype], vec_ok)
    with _count_lock:
        launches += 1
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
    z = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    _launch(_lib().det_serve_project_i8, x, x.data_ptr(), q.data_ptr(),
            scale.data_ptr(), z.data_ptr(), rows, d, k, _X_CODES[x.dtype], vec_ok)
    with _count_lock:
        launches_i8 += 1
    return z


def serve_project_f32_cuda(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x @ v`` fp32 by the fixed-order kernel: x ``(rows, d)`` and v
    ``(d, k)`` fp32, contiguous on one card; every row's bits depend on d
    alone, never on how many rows share the launch."""
    global launches_f32
    if x.dtype != torch.float32:
        raise ValueError(f"serve_project_f32_cuda takes float32 x, got {x.dtype}")
    rows, d, k, vec_ok = _check("serve_project_f32_cuda", x, v, torch.float32)
    z = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    _launch(_lib().det_serve_project_f32, x, x.data_ptr(), v.data_ptr(),
            z.data_ptr(), rows, d, k, vec_ok)
    with _count_lock:
        launches_f32 += 1
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
