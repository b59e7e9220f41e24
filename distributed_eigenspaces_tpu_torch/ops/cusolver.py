"""cuSOLVER's batched symmetric eigensolver, bound with ctypes: the port's
eigensolver on the card for widths 33 to 256.

``torch.linalg.eigh`` on a CUDA matrix larger than 32 x 32 runs one cuSOLVER
``syevj`` call per matrix (327 kernel launches each at 160 x 160), so a batch
of B such matrices costs B times one. The merge
(``ops.linalg.merged_top_k_lowrank``) solves one ``(m k, m k)`` problem a
step for a solo fit and B of them for a B-tenant fleet; the workers'
Rayleigh-Ritz solves ``(k, k)`` for each of them.
``cusolverDnXsyevBatched`` (cuSOLVER 11.7.1 and later) solves a whole batch
in one call: 60 launches and 1.76 ms of device time for 8 x 160 x 160 on an
H100 (700 W), against 2,595 launches and 17.9 ms for the loop
(``scripts/torch_profile_eigh.py``). The library is the one torch itself
loads; nothing is built.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_CUSOLVER_EIG_MODE_VECTOR = 1
_CUBLAS_FILL_MODE_LOWER = 0
_CUDA_R_32F = 0

_lib = None
_lib_lock = threading.Lock()
#: {device index: (handle, params, lock)}, one of each a device for the
#: process: a cuSOLVER handle must not be used by two threads at once (the
#: fleet server's lane and its prewarm lane both solve), so a solve holds
#: its device's lock
_handles: dict = {}


def _library() -> ctypes.CDLL:
    """The ``libcusolver`` this process has loaded (torch's), else the
    loader's; raises where neither has the batched routine."""
    global _lib
    with _lib_lock:
        if _lib is None:
            torch.zeros(1, device="cuda")  # torch's CUDA libraries up
            path = None
            with open("/proc/self/maps") as maps:
                for line in maps:
                    if "libcusolver.so" in line:
                        path = line.split()[-1]
                        break
            lib = ctypes.CDLL(path or "libcusolver.so.11")
            if not hasattr(lib, "cusolverDnXsyevBatched"):
                raise RuntimeError(
                    f"{path or 'libcusolver.so.11'} has no cusolverDnXsyevBatched "
                    "(cuSOLVER 11.7.1, CUDA 12.6 Update 2, or later)"
                )
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.cusolverDnXsyevBatched_bufferSize.argtypes = [
                vp, vp, ctypes.c_int, ctypes.c_int, i64, ctypes.c_int, vp, i64,
                ctypes.c_int, vp, ctypes.c_int, ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t), i64]
            lib.cusolverDnXsyevBatched.argtypes = [
                vp, vp, ctypes.c_int, ctypes.c_int, i64, ctypes.c_int, vp, i64,
                ctypes.c_int, vp, ctypes.c_int, vp, ctypes.c_size_t, vp,
                ctypes.c_size_t, vp, i64]
            _lib = lib
        return _lib


def _handle(lib, device: torch.device):
    with _lib_lock:
        if device.index not in _handles:
            handle, params = ctypes.c_void_p(), ctypes.c_void_p()
            _check(lib.cusolverDnCreate(ctypes.byref(handle)), "cusolverDnCreate")
            _check(lib.cusolverDnCreateParams(ctypes.byref(params)),
                   "cusolverDnCreateParams")
            _handles[device.index] = (handle, params, threading.Lock())
        return _handles[device.index]


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} failed: cusolverStatus {status}")


def syev_batched(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) and eigenvectors (columns) of a ``(B, n, n)``
    batch of symmetric float32 matrices on the card, as
    ``torch.linalg.eigh`` returns them, by one ``cusolverDnXsyevBatched``
    call on the current stream. A matrix that fails to converge comes out
    NaN, the others as they are: its flag is read on the device, with no
    sync, so one failed lane fails neither the batch nor the host."""
    if not a.is_cuda or a.dtype != torch.float32 or a.dim() != 3 \
            or a.shape[-1] != a.shape[-2]:
        raise ValueError(
            "syev_batched takes a (B, n, n) float32 CUDA tensor, got "
            f"{tuple(a.shape)} {a.dtype} on {a.device}"
        )
    lib = _library()
    dev = a.device if a.device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
    b, n = a.shape[0], a.shape[-1]
    # a symmetric row-major matrix is its own column-major form; the call
    # overwrites its copy with the eigenvectors, column-major
    work = a.contiguous().clone()
    w = torch.empty((b, n), dtype=torch.float32, device=dev)
    info = torch.zeros((b,), dtype=torch.int32, device=dev)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    handle, params, lock = _handle(lib, dev)
    with torch.cuda.device(dev), lock:
        _check(lib.cusolverDnSetStream(handle, vp(torch.cuda.current_stream(dev).cuda_stream)),
               "cusolverDnSetStream")
        dws, hws = ctypes.c_size_t(), ctypes.c_size_t()
        _check(lib.cusolverDnXsyevBatched_bufferSize(
            handle, params, _CUSOLVER_EIG_MODE_VECTOR, _CUBLAS_FILL_MODE_LOWER, i64(n),
            _CUDA_R_32F, vp(work.data_ptr()), i64(n), _CUDA_R_32F, vp(w.data_ptr()),
            _CUDA_R_32F, ctypes.byref(dws), ctypes.byref(hws), i64(b)),
            "cusolverDnXsyevBatched_bufferSize")
        dbuf = torch.empty((max(dws.value, 1),), dtype=torch.uint8, device=dev)
        hbuf = ctypes.create_string_buffer(max(hws.value, 1))
        _check(lib.cusolverDnXsyevBatched(
            handle, params, _CUSOLVER_EIG_MODE_VECTOR, _CUBLAS_FILL_MODE_LOWER, i64(n),
            _CUDA_R_32F, vp(work.data_ptr()), i64(n), _CUDA_R_32F, vp(w.data_ptr()),
            _CUDA_R_32F, vp(dbuf.data_ptr()), ctypes.c_size_t(dws.value),
            ctypes.cast(hbuf, vp), ctypes.c_size_t(hws.value), vp(info.data_ptr()), i64(b)),
            "cusolverDnXsyevBatched")
    ok = info.eq(0)
    return (torch.where(ok[:, None], w, float("nan")),
            torch.where(ok[:, None, None], work.mT, float("nan")))


#: the widths the batched routine takes on the card: above 32 torch's
#: ``syevjBatched`` no longer applies and it loops ``syevj`` a matrix; at
#: 80, 160 and 256 one batched call beats that loop in kernels and device
#: time; from 768 up a single matrix runs the same ``syevd`` kernels either
#: way, and a batch of 8 at 784 takes 5.7x the loop's kernels
#: (``scripts/torch_profile_eigh.py``)
BATCHED_N = (33, 256)


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The port's ``torch.linalg.eigh`` of ``(..., n, n)``: on the card, a
    float32 input with n in :data:`BATCHED_N` is solved by one
    :func:`syev_batched` call over all its leading dimensions (a solo
    merge and a fleet's B merges alike); any other input (the CPU, another
    dtype, another n) goes to ``torch.linalg.eigh``.

    Each matrix fails alone, as the reference's batched ``jnp.linalg.eigh``
    lanes do: a matrix that is not finite is solved as zeros and comes out
    NaN (torch's solver would return some finite columns for it, or raise
    for the batch), with no host sync; one that torch's solver fails to
    converge on comes out NaN after the batch is solved again matrix by
    matrix."""
    n = a.shape[-1]
    ok = torch.isfinite(a).flatten(-2).all(-1)
    a = torch.where(ok[..., None, None], a, 0.0)
    if a.is_cuda and a.dtype == torch.float32 and BATCHED_N[0] <= n <= BATCHED_N[1] \
            and a.numel() > 0:
        lead = a.shape[:-2]
        w, v = syev_batched(a.reshape(-1, n, n))
        w, v = w.reshape(*lead, n), v.reshape(*lead, n, n)
    else:
        w, v = _torch_eigh(a)
    return (torch.where(ok[..., None], w, float("nan")),
            torch.where(ok[..., None, None], v, float("nan")))


def _torch_eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh``; where it fails to converge, each matrix again
    alone, the failed ones NaN."""
    try:
        return torch.linalg.eigh(a)
    except torch.linalg.LinAlgError:
        if a.dim() == 2:
            return a.new_full(a.shape[:-1], float("nan")), a.new_full(a.shape, float("nan"))
    parts = [_torch_eigh(m) for m in a.reshape(-1, *a.shape[-2:])]
    return (torch.stack([p[0] for p in parts]).reshape(a.shape[:-1]),
            torch.stack([p[1] for p in parts]).reshape(a.shape))
