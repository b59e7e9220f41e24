"""ctypes bindings for the native host reader (``native/loader.cc``).

A copy of ``distributed_eigenspaces_tpu/runtime/native.py``: the bin
stream's :class:`ChunkReader`, :func:`to_f32`, :func:`absmax_f32` and
:func:`quantize_i8`, and the CIFAR loader's :func:`to_gray_f32`. The shared library is built with ``g++ -O3
-shared`` at first use into ``build/native/`` at the root of the checkout,
under a name that carries a hash of the source, and loaded once. Every
entry point has a numpy fallback, taken on a machine without a toolchain
(the failed build is logged once) or with ``DET_NO_NATIVE=1`` (silently);
:func:`native_available` says which is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from distributed_eigenspaces_tpu_torch.utils.metrics import log_line

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False

_SRC = Path(__file__).resolve().parents[1] / "native" / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode())
    return BUILD_DIR / f"det_loader-{digest.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL | None:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("DET_NO_NATIVE") == "1" or not _SRC.is_file():
            _LIB_FAILED = True
            return None
        try:
            so_path = _library_path()
            if not so_path.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(str(so_path))
            lib.u8_nhwc_to_gray_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.u8_to_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.reader_open_strided.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.reader_open_strided.restype = ctypes.c_void_p
            lib.reader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.reader_next.restype = ctypes.c_int64
            lib.reader_close.argtypes = [ctypes.c_void_p]
            lib.f32_absmax.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.f32_absmax.restype = ctypes.c_float
            lib.f32_quantize_i8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_float, ctypes.c_int32,
            ]
            _LIB = lib
        except Exception as e:
            # said once: the numpy fallback rounds quantization ties to
            # even where the native code rounds them away from zero
            _LIB_FAILED = True
            detail = getattr(e, "stderr", None)
            log_line("native reader unavailable; using the numpy fallback",
                     error=repr(e),
                     detail=detail.decode(errors="replace")[-2000:] if detail else None)
        return _LIB


def native_available() -> bool:
    """True when the native library is built and loaded (else every entry
    point takes its numpy fallback)."""
    return _load() is not None


def _nthreads() -> int:
    return min(8, os.cpu_count() or 1)


def to_gray_f32(images: np.ndarray) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, H*W) float32 channel-mean grayscale — the
    reference's preprocessing (``distributed.py:170-173``) as a native
    kernel; numpy fallback otherwise."""
    images = np.ascontiguousarray(images)
    n, h, w, c = images.shape
    lib = _load()
    if lib is None or images.dtype != np.uint8:
        return (
            images.astype(np.float32).mean(axis=3).reshape(n, h * w)
        )
    out = np.empty((n, h * w), np.float32)
    lib.u8_nhwc_to_gray_f32(
        images.ctypes.data, out.ctypes.data, n, h, w, c, _nthreads()
    )
    return out


def to_f32(flat: np.ndarray) -> np.ndarray:
    """uint8 array -> float32 (same shape) via the native widen kernel."""
    flat = np.ascontiguousarray(flat)
    lib = _load()
    if lib is None or flat.dtype != np.uint8:
        return flat.astype(np.float32)
    out = np.empty(flat.shape, np.float32)
    lib.u8_to_f32(flat.ctypes.data, out.ctypes.data, flat.size, _nthreads())
    return out


def absmax_f32(x: np.ndarray) -> float:
    """Max |x| of a float32 array: pass 1 of symmetric int8 quantization
    (threaded native kernel; numpy fallback)."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return float(np.max(np.abs(x))) if x.size else 0.0
    return float(lib.f32_absmax(x.ctypes.data, x.size, _nthreads()))


def quantize_i8(x: np.ndarray, scale: float) -> np.ndarray:
    """``clip(round(x * scale), -127, 127)`` as int8 (same shape): pass 2 of
    the symmetric quantization behind the int8 wire format
    (``data/bin_stream.py``). Threaded native kernel; numpy fallback.

    Rounding is half away from zero natively and half to even in the
    fallback: the two differ only where ``x * scale`` lands exactly on
    ``q + 0.5``.
    """
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return np.clip(np.round(x * np.float32(scale)), -127, 127).astype(np.int8)
    out = np.empty(x.shape, np.int8)
    lib.f32_quantize_i8(
        x.ctypes.data, out.ctypes.data, x.size, ctypes.c_float(scale), _nthreads(),
    )
    return out


class ChunkReader:
    """Double-buffered chunked file reader (a background read-ahead thread
    in C++; the fallback reads synchronously).

    Iterates ``bytes`` chunks of ``chunk_bytes`` (the last may be short)::

        for chunk in ChunkReader(path, 1 << 20):
            ...

    ``offset`` seeks before the first chunk and ``skip`` bytes are skipped
    after every chunk (a strided read). When the stride runs past the end
    of the file the final, possibly short, chunk is still delivered, then
    iteration ends.
    """

    def __init__(self, path: str, chunk_bytes: int, *, offset: int = 0,
                 skip: int = 0):
        if chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        if offset < 0 or skip < 0:
            raise ValueError("offset/skip must be >= 0")
        self.path = path
        self.chunk_bytes = chunk_bytes
        self._skip = skip
        self._lib = _load()
        self._handle = None
        self._file = None
        if self._lib is not None:
            h = self._lib.reader_open_strided(
                os.fsencode(path), ctypes.c_int64(chunk_bytes),
                ctypes.c_int64(offset), ctypes.c_int64(skip),
            )
            if not h:
                raise FileNotFoundError(path)
            self._handle = h
        else:
            self._file = open(path, "rb")
            if offset:
                self._file.seek(offset)

    def __iter__(self):
        buf = np.empty(self.chunk_bytes, np.uint8)
        while True:
            if self._handle is not None:
                got = self._lib.reader_next(self._handle, buf.ctypes.data)
                if got <= 0:
                    return
                yield buf[:got].tobytes()
                if got < self.chunk_bytes:
                    return
            else:
                data = self._file.read(self.chunk_bytes)
                if not data:
                    return
                yield data
                if len(data) < self.chunk_bytes:
                    return
                if self._skip:
                    self._file.seek(self._skip, 1)

    def close(self):
        if self._handle is not None:
            self._lib.reader_close(self._handle)
            self._handle = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
