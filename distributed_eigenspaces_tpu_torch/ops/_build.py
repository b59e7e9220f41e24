"""Build the port's CUDA kernels with ``nvcc`` at first use, load with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled for
``sm_90a`` into the library directory, ``build/torch_kernels/`` at the root
of the checkout unless :func:`set_build_dir` points it elsewhere (the
persistent compile cache, ``utils/compile_cache.py``, points it at
``<dir>/kernels``), under a file name that carries a hash of the source,
the flags and the ``nvcc`` version, so an edited source or another
compiler is rebuilt and an unchanged one is loaded as it is. A library is
written to a temporary file and renamed into place, so a reader never sees
a torn one. Nothing is built when a module is imported: only the first
launch on a CUDA tensor calls :func:`load`. A library loaded once stays
loaded for the process, wherever the directory points later.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_runs_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per kernel source: {"seconds": build time (0.0 when reused), "log": the
#: compiler's output (ptxas register / shared-memory / spill lines)}
build_info: dict[str, dict] = {}
#: ``nvcc`` compiles this process ran (a warm start runs none)
nvcc_runs = 0


def set_build_dir(path) -> Path:
    """Point the library directory at ``path`` for this process (libraries
    already loaded stay loaded); returns it."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = Path(path)
    return BUILD_DIR


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "csrc/ on the machine with the card"
    )


@functools.lru_cache(maxsize=1)
def nvcc_version() -> str:
    """The compiler's version as the CUDA toolkit's ``version.json`` states
    it, read without running ``nvcc``; the digest of the ``nvcc`` binary
    where that file is missing."""
    nvcc = Path(nvcc_path())
    try:
        meta = json.loads((nvcc.resolve().parent.parent / "version.json").read_text())
        return f"nvcc {meta['cuda_nvcc']['version']}"
    except (OSError, ValueError, KeyError, TypeError):
        return f"nvcc sha256:{hashlib.sha256(nvcc.read_bytes()).hexdigest()[:16]}"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives in the current library
    directory: its file name carries the digest of the source, the flags
    and the ``nvcc`` version."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = src + " ".join(NVCC_FLAGS).encode() + nvcc_version().encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library unless the same
    source was already built; returns the library's path."""
    global nvcc_runs
    lib = library_path(name)
    if lib.is_file():
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with _runs_lock:
        nvcc_runs += 1
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    build_info[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
    return lib


def build_all(names) -> None:
    """Compile several ``csrc/`` sources at once: one ``nvcc`` process each,
    all started together (each build waits on its own subprocess)."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
