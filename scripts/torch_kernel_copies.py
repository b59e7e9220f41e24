"""Copies of a ``csrc/`` source with text edits, built side by side and timed
on one card: the harness of the ``torch_profile_*`` scripts that measure a
kernel against variants of itself.

A variant is a function from the source's text to the copy's. :func:`edit`
replaces text that must occur exactly once, so a copy whose anchor has gone
from the source fails loudly instead of timing the unchanged kernel.
:func:`build` writes every copy into ``build/torch_kernels/`` (which the port
never loads), starts one ``nvcc`` per copy, all together, and binds each
library's C interface. :func:`rounds` times callables with CUDA events over
back-to-back launches, alternating them round by round.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from distributed_eigenspaces_tpu_torch.ops import _build  # noqa: E402

PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def require_card(script: str) -> bool:
    """Whether torch sees a card; says so on stderr when it does not."""
    import torch

    if torch.cuda.is_available():
        return True
    print(f"{script}: torch.cuda.is_available() is False; needs a card", file=sys.stderr)
    return False


def card() -> str:
    """The card's name and power limit (``nvidia-smi``), printed and returned."""
    line = chip_smoke.card_line()
    print(line, flush=True)
    return line


def edit(src: str, old: str, new: str, source: str) -> str:
    """``src`` with its one occurrence of ``old`` replaced by ``new``."""
    if src.count(old) != 1:
        raise RuntimeError(f"{source} has no single text {old!r}")
    return src.replace(old, new)


def build(source: str, variants: dict, functions: dict) -> dict:
    """Per variant name, the library built from ``variants[name]`` applied to
    ``csrc/<source>.cu``, with each of ``functions`` (C name -> argument
    types) bound to return ``int``."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    copies = {name: variant(src) for name, variant in variants.items()}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in copies.items():
        path = _build.BUILD_DIR / f"{source}_copy_{name}.cu"
        path.write_text(text)
        out = _build.BUILD_DIR / f"lib{source}_copy_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy of {source}.cu:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = INT
        libs[name] = lib
    return libs


def checked(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed, CUDA error {rc}")


def ms_per_launch(fn, reps: int) -> float:
    """ms per call of ``fn`` over ``reps`` back-to-back calls (CUDA events),
    after one call that is not timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rounds(fns: dict, n_rounds: int, reps: int) -> dict:
    """Per name, the ms per call of each of ``n_rounds`` rounds; every round
    times each of ``fns`` in turn."""
    times = {name: [] for name in fns}
    for _ in range(n_rounds):
        for name, fn in fns.items():
            times[name].append(ms_per_launch(fn, reps))
    return times
