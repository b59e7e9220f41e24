"""The audited program matrix of the port: every program runs once, at
audit-sized shapes, on the device asked for.

Counterpart of ``distributed_eigenspaces_tpu/analysis/programs.py``, with
its names and audit shapes (d=64, k=2, 16 rows for serve; 1024 / 256 / 8 /
32 for the kernels). A :class:`BuiltProgram` holds the callable, its inputs,
the buffers one call of it materialized (:func:`trace_buffers`) and the
:class:`~..ops.geometry.KernelLaunch` records of its hand-written kernels:

- on the card the program really runs, under :func:`~..ops.geometry.
  recording`, so the records are the launches it made (``torch.profiler``
  holds them against the card in ``chip_smoke.py``);
- on the CPU the kernels cannot run; the program runs its plain versions
  for the buffer trace, and its records come from the ``*_launch``
  functions at the same shapes — what the JAX audit gets from
  ``interpret=True``: the blocks, not the execution.

The scan, tree, fleet, feature-sharded, dist and deflation programs of the
JAX matrix wait for ROADMAP Queue 1 item 17b (the multi-device trainers
they read are ported).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from distributed_eigenspaces_tpu_torch.analysis.contracts import ProgramParams
from distributed_eigenspaces_tpu_torch.device import resolve_device
from distributed_eigenspaces_tpu_torch.ops.geometry import KernelLaunch, recording

# audit shapes: d=64 serve, every other dimension well below it
_D, _K = 64, 2
_SERVE_ROWS = 16
# kernel-audit shapes: LARGE enough that a full-operand block is
# distinguishable from a tile — and the legit kernels sit far under the
# 131072-elem budget that the mutant's full (rows, d) CTA (262144) trips
_PALLAS_D, _PALLAS_ROWS, _PALLAS_K, _PALLAS_F = 1024, 256, 8, 32


@dataclass
class BuiltProgram:
    """One audited program after one call on ``device``."""

    name: str
    contract: str  # key into contracts.CONTRACTS
    params: ProgramParams
    fn: Callable
    args: tuple
    device: torch.device
    #: the hand-written kernels' launches (recorded on the card, declared
    #: by the ``*_launch`` functions on the CPU)
    launches: tuple[KernelLaunch, ...]
    #: ``(where, shape, dtype)`` of every input and every aten op output
    buffers: tuple
    #: the CUDA source whose kernel the program audits, if any
    source: str | None = None
    output: Any = None


class _BufferTrace(TorchDispatchMode):
    """Records the shape of every tensor each aten op returns."""

    def __init__(self):
        super().__init__()
        self.buffers: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.buffers.append((str(func), tuple(t.shape), str(t.dtype)))
        return out


def trace_buffers(fn, *args):
    """``(fn(*args), buffers)``: ``buffers`` lists ``(where, shape,
    dtype)`` for every tensor input and every tensor an aten op returned
    during the call — the port's counterpart of walking a jaxpr's avals."""
    inputs = [("<input>", tuple(a.shape), str(a.dtype))
              for a in tree_leaves(args) if isinstance(a, torch.Tensor)]
    with _BufferTrace() as trace:
        out = fn(*args)
    return out, tuple(inputs + trace.buffers)


def _normal(shape, seed: int, device) -> torch.Tensor:
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device)


def _orthonormal(d: int, k: int, seed: int, device) -> torch.Tensor:
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, k)))
    return torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(device)


def _built(name, contract, params, fn, args, declare, source, device):
    """Run ``fn(*args)`` once under the buffer trace; on the card also
    under the launch recorder, on the CPU take ``declare(*args)``."""
    if device.type == "cuda":
        with recording() as launches:
            out, buffers = trace_buffers(fn, *args)
        torch.cuda.synchronize(device)
    else:
        out, buffers = trace_buffers(fn, *args)
        launches = declare(*args)
    return BuiltProgram(
        name=name, contract=contract, params=params, fn=fn, args=args,
        device=device, launches=tuple(launches), buffers=buffers,
        source=source, output=out,
    )


def _serve_program(name: str):
    """The port's ``TransformEngine`` fp32 project on one device: on the
    card the fixed-order serve kernel (``det_serve_project_f32``)."""

    def build(device) -> BuiltProgram:
        from distributed_eigenspaces_tpu_torch.ops.serve_project import (
            serve_project_launch,
        )
        from distributed_eigenspaces_tpu_torch.serving.transform import (
            TransformEngine,
            bucket_rows,
        )

        eng = TransformEngine(_D, _K, device=device)
        x = _normal((_SERVE_ROWS, _D), 0, device)
        v = _orthonormal(_D, _K, 1, device)

        def declare(x, v):
            rows = bucket_rows(x.shape[0], min_bucket=eng.min_bucket)
            return [serve_project_launch(rows, _D, _K, torch.float32, "f32")]

        return _built(
            name, "serve_transform",
            ProgramParams(d=_D, k=_K, rows=_SERVE_ROWS),
            eng.project, (x, v), declare, "csrc/serve_project.cu", device,
        )

    return build


def _kernel_program(name: str, kind: str):
    """The hand-written serve / solver kernels at the kernel-audit shapes,
    through the ``*_auto`` functions the port's callers use."""

    def build(device) -> BuiltProgram:
        from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
        from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

        d, rows, k, f = _PALLAS_D, _PALLAS_ROWS, _PALLAS_K, _PALLAS_F
        x = _normal((rows, d), 2, device)
        v = _orthonormal(d, k, 3, device)
        if kind == "project_bf16":
            fn, args, source = sp.serve_project_auto, (x, v), "csrc/serve_project.cu"

            def declare(x, v):
                return [sp.serve_project_launch(rows, d, k, x.dtype, "bf16")]
        elif kind == "project_i8":
            q, s = sp.quantize_basis_i8(v)
            fn, args, source = sp.serve_project_i8_auto, (x, q, s), "csrc/serve_project.cu"

            def declare(x, q, s):
                return [sp.serve_project_launch(rows, d, k, x.dtype, "i8")]
        else:  # matvec_gram: the large-d solver's fused inner sweep
            c = _normal((d, f), 4, device)
            fn, args, source = mg.matvec_gram_auto, (c, v), "csrc/matvec_gram.cu"

            def declare(c, v):
                return [mg.matvec_gram_launch(d, f, k)]

        return _built(
            name, "serve_pallas",
            ProgramParams(d=d, k=k, rows=rows, sketch_width=f),
            fn, args, declare, source, device,
        )

    return build


#: name -> build function taking the device. The ORDER is the report order.
PROGRAMS: dict[str, Callable[[torch.device], BuiltProgram]] = {
    "serve_project_solo": _serve_program("serve_project_solo"),
    "pallas_serve_project_bf16": _kernel_program(
        "pallas_serve_project_bf16", "project_bf16"
    ),
    "pallas_serve_project_i8": _kernel_program(
        "pallas_serve_project_i8", "project_i8"
    ),
    "pallas_matvec_gram": _kernel_program("pallas_matvec_gram", "matvec_gram"),
}


def build_program(name: str, device="cuda") -> BuiltProgram:
    """Build and run one audited program by matrix name on ``device``
    (``"cuda"`` unless the caller asks for the CPU; raises without a card)."""
    if name not in PROGRAMS:
        raise KeyError(f"unknown program {name!r}; matrix: {sorted(PROGRAMS)}")
    return PROGRAMS[name](resolve_device(device))
