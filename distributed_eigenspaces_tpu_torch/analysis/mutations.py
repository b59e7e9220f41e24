"""Mutation self-tests: the gate that checks the checker.

Counterpart of ``distributed_eigenspaces_tpu/analysis/mutations.py``, for
the mutations whose passes this package has, under the JAX keys and rules.
Each seeds ONE violation class — a materialized ``d x d`` temp, a kernel
whose one CTA owns the whole operand, a blocking call under a lock, … — and
requires the matching checker to flag it with the expected rule. A
static-analysis stage that can only pass is worthless.

On the card ``pallas_full_block`` really launches ``csrc/
mutant_full_block.cu`` and audits the launch it recorded; on the CPU it
audits the launch ``mutant_full_block_launch`` declares. AST mutants are
source-text fixtures (copied verbatim from the JAX package) fed to
:func:`~.ast_lints.lint_concurrency_source`. Nothing here touches the tree.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_eigenspaces_tpu_torch.analysis import ast_lints, contracts
from distributed_eigenspaces_tpu_torch.device import resolve_device

_D = 64


def _mutant_dense_temp(device) -> list[contracts.Violation]:
    """A factor-only program that materializes the d x d Gram."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import trace_buffers

    def gram(x):  # (rows, d) -> (d, d): exactly what serve must not do
        return x.T @ x

    _, buffers = trace_buffers(gram, torch.zeros((16, _D), device=device))
    contract = contracts.CONTRACTS["serve_transform"]
    params = contracts.ProgramParams(d=_D, k=2, rows=16)
    viols, _ = contracts.check_memory(
        contract, params, program="mutant_dense_temp", buffers=buffers
    )
    return viols


def _mutant_pallas_full_block(device) -> list[contracts.Violation]:
    """The tiling regression the kernel gate exists for: a projection whose
    single CTA owns the FULL (rows, d) operand. Legal and exact — one SM
    does the work while 131 idle — so only the per-CTA tile budget can
    catch it."""
    from distributed_eigenspaces_tpu_torch.analysis.programs import (
        _normal,
        _orthonormal,
    )
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb
    from distributed_eigenspaces_tpu_torch.ops.geometry import recording

    d, rows, k = 1024, 256, 8
    if device.type == "cuda":
        x, v = _normal((rows, d), 5, device), _orthonormal(d, k, 6, device)
        with recording() as launches:
            mfb.mutant_full_block_cuda(x, v)
        torch.cuda.synchronize(device)
    else:
        launches = [mfb.mutant_full_block_launch(rows, d, k)]
    contract = contracts.CONTRACTS["serve_pallas"]
    params = contracts.ProgramParams(d=d, k=k, rows=rows)
    viols, _ = contracts.check_pallas(
        contract, params, launches, program="mutant_pallas_full_block"
    )
    return viols


_FIXTURE_BLOCKING = '''
import threading, time
class Worker:
    def __init__(self):
        self._lock = threading.Lock()
    def drain(self):
        with self._lock:
            self._thread.join()
            time.sleep(0.1)
'''

_FIXTURE_LOCK_ORDER = '''
import threading
class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._aux = threading.Lock()
    def swap(self):
        with self._lock:
            with self._aux:
                pass
'''

_FIXTURE_UNGUARDED = '''
import threading
class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
    def bump(self):
        with self._lock:
            self.count += 1
    def reset(self):
        self.count = 0
'''


def _ast_mutant(fixture: str, linter) -> Callable[[torch.device], list]:
    def run(device) -> list[contracts.Violation]:
        return linter(fixture, "seeded_fixture.py")

    return run


#: mutation name -> (expected rule, runner(device)). Every violation class
#: this analyzer claims to catch has exactly one seeded witness here.
MUTATIONS: dict[str, tuple[str, Callable[[torch.device], list]]] = {
    "dense_temp": ("dense-buffer", _mutant_dense_temp),
    "pallas_full_block": ("pallas-block", _mutant_pallas_full_block),
    "blocking_under_lock": ("blocking-under-lock", _ast_mutant(
        _FIXTURE_BLOCKING, ast_lints.lint_concurrency_source
    )),
    "lock_order": ("lock-order", _ast_mutant(
        _FIXTURE_LOCK_ORDER, ast_lints.lint_concurrency_source
    )),
    "unguarded_shared_write": ("unguarded-shared-write", _ast_mutant(
        _FIXTURE_UNGUARDED, ast_lints.lint_concurrency_source
    )),
}


def run_mutation_checks(device="cuda") -> tuple[bool, list[dict]]:
    """Run every seeded mutation on ``device``; each must be CAUGHT with
    the expected rule. Returns (all_caught, per-mutation records)."""
    dev = resolve_device(device)
    records = []
    all_ok = True
    for name, (rule, runner) in MUTATIONS.items():
        viols = runner(dev)
        hits = [v for v in viols if v.rule == rule]
        caught = bool(hits)
        all_ok &= caught
        records.append({
            "mutation": name,
            "expected_rule": rule,
            "caught": caught,
            "n_violations": len(viols),
            "messages": [v.format() for v in hits[:2]],
        })
    return all_ok, records
