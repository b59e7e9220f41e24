"""The whole-fit trainer: T online steps, cold first, warm after.

Counterpart of ``make_scan_fit`` in ``distributed_eigenspaces_tpu/algo/
scan.py`` for one device and no masks; the crossover merge rides on the
per-step trainer's round. The reference compiles the T steps
into one ``lax.scan``; here they are a Python loop over the per-step
trainer (``algo/step.py``).
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
from distributed_eigenspaces_tpu_torch.config import PCAConfig


def make_scan_fit(cfg: PCAConfig, *, device="cuda", v0=None, v_init=None):
    """Build ``fit(state, x_steps) -> (state, v_bars)``.

    ``x_steps`` is a ``(T, m, n, d)`` tensor or a sequence of ``(m, n, d)``
    blocks; ``v_bars (T, d, k)`` is the merged eigenspace after every step.
    Step 1 runs the cold core at ``cfg.subspace_iters`` from ``v0``
    (default: :func:`~..ops.linalg.initial_basis` from ``cfg.seed``); with
    warm starts on, every later step starts from the previous ``v_bar`` at
    ``cfg.resolved_warm_start()`` iterations, otherwise every step is cold.
    Above the crossover (``cfg.uses_distributed_solve()``) every step's
    merge is the distributed solve from ``v_init (d, k')`` (default: drawn
    from ``cfg.seed``).
    """
    step = make_train_step(cfg, device=device, v0=v0, v_init=v_init)

    def fit(state: OnlineState, x_steps):
        v_bars = []
        v_prev = None
        for x in x_steps:
            state, v_prev = step(state, x, v_prev)
            v_bars.append(v_prev)
        if not v_bars:
            raise ValueError("make_scan_fit: x_steps holds no step")
        return state, torch.stack(v_bars)

    return fit
