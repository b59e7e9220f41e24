"""Rank program of the guards test (``tests/test_torch_guards.py``).

Runs in every rank of a two-rank gloo group that ``parallel.mesh.launch``
starts, on the CPU, with ``DET_CHECKIFY=1``, and returns plain values and
numpy arrays. It imports torch and the port only, so no rank ever imports
JAX; it is not a test file itself.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as fs
from distributed_eigenspaces_tpu_torch.parallel import fleet
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import topology as tp
from distributed_eigenspaces_tpu_torch.utils import guards

CPU = "cpu"


def _attempt(fn) -> dict:
    """What ``fn()`` did: ``{"raised": name or None, "s": seconds, "out":
    its result}``."""
    t0 = time.perf_counter()
    try:
        out = fn()
        raised = None
    except Exception as e:  # noqa: BLE001 - the kind is the result
        out, raised = None, type(e).__name__
    return {"raised": raised, "s": time.perf_counter() - t0, "out": out}


def _poison(a: np.ndarray, on: bool) -> np.ndarray:
    a = np.array(a, copy=True)
    if on:
        a.flat[0] = np.nan
    return a


def guard_rank(rank, world, cfg_kw, block, tenants, v0):
    """Each guarded mesh trainer given this rank's share, poisoned on rank 1
    only, then clean: the per-step trainer on a workers mesh, the fleet fit
    on a fleet mesh (a poisoned tenant in rank 1's half), the feature-sharded
    step on a ``(1, 2)`` mesh (rank 1's columns), the tree scan fit on a
    two-leaf tiered mesh, and a checked step that raises on rank 1 alone."""
    os.environ["DET_CHECKIFY"] = "1"
    cfg = PCAConfig(**cfg_kw)
    m, d = cfg.num_workers, cfg.dim
    bad = rank == 1
    out = {}

    mesh = pmesh.make_mesh(world, device=CPU)
    step = make_train_step(cfg, mesh=mesh, device=CPU, v0=torch.from_numpy(v0))
    share = block[pmesh.worker_rows(mesh, m)]
    st0 = lambda: OnlineState.initial(d, device=CPU)  # noqa: E731
    out["step_poisoned"] = _attempt(lambda: step(st0(), torch.from_numpy(_poison(share, bad))))
    out["step_clean"] = _attempt(
        lambda: step(st0(), torch.from_numpy(share))[0].sigma_tilde.numpy())

    fmesh = fleet.fleet_mesh(len(tenants), CPU)
    poisoned = list(tenants)
    poisoned[-1] = _poison(poisoned[-1], True)  # the last tenant: rank 1's half
    fcfg = PCAConfig(**dict(cfg_kw, backend="local"))
    out["fleet_poisoned"] = _attempt(
        lambda: fleet.fit_fleet(fcfg, poisoned, mesh=fmesh, device=CPU, v0=v0))
    out["fleet_clean"] = _attempt(
        lambda: fleet.fit_fleet(fcfg, tenants, mesh=fmesh, device=CPU, v0=v0).components)

    scfg = PCAConfig(**dict(cfg_kw, backend="feature_sharded"))
    smesh = pmesh.make_mesh(1, world, device=CPU)
    fstep = fs.make_feature_sharded_step(scfg, smesh, device=CPU)
    cols = block[..., pmesh.feature_rows(smesh, d)]
    out["fs_poisoned"] = _attempt(
        lambda: fstep(fstep.init_state(), torch.from_numpy(_poison(cols, bad))))
    out["fs_clean"] = _attempt(
        lambda: fstep(fstep.init_state(), torch.from_numpy(cols))[0].s.numpy())

    tcfg = PCAConfig(**dict(cfg_kw, num_workers=world, merge_topology=(("chip", world),)))
    tmesh = tp.make_tiered_mesh(tp.resolve_topology(tcfg), device=CPU)
    tfit = tp.make_tree_scan_fit(tcfg, tmesh, v0=torch.from_numpy(v0))
    steps = np.stack([block[:world]] * cfg.num_steps)
    leaf = steps[:, rank:rank + 1]
    out["tree_poisoned"] = _attempt(lambda: tfit(st0(), torch.from_numpy(_poison(leaf, bad))))
    out["tree_clean"] = _attempt(lambda: tfit(st0(), torch.from_numpy(leaf))[0]
                                 .sigma_tilde.numpy())

    def fails_on_rank_1(x):
        if bad:
            raise ValueError("rank 1's factorization failed")
        return x

    out["raises_on_one"] = _attempt(
        lambda: guards.checked(fails_on_rank_1, mesh=mesh)(torch.ones(3)))
    out["after"] = _attempt(lambda: step(st0(), torch.from_numpy(share))[0]
                            .sigma_tilde.numpy())
    return out
