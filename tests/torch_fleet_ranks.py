"""Rank programs of the fleet and cohort-merge tests
(``tests/test_torch_fleet.py``, ``tests/test_torch_clients.py``).

Each function runs in every rank of a gloo group that
``parallel.mesh.launch`` starts, on the CPU, and returns numpy arrays and
plain values. This module imports torch and the port only, so no rank ever
imports JAX; it is not a test file itself (pytest collects ``test_*.py``).
"""

from __future__ import annotations

import torch

from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.parallel import clients
from distributed_eigenspaces_tpu_torch.parallel import fleet
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy().copy()


def _summary(log) -> list:
    """A recorder log as ``(op, axis, dtype, elements, group_size, tag)``
    tuples, in call order."""
    return [(r["op"], r["axis"], r["dtype"], r["elements"], r["group_size"], r["tag"])
            for r in log]


def fleet_rank(rank, world, cfg_kw, problems, v0):
    """The fleet on a fleet mesh of ``world`` ranks: ``fit_fleet`` under the
    collective recorder, this rank's tenants through ``make_fleet_fit``
    alone under another, and the refusal of a fleet the mesh does not
    divide."""
    cfg = PCAConfig(**cfg_kw)
    b = len(problems)
    mesh = fleet.fleet_mesh(b, device=CPU)
    out = {"mesh": None if mesh is None else mesh.shape}
    with pmesh.recording_collectives() as log:
        res = fleet.fit_fleet(cfg, problems, mesh=mesh, device=CPU, v0=v0)
    out.update(components=res.components, sigma=_np(res.states.sigma_tilde),
               steps=_np(res.states.step), v_bars=res.v_bars, log=_summary(log))
    batch = fleet.stage_fleet(cfg, problems)
    rows = pmesh.worker_rows(mesh, b)
    fit = fleet.make_fleet_fit(cfg, mesh, device=CPU, v0=v0)
    with pmesh.recording_collectives() as inner:
        st, _ = fit(fleet.init_fleet_states(cfg, rows.stop - rows.start, device=CPU),
                    torch.from_numpy(batch.xs[rows]), batch.actives[rows])
    out.update(local_sigma=_np(st.sigma_tilde), fit_log=_summary(inner))
    try:
        fleet.fit_fleet(cfg, problems[:b - 1], mesh=mesh, device=CPU, v0=v0)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def cohort_rank(rank, world, cfg_kw, stack, mask, wires):
    """``make_sharded_cohort_reduce`` on a workers mesh of ``world`` ranks,
    each rank given its shard of the cohort, once per wire dtype, with the
    recorder's log of each."""
    cfg = PCAConfig(**cfg_kw)
    mesh = pmesh.make_mesh(world, device=CPU)
    rows = pmesh.worker_rows(mesh, stack.shape[0])
    out = {}
    for wire in wires:
        reduce = clients.make_sharded_cohort_reduce(cfg, mesh, wire_dtype=wire)
        with pmesh.recording_collectives() as log:
            v = reduce(torch.from_numpy(stack[rows]), torch.from_numpy(mask[rows]))
        out[wire] = {"v": _np(v), "log": _summary(log)}
    return out
