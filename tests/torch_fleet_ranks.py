"""Rank programs of the fleet and cohort-merge tests
(``tests/test_torch_fleet.py``, ``tests/test_torch_clients.py``): the fleet
fit, the mesh ``FleetServer``'s cases and the sharded cohort reduce.

Each function runs in every rank of a gloo group that
``parallel.mesh.launch`` starts, on the CPU, and returns numpy arrays and
plain values. This module imports torch and the port only, so no rank ever
imports JAX; it is not a test file itself (pytest collects ``test_*.py``).
"""

from __future__ import annotations

import time

import numpy as np
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


def _outcomes(tickets) -> list:
    """Each submission's outcome: ``("ok", components)``, ``("failed",
    error, its cause)`` or ``("refused", error)`` (raised by ``submit``)."""
    out = []
    for t in tickets:
        if isinstance(t, Exception):
            out.append(("refused", type(t).__name__))
            continue
        try:
            out.append(("ok", t.result(timeout=120)))
        except Exception as e:  # noqa: BLE001 - the kind is the result
            cause = e.__cause__
            out.append(("failed", type(e).__name__,
                        None if cause is None else type(cause).__name__))
    return out


def _submit(srv, problem, **kw):
    try:
        return srv.submit(problem, **kw)
    except Exception as e:  # noqa: BLE001 - a refusal is an outcome
        return e


def _report(srv, outcomes, log) -> dict:
    records = srv.metrics.fleet_records
    return {"outcomes": outcomes, "rounds": srv.lockstep_rounds,
            "buckets": [(b["tenants"], b["compile_stall_ms"]) for b in records
                        if b["fleet"] == "bucket"],
            "notices": [b["refused"] for b in records if b["fleet"] == "notice"],
            "log": _summary(log)}


def _server(cfg, v0, **kw):
    return fleet.FleetServer(cfg, mesh=fleet.fleet_mesh(cfg.fleet_bucket_size, device=CPU),
                             device=CPU, v0=v0, **kw)


def server_cases(rank, world, cfg_kw, probs, v0):
    """The mesh ``FleetServer`` on a fleet mesh of ``world`` ranks, a fresh
    server a case, each given the same requests in the same order:

    - ``skewed``: prewarmed; rank 1 submits two, sleeps past the flush, then
      the rest, so the ranks' own timers would cut different buckets;
    - ``signatures``: two signatures (``num_steps`` T and T - 2) interleaved;
    - ``shed``: ``serve_queue_depth`` 2, each rank in turn submitting four at
      once, then meeting the other at a barrier, which then submits two and
      waits for them, then two more: the bursting rank refuses the last two,
      rank 0 by notice rounds;
    - ``raises``: one request whose staging raises on rank 1 only, with one
      retry, then a clean one;
    - ``lanes``: two lanes, buckets of two.
    """
    base = dict(cfg_kw, fleet_bucket_size=4, fleet_flush_s=0.05)
    cfg = PCAConfig(**base)
    out = {}

    with pmesh.recording_collectives() as log:
        srv = _server(cfg, v0)
        srv.prewarm()
        warm = srv.wait_warm(120)
        tickets = []
        for i, p in enumerate(probs):
            tickets.append(_submit(srv, p))
            if rank == 1 and i == 1:
                time.sleep(3 * cfg.fleet_flush_s)
        res = _outcomes(tickets)
        srv.close()
    out["skewed"] = dict(_report(srv, res, log), warm=warm)

    short = PCAConfig(**dict(base, num_steps=cfg.num_steps - 2))
    with pmesh.recording_collectives() as log:
        srv = _server(cfg, v0)
        tickets = [_submit(srv, p, cfg=short if i % 2 else cfg) for i, p in enumerate(probs)]
        res = _outcomes(tickets)
        srv.close()
    out["signatures"] = _report(srv, res, log)

    with pmesh.recording_collectives() as log:
        srv = _server(PCAConfig(**dict(base, serve_queue_depth=2)), v0)
        res = []
        for burst in (1, 0):
            four = probs[:4]
            if rank == burst:
                tickets = [_submit(srv, p) for p in four]
                pmesh.barrier()  # the burst is in before the other rank submits
                res.extend(_outcomes(tickets))
            else:  # two at a time, each pair served before the next
                pmesh.barrier()
                for pair in (four[:2], four[2:]):
                    res.extend(_outcomes([_submit(srv, p) for p in pair]))
        srv.close()
    out["shed"] = _report(srv, res, log)

    with pmesh.recording_collectives() as log:
        srv = _server(cfg, v0, max_retries=1)
        bad = probs[0] if rank == 0 else np.zeros(probs[0].shape[:-1] + (1,), np.float32)
        res = _outcomes([_submit(srv, bad)]) + _outcomes([_submit(srv, probs[1])])
        srv.close()
    out["raises"] = _report(srv, res, log)

    with pmesh.recording_collectives() as log:
        srv = _server(PCAConfig(**dict(base, fleet_bucket_size=2)), v0, num_lanes=2)
        res = _outcomes([_submit(srv, p) for p in probs])
        srv.close()
    out["lanes"] = _report(srv, res, log)
    return out


def fleet_suite(rank, world, cfg_kw, problems, v0, server_probs):
    """:func:`fleet_rank` and :func:`server_cases` in one group."""
    return {"fit": fleet_rank(rank, world, cfg_kw, problems, v0),
            "server": server_cases(rank, world, cfg_kw, server_probs, v0)}
