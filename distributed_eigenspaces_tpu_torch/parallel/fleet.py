"""Fleet serving: B tenant fits batched into each launch.

Counterpart of ``distributed_eigenspaces_tpu/parallel/fleet.py``. The
reference stacks B independent fits that share one shape signature ``(d,
k, m, n, T)`` along a leading fleet axis and ``vmap``s every per-problem
core over it, so B fits pay for one dispatch. Here the fleet axis is
written out. Each step's ``(B, m, n, d)`` blocks are one ``(B m, n, d)``
worker batch, so a cold step is one launch of the Gram kernel
(``ops.gram.gram_auto``) for all ``B m`` workers. The solves' Cholesky,
triangular solves and ``eigh`` calls, the merge
(``ops.linalg.merged_top_k_lowrank`` with a leading tenant axis), the fold
(``algo.online.fold_projector``, each tenant at its own weight) and the
extraction are batched over tenants too: a fleet step
launches what a solo step launches, not B times that.

- :func:`make_fleet_fit`: B whole fits over ``(B, T, m, n, d)`` stacked
  schedules, the solo warm schedule (a cold step 1, warm steps after) or
  every step cold, and a masked build.
- Ragged schedules ride a ``(B, T)`` active mask. An inactive step's
  solves still run (the batch has no per-tenant exit) and a select
  discards them, so a tenant's result is exactly its own ``T_b``-step fit.
  A frozen tenant whose carry holds no basis yet (a padding tenant) solves
  from the cold start, which is finite, and that solve is never reported.
- One tenant's failure is its own, as in the reference's independent
  lanes: the batched Cholesky (``ops.linalg.chol_apply``) and eigensolves
  (``ops.cusolver.eigh``) fail per batch element, NaN in that element and
  no host sync, so a tenant whose Gram is not finite or not positive
  definite comes out non-finite and every other tenant as it would alone.
- Worker masks ``(B, T, m)`` run the solo masked body's semantics
  (``algo.scan._masked_body_factory``) with per-tenant selects: cold or
  warm by the carry's liveness (read from the device once a step), the
  masked merge, the carry kept on an all-masked row.
- The fleet axis over ranks: on a workers mesh of W ranks
  (:func:`fleet_mesh`) rank r fits tenants ``[r B / W, (r + 1) B / W)``
  alone. The fit makes no collective; :func:`fit_fleet` all-gathers the
  results once after it.
- :class:`FleetServer`: requests accumulate into exact-signature buckets
  (``runtime.scheduler.ShapeBucketQueue``) that dispatch when full
  (``cfg.fleet_bucket_size``) or on a deadline (``cfg.fleet_flush_s``),
  padded with inactive tenants to the bucket size. On a mesh of ranks every
  rank runs the server, given the same requests in the same order: rank 0
  cuts the buckets and each is one round of every rank, agreed in small
  all-gathers before its one results gather.

Solo fits are the B = 1 case: ``OnlineDistributedPCA(trainer="fleet")``.

``stage_fleet(supervisor=)`` / ``fit_fleet(supervisor=)`` screen every
tenant block through ``runtime.supervisor.Supervisor.screen_block``: a
tenant's corrupt worker is that tenant's mask drop, ledgered with its
index, and a tenant whose stream dies is quarantined whole, the others
untouched. ``FleetServer(metrics=)`` feeds a ``MetricsLogger``'s fleet
section. ``compile_cache=`` (a ``utils.compile_cache.CompileCache``;
``"auto"`` resolves ``cfg.compile_cache_dir``) acquires the fleet's fit and
extraction through the persistent store, so a second process loads the
Gram kernel's library from the cache directory instead of building it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import threading
import time
from typing import Any, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from distributed_eigenspaces_tpu_torch.algo.online import (
    OnlineState,
    discount_schedule,
    fold_projector,
)
from distributed_eigenspaces_tpu_torch.algo.step import (
    merge_core,
    merge_knobs,
    merge_start,
)
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.device import resolve_device, torch_dtype
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    initial_basis,
    merged_top_k_lowrank,
    projector,
)
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel.worker_pool import _local_eigenspaces
from distributed_eigenspaces_tpu_torch.runtime.scheduler import (
    Bucket,
    QueueClosed,
    QueueFull,
    SchedulerError,
    ShapeBucketQueue,
)
from distributed_eigenspaces_tpu_torch.utils.guards import CheckError, checked
from distributed_eigenspaces_tpu_torch.utils.telemetry import NULL_TRACER, tracer_of

__all__ = [
    "FleetBatch",
    "FleetResult",
    "FleetServer",
    "FleetPCA",
    "acquire_fleet_programs",
    "fleet_mesh",
    "fleet_signature",
    "fit_fleet",
    "init_fleet_states",
    "make_fleet_fit",
    "padded_fleet_cfg",
    "stage_fleet",
]

def fleet_signature(cfg: PCAConfig) -> tuple:
    """The exact shape signature ``(d, k, m, n, T)`` two requests must
    share to ride one fleet program (the bucket key's shape half:
    :class:`FleetServer` adds the whole config)."""
    return (
        cfg.dim, cfg.k, cfg.num_workers, cfg.rows_per_worker,
        cfg.num_steps,
    )


def padded_fleet_cfg(cfg: PCAConfig) -> PCAConfig:
    """Heterogeneous-k admission: the config a ``cfg.fleet_pad_k`` request
    buckets under, ``k`` padded up to the next power of two (kept a
    multiple of ``components_axis_size``, capped at ``dim``), every other
    knob untouched. Returns ``cfg`` itself when padding would not change k
    or cannot produce a valid config."""
    k = cfg.k
    k_pad = 1
    while k_pad < k:
        k_pad *= 2
    lanes = cfg.components_axis_size
    if k_pad % lanes:
        k_pad = -(-k_pad // lanes) * lanes
    k_pad = min(k_pad, cfg.dim)
    if k_pad <= k:
        return cfg
    try:
        return dataclasses.replace(cfg, k=k_pad)
    except ValueError:
        # a knob elsewhere pins k: serve the exact shape
        return cfg


def _placeholder_rows(n: int, d: int) -> np.ndarray:
    """The port's copy of the reference's ``Supervisor._placeholder``:
    cycled identity rows, a finite and well-conditioned block for steps
    and tenants that carry no data (all zeros would make a CholeskyQR of
    the discarded solve singular)."""
    rows = np.zeros((n, d), np.float32)
    rows[np.arange(n), np.arange(n) % d] = 1.0
    return rows


def _where(keep: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-tenant select along axis 0: ``new[b]`` where ``keep[b]``."""
    return torch.where(keep.view(-1, *([1] * (new.dim() - 1))), new, old)


class _FleetCores:
    """The tenant-batched cores of one fleet program: the worker solves of
    B tenants as one ``(B m, n, d)`` batch, the merge and the fold."""

    def __init__(self, cfg: PCAConfig, dev: torch.device, v0, v_init):
        self.cfg = cfg
        self.dev = dev
        self.v_cold = initial_basis(cfg.dim, cfg.k, seed=cfg.seed, device=dev, v0=v0)
        self.v_merge = merge_start(cfg, device=dev, v_init=v_init)
        self.knobs = merge_knobs(cfg)
        self.flat = self.knobs["topology"] is None and self.knobs["dist_iters"] is None
        self.warm_iters = cfg.resolved_warm_start()
        self.xdtype = (torch.float32 if cfg.compute_dtype is None
                       else torch_dtype(cfg.compute_dtype))

    def block(self, xs: torch.Tensor, t: int) -> torch.Tensor:
        """Step ``t`` of the ``(B, T, m, n, d)`` stack on the device in the
        compute dtype: one cast a step, as the solo trainers cast."""
        return xs[:, t].to(device=self.dev, dtype=self.xdtype).contiguous()

    def solve(self, x: torch.Tensor, v0: torch.Tensor, warm: bool) -> torch.Tensor:
        """Every tenant's worker solves, ``(B, m, n, d) -> (B, m, d, k)``,
        from the shared ``(d, k)`` start or per-tenant ``(B, d, k)`` ones."""
        cfg = self.cfg
        b, m, n, d = x.shape
        if v0.dim() == 3:
            v0 = v0.repeat_interleave(m, dim=0)
        iters = self.warm_iters if warm else cfg.subspace_iters
        orth = cfg.resolved_warm_orth() if warm else cfg.orth_method
        with record_function("det_worker_solve"):
            vs = _local_eigenspaces(x.reshape(b * m, n, d), cfg.k,
                                    cfg.resolved_local_solver(), iters, orth,
                                    cfg.compute_dtype, v0=v0)
        return vs.reshape(b, m, d, cfg.k)

    def merge(self, vs: torch.Tensor, mask=None) -> torch.Tensor:
        """Every tenant's masked merge, ``(B, m, d, k) -> (B, d, k)``: the
        flat low-rank merge batched; the tree and the distributed merges
        tenant by tenant (``algo.step.merge_core``)."""
        k = self.cfg.k
        if self.flat:
            with record_function("det_merge"):
                return merged_top_k_lowrank(vs, k, mask)
        return torch.stack([
            merge_core(vs[b], k, mask=None if mask is None else mask[b],
                       v_init=self.v_merge, **self.knobs)
            for b in range(vs.shape[0])
        ])

    def round(self, x, v0, warm: bool) -> torch.Tensor:
        return self.merge(self.solve(x, v0, warm))

    def fold(self, sigma, v, w, om) -> torch.Tensor:
        return fold_projector(sigma, projector(v), w[:, None, None],
                              om[:, None, None], discount=self.cfg.discount)


def _host_array(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def make_fleet_fit(cfg: PCAConfig, mesh=None, *, masked: bool = False,
                   device="cuda", v0=None, v_init=None):
    """Build the B-tenant whole-fit trainer.

    Returns ``fit(states, xs, actives) -> (states, v_bars)``, or with
    ``masked=True`` ``fit(states, xs, masks, actives)``, where

    - ``states``: a batched ``OnlineState`` (``sigma_tilde (B, d, d)`` on
      the device, ``step (B,)`` int32 on the host), :func:`init_fleet_states`;
    - ``xs``: ``(B, T, m, n, d)`` stacked schedules (:func:`stage_fleet`
      pads ragged tails with finite placeholder blocks), on the device or
      the host; each step is cast to the compute dtype as it is used;
    - ``actives``: ``(B, T)`` {0, 1}: step t advances tenant b iff
      ``actives[b, t]``, each tenant's active steps a prefix of the
      schedule (as :func:`stage_fleet` stages them); a frozen step's
      ``v_bars[b, t]`` is the carried basis (zeros before any);
    - ``masks``: ``(B, T, m)`` {0, 1} per-tenant worker masks;
    - ``v_bars``: ``(B, T, d, k)`` on the device.

    ``v0 (d, k)`` is every cold solve's start (default: drawn from
    ``cfg.seed``), ``v_init`` the crossover merge's (``algo.step.
    merge_start``). With ``mesh`` (:func:`fleet_mesh`) the trainer runs on
    the mesh's device over this rank's tenants; it makes no collective
    (with the guards armed, the two flag all-reduces of ``checked``).

    ``pipeline_merge`` and ``merge_interval > 1`` are refused, with the
    reference's messages. Under ``DET_CHECKIFY=1`` both fits run inside
    ``utils.guards.checked``: a non-finite tenant fails the whole call
    (the reference's ``checked_jit`` around the batched program), and on a
    mesh every rank raises alike, each rank having checked its tenants.
    """
    if cfg.pipeline_merge:
        raise ValueError(
            "fleet fits do not support pipeline_merge: the pipelined "
            "pending-factor carry does not compose with the per-tenant "
            "ragged-T freeze (use the solo scan trainer for pipelined "
            "fits)"
        )
    if cfg.merge_interval != 1:
        raise ValueError(
            "fleet fits run the s=1 per-step merge: ragged tenants sit "
            "at different schedule phases, so a shared merge interval "
            "would change per-tenant results (use the solo trainers "
            "for merge_interval > 1)"
        )
    dev = pmesh.mesh_device(mesh, device)
    cores = _FleetCores(cfg, dev, v0, v_init)
    warm = cores.warm_iters is not None
    T = cfg.num_steps

    def schedule(xs, actives):
        act = _host_array(actives, np.float32) != 0
        if act.shape != (xs.shape[0], T) or xs.shape[1] != T:
            raise ValueError(
                f"fleet schedule: xs {tuple(xs.shape)} and actives "
                f"{act.shape} must be (B, T={T}, ...) and (B, T)"
            )
        w, om = discount_schedule(cfg.discount, act, cfg.num_steps)
        sched = dict(
            act=act, all_on=act.all(axis=0),
            keep=torch.from_numpy(act.T.copy()).to(dev),
            w=torch.from_numpy(w).to(dev), om=torch.from_numpy(om).to(dev),
        )
        return sched

    def folded(sched, t, sigma, v):
        new = cores.fold(sigma, v, sched["w"][t], sched["om"][t])
        return new if sched["all_on"][t] else _where(sched["keep"][t], new, sigma)

    def finish(states, sched, sigma, out):
        steps = states.step + torch.from_numpy(sched["act"].sum(axis=1).astype(np.int32))
        return OnlineState(sigma, steps), torch.stack(out, dim=1)

    def fit(states: OnlineState, xs, actives):
        sched = schedule(xs, actives)
        act, all_on, keep = sched["act"], sched["all_on"], sched["keep"]
        sigma, out = states.sigma_tilde, []
        if not warm:
            for t in range(T):
                v = cores.round(cores.block(xs, t), cores.v_cold, warm=False)
                sigma = folded(sched, t, sigma, v)
                out.append(v if all_on[t] else _where(keep[t], v, torch.zeros_like(v)))
            return finish(states, sched, sigma, out)
        # step 1 cold at the full iteration count: every tenant of a bucket
        # starts together, so the phase is the same across the fleet
        v = cores.round(cores.block(xs, 0), cores.v_cold, warm=False)
        sigma = folded(sched, 0, sigma, v)
        vp = v if all_on[0] else _where(keep[0], v, torch.zeros_like(v))
        out.append(vp)
        # a lane inactive at step 1 (a padding tenant) never holds a basis:
        # it solves from the cold start, finite, and the selects discard it
        start = None if all_on[0] else keep[0]
        for t in range(1, T):
            v_start = vp if start is None else _where(start, vp, cores.v_cold.expand_as(vp))
            v = cores.round(cores.block(xs, t), v_start, warm=True)
            sigma = folded(sched, t, sigma, v)
            vp = v if all_on[t] else _where(keep[t], v, vp)
            out.append(vp)
        return finish(states, sched, sigma, out)

    if not masked:
        return checked(fit, mesh=mesh)

    def fit_masked(states: OnlineState, xs, masks, actives):
        sched = schedule(xs, actives)
        act, all_on, keep = sched["act"], sched["all_on"], sched["keep"]
        mk = _host_array(masks, np.float32)
        b = xs.shape[0]
        if mk.shape != (b, T, cfg.num_workers):
            raise ValueError(
                f"masks shape {mk.shape} != (B={b}, T={T}, "
                f"num_workers={cfg.num_workers})"
            )
        mk_dev = torch.from_numpy(mk).to(dev)
        sigma, out = states.sigma_tilde, []
        vp = torch.zeros((b, cfg.dim, cfg.k), dtype=torch.float32, device=dev)
        for t in range(T):
            x = cores.block(xs, t)
            # the carry's liveness, read on the host once a step (the solo
            # masked body's ``_live``): warm from the carry, else cold
            live = (vp != 0).flatten(1).any(dim=1).cpu().numpy() if warm else np.zeros(b, bool)
            if live.all():
                vs = cores.solve(x, vp, warm=True)
            elif not live.any():
                vs = cores.solve(x, cores.v_cold, warm=False)
            else:
                wi = torch.from_numpy(np.flatnonzero(live)).to(dev)
                ci = torch.from_numpy(np.flatnonzero(~live)).to(dev)
                vs = torch.empty((b, cfg.num_workers, cfg.dim, cfg.k),
                                 dtype=torch.float32, device=dev)
                vs[wi] = cores.solve(x[wi], vp[wi], warm=True)
                vs[ci] = cores.solve(x[ci], cores.v_cold, warm=False)
            v_new = cores.merge(vs, mk_dev[:, t])
            sigma = folded(sched, t, sigma, v_new)
            # the warm carry advances on an active step with a live row
            upd = act[:, t] & mk[:, t].any(axis=1)
            if upd.all():
                vp = v_new
            elif upd.any():
                vp = _where(torch.from_numpy(upd).to(dev), v_new, vp)
            out.append(v_new if all_on[t] else _where(keep[t], v_new, vp))
        return finish(states, sched, sigma, out)

    return checked(fit_masked, mesh=mesh)


def init_fleet_states(cfg: PCAConfig, b: int, *, device="cuda") -> OnlineState:
    """Batched initial online state of a B-tenant fleet: ``sigma_tilde (B,
    d, d)`` zeros on ``device``, ``step (B,)`` int32 zeros on the host."""
    return OnlineState(
        sigma_tilde=torch.zeros((b, cfg.dim, cfg.dim), dtype=torch_dtype(cfg.state_dtype),
                                device=resolve_device(device)),
        step=torch.zeros((b,), dtype=torch.int32),
    )


def fleet_mesh(b: int, device="cuda"):
    """The workers mesh a B-tenant fleet shards over, or None: outside a
    process group, and when no divisor of B above 1 fits the group's ranks.
    The fleet axis is the ``workers`` axis, one tenant's whole fit a slot,
    sized to the largest divisor of B up to the group's size (a layout that
    leaves ranks out is refused, as ``parallel.mesh.workers_mesh`` does)."""
    if pmesh.world_size() <= 1:
        return None
    mesh = pmesh.workers_mesh(b, device)
    if mesh is None or mesh.axis_size(pmesh.WORKER_AXIS) <= 1:
        return None
    return mesh


def _placeholder_block(m: int, n: int, d: int) -> np.ndarray:
    """Finite, well-conditioned padding for inactive steps and tenants: the
    placeholder rows broadcast to a whole ``(m, n, d)`` block."""
    return np.broadcast_to(_placeholder_rows(n, d)[None], (m, n, d))


def _tenant_blocks(cfg: PCAConfig, problem) -> Iterable:
    """One tenant's ``(m, n, d)`` step blocks from any accepted problem
    form: an ``(N, d)`` dataset (numpy or torch, streamed as the solo
    estimator streams it), a pre-blocked ``(T_b, m, n, d)`` stack, or an
    iterable of blocks."""
    if hasattr(problem, "ndim") and problem.ndim == 2:
        from distributed_eigenspaces_tpu_torch.data.stream import block_stream

        return block_stream(
            problem,
            num_workers=cfg.num_workers,
            rows_per_worker=cfg.rows_per_worker,
            num_steps=cfg.num_steps,
            remainder=cfg.remainder,
            device="cpu",
        )
    if hasattr(problem, "ndim"):
        if problem.ndim != 4:
            raise ValueError(
                f"tenant problem array must be (N, d) or (T, m, n, d), "
                f"got shape {tuple(problem.shape)}"
            )
        return iter(problem)
    return iter(problem)


@dataclasses.dataclass
class FleetBatch:
    """One staged fleet dispatch: B tenants stacked along axis 0, padded
    to a common T (and optionally to a bucket size B_pad with inactive
    tenants)."""

    xs: np.ndarray  # (B_pad, T, m, n, d) float32
    actives: np.ndarray  # (B_pad, T) {0, 1}
    masks: np.ndarray | None  # (B_pad, T, m) {0, 1}; None = unmasked
    n_tenants: int  # real tenants (<= B_pad; the rest is padding)
    signature: tuple

    @property
    def fleet_size(self) -> int:
        return self.xs.shape[0]


def stage_fleet(
    cfg: PCAConfig,
    problems: Sequence[Any],
    *,
    worker_masks=None,
    supervisor=None,
    pad_to: int | None = None,
) -> FleetBatch:
    """Stage B tenant problems into one fleet batch on the host, in fp32
    (whatever ``cfg.stage_dtype`` says: each step is cast to the compute
    dtype on the device, as the reference's fleet stages it).

    A tenant whose data yields ``T_b < cfg.num_steps`` blocks gets
    placeholder padding and an inactive tail (its result is exactly its own
    ``T_b``-step fit). ``worker_masks`` is an optional per-tenant sequence
    of ``(T_b, m)`` mask schedules (entries may be None for all-live
    tenants). ``pad_to`` pads the fleet axis with inactive tenants so a
    partial bucket runs at the full bucket's width. ``supervisor`` (a
    ``runtime.supervisor.Supervisor``) screens every tenant block through
    its quarantine check: a corrupt worker becomes that tenant's mask drop,
    ledgered with its tenant index, and a tenant whose stream dies with
    ``utils.faults.KillSwitch`` is quarantined whole (its remaining steps
    inactive, ledger kind ``"tenant_killed"``) without touching the other
    tenants' fits.
    """
    from distributed_eigenspaces_tpu_torch.utils.faults import KillSwitch

    b_real = len(problems)
    if b_real == 0:
        raise ValueError("stage_fleet needs at least one tenant")
    b_pad = max(b_real, pad_to or 0)
    m, n, d, t_max = (
        cfg.num_workers, cfg.rows_per_worker, cfg.dim, cfg.num_steps,
    )
    if worker_masks is not None and len(worker_masks) != b_real:
        raise ValueError(
            f"worker_masks covers {len(worker_masks)} tenants, fleet "
            f"has {b_real}"
        )

    ph = _placeholder_block(m, n, d)
    xs = np.empty((b_pad, t_max, m, n, d), np.float32)
    actives = np.zeros((b_pad, t_max), np.float32)
    masks = np.ones((b_pad, t_max, m), np.float32)
    any_mask = worker_masks is not None or supervisor is not None

    for b, problem in enumerate(problems):
        base = None if worker_masks is None else worker_masks[b]
        if base is not None:
            base = _host_array(base, np.float32)
            if base.ndim != 2 or base.shape[1] != m:
                raise ValueError(
                    f"tenant {b} worker_masks shape {base.shape} != "
                    f"(T, num_workers={m})"
                )
        it = _tenant_blocks(cfg, problem)
        t = 0
        while t < t_max:
            try:
                block = next(it)
            except StopIteration:
                break
            except KillSwitch as e:
                if supervisor is None:
                    raise
                # a hard tenant death: the whole tenant is quarantined from
                # this step on; the other tenants never notice
                supervisor.record("tenant_killed", t + 1, tenant=b, error=repr(e))
                break
            base_row = None
            if base is not None:
                if t >= len(base):
                    raise ValueError(
                        f"tenant {b} worker_masks covers {len(base)} "
                        f"steps; its schedule reached step {t + 1} — "
                        "every step needs its mask row"
                    )
                base_row = base[t]
            if supervisor is not None:
                screened = supervisor.screen_block(block, t + 1,
                                                   base_mask=base_row, tenant=b)
                if screened is None:
                    continue  # dropped round: same step, next block
                block, base_row = screened
            if base_row is not None:
                masks[b, t] = base_row
            block = _host_array(block, np.float32)
            if block.shape != (m, n, d):
                raise ValueError(
                    f"tenant {b} step {t + 1} block shape {block.shape}"
                    f" != ({m}, {n}, {d})"
                )
            xs[b, t] = block
            actives[b, t] = 1.0
            t += 1
        if t == 0 and supervisor is None:
            raise ValueError(f"tenant {b} yielded zero full steps")
        xs[b, t:] = ph
    xs[b_real:] = ph

    return FleetBatch(
        xs=xs,
        actives=actives,
        masks=masks if any_mask else None,
        n_tenants=b_real,
        signature=fleet_signature(cfg),
    )


@dataclasses.dataclass
class FleetResult:
    """Per-tenant results of one fleet dispatch (padding dropped)."""

    components: np.ndarray  # (B, d, k), descending, canonical signs
    #: final online states: ``sigma_tilde (B, d, d)`` on the device,
    #: ``step (B,)`` int32 on the host
    states: OnlineState
    v_bars: np.ndarray  # (B, T, d, k) per-step merged bases
    batch: FleetBatch
    #: wall ms this dispatch spent acquiring its programs
    #: (:func:`acquire_fleet_programs`; 0.0 on a ``fit_cache`` hit)
    compile_ms: float = 0.0

    def __len__(self) -> int:
        return len(self.components)


def _start_key(v):
    """A cache key for an explicit start (None: the seeded one)."""
    if v is None:
        return None
    return hashlib.sha256(_host_array(v, np.float32).tobytes()).hexdigest()


def _fleet_cache_key(cfg: PCAConfig, masked: bool, b_pad: int, mesh, dev,
                     v0=None, v_init=None):
    """The ``fit_cache`` key: everything that changes a bucket's programs
    (one definition for :func:`fit_fleet` and the prewarm path, so a
    prewarmed program is the program dispatch fetches)."""
    return (
        repr(cfg), masked, b_pad,
        None if mesh is None else tuple(mesh.shape.items()),
        str(dev), _start_key(v0), _start_key(v_init),
    )


def _acquire_device(dev: torch.device) -> None:
    """First-use costs on the card, paid where programs are acquired
    rather than inside a bucket: the Gram kernels' build (``nvcc``, once a
    checkout) and the start-up of the cuBLAS / cuSOLVER libraries."""
    if dev.type != "cuda":
        return
    from distributed_eigenspaces_tpu_torch.ops import _build, cusolver
    from distributed_eigenspaces_tpu_torch.ops.cusolver import BATCHED_N

    _build.load("gram")
    cusolver.eigh(torch.eye(BATCHED_N[0], device=dev))
    a = torch.eye(2, device=dev)
    torch.linalg.eigh(a)
    torch.linalg.qr(a)
    torch.linalg.solve_triangular(torch.linalg.cholesky_ex(a)[0], a, upper=False)
    torch.matmul(a, a)
    torch.cuda.synchronize(dev)


def acquire_fleet_programs(
    cfg: PCAConfig,
    mesh,
    *,
    masked: bool,
    b_pad: int,
    fit_cache: dict | None = None,
    compile_cache=None,
    device="cuda",
    v0=None,
    v_init=None,
):
    """Build, or fetch from ``fit_cache``, the fleet fit and extraction
    programs of one padded bucket shape; returns ``(fit, extract,
    build_ms)``.

    The port has no compile step: ``build_ms`` is the wall time acquiring
    the programs costs here, building the closures and, on a first use in
    the process, the Gram kernels' build (``ops/_build.py``) and the
    cuBLAS / cuSOLVER start-up (0.0 on a cache hit, the steady state).
    :class:`FleetServer` reports it per bucket as ``compile_ms``. With
    ``compile_cache`` (a ``utils.compile_cache.CompileCache``) the fit
    (and, on one device, the extraction) is acquired through the
    persistent store, keyed by the padded bucket's shape, the config's
    program knobs, the seed, the starts and the device.
    """
    dev = pmesh.mesh_device(mesh, device)
    key = _fleet_cache_key(cfg, masked, b_pad, mesh, dev, v0, v_init)
    if fit_cache is not None and key in fit_cache:
        fit, extract = fit_cache[key]
        return fit, extract, 0.0
    t0 = time.perf_counter()

    def build_fit():
        return make_fleet_fit(cfg, mesh, masked=masked, device=dev, v0=v0,
                              v_init=v_init)

    def build_extract():
        return _make_extract_fleet(cfg, dev, v0)

    if compile_cache is not None:
        from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
            config_knobs,
            fit_libraries,
            make_key,
        )

        starts = (cfg.seed, _start_key(v0), _start_key(v_init), str(dev))
        mesh_shape = None if mesh is None else tuple(mesh.shape.items())
        sig = (cfg.dim, cfg.k, cfg.num_workers, cfg.rows_per_worker,
               cfg.num_steps, b_pad, bool(masked), mesh_shape, starts)
        fit = compile_cache.get_or_build(
            make_key("fleet_fit", sig, "float32", knobs=config_knobs(cfg),
                     device=dev),
            build_fit,
            libraries=fit_libraries(cfg, staged=False) if dev.type == "cuda" else (),
        )
        # the extraction through the store on one device only, as the
        # reference's (a mesh rank extracts its tenants directly)
        extract = build_extract() if mesh is not None else compile_cache.get_or_build(
            make_key("fleet_extract", (cfg.dim, cfg.k, b_pad, starts), "float32",
                     knobs=config_knobs(cfg), device=dev),
            build_extract,
        )
    else:
        fit, extract = build_fit(), build_extract()
    _acquire_device(dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    if fit_cache is not None:
        fit_cache[key] = (fit, extract)
    return fit, extract, build_ms


def _make_extract_fleet(cfg: PCAConfig, dev, v0=None):
    """The solo ``extract_dense`` over a ``(B, d, d)`` state: each solve
    batched over tenants, from the same cold start."""
    from distributed_eigenspaces_tpu_torch.api.runner import extract_dense

    v_cold = initial_basis(cfg.dim, cfg.k, seed=cfg.seed, device=dev, v0=v0)
    return lambda sigma: extract_dense(cfg, sigma, v0=v_cold)


def _gather_results(mesh, sigma, steps, v_bars, w):
    """Every rank's tenants of the four results, in tenant order, by ONE
    all-gather over ``workers`` (the results packed into one fp32 row a
    tenant)."""
    n, d = sigma.shape[:2]
    dev = sigma.device
    parts = (sigma, v_bars, w, steps.to(device=dev, dtype=torch.float32))
    packed = torch.cat([p.float().reshape(n, -1) for p in parts], dim=1)
    with pmesh.mesh_scope(mesh):
        whole = pmesh.all_gather(packed, pmesh.WORKER_AXIS)
    b = whole.shape[0]
    cuts = np.cumsum([p[0].numel() for p in parts])[:-1].tolist()
    s, vb, ws, st = torch.tensor_split(whole, cuts, dim=1)
    return (s.reshape(b, d, d).to(sigma.dtype), st[:, 0].cpu().to(torch.int32),
            vb.reshape(b, *v_bars.shape[1:]), ws.reshape(b, *w.shape[1:]))


def _check_divisible(b_pad: int, mesh) -> None:
    if mesh is not None and b_pad % mesh.axis_size(pmesh.WORKER_AXIS):
        raise ValueError(
            f"fleet size {b_pad} not divisible by the mesh fleet axis "
            f"{mesh.axis_size(pmesh.WORKER_AXIS)}"
        )


def fit_fleet(
    cfg: PCAConfig,
    problems: Sequence[Any],
    *,
    mesh="auto",
    worker_masks=None,
    supervisor=None,
    pad_to: int | None = None,
    fit_cache: dict | None = None,
    compile_cache="auto",
    device="cuda",
    v0=None,
    v_init=None,
) -> FleetResult:
    """Fit B independent problems sharing ``cfg``'s shape signature as one
    fleet program; returns per-tenant results equal to the solo fits'
    (``sigma_tilde`` to fp32 rounding).

    The staged ``(B_pad, T, m, n, d)`` stack is copied to the device once
    (this rank's tenants of it on a mesh). ``mesh="auto"`` shards the fleet
    axis over the ranks of a process group (:func:`fleet_mesh`; None in
    one process); pass None to force one device, or a workers mesh. On a
    mesh each rank fits and extracts its tenants, then one all-gather gives
    every rank every tenant's results. ``fit_cache`` (a dict the caller
    owns) reuses programs across calls, keyed by config, variant, B, mesh,
    device and starts. ``compile_cache`` backs the program build with the
    persistent store (``"auto"`` resolves ``cfg.compile_cache_dir`` through
    ``utils.compile_cache.compile_cache_for``; pass a ``CompileCache`` or
    None). ``supervisor`` screens every tenant block
    (:func:`stage_fleet`). ``v0`` / ``v_init`` as for
    :func:`make_fleet_fit`.
    """
    batch = stage_fleet(
        cfg, problems, worker_masks=worker_masks, supervisor=supervisor,
        pad_to=pad_to,
    )
    b_pad = batch.fleet_size
    masked = batch.masks is not None
    if mesh == "auto":
        mesh = fleet_mesh(b_pad, device)
    _check_divisible(b_pad, mesh)
    if compile_cache == "auto":
        from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
            compile_cache_for,
        )

        compile_cache = compile_cache_for(cfg)
    fit, extract, build_ms = acquire_fleet_programs(
        cfg, mesh, masked=masked, b_pad=b_pad, fit_cache=fit_cache,
        compile_cache=compile_cache, device=device, v0=v0, v_init=v_init,
    )
    local = _fit_batch(cfg, batch, fit, extract, mesh, device)
    return _fleet_result(batch, mesh, local, build_ms)


def _fit_batch(cfg: PCAConfig, batch: FleetBatch, fit, extract, mesh, device) -> tuple:
    """This rank's half of a fleet fit (every tenant without a mesh):
    ``(sigma_tilde, steps, v_bars, components)`` of its tenants, made with
    no collective."""
    b_pad = batch.fleet_size
    dev = pmesh.mesh_device(mesh, device)
    rows = slice(0, b_pad) if mesh is None else pmesh.worker_rows(mesh, b_pad)
    n_local = rows.stop - rows.start
    real_local = min(max(batch.n_tenants - rows.start, 0), n_local)
    xs = torch.from_numpy(batch.xs[rows]).to(dev)  # one copy of the stack
    states = init_fleet_states(cfg, n_local, device=dev)
    with record_function("det_fleet_fit"):
        if batch.masks is not None:
            states, v_bars = fit(states, xs, batch.masks[rows], batch.actives[rows])
        else:
            states, v_bars = fit(states, xs, batch.actives[rows])
    del xs
    w = torch.zeros((n_local, cfg.dim, cfg.k), dtype=torch.float32, device=dev)
    if real_local:
        # padding lanes carry a zero state: only real tenants are extracted
        w[:real_local] = extract(states.sigma_tilde[:real_local])
    return states.sigma_tilde, states.step, v_bars, w


def _fleet_result(batch: FleetBatch, mesh, local: tuple, build_ms: float) -> FleetResult:
    """The :class:`FleetResult` of :func:`_fit_batch`'s output: on a mesh,
    after the one all-gather of every rank's tenants."""
    sigma, steps, v_bars, w = local
    if mesh is not None:
        sigma, steps, v_bars, w = _gather_results(mesh, sigma, steps, v_bars, w)
    nreal = batch.n_tenants
    return FleetResult(
        components=w[:nreal].cpu().numpy(),
        states=OnlineState(sigma[:nreal], steps[:nreal]),
        v_bars=v_bars[:nreal].cpu().numpy(),
        batch=batch,
        compile_ms=round(build_ms, 3),
    )


class FleetPCA:
    """Multi-tenant estimator: B independent datasets, one fleet program,
    per-tenant components; the fleet twin of ``OnlineDistributedPCA``
    (whose ``trainer="fleet"`` is the B = 1 case).

    Example::

        fleet = FleetPCA(PCAConfig(dim=256, k=4, num_workers=4,
                                   rows_per_worker=128, num_steps=8))
        fleet.fit([data_a, data_b, data_c])      # each (N_b, 256)
        z = fleet.transform(1, data_b)           # tenant 1's projection
    """

    def __init__(self, cfg: PCAConfig, *, mesh="auto", device="cuda", v0=None,
                 compile_cache="auto"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.v0 = v0
        #: as :func:`fit_fleet`'s (``"auto"``: ``cfg.compile_cache_dir``)
        self.compile_cache = compile_cache
        self.result: FleetResult | None = None
        self._fit_cache: dict = {}

    def fit(self, problems, *, worker_masks=None, supervisor=None) -> "FleetPCA":
        self.result = fit_fleet(
            self.cfg, problems, mesh=self.mesh,
            worker_masks=worker_masks, supervisor=supervisor,
            fit_cache=self._fit_cache, compile_cache=self.compile_cache,
            device=self.device, v0=self.v0,
        )
        return self

    @property
    def components_(self) -> np.ndarray:
        """(B, d, k) per-tenant principal directions."""
        if self.result is None:
            raise RuntimeError("call fit() first")
        return self.result.components

    def transform(self, tenant: int, x) -> torch.Tensor:
        """Tenant ``tenant``'s projection of ``(N, d)`` rows, on the
        estimator's device, as ``OnlineDistributedPCA.transform`` projects
        (``ops.serve_project.project_exact``)."""
        from distributed_eigenspaces_tpu_torch.ops.serve_project import project_exact

        w = torch.as_tensor(self.components_[tenant]).to(self.device)
        x = torch.as_tensor(x).to(device=self.device, dtype=torch_dtype(self.cfg.dtype))
        return project_exact(x, w)


@dataclasses.dataclass
class _FleetRequest:
    cfg: PCAConfig
    problem: Any
    worker_masks: Any = None
    #: the k-padded config this request buckets under when
    #: ``cfg.fleet_pad_k`` admitted it into a shared-width bucket; None =
    #: exact-shape admission. The tenant's own ``cfg`` still slices its
    #: result (the first ``cfg.k`` columns).
    pad_cfg: PCAConfig | None = None
    t_submit: float = 0.0
    #: the request's trace (``Tracer.new_trace("fleet")``), or None
    trace_id: str | None = None
    #: its admission sequence number: its place in the order every rank of
    #: a mesh server is given the requests (-1 on one device)
    seq: int = -1


#: what rank 0 announces at the head of a mesh round (column 0 of its row)
_IDLE, _ROUND, _NOTICE, _END = 0, 1, 2, 3
#: how long a follower waits for a request a round names to be submitted
#: there, before the round fails it as out of step
ADMIT_WAIT_S = 30.0
#: the mesh server's own gloo groups' collective timeout, and how long
#: ``close()`` waits for every rank to reach it
ROUND_TIMEOUT_S = 300.0
#: what a rank holds of a request a round names
_SHED, _HAVE, _MISSING, _OTHER = 0, 1, 2, 3


class FleetRoundError(RuntimeError):
    """A mesh round's staging, program acquisition or fit raised on the
    ranks its message names. Every rank raises it alike (the one that
    raised chains its own exception), so the retry ladder and the breaker
    see one failure everywhere."""


@dataclasses.dataclass
class _Notice(Bucket):
    """Rank 0's notice of requests its admission refused: the other ranks
    fail them alike."""

    shed: tuple = ()


def _sig_code(signature) -> int:
    """A digest of a bucket signature, the same on every rank (62 bits, so
    it rides an int64 row)."""
    return int.from_bytes(hashlib.sha256(repr(signature).encode()).digest()[:8],
                          "little") >> 2


class FleetServer:
    """Shape-bucketed admission and batched dispatch: the serving loop.

    ``submit(data)`` returns a ticket that resolves to the tenant's ``(d,
    k)`` components (numpy) once its bucket has run. Buckets key on the
    exact config; a bucket dispatches when full (``cfg.fleet_bucket_size``)
    or when its oldest request has waited ``cfg.fleet_flush_s``, padded
    with inactive tenants to the bucket size so every bucket of a signature
    runs at one width. Dispatch runs on the queue's lane thread with the
    ``WorkQueue``'s lease and retry semantics (``runtime/scheduler.py``),
    one failing signature failing its own tickets only;
    ``cfg.serve_queue_depth`` sheds the newest request past the depth
    (``ServerOverloaded``) and ``cfg.serve_breaker_threshold`` trips a
    signature's breaker.

    ``mesh``: None runs every bucket on ``device`` in this process; a
    workers mesh (:func:`fleet_mesh`) or ``"auto"`` inside a process group
    runs the server on every rank of the group (below); ``"auto"`` resolves
    per bucket as the reference's ``_resolve_mesh`` does, to
    ``fleet_mesh(cfg.fleet_bucket_size)`` (None in one process, so there
    ``"auto"`` is the one-device server). ``v0``, when given, is the cold
    start of every bucket whose k is its width. The server's
    ``MetricsLogger`` (``metrics=``, else one of its own) receives each
    bucket as a fleet event in ``fleet_records``: its tenants, occupancy,
    ``compile_stall_ms`` (the acquisition its dispatch paid: 0.0 once
    prewarmed), padded lanes, queue waits and seconds;
    ``summary()["fleet"]`` aggregates them (padded lanes and compile stalls
    by signature, the latency decomposition; ``cfg.fleet_slo_p99_ms``
    becomes its fleet SLO), and its tracer records each tenant's span chain
    (admit, queue_wait, dispatch, compile_stall, compute). Program builds go
    through ``compile_cache`` (default: ``compile_cache_for(cfg)``, else a
    memory-only ``CompileCache``), so ``compile_stall_ms`` is a measured
    acquisition and a cache directory makes a second process start warm.

    **On a mesh of ranks** every rank of the group constructs the server
    with the same ``cfg``, ``mesh`` and ``v0`` and is given the same
    requests in the same order (as ``QueryServer(mesh=)``); each request
    is numbered by that order. Rank 0's queue cuts the buckets, with its
    own timer; the others queue as followers (``ShapeBucketQueue(
    follower=True)``) and run what rank 0 announces. A round is:

    1. rank 0's announcement, one small all-gather: the signature's
       digest, the requests' numbers, and whether this attempt is the last
       of the retry ladder (``max_retries``);
    2. what each rank holds of them, one small all-gather (a follower
       waits up to ``ADMIT_WAIT_S`` for a request not yet submitted
       there): a request that any rank shed at admission
       (``serve_queue_depth``, an open breaker) fails on every rank with
       ``ServerOverloaded``, one that never reached a rank or differs there
       fails as out of step, and the rest run;
    3. staging and program acquisition, then one all-gather of whether
       every rank got through them;
    4. the fit, each rank its ``b_pad / W`` tenants with no collective
       (two flag all-reduces when the guards are armed), then one
       all-gather of whether it raised anywhere: if so every rank raises
       the same ``FleetRoundError`` (or ``CheckError``), and rank 0's
       retry ladder announces the round again or, after its last attempt,
       every rank fails its tickets;
    5. the one fp32 all-gather of the results: each rank's tickets resolve
       to the same arrays, bit for bit.

    Rank 0 announces a shed of its own at admission in a notice round (a
    ``{"fleet": "notice"}`` record on every rank), so a follower fails the
    request too, or refuses it if it comes there later. The rounds of
    ``num_lanes`` lanes run one at a time. ``lockstep_rounds`` counts the
    rounds that ran a fit. The agreement rides a gloo group of the
    server's own; ``close()`` first waits at a monitored barrier, so a rank
    that never reaches ``close()`` within ``ROUND_TIMEOUT_S`` is named in a
    ``TimeoutError`` instead of being waited on forever. The server has no
    deadline shed: a bucket's deadline is its flush.
    """

    def __init__(
        self,
        cfg: PCAConfig,
        *,
        mesh="auto",
        num_lanes: int = 1,
        max_retries: int = 3,
        lease_timeout: float | None = None,
        metrics=None,
        compile_cache=None,
        device="cuda",
        v0=None,
    ):
        from distributed_eigenspaces_tpu_torch.utils.compile_cache import (
            CompileCache,
            compile_cache_for,
        )

        if mesh == "auto":
            self.on_mesh = pmesh.world_size() > 1
        else:
            self.on_mesh = mesh is not None and mesh.device_mesh is not None
        self.mesh = mesh
        self.cfg = cfg
        if metrics is None:
            from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

            metrics = MetricsLogger()
        self.metrics = metrics
        if (
            cfg.fleet_slo_p99_ms is not None
            and metrics.fleet_slo_p99_ms is None
        ):
            metrics.fleet_slo_p99_ms = cfg.fleet_slo_p99_ms
        self.device = (mesh.device if mesh not in (None, "auto")
                       else pmesh._mesh_device(device))
        self.v0 = None if v0 is None else _host_array(v0, np.float32)
        self.compile_cache = (
            compile_cache or compile_cache_for(cfg) or CompileCache(None)
        )
        self.prewarmer = None
        self.leader = not self.on_mesh or pmesh.rank() == 0
        self.max_retries = max_retries
        #: mesh rounds that ran a fit (QueryServer's counter of the same name)
        self.lockstep_rounds = 0
        self.queue = ShapeBucketQueue(
            bucket_size=cfg.fleet_bucket_size,
            flush_deadline=cfg.fleet_flush_s,
            max_retries=max_retries,
            lease_timeout=lease_timeout,
            isolate_failures=True,
            max_depth=cfg.serve_queue_depth,
            breaker_threshold=cfg.serve_breaker_threshold,
            continuous=cfg.serve_continuous,
            follower=not self.leader,
        )
        self._fit_cache: dict = {}
        lanes = max(num_lanes, 1)
        if self.on_mesh:
            self._start_mesh()
            target = self._lead if self.leader else self._follow
            args, kwargs = (), ({"num_lanes": lanes} if self.leader else {})
        else:
            target, args, kwargs = self.queue.serve, (self._fit_bucket,), {"num_lanes": lanes}
        self._thread = threading.Thread(target=target, args=args, kwargs=kwargs,
                                        daemon=True)
        self._thread.start()

    def _start_mesh(self) -> None:
        """The mesh server's shared state, built on every rank together
        (two gloo groups of its own, and the server's own bucket mesh)."""
        timeout = datetime.timedelta(seconds=ROUND_TIMEOUT_S)
        self._width = self.cfg.fleet_bucket_size
        self._ctl = dist.new_group(backend="gloo", timeout=timeout)
        self._close_group = dist.new_group(backend="gloo", timeout=timeout)
        self._round_lock = threading.Lock()
        self._cond = threading.Condition()
        self._next_seq = 0
        self._table: dict[int, Any] = {}  # admitted, unresolved tickets by number
        self._shed: set[int] = set()  # numbers this rank refused at admission
        #: refused numbers no round or notice has named yet: rank 0 still
        #: announces each (a round that drops it, or its own notice)
        self._awaited: set[int] = set()
        self._noticed: set[int] = set()  # numbers rank 0 refused before they came here
        self._attempts: dict[int, int] = {}  # rank 0: attempts by bucket
        self._closing = False
        self._closed = False
        self._meshes: dict[int, Any] = {}
        self._resolve_mesh(self.cfg)

    # -- client API ----------------------------------------------------------

    def submit(self, problem, *, cfg: PCAConfig | None = None,
               worker_masks=None, tenant=None):
        """Admit one fit request; returns its ``FleetTicket``
        (``.result()`` blocks for the tenant's ``(d, k)`` components).
        ``tenant`` is the continuous-batching fairness key."""
        cfg = self.cfg if cfg is None else cfg
        seq = -1
        if self.on_mesh:
            with self._cond:
                seq, self._next_seq = self._next_seq, self._next_seq + 1
                noticed = seq in self._noticed
            if noticed:
                from distributed_eigenspaces_tpu_torch.serving.server import ServerOverloaded

                raise ServerOverloaded(
                    f"fit request {seq} shed: rank 0 refused it at admission "
                    "(serve_queue_depth or an open breaker); every rank refuses it")
        pad_cfg = None
        if cfg.fleet_pad_k:
            padded = padded_fleet_cfg(cfg)
            if padded is not cfg:
                pad_cfg = padded
        bucket_cfg = pad_cfg if pad_cfg is not None else cfg
        if self.on_mesh and bucket_cfg.fleet_bucket_size > self._width:
            self._refused(seq)
            raise ValueError(
                f"a mesh FleetServer built with fleet_bucket_size {self._width} "
                f"cannot run a bucket of {bucket_cfg.fleet_bucket_size}: its "
                "rounds announce at most the server's bucket size of requests")
        sig = (fleet_signature(bucket_cfg), repr(bucket_cfg))
        tr = tracer_of(self.metrics)
        tid = tr.new_trace("fleet")
        t0 = time.perf_counter()
        try:
            ticket = self.queue.submit(
                sig,
                _FleetRequest(cfg, problem, worker_masks, pad_cfg=pad_cfg,
                              t_submit=t0, trace_id=tid, seq=seq),
                tenant=tenant,
            )
        except QueueClosed as e:
            from distributed_eigenspaces_tpu_torch.serving.server import ServerClosed

            raise ServerClosed(
                "submit on a closed FleetServer (close() already ran; "
                "in-flight buckets drained first) — construct a new "
                "server to keep admitting fits"
            ) from e
        except QueueFull as e:
            from distributed_eigenspaces_tpu_torch.serving.server import ServerOverloaded

            self._refused(seq)
            raise ServerOverloaded(
                f"fit request shed: {self.queue.inflight} requests "
                f"already in flight >= serve_queue_depth "
                f"{self.queue.max_depth} (reject-newest load shedding)"
            ) from e
        except Exception:  # an open breaker (BreakerOpen)
            self._refused(seq)
            raise
        if not self.leader:
            with self._cond:
                self._table[seq] = ticket
                self._cond.notify_all()
        tr.record_span(
            "admit", t0, time.perf_counter(), trace_id=tid,
            category="fleet", attrs={"signature": str(fleet_signature(cfg))},
        )
        return ticket

    def _refused(self, seq: int) -> None:
        """A mesh rank's admission refused request ``seq``: a follower
        remembers it for the round that names it; rank 0 announces it in a
        notice round."""
        if not self.on_mesh:
            return
        if self.leader:
            with contextlib.suppress(QueueClosed):
                self.queue.add_control(_Notice(signature=None, tickets=[], shed=(seq,)))
        else:
            with self._cond:
                self._shed.add(seq)
                self._awaited.add(seq)
                self._cond.notify_all()

    def pending_cfgs(self) -> list[PCAConfig]:
        """One config per signature waiting in a bucket: the live half of
        the prewarm feed (the padded config for ``fleet_pad_k``
        admissions, the one the bucket runs)."""
        with self.queue._lock:
            return [
                tickets[0].payload.pad_cfg or tickets[0].payload.cfg
                for tickets in self.queue._buckets.values()
                if tickets
            ]

    def _v0_for(self, cfg: PCAConfig):
        if self.v0 is not None and self.v0.shape == (cfg.dim, cfg.k):
            return self.v0
        return None

    def prewarm(self, cfgs=None, *, prewarmer=None, masked: bool = False):
        """Acquire fleet programs OFF the dispatch lane for the given
        configs (default: this server's config and every signature already
        queuing), so buckets find them ready. Returns the
        ``runtime.prewarm.Prewarmer``; call its ``wait()`` (or
        :meth:`wait_warm`) before traffic for a first bucket that acquires
        nothing."""
        from distributed_eigenspaces_tpu_torch.runtime.prewarm import Prewarmer

        if prewarmer is None:
            if self.prewarmer is None:
                self.prewarmer = Prewarmer()
            prewarmer = self.prewarmer
        else:
            self.prewarmer = prewarmer
        todo = list(cfgs) if cfgs is not None else [self.cfg]
        if cfgs is None:
            todo.extend(self.pending_cfgs())
        seen = set()
        for cfg in todo:
            key = (repr(cfg), masked)
            if key in seen:
                continue
            seen.add(key)
            # resolved here, on the calling thread: a mesh is built by every
            # rank together, and the program is the one its buckets fetch
            mesh = self._resolve_mesh(cfg)
            prewarmer.submit(
                ("fleet", repr(cfg), masked),
                lambda c=cfg, m=mesh: acquire_fleet_programs(
                    c, m, masked=masked, b_pad=c.fleet_bucket_size,
                    fit_cache=self._fit_cache, compile_cache=self.compile_cache,
                    device=self.device, v0=self._v0_for(c),
                ),
            )
        return prewarmer

    def wait_warm(self, timeout: float | None = None) -> bool:
        """Block until submitted prewarms finish (True when none)."""
        if self.prewarmer is None:
            return True
        return self.prewarmer.wait(timeout)

    def close(self) -> None:
        """Flush partial buckets, drain, and join the dispatch lanes (and
        the prewarm lane, when there is one). On a mesh every rank calls it:
        the ranks first meet at a monitored barrier (a rank that does not
        come within ``ROUND_TIMEOUT_S`` is named in a ``TimeoutError``), then rank
        0 runs what is left and announces the end, and every rank's round
        thread exits."""
        if self.on_mesh:
            if self._closed:
                return
            self._closed = True
            try:
                dist.monitored_barrier(
                    group=self._close_group, wait_all_ranks=True,
                    timeout=datetime.timedelta(seconds=ROUND_TIMEOUT_S))
            except RuntimeError as e:
                raise TimeoutError(
                    f"FleetServer.close on rank {pmesh.rank()}: a rank of the group "
                    f"did not reach close() within {ROUND_TIMEOUT_S} s ({e})") from e
        self.queue.close()
        if self.on_mesh:
            with self._cond:
                self._closing = True
                self._cond.notify_all()
        self._thread.join()
        if self.prewarmer is not None:
            self.prewarmer.close()

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatch ------------------------------------------------------------

    def _resolve_mesh(self, cfg: PCAConfig):
        """The mesh a ``cfg.fleet_bucket_size``-padded bucket runs on,
        shared by dispatch and prewarm so they acquire the same program (the
        reference's ``_resolve_mesh``): ``"auto"`` is ``fleet_mesh(cfg.
        fleet_bucket_size)``, built once a bucket size."""
        if not self.on_mesh:
            return None
        if self.mesh != "auto":
            return self.mesh
        b = cfg.fleet_bucket_size
        if b not in self._meshes:
            self._meshes[b] = fleet_mesh(b, self.device)
        return self._meshes[b]

    def _exchange(self, row: list) -> list[list[int]]:
        """Every rank's ``row`` of small ints, in rank order: one all-gather
        of an int64 row over the server's gloo group (recorded as an
        ``all_gather`` over ``"ranks"`` tagged ``"fleet_round"``)."""
        buf = torch.full((4 + self._width,), -1, dtype=torch.int64)
        buf[:len(row)] = torch.tensor(row, dtype=torch.int64)
        world = dist.get_world_size(self._ctl)
        pmesh._record("all_gather", "ranks", buf, world, tag="fleet_round",
                      shape=(world, buf.numel()))
        parts = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(parts, buf, group=self._ctl)
        return [p.tolist() for p in parts]

    def _lead(self, num_lanes: int) -> None:
        """Rank 0's thread: its queue's lanes run the rounds; once closed and
        drained, the end is announced."""
        try:
            self.queue.serve(self._lead_round, num_lanes=num_lanes)
        finally:
            with self._round_lock:
                self._exchange([_END])

    def _lead_round(self, bucket) -> list:
        """One bucket of rank 0's queue as a round of every rank (a notice
        when it carries refused requests); returns one result a ticket."""
        with self._round_lock:
            if isinstance(bucket, _Notice):
                self._exchange([_NOTICE, 0, len(bucket.shed), 0, *bucket.shed])
                self.metrics.fleet({"kind": "notice", "refused": list(bucket.shed)})
                return []
            live = [t for t in bucket.tickets if not t.done()]
            if not live:
                return [None] * len(bucket.tickets)
            seqs = [t.payload.seq for t in live]
            key = id(bucket)  # the work queue retries the same bucket
            attempt = self._attempts.get(key, 0) + 1
            self._attempts[key] = attempt
            final = attempt > self.max_retries
            self._exchange([_ROUND, _sig_code(bucket.signature), len(seqs), int(final), *seqs])
            try:
                out = self._round(dict(zip(seqs, live)), seqs, bucket.t_dispatch)
            except Exception:
                if final:
                    self._attempts.pop(key, None)
                raise
            self._attempts.pop(key, None)
            return [out.get(t.payload.seq) for t in bucket.tickets]

    def _follow(self) -> None:
        """A follower's thread: whenever it holds an unresolved request, a
        refused one rank 0 has not named yet, or is closing, it meets rank
        0's next announcement and runs it; at the end, a request rank 0
        never ran fails as closed."""
        from distributed_eigenspaces_tpu_torch.serving.server import ServerClosed

        try:
            self._follow_rounds()
        except Exception as e:  # the group itself failed: no round can run
            with self._cond:
                left = list(self._table)
            self._settle(left, error=e)
            raise
        with self._cond:
            left = list(self._table)
        self._settle(left, error=ServerClosed(
            "the mesh FleetServer closed before rank 0 ran this request"))

    def _follow_rounds(self) -> None:
        from distributed_eigenspaces_tpu_torch.serving.server import ServerOverloaded

        while True:
            with self._cond:
                while not (self._table or self._awaited or self._closing):
                    self._cond.wait()
            kind, code, n, final, *named = self._exchange([_IDLE])[0]
            named = named[:n]
            if kind == _END:
                break
            with self._cond:
                self._awaited.difference_update(named)
            if kind == _NOTICE:
                self.metrics.fleet({"kind": "notice", "refused": list(named)})
                with self._cond:
                    self._noticed.update(named)
                self._settle(named, error=ServerOverloaded(
                    f"fit request {named} shed: rank 0 refused it at admission "
                    "(serve_queue_depth or an open breaker); every rank fails it"))
                continue
            with self._cond:
                sig = next((t.signature for s, t in self._table.items() if s in named), None)
            br = None if sig is None else self.queue.breaker_for(sig)
            try:
                out = self._round(None, named, None, code)
            except Exception as e:  # every rank raised it alike
                if br is not None:
                    br.record_failure(e)
                if final:
                    term = SchedulerError(
                        f"fleet round of requests {named} failed on its last attempt "
                        f"(max_retries {self.max_retries})")
                    term.__cause__ = e
                    self._settle(named, error=term)
                continue
            if br is not None:
                br.record_success()
            self._settle(named, results=out)

    def _settle(self, seqs, *, results=None, error=None) -> None:
        """Resolve (``results`` by number) or fail this follower's tickets
        of ``seqs``, and take them out of its queue."""
        with self._cond:
            done = [(s, self._table.pop(s)) for s in seqs if s in self._table
                    and (results is None or s in results)]
        for s, t in done:
            if error is not None:
                t.fail(error)
            else:
                t.resolve(results[s])
        self.queue.withdraw([t for _, t in done])

    def _take(self, seqs: list, sig_code: int):
        """A follower's tickets of the named requests, and what it holds of
        each (``_HAVE``, ``_SHED``, ``_MISSING``, ``_OTHER``), waiting up to
        ``ADMIT_WAIT_S`` for one not yet submitted here."""
        deadline = time.monotonic() + ADMIT_WAIT_S
        local, codes = {}, []
        with self._cond:
            for s in seqs:
                while s not in self._table and s not in self._shed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                t = self._table.get(s)
                if t is None:
                    codes.append(_SHED if s in self._shed else _MISSING)
                elif _sig_code(t.signature) != sig_code:
                    codes.append(_OTHER)
                else:
                    local[s] = t
                    codes.append(_HAVE)
        return local, codes

    def _agree(self, err, what: str) -> None:
        """One all-gather of whether ``what`` raised on each rank; if it did
        anywhere, every rank raises the same kind of error (``CheckError``
        when a guard fired, else :class:`FleetRoundError`)."""
        code = 0 if err is None else (1 if isinstance(err, CheckError) else 2)
        codes = [r[0] for r in self._exchange([code])]
        if not any(codes):
            return
        bad = [r for r, c in enumerate(codes) if c]
        mine = "" if err is None else f" ({type(err).__name__}: {err})"
        kind = CheckError if 1 in codes else FleetRoundError
        raise kind(f"fleet round: the {what} raised on rank(s) {bad}{mine}") from err

    def _round(self, local, seqs: list, t_dispatch, sig_code=None) -> dict:
        """The rest of a round on this rank (the class docstring, steps 2-5):
        ``local`` maps each named request to this rank's ticket (rank 0's
        bucket), or is None on a follower, which takes its own. Returns the
        results by number; raises what every rank raises."""
        from distributed_eigenspaces_tpu_torch.serving.server import ServerOverloaded

        t0 = time.perf_counter()
        if local is None:
            local, codes = self._take(seqs, sig_code)
        else:
            codes = [_HAVE] * len(seqs)
        held = self._exchange(codes)
        live = []
        for j, s in enumerate(seqs):
            col = [row[j] for row in held]
            if all(c == _HAVE for c in col):
                live.append(s)
                continue
            shed = [r for r, c in enumerate(col) if c == _SHED]
            err = (ServerOverloaded(
                f"fit request {s} shed: rank(s) {shed} refused it at admission "
                "(serve_queue_depth or an open breaker); every rank fails it")
                if shed else RuntimeError(
                f"mesh fleet serving out of step: request {s} never reached, or "
                f"differs on, rank(s) {[r for r, c in enumerate(col) if c != _HAVE]} "
                "- every rank must be given the same requests in the same order"))
            if self.leader:
                local[s].fail(err)
            else:
                self._settle([s], error=err)
        if not live:
            return {}
        tickets = [local[s] for s in live]
        reqs = [t.payload for t in tickets]
        cfg = reqs[0].pad_cfg or reqs[0].cfg
        masks = ([r.worker_masks for r in reqs]
                 if any(r.worker_masks is not None for r in reqs) else None)
        scope = (torch.cuda.device(self.device) if self.device.type == "cuda"
                 else contextlib.nullcontext())
        mesh = self._resolve_mesh(cfg)
        err = batch = fit = extract = part = None
        build_ms = 0.0
        with scope:
            try:
                batch = stage_fleet(cfg, [r.problem for r in reqs], worker_masks=masks,
                                    pad_to=cfg.fleet_bucket_size)
                _check_divisible(batch.fleet_size, mesh)
                fit, extract, build_ms = acquire_fleet_programs(
                    cfg, mesh, masked=batch.masks is not None, b_pad=batch.fleet_size,
                    fit_cache=self._fit_cache, compile_cache=self.compile_cache,
                    device=self.device, v0=self._v0_for(cfg))
            except Exception as e:
                err = e
            self._agree(err, "staging")
            try:
                part = _fit_batch(cfg, batch, fit, extract, mesh, self.device)
            except Exception as e:
                err = e
            self._agree(err, "fit")
            result = _fleet_result(batch, mesh, part, build_ms)
        now = time.perf_counter()
        self.lockstep_rounds += 1
        self._record_bucket(Bucket(tickets[0].signature, tickets, t_dispatch), reqs, cfg,
                            result, t0, now)
        return {s: result.components[i][:, :reqs[i].cfg.k] for i, s in enumerate(live)}

    def _fit_bucket(self, bucket) -> list:
        t0 = time.perf_counter()
        reqs = [t.payload for t in bucket.tickets]
        # run at the bucket's width: the k-padded config for fleet_pad_k
        # admissions (every request of the bucket padded alike)
        cfg = reqs[0].pad_cfg or reqs[0].cfg
        masks = (
            [r.worker_masks for r in reqs]
            if any(r.worker_masks is not None for r in reqs) else None
        )
        scope = (torch.cuda.device(self.device) if self.device.type == "cuda"
                 else contextlib.nullcontext())
        with scope:
            result = fit_fleet(
                cfg,
                [r.problem for r in reqs],
                mesh=None,
                worker_masks=masks,
                pad_to=cfg.fleet_bucket_size,
                fit_cache=self._fit_cache,
                compile_cache=self.compile_cache,
                device=self.device,
                v0=self._v0_for(cfg),
            )
        now = time.perf_counter()
        self._record_bucket(bucket, reqs, cfg, result, t0, now)
        # each tenant's own k columns of the padded program's output
        # (descending order, so the first k_i columns are its top-k_i)
        return [
            result.components[i][:, : reqs[i].cfg.k]
            for i in range(len(reqs))
        ]

    def _record_bucket(self, bucket, reqs, cfg: PCAConfig, result, t0: float,
                       now: float) -> None:
        """Each tenant's span chain under its trace (the fleet twin of the
        query server's) and the bucket's fleet event: the first use of a
        signature's programs counted as its compile stall, per signature,
        instead of inflating the bucket's latency unseen."""
        tr = tracer_of(self.metrics)
        stall_s = result.compile_ms / 1e3
        if tr is not NULL_TRACER:
            for req in reqs:
                qw_attrs = {}
                if bucket.t_dispatch is not None:
                    qw_attrs = {
                        "bucket_wait_s": round(max(0.0, bucket.t_dispatch - req.t_submit), 6),
                        "lane_wait_s": round(max(0.0, t0 - bucket.t_dispatch), 6),
                    }
                tr.record_span("queue_wait", req.t_submit, t0, trace_id=req.trace_id,
                               category="fleet", attrs=qw_attrs)
                dspan = tr.record_span("dispatch", t0, now, trace_id=req.trace_id,
                                       category="fleet", attrs={"tenants": len(reqs)})
                if result.compile_ms:
                    tr.record_span("compile_stall", t0, t0 + stall_s,
                                   trace_id=req.trace_id, parent=dspan,
                                   category="compile",
                                   attrs={"compile_stall_ms": result.compile_ms})
                tr.record_span("compute", t0 + stall_s, now, trace_id=req.trace_id,
                               parent=dspan, category="fleet")
        self.metrics.fleet({
            "kind": "bucket",
            "tenants": len(reqs),
            "occupancy": round(len(reqs) / cfg.fleet_bucket_size, 4),
            "signature": list(fleet_signature(cfg)),
            "compile_misses": 1 if result.compile_ms else 0,
            "compile_stall_ms": result.compile_ms,
            "bucket_seconds": round(now - t0, 6),
            # the decomposition feed: per-request latency = queue_wait +
            # compile_stall + compute + other
            "request_latency_s": [round(now - r.t_submit, 6) for r in reqs],
            "queue_wait_s": [round(max(0.0, t0 - r.t_submit), 6) for r in reqs],
            "compute_s": round(max(0.0, (now - t0) - stall_s), 6),
            "dispatch_s": round(now - t0, 6),
            # eigenvector lanes fitted only because a tenant's k was padded
            # up to the bucket's width
            "padded_lanes": sum(cfg.k - r.cfg.k for r in reqs),
        })
