"""The hierarchical merge: the flat merge as a tiered tree.

Counterpart of ``distributed_eigenspaces_tpu/parallel/topology.py``.
``cfg.merge_topology`` (tiers leaf to root, e.g. ``(("chip", 4), ("host",
2))``) turns the flat merge (average the workers' projectors, re-solve)
into a tree:

- **The tiered mesh** (:func:`make_tiered_mesh`): one mesh axis per tier,
  root-major, over the ranks of a process group, so rank ``r`` is leaf
  worker ``r`` in C order and a leaf group is a run of adjacent ranks.
- **Tier-local merges with the sharded update**
  (:func:`tier_merge_sharded`): a tier of fan-in ``f`` merges its
  children's projectors with no ``d x d`` and no replicated ``(f, d, k)``
  stack: an all-to-all gives rank ``r`` every child's row slice ``r``
  (``d k`` elements), one sum forms the ``(f k)^2`` factor Gram, and only
  the merged ``(d, k)`` basis is all-gathered at the tier's boundary. A
  tier's largest payload is ``max(d k, (f k)^2)`` elements.
- **The stacked tree** (:func:`tree_merge_stacked`): the same tree over a
  gathered ``(m, d, k)`` stack, for one device and for a workers mesh
  (``algo.step.merge_core``). Each tier runs the exact masked low-rank
  merge a group, so one tier is the flat merge bit for bit.

Weights carry the live leaf count through the tree, so masked workers
weigh exactly at every level, as in the flat masked mean. Each tier
truncates to rank k, so several tiers are the flat merge's subspace up to
that truncation, not its bits.

Every rank runs :func:`make_tree_scan_fit`'s loop on its own leaf worker.
The reference's on-device ``lax.cond`` on the warm carry's liveness is a
host branch here, on a value every rank holds alike: the carry is the
tier gather's output, the same bits on every rank (the replicated ``(f
k)^2`` ``eigh`` runs on the summed Gram, the same input everywhere), and
the masked body's liveness comes from the host's mask row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.device import resolve_device
from distributed_eigenspaces_tpu_torch.ops import cusolver
from distributed_eigenspaces_tpu_torch.ops.linalg import (
    _cholqr2,
    _sym,
    canonicalize_signs,
    guarded_inv_sqrt,
    merged_top_k_lowrank,
)
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import wire as _wire

__all__ = [
    "MergeTopology",
    "flat_worker_index",
    "init_wire_residuals",
    "is_tiered_mesh",
    "make_tiered_mesh",
    "make_tree_scan_fit",
    "resolve_topology",
    "tier_merge_sharded",
    "tier_merge_sharded_wire",
    "tree_merge_sharded",
    "tree_merge_stacked",
]


@dataclasses.dataclass(frozen=True)
class MergeTopology:
    """A resolved merge tree: ``tiers`` leaf to root, checked against a
    worker count and a feature dimension by :func:`resolve_topology`."""

    tiers: tuple[tuple[str, int], ...]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.tiers)

    @property
    def fan_ins(self) -> tuple[int, ...]:
        return tuple(f for _, f in self.tiers)

    @property
    def num_workers(self) -> int:
        n = 1
        for _, f in self.tiers:
            n *= f
        return n

    def member_count(self, stage: int) -> int:
        """Members entering tier ``stage`` (0 = the leaf tier)."""
        n = self.num_workers
        for _, f in self.tiers[:stage]:
            n //= f
        return n

    def group_of(self, stage: int, worker: int) -> int:
        """The tier-``stage`` member leaf ``worker`` rolls up into (C order:
        leaf groups are runs of adjacent workers)."""
        g = worker
        for _, f in self.tiers[: stage + 1]:
            g //= f
        return g


def resolve_topology(cfg) -> MergeTopology | None:
    """``cfg.merge_topology`` as a checked :class:`MergeTopology`, or None
    for the flat merge: each fan-in must divide ``dim`` and their product
    be ``num_workers`` (checked here, where a trainer is built, as the
    reference does)."""
    topo = getattr(cfg, "merge_topology", None)
    if topo is None:
        return None
    tiers = tuple((str(n), int(f)) for n, f in topo)
    product = 1
    for name, f in tiers:
        if cfg.dim % f:
            raise ValueError(
                f"merge_topology tier {name!r} fan_in {f} must divide "
                f"dim={cfg.dim}: the sharded tier update splits the "
                f"basis rows across the tier's replicas"
            )
        product *= f
    if product != cfg.num_workers:
        raise ValueError(
            f"merge_topology fan-ins {tuple(f for _, f in tiers)} "
            f"multiply to {product}, but num_workers={cfg.num_workers} "
            f"— the tree must cover the fleet exactly"
        )
    return MergeTopology(tiers)


def make_tiered_mesh(topo: MergeTopology, *, device="cuda") -> pmesh.Mesh:
    """One mesh axis per tier over the default group's ``topo.num_workers``
    ranks, root-major (axis order ``reversed(topo.names)``, the leaf tier
    fastest), so rank ``r`` is leaf worker ``r``. A group of another size is
    refused (``parallel.mesh.grid_mesh``)."""
    return pmesh.grid_mesh(tuple(reversed(topo.names)), tuple(reversed(topo.fan_ins)),
                           device)


def is_tiered_mesh(mesh, topo: MergeTopology | None) -> bool:
    """Whether ``mesh`` is the tier-factored mesh of ``topo``: the test
    ``algo.scan.make_scan_fit`` dispatches on."""
    if mesh is None or topo is None or mesh.device_mesh is None:
        return False
    return tuple(mesh.axis_names) == tuple(reversed(topo.names))


def flat_worker_index(topo: MergeTopology, mesh=None) -> int:
    """This rank's leaf worker on a tiered mesh (``mesh``, or the one made
    active by ``parallel.mesh.mesh_scope``), accumulated root-major."""
    mesh = pmesh.current_mesh() if mesh is None else mesh
    idx = 0
    for name, f in reversed(topo.tiers):
        idx = idx * f + mesh.axis_index(name)
    return idx


# -- the stacked route ------------------------------------------------------------


def tree_merge_stacked(vs: torch.Tensor, k: int, topo: MergeTopology, mask=None,
                       root_dist_iters=None, root_v_init=None) -> torch.Tensor:
    """The tree over a gathered factor stack ``vs (m, d, kf)``: each tier
    splits the members into runs of its fan-in and merges each run exactly
    (``merged_top_k_lowrank``, one call for the tier's groups), every member weighted by the live leaves it
    stands for; returns the root's ``(d, k)``. One tier is one call of the
    flat merge on the whole stack, bit for bit. A group whose leaves are
    all masked merges to zeros with weight zero. ``root_dist_iters`` (set
    under ``cfg.uses_distributed_solve()``) solves the root tier by
    ``solvers.merged_top_k_distributed`` from ``root_v_init``."""
    m = vs.shape[0]
    if m != topo.num_workers:
        raise ValueError(
            f"factor stack has {m} workers but merge_topology covers "
            f"{topo.num_workers}"
        )
    if mask is None:
        w = torch.ones((m,), dtype=torch.float32, device=vs.device)
    else:
        w = torch.as_tensor(mask).to(device=vs.device, dtype=torch.float32)
    for _, f in topo.tiers:
        g = vs.shape[0] // f
        groups = vs.reshape(g, f, *vs.shape[1:])
        gw = w.reshape(g, f)
        if g == 1 and root_dist_iters is not None:
            from distributed_eigenspaces_tpu_torch.solvers.distributed import (
                merged_top_k_distributed,
            )

            vs = merged_top_k_distributed(groups[0], k, mask=gw[0], iters=root_dist_iters,
                                          v_init=root_v_init)[None]
        else:
            vs = merged_top_k_lowrank(groups, k, mask=gw)
        w = gw.sum(dim=1)
    return vs[0]


# -- the sharded route: tier-local collectives on a tiered mesh --------------------


def _tier_solve(s: torch.Tensor, k: int, axis: str) -> torch.Tensor:
    """This rank's rows of a tier's merged basis from its row slice ``s
    (d / f, f kf)`` of the scaled factor concatenation: the ``(f kf)^2``
    Gram summed over the tier, its replicated ``eigh``, mapped back."""
    b = pmesh.psum(torch.matmul(s.mT, s), axis)
    ew, u = cusolver.eigh(_sym(b))
    wk = torch.flip(ew[-k:], dims=(-1,))
    uk = torch.flip(u[:, -k:], dims=(-1,))
    return torch.matmul(s, uk) * guarded_inv_sqrt(wk)[None, :]


def _rows_major(c: torch.Tensor) -> torch.Tensor:
    """``(f, d / f, kf)`` exchanged slices as ``(d / f, f kf)``, child-major
    columns (the flat merge's ordering)."""
    return c.permute(1, 0, 2).reshape(c.shape[1], -1)


def tier_merge_sharded(v: torch.Tensor, w: torch.Tensor, k: int, axis: str,
                       fan_in: int):
    """One tier with the sharded update: every rank of the tier group holds
    its child basis ``v (d, kf)`` and leaf weight ``w`` (a 0-d tensor);
    returns the group's merged ``(d, k)`` (the same on every rank of the
    group) and its total weight.

    1. scale by ``sqrt(w / cnt)``, ``cnt`` the weights summed over the tier;
    2. all-to-all the ``f`` row slices, so rank ``r`` holds every child's
       slice ``r``;
    3. sum the ``(f kf)^2`` factor Gram over the tier and ``eigh`` it on
       every rank;
    4. map back on the local slice and all-gather the merged rows.

    An all-masked group gives zeros with weight zero; ``d % fan_in == 0``
    (checked by :func:`resolve_topology`)."""
    d, kf = v.shape
    cnt = pmesh.psum(w, axis)
    c = v * torch.sqrt(w / torch.clamp(cnt, min=1.0))
    c = pmesh.all_to_all(c.reshape(fan_in, d // fan_in, kf), axis)
    rows = _tier_solve(_rows_major(c), k, axis)
    return canonicalize_signs(pmesh.all_gather(rows, axis)), cnt


def tier_merge_sharded_wire(v: torch.Tensor, w: torch.Tensor, k: int, axis: str,
                            fan_in: int, *, dtype: str, residuals):
    """One tier of :func:`tier_merge_sharded` with its two data movers (the
    all-to-all and the basis all-gather) in ``dtype`` (``parallel/wire.py``);
    the weight sum and the Gram sum stay fp32.

    The payloads are delta-coded against ``residuals = (h_send, h_recv,
    h_v)``, the tier's carry of what the codec reconstructed last round
    (the all-to-all's payload in sender and receiver layout, and the
    gathered basis), the same on every rank of the group since both sides
    advance by the same decoded delta: only the round-over-round change
    rides the lossy wire, and its rounding residual folds into the next
    round one step stale. The payload is the child basis aligned to the
    carry by a Procrustes rotation (absorbed by the Gram's ``eigh``), the
    weights are applied after the exchange from a gather of the ``f``
    scalars, the merged rows are aligned to the basis carry by one
    rotation every rank computes alike (from a summed ``(k, k)`` Gram), and
    a CholeskyQR2 restores orthonormal columns after the lossy decode.

    Returns ``(v_new, cnt, new_residuals, ef_norm)``, ``ef_norm`` this
    round's quantization error (Frobenius); an fp32 tier carries ``()``
    and reports zero."""
    d, kf = v.shape
    if dtype == "fp32":
        v_new, cnt = tier_merge_sharded(v, w, k, axis, fan_in)
        return v_new, cnt, residuals, torch.zeros((), dtype=torch.float32,
                                                 device=v.device)
    cnt = pmesh.psum(w, axis)
    h_send, h_recv, h_v = residuals
    r_send = _wire.procrustes_rotation(torch.matmul(v.mT, h_send.reshape(d, kf)))
    p = torch.matmul(v, r_send).reshape(fan_in, d // fan_in, kf)
    delta = p - h_send
    rt = _wire.wire_roundtrip(delta, dtype)
    dec = _wire.wire_all_to_all(delta, axis, dtype)
    h_send = h_send + rt
    c = h_recv + dec
    h_recv = c
    # slot j is child j's slice, scaled by child j's sqrt(w_j / cnt) from
    # a gather of the f weights that never rides the codec
    wg = pmesh.all_gather(w.reshape(1), axis, tag="weights")
    c = c * torch.sqrt(wg / torch.clamp(cnt, min=1.0))[:, None, None]
    rows = _tier_solve(_rows_major(c), k, axis)
    i = pmesh.axis_index(axis)
    ref = h_v[i * (d // fan_in):(i + 1) * (d // fan_in)]
    r_gather = _wire.procrustes_rotation(pmesh.psum(torch.matmul(rows.mT, ref), axis))
    rows = torch.matmul(rows, r_gather)
    gdelta = rows - ref
    grt = _wire.wire_roundtrip(gdelta, dtype)
    v_new = _cholqr2(h_v + _wire.wire_all_gather(gdelta, axis, dtype))
    ef_norm = torch.sqrt(torch.sum(torch.square(delta - rt))
                         + torch.sum(torch.square(gdelta - grt)))
    return canonicalize_signs(v_new), cnt, (h_send, h_recv, v_new), ef_norm


def init_wire_residuals(topo: MergeTopology, wire, d: int, kf: int, k: int, *,
                        device="cuda") -> tuple:
    """The zero error-feedback carry of :func:`tier_merge_sharded_wire`, a
    tier: ``(h_send, h_recv)`` of shape ``(f, d / f, cols)`` and ``h_v (d,
    k)``; tier 0 moves the solver's ``kf`` columns, later tiers ``k``. An
    fp32 tier carries ``()``."""
    res, cols, device = [], kf, resolve_device(device)
    for (_, f), dtype in zip(topo.tiers, wire):
        if dtype == "fp32":
            res.append(())
        else:
            res.append((torch.zeros((f, d // f, cols), dtype=torch.float32, device=device),
                        torch.zeros((f, d // f, cols), dtype=torch.float32, device=device),
                        torch.zeros((d, k), dtype=torch.float32, device=device)))
        cols = k
    return tuple(res)


def tree_merge_sharded(v: torch.Tensor, w, k: int, topo: MergeTopology, *, wire=None,
                       residuals=None):
    """Every tier of the sharded tree, leaf to root, inside
    ``mesh_scope(<tiered mesh>)``: ``v (d, kf)`` and ``w`` are this rank's
    leaf basis and weight; after the root tier the merged ``(d, k)`` is on
    every rank. ``wire`` (a per-tier dtype tuple from
    ``wire.resolve_wire_policy``) runs each tier through
    :func:`tier_merge_sharded_wire` with ``residuals`` as the carry and
    returns ``(v, new_residuals, ef_norms (n_tiers,))``; None returns ``v``."""
    w = torch.as_tensor(w, dtype=torch.float32).to(v.device)
    if wire is None:
        for name, f in topo.tiers:
            v, w = tier_merge_sharded(v, w, k, name, f)
        return v
    new_res, norms = [], []
    for (name, f), dtype, res in zip(topo.tiers, wire, residuals):
        v, w, res, ef = tier_merge_sharded_wire(v, w, k, name, f, dtype=dtype,
                                                residuals=res)
        new_res.append(res)
        norms.append(ef)
    return v, tuple(new_res), torch.stack(norms)


def make_tree_scan_fit(cfg, mesh, *, masked: bool = False, with_wire_stats: bool = False,
                       v0=None):
    """The whole-fit trainer on a tiered mesh (:func:`make_tiered_mesh`),
    run by every rank: each rank solves its own leaf worker (no factor
    gather: the flat route's gather of the ``(m, d, k)`` stack is what the
    tree removes), then the tier-local sharded tree merges, a step.

    ``fit(state, x_steps) -> (state, v_bars)``, or with ``masked=True``
    ``fit(state, x_steps, masks, membership_masks=None)`` (``masks (T, m)``
    on the host, times ``membership_masks`` when given). ``x_steps`` holds
    ``(T, m, n, d)`` blocks, whole (each rank takes worker
    :func:`flat_worker_index`) or already this rank's ``(T, 1, n, d)``;
    ``v_bars (T, d, k)`` and the state are the same on every rank. Step 1
    runs cold from ``v0 (d, k)`` (default drawn from ``cfg.seed``); with
    warm starts a later step is warm while the carry holds a basis. A
    masked step folds its merge and advances the carry only when a worker
    of its mask row is live.

    ``cfg.merge_wire_dtype`` sends every tier's data movers through the
    wire codecs with the error-feedback carry (one step stale);
    ``with_wire_stats=True`` (an active policy only) adds a third output,
    the ``(T, n_tiers)`` residual norms. Refused, as in the reference:
    ``merge_interval > 1`` (a flat-merge schedule; the stacked route takes
    it) and a mesh whose axes are not the tiers."""
    from distributed_eigenspaces_tpu_torch.algo.online import update_state
    from distributed_eigenspaces_tpu_torch.algo.scan import _cores, _live

    topo = resolve_topology(cfg)
    if topo is None:
        raise ValueError(
            "make_tree_scan_fit needs cfg.merge_topology (flat fits "
            "use make_scan_fit)"
        )
    if not is_tiered_mesh(mesh, topo):
        axes = None if mesh is None else mesh.axis_names
        raise ValueError(
            f"mesh axes {axes} do not match merge_topology "
            f"tiers {topo.names} (build the mesh with make_tiered_mesh)"
        )
    if cfg.merge_interval > 1:
        raise ValueError(
            "merge_interval > 1 is not supported on the tiered-mesh "
            "path: the between-merge mean-projector fold is a flat-"
            "merge schedule (use the stacked topology route — a "
            "single-worker-axis mesh or single device)"
        )
    wire = _wire.resolve_wire_policy(cfg, topo)
    if with_wire_stats and wire is None:
        raise ValueError(
            "with_wire_stats needs an active cfg.merge_wire_dtype "
            "policy (the stats ARE the error-feedback residual norms)"
        )
    cores = _cores(cfg, mesh.device, v0, None)
    warm = cores.solve_warm is not None
    k, m, d = cfg.k, cfg.num_workers, cfg.dim
    leaf = flat_worker_index(topo, mesh)

    def leaf_block(x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if x.shape[0] == m:
            x = x[leaf:leaf + 1]
        elif x.shape[0] != 1:
            raise ValueError(
                f"block holds {x.shape[0]} workers: want all {m} or this rank's one"
            )
        return x.to(mesh.device)

    def merge_step(v_local, w, res):
        if wire is None:
            return tree_merge_sharded(v_local, w, k, topo), res, None
        return tree_merge_sharded(v_local, w, k, topo, wire=wire, residuals=res)

    def run(state, x_steps, masks=None):
        res = () if wire is None else init_wire_residuals(topo, wire, d, k, k,
                                                         device=mesh.device)
        vp = torch.zeros((d, k), dtype=torch.float32, device=mesh.device)
        out, norms = [], []
        with pmesh.mesh_scope(mesh):
            for t, x in enumerate(x_steps):
                x = leaf_block(x)
                if warm and _live(vp):
                    vs = cores.solve_warm(x, vp)
                else:
                    vs = cores.solve_cold(x, cores.v_cold)
                w = 1.0 if masks is None else float(masks[t, leaf])
                v_bar, res, nrm = merge_step(vs[0], w, res)
                state = update_state(state, v_bar, discount=cfg.discount,
                                     num_steps=cfg.num_steps)
                if masks is None or np.any(masks[t] != 0):
                    vp = v_bar
                out.append(v_bar)
                norms.append(nrm)
        if with_wire_stats:
            return state, torch.stack(out), torch.stack(norms)
        return state, torch.stack(out)

    if not masked:

        def fit(state, x_steps):
            return run(state, list(x_steps))

        return fit

    def fit_masked_elastic(state, x_steps, masks, membership_masks=None):
        masks = np.asarray(masks.detach().cpu() if isinstance(masks, torch.Tensor)
                           else masks, np.float32)
        if membership_masks is not None:
            masks = masks * np.asarray(membership_masks, np.float32)
        steps = list(x_steps)
        if masks.shape != (len(steps), m):
            raise ValueError(
                f"masks shape {masks.shape} != (T={len(steps)}, num_workers={m})"
            )
        return run(state, steps, masks)

    return fit_masked_elastic
