"""Carry configurations and online state across from the JAX package.

Everything here takes plain Python / numpy values (``dataclasses.asdict``
of the reference's ``PCAConfig``, ``np.asarray`` of its arrays), so this
module needs nothing of the JAX package: a run started there can be
continued here and the two compared.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.device import resolve_device
from distributed_eigenspaces_tpu_torch.parallel.feature_sharded import (
    LowRankState,
    SketchState,
    shard_state,
)

_FIELDS = tuple(f.name for f in dataclasses.fields(PCAConfig))


def config_from_jax(cfg_dict: dict) -> PCAConfig:
    """The port's ``PCAConfig`` from ``dataclasses.asdict`` of a reference
    ``PCAConfig``, restricted to the fields this port carries. A value the
    port does not support (int8 staging, ``"ns"``, a mesh backend, ...)
    raises ``NotImplementedError`` from the port's own validation."""
    kw = {name: cfg_dict[name] for name in _FIELDS if name in cfg_dict}
    if kw.get("merge_topology") is not None:
        kw["merge_topology"] = tuple(kw["merge_topology"])
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = dict(kw["mesh_shape"])
    return PCAConfig(**kw)


def state_from_numpy(state: dict, device="cuda") -> OnlineState:
    """``OnlineState`` from ``{"sigma_tilde": (d, d), "step": int}`` arrays."""
    dev = resolve_device(device)
    sigma = np.asarray(state["sigma_tilde"])
    return OnlineState(
        sigma_tilde=torch.from_numpy(np.array(sigma, dtype=np.float32)).to(dev),
        step=int(np.asarray(state["step"])),
    )


def state_to_numpy(state: OnlineState) -> dict:
    """``{"sigma_tilde": float32 (d, d), "step": int32}`` numpy arrays."""
    return {
        "sigma_tilde": state.sigma_tilde.detach().float().cpu().numpy(),
        "step": np.int32(state.step),
    }


def basis_from_numpy(v, device="cuda") -> torch.Tensor:
    """A ``(d, k)`` basis (e.g. a warm ``v_prev``) as a float32 tensor."""
    dev = resolve_device(device)
    return torch.from_numpy(np.array(np.asarray(v), dtype=np.float32)).to(dev)


_FS_STATES = {"lowrank": LowRankState, "sketch": SketchState}


def fs_state_from_numpy(kind: str, state: dict, device="cuda", mesh=None):
    """A feature-sharded state from the reference's ``LowRankState``
    (``kind="lowrank"``: ``{"u", "s", "step"}``) or ``SketchState``
    (``"sketch"``: ``{"y", "v", "step"}``) as numpy arrays of the whole
    state. With a ``(workers, features)`` ``mesh`` each rank keeps its rows
    (on the mesh's device); otherwise the whole state on ``device``."""
    cls = _FS_STATES[kind]
    dev = resolve_device(device)
    out = {}
    for name in cls._fields:
        if name == "step":
            out[name] = int(np.asarray(state[name]))
        else:
            arr = np.array(np.asarray(state[name]), dtype=np.float32)
            out[name] = torch.from_numpy(arr).to(dev)
    st = cls(**out)
    return st if mesh is None else shard_state(mesh, st)


def fs_state_to_numpy(state) -> dict:
    """A whole ``LowRankState`` / ``SketchState`` as numpy arrays: the
    float32 fields and ``step`` as an int32 scalar (the reference's)."""
    return {
        name: (np.int32(value) if name == "step"
               else value.detach().float().cpu().numpy())
        for name, value in zip(state._fields, state)
    }
