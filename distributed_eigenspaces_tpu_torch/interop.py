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

_FIELDS = tuple(f.name for f in dataclasses.fields(PCAConfig))


def config_from_jax(cfg_dict: dict) -> PCAConfig:
    """The port's ``PCAConfig`` from ``dataclasses.asdict`` of a reference
    ``PCAConfig``, restricted to the fields this port carries. A value the
    port does not support (int8 staging, ``"ns"``, a mesh backend, ...)
    raises ``NotImplementedError`` from the port's own validation."""
    kw = {name: cfg_dict[name] for name in _FIELDS if name in cfg_dict}
    if kw.get("merge_topology") is not None:
        kw["merge_topology"] = tuple(kw["merge_topology"])
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
