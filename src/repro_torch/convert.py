"""Carry parameters across from the JAX reference.

``params_from_jax`` takes the reference's ``repro.models.gnn.init_params``
output with every leaf turned into a numpy array (``jax.tree.map(
np.asarray, params)``) and returns the port's parameter dict, so that both
packages compute the same function. It needs no JAX itself.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(params_np: dict, device=None) -> dict:
    """{"layer{l}": {name: np.ndarray}} -> the same dict of float32
    tensors on ``device`` (None means the card)."""
    dev = resolve_device(device)
    return {
        layer: {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
                for k, v in p.items()}
        for layer, p in params_np.items()
    }
