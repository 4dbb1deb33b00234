"""Carry state across from the JAX reference, as numpy arrays.

``params_from_jax`` takes the reference's ``repro.models.gnn.init_params``
output with every leaf turned into a numpy array (``jax.tree.map(
np.asarray, params)``) and returns the port's parameter dict, so that both
packages compute the same function. ``bittensor_from_jax`` takes a
reference BitTensor's fields (data as uint32, nbits, shape, pack_axis,
scale, zero) and returns the port's ``BitTensor``; ``weightq_from_jax``
does the same for a reference ``WeightQ``. ``adamw_state_from_jax`` and
``compression_state_from_jax`` carry the reference's optimizer state
(``repro.train.optimizer``) across, and ``params_to_numpy`` turns the
port's parameter dict back into numpy for comparison. None of them needs
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bittensor import BitTensor
from repro_torch.core.qgemm import WeightQ
from repro_torch.core.quantize import QuantParams
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import CompressionState

__all__ = ["params_from_jax", "params_to_numpy", "adamw_state_from_jax",
           "compression_state_from_jax", "bittensor_from_jax",
           "weightq_from_jax"]


def params_from_jax(params_np: dict, device=None) -> dict:
    """{"layer{l}": {name: np.ndarray}} -> the same dict of float32
    tensors on ``device`` (None means the card)."""
    dev = resolve_device(device)
    return {
        layer: {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
                for k, v in p.items()}
        for layer, p in params_np.items()
    }


def params_to_numpy(params: dict) -> dict:
    """The port's {"layer{l}": {name: tensor}} -> the same dict of numpy
    arrays on the host."""
    return {layer: {k: v.detach().cpu().numpy() for k, v in p.items()}
            for layer, p in params.items()}


def adamw_state_from_jax(state_np: dict, device=None) -> dict:
    """The reference's ``adamw_init``/``adamw_update`` state with numpy
    leaves ({"mu": params-like, "nu": params-like, "step": int32 scalar})
    -> the port's, on ``device`` (None means the card)."""
    dev = resolve_device(device)
    return {"mu": params_from_jax(state_np["mu"], device=dev),
            "nu": params_from_jax(state_np["nu"], device=dev),
            "step": torch.tensor(int(np.asarray(state_np["step"])),
                                 dtype=torch.int32, device=dev)}


def compression_state_from_jax(residual_np: dict,
                               device=None) -> CompressionState:
    """A reference ``CompressionState``'s residuals (numpy leaves, params-
    like) -> the port's, on ``device`` (None means the card)."""
    return CompressionState(params_from_jax(residual_np, device=device))


def bittensor_from_jax(data, nbits: int, shape, pack_axis: int, scale=None,
                       zero=None, device=None) -> BitTensor:
    """A reference BitTensor's fields -> the port's BitTensor on ``device``
    (None means the card). ``data`` holds uint32 words; the port keeps the
    same bit patterns as int32. ``scale``/``zero`` are None for a BitTensor
    without quantization parameters."""
    dev = resolve_device(device)
    words = np.ascontiguousarray(np.asarray(data, dtype=np.uint32)).view(np.int32)
    qp = None
    if scale is not None:
        qp = QuantParams(nbits, torch.tensor(np.asarray(scale, np.float32), device=dev),
                         torch.tensor(np.asarray(zero, np.float32), device=dev))
    return BitTensor(torch.tensor(words, device=dev), nbits, tuple(shape),
                     pack_axis, qp)


def weightq_from_jax(data, scale, zero, nbits: int, packed=None,
                     device=None) -> WeightQ:
    """A reference WeightQ's fields -> the port's WeightQ on ``device``
    (None means the card). ``data`` is int8, ``scale``/``zero`` float32,
    ``packed`` the uint32 bit planes or None; the port keeps the planes'
    bit patterns as int32."""
    dev = resolve_device(device)
    planes = None
    if packed is not None:
        words = np.ascontiguousarray(np.asarray(packed, dtype=np.uint32))
        planes = torch.tensor(words.view(np.int32), device=dev)
    return WeightQ(torch.tensor(np.asarray(data, np.int8), device=dev),
                   torch.tensor(np.asarray(scale, np.float32), device=dev),
                   torch.tensor(np.asarray(zero, np.float32), device=dev),
                   nbits, planes)
