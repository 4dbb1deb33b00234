"""AdamW with global-norm clipping, and int8 gradient compression with
error feedback, over the model's nested dict of tensors.

Written step for step as the reference's ``repro.train.optimizer``:
``torch.optim.AdamW`` computes the same update in another order (decay
before the step, the bias corrections folded into the step size and the
denominator), so its results differ in the last bits, and it has no
global-norm clipping. Leaves are visited in sorted key order, the order in
which JAX flattens a dict.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_grads", "decompress_grads", "CompressionState",
           "compression_init"]


def _map(fn, tree, *rest):
    """fn over the leaves of nested dicts with the same keys."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # 0 = off


def adamw_init(params) -> dict:
    """Zero moments and a step count of 0 (an int32 tensor on the params'
    device)."""
    dev = _leaves(params)[0].device
    return {"mu": _map(torch.zeros_like, params),
            "nu": _map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / (||grads|| + 1e-9))."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in _leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda g: g * scale, grads), norm


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step -> (new params, new state)."""
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
              state["nu"], grads)
    t = step.to(torch.float32)
    mu_hat_scale = 1.0 / (1 - b1 ** t)
    nu_hat_scale = 1.0 / (1 - b2 ** t)

    def upd(p, m, v):
        u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + cfg.eps)
        return (p - cfg.lr * (u + cfg.weight_decay * p)).to(p.dtype)

    new_params = _map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "step": step}


# ------------------------------------------------- gradient compression

@dataclasses.dataclass(frozen=True)
class CompressionState:
    """Per-leaf error-feedback residuals, a dict mirroring the gradients."""

    residual: dict


def compression_init(grads_like) -> CompressionState:
    return CompressionState(_map(torch.zeros_like, grads_like))


def compress_grads(grads, state: CompressionState, nbits: int = 8):
    """Symmetric per-leaf int8 quantization with error feedback.

    Returns (int8 gradients, scales, new state). The quantization error of
    this step is added to the next step's gradients, which keeps the
    optimizer unbiased (error-feedback SGD).
    """
    qmax = float((1 << (nbits - 1)) - 1)

    def comp(g, r):
        v = g + r
        scale = torch.clamp(torch.max(torch.abs(v)), min=1e-12) / qmax
        q = torch.clamp(torch.round(v / scale), -qmax, qmax).to(torch.int8)
        return q, scale, v - q.to(torch.float32) * scale

    out = _map(comp, grads, state.residual)

    def pick(i):
        return _map(lambda leaf: leaf[i], out)

    return pick(0), pick(1), CompressionState(pick(2))


def decompress_grads(qgrads, scales):
    return _map(lambda q, s: q.to(torch.float32) * s, qgrads, scales)
