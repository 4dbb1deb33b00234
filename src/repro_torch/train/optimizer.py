"""AdamW with global-norm clipping, and int8 gradient compression with
error feedback, over the model's nested dict of tensors.

Written step for step as the reference's ``repro.train.optimizer``:
``torch.optim.AdamW`` computes the same update in another order (decay
before the step, the bias corrections folded into the step size and the
denominator), so its results differ in the last bits, and it has no
global-norm clipping. Leaves are visited in sorted key order, the order in
which JAX flattens a dict.

Each op follows JAX's promotion rules, so that a bfloat16 leaf is
updated bit for bit as the reference updates it:

  * a Python scalar is weakly typed in JAX: it is first rounded to the
    leaf's dtype (0.9 becomes 0.8984375 in bfloat16), where torch would
    keep it in float32 for the op; so every scalar is rounded so on the
    host and stays a Python float (the product of two bfloat16 values is
    exact in torch's float32 arithmetic, and rounds once to the leaf's
    dtype, as JAX's does), which costs no copy to the device;
  * a float32 0-d array (the global-norm scale, the bias corrections) is
    not weak in JAX: it promotes a bfloat16 leaf to float32, where torch
    keeps the leaf's dtype; so those products are taken in the promoted
    dtype, and the update is cast back to the leaf's only at the end.

``adamw_update_`` is the step done in place: it replaces each leaf of the
given dicts as soon as that leaf is computed, so that the caller's old
tensors are freed one by one (the counterpart of the reference's
``donate_argnums``); ``adamw_update`` runs it on new dicts.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "clip_by_global_norm", "tree_map", "tree_leaves", "tree_unflatten",
           "compress_grads", "decompress_grads", "CompressionState",
           "compression_init"]


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts with the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted key order, as ``jax.tree.leaves`` flattens."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """``leaves`` (in ``tree_leaves(like)``'s order) in the shape of
    ``like``. Holds no reference to ``leaves`` once it returns (a nested
    function calling itself would: its cycle keeps the iterator, and so
    every leaf, alive until the garbage collector runs)."""
    return _unflatten(like, iter(leaves))


def _unflatten(t, it):
    if not isinstance(t, dict):
        return next(it)
    out = {k: _unflatten(t[k], it) for k in sorted(t)}
    return {k: out[k] for k in t}


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
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype))


def _scalar(x: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX sees it beside ``like``: rounded to like's
    dtype, on the host."""
    return _rounded(x, like.dtype)


def _scaled(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x * s`` in the dtype JAX gives it for a 0-d ``s``, a new tensor
    (one op where ``x`` has that dtype already)."""
    y = x.to(torch.promote_types(x.dtype, s.dtype))
    return x * s if y is x else y.mul_(s)


def _clip_scale(grads, max_norm: float):
    """(min(1, max_norm / (||grads|| + 1e-9)), ||grads||)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g))
                          for g in tree_leaves(grads)))
    # a division by a tensor (float / tensor is a reciprocal and a product)
    num = torch.full((), _scalar(max_norm, norm), dtype=norm.dtype,
                     device=norm.device)
    scale = torch.clamp(num / (norm + _scalar(1e-9, norm)), max=1.0)
    return scale, norm


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / (||grads|| + 1e-9))."""
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _scaled(g, scale), grads), norm


def _moments(m, v, g, cfg: AdamWConfig):
    mu = _scalar(cfg.b1, m) * m + _scalar(1 - cfg.b1, g) * g
    nu = (_scalar(cfg.b2, v) * v
          + _scalar(1 - cfg.b2, g) * torch.square(g))
    return mu, nu


def _new_param(p, m, v, mu_hat_scale, nu_hat_scale, cfg: AdamWConfig):
    """The reference's ``upd``, in float32 (the scales promote bf16 moments)
    and cast to the leaf's dtype at the end; in-place ops on the
    temporaries keep two of them alive, not five."""
    u = _scaled(m, mu_hat_scale)
    den = _scaled(v, nu_hat_scale)
    u.div_(den.sqrt_().add_(cfg.eps))
    del den
    u.add_(_scalar(cfg.weight_decay, p) * p)
    # p - lr * (...): (-lr) * u is -(lr * u) exactly, and a - b is a + (-b)
    return u.mul_(-cfg.lr).add_(p).to(p.dtype)


def _paths(tree, prefix=()):
    """Key paths of the leaves, in sorted key order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def adamw_update_(params, grads, state, cfg: AdamWConfig):
    """One AdamW step in place -> (params, state), the same dicts.

    Each leaf of ``params``, ``state["mu"]`` and ``state["nu"]`` is
    replaced as soon as it is computed, and each gradient dropped from
    ``grads`` once used, so the peak holds one leaf's temporaries beside
    the trees, not a second copy of them. No tensor is written to: a
    caller that still holds an old leaf keeps its values.
    """
    if cfg.grad_clip > 0:
        scale, _ = _clip_scale(grads, cfg.grad_clip)
    step = state["step"] + 1
    t = step.to(torch.float32)
    mu_hat_scale = 1.0 / (1 - cfg.b1 ** t)
    nu_hat_scale = 1.0 / (1 - cfg.b2 ** t)
    for path in _paths(params):
        g = _get(grads, path)
        _set(grads, path, None)
        if cfg.grad_clip > 0:
            g = _scaled(g, scale)
        mu, nu = _moments(_get(state["mu"], path), _get(state["nu"], path),
                          g, cfg)
        del g
        _set(state["mu"], path, mu)
        _set(state["nu"], path, nu)
        _set(params, path, _new_param(_get(params, path), mu, nu,
                                      mu_hat_scale, nu_hat_scale, cfg))
    state["step"] = step
    return params, state


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step -> (new params, new state); the arguments are left as
    they are (``adamw_update_`` on new dicts holding the same tensors)."""
    def skeleton(tree):
        return tree_map(lambda x: x, tree)

    return adamw_update_(skeleton(params), skeleton(grads),
                         {"mu": skeleton(state["mu"]),
                          "nu": skeleton(state["nu"]),
                          "step": state["step"]}, cfg)


# ------------------------------------------------- gradient compression

@dataclasses.dataclass(frozen=True)
class CompressionState:
    """Per-leaf error-feedback residuals, a dict mirroring the gradients."""

    residual: dict


def compression_init(grads_like) -> CompressionState:
    return CompressionState(tree_map(torch.zeros_like, grads_like))


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

    out = tree_map(comp, grads, state.residual)

    def pick(i):
        return tree_map(lambda leaf: leaf[i], out)

    return pick(0), pick(1), CompressionState(pick(2))


def decompress_grads(qgrads, scales):
    return tree_map(lambda q, s: q.to(torch.float32) * s, qgrads, scales)
