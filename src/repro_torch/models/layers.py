"""Shared NN layers for the LM zoo: plain functions on tensors over a nested
dict of parameters, as the reference's ``repro.models.layers``.

``constrain`` is ``repro_torch.dist.sharding.constrain``, re-exported as the
reference's is: a sharding hint in logical axis names, the identity outside
a ``shard_ctx`` and on a plain tensor, a redistribution of a DTensor inside
one.
"""
from __future__ import annotations

import math

import torch

# no-op outside a repro_torch.dist shard_ctx; a redistribution inside one
from repro_torch.dist.sharding import constrain

__all__ = ["constrain", "rms_norm", "layer_norm", "rope", "apply_rope", "dense",
           "cross_entropy", "Initializer"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    # w and b promote as in the reference: a bf16 weight times float32 is
    # float32
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def rope(positions: torch.Tensor, d_head: int, theta: float):
    """positions (..., T) -> cos/sin (..., T, d_head//2) float32."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B,T,H,dh); cos/sin (B,T,half) or (T,half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x1.to(torch.float32), x2.to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0):
    """Masked token CE; labels < 0 are padding. Returns (loss, n_tokens)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse.square()
    valid = labels >= 0
    n = valid.sum().clamp(min=1)
    return torch.where(valid, nll, 0.0).sum() / n, n


class Initializer:
    """Parameter factory on a ``torch.Generator`` that records logical axes.

    Each draw returns ``(tensor, axes)``. ``lead`` prefixes every shape (the
    stacked layer axis, drawn at once) without entering the fan-in, so a
    stacked leaf has the scale of one layer's. The scales are the
    reference's: ``1/sqrt(shape[-2])`` (``shape[-1]`` for a vector) or
    ``scale=``. The draws are not the reference's (JAX's threefry stream is
    not reproduced), and a seed gives different weights on the CPU and on
    the card: each device's generator has its own stream. On the ``meta``
    device nothing is drawn.
    """

    def __init__(self, generator: torch.Generator | None, dtype=torch.bfloat16,
                 device=None, lead: tuple = ()):
        self.generator = generator
        self.dtype = dtype
        self.device = device if device is not None else generator.device
        self.lead = tuple(lead)

    def _kw(self, dtype):
        return {"dtype": dtype or self.dtype, "device": self.device}

    def normal(self, shape, axes, scale=None, dtype=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        out = torch.empty(self.lead + tuple(shape), **self._kw(dtype))
        return out.normal_(generator=self.generator).mul_(s), tuple(axes)

    def zeros(self, shape, axes, dtype=None):
        return torch.zeros(self.lead + tuple(shape), **self._kw(dtype)), tuple(axes)

    def ones(self, shape, axes, dtype=None):
        return torch.ones(self.lead + tuple(shape), **self._kw(dtype)), tuple(axes)
