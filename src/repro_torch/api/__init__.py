"""repro_torch.api — the single dispatch point for the quantized GEMMs.

  Backend          — protocol an execution engine implements (backend.py)
  ExecutionPolicy  — frozen dataclass of tunables (policy.py)
  register/use     — registry and scoped defaults:
                         with repro_torch.api.use("cuda", policy=pol): ...
  bitserial_mm, bitserial_mm_packed, bgemm, bitpack,
  bitserial_fused, wq_mm — the dispatch functions
  repro_torch.api.nn — functional layers (qlinear, qgraph_conv, wq_linear)

Every dispatch function takes optional ``backend=`` / ``policy=``, which
beat the active context.
"""
from __future__ import annotations

import torch

from repro_torch.api.backend import OPS, Backend, UnsupportedOpError
from repro_torch.api.policy import DEFAULT_POLICY, ExecutionPolicy
from repro_torch.api.registry import (DEFAULT_BACKEND, current, get_backend,
                                      list_backends, register, resolve,
                                      set_default, use)
import repro_torch.api.backends  # noqa: F401  (registers torch_dot/popcount/cuda)

__all__ = [
    "Backend", "UnsupportedOpError", "OPS",
    "ExecutionPolicy", "DEFAULT_POLICY", "DEFAULT_BACKEND",
    "register", "get_backend", "list_backends", "use", "set_default",
    "current", "resolve", "bitserial_mm", "bitserial_mm_packed", "bgemm",
    "bitpack", "bitserial_fused", "wq_mm",
]


def _jump_kw(be, tiles):
    """Precomputed-tile pass-through, gated on the probed capability.

    Backends without the matching capability never see the kwarg (jumping
    and translation are optimizations — results are identical either
    way). Compact tiles probe ``bitserial_jump``; the tagged sgt 4-tuple
    probes ``bitserial_sgt``.
    """
    if tiles is None:
        return {}
    cap = ("bitserial_sgt" if len(tiles) == 4 and tiles[3] == "sgt"
           else "bitserial_jump")
    return {"tiles": tiles} if be.supports(cap) else {}


def bitserial_mm(aq, bq, s: int, t: int, *, backend=None, policy=None,
                 tiles=None):
    """Exact int32 (M,K)@(K,N) over unpacked unsigned s-bit x t-bit operands."""
    be, pol = resolve("bitserial_mm", backend=backend, policy=policy, s=s, t=t)
    return be.bitserial_mm_vals(aq, bq, s, t, policy=pol,
                                **_jump_kw(be, tiles))


def bitserial_mm_packed(a_packed, b_packed, *, backend=None, policy=None,
                        tiles=None):
    """Exact int32 GEMM over packed (s,M,W) x (t,W,N) bit-plane operands."""
    s, t = a_packed.shape[0], b_packed.shape[0]
    be, pol = resolve("bitserial_mm", backend=backend, policy=policy, s=s, t=t)
    return be.bitserial_mm(a_packed, b_packed, policy=pol,
                           **_jump_kw(be, tiles))


def bgemm(a_packed, b_packed, *, backend=None, policy=None, tiles=None):
    """1-bit (M,W) x (W,N) packed GEMM -> int32 (zero-tile jump per policy)."""
    be, pol = resolve("bgemm", backend=backend, policy=policy)
    return be.bgemm(a_packed, b_packed, policy=pol, **_jump_kw(be, tiles))


def bitpack(x, scale, zero, *, nbits: int, backend=None, policy=None):
    """Quantize + 3D-stacked pack: (M,K) f32 -> (nbits, M, ceil(K/32))."""
    be, pol = resolve("bitpack", backend=backend, policy=policy,
                      s=nbits, t=nbits)
    return be.bitpack(x, scale, zero, nbits=nbits, policy=pol)


def wq_mm(x, wq, *, out_dtype=torch.bfloat16, backend=None, policy=None):
    """Weight-only quantized matmul: x (..., K) float @ WeightQ (K, N)."""
    be, pol = resolve("wq_mm", backend=backend, policy=policy,
                      s=wq.nbits, t=wq.nbits)
    return be.wq_mm(x, wq, policy=pol, out_dtype=out_dtype)


def bitserial_fused(a_packed, b_packed, alpha, beta, *, out_bits: int,
                    relu: bool = True, backend=None, policy=None,
                    tiles=None):
    """Packed GEMM with the fused rescale+requantize epilogue (§4.5)."""
    s, t = a_packed.shape[0], b_packed.shape[0]
    be, pol = resolve("bitserial_fused", backend=backend, policy=policy,
                      s=s, t=t)
    return be.bitserial_fused(a_packed, b_packed, alpha, beta,
                              out_bits=out_bits, relu=relu, policy=pol,
                              **_jump_kw(be, tiles))
