"""Backend protocol for the quantized-GEMM execution engines.

A Backend implements some of the capability ops over the packed bit-plane
layouts (``core.bitops.pack_a`` / ``pack_b``):

  bitserial_mm    — (s,M,W) x (t,W,N) packed -> exact int32 (M,N)
  bgemm           — (M,W) x (W,N) 1-bit packed -> int32 (M,N)
  bitpack         — (M,K) f32 -> quantize + pack -> (nbits, M, ceil(K/32))
  bitserial_fused — bitserial_mm with the §4.5 rescale+requantize epilogue
  wq_mm           — x (..., K) float @ WeightQ (K, N), weight-only quantized,
                    with the affine epilogue (a float product, as the
                    reference's xla_dot computes it)
  bitserial_jump  — capability FLAG (no method): the engine consumes
                    precomputed compact zero-tile artifacts (``tiles=``)
                    and ``policy.jump``
  bitserial_sgt   — capability FLAG (no method): the engine consumes the
                    tagged ``(idx, counts, s_w, "sgt")`` word-column remap

Dispatch strips ``tiles=`` for an engine without the flag: jumping
changes the schedule, never the result.

An engine that lacks an op is replaced by the first registered one that
has it, unless the caller named it with ``backend=``; then it raises
``UnsupportedOpError`` (``api.registry.resolve``, as in the reference).
The ``cuda`` engine provides ``wq_mm`` itself, so the default engine
serves it without falling back.
"""
from __future__ import annotations

import abc

from repro_torch.core import bitops

__all__ = ["Backend", "UnsupportedOpError", "OPS"]

OPS = ("bitserial_mm", "bgemm", "bitpack", "bitserial_fused", "wq_mm",
       "bitserial_jump", "bitserial_sgt")


class UnsupportedOpError(NotImplementedError):
    """Raised when a backend is asked for an op it does not provide."""


class Backend(abc.ABC):
    """Base class; concrete backends override the ops they provide.

      name               — registry key
      capabilities       — frozenset of op names from OPS
      min_bits/max_bits  — supported operand bitwidth range
    """

    name: str = "abstract"
    capabilities: frozenset = frozenset()
    min_bits: int = 1
    max_bits: int = 8

    def supports(self, op: str, *, s: int = 1, t: int = 1) -> bool:
        """Probe: can this backend run ``op`` on s-bit x t-bit operands?"""
        if op not in self.capabilities:
            return False
        lo, hi = self.min_bits, self.max_bits
        return lo <= s <= hi and lo <= t <= hi

    def bitserial_mm(self, a_packed, b_packed, *, policy, tiles=None):
        """(s,M,W) x (t,W,N) packed words -> exact int32 (M,N)."""
        raise UnsupportedOpError(f"{self.name} does not provide bitserial_mm")

    def bitserial_mm_vals(self, aq, bq, s: int, t: int, *, policy,
                          tiles=None):
        """Unpacked int32 operands (M,K) x (K,N); packs, then runs the
        packed op. Backends with a faster direct route override."""
        kw = {"tiles": tiles} if tiles is not None else {}
        out = self.bitserial_mm(bitops.pack_a(aq, s), bitops.pack_b(bq, t),
                                policy=policy, **kw)
        return out[: aq.shape[0], : bq.shape[1]]

    def bgemm(self, a_packed, b_packed, *, policy, tiles=None):
        """(M,W) x (W,N) packed 1-bit GEMM -> int32 (M,N)."""
        raise UnsupportedOpError(f"{self.name} does not provide bgemm")

    def bitpack(self, x, scale, zero, *, nbits: int, policy):
        """Quantize (Eq. 2) + 3D-stacked pack -> (nbits, M, ceil(K/32))."""
        raise UnsupportedOpError(f"{self.name} does not provide bitpack")

    def bitserial_fused(self, a_packed, b_packed, alpha, beta, *,
                        out_bits: int, relu: bool, policy, tiles=None):
        """bitserial_mm + fused alpha*acc+beta -> (relu) -> requantize."""
        raise UnsupportedOpError(f"{self.name} does not provide bitserial_fused")

    def wq_mm(self, x, wq, *, policy, out_dtype):
        """x (..., K) float @ WeightQ (K, N) with affine epilogue."""
        raise UnsupportedOpError(f"{self.name} does not provide wq_mm")

    def __repr__(self):
        caps = ",".join(sorted(self.capabilities))
        return f"<Backend {self.name} [{caps}] bits={self.min_bits}..{self.max_bits}>"
