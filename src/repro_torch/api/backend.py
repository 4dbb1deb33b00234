"""Backend protocol for the quantized-GEMM execution engines.

A Backend implements some of the capability ops over the packed bit-plane
layouts (``core.bitops.pack_a`` / ``pack_b``):

  bitserial_mm    — (s,M,W) x (t,W,N) packed -> exact int32 (M,N)
  bitserial_jump  — capability FLAG (no method): the engine consumes
                    precomputed compact zero-tile artifacts (``tiles=``)
                    and ``policy.jump``
  bitserial_sgt   — capability FLAG (no method): the engine consumes the
                    tagged ``(idx, counts, s_w, "sgt")`` word-column remap

Dispatch strips ``tiles=`` for an engine without the flag: jumping
changes the schedule, never the result. The reference's other ops
(bgemm, bitpack, wq_mm, bitserial_fused) join the list as their kernels
are ported.
"""
from __future__ import annotations

import abc

from repro_torch.core import bitops

__all__ = ["Backend", "UnsupportedOpError", "OPS"]

OPS = ("bitserial_mm", "bitserial_jump", "bitserial_sgt")


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

    def __repr__(self):
        caps = ",".join(sorted(self.capabilities))
        return f"<Backend {self.name} [{caps}] bits={self.min_bits}..{self.max_bits}>"
