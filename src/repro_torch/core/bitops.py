"""Bit decomposition, 3D-stacked bit compression and the packed bit-serial oracle.

The packed layouts are the reference's (``repro.core.bitops``):

  A: (s, M, ceil(K/32))  -- "column-wise" compression: bits of the
                            reduction dim K packed along words (Fig. 4b)
  B: (t, ceil(K/32), N)  -- "row-wise" compression (Fig. 4c)

little-endian within each 32-bit word. torch has no uint32 arithmetic on
the CPU (``>>`` is not implemented there), so a packed word is carried as
the int32 with the same bit pattern: words are built in int64 and then
narrowed (bit 31 does not fit a positive int32), and every right shift is
followed by a mask, because ``>>`` on int32 sign-extends. On the numpy
side ``.view(np.uint32)`` turns the patterns back into the reference's
words. torch has no popcount either: ``popcount32`` is a SWAR count over
int64 lanes, exact for words with bit 31 set.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "WORD", "pad_to", "bit_decompose", "bit_compose", "pack_along_axis",
    "unpack_along_axis", "pack_a", "pack_b", "popcount32",
    "popcount_matmul_packed", "bitserial_matmul_packed",
    "bitserial_matmul_planes", "bitserial_matmul", "packing_ratio",
    "wrap_int32", "np_pack_words",
]

WORD = 32
_MASK32 = 0xFFFFFFFF


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32: the int32 bit pattern of x's low word."""
    x = x & _MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pad_to(x: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``dim`` up to a multiple (paper's PAD8 / PAD128)."""
    size = x.shape[dim]
    rem = (-size) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[dim] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _bit_shifts(nbits: int, ndim: int, device) -> torch.Tensor:
    return torch.arange(nbits, dtype=torch.int32, device=device).reshape(
        (nbits,) + (1,) * ndim)


def bit_decompose(q: torch.Tensor, nbits: int) -> torch.Tensor:
    """(...) int32 unsigned-range -> (nbits, ...) 0/1 int32 planes."""
    return (q.to(torch.int32)[None] >> _bit_shifts(nbits, q.ndim, q.device)) & 1


def bit_compose(planes: torch.Tensor) -> torch.Tensor:
    """(nbits, ...) 0/1 -> int32 values. Inverse of bit_decompose."""
    shifts = _bit_shifts(planes.shape[0], planes.ndim - 1, planes.device)
    return torch.sum(planes.to(torch.int64) << shifts, dim=0).to(torch.int32)


def pack_along_axis(bits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Pack 0/1 values into 32-bit words along ``dim`` (little-endian).

    Shape (..., K, ...) -> (..., ceil(K/32), ...) int32 bit patterns. K is
    zero-padded to a word boundary first.
    """
    dim = dim % bits.ndim
    bits = pad_to(bits, dim, WORD)
    k = bits.shape[dim]
    shape = bits.shape[:dim] + (k // WORD, WORD) + bits.shape[dim + 1:]
    b = bits.reshape(shape).to(torch.int64)
    weights = (torch.ones(WORD, dtype=torch.int64, device=bits.device)
               << torch.arange(WORD, device=bits.device)).reshape(
        (1,) * (dim + 1) + (WORD,) + (1,) * (bits.ndim - dim - 1))
    return wrap_int32(torch.sum(b * weights, dim=dim + 1))


def unpack_along_axis(packed: torch.Tensor, dim: int = -1,
                      size: int | None = None) -> torch.Tensor:
    """Inverse of pack_along_axis; optionally crop ``dim`` back to ``size``."""
    dim = dim % packed.ndim
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device).reshape(
        (1,) * (dim + 1) + (WORD,) + (1,) * (packed.ndim - dim - 1))
    expanded = (packed.unsqueeze(dim + 1) >> shifts) & 1
    shape = list(expanded.shape)
    shape[dim:dim + 2] = [shape[dim] * WORD]
    out = expanded.reshape(shape).to(torch.int32)
    if size is not None:
        out = out.narrow(dim, 0, size)
    return out


def pack_a(q: torch.Tensor, nbits: int) -> torch.Tensor:
    """A (M, K) s-bit int32 -> (s, M, ceil(K/32)) words (column-wise, Fig 4b)."""
    return pack_along_axis(bit_decompose(q, nbits), dim=-1)


def pack_b(q: torch.Tensor, nbits: int) -> torch.Tensor:
    """B (K, N) t-bit int32 -> (t, ceil(K/32), N) words (row-wise, Fig 4c)."""
    return pack_along_axis(bit_decompose(q, nbits), dim=-2)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern, as int64 (SWAR over int64 lanes)."""
    v = x.to(torch.int64) & _MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _MASK32) >> 24


def _popcount_terms(a_packed: torch.Tensor, b_packed: torch.Tensor):
    """(M, W) x (W, N) -> (M, W, N) int64 popcount(A & B) per word."""
    return popcount32(a_packed[:, :, None] & b_packed[None, :, :])


def popcount_matmul_packed(a_packed: torch.Tensor,
                           b_packed: torch.Tensor) -> torch.Tensor:
    """popcount(AND) GEMM over packed words: (M,W)x(W,N) -> int32 (M,N)."""
    return wrap_int32(_popcount_terms(a_packed, b_packed).sum(dim=1))


def bitserial_matmul_packed(a_packed: torch.Tensor,
                            b_packed: torch.Tensor) -> torch.Tensor:
    """Packed (s,M,W) x (t,W,N) -> exact int32 (M,N) via Eq. 5/6 composition.

    Sums in int64 and wraps once at the end, which equals the reference's
    int32 accumulation modulo 2**32.
    """
    s, t = a_packed.shape[0], b_packed.shape[0]
    acc = torch.zeros((a_packed.shape[1], b_packed.shape[2]), dtype=torch.int64,
                      device=a_packed.device)
    for i in range(s):
        for j in range(t):
            acc += _popcount_terms(a_packed[i], b_packed[j]).sum(dim=1) << (i + j)
    return wrap_int32(acc)


def bitserial_matmul_planes(aq: torch.Tensor, bq: torch.Tensor, s: int,
                            t: int) -> torch.Tensor:
    """Exact int32 matmul of unsigned s-bit x t-bit operands by per-plane
    products (Eq. 5/6), shifted and summed: one exact integer product per
    (i, j) bit-plane pair (``api.backends.int_matmul_mod32``, int8 GEMMs
    on any device)."""
    from repro_torch.api.backends import int_matmul_mod32

    a_planes, b_planes = bit_decompose(aq, s), bit_decompose(bq, t)
    acc = torch.zeros((aq.shape[0], bq.shape[1]), dtype=torch.int64,
                      device=aq.device)
    for i in range(s):
        for j in range(t):
            acc += int_matmul_mod32(a_planes[i], b_planes[j], 1, 1) << (i + j)
    return wrap_int32(acc)


def bitserial_matmul(aq: torch.Tensor, bq: torch.Tensor, s: int, t: int,
                     impl: str = "dot") -> torch.Tensor:
    """Deprecated ``impl=`` shim; use ``repro_torch.api.bitserial_mm``.

    ``impl="dot"`` runs ``bitserial_matmul_planes``, ``"popcount"``
    ``bitserial_matmul_packed``; both return exactly aq @ bq (int32).
    """
    import warnings

    warnings.warn(
        "bitops.bitserial_matmul(impl=...) is deprecated; use "
        "repro_torch.api.bitserial_mm (registry dispatch) or call "
        "bitserial_matmul_planes / bitserial_matmul_packed directly",
        DeprecationWarning,
        stacklevel=2,
    )
    if impl == "popcount":
        return bitserial_matmul_packed(pack_a(aq, s), pack_b(bq, t))
    if impl != "dot":
        raise ValueError(f"unknown impl {impl!r}")
    return bitserial_matmul_planes(aq, bq, s, t)


def packing_ratio(nbits: int, dtype_bits: int = 32) -> float:
    """Memory compression vs a full-precision tensor (for reporting)."""
    return dtype_bits / float(nbits)


def np_pack_words(bits: np.ndarray) -> np.ndarray:
    """Host-side (numpy) packing used by the subgraph packer; little-endian."""
    k = bits.shape[-1]
    pad = (-k) % WORD
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    shaped = bits.reshape(bits.shape[:-1] + (-1, WORD)).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(WORD, dtype=np.uint32))
    return (shaped * weights).sum(-1, dtype=np.uint32)
