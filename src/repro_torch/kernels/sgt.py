"""Sparse-graph translation (SGT): the word-column remap artifacts.

The artifact half of the reference's ``repro.kernels.sgt``: per row
window of ``tile_m`` packed rows, the non-zero 32-bit WORD columns (OR
over bit planes, OR over the window's rows), compacted front-aligned —
the ``compact_tiles`` remap at single-word granularity. The bit-serial
kernel's sgt schedule visits only these words. The artifacts depend on
``tile_m`` alone, so they hold for any ``block_w``.
"""
from __future__ import annotations

import torch

from repro_torch.core import zerotile
from repro_torch.core.bitops import pad_to

__all__ = ["word_occupancy", "sgt_plan", "sgt_artifacts"]


def word_occupancy(a_packed: torch.Tensor, tile_m: int) -> torch.Tensor:
    """Packed A (M, W) or (s, M, W) -> (M/tile_m, W) int32 0/1 per word column.

    M must be padded to ``tile_m`` by the caller.
    """
    if a_packed.ndim == 2:
        a_packed = a_packed[None]
    plane = zerotile._nonzero_words(a_packed)
    m, w = plane.shape
    if m % tile_m:
        raise ValueError(f"M={m} is not a multiple of tile_m={tile_m}")
    return plane.reshape(m // tile_m, tile_m, w).any(dim=1).to(torch.int32)


def sgt_plan(word_occ: torch.Tensor):
    """Word occupancy (MT, W) -> (idx (MT, W), counts (MT,)) remap."""
    return zerotile.compact_tiles(word_occ)


def sgt_artifacts(a_packed: torch.Tensor, tile_m: int):
    """Eager recipe for the kernels' SGT ``tiles=`` contract.

    Pads a packed (M, W) plane or (s, M, W) stack to the row-window grid,
    reduces word occupancy, compacts, and reads the largest count back to
    a HOST int: returns the tagged ``(idx, counts, s_w, "sgt")`` tuple.
    """
    if a_packed.ndim == 2:
        a_packed = a_packed[None]
    idx, counts = sgt_plan(word_occupancy(pad_to(a_packed, 1, tile_m), tile_m))
    return idx, counts, int(torch.max(counts)), "sgt"
