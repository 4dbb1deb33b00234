"""Zero-tile occupancy maps and compaction (paper §4.3 zero-tile jumping).

The artifacts are the reference's (``repro.core.zerotile``), computed
with torch ops on whatever device holds the packed operand:

  mask    — occupancy (MT, KT) int32: tile (i, k) holds a non-zero word.
  compact — per row tile, the ascending ids of its non-zero k-tiles,
            front-aligned and padded with 0 (the kernel stops at the count).

A tile is ``tile_m`` rows by ``tile_w`` 32-bit words of the packed A.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitops import pad_to

__all__ = ["tile_occupancy", "tile_occupancy_planes", "compact_tiles",
           "compact_artifacts", "occupancy_stats"]


def tile_occupancy(a_packed_plane: torch.Tensor, tile_m: int,
                   tile_w: int) -> torch.Tensor:
    """(M, W) packed 1-bit matrix -> (M/tile_m, W/tile_w) int32 0/1.

    A tile is occupied iff any word in it is non-zero. M and W must be
    padded to tile multiples by the caller.
    """
    m, w = a_packed_plane.shape
    if m % tile_m or w % tile_w:
        raise ValueError(f"({m}, {w}) is not a multiple of the "
                         f"({tile_m}, {tile_w}) tile grid")
    t = (a_packed_plane != 0).reshape(m // tile_m, tile_m, w // tile_w, tile_w)
    return t.any(dim=3).any(dim=1).to(torch.int32)


def _nonzero_words(a_packed: torch.Tensor) -> torch.Tensor:
    """(s, M, W) planes -> (M, W) bool: the word is non-zero in ANY plane.

    A word that is zero in every plane adds nothing at any bitwidth, so
    skipping it is exact; for the 1-bit adjacency (s == 1) this is the
    plane itself.
    """
    return a_packed[0] != 0 if a_packed.shape[0] == 1 else (a_packed != 0).any(0)


def tile_occupancy_planes(a_packed: torch.Tensor, tile_m: int,
                          tile_w: int) -> torch.Tensor:
    """(s, M, W) packed bit-planes -> (M/tile_m, W/tile_w) int32 0/1."""
    return tile_occupancy(_nonzero_words(a_packed), tile_m, tile_w)


def compact_tiles(occ: torch.Tensor):
    """Occupancy (MT, KT) -> (indices (MT, KT) int32, counts (MT,) int32).

    indices[i, :counts[i]] are the k-tile ids of row i's non-zero tiles in
    ascending order (a stable sort keeps the ids in order); the tail is 0.
    """
    kt = occ.shape[1]
    order = torch.argsort(-occ, dim=1, stable=True)
    counts = torch.sum(occ, dim=1).to(torch.int32)
    live = torch.arange(kt, device=occ.device)[None, :] < counts[:, None]
    idx = torch.where(live, order, torch.zeros_like(order))
    return idx.to(torch.int32), counts


def compact_artifacts(a_packed: torch.Tensor, tile_m: int, tile_w: int):
    """Eager recipe for the kernels' ``tiles=`` contract.

    Pads a packed (M, W) plane or (s, M, W) plane stack to the tile grid,
    reduces occupancy, compacts, and reads the largest count back to a
    HOST int: returns the ``(idx, counts, s_max)`` triple that
    ``kernels.ops.bitserial_gemm(tiles=...)`` consumes. It synchronises
    with the device once, for that int.
    """
    if a_packed.ndim == 2:
        a_packed = a_packed[None]
    ap = pad_to(pad_to(a_packed, 1, tile_m), 2, tile_w)
    idx, counts = compact_tiles(tile_occupancy_planes(ap, tile_m, tile_w))
    return idx, counts, int(torch.max(counts))


def occupancy_stats(occ: torch.Tensor) -> dict:
    total = occ.numel()
    nz = int(torch.sum(occ))
    return {
        "tiles_total": int(total),
        "tiles_nonzero": nz,
        "tiles_zero": int(total - nz),
        "nonzero_ratio": nz / max(total, 1),
        "skip_ratio": 1.0 - nz / max(total, 1),
    }
