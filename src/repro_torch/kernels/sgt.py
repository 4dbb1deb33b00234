"""Sparse-graph translation (SGT): the word-column remap artifacts.

The artifact half of the reference's ``repro.kernels.sgt``: per row
window of ``tile_m`` packed rows, the non-zero 32-bit WORD columns (OR
over bit planes, OR over the window's rows), compacted front-aligned —
the ``compact_tiles`` remap at single-word granularity. The bit-serial
kernel's sgt schedule visits only these words. The artifacts depend on
``tile_m`` alone, so they hold for any ``block_w``. ``condense``
materializes the gather the remap describes, the test oracle that the
translation is a pure re-layout; ``sgt_stats`` counts the words it skips.
"""
from __future__ import annotations

import torch

from repro_torch.core import zerotile
from repro_torch.core.bitops import pad_to

__all__ = ["word_occupancy", "sgt_plan", "sgt_artifacts", "condense",
           "sgt_stats"]


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


def condense(a_packed: torch.Tensor, b_packed: torch.Tensor, idx: torch.Tensor,
             counts: torch.Tensor, tile_m: int, s_w: int | None = None):
    """Per-window condensed A and gathered B of the translation.

    Returns ``(a_cond (s, MT, tile_m, s_w), b_gath (t, MT, s_w, N))`` with
    each window's padded tail zeroed, so a dense per-window popcount GEMM
    over them reproduces the original product exactly. The kernels never
    build this; it is the oracle their remap is tested against.
    """
    if a_packed.ndim == 2:
        a_packed = a_packed[None]
    if b_packed.ndim == 2:
        b_packed = b_packed[None]
    s, m, w = a_packed.shape
    mt = m // tile_m
    if idx.shape[0] != mt or tuple(counts.shape) != (mt,):
        raise ValueError(f"artifacts {tuple(idx.shape)}, {tuple(counts.shape)} "
                         f"do not fit {mt} row windows")
    if s_w is None:
        s_w = int(torch.max(counts))
    s_w = max(int(s_w), 1)
    sel = idx[:, :s_w].to(torch.int64)                      # (MT, s_w)
    live = (torch.arange(s_w, device=idx.device)[None, :]
            < counts[:, None])                              # (MT, s_w)
    aw = a_packed.reshape(s, mt, tile_m, w)
    a_cond = torch.take_along_dim(
        aw, sel[None, :, None, :].expand(s, mt, tile_m, s_w), dim=3)
    a_cond = torch.where(live[None, :, None, :], a_cond, 0)
    b_gath = b_packed[:, sel, :]                            # (t, MT, s_w, N)
    b_gath = torch.where(live[None, :, :, None], b_gath, 0)
    return a_cond, b_gath


# lint: allow[kernel-int-purity] — host-side occupancy ratios, not kernel math
def sgt_stats(word_occ: torch.Tensor) -> dict:
    """Word-granularity analogue of ``zerotile.occupancy_stats``."""
    total = word_occ.numel()
    nz = int(torch.sum(word_occ))
    return {
        "words_total": int(total),
        "words_nonzero": nz,
        "words_zero": int(total - nz),
        "nonzero_ratio": nz / max(total, 1),
        "skip_ratio": 1.0 - nz / max(total, 1),
    }
