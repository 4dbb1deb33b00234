"""Public wrappers around the kernels: policy resolution, padding, the jump
artifacts of the ``tiles=`` contract, and cropping.

Tunables come from an ``api.ExecutionPolicy`` (``policy=``); explicit
keyword overrides (``block_m=``, ``jump=``, ...) win over the policy,
which wins over DEFAULT_POLICY, as in the reference's
``repro.kernels.ops``. The device of the operands decides what runs:
a CUDA tensor launches the kernel, a CPU tensor takes its plain version.
``mode`` picks the bit-GEMM kernels' compute unit on the card: 'vpu' the
CUDA cores, 'mxu' the b1 tensor cores; the plain version serves both.
"""
from __future__ import annotations

import torch

from repro_torch.api.policy import DEFAULT_POLICY, ExecutionPolicy
from repro_torch.core import bitops, zerotile
from repro_torch.kernels import bgemm as _bgemm
from repro_torch.kernels import bitpack as _bitpack
from repro_torch.kernels import bitserial as _bitserial
from repro_torch.kernels import sgt as _sgt
from repro_torch.kernels import wqmm as _wqmm

__all__ = ["bgemm", "bitserial_gemm", "bitserial_fused", "bitpack", "wq_gemm",
           "edge_scatter_sum"]


def _resolve(policy: ExecutionPolicy | None, **overrides):
    """Merge explicit kwargs over the policy over DEFAULT_POLICY."""
    pol = policy if policy is not None else DEFAULT_POLICY
    return {k: (v if v is not None else getattr(pol, k))
            for k, v in overrides.items()}


def _unpack_tiles(tiles):
    """tiles=(idx, counts, s_max[, kind]) -> (idx, counts, host int, kind).

    ``kind`` tags the remap: ``"compact"`` (the default, block_w-word
    k-tile ids from ``zerotile.compact_artifacts``) or ``"sgt"``
    (single-word column ids from ``sgt.sgt_artifacts``). ``s_max`` sizes
    the kernel's K loop, so it must be a host int.
    """
    if tiles is None:
        return None, None, 0, "compact"
    if len(tiles) == 4:
        idx, cnt, s_max, kind = tiles
    else:
        (idx, cnt, s_max), kind = tiles, "compact"
    if kind not in ("compact", "sgt"):
        raise ValueError(
            f"tiles kind must be 'compact' or 'sgt', got {kind!r}")
    if not isinstance(s_max, int):
        raise TypeError(
            f"tiles s_max must be a host int (it sizes the kernel's K loop), "
            f"got {type(s_max).__name__}")
    return idx, cnt, s_max, kind


def _jump_artifacts(a, tiles_idx, tiles_cnt, occupancy, jump, block_m,
                    block_w, s_max, tiles_kind):
    """Resolve (occupancy, compact, sgt) for a padded (s, M, W) operand.

    Precedence: tiles > occupancy > recompute from ``jump``. The in-call
    recompute keeps the full K bound as the step count, so it needs no
    read back to the host.
    """
    if tiles_idx is not None:
        if tiles_kind == "sgt":
            return None, None, (tiles_idx, tiles_cnt, s_max)
        return None, (tiles_idx, tiles_cnt, s_max), None
    if jump == "sgt":
        # a tile-granularity occupancy map cannot seed the word remap
        wocc = _sgt.word_occupancy(a, block_m)
        idx, cnt = zerotile.compact_tiles(wocc)
        return None, None, (idx, cnt, wocc.shape[1])
    if jump == "compact":
        occ = (occupancy if occupancy is not None
               else zerotile.tile_occupancy_planes(a, block_m, block_w))
        idx, cnt = zerotile.compact_tiles(occ)
        return None, (idx, cnt, occ.shape[1]), None
    if occupancy is not None:
        return occupancy, None, None
    if jump == "mask":
        return zerotile.tile_occupancy_planes(a, block_m, block_w), None, None
    return None, None, None


def _bitserial_operands(a_packed, b_packed, tiles, occupancy, kw):
    """Pad (s, M, W) x (t, W, N) to the grid and resolve the artifacts:
    (a, b, dict of the kernel's tile and jump keywords)."""
    t_idx, t_cnt, s_max, kind = _unpack_tiles(tiles)
    bm, bw = kw["block_m"], kw["block_w"]
    a = bitops.pad_to(bitops.pad_to(a_packed, 1, bm), 2, bw).contiguous()
    b = bitops.pad_to(b_packed, 1, bw).contiguous()
    occ, compact, sgt = _jump_artifacts(a, t_idx, t_cnt, occupancy,
                                        kw["jump"], bm, bw, s_max, kind)
    return a, b, dict(block_m=bm, block_n=kw["block_n"], block_w=bw,
                      occupancy=occ, compact=compact, sgt=sgt, mode=kw["mode"])


def bgemm(
    a_packed: torch.Tensor,
    b_packed: torch.Tensor,
    *,
    policy: ExecutionPolicy | None = None,
    block_m: int | None = None,
    block_n: int | None = None,
    block_w: int | None = None,
    mode: str | None = None,
    jump: str | None = None,             # none | mask | compact | sgt
    tiles: tuple | None = None,          # precomputed (idx, counts, s_max[, kind])
    occupancy: torch.Tensor | None = None,  # precomputed (MT, KT) mask
) -> torch.Tensor:
    """1-bit (M,W) x (W,N) -> int32 (M,N) with zero-tile jumping.

    The artifacts and the padding are those of ``bitserial_gemm`` at one
    plane each.
    """
    kw = _resolve(policy, block_m=block_m, block_n=block_n, block_w=block_w,
                  mode=mode, jump=jump)
    a, b, kern = _bitserial_operands(a_packed[None], b_packed[None], tiles,
                                     occupancy, kw)
    return _bgemm.bgemm(a[0], b[0], **kern)[:a_packed.shape[0]]


def bitserial_gemm(
    a_packed: torch.Tensor,
    b_packed: torch.Tensor,
    *,
    policy: ExecutionPolicy | None = None,
    block_m: int | None = None,
    block_n: int | None = None,
    block_w: int | None = None,
    mode: str | None = None,
    jump: str | None = None,             # none | mask | compact | sgt
    tiles: tuple | None = None,          # precomputed (idx, counts, s_max[, kind])
    occupancy: torch.Tensor | None = None,  # precomputed (MT, KT) mask
) -> torch.Tensor:
    """(s,M,W) x (t,W,N) -> int32 (M,N): exact any-bitwidth GEMM with
    zero-tile jumping.

    ``tiles``/``occupancy`` are precomputed artifacts on A's padded
    (block_m, block_w) grid; they win over ``jump``, which recomputes them
    per call. M and W are zero-padded to the grid; N is not (the kernel
    masks the ragged edge).
    """
    kw = _resolve(policy, block_m=block_m, block_n=block_n, block_w=block_w,
                  mode=mode, jump=jump)
    a, b, kern = _bitserial_operands(a_packed, b_packed, tiles, occupancy, kw)
    return _bitserial.bitserial_gemm(a, b, **kern)[:a_packed.shape[1]]


def bitserial_fused(
    a_packed: torch.Tensor,
    b_packed: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    *,
    out_bits: int,
    relu: bool = True,
    policy: ExecutionPolicy | None = None,
    block_m: int | None = None,
    block_n: int | None = None,
    block_w: int | None = None,
    mode: str | None = None,
    jump: str | None = None,             # none | mask | compact | sgt
    tiles: tuple | None = None,          # precomputed (idx, counts, s_max[, kind])
    occupancy: torch.Tensor | None = None,  # precomputed (MT, KT) mask
) -> torch.Tensor:
    """Any-bit GEMM with the fused rescale+ReLU+requantize epilogue (§4.5).

    ``alpha`` holds M values (per row), ``beta`` N (per column), as float32;
    alpha is padded with rows to the grid. Jump artifacts behave as in
    ``bitserial_gemm``; a row tile that visits no K tile still writes the
    epilogue of a zero accumulator.
    """
    kw = _resolve(policy, block_m=block_m, block_n=block_n, block_w=block_w,
                  mode=mode, jump=jump)
    m, n = a_packed.shape[1], b_packed.shape[2]
    a, b, kern = _bitserial_operands(a_packed, b_packed, tiles, occupancy, kw)
    al = bitops.pad_to(alpha.to(torch.float32).reshape(m, 1), 0,
                       kw["block_m"]).contiguous()
    be = beta.to(torch.float32).reshape(1, n).contiguous()
    return _bitserial.bitserial_fused(a, b, al, be, out_bits=out_bits,
                                      relu=relu, **kern)[:m]


def bitpack(
    x: torch.Tensor,
    scale,
    zero,
    *,
    nbits: int,
    policy: ExecutionPolicy | None = None,
    block_w: int | None = None,
) -> torch.Tensor:
    """Quantize + pack (M,K) f32 -> (nbits, M, W_pad) int32 words.

    The reference's shape contract: the word axis is K padded to
    ``block_w * 32`` columns (the padding words are zero) and M is not
    padded (the kernel has no row tiles). ``scale`` and ``zero`` are
    scalars.
    """
    kw = _resolve(policy, block_w=block_w)
    words = -(-x.shape[1] // (kw["block_w"] * bitops.WORD)) * kw["block_w"]
    return _bitpack.bitpack(x.to(torch.float32).contiguous(), scale, zero,
                            nbits=nbits, words=words)


def wq_gemm(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scales: torch.Tensor,
    *,
    group: int = 32,
    block_m: int = 8,
    block_n: int = 256,
    block_k: int = 128,
) -> torch.Tensor:
    """x (M,K) @ 4-bit packed W (K,N) -> float32 (M,N), dequantized on chip.

    Tile sizes keep their own defaults (the packed-nibble layout wants a
    wider N block than the bit-serial kernels); the reference reads only
    ``interpret`` from its policy, so this wrapper takes none. K is padded
    to ``block_k`` (zero weights, zero scales); the kernel masks the ragged
    M and N edges, so the result is (M, N) as it comes.
    """
    k, n = x.shape[-1], 2 * w_packed.shape[-1]
    if block_k % group or k % group:
        raise ValueError(f"block_k={block_k} and K={k} must be multiples of "
                         f"group={group}")
    if tuple(scales.shape) != (k // group, n):
        raise ValueError(f"scales must be {(k // group, n)}, got "
                         f"{tuple(scales.shape)}")
    xp = bitops.pad_to(x, 1, block_k).contiguous()
    wp = bitops.pad_to(w_packed, 0, block_k).contiguous()
    sp = bitops.pad_to(scales, 0, block_k // group).contiguous()
    return _wqmm.wq_gemm(xp, wp, sp, group=group, block_m=block_m,
                         block_n=block_n, block_k=block_k)


def edge_scatter_sum(values: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor, n_out: int) -> torch.Tensor:
    """Edge-list aggregation: out[dst[e]] += values[src[e]], -1-padded edges.

    Keeps the dtype (int32 in, int32 out), so the integer training path
    adds the cross-partition remainder of its blocked GEMMs without leaving
    the integer domain. A padded edge's message is masked to zero before
    the add, which then lands harmlessly on row 0. The adds go through
    ``index_add_``, except float sums on the card: there ``index_add_``
    adds with atomics, in whatever order they land, so those go through
    ``index_put_`` with ``accumulate``, which sorts by destination and adds
    each row's messages in edge order. Either way a float sum is the same
    bits on every run and every engine (integers are exact in any order).
    """
    valid = (src >= 0)[:, None]
    s, d = src.clamp(min=0).to(torch.int64), dst.clamp(min=0).to(torch.int64)
    msgs = torch.where(valid, values[s], 0)
    out = torch.zeros((n_out,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if values.is_cuda and values.dtype.is_floating_point:
        return out.index_put_((d,), msgs, accumulate=True)
    return out.index_add_(0, d, msgs)
