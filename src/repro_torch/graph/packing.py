"""Bandwidth-optimized subgraph packing (paper §4.6).

Three host->device transfer strategies, mirroring Fig. 9b:
  I   — transfer the dense adjacency and dense features separately
  II  — transfer the sparse edge list and features separately, densify on
        device
  III — QGTC: pack (header | edge list | quantized-packed features) into ONE
        contiguous compound buffer, single transfer, then unpack + densify
        on device

The host side is a numpy copy of the reference's ``repro.graph.packing``:
the same header, quantizer and words, bit for bit. A buffer is built in
numpy uint32 as there and handed on as its int32 view, the port's bit
pattern convention for packed words (``core/bitops.py``); the edge list is
then a plain int32 view of it.

On a CUDA device every strategy copies through one pinned staging buffer,
reused and grown as needed: the host fills it, one non-blocking copy per
array moves it over the link, and an event recorded after the copies lets
the next fill wait until they are done. So the strategies differ only in
the bytes they move and the number of copies, as in the paper. On the
CPU there is no link and no pinning: a transfer is a copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitops import np_pack_words
from repro_torch.device import resolve_device
from repro_torch.graph.batching import SubgraphBatch
from repro_torch.graph.sparse import sparse_to_dense

__all__ = ["pack_compound", "unpack_compound", "pack_feats", "unpack_feats",
           "transfer_dense", "transfer_sparse", "transfer_packed",
           "transfer_packed_feats", "compound_nbytes"]

_HDR = 8  # header words: n_nodes, n_valid, n_edges, dim, nbits, e_cap, wpf, reserved
_ALIGN = 16  # bytes between arrays in the staging buffer


def _quantize_feats(features: np.ndarray, nbits: int):
    fmin, fmax = float(features.min()), float(features.max())
    scale = max((fmax - fmin) / (1 << nbits), 1e-8)
    q = np.clip(np.floor((features - fmin) / scale), 0, (1 << nbits) - 1)
    return q.astype(np.uint32), scale, fmin


def _pack_body(batch: SubgraphBatch, nbits: int, e_cap: int):
    """Shared compound-layout core: quantize + bit-plane-pack + header."""
    q, scale, zero = _quantize_feats(batch.features, nbits)
    n, d = q.shape
    planes = np.stack([(q >> i) & 1 for i in range(nbits)])  # (nbits, N, D)
    packed = np_pack_words(planes)  # (nbits, N, ceil(D/32))
    wpf = packed.shape[-1]
    header = np.array([batch.n_nodes, batch.n_valid, batch.n_edges, d, nbits,
                       e_cap, wpf, 0], dtype=np.uint32)
    meta = {"scale": scale, "zero": zero, "n": n, "d": d, "nbits": nbits,
            "e_cap": e_cap, "wpf": wpf}
    return header, packed, meta


def pack_compound(batch: SubgraphBatch, nbits: int = 8) -> tuple[np.ndarray, dict]:
    """Pack one subgraph batch into a single int32 buffer (strategy III).

    Features are quantized to ``nbits`` and bit-packed 32/word along the
    feature dim — the same 3D-stacked compression as the compute path, so
    the transfer cost scales with nbits. The words are the reference's
    uint32 words; ``.view(np.uint32)`` gives them back.
    """
    header, packed, meta = _pack_body(batch, nbits, batch.edges.shape[1])
    buf = np.concatenate([
        header,
        batch.edges.astype(np.int32).view(np.uint32).ravel(),
        packed.ravel(),
    ])
    return buf.view(np.int32), meta


def pack_feats(batch: SubgraphBatch, nbits: int = 8) -> tuple[np.ndarray, dict]:
    """Features-only compound buffer (header | packed quantized features).

    For a subgraph whose adjacency artifacts are already on the device (the
    serving tile cache), only its features move. Same header and bit-plane
    layout as :func:`pack_compound`, minus the edges (header e_cap = 0).
    """
    header, packed, meta = _pack_body(batch, nbits, e_cap=0)
    return np.concatenate([header, packed.ravel()]).view(np.int32), meta


def unpack_feats(buf: torch.Tensor, *, n: int, nbits: int, wpf: int) -> torch.Tensor:
    """Device-side unpack of a features-only compound buffer: a view."""
    return buf[_HDR:_HDR + nbits * n * wpf].view(nbits, n, wpf)


def unpack_compound(buf: torch.Tensor, *, n: int, d: int, nbits: int,
                    e_cap: int, wpf: int):
    """Device-side unpack: compound buffer -> (dense adjacency, packed feats).

    The packed planes are a view into ``buf`` at word ``8 + 2 e_cap``:
    8-byte aligned, and 16-byte aligned only for even ``e_cap``.
    """
    off = _HDR
    edges = buf[off:off + 2 * e_cap].view(2, e_cap)
    off += 2 * e_cap
    packed = buf[off:off + nbits * n * wpf].view(nbits, n, wpf)
    adj = sparse_to_dense(edges, n)
    return adj, packed


class _Staging:
    """A device's pinned host buffer and the event after its last copies."""

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.done: torch.cuda.Event | None = None


_STAGING: dict[torch.device, _Staging] = {}


def _stage(arrays, device: torch.device) -> list:
    """Put host arrays where the copy reads them: on a CUDA device, into
    the pinned staging buffer at 16-byte aligned offsets, after the
    previous copies out of it have ended; on the CPU, as they are.
    Returns one (host tensor, shape, dtype) per array."""
    dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype for a in arrays]
    if device.type != "cuda":
        return [(torch.from_numpy(np.ascontiguousarray(a)), a.shape, dt)
                for a, dt in zip(arrays, dtypes)]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    slot = _STAGING.setdefault(device, _Staging())
    if slot.done is not None:
        slot.done.synchronize()  # the host must not overwrite bytes in flight
    if slot.buf is None or slot.buf.numel() < total:
        size = max(total, 2 * (0 if slot.buf is None else slot.buf.numel()))
        slot.buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    host = slot.buf.numpy()
    staged = []
    for a, off, dt in zip(arrays, offsets, dtypes):
        np.copyto(host[off:off + a.nbytes].view(a.dtype).reshape(a.shape), a)
        staged.append((slot.buf[off:off + a.nbytes], a.shape, dt))
    return staged


def _copy(staged, device: torch.device) -> list[torch.Tensor]:
    """One copy per staged array to ``device``: non-blocking from the
    pinned buffer on a CUDA device, followed by the event the next fill
    waits on; a plain copy on the CPU."""
    if device.type != "cuda":
        return [host.clone() for host, _, _ in staged]
    out = []
    for host, shape, dt in staged:
        dev = torch.empty(host.numel(), dtype=torch.uint8, device=device)
        dev.copy_(host, non_blocking=True)
        out.append(dev.view(dt).view(shape))
    slot = _STAGING[device]
    slot.done = torch.cuda.Event()
    slot.done.record(torch.cuda.current_stream(device))
    return out


def _transfer(arrays, device) -> list[torch.Tensor]:
    dev = resolve_device(device)
    return _copy(_stage(arrays, dev), dev)


def transfer_dense(batch: SubgraphBatch, device=None):
    """Strategy I: dense adjacency + dense features, two transfers.
    ``device=None`` means the card (``device.resolve_device``)."""
    n = batch.n_nodes
    adj = np.zeros((n, n), np.int32)
    e = batch.edges
    valid = e[0] >= 0
    adj[e[0, valid], e[1, valid]] = 1
    a, f = _transfer([adj, batch.features], device)
    return a, f


def transfer_sparse(batch: SubgraphBatch, device=None):
    """Strategy II: edge list + dense features, two transfers + device scatter."""
    e, f = _transfer([batch.edges.astype(np.int32), batch.features], device)
    return sparse_to_dense(e, batch.n_nodes), f


def transfer_packed(batch: SubgraphBatch, nbits: int = 8, device=None):
    """Strategy III (QGTC): one compound transfer + device unpack."""
    buf, meta = pack_compound(batch, nbits)
    (dbuf,) = _transfer([buf], device)
    adj, packed = unpack_compound(dbuf, n=meta["n"], d=meta["d"],
                                  nbits=meta["nbits"], e_cap=meta["e_cap"],
                                  wpf=meta["wpf"])
    return adj, packed, meta


def transfer_packed_feats(batch: SubgraphBatch, nbits: int = 8, device=None):
    """Strategy III on a tile-cache hit: features-only compound transfer."""
    buf, meta = pack_feats(batch, nbits)
    (dbuf,) = _transfer([buf], device)
    packed = unpack_feats(dbuf, n=meta["n"], nbits=meta["nbits"],
                          wpf=meta["wpf"])
    return packed, meta


def compound_nbytes(batch: SubgraphBatch, nbits: int = 8) -> dict:
    """Bytes moved under each strategy (the Fig. 9b 'derived' columns)."""
    n, d = batch.features.shape
    e_cap = batch.edges.shape[1]
    wpf = (d + 31) // 32
    return {
        "I_dense": n * n * 4 + n * d * 4,
        "II_sparse": 2 * e_cap * 4 + n * d * 4,
        "III_packed": (_HDR + 2 * e_cap + nbits * n * wpf) * 4,
        # tile-cache hit: adjacency artifacts already on device, only the
        # features-only compound buffer moves (see pack_feats)
        "III_feats": (_HDR + nbits * n * wpf) * 4,
    }
