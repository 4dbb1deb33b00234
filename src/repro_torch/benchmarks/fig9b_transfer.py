"""Fig. 9b: host->device transfer strategies I/II/III (paper §4.6).

  I   dense adjacency + dense features, two copies
  II  sparse edge list + dense features, two copies + device scatter
  III QGTC packed compound buffer, ONE copy + device unpack and densify

measured: each strategy end to end, the host's work included and every run
waited for (``graph.packing.transfer_*``); the same for III's features-only
buffer (a tile-cache hit, ``III_feats``). III is then split into its steps:
host pack (numpy quantize and pack, host clock), staging (the fill of the
pinned buffer, host clock), H2D (the copy, CUDA events) and device unpack +
densify (CUDA events), beside the bare copy of the same bytes; the copies'
rates as shares of the link's rate, measured once with one 256 MB pinned
copy (``fig9b_link_peak``).
derived: exact bytes moved per strategy (what drives the paper's 15.5x and
1.54x).
"""
from __future__ import annotations

import statistics
import time

import torch

from repro_torch.benchmarks.common import emit, timeit
from repro_torch.device import resolve_device
from repro_torch.graph import batching, datasets, packing, partition
from repro_torch.perf.report import time_ms

LINK_PROBE_BYTES = 256 << 20


def link_peak_bytes_s(device) -> float:
    """The host-to-device rate of one 256 MB copy from pinned memory."""
    host = torch.empty(LINK_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(LINK_PROBE_BYTES, dtype=torch.uint8, device=device)
    ms = time_ms(torch, lambda: dev.copy_(host, non_blocking=True), warmup=1,
                 reps=1, repeats=3)
    return LINK_PROBE_BYTES / (ms / 1e3)


def _timed(fn, dev):
    """(fn(), ms): CUDA events around the call on the card, waited for;
    the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


SPLIT_STEPS = ("pack_ms", "stage_ms", "h2d_ms", "unpack_ms")


def split_packed(batch, nbits: int, dev, iters: int = 5) -> dict:
    """Strategy III step by step: the median ms of each step over ``iters``
    runs, after one warm-up run. ``h2d_ms`` is the copy as
    ``transfer_packed`` makes it (the device buffer's allocation, the copy
    and the event after it); ``copy_only_ms`` the bare copy of the same
    bytes into a buffer allocated before, which is not one of the steps."""
    steps = {k: [] for k in SPLIT_STEPS + ("copy_only_ms",)}
    for i in range(iters + 1):
        t0 = time.perf_counter()
        buf, meta = packing.pack_compound(batch, nbits)
        t1 = time.perf_counter()
        staged = packing._stage([buf], dev)
        t2 = time.perf_counter()
        (dbuf,), h2d = _timed(lambda: packing._copy(staged, dev), dev)
        _, unpack = _timed(lambda: packing.unpack_compound(
            dbuf, n=meta["n"], d=meta["d"], nbits=meta["nbits"],
            e_cap=meta["e_cap"], wpf=meta["wpf"]), dev)
        host = staged[0][0]
        dst = torch.empty(host.shape, dtype=host.dtype, device=dev)
        _, copy_only = _timed(lambda: dst.copy_(host, non_blocking=True), dev)
        if i:
            for k, v in zip(steps, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, h2d,
                                    unpack, copy_only)):
                steps[k].append(v)
    return {k: statistics.median(v) for k, v in steps.items()}


def run(batches: dict, nbits: int = 8, device=None, link_bytes_s=None):
    """Fig. 9b on one batch per name in ``batches``; ``link_bytes_s``, when
    given, is the rate III's copy is held to."""
    dev = resolve_device(device)
    for name, b in batches.items():
        nb = packing.compound_nbytes(b, nbits=nbits)
        t1 = timeit(packing.transfer_dense, b, device=dev)
        t2 = timeit(packing.transfer_sparse, b, device=dev)
        t3 = timeit(lambda: packing.transfer_packed(b, nbits, device=dev)[:2])
        t4 = timeit(lambda: packing.transfer_packed_feats(b, nbits, device=dev)[0])
        emit(f"fig9b_{name}_I_dense", t1 * 1e3, "ms", bytes=nb["I_dense"])
        emit(f"fig9b_{name}_II_sparse", t2 * 1e3, "ms", bytes=nb["II_sparse"])
        emit(f"fig9b_{name}_III_packed", t3 * 1e3, "ms",
             bytes=nb["III_packed"], speedup_vs_I=t1 / t3, speedup_vs_II=t2 / t3)
        emit(f"fig9b_{name}_III_feats", t4 * 1e3, "ms", bytes=nb["III_feats"])
        split = split_packed(b, nbits, dev)
        extra = {}
        if link_bytes_s:
            rate = nb["III_packed"] / (split["h2d_ms"] / 1e3)
            copy_rate = nb["III_packed"] / (split["copy_only_ms"] / 1e3)
            extra = {"h2d_bytes_s": rate, "link_share": rate / link_bytes_s,
                     "copy_only_link_share": copy_rate / link_bytes_s}
        emit(f"fig9b_{name}_III_split", sum(split[k] for k in SPLIT_STEPS),
             "ms", nodes=b.n_nodes, edges=b.edges.shape[1], **split, **extra)
        emit(f"fig9b_{name}_bytes_ratio_I_III",
             round(nb["I_dense"] / nb["III_packed"], 1), "x", derived=True)
        emit(f"fig9b_{name}_bytes_ratio_II_III",
             round(nb["II_sparse"] / nb["III_packed"], 2), "x", derived=True)


def main(scale: float = 0.02, nbits: int = 8, device=None):
    dev = resolve_device(device)
    batches = {}
    for name in ("ogbn-arxiv", "ogbn-products"):
        ds_scale = scale * (0.1 if name == "ogbn-products" else 1.0)
        data = datasets.load(name, scale=ds_scale)
        parts = partition.partition(data.csr, 8)
        batches[name] = batching.make_batches(data, parts, 4, shuffle=False)[0]
    link = None
    if dev.type == "cuda":
        link = link_peak_bytes_s(dev)
        emit("fig9b_link_peak", link / 1e9, "GB_s", bytes=LINK_PROBE_BYTES)
    run(batches, nbits, device=dev, link_bytes_s=link)


if __name__ == "__main__":
    main()
