#!/usr/bin/env python3
"""Time this checkout's kernels against other checkouts', in turns, on one
NVIDIA GPU.

Run from the root of a checkout:

    python3 compare_kernels.py OTHER [OTHER ...]

Each OTHER is the root of another checkout of this repository, for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory. Every checkout's ``src/repro_torch/csrc`` is built with the same
nvcc flags into its own library (``build/compare/``), and each library's
launch functions are called through ctypes with the same arguments (the C
interface is shared), so only the kernels' code differs.

Cases: the rows of the kernel table in PERF.md §6 at their main-path
shapes, on batch 0 of ogbn-arxiv at full scale (the adjacency GEMM in the
four schedules, the fused epilogue, bgemm, GIN's widest feature GEMM), in
both compute modes, plus bgemm on the all-ones adjacency of fig9a;
bitpack at one batch's features (2304 x 128, 8 bits) and at all of
ogbn-arxiv's (8, 2 and 1 bits), ogbn-products' (8 and 1) and ppi's (8)
features at once (``chip_smoke.PACK_GRAPHS``); and wq_gemm, x in float32 and in bf16, at codeqwen1.5-7b's gate projection
(the 34 MB weight L2-resident: one copy) and at its lm_head (237 MB, past
the 50 MB L2), batch 1, 8 and 128. Each library's integer result must equal
this checkout's plain version, and each library's wq_gemm result must lie
within the float32 bound K * 2^-24 * (|x| @ |W|) around a float64 product
on its own (two kernels may round differently, so they are not compared
with each other), else the script exits non-zero. Then each library runs
under a CUDA graph of 50 launches
(``repro_torch.perf.report.graph_ms``) in turns: this, OTHER..., OTHER... reversed,
this, each time the mean of its two turns. One JSON line a case, after the
card's name and power limit and the launch floor (an empty kernel,
``torch.cuda._sleep(0)``, under the same graph).
"""
from __future__ import annotations

import concurrent.futures
import json
import sys
from pathlib import Path

import chip_smoke

REPO = chip_smoke.REPO
DEVICE = chip_smoke.DEVICE


def _libraries(others):
    from repro_torch.kernels import _build

    roots = [REPO] + [Path(o).resolve() for o in others]
    labels = ["this"] + list(others)
    dirs = [REPO / "build" / "compare" / f"{n}" for n in range(len(roots))]
    with concurrent.futures.ThreadPoolExecutor(len(roots)) as pool:
        paths = list(pool.map(
            lambda rd: _build.build(rd[0] / "src" / "repro_torch" / "csrc", rd[1]),
            zip(roots, dirs)))
    return {label: _build.load(path) for label, path in zip(labels, paths)}


def _cases(torch):
    """(case name, launch name, out, launch arguments, plain result, the
    tensors behind the arguments' pointers)."""
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.core import bitops, zerotile
    from repro_torch.graph import batching, datasets, partition
    from repro_torch.kernels import bitserial, sgt
    from repro_torch.train.trainer import make_device_batch

    data = datasets.load(chip_smoke.DATASET, scale=chip_smoke.SCALE, seed=0)
    parts = partition.partition(data.csr, chip_smoke.PARTS)
    batch = batching.make_batches(data, parts, chip_smoke.BATCH_PARTS)[0]
    adj = make_device_batch(batch, device=DEVICE)["adj"]
    m = adj.shape[0]
    gen = torch.Generator().manual_seed(11)

    def ints(shape, bits):
        return torch.randint(0, 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(DEVICE)

    grid = dict(block_m=pol.block_m, block_w=pol.block_w)

    def pad(ap, bp):
        return (bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w),
                bitops.pad_to(bp, 1, pol.block_w))

    cases = []

    def add(case, kind, ap, bp, jump="dense", epi=None):
        """Both modes of ``kind`` ('bitserial_gemm', 'bitserial_fused' or
        'bgemm') on packed (s, M, W) x (t, W, N) operands."""
        a_pad, b_pad = pad(ap, bp)
        art = {}
        if jump == "mask":
            art["occupancy"] = zerotile.tile_occupancy_planes(
                a_pad, pol.block_m, pol.block_w)
        elif jump == "compact":
            art["compact"] = zerotile.compact_artifacts(
                ap, pol.block_m, pol.block_w)[:3]
        elif jump == "sgt":
            art["sgt"] = sgt.sgt_artifacts(ap, pol.block_m)[:3]
        want = bitserial.bitserial_gemm_plain(a_pad, b_pad, **grid, **art)
        # the launches take raw pointers: every tensor they read stays alive
        keep = {"a": a_pad, "b": b_pad, "artifacts": art}
        if epi is not None:
            keep["alpha"] = bitops.pad_to(epi[0], 0, pol.block_m)
            keep["beta"] = epi[1]
            want = bitserial.fused_epilogue(want, keep["alpha"], keep["beta"], 8,
                                            False)
        for mode in ("vpu", "mxu"):
            name = bitserial.kernel_name(kind, mode)
            out, args = bitserial.tile_launch_args(
                name, a_pad, b_pad, pol.block_m, pol.block_n, pol.block_w,
                art.get("occupancy"), art.get("compact"), art.get("sgt"))
            if kind == "bitserial_fused":
                args += (keep["alpha"].data_ptr(), keep["beta"].data_ptr(), 255.0, 0)
            elif kind == "bgemm":
                args = args[:3] + args[5:]  # no plane counts
            cases.append((f"{case} {jump}", name, out, args, want, keep))

    # the adjacency GEMM of GCN: 1-bit adjacency x 8-bit hidden features
    ap1 = bitops.pack_a(adj, 1)
    bp8 = bitops.pack_b(ints((m, 16), 8), 8)
    for jump in chip_smoke.SCHEDULES:
        add("adjacency 1x8 N=16", "bitserial_gemm", ap1, bp8, jump)
    # the fused first bitmm2bit: 8-bit (M, 128) @ 8-bit (128, 16)
    xp = bitops.pack_a(ints((m, 128), 8), 8)
    top = 128 * 255 * 255
    alpha = torch.full((m, 1), 255.0 / top, device=DEVICE)
    beta = (torch.rand((1, 16), generator=gen) * 8 - 4).to(DEVICE)
    add("fused 8x8 N=16", "bitserial_fused", xp,
        bitops.pack_b(ints((128, 16), 8), 8), epi=(alpha, beta))
    # bgemm: the adjacency x one 0/1 plane of 128 features, and fig9a's all-ones A
    plane = bitops.pack_b(ints((m, 128), 1), 1)
    add("bgemm N=128", "bgemm", ap1, plane)
    add("bgemm all-ones N=128", "bgemm", bitops.pack_a(torch.ones_like(adj), 1),
        plane)
    # GIN's widest feature GEMM: 8-bit (M, 128) @ 8-bit (128, 64)
    add("gin 8x8 N=64", "bitserial_gemm", xp, bitops.pack_b(ints((128, 64), 8), 8))
    # bitpack at one batch's features and all of ogbn-arxiv's,
    # ogbn-products' and ppi's (PERF.md §6 row 7), ops.bitpack's words
    from repro_torch.core.quantize import calibrate

    for graph, (m, k), widths in chip_smoke._pack_graphs():
        x = torch.randn((m, k), generator=torch.Generator(device=DEVICE)
                        .manual_seed(m), device=DEVICE)
        words = chip_smoke.pack_words(k)
        for nbits in widths:
            qp = calibrate(x, nbits)
            out = torch.empty((nbits, m, words), dtype=torch.int32, device=DEVICE)
            want = chip_smoke._bitpack_plain_slices(torch, x, qp.scale, qp.zero,
                                                    nbits, words)
            cases.append((f"bitpack {graph} {m}x{k} {nbits} bits", "bitpack", out,
                          (x.data_ptr(), qp.scale.data_ptr(), qp.zero.data_ptr(),
                           out.data_ptr(), m, k, words, nbits,
                           float((1 << nbits) - 1)),
                          want, {"x": x, "qp": qp}))
    # wq_gemm, float32 x, with ops.wq_gemm's tiles
    from repro_torch.kernels import wqmm

    k = chip_smoke.D_MODEL
    for weight, n in (("wg", chip_smoke.D_FF), ("lm_head", chip_smoke.VOCAB)):
        w = (torch.randn((k, n), generator=gen) * 0.02).to(DEVICE)
        wp, sc = wqmm.pack_w4(w, 32)
        del w
        w64 = wqmm.unpack_w4(wp, sc, 32).double()
        for m in chip_smoke.WQ_BATCHES:
            x32 = torch.randn((m, k), generator=gen).to(DEVICE)
            for x in (x32, x32.to(torch.bfloat16)):
                out = torch.empty((m, n), dtype=torch.float32, device=DEVICE)
                x64 = x.double()
                exact = x64 @ w64
                bound = k * 2.0 ** -24 * (x64.abs() @ w64.abs())

                def within_bound(got, exact=exact, bound=bound):
                    """The float32 dot-product bound around the float64
                    product."""
                    return bool(((got.double() - exact).abs() <= bound).all())

                bf16 = int(x.dtype == torch.bfloat16)
                cases.append((f"wq_gemm {weight} batch {m}"
                              f"{' bf16 x' if bf16 else ''}", "wq_gemm", out,
                              (x.data_ptr(), wp.data_ptr(), sc.data_ptr(),
                               out.data_ptr(), m, n, k, 32, 8, 256, 128, bf16),
                              within_bound, {"x": x, "wp": wp, "sc": sc}))
        del w64
    return cases


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.perf.report import graph_ms
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = _libraries(argv)
    labels = list(libs)
    order = labels + labels[::-1]
    print(json.dumps({"launch_floor_ms": graph_ms(
        torch, lambda: torch.cuda._sleep(0)), "card": card}), flush=True)
    for case, name, out, args, want, _keep in _cases(torch):

        def run(lib, name=name, args=args):
            err = getattr(lib, f"{name}_launch")(
                *args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} launch failed: CUDA error {err}")

        for label, lib in libs.items():
            out.fill_(-1)
            run(lib)
            torch.cuda.synchronize()
            if callable(want):  # a float product: each within the bound
                if not want(out):
                    raise AssertionError(f"{case} {name}: {label} off the "
                                         f"float32 bound")
            elif not torch.equal(out, want):
                raise AssertionError(f"{case} {name}: {label} != plain")
        turns = {label: [] for label in labels}
        for label in order:
            turns[label].append(graph_ms(torch, lambda lib=libs[label]: run(lib)))
        print(json.dumps({"case": case, "kernel": name,
                          "ms": {k: sum(v) / len(v) for k, v in turns.items()},
                          "turns_ms": turns,
                          ("within_float32_bound" if callable(want)
                           else "equal_plain"): True, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
