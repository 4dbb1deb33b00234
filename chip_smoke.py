#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases run in order; any failure raises and the script exits non-zero
without printing a result:

  1. device and build — the card's name and power limit (nvidia-smi), and
     every kernel of src/repro_torch/csrc built into one library with nvcc.
  2. kernels against plain — each kernel and its plain PyTorch version on
     the same CUDA tensors. The integer kernels must be equal
     (torch.equal): bitserial_gemm (also equal to the exact product),
     bitserial_fused (out_bits 8/4/2, ReLU on and off) and bgemm, in the
     dense, mask, compact and sgt schedules at ragged shapes, at the
     paths' own shapes and with an all-zero A; bitpack at nbits 1/2/5/8, K
     not a multiple of 32 and M not a multiple of block_m, K = 1, 50 and
     100, M = 1, rows that are not 16-byte aligned, words past ceil(K/32),
     a row wider than a tile, x at grid points and the floats beside them,
     +-inf and past both clip ends, scales outside the kernel's fast
     quotient, and all of ogbn-arxiv's, ogbn-products' and ppi's features at
     once (the plain version a slice of rows at a time). The 4-bit
     wq_gemm, a float product, and its plain version are each held to the
     float32 dot-product error bound around a float64 product of the same
     dequantized weight, at the reference test's shapes, ragged ones and
     the kernel's own paths (a K split over a cluster, tiles past 32 rows),
     groups 32, 16 and 8, x in float32 and bf16 and scaled by 2^20 and
     2^-20, at three tile sizes; and a row's result bit-equal at M = 1, 3,
     8, 37 and 128. Then mode="mxu", the
     tensor-core kernels bitserial_gemm_mxu (four schedules),
     bitserial_fused_mxu and bgemm_mxu, each equal to its plain version
     and to the 'vpu' kernel at plane pairs (1,1)..(8,8), patterns random,
     zero and block-diagonal, and tiles (8,32,4), (1,32,1), (16,8,8),
     (32,32,9), (1,1024,4) and (1024,1,1); one-hot checks that pin the mma
     fragment layout; one-hot words (one set bit a row of A, or a column
     of B, at every plane, word and end bit); and the kernel's own paths:
     short walks of 1..5 words (plane pairs sharing an mma), all-zero A,
     one non-zero word a 16-row strip, B past a staged column block or K
     window, row tiles below a strip. Then the 'vpu' kernels again at
     those tiles, each equal to its plain version, and one-hot words
     across the kernel's 32-word chunks and column blocks.
  3. main path — ogbn-arxiv at full scale, partitioned into 1500 parts
     (Cluster-GCN's setting), batches of 20 parts; the first 8 batches
     are served through forward_qgtc for qgtc-gcn and qgtc-gin at 8, 4
     and 2 bits, with no jumping, compact tiles and sgt tiles. The kernel
     engine's logits must equal the plain engine's bit for bit, and the
     kernel must launch 6 times per GCN forward and 9 per GIN forward, and
     no other kernel at all. Then the same forwards at mode="mxu": logits
     equal to the 'vpu' kernel's (so to the plain engine's), through
     bitserial_gemm_mxu alone, with its launches counted apart.
  4. tensor API — the §5 BitTensor path at full width on batch 0 (2304
     nodes, 128 features) at the qgtc-gcn widths 128->16->16->40, at 8/4/2
     bits: to_bit equal to api.bitpack word for word; the chain bitmm2bit
     -> bitmm2bit -> bitmm2int with fused_requantize off and on, equal on
     the cuda and popcount engines; the adjacency product under reuse=True
     and reuse=False, equal, with 1 bitserial_gemm launch against s*t
     bgemm launches; one case against the port on the CPU. Every kernel's
     launch count must be what the phase expects. Then the chain and the
     adjacency product at mode="mxu", equal to the 'vpu' results, through
     bitserial_gemm_mxu, bitserial_fused_mxu and bgemm_mxu alone.
  5. weight only — codeqwen1.5-7b's decode projections at full width
     (pack_w4 on the card, x at batch 1, 8 and 128, float32 and bf16)
     through kernels.ops.wq_gemm, each within the float32 bound, one
     wq_gemm launch a call and no other kernel; wq_linear over a 4-bit
     WeightQ on the cuda engine (no launch) and on the CPU, each within
     the float32 bound of the affine product; quantize_lm_params over one
     layer, embed and lm_head.
  6. timing, fig7-style — per batch, CUDA events, median over repeats:
     fp32_dense, fp32_csr, qgtc at 8/4/2 bits in both modes; each kernel
     alone at its path shape (a CUDA graph of 50 calls; the two modes of a
     kernel in turns) beside its plain version, its
     bound, and one PyTorch call of the same function where there is one
     (a float32 torch.matmul on the unpacked values, exact: every sum stays
     below 2**24), as the library yardstick, which the port never calls;
     and the launch floor, an empty kernel under the same CUDA graph.
  7. fig9a — the adjacency product with tile reuse (one bitserial_gemm)
     and without (one bgemm per plane pair), CUDA events, at 2/4/8 bits,
     for batch 0's adjacency and for the paper's all-ones A of its size.
  8. profile — one qgtc forward per model and mode under torch.profiler:
     host wall time, device time of its kernels and of the bit-serial
     kernel alone, and the device's idle share.
  8b. bitpack timing — one batch's features and all of ogbn-arxiv's,
     ogbn-products' and ppi's at once (random normal x, scale and zero from
     calibrate): ms under a CUDA graph beside the bytes bound and its share,
     and the plain version's time.
  9. wq_gemm timing — at the gate projection and lm_head, batch 1, 8 and
     128, x in float32 and bf16: ms (a CUDA graph of 50 calls over enough
     weight copies to exceed L2) beside its plain version, its bound (bytes
     or bf16 tensor-core passes, with the CUDA-core bound beside it), and
     float32 and bf16 torch.matmul of the dequantized weight.
  10. packing — paper §4.6 on the main path's batch 0 and on a copy of it
     whose edge list is padded to an odd length (the packed planes then 8-
     but not 16-byte aligned in the buffer), at 8, 4 and 1 bits: the four
     graph.packing transfers on the card, through the pinned staging
     buffer; II's and III's adjacency equal to I's and to
     make_device_batch's, the features equal to the host's, the unpacked
     planes equal to the host's words, and the planes fed as A to
     api.bitserial_mm_packed in both modes, equal to the plain engine.
  11. fig9b — the three transfer strategies end to end, and the
     features-only buffer, on that batch and on an ogbn-products batch
     (scale 0.05, 1000 parts, 20 a batch); III split into host pack,
     staging, H2D and device unpack + densify, the copy's rate against the
     rate of one 256 MB pinned copy.
  12. figures — repro_torch.benchmarks.run at the reference's default
     sizes: fig7, fig8a, fig8b, fig8c, fig9a and fig9b, each line echoed as
     JSON; a suite's failed check fails the script.
  13. training — Cluster-GCN QAT at full width: qgtc-gcn (128->16->16->40)
     on the main path's graph and parts, every batch through
     trainer.prepare_batches (20 diagonal blocks a batch). The blocked
     aggregation of batches 0 and 1 equal to the dense adjacency product
     at 1/4/8 bits, in both modes and with zero-tile artifacts. One
     int_bitserial step on the kernel engine and the same step on the
     plain torch_dot engine, from the same params and generator state,
     with grad_bits 0 and 8 and stochastic rounding off and on, at 'vpu'
     and 'mxu': loss, gradients and updated params and AdamW moments bit-
     equal, and the kernel launched as often as the step's GEMMs. Then
     trainer.train for a few steps of three runs (fake-quant 8-bit,
     int_bitserial 8-bit, int_bitserial with 8-bit gradients and
     stochastic rounding): first and last loss finite, launches per step;
     ms per step (CUDA events, each step synchronized), host ms per step;
     three steps each under torch.profiler (device ms, idle share). Then
     Table 2 through repro_torch.benchmarks.run at the reference's sizes:
     each cell's test accuracy and the suite's seconds.

Phases 3, 4 and 13 run with the registry's fallback warning turned into
an error: a path must stay on the engine it asks for.

The line before the last lists each kernel as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
DATASET, SCALE, PARTS, BATCH_PARTS, N_BATCHES = "ogbn-arxiv", 1.0, 1500, 20, 8
# fig9b's second graph: ogbn-products at a scale whose parts are as large as
# the main path's (~120 nodes), so that a batch of 20 holds >= 2048 nodes
PRODUCTS_SCALE, PRODUCTS_PARTS = 0.05, 1000
# training at full width: qgtc-gcn on the main path's batches (1500 parts,
# 20 a batch through trainer.prepare_batches), 8 bits
TRAIN_BITS = 8
TRAIN_STEPS = 6           # steps of each trainer.train run
TRAIN_TIMED_STEPS = 10    # steps timed one by one, after 2 unmeasured ones
TRAIN_PROFILED_STEPS = 3
TRAIN_RUNS = (("fake8", dict(path="fake")),
              ("int8", dict(path="int_bitserial")),
              ("int8_g8_sr", dict(path="int_bitserial", grad_bits=8,
                                  stochastic=True)))
# the int path's steps held to the plain engine: (grad_bits, stochastic)
TRAIN_EQUAL = ((0, False), (8, False), (8, True))
TRAIN_OPT = dict(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)  # trainer.train's
PACKING_BITS = (8, 4, 1)
DEVICE = "cuda"
BITS = (8, 4, 2)
ST_PAIRS = ((1, 1), (1, 8), (2, 4), (3, 5), (8, 8))
RAGGED = ((37, 333, 5), (61, 1000, 70))
FUSED_EPILOGUES = ((8, True), (8, False), (4, True), (4, False), (2, True),
                   (2, False))
PACK_BITS = (1, 2, 5, 8)
# bitpack: ragged shapes, the Tensor API's, K = 50 (not a multiple of 4: the
# kernel's 4-byte path) and 100, K = 1, M = 1, and a row wider than a tile's
# 4096 columns (a row's words over several tiles)
PACK_SHAPES = ((37, 333), (129, 33), (61, 1000), (2304, 128), (37, 50),
               (33, 100), (5, 1), (1, 128), (1, 50), (9, 4200))
# bitpack at whole-graph feature sizes (paper Table 1, graph/datasets.py):
# one batch of ogbn-arxiv (L2-resident), then all of a graph's features at
# once, at these bit widths; ppi's K = 50 takes the 4-byte path
PACK_GRAPHS = (("batch", (2304, 128), (8,)), ("ogbn-arxiv", None, (8, 2, 1)),
               ("ogbn-products", None, (8, 1)), ("ppi", None, (8,)))
PACK_SLICE_ROWS = 1 << 18  # the plain version's rows at a time
SCHEDULES = ("dense", "mask", "compact", "sgt")
# H100 SXM published peaks: HBM bytes/s, the float32 rate outside the
# tensor cores, where bitpack's float arithmetic runs, and the dense bf16
# tensor-core rate, where wq_gemm's runs (float32 x as three exact bf16
# passes, bf16 x as one).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12
# The 'vpu' kernels' integer rates, results a clock on one SM for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput): popcount 16, and 64 for the 32-bit AND (LOP3) and the
# shift-adds. Times the SM count and the SM clock nvidia-smi reports.
POPC_PER_CLOCK_SM = 16
LOP3_PER_CLOCK_SM = 64
KERNEL_SOURCES = {
    "bitserial_gemm": ("src/repro_torch/csrc/bitserial.cu",
                       "src/repro/kernels/bitserial.py:245"),
    "bitserial_fused": ("src/repro_torch/csrc/bitserial.cu",
                        "src/repro/kernels/bitserial.py:273"),
    "bgemm": ("src/repro_torch/csrc/bgemm.cu", "src/repro/kernels/bgemm.py:112"),
    "bitpack": ("src/repro_torch/csrc/bitpack.cu",
                "src/repro/kernels/bitpack.py:43"),
    "wq_gemm": ("src/repro_torch/csrc/wqmm.cu", "src/repro/kernels/wqmm.py:62"),
    # mode="mxu" of the first three: the TPU kernels' mxu branch is
    # src/repro/kernels/bgemm.py:53 (_tile_product), reached from these
    "bitserial_gemm_mxu": ("src/repro_torch/csrc/bitserial_mma.cuh",
                           "src/repro/kernels/bitserial.py:245"),
    "bitserial_fused_mxu": ("src/repro_torch/csrc/bitserial_mma.cuh",
                            "src/repro/kernels/bitserial.py:273"),
    "bgemm_mxu": ("src/repro_torch/csrc/bitserial_mma.cuh",
                  "src/repro/kernels/bgemm.py:112"),
}
MXU_KERNELS = ("bitserial_gemm_mxu", "bitserial_fused_mxu", "bgemm_mxu")
# checks of both modes at every kind of tile (block_m, block_n, block_w) the
# policy accepts: the default first, down to one row and to one fragment, a
# K tile of 9 words, and the two extremes, 1 x 1024 and 1024 x 1
TILES = ((8, 32, 4), (1, 32, 1), (16, 8, 8), (32, 32, 9), (1, 1024, 4),
         (1024, 1, 1))
MXU_EPILOGUES = ((8, True), (4, False), (2, True))
# one-hot words at these tiles and plane pairs, in both modes
ONE_HOT_TILES = ((8, 32, 4), (1, 1024, 4), (1024, 1, 1))
ONE_HOT_ST = ((1, 1), (1, 8), (8, 8), (3, 5))
# bit-serial GEMMs of one forward_qgtc: two per GCN layer, three per GIN layer
PER_FORWARD = {"gcn": 6, "gin": 9}
# wq_gemm: the reference test's (M, K, N) and a ragged one; the K split of
# the decode shapes (a cluster of 8 at N = 4096 and at N = 512), a wide tile
# past 32 rows with N not a multiple of 16 bytes of packed row, and a ragged
# M past the tall tile; group sizes (8: not whole 16-row chunks), and tile
# sizes (block_m, block_n, block_k) besides the default
WQ_SHAPES = ((1, 128, 256), (8, 256, 512), (5, 160, 64), (13, 416, 300),
             (1, 4096, 4096), (8, 13440, 512), (128, 1024, 1000),
             (37, 416, 300))
WQ_GROUPS = (32, 16, 8)
# x scaled by 2^20 and 2^-20 as well: the three bf16 pieces must carry it
WQ_X_SCALES = (1.0, 2.0 ** 20, 2.0 ** -20)
# a row's result at these M must be the same bit for bit (wg's K, N = 4096)
WQ_M_ROWS = (1, 3, 8, 37, 128)
WQ_BLOCKS = ((8, 256, 128), (1, 64, 32), (32, 128, 64))
# codeqwen1.5-7b (src/repro/configs/codeqwen1_5_7b.py): d_model 4096, 32
# heads with 32 kv heads, d_ff 13440, vocab 92416; one decoder layer's
# projections and the head, as (K, N)
D_MODEL, D_FF, VOCAB = 4096, 13440, 92416
CODEQWEN_PROJ = {"wq": (D_MODEL, D_MODEL), "wk": (D_MODEL, D_MODEL),
                 "wv": (D_MODEL, D_MODEL), "wo": (D_MODEL, D_MODEL),
                 "wg": (D_MODEL, D_FF), "wu": (D_MODEL, D_FF),
                 "wd": (D_FF, D_MODEL), "lm_head": (D_MODEL, VOCAB)}
# decode batch 1, 8 and 128 (decode_32k's batch, src/repro/configs/base.py)
WQ_BATCHES = (1, 8, 128)
L2_BYTES = 50e6  # the H100's L2: a timed weight must not stay in it


_START = time.perf_counter()


def emit(**kw):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**kw, "elapsed_s": time.perf_counter() - _START}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def roofline(nbytes, ops) -> tuple[float, str]:
    """Least time (ms) to move ``nbytes`` and do ``ops`` float32 operations,
    and which bounds."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wq_bound(m, k, n, w_bytes, x_bytes) -> dict:
    """Least time (ms) for wq_gemm at (M, K, N): the larger of its bytes (x
    read once, the packed weight and its scales, the float32 output) over
    the HBM rate and its bf16 tensor-core passes (3 for float32 x, 1 for
    bf16: the pieces the kernel multiplies) at 2 M K N each over the dense
    bf16 rate; beside it the CUDA-core bound the first kernel was held to
    (2 M K N float32 operations at 67 TFLOP/s)."""
    passes = 3 if x_bytes == 4 else 1
    t_bytes = (x_bytes * m * k + w_bytes + 4 * m * n) / PEAK_BYTES_S * 1e3
    t_ops = passes * 2 * m * k * n / PEAK_BF16_S * 1e3
    old_ms, old_by = roofline(x_bytes * m * k + w_bytes + 4 * m * n, 2 * m * k * n)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "passes": passes, "cuda_core_bound_ms": old_ms,
            "cuda_core_bound_by": old_by}


def int_rates(torch) -> dict:
    """The card's popcount and LOP3 rates (results/s): the per-SM rates of
    compute capability 9.0 times the SM count and the SM clock that
    nvidia-smi reports (clocks.max.sm, MHz)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sm_clock_mhz": mhz, "sms": sms,
            "popc_s": POPC_PER_CLOCK_SM * sms * mhz * 1e6,
            "lop3_s": LOP3_PER_CLOCK_SM * sms * mhz * 1e6}


def bound(a_packed, t, n, rates, *, fused=False,
          tensor_cores=False) -> tuple[float, str]:
    """Least time (ms) for the bit-serial GEMM on these inputs, and what
    bounds it.

    Bytes: every input word read once, every output written once. Operations:
    one AND and one popcount per non-zero word of A, per plane of B, per
    output column; a zero word adds nothing, whatever the schedule, so the
    work this data needs counts only the non-zero ones. The popcounts run at
    ``rates["popc_s"]``, the ANDs at ``rates["lop3_s"]``, on separate units:
    the slower sets the time. The fused epilogue adds alpha and beta (4
    bytes a row and a column) and, per output, two conversions (16 a clock
    on an SM, the popcount rate, taken as a unit of their own) and four
    float operations (counted with the ANDs).

    ``tensor_cores``: the mode="mxu" kernels run the AND and popcount on the
    b1 tensor cores, whose rate NVIDIA's data sheet does not give; the bound
    is then the bytes alone (the operations side, even at the CUDA cores'
    popcount rate, is below the bytes at most GNN shapes, and far below at
    any tensor-core rate)."""
    s, m, w = a_packed.shape
    nonzero_words = int((a_packed != 0).sum())
    nbytes = 4 * (s * m * w + t * w * n + m * n)
    pops = ands = t * n * nonzero_words
    converts = 0
    if fused:
        nbytes, converts, ands = nbytes + 4 * (m + n), 2 * m * n, ands + 4 * m * n
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 0.0 if tensor_cores else 1e3 * max(
        pops / rates["popc_s"], converts / rates["popc_s"], ands / rates["lop3_s"])
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def turns_ms(torch, fns: dict, *, reps=50) -> dict:
    """``graph_ms`` of two versions of one function in turns (a, b, b, a),
    each the mean of its two turns: the way two versions are compared on one
    card."""
    a, b = fns
    times = {a: [], b: []}
    for name in (a, b, b, a):
        times[name].append(graph_ms(torch, fns[name], reps=reps))
    return {name: sum(v) / len(v) for name, v in times.items()}


def _operand(torch, gen, m, k, bits, pattern):
    a = torch.randint(0, 1 << bits, (m, k), generator=gen, dtype=torch.int32)
    if pattern == "zero":
        a.zero_()
    elif pattern == "block_diag":
        out = torch.zeros_like(a)
        sm, sk = max(m // 4, 1), max(k // 4, 1)
        for i in range(4):
            out[i * sm:(i + 1) * sm, i * sk:(i + 1) * sk] = \
                a[i * sm:(i + 1) * sm, i * sk:(i + 1) * sk]
        a = out
    return a


def _schedules(ap, a_pad, pol):
    """The four schedules as (wrapper kwargs, plain-version kwargs) for a
    packed (s, M, W) operand and its padded copy."""
    from repro_torch.core import zerotile
    from repro_torch.kernels import sgt

    occ = zerotile.tile_occupancy_planes(a_pad, pol.block_m, pol.block_w)
    ctiles = zerotile.compact_artifacts(ap, pol.block_m, pol.block_w)
    stiles = sgt.sgt_artifacts(ap, pol.block_m)
    return {
        "dense": ({}, {}),
        "mask": ({"occupancy": occ}, {"occupancy": occ}),
        "compact": ({"tiles": ctiles}, {"compact": ctiles[:3]}),
        "sgt": ({"tiles": stiles}, {"sgt": stiles[:3]}),
    }


def _max_err(torch, got, plain, what):
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        raise AssertionError(f"kernel != plain: {what}")
    return (got.long() - plain.long()).abs().max().item() if got.numel() else 0


def phase_kernel_vs_plain(torch, card):
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.core import bitops
    from repro_torch.kernels import bitserial, ops

    gen = torch.Generator().manual_seed(1)
    cases = [(shape, st) for shape in RAGGED for st in ST_PAIRS]
    cases += [((2048, 2048, 16), (1, 8)), ((2048, 128, 64), (8, 8))]
    max_err, n_checks = 0, 0
    for (m, k, n), (s, t) in cases:
        for pattern in ("random", "zero", "block_diag"):
            a = _operand(torch, gen, m, k, s, pattern)
            b = torch.randint(0, 1 << t, (k, n), generator=gen, dtype=torch.int32)
            exact = (a.double() @ b.double()).to(torch.int32).to(DEVICE)
            ap, bp = bitops.pack_a(a, s).to(DEVICE), bitops.pack_b(b, t).to(DEVICE)
            a_pad = bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w)
            b_pad = bitops.pad_to(bp, 1, pol.block_w)
            for name, (wrap_kw, plain_kw) in _schedules(ap, a_pad, pol).items():
                got = ops.bitserial_gemm(ap, bp, **wrap_kw)
                plain = bitserial.bitserial_gemm_plain(
                    a_pad, b_pad, block_m=pol.block_m, block_w=pol.block_w,
                    **plain_kw)[:m]
                what = f"bitserial_gemm {(m, k, n)} s={s} t={t} {pattern} {name}"
                err = _max_err(torch, got, plain, what)
                if not torch.equal(got, exact):
                    raise AssertionError(f"kernel != exact product: {what}")
                max_err, n_checks = max(max_err, err), n_checks + 1
    emit(phase="kernel_vs_plain", kernel="bitserial_gemm", checks=n_checks,
         schedules=list(SCHEDULES),
         st_pairs=[list(p) for p in ST_PAIRS], ragged=[list(r) for r in RAGGED],
         path_shapes=[[2048, 2048, 16, 1, 8], [2048, 128, 64, 8, 8]],
         patterns=["random", "zero", "block_diag"], equal=True,
         max_abs_err=max_err, card=card)
    return max_err


def phase_new_kernels_vs_plain(torch, card):
    """bitserial_fused, bgemm and bitpack against their plain versions on
    the same CUDA tensors. Returns {kernel: max_abs_err}."""
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.core import bitops
    from repro_torch.core.quantize import calibrate
    from repro_torch.kernels import bgemm, bitserial, ops

    gen = torch.Generator().manual_seed(4)
    errs = {"bitserial_fused": 0, "bgemm": 0, "bitpack": 0}
    checks = dict.fromkeys(errs, 0)

    # fused: the ragged shapes and plane pairs of the bit-serial check, and
    # the Tensor API's two bitmm2bit shapes (2304 x 128 @ 128 x 16 and
    # 2304 x 16 @ 16 x 16)
    cases = [(shape, st) for shape in RAGGED for st in ST_PAIRS]
    cases += [((2304, 128, 16), (8, 8)), ((2304, 16, 16), (4, 4))]
    for (m, k, n), (s, t) in cases:
        for pattern in ("random", "zero", "block_diag"):
            a = _operand(torch, gen, m, k, s, pattern)
            b = torch.randint(0, 1 << t, (k, n), generator=gen, dtype=torch.int32)
            top = max(int((a.double() @ b.double()).max()), 1)
            ap, bp = bitops.pack_a(a, s).to(DEVICE), bitops.pack_b(b, t).to(DEVICE)
            a_pad = bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w)
            b_pad = bitops.pad_to(bp, 1, pol.block_w)
            schedules = _schedules(ap, a_pad, pol)
            for out_bits, relu in FUSED_EPILOGUES:
                # spread the outputs over every level, clipped at both ends
                alpha = (torch.rand((m, 1), generator=gen) * 1.5
                         * (1 << out_bits) / top).to(DEVICE)
                beta = ((torch.rand((1, n), generator=gen) - 0.5)
                        * (1 << out_bits)).to(DEVICE)
                al = bitops.pad_to(alpha, 0, pol.block_m)
                for name, (wrap_kw, plain_kw) in schedules.items():
                    got = ops.bitserial_fused(ap, bp, alpha, beta,
                                              out_bits=out_bits, relu=relu,
                                              **wrap_kw)
                    plain = bitserial.bitserial_fused_plain(
                        a_pad, b_pad, al, beta, out_bits=out_bits, relu=relu,
                        block_m=pol.block_m, block_w=pol.block_w,
                        **plain_kw)[:m]
                    err = _max_err(torch, got, plain,
                                   f"bitserial_fused {(m, k, n)} s={s} t={t} "
                                   f"{pattern} {name} out_bits={out_bits} relu={relu}")
                    errs["bitserial_fused"] = max(errs["bitserial_fused"], err)
                    checks["bitserial_fused"] += 1
    emit(phase="kernel_vs_plain", kernel="bitserial_fused",
         checks=checks["bitserial_fused"], schedules=list(SCHEDULES),
         epilogues=[list(e) for e in FUSED_EPILOGUES],
         shapes=[[*shape, *st] for shape, st in cases],
         patterns=["random", "zero", "block_diag"], equal=True,
         max_abs_err=errs["bitserial_fused"], card=card)

    # bgemm: the ragged shapes, the adjacency shape of the main path and the
    # fig9a shape (2304 x 2304 adjacency x 128 features)
    shapes = list(RAGGED) + [(2048, 2048, 16), (2304, 2304, 128)]
    for m, k, n in shapes:
        for pattern in ("random", "zero", "block_diag"):
            a = _operand(torch, gen, m, k, 1, pattern)
            b = torch.randint(0, 2, (k, n), generator=gen, dtype=torch.int32)
            exact = (a.double() @ b.double()).to(torch.int32).to(DEVICE)
            ap, bp = bitops.pack_a(a, 1).to(DEVICE), bitops.pack_b(b, 1).to(DEVICE)
            a_pad = bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w)
            b_pad = bitops.pad_to(bp, 1, pol.block_w)
            for name, (wrap_kw, plain_kw) in _schedules(ap, a_pad, pol).items():
                got = ops.bgemm(ap[0], bp[0], **wrap_kw)
                plain = bgemm.bgemm_plain(a_pad[0], b_pad[0], block_m=pol.block_m,
                                          block_w=pol.block_w, **plain_kw)[:m]
                what = f"bgemm {(m, k, n)} {pattern} {name}"
                err = _max_err(torch, got, plain, what)
                if not torch.equal(got, exact):
                    raise AssertionError(f"kernel != exact product: {what}")
                errs["bgemm"] = max(errs["bgemm"], err)
                checks["bgemm"] += 1
    emit(phase="kernel_vs_plain", kernel="bgemm", checks=checks["bgemm"],
         schedules=list(SCHEDULES), shapes=[list(x) for x in shapes],
         patterns=["random", "zero", "block_diag"], equal=True,
         max_abs_err=errs["bgemm"], card=card)

    # bitpack: the shapes of PACK_SHAPES at every width, each also with words
    # past ceil(K / 32), from a row that is not 16-byte aligned, and with x
    # at grid points, +-inf and past both clip ends; then the timed graphs'
    # features
    def pack_check(x, scale, zero, nbits, words=None):
        what = f"bitpack {tuple(x.shape)} nbits={nbits} words={words}"
        errs["bitpack"] = max(errs["bitpack"], _bitpack_vs_plain(
            torch, x, scale, zero, nbits, words, what))
        checks["bitpack"] += 1

    for m, k in PACK_SHAPES:
        x = (torch.randn((m, k), generator=gen) * 2).to(DEVICE)
        need = -(-k // 32)
        for nbits in PACK_BITS:
            scale = torch.tensor(4.0 / (1 << nbits), device=DEVICE)
            zero = torch.tensor(-2.0, device=DEVICE)
            pack_check(x, scale, zero, nbits)
            for words in (need + 1, need + 5, -(-need // 4) * 4 + 8):
                pack_check(x, scale, zero, nbits, words)
            shifted = torch.empty(m * k + 1, device=DEVICE)[1:].view(m, k)
            shifted.copy_(x)
            pack_check(shifted, scale, zero, nbits)
            pack_check(_special_values(torch, x, scale, zero, nbits), scale,
                       zero, nbits)
    # scales outside the kernel's fast quotient (2^-100 .. 2^100): __fdiv_rn
    for step in (2.0 ** -110, 2.0 ** 110):
        x = (torch.randn((33, 100), generator=gen) * 100 * step).to(DEVICE)
        scale = torch.tensor(step, device=DEVICE)
        zero = torch.tensor(0.0, device=DEVICE)
        for nbits in PACK_BITS:
            pack_check(x, scale, zero, nbits)
            pack_check(_special_values(torch, x, scale, zero, nbits), scale,
                       zero, nbits)
    graphs = []
    for name, (m, k), widths in _pack_graphs():
        x = torch.randn((m, k), generator=torch.Generator(device=DEVICE)
                        .manual_seed(m), device=DEVICE)
        for nbits in widths:
            qp = calibrate(x, nbits)
            pack_check(x, qp.scale, qp.zero, nbits)
            graphs.append([name, m, k, nbits])
        del x
    emit(phase="kernel_vs_plain", kernel="bitpack", checks=checks["bitpack"],
         nbits=list(PACK_BITS), shapes=[list(x) for x in PACK_SHAPES],
         variants=["words past ceil(K/32)", "row not 16-byte aligned",
                   "grid points and 2 floats each side, +-inf, past both "
                   "clip ends", "scale 2^-110 and 2^110 (__fdiv_rn)"],
         graphs=graphs, equal=True, padding_zero=True,
         max_abs_err=errs["bitpack"], card=card)
    return errs


def _special_values(torch, x, scale, zero, nbits):
    """x with its first entries at every grid point zero + j * scale (j from
    -3 to 2^nbits + 2) and the two floats each side of it, then +-inf and
    +-1e30: the quotients next to every level and past both clip ends."""
    grid = zero + torch.arange(-3, (1 << nbits) + 3, device=x.device) * scale
    up, down = torch.full_like(grid, math.inf), torch.full_like(grid, -math.inf)
    near = [grid, torch.nextafter(grid, up), torch.nextafter(grid, down)]
    near += [torch.nextafter(near[1], up), torch.nextafter(near[2], down)]
    vals = torch.cat(near + [torch.tensor([math.inf, -math.inf, 1e30, -1e30],
                                          device=x.device)])
    special = x.clone().view(-1)
    n = min(special.numel(), vals.numel())
    special[:n] = vals[:n]
    return special.view(x.shape)


def _pack_graphs():
    """PACK_GRAPHS as (name, (M, K), widths), M and K from Table 1."""
    from repro_torch.graph.datasets import TABLE1

    return [(name, shape or (TABLE1[name][0], TABLE1[name][2]), widths)
            for name, shape, widths in PACK_GRAPHS]


def pack_words(k) -> int:
    """ops.bitpack's word count at the default policy: K padded to block_w
    words."""
    from repro_torch.api import DEFAULT_POLICY as pol

    return -(-k // (32 * pol.block_w)) * pol.block_w


def _bitpack_plain_slices(torch, x, scale, zero, nbits, words):
    """The plain version PACK_SLICE_ROWS rows at a time: its int64
    intermediates of a whole graph's features would not fit at once."""
    from repro_torch.kernels import bitpack

    return torch.cat([bitpack.bitpack_plain(x[r:r + PACK_SLICE_ROWS], scale,
                                            zero, nbits=nbits, words=words)
                      for r in range(0, x.shape[0], PACK_SLICE_ROWS)], dim=1)


def _bitpack_vs_plain(torch, x, scale, zero, nbits, words, what):
    """The kernel (through ops.bitpack when ``words`` is None, else at
    ``words``) against the plain version on the same CUDA tensors: equal,
    padding words zero, one launch."""
    from repro_torch.kernels import bitpack, ops

    before = bitpack.LAUNCHES["bitpack"]
    if words is None:
        got = ops.bitpack(x, scale, zero, nbits=nbits)
    else:
        got = bitpack.bitpack(x, scale, zero, nbits=nbits, words=words)
    if bitpack.LAUNCHES["bitpack"] != before + 1:
        raise AssertionError(f"not one launch: {what}")
    plain = _bitpack_plain_slices(torch, x, scale, zero, nbits, got.shape[2])
    err = _max_err(torch, got, plain, what)
    if bool(got[:, :, -(-x.shape[1] // 32):].any()):
        raise AssertionError(f"padding words not zero: {what}")
    return err


def _word(bit):
    """A 32-bit word with one bit set, as the int32 bit pattern."""
    return (1 << bit) - (1 << 32) if bit == 31 else 1 << bit


def _one_hot_checks(torch, ops, pol) -> int:
    """mode="mxu" against the fragment layout of mma m16n8k256 .b1: one set
    bit of A at every (row < 16, word < 8, bit 0 or 31) against a B of all
    ones must light exactly that row, through bgemm and bitserial_gemm; one
    set bit of B at every (word < 8, column < 8) against an A of all ones
    exactly that column. Returns the number of checks."""
    ones_a = torch.full((16, 8), -1, dtype=torch.int32, device=DEVICE)
    ones_b = torch.full((8, 8), -1, dtype=torch.int32, device=DEVICE)
    checks = 0
    for row, word, bit in itertools.product(range(16), range(8), (0, 31)):
        a = torch.zeros((16, 8), dtype=torch.int32)
        a[row, word] = _word(bit)
        a = a.to(DEVICE)
        want = torch.zeros((16, 8), dtype=torch.int32, device=DEVICE)
        want[row] = 1
        col = row % 8
        b = torch.zeros((8, 8), dtype=torch.int32)
        b[word, col] = _word(bit)
        want_b = torch.zeros((16, 8), dtype=torch.int32, device=DEVICE)
        want_b[:, col] = 1
        for got, exp, what in (
                (ops.bgemm(a, ones_b, policy=pol), want, "A, bgemm"),
                (ops.bitserial_gemm(a[None], ones_b[None], policy=pol), want,
                 "A, bitserial_gemm"),
                (ops.bgemm(ones_a, b.to(DEVICE), policy=pol), want_b, "B, bgemm")):
            _max_err(torch, got, exp, f"one-hot {what} row={row} word={word} "
                                      f"bit={bit} tile={pol.block_m, pol.block_n}")
            checks += 1
    return checks


def _tile_cases():
    """The shapes and plane pairs of the checks at non-default tiles:
    (kind, ((m, k, n), (s, t))) for kind 'gemm', 'fused' and 'bgemm'."""
    gemm_cases = [(shape, st) for shape in RAGGED for st in ST_PAIRS]
    gemm_cases += [((2048, 2048, 16), (1, 8)), ((2048, 128, 64), (8, 8))]
    fused_cases = [(shape, st) for shape in RAGGED for st in ST_PAIRS]
    one_bit = list(RAGGED) + [(2048, 2048, 16), (2304, 2304, 128)]
    return ([("gemm", c) for c in gemm_cases] + [("fused", c) for c in fused_cases]
            + [("bgemm", (shape, (1, 1))) for shape in one_bit])


def _tiles_vs_plain(torch, gen, mode, tiles):
    """The three kernels of ``mode`` at each tile of ``tiles``, in the four
    schedules, on the random, zero and block-diagonal patterns of
    ``_tile_cases``, each equal to its plain version; at 'mxu' each also
    equal to the 'vpu' kernel. Returns ({kernel: max_abs_err}, {kernel:
    checks})."""
    from repro_torch import api
    from repro_torch.core import bitops
    from repro_torch.kernels import bgemm, bitserial, ops

    names = {kind: bitserial.kernel_name(base, mode) for kind, base in (
        ("gemm", "bitserial_gemm"), ("fused", "bitserial_fused"), ("bgemm", "bgemm"))}
    errs = dict.fromkeys(names.values(), 0)
    checks = dict.fromkeys(names.values(), 0)
    for kind, ((m, k, n), (s, t)) in _tile_cases():
        for pattern in ("random", "zero", "block_diag"):
            a = _operand(torch, gen, m, k, s, pattern)
            b = torch.randint(0, 1 << t, (k, n), generator=gen, dtype=torch.int32)
            top = max(int((a.double() @ b.double()).max()), 1)
            ap, bp = bitops.pack_a(a, s).to(DEVICE), bitops.pack_b(b, t).to(DEVICE)
            for bm, bn, bw in tiles:
                pol = api.ExecutionPolicy(block_m=bm, block_n=bn, block_w=bw,
                                          mode=mode)
                vpu = pol.replace(mode="vpu")
                a_pad = bitops.pad_to(bitops.pad_to(ap, 1, bm), 2, bw)
                b_pad = bitops.pad_to(bp, 1, bw)
                grid = dict(block_m=bm, block_w=bw)
                key = names[kind]
                for name, (wrap_kw, plain_kw) in _schedules(ap, a_pad, pol).items():
                    what = (f"{kind} {mode} {(m, k, n)} s={s} t={t} {pattern} "
                            f"{name} tile={(bm, bn, bw)}")
                    if kind == "gemm":
                        got = ops.bitserial_gemm(ap, bp, policy=pol, **wrap_kw)
                        ref = (mode == "mxu" and
                               ops.bitserial_gemm(ap, bp, policy=vpu, **wrap_kw))
                        plain = bitserial.bitserial_gemm_plain(
                            a_pad, b_pad, **grid, **plain_kw)[:m]
                        pairs = [(None, None)]
                    elif kind == "bgemm":
                        got = ops.bgemm(ap[0], bp[0], policy=pol, **wrap_kw)
                        ref = (mode == "mxu" and
                               ops.bgemm(ap[0], bp[0], policy=vpu, **wrap_kw))
                        plain = bgemm.bgemm_plain(a_pad[0], b_pad[0], **grid,
                                                  **plain_kw)[:m]
                        pairs = [(None, None)]
                    else:
                        pairs = MXU_EPILOGUES
                    for out_bits, relu in pairs:
                        check = what
                        if kind == "fused":
                            alpha = (torch.rand((m, 1), generator=gen) * 1.5
                                     * (1 << out_bits) / top).to(DEVICE)
                            beta = ((torch.rand((1, n), generator=gen) - 0.5)
                                    * (1 << out_bits)).to(DEVICE)
                            epi = dict(out_bits=out_bits, relu=relu)
                            got = ops.bitserial_fused(ap, bp, alpha, beta, policy=pol,
                                                      **epi, **wrap_kw)
                            ref = mode == "mxu" and ops.bitserial_fused(
                                ap, bp, alpha, beta, policy=vpu, **epi, **wrap_kw)
                            plain = bitserial.bitserial_fused_plain(
                                a_pad, b_pad, bitops.pad_to(alpha, 0, bm), beta,
                                **epi, **grid, **plain_kw)[:m]
                            check += f" out_bits={out_bits} relu={relu}"
                        err = _max_err(torch, got, plain, check)
                        if mode == "mxu" and not torch.equal(got, ref):
                            raise AssertionError(f"mxu kernel != vpu kernel: {check}")
                        errs[key] = max(errs[key], err)
                        checks[key] += 1
    return errs, checks


def _one_hot_words(torch, ops, pol, s, t, words=40) -> int:
    """The lane-to-word, plane and column mapping of either mode, on one
    call each: A with one set bit a row, at every (plane p < s, word <
    ``words``, bit 0 or 31), times a random t-plane B of 40 columns; and a
    random s-plane A times B with one set bit a column, at every (plane q <
    t, word, bit 0 or 31). ``words`` past 32 crosses the 'vpu' kernel's
    32-word chunks, t * words * 2 columns its column blocks. Each product is
    exact (one non-zero term a row or column); bitserial_gemm in the four
    schedules, bitserial_fused under an identity epilogue (alpha 1, beta 0,
    out_bits 30), and bgemm at s = t = 1. Returns the number of checks."""
    from repro_torch.core import bitops

    gen = torch.Generator().manual_seed(s * 16 + t)
    k = 32 * words
    hot = [(p, wd, bit) for p in range(max(s, t)) for wd in range(words)
           for bit in (0, 31)]
    a_hot = torch.zeros((len(hot), k), dtype=torch.int64)
    for r, (p, wd, bit) in enumerate(hot):
        a_hot[r, 32 * wd + bit] = 1 << p
    a_hot = a_hot[:s * words * 2]  # rows of planes < s
    b_hot = torch.zeros((k, t * words * 2), dtype=torch.int64)
    for col, (q, wd, bit) in enumerate(hot[:t * words * 2]):
        b_hot[32 * wd + bit, col] = 1 << q
    b_rand = torch.randint(0, 1 << t, (k, 40), generator=gen, dtype=torch.int64)
    a_rand = torch.randint(0, 1 << s, (64, k), generator=gen, dtype=torch.int64)
    checks = 0
    for a, b in ((a_hot, b_rand), (a_rand, b_hot)):
        exact = (a @ b).to(torch.int32).to(DEVICE)
        ap = bitops.pack_a(a.to(torch.int32), s).to(DEVICE)
        bp = bitops.pack_b(b.to(torch.int32), t).to(DEVICE)
        a_pad = bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w)
        m, n = a.shape[0], b.shape[1]
        one = torch.ones((m, 1), device=DEVICE)
        zero = torch.zeros((1, n), device=DEVICE)
        for name, (wrap_kw, _) in _schedules(ap, a_pad, pol).items():
            got = {"bitserial_gemm": ops.bitserial_gemm(ap, bp, policy=pol, **wrap_kw),
                   "bitserial_fused": ops.bitserial_fused(
                       ap, bp, one, zero, out_bits=30, relu=False, policy=pol,
                       **wrap_kw)}
            if s == t == 1:
                got["bgemm"] = ops.bgemm(ap[0], bp[0], policy=pol, **wrap_kw)
            for kernel, out in got.items():
                _max_err(torch, out, exact, f"one-hot words {pol.mode} {kernel} "
                                            f"s={s} t={t} {name} tile="
                                            f"{pol.block_m, pol.block_n, pol.block_w}")
                checks += 1
    return checks


def phase_vpu_tiles_vs_plain(torch, card):
    """The 'vpu' kernels (bitserial_gemm in the four schedules,
    bitserial_fused, bgemm) against their plain versions at every TILES
    tile: the launch no longer follows the tile, so each tile's artifacts
    and ragged edges are checked apart; then one-hot words at three tiles.
    Returns {kernel: max_abs_err}."""
    from repro_torch import api
    from repro_torch.kernels import ops

    errs, checks = _tiles_vs_plain(torch, torch.Generator().manual_seed(12),
                                   "vpu", TILES)
    one_hot = sum(_one_hot_words(torch, ops, api.ExecutionPolicy(
        block_m=bm, block_n=bn, block_w=bw), s, t)
        for bm, bn, bw in ONE_HOT_TILES for s, t in ONE_HOT_ST)
    emit(phase="kernel_vs_plain", mode="vpu", checks=checks,
         one_hot_word_checks=one_hot, schedules=list(SCHEDULES),
         st_pairs=[list(p) for p in ST_PAIRS], tiles=[list(x) for x in TILES],
         epilogues=[list(e) for e in MXU_EPILOGUES],
         cases=[[kind, *shape, *st] for kind, (shape, st) in _tile_cases()],
         patterns=["random", "zero", "block_diag"], equal_plain=True,
         max_abs_err=errs, card=card)
    return errs


def _mxu_exact(torch, ops, pol, a, b, s, t, schedule, what) -> int:
    """bitserial_gemm, the identity-epilogue bitserial_fused and (at one bit)
    bgemm at 'mxu' on int64 CPU values ``a`` (M, K) and ``b`` (K, N) in one
    schedule: each equal to the exact product and to the 'vpu' kernel.
    Returns the number of checks."""
    from repro_torch.core import bitops

    exact = (a @ b).to(torch.int32).to(DEVICE)
    ap = bitops.pack_a(a.to(torch.int32), s).to(DEVICE)
    bp = bitops.pack_b(b.to(torch.int32), t).to(DEVICE)
    a_pad = bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w)
    wrap_kw = _schedules(ap, a_pad, pol)[schedule][0]
    one = torch.ones((a.shape[0], 1), device=DEVICE)
    zero = torch.zeros((1, b.shape[1]), device=DEVICE)
    checks = 0
    for p in (pol, pol.replace(mode="vpu")):
        outs = [ops.bitserial_gemm(ap, bp, policy=p, **wrap_kw),
                ops.bitserial_fused(ap, bp, one, zero, out_bits=30, relu=False,
                                    policy=p, **wrap_kw)]
        if s == t == 1:
            outs.append(ops.bgemm(ap[0], bp[0], policy=p, **wrap_kw))
        for out in outs:
            _max_err(torch, out, exact, f"{p.mode} {what} s={s} t={t} {schedule} "
                                        f"tile={pol.block_m, pol.block_n, pol.block_w}")
            checks += 1
    return checks


def _mxu_new_paths(torch, ops) -> dict:
    """The paths of the 'mxu' kernel that the tile checks do not aim at,
    each exact and equal to the 'vpu' kernel: short walks of 1..5 words
    (same-weight plane pairs sharing an mma over 1, 2 or 4 live words; 5
    words take the long walk) with random, all-zero and one-word A; one
    non-zero word per 16-row strip in a 72-word K (the zero-run skip); B past
    one staged column block and past one K window; row tiles below a strip
    in the mask and list schedules. Returns {case: checks}."""
    from repro_torch import api

    def policy(tile):
        bm, bn, bw = tile
        return api.ExecutionPolicy(block_m=bm, block_n=bn, block_w=bw, mode="mxu")

    gen = torch.Generator().manual_seed(13)

    def ints(shape, bits):
        return torch.randint(0, 1 << bits, shape, generator=gen, dtype=torch.int64)

    checks = dict.fromkeys(("short_walks", "zero_runs", "staged_windows",
                            "row_tiles_below_a_strip"), 0)
    for tile, (s, t), words, pattern in itertools.product(
            ((8, 32, 1), (16, 8, 8)), ((8, 8), (3, 5), (1, 8)), range(1, 6),
            ("random", "zero", "one_word")):
        k = 32 * words - 7
        a, b = ints((37, k), s), ints((k, 40), t)
        if pattern == "zero":
            a.zero_()
        elif pattern == "one_word":
            keep = 32 * int(torch.randint(0, words, (1,), generator=gen))
            a[:, :keep] = 0
            a[:, keep + 32:] = 0
        for schedule in SCHEDULES:
            checks["short_walks"] += _mxu_exact(
                torch, ops, policy(tile), a, b, s, t, schedule,
                f"short walk words={words} {pattern}")
    for s, t in ((1, 8), (1, 1), (3, 5)):
        m, k = 100, 32 * 72
        a = torch.zeros((m, k), dtype=torch.int64)
        for r0 in range(0, m, 16):
            row = r0 + int(torch.randint(0, min(16, m - r0), (1,), generator=gen))
            word = int(torch.randint(0, 72, (1,), generator=gen))
            a[row, 32 * word:32 * word + 32] = ints((32,), s)
        b = ints((k, 16), t)
        for schedule in SCHEDULES:
            checks["zero_runs"] += _mxu_exact(
                torch, ops, policy((8, 32, 4)), a, b, s, t, schedule,
                "one non-zero word a strip")
    for m, k, n, s, t in ((61, 1000, 70, 2, 3), (40, 2304, 130, 1, 1),
                          (40, 2304, 64, 1, 8), (24, 12800, 9, 1, 8),
                          (18, 100000, 8, 1, 1)):
        a, b = ints((m, k), s), ints((k, n), t)
        a[:, k // 3:] *= (torch.rand((m, k - k // 3), generator=gen) < 0.05)
        for schedule in SCHEDULES:
            checks["staged_windows"] += _mxu_exact(
                torch, ops, policy((8, 32, 4)), a, b, s, t, schedule,
                f"staged window {(m, k, n)}")
    for tile in ((1, 32, 1), (2, 16, 3), (4, 8, 5), (8, 32, 4), (12, 8, 4),
                 (24, 4, 2)):
        for s, t in ((3, 5), (1, 8), (1, 1)):
            m, k = 72, 32 * 40
            a = ints((m, k), s)
            for r in range(m):  # each row keeps a band of its own
                lo = (r * 7) % 30 * 32
                a[r, :lo] = 0
                a[r, lo + 5 * 32:] = 0
            a[::5] = 0
            b = ints((k, 24), t)
            for schedule in ("mask", "compact", "sgt"):
                checks["row_tiles_below_a_strip"] += _mxu_exact(
                    torch, ops, policy(tile), a, b, s, t, schedule,
                    "row tiles below a strip")
    return checks


def phase_mxu_vs_plain(torch, card):
    """The mode="mxu" kernels (bitserial_gemm in the four schedules,
    bitserial_fused, bgemm) against their plain versions and against the
    'vpu' kernels on the same CUDA tensors, at every TILES tile; then the
    one-hot fragment checks, one-hot words at three tiles, and the kernel's
    own paths (_mxu_new_paths). Returns {kernel: max_abs_err}."""
    from repro_torch import api
    from repro_torch.kernels import ops

    errs, checks = _tiles_vs_plain(torch, torch.Generator().manual_seed(9),
                                   "mxu", TILES)
    one_hot = sum(_one_hot_checks(torch, ops, api.ExecutionPolicy(
        block_m=bm, block_n=bn, block_w=bw, mode="mxu"))
        for bm, bn, bw in ((16, 8, 8), (8, 32, 4)))
    one_hot_words = sum(_one_hot_words(torch, ops, api.ExecutionPolicy(
        block_m=bm, block_n=bn, block_w=bw, mode="mxu"), s, t)
        for bm, bn, bw in ONE_HOT_TILES for s, t in ONE_HOT_ST)
    paths = _mxu_new_paths(torch, ops)
    cases = _tile_cases()
    emit(phase="kernel_vs_plain", mode="mxu", checks=checks,
         one_hot_checks=one_hot, one_hot_word_checks=one_hot_words,
         path_checks=paths, schedules=list(SCHEDULES),
         st_pairs=[list(p) for p in ST_PAIRS], tiles=[list(x) for x in TILES],
         epilogues=[list(e) for e in MXU_EPILOGUES],
         gemm_shapes=[[*shape, *st] for kind, (shape, st) in cases if kind == "gemm"],
         bgemm_shapes=[list(shape) for kind, (shape, _) in cases if kind == "bgemm"],
         patterns=["random", "zero", "block_diag"],
         equal_plain=True, equal_vpu_kernel=True, max_abs_err=errs, card=card)
    return errs


def phase_main_path(torch, card):
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.configs.qgtc_gnn import GNN_CONFIGS
    from repro_torch.core import bitops, zerotile
    from repro_torch.graph import batching, datasets, partition
    from repro_torch.kernels import bitserial, sgt
    from repro_torch.models import gnn
    from repro_torch.train.trainer import make_device_batch

    t0 = time.perf_counter()
    data = datasets.load(DATASET, scale=SCALE, seed=0)
    t1 = time.perf_counter()
    parts = partition.partition(data.csr, PARTS)
    t2 = time.perf_counter()
    batches = batching.make_batches(data, parts, BATCH_PARTS)[:N_BATCHES]
    t3 = time.perf_counter()
    emit(phase="data", dataset=DATASET, scale=SCALE, nodes=data.csr.n,
         directed_edges=data.csr.e, parts=PARTS, batch_parts=BATCH_PARTS,
         batch_nodes=[b.n_nodes for b in batches],
         batch_edges=[b.n_edges for b in batches], load_s=t1 - t0,
         partition_s=t2 - t1, batching_s=t3 - t2)

    dbs, tiles = [], []
    for b in batches:
        db = make_device_batch(b, device=DEVICE)
        db["edges"] = torch.as_tensor(b.edges, device=DEVICE)
        ap = bitops.pack_a(db["adj"], 1)
        dbs.append(db)
        tiles.append({"none": None,
                      "compact": zerotile.compact_artifacts(
                          ap, pol.block_m, pol.block_w),
                      "sgt": sgt.sgt_artifacts(ap, pol.block_m)})
    occ = [zerotile.occupancy_stats(zerotile.tile_occupancy(
        bitops.pack_a(db["adj"], 1)[0], pol.block_m, pol.block_w))["nonzero_ratio"]
        for db in dbs]
    emit(phase="artifacts", tile_nonzero_ratio=occ,
         compact_s_max=[t["compact"][2] for t in tiles],
         sgt_s_w=[t["sgt"][2] for t in tiles])

    models = {}
    for name, cfg in GNN_CONFIGS.items():
        params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEVICE)
        per_bits = {}
        for bits in BITS:
            cfg_b = dataclasses.replace(cfg, x_bits=bits, w_bits=bits)
            per_bits[bits] = (cfg_b, gnn.quantize_params(params, cfg_b))
        models[name] = (cfg, params, per_bits)

    bitserial.reset_launches()
    expected, logits = 0, {}
    for name, (cfg, _, per_bits) in models.items():
        for bits, (cfg_b, qp) in per_bits.items():
            for jump in ("none", "compact", "sgt"):
                for batch, (db, tl) in enumerate(zip(dbs, tiles)):
                    before = bitserial.LAUNCHES["bitserial_gemm"]
                    got = gnn.forward_qgtc(qp, db["adj"], db["x"], db["inv_deg"],
                                           cfg_b, backend="cuda", tiles=tl[jump])
                    launched = bitserial.LAUNCHES["bitserial_gemm"] - before
                    want = gnn.forward_qgtc(qp, db["adj"], db["x"], db["inv_deg"],
                                            cfg_b, backend="popcount",
                                            tiles=tl[jump])
                    if launched != PER_FORWARD[cfg.model]:
                        raise AssertionError(
                            f"{name} launched the kernel {launched} times, "
                            f"expected {PER_FORWARD[cfg.model]}")
                    if got.shape != (db["adj"].shape[0], cfg.n_classes) or \
                            not bool(torch.isfinite(got).all()):
                        raise AssertionError(f"{name} logits: bad shape or values")
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{name} {bits}b jump={jump}: kernel engine logits "
                            f"differ from the plain engine's")
                    expected += launched
                    logits[name, bits, jump, batch] = got
                emit(phase="main_path", model=name, bits=bits, jump=jump,
                     batches=len(dbs), logits_equal_plain=True,
                     launches_per_forward=PER_FORWARD[cfg.model])
    launches = bitserial.LAUNCHES["bitserial_gemm"]
    if launches == 0 or launches != expected:
        raise AssertionError(f"kernel launches on the main path: {launches}, "
                             f"expected {expected}")
    # forward_qgtc runs the bit-serial GEMM alone, as the reference does
    others = {k: v for k, v in bitserial.LAUNCHES.items() if k != "bitserial_gemm"}
    if any(others.values()):
        raise AssertionError(f"the main path launched other kernels: {others}")
    emit(phase="launches", kernel="bitserial_gemm", launches=launches,
         forwards=len(dbs) * len(BITS) * 3 * len(models))

    # the whole port on the CPU, on the first batch, as the reference the card
    # is held to: integer products are exact on both, and each float step is
    # one IEEE operation on both, so the logits agree to within 1e-5
    cpu_db = make_device_batch(batches[0], device="cpu")
    for name, (cfg, params, per_bits) in models.items():
        cfg_b, qp = per_bits[8]
        params_cpu = {layer: {k: v.cpu() for k, v in p.items()}
                      for layer, p in params.items()}
        qp_cpu = gnn.quantize_params(params_cpu, cfg_b)
        on_card = gnn.forward_qgtc(qp, dbs[0]["adj"], dbs[0]["x"],
                                   dbs[0]["inv_deg"], cfg_b).cpu()
        on_cpu = gnn.forward_qgtc(qp_cpu, cpu_db["adj"], cpu_db["x"],
                                  cpu_db["inv_deg"], cfg_b)
        diff = (on_card - on_cpu).abs().max().item()
        if not torch.allclose(on_card, on_cpu, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{name}: card and CPU logits differ by {diff}")
        dense = gnn.forward(params, dbs[0]["adj"], dbs[0]["x"],
                            dbs[0]["inv_deg"], cfg)
        csr = gnn.forward(params, dbs[0]["edges"], dbs[0]["x"],
                          dbs[0]["inv_deg"], cfg, path="fp32_csr")
        fp_diff = (dense - csr).abs().max().item()
        if not torch.allclose(dense, csr, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{name}: fp32_dense and fp32_csr differ by "
                                 f"{fp_diff}")
        emit(phase="reference", model=name, qgtc8_card_vs_cpu_max_abs=diff,
             fp32_dense_vs_csr_max_abs=fp_diff, card=card)
    return models, batches, dbs, tiles, launches, logits, data, parts


def phase_main_path_mxu(torch, card, models, dbs, tiles, logits):
    """The main path again at mode="mxu": the same forwards, batches, bits
    and jumps through the tensor-core kernel. The logits must equal the
    'vpu' kernel's of phase 3, which equal the plain engine's; the phase
    launches bitserial_gemm_mxu and no other kernel. Returns its launches."""
    from repro_torch import api
    from repro_torch.kernels import bitserial
    from repro_torch.models import gnn

    mxu = api.ExecutionPolicy(mode="mxu")
    bitserial.reset_launches()
    expected = 0
    for name, (cfg, _, per_bits) in models.items():
        for bits, (cfg_b, qp) in per_bits.items():
            for jump in ("none", "compact", "sgt"):
                for batch, (db, tl) in enumerate(zip(dbs, tiles)):
                    got = gnn.forward_qgtc(qp, db["adj"], db["x"], db["inv_deg"],
                                           cfg_b, backend="cuda", policy=mxu,
                                           tiles=tl[jump])
                    if not torch.equal(got, logits[name, bits, jump, batch]):
                        raise AssertionError(
                            f"{name} {bits}b jump={jump} batch {batch}: mxu "
                            f"logits differ from the vpu kernel's")
                    expected += PER_FORWARD[cfg.model]
                emit(phase="main_path", mode="mxu", model=name, bits=bits,
                     jump=jump, batches=len(dbs), logits_equal_vpu_and_plain=True,
                     launches_per_forward=PER_FORWARD[cfg.model])
    launches = dict(bitserial.LAUNCHES)
    others = {k: v for k, v in launches.items() if k != "bitserial_gemm_mxu" and v}
    if launches["bitserial_gemm_mxu"] != expected or expected == 0 or others:
        raise AssertionError(f"mxu main path launches {launches}, expected "
                             f"{expected} of bitserial_gemm_mxu alone")
    emit(phase="launches", mode="mxu", kernel="bitserial_gemm_mxu",
         launches=expected, forwards=len(logits))
    return launches["bitserial_gemm_mxu"]


def _chain(bt, api, x, ws, qps, bits, *, backend, fused, mode="vpu"):
    """The Tensor API's three layers: bitmm2bit -> bitmm2bit -> bitmm2int."""
    pol = api.ExecutionPolicy(fused_requantize=fused, mode=mode)
    for w, qp in zip(ws[:-1], qps):
        x = bt.bitmm2bit(x, w, bits, qp, backend=backend, policy=pol)
    return bt.bitmm2int(x, ws[-1], backend=backend, policy=pol)


def phase_tensor_api(torch, card, models, dbs):
    """The §5 BitTensor path at full width on batch 0, at the qgtc-gcn
    widths. Returns the launches of every kernel in the phase, and per bits
    the operands and the results, which the mxu phase is held to."""
    from repro_torch import api
    from repro_torch.core import bittensor as bt
    from repro_torch.kernels import bitserial

    db = dbs[0]
    _, params, _ = models["qgtc-gcn"]
    weights = [params[f"layer{l}"]["w"] for l in range(3)]
    x, adj = db["x"], db["adj"]
    ta = bt.to_bit(adj, 1, pack_axis=1)
    expected = dict.fromkeys(bitserial.LAUNCHES, 0)
    first = None  # (operands, fused logits on the card) at BITS[0]
    kept = {}
    bitserial.reset_launches()
    for bits in BITS:
        tx = bt.to_bit(x, bits, pack_axis=1)
        packed = api.bitpack(x, tx.qp.scale, tx.qp.zero, nbits=bits)
        expected["bitpack"] += 1
        if not torch.equal(packed, tx.data):
            raise AssertionError(f"{bits}b: to_bit != api.bitpack")
        tws = [bt.to_bit(w, bits, pack_axis=0) for w in weights]
        # output quantization parameters from one calibrated (unfused) pass,
        # so that the fused epilogue has a scalar out_qp to fold in
        h, qps = tx, []
        for tw in tws[:-1]:
            h = bt.bitmm2bit(h, tw, bits, backend="popcount")
            qps.append(h.qp)
        chains = {}
        for fused in (False, True):
            got = _chain(bt, api, tx, tws, qps, bits, backend="cuda", fused=fused)
            want = _chain(bt, api, tx, tws, qps, bits, backend="popcount",
                          fused=fused)
            if fused:
                expected["bitserial_fused"] += 2
                expected["bitserial_gemm"] += 1
            else:
                expected["bitserial_gemm"] += 3
            if got.shape != (x.shape[0], weights[-1].shape[1]) or \
                    not torch.equal(got, want):
                raise AssertionError(f"{bits}b fused={fused}: cuda engine != "
                                     f"popcount engine")
            chains[fused] = got
        first = first or ((tx, tws, qps), chains[True])
        # the adjacency product, with and without tile reuse (Fig. 9a)
        th = bt.to_bit(x, bits, pack_axis=0)
        before = dict(bitserial.LAUNCHES)
        reuse = bt.bitmm2int(ta, th)
        mid = dict(bitserial.LAUNCHES)
        no_reuse = bt.bitmm2int(ta, th, policy=api.ExecutionPolicy(reuse=False))
        after = dict(bitserial.LAUNCHES)
        expected["bitserial_gemm"] += 1
        expected["bgemm"] += bits
        if (mid["bitserial_gemm"] - before["bitserial_gemm"] != 1 or
                after["bgemm"] - mid["bgemm"] != bits or
                after["bitserial_gemm"] != mid["bitserial_gemm"]):
            raise AssertionError(f"{bits}b adjacency: launches {before} -> "
                                 f"{mid} -> {after}")
        if not torch.equal(reuse, no_reuse) or not torch.equal(
                reuse, bt.bitmm2int(ta, th, backend="popcount")):
            raise AssertionError(f"{bits}b adjacency: reuse=False != reuse=True")
        kept[bits] = ((tx, tws, qps, ta, th), chains, reuse)
        level_diff = (chains[True] - chains[False]).abs().max().item()
        emit(phase="tensor_api", bits=bits, nodes=x.shape[0],
             widths=[x.shape[1]] + [w.shape[1] for w in weights],
             to_bit_equals_bitpack=True, cuda_equals_popcount=True,
             reuse_equals_no_reuse=True, fused_vs_unfused_logits_max_abs=level_diff,
             card=card)
    launches = dict(bitserial.LAUNCHES)
    phase_kernels = ("bitserial_gemm", "bitserial_fused", "bgemm", "bitpack")
    if launches != expected or not all(launches[k] for k in phase_kernels):
        raise AssertionError(f"tensor API launches {launches}, expected {expected}")

    # one case on the CPU, where the cuda engine runs the plain versions:
    # the fused chain at BITS[0] gives the card's logits
    (tx, tws, qps), on_card = first

    def cpu_qp(qp):
        return None if qp is None else dataclasses.replace(
            qp, scale=qp.scale.cpu(), zero=qp.zero.cpu())

    def cpu(t):
        return dataclasses.replace(t, data=t.data.cpu(), qp=cpu_qp(t.qp))

    on_cpu = _chain(bt, api, cpu(tx), [cpu(t) for t in tws],
                    [cpu_qp(q) for q in qps], BITS[0], backend="cuda", fused=True)
    if not torch.equal(on_card.cpu(), on_cpu):
        raise AssertionError("tensor API: card != CPU")
    emit(phase="tensor_api_launches", launches=launches, expected=expected,
         card_equals_cpu_fused=BITS[0], card=card)
    return launches, kept


def phase_tensor_api_mxu(torch, card, kept):
    """The Tensor API's chain at mode="mxu" on the operands of phase 4, with
    fused_requantize off and on, and the adjacency product with reuse=True
    and reuse=False: each equal to the 'vpu' result of phase 4, through the
    mxu kernels alone. Returns the phase's launches."""
    from repro_torch import api
    from repro_torch.core import bittensor as bt
    from repro_torch.kernels import bitserial

    expected = dict.fromkeys(bitserial.LAUNCHES, 0)
    bitserial.reset_launches()
    for bits, ((tx, tws, qps, ta, th), chains, reuse) in kept.items():
        for fused in (False, True):
            got = _chain(bt, api, tx, tws, qps, bits, backend="cuda", fused=fused,
                         mode="mxu")
            if fused:
                expected["bitserial_fused_mxu"] += 2
                expected["bitserial_gemm_mxu"] += 1
            else:
                expected["bitserial_gemm_mxu"] += 3
            if not torch.equal(got, chains[fused]):
                raise AssertionError(f"{bits}b fused={fused}: mxu chain != vpu chain")
        mxu = api.ExecutionPolicy(mode="mxu")
        got_reuse = bt.bitmm2int(ta, th, policy=mxu)
        got_no_reuse = bt.bitmm2int(ta, th, policy=mxu.replace(reuse=False))
        expected["bitserial_gemm_mxu"] += 1
        expected["bgemm_mxu"] += bits
        if not (torch.equal(got_reuse, reuse) and torch.equal(got_no_reuse, reuse)):
            raise AssertionError(f"{bits}b adjacency at mxu != vpu")
        emit(phase="tensor_api", mode="mxu", bits=bits, chain_equals_vpu=True,
             fused_chain_equals_vpu=True, reuse_and_no_reuse_equal_vpu=True,
             card=card)
    launches = dict(bitserial.LAUNCHES)
    if launches != expected or not all(launches[k] for k in MXU_KERNELS):
        raise AssertionError(f"tensor API mxu launches {launches}, expected {expected}")
    emit(phase="tensor_api_launches", mode="mxu", launches=launches,
         expected=expected, card=card)
    return launches


def phase_timing(torch, card, rates, models, dbs, tiles):
    """fig7 per batch, and bitserial_gemm alone at the adjacency GEMM in both
    modes, 'vpu' and 'mxu' timed in turns. Returns {kernel: (ms, plain_ms,
    bound_ms, bound_by, library_ms)} for bitserial_gemm and its mxu twin."""
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.core import bitops, zerotile
    from repro_torch.kernels import bitserial, ops
    from repro_torch.models import gnn

    mxu = pol.replace(mode="mxu")

    for name, (cfg, params, per_bits) in models.items():
        runs = {
            "fp32_dense": lambda db: gnn.forward(params, db["adj"], db["x"],
                                                 db["inv_deg"], cfg),
            "fp32_csr": lambda db: gnn.forward(params, db["edges"], db["x"],
                                               db["inv_deg"], cfg,
                                               path="fp32_csr"),
        }
        for bits, (cfg_b, qp) in per_bits.items():
            runs[f"qgtc{bits}"] = (
                lambda db, cfg_b=cfg_b, qp=qp: gnn.forward_qgtc(
                    qp, db["adj"], db["x"], db["inv_deg"], cfg_b))
        for bits, (cfg_b, qp) in per_bits.items():
            runs[f"qgtc{bits}_mxu"] = (
                lambda db, cfg_b=cfg_b, qp=qp: gnn.forward_qgtc(
                    qp, db["adj"], db["x"], db["inv_deg"], cfg_b, policy=mxu))
        for path, fn in runs.items():
            per_batch = [time_ms(torch, lambda db=db: fn(db)) for db in dbs]
            emit(phase="fig7", model=name, path=path, unit="ms",
                 median_ms=statistics.median(per_batch), per_batch_ms=per_batch,
                 card=card)

    # the launch floor the kernel times are read against: an empty kernel
    # (torch.cuda._sleep(0)) under the same CUDA-graph harness
    floor_ms = graph_ms(torch, lambda: torch.cuda._sleep(0))
    emit(phase="launch_floor", graph_ms=floor_ms, kernel="torch.cuda._sleep(0)",
         card=card)
    # the kernel alone at the adjacency GEMM of the first batch: 1-bit
    # adjacency x 8-bit GCN hidden features (N = 16)
    db, tl = dbs[0], tiles[0]
    m = db["adj"].shape[0]
    n = models["qgtc-gcn"][0].hidden
    values = torch.randint(0, 256, (m, n), generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32).to(DEVICE)
    ap, bp = bitops.pack_a(db["adj"], 1), bitops.pack_b(values, 8)
    s, w, t = 1, ap.shape[2], 8
    a_f, v_f = db["adj"].float(), values.float()
    both = turns_ms(torch, {
        "vpu": lambda: ops.bitserial_gemm(ap, bp),
        "mxu": lambda: ops.bitserial_gemm(ap, bp, policy=mxu)})
    kernel_ms = both["vpu"]
    plain_ms = time_ms(torch, lambda: bitserial.bitserial_gemm_plain(
        ap, bp, block_m=pol.block_m, block_w=pol.block_w), reps=3)
    library_ms = graph_ms(torch, lambda: torch.matmul(a_f, v_f))
    if not torch.equal(torch.matmul(a_f, v_f).to(torch.int32),
                       ops.bitserial_gemm(ap, bp)):
        raise AssertionError("float32 matmul yardstick is not exact here")
    bound_ms, bound_by = bound(ap, t, n, rates)
    emit(phase="kernel_timing", kernel="bitserial_gemm", schedule="dense",
         shape=[s, m, w, t, n], ms=kernel_ms, plain_ms=plain_ms,
         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, card=card)
    mxu_bound = bound(ap, t, n, rates, tensor_cores=True)
    out = {"bitserial_gemm": (kernel_ms, plain_ms, bound_ms, bound_by, library_ms),
           "bitserial_gemm_mxu": (both["mxu"], plain_ms, *mxu_bound, library_ms)}
    emit(phase="kernel_timing", kernel="bitserial_gemm_mxu", schedule="dense",
         shape=[s, m, w, t, n], ms=both["mxu"], vpu_ms_in_turns=kernel_ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=mxu_bound[0],
         bound_by=mxu_bound[1], card=card)
    # the other schedules compute the same function: the same bound and the
    # same library yardstick; mask takes a precomputed occupancy map
    occ = zerotile.tile_occupancy_planes(
        bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w),
        pol.block_m, pol.block_w)
    jump_kw = {"mask": {"occupancy": occ}, "compact": {"tiles": tl["compact"]},
               "sgt": {"tiles": tl["sgt"]}}
    for sched, kw in jump_kw.items():
        ms = turns_ms(torch, {
            "vpu": lambda kw=kw: ops.bitserial_gemm(ap, bp, **kw),
            "mxu": lambda kw=kw: ops.bitserial_gemm(ap, bp, policy=mxu, **kw)})
        emit(phase="kernel_timing", kernel="bitserial_gemm", schedule=sched,
             shape=[s, m, w, t, n], ms=ms["vpu"], library_ms=library_ms,
             bound_ms=bound_ms, bound_by=bound_by, card=card)
        emit(phase="kernel_timing", kernel="bitserial_gemm_mxu", schedule=sched,
             shape=[s, m, w, t, n], ms=ms["mxu"], library_ms=library_ms,
             bound_ms=mxu_bound[0], bound_by=mxu_bound[1], card=card)
    # and at GIN's widest feature GEMM: 8-bit (M, 128) x 8-bit (128, 64)
    gen = torch.Generator().manual_seed(3)
    xq = torch.randint(0, 256, (m, 128), generator=gen, dtype=torch.int32)
    wq = torch.randint(0, 256, (128, 64), generator=gen, dtype=torch.int32)
    xp, wp = bitops.pack_a(xq, 8).to(DEVICE), bitops.pack_b(wq, 8).to(DEVICE)
    ms = turns_ms(torch, {
        "vpu": lambda: ops.bitserial_gemm(xp, wp),
        "mxu": lambda: ops.bitserial_gemm(xp, wp, policy=mxu)})
    ms_plain = time_ms(torch, lambda: bitserial.bitserial_gemm_plain(
        xp, wp, block_m=pol.block_m, block_w=pol.block_w), reps=3)
    # float32 is exact here: every sum is at most 255 * 255 * 128 < 2**24
    x32, w32 = xq.float().to(DEVICE), wq.float().to(DEVICE)
    x64, w64 = xq.double().to(DEVICE), wq.double().to(DEVICE)
    if not torch.equal(torch.matmul(x32, w32).to(torch.int32),
                       ops.bitserial_gemm(xp, wp, policy=mxu)):
        raise AssertionError("float32 matmul yardstick is not exact at GIN's GEMM")
    ms_lib = graph_ms(torch, lambda: torch.matmul(x32, w32))
    ms_lib64 = graph_ms(torch, lambda: torch.matmul(x64, w64))
    for name, mode_ms, (b_ms, b_by) in (
            ("bitserial_gemm", ms["vpu"], bound(xp, 8, 64, rates)),
            ("bitserial_gemm_mxu", ms["mxu"],
             bound(xp, 8, 64, rates, tensor_cores=True))):
        emit(phase="kernel_timing", kernel=name, schedule="dense",
             shape=list(xp.shape) + [8, 64], ms=mode_ms, plain_ms=ms_plain,
             library_ms=ms_lib, library_ms_float64=ms_lib64, bound_ms=b_ms,
             bound_by=b_by, launch_floor_ms=floor_ms, card=card)
    return out


def phase_new_kernel_timing(torch, card, rates, models, dbs):
    """Each new kernel alone at its Tensor API shape on batch 0; the fused
    and 1-bit kernels in both modes, timed in turns. Returns {kernel: (ms,
    plain_ms, bound_ms, bound_by, library_ms)}."""
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.core import bitops, bittensor as bt
    from repro_torch.core.quantize import calibrate
    from repro_torch.kernels import bgemm, bitpack, bitserial, ops

    db = dbs[0]
    x, adj = db["x"], db["adj"]
    m, k = x.shape
    w0 = models["qgtc-gcn"][1]["layer0"]["w"]
    n = w0.shape[1]
    out = {}

    # bitserial_fused at the first bitmm2bit: 8-bit (2304, 128) @ (128, 16)
    tx, tw = bt.to_bit(x, 8, pack_axis=1), bt.to_bit(w0, 8, pack_axis=0)
    qp = calibrate(bt.bitmm2int(tx, tw, backend="popcount").float(), 8)
    alpha = (1.0 / qp.scale).broadcast_to((m, 1)).contiguous()
    beta = (-qp.zero / qp.scale).broadcast_to((1, n)).contiguous()
    ap, bp = tx.data, tw.data
    a_pad = bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w)
    b_pad = bitops.pad_to(bp, 1, pol.block_w)
    al = bitops.pad_to(alpha, 0, pol.block_m)

    def fused(policy=pol):
        return ops.bitserial_fused(ap, bp, alpha, beta, out_bits=8, relu=False,
                                   policy=policy)

    def unfused():
        return bitserial.fused_epilogue(ops.bitserial_gemm(ap, bp), alpha, beta,
                                        8, False)

    mxu = pol.replace(mode="mxu")
    if not torch.equal(fused(), unfused()) or not torch.equal(fused(mxu), fused()):
        raise AssertionError("fused kernel != bitserial_gemm + torch epilogue")
    ms = turns_ms(torch, {"vpu": fused, "mxu": lambda: fused(mxu)})
    unfused_ms = graph_ms(torch, unfused)
    plain_ms = time_ms(torch, lambda: bitserial.bitserial_fused_plain(
        a_pad, b_pad, al, beta, out_bits=8, relu=False, block_m=pol.block_m,
        block_w=pol.block_w), reps=3)
    for name, mode in (("bitserial_fused", "vpu"), ("bitserial_fused_mxu", "mxu")):
        b_ms, b_by = bound(ap, 8, n, rates, fused=True,
                           tensor_cores=mode == "mxu")
        out[name] = (ms[mode], plain_ms, b_ms, b_by, None)
        emit(phase="kernel_timing", kernel=name, schedule="dense",
             shape=list(ap.shape) + [8, n], ms=ms[mode], plain_ms=plain_ms,
             unfused_ms=unfused_ms, library_ms=None, bound_ms=b_ms,
             bound_by=b_by, card=card)

    # bgemm at one plane pair of the adjacency product: the 1-bit
    # (2304, 2304) adjacency x the top plane of the 8-bit features
    a1 = bitops.pack_a(adj, 1)[0]
    plane = bt.to_bit(x, 8, pack_axis=0).data[7]
    plane_vals = bitops.unpack_along_axis(plane, dim=0, size=adj.shape[1])
    a_f, p_f = adj.float(), plane_vals.float()
    lib_out = torch.matmul(a_f, p_f).to(torch.int32)
    if not (torch.equal(lib_out, ops.bgemm(a1, plane)) and
            torch.equal(lib_out, ops.bgemm(a1, plane, policy=mxu))):
        raise AssertionError("bgemm != float32 matmul of the 0/1 values")
    ms = turns_ms(torch, {"vpu": lambda: ops.bgemm(a1, plane),
                          "mxu": lambda: ops.bgemm(a1, plane, policy=mxu)})
    plain_ms = time_ms(torch, lambda: bgemm.bgemm_plain(
        a1, plane, block_m=pol.block_m, block_w=pol.block_w), reps=3)
    library_ms = graph_ms(torch, lambda: torch.matmul(a_f, p_f))
    for name, mode in (("bgemm", "vpu"), ("bgemm_mxu", "mxu")):
        b_ms, b_by = bound(a1[None], 1, plane.shape[1], rates,
                           tensor_cores=mode == "mxu")
        out[name] = (ms[mode], plain_ms, b_ms, b_by, library_ms)
        emit(phase="kernel_timing", kernel=name, schedule="dense",
             shape=list(a1.shape) + [plane.shape[1]], ms=ms[mode],
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
             bound_by=b_by, card=card)

    # bitpack of the features at 8 bits, as to_bit quantizes them
    scale, zero = tx.qp.scale, tx.qp.zero
    packed = ops.bitpack(x, scale, zero, nbits=8)
    words = packed.shape[2]
    ms = graph_ms(torch, lambda: ops.bitpack(x, scale, zero, nbits=8))
    plain_ms = time_ms(torch, lambda: bitpack.bitpack_plain(
        x, scale, zero, nbits=8, words=words), reps=3)
    b_ms, b_by = pack_bound(m, k, 8, words)
    out["bitpack"] = (ms, plain_ms, b_ms, b_by, None)
    emit(phase="kernel_timing", kernel="bitpack", shape=[m, k, 8, words],
         ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
         bound_by=b_by, card=card)
    return out


def pack_bytes(m, k, nbits, words) -> int:
    """bitpack's bytes: x read, scale and zero, the planes written."""
    return 4 * m * k + 8 + 4 * nbits * m * words


def pack_bound(m, k, nbits, words) -> tuple[float, str]:
    """bitpack's least time (ms) and what bounds it: its bytes, and five
    operations an element (subtract, divide, floor, two clips) and one a
    bit a word."""
    return roofline(pack_bytes(m, k, nbits, words),
                    5 * m * k + nbits * m * words)


def phase_bitpack_timing(torch, card):
    """bitpack alone at PACK_GRAPHS: random normal x, scale and zero from
    calibrate, ops.bitpack's words; ms under a CUDA graph of 50 calls beside
    the bound and its share, and the plain version (a slice of rows at a
    time)."""
    from repro_torch.core.quantize import calibrate
    from repro_torch.kernels import ops

    for name, (m, k), widths in _pack_graphs():
        x = torch.randn((m, k), generator=torch.Generator(device=DEVICE)
                        .manual_seed(m), device=DEVICE)
        words = pack_words(k)
        for nbits in widths:
            qp = calibrate(x, nbits)
            ms = graph_ms(torch, lambda: ops.bitpack(x, qp.scale, qp.zero,
                                                     nbits=nbits))
            plain_ms = time_ms(torch, lambda: _bitpack_plain_slices(
                torch, x, qp.scale, qp.zero, nbits, words), warmup=1, reps=1,
                repeats=3)
            b_ms, b_by = pack_bound(m, k, nbits, words)
            nbytes = pack_bytes(m, k, nbits, words)
            emit(phase="bitpack_timing", graph=name, shape=[m, k, nbits, words],
                 path="16-byte" if k % 4 == 0 else "4-byte", ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 share_of_bound=b_ms / ms, bytes=nbytes,
                 l2_resident=nbytes < L2_BYTES, card=card)
        del x


def phase_fig9a(torch, card, dbs):
    """Paper Fig. 9a on the card: the adjacency product with tile reuse
    (one bitserial_gemm) and without (one bgemm per plane pair)."""
    from repro_torch import api
    from repro_torch.core import bitops
    from repro_torch.kernels import bitserial

    adj = dbs[0]["adj"]
    m = adj.shape[0]
    gen = torch.Generator().manual_seed(5)
    reuse, no_reuse = api.ExecutionPolicy(), api.ExecutionPolicy(reuse=False)
    for a_name, a in (("batch0_adjacency", adj), ("all_ones", torch.ones_like(adj))):
        ap = bitops.pack_a(a, 1)
        for bits in (2, 4, 8):
            xq = torch.randint(0, 1 << bits, (m, 128), generator=gen,
                               dtype=torch.int32).to(DEVICE)
            xp = bitops.pack_b(xq, bits)
            runs = {"reuse": lambda: api.bitserial_mm_packed(ap, xp, policy=reuse),
                    "no_reuse": lambda: api.bitserial_mm_packed(ap, xp,
                                                                policy=no_reuse)}
            launches = {}
            for name, fn in runs.items():
                before = dict(bitserial.LAUNCHES)
                fn()
                launches[name] = {k: v - before[k]
                                  for k, v in bitserial.LAUNCHES.items()
                                  if v != before[k]}
            if launches != {"reuse": {"bitserial_gemm": 1},
                            "no_reuse": {"bgemm": bits}}:
                raise AssertionError(f"fig9a launches: {launches}")
            if not torch.equal(runs["reuse"](), runs["no_reuse"]()):
                raise AssertionError(f"fig9a {a_name} {bits}b: results differ")
            # in turns: reuse, no_reuse, no_reuse, reuse
            order = ("reuse", "no_reuse", "no_reuse", "reuse")
            ev = {name: [] for name in runs}
            for name in order:
                ev[name].append(time_ms(torch, runs[name]))
            graph = {name: graph_ms(torch, fn) for name, fn in runs.items()}
            ms = {name: statistics.median(v) for name, v in ev.items()}
            emit(phase="fig9a", a=a_name, bits=bits, shape=[m, m, 128],
                 reuse_ms=ms["reuse"], no_reuse_ms=ms["no_reuse"],
                 ratio=ms["no_reuse"] / ms["reuse"],
                 reuse_graph_ms=graph["reuse"], no_reuse_graph_ms=graph["no_reuse"],
                 turns_ms=ev, launches=launches, card=card)


def phase_profile(torch, card, models, dbs, reps=5):
    """Where one qgtc forward's time goes: host wall time per forward, the
    device time of the kernels it launches (torch.profiler), and the device's
    idle share; in both compute modes. ``gemm_kernel_ms`` is the device time
    of the bit-serial kernel alone (bitserial_tile_kernel at 'vpu',
    bitserial_mma_kernel at 'mxu')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.models import gnn

    db = dbs[0]
    for (name, (_, _, per_bits)), mode in itertools.product(models.items(),
                                                            ("vpu", "mxu")):
        cfg_b, qp = per_bits[8]
        pol = api.ExecutionPolicy(mode=mode)
        kernel = "bitserial_mma_kernel" if mode == "mxu" else "bitserial_tile_kernel"

        def fn():
            return gnn.forward_qgtc(qp, db["adj"], db["x"], db["inv_deg"], cfg_b,
                                    policy=pol)

        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        gemm = [e for e in kernels if kernel in e.key]
        emit(phase="profile", model=name, bits=8, mode=mode, host_wall_ms=wall_ms,
             device_ms=device_ms if kernels else "not measured",
             gemm_kernel_ms=(sum(e.self_device_time_total for e in gemm) / 1e3 / reps
                             if gemm else "not measured"),
             gemm_kernel_launches_per_forward=sum(e.count for e in gemm) / reps,
             device_idle_share=(1 - device_ms / wall_ms) if kernels else "not measured",
             device_ops_per_forward=sum(e.count for e in kernels) / reps,
             top_device_ms=[[e.key[:60], e.self_device_time_total / 1e3 / reps,
                             e.count // reps] for e in top],
             card=card)


def _wq_bound_check(torch, got, x, w64, w64_abs, what) -> float:
    """Hold ``got`` to the float32 dot-product error bound around the
    float64 product of ``x`` and the dequantized weight ``w64``:
    |got - x @ W| <= K * 2^-24 * (|x| @ |W|), which holds in any summation
    order. Returns the largest ratio of error to bound."""
    x64 = x.double()
    exact = x64 @ w64
    if got.shape != exact.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: bad shape or values")
    bnd = x.shape[1] * 2.0 ** -24 * (x64.abs() @ w64_abs)
    err = (got.double() - exact).abs()
    if bool((err > bnd).any()):
        raise AssertionError(f"{what}: error above the float32 bound "
                             f"(max {err.max().item()})")
    return (err / bnd.clamp_min(1e-300)).max().item()


def phase_wq_gemm_vs_plain(torch, card) -> float:
    """wq_gemm and its plain version on the same CUDA tensors, each held to
    the float32 error bound: every shape, group and x dtype at the default
    tiles and at WQ_BLOCKS, and with x scaled by 2^20 and 2^-20 at the
    default tiles. Then a row's result at every M of WQ_M_ROWS, bit for bit.
    Returns the largest |kernel - plain|."""
    from repro_torch.kernels import ops, wqmm
    from repro_torch.kernels._build import LAUNCHES

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    max_err, max_ratio, checks = 0.0, 0.0, 0

    def launch(x, wp, sc, group, blocks, what):
        before = LAUNCHES["wq_gemm"]
        got = ops.wq_gemm(x, wp, sc, group=group, block_m=blocks[0],
                          block_n=blocks[1], block_k=blocks[2])
        if LAUNCHES["wq_gemm"] != before + 1:
            raise AssertionError(f"{what}: the kernel did not launch")
        return got

    for m, k, n in WQ_SHAPES:
        for group in WQ_GROUPS:
            w = torch.randn((k, n), generator=gen, device=DEVICE)
            wp, sc = wqmm.pack_w4(w, group)
            w64 = wqmm.unpack_w4(wp, sc, group).double()
            w64_abs = w64.abs()
            for dtype in (torch.float32, torch.bfloat16):
                x1 = torch.randn((m, k), generator=gen, device=DEVICE)
                for scale in WQ_X_SCALES:
                    x = (x1 * scale).to(dtype)
                    what = f"wq_gemm {(m, k, n)} group={group} {dtype} x*{scale}"
                    plain = wqmm.wq_gemm_plain(x, wp, sc, group=group)
                    max_ratio = max(max_ratio, _wq_bound_check(
                        torch, plain, x, w64, w64_abs, f"plain {what}"))
                    for blocks in WQ_BLOCKS if scale == 1.0 else WQ_BLOCKS[:1]:
                        got = launch(x, wp, sc, group, blocks, what)
                        max_ratio = max(max_ratio, _wq_bound_check(
                            torch, got, x, w64, w64_abs,
                            f"kernel {what} blocks {blocks}"))
                        if scale == 1.0:
                            max_err = max(max_err, (got - plain).abs().max().item())
                        checks += 1
            del w64, w64_abs
    # a row's result does not depend on M
    k, n = D_MODEL, D_MODEL
    wp, sc = wqmm.pack_w4(torch.randn((k, n), generator=gen, device=DEVICE) * 0.02)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((max(WQ_M_ROWS), k), generator=gen, device=DEVICE).to(dtype)
        full = launch(x, wp, sc, 32, WQ_BLOCKS[0], f"rows {dtype}")
        for m in WQ_M_ROWS:
            got = launch(x[:m].contiguous(), wp, sc, 32, WQ_BLOCKS[0], f"rows {dtype}")
            torch.cuda.synchronize()
            if not torch.equal(got, full[:m]):
                raise AssertionError(f"wq_gemm rows at M={m} {dtype} differ from "
                                     f"the same rows at M={max(WQ_M_ROWS)}")
            checks += 1
    emit(phase="kernel_vs_plain", kernel="wq_gemm", checks=checks,
         shapes=[list(x) for x in WQ_SHAPES], groups=list(WQ_GROUPS),
         blocks=[list(b) for b in WQ_BLOCKS], x_dtypes=["float32", "bfloat16"],
         x_scales=list(WQ_X_SCALES), within_float32_bound=True,
         max_err_over_bound=max_ratio, max_abs_err=max_err,
         rows_bit_equal_at_m=list(WQ_M_ROWS), card=card)
    return max_err


def phase_weight_only(torch, card):
    """codeqwen1.5-7b's decode projections at full width through
    kernels.ops.wq_gemm; wq_linear on the cuda engine against the port on
    the CPU; quantize_lm_params over one layer, embed and lm_head. Returns
    the wq_gemm launches and the packed gate and head weights for timing."""
    from repro_torch.api import nn
    from repro_torch.core.qgemm import (WeightQ, weight_dequantize,
                                        weight_quantize)
    from repro_torch.kernels import ops, wqmm
    from repro_torch.kernels._build import LAUNCHES, reset_launches

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    weights = {name: torch.randn(shape, generator=gen, device=DEVICE) * 0.02
               for name, shape in CODEQWEN_PROJ.items()}
    x_dtypes = (torch.float32, torch.bfloat16)

    # the path: every projection at every batch, x in float32 and bf16
    reset_launches()
    calls, max_ratio, packed = 0, 0.0, {}
    for name, w in weights.items():
        wp, sc = wqmm.pack_w4(w)
        w64 = wqmm.unpack_w4(wp, sc, 32).double()
        w64_abs = w64.abs()
        for m in WQ_BATCHES:
            x32 = torch.randn((m, w.shape[0]), generator=gen, device=DEVICE)
            for dtype in x_dtypes:
                x = x32.to(dtype)
                got = ops.wq_gemm(x, wp, sc)
                calls += 1
                max_ratio = max(max_ratio, _wq_bound_check(
                    torch, got, x, w64, w64_abs, f"{name} M={m} {dtype}"))
        if name in ("wg", "lm_head"):
            packed[name] = (wp, sc)
        del w64, w64_abs
    launches = dict(LAUNCHES)
    if launches["wq_gemm"] != calls or any(
            v for kernel, v in launches.items() if kernel != "wq_gemm"):
        raise AssertionError(f"weight-only launches {launches}, expected "
                             f"{calls} of wq_gemm alone")
    emit(phase="weight_only", model="codeqwen1.5-7b",
         projections={k: list(v) for k, v in CODEQWEN_PROJ.items()},
         batches=list(WQ_BATCHES), x_dtypes=["float32", "bfloat16"], group=32,
         calls=calls, launches=launches["wq_gemm"], within_float32_bound=True,
         max_err_over_bound=max_ratio, card=card)

    # wq_linear over a 4-bit WeightQ: the cuda engine's float product
    # launches no kernel; it and the port on the CPU (torch_dot) are each
    # held to the float32 bound of the affine product around float64
    u, max_lin, max_card_cpu = 2.0 ** -24, 0.0, 0.0
    for name, w in weights.items():
        k = w.shape[0]
        wq = weight_quantize(w, 4)
        wq_cpu = WeightQ(wq.data.cpu(), wq.scale.cpu(), wq.zero.cpu(), 4)
        d64, s64, z64 = wq.data.double(), wq.scale.double(), wq.zero.double()
        d64_abs = d64.abs()
        for m in WQ_BATCHES:
            x = torch.randn((m, k), generator=gen, device=DEVICE)
            before = dict(LAUNCHES)
            on_card = nn.wq_linear(x, wq, out_dtype=torch.float32, backend="cuda")
            if dict(LAUNCHES) != before:
                raise AssertionError(f"wq_linear {name} M={m} launched a kernel")
            on_cpu = nn.wq_linear(x.cpu(), wq_cpu, out_dtype=torch.float32,
                                  backend="torch_dot").to(DEVICE)
            x64 = x.double()
            core, rowsum = x64 @ d64, x64.sum(-1, keepdim=True)
            exact = core * s64 + rowsum * z64
            bnd = (k * u * ((x64.abs() @ d64_abs) * s64.abs()
                            + x64.abs().sum(-1, keepdim=True) * z64.abs())
                   + 3 * u * ((core * s64).abs() + (rowsum * z64).abs()))
            for where, y in (("card", on_card), ("cpu", on_cpu)):
                err = (y.double() - exact).abs()
                if y.shape != exact.shape or bool((err > bnd).any()):
                    raise AssertionError(f"wq_linear {name} M={m} on the {where}: "
                                         f"error above the float32 bound")
                max_lin = max(max_lin, (err / bnd.clamp_min(1e-300)).max().item())
            max_card_cpu = max(max_card_cpu, (on_card - on_cpu).abs().max().item())
        del d64, d64_abs
    emit(phase="wq_linear", model="codeqwen1.5-7b", nbits=4, engine="cuda",
         batches=list(WQ_BATCHES), launches=0, within_float32_bound=True,
         max_err_over_bound=max_lin, card_vs_cpu_max_abs=max_card_cpu, card=card)

    # quantize_lm_params over one layer's projections, embed and lm_head
    params = {"embed": torch.randn((VOCAB, D_MODEL), generator=gen,
                                   device=DEVICE) * 0.02,
              "lm_head": weights["lm_head"],
              "layer0": {k: v for k, v in weights.items() if k != "lm_head"}}
    params_q, stats = nn.quantize_lm_params(params, nbits=4)
    if stats["n_quantized"] != len(weights) or params_q["embed"] is not params["embed"]:
        raise AssertionError(f"quantize_lm_params: {stats}")
    max_steps = 0.0
    for name, w in weights.items():
        got = params_q[name] if name == "lm_head" else params_q["layer0"][name]
        wq = weight_quantize(w, 4)
        if not torch.equal(got, weight_dequantize(wq)):
            raise AssertionError(f"quantize_lm_params {name}: not the round trip")
        # floor quantization: within one step, plus float32 rounding
        steps = ((got - w).abs() / wq.scale).max().item()
        if steps > 1 + 1e-5:
            raise AssertionError(f"quantize_lm_params {name}: {steps} steps off")
        max_steps = max(max_steps, steps)
    emit(phase="quantize_lm_params", model="codeqwen1.5-7b", nbits=4,
         stats=stats, max_err_in_steps=max_steps, card=card)
    return launches["wq_gemm"], packed


def phase_wq_timing(torch, card, packed) -> dict:
    """wq_gemm alone at the gate projection and lm_head, batch 1, 8 and
    128, x in float32 and in bf16. A weight that would stay in L2 is timed
    in turns over enough copies to exceed it: a decode step reads each
    layer's weight once. Beside each: the plain version (float32 x), float32
    and bf16 torch.matmul of the dequantized weight, and the bound with the
    tensor-core passes it counts (``wq_bound``) and the CUDA-core bound the
    first kernel was held to. Returns {(weight, M): (ms, plain_ms, bound_ms,
    bound_by, library_ms)} for float32 x."""
    from repro_torch.kernels import ops, wqmm

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    out = {}
    for name, (wp, sc) in packed.items():
        k, n = wp.shape[0], 2 * wp.shape[1]
        w_bytes = wp.numel() + 4 * sc.numel()
        copies = max(1, math.ceil(2 * L2_BYTES / w_bytes))
        pool = [(wp, sc)] + [(wp.clone(), sc.clone()) for _ in range(copies - 1)]
        w32 = wqmm.unpack_w4(wp, sc, 32)
        w16 = w32.to(torch.bfloat16)
        for m in WQ_BATCHES:
            x = torch.randn((m, k), generator=gen, device=DEVICE)
            x16 = x.to(torch.bfloat16)
            turn = itertools.cycle(pool)
            ms = graph_ms(torch, lambda: ops.wq_gemm(x, *next(turn)))
            ms16 = graph_ms(torch, lambda: ops.wq_gemm(x16, *next(turn)))
            plain_ms = time_ms(torch, lambda: wqmm.wq_gemm_plain(x, wp, sc, group=32),
                               reps=3)
            library_ms = graph_ms(torch, lambda: torch.matmul(x, w32))
            library_bf16_ms = graph_ms(torch, lambda: torch.matmul(x16, w16))
            bnd = wq_bound(m, k, n, w_bytes, 4)
            out[(name, m)] = (ms, plain_ms, bnd["bound_ms"], bnd["bound_by"],
                              library_ms)
            emit(phase="kernel_timing", kernel="wq_gemm", weight=name,
                 shape=[m, k, n], x_dtype="float32", group=32, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 library_bf16_ms=library_bf16_ms, **bnd,
                 weight_copies=copies, card=card)
            emit(phase="kernel_timing", kernel="wq_gemm", weight=name,
                 shape=[m, k, n], x_dtype="bfloat16", group=32, ms=ms16,
                 library_bf16_ms=library_bf16_ms, **wq_bound(m, k, n, w_bytes, 2),
                 weight_copies=copies, card=card)
        del pool, w32, w16
    return out


@contextlib.contextmanager
def no_fallback():
    """Run a path with the registry's fallback warning as an error: every op
    must run on the engine the path asks for. The registry warns once per
    (engine, op, fallback), so the record of earlier warnings is cleared."""
    from repro_torch.api import registry

    registry._warned_fallbacks.clear()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*falling back",
                                category=RuntimeWarning)
        yield


def phase_packing(torch, card, batch, db):
    """Paper §4.6 on the card: the four transfers of ``batch`` (the main
    path's batch 0) and of a copy whose edge list is one column longer, an
    odd length, at PACKING_BITS. Every result is held to the host's arrays
    and to ``db`` (make_device_batch's), and the unpacked planes, a view at
    word 8 + 2 e_cap of the copied buffer, are fed as A to the bit-serial
    GEMM in both modes and held to the plain engine."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core import bitops
    from repro_torch.graph import packing
    from repro_torch.kernels import bitserial

    odd = dataclasses.replace(batch, edges=np.concatenate(
        [batch.edges, -np.ones((2, 1 + batch.edges.shape[1] % 2), np.int32)], 1))
    gen = torch.Generator().manual_seed(21)
    feats = torch.from_numpy(batch.features)
    for b in (batch, odd):
        e_cap = b.edges.shape[1]
        adj_i, f_i = packing.transfer_dense(b, device=DEVICE)
        adj_ii, f_ii = packing.transfer_sparse(b, device=DEVICE)
        if not (torch.equal(adj_i, db["adj"]) and torch.equal(adj_ii, adj_i)):
            raise AssertionError(f"packing e_cap={e_cap}: I/II adjacency differs")
        if not (torch.equal(f_i.cpu(), feats) and torch.equal(f_ii.cpu(), feats)):
            raise AssertionError(f"packing e_cap={e_cap}: features differ")
        for nbits in PACKING_BITS:
            adj_iii, planes, meta = packing.transfer_packed(b, nbits, device=DEVICE)
            only, fmeta = packing.transfer_packed_feats(b, nbits, device=DEVICE)
            if not torch.equal(adj_iii, adj_i):
                raise AssertionError(f"packing {nbits}b e_cap={e_cap}: III "
                                     f"adjacency differs from I's")
            buf, _ = packing.pack_compound(b, nbits)
            host = torch.from_numpy(buf[8 + 2 * e_cap:]).view(planes.shape)
            if not (torch.equal(planes.cpu(), host) and torch.equal(only.cpu(), host)):
                raise AssertionError(f"packing {nbits}b e_cap={e_cap}: unpacked "
                                     f"planes differ from the host's words")
            # the first layer's GEMM of qgtc-gcn, X (n, 128) @ W (128, 16)
            w = torch.randint(0, 1 << nbits, (meta["d"], 16), generator=gen,
                              dtype=torch.int32).to(DEVICE)
            wp = bitops.pack_b(w, nbits)
            want = api.bitserial_mm_packed(planes, wp, backend="popcount")
            launched = {}
            for mode in ("vpu", "mxu"):
                before = dict(bitserial.LAUNCHES)
                got = api.bitserial_mm_packed(planes, wp, backend="cuda",
                                              policy=api.ExecutionPolicy(mode=mode))
                launched[mode] = {k: v - before[k] for k, v in
                                  bitserial.LAUNCHES.items() if v != before[k]}
                if not torch.equal(got, want):
                    raise AssertionError(f"packing {nbits}b e_cap={e_cap} "
                                         f"{mode}: GEMM on the planes != plain")
            if launched != {"vpu": {"bitserial_gemm": 1},
                            "mxu": {"bitserial_gemm_mxu": 1}}:
                raise AssertionError(f"packing GEMM launches {launched}")
            emit(phase="packing", nbits=nbits, nodes=b.n_nodes, e_cap=e_cap,
                 planes_byte_offset=4 * (8 + 2 * e_cap),
                 planes_addr_mod16=planes.data_ptr() % 16,
                 adjacency_equal=True, planes_equal_host=True,
                 gemm_equal_plain={"vpu": True, "mxu": True},
                 launches=launched, bytes=packing.compound_nbytes(b, nbits),
                 card=card)


def _quiet(fn, **kw):
    """``fn(**kw)`` with the CSV a figure suite prints kept off stdout."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(**kw)


def phase_fig9b(torch, card, arxiv_batch):
    """Paper Fig. 9b on the card: the three strategies and the features-only
    buffer, end to end, on the main path's batch 0 and on an ogbn-products
    batch of >= 2048 nodes, with III's split and the share of the link."""
    from repro_torch.benchmarks import common, fig9b_transfer
    from repro_torch.graph import batching, datasets, partition

    t0 = time.perf_counter()
    data = datasets.load("ogbn-products", scale=PRODUCTS_SCALE, seed=0)
    parts = partition.partition(data.csr, PRODUCTS_PARTS)
    products = batching.make_batches(data, parts, BATCH_PARTS)[0]
    if products.n_nodes < 2048:
        raise AssertionError(f"ogbn-products batch of {products.n_nodes} nodes")
    link = fig9b_transfer.link_peak_bytes_s(DEVICE)
    emit(phase="fig9b_setup", products_scale=PRODUCTS_SCALE,
         products_parts=PRODUCTS_PARTS, products_nodes=products.n_nodes,
         products_edges=int(products.edges.shape[1]),
         arxiv_nodes=arxiv_batch.n_nodes,
         arxiv_edges=int(arxiv_batch.edges.shape[1]),
         link_peak_GB_s=link / 1e9, setup_s=time.perf_counter() - t0, card=card)
    start = len(common.RECORDS)
    _quiet(fig9b_transfer.run, batches={"ogbn-arxiv": arxiv_batch,
                                        "ogbn-products": products},
           nbits=8, device=DEVICE, link_bytes_s=link)
    records = common.RECORDS[start:]
    for r in records:
        emit(phase="fig9b", **r, card=card)
    ms = {r["name"]: r["value"] for r in records}
    for name in ("ogbn-arxiv", "ogbn-products"):
        order = sorted(("I_dense", "II_sparse", "III_packed"),
                       key=lambda k: ms[f"fig9b_{name}_{k}"])
        emit(phase="fig9b_order", graph=name, fastest_first=order, card=card)


def phase_figures(torch, card):
    """The paper-figure suites at the reference's default sizes, on the
    card; each record echoed. A suite's failed check raises. Table 2 runs
    in the training phase."""
    from repro_torch.benchmarks import run

    t0 = time.perf_counter()
    figures = [name for name, _ in run.SUITES if name != "table2"]
    records = _quiet(run.main, device=DEVICE, suites=figures)
    for r in records:
        emit(phase="figures", **r, card=card)
    suites = sorted({r["suite"] for r in records})
    if suites != sorted(figures):
        raise AssertionError(f"figures: suites that ran {suites}")
    emit(phase="figures_done", suites=suites, records=len(records),
         seconds=time.perf_counter() - t0, card=card)


def int_launches_per_step(layers: int, blocks: int, grad_bits: int) -> int:
    """Bit-serial GEMM launches of one int_bitserial step of a GCN: forward,
    each layer's feature GEMM and one GEMM per diagonal block; with
    grad_bits, each layer's weight-gradient GEMM, its input-gradient GEMM
    (not at layer 0, whose input needs no gradient) and one GEMM per
    transposed block."""
    forward = layers * (1 + blocks)
    if not grad_bits:
        return forward
    return forward + layers + (layers - 1) + layers * blocks


def int_step(torch, params, db, cfg, gen_state, *, grad_bits, stochastic,
             device):
    """One int_bitserial step on the active engine, from ``params``, fresh
    AdamW state and a ``device`` generator at ``gen_state`` (trainer.train's
    update): [loss, gradients..., updated params..., first moments...,
    second moments...], in the params' order."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    names = [(layer, k) for layer in params for k in params[layer]]
    p = {layer: {k: v.detach().requires_grad_() for k, v in ps.items()}
         for layer, ps in params.items()}
    loss, _ = trainer.loss_fn(p, db, cfg, False, "int_bitserial", grad_bits,
                              stochastic, gen if stochastic else None)
    gs = torch.autograd.grad(loss, [p[layer][k] for layer, k in names])
    grads = {layer: {} for layer in params}
    for (layer, k), g in zip(names, gs):
        grads[layer][k] = g
    new, state = opt.adamw_update(params, grads, opt.adamw_init(params),
                                  opt.AdamWConfig(**TRAIN_OPT))
    return ([loss.detach(), *gs] + [new[layer][k] for layer, k in names]
            + [state[m][layer][k] for m in ("mu", "nu") for layer, k in names])


def _int_dbatch(torch, batch, art):
    return {"art": art, "y": torch.as_tensor(batch.labels, device=DEVICE),
            "mask": torch.as_tensor(batch.train_mask, device=DEVICE)}


def phase_training(torch, card, data, parts):
    """Cluster-GCN training at full width (phase 13). Returns the bit-serial
    GEMM launches of the three trainer.train runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.api import nn
    from repro_torch.benchmarks import run
    from repro_torch.kernels import bitserial
    from repro_torch.models import gnn
    from repro_torch.train import intpath, trainer
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    batches = trainer.prepare_batches(data, parts, batch_size=BATCH_PARTS)
    bp, rp = intpath.batch_caps(batches)
    blocks = {len(b.part_sizes) for b in batches}
    if blocks != {BATCH_PARTS}:
        raise AssertionError(f"training batches of {blocks} parts")
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes,
                                  TRAIN_BITS, TRAIN_BITS)
    arts = [intpath.build_artifacts(b, TRAIN_BITS, block_pad=bp, rem_pad=rp,
                                    device=DEVICE) for b in batches[:2]]
    emit(phase="training_setup", model="qgtc-gcn", widths=[cfg.in_dim, cfg.hidden,
                                                          cfg.hidden, cfg.n_classes],
         batches=len(batches), batch_nodes=batches[0].n_nodes,
         e_cap=int(batches[0].edges.shape[1]), blocks=BATCH_PARTS, block_pad=bp,
         rem_pad=rp, cross_edges=[int((a.rem_src >= 0).sum()) for a in arts],
         seconds=time.perf_counter() - t_phase, card=card)

    # the decomposition is exact: blocks + remainder == the dense product
    gen = torch.Generator().manual_seed(13)
    for b, art in zip(batches[:2], arts):
        adj = trainer.make_device_batch(b, device=DEVICE)["adj"].to(torch.float64)
        tiled = intpath.build_artifacts(b, TRAIN_BITS, block_pad=bp, rem_pad=rp,
                                        with_tiles=True, device=DEVICE)
        for bits in (1, 4, 8):
            vq = torch.randint(0, 1 << bits, (b.n_nodes, cfg.hidden),
                               generator=gen, dtype=torch.int32).to(DEVICE)
            want = (adj @ vq.to(torch.float64)).to(torch.int32)
            for mode, a in itertools.product(("vpu", "mxu"), (art, tiled)):
                got = nn.blocked_agg_full(
                    a.adjb, a.row_idx, a.rem_src, a.rem_dst, vq, bits,
                    backend="cuda", policy=api.ExecutionPolicy(mode=mode),
                    tiles=a.tiles, s_maxes=a.s_maxes)
                if not torch.equal(got, want):
                    raise AssertionError(f"blocked aggregate {bits}b {mode} "
                                         f"tiles={a.tiles is not None} != dense")
    emit(phase="training_blocked_aggregate", batches=2, bits=[1, 4, 8],
         modes=["vpu", "mxu"], tiles=[False, True], equal_dense=True, card=card)

    # one int step on the kernels against the same step on the plain engine
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device=DEVICE)
    db = _int_dbatch(torch, batches[0], arts[0])
    gen_state = torch.Generator(device=DEVICE).manual_seed(0x5eed).get_state()
    for mode, (grad_bits, sr) in itertools.product(("vpu", "mxu"), TRAIN_EQUAL):
        kernel = bitserial.kernel_name("bitserial_gemm", mode)
        bitserial.reset_launches()
        with api.use("cuda", policy=api.ExecutionPolicy(mode=mode)):
            got = int_step(torch, params, db, cfg, gen_state, grad_bits=grad_bits,
                           stochastic=sr, device=DEVICE)
        torch.cuda.synchronize()
        launched = {k: v for k, v in bitserial.LAUNCHES.items() if v}
        bitserial.reset_launches()
        with api.use("torch_dot"):
            want = int_step(torch, params, db, cfg, gen_state, grad_bits=grad_bits,
                            stochastic=sr, device=DEVICE)
        torch.cuda.synchronize()
        # the backward runs on autograd's own thread: it must keep the engine
        if any(bitserial.LAUNCHES.values()):
            raise AssertionError(f"the torch_dot step launched "
                                 f"{dict(bitserial.LAUNCHES)}")
        expected = int_launches_per_step(cfg.layers, BATCH_PARTS, grad_bits)
        if launched != {kernel: expected}:
            raise AssertionError(f"training step {mode} g{grad_bits}: launches "
                                 f"{launched}, expected {kernel}: {expected}")
        unequal = [i for i, (g, w) in enumerate(zip(got, want))
                   if not torch.equal(g, w)]
        if unequal or not bool(torch.isfinite(got[0])):
            raise AssertionError(f"training step {mode} g{grad_bits} sr={sr}: "
                                 f"tensors {unequal} differ from torch_dot's")
        emit(phase="training_step_vs_plain", mode=mode, bits=TRAIN_BITS,
             grad_bits=grad_bits, stochastic=sr, loss=float(got[0]),
             tensors_bit_equal=len(got), launches=launched, card=card)

    # trainer.train at full width: the user's entry point
    run_launches = {}
    for name, kw in TRAIN_RUNS:
        tcfg = trainer.TrainConfig(steps=TRAIN_STEPS, log_every=1, seed=0, **kw)
        bitserial.reset_launches()
        t0 = time.perf_counter()
        _, _, hist = trainer.train(data, parts, cfg, tcfg, batch_size=BATCH_PARTS,
                                   device=DEVICE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in bitserial.LAUNCHES.items() if v}
        per_step = (int_launches_per_step(cfg.layers, BATCH_PARTS,
                                          kw.get("grad_bits", 0))
                    if kw["path"] == "int_bitserial" else 0)
        if launched != ({"bitserial_gemm": per_step * TRAIN_STEPS} if per_step
                        else {}):
            raise AssertionError(f"training run {name}: launches {launched}, "
                                 f"expected {per_step} a step")
        losses = [r["loss"] for r in hist]
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"training run {name}: losses {losses}")
        run_launches[name] = launched.get("bitserial_gemm", 0)
        emit(phase="training_run", run=name, steps=TRAIN_STEPS,
             loss_first=losses[0], loss_last=losses[-1], losses=losses,
             bitserial_gemm_launches=run_launches[name],
             launches_per_step=per_step, seconds=seconds, card=card)

    # ms per step, one step at a time, each waited for; then a profile
    cache = intpath.ArtifactCache(TRAIN_BITS, block_pad=bp, rem_pad=rp,
                                  device=DEVICE)
    dbs = [_int_dbatch(torch, b, cache.get(b)) for b in batches[:4]]
    ocfg = opt.AdamWConfig(**TRAIN_OPT)
    for name, kw in TRAIN_RUNS:
        params_r = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device=DEVICE)
        state = [params_r, opt.adamw_init(params_r)]
        sr_gen = torch.Generator(device=DEVICE).manual_seed(0x5eed)
        steps = itertools.count()

        def step():
            i = next(steps) % len(dbs)
            if kw["path"] == "fake":
                db_f = trainer.make_device_batch(batches[i], device=DEVICE)
                p, s, loss, _ = trainer.train_step(*state, db_f, cfg, ocfg, True)
            else:
                p, s, _, loss, _ = trainer.train_step_int(
                    *state, None, dbs[i], sr_gen, cfg, ocfg, kw.get("grad_bits", 0),
                    kw.get("stochastic", False), 0, None)
            state[:] = [p, s]
            return loss

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        ms, host_ms = [], []
        for _ in range(TRAIN_TIMED_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            step()
            end.record()
            end.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ms.append(start.elapsed_time(end))
        bitserial.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRAIN_PROFILED_STEPS):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_PROFILED_STEPS
        gemm_launches = bitserial.LAUNCHES["bitserial_gemm"] / TRAIN_PROFILED_STEPS
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = (sum(e.self_device_time_total for e in kernels) / 1e3
                     / TRAIN_PROFILED_STEPS)
        gemm = [e for e in kernels if "bitserial_tile_kernel" in e.key]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        emit(phase="training_step_ms", run=name, batch_nodes=batches[0].n_nodes,
             ms_per_step=statistics.median(ms), ms_per_step_min=min(ms),
             host_ms_per_step=statistics.median(host_ms),
             bitserial_gemm_launches_per_step=gemm_launches,
             profiled_host_wall_ms=wall_ms,
             device_ms_per_step=device_ms if kernels else "not measured",
             device_idle_share=(1 - device_ms / wall_ms) if kernels else "not measured",
             device_ops_per_step=sum(e.count for e in kernels) / TRAIN_PROFILED_STEPS,
             gemm_kernel_ms_per_step=(sum(e.self_device_time_total for e in gemm)
                                      / 1e3 / TRAIN_PROFILED_STEPS
                                      if gemm else "not measured"),
             top_device_ms=[[e.key[:60], e.self_device_time_total / 1e3
                             / TRAIN_PROFILED_STEPS, e.count // TRAIN_PROFILED_STEPS]
                            for e in top], card=card)

    # Table 2 through the suite runner, at the reference's sizes
    t0 = time.perf_counter()
    records = _quiet(run.main, device=DEVICE, suites=["table2"])
    seconds = time.perf_counter() - t0
    accs = {r["name"]: r["value"] for r in records}
    if len(accs) != 18 or not all(0.0 <= v <= 1.0 for v in accs.values()):
        raise AssertionError(f"table2: cells {accs}")
    for r in records:
        emit(phase="table2", **r, card=card)
    emit(phase="table2_done", cells=len(accs), seconds=seconds,
         test_acc=accs, card=card)
    emit(phase="training_done", seconds=time.perf_counter() - t_phase,
         run_launches=run_launches, card=card)
    return run_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    # the port's timing method, used by every phase
    global graph_ms, time_ms
    from repro_torch.perf.report import graph_ms, time_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    _build.library()
    rates = int_rates(torch)
    emit(phase="build", kernels=list(_build.LAUNCHES),
         sources=[str(p.relative_to(REPO)) for p in _build.sources()],
         seconds=time.perf_counter() - t0, torch=torch.__version__,
         cuda=torch.version.cuda, int_rates=rates, card=card)

    errs = {"bitserial_gemm": phase_kernel_vs_plain(torch, card)}
    errs.update(phase_new_kernels_vs_plain(torch, card))
    errs["wq_gemm"] = phase_wq_gemm_vs_plain(torch, card)
    errs.update(phase_mxu_vs_plain(torch, card))
    vpu_tile_errs = phase_vpu_tiles_vs_plain(torch, card)
    for name, err in vpu_tile_errs.items():
        errs[name] = max(errs[name], err)
    # each path runs with every count at 0 just before it and read after it,
    # and never leaves the engine it asks for
    with no_fallback():
        (models, batches, dbs, tiles, path_launches, logits, data,
         parts) = phase_main_path(torch, card)
        launches = {"bitserial_gemm": path_launches}
        launches["bitserial_gemm_mxu"] = phase_main_path_mxu(
            torch, card, models, dbs, tiles, logits)
        del logits
        api_launches, kept = phase_tensor_api(torch, card, models, dbs)
        launches.update({k: api_launches[k] for k in ("bitserial_fused", "bgemm",
                                                       "bitpack")})
        mxu_launches = phase_tensor_api_mxu(torch, card, kept)
    launches.update({k: mxu_launches[k] for k in ("bitserial_fused_mxu",
                                                   "bgemm_mxu")})
    del kept
    launches["wq_gemm"], wq_packed = phase_weight_only(torch, card)
    timing = phase_timing(torch, card, rates, models, dbs, tiles)
    timing.update(phase_new_kernel_timing(torch, card, rates, models, dbs))
    phase_bitpack_timing(torch, card)
    phase_fig9a(torch, card, dbs)
    phase_profile(torch, card, models, dbs)
    phase_packing(torch, card, batches[0], dbs[0])
    phase_fig9b(torch, card, batches[0])
    phase_figures(torch, card)
    with no_fallback():
        phase_training(torch, card, data, parts)
    # the kernels line carries wq_gemm at the gate projection, batch 1
    timing["wq_gemm"] = phase_wq_timing(torch, card, wq_packed)[("wg", 1)]

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        ms, p_ms, b_ms, b_by, lib_ms = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "mode": ("mxu" if name in MXU_KERNELS else
                     "vpu" if f"{name}_mxu" in MXU_KERNELS else None),
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
