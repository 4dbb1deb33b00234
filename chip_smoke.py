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
     float32 and bf16 torch.matmul of the dequantized weight; at the gate
     projection and batch 128 the kernel and both products again in turns
     (``wq_library_turns``).
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
     sizes: fig7, fig8a, fig8b, fig8c, fig9a, fig9b and kernels
     (kernel_bench: the bit GEMMs over jump modes, SGT against compact,
     the serving arms, a training step of each arm), each line echoed as
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
  14. serving — repro_torch.serve.GNNServer on the card: one request per
     Cluster-GCN part of the main path's graph (1500), qgtc-gcn 8-bit on
     the cuda engine with jump="compact", buckets topping out at 2560
     nodes; three rounds, each drained (round 1 cold, then the tile
     cache), with nodes/s, batch and request p50/p95, queue p95, hit rate,
     bytes moved and forward signatures a round; bitserial_gemm launched
     6 times a batch and nothing else. Every bit-serial GEMM of a cold, a
     warm and an sgt batch against its plain version on the same inputs
     (composed tiles, s_max rounded up to a power of two). 300 requests x
     2 rounds served equal (torch.equal, request by request) on the cuda
     engine with compact tiles, torch_dot, sgt, mode="mxu", no jumping
     and no cache, and GIN 8-bit on the cuda engine and torch_dot; the
     first two batches within 1e-5 of the port on the CPU. Failover: 3
     virtual replicas, one killed, nothing lost, logits equal to a clean
     run, the last round's hit rate >= 0.9. Cold and warm batches under
     torch.profiler, and the host's split (numpy pack, staging and copy,
     entries built and composed, forward dispatch, the wait for the
     device). Then the serve suite of repro_torch.benchmarks.run at the
     reference's sizes, the --gnn launcher and the train-then-serve
     example.

  15. tuning — a policy sweep (repro_torch.tune.sweep) of bitserial_mm at
     the main path's adjacency and first feature GEMM, 8 bits, bands 0.0
     and 0.9, four candidates, every arm equal to torch_dot as it is
     timed; each cell's winner and times. The packaged tuning table
     (src/repro_torch/tune/tables/h100_kernels.json) loaded strict, its
     provenance naming this card. Then qgtc-gcn and qgtc-gin 8-bit on
     batch 0 through forward_qgtc with no policy, under the packaged
     table and with tuning off: logits equal, the launches of each mode
     and the host ms of a forward in each run, and the policy the table
     gave each GEMM.

  16. analysis — the port's contract lint (repro_torch.launch.lint
     --strict) on src/repro_torch: zero findings. The trace checker
     (repro_torch.analysis.trace.run_trace_checks) on the card: every
     registered engine at bits 1..8 (and 1x8, 8x1), jump mask, compact and
     sgt tiles, the tiles= errors, the int training step at 4 and 8 bits
     and the policy sites, with zero failures; every aten op seen, and on
     the cuda engine a kernel launch for each integer op. Then torch_dot's
     bitserial_mm on the card at (s, t) = (32, 32) on a 4 x 16 x 4 int32
     input, (24, 24) at K = 4096 and (8, 8), each equal to the exact int64
     product wrapped to int32 on the CPU, with no float GEMM among its
     aten ops. Its launches join the kernels line.

  17. LM serving — the port's LM stack (repro_torch.models.lm), which
     reaches no hand-written kernel (the reference's reaches no Pallas
     kernel). (a) Every one of the ten archs at its smoke config in
     float32 (MoE dropless), weights drawn on the CPU: prefill and 4
     teacher-forced decode steps on the card against the port on the CPU,
     within 1e-4 relative, TF32 off. (b) Every arch at full width with its
     depth cut (2 layers; whisper 2 + 2; zamba2 9, one attn_every group;
     codeqwen1.5-7b its full 32), weights drawn on the card: in bf16,
     prefill of 2 x 32 tokens and 8 greedy decode steps, logits finite; in
     float32, the last position's logits through prefill + one decode step
     against the scoring forward's (< 0.05, as the reference's own test).
     (c) codeqwen1.5-7b at full width and depth through the --arch engine
     (DecodeEngine): 4 slots, prompt 32, 64 new tokens, in bf16, with
     4-bit weights (quantize_lm_params), and with int8 and int4 KV caches:
     prefill ms, ms a token (p50/p95, each from the call of its decode
     step to the host copy of its argmax), tokens/s, peak memory, the
     decode bound (kernel_cost's HBM bytes of a step over 3.35 TB/s) and
     its share, 5 decode steps under torch.profiler (device ms, idle share,
     ops a step), and the greedy agreement of bf16 and 4-bit. (d) The
     --arch launcher (rwkv6-1.6b --smoke) and the quantized-LM example.

  18. LM training — gradients through lm_loss by autograd, the train step
     (launch/steps.make_train_step) and the launchers. (a) Every arch's
     float32 smoke config (MoE dropless), TF32 off: the loss and every
     leaf's gradient on the card against the port on the CPU, within 1e-4
     of the leaf's largest value; remat none, dots and full on the card
     within 1e-6 of each other, bit for bit on the dense archs. (b) Every
     arch at full width in bf16 with remat full and its depth cut as in
     17 (codeqwen1.5-7b to 2 layers too): two train steps at n_micro 1 and
     2 (batch 2 x 256), loss, parameters and moments finite, peak memory.
     (c) h2o-danube-3-4b at full width and depth (3.96 B parameters),
     sequence 4096 (train_4k's), batch 2 (cut from 256), remat full,
     AdamW lr 1e-4 with clipping at 1.0: 10 steps, each ended by a read of
     the loss (ms a step p50/p95, tokens/s, peak memory, 6 * N * tokens
     over the step as a share of the 989 TFLOP/s dense bf16 peak of the
     datasheet); 3 steps under torch.profiler (device ms, idle share,
     ops a step); one step with the stacked leaves indexed per layer
     against one unbind; the remat modes at 4 layers (ms, peak), each
     with one more step under the peak check below and one with the
     allocator read around each op (``peak_scratch``: the kernels'
     scratch, which perf/roofline.PeakMemory models). The peak check:
     PeakMemory around the step against the allocator's in-step peak
     (max_memory_allocated() after it less memory_allocated() just before
     it), within 5 %, and against the same step's peak on meta, run in a
     subprocess holding a world-1 fake group (``meta_peaks``), which must
     be equal (``peak_check`` lines, with what the card held beside the
     step's arguments). (d) The
     launchers: launch/train on rwkv6-1.6b --smoke, failing at step 6
     (exit 17) and rerun to resume from step 4 to step 12, its final
     parameters against an uninterrupted run's; qgtc-gcn --smoke
     --int-path for 8 steps, bitserial_gemm launched as often as the int
     step's GEMMs (these launches join the kernels line); and
     examples/train_lm_100m at ~100M parameters for 100 steps. The decode
     bound of 17 and the MFU of 18 are also taken through
     perf/roofline.py (roofline_terms' memory term, model_flops over
     HW's bf16 peak), and must equal the phases' own figures.

  19. Dist — (a) a process group of one rank on NCCL (a FileStore, no
     port) and launch/mesh.make_local_mesh() as a (1, 1) mesh on the card:
     codeqwen1.5-7b at full width (d_model 4096, 32 heads, vocab 92416)
     with depth cut to 2 layers as in phase 18, in float32: loss_and_grads
     and one train step with DTensor parameters against the plain ones,
     the loss, every gradient and every updated parameter within 1e-6
     relative to the leaf's largest element, both steps under phase 18's
     peak check; compressed_psum_mean over NCCL bit-equal to the local round
     trip, 3 rounds of error feedback; forward_int of qgtc-gcn under
     shard_ctx bit-equal to the forward without a context, through
     bitserial_gemm (these launches join the kernels line); rwkv6-1.6b at
     full width (d_model 2048, 32 heads) with depth cut to 2 layers, in
     float32, sequence 256 (8 chunks of the scan): the same gradients and
     train step, whose chunked scan runs per rank in its chunk-batched
     form (models/ssm.py _scan), held within 1e-6 to the plain step run
     with that form; the plain model with the scan's two forms (the loop
     over chunks and the batched one, float32 reassociations of each
     other): hidden states within 1e-5 of their largest element, every
     gradient within 1e-4 of its leaf's norm; and each form of the GLA
     (rwkv6's shapes) and SSD (zamba2's) scans against the loop form in
     float64, within 5e-5, the batched no further than twice the loop. (b)
     launch/dryrun.py as ten subprocesses (codeqwen1.5-7b x train_4k
     and decode_32k on the fake 16x16 and 2x16x16 groups; whisper-large-v3
     x train_4k, rwkv6-1.6b x prefill_32k, zamba2-7b x prefill_32k and
     minitron-8b x prefill_32k on 16x16; rwkv6-1.6b and zamba2-7b x
     decode_32k on 2x16x16), every cell OK with its per-device peak, each
     also counted by torch's CommDebugMode in its subprocess (records and
     counts printed by op, the phase fails where they differ), zamba2's
     all-gather count and bytes printed a cell (the phase fails where
     prefill_32k's pass 14 GB a device: the Mamba-2 split gathers only B
     and C), the report's roofline and dry-run tables printed.

  20. Quickstart — ``python -m repro_torch.examples.quickstart`` as a
     subprocess on the card: the §5 tour (to_bit and bitpack, bitmm2int
     and bitmm2bit with and without the fused epilogue, every engine
     exact, bgemm with zero-tile jumping) must exit 0 ending in OK.

Each phase prints its seconds when it ends (``phase_seconds`` lines).

Phases 1-14 run with tuning off (tune.use_table(None)), so that they hold
what they held before a table was packaged: the tuned path is measured in
phase 15 alone. Phases 3, 4, 13, 14 and 15 run with the registry's
fallback warning turned into an error: a path must stay on the engine it
asks for.

The line before the last lists each kernel as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import types
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
# serving (phase 14): GNNServer on the main path's graph, a request a part
SERVE_BITS = 8
SERVE_NODE_BUDGET = 2560       # a bucket of about the main path's 20 parts
SERVE_LEVELS = 3
SERVE_ROUNDS = 3               # round 1 cold, rounds 2-3 hit the tile cache
SERVE_CACHE_ENTRIES = 2048     # every one of the 1500 subgraphs stays resident
SERVE_EQ_REQUESTS, SERVE_EQ_ROUNDS = 300, 2
SERVE_FAILOVER_REQUESTS, SERVE_FAILOVER_ROUNDS = 60, 4
SERVE_PROFILED_BATCHES = 5
# launcher and example: the reference's documented smoke sizes
SERVE_CLI = ["--gnn", "ogbn-arxiv", "--scale", "0.008", "--parts", "8",
             "--rounds", "2"]
SERVE_EXAMPLE = ["--steps", "20"]
PACKING_BITS = (8, 4, 1)
# the tuning phase: the main path's adjacency and first feature GEMM
TUNING_SHAPES = ((2304, 2304, 16), (2304, 128, 16))
TUNING_CANDIDATES = ({}, {"mode": "mxu"}, {"jump": "compact"}, {"jump": "sgt"})
TUNING_TIMED_FORWARDS = 20  # each run, the two in turns
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
# passes, bf16 x as one). main() reads them from the port's one table of
# card constants, repro_torch.perf.roofline.HW.
PEAK_BYTES_S = PEAK_F32_S = PEAK_BF16_S = None
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
# the weight-only kernel against torch.matmul of the dequantized weight, in
# turns: the gate projection at decode_32k's batch
WQ_LIBRARY_TURNS = ("wg", 128)
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
    """``graph_ms`` of versions of one function in turns (a, b, b, a; with
    three a, b, c, c, b, a), each the mean of its two turns: the way
    versions are compared on one card."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
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
            if (name, m) == WQ_LIBRARY_TURNS:
                # the kernel and the two library products of the
                # dequantized weight (float32, bf16) in turns
                emit(phase="wq_library_turns", weight=name, shape=[m, k, n],
                     **turns_ms(torch, {
                         "wq_gemm_ms": lambda: ops.wq_gemm(x, *next(turn)),
                         "library_bf16_ms": lambda: torch.matmul(x16, w16),
                         "library_f32_ms": lambda: torch.matmul(x, w32)}),
                     card=card)
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
    in the training phase, the serve suite in the serving phase."""
    from repro_torch.benchmarks import run

    t0 = time.perf_counter()
    figures = [name for name, _ in run.SUITES if name not in ("table2", "serve")]
    records = _quiet(run.main, device=DEVICE, suites=figures)
    for r in records:
        r = dict(r)
        if "phase" in r:  # kernel_bench tags its training lines phase=train
            r["record_phase"] = r.pop("phase")
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


def _fresh_request(r):
    from repro_torch.serve import SubgraphRequest

    return SubgraphRequest(edges=r.edges, features=r.features, n_nodes=r.n_nodes)


def _serve_rounds(server, reqs, rounds):
    """``rounds`` waves of ``reqs``, each drained; the logits of every
    request in submit order, a list per round. Nothing may be lost."""
    out = []
    for _ in range(rounds):
        ids = [server.submit(_fresh_request(r)) for r in reqs]
        got = server.drain(return_logits=True)
        lost = [i for i in ids if i not in got]
        if lost or None in ids:
            raise AssertionError(f"serving lost requests {lost}")
        out.append([got[i][1] for i in ids])
    return out


def _equal_logits(torch, a, b, what):
    """Request-by-request torch.equal of two runs' logits."""
    for rnd, (ra, rb) in enumerate(zip(a, b)):
        for i, (x, y) in enumerate(zip(ra, rb)):
            if not torch.equal(torch.from_numpy(x), torch.from_numpy(y)):
                raise AssertionError(f"serving {what}: round {rnd} request "
                                     f"{i} logits differ")


def _check_launches(bitserial, kernel, expected, what):
    launches = dict(bitserial.LAUNCHES)
    others = {k: v for k, v in launches.items() if k != kernel and v}
    if launches[kernel] != expected or others:
        raise AssertionError(f"serving {what}: launches {launches}, expected "
                             f"{expected} of {kernel} alone")
    return launches[kernel]


class _HostSplit:
    """Host seconds in the serving path's parts, by wrapping the functions
    the engine calls: the numpy pack, the staging + copy, the transfer
    as a whole (pack, stage, copy, unpack), entry builds, composition, the
    forward's dispatch and the wait for the device."""

    def __init__(self, server):
        from repro_torch.graph import packing
        from repro_torch.serve import engine

        self.seconds = {}
        self._undo = []
        for mod, name, key in ((packing, "pack_compound", "numpy_pack"),
                               (packing, "pack_feats", "numpy_pack"),
                               (packing, "_transfer", "stage_and_copy"),
                               (engine, "transfer_packed", "transfer"),
                               (engine, "transfer_packed_feats", "transfer"),
                               (engine, "compose_entries", "compose_entries"),
                               (engine, "_wait", "device_wait")):
            self._wrap(mod, name, key)
        self._wrap(server, "_build_entry", "build_entries")
        self._wrap(server, "_fwd", "forward_dispatch")

    def _wrap(self, owner, name, key):
        fn = getattr(owner, name)
        self.seconds.setdefault(key, 0.0)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[key] += time.perf_counter() - t0

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def close(self):
        for owner, name, fn in reversed(self._undo):
            if isinstance(owner, types.ModuleType):
                setattr(owner, name, fn)
            else:
                delattr(owner, name)  # the instance's wrapper hid the method


def phase_serving(torch, card, data, parts):
    """Continuous-batching GNN serving on the card (phase 14): GNNServer over
    one request per Cluster-GCN part of the main path's graph. Returns the
    bit-serial launches of the timed traffic and of its 'mxu' twin, and the
    largest kernel-vs-plain difference on the serving path's own inputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.benchmarks import run
    from repro_torch.configs.qgtc_gnn import GNN_CONFIGS
    from repro_torch.examples import train_cluster_gcn
    from repro_torch.kernels import bitserial
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import gnn
    from repro_torch.perf import report
    from repro_torch.serve import (FaultInjector, GNNServer, MicroBatcher,
                                   make_buckets, requests_from_partitions)

    t_phase = time.perf_counter()
    models = {}
    for name in ("qgtc-gcn", "qgtc-gin"):
        cfg = dataclasses.replace(GNN_CONFIGS[name], x_bits=SERVE_BITS,
                                  w_bits=SERVE_BITS)
        params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEVICE)
        models[name] = (cfg, gnn.quantize_params(params, cfg))
    cfg, qp = models["qgtc-gcn"]
    compact = api.ExecutionPolicy(jump="compact")
    reqs = requests_from_partitions(data, parts)
    t_reqs = time.perf_counter() - t_phase

    def server(policy=compact, backend="cuda", model="qgtc-gcn", **kw):
        kw.setdefault("buckets", buckets)
        kw.setdefault("cache_entries", SERVE_CACHE_ENTRIES)
        return GNNServer(models[model][1], models[model][0], backend=backend,
                         policy=policy, tuning_table=None, devices=[DEVICE],
                         **kw)

    align = GNNServer(qp, cfg, policy=compact, tuning_table=None,
                      devices=[DEVICE]).align
    buckets = make_buckets(node_budget=SERVE_NODE_BUDGET,
                           edge_budget=BATCH_PARTS * max(r.n_edges for r in reqs),
                           tile=align, levels=SERVE_LEVELS)
    emit(phase="serving_setup", model="qgtc-gcn", bits=SERVE_BITS,
         requests=len(reqs), request_nodes_max=max(r.n_nodes for r in reqs),
         request_nodes_mean=statistics.mean(r.n_nodes for r in reqs),
         request_edges_max=max(r.n_edges for r in reqs), align=align,
         buckets=[[b.n_pad, b.e_cap] for b in buckets],
         requests_s=t_reqs, card=card)

    # timed traffic: every part a request, three rounds, each drained
    srv = server()
    bitserial.reset_launches()
    batches, signatures = 0, []
    for rnd in range(SERVE_ROUNDS):
        st, cache = srv.stats, srv.cache
        b0, n0, r0, x0 = st.batches, st.nodes, st.requests, st.transfer_bytes
        h0, m0 = cache.hits, cache.misses
        t0 = time.perf_counter()
        for r in reqs:
            srv.submit(_fresh_request(r))
        srv.drain()
        wall = time.perf_counter() - t0
        nb, nr = st.batches - b0, st.requests - r0
        lat = list(st.batch_latencies_s)[-nb:]
        req_lat = list(st.request_latencies_s)[-nr:]
        waits = list(st.queue_wait_s)[-nr:]
        hits = cache.hits - h0
        batches += nb
        signatures.append(srv.n_compiles)
        emit(phase="serving", round=rnd + 1, batches=nb, requests=nr,
             nodes=st.nodes - n0, wall_s=wall, nodes_per_s=(st.nodes - n0) / wall,
             requests_per_s=nr / wall,
             batch_p50_ms=report.percentile(lat, 50) * 1e3,
             batch_p95_ms=report.percentile(lat, 95) * 1e3,
             req_p50_ms=report.percentile(req_lat, 50) * 1e3,
             req_p95_ms=report.percentile(req_lat, 95) * 1e3,
             queue_p95_ms=report.percentile(waits, 95) * 1e3,
             cache_hit_rate=hits / max(hits + cache.misses - m0, 1),
             transfer_bytes=st.transfer_bytes - x0,
             zero_tile_skip_ratio=st.zero_tile_skip_ratio,
             cache_resident_bytes=st.cache_resident_bytes,
             n_compiles=srv.n_compiles, card=card)
    if srv.stats.requests != SERVE_ROUNDS * len(reqs):
        raise AssertionError(f"served {srv.stats.requests} requests")
    launches = {"bitserial_gemm": _check_launches(
        bitserial, "bitserial_gemm", PER_FORWARD["gcn"] * batches, "traffic")}
    if len(set(signatures)) != 1:  # a repeated wave adds no signature
        raise AssertionError(f"forward signatures by round: {signatures}")
    emit(phase="serving_launches", kernel="bitserial_gemm", batches=batches,
         launches=launches["bitserial_gemm"],
         per_batch=launches["bitserial_gemm"] / batches,
         n_compiles=srv.n_compiles, card=card)

    # the kernel on the serving path's own inputs: every bit-serial GEMM of
    # one cold and one warm batch (composed compact tiles, s_max rounded up
    # to a power of two) and of a batch under sgt, against its plain version
    max_err = 0
    calls = []
    real = kops.bitserial_gemm

    def capture(a_packed, b_packed, **kw):
        calls.append((a_packed, b_packed, kw))
        return real(a_packed, b_packed, **kw)

    kops.bitserial_gemm = capture
    try:
        for policy, rounds in ((compact, 2), (api.ExecutionPolicy(jump="sgt"), 1)):
            probe = server(policy=policy)
            for _ in range(rounds):
                for r in reqs[:BATCH_PARTS]:
                    probe.submit(_fresh_request(r))
                probe.step()
                probe.drain()
    finally:
        kops.bitserial_gemm = real
    kinds = {}
    for a_packed, b_packed, kw in calls:
        pol, tiles = kw["policy"], kw.get("tiles")
        a, b, kern = kops._bitserial_operands(a_packed, b_packed, tiles, None, {
            "block_m": pol.block_m, "block_n": pol.block_n,
            "block_w": pol.block_w, "mode": pol.mode, "jump": pol.jump})
        got = real(a_packed, b_packed, **kw)
        want = bitserial.bitserial_gemm_plain(
            a, b, block_m=kern["block_m"], block_w=kern["block_w"],
            occupancy=kern["occupancy"], compact=kern["compact"],
            sgt=kern["sgt"])[:a_packed.shape[1]]
        if not torch.equal(got, want):
            raise AssertionError("serving: the kernel differs from its plain "
                                 "version on the serving path's inputs")
        max_err = max(max_err, (got.to(torch.int64) - want).abs().max().item())
        kind = ("sgt" if tiles is not None and len(tiles) == 4 else
                "compact" if tiles is not None else "none")
        kinds.setdefault(kind, []).append(
            [list(a_packed.shape), list(b_packed.shape),
             tiles[2] if tiles is not None else None])
    if set(kinds) != {"none", "compact", "sgt"}:
        raise AssertionError(f"serving path's GEMMs: {sorted(kinds)}")
    emit(phase="serving_kernel_vs_plain", checks=len(calls), max_abs_err=max_err,
         shapes={k: v[:3] for k, v in kinds.items()}, card=card)

    # equality: one traffic of 300 requests x 2 rounds through every variant
    eq = reqs[:SERVE_EQ_REQUESTS]
    variants = (
        ("cuda_vpu_compact", dict(), "bitserial_gemm", "gcn"),
        ("torch_dot", dict(backend="torch_dot"), None, "gcn"),
        ("cuda_sgt", dict(policy=api.ExecutionPolicy(jump="sgt")),
         "bitserial_gemm", "gcn"),
        ("cuda_mxu_compact", dict(policy=api.ExecutionPolicy(mode="mxu",
                                                             jump="compact")),
         "bitserial_gemm_mxu", "gcn"),
        ("jump_none", dict(policy=api.ExecutionPolicy()), "bitserial_gemm", "gcn"),
        ("scratch", dict(cache_entries=0), "bitserial_gemm", "gcn"),
        ("gin_cuda_compact", dict(model="qgtc-gin"), "bitserial_gemm", "gin"),
        ("gin_torch_dot", dict(model="qgtc-gin", backend="torch_dot"), None,
         "gin"))
    runs = {}
    for name, kw, kernel, model in variants:
        srv_v = server(**kw)
        bitserial.reset_launches()
        t0 = time.perf_counter()
        runs[name] = _serve_rounds(srv_v, eq, SERVE_EQ_ROUNDS)
        seconds = time.perf_counter() - t0
        expected = PER_FORWARD[model] * srv_v.stats.batches if kernel else 0
        got = (_check_launches(bitserial, kernel, expected, name) if kernel
               else sum(bitserial.LAUNCHES.values()))
        if got != expected:
            raise AssertionError(f"serving {name} launched {got} kernels")
        if name == "cuda_mxu_compact":
            launches["bitserial_gemm_mxu"] = got
        ref = "gin_torch_dot" if model == "gin" else "cuda_vpu_compact"
        if ref in runs and name != ref:
            _equal_logits(torch, runs[name], runs[ref], f"{name} vs {ref}")
        emit(phase="serving_equal", variant=name, requests=len(eq),
             rounds=SERVE_EQ_ROUNDS, batches=srv_v.stats.batches,
             launches=got, kernel=kernel, equal_to=ref if name != ref else None,
             cache_hit_rate=srv_v.cache.hit_rate if srv_v.cache else None,
             n_compiles=srv_v.n_compiles, seconds=seconds, card=card)
    _equal_logits(torch, runs["gin_cuda_compact"], runs["gin_torch_dot"], "gin")

    # the first two batches against the port on the CPU (the kernels' plain
    # versions there): the same plans, the logits within 1e-5
    mb = MicroBatcher(buckets, align=align)
    for r in eq:
        mb.add(_fresh_request(r))
    n_two = sum(len(mb.next_plan().requests) for _ in range(2))
    cpu_srv = GNNServer(qp, cfg, policy=compact, tuning_table=None,
                        buckets=buckets, devices=["cpu"])
    on_cpu = _serve_rounds(cpu_srv, eq[:n_two], 1)[0]
    diff = max(float(abs(a - b).max())
               for a, b in zip(on_cpu, runs["cuda_vpu_compact"][0][:n_two]))
    if cpu_srv.stats.batches != 2 or diff > 1e-5 or not all(
            torch.allclose(torch.from_numpy(a), torch.from_numpy(b),
                           rtol=1e-5, atol=1e-5)
            for a, b in zip(on_cpu, runs["cuda_vpu_compact"][0][:n_two])):
        raise AssertionError(f"serving: card and CPU logits differ by {diff} "
                             f"over {cpu_srv.stats.batches} batches")
    emit(phase="serving_reference", batches=2, requests=n_two,
         card_vs_cpu_max_abs=diff, card=card)
    del runs

    # failover: three virtual replicas on the card, one killed mid-serve;
    # single-request plans (node budget = one tile), so a request's logits
    # do not depend on what it was coalesced with
    fo_reqs = [r for r in reqs if r.n_nodes <= align][:SERVE_FAILOVER_REQUESTS]
    outs, hit_rates, fo_servers = {}, {}, {}
    for name, chaos in (("clean", None), ("failover", FaultInjector("kill@2"))):
        fo = server(replicas=3, node_budget=align, chaos=chaos)
        outs[name], hit_rates[name] = [], []
        for _ in range(SERVE_FAILOVER_ROUNDS):
            h0, m0 = fo.cache.hits, fo.cache.misses
            outs[name] += _serve_rounds(fo, fo_reqs, 1)
            dh, dm = fo.cache.hits - h0, fo.cache.misses - m0
            hit_rates[name].append(dh / max(dh + dm, 1))
        fo_servers[name] = (fo, chaos)
    _equal_logits(torch, outs["failover"], outs["clean"], "failover vs clean")
    fo, chaos = fo_servers["failover"]
    st = fo.stats
    lost = SERVE_FAILOVER_ROUNDS * len(fo_reqs) - st.requests
    if (lost or st.replicas_live != 2 or st.replica_faults != 1
            or not chaos.fired or hit_rates["failover"][-1] < 0.9):
        raise AssertionError(f"failover: lost {lost}, live {st.replicas_live}, "
                             f"faults {st.replica_faults}, final hit rate "
                             f"{hit_rates['failover'][-1]}")
    emit(phase="serving_failover", requests=len(fo_reqs),
         rounds=SERVE_FAILOVER_ROUNDS, lost=lost, logits_equal_clean=True,
         replicas_live=st.replicas_live, retried=st.requests_retried,
         rehomed_entries=st.cache_rehomed_entries,
         rehomed_bytes=st.cache_rehomed_bytes, fired=chaos.fired,
         hit_rate_by_round=hit_rates["failover"], mesh_plan=fo.mesh_plan(),
         card=card)
    del outs, fo_servers, fo

    # where the time goes: cold and warm batches under the profiler, then
    # the host's split in a second pass without it
    prof_reqs = reqs[-SERVE_PROFILED_BATCHES * BATCH_PARTS:]
    for temp in ("cold", "warm"):
        for mode in ("profile", "split"):
            srv_p = server()
            if temp == "warm":
                _serve_rounds(srv_p, prof_reqs, 1)
            for r in prof_reqs:
                srv_p.submit(_fresh_request(r))
            b0 = srv_p.stats.batches
            torch.cuda.synchronize()
            if mode == "profile":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    srv_p.drain()
                    wall = time.perf_counter() - t0
                nb = srv_p.stats.batches - b0
                kernels = [e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA]
                device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
                gemm = [e for e in kernels if "bitserial_tile_kernel" in e.key]
                top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
                emit(phase="serving_profile", batches=temp, n=nb,
                     host_wall_ms_per_batch=wall * 1e3 / nb,
                     device_ms_per_batch=(device_ms / nb if kernels
                                          else "not measured"),
                     device_idle_share=(1 - device_ms / (wall * 1e3)
                                        if kernels else "not measured"),
                     device_ops_per_batch=sum(e.count for e in kernels) / nb,
                     gemm_kernel_ms_per_batch=(
                         sum(e.self_device_time_total for e in gemm) / 1e3 / nb
                         if gemm else "not measured"),
                     top_device_ms=[[e.key[:60], e.self_device_time_total / 1e3
                                     / nb, e.count / nb] for e in top],
                     card=card)
            else:
                split = _HostSplit(srv_p)
                try:
                    t0 = time.perf_counter()
                    srv_p.drain()
                    wall = time.perf_counter() - t0
                finally:
                    split.close()
                nb = srv_p.stats.batches - b0
                emit(phase="serving_host_split", batches=temp, n=nb,
                     host_wall_ms_per_batch=wall * 1e3 / nb,
                     **{f"{k}_ms_per_batch": v * 1e3 / nb
                        for k, v in split.seconds.items()}, card=card)

    # the entry points: the serve suite, the --gnn launcher, the example
    t0 = time.perf_counter()
    records = _quiet(run.main, device=DEVICE, suites=["serve"])
    for r in records:
        emit(phase="serving_suite", **r, card=card)
    emit(phase="serving_suite_done", records=len(records),
         seconds=time.perf_counter() - t0, card=card)
    t0 = time.perf_counter()
    summary = _quiet(serve_cli.main, argv=SERVE_CLI)
    want = 8 * 2
    if summary["requests"] != want or summary["requests_shed"]:
        raise AssertionError(f"launcher served {summary['requests']} of {want}")
    emit(phase="serving_launcher", argv=SERVE_CLI, requests=summary["requests"],
         batches=summary["batches"], n_compiles=summary["n_compiles"],
         batch_p50_ms=summary["batch_p50_s"] * 1e3,
         batch_p95_ms=summary["batch_p95_s"] * 1e3,
         nodes_per_s=summary["nodes_per_s"], device=summary["device"],
         seconds=time.perf_counter() - t0, card=card)
    t0 = time.perf_counter()
    result = _quiet(train_cluster_gcn.main, argv=SERVE_EXAMPLE)
    losses = [r["loss"] for r in result["history"]]
    if not all(math.isfinite(x) for x in losses) or not result["serve"]["batches"]:
        raise AssertionError(f"example: losses {losses}")
    emit(phase="serving_example", argv=SERVE_EXAMPLE, loss_first=losses[0],
         loss_last=losses[-1], qat_acc=result["qat_acc"],
         int_acc=result["int_acc"], serve_batches=result["serve"]["batches"],
         serve_batch_p50_ms=result["serve"]["batch_p50_s"] * 1e3,
         seconds=time.perf_counter() - t0, card=card)
    emit(phase="serving_done", seconds=time.perf_counter() - t_phase, card=card)
    return launches, max_err


def phase_tuning(torch, card, models, dbs):
    """Policy tuning on the card (phase 15): a sweep at the main path's
    shapes, the packaged table, and the 8-bit forwards of batch 0 under it
    and with tuning off. Returns each kernel's launches in the forwards."""
    from repro_torch.api import registry
    from repro_torch.kernels import bitserial
    from repro_torch.models import gnn
    from repro_torch.tune import sweep
    from repro_torch.tune import table as tune_table

    t_phase = time.perf_counter()
    config = {"name": "chip-smoke-tuning", "ops": ["bitserial_mm"],
              "bits": [8], "sparsity_bands": [0.0, 0.9],
              "shapes": [list(s) for s in TUNING_SHAPES], "backend": "cuda",
              "candidates": [dict(c) for c in TUNING_CANDIDATES],
              "iters": 20, "warmup": 3}
    # run_sweep holds every arm equal to torch_dot (torch.equal) as it times it
    res = sweep.run_sweep(config, log=lambda *_: None,
                          source="chip_smoke.py:TUNING_CANDIDATES", device=DEVICE)
    if res.rejected or len(res.records) != (len(TUNING_SHAPES) * 2
                                            * len(TUNING_CANDIDATES)):
        raise AssertionError(f"tuning sweep: {len(res.records)} arms, "
                             f"rejected {res.rejected}")
    for entry in res.table.entries:
        arms = {json.dumps(r["candidate"]): r["median_ms"] for r in res.records
                if (r["m"], r["k"], r["n"]) == entry.shape_bucket
                and r["sparsity"] == entry.sparsity_band}
        best = next(r["candidate"] for r in res.records
                    if r.get("best") and (r["m"], r["k"], r["n"])
                    == entry.shape_bucket and r["sparsity"] == entry.sparsity_band)
        emit(phase="tuning_sweep", op=entry.op, bits=entry.bits,
             band=entry.sparsity_band, shape=list(entry.shape_bucket),
             best=best, best_ms=entry.median_ms, default_ms=entry.baseline_ms,
             arms_ms=arms, arms_equal_torch_dot=True, card=card)
    sweep_s = time.perf_counter() - t_phase

    packaged = tune_table.TuningTable.load(tune_table.DEFAULT_TABLE_PATH,
                                           strict=True)
    kind = torch.cuda.get_device_name(0)
    if packaged.meta.get("device") != kind:
        raise AssertionError(f"the packaged table was measured on "
                             f"{packaged.meta.get('device')!r}, not on {kind!r}")
    emit(phase="tuning_table", path=str(tune_table.DEFAULT_TABLE_PATH.relative_to(REPO)),
         entries=len(packaged), measured_on=packaged.meta.get("card"),
         commit=packaged.meta.get("commit"), this_card=card)

    asked = {}
    real = registry._tuned_policy

    def spy(op, **kw):
        pol = real(op, **kw)
        asked[op, kw["bits"], kw["shape"]] = pol
        return pol

    db = dbs[0]
    runs = {"tuned": packaged, "untuned": None}
    launches = dict.fromkeys(bitserial.LAUNCHES, 0)
    for name, (_, _, per_bits) in models.items():
        cfg_b, qp = per_bits[8]

        def fn():
            return gnn.forward_qgtc(qp, db["adj"], db["x"], db["inv_deg"], cfg_b)

        policies, logits = {}, {}
        for run, tbl in runs.items():  # warm-up, and the policy of each GEMM
            asked.clear()
            registry._tuned_policy = spy
            try:
                with tune_table.use_table(tbl):
                    logits[run] = fn()
            finally:
                registry._tuned_policy = real
            policies[run] = [[op, bits, list(shape) if shape else None,
                              None if pol is None else
                              {"mode": pol.mode, "jump": pol.jump,
                               "tile": [pol.block_m, pol.block_n, pol.block_w]}]
                             for (op, bits, shape), pol in asked.items()]
        torch.cuda.synchronize()
        if not torch.equal(logits["tuned"], logits["untuned"]):
            raise AssertionError(f"{name}: tuned logits differ from untuned")
        counts = {run: dict.fromkeys(bitserial.LAUNCHES, 0) for run in runs}
        times = {run: [] for run in runs}
        for i in range(TUNING_TIMED_FORWARDS):  # in turns, each order in turn
            for run in (("tuned", "untuned") if i % 2 == 0
                        else ("untuned", "tuned")):
                with tune_table.use_table(runs[run]):
                    bitserial.reset_launches()
                    t0 = time.perf_counter()
                    out = fn()
                    torch.cuda.synchronize()
                    times[run].append((time.perf_counter() - t0) * 1e3)
                    for k, v in bitserial.LAUNCHES.items():
                        counts[run][k] += v
                if not torch.equal(out, logits[run]):
                    raise AssertionError(f"{name} {run}: logits changed")
        for run in runs:
            out = logits[run]
            if out.shape != (db["adj"].shape[0], cfg_b.n_classes) or \
                    not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} {run}: bad logits")
            per_fwd = sum(counts[run].values()) / TUNING_TIMED_FORWARDS
            if per_fwd != PER_FORWARD[cfg_b.model]:
                raise AssertionError(f"{name} {run}: {counts[run]} launches in "
                                     f"{TUNING_TIMED_FORWARDS} forwards")
            for k, v in counts[run].items():
                launches[k] += v
            emit(phase="tuning_forward", model=name, bits=8, run=run,
                 forwards=TUNING_TIMED_FORWARDS,
                 bitserial_gemm=counts[run]["bitserial_gemm"],
                 bitserial_gemm_mxu=counts[run]["bitserial_gemm_mxu"],
                 host_ms_median=statistics.median(times[run]),
                 host_ms_min=min(times[run]), host_ms=times[run],
                 policies=policies[run], card=card)
        emit(phase="tuning_equal", model=name, bits=8, logits_equal=True)
    emit(phase="tuning_done", sweep_s=sweep_s,
         seconds=time.perf_counter() - t_phase, card=card)
    return launches


# phase 16: torch_dot on the card at operands past float64's exact range;
# the first is a 4 x 16 x 4 product of whole int32s from default_rng(0)
# LM serving (phase 17): the full-width runs' depth cuts, and the served cell
LM_DEPTH = {"whisper-large-v3": dict(n_layers=2, enc_layers=2),
            "zamba2-7b": dict(n_layers=9, attn_every=9),
            "codeqwen1.5-7b": {}}      # full depth; any other arch: 2 layers
LM_TEACHER_STEPS, LM_FREE_STEPS = 4, 8
LM_SERVE = dict(arch="codeqwen1.5-7b", slots=4, prompt=32, max_new=64)
LM_SERVE_RUNS = (("bf16", 0, 0), ("w4", 4, 0), ("bf16_kv8", 0, 8),
                 ("bf16_kv4", 0, 4))   # (name, wq_bits, kv_bits)
LM_PROFILED_STEPS = 5
LM_CLI = ["--arch", "rwkv6-1.6b", "--smoke", "--requests", "4",
          "--batch-slots", "2", "--max-new", "8"]
TORCH_DOT_CASES = ((32, 32, (4, 16, 4)), (24, 24, (64, 4096, 48)),
                   (8, 8, (300, 700, 130)))


def phase_analysis(torch, card):
    """The contract lint and the trace checker on the card (phase 16), and
    torch_dot's exact int32 product. Returns each kernel's launches."""
    import numpy as np

    from repro_torch import api
    from repro_torch.analysis import trace
    from repro_torch.kernels import _build
    from repro_torch.launch import lint

    t_phase = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lint.main(["--strict"])
    if rc != 0:
        raise AssertionError(f"lint --strict: {out.getvalue()}")
    emit(phase="analysis_lint", result=out.getvalue().strip(), card=card)

    _build.reset_launches()
    report = trace.run_trace_checks(device=DEVICE, log=lambda *_: None)
    launches = dict(_build.LAUNCHES)
    if report["failures"]:
        raise AssertionError(f"trace checker: {report['failures']}")
    if not all(launches[k] for k in ("bitserial_gemm", "bitserial_fused",
                                     "bgemm")):
        raise AssertionError(f"trace checker launched {launches}")
    emit(phase="analysis_trace", device=report["device"],
         backends=report["backends"], checks=report["checks"],
         failures=len(report["failures"]),
         policy_sites=report["policy_sites"], train_path=report["train_path"],
         launches={k: v for k, v in launches.items() if v}, card=card)

    rng = np.random.default_rng(0)
    for s, t, (m, k, n) in TORCH_DOT_CASES:
        a = rng.integers(-2**31, 2**31, (m, k)) if s == 32 else \
            rng.integers(0, 1 << s, (m, k))
        b = rng.integers(-2**31, 2**31, (k, n)) if t == 32 else \
            rng.integers(0, 1 << t, (k, n))
        # numpy's int64 matmul wraps modulo 2**64, which keeps the low word
        want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
        ta = torch.as_tensor(a.astype(np.int32), device=DEVICE)
        tb = torch.as_tensor(b.astype(np.int32), device=DEVICE)
        got, ops = trace.record_ops(lambda x, y: api.bitserial_mm(
            x, y, s, t, backend="torch_dot"), ta, tb)
        float_gemms = sorted({op for op in trace.float_ops(ops)
                              if op in trace.GEMM_OPS})
        if float_gemms:
            raise AssertionError(f"torch_dot {s}x{t}: float GEMMs {float_gemms}")
        if not np.array_equal(got.cpu().numpy(), want):
            bad = int((got.cpu().numpy() != want).sum())
            raise AssertionError(f"torch_dot {s}x{t} K={k}: {bad} of "
                                 f"{want.size} entries differ from the "
                                 f"exact product")
        emit(phase="analysis_torch_dot", s=s, t=t, shape=[m, k, n],
             equal_exact_int32=True,
             gemm_ops=sorted({op for op, _ in ops if "mm" in op}), card=card)
    emit(phase="analysis_done", seconds=time.perf_counter() - t_phase,
         card=card)
    return launches


def _lm_rel(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-12))


def _lm_to(tree, device):
    return {k: _lm_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _lm_batch(torch, cfg, batch, seq, dtype):
    from repro_torch.train import data

    b = data.batch_for_arch(cfg, 0, 0, batch, seq, device=DEVICE)
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}


def _lm_card_vs_cpu(torch, card):
    """(a) every arch's smoke config on the card against the port on the
    CPU, the same weights and tokens."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import data

    worst = 0.0
    for arch in configs.ARCHS:
        cfg = dataclasses.replace(configs.smoke_config(configs.get(arch)),
                                  dtype="float32")
        if cfg.moe_experts:  # dropless: prefill and decode route alike
            cfg = dataclasses.replace(
                cfg, capacity_factor=float(cfg.moe_experts) / cfg.moe_top_k)
        params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        batch = data.batch_for_arch(cfg, 0, 0, 2, 13 + LM_TEACHER_STEPS,
                                    device="cpu")
        batch = {k: v.float() if v.is_floating_point() else v
                 for k, v in batch.items() if k != "labels"}
        outs = {}
        for dev in ("cpu", DEVICE):
            p, b = _lm_to(params, dev), _lm_to(batch, dev)
            logits, cache = lm.prefill(p, dict(b, tokens=b["tokens"][:, :13]),
                                       cfg, max_seq=24)
            got = [logits]
            for i in range(LM_TEACHER_STEPS):
                logits, cache = lm.decode_step(
                    p, cache, b["tokens"][:, 13 + i:14 + i], cfg)
                got.append(logits)
            outs[dev] = got
        errs = [_lm_rel(c, r) for c, r in zip(outs[DEVICE], outs["cpu"])]
        if max(errs) > 1e-4 or not all(o.device.type == "cuda"
                                       for o in outs[DEVICE]):
            raise AssertionError(f"{arch}: card against CPU {errs}")
        worst = max(worst, max(errs))
        emit(phase="lm_card_vs_cpu", arch=arch, family=cfg.family,
             max_rel_err=errs, card=card)
    return worst


def _lm_full_width_run(torch, cfg) -> dict:
    """One full-width run of ``cfg`` on the card, its weights drawn there:
    bf16, prefill + greedy decode, logits finite; float32, the decode step
    against the scoring forward."""
    from repro_torch.models import lm

    params, _ = lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           device=DEVICE)
    row = {"params": lm.param_count(params)}
    if cfg.dtype == "bfloat16":
        b = _lm_batch(torch, cfg, 2, 32, torch.bfloat16)
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, b, cfg,
                                   max_seq=32 + LM_FREE_STEPS + 1)
        finite = bool(torch.isfinite(logits).all())
        for _ in range(LM_FREE_STEPS):
            nxt = logits.argmax(-1).clamp(max=cfg.vocab - 1).to(torch.int32)
            logits, cache = lm.decode_step(params, cache, nxt[:, None], cfg)
            finite &= bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        row["bf16_prefill_and_decode_s"] = time.perf_counter() - t0
        if not finite:
            raise AssertionError(f"{cfg.name} bf16: non-finite logits")
        return row
    b = _lm_batch(torch, cfg, 2, 17, torch.float32)
    h = lm.forward_hidden(params, b, cfg)
    want = h[:, -1] @ lm._head_matrix(params, cfg)
    _, cache = lm.prefill(params, dict(b, tokens=b["tokens"][:, :-1]), cfg,
                          max_seq=24)
    got, _ = lm.decode_step(params, cache, b["tokens"][:, -1:], cfg)
    row["decode_vs_forward"] = _lm_rel(got, want)
    if not row["decode_vs_forward"] < 0.05:
        raise AssertionError(f"{cfg.name}: decode diverges from forward {row}")
    return row


def _lm_full_width(torch, card):
    """(b) every arch at full width, depth cut, in bf16 and in float32 (MoE
    dropless there)."""
    from repro_torch import configs

    for arch in configs.ARCHS:
        base = dataclasses.replace(configs.get(arch),
                                   **LM_DEPTH.get(arch, dict(n_layers=2)))
        row = {"arch": arch, "n_layers": base.n_layers,
               "enc_layers": base.enc_layers}
        with torch.no_grad():
            row.update(_lm_full_width_run(torch, dataclasses.replace(
                base, dtype="bfloat16")))
            f32 = dataclasses.replace(base, dtype="float32")
            if f32.moe_experts:
                f32 = dataclasses.replace(f32, capacity_factor=float(
                    f32.moe_experts) / f32.moe_top_k)
            row.update(_lm_full_width_run(torch, f32))
        torch.cuda.empty_cache()
        emit(phase="lm_full_width", **row, card=card)


def _lm_profile(torch, engine, prompts):
    """LM_PROFILED_STEPS decode steps under torch.profiler (the device's
    activity only: recording every host op would slow the host that sets
    this path's pace), after a prefill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm

    cfg, params = engine.cfg, engine.params
    with torch.no_grad():
        logits, cache = lm.prefill(params, engine._inputs(prompts), cfg,
                                   max_seq=engine.max_seq)
        nxt = logits.argmax(-1).to(torch.int32).clamp(max=cfg.vocab - 1)[:, None]
        logits, cache = lm.decode_step(params, cache, nxt, cfg)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(LM_PROFILED_STEPS):  # as the engine's loop
                logits, cache = lm.decode_step(params, cache, nxt, cfg)
                nxt = logits.argmax(-1).to(torch.int32).clamp(
                    max=cfg.vocab - 1)[:, None]
                nxt.cpu()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / LM_PROFILED_STEPS
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"profile": "not measured", "host_wall_ms": wall_ms}
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / LM_PROFILED_STEPS
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"host_wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1 - device_ms / wall_ms,
            "device_ops_per_step": sum(e.count for e in kernels) / LM_PROFILED_STEPS,
            "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3
                               / LM_PROFILED_STEPS] for e in top]}


def _lm_serve(torch, card):
    """(c) codeqwen1.5-7b at full width and depth through the --arch engine."""
    from repro_torch import configs
    from repro_torch.api import nn as qnn
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.serve import DecodeEngine
    from repro_torch.models import lm
    from repro_torch.perf import kernel_cost, report, roofline
    from repro_torch.train import data

    base = configs.get(LM_SERVE["arch"])
    # what earlier phases still hold counts in max_memory_allocated: the
    # model's own peak is the part above this, once their garbage is gone
    gc.collect()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, _ = lm.init_lm(base, torch.Generator(device=DEVICE).manual_seed(0),
                           device=DEVICE)
    torch.cuda.synchronize()
    emit(phase="lm_serve_init", arch=base.name, seconds=time.perf_counter() - t0,
         card=card)
    n_params = lm.param_count(params)
    slots, prompt_len, max_new = (LM_SERVE["slots"], LM_SERVE["prompt"],
                                  LM_SERVE["max_new"])
    max_seq = prompt_len + max_new + 8
    prompts = data.synthetic_batch(0, 0, batch=slots, seq=prompt_len,
                                   vocab=base.vocab, device="cpu")[0].numpy()
    tokens = {}
    for name, wq_bits, kv_bits in LM_SERVE_RUNS:
        t_run = time.perf_counter()
        cfg = dataclasses.replace(base, kv_bits=kv_bits)
        p, qstats = params, None
        if wq_bits:
            p, qstats = qnn.quantize_lm_params(params, wq_bits)
        engine = DecodeEngine(cfg, p, slots, max_seq=max_seq)
        engine.generate(prompts, 4)  # warm: the allocator and the kernels
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, _ = engine.generate(prompts, max_new)
        peak = torch.cuda.max_memory_allocated()
        tokens[name] = out
        walls = engine.last_walls
        steps = walls["token_s"][1:]  # token 0 is the prefill's argmax
        p50 = report.percentile(steps, 50) * 1e3
        shape = ShapeSpec("decode", "decode", max_seq, slots)
        cost = kernel_cost.analytic_cost(cfg, shape, 1, n_params)
        bound_ms = cost.hbm_bytes_per_device / PEAK_BYTES_S * 1e3
        # the same bound through perf/roofline.py: its memory term
        rl_ms = roofline.roofline_terms(
            cost.flops_per_device, cost.hbm_bytes_per_device, 0.0,
            n_devices=1).memory_s * 1e3
        if rl_ms != bound_ms:
            raise AssertionError(f"roofline memory term {rl_ms} ms against "
                                 f"the phase's bound {bound_ms} ms")
        prof = _lm_profile(torch, engine, prompts)
        row = dict(phase="lm_serve", arch=cfg.name, run=name, wq_bits=wq_bits,
                   kv_bits=kv_bits, params=n_params, slots=slots,
                   prompt=prompt_len, max_new=max_new,
                   prefill_ms=walls["prefill_s"] * 1e3,
                   decode_ms_per_token_p50=p50,
                   decode_ms_per_token_p95=report.percentile(steps, 95) * 1e3,
                   decode_s=walls["decode_s"],
                   tok_per_s=out.size / walls["decode_s"],
                   peak_memory_gb=peak / 1e9,
                   peak_above_phase_start_gb=(peak - held_before) / 1e9,
                   decode_bound_ms=bound_ms, bound_by="bytes",
                   bound_bytes=cost.hbm_bytes_per_device,
                   bound_share_p50=bound_ms / p50,
                   roofline_bound_share_p50=rl_ms / p50,
                   **prof, seconds=time.perf_counter() - t_run, card=card)
        if qstats is not None:
            # a footprint: the forward reads the dequantized bf16 weights
            row.update(n_quantized=qstats["n_quantized"],
                       packed_footprint_ratio=qstats["ratio"],
                       bound_note="the w4 forward reads bf16 weights: "
                                  "the bf16 bound holds")
        emit(**row)
        del engine, p
    agree = float((tokens["bf16"] == tokens["w4"]).mean())
    emit(phase="lm_serve_agreement", bf16_vs_w4=agree,
         bf16_vs_kv8=float((tokens["bf16"] == tokens["bf16_kv8"]).mean()),
         bf16_vs_kv4=float((tokens["bf16"] == tokens["bf16_kv4"]).mean()),
         card=card)
    del params
    torch.cuda.empty_cache()


def phase_lm_serving(torch, card):
    """Phase 17: the LM stack on the card. Returns the kernel launches it
    made (the path reaches none)."""
    from repro_torch.examples import serve_quantized_lm
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    _build.reset_launches()
    worst = _lm_card_vs_cpu(torch, card)
    _lm_full_width(torch, card)
    _lm_serve(torch, card)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = serve.main(LM_CLI)
        example = serve_quantized_lm.main([])
    if (result["requests"] != 4 or result["device"] == "cpu"
            or not out.getvalue().rstrip().endswith("OK")):
        raise AssertionError(f"LM launcher or example: {out.getvalue()}")
    emit(phase="lm_cli", launcher=result["stats"], example_agreement=
         example["agreement"], example_n_quantized=example["n_quantized"],
         card=card)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    emit(phase="lm_done", card_vs_cpu_max_rel_err=worst,
         kernel_launches=launches, seconds=time.perf_counter() - t_phase,
         card=card)
    return launches


# LM training (phase 18): depth cuts of the full-width runs (codeqwen's 32
# layers would hold 65.5 GB of bf16 params, gradients and moments: 2 here),
# the timed cell (train_4k's sequence, batch cut from 256 to 2) and the
# launchers' command lines
LM_TRAIN_DEPTH = dict(LM_DEPTH, **{"codeqwen1.5-7b": dict(n_layers=2)})
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 2, 256
LM_TRAIN_CELL = dict(arch="h2o-danube-3-4b", batch=2, seq=4096, steps=10,
                     profiled=3, remat_layers=4)
LM_TRAIN_OPT = dict(lr=1e-4, grad_clip=1.0)
LM_TRAIN_CLI = ["--arch", "rwkv6-1.6b", "--smoke", "--steps", "12", "--batch",
                "2", "--seq", "32", "--ckpt-every", "4", "--log-every", "2"]
LM_TRAIN_FAIL_AT = 6
GNN_TRAIN_CLI = ["--arch", "qgtc-gcn", "--smoke", "--int-path", "--steps",
                 "8", "--log-every", "1"]
GNN_TRAIN_BLOCKS = 4   # --smoke: 8 parts, batches of 4
LM_100M_CLI = ["--steps", "100"]
REMAT_MODES = ("none", "dots", "full")
# the live-storage tracker (perf/roofline.PeakMemory) around a step on the
# card against the allocator's in-step peak (max_memory_allocated() after
# the step less memory_allocated() just before it): within this share
PEAK_TOL = 0.05
# a kernel's scratch worth naming (the per-op allocator readings)
SCRATCH_MIN_BYTES = 1 << 20
META_PEAKS_TIMEOUT_S = 600


def meta_peaks() -> None:
    """The steps of the card's peak checks on ``meta``, in a process of
    their own holding a world-1 ``fake`` group: phase 18's remat arms and
    phase 19's plain and sharded codeqwen1.5-7b steps, each under
    PeakMemory. Prints one JSON line, {name: {"peak_bytes", "top"}}. Run by
    ``MetaPeaks``; touches no card."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.perf.roofline import PeakMemory
    from repro_torch.train import data
    from repro_torch.train import optimizer as opt

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    out = {}

    def peak(name, run):
        with PeakMemory() as mem:
            run()
        out[name] = {"peak_bytes": mem.peak_bytes, "top": mem.top(5)}

    c = LM_TRAIN_CELL
    base = dataclasses.replace(configs.get(c["arch"]), remat="full")
    for mode in REMAT_MODES:
        cfg = dataclasses.replace(base, n_layers=c["remat_layers"], remat=mode)
        params, _ = lm.init_lm(cfg, device="meta")
        ostate = opt.adamw_init(params)
        batch = _lm_to(data.batch_for_arch(cfg, 0, 3, c["batch"], c["seq"],
                                           device="cpu"), "meta")
        step = steps.make_train_step(cfg, opt.AdamWConfig(**LM_TRAIN_OPT))
        peak(f"lm_train_remat/{mode}", lambda: step(params, ostate, batch))
        del params, ostate

    cfg = dataclasses.replace(configs.get(DIST_ARCH), dtype="float32",
                              **LM_TRAIN_DEPTH[DIST_ARCH])
    params, axes = lm.init_lm(cfg, device="meta")
    batch = _lm_to(data.batch_for_arch(cfg, 0, 0, DIST_TRAIN["batch"],
                                       DIST_TRAIN["seq"], device="cpu"), "meta")
    mesh = make_local_mesh()
    rules = shd.make_rules("train")
    ps = steps.distribute(params, steps.param_shardings(mesh, rules, axes,
                                                        params))
    b_sh = steps.batch_shardings(cfg, mesh, rules)
    bs = steps.distribute(batch, {k: b_sh[k] for k in batch})
    step = steps.make_train_step(cfg, opt.AdamWConfig(lr=DIST_TRAIN["lr"]))
    o1, o2 = opt.adamw_init(params), opt.adamw_init(ps)
    peak("dist_train_step/plain", lambda: step(params, o1, batch))

    def sharded():
        with steps.sharded(mesh, rules):
            step(ps, o2, bs)

    peak("dist_train_step/sharded", sharded)
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


class MetaPeaks:
    """``meta_peaks`` in a subprocess (a fake group cannot share the card's
    process with its NCCL group), started at once, read when first asked."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.meta_peaks()"],
            cwd=str(REPO), env=dict(_src_env(), CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.peaks = None

    def __getitem__(self, name):
        if self.peaks is None:
            out, err = self.proc.communicate(timeout=META_PEAKS_TIMEOUT_S)
            if self.proc.returncode:
                raise AssertionError(f"meta peaks exited {self.proc.returncode}:"
                                     f" {err[-3000:]}")
            self.peaks = json.loads(out.strip().splitlines()[-1])
        return self.peaks[name]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _kernel_scratch(torch, run) -> dict:
    """``run()`` with the allocator read around each op: the ops whose
    kernels peaked above what they returned (scratch they freed before
    returning, which perf/roofline.PeakMemory cannot see and models in its
    ``_SCRATCH``), by op: calls, the largest scratch, the bytes and shape of
    that call's first tensor argument."""
    from torch.utils._python_dispatch import TorchDispatchMode

    found: dict = {}

    class Reader(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            torch.cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            scratch = (torch.cuda.max_memory_allocated()
                       - torch.cuda.memory_allocated())
            if scratch >= SCRATCH_MIN_BYTES:
                arg = next(a for a in args if isinstance(a, torch.Tensor))
                r = found.setdefault(str(func), {"calls": 0, "max_bytes": 0})
                r["calls"] += 1
                if scratch > r["max_bytes"]:
                    r.update(max_bytes=scratch, input_shape=list(arg.shape),
                             input_bytes=arg.numel() * arg.element_size())
            return out

    with Reader():
        run()
    torch.cuda.synchronize()
    return found


def _peak_check(torch, run, what, resident, meta, card):
    """``run()`` once under PeakMemory on the card, against the allocator's
    in-step peak (within PEAK_TOL) and the same step's peak on ``meta``
    (``meta[what]``, equal); beside them what the card held before the step
    that ``resident`` (the step's arguments) does not, and the allocator's
    peak of requested bytes (before its rounding). Returns ``run()``'s
    value."""
    from repro_torch.launch.dryrun import _local_bytes
    from repro_torch.perf.roofline import PeakMemory

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    requested0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    with PeakMemory() as mem:
        out = run()
        torch.cuda.synchronize()
    allocator = torch.cuda.max_memory_allocated() - before
    requested = torch.cuda.memory_stats()["requested_bytes.all.peak"] - requested0
    rel = abs(mem.peak_bytes - allocator) / allocator
    on_meta = meta[what]
    args = _local_bytes(resident)
    emit(phase="peak_check", what=what, tracker_bytes=mem.peak_bytes,
         allocator_bytes=allocator, allocator_requested_bytes=requested,
         rel_err=rel, tolerance=PEAK_TOL, meta_bytes=on_meta["peak_bytes"],
         meta_minus_tracker_bytes=on_meta["peak_bytes"] - mem.peak_bytes,
         allocated_before_bytes=before, argument_bytes=args,
         held_beside_arguments_bytes=before - args, top=mem.top(5),
         meta_top=on_meta["top"], card=card)
    if rel > PEAK_TOL or on_meta["peak_bytes"] != mem.peak_bytes:
        raise AssertionError(f"{what}: tracker {mem.peak_bytes} bytes against "
                             f"the allocator's {allocator} and meta's "
                             f"{on_meta['peak_bytes']}")
    return out


def _lm_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_lm_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _lm_train_card_vs_cpu(torch, card):
    """(a) every arch's float32 smoke config: loss and gradients on the card
    against the port on the CPU, and the three remat modes on the card."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import data

    worst = 0.0
    for arch in configs.ARCHS:
        cfg = dataclasses.replace(configs.smoke_config(configs.get(arch)),
                                  dtype="float32")
        if cfg.moe_experts:  # dropless, as the CPU tests
            cfg = dataclasses.replace(
                cfg, capacity_factor=float(cfg.moe_experts) / cfg.moe_top_k)
        params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        batch = data.batch_for_arch(cfg, 0, 0, 2, 17, device="cpu")
        batch = {k: v.float() if v.is_floating_point() else v
                 for k, v in batch.items()}
        loss_c, _, g_c = steps.loss_and_grads(params, batch, cfg, t_chunk=8)
        p_d, b_d = _lm_to(params, DEVICE), _lm_to(batch, DEVICE)
        out = {r: steps.loss_and_grads(p_d, b_d, dataclasses.replace(
            cfg, remat=r), t_chunk=8) for r in ("none", "dots", "full")}
        g_c, g_d = _lm_flat(g_c), _lm_flat(out["none"][2])
        loss_err = abs(out["none"][0].item() - loss_c.item()) / abs(loss_c.item())
        grad_err = max(_lm_rel(g_d[k], g) for k, g in g_c.items())
        remat_err, remat_equal = 0.0, True
        for r in ("dots", "full"):
            for k, g in _lm_flat(out[r][2]).items():
                remat_err = max(remat_err, _lm_rel(g, g_d[k]))
                remat_equal &= bool(torch.equal(g, g_d[k]))
        if (loss_err > 1e-4 or grad_err > 1e-4 or remat_err > 1e-6
                or (cfg.family == "dense" and not remat_equal)
                or g_d["embed"].device.type != DEVICE):
            raise AssertionError(f"{arch}: card against CPU: loss {loss_err}, "
                                 f"grads {grad_err}, remat {remat_err} "
                                 f"(bit-equal {remat_equal})")
        worst = max(worst, grad_err)
        emit(phase="lm_train_card_vs_cpu", arch=arch, family=cfg.family,
             loss_rel_err=loss_err, grad_max_rel_err=grad_err,
             remat_max_rel_err=remat_err, remat_bit_equal=remat_equal,
             card=card)
    return worst


def _lm_finite(torch, tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in _lm_flat(tree).values())


def _lm_train_full_width(torch, card):
    """(b) every arch at full width, bf16, remat full, depth cut: two train
    steps at n_micro 1 and 2; loss, parameters and moments finite."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import data
    from repro_torch.train import optimizer as opt

    for arch in configs.ARCHS:
        cfg = dataclasses.replace(configs.get(arch), remat="full",
                                  **LM_TRAIN_DEPTH.get(arch, dict(n_layers=2)))
        row = {"arch": arch, "n_layers": cfg.n_layers,
               "enc_layers": cfg.enc_layers, "batch": LM_TRAIN_BATCH,
               "seq": LM_TRAIN_SEQ}
        for n_micro in (1, 2):
            params, _ = lm.init_lm(
                cfg, torch.Generator(device=DEVICE).manual_seed(0),
                device=DEVICE)
            row["params"] = lm.param_count(params)
            ostate = opt.adamw_init(params)
            step = steps.make_train_step(cfg, opt.AdamWConfig(**LM_TRAIN_OPT),
                                         n_micro=n_micro)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses = []
            for i in range(2):
                b = data.batch_for_arch(cfg, 0, i, LM_TRAIN_BATCH,
                                        LM_TRAIN_SEQ, device=DEVICE)
                params, ostate, m = step(params, ostate, b)
                losses.append(m["loss"].item())
            row[f"n_micro{n_micro}"] = dict(
                losses=losses, seconds=time.perf_counter() - t0,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            if not (all(math.isfinite(x) for x in losses)
                    and _lm_finite(torch, params)
                    and _lm_finite(torch, ostate["mu"])
                    and _lm_finite(torch, ostate["nu"])):
                raise AssertionError(f"{arch} n_micro {n_micro}: not finite "
                                     f"{losses}")
            del params, ostate, step
            gc.collect()
            torch.cuda.empty_cache()
        emit(phase="lm_train_full_width", **row, card=card)


def _lm_train_profile(torch, step, params, ostate, batches):
    """LM_TRAIN_CELL["profiled"] steps under torch.profiler (the device's
    activity): device ms, idle share and device ops a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            params, ostate, m = step(params, ostate, b)
            m["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return params, ostate, {"profile": "not measured",
                                "host_wall_ms": wall_ms}
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return params, ostate, {
        "host_wall_ms": wall_ms, "device_ms": device_ms,
        "device_idle_share": 1 - device_ms / wall_ms,
        "device_ops_per_step": sum(e.count for e in kernels) / n,
        "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3 / n]
                          for e in top]}


def _lm_train_timed(torch, cfg, params, ostate, batches):
    """One train step a batch, each ended by a read of the loss; returns
    (params, ostate, walls in s, losses)."""
    from repro_torch.launch import steps
    from repro_torch.train import optimizer as opt

    step = steps.make_train_step(cfg, opt.AdamWConfig(**LM_TRAIN_OPT))
    walls, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, ostate, m = step(params, ostate, b)
        losses.append(m["loss"].item())
        walls.append(time.perf_counter() - t0)
    return params, ostate, walls, losses


def _lm_train_cell(torch, card, meta):
    """(c) h2o-danube-3-4b at full width and depth: LM_TRAIN_CELL's steps,
    a profile, stack[i] against unbind, and the remat modes at 4 layers,
    each with one more step under the peak check."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.perf import report, roofline
    from repro_torch.train import data
    from repro_torch.train import optimizer as opt

    c = LM_TRAIN_CELL
    cfg = dataclasses.replace(configs.get(c["arch"]), remat="full")
    gc.collect()
    torch.cuda.empty_cache()
    params, _ = lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           device=DEVICE)
    n_params = lm.param_count(params)
    ostate = opt.adamw_init(params)
    batches = [data.batch_for_arch(cfg, 0, i, c["batch"], c["seq"],
                                   device=DEVICE)
               for i in range(1 + c["steps"] + c["profiled"] + 3)]
    tokens = c["batch"] * c["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, ostate, _, first = _lm_train_timed(torch, cfg, params, ostate,
                                               batches[:1])  # warm
    params, ostate, walls, losses = _lm_train_timed(
        torch, cfg, params, ostate, batches[1:1 + c["steps"]])
    peak = torch.cuda.max_memory_allocated()
    p50 = report.percentile(walls, 50)
    flops = 6 * n_params * tokens
    # the same MFU through perf/roofline.py
    rl_mfu = (roofline.model_flops(n_params, tokens, "train") / p50
              / roofline.HW["peak_flops_bf16"])
    if rl_mfu != flops / p50 / PEAK_BF16_S:
        raise AssertionError(f"roofline MFU {rl_mfu} against the phase's "
                             f"{flops / p50 / PEAK_BF16_S}")
    row = dict(phase="lm_train_cell", arch=cfg.name, params=n_params,
               n_layers=cfg.n_layers, batch=c["batch"], seq=c["seq"],
               remat=cfg.remat, steps=c["steps"], loss_first=first[0],
               losses=losses, ms_per_step_p50=p50 * 1e3,
               ms_per_step_p95=report.percentile(walls, 95) * 1e3,
               ms_per_step=[w * 1e3 for w in walls], tokens_per_s=tokens / p50,
               peak_memory_gb=peak / 1e9, model_flops_per_step=flops,
               model_flops_note="6 * N * tokens, N every parameter",
               model_flops_share_of_989_tflops=flops / p50 / PEAK_BF16_S,
               roofline_mfu=rl_mfu)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name}: non-finite losses {losses}")
    k = 1 + c["steps"]
    step = steps.make_train_step(cfg, opt.AdamWConfig(**LM_TRAIN_OPT))
    params, ostate, prof = _lm_train_profile(torch, step, params, ostate,
                                             batches[k:k + c["profiled"]])
    row.update(prof)
    emit(**row, card=card)

    # stack[i] per layer (the backward writes each layer's gradient into a
    # zero tensor the size of the stack) against one unbind a forward
    k += c["profiled"]
    split = {}
    unbind = lm._unbind
    try:
        for name, fn in (("unbind", unbind),
                         ("stack_index", lambda tree, n: [lm._index(tree, i)
                                                          for i in range(n)]),
                         ("unbind_again", unbind)):
            lm._unbind = fn
            torch.cuda.reset_peak_memory_stats()
            params, ostate, w, _ = _lm_train_timed(torch, cfg, params, ostate,
                                                   batches[k:k + 1])
            k += 1
            split[name] = dict(ms=w[0] * 1e3, peak_memory_gb=torch.cuda
                               .max_memory_allocated() / 1e9)
    finally:
        lm._unbind = unbind
    emit(phase="lm_train_stack_vs_unbind", arch=cfg.name, **split, card=card)
    del params, ostate, step
    gc.collect()
    torch.cuda.empty_cache()

    remat = {}
    for mode in REMAT_MODES:
        cfg4 = dataclasses.replace(cfg, n_layers=c["remat_layers"], remat=mode)
        params, _ = lm.init_lm(cfg4, torch.Generator(device=DEVICE)
                               .manual_seed(0), device=DEVICE)
        ostate = opt.adamw_init(params)
        params, ostate, _, _ = _lm_train_timed(torch, cfg4, params, ostate,
                                               batches[:1])  # warm
        torch.cuda.reset_peak_memory_stats()
        params, ostate, w, _ = _lm_train_timed(torch, cfg4, params, ostate,
                                               batches[1:3])
        remat[mode] = dict(ms_per_step=[x * 1e3 for x in w],
                           peak_memory_gb=torch.cuda.max_memory_allocated()
                           / 1e9)
        step = steps.make_train_step(cfg4, opt.AdamWConfig(**LM_TRAIN_OPT))
        _peak_check(torch, lambda: step(params, ostate, batches[3]),
                    f"lm_train_remat/{mode}", (params, ostate, batches[3]),
                    meta, card)
        emit(phase="peak_scratch", what=f"lm_train_remat/{mode}",
             ops=_kernel_scratch(torch, lambda: step(params, ostate,
                                                     batches[4])),
             modeled=sorted(map(str, roofline._SCRATCH)), card=card)
        del params, ostate, step
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="lm_train_remat", arch=cfg.name, n_layers=c["remat_layers"],
         batch=c["batch"], seq=c["seq"], **remat, card=card)


def _lm_train_launchers(torch, card):
    """(d) the --arch launcher's failure and resume, the GNN launcher's int
    path through bitserial_gemm, and the 100M example. Returns the kernel
    launches of the GNN launcher's run."""
    import tempfile

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.examples import train_lm_100m
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.tune import use_table

    def final(d):
        m = json.loads((Path(d) / f"step_{ckpt.latest_step(d):010d}" /
                        "manifest.json").read_text())
        return ckpt.restore(d, [None] * m["n_leaves"])[0]

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        full, cut = f"{tmp}/full", f"{tmp}/cut"
        res = train.main(LM_TRAIN_CLI + ["--ckpt-dir", full])
        try:
            train.main(LM_TRAIN_CLI + ["--ckpt-dir", cut, "--simulate-failure-at",
                                       str(LM_TRAIN_FAIL_AT)])
            code = 0
        except SystemExit as exc:
            code = exc.code
        train.main(LM_TRAIN_CLI + ["--ckpt-dir", cut])
        latest = ckpt.latest_step(cut)
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(final(full), final(cut)))
    text = out.getvalue()
    if (code != 17 or "resumed from step 4" not in text or latest != 12
            or not res["device"].startswith(DEVICE)):
        raise AssertionError(f"LM launcher: exit {code}, latest {latest}: "
                             f"{text[-2000:]}")
    emit(phase="lm_train_launcher", argv=LM_TRAIN_CLI, exit_code=code,
         resumed_from=4, latest_step=latest,
         max_abs_diff_vs_uninterrupted=diff, history=res["history"], card=card)

    out = io.StringIO()
    with use_table(None), no_fallback(), contextlib.redirect_stdout(out):
        _build.reset_launches()
        res = train.main(GNN_TRAIN_CLI)
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    steps_ = int(GNN_TRAIN_CLI[GNN_TRAIN_CLI.index("--steps") + 1])
    per_step = int_launches_per_step(3, GNN_TRAIN_BLOCKS, 0)
    if launches.get("bitserial_gemm") != steps_ * per_step:
        raise AssertionError(f"GNN launcher launched {launches}, expected "
                             f"{per_step} bitserial_gemm a step")
    emit(phase="gnn_train_launcher", argv=GNN_TRAIN_CLI, launches=launches,
         bitserial_gemm_per_step=launches["bitserial_gemm"] / steps_,
         expected_per_step=per_step, test_acc=res["test_acc"],
         history=res["history"], card=card)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_lm_100m.main(LM_100M_CLI)
    if not out.getvalue().rstrip().endswith("OK"):
        raise AssertionError(f"train_lm_100m: {out.getvalue()[-2000:]}")
    emit(phase="lm_train_100m", argv=LM_100M_CLI, params=res["params"],
         loss_step0=res["losses"][0], loss_last=res["losses"][-1],
         steps=len(res["losses"]), ms_per_step_p50=res["p50_s"] * 1e3,
         seconds=res["seconds"], card=card)
    return launches


def phase_lm_training(torch, card, meta=None):
    """Phase 18: LM training on the card (``meta``: a ``MetaPeaks``, made
    here when None). Returns the kernel launches of its runs (the GNN
    launcher's int path)."""
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    meta = MetaPeaks() if meta is None else meta
    worst = _lm_train_card_vs_cpu(torch, card)
    _lm_train_full_width(torch, card)
    _lm_train_cell(torch, card, meta)
    _build.reset_launches()
    launches = _lm_train_launchers(torch, card)
    emit(phase="lm_train_done", card_vs_cpu_grad_max_rel_err=worst,
         kernel_launches=launches, seconds=time.perf_counter() - t_phase,
         card=card)
    return launches


# phase 19: the dist layer on a world-1 NCCL group, and the dry run
# full width, float32, on a (1, 1) mesh; depth cut as in phase 18 (the
# float32 parameters, gradients and both moments of the plain and the
# sharded step side by side: ~40 GB at 2 layers)
DIST_ARCH = "codeqwen1.5-7b"
DIST_TRAIN = dict(batch=8, seq=32, lr=1e-3)
# world size 1: DTensor runs the same local ops as the plain step, so the
# loss, the gradients and the updated parameters are held to equality
# within this relative bound (expected 0)
DIST_TOL = 1e-6
DIST_CPSUM_ROUNDS = 3
DIST_GNN = dict(dataset="proteins", scale=0.01, parts=8, batch_size=4)
# (arch, shape, meshes): 16x16, and 2x16x16 with --multi-pod
DIST_DRYRUN = (("codeqwen1.5-7b", "train_4k", ([], ["--multi-pod"])),
               ("codeqwen1.5-7b", "decode_32k", ([], ["--multi-pod"])),
               ("whisper-large-v3", "train_4k", ([],)),
               ("rwkv6-1.6b", "prefill_32k", ([],)),
               ("zamba2-7b", "prefill_32k", ([],)),
               # the scans' decode steps per rank; a split-KV cache's
               # writes per rank
               ("rwkv6-1.6b", "decode_32k", (["--multi-pod"],)),
               ("zamba2-7b", "decode_32k", (["--multi-pod"],)),
               ("minitron-8b", "prefill_32k", ([],)))
# the Mamba-2 split per rank: zamba2's all-gathered bytes a device at
# prefill_32k (B and C, every head's, 2.7 GB) bounded
DIST_ZAMBA2_GATHER_BOUND = 14e9
# rwkv6 at full width: the per-rank scan on the card (8 chunks of 32)
DIST_SCAN_ARCH = "rwkv6-1.6b"
DIST_SCAN_TRAIN = dict(batch=4, seq=256, lr=1e-3)
# the scan's two forms (the loop over chunks, the chunk-batched per-rank
# one) are float32 reassociations of each other; on the card cuBLAS sums
# their batched products in other orders: the model's hidden states within
# this bound of their largest element, its gradients of their leaf's norm
DIST_SCAN_FORMS_TOL = dict(hidden=1e-5, grads_norm=1e-4)
# each form against the loop form in float64 on the same float32 inputs
# (B, T, H, K|P[, N]) at the layers' own shapes: within this bound of the
# largest element, the batched form no further than twice the loop's
DIST_SCAN_F64 = dict(gla=(4, 256, 32, 64), ssd=(2, 256, 112, 64, 64),
                     tol=5e-5)
# a cell's step budget on the host: DTensor plans each distinct (op,
# placements) once, minutes on the 3-D mesh for an op it must plan with its
# graph search; every cell must be OK within it
DIST_CELL_TIMEOUT_S = 240


def _dist_full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _dist_leaf_err(torch, got, want) -> float:
    """The largest |got - want| of any leaf over that leaf's largest |want|
    (computed on the card: the leaves are GBs)."""
    from repro_torch.train import optimizer as opt

    err = 0.0
    for i, (a, b) in enumerate(zip(opt.tree_leaves(want),
                                   opt.tree_leaves(got), strict=True)):
        b = _dist_full(b).detach()
        if type(a) is not torch.Tensor or type(b) is not torch.Tensor:
            raise AssertionError(f"leaf {i}: {type(a).__name__} "
                                 f"against {type(b).__name__}")
        err = max(err, float((b - a).abs().max()
                             / a.abs().max().clamp(min=1e-12)))
    return err


def _dist_train_step(torch, mesh, card, meta):
    """(a) codeqwen1.5-7b at full width, depth cut as in phase 18, float32:
    the gradients and one train step with DTensor parameters against the
    plain ones, both on the card, each step under the peak check."""
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import data
    from repro_torch.train import optimizer as opt

    cut = LM_TRAIN_DEPTH[DIST_ARCH]
    cfg = dataclasses.replace(configs.get(DIST_ARCH), dtype="float32", **cut)
    params, axes = lm.init_lm(cfg, torch.Generator(device=DEVICE)
                              .manual_seed(0), device=DEVICE)
    batch = data.batch_for_arch(cfg, 0, 0, DIST_TRAIN["batch"],
                                DIST_TRAIN["seq"], device=DEVICE)
    rules = shd.make_rules("train")
    ps = steps.distribute(opt.tree_map(torch.clone, params),
                          steps.param_shardings(mesh, rules, axes, params))
    b_sh = steps.batch_shardings(cfg, mesh, rules)
    bs = steps.distribute(batch, {k: b_sh[k] for k in batch})
    if not all(type(x).__name__ == "DTensor"
               and x.to_local().device.type == DEVICE
               for x in opt.tree_leaves(ps)):
        raise AssertionError("the sharded parameters are not DTensors on "
                             "the card")

    leaf_err = functools.partial(_dist_leaf_err, torch)
    _, _, g1 = steps.loss_and_grads(params, batch, cfg)
    with steps.sharded(mesh, rules):
        _, _, g2 = steps.loss_and_grads(ps, bs, cfg)
    g_err = leaf_err(g2, g1)
    del g1, g2
    step = steps.make_train_step(cfg, opt.AdamWConfig(lr=DIST_TRAIN["lr"]))
    o1 = opt.adamw_init(params)
    # each peak check resets the allocator's peak: the phase's is the
    # largest of the readings before each reset and after the last
    peaks = [torch.cuda.max_memory_allocated()]
    t0 = time.perf_counter()
    p1, o1, m1 = _peak_check(torch, lambda: step(params, o1, batch),
                             "dist_train_step/plain", (params, o1, batch),
                             meta, card)
    loss1 = m1["loss"].item()
    plain_s = time.perf_counter() - t0
    del o1
    o2 = opt.adamw_init(ps)
    peaks.append(torch.cuda.max_memory_allocated())

    def sharded_step():
        with steps.sharded(mesh, rules):
            return step(ps, o2, bs)

    t0 = time.perf_counter()
    p2, o2, m2 = _peak_check(torch, sharded_step, "dist_train_step/sharded",
                             (ps, o2, bs), meta, card)
    loss2 = _dist_full(m2["loss"]).item()
    sharded_s = time.perf_counter() - t0
    del o2
    loss_err = abs(loss2 - loss1) / abs(loss1)
    p_err = leaf_err(p2, p1)
    peak = max(peaks + [torch.cuda.max_memory_allocated()]) / 1e9
    del p1, p2, ps, params
    gc.collect()
    torch.cuda.empty_cache()
    if max(loss_err, g_err, p_err) > DIST_TOL:
        raise AssertionError(f"sharded step: loss {loss2} against {loss1}, "
                             f"grads max rel err {g_err}, params {p_err}")
    emit(phase="dist_train_step", arch=cfg.name, d_model=cfg.d_model,
         n_heads=cfg.n_heads, vocab=cfg.vocab, n_layers=cfg.n_layers,
         depth_cut=cut, dtype=cfg.dtype, batch=DIST_TRAIN["batch"],
         seq=DIST_TRAIN["seq"], mesh=shd.mesh_shape(mesh), loss=loss2,
         loss_unsharded=loss1, loss_rel_err=loss_err,
         grads_max_rel_err=g_err, params_max_rel_err=p_err,
         tolerance=DIST_TOL, step_s=sharded_s, step_unsharded_s=plain_s,
         peak_memory_gb=peak, card=card)


def _dist_scan_forms_f64(torch) -> dict:
    """The scan's loop and chunk-batched forms in float32 against the loop
    form in float64, on inputs drawn at the layers' shapes: rwkv6's GLA
    (8 chunks of 32) and zamba2's SSD (2 chunks of 128, B and C of one
    group)."""
    from repro_torch.models import ssm

    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def draw(*shape, decay=False):
        x = torch.randn(shape, generator=gen, device=DEVICE)
        return -torch.exp(x) if decay else x

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    b, t, h, k = DIST_SCAN_F64["gla"]
    gla = (draw(b, t, h, k), draw(b, t, h, k), draw(b, t, h, k),
           draw(b, t, h, k, decay=True), draw(h, k), draw(b, h, k, k))
    b, t, h, p, n = DIST_SCAN_F64["ssd"]
    ssd = (draw(b, t, h, p), draw(b, t, h, decay=True), draw(b, t, n),
           draw(b, t, n), draw(b, h, n, p))
    out = {}
    for name, loop, batched, args, chunk in (
            ("gla", ssm.gla_chunked, ssm.gla_chunks_batched, gla, 32),
            ("ssd", ssm._ssd_grouped, ssm.ssd_chunks_batched, ssd, 128)):
        want = loop(*[a.double() for a in args], chunk)[0]
        out[name] = dict(loop=rel(loop(*args, chunk)[0], want),
                         batched=rel(batched(*args, chunk)[0], want))
    return out


def _dist_scan_step(torch, mesh, card):
    """(a) rwkv6-1.6b at full width, depth cut to 2 layers, float32: the
    gradients and one train step with DTensor parameters, whose chunked
    scan runs per rank in its chunk-batched form, against the plain ones
    run with that form (the same ops on a world of one: expected 0); the
    plain model's hidden states and gradients with the two scan forms
    against each other; each form against float64."""
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm, ssm
    from repro_torch.train import data
    from repro_torch.train import optimizer as opt

    tr = DIST_SCAN_TRAIN
    cfg = dataclasses.replace(configs.get(DIST_SCAN_ARCH), dtype="float32",
                              n_layers=2)
    params, axes = lm.init_lm(cfg, torch.Generator(device=DEVICE)
                              .manual_seed(0), device=DEVICE)
    batch = data.batch_for_arch(cfg, 0, 0, tr["batch"], tr["seq"],
                                device=DEVICE)
    rules = shd.make_rules("train")
    ps = steps.distribute(opt.tree_map(torch.clone, params),
                          steps.param_shardings(mesh, rules, axes, params))
    b_sh = steps.batch_shardings(cfg, mesh, rules)
    bs = steps.distribute(batch, {k: b_sh[k] for k in batch})
    leaf_err = functools.partial(_dist_leaf_err, torch)
    loop_scan, batched = ssm._scan, ssm.gla_chunks_batched
    per_rank = []

    def counted(*a, **kw):
        per_rank.append(1)
        return batched(*a, **kw)

    @contextlib.contextmanager
    def batched_form():  # the plain step with the per-rank scan's form
        ssm._scan = lambda plain, pr, args, names, state_at: pr(*args)
        try:
            yield
        finally:
            ssm._scan = loop_scan

    with torch.no_grad():
        h_loop = lm.forward_hidden(params, batch, cfg)
        with batched_form():
            h_b = lm.forward_hidden(params, batch, cfg)
    hidden_err = float((h_b - h_loop).abs().max() / h_loop.abs().max())
    del h_loop, h_b
    _, _, g_loop = steps.loss_and_grads(params, batch, cfg)
    with batched_form():
        _, _, g1 = steps.loss_and_grads(params, batch, cfg)
    forms_err = leaf_err(g1, g_loop)
    forms_norm = max(float((a - b).norm() / b.norm()) for a, b in zip(
        opt.tree_leaves(g1), opt.tree_leaves(g_loop), strict=True))
    del g_loop
    ssm.gla_chunks_batched = counted
    try:
        with steps.sharded(mesh, rules):
            _, _, g2 = steps.loss_and_grads(ps, bs, cfg)
    finally:
        ssm.gla_chunks_batched = batched
    g_err = leaf_err(g2, g1)
    del g1, g2
    step = steps.make_train_step(cfg, opt.AdamWConfig(lr=tr["lr"]))
    with batched_form():
        p1, o1, m1 = step(params, opt.adamw_init(params), batch)
    loss1 = m1["loss"].item()
    del o1
    with steps.sharded(mesh, rules):
        p2, o2, m2 = step(ps, opt.adamw_init(ps), bs)
    loss2 = _dist_full(m2["loss"]).item()
    del o2
    loss_err = abs(loss2 - loss1) / abs(loss1)
    p_err = leaf_err(p2, p1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del p1, p2, ps, params
    gc.collect()
    torch.cuda.empty_cache()
    f64 = _dist_scan_forms_f64(torch)
    tol = DIST_SCAN_FORMS_TOL
    if not per_rank:
        raise AssertionError("the sharded rwkv6 step never ran the per-rank "
                             "scan")
    if max(loss_err, g_err, p_err) > DIST_TOL or \
            hidden_err > tol["hidden"] or forms_norm > tol["grads_norm"] or \
            any(e["loop"] > DIST_SCAN_F64["tol"]
                or e["batched"] > max(DIST_SCAN_F64["tol"], 2 * e["loop"])
                for e in f64.values()):
        raise AssertionError(f"sharded rwkv6 step: loss {loss2} against "
                             f"{loss1}, grads max rel err {g_err}, params "
                             f"{p_err}; the scan forms: hidden {hidden_err},"
                             f" grads {forms_norm} in norm; float64 {f64}")
    emit(phase="dist_scan_step", arch=cfg.name, d_model=cfg.d_model,
         n_heads=cfg.d_model // ssm.RWKV_HEAD, n_layers=cfg.n_layers,
         dtype=cfg.dtype, batch=tr["batch"], seq=tr["seq"],
         chunks=-(-tr["seq"] // 32), per_rank_scan_calls=len(per_rank),
         mesh=shd.mesh_shape(mesh), loss=loss2, loss_unsharded=loss1,
         loss_rel_err=loss_err, grads_max_rel_err=g_err,
         params_max_rel_err=p_err, tolerance=DIST_TOL,
         scan_forms_hidden_rel_err=hidden_err,
         scan_forms_grads_norm_rel_err=forms_norm,
         scan_forms_grads_max_rel_err=forms_err,
         scan_forms_tolerance=tol, scan_forms_against_float64=f64,
         scan_float64_tolerance=DIST_SCAN_F64["tol"], peak_memory_gb=peak,
         card=card)


def _dist_cpsum(torch, card):
    """(a) compressed_psum_mean on NCCL against the local round trip."""
    from repro_torch.dist import collectives

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = 3 * torch.randn((64, 256), generator=gen, device=DEVICE)
    err = ref_err = None
    worst = 0.0
    for _ in range(DIST_CPSUM_ROUNDS):
        mean, err = collectives.compressed_psum_mean(x, None, nbits=8, err=err)
        v = x if ref_err is None else x + ref_err
        scale = v.abs().max().reshape(1)[0].clamp(min=1e-12) / 127.0
        q = torch.clamp(torch.round(v / scale), -127.0, 127.0).to(torch.int32)
        deq = q.to(torch.float32) * scale
        ref_err = v - deq
        if not (torch.equal(mean, deq / 1) and torch.equal(err, ref_err)):
            worst = max(worst, float((mean - deq).abs().max()),
                        float((err - ref_err).abs().max()))
    if worst:
        raise AssertionError(f"compressed_psum_mean on NCCL differs from the "
                             f"local round trip by {worst}")
    emit(phase="dist_compressed_psum", rounds=DIST_CPSUM_ROUNDS, nbits=8,
         bit_equal=True, card=card)


def _dist_gnn(torch, mesh, card):
    """(a) forward_int under shard_ctx: bit-equal to the forward without a
    context, through bitserial_gemm. Returns the launches of the run under
    the context."""
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.graph import partition
    from repro_torch.graph.datasets import load
    from repro_torch.kernels import _build
    from repro_torch.models import gnn
    from repro_torch.train import intpath, trainer
    from repro_torch.tune import use_table

    g = DIST_GNN
    data_ = load(g["dataset"], scale=g["scale"], seed=0)
    parts = partition.partition(data_.csr, g["parts"])
    cfg = dataclasses.replace(configs.get("qgtc-gcn"),
                              in_dim=data_.features.shape[1],
                              n_classes=int(data_.labels.max()) + 1)
    batches = trainer.prepare_batches(data_, parts,
                                      batch_size=g["batch_size"])
    bp, rp = intpath.batch_caps(batches)
    art = intpath.ArtifactCache(cfg.x_bits, block_pad=bp, rem_pad=rp,
                                device=DEVICE).get(batches[0])
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device=DEVICE)
    with use_table(None), no_fallback(), torch.no_grad():
        want = gnn.forward_int(params, art, cfg)
        torch.cuda.synchronize()
        _build.reset_launches()
        with shd.shard_ctx(mesh, shd.make_rules("train")):
            got = gnn.forward_int(params, art, cfg)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    expected = int_launches_per_step(cfg.layers, g["batch_size"], 0)
    if not torch.equal(want, got) or got.device.type != DEVICE:
        raise AssertionError("forward_int under shard_ctx differs from the "
                             "forward without a context")
    if launches.get("bitserial_gemm") != expected:
        raise AssertionError(f"forward_int under shard_ctx launched "
                             f"{launches}, expected {expected} bitserial_gemm")
    emit(phase="dist_gnn_forward", logits_bit_equal=True, launches=launches,
         expected_bitserial_gemm=expected, card=card)
    return launches


def _src_env() -> dict:
    """The environment of a subprocess that imports the checkout's port."""
    import os

    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))


def _dist_dryrun(torch, card):
    """(b) launch/dryrun.py as subprocesses on the fake 256- and 512-rank
    meshes, the report's tables printed."""
    import tempfile

    from repro_torch.perf import report, roofline

    t0 = time.perf_counter()
    env = _src_env()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--out", out, "--cell-timeout",
             str(DIST_CELL_TIMEOUT_S), "--comm-debug", *mp], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for arch, shape, meshes in DIST_DRYRUN for mp in meshes]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        recs = report.load(out)
    bad = [r for r in recs if r["status"] != "OK"]
    if any(p.returncode for p in procs) or bad or len(recs) != len(procs):
        raise AssertionError(f"dry run: {[r.get('error') for r in bad]} "
                             f"{[log[-1000:] for log in logs]}")
    # every collective the step issued is recorded: the records by op
    # against torch's CommDebugMode in the same run
    for r in recs:
        c = r["comm_debug"]
        print(f"comm_debug {r['arch']} x {r['shape']} x {r['mesh']}: "
              f"records {c['records']} CommDebugMode {c['counts']}",
              flush=True)
    unequal = [(r["arch"], r["shape"], r["mesh"], r["comm_debug"])
               for r in recs if not r["comm_debug"]["equal"]]
    if unequal:
        raise AssertionError(f"dry run: records differ from CommDebugMode's "
                             f"counts: {unequal}")
    over = []
    for r in recs:
        if r["arch"] != "zamba2-7b":
            continue
        ag = r["collectives_by_op"].get("all-gather",
                                        {"count": 0, "result_bytes": 0})
        bound = DIST_ZAMBA2_GATHER_BOUND if r["shape"] == "prefill_32k" \
            else None
        print(f"zamba2_all_gathers {r['shape']} x {r['mesh']}: count "
              f"{ag['count']} bytes {ag['result_bytes']} bound {bound}",
              flush=True)
        if bound is not None and ag["result_bytes"] > bound:
            over.append((r["shape"], r["mesh"], ag["result_bytes"]))
    if over:
        raise AssertionError(f"dry run: zamba2's all-gathers above their "
                             f"bound: {over}")
    for mesh in ("16x16", "2x16x16"):
        print(f"## Roofline ({mesh}, per-device seconds/step, H100 rates)")
        print(report.roofline_table(recs, mesh), flush=True)
    print("## Dry-run detail")
    print(report.dryrun_table(recs), flush=True)
    cells = []
    for r in recs:
        cell = dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                    status=r["status"])
        if r["status"] == "OK":
            cell.update(lower_s=r["lower_s"], run_s=r["compile_s"],
                        param_bytes=r["memory"]["param_bytes"],
                        peak_bytes_est=r["memory"]["peak_bytes_est"],
                        fits_hbm=r["fits_hbm"],
                        collectives_by_op=r["collectives_by_op"],
                        comm_debug=r["comm_debug"],
                        roofline=r["roofline"])
        else:
            cell.update(error=r["error"], where=r["traceback"][-600:])
        cells.append(cell)
    emit(phase="dist_dryrun", cells=cells, cell_timeout_s=DIST_CELL_TIMEOUT_S,
         fits_hbm_against=roofline.HW["hbm_bytes"],
         card_hbm_bytes=roofline.hbm_bytes(),
         seconds=time.perf_counter() - t0, card=card)


def phase_dist(torch, card, meta=None):
    """Phase 19: the dist layer on the card. (a) a world-1 NCCL group over a
    FileStore and make_local_mesh() as (1, 1): the sharded codeqwen and
    rwkv6 train steps, compressed_psum_mean, forward_int under shard_ctx;
    (b) the dry run on the fake meshes. ``meta``: a ``MetaPeaks`` (made
    here when None). Returns the kernel launches of (a)'s run under the
    context."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    meta = MetaPeaks() if meta is None else meta
    mesh = make_local_mesh()
    if (dist.get_backend() != "nccl" or mesh.device_type != "cuda"
            or shd.mesh_shape(mesh) != {"data": 1, "model": 1}):
        raise AssertionError(f"local mesh {mesh} on {dist.get_backend()}")
    try:
        _dist_train_step(torch, mesh, card, meta)
        _dist_scan_step(torch, mesh, card)
        _dist_cpsum(torch, card)
        launches = _dist_gnn(torch, mesh, card)
    finally:
        dist.destroy_process_group()
    _dist_dryrun(torch, card)
    emit(phase="dist_done", kernel_launches=launches,
         seconds=time.perf_counter() - t_phase, card=card)
    return launches


QUICKSTART_TIMEOUT_S = 600


def phase_quickstart(torch, card):
    """Phase 20: ``python -m repro_torch.examples.quickstart`` on the card,
    as a subprocess: exit 0, the last line OK."""
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart"],
        env=_src_env(), capture_output=True, text=True,
        timeout=QUICKSTART_TIMEOUT_S)
    lines = done.stdout.strip().splitlines()
    if done.returncode or not lines or lines[-1] != "OK":
        raise AssertionError(f"quickstart exited {done.returncode}: "
                             f"{done.stdout[-2000:]} {done.stderr[-2000:]}")
    emit(phase="quickstart", lines=lines, card=card)


PHASE_S: dict = {}


def _timed(fn):
    """``fn`` printing its seconds (a ``phase_seconds`` line) as it ends."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            PHASE_S[fn.__name__] = dt
            emit(phase="phase_seconds", name=fn.__name__, seconds=dt)
    return run


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
    for name in [n for n in globals() if n.startswith("phase_")]:
        globals()[name] = _timed(globals()[name])
    # the port's timing method, used by every phase, and its card constants
    global graph_ms, time_ms, PEAK_BYTES_S, PEAK_F32_S, PEAK_BF16_S
    from repro_torch.perf.report import graph_ms, time_ms
    from repro_torch.perf.roofline import HW
    PEAK_BYTES_S, PEAK_F32_S = HW["hbm_bw"], HW["peak_flops_fp32"]
    PEAK_BF16_S = HW["peak_flops_bf16"]
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

    from repro_torch.tune import use_table

    # phases 2-14 as they ran before a tuning table was packaged
    with use_table(None):
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
            serve_launches, serve_err = phase_serving(torch, card, data, parts)
        for name, n in serve_launches.items():
            launches[name] += n
        errs["bitserial_gemm"] = max(errs["bitserial_gemm"], serve_err)
        # the kernels line carries wq_gemm at the gate projection, batch 1
        timing["wq_gemm"] = phase_wq_timing(torch, card, wq_packed)[("wg", 1)]
    with no_fallback():
        tuned_launches = phase_tuning(torch, card, models, dbs)
    for name, n in tuned_launches.items():
        launches[name] += n
    for name, n in phase_analysis(torch, card).items():
        launches[name] += n
    for name, n in phase_lm_serving(torch, card).items():
        launches[name] += n
    meta = MetaPeaks()  # on the host's cores while the card works
    try:
        for name, n in phase_lm_training(torch, card, meta).items():
            launches[name] += n
        for name, n in phase_dist(torch, card, meta).items():
            launches[name] += n
    finally:
        meta.close()
    phase_quickstart(torch, card)
    emit(phase="phase_times", seconds=PHASE_S, card=card)

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
