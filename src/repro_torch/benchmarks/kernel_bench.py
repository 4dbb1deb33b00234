"""Kernel, serving and training micro-benchmarks -> machine-readable records.

The reference's ``benchmarks/kernel_bench.py`` on the port, suite
``kernels`` of ``repro_torch.benchmarks.run`` (``--smoke``: the sizes of
``SMOKE``, for the CPU). Sweeps the bit-serial GEMM stack over (op, bits,
sparsity, jump mode) on the ``cuda`` engine wherever the reference names
``pallas``, the GNN serving forward over jump modes, and one training
step of each arm. Every function takes ``device=`` (None: the card).

The checks of what is computed stay assertions: every jump arm equal
(``torch.equal``) to its dense arm, and every SGT and compact arm equal
to the dense ``torch_dot`` product, as they are timed; the serving arms
assert their own invariants (``serve_throughput``); a training arm that
diverges fails. The reference's two speed gates are measured and
emitted with ``claim_holds``, not asserted: SGT at least as fast as
compact jumping on every scattered cell and strictly faster on one
(``bench_sgt``), and the integer training step no slower than the
fake-quant step (``bench_train``). On an H100 both arms of the first sit
near the launch floor at these sizes, and the integer step is host-bound
(PERF.md §5, §7), so neither is a property of the port to assert.

Record schema (one dict per timed configuration), the reference's:
  op         — bgemm | bitserial_gemm | bitserial_fused | serve_forward
               | serve_overload | serve_shuffled | serve_failover
               | train_step
  bits       — operand bitwidth (feature bits for the serve_* ops)
  sparsity   — zeroed fraction of A's reduction dim (tile-aligned band),
               or the measured zero-tile skip ratio for the serve_* ops
  jump       — none | mask | compact | sgt
  median_ms  — median ms of a call with its dispatch (serve: median batch
               latency; train: median steady-state step, host wall with
               the step's batch work, ended by a synchronize)
  m, k, n    — the GEMM's shape (kernel records)
  pattern    — "scattered" on the SGT-vs-compact cells
  phase/arm  — train_step records carry phase="train" and arm="fake"|"int"
  serve_* records add the arm's own fields (serve_throughput)
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.api.policy import DEFAULT_POLICY
from repro_torch.benchmarks.common import emit, timeit
from repro_torch.core import bitops, zerotile
from repro_torch.device import resolve_device
from repro_torch.kernels import sgt as sgt_lib

__all__ = ["bench_gemms", "bench_sgt", "bench_serve", "bench_train", "main"]


def _banded(rng, m, k, bits, sparsity):
    """s-bit operand with a leading zero band covering ``sparsity`` of K.

    A contiguous band is tile-aligned under any block split, so the zeroed
    fraction translates directly into skippable tiles.
    """
    a = rng.integers(1, 1 << bits, (m, k)).astype(np.int32)
    z = int(k * sparsity)
    if z:
        a[:, :z] = 0
    return a


def _scattered(rng, m, k, bits, sparsity):
    """s-bit operand whose surviving non-zero WORDS are spread evenly.

    Zeroing ``sparsity`` of K in evenly spaced 32-column word groups leaves
    (almost) every k-tile occupied, so tile-granular compact jumping still
    reads nearly the full matrix while word-granular sparse-graph
    translation reads only the live words.
    """
    a = rng.integers(1, 1 << bits, (m, k)).astype(np.int32)
    nw = k // 32
    keep = max(1, round(nw * (1.0 - sparsity)))
    kept = np.round(np.linspace(0, nw - 1, keep)).astype(int)
    dead = np.ones(nw, bool)
    dead[kept] = False
    a[:, np.repeat(dead, 32)] = 0
    return a


def _operands(rng_a, rng, m, k, n, bits, sparsity, dev):
    a = rng_a(rng, m, k, bits, sparsity)
    b = rng.integers(0, 1 << bits, (k, n)).astype(np.int32)
    ap = bitops.pack_a(torch.as_tensor(a, device=dev), bits)
    bp = bitops.pack_b(torch.as_tensor(b, device=dev), bits)
    alpha = torch.full((m, 1), 0.01, dtype=torch.float32, device=dev)
    beta = torch.zeros((1, n), dtype=torch.float32, device=dev)
    return ap, bp, alpha, beta


def _call(op, ap, bp, alpha, beta, **kw):
    if op == "bgemm":
        return api.bgemm(ap[0], bp[0], **kw)
    if op == "bitserial_gemm":
        return api.bitserial_mm_packed(ap, bp, **kw)
    return api.bitserial_fused(ap, bp, alpha, beta, out_bits=4, **kw)


def bench_gemms(smoke: bool = False, device=None) -> list[dict]:
    """(op, bits, sparsity, jump) sweep with built-in equality checks.

    The ``compact`` arm consumes PREcomputed tiles with the true max count
    (the serving contract): the arm that shows the zero-tile payoff.
    """
    dev = resolve_device(device)
    m, k, n = (24, 256, 16) if smoke else (64, 2048, 64)
    iters = 2 if smoke else 5
    bm, bw = DEFAULT_POLICY.block_m, DEFAULT_POLICY.block_w
    records: list[dict] = []
    rng = np.random.default_rng(0)
    for op in ("bgemm", "bitserial_gemm", "bitserial_fused"):
        bit_sweep = (1,) if op == "bgemm" else ((2,) if smoke else (2, 4))
        for bits in bit_sweep:
            for sparsity in (0.0, 0.5, 0.9):
                ap, bp, alpha, beta = _operands(_banded, rng, m, k, n, bits,
                                                sparsity, dev)
                tiles = zerotile.compact_artifacts(ap, bm, bw)

                def run(jump, _ap=ap, _bp=bp, _al=alpha, _be=beta,
                        _tiles=tiles, _op=op):
                    # tiles take precedence over the policy's jump mode, so
                    # the compact arm rides DEFAULT_POLICY + precomputed
                    # artifacts
                    if jump == "compact":
                        pol, tl = DEFAULT_POLICY, _tiles
                    else:
                        pol, tl = DEFAULT_POLICY.replace(jump=jump), None
                    return _call(_op, _ap, _bp, _al, _be, backend="cuda",
                                 policy=pol, tiles=tl)

                ref = run("none")
                for jump in ("none", "mask", "compact"):
                    if not torch.equal(run(jump), ref):
                        raise AssertionError(
                            f"jump parity: {op} {bits}b sparsity={sparsity} "
                            f"{jump}")
                    ms = timeit(run, jump, iters=iters) * 1e3
                    records.append({
                        "op": op, "bits": bits, "sparsity": sparsity,
                        "jump": jump, "median_ms": ms,
                        "m": m, "k": k, "n": n,
                    })
                    emit(f"kernel_{op}_{bits}b_z{sparsity}_{jump}", ms, "ms",
                         skipped_frac=sparsity)
    return records


def bench_sgt(smoke: bool = False, device=None) -> list[dict]:
    """Sparse-graph translation vs compact jumping at scattered sparsity.

    ``_scattered`` leaves every k-tile occupied, so the compact arm reads
    block_w words per surviving tile while the SGT arm's word-column remap
    reads only the live words. Both arms consume PREcomputed artifacts
    and are asserted equal to the dense ``torch_dot`` product as they are
    timed. The reference's gate (SGT no slower than compact on every
    cell, strictly faster on one) is emitted with ``claim_holds``.
    """
    dev = resolve_device(device)
    m, k, n = (24, 1024, 16) if smoke else (64, 2048, 64)
    iters = 5 if smoke else 7  # medians must shrug off scheduler spikes
    bm, bw = DEFAULT_POLICY.block_m, DEFAULT_POLICY.block_w
    cells = ([("bgemm", 1), ("bitserial_gemm", 1), ("bitserial_gemm", 2),
              ("bitserial_gemm", 8)] if smoke else
             [("bgemm", 1)]
             + [("bitserial_gemm", b) for b in range(1, 9)]
             + [("bitserial_fused", 2), ("bitserial_fused", 4)])
    records: list[dict] = []
    rng = np.random.default_rng(7)
    wins = cells_held = n_cells = 0
    for op, bits in cells:
        for sparsity in ((0.9,) if smoke else (0.9, 0.95)):
            ap, bp, alpha, beta = _operands(_scattered, rng, m, k, n, bits,
                                            sparsity, dev)
            arms = {"compact": zerotile.compact_artifacts(ap, bm, bw),
                    "sgt": sgt_lib.sgt_artifacts(ap, bm)}

            def run(arm, _op=op, _ap=ap, _bp=bp, _arms=arms, _al=alpha,
                    _be=beta):
                if arm == "torch_dot":  # dense plain engine, no tiles
                    return _call(_op, _ap, _bp, _al, _be,
                                 backend="torch_dot")
                return _call(_op, _ap, _bp, _al, _be, backend="cuda",
                             policy=DEFAULT_POLICY, tiles=_arms[arm])

            ref = run("torch_dot")  # the parity target
            cell_ms = {}
            for arm in ("compact", "sgt"):
                if not torch.equal(run(arm), ref):
                    raise AssertionError(
                        f"sgt parity: {op} {bits}b scattered z{sparsity} "
                        f"{arm} vs torch_dot")
                ms = timeit(run, arm, iters=iters) * 1e3
                cell_ms[arm] = ms
                records.append({
                    "op": op, "bits": bits, "sparsity": sparsity,
                    "jump": arm, "median_ms": ms,
                    "m": m, "k": k, "n": n, "pattern": "scattered",
                })
                emit(f"sgt_{op}_{bits}b_z{sparsity}_{arm}", ms, "ms",
                     pattern="scattered")
            held = cell_ms["sgt"] <= cell_ms["compact"]
            emit(f"sgt_{op}_{bits}b_z{sparsity}_vs_compact",
                 cell_ms["compact"] / cell_ms["sgt"], "x", derived=True,
                 claim_holds=held)
            n_cells += 1
            cells_held += held
            wins += cell_ms["sgt"] < cell_ms["compact"]
    emit("sgt_no_slower_than_compact", cells_held, "cells", derived=True,
         of=n_cells, claim_holds=cells_held == n_cells and wins >= 1)
    return records


def bench_serve(smoke: bool = False, device=None) -> list[dict]:
    """Serving arms: jump parity, overload shedding, shuffled coalescing,
    failover, through ``serve_throughput``'s runners, each asserting its
    own invariants as it is timed."""
    from repro_torch.benchmarks.serve_throughput import (failover_arm,
                                                         jump_arm,
                                                         overload_arm,
                                                         sgt_arm,
                                                         shuffled_arm)

    if smoke:
        return (jump_arm(scale=0.004, parts_k=4, rounds=2, device=device)
                + sgt_arm(scale=0.004, parts_k=4, rounds=2, device=device)
                + overload_arm(scale=0.004, parts_k=4, bursts=3,
                               device=device)
                + shuffled_arm(scale=0.004, parts_k=4, rounds=2,
                               device=device)
                + failover_arm(scale=0.004, parts_k=16, rounds=3,
                               device=device))
    return (jump_arm(scale=0.01, parts_k=8, rounds=4, device=device)
            + sgt_arm(scale=0.01, parts_k=8, rounds=4, device=device)
            + overload_arm(scale=0.006, parts_k=8, bursts=5, device=device)
            + shuffled_arm(scale=0.006, parts_k=8, rounds=3, device=device)
            + failover_arm(scale=0.008, parts_k=16, rounds=4,
                           device=device))


def bench_train(smoke: bool = False, device=None) -> list[dict]:
    """Per-step training time: QAT fake-quant vs the integer bitserial path.

    Times the STEADY-STATE step of both arms on the Table 2 harness
    (Cluster-GCN, proteins): host wall per step, with the batch work each
    arm does and a synchronize at its end. The fake arm rebuilds its dense
    device batch every step, the int arm hits its per-batch artifact
    cache; warm-up steps absorb the artifact builds. The reference's gate
    (int no slower than fake) is emitted with ``claim_holds``.
    """
    from repro_torch.graph import partition
    from repro_torch.graph.batching import batch_iterator
    from repro_torch.graph.datasets import load as load_dataset
    from repro_torch.models import gnn
    from repro_torch.train import intpath, trainer
    from repro_torch.train import optimizer as opt

    dev = resolve_device(device)
    scale, warm, steps = (0.05, 4, 12) if smoke else (0.1, 8, 40)
    bits = 4
    data = load_dataset("proteins", scale=scale, seed=0)
    parts = partition.partition(data.csr, 8)
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1],
                                  int(data.labels.max()) + 1, bits, bits)
    ocfg = opt.AdamWConfig(lr=1e-2, weight_decay=1e-4, grad_clip=1.0)
    batches = trainer.prepare_batches(data, parts, batch_size=4)
    records: list[dict] = []
    arm_ms: dict[str, float] = {}
    for arm in ("fake", "int"):
        params = gnn.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device=dev)
        ostate = opt.adamw_init(params)
        if arm == "int":
            bp, rp = intpath.batch_caps(batches)
            cache = intpath.ArtifactCache(cfg.x_bits, block_pad=bp,
                                          rem_pad=rp, device=dev)
            dev_batches: dict[int, dict] = {}
            gen = torch.Generator(device=dev).manual_seed(1)
        times = []
        loss = None
        for step, batch in batch_iterator(batches, epochs=None, seed=0):
            if step >= warm + steps:
                break
            t0 = time.perf_counter()
            if arm == "int":
                db = dev_batches.get(id(batch))
                if db is None:
                    db = {"art": cache.get(batch),
                          "y": torch.as_tensor(batch.labels, device=dev),
                          "mask": torch.as_tensor(batch.train_mask,
                                                  device=dev)}
                    dev_batches[id(batch)] = db
                params, ostate, _, loss, _ = trainer.train_step_int(
                    params, ostate, None, db, gen, cfg, ocfg, 0, False, 0,
                    None)
            else:
                db = trainer.make_device_batch(batch, device=dev)
                params, ostate, loss, _ = trainer.train_step(
                    params, ostate, db, cfg, ocfg, True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if step >= warm:
                times.append(time.perf_counter() - t0)
        assert np.isfinite(float(loss)), f"train arm {arm} diverged"
        ms = float(np.median(times)) * 1e3
        arm_ms[arm] = ms
        records.append({
            "op": "train_step", "bits": bits, "sparsity": 0.0,
            "jump": "none", "median_ms": ms, "phase": "train",
            "arm": arm, "dataset": "proteins", "steps": steps,
        })
        emit(f"train_step_{arm}_{bits}b", ms, "ms", phase="train")
    emit(f"train_step_int_vs_fake_{bits}b", arm_ms["fake"] / arm_ms["int"],
         "x", derived=True, phase="train",
         claim_holds=arm_ms["int"] <= arm_ms["fake"])
    return records


def main(device=None, smoke: bool = False) -> list[dict]:
    records = bench_gemms(smoke=smoke, device=device)
    records += bench_sgt(smoke=smoke, device=device)
    records += bench_serve(smoke=smoke, device=device)
    records += bench_train(smoke=smoke, device=device)
    return records
