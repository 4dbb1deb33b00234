"""Training launcher, as the reference's ``repro.launch.train``: a
resume-from-latest loop with fault injection, a straggler watchdog and
atomic checkpoints, on the card (``--device cpu`` for the CPU).

The loop:

  1. restore the latest checkpoint under ``--ckpt-dir`` if there is one;
  2. a deterministic data stream addressed by (seed, step): no data state;
  3. the train step (``launch.steps.make_train_step``), which updates the
     parameters and optimizer state in place;
  4. an atomic checkpoint every ``--ckpt-every`` steps
     (``dist.checkpoint``, the reference's layout);
  5. ``--simulate-failure-at N``: exit with code 17 after step N; the same
     command run again resumes from the last checkpoint and reproduces the
     remaining steps;
  6. the straggler watchdog: each step's wall time, which ends in a read
     of the loss to the host (the device's work included), feeds a
     rolling p50 / p95 and flags slow steps.

Every ``--log-every`` steps and at the last it prints ``[train] {json}``
with ``step``, ``loss``, ``wall_s`` and ``straggler`` (and ``acc`` for a
GNN), then a ``done:`` line.

LM archs: ``--smoke`` trains the arch's reduced same-family config;
``--n-micro`` splits each batch into microbatches; ``--grad-compress-bits``
quantizes the gradients with error feedback before the update (the
residuals are not checkpointed, as in the reference).

``--model-parallel N`` (N > 1, or any N when the process was started by a
launcher that sets ``WORLD_SIZE``) trains on a (data, model) mesh over every
rank of the default process group (``launch.mesh.make_local_mesh``: NCCL
on the card, gloo with ``--device cpu``), which raises when the world size
is not a multiple of N. Parameters and moments are DTensors distributed by
``steps.param_shardings`` / ``opt_shardings`` under the train rules, each
rank draws the same global batch and keeps its data shard, and the step
runs under ``shard_ctx``. Checkpoints gather to host numpy and restore onto
whatever mesh the run has, so a run resumes at any ``--model-parallel``.
``--grad-compress-bits`` quantizes the DTensor gradients there: each leaf's
scale is the max-abs over all its shards, as the reference's jitted step
computes it over the global array.

GNN archs (qgtc-gcn / qgtc-gin) take the same loop over Cluster-GCN
subgraph batches; ``--int-path`` trains through the integer bit-serial
forward, whose GEMMs run the hand-written ``bitserial_gemm`` on the card.
Stochastic rounding (``--stochastic``) draws from a ``torch.Generator``
seeded from (seed, step) each step, not from the reference's JAX key: the
draws differ from the reference's, and a resumed run still reproduces
the uninterrupted one.

  python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt    # on the card
  python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke --device cpu
  python -m repro_torch.launch.train --arch qgtc-gcn --smoke --int-path \\
      --steps 30 --ckpt-dir /tmp/gnn-ckpt
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch codeqwen1.5-7b --smoke --model-parallel 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import smoke_config
from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import sharding as shd
from repro_torch.dist.elastic import StragglerWatchdog
from repro_torch.launch import steps as step_lib
from repro_torch.models import gnn, lm
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt

__all__ = ["main"]


def _step_seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def _restore(args, tree, cfg_hash, shardings=None):
    """(tree, first step): the latest checkpoint's, or ``tree`` and 0."""
    if not args.ckpt_dir or ckpt.latest_step(args.ckpt_dir) is None:
        return tree, 0
    tree, manifest = ckpt.restore(args.ckpt_dir, tree, cfg_hash=cfg_hash,
                                  shardings=shardings)
    print(f"[train] resumed from step {manifest['step']}", flush=True)
    return tree, manifest["step"]


def _after_step(args, step, watchdog, history, rec, tree, cfg_hash,
                mesh_shape=None) -> None:
    """Log, checkpoint and inject the failure, as the reference's loop."""
    rec["straggler"] = watchdog.observe(step, rec["wall_s"])
    if step % args.log_every == 0 or step == args.steps - 1:
        rec = {k: round(v, 4) if k in ("loss", "acc") else
               round(v, 3) if k == "wall_s" else v for k, v in rec.items()}
        history.append(rec)
        print(f"[train] {json.dumps(rec)}", flush=True)
    if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
        ckpt.save(args.ckpt_dir, step + 1, tree, cfg_hash=cfg_hash,
                  mesh_shape=mesh_shape)
    if args.simulate_failure_at == step:
        print(f"[train] SIMULATED FAILURE at step {step}", flush=True)
        sys.exit(17)


def _train_gnn(cfg, args, dev) -> dict:
    """Cluster-GCN training with the LM branch's resume / failure loop:
    a deterministic (seed, step) -> batch stream (a resume skips the steps
    done), atomic checkpoints, the failure exit, the watchdog.
    ``--int-path`` swaps the fake-quant step for the integer bit-serial
    step over per-batch cached artifacts."""
    from repro_torch.graph import partition
    from repro_torch.graph.batching import batch_iterator
    from repro_torch.graph.datasets import load as load_dataset
    from repro_torch.train import intpath, trainer

    scale = min(args.scale, 0.05) if args.smoke else args.scale
    data = load_dataset(args.dataset, scale=scale, seed=args.seed)
    parts = partition.partition(data.csr, args.parts)
    cfg = dataclasses.replace(cfg, in_dim=data.features.shape[1],
                              n_classes=int(data.labels.max()) + 1)
    tcfg = trainer.TrainConfig(
        steps=args.steps, lr=args.lr, seed=args.seed,
        log_every=args.log_every,
        path="int_bitserial" if args.int_path else "fake",
        grad_bits=args.grad_bits, stochastic=args.stochastic,
        grad_compress_bits=args.grad_compress_bits)
    ocfg = opt.AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                           grad_clip=1.0)
    cfg_hash = ckpt.config_hash((cfg, tcfg, ocfg))

    params = gnn.init_params(
        cfg, generator=torch.Generator().manual_seed(args.seed), device=dev)
    (params, ostate), start_step = _restore(
        args, (params, opt.adamw_init(params)), cfg_hash)
    # error-feedback residuals are not checkpointed (as in the LM branch):
    # after a restart compression starts again from a zero residual
    cstate = (opt.compression_init(params) if tcfg.grad_compress_bits
              else None)

    batches = trainer.prepare_batches(data, parts, batch_size=4)
    use_int = tcfg.path == "int_bitserial"
    if use_int:
        bp, rp = intpath.batch_caps(batches)
        cache = intpath.ArtifactCache(cfg.x_bits, block_pad=bp, rem_pad=rp,
                                      device=dev)
        dev_batches: dict[int, dict] = {}
    gen = torch.Generator(device=dev)
    watchdog = StragglerWatchdog()
    history: list[dict] = []
    for step, batch in batch_iterator(batches, epochs=None, seed=args.seed):
        if step >= args.steps:
            break
        if step < start_step:
            continue  # deterministic stream: a resume skips the steps done
        t0 = time.perf_counter()
        if use_int:
            dbatch = dev_batches.get(id(batch))
            if dbatch is None:
                dbatch = {"art": cache.get(batch),
                          "y": torch.as_tensor(batch.labels, device=dev),
                          "mask": torch.as_tensor(batch.train_mask,
                                                  device=dev)}
                dev_batches[id(batch)] = dbatch
            gen.manual_seed(_step_seed(args.seed + 0x5eed, step))
            params, ostate, cstate, loss, acc = trainer.train_step_int(
                params, ostate, cstate, dbatch, gen, cfg, ocfg,
                tcfg.grad_bits, tcfg.stochastic, tcfg.grad_compress_bits,
                None)
        else:
            dbatch = trainer.make_device_batch(batch, device=dev)
            params, ostate, loss, acc = trainer.train_step(
                params, ostate, dbatch, cfg, ocfg, tcfg.qat)
        rec = {"step": step, "loss": loss.item(), "acc": acc.item()}
        rec["wall_s"] = time.perf_counter() - t0
        _after_step(args, step, watchdog, history, rec, (params, ostate),
                    cfg_hash)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (params, ostate),
                  cfg_hash=cfg_hash)
    test_acc = trainer.evaluate(params, data, parts, cfg, qat=True,
                                device=dev)
    print(f"[train] done: test_acc={test_acc:.4f} p50={watchdog.p50:.3f}s "
          f"p95={watchdog.p95:.3f}s flagged={len(watchdog.flagged)}",
          flush=True)
    return {"history": history, "test_acc": test_acc,
            "final_loss": history[-1]["loss"] if history else None,
            "device": str(dev)}


def _compressed_step(cfg, ocfg, q_chunk: int, nbits: int, params):
    """The compressed-DP variant: the gradients are quantized with error
    feedback before the update (the cross-pod payload on a cluster); the
    residuals ride beside the optimizer state."""
    cstate = opt.compression_init(params)

    def step_fn(params, ostate, batch):
        nonlocal cstate
        loss, _, grads = step_lib.loss_and_grads(params, batch, cfg,
                                                 q_chunk=q_chunk)
        q, scales, cstate = opt.compress_grads(grads, cstate, nbits=nbits)
        del grads
        params, ostate = opt.adamw_update_(
            params, opt.decompress_grads(q, scales), ostate, ocfg)
        return params, ostate, {"loss": loss}

    return step_fn


def _laid_out(params, ostate, shardings):
    """The trees in the layout ``shardings`` name, as the reference's jitted
    step keeps it: a run resumed from a checkpoint then issues the same
    collectives in the same order as one that never stopped."""
    return (step_lib.distribute(params, shardings[0]),
            step_lib.distribute(ostate, shardings[1]))


def _sharded(args) -> bool:
    return args.model_parallel > 1 or int(os.environ.get("WORLD_SIZE", 1)) > 1


def _train_lm(cfg, args, dev) -> dict:
    if args.smoke:
        cfg = smoke_config(cfg)
    ocfg = opt.AdamWConfig(lr=args.lr, grad_clip=1.0)
    cfg_hash = ckpt.config_hash((cfg, ocfg))

    params, axes = lm.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    mesh = rules = None
    shardings = b_sh = None
    if _sharded(args):
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(model=args.model_parallel, device=dev)
        rules = shd.make_rules("train")
        p_sh = step_lib.param_shardings(mesh, rules, axes, params)
        shardings = (p_sh, step_lib.opt_shardings(mesh, rules, axes, params))
        b_sh = step_lib.batch_shardings(cfg, mesh, rules)
        params = step_lib.distribute(params, p_sh)
    mesh_shape = None if mesh is None else shd.mesh_shape(mesh)
    (params, ostate), start_step = _restore(
        args, (params, opt.adamw_init(params)), cfg_hash, shardings)
    if mesh is not None:
        params, ostate = _laid_out(params, ostate, shardings)
    if args.grad_compress_bits:
        step_fn = _compressed_step(cfg, ocfg, args.q_chunk,
                                   args.grad_compress_bits, params)
    else:
        step_fn = step_lib.make_train_step(cfg, ocfg, q_chunk=args.q_chunk,
                                           n_micro=args.n_micro)
    watchdog = StragglerWatchdog()
    history: list[dict] = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = data_lib.batch_for_arch(cfg, args.seed, step, args.batch,
                                        args.seq, device=dev)
        if mesh is None:
            params, ostate, metrics = step_fn(params, ostate, batch)
            loss = metrics["loss"]
        else:
            batch = step_lib.distribute(batch, {k: b_sh[k] for k in batch})
            with step_lib.sharded(mesh, rules):
                params, ostate, metrics = step_fn(params, ostate, batch)
            params, ostate = _laid_out(params, ostate, shardings)
            loss = metrics["loss"]
            if hasattr(loss, "full_tensor"):
                loss = loss.full_tensor()
        rec = {"step": step, "loss": loss.item()}
        rec["wall_s"] = time.perf_counter() - t0
        _after_step(args, step, watchdog, history, rec, (params, ostate),
                    cfg_hash, mesh_shape)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (params, ostate),
                  cfg_hash=cfg_hash, mesh_shape=mesh_shape)
    print(f"[train] done: p50={watchdog.p50:.3f}s p95={watchdog.p95:.3f}s "
          f"flagged={len(watchdog.flagged)}", flush=True)
    return {"history": history,
            "final_loss": history[-1]["loss"] if history else None,
            "device": str(dev), "mesh_shape": mesh_shape}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--q-chunk", type=int, default=1024)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--grad-compress-bits", type=int, default=0,
                    help="int8/int4 error-feedback gradient compression for "
                         "the DP reduction (0 = off)")
    # GNN-arch (qgtc-*) options
    ap.add_argument("--dataset", default="proteins")
    ap.add_argument("--scale", type=float, default=0.1,
                    help="GNN dataset subsample fraction")
    ap.add_argument("--parts", type=int, default=8,
                    help="Cluster-GCN partition count")
    ap.add_argument("--int-path", action="store_true",
                    help="GNN: train through the integer bitserial forward")
    ap.add_argument("--grad-bits", type=int, default=0,
                    help="GNN int path: quantize backward GEMMs (0 = float)")
    ap.add_argument("--stochastic", action="store_true",
                    help="GNN int path: stochastic rounding")
    args = ap.parse_args(argv)
    if args.model_parallel < 1:
        ap.error(f"--model-parallel must be at least 1, got "
                 f"{args.model_parallel}")

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if isinstance(cfg, gnn.GNNConfig):
        return _train_gnn(cfg, args, dev)
    return _train_lm(cfg, args, dev)


if __name__ == "__main__":
    main()
